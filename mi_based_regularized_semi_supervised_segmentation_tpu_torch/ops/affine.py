"""Random affine augmentation with its exact inverse, and random cutout
(counterpart of the JAX package's ``ops/affine.py``; not wired into the
trainers, as there).

Images are NCHW. Matrices are [B, 2, 3] in normalised [-1, 1] coordinates;
``affine_transform`` samples bilinearly with zero padding in align-corners
coordinates (pixel = (u + 1) (size - 1) / 2), which is ``F.grid_sample``
with ``align_corners=True``. Draws come from an explicit ``torch.Generator``
(``random_*``); ``affine_matrix`` and ``cutout`` take the draws themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _uniform(n: int, low: float, high: float, generator, device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device) * (high - low) + low


def affine_matrix(degrees: torch.Tensor, scale: torch.Tensor, shear: torch.Tensor
                  ) -> torch.Tensor:
    """[B, 2, 3] matrices [[s cos, -s sin + sh, 0], [s sin + sh, s cos, 0]]
    from rotations in degrees, scales and shears, each [B]."""
    theta = torch.deg2rad(degrees)
    cos, sin = torch.cos(theta) * scale, torch.sin(theta) * scale
    zero = torch.zeros_like(cos)
    row0 = torch.stack([cos, -sin + shear, zero], dim=-1)
    row1 = torch.stack([sin + shear, cos, zero], dim=-1)
    return torch.stack([row0, row1], dim=1)


def random_affine_matrix(batch: int, degrees: float = 10.0,
                         scale: Tuple[float, float] = (0.9, 1.1), shear: float = 0.1,
                         generator: Optional[torch.Generator] = None,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """``affine_matrix`` of uniform draws: rotation in [-degrees, degrees],
    scale in ``scale``, shear in [-shear, shear]."""
    device = device if device is not None else (generator.device if generator else "cpu")
    return affine_matrix(_uniform(batch, -degrees, degrees, generator, device),
                         _uniform(batch, scale[0], scale[1], generator, device),
                         _uniform(batch, -shear, shear, generator, device))


def invert_affine_matrix(matrix: torch.Tensor) -> torch.Tensor:
    """The exact inverse of [B, 2, 3] affine matrices."""
    a, t = matrix[:, :, :2], matrix[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv = torch.stack([torch.stack([a[:, 1, 1], -a[:, 0, 1]], dim=-1),
                       torch.stack([-a[:, 1, 0], a[:, 0, 0]], dim=-1)], dim=1)
    inv = inv / det[:, None, None]
    inv_t = -torch.einsum("bij,bj->bi", inv, t)
    return torch.cat([inv, inv_t[:, :, None]], dim=-1)


def affine_transform(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """Warps [B, C, H, W] by [B, 2, 3] matrices: output pixel (x, y) in
    normalised coordinates samples the input at matrices @ (x, y, 1),
    bilinearly, zero outside. ``affine_transform(x, m)`` then
    ``affine_transform(., invert_affine_matrix(m))`` is the identity up to
    resampling error."""
    b, _, h, w = images.shape
    ys = torch.linspace(-1.0, 1.0, h, device=images.device)
    xs = torch.linspace(-1.0, 1.0, w, device=images.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    m = matrices.to(images.device, torch.float32)[:, :, :, None, None]
    src_x = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    src_y = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    grid = torch.stack([src_x, src_y], dim=-1)
    return F.grid_sample(images, grid.to(images.dtype), mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def cutout(images: torch.Tensor, sizes: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
           pad_value: float = 0.0) -> torch.Tensor:
    """Each sample's box [ys, ys + sizes) x [xs, xs + sizes) set to
    ``pad_value`` in every channel (clipped at the border)."""
    _, _, h, w = images.shape
    gy = torch.arange(h, device=images.device)[None, :, None]
    gx = torch.arange(w, device=images.device)[None, None, :]
    ys, xs, sizes = (v.to(images.device)[:, None, None] for v in (ys, xs, sizes))
    in_box = (gy >= ys) & (gy < ys + sizes) & (gx >= xs) & (gx < xs + sizes)
    return torch.where(in_box[:, None], torch.as_tensor(pad_value, dtype=images.dtype,
                                                        device=images.device), images)


def random_cutout(images: torch.Tensor, min_box: int, max_box: int, pad_value: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``cutout`` with one box a sample: its edge uniform in [min_box,
    max_box], its corner uniform over the image (the reference's
    ``TensorCutout``)."""
    b, _, h, w = images.shape
    device = generator.device if generator is not None else images.device

    def randint(low, high):
        return torch.randint(low, high, (b,), generator=generator, device=device)

    return cutout(images, randint(min_box, max_box + 1), randint(0, h), randint(0, w), pad_value)

