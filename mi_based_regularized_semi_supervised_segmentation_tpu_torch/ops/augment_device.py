"""On-device augmentation of the device-data path (counterpart of the JAX
package's ``ops/augment_device.py``).

The original project's strong transform (rotation by up to 45 degrees,
nearest; random vertical and horizontal flips; a random 224 crop; brightness
and contrast jitter), applied to batches gathered from a ``DeviceDataStore``
on the card, with the same geometry for image and label.

Drawing is split from applying: ``sample_augment_params`` draws the angles,
flips, crop offsets and jitter factors from a ``torch.Generator`` on the data's
device (no host round trip), and ``apply_augment`` applies them. Tests inject
the JAX package's draws into ``apply_augment``.

Geometries (``Kernel.geometry``):
- ``fused``: crop -> flip -> rotate composed into one source map, rounded
  once (rint) and gathered once from the raw uint8 (or packed uint16) store;
  only the crop-sized output is cast.
- ``sequential``: rotate (``rotate_nearest_batch``), then flip, then crop;
  bit-identical to ``fused``.
- ``shear``: rotate with the 3-shear kernel (``ops/rotate.rotate_shear``, one
  launch for a batch's images and labels together), then flip and crop. A
  pixel permutation, exact for labels; it differs from nearest rotation in
  sub-pixel choices.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .rotate import rotate_shear

GEOMETRIES = ("fused", "sequential", "shear")
Params = Dict[str, Optional[torch.Tensor]]


def _deg2rad(angles: torch.Tensor) -> torch.Tensor:
    return angles.float() * (math.pi / 180)


def rotate_nearest_batch(images: torch.Tensor, angles_deg: torch.Tensor,
                         fill: float = 0.0) -> torch.Tensor:
    """[B, H, W] (any dtype) rotated per sample by ``angles_deg`` about the
    canvas centre: nearest neighbour (rint), original canvas, ``fill``
    outside."""
    b, h, w = images.shape
    dev = images.device
    theta = _deg2rad(angles_deg.to(dev))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    src_x = cos_t * xs - sin_t * ys + cx
    src_y = sin_t * xs + cos_t * ys + cy
    return _gather(images, src_y, src_x, fill)


def _gather(images: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
            fill: float = 0.0) -> torch.Tensor:
    """images[b, rint(src_y), rint(src_x)] per sample, ``fill`` where the
    rounded source lies outside the [H, W] image; src_* are [B, h', w']."""
    b, h, w = images.shape
    sy = torch.round(src_y).to(torch.int64)
    sx = torch.round(src_x).to(torch.int64)
    ok = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    base = torch.arange(b, device=images.device)[:, None, None] * (h * w)
    vals = images.reshape(-1)[base + sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)]
    return torch.where(ok, vals, torch.full((), fill, dtype=vals.dtype, device=vals.device))


def _packed_bits(plane: torch.Tensor) -> torch.Tensor:
    """The img<<8|label values of a uint16 plane (or of its int16 view) as
    int32. uint16 has few kernels in PyTorch (no shifts, no gathers on every
    device), so its bits travel as int16."""
    return plane.view(torch.int16).to(torch.int32) & 0xFFFF


def flip_batch(images: torch.Tensor, vflip: torch.Tensor, hflip: torch.Tensor) -> torch.Tensor:
    """[B, H, W]; per-sample flips of axis 1 (v) and axis 2 (h)."""
    images = torch.where(vflip[:, None, None], images.flip(1), images)
    return torch.where(hflip[:, None, None], images.flip(2), images)


def crop_batch(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, crop: int) -> torch.Tensor:
    """[B, H, W] -> [B, crop, crop] at per-sample offsets, clamped into
    [0, H - crop] x [0, W - crop] as ``jax.lax.dynamic_slice`` clamps."""
    b, h, w = images.shape
    if crop > h or crop > w:
        raise ValueError(f"crop {crop} exceeds the canvas {h}x{w}")
    r = torch.arange(crop, device=images.device)
    rows = ys.to(images.device).long().clamp(0, h - crop)[:, None] + r
    cols = xs.to(images.device).long().clamp(0, w - crop)[:, None] + r
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images[bi, rows[:, :, None], cols[:, None, :]]


def center_crop_batch(images: torch.Tensor, crop: int) -> torch.Tensor:
    """[B, H, W] -> [B, crop, crop] centre crop (the eval transform)."""
    _, h, w = images.shape
    y, x = max((h - crop) // 2, 0), max((w - crop) // 2, 0)
    return images[:, y:y + crop, x:x + crop]


def crop_offsets_in_window(u: torch.Tensor, size: torch.Tensor, start: torch.Tensor,
                           crop: int, canvas: int) -> torch.Tensor:
    """Crop offsets from uniform draws ``u`` [B], confined to each slice's
    valid window (extent ``size``, canvas offset ``start``): inside the window
    when it is at least ``crop`` wide, else covering the whole window with the
    rest of the padding placed at random (pad-if-needed)."""
    size, start = size.long(), start.long()
    lo = torch.where(size >= crop, start, start + size - crop)
    hi = torch.where(size >= crop, start + size - crop, start)
    lo = lo.clamp(0, canvas - crop)
    hi = torch.minimum(torch.maximum(hi, lo), torch.full_like(hi, canvas - crop))
    off = lo + torch.floor(u * (hi - lo + 1).float()).long()
    return torch.minimum(torch.maximum(off, lo), hi)


def sample_augment_params(
    generator: torch.Generator,
    batch: int,
    shape: Tuple[int, int],
    crop: int = 224,
    rotation: float = 45.0,
    jitter: Optional[Tuple[float, float]] = (0.5, 1.5),
    flips: bool = True,
    valid_hw: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> Params:
    """One batch's draws on the generator's device, with the distributions
    and bounds of the JAX package's ``augment_pair_batch``: angles
    U(-rotation, rotation); v and h flips each with p 0.5; crop offsets in
    each slice's valid window after the flips moved it (or uniform over the
    canvas without windows); brightness and contrast U(jitter). Absent
    transforms are None."""
    h, w = shape
    dev = generator.device

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=dev)

    p: Params = {"angles": None, "vflip": None, "hflip": None,
                 "brightness": None, "contrast": None}
    if rotation:
        p["angles"] = uniform(-rotation, rotation)
    if flips:
        p["vflip"] = torch.rand(batch, generator=generator, device=dev) < 0.5
        p["hflip"] = torch.rand(batch, generator=generator, device=dev) < 0.5
        if offsets is not None:
            # flipping the canvas moves the valid window: top -> H - top - h
            top = torch.where(p["vflip"], h - offsets[:, 0] - valid_hw[:, 0], offsets[:, 0])
            left = torch.where(p["hflip"], w - offsets[:, 1] - valid_hw[:, 1], offsets[:, 1])
            offsets = torch.stack([top, left], dim=1)
    if valid_hw is not None and offsets is not None:
        p["ys"] = crop_offsets_in_window(torch.rand(batch, generator=generator, device=dev),
                                         valid_hw[:, 0], offsets[:, 0], crop, h)
        p["xs"] = crop_offsets_in_window(torch.rand(batch, generator=generator, device=dev),
                                         valid_hw[:, 1], offsets[:, 1], crop, w)
    else:
        p["ys"] = torch.randint(0, max(h - crop, 0) + 1, (batch,), generator=generator, device=dev)
        p["xs"] = torch.randint(0, max(w - crop, 0) + 1, (batch,), generator=generator, device=dev)
    if jitter is not None:
        p["brightness"] = uniform(*jitter)
        p["contrast"] = uniform(*jitter)
    return p


def _to_float(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def apply_augment(
    images: torch.Tensor,            # [B, H, W] uint8 or float, or packed uint16
    labels: Optional[torch.Tensor],  # [B, H, W] integer or None
    params: Params,
    crop: int = 224,
    rotation: float = 45.0,
    geometry: str = "fused",
    packed: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Applies ``params`` (from ``sample_augment_params``); returns (image
    [B, crop, crop, 1] float32, label [B, crop, crop] int32 or None).
    ``rotation`` is the largest angle the draws may hold (it sizes the shear
    canvas). ``packed``: ``images`` is the store's uint16 img<<8|label plane
    and ``labels`` is None; ``fused`` gathers it once, the other geometries
    unpack it first."""
    if geometry not in GEOMETRIES:
        raise ValueError(f"unknown geometry {geometry!r}")
    _, h, w = images.shape
    dev = images.device
    if packed:
        if labels is not None or images.dtype != torch.uint16:
            raise ValueError("packed mode takes the uint16 img<<8|label canvas and no labels")
        if geometry != "fused":
            bits = _packed_bits(images)
            labels = (bits & 0xFF).to(torch.uint8)
            images = (bits >> 8).to(torch.uint8)
            packed = False
    angles, v, hf = params["angles"], params["vflip"], params["hflip"]
    ys, xs = params["ys"].to(dev), params["xs"].to(dev)

    if geometry == "fused":
        # composed source coordinates of the crop output: crop -> flip -> rotate
        ii = torch.arange(crop, dtype=torch.float32, device=dev)[None, :, None]
        jj = torch.arange(crop, dtype=torch.float32, device=dev)[None, None, :]
        y1 = ys[:, None, None].float() + ii
        x1 = xs[:, None, None].float() + jj
        if v is not None:
            y1 = torch.where(v.to(dev)[:, None, None], (h - 1) - y1, y1)
            x1 = torch.where(hf.to(dev)[:, None, None], (w - 1) - x1, x1)
        if angles is not None:
            theta = _deg2rad(angles.to(dev))[:, None, None]
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
            dy, dx = y1 - cy, x1 - cx
            src_x = torch.cos(theta) * dx - torch.sin(theta) * dy + cx
            src_y = torch.sin(theta) * dx + torch.cos(theta) * dy + cy
        else:
            src_y, src_x = y1, x1
        # gather the raw store dtype, cast only the crop-sized output
        if packed:
            bits = _packed_bits(_gather(images.view(torch.int16), src_y, src_x))
            img = _to_float((bits >> 8).to(torch.uint8))
            lab = (bits & 0xFF).to(torch.int32)
        else:
            img = _to_float(_gather(images, src_y, src_x))
            lab = None if labels is None else _gather(labels, src_y, src_x).to(torch.int32)
    else:
        img = _to_float(images)
        lab = None if labels is None else labels.to(torch.int32)
        if angles is not None:
            if geometry == "shear":  # labels: the same permutation, in the same launch
                if lab is None:
                    img = rotate_shear(img, angles.to(dev), max_angle=rotation)
                else:
                    img, lab = rotate_shear(img, angles.to(dev), max_angle=rotation, labels=lab)
            else:
                img = rotate_nearest_batch(img, angles)
                if lab is not None:
                    lab = rotate_nearest_batch(lab, angles)
        if v is not None:
            img = flip_batch(img, v.to(dev), hf.to(dev))
            if lab is not None:
                lab = flip_batch(lab, v.to(dev), hf.to(dev))
        img = crop_batch(img, ys, xs, crop)
        if lab is not None:
            lab = crop_batch(lab, ys, xs, crop)
    if params.get("brightness") is not None:
        img = img * params["brightness"].to(dev)[:, None, None]
        mean = img.mean(dim=(1, 2), keepdim=True)
        img = torch.clamp((img - mean) * params["contrast"].to(dev)[:, None, None] + mean, min=0.0)
    return img[..., None], lab


def augment_pair_batch(
    generator: torch.Generator,
    images: torch.Tensor,
    labels: Optional[torch.Tensor],
    crop: int = 224,
    rotation: float = 45.0,
    jitter: Optional[Tuple[float, float]] = (0.5, 1.5),
    flips: bool = True,
    valid_hw: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    geometry: str = "fused",
    packed: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``sample_augment_params`` then ``apply_augment``: the full strong
    transform, synchronised over image and label. ``valid_hw``/``offsets``
    [B, 2] (from ``DeviceDataStore``) keep the crops inside each slice's valid
    window on the padded canvas."""
    params = sample_augment_params(generator, images.shape[0], tuple(images.shape[1:]),
                                   crop=crop, rotation=rotation, jitter=jitter, flips=flips,
                                   valid_hw=valid_hw, offsets=offsets)
    return apply_augment(images, labels, params, crop=crop, rotation=rotation,
                         geometry=geometry, packed=packed)
