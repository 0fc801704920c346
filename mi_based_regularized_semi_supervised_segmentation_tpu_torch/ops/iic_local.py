"""Local (spatially displaced) IIC segmentation MI loss.

Counterpart of the JAX package's ``ops/iic_local.py``:

  J[dy, dx, k1, k2] = sum_{b,y,x} x[b, y+dy-p, x+dx-p, k1] * x_tf[b, y, x, k2]

with zero contribution outside the image, then per-displacement
normalization, symmetrization and the negative MI (``mi_from_joint``).

Backends of ``iid_segmentation_small_patch_loss_flat``:
  auto          the CUDA kernel (bf16 operands, fp32 sums) for CUDA tensors,
                its plain version (same rounding) for CPU tensors
  plain         fp32 per-displacement products (``displaced_joint_plain``),
                the parity path
  pallas_fused  the softmax-in-kernel opt-in: not ported yet (ROADMAP.md)
The multi-tile path (patch smaller than the map) is not ported yet either.
"""

from __future__ import annotations

import torch

from .mi_joint import displaced_joint

_ROADMAP = "see ROADMAP.md, which lists what the port still lacks"


def displaced_joint_plain(x: torch.Tensor, x_tf: torch.Tensor, padding: int) -> torch.Tensor:
    """[B, H, W, K] x2 -> [T, T, K, K] raw displaced sums, fp32, one product
    of two shifted slices per displacement (``displaced_joint_xla``)."""
    if x.dim() != 4 or x.shape != x_tf.shape:
        raise ValueError(f"expected two equal [B, H, W, K] shapes, got {x.shape}, {x_tf.shape}")
    _, h, w, _ = x.shape
    p = padding
    x, x_tf = x.float(), x_tf.float()
    rows = []
    for dy in range(-p, p + 1):
        y0, y1 = max(0, -dy), min(h, h - dy)
        cols = []
        for dx in range(-p, p + 1):
            x0, x1 = max(0, -dx), min(w, w - dx)
            a = x[:, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
            b = x_tf[:, y0:y1, x0:x1]
            cols.append(torch.einsum("bhwk,bhwl->kl", a, b))
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def mi_from_joint(joint: torch.Tensor, lamb: float = 1.0) -> torch.Tensor:
    """[T, T, K, K] raw sums -> negative MI averaged over displacements.
    Global min subtraction (detached), per-displacement normalization over
    both cluster axes, symmetrization, then
    sum(-P * (log P - lamb log Pi - lamb log Pj)) / T^2."""
    t = joint.shape[0]
    p = joint - joint.min().detach() + 1e-16
    p = p / p.sum(dim=(2, 3), keepdim=True)
    p = (p + p.transpose(2, 3)) / 2.0
    p_i = p.sum(2, keepdim=True).expand_as(p)
    p_j = p.sum(3, keepdim=True).expand_as(p)
    loss = -p * (torch.log(p + 1e-16) - lamb * torch.log(p_i + 1e-16)
                 - lamb * torch.log(p_j + 1e-16))
    return loss.sum() / (t * t)


def _block_diagonal_subheads(flat_joint: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """[T, T, S*K, S*K] -> per-subhead diagonal blocks [T, T, S, K, K]."""
    t = flat_joint.shape[0]
    r = flat_joint.reshape(t, t, s, k, s, k)
    return torch.stack([r[:, :, i, :, i, :] for i in range(s)], dim=2)


def iid_segmentation_small_patch_loss_flat(
    x_out: torch.Tensor,
    x_tf_out: torch.Tensor,
    S: int,
    K: int,
    padding: int,
    patch_size: int,
    lamb: float = 1.0,
    backend: str = "auto",
    pre_padded: bool = False,
) -> torch.Tensor:
    """Subhead-mean displaced-MI loss over flat [B, H, W, C] maps, C >= S*K
    (trailing lanes dead). Covers the single-tile case (patch_size at least
    the map's interior), which is the headline config's patch_sizes=1024."""
    _, h, w, c = x_out.shape
    if c < S * K:
        raise ValueError(f"{c} lanes cannot hold {S} x {K} clusters")
    if backend == "pallas_fused":
        raise NotImplementedError(f"Kernel.backend=pallas_fused is not ported yet; {_ROADMAP}")
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown backend {backend!r}: expected 'auto' or 'plain'")
    interior_h = h - 2 * padding if pre_padded else h
    interior_w = w - 2 * padding if pre_padded else w
    if patch_size < interior_h or patch_size < interior_w:
        raise NotImplementedError(
            f"small-patch tiling (patch {patch_size} < map {interior_h}x{interior_w}) is not "
            f"ported yet; {_ROADMAP}")
    if backend == "auto":
        flat = displaced_joint(x_out, x_tf_out, padding, torch.bfloat16, pre_padded)
    else:
        if pre_padded:
            p = padding
            x_out = x_out[:, p:h - p, p:w - p]
            x_tf_out = x_tf_out[:, p:h - p, p:w - p]
        flat = displaced_joint_plain(x_out[..., :S * K], x_tf_out[..., :S * K], padding)
    joint = _block_diagonal_subheads(flat[:, :, :S * K, :S * K], S, K)
    return torch.stack([mi_from_joint(joint[:, :, i], lamb) for i in range(S)]).mean()
