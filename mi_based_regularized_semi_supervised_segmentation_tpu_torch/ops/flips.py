"""Per-sample random flips: the pairing of the twin views.

Counterpart of the JAX package's ``ops/flips.py``. One [B, 2] mask is drawn
per step and the same flips are applied to images, logits and decoder
features. Layout [B, H, W, ...]: mask[:, 0] flips H (axis 1), mask[:, 1]
flips W (axis 2). The JAX package applies float flips as permutation
matmuls; that is the same function as ``torch.flip``.
"""

from __future__ import annotations

import torch


def sample_flip_mask(generator: torch.Generator, batch: int,
                     threshold: float = 0.8) -> torch.Tensor:
    """[B, 2] booleans, each True with probability ``threshold``, drawn on
    the generator's device."""
    return torch.rand((batch, 2), generator=generator, device=generator.device) < threshold


def apply_flips(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if x.dim() < 3 or tuple(mask.shape) != (x.shape[0], 2):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit x {tuple(x.shape)}")
    view = (-1,) + (1,) * (x.dim() - 1)
    mask = mask.to(x.device)
    x = torch.where(mask[:, 0].view(view), x.flip(1), x)
    return torch.where(mask[:, 1].view(view), x.flip(2), x)
