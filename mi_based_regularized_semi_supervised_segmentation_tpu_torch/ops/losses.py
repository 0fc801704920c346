"""Loss functions on [..., C] tensors (class axis last, as in the JAX package).

Counterpart of the JAX package's ``ops/losses.py``: ``kl_div`` (with a one-hot
target it is the supervised cross-entropy, with a softmax target the UDA
``kl`` criterion), ``entropy`` (the ``entropy`` trainer's term) and
``mse_consistency`` (the UDA ``mse`` criterion between two softmax maps). The
other losses there wait for the pretrain slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")


def kl_div(prob: torch.Tensor, target: torch.Tensor, weight: Optional[torch.Tensor] = None,
           reduction: str = "mean", eps: float = 1e-16) -> torch.Tensor:
    """KL(target || prob) summed over the last axis; the target is detached.
    ``weight``: per-class weights, normalized to mean 1."""
    prob = prob.float()
    target = target.detach().float()
    kl = -target * torch.log((prob + eps) / (target + eps))
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=torch.float32, device=prob.device)
        kl = kl * (weight / weight.sum() * weight.shape[0])
    return _reduce(kl.sum(-1), reduction)


def entropy(prob: torch.Tensor, reduction: str = "mean", eps: float = 1e-16) -> torch.Tensor:
    """-sum_c p log(p + eps) over the last axis."""
    return _reduce(-(prob * torch.log(prob + eps)).sum(-1), reduction)


def mse_consistency(pred_probs: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two softmax maps; the target is detached."""
    diff = pred_probs.float() - target_probs.detach().float()
    return (diff * diff).mean()
