"""Loss functions on [..., C] tensors (class axis last, as in the JAX package).

Counterpart of the JAX package's ``ops/losses.py``: ``kl_div`` (with a one-hot
target it is the supervised cross-entropy, with a softmax target the UDA
``kl`` criterion), ``entropy`` (the ``entropy`` trainer's term) and
``mse_consistency`` (the UDA ``mse`` criterion between two softmax maps),
``simplex_cross_entropy``, ``jsd_div`` and ``supcon_loss`` (the supervised
contrastive loss of the pretrain pipeline, ``engine/pretrain.py``).
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


def simplex_cross_entropy(prob: torch.Tensor, target: torch.Tensor, reduction: str = "mean",
                          eps: float = 1e-16) -> torch.Tensor:
    """-sum_c t log(p + eps) over the last axis; the target is detached."""
    return _reduce((-target.detach() * torch.log(prob + eps)).sum(-1), reduction)


def jsd_div(*probs: torch.Tensor, reduction: str = "mean", eps: float = 1e-16) -> torch.Tensor:
    """Jensen-Shannon divergence of simplexes: the entropy of their mean
    minus the mean of their entropies."""
    mean_prob = sum(probs) / len(probs)
    mean_entropy = sum(entropy(p, reduction=reduction, eps=eps) for p in probs) / len(probs)
    return entropy(mean_prob, reduction=reduction, eps=eps) - mean_entropy


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, temperature: float = 0.07,
                base_temperature: float = 0.07, contrast_mode: str = "all") -> torch.Tensor:
    """Supervised contrastive loss of L2-normalized ``features`` [B, n_views,
    D]: samples with equal ``labels`` [B] (or ``mask`` [B, B] > 0) are
    positives; with neither it is SimCLR (each sample's own views).
    ``contrast_mode``: ``all`` anchors every view, ``one`` the first. At the
    JAX function's rounding points: the row max subtracted under no gradient,
    self-contrast masked by ``1 - eye(n_anchor, B * n_views)``, the positive
    count clamped at 1."""
    if features.dim() != 3:
        raise ValueError(f"features must be [B, n_views, D], got {tuple(features.shape)}")
    if contrast_mode not in ("all", "one"):
        raise ValueError(f"contrast_mode={contrast_mode!r}: expected 'all' | 'one'")
    b, n_views, _ = features.shape
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both labels and mask")
    dev = features.device
    if labels is None and mask is None:
        mask = torch.eye(b, dtype=torch.float32, device=dev)
    elif labels is not None:
        labels = torch.as_tensor(labels, device=dev).reshape(-1, 1)
        mask = (labels == labels.T).float()
    else:
        mask = torch.as_tensor(mask, device=dev).float()
    contrast = torch.cat(features.unbind(1))  # [B * V, D], view-major
    anchor, anchor_count = (features[:, 0], 1) if contrast_mode == "one" else (contrast, n_views)
    logits = anchor @ contrast.T / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    n_anchor = anchor_count * b
    logits_mask = 1.0 - torch.eye(n_anchor, b * n_views, device=dev)
    mask = mask.repeat(anchor_count, n_views) * logits_mask
    log_prob = logits - torch.log((torch.exp(logits) * logits_mask).sum(1, keepdim=True))
    pos_count = mask.sum(1).clamp_min(1.0)
    mean_log_prob_pos = (mask * log_prob).sum(1) / pos_count
    return (-(temperature / base_temperature) * mean_log_prob_pos).mean()
