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

from ..parallel.mesh import DistContext, all_gather_rows, gather_rows


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
                base_temperature: float = 0.07, contrast_mode: str = "all",
                row_mask: Optional[torch.Tensor] = None,
                context: Optional[DistContext] = None, blocks: int = 1) -> torch.Tensor:
    """Supervised contrastive loss of L2-normalized ``features`` [B, n_views,
    D]: samples with equal ``labels`` [B] (or ``mask`` [B, B] > 0) are
    positives; with neither it is SimCLR (each sample's own views).
    ``contrast_mode``: ``all`` anchors every view, ``one`` the first. At the
    JAX function's rounding points: the row max subtracted under no gradient,
    self-contrast masked by ``1 - eye(n_anchor, B * n_views)``, the positive
    count clamped at 1.

    Pad-and-mask and data parallelism: ``row_mask`` [B] marks the real rows
    (a pad row is no anchor, no contrast entry and no positive); under a
    ``context`` with a data group, ``features`` and ``row_mask`` hold this
    rank's rows and ``labels`` / ``mask`` the global batch's, whole. Each
    rank's anchors then meet the gathered contrast set (``all_gather_rows``),
    put in the one-process order, and the rank returns its anchors' loss sum
    over the global count of real anchors, so the ranks' losses sum to the
    one-process loss. ``blocks``: ``features`` holds this rank's rows of
    each of ``blocks`` equal blocks of the global batch, block-major (the
    decoder phase's 2 x 2 blocks, ``engine/pretrain.py:unfold_blocks``),
    which the gather puts back block-major over the global batch. Without a
    row mask or a group every row is real and the gather is the identity:
    the one-process function."""
    if features.dim() != 3:
        raise ValueError(f"features must be [B, n_views, D], got {tuple(features.shape)}")
    if contrast_mode not in ("all", "one"):
        raise ValueError(f"contrast_mode={contrast_mode!r}: expected 'all' | 'one'")
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both labels and mask")
    b, n_views, _ = features.shape
    sharded = context is not None and context.group is not None
    world, rank = (context.data_world, context.data_rank) if sharded else (1, 0)
    if b % blocks:
        raise ValueError(f"{b} rows do not split into {blocks} blocks")
    per = b // blocks  # this rank's rows of each block
    n = per * world  # the global batch's rows of each block
    total = blocks * n
    dev = features.device

    def global_order(gathered: torch.Tensor) -> torch.Tensor:
        """Rank-major gathered rows [world, blocks, per] -> block-major
        [blocks, world * per], the one-process order."""
        if blocks == 1 or world == 1:
            return gathered
        return gathered.reshape((world, blocks, per) + tuple(gathered.shape[1:])).transpose(
            0, 1).reshape((total,) + tuple(gathered.shape[1:]))

    ones = torch.ones(b, dtype=torch.float32, device=dev)
    valid_local = ones if row_mask is None else row_mask.detach().to(torch.float32)
    valid = global_order(gather_rows(valid_local, context))
    # this rank's rows in the global order
    idx = (torch.arange(blocks, device=dev)[:, None] * n + rank * per
           + torch.arange(per, device=dev)[None]).reshape(-1)
    if labels is None and mask is None:
        base = torch.eye(total, dtype=torch.float32, device=dev)[idx]
    elif labels is not None:
        labels = torch.as_tensor(labels, device=dev).reshape(-1)
        if labels.numel() != total:
            raise ValueError(f"{labels.numel()} labels for a global batch of {total}")
        base = (labels[idx][:, None] == labels[None]).float()
    else:
        base = torch.as_tensor(mask, device=dev).float()[idx]
    gathered = global_order(all_gather_rows(features, context))
    contrast = torch.cat(gathered.unbind(1))  # [total * V, D], view-major
    anchor_count = 1 if contrast_mode == "one" else n_views
    anchor = features[:, 0] if contrast_mode == "one" else torch.cat(features.unbind(1))
    logits = anchor @ contrast.T / temperature
    col_valid = valid.repeat(n_views)
    # the row max over the real entries (the one-process batch's), self included
    row_max = logits.masked_fill(col_valid[None] == 0, float("-inf")).max(dim=1, keepdim=True)
    logits = logits - row_max.values.detach()
    n_anchor = anchor_count * b
    self_col = (torch.arange(anchor_count, device=dev)[:, None] * total + idx[None]).reshape(-1)
    logits_mask = col_valid[None].repeat(n_anchor, 1)
    logits_mask[torch.arange(n_anchor, device=dev), self_col] = 0.0
    pos = base.repeat(anchor_count, n_views) * logits_mask
    log_prob = logits - torch.log((torch.exp(logits) * logits_mask).sum(1, keepdim=True))
    pos_count = pos.sum(1).clamp_min(1.0)
    mean_log_prob_pos = (pos * log_prob).sum(1) / pos_count
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    return (per_anchor * valid_local.repeat(anchor_count)).sum() / (valid.sum() * anchor_count)
