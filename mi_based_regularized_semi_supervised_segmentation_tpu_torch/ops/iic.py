"""Global IIC mutual-information loss over [B, K] simplex rows.

Counterpart of the JAX package's ``ops/iic.py``: the K x K joint is one fp32
matmul, symmetrized and normalized; the loss is the negative MI.

Pad-and-mask and data parallelism: ``mask`` [B] zeroes the pad rows before
the product (detached), and ``group`` sums the raw product over the ranks
of a process group before it is symmetrized and normalized, so every rank
holds the joint of the global batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import all_reduce_sum


def compute_joint(x_out: torch.Tensor, x_tf_out: torch.Tensor, symmetric: bool = True,
                  mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    if x_out.dim() != 2 or x_out.shape != x_tf_out.shape:
        raise ValueError(f"expected two equal [B, K] shapes, got {x_out.shape}, {x_tf_out.shape}")
    x_out, x_tf_out = x_out.float(), x_tf_out.float()
    if mask is not None:
        m = mask.detach().float()[:, None]
        x_out, x_tf_out = x_out * m, x_tf_out * m
    p = all_reduce_sum(x_out.T @ x_tf_out, group)
    if symmetric:
        p = (p + p.T) / 2.0
    return p / p.sum()


def iid_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamb: float = 1.0,
             mask: Optional[torch.Tensor] = None,
             group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, loss_no_lamb, joint); loss = -sum P (log P - lamb log Pi - lamb log Pj)."""
    p_i_j = compute_joint(x_out, x_tf_out, mask=mask, group=group)
    p_i = p_i_j.sum(1, keepdim=True).expand_as(p_i_j)
    p_j = p_i_j.sum(0, keepdim=True).expand_as(p_i_j)
    log_p = torch.log(p_i_j + 1e-10)
    log_pi = torch.log(p_i + 1e-10)
    log_pj = torch.log(p_j + 1e-10)
    loss = -(p_i_j * (log_p - lamb * log_pj - lamb * log_pi)).sum()
    loss_no_lamb = -(p_i_j * (log_p - log_pj - log_pi)).sum()
    return loss, loss_no_lamb, p_i_j
