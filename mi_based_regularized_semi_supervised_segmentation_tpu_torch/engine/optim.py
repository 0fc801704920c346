"""Optimizer and the reference learning-rate table (counterpart of the JAX
package's ``engine/optim.py``).

Adam with torch's coupled L2 weight decay (added to the gradient before the
moments), which is what the JAX package builds with optax. The other names of
its optimizer namespace wait.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable

import torch


def lr_at_epoch(
    epoch: int,
    base_lr: float,
    multiplier: float = 400.0,
    warmup_max: int = 10,
    max_epoch: int = 100,
    eta_min: float = 1e-7,
) -> float:
    """LR used DURING 0-based ``epoch``, matching the torch scheduler pair
    GradualWarmupScheduler(multiplier, warmup_max) over
    CosineAnnealingLR(max_epoch - warmup_max, eta_min)."""
    if epoch <= warmup_max:
        return base_lr * ((multiplier - 1.0) * epoch / warmup_max + 1.0)
    t_max = max_epoch - warmup_max
    t = epoch - warmup_max - 1  # torch handover consumes one step at peak
    peak = base_lr * multiplier
    return eta_min + (peak - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optim_config: Dict[str, Any]) -> torch.optim.Optimizer:
    """``optim_config``: the ``Optim`` config section ({name, lr, weight_decay, ...})."""
    cfg = dict(optim_config)
    name = cfg.pop("name", "Adam")
    if name != "Adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; see ROADMAP.md")
    lr = float(cfg.pop("lr", 1e-3))
    b1, b2 = float(cfg.pop("b1", 0.9)), float(cfg.pop("b2", 0.999))
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=float(cfg.pop("eps", 1e-8)),
                            weight_decay=float(cfg.pop("weight_decay", 0.0)))


def init_optimizer_state(optimizer: torch.optim.Adam) -> None:
    """Creates Adam's per-parameter state (step 0, zero moments) now, as
    torch's Adam (the one ``build_optimizer`` makes: not capturable, fused
    or amsgrad) would on its first step, so that a checkpoint of a trainer
    that has not stepped yet already holds every entry a resumed one loads
    (the JAX package's ``tx.init``)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
