"""Optimizers by name, the reference learning-rate table and the weight
schedulers (counterpart of the JAX package's ``engine/optim.py``).

``build_optimizer(params, {"name": ..., "lr": ..., ...})`` takes the JAX
package's ``Optim`` section: ``name`` defaults to ``Adam``, ``lr`` is popped,
every other key is passed as ``float(v)`` (``nesterov: true`` arrives as
1.0) and keys an optimizer does not take are dropped, as the JAX factories'
``**_`` drops them; an unknown name raises ``KeyError`` with the sorted list.

Each name computes the update of the JAX package's optax chain, not what
``torch.optim`` computes under the same name. Every optimizer keeps ``lr``
in ``param_groups`` (``set_learning_rate``, the warmup -> cosine table) and
follows torch's convention for a parameter without a gradient: it is
skipped. Weight decay is torch's coupled L2 (added to the gradient before
the scaling) except in ``AdamW``, ``Lamb`` and ``Lion``, which add it after
the scaling.

- ``Adam``, ``AdamW`` and ``SGD`` are torch's own classes: their formulas
  are optax's (``scale_by_adam``; ``scale_by_adam`` then decay; ``trace``),
  summed in another order (a few fp32 ulps apart).
- The other 15 are ``OptaxOptimizer``s that compute optax's formulas in
  optax's order, with ``torch._foreach_*`` over a group's parameters and
  the step-dependent scalars in fp32 as optax computes them:
  ``RAdam`` (rectified at rho >= 5), ``NAdam`` (``scale_by_adam(nesterov)``,
  no momentum-decay schedule), ``Adadelta``, ``Adagrad`` (``scale_by_rss``:
  rsqrt(sum + eps) where the sum is positive, 0 elsewhere), ``Adamax``,
  ``RMSprop`` (eps inside the square root; ``centered``: ``scale_by_stddev``;
  momentum a trace after the scaling), ``Rprop`` (``scale_by_rprop`` at step
  size 1, times lr: each step applies the previous step's sign update, so
  the first update is zero), ``AdaBound`` (the JAX package's own transform:
  its band does not scale with lr), ``AdaBelief``, ``Yogi`` (accumulators
  start at 1e-6), ``NovoGrad`` (one second moment a tensor), ``Lamb``
  (optax's trust ratio: 1 where either norm is 0), ``Lion``, ``Lookahead``
  and ``Ranger`` (optax's ``lookahead`` over the JAX package's Adam,
  period 5, or RAdam, period 6, slow step 0.5: the model's parameters are
  the fast weights, the slow ones live in the optimizer's state).

For a CUDA graph (``build_optimizer(..., graph=True)``, which the semi
trainer passes where it captures its step): ``Adam``, ``AdamW`` and ``SGD``
keep ``lr`` as a 0-d fp32 tensor on the parameters' device, which
``set_learning_rate`` fills in place, so a captured step reads each epoch's
rate; on a card ``Adam`` / ``AdamW`` are built ``capturable`` (step counts
and bias corrections on the device) and ``SGD`` ``fused`` (torch's foreach
SGD reads a tensor lr on the host). The ``OptaxOptimizer``s compute their
step-dependent scalars from a host count, so a step with one stays eager
(``capture_unmet``). A checkpoint holds ``lr`` as a float either way
(``optimizer_state_dict`` / ``load_optimizer_state``).

The JAX trainers cannot step ``Lookahead`` / ``Ranger`` (``optax.lookahead``
needs ``LookaheadParams``); the port's trainers refuse them too
(``engine/trainer.py:check_optimizer``).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

Tensors = List[torch.Tensor]


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


# --- step-dependent scalars, in fp32 as optax computes them ----------------
_f32 = np.float32


def _pow(decay: float, t: int) -> np.float32:
    return _f32(decay) ** _f32(t)


def _bias(decay: float, t: int) -> float:
    """``1 - decay ** t`` (optax's ``bias_correction``)."""
    return float(_f32(1) - _pow(decay, t))


# --- moments, in optax's order ----------------------------------------------
def _moment(moments: Tensors, grads: Tensors, decay: float, order: int) -> None:
    """moments <- (1 - decay) * g ** order + decay * moments, in place."""
    g = torch._foreach_mul(grads, grads) if order == 2 else grads
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, torch._foreach_mul(g, 1 - decay))


def _decayed(grads: Tensors, params: Tensors, weight_decay: float) -> Tensors:
    """g + weight_decay * p (``add_decayed_weights``)."""
    if not weight_decay:
        return grads
    return torch._foreach_add(grads, torch._foreach_mul(params, weight_decay))


class OptaxOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` whose step is an optax chain ending in
    ``scale_by_learning_rate``. A subclass names its hyperparameters and
    their JAX defaults in ``hyper``, its per-parameter state in ``_init``
    and the chain's update (lr included) in ``_updates``. The state exists
    from construction (optax's ``tx.init``); ``state[p]["step"]`` is the
    chain's count, a CPU scalar as in torch's own optimizers."""

    hyper: Dict[str, float] = {}

    def __init__(self, params, lr: float, **hyper: float) -> None:
        super().__init__(params, dict(self.hyper, lr=float(lr), **hyper))
        self.init_state()

    def init_state(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p]["step"] = torch.tensor(0.0, dtype=torch.float32)
                    self.state[p].update(self._init(p, group))

    def _init(self, p: torch.Tensor, group: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {}

    def _updates(self, group: Dict[str, Any], params: Tensors, grads: Tensors,
                 states: List[Dict[str, torch.Tensor]], t: int) -> Tensors:
        raise NotImplementedError

    def _scaled(self, group: Dict[str, Any], directions: Tensors) -> Tensors:
        """-lr * directions (``scale_by_learning_rate``)."""
        return torch._foreach_mul(directions, -group["lr"])

    @torch.no_grad()
    def step(self, closure: Callable[[], float] | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.init_state()
        for group in self.param_groups:
            by_count = defaultdict(list)  # parameters at the same count step together
            for p in group["params"]:
                if p.grad is not None:
                    by_count[int(self.state[p]["step"])].append(p)
            for count, params in by_count.items():
                states = [self.state[p] for p in params]
                for s in states:
                    s["step"] += 1
                updates = self._updates(group, params, [p.grad for p in params], states,
                                        count + 1)
                torch._foreach_add_(params, updates)
        return loss


def _zeros(*names: str):
    return lambda self, p, group: {n: torch.zeros_like(p) for n in names}


def _take(states, name: str) -> Tensors:
    return [s[name] for s in states]


def _adam_directions(group, params, grads, states, t, weight_decay: float,
                     nesterov: bool = False) -> Tensors:
    """``add_decayed_weights`` (coupled) + ``scale_by_adam``."""
    b1, b2, eps = group["b1"], group["b2"], group["eps"]
    g = _decayed(grads, params, weight_decay)
    mu, nu = _take(states, "mu"), _take(states, "nu")
    _moment(mu, g, b1, 1)
    _moment(nu, g, b2, 2)
    if nesterov:
        mu_hat = torch._foreach_mul(torch._foreach_div(mu, _bias(b1, t + 1)), b1)
        torch._foreach_add_(mu_hat, torch._foreach_mul(torch._foreach_div(g, _bias(b1, t)),
                                                       1 - b1))
    else:
        mu_hat = torch._foreach_div(mu, _bias(b1, t))
    denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias(b2, t)))
    torch._foreach_add_(denom, eps)
    return torch._foreach_div(mu_hat, denom)


class OptaxAdam(OptaxOptimizer):
    """optax's Adam chain in optax's order (``nesterov``: NAdam): the inner
    optimizer of ``Lookahead``."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    nesterov = False
    _init = _zeros("mu", "nu")

    def _updates(self, group, params, grads, states, t):
        return self._scaled(group, _adam_directions(group, params, grads, states, t,
                                                    group["weight_decay"], self.nesterov))


class NAdam(OptaxAdam):
    nesterov = True


class RAdam(OptaxOptimizer):
    """``scale_by_radam``: Adam rectified where rho_t >= 5, the bias-corrected
    first moment elsewhere."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    _init = _zeros("mu", "nu")
    threshold = 5.0

    def _updates(self, group, params, grads, states, t):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        _moment(nu, g, b2, 2)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _pow(b2, t)
        ro = _f32(ro_inf) - _f32(2 * t) * b2t / (_f32(1) - b2t)
        mu_hat = torch._foreach_div(mu, _bias(b1, t))
        if ro < self.threshold:
            return self._scaled(group, mu_hat)
        r = np.sqrt((ro - _f32(4)) * (ro - _f32(2)) * _f32(ro_inf)
                    / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias(b2, t)))
        torch._foreach_add_(denom, eps)
        return self._scaled(group, torch._foreach_div(torch._foreach_mul(mu_hat, float(r)), denom))


class Adadelta(OptaxOptimizer):
    hyper = dict(weight_decay=0.0, rho=0.9, eps=1e-6)
    _init = _zeros("e_g", "e_x")

    def _updates(self, group, params, grads, states, t):
        rho, eps = group["rho"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        e_g, e_x = _take(states, "e_g"), _take(states, "e_x")
        _moment(e_g, g, rho, 2)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        upd = torch._foreach_mul(torch._foreach_div(num, den), g)
        _moment(e_x, upd, rho, 2)
        return self._scaled(group, upd)


class Adagrad(OptaxOptimizer):
    """``scale_by_rss``: g * rsqrt(sum + eps) where the sum of squares is
    positive, 0 elsewhere."""

    hyper = dict(weight_decay=0.0, eps=1e-10, initial_accumulator_value=0.0)

    def _init(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def _updates(self, group, params, grads, states, t):
        g = _decayed(grads, params, group["weight_decay"])
        sums = _take(states, "sum_of_squares")
        torch._foreach_add_(sums, torch._foreach_mul(g, g))
        scale = [torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) for s in sums]
        return self._scaled(group, torch._foreach_mul(scale, g))


class Adamax(OptaxOptimizer):
    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    _init = _zeros("mu", "nu")

    def _updates(self, group, params, grads, states, t):
        b1, b2 = group["b1"], group["b2"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, torch._foreach_add(torch._foreach_abs(g), group["eps"]))
        return self._scaled(group, torch._foreach_div(torch._foreach_div(mu, _bias(b1, t)), nu))


class RMSprop(OptaxOptimizer):
    """``scale_by_rms`` (eps inside the square root) or, ``centered``,
    ``scale_by_stddev``; ``momentum``: a trace of the scaled updates."""

    hyper = dict(weight_decay=0.0, alpha=0.99, eps=1e-8, momentum=0.0, centered=0.0)

    def _init(self, p, group):
        names = ["nu"] + ["mu"] * bool(group["centered"]) + ["trace"] * bool(group["momentum"])
        return {n: torch.zeros_like(p) for n in names}

    def _updates(self, group, params, grads, states, t):
        alpha = group["alpha"]
        g = _decayed(grads, params, group["weight_decay"])
        nu = _take(states, "nu")
        _moment(nu, g, alpha, 2)
        if group["centered"]:
            mu = _take(states, "mu")
            _moment(mu, g, alpha, 1)
            var = torch._foreach_sub(nu, torch._foreach_mul(mu, mu))
        else:
            var = nu
        upd = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(var, group["eps"])), g)
        if group["momentum"]:
            trace = _take(states, "trace")
            torch._foreach_mul_(trace, group["momentum"])
            torch._foreach_add_(trace, upd)
            upd = trace
        return self._scaled(group, upd)


class Rprop(OptaxOptimizer):
    """``scale_by_rprop(learning_rate=1.0)`` times lr: the step sizes grow by
    eta_plus where the gradient keeps the sign of the previous sign update,
    shrink by eta_minus where it flips (within [1e-6, 50]); the update
    applied is the previous step's sign update (zero where the sign flipped),
    so the first one is zero."""

    hyper = dict(weight_decay=0.0, eta_minus=0.5, eta_plus=1.2)
    min_step, max_step = 1e-6, 50.0

    def _init(self, p, group):
        return {"step_sizes": torch.ones_like(p), "prev_updates": torch.zeros_like(p)}

    def _updates(self, group, params, grads, states, t):
        g = _decayed(grads, params, group["weight_decay"])
        out = []
        for grad, s in zip(g, states):
            sign = grad * s["prev_updates"]
            grown = torch.where(sign > 0, group["eta_plus"], group["eta_minus"])
            steps = torch.where(sign == 0, s["step_sizes"],
                                (s["step_sizes"] * grown).clamp(self.min_step, self.max_step))
            applied = torch.where(sign < 0, 0.0, s["prev_updates"])
            s["step_sizes"].copy_(steps)
            s["prev_updates"].copy_(torch.where(sign < 0, 0.0, steps * torch.sign(grad)))
            out.append(applied)
        return self._scaled(group, out)


class AdaBound(OptaxOptimizer):
    """The JAX package's AdaBound: Adam whose per-element step
    lr * sqrt(bc2) / bc1 / (sqrt(nu) + eps) is clipped to a band around
    ``final_lr`` that narrows as the count grows (the band does not scale
    with lr)."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, final_lr=0.1, gamma=1e-3)
    _init = _zeros("mu", "nu")

    def _updates(self, group, params, grads, states, t):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        _moment(nu, g, b2, 2)
        tf, lr = _f32(t), _f32(group["lr"])
        step_size = lr * np.sqrt(_f32(_bias(b2, t))) / _f32(_bias(b1, t))
        final, gamma = _f32(group["final_lr"]), _f32(group["gamma"])
        lower = float(final * (_f32(1) - _f32(1) / (gamma * tf + _f32(1))))
        upper = float(final * (_f32(1) + _f32(1) / (gamma * tf)))
        denom = torch._foreach_add(torch._foreach_sqrt(nu), eps)
        eff = torch._foreach_div([torch.full_like(d, float(step_size)) for d in denom], denom)
        torch._foreach_clamp_min_(eff, lower)
        torch._foreach_clamp_max_(eff, upper)
        return torch._foreach_mul(torch._foreach_neg(eff), mu)


class AdaBelief(OptaxOptimizer):
    """``scale_by_belief``: the second moment of g - mu, plus eps_root 1e-16
    each step."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-16)
    eps_root = 1e-16
    _init = _zeros("mu", "nu")

    def _updates(self, group, params, grads, states, t):
        b1, b2 = group["b1"], group["b2"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        _moment(nu, torch._foreach_sub(g, mu), b2, 2)
        torch._foreach_add_(nu, self.eps_root)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias(b2, t)))
        torch._foreach_add_(denom, group["eps"])
        return self._scaled(group, torch._foreach_div(torch._foreach_div(mu, _bias(b1, t)),
                                                      denom))


class Yogi(OptaxOptimizer):
    """``scale_by_yogi``: both accumulators start at 1e-6."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-3)
    initial_accumulator_value = 1e-6

    def _init(self, p, group):
        return {n: torch.full_like(p, self.initial_accumulator_value) for n in ("mu", "nu")}

    def _updates(self, group, params, grads, states, t):
        b1, b2 = group["b1"], group["b2"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        g2 = torch._foreach_mul(g, g)
        sign = torch._foreach_sign(torch._foreach_sub(nu, g2))
        torch._foreach_sub_(nu, torch._foreach_mul(torch._foreach_mul(sign, 1 - b2), g2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias(b2, t)))
        torch._foreach_add_(denom, group["eps"])
        return self._scaled(group, torch._foreach_div(torch._foreach_div(mu, _bias(b1, t)),
                                                      denom))


class NovoGrad(OptaxOptimizer):
    """``scale_by_novograd``: one second moment a tensor (its squared norm's
    average), the first moment of the normalized gradient."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.25, eps=1e-8)

    def _init(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def _updates(self, group, params, grads, states, t):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        nu = _take(states, "nu")
        sq = [n * n for n in torch._foreach_norm(g)]
        if t == 1:
            torch._foreach_copy_(nu, sq)
        else:
            _moment(nu, sq, b2, 1)
        added = torch._foreach_div(g, torch._foreach_add(torch._foreach_sqrt(nu), eps))
        mu = _take(states, "mu")
        if t == 1:
            torch._foreach_copy_(mu, added)
        else:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, added)
        return self._scaled(group, mu)


class Lamb(OptaxOptimizer):
    """``scale_by_adam`` (eps 1e-6), then the decay, then optax's trust ratio
    ||p|| / ||u|| per tensor (1 where either norm is 0)."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-6)
    _init = _zeros("mu", "nu")

    def _updates(self, group, params, grads, states, t):
        upd = _adam_directions(group, params, grads, states, t, weight_decay=0.0)
        if group["weight_decay"]:
            upd = _decayed(upd, params, group["weight_decay"])
        p_norm, u_norm = torch._foreach_norm(params), torch._foreach_norm(upd)
        ratio = [torch.where((pn == 0) | (un == 0), 1.0, pn / un) for pn, un in zip(p_norm, u_norm)]
        return self._scaled(group, torch._foreach_mul(upd, ratio))


class Lion(OptaxOptimizer):
    """``scale_by_lion``: sign((1 - b1) g + b1 mu), mu <- (1 - b2) g + b2 mu;
    then the decay."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.99)
    _init = _zeros("mu")

    def _updates(self, group, params, grads, states, t):
        b1, b2 = group["b1"], group["b2"]
        mu = _take(states, "mu")
        mix = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu, b1))
        upd = torch._foreach_sign(mix)
        _moment(mu, grads, b2, 1)
        if group["weight_decay"]:
            upd = _decayed(upd, params, group["weight_decay"])
        return self._scaled(group, upd)


class _Lookahead(OptaxOptimizer):
    """optax's ``lookahead`` over the next class in the MRO (the inner
    optimizer): the parameters are the fast weights; every ``sync_period``
    steps the slow weights (``slow`` in the state) move ``slow_step`` of the
    way to the fast ones, and the fast ones take their place."""

    sync_period, slow_step = 5, 0.5

    def _init(self, p, group):
        return {**super()._init(p, group), "slow": p.detach().clone()}

    def _updates(self, group, params, grads, states, t):
        fast = super()._updates(group, params, grads, states, t)
        if t % self.sync_period:
            return fast
        # optax: diff = f + u - s; f += u - (1 - a) diff; s += a diff
        slow = _take(states, "slow")
        diff = torch._foreach_sub(torch._foreach_add(params, fast), slow)
        torch._foreach_sub_(fast, torch._foreach_mul(diff, 1 - self.slow_step))
        torch._foreach_add_(slow, torch._foreach_mul(diff, self.slow_step))
        return fast


class Lookahead(_Lookahead, OptaxAdam):
    sync_period = 5


class Ranger(_Lookahead, RAdam):
    sync_period = 6


def _graph_lr(params, lr: float, graph: bool):
    """(lr as the optimizer keeps it, whether the parameters are on a card):
    for a graph a 0-d fp32 tensor on the parameters' device."""
    device = params[0].device if params else torch.device("cpu")
    if graph:
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
    return lr, graph and device.type == "cuda"


def _torch_adam(params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, graph=False, **_):
    lr, card = _graph_lr(params, lr, graph)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                            capturable=card)


def _torch_adamw(params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, graph=False, **_):
    lr, card = _graph_lr(params, lr, graph)
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                             capturable=card)


def _torch_sgd(params, lr, momentum=0.0, weight_decay=0.0, nesterov=0.0, graph=False, **_):
    lr, card = _graph_lr(params, lr, graph)
    # optax's trace is skipped without momentum, nesterov with it
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=bool(nesterov) and bool(momentum), fused=card or None)


def _ours(cls):
    def factory(params, lr, **kw):
        return cls(params, lr, **{k: v for k, v in kw.items() if k in cls.hyper})
    return factory


# The JAX package's OPTIMIZERS names. Its configs use SGD, Adam, AdamW,
# RAdam and AdaBound.
OPTIMIZERS: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "Adam": _torch_adam,
    "AdamW": _torch_adamw,
    "SGD": _torch_sgd,
    **{cls.__name__: _ours(cls) for cls in (
        RAdam, NAdam, Adadelta, Adagrad, Adamax, RMSprop, Rprop, AdaBound, AdaBelief, Yogi,
        NovoGrad, Lamb, Lion, Lookahead, Ranger)},
}
# names the trainers refuse: optax.lookahead needs LookaheadParams, which the
# JAX trainers' flat parameter tree is not
LOOKAHEAD_NAMES = ("Lookahead", "Ranger")


# the names whose step a CUDA graph can capture (torch's own classes), and
# why the others' cannot
GRAPH_OPTIMIZERS = ("Adam", "AdamW", "SGD")
EAGER_OPTAX = "the optax chains compute their step-dependent scalars from a host step count"


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_config: Dict[str, Any],
                    graph: bool = False) -> torch.optim.Optimizer:
    """``optim_config``: the ``Optim`` config section ({name, lr,
    weight_decay, ...}); see the module docstring. ``graph``: build one of
    ``GRAPH_OPTIMIZERS`` for a CUDA graph."""
    cfg = dict(optim_config)
    name = cfg.pop("name", "Adam")
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: {sorted(OPTIMIZERS)}")
    if graph and name not in GRAPH_OPTIMIZERS:
        raise ValueError(f"Optim.name={name} cannot be built for a CUDA graph: {EAGER_OPTAX}")
    lr = float(cfg.pop("lr", 1e-3))
    kw = {k: float(v) for k, v in cfg.items()}
    if graph:
        kw["graph"] = True
    return OPTIMIZERS[name](list(params), lr, **kw)


def capture_unmet(optimizer: Union[torch.optim.Optimizer, str]) -> Optional[str]:
    """None when a CUDA graph can capture ``optimizer.step()``, else why
    not; ``optimizer`` may be its ``Optim.name``, before it is built."""
    if isinstance(optimizer, OptaxOptimizer):
        return f"Optim.name={type(optimizer).__name__}: {EAGER_OPTAX}"
    if isinstance(optimizer, str):
        return None if optimizer in GRAPH_OPTIMIZERS else f"Optim.name={optimizer}: {EAGER_OPTAX}"
    groups = optimizer.param_groups
    if not all(isinstance(g["lr"], torch.Tensor) for g in groups):
        return "the optimizer's lr is a Python float (build_optimizer(..., graph=True))"
    if isinstance(optimizer, torch.optim.Adam):  # AdamW too
        ok = all(g["capturable"] for g in groups)
    else:
        ok = isinstance(optimizer, torch.optim.SGD) and all(g["fused"] for g in groups)
    if not ok:
        return (f"{type(optimizer).__name__} is not built for a CUDA graph (Adam / AdamW "
                "capturable, SGD fused)")
    return None


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Creates every parameter's state now (optax's ``tx.init``), so that a
    checkpoint of a trainer that has not stepped yet already holds every
    entry a resumed one loads. torch's Adam / AdamW (not fused or amsgrad)
    get step 0 and zero moments, its SGD a zero momentum buffer
    (its first step then gives the lazy buffer's value, g); an
    ``OptaxOptimizer`` made its state when it was built. A ``capturable``
    Adam's step count lies on the parameter's device, as torch makes it."""
    if isinstance(optimizer, OptaxOptimizer):
        optimizer.init_state()
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            if isinstance(optimizer, torch.optim.Adam):  # AdamW too
                state["step"] = torch.zeros((), dtype=torch.float32,
                                            device=p.device if group["capturable"] else None)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            elif isinstance(optimizer, torch.optim.SGD):
                if group["momentum"] != 0:
                    state["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            else:
                raise TypeError(f"no initial state for {type(optimizer).__name__}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's lr; a tensor lr (``graph``) is filled in place, where a
    captured step reads it."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


_GRAPH_KEYS = ("capturable", "fused")


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with each group's lr as a float, so that a
    checkpoint reads alike from a card's graph-built optimizer and the
    CPU's."""
    state = optimizer.state_dict()
    state["param_groups"] = [{**g, "lr": float(g["lr"])} for g in state["param_groups"]]
    return state


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(state)`` into the optimizer's own tensors:
    each state tensor, and a tensor lr, is filled in place, so a captured
    step goes on reading it; ``capturable`` / ``fused`` stay as built."""
    groups = [{k: g[k] for k in ("lr",) + _GRAPH_KEYS if k in g} for g in optimizer.param_groups]
    own = {p: dict(st) for p, st in optimizer.state.items()}
    optimizer.load_state_dict(state)
    for group, kept in zip(optimizer.param_groups, groups):
        lr = float(group["lr"])
        group.update(kept)
        if isinstance(kept["lr"], torch.Tensor):
            kept["lr"].fill_(lr)
        else:
            group["lr"] = lr
    for p, st in optimizer.state.items():
        for key, value in st.items():
            mine = own.get(p, {}).get(key)
            if isinstance(mine, torch.Tensor) and isinstance(value, torch.Tensor) \
                    and mine.shape == value.shape:
                st[key] = mine.copy_(value)


class RampScheduler:
    """Linear loss-weight ramp between epochs (the JAX package's copy of the
    reference's shipped but unused ``RampScheduler``)."""

    def __init__(self, begin_epoch: int, max_epoch: int, min_value: float,
                 max_value: float, ramp_mult: float = -5.0) -> None:
        self.begin_epoch = int(begin_epoch)
        self.max_epoch = int(max_epoch)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.mult = float(ramp_mult)
        self.epoch = 0

    def step(self) -> None:
        self.epoch += 1

    @property
    def value(self) -> float:
        return self.get_lr(self.epoch)

    def get_lr(self, epoch: int) -> float:
        if epoch < self.begin_epoch:
            return self.min_value
        if epoch >= self.max_epoch:
            return self.max_value
        frac = (epoch - self.begin_epoch) / max(self.max_epoch - self.begin_epoch, 1)
        ramp = math.exp(self.mult * (1.0 - frac) ** 2)
        return self.min_value + (self.max_value - self.min_value) * ramp


class ConstantScheduler:
    def __init__(self, begin_epoch: int = 0, value: float = 1.0) -> None:
        self.begin_epoch = int(begin_epoch)
        self._value = float(value)
        self.epoch = 0

    def step(self) -> None:
        self.epoch += 1

    @property
    def value(self) -> float:
        return self._value if self.epoch >= self.begin_epoch else 0.0
