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
trainer passes where it captures its step) every name but ``Lookahead`` /
``Ranger`` keeps ``lr`` as a 0-d fp32 tensor on the parameters' device,
which ``set_learning_rate`` fills in place, so a captured step reads each
epoch's rate. On a card ``Adam`` / ``AdamW`` are built ``capturable``
(step counts and bias corrections on the device) and ``SGD`` ``fused``
(torch's foreach SGD reads a tensor lr on the host). An ``OptaxOptimizer``
keeps one count a group on the device and computes its step's scalars
there with torch ops (``b ** t`` in float64, rounded once to fp32, as on
the CPU), its branches (RAdam's rectification, NovoGrad's first step) as
selects; built plainly it computes the same scalars on the CPU from each
parameter's count and hands them over as floats, and the two agree bit for
bit. A checkpoint holds ``lr`` as a float either way
(``optimizer_state_dict`` / ``load_optimizer_state``).

The JAX trainers cannot step ``Lookahead`` / ``Ranger`` (``optax.lookahead``
needs ``LookaheadParams``); the port's trainers refuse them too
(``engine/trainer.py:check_optimizer``), and they are not built for a graph
(``capture_unmet``).
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


# --- step-dependent scalars -------------------------------------------------
# Each is a 0-d fp32 tensor computed with torch ops from the chain's count t
# (a 0-d fp32 tensor), in optax's order: on the parameters' device for an
# optimizer built with ``graph=True``, which hands them to the _foreach_*
# ops as tensors; on the CPU otherwise, handed over as Python floats
# (``OptaxOptimizer._step_scalars``).
_f32 = np.float32


def _pow(decay: float, t: torch.Tensor) -> torch.Tensor:
    """``decay ** t`` in fp32: the fp32 decay raised in float64 and rounded
    once, so that the card and the CPU give the same value (their fp32 pows
    differ; numpy's powf is an ulp off from t = 4 at 0.9, XLA's fp32 pow
    equals this over the first hundreds of steps)."""
    return torch.pow(float(_f32(decay)), t.double()).float()


def _bias(decay: float, t: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** t`` (optax's ``bias_correction``)."""
    return torch.rsub(_pow(decay, t), 1.0)


def _select(cond: Union[bool, torch.Tensor], taken: Tensors, other: Tensors) -> Tensors:
    """``taken`` where ``cond`` else ``other``, tensor by tensor; both were
    computed, and a NaN in the one not taken reaches nothing. ``cond``: a
    Python bool (host scalars) or a 0-d bool tensor."""
    if isinstance(cond, bool):
        return taken if cond else other
    return [torch.where(cond, a, b) for a, b in zip(taken, other)]


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


Scalars = Dict[str, Any]


class OptaxOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` whose step is an optax chain ending in
    ``scale_by_learning_rate``. A subclass names its hyperparameters and
    their JAX defaults in ``hyper``, its per-parameter state in ``_init``,
    the scalars its step computes from the count in ``_scalars`` and the
    chain's update (lr included, ``_scaled``) in ``_updates``. The state
    exists from construction (optax's ``tx.init``).

    ``state[p]["step"]`` is the chain's count. Built plainly it is a CPU
    scalar of each parameter's own, as in torch's optimizers, and parameters
    at different counts step apart. With ``graph=True`` a group has one
    count on its parameters' device, as optax's chain has one, and every
    parameter's ``state[p]["step"]`` is that tensor; lr is a 0-d fp32
    tensor on the same device, and the step reads neither on the host, so a
    CUDA graph can capture it. A parameter without a gradient is skipped
    either way (under a graph, the set of the captured step)."""

    hyper: Dict[str, float] = {}

    def __init__(self, params, lr: float, graph: bool = False, **hyper: float) -> None:
        self.graph = bool(graph)
        self._counts: Dict[int, torch.Tensor] = {}  # graph: each group's count
        lr = float(lr)
        if self.graph:
            params = list(params)
            lr, _ = _graph_lr(params, lr, True)
        super().__init__(params, dict(self.hyper, lr=lr, **hyper))
        self.init_state()

    def init_state(self) -> None:
        for i, group in enumerate(self.param_groups):
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p]["step"] = self._new_count(i, p)
                    self.state[p].update(self._init(p, group))

    def _new_count(self, i: int, p: torch.Tensor) -> torch.Tensor:
        if not self.graph:
            return torch.tensor(0.0, dtype=torch.float32)
        if i not in self._counts:
            self._counts[i] = torch.zeros((), dtype=torch.float32, device=p.device)
        return self._counts[i]

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """torch's load, then the counts made this optimizer's again: plain,
        a CPU tensor for each parameter (a graph-built optimizer's checkpoint
        holds one tensor a group); graph, each group's own count, filled in
        place with the largest of its parameters' loaded counts."""
        super().load_state_dict(state_dict)
        for i, group in enumerate(self.param_groups):
            states = [self.state[p] for p in group["params"] if "step" in self.state[p]]
            if not self.graph:
                for s in states:
                    s["step"] = s["step"].detach().to("cpu", torch.float32, copy=True)
                continue
            if not states:
                continue
            count = self._new_count(i, group["params"][0])
            count.copy_(torch.stack([s["step"].to(count.device, torch.float32)
                                     for s in states]).max())
            for s in states:
                s["step"] = count

    def _init(self, p: torch.Tensor, group: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {}

    def _scalars(self, group: Dict[str, Any], t: torch.Tensor, lr: torch.Tensor) -> Scalars:
        return {}

    def _updates(self, group: Dict[str, Any], params: Tensors, grads: Tensors,
                 states: List[Dict[str, torch.Tensor]], s: Scalars) -> Tensors:
        raise NotImplementedError

    def _scaled(self, directions: Tensors, s: Scalars) -> Tensors:
        """-lr * directions (``scale_by_learning_rate``)."""
        return torch._foreach_mul(directions, s["neg_lr"])

    def _step_scalars(self, group: Dict[str, Any], t: torch.Tensor) -> Scalars:
        """The step's scalars at count ``t``: -lr and the subclass's; as
        tensors for a graph, else as Python floats and bools."""
        lr = group["lr"]
        if not isinstance(lr, torch.Tensor):
            lr = torch.tensor(lr, dtype=torch.float32)
        s = {"neg_lr": -lr, **self._scalars(group, t, lr)}
        return s if self.graph else {k: v.item() for k, v in s.items()}

    def _stepped(self, i: int, group: Dict[str, Any]):
        """(count after the step, parameters) for each set of the group's
        parameters with a gradient that steps together, the count advanced:
        graph, the group's count; else each parameter's, the parameters
        grouped by it (on the host)."""
        params = [p for p in group["params"] if p.grad is not None]
        if self.graph:
            if params:
                yield self._counts[i].add_(1), params
            return
        by_count = defaultdict(list)
        for p in params:
            by_count[int(self.state[p]["step"])].append(p)
        for count, same in by_count.items():
            for p in same:
                self.state[p]["step"] += 1
            yield torch.tensor(count + 1.0, dtype=torch.float32), same

    @torch.no_grad()
    def step(self, closure: Callable[[], float] | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.init_state()
        for i, group in enumerate(self.param_groups):
            for t, params in self._stepped(i, group):
                states = [self.state[p] for p in params]
                updates = self._updates(group, params, [p.grad for p in params], states,
                                        self._step_scalars(group, t))
                torch._foreach_add_(params, updates)
        return loss


def _zeros(*names: str):
    return lambda self, p, group: {n: torch.zeros_like(p) for n in names}


def _take(states, name: str) -> Tensors:
    return [s[name] for s in states]


def _adam_scalars(group, t, nesterov: bool = False) -> Scalars:
    s = {"bc1": _bias(group["b1"], t), "bc2": _bias(group["b2"], t)}
    if nesterov:
        s["bc1_next"] = _bias(group["b1"], t + 1)
    return s


def _adam_directions(group, params, grads, states, s, weight_decay: float,
                     nesterov: bool = False) -> Tensors:
    """``add_decayed_weights`` (coupled) + ``scale_by_adam``."""
    b1, b2, eps = group["b1"], group["b2"], group["eps"]
    g = _decayed(grads, params, weight_decay)
    mu, nu = _take(states, "mu"), _take(states, "nu")
    _moment(mu, g, b1, 1)
    _moment(nu, g, b2, 2)
    if nesterov:
        mu_hat = torch._foreach_mul(torch._foreach_div(mu, s["bc1_next"]), b1)
        torch._foreach_add_(mu_hat, torch._foreach_mul(torch._foreach_div(g, s["bc1"]), 1 - b1))
    else:
        mu_hat = torch._foreach_div(mu, s["bc1"])
    denom = torch._foreach_sqrt(torch._foreach_div(nu, s["bc2"]))
    torch._foreach_add_(denom, eps)
    return torch._foreach_div(mu_hat, denom)


class OptaxAdam(OptaxOptimizer):
    """optax's Adam chain in optax's order (``nesterov``: NAdam): the inner
    optimizer of ``Lookahead``."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    nesterov = False
    _init = _zeros("mu", "nu")

    def _scalars(self, group, t, lr):
        return _adam_scalars(group, t, self.nesterov)

    def _updates(self, group, params, grads, states, s):
        return self._scaled(_adam_directions(group, params, grads, states, s,
                                             group["weight_decay"], self.nesterov), s)


class NAdam(OptaxAdam):
    nesterov = True


class RAdam(OptaxOptimizer):
    """``scale_by_radam``: Adam rectified where rho_t >= 5, the bias-corrected
    first moment elsewhere (a select on the count: both computed; r is NaN
    where rho_t < 4, in the branch not taken)."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    _init = _zeros("mu", "nu")
    threshold = 5.0

    def _scalars(self, group, t, lr):
        b2 = group["b2"]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _pow(b2, t)
        ro = torch.rsub(t * 2 * b2t / torch.rsub(b2t, 1.0), ro_inf)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / (ro * ((ro_inf - 4.0) * (ro_inf - 2.0))))
        return {"bc1": _bias(group["b1"], t), "bc2": _bias(b2, t),
                "rectified": ro >= self.threshold, "r": r}

    def _updates(self, group, params, grads, states, s):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        _moment(nu, g, b2, 2)
        mu_hat = torch._foreach_div(mu, s["bc1"])
        denom = torch._foreach_sqrt(torch._foreach_div(nu, s["bc2"]))
        torch._foreach_add_(denom, eps)
        rectified = torch._foreach_div(torch._foreach_mul(mu_hat, s["r"]), denom)
        return self._scaled(_select(s["rectified"], rectified, mu_hat), s)


class Adadelta(OptaxOptimizer):
    hyper = dict(weight_decay=0.0, rho=0.9, eps=1e-6)
    _init = _zeros("e_g", "e_x")

    def _updates(self, group, params, grads, states, s):
        rho, eps = group["rho"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        e_g, e_x = _take(states, "e_g"), _take(states, "e_x")
        _moment(e_g, g, rho, 2)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        upd = torch._foreach_mul(torch._foreach_div(num, den), g)
        _moment(e_x, upd, rho, 2)
        return self._scaled(upd, s)


class Adagrad(OptaxOptimizer):
    """``scale_by_rss``: g * rsqrt(sum + eps) where the sum of squares is
    positive, 0 elsewhere."""

    hyper = dict(weight_decay=0.0, eps=1e-10, initial_accumulator_value=0.0)

    def _init(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def _updates(self, group, params, grads, states, s):
        g = _decayed(grads, params, group["weight_decay"])
        sums = _take(states, "sum_of_squares")
        torch._foreach_add_(sums, torch._foreach_mul(g, g))
        scale = [torch.where(q > 0, torch.rsqrt(q + group["eps"]), 0.0) for q in sums]
        return self._scaled(torch._foreach_mul(scale, g), s)


class Adamax(OptaxOptimizer):
    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    _init = _zeros("mu", "nu")

    def _scalars(self, group, t, lr):
        return {"bc1": _bias(group["b1"], t)}

    def _updates(self, group, params, grads, states, s):
        b1, b2 = group["b1"], group["b2"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, torch._foreach_add(torch._foreach_abs(g), group["eps"]))
        return self._scaled(torch._foreach_div(torch._foreach_div(mu, s["bc1"]), nu), s)


class RMSprop(OptaxOptimizer):
    """``scale_by_rms`` (eps inside the square root) or, ``centered``,
    ``scale_by_stddev``; ``momentum``: a trace of the scaled updates."""

    hyper = dict(weight_decay=0.0, alpha=0.99, eps=1e-8, momentum=0.0, centered=0.0)

    def _init(self, p, group):
        names = ["nu"] + ["mu"] * bool(group["centered"]) + ["trace"] * bool(group["momentum"])
        return {n: torch.zeros_like(p) for n in names}

    def _updates(self, group, params, grads, states, s):
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
        return self._scaled(upd, s)


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

    def _updates(self, group, params, grads, states, s):
        g = _decayed(grads, params, group["weight_decay"])
        out = []
        for grad, st in zip(g, states):
            sign = grad * st["prev_updates"]
            grown = torch.where(sign > 0, group["eta_plus"], group["eta_minus"])
            steps = torch.where(sign == 0, st["step_sizes"],
                                (st["step_sizes"] * grown).clamp(self.min_step, self.max_step))
            applied = torch.where(sign < 0, 0.0, st["prev_updates"])
            st["step_sizes"].copy_(steps)
            st["prev_updates"].copy_(torch.where(sign < 0, 0.0, steps * torch.sign(grad)))
            out.append(applied)
        return self._scaled(out, s)


class AdaBound(OptaxOptimizer):
    """The JAX package's AdaBound: Adam whose per-element step
    lr * sqrt(bc2) / bc1 / (sqrt(nu) + eps) is clipped to a band around
    ``final_lr`` that narrows as the count grows (the band does not scale
    with lr)."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, final_lr=0.1, gamma=1e-3)
    _init = _zeros("mu", "nu")

    def _scalars(self, group, t, lr):
        final, gamma = group["final_lr"], group["gamma"]
        return {"step_size": lr * torch.sqrt(_bias(group["b2"], t)) / _bias(group["b1"], t),
                "lower": torch.rsub(torch.reciprocal(t * gamma + 1.0), 1.0) * final,
                "upper": (torch.reciprocal(t * gamma) + 1.0) * final}

    def _updates(self, group, params, grads, states, s):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        _moment(nu, g, b2, 2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu), eps)
        eff = [torch.div(s["step_size"], d) for d in denom]
        # one bound a tensor: maximum / minimum take no single 0-d tensor
        torch._foreach_maximum_(eff, [s["lower"]] * len(eff))
        torch._foreach_minimum_(eff, [s["upper"]] * len(eff))
        return torch._foreach_mul(torch._foreach_neg(eff), mu)


class AdaBelief(OptaxOptimizer):
    """``scale_by_belief``: the second moment of g - mu, plus eps_root 1e-16
    each step."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-16)
    eps_root = 1e-16
    _init = _zeros("mu", "nu")

    def _scalars(self, group, t, lr):
        return _adam_scalars(group, t)

    def _updates(self, group, params, grads, states, s):
        b1, b2 = group["b1"], group["b2"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        _moment(nu, torch._foreach_sub(g, mu), b2, 2)
        torch._foreach_add_(nu, self.eps_root)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, s["bc2"]))
        torch._foreach_add_(denom, group["eps"])
        return self._scaled(torch._foreach_div(torch._foreach_div(mu, s["bc1"]), denom), s)


class Yogi(OptaxOptimizer):
    """``scale_by_yogi``: both accumulators start at 1e-6."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-3)
    initial_accumulator_value = 1e-6

    def _init(self, p, group):
        return {n: torch.full_like(p, self.initial_accumulator_value) for n in ("mu", "nu")}

    def _scalars(self, group, t, lr):
        return _adam_scalars(group, t)

    def _updates(self, group, params, grads, states, s):
        b1, b2 = group["b1"], group["b2"]
        g = _decayed(grads, params, group["weight_decay"])
        mu, nu = _take(states, "mu"), _take(states, "nu")
        _moment(mu, g, b1, 1)
        g2 = torch._foreach_mul(g, g)
        sign = torch._foreach_sign(torch._foreach_sub(nu, g2))
        torch._foreach_sub_(nu, torch._foreach_mul(torch._foreach_mul(sign, 1 - b2), g2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, s["bc2"]))
        torch._foreach_add_(denom, group["eps"])
        return self._scaled(torch._foreach_div(torch._foreach_div(mu, s["bc1"]), denom), s)


class NovoGrad(OptaxOptimizer):
    """``scale_by_novograd``: one second moment a tensor (its squared norm's
    average), the first moment of the normalized gradient. At the first
    step optax sets both moments to their new term; the count selects the
    coefficients (decay 0, weight 1 then), which give those terms exactly
    from the zero state."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.25, eps=1e-8)

    def _init(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def _scalars(self, group, t, lr):
        first = t == 1
        b1, b2 = group["b1"], group["b2"]
        return {"nu_decay": torch.where(first, 0.0, b2).float(),
                "nu_weight": torch.where(first, 1.0, 1 - b2).float(),
                "mu_decay": torch.where(first, 0.0, b1).float()}

    def _updates(self, group, params, grads, states, s):
        eps = group["eps"]
        g = _decayed(grads, params, group["weight_decay"])
        nu = _take(states, "nu")
        sq = [n * n for n in torch._foreach_norm(g)]
        torch._foreach_mul_(nu, s["nu_decay"])
        torch._foreach_add_(nu, torch._foreach_mul(sq, s["nu_weight"]))
        added = torch._foreach_div(g, torch._foreach_add(torch._foreach_sqrt(nu), eps))
        mu = _take(states, "mu")
        torch._foreach_mul_(mu, s["mu_decay"])
        torch._foreach_add_(mu, added)
        return self._scaled(mu, s)


class Lamb(OptaxOptimizer):
    """``scale_by_adam`` (eps 1e-6), then the decay, then optax's trust ratio
    ||p|| / ||u|| per tensor (1 where either norm is 0)."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-6)
    _init = _zeros("mu", "nu")

    def _scalars(self, group, t, lr):
        return _adam_scalars(group, t)

    def _updates(self, group, params, grads, states, s):
        upd = _adam_directions(group, params, grads, states, s, weight_decay=0.0)
        if group["weight_decay"]:
            upd = _decayed(upd, params, group["weight_decay"])
        p_norm, u_norm = torch._foreach_norm(params), torch._foreach_norm(upd)
        ratio = [torch.where((pn == 0) | (un == 0), 1.0, pn / un) for pn, un in zip(p_norm, u_norm)]
        return self._scaled(torch._foreach_mul(upd, ratio), s)


class Lion(OptaxOptimizer):
    """``scale_by_lion``: sign((1 - b1) g + b1 mu), mu <- (1 - b2) g + b2 mu;
    then the decay."""

    hyper = dict(weight_decay=0.0, b1=0.9, b2=0.99)
    _init = _zeros("mu")

    def _updates(self, group, params, grads, states, s):
        b1, b2 = group["b1"], group["b2"]
        mu = _take(states, "mu")
        mix = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu, b1))
        upd = torch._foreach_sign(mix)
        _moment(mu, grads, b2, 1)
        if group["weight_decay"]:
            upd = _decayed(upd, params, group["weight_decay"])
        return self._scaled(upd, s)


class _Lookahead(OptaxOptimizer):
    """optax's ``lookahead`` over the next class in the MRO (the inner
    optimizer): the parameters are the fast weights; every ``sync_period``
    steps the slow weights (``slow`` in the state) move ``slow_step`` of the
    way to the fast ones, and the fast ones take their place. Its sync is a
    host branch: it is not built for a graph (``build_optimizer``,
    ``capture_unmet``)."""

    sync_period, slow_step = 5, 0.5

    def _init(self, p, group):
        return {**super()._init(p, group), "slow": p.detach().clone()}

    def _scalars(self, group, t, lr):
        return {**super()._scalars(group, t, lr), "sync": t % self.sync_period == 0}

    def _updates(self, group, params, grads, states, s):
        fast = super()._updates(group, params, grads, states, s)
        if not s["sync"]:
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
    def factory(params, lr, graph=False, **kw):
        return cls(params, lr, graph=graph, **{k: v for k, v in kw.items() if k in cls.hyper})
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
# JAX trainers' flat parameter tree is not; the only ones not built for a graph
LOOKAHEAD_NAMES = ("Lookahead", "Ranger")
EAGER_LOOKAHEAD = ("the lookahead chains stay eager (their sync is a host branch, and the "
                   "trainers refuse them: optax's lookahead needs LookaheadParams)")


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_config: Dict[str, Any],
                    graph: bool = False) -> torch.optim.Optimizer:
    """``optim_config``: the ``Optim`` config section ({name, lr,
    weight_decay, ...}); see the module docstring. ``graph``: build it for a
    CUDA graph (every name but ``LOOKAHEAD_NAMES``)."""
    cfg = dict(optim_config)
    name = cfg.pop("name", "Adam")
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: {sorted(OPTIMIZERS)}")
    if graph and name in LOOKAHEAD_NAMES:
        raise ValueError(f"Optim.name={name} cannot be built for a CUDA graph: {EAGER_LOOKAHEAD}")
    lr = float(cfg.pop("lr", 1e-3))
    kw = {k: float(v) for k, v in cfg.items()}
    if graph:
        kw["graph"] = True
    return OPTIMIZERS[name](list(params), lr, **kw)


def capture_unmet(optimizer: Union[torch.optim.Optimizer, str]) -> Optional[str]:
    """None when a CUDA graph can capture ``optimizer.step()``, else why
    not; ``optimizer`` may be its ``Optim.name``, before it is built."""
    if isinstance(optimizer, str):
        return f"Optim.name={optimizer}: {EAGER_LOOKAHEAD}" if optimizer in LOOKAHEAD_NAMES else None
    if isinstance(optimizer, _Lookahead):
        return f"Optim.name={type(optimizer).__name__}: {EAGER_LOOKAHEAD}"
    groups = optimizer.param_groups
    if not all(isinstance(g["lr"], torch.Tensor) for g in groups):
        return "the optimizer's lr is a Python float (build_optimizer(..., graph=True))"
    if isinstance(optimizer, OptaxOptimizer):
        ok = optimizer.graph and all(g["lr"].is_cuda for g in groups) and all(
            c.is_cuda for c in optimizer._counts.values())
    elif isinstance(optimizer, torch.optim.Adam):  # AdamW too
        ok = all(g["capturable"] for g in groups)
    else:
        ok = isinstance(optimizer, torch.optim.SGD) and all(g["fused"] for g in groups)
    if not ok:
        return (f"{type(optimizer).__name__} is not built for a CUDA graph (Adam / AdamW "
                "capturable, SGD fused, an optax chain's count and lr on the card)")
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
