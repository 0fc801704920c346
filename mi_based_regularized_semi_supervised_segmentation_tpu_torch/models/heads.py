"""Cluster heads over U-Net feature taps (counterpart of the JAX package's
``models/heads.py``; linear heads only so far).

Subheads are one batched linear layer producing S*K outputs. Layout NHWC,
clusters on the last axis. Decoder heads emit flat probabilities
[B, H, W, C] with C = S*K rounded up to 128 lanes and the dead lanes exactly
zero, which is the layout the displaced-MI kernel consumes; with
``emit_logits`` they emit the logits instead, dead lanes at float32 min
rounded to the head's dtype (-inf in bf16, as ``jnp.pad`` rounds it), for
the fused softmax + mask + joint kernels (``Kernel.backend=pallas_fused``).
A decoder head computes in its ``dtype`` (the trainer's
``Precision.compute_dtype``); encoder heads stay fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import ENCODER_NAMES, UNET_DIMENSIONS

_ROADMAP = "not ported yet; see ROADMAP.md"


def _linear(dim: int, out: int) -> nn.Linear:
    layer = nn.Linear(dim, out)
    nn.init.zeros_(layer.bias)  # flax Dense: zero bias, U(+-1/sqrt(fan_in)) kernel
    return layer


def _check_head(head_type: str, normalize: bool) -> None:
    if head_type != "linear" or normalize:
        raise NotImplementedError(
            f"head_type={head_type!r}, normalize={normalize}: only linear unnormalized heads "
            f"are ported; {_ROADMAP}")


def group_softmax_flat(z: torch.Tensor, S: int, K: int, T: float = 1.0) -> torch.Tensor:
    """Per-subhead softmax over the flat [..., C] layout, C >= S*K: lanes
    [s*K, (s+1)*K) form group s; the dead lanes beyond S*K come out as exact
    zeros (with zero gradient). fp32 (and any non-bf16 input): a softmax per
    group in fp32. bf16: the JAX package's rounding points (its
    ``group_softmax_flat``): the max over all live lanes of the pixel, the
    exps in bf16, each group's sum of the bf16 exps in fp32 rounded to bf16
    once, the quotient in bf16."""
    c = z.shape[-1]
    if c < S * K:
        raise ValueError(f"{c} lanes cannot hold {S} x {K} clusters")
    live = z[..., :S * K]
    if z.dtype == torch.bfloat16:
        live = live / torch.tensor(T, dtype=z.dtype)  # T rounded to bf16 first, as jnp does
        e = torch.exp(live - live.amax(-1, keepdim=True).detach())
        groups = e.reshape(*z.shape[:-1], S, K)
        denom = groups.float().sum(-1, keepdim=True).to(torch.bfloat16)
        probs = (groups / denom).reshape(*z.shape[:-1], S * K)
    else:
        probs = torch.softmax(live.reshape(*z.shape[:-1], S, K).float() / T, dim=-1)
        probs = probs.reshape(*z.shape[:-1], S * K)
    return F.pad(probs, (0, c - S * K))


class ClusterHead(nn.Module):
    """Global (encoder) head: average pool -> linear -> softmax/T over K,
    S subheads. Output [B, S, K]."""

    def __init__(self, input_dim: int, num_clusters: int = 10, num_subheads: int = 5,
                 head_type: str = "linear", T: float = 1.0, normalize: bool = False) -> None:
        super().__init__()
        _check_head(head_type, normalize)
        self.S, self.K, self.T = num_subheads, num_clusters, T
        self.linear = _linear(input_dim, num_subheads * num_clusters)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.float().mean(dim=(1, 2))
        out = self.linear(x).reshape(x.shape[0], self.S, self.K)
        return torch.softmax(out / self.T, dim=-1)


class LocalClusterHead(nn.Module):
    """Per-pixel (decoder) head: a 1x1 linear map -> per-subhead softmax ->
    probabilities lane-padded with zeros to a multiple of ``lane_multiple``.
    Output [B, H, W, C] in ``dtype``: features, kernel and bias are cast to
    it and the map is ``x @ W + b`` (two roundings in bf16). The JAX head pads
    the logits with float32 min and then softmaxes; the probabilities are the
    same. With ``emit_logits`` the softmax is skipped and the logits come out
    lane-padded with float32 min rounded to ``dtype`` (-inf in bf16), as the
    JAX head emits them (T = 1 only)."""

    def __init__(self, input_dim: int, num_clusters: int = 10, num_subheads: int = 5,
                 head_type: str = "linear", T: float = 1.0, normalize: bool = False,
                 lane_multiple: int = 128, emit_logits: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        _check_head(head_type, normalize)
        if emit_logits and T != 1.0:
            raise ValueError(f"emit_logits covers the T = 1 head, got T = {T}")
        self.S, self.K, self.T = num_subheads, num_clusters, T
        self.lane_multiple = lane_multiple
        self.emit_logits = emit_logits
        self.dtype = dtype
        self.linear = _linear(input_dim, num_subheads * num_clusters)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = features.to(dt) @ self.linear.weight.to(dt).T + self.linear.bias.to(dt)
        sk = self.S * self.K
        lanes = (0, -(-sk // self.lane_multiple) * self.lane_multiple - sk)
        if self.emit_logits:
            dead = float(torch.tensor(torch.finfo(torch.float32).min).to(dt))
            return F.pad(out, lanes, value=dead)
        return F.pad(group_softmax_flat(out, self.S, self.K, self.T), lanes)


class ProjectorWrapper(nn.Module):
    """Cluster heads keyed by U-Net feature name: ClusterHead at encoder taps,
    LocalClusterHead at decoder taps. Per-head settings may be scalars or
    per-position lists. ``local_emit_logits``: the decoder heads emit logits
    (the fused path); the parameters are the same either way. ``local_dtype``:
    the decoder heads' compute and output dtype."""

    def __init__(self, feature_names: Sequence[str], num_clusters=20, num_subheads=5,
                 head_types="linear", normalize=False, local_lane_multiple: int = 128,
                 local_emit_logits: bool = False,
                 local_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.local_emit_logits = bool(local_emit_logits)
        self._shapes: Dict[str, Tuple[int, int]] = {}
        heads = {}
        for i, name in enumerate(self.feature_names):
            pick = lambda v: v[i] if isinstance(v, (list, tuple)) else v
            kwargs = dict(input_dim=UNET_DIMENSIONS[name], num_clusters=int(pick(num_clusters)),
                          num_subheads=int(pick(num_subheads)), head_type=pick(head_types),
                          normalize=bool(pick(normalize)))
            if name in ENCODER_NAMES:
                heads[name] = ClusterHead(**kwargs)
            else:
                heads[name] = LocalClusterHead(**kwargs, lane_multiple=local_lane_multiple,
                                               emit_logits=self.local_emit_logits,
                                               dtype=local_dtype)
            self._shapes[name] = (kwargs["num_subheads"], kwargs["num_clusters"])
        self.heads = nn.ModuleDict(heads)

    def head_shape(self, name: str) -> Tuple[int, int]:
        """(num_subheads, num_clusters) of a position."""
        return self._shapes[name]

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self.heads[name](features[name]) for name in self.feature_names}
