"""Cluster heads over U-Net feature taps (counterpart of the JAX package's
``models/heads.py``; linear heads only so far).

Subheads are one batched linear layer producing S*K outputs. Layout NHWC,
clusters on the last axis. Decoder heads emit flat probabilities
[B, H, W, C] with C = S*K rounded up to 128 lanes and the dead lanes exactly
zero, which is the layout the displaced-MI kernel consumes.
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
    zeros (with zero gradient)."""
    c = z.shape[-1]
    if c < S * K:
        raise ValueError(f"{c} lanes cannot hold {S} x {K} clusters")
    live = z[..., :S * K].reshape(*z.shape[:-1], S, K)
    probs = torch.softmax(live.float() / T, dim=-1).reshape(*z.shape[:-1], S * K)
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
    Output [B, H, W, C]. The JAX head pads the logits with float32 min and
    then softmaxes; the probabilities are the same."""

    def __init__(self, input_dim: int, num_clusters: int = 10, num_subheads: int = 5,
                 head_type: str = "linear", T: float = 1.0, normalize: bool = False,
                 lane_multiple: int = 128) -> None:
        super().__init__()
        _check_head(head_type, normalize)
        self.S, self.K, self.T = num_subheads, num_clusters, T
        self.lane_multiple = lane_multiple
        self.linear = _linear(input_dim, num_subheads * num_clusters)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        probs = group_softmax_flat(self.linear(features.float()), self.S, self.K, self.T)
        sk = self.S * self.K
        return F.pad(probs, (0, -(-sk // self.lane_multiple) * self.lane_multiple - sk))


class ProjectorWrapper(nn.Module):
    """Cluster heads keyed by U-Net feature name: ClusterHead at encoder taps,
    LocalClusterHead at decoder taps. Per-head settings may be scalars or
    per-position lists."""

    def __init__(self, feature_names: Sequence[str], num_clusters=20, num_subheads=5,
                 head_types="linear", normalize=False, local_lane_multiple: int = 128) -> None:
        super().__init__()
        self.feature_names = tuple(feature_names)
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
                heads[name] = LocalClusterHead(**kwargs, lane_multiple=local_lane_multiple)
            self._shapes[name] = (kwargs["num_subheads"], kwargs["num_clusters"])
        self.heads = nn.ModuleDict(heads)

    def head_shape(self, name: str) -> Tuple[int, int]:
        """(num_subheads, num_clusters) of a position."""
        return self._shapes[name]

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self.heads[name](features[name]) for name in self.feature_names}
