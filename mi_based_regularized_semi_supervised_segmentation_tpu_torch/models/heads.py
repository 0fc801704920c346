"""Cluster and projection heads over U-Net feature taps (counterpart of the
JAX package's ``models/heads.py``). The projection heads
(``ProjectionHead``, ``LocalProjectionHead``) serve the contrastive pretrain
pipeline (``engine/pretrain.py``); the rest of this docstring is about the
cluster heads.

Two head types, S subheads of K clusters each:
  linear  one batched linear layer producing S*K outputs
  mlp     per subhead dim -> interm_dim, LeakyReLU 0.01, -> K; the
          parameters keep the JAX shapes: w1 [S, dim, I], b1 [S, I],
          w2 [S, I, K], b2 [S, K] (the subheads share nothing)
``normalize`` L2-normalizes each subhead's K logits before the softmax.
Layout NHWC, clusters on the last axis. Decoder heads emit flat
probabilities [B, H, W, C] (``flat_output``, the trainer's layout) with
C = S*K rounded up to ``lane_multiple`` lanes and the dead lanes exactly
zero, which is the layout the displaced-MI kernel consumes; or [B, H, W, S, K]
with ``flat_output=False`` (the 5-D layout). With ``emit_logits`` (flat,
linear-or-mlp, unnormalized, T = 1) they emit the logits instead, dead lanes
at float32 min rounded to the head's dtype (-inf in bf16, as ``jnp.pad``
rounds it), for the fused softmax + mask + joint kernels
(``Kernel.backend=pallas_fused``). A decoder head computes in its ``dtype``
(the trainer's ``Precision.compute_dtype``), its weights cast to it as flax
casts them; encoder heads stay fp32, as in the JAX package.

Two departures, both where the JAX package's ``normalize`` gives NaN
(ROADMAP.md, Queue 3): its flat head multiplies its -inf dead lanes by 0, so
with dead lanes (S*K below the lane width) every live output is NaN; the
port normalizes the live lanes only, which is what the JAX 5-D head and the
JAX flat head without dead lanes compute. Its 5-D and encoder heads'
gradient is NaN at a zero logit vector; the port's is finite there.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import DECODER_NAMES, ENCODER_NAMES, UNET_DIMENSIONS

HEAD_TYPES = ("linear", "mlp")


def _linear(dim: int, out: int) -> nn.Linear:
    layer = nn.Linear(dim, out)
    nn.init.zeros_(layer.bias)  # flax Dense: zero bias, U(+-1/sqrt(fan_in)) kernel
    return layer


def _dense_init(*shape: int) -> nn.Parameter:
    """flax's variance_scaling(1/3, "fan_in", "uniform"): U(+-1/sqrt(fan_in)),
    fan_in the product of every axis but the last."""
    bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


def split_feature_names(feature_names: Sequence[str]) -> Tuple[List[str], List[str]]:
    """(encoder, decoder) feature names, each in the given order; a name of
    neither raises."""
    enc = [f for f in feature_names if f in ENCODER_NAMES]
    dec = [f for f in feature_names if f in DECODER_NAMES]
    if len(enc) + len(dec) != len(feature_names):
        raise ValueError(f"{list(feature_names)}: not all are U-Net components")
    return enc, dec


def _check_head(head_type: str) -> None:
    if head_type not in HEAD_TYPES:
        raise ValueError(f"head_type={head_type!r}: expected one of {HEAD_TYPES}")


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis, each op in x's dtype (the JAX
    ``_l2_normalize``), as x / sqrt(max(||x||^2, eps^2)): the same values,
    and a zero gradient through the norm where it is clamped, where the JAX
    form's sqrt'(0) = inf times 0 gives NaN (a zero logit vector: any
    pixel of the zero border with zero biases)."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(eps * eps))


def _softmax(z: torch.Tensor, T: float) -> torch.Tensor:
    """softmax(z / T) over the last axis. bf16: ``jax.nn.softmax``'s rounding
    points (the exps in bf16, their fp32 sum rounded to bf16 once, the
    quotient in bf16)."""
    if z.dtype != torch.bfloat16:
        return torch.softmax(z / T, dim=-1)
    z = z / torch.tensor(T, dtype=z.dtype)
    e = torch.exp(z - z.amax(-1, keepdim=True).detach())
    return e / e.float().sum(-1, keepdim=True).to(z.dtype)


def _group_l2_normalize(z: torch.Tensor, S: int, K: int) -> torch.Tensor:
    """Each subhead's K lanes of flat [..., S*K] logits over their L2 norm,
    at the JAX flat head's rounding points: the squares summed in fp32,
    rsqrt(max(sum, 1e-24)) rounded to z's dtype, then z times it."""
    groups = z.reshape(*z.shape[:-1], S, K)
    zf = groups.float()
    inv = torch.rsqrt((zf * zf).sum(-1, keepdim=True).clamp_min(1e-24))
    return (groups * inv.to(z.dtype)).reshape(z.shape)


def group_softmax_flat(z: torch.Tensor, S: int, K: int, T: float = 1.0,
                       normalize: bool = False) -> torch.Tensor:
    """Per-subhead softmax over the flat [..., C] layout, C >= S*K: lanes
    [s*K, (s+1)*K) form group s; the dead lanes beyond S*K come out as exact
    zeros (with zero gradient). ``normalize``: each group's logits over their
    L2 norm first (``_group_l2_normalize``). fp32 (and any non-bf16 input): a
    softmax per group in fp32. bf16: the JAX package's rounding points (its
    ``group_softmax_flat``): the max over all live lanes of the pixel, the
    exps in bf16, each group's sum of the bf16 exps in fp32 rounded to bf16
    once, the quotient in bf16."""
    c = z.shape[-1]
    if c < S * K:
        raise ValueError(f"{c} lanes cannot hold {S} x {K} clusters")
    live = z[..., :S * K]
    if normalize:
        live = _group_l2_normalize(live, S, K)
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


class _Subheads(nn.Module):
    """The S subheads' logits [..., S, K] from features [..., dim]: linear
    (``linear``) or mlp (``w1``, ``b1``, ``w2``, ``b2``), computed in
    ``dtype`` with the parameters cast to it."""

    def __init__(self, dim: int, num_subheads: int, num_clusters: int, head_type: str,
                 interm_dim: int) -> None:
        super().__init__()
        _check_head(head_type)
        self.S, self.K, self.head_type = num_subheads, num_clusters, head_type
        if head_type == "linear":
            self.linear = _linear(dim, num_subheads * num_clusters)
        else:
            self.w1 = _dense_init(num_subheads, dim, interm_dim)
            self.b1 = nn.Parameter(torch.zeros(num_subheads, interm_dim))
            self.w2 = _dense_init(num_subheads, interm_dim, num_clusters)
            self.b2 = nn.Parameter(torch.zeros(num_subheads, num_clusters))

    def logits(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        if self.head_type == "linear":
            out = x @ self.linear.weight.to(dt).T + self.linear.bias.to(dt)
            return out.reshape(*x.shape[:-1], self.S, self.K)
        h = torch.einsum("...d,sdi->...si", x, self.w1.to(dt)) + self.b1.to(dt)
        h = F.leaky_relu(h, 0.01)
        return torch.einsum("...si,sik->...sk", h, self.w2.to(dt)) + self.b2.to(dt)


class ClusterHead(_Subheads):
    """Global (encoder) head: average pool -> linear or mlp (``interm_dim``
    128) -> [normalize] -> softmax/T over K, S subheads. Output [B, S, K],
    fp32."""

    def __init__(self, input_dim: int, num_clusters: int = 10, num_subheads: int = 5,
                 head_type: str = "linear", T: float = 1.0, normalize: bool = False,
                 interm_dim: int = 128) -> None:
        super().__init__(input_dim, num_subheads, num_clusters, head_type, interm_dim)
        self.T, self.normalize = T, normalize

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        out = self.logits(features.float().mean(dim=(1, 2)), torch.float32)
        if self.normalize:
            out = _l2_normalize(out)
        return torch.softmax(out / self.T, dim=-1)


class LocalClusterHead(_Subheads):
    """Per-pixel (decoder) head: a 1x1 linear map or mlp (``interm_dim`` 64)
    -> [normalize] -> per-subhead softmax/T, in ``dtype`` (features and
    weights cast to it: two roundings in bf16 for a linear head, ``x @ W + b``).
    ``flat_output``: [B, H, W, C], the probabilities lane-padded with zeros to
    a multiple of ``lane_multiple`` (the JAX head pads the logits with float32
    min and then softmaxes; the probabilities are the same), normalized as
    ``group_softmax_flat`` does; otherwise [B, H, W, S, K], normalized and
    softmaxed over the last axis as the JAX 5-D head does. With
    ``emit_logits`` (flat, unnormalized, T = 1) the softmax is skipped and the
    logits come out lane-padded with float32 min rounded to ``dtype`` (-inf in
    bf16), as the JAX head emits them."""

    def __init__(self, input_dim: int, num_clusters: int = 10, num_subheads: int = 5,
                 head_type: str = "linear", T: float = 1.0, normalize: bool = False,
                 lane_multiple: int = 128, emit_logits: bool = False,
                 dtype: torch.dtype = torch.float32, flat_output: bool = True,
                 interm_dim: int = 64) -> None:
        super().__init__(input_dim, num_subheads, num_clusters, head_type, interm_dim)
        if emit_logits and (T != 1.0 or normalize or not flat_output):
            raise ValueError(f"emit_logits covers the flat, unnormalized T = 1 head, got T = {T}, "
                             f"normalize={normalize}, flat_output={flat_output}")
        self.T, self.normalize = T, normalize
        self.lane_multiple = lane_multiple
        self.emit_logits = emit_logits
        self.dtype = dtype
        self.flat_output = flat_output

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        out = self.logits(features.to(self.dtype), self.dtype)
        if not self.flat_output:
            return _softmax(_l2_normalize(out) if self.normalize else out, self.T)
        sk = self.S * self.K
        out = out.reshape(*out.shape[:-2], sk)
        lanes = (0, -(-sk // self.lane_multiple) * self.lane_multiple - sk)
        if self.emit_logits:
            dead = float(torch.tensor(torch.finfo(torch.float32).min).to(self.dtype))
            return F.pad(out, lanes, value=dead)
        return F.pad(group_softmax_flat(out, self.S, self.K, self.T, self.normalize), lanes)


class ProjectorWrapper(nn.Module):
    """Cluster heads keyed by U-Net feature name: ClusterHead at encoder taps,
    LocalClusterHead at decoder taps. Per-head settings may be scalars or
    per-position lists. ``local_flat``: the decoder heads emit the flat
    lane-padded layout (the trainer's, as in the JAX trainer) or, off, the 5-D
    [B, H, W, S, K] one (the JAX ``ProjectorWrapper``'s default).
    ``local_emit_logits``: the decoder heads emit logits (the fused path); the
    parameters are the same either way. ``local_dtype``: the decoder heads'
    compute and output dtype."""

    def __init__(self, feature_names: Sequence[str], num_clusters=20, num_subheads=5,
                 head_types="linear", normalize=False, local_lane_multiple: int = 128,
                 local_emit_logits: bool = False,
                 local_dtype: torch.dtype = torch.float32, local_flat: bool = True) -> None:
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.local_emit_logits = bool(local_emit_logits)
        self.local_flat = bool(local_flat)
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
                                               dtype=local_dtype, flat_output=self.local_flat)
            self._shapes[name] = (kwargs["num_subheads"], kwargs["num_clusters"])
        self.heads = nn.ModuleDict(heads)

    def head_shape(self, name: str) -> Tuple[int, int]:
        """(num_subheads, num_clusters) of a position."""
        return self._shapes[name]

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self.heads[name](features[name]) for name in self.feature_names}


class ProjectionHead(nn.Module):
    """Global contrastive projection (the pretrain encoder phase): the
    features' mean over H, W in fp32, then for ``mlp`` a linear layer to
    ``interm_dim`` and LeakyReLU 0.01, then a linear layer to ``output_dim``.
    Output [B, output_dim]."""

    def __init__(self, input_dim: int, output_dim: int = 256, interm_dim: int = 256,
                 head_type: str = "mlp") -> None:
        super().__init__()
        _check_head(head_type)
        self.head_type = head_type
        if head_type == "mlp":
            self.hidden = _linear(input_dim, interm_dim)
            input_dim = interm_dim
        self.out = _linear(input_dim, output_dim)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.float().mean(dim=(1, 2))
        if self.head_type == "mlp":
            x = F.leaky_relu(self.hidden(x), 0.01)
        return self.out(x)


def _conv3x3(in_ch: int, out_ch: int) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
    nn.init.zeros_(conv.bias)  # flax Conv: zero bias, U(+-1/sqrt(fan_in)) kernel
    return conv


class LocalProjectionHead(nn.Module):
    """Local contrastive projection (the pretrain decoder phase): a 3x3
    convolution (padding 1) to 64 channels, then for ``mlp`` LeakyReLU 0.01
    and a 3x3 convolution to 32 channels, in fp32; then a max pool over
    equal blocks to ``output_size`` (the map must divide into them). NHWC in
    and out: [B, oh, ow, 64 or 32]."""

    def __init__(self, input_dim: int, head_type: str = "mlp",
                 output_size: Tuple[int, int] = (4, 4)) -> None:
        super().__init__()
        _check_head(head_type)
        self.head_type, self.output_size = head_type, tuple(output_size)
        self.conv0 = _conv3x3(input_dim, 64)
        if head_type == "mlp":
            self.conv1 = _conv3x3(64, 32)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.conv0(features.float().permute(0, 3, 1, 2))
        if self.head_type == "mlp":
            x = self.conv1(F.leaky_relu(x, 0.01))
        b, c, h, w = x.shape
        oh, ow = self.output_size
        if h % oh or w % ow:
            raise ValueError(f"a {h}x{w} map does not divide into {oh}x{ow} blocks")
        return x.reshape(b, c, oh, h // oh, ow, w // ow).amax(dim=(3, 5)).permute(0, 2, 3, 1)
