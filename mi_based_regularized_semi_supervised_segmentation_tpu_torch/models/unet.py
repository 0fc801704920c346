"""2D U-Net with named feature taps (counterpart of the JAX package's
``models/unet.py``).

4-down/4-up, channels 16..256; each block is 2x (Conv3x3 without bias, BN,
ReLU); an up step is nearest x2 upsample, Conv3x3, BN, ReLU; skip concat; a
1x1 head to the classes. Module names are the original PyTorch project's
(``ConvN.conv.{0,1,3,4}``, ``UpN.up.{1,2}``, ``DeConv_1x1``), so its
checkpoints and ``weights.py``'s map line up.

Layout: the network runs NCHW inside; ``forward`` takes and returns the JAX
package's NHWC layout (images [B, H, W, 1], logits [B, H, W, C], taps
[B, h, w, c]).

BatchNorm matches flax's: eps 1e-5, running statistics updated with
momentum 0.1 (flax 0.9) from the BIASED batch variance (torch's own
BatchNorm2d uses the unbiased one).

Precision, as flax computes it (the parameters stay fp32; ``dtype`` and
``bn_dtype`` are the JAX model's): the input is cast to ``dtype`` and each
convolution casts its input and weight to ``dtype`` at the call; a BN layer
takes its batch statistics in fp32 from its (possibly bf16) input, computes
``(x - mean) * rsqrt(var + eps) * scale + bias`` in fp32 and returns
``bn_dtype``, so the ReLU outputs and the taps are ``bn_dtype``; the 1x1 head
is ``x @ W + b`` in ``dtype`` (two roundings) and the logits return as fp32.

``stem="s2d"``: the input is pixel-unshuffled 2x before Conv1 (4 * input_dim
channels), the head predicts 4 * num_classes channels at half resolution,
pixel-shuffled back; the taps sit at the halved grid. The channel order is
the JAX package's, ``(ry * r + rx) * C + c`` (``space_to_depth``), not
``F.pixel_unshuffle``'s, so its parameters map as they are.

``remat=True``: each ConvBlock and UpConv runs under
``torch.utils.checkpoint`` (non-reentrant) while gradients are recorded; its
forward runs again in the backward, with the same numerics, and the BN
running statistics move on the first run only (flax's ``nn.remat``).

Pad-and-mask and data parallelism: ``forward(..., bn_mask=, bn_group=)``
reaches every train-mode BN layer. ``bn_mask`` [B] marks the real rows (pad
rows are normalized but enter no statistic, flax's ``BatchNorm(mask=)``);
``bn_group`` sums the statistics' sums and counts over the ranks of a
process group (``parallel/mesh.py:all_reduce_sum``), so every rank
normalizes with, and keeps running statistics of, the global batch.
"""

from __future__ import annotations

from collections import OrderedDict
from itertools import count
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import all_reduce_sum

UNET_DIMENSIONS: Dict[str, int] = {
    "Conv1": 16, "Conv2": 32, "Conv3": 64, "Conv4": 128, "Conv5": 256,
    "Up_conv5": 128, "Up_conv4": 64, "Up_conv3": 32, "Up_conv2": 16,
}
ENCODER_NAMES = ["Conv1", "Conv2", "Conv3", "Conv4", "Conv5"]
DECODER_NAMES = ["Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3", "Up2", "Up_conv2",
                 "DeConv_1x1"]
# the top-level modules in forward order: the pretrain pipeline freezes by them
COMPONENT_NAMES = ENCODER_NAMES + DECODER_NAMES
TAP_NAMES = ["Conv1", "Conv2", "Conv3", "Conv4", "Conv5",
             "Up_conv5", "Up_conv4", "Up_conv3", "Up_conv2"]


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose running variance follows the biased batch variance,
    with fp32 statistics and a ``dtype`` output (flax's ``_normalize``).
    ``update_stats`` off leaves the running statistics alone (a remat
    block's recompute). It takes any rank from [B, C] up (the statistics
    over every axis but the channels'): the zoo's 3-D models use it too.
    ``mask`` [B] / ``group``: see ``_masked_forward``."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5) -> None:
        super().__init__(num_features, eps=eps, momentum=0.1)
        self.out_dtype = dtype
        self.update_stats = True

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        # a bf16 input with a bf16 output normalizes in fp32 inside batch_norm;
        # any other pair normalizes the fp32 input
        x_in = x if x.dtype == self.out_dtype else x.float()
        if not self.training:
            y = F.batch_norm(x_in, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(self.out_dtype)
        if mask is not None or group is not None:
            return self._masked_forward(x, mask, group)
        if self.update_stats:
            with torch.no_grad():
                dims = (0,) + tuple(range(2, x.dim()))
                var, mean = torch.var_mean(x.to(self.running_var.dtype), dim=dims, unbiased=False)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        y = F.batch_norm(x_in, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.out_dtype)

    def _masked_forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                        group) -> torch.Tensor:
        """Train-mode BN over the rows ``mask`` marks (all without one), of
        this rank and, with ``group``, of every rank of it: fp32 sums and
        counts (float64 for a float64 input, as the one-process path keeps
        them) summed over the group, mean, then the biased variance of the
        same rows (two passes). Gradients reach every rank's rows through
        ``all_reduce_sum``."""
        dims = (0,) + tuple(range(2, x.dim()))
        view = (1, -1) + (1,) * (x.dim() - 2)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        per_row = x[0, 0].numel()
        if mask is None:
            w = None
            count = x32.new_full((1,), float(x.shape[0] * per_row))
        else:
            w = mask.detach().to(x32.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
            count = (w.sum() * per_row).reshape(1)
        sums = all_reduce_sum(torch.cat([(x32 if w is None else x32 * w).sum(dims), count]),
                              group)
        mean = sums[:-1] / sums[-1]
        d = x32 - mean.view(view)
        sq = d * d
        var = all_reduce_sum((sq if w is None else sq * w).sum(dims), group) / sums[-1]
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        y = d * torch.rsqrt(var + self.eps).view(view) * self.weight.view(view) \
            + self.bias.view(view)
        return y.to(self.out_dtype)


class Conv2d(nn.Conv2d):
    """3x3 convolution without bias computing in ``dtype``: input and weight
    are cast at the call, the weight stays fp32 (flax's ``param_dtype``)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_ch, out_ch, 3, padding=1, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class ConvBlock(nn.Module):
    """2x (Conv3x3 without bias -> BN -> ReLU)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, out_ch, dtype), BatchNorm2d(out_ch, bn_dtype), nn.ReLU(inplace=True),
            Conv2d(out_ch, out_ch, dtype), BatchNorm2d(out_ch, bn_dtype), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        return _run_layers(self.conv, x, mask, group)


class UpConv(nn.Module):
    """Nearest x2 upsample -> Conv3x3 without bias -> BN -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv2d(in_ch, out_ch, dtype), BatchNorm2d(out_ch, bn_dtype), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        return _run_layers(self.up, x, mask, group)


def _run_layers(layers: nn.Sequential, x: torch.Tensor, mask: Optional[torch.Tensor],
                group) -> torch.Tensor:
    """``layers(x)``, with ``mask`` and ``group`` handed to each BN layer."""
    if mask is None and group is None:
        return layers(x)
    for layer in layers:
        x = layer(x, mask, group) if isinstance(layer, BatchNorm2d) else layer(x)
    return x


def _remat(block: nn.Module, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
           group=None) -> torch.Tensor:
    """``block(x, mask, group)`` under non-reentrant
    ``torch.utils.checkpoint``: only the input is kept, and the backward runs
    the forward again (its BN sums over ``group`` too, on every rank alike)
    with the BN running statistics left alone."""
    runs = count()
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]

    def run(inp: torch.Tensor) -> torch.Tensor:
        first = next(runs) == 0
        for m in norms:
            m.update_stats = first
        try:
            return block(inp, mask, group)
        finally:
            for m in norms:
                m.update_stats = True

    return checkpoint(run, x, use_reentrant=False)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/r, W/r, r*r*C] (pixel-unshuffle, channel
    (ry * r + rx) * C + c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, r*r*C] -> [B, H*r, W*r, C] (pixel-shuffle, the inverse)."""
    b, h, w, rc = x.shape
    c = rc // (r * r)
    x = x.reshape(b, h, w, r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, c)


class UNet(nn.Module):
    dimension_dict = UNET_DIMENSIONS

    def __init__(self, input_dim: int = 1, num_classes: int = 4,
                 dtype: torch.dtype = torch.float32, bn_dtype: torch.dtype = torch.float32,
                 stem: str = "conv", remat: bool = False) -> None:
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"stem={stem!r}: expected 'conv' | 's2d'")
        self.dtype, self.bn_dtype, self.stem, self.remat = dtype, bn_dtype, stem, bool(remat)
        r2 = 4 if stem == "s2d" else 1
        dt = (dtype, bn_dtype)
        self.Conv1 = ConvBlock(input_dim * r2, 16, *dt)
        self.Conv2 = ConvBlock(16, 32, *dt)
        self.Conv3 = ConvBlock(32, 64, *dt)
        self.Conv4 = ConvBlock(64, 128, *dt)
        self.Conv5 = ConvBlock(128, 256, *dt)
        self.Up5 = UpConv(256, 128, *dt)
        self.Up_conv5 = ConvBlock(256, 128, *dt)
        self.Up4 = UpConv(128, 64, *dt)
        self.Up_conv4 = ConvBlock(128, 64, *dt)
        self.Up3 = UpConv(64, 32, *dt)
        self.Up_conv3 = ConvBlock(64, 32, *dt)
        self.Up2 = UpConv(32, 16, *dt)
        self.Up_conv2 = ConvBlock(32, 16, *dt)
        self.DeConv_1x1 = nn.Conv2d(16, num_classes * r2, 1)
        nn.init.zeros_(self.DeConv_1x1.bias)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                bn_mask: Optional[torch.Tensor] = None, bn_group=None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        """x: [B, H, W, input_dim]. Returns fp32 logits [B, H, W, C] and, with
        ``return_features``, the nine named taps, each [B, h, w, c].
        ``bn_mask`` [B] (the real rows) and ``bn_group`` (a process group)
        reach every train-mode BN layer (``BatchNorm2d._masked_forward``)."""
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)
        if self.remat and self.training and torch.is_grad_enabled():
            blk = lambda block, inp: _remat(block, inp, bn_mask, bn_group)
        else:
            blk = lambda block, inp: block(inp, bn_mask, bn_group)
        e1 = blk(self.Conv1, x)
        e2 = blk(self.Conv2, F.max_pool2d(e1, 2))
        e3 = blk(self.Conv3, F.max_pool2d(e2, 2))
        e4 = blk(self.Conv4, F.max_pool2d(e3, 2))
        e5 = blk(self.Conv5, F.max_pool2d(e4, 2))
        d5 = blk(self.Up_conv5, torch.cat([e4, blk(self.Up5, e5)], dim=1))
        d4 = blk(self.Up_conv4, torch.cat([e3, blk(self.Up4, d5)], dim=1))
        d3 = blk(self.Up_conv3, torch.cat([e2, blk(self.Up3, d4)], dim=1))
        d2 = blk(self.Up_conv2, torch.cat([e1, blk(self.Up2, d3)], dim=1))
        head, dt = self.DeConv_1x1, self.dtype
        logits = F.conv2d(d2.to(dt), head.weight.to(dt)) + head.bias.to(dt)[:, None, None]
        logits = logits.permute(0, 2, 3, 1)
        if self.stem == "s2d":
            logits = depth_to_space(logits, 2)
        logits = logits.float()
        if not return_features:
            return logits
        taps = {"Conv1": e1, "Conv2": e2, "Conv3": e3, "Conv4": e4, "Conv5": e5,
                "Up_conv5": d5, "Up_conv4": d4, "Up_conv3": d3, "Up_conv2": d2}
        return logits, {k: v.permute(0, 2, 3, 1) for k, v in taps.items()}


def weight_norm(model: nn.Module) -> "OrderedDict[str, float]":
    """The L2 norm of each parameter, by its name (a debug dump)."""
    return OrderedDict((name, float(torch.linalg.vector_norm(p.detach().float())))
                       for name, p in model.named_parameters())


def component_param_filter(names: Sequence[str]) -> Callable[[str], bool]:
    """A predicate over parameter names (``Conv1.conv.0.weight``): true when
    the name belongs to one of the components ``names``."""
    names = set(names)
    return lambda param_name: param_name.split(".", 1)[0] in names
