"""Architecture registry and the other segmentation model families
(counterpart of the JAX package's ``models/zoo.py``).

``get_arch(name, kwargs)`` builds a registered model: names are lower-cased
and an ``arch`` key in ``kwargs`` is dropped; an unknown name raises
``KeyError`` (the JAX package asserts). Registered: ``contrastunet`` and
``unet`` (the port's ``UNet``), ``enet``, ``attention_unet``, ``vnet``,
``deeplabv2``, ``deeplabv3``, ``deeplabv3plus``, ``densenet3d``.

Each family has the JAX modules' structure and names (``b1_0.proj_in``,
``backbone.layer3_2.conv``, ``enc2.PReLU_1``, ...), so ``weights.py`` maps a
flax tree across name for name. Unlike ``UNet``, whose forward keeps the
trainer's NHWC, the zoo's models take and return PyTorch's layouts: images
[B, C, H, W] (VNet, DenseNet3D: [B, C, D, H, W]), logits [B, classes, H, W]
(DenseNet3D: [B, classes]).

Numerics follow flax: parameters stay fp32 and each convolution casts its
input and weight to ``dtype`` at the call and adds its bias after, in
``dtype``; BatchNorm is ``models/unet.py:BatchNorm2d`` (fp32 statistics,
biased running variance, momentum 0.1 = flax's 0.9, a ``bn_dtype`` output;
eps 1e-3 in ENet, 1e-5 elsewhere); ``nn.PReLU`` is one slope initialised to
0.01 (torch's default is 0.25); where flax mixes dtypes (a bf16 branch plus
an fp32 residual) torch promotes the same way. flax's ``nn.ConvTranspose``
does not flip its kernel: ``weights.py`` flips it into
``F.conv_transpose3d``'s. ``jax.image.resize`` ("nearest" x2, "bilinear"
upsampling) is ``F.interpolate`` with ``align_corners=False``.

ENet's dropout draws its keep masks from the model's ``generator`` (a
``torch.Generator`` on the input's device, or torch's default one); a test
replaces ``Dropout.draw`` to feed the JAX side's masks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import BatchNorm2d, ConvBlock, UNet, UpConv

F32 = torch.float32
ARCH_CALLABLES: Dict[str, Callable[..., nn.Module]] = {}


def register_arch(name: str, callable_: Callable[..., nn.Module]) -> None:
    ARCH_CALLABLES[name.lower()] = callable_


def get_arch(arch: str, kwargs: Dict[str, Any]) -> nn.Module:
    """The registered model ``arch`` built from ``kwargs`` (its ``arch`` key
    dropped)."""
    kwargs = dict(kwargs)
    kwargs.pop("arch", None)
    fn = ARCH_CALLABLES.get(arch.lower())
    if fn is None:
        raise KeyError(f"Architecture {arch} is not found! Registered: {sorted(ARCH_CALLABLES)}")
    return fn(**kwargs)


# --------------------------------------------------------------------------
# layers with flax's numerics
# --------------------------------------------------------------------------
class _DtypeConv:
    """flax ``nn.Conv``'s numerics: the input and the fp32 weight cast to
    ``compute_dtype``, the bias added after the convolution in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(-1, *([1] * (y.dim() - 2)))
        return y


class Conv2d(_DtypeConv, nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0, dilation=1,
                 bias: bool = True, dtype: torch.dtype = F32) -> None:
        super().__init__(in_ch, out_ch, kernel, stride, padding, dilation, bias=bias)
        self.compute_dtype = dtype


class Conv3d(_DtypeConv, nn.Conv3d):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                 bias: bool = True, dtype: torch.dtype = F32) -> None:
        super().__init__(in_ch, out_ch, kernel, stride, padding, bias=bias)
        self.compute_dtype = dtype


class ConvTranspose3d(nn.ConvTranspose3d):
    """flax ``nn.ConvTranspose`` at kernel = stride (its "SAME" output is the
    input times the stride); the weight [in, out, kd, kh, kw] is the flax
    kernel flipped in its three spatial axes (``weights.py``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype = F32) -> None:
        super().__init__(in_ch, out_ch, kernel, stride=kernel)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv_transpose3d(x.to(dt), self.weight.to(dt), None, stride=self.stride)
        return y + self.bias.to(dt).view(-1, 1, 1, 1)


class Linear(nn.Linear):
    """flax ``nn.Dense`` in ``dtype``: x @ W, then the bias."""

    def __init__(self, in_f: int, out_f: int, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(in_f, out_f)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, F32)
        return x.to(dt) @ self.weight.to(dt).t() + self.bias.to(dt)


class PReLU(nn.PReLU):
    """flax ``nn.PReLU``: one slope, initialised to 0.01, applied in the
    input's dtype."""

    def __init__(self) -> None:
        super().__init__(1, init=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in train mode: x / keep where the keep mask is
    set, 0 elsewhere; the mask comes from ``draw``."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        """The keep mask: uniform draws below 1 - rate."""
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return u < 1.0 - self.rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(self.draw(x), x / keep, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))


def _resize(x: torch.Tensor, size: Sequence[int], mode: str) -> torch.Tensor:
    """``jax.image.resize`` upsampling (half-pixel centres)."""
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=False)


def _resize2x(x: torch.Tensor) -> torch.Tensor:
    return _resize(x, [2 * n for n in x.shape[2:]], "nearest")


def _avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2^3 average pool; a bf16 input is summed in fp32 and rounded once (the
    card's bf16 kernel does the same; the CPU has none)."""
    if x.dtype == torch.bfloat16:
        return F.avg_pool3d(x.float(), 2).to(x.dtype)
    return F.avg_pool3d(x, 2)


def _flax_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pads the spatial axes as flax's "SAME" does at a stride: the total
    max((ceil(n / s) - 1) s + k - n, 0), the smaller half first."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


# --------------------------------------------------------------------------
# ENet
# --------------------------------------------------------------------------
class _ENetInitial(nn.Module):
    """Conv (stride 2, 16 - input_dim channels) || 2x2 max pool -> 16."""

    def __init__(self, input_dim: int, out: int = 16, dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        self.conv = Conv2d(input_dim, out - input_dim, 3, 2, 1, dtype=dtype)
        self.bn = BatchNorm2d(out - input_dim, bn_dtype, eps=1e-3)
        self.PReLU_0 = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.PReLU_0(self.bn(self.conv(x)))
        return torch.cat([conv, F.max_pool2d(x, 2)], dim=1)


class _Bottleneck(nn.Module):
    """1x1 in -> (3x3, dilated 3x3, 5x1 + 1x5, or 2x2 stride 2) -> 1x1 out,
    dropout, residual add (pooled and zero-padded in channels when it
    downsamples or widens), PReLU."""

    def __init__(self, in_ch: int, out: int, downsample: bool = False, dilation: int = 1,
                 asymmetric: bool = False, dropout: float = 0.1, dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        internal = out // 4
        self.downsample, self.asymmetric, self.out = downsample, asymmetric, out
        self.proj_in = Conv2d(in_ch, internal, 2 if downsample else 1, 2 if downsample else 1,
                              bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(internal, bn_dtype, eps=1e-3)
        self.PReLU_0 = PReLU()
        if asymmetric:
            self.conv5x1 = Conv2d(internal, internal, (5, 1), padding=(2, 0), bias=False,
                                  dtype=dtype)
            self.conv1x5 = Conv2d(internal, internal, (1, 5), padding=(0, 2), bias=False,
                                  dtype=dtype)
        else:
            self.conv = Conv2d(internal, internal, 3, padding=dilation, dilation=dilation,
                               bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(internal, bn_dtype, eps=1e-3)
        self.PReLU_1 = PReLU()
        self.proj_out = Conv2d(internal, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out, bn_dtype, eps=1e-3)
        self.drop = Dropout(dropout)
        self.PReLU_2 = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.PReLU_0(self.bn1(self.proj_in(x)))
        h = self.conv1x5(self.conv5x1(h)) if self.asymmetric else self.conv(h)
        h = self.PReLU_1(self.bn2(h))
        h = self.drop(self.bn3(self.proj_out(h)))
        res = F.max_pool2d(x, 2) if self.downsample else x
        if res.shape[1] != self.out:
            res = F.pad(res, (0, 0, 0, 0, 0, self.out - res.shape[1]))
        return self.PReLU_2(h + res)


class _ENetUp(nn.Module):
    """Nearest x2 resize -> 3x3 conv -> BN -> PReLU (the JAX package's
    replacement of max-unpooling)."""

    def __init__(self, in_ch: int, out: int, dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        self.conv = Conv2d(in_ch, out, 3, padding=1, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(out, bn_dtype, eps=1e-3)
        self.PReLU_0 = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLU_0(self.bn(self.conv(_resize2x(x))))


class ENet(nn.Module):
    """ENet for 2-D segmentation: 16 -> 64 -> 128 channels, stage 2 mixing
    dilated and asymmetric bottlenecks, a two-stage decoder. ``generator``:
    the dropout draws'."""

    def __init__(self, input_dim: int = 1, num_classes: int = 4, dtype=F32, bn_dtype=F32,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, bn_dtype=bn_dtype)
        self.initial = _ENetInitial(input_dim, **kw)
        self.b1_0 = _Bottleneck(16, 64, downsample=True, dropout=0.01, **kw)
        for i in range(4):
            setattr(self, f"b1_{i + 1}", _Bottleneck(64, 64, dropout=0.01, **kw))
        self.b2_0 = _Bottleneck(64, 128, downsample=True, **kw)
        for rep in range(2):
            setattr(self, f"b2_{rep}_1", _Bottleneck(128, 128, **kw))
            setattr(self, f"b2_{rep}_2", _Bottleneck(128, 128, dilation=2, **kw))
            setattr(self, f"b2_{rep}_3", _Bottleneck(128, 128, asymmetric=True, **kw))
            setattr(self, f"b2_{rep}_4", _Bottleneck(128, 128, dilation=4, **kw))
        self.up1 = _ENetUp(128, 64, **kw)
        self.b4_1 = _Bottleneck(64, 64, **kw)
        self.up2 = _ENetUp(64, 16, **kw)
        self.b5_1 = _Bottleneck(16, 16, **kw)
        self.head = Conv2d(16, num_classes, 1, dtype=F32)
        self.set_generator(generator)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, input_dim, H, W] -> fp32 logits [B, num_classes, H, W]."""
        for block in self.children():
            if block is self.head:
                break
            x = block(x)
        return self.head(_resize2x(x))


# --------------------------------------------------------------------------
# Attention U-Net
# --------------------------------------------------------------------------
class _AttentionGate(nn.Module):
    """x * sigmoid(psi(relu(W_g g + W_x x)))."""

    def __init__(self, g_ch: int, x_ch: int, inter: int, dtype=F32) -> None:
        super().__init__()
        self.W_g = Conv2d(g_ch, inter, 1, dtype=dtype)
        self.W_x = Conv2d(x_ch, inter, 1, dtype=dtype)
        self.psi = Conv2d(inter, 1, 1, dtype=dtype)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        a = self.psi(F.relu(self.W_g(g) + self.W_x(x)))
        return x * torch.sigmoid(a)


class AttentionUNet(nn.Module):
    """The U-Net skeleton (``models/unet.py``'s blocks, 16..256 channels)
    with an attention gate on every skip connection."""

    def __init__(self, input_dim: int = 1, num_classes: int = 4, dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        dt = (dtype, bn_dtype)
        self.Conv1 = ConvBlock(input_dim, 16, *dt)
        self.Conv2 = ConvBlock(16, 32, *dt)
        self.Conv3 = ConvBlock(32, 64, *dt)
        self.Conv4 = ConvBlock(64, 128, *dt)
        self.Conv5 = ConvBlock(128, 256, *dt)
        for level, ch in ((5, 128), (4, 64), (3, 32), (2, 16)):
            setattr(self, f"Up{level}", UpConv(2 * ch, ch, *dt))
            setattr(self, f"Att{level}", _AttentionGate(ch, ch, ch // 2, dtype))
            setattr(self, f"Up_conv{level}", ConvBlock(2 * ch, ch, *dt))
        self.DeConv_1x1 = Conv2d(16, num_classes, 1, dtype=F32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, input_dim, H, W] -> fp32 logits [B, num_classes, H, W]."""
        skips = [self.Conv1(x)]
        for block in (self.Conv2, self.Conv3, self.Conv4, self.Conv5):
            skips.append(block(F.max_pool2d(skips[-1], 2)))
        d = skips.pop()
        for level in (5, 4, 3, 2):
            d = getattr(self, f"Up{level}")(d)
            a = getattr(self, f"Att{level}")(d, skips.pop())
            d = getattr(self, f"Up_conv{level}")(torch.cat([a, d], dim=1))
        return self.DeConv_1x1(d)


# --------------------------------------------------------------------------
# VNet (3-D)
# --------------------------------------------------------------------------
class _VNetStage(nn.Module):
    """n x (5^3 conv + PReLU), plus the input (its channel block repeated up
    to ``ch`` when narrower)."""

    def __init__(self, in_ch: int, ch: int, n_convs: int, dtype=F32) -> None:
        super().__init__()
        self.ch, self.n_convs = ch, n_convs
        for i in range(n_convs):
            setattr(self, f"conv{i}", Conv3d(in_ch if i == 0 else ch, ch, 5, padding=2,
                                             dtype=dtype))
            setattr(self, f"PReLU_{i}", PReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_convs):
            h = getattr(self, f"PReLU_{i}")(getattr(self, f"conv{i}")(h))
        if x.shape[1] != self.ch:
            x = x.repeat(1, self.ch // x.shape[1], 1, 1, 1)
        return h + x


class VNet(nn.Module):
    """Compact VNet: 2^3 stride-2 convolutions down (16 -> 32 -> 64 -> 128),
    2^3 transposed convolutions up with skip concatenation, residual stages
    throughout; no BN."""

    def __init__(self, input_dim: int = 1, num_classes: int = 4, dtype=F32) -> None:
        super().__init__()
        self.enc1 = _VNetStage(input_dim, 16, 1, dtype)
        self.down1 = Conv3d(16, 32, 2, 2, dtype=dtype)
        self.enc2 = _VNetStage(32, 32, 2, dtype)
        self.down2 = Conv3d(32, 64, 2, 2, dtype=dtype)
        self.enc3 = _VNetStage(64, 64, 3, dtype)
        self.down3 = Conv3d(64, 128, 2, 2, dtype=dtype)
        self.bottom = _VNetStage(128, 128, 3, dtype)
        self.up3 = ConvTranspose3d(128, 64, 2, dtype)
        self.dec3 = _VNetStage(128, 128, 3, dtype)
        self.up2 = ConvTranspose3d(128, 32, 2, dtype)
        self.dec2 = _VNetStage(64, 64, 2, dtype)
        self.up1 = ConvTranspose3d(64, 16, 2, dtype)
        self.dec1 = _VNetStage(32, 32, 1, dtype)
        self.head = Conv3d(32, num_classes, 1, dtype=F32)
        for i in range(6):  # after down1..3, then up3..1, as flax numbers them
            setattr(self, f"PReLU_{i}", PReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, input_dim, D, H, W] -> fp32 logits [B, num_classes, D, H, W]."""
        s1 = self.enc1(x)
        s2 = self.enc2(self.PReLU_0(self.down1(_flax_same(s1, 2, 2))))
        s3 = self.enc3(self.PReLU_1(self.down2(_flax_same(s2, 2, 2))))
        s4 = self.bottom(self.PReLU_2(self.down3(_flax_same(s3, 2, 2))))
        s5 = self.dec3(torch.cat([self.PReLU_3(self.up3(s4)), s3], dim=1))
        s6 = self.dec2(torch.cat([self.PReLU_4(self.up2(s5)), s2], dim=1))
        s7 = self.dec1(torch.cat([self.PReLU_5(self.up1(s6)), s1], dim=1))
        return self.head(s7)


# --------------------------------------------------------------------------
# DeepLab v2 / v3 / v3+ over a dilated bottleneck ResNet (output stride 8)
# --------------------------------------------------------------------------
class _BottleneckRes(nn.Module):
    """1x1 -> 3x3 (strided or dilated) -> 1x1 (4 x ch) residual bottleneck,
    BN + ReLU; a 1x1 projection of the input when it changes shape."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1, dilation: int = 1, dtype=F32,
                 bn_dtype=F32) -> None:
        super().__init__()
        out = 4 * ch
        self.reduce = Conv2d(in_ch, ch, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(ch, bn_dtype)
        self.conv = Conv2d(ch, ch, 3, stride, dilation, dilation, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(ch, bn_dtype)
        self.expand = Conv2d(ch, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out, bn_dtype)
        if in_ch != out or stride != 1:
            self.proj = Conv2d(in_ch, out, 1, stride, bias=False, dtype=dtype)
            self.bn_proj = BatchNorm2d(out, bn_dtype)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.reduce(x)))
        h = F.relu(self.bn2(self.conv(h)))
        h = self.bn3(self.expand(h))
        if self.proj is not None:
            x = self.bn_proj(self.proj(x))
        return F.relu(x + h)


class _DilatedResNet(nn.Module):
    """7x7 stride-2 stem, 3x3 stride-2 max pool, four bottleneck stages
    (widths 64..512; stages 3 and 4 dilated 2 and 4 instead of strided).
    Returns (the stage-1 features at stride 4, the stage-4 features)."""

    PLAN = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))  # (width, stride, dilation)

    def __init__(self, input_dim: int = 3, n_blocks: Sequence[int] = (2, 2, 2, 2), dtype=F32,
                 bn_dtype=F32) -> None:
        super().__init__()
        self.stem = Conv2d(input_dim, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.stem_bn = BatchNorm2d(64, bn_dtype)
        self.blocks = []
        in_ch = 64
        for si, ((ch, stride, dil), n) in enumerate(zip(self.PLAN, n_blocks)):
            for bi in range(n):
                name = f"layer{si + 1}_{bi}"
                setattr(self, name, _BottleneckRes(in_ch, ch, stride if bi == 0 else 1, dil,
                                                   dtype, bn_dtype))
                self.blocks.append((si, name))
                in_ch = 4 * ch
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        low = None
        for si, name in self.blocks:
            x = getattr(self, name)(x)
            if si == 0:
                low = x  # os = 4 low-level features for the v3+ decoder
        return low, x


class DeepLabV2(nn.Module):
    """Backbone -> the sum of dilated 3x3 convolutions (the v2 ASPP) ->
    bilinear resize to the input."""

    def __init__(self, input_dim: int = 3, num_classes: int = 10,
                 n_blocks: Sequence[int] = (2, 2, 2, 2),
                 pyramids: Sequence[int] = (6, 12, 18, 24), dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        self.backbone = _DilatedResNet(input_dim, n_blocks, dtype, bn_dtype)
        self.pyramids = tuple(pyramids)
        for i, d in enumerate(self.pyramids):
            setattr(self, f"aspp{i}", Conv2d(self.backbone.out_channels, num_classes, 3,
                                              padding=d, dilation=d, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, feat = self.backbone(x)
        logits = 0
        for i in range(len(self.pyramids)):
            logits = logits + getattr(self, f"aspp{i}")(feat)
        return _resize(logits, x.shape[2:], "bilinear").float()


class _ASPPv3(nn.Module):
    """1x1 and dilated 3x3 branches and an image-level branch (global mean,
    1x1, BN over the [B, C, 1, 1] map, broadcast back), concatenated, then
    a 1x1 projection."""

    def __init__(self, in_ch: int, ch: int = 256, rates: Sequence[int] = (6, 12, 18), dtype=F32,
                 bn_dtype=F32) -> None:
        super().__init__()
        self.rates = tuple(rates)
        self.c_1x1 = Conv2d(in_ch, ch, 1, bias=False, dtype=dtype)
        self.bn_1x1 = BatchNorm2d(ch, bn_dtype)
        for i, d in enumerate(self.rates):
            setattr(self, f"c_r{i}", Conv2d(in_ch, ch, 3, padding=d, dilation=d, bias=False,
                                            dtype=dtype))
            setattr(self, f"bn_r{i}", BatchNorm2d(ch, bn_dtype))
        self.c_img = Conv2d(in_ch, ch, 1, bias=False, dtype=dtype)
        self.bn_img = BatchNorm2d(ch, bn_dtype)
        self.project = Conv2d((len(self.rates) + 2) * ch, ch, 1, bias=False, dtype=dtype)
        self.bn_proj = BatchNorm2d(ch, bn_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(self.bn_1x1(self.c_1x1(x)))]
        for i in range(len(self.rates)):
            branches.append(F.relu(getattr(self, f"bn_r{i}")(getattr(self, f"c_r{i}")(x))))
        pooled = F.relu(self.bn_img(self.c_img(x.mean(dim=(2, 3), keepdim=True))))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return F.relu(self.bn_proj(self.project(torch.cat(branches, dim=1))))


class DeepLabV3(nn.Module):
    def __init__(self, input_dim: int = 3, num_classes: int = 10,
                 n_blocks: Sequence[int] = (2, 2, 2, 2), rates: Sequence[int] = (6, 12, 18),
                 dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        self.backbone = _DilatedResNet(input_dim, n_blocks, dtype, bn_dtype)
        self.aspp = _ASPPv3(self.backbone.out_channels, 256, rates, dtype, bn_dtype)
        self.classifier = Conv2d(256, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, feat = self.backbone(x)
        logits = self.classifier(self.aspp(feat))
        return _resize(logits, x.shape[2:], "bilinear").float()


class DeepLabV3Plus(nn.Module):
    """The v3 ASPP and the v3+ decoder: the ASPP output resized to the
    stride-4 features, concatenated with their 48-channel projection, two
    3x3 convolutions, the classifier, a resize to the input."""

    def __init__(self, input_dim: int = 3, num_classes: int = 10,
                 n_blocks: Sequence[int] = (2, 2, 2, 2), rates: Sequence[int] = (6, 12, 18),
                 dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        self.backbone = _DilatedResNet(input_dim, n_blocks, dtype, bn_dtype)
        self.aspp = _ASPPv3(self.backbone.out_channels, 256, rates, dtype, bn_dtype)
        self.low_proj = Conv2d(4 * _DilatedResNet.PLAN[0][0], 48, 1, bias=False, dtype=dtype)
        self.bn_low = BatchNorm2d(48, bn_dtype)
        self.dec0 = Conv2d(256 + 48, 256, 3, padding=1, bias=False, dtype=dtype)
        self.bn_dec0 = BatchNorm2d(256, bn_dtype)
        self.dec1 = Conv2d(256, 256, 3, padding=1, bias=False, dtype=dtype)
        self.bn_dec1 = BatchNorm2d(256, bn_dtype)
        self.classifier = Conv2d(256, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low, feat = self.backbone(x)
        h = _resize(self.aspp(feat), low.shape[2:], "bilinear")
        low = F.relu(self.bn_low(self.low_proj(low)))
        h = torch.cat([h, low], dim=1)
        h = F.relu(self.bn_dec0(self.dec0(h)))
        h = F.relu(self.bn_dec1(self.dec1(h)))
        return _resize(self.classifier(h), x.shape[2:], "bilinear").float()


# --------------------------------------------------------------------------
# DenseNet3D: a volumetric DenseNet classifier
# --------------------------------------------------------------------------
class _DenseLayer3D(nn.Module):
    """BN-ReLU-1^3 conv (bn_size x growth) -> BN-ReLU-3^3 conv (growth),
    concatenated to the input."""

    def __init__(self, in_ch: int, growth: int, bn_size: int = 4, dtype=F32, bn_dtype=F32) -> None:
        super().__init__()
        self.bn1 = BatchNorm2d(in_ch, bn_dtype)
        self.conv1 = Conv3d(in_ch, bn_size * growth, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(bn_size * growth, bn_dtype)
        self.conv2 = Conv3d(bn_size * growth, growth, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return torch.cat([x, h], dim=1)


class DenseNet3D(nn.Module):
    """[B, input_dim, D, H, W] -> class logits [B, num_classes]: a 3^3 stem
    at stride (1, 2, 2), dense blocks with 1^3-conv + 2^3 average-pool
    transitions, BN-ReLU, a global mean, a dense classifier."""

    def __init__(self, input_dim: int = 1, num_classes: int = 2, growth_rate: int = 16,
                 block_config: Sequence[int] = (2, 2, 2), init_features: int = 32, dtype=F32,
                 bn_dtype=F32) -> None:
        super().__init__()
        self.block_config = tuple(block_config)
        self.stem = Conv3d(input_dim, init_features, 3, (1, 2, 2), 1, bias=False, dtype=dtype)
        ch = init_features
        for bi, n_layers in enumerate(self.block_config):
            for li in range(n_layers):
                setattr(self, f"block{bi}_layer{li}", _DenseLayer3D(ch, growth_rate,
                                                                     dtype=dtype, bn_dtype=bn_dtype))
                ch += growth_rate
            if bi != len(self.block_config) - 1:
                setattr(self, f"trans_bn{bi}", BatchNorm2d(ch, bn_dtype))
                setattr(self, f"trans{bi}", Conv3d(ch, ch // 2, 1, bias=False, dtype=dtype))
                ch //= 2
        self.final_bn = BatchNorm2d(ch, bn_dtype)
        self.classifier = Linear(ch, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for bi, n_layers in enumerate(self.block_config):
            for li in range(n_layers):
                x = getattr(self, f"block{bi}_layer{li}")(x)
            if bi != len(self.block_config) - 1:
                x = getattr(self, f"trans{bi}")(F.relu(getattr(self, f"trans_bn{bi}")(x)))
                x = _avg_pool3d(x)
        x = F.relu(self.final_bn(x)).mean(dim=(2, 3, 4))
        return self.classifier(x).float()


register_arch("ContrastUnet", UNet)
register_arch("unet", UNet)
register_arch("enet", ENet)
register_arch("attention_unet", AttentionUNet)
register_arch("vnet", VNet)
register_arch("deeplabv2", DeepLabV2)
register_arch("deeplabv3", DeepLabV3)
register_arch("deeplabv3plus", DeepLabV3Plus)
register_arch("densenet3d", DenseNet3D)
