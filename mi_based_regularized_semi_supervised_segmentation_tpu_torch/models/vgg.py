"""VGG11 backbone and the classify head (counterpart of the JAX package's
``models/vgg.py``): NCHW images in, [B, 512] features out; module names are
flax's (``conv{i}`` / ``bn{i}`` at the config index, ``Dense_0`` /
``Dense_1``), so ``weights.py`` maps them across."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import BatchNorm2d
from .zoo import Conv2d, Linear

VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class VGG11(nn.Module):
    """Eight 3x3 convolutions (each BN in fp32 and ReLU) between five 2x2 max
    pools, then the mean over the map: [B, input_dim, H, W] -> [B, 512]."""

    def __init__(self, input_dim: int = 1, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        ch = input_dim
        for i, spec in enumerate(VGG11_CFG):
            if spec != "M":
                setattr(self, f"conv{i}", Conv2d(ch, spec, 3, padding=1, dtype=dtype))
                setattr(self, f"bn{i}", BatchNorm2d(spec, torch.float32))
                ch = spec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, spec in enumerate(VGG11_CFG):
            if spec == "M":
                x = F.max_pool2d(x, 2)
            else:
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x.mean(dim=(2, 3))


class ClassifyHead(nn.Module):
    """Dense -> leaky ReLU (0.01) -> Dense; returns (projection, logits)."""

    def __init__(self, in_dim: int = 512, num_classes: int = 10, interm_dim: int = 256) -> None:
        super().__init__()
        self.Dense_0 = Linear(in_dim, interm_dim)
        self.Dense_1 = Linear(interm_dim, num_classes)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        proj = F.leaky_relu(self.Dense_0(features), 0.01)
        return proj, self.Dense_1(proj)
