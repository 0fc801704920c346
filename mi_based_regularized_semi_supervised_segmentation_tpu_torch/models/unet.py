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
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

UNET_DIMENSIONS: Dict[str, int] = {
    "Conv1": 16, "Conv2": 32, "Conv3": 64, "Conv4": 128, "Conv5": 256,
    "Up_conv5": 128, "Up_conv4": 64, "Up_conv3": 32, "Up_conv2": 16,
}
ENCODER_NAMES = ["Conv1", "Conv2", "Conv3", "Conv4", "Conv5"]
DECODER_NAMES = ["Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3", "Up2", "Up_conv2",
                 "DeConv_1x1"]
TAP_NAMES = ["Conv1", "Conv2", "Conv3", "Conv4", "Conv5",
             "Up_conv5", "Up_conv4", "Up_conv3", "Up_conv2"]


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose running variance follows the biased batch variance."""

    def __init__(self, num_features: int) -> None:
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBlock(nn.Module):
    """2x (Conv3x3 without bias -> BN -> ReLU)."""

    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False), BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False), BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UpConv(nn.Module):
    """Nearest x2 upsample -> Conv3x3 without bias -> BN -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False), BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class UNet(nn.Module):
    dimension_dict = UNET_DIMENSIONS

    def __init__(self, input_dim: int = 1, num_classes: int = 4) -> None:
        super().__init__()
        self.Conv1 = ConvBlock(input_dim, 16)
        self.Conv2 = ConvBlock(16, 32)
        self.Conv3 = ConvBlock(32, 64)
        self.Conv4 = ConvBlock(64, 128)
        self.Conv5 = ConvBlock(128, 256)
        self.Up5 = UpConv(256, 128)
        self.Up_conv5 = ConvBlock(256, 128)
        self.Up4 = UpConv(128, 64)
        self.Up_conv4 = ConvBlock(128, 64)
        self.Up3 = UpConv(64, 32)
        self.Up_conv3 = ConvBlock(64, 32)
        self.Up2 = UpConv(32, 16)
        self.Up_conv2 = ConvBlock(32, 16)
        self.DeConv_1x1 = nn.Conv2d(16, num_classes, 1)
        nn.init.zeros_(self.DeConv_1x1.bias)

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        """x: [B, H, W, input_dim]. Returns logits [B, H, W, C] and, with
        ``return_features``, the nine named taps, each [B, h, w, c]."""
        x = x.permute(0, 3, 1, 2).float()
        e1 = self.Conv1(x)
        e2 = self.Conv2(F.max_pool2d(e1, 2))
        e3 = self.Conv3(F.max_pool2d(e2, 2))
        e4 = self.Conv4(F.max_pool2d(e3, 2))
        e5 = self.Conv5(F.max_pool2d(e4, 2))
        d5 = self.Up_conv5(torch.cat([e4, self.Up5(e5)], dim=1))
        d4 = self.Up_conv4(torch.cat([e3, self.Up4(d5)], dim=1))
        d3 = self.Up_conv3(torch.cat([e2, self.Up3(d4)], dim=1))
        d2 = self.Up_conv2(torch.cat([e1, self.Up2(d3)], dim=1))
        logits = self.DeConv_1x1(d2).permute(0, 2, 3, 1)
        if not return_features:
            return logits
        taps = {"Conv1": e1, "Conv2": e2, "Conv3": e3, "Conv4": e4, "Conv5": e5,
                "Up_conv5": d5, "Up_conv4": d4, "Up_conv3": d3, "Up_conv2": d2}
        return logits, {k: v.permute(0, 2, 3, 1) for k, v in taps.items()}
