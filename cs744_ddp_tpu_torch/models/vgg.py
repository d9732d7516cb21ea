"""Config-table-driven VGG family for 32x32x3 inputs, 10 classes.

3x3 conv (pad 1, bias) + BatchNorm + ReLU blocks with a 2x2/2 max pool at
the "M" markers, then a flatten-512 -> Linear(512, 10) head — the reference
package's ``models/vgg.py``.  A conv followed by "M" goes Conv ->
``BnReluPool2d`` (the fused op); any other conv goes Conv -> BN -> ReLU.
Activations are NCHW-logical in ``torch.channels_last`` memory.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers

CFG = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

NUM_CLASSES = 10


class ConvBlock(nn.Module):
    """Conv -> BN -> ReLU, with the 2x2 pool fused in when ``pool``."""

    def __init__(self, in_ch: int, out_ch: int, pool: bool):
        super().__init__()
        self.pool = pool
        self.conv = layers.conv3x3(in_ch, out_ch)
        self.bn = layers.BnReluPool2d(out_ch) if pool \
            else layers.batchnorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.pool else F.relu(x)


class VGG(nn.Module):
    """x: [N,3,32,32] f32 (channels_last) -> logits [N,10]."""

    def __init__(self, name: str = "VGG11"):
        super().__init__()
        cfg = CFG[name]
        blocks = []
        in_ch = 3
        for i, v in enumerate(cfg):
            if v == "M":
                continue
            pool = i + 1 < len(cfg) and cfg[i + 1] == "M"
            blocks.append(ConvBlock(in_ch, v, pool))
            in_ch = v
        self.name = name
        self.blocks = nn.ModuleList(blocks)
        self.fc1 = layers.linear(512, NUM_CLASSES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        # After 5 pools: [N,512,1,1] -> flatten 512.
        return self.fc1(x.flatten(1))
