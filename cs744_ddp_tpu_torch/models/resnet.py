"""ResNet-18/34 for 32x32x3 inputs, 10 classes — the reference package's
``models/resnet.py`` (BASELINE.json config #5, the scaling stress model).

The CIFAR-adapted BasicBlock ResNet: a 3x3 stem conv + BN + ReLU (no 7x7,
no max pool), four stages of BasicBlocks at widths 64/128/256/512 with
strides 1/2/2/2, a global average pool and ``Linear(512, 10)``.  ResNet-18
has (2, 2, 2, 2) blocks per stage, ResNet-34 (3, 4, 6, 3).  Convolutions
have no bias (a BatchNorm follows each).  A block is
``relu(bn2(conv2(relu(bn1(conv1(x))))) + shortcut)``; the shortcut is a
1x1 conv + BN where the stride or the width changes, else ``x``.

The module names are the reference pytree's keys (``stem_conv``,
``stem_bn``, ``blocks[i].conv1`` ... ``down_bn``, ``fc``), so
``models/convert.py`` maps the two trees name for name.  Every BatchNorm is
the library's: no block ends in a pool, so the fused BN->ReLU->MaxPool op
and its kernels do not run here.  Activations are NCHW-logical in
``torch.channels_last`` memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))
BLOCK_COUNTS = {"ResNet18": (2, 2, 2, 2), "ResNet34": (3, 4, 6, 3)}
NUM_CLASSES = 10


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = layers.conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = layers.batchnorm(out_ch)
        self.conv2 = layers.conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = layers.batchnorm(out_ch)
        self.down_conv: Optional[nn.Module] = None
        if stride != 1 or in_ch != out_ch:
            self.down_conv = layers.conv2d(in_ch, out_ch, 1, stride, 0,
                                           bias=False)
            self.down_bn = layers.batchnorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + sc)


class ResNet(nn.Module):
    """x: [N,3,H,W] f32 or bf16 (channels_last), H and W divisible by 8 ->
    logits [N,10] in x's dtype."""

    def __init__(self, name: str = "ResNet18"):
        super().__init__()
        self.name = name
        self.stem_conv = layers.conv2d(3, 64, 3, 1, 1, bias=False)
        self.stem_bn = layers.batchnorm(64)
        blocks = []
        in_ch = 64
        for (width, stage_stride), nblocks in zip(STAGES, BLOCK_COUNTS[name]):
            for b in range(nblocks):
                blocks.append(BasicBlock(in_ch, width,
                                         stage_stride if b == 0 else 1))
                in_ch = width
        self.blocks = nn.ModuleList(blocks)
        self.fc = layers.linear(512, NUM_CLASSES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.stem_bn(self.stem_conv(x)))
        for block in self.blocks:
            y = block(y)
        # Global average pool -> [N,512]; a bf16 mean accumulates in f32
        # and rounds once, as the reference's jnp.mean does.
        return self.fc(y.mean(dim=(2, 3)))
