"""ResNet with BasicBlocks and the CIFAR stem (the zoo's ResNet-18/34):
its plain forward, its parameters and its costs.

A 3x3 stride-1 stem convolution -> BN -> ReLU; each stage's blocks of two
bias-free 3x3 convolutions with BN, the first of a stage at the stage's
stride, a 1x1 convolution + BN shortcut where the stride or the width
changes, the residual sum then ReLU; a global average pool and one linear
layer.  ``q`` also rounds each residual sum and the pooled features.
"""

from __future__ import annotations

import torch.nn.functional as F

from portbench.reference.layers import (Cursor, bn_leaves, conv_leaves,
                                        init as init_leaves, linear_leaves)

BATCH_STATISTICS = True
CHECKED_STATE = ("running_mean", "running_var")


def leaves(config: dict):
    cin = config["input"][2]
    stem = config["stem_width"]
    out = conv_leaves("stem_conv", cin, stem, 3, False) + \
        bn_leaves("stem_bn", stem)
    cin, i = stem, 0
    for width, stride, blocks in zip(config["widths"], config["strides"],
                                     config["blocks_per_stage"]):
        for b in range(blocks):
            s = stride if b == 0 else 1
            p = f"blocks.{i}"
            out += conv_leaves(f"{p}.conv1", cin, width, 3, False)
            out += bn_leaves(f"{p}.bn1", width)
            out += conv_leaves(f"{p}.conv2", width, width, 3, False)
            out += bn_leaves(f"{p}.bn2", width)
            if s != 1 or cin != width:
                out += conv_leaves(f"{p}.down_conv", cin, width, 1, False)
                out += bn_leaves(f"{p}.down_bn", width)
            cin, i = width, i + 1
    return out + linear_leaves("fc", cin, config["num_classes"])


def init(config: dict, seed: int, device):
    return init_leaves(leaves(config), seed, device)


def forward(config, params, stats, x, q=lambda t: t):
    """Logits of ``x`` [N,3,H,W] f32 in training mode; ``stats`` (this
    call's own copies) take the running-statistics update."""
    c = Cursor(params, stats, config, q)
    y = F.relu(c.bn(c.conv(x, 1, 1, False)))
    cin = config["stem_width"]
    for width, stride, blocks in zip(config["widths"], config["strides"],
                                     config["blocks_per_stage"]):
        for b in range(blocks):
            s = stride if b == 0 else 1
            h = F.relu(c.bn(c.conv(y, s, 1, False)))
            h = c.bn(c.conv(h, 1, 1, False))
            if s != 1 or cin != width:
                y = c.bn(c.conv(y, s, 0, False))
            y = F.relu(q(h + y))
            cin = width
    return c.linear(q(y.mean(dim=(2, 3))))


def macs_per_example(config: dict, traffic: dict) -> int:
    """The stem's, every block's two convolutions' and shortcut's MACs at
    their output size, and the head's."""
    h = config["input"][0]
    cin = config["input"][2]
    stem = config["stem_width"]
    macs = cin * 9 * stem * h * h            # the 3x3 stem, stride 1
    cin = stem
    for width, stride, blocks in zip(config["widths"], config["strides"],
                                     config["blocks_per_stage"]):
        for b in range(blocks):
            s = stride if b == 0 else 1
            h_out = h // s
            macs += cin * 9 * width * h_out * h_out       # conv1
            macs += width * 9 * width * h_out * h_out     # conv2
            if s != 1 or cin != width:
                macs += cin * width * h_out * h_out       # 1x1 shortcut
            cin, h = width, h_out
    return macs + cin * config["num_classes"]
