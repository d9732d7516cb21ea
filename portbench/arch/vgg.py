"""VGG with BatchNorm after every convolution (the CS744 reference's
model): its plain forward, its parameters and its costs.

The configuration's ``layers`` lists each convolution's output channels
and ``"M"`` for a 2x2/2 max pool; every convolution is followed by
BatchNorm (training mode) and ReLU, and a pool block's BN -> ReLU ->
MaxPool is the program's fused op.  The head is one linear layer from the
last block's channels to ``num_classes``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch.nn.functional as F

from portbench.reference.layers import (Cursor, bn_leaves, conv_leaves,
                                        init as init_leaves, linear_leaves)

BATCH_STATISTICS = True
CHECKED_STATE = ("running_mean", "running_var")


def _layers(config: dict) -> List[Tuple[str, int, int, int]]:
    """(kind, in_ch, out_ch, spatial) for each conv, and ("pool", ch, ch,
    spatial before the pool) for each pool."""
    h = config["input"][0]
    in_ch = config["input"][2]
    out = []
    for v in config["layers"]:
        if v == "M":
            out.append(("pool", in_ch, in_ch, h))
            h //= 2
        else:
            out.append(("conv", in_ch, int(v), h))
            in_ch = int(v)
    return out


def leaves(config: dict):
    out = []
    cin = config["input"][2]
    k = config["conv_kernel"]
    i = 0
    for v in config["layers"]:
        if v == "M":
            continue
        out += conv_leaves(f"blocks.{i}.conv", cin, v, k, config["conv_bias"])
        out += bn_leaves(f"blocks.{i}.bn", v)
        cin, i = v, i + 1
    return out + linear_leaves("fc1", cin, config["num_classes"])


def init(config: dict, seed: int, device):
    return init_leaves(leaves(config), seed, device)


def forward(config, params, stats, x, q=lambda t: t):
    """Logits of ``x`` [N,3,H,W] f32 in training mode; ``stats`` (this
    call's own copies) take the running-statistics update."""
    c = Cursor(params, stats, config, q)
    layers = config["layers"]
    for i, v in enumerate(layers):
        if v == "M":
            continue
        x = F.relu(c.bn(c.conv(x, 1, config["conv_padding"],
                               config["conv_bias"])))
        if i + 1 < len(layers) and layers[i + 1] == "M":
            x = F.max_pool2d(x, 2, 2)
    return c.linear(x.flatten(1))


def macs_per_example(config: dict, traffic: dict) -> int:
    """Every convolution's MACs at its spatial size, and the head's."""
    k = config["conv_kernel"]
    macs = sum(cin * k * k * cout * h * h
               for kind, cin, cout, h in _layers(config) if kind == "conv")
    return macs + config["classifier"][0] * config["num_classes"]


def pool_blocks(config: dict) -> List[Tuple[int, int, int]]:
    return [(c, h, h) for kind, c, _, h in _layers(config) if kind == "pool"]
