"""The two architectures as plain functions of their parameters, in f32.

Parameters are one ordered list of leaves (``Leaf``) in the order a
PyTorch module tree of the architecture registers them; BN running
statistics are one (mean, var) pair per BatchNorm in the same order.

``init`` draws the initial weights from ``seed`` by PyTorch's default
rule, in module order, from one CPU ``torch.Generator``: each convolution
and linear layer its weight and then its bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BatchNorm gamma 1, beta 0, running
mean 0, running var 1.

``forward`` is convolution -> BatchNorm (training mode: the batch's
statistics, the biased variance to normalize, the unbiased one into the
running variance at momentum 0.1) -> ReLU, with a 2x2/2 max pool after the
VGG's pool blocks, and the ResNet's BasicBlocks with their 1x1 shortcuts.
``q`` rounds every activation where a mixed-precision program stores
one in its activation dtype: each convolution's and linear layer's input,
weight and output, each BatchNorm's output and each residual sum (the
identity in f32; the lower-precision control's quantizer).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    fan_in: int        # > 0: a convolution or linear leaf drawn uniform
    fill: float        # BN leaves: the constant they start at


def _conv(name, cin, cout, k, bias) -> List[Leaf]:
    fan = cin * k * k
    out = [Leaf(f"{name}.weight", (cout, cin, k, k), fan, 0.0)]
    if bias:
        out.append(Leaf(f"{name}.bias", (cout,), fan, 0.0))
    return out


def _bn(name, c) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (c,), 0, 1.0),
            Leaf(f"{name}.bias", (c,), 0, 0.0)]


def _linear(name, cin, cout) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (cout, cin), cin, 0.0),
            Leaf(f"{name}.bias", (cout,), cin, 0.0)]


def leaves(config: dict) -> List[Leaf]:
    """Every parameter of ``config``, in registration order."""
    out: List[Leaf] = []
    cin = config["input"][2]
    if config["architecture"] == "vgg":
        k = config["conv_kernel"]
        i = 0
        for v in config["layers"]:
            if v == "M":
                continue
            out += _conv(f"blocks.{i}.conv", cin, v, k, config["conv_bias"])
            out += _bn(f"blocks.{i}.bn", v)
            cin, i = v, i + 1
        return out + _linear("fc1", cin, config["num_classes"])
    stem = config["stem_width"]
    out += _conv("stem_conv", cin, stem, 3, False) + _bn("stem_bn", stem)
    cin, i = stem, 0
    for width, stride, blocks in zip(config["widths"], config["strides"],
                                     config["blocks_per_stage"]):
        for b in range(blocks):
            s = stride if b == 0 else 1
            p = f"blocks.{i}"
            out += _conv(f"{p}.conv1", cin, width, 3, False)
            out += _bn(f"{p}.bn1", width)
            out += _conv(f"{p}.conv2", width, width, 3, False)
            out += _bn(f"{p}.bn2", width)
            if s != 1 or cin != width:
                out += _conv(f"{p}.down_conv", cin, width, 1, False)
                out += _bn(f"{p}.down_bn", width)
            cin, i = width, i + 1
    return out + _linear("fc", cin, config["num_classes"])


def init(config: dict, seed: int, device) -> Tuple[List[torch.Tensor],
                                                   List[torch.Tensor]]:
    """(parameters, BN running statistics [mean, var, mean, var, ...]),
    f32 on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    params, stats = [], []
    for leaf in leaves(config):
        if leaf.fan_in:
            bound = 1.0 / (leaf.fan_in ** 0.5)
            t = torch.empty(leaf.shape).uniform_(-bound, bound,
                                                 generator=gen)
        else:
            t = torch.full(leaf.shape, leaf.fill)
            if leaf.name.endswith(".bias"):
                c = leaf.shape[0]
                stats += [torch.zeros(c), torch.ones(c)]
        params.append(t)
    return ([p.to(device) for p in params], [s.to(device) for s in stats])


class _Cursor:
    """Walks the parameter and statistics lists in registration order."""

    def __init__(self, params, stats, config, q: Quant):
        self.params, self.stats = params, stats
        self.p = self.s = 0
        self.eps, self.momentum = config["bn_eps"], config["bn_momentum"]
        self.q = q

    def take(self, n: int) -> List[torch.Tensor]:
        out = self.params[self.p:self.p + n]
        self.p += n
        return out

    def conv(self, x, stride, padding, bias):
        w, *b = self.take(2 if bias else 1)
        return self.q(F.conv2d(self.q(x), self.q(w), b[0] if b else None,
                               stride, padding))

    def bn(self, x):
        gamma, beta = self.take(2)
        rm, rv = self.stats[self.s], self.stats[self.s + 1]
        self.s += 2
        return self.q(F.batch_norm(x, rm, rv, gamma, beta, True,
                                   self.momentum, self.eps))

    def linear(self, x):
        w, b = self.take(2)
        return self.q(F.linear(self.q(x), self.q(w), b))


def forward(config: dict, params: List[torch.Tensor],
            stats: List[torch.Tensor], x: torch.Tensor,
            q: Quant = lambda t: t) -> torch.Tensor:
    """Logits of ``x`` [N,3,H,W] f32 in training mode; ``stats`` (this
    call's own copies) take the running-statistics update."""
    c = _Cursor(params, stats, config, q)
    if config["architecture"] == "vgg":
        layers = config["layers"]
        for i, v in enumerate(layers):
            if v == "M":
                continue
            x = F.relu(c.bn(c.conv(x, 1, config["conv_padding"],
                                   config["conv_bias"])))
            if i + 1 < len(layers) and layers[i + 1] == "M":
                x = F.max_pool2d(x, 2, 2)
        return c.linear(x.flatten(1))
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
