"""The building blocks of the architectures' plain forwards (``arch/``),
as functions of their parameters, in f32.

Parameters are one ordered list of leaves (``Leaf``) in the order a
PyTorch module tree of the architecture registers them; BN running
statistics are one (mean, var) pair per BatchNorm in the same order.

``init`` draws the initial weights from ``seed`` by PyTorch's default
rule, in module order, from one CPU ``torch.Generator``: each convolution
and linear layer its weight and then its bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BatchNorm gamma 1, beta 0, running
mean 0, running var 1.

``Cursor`` walks the lists through a forward: convolution, BatchNorm
(training mode: the batch's statistics, the biased variance to normalize,
the unbiased one into the running variance at momentum 0.1) and linear
layers.  ``q`` rounds every activation where a mixed-precision program
stores one in its activation dtype: each convolution's and linear layer's
input, weight and output, each BatchNorm's output (the identity in f32;
the lower-precision control's quantizer).
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


def conv_leaves(name, cin, cout, k, bias) -> List[Leaf]:
    fan = cin * k * k
    out = [Leaf(f"{name}.weight", (cout, cin, k, k), fan, 0.0)]
    if bias:
        out.append(Leaf(f"{name}.bias", (cout,), fan, 0.0))
    return out


def bn_leaves(name, c) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (c,), 0, 1.0),
            Leaf(f"{name}.bias", (c,), 0, 0.0)]


def linear_leaves(name, cin, cout) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (cout, cin), cin, 0.0),
            Leaf(f"{name}.bias", (cout,), cin, 0.0)]


def init(leaves: List[Leaf], seed: int, device
         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(parameters, BN running statistics [mean, var, mean, var, ...]),
    f32 on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    params, stats = [], []
    for leaf in leaves:
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


class Cursor:
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
