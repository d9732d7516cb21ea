"""SGD with PyTorch semantics: L2 weight decay folded into the gradient,
then classic (non-Nesterov) momentum.

    g = grad + wd * p
    v = mu * v + g          (v starts at zero, so the first step gives v = g)
    p = p - lr * v

The same formula, in the same order of roundings, as the reference
package's ``ops/sgd.py`` (element-equal, tests/test_torch_port_train.py).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence

import torch


class SGDConfig(NamedTuple):
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4


class SGDState(NamedTuple):
    momentum: List[torch.Tensor]   # one velocity buffer per parameter
    # A compressed strategy's state for THIS rank (error-feedback
    # residuals, PowerSGD Q factors: parallel/strategies.py); None for the
    # stateless strategies.  The reference package stacks every worker's.
    comm: Any = None


def init(params: Sequence[torch.Tensor]) -> SGDState:
    return SGDState(momentum=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: SGDState, cfg: SGDConfig = SGDConfig()) -> None:
    """One SGD step, updating ``params`` and the velocity buffers IN PLACE
    (the reference is pure and returns new arrays; in place saves a copy of
    every parameter per step and rounds identically)."""
    for p, g, v in zip(params, grads, state.momentum):
        d = g + cfg.weight_decay * p
        v.mul_(cfg.momentum).add_(d)
        p.sub_(cfg.lr * v)
