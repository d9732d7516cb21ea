"""The first training steps of a cell, written out in plain PyTorch.

From the split and the seed alone: the sampler's order (one permutation
of the epoch's examples drawn from ``seed``, wrap-padded to a multiple of
the world, rank r taking positions r::world, ``global_batch // world``
rows a step), each rank's inputs for its rows (the recipe's ``batch``:
for CIFAR-10 the counter-keyed crop and flip of ``augment.py``), the
architecture's forward in training mode (``arch/<architecture>.py``), the
f32 cross-entropy over every row of the logits, the backward by autograd
(the max pool's gradient to the first maximal element of its window, BN's
through the batch statistics), the mean of the ranks' gradients, losses
and state (BN running statistics), and SGD with L2 weight decay and
momentum: d = g + wd p; v = mu v + d; p = p - lr v.

A rank's rows go through the forward and the backward in chunks, each
chunk's summed cross-entropy over the rank's number of targets, the
gradients summed in f32: one chunk of all of them, or with the traffic's
``reference_chunk_rows`` chunks of that many, the same gradient in less
memory.  Only an architecture that keeps no batch statistics may be
chunked (``chunk_rows``).

``precision`` says how the forward and backward compute:

  * ``"f32"``: f32 with TF32 off, the reference;
  * ``"tf32"``: the control of an f32 cell: convolutions and matmuls in
    TF32 (the card's tensor-core f32 path);
  * ``"fp8"``: the control of a bf16 cell: every activation that the bf16
    program stores in bf16 (the architecture's ``q``: for the CIFAR
    classifiers the convolutions' and linear layers' inputs, weights and
    outputs, BatchNorm's outputs, the residual sums) rounded to float8
    e4m3 instead, and each gradient that flows back through them to e5m2,
    each with a per-tensor scale from its largest magnitude (fp8
    training's usual recipe); master weights, state, the loss and the
    update in f32.

What it returns is what the comparison reads (``Readings``): each step's
loss, the per-leaf norms of the first step's gradient, of the parameters'
change over the steps, and of the compared state's change after the
first step (none where the architecture names no state).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "fp8")


class Readings(NamedTuple):
    """What both sides give the comparison, per leaf in registration
    order: parameters for ``grad1`` and ``change``, the compared state
    (the running means and variances) for ``stats_change1``."""
    losses: List[float]
    grad1: List[float]          # |first gradient| per parameter
    change: List[float]         # |p_steps - p_0| per parameter
    stats_change1: List[float]  # |s_1 - s_0| per running statistic


def norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(t.detach().double()))
            for t in tensors]


def rank_rows(n: int, world: int, seed: int) -> List[np.ndarray]:
    """Each rank's example order for the epoch."""
    perm = np.random.default_rng(seed).permutation(n)
    total = -(-n // world) * world
    if total > n:
        perm = np.concatenate([perm] * (-(-total // n)))[:total]
    return [perm[r::world] for r in range(world)]


def _qdq(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32).clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _qdq(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _qdq(g, torch.float8_e5m2)


@contextlib.contextmanager
def _tf32(on: bool) -> Iterator[None]:
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def chunk_rows(arch, traffic: dict) -> Optional[int]:
    """The traffic's ``reference_chunk_rows``, or None; refused for an
    architecture that keeps batch statistics, whose rows a chunk would
    normalize apart."""
    rows = traffic.get("reference_chunk_rows")
    if rows is None:
        return None
    if arch.BATCH_STATISTICS:
        raise ValueError("reference_chunk_rows is refused: the architecture "
                         "keeps batch statistics")
    if not isinstance(rows, int) or rows < 1:
        raise ValueError(f"reference_chunk_rows must be a whole number >= 1, "
                         f"got {rows!r}")
    return rows


def _loss_and_grads(arch, config, params, state, x, y, q, chunk):
    """A rank's mean cross-entropy over its targets and its gradient,
    summed in f32 over chunks of ``chunk`` rows (None: all the rank's rows
    in one chunk)."""
    chunk = chunk or x.shape[0]
    targets = y.numel()
    loss, grads = 0.0, None
    for lo in range(0, x.shape[0], chunk):
        logits = arch.forward(config, params, state, x[lo:lo + chunk], q)
        part = F.cross_entropy(logits.float(),
                               y[lo:lo + chunk].reshape(-1),
                               reduction="sum") / targets
        g = torch.autograd.grad(part, params)
        grads = list(g) if grads is None else \
            [a + b for a, b in zip(grads, g)]
        loss = loss + part.detach()
    return loss, grads


def run(arch, recipe, split, config: dict, traffic: dict, seed: int,
        steps: int, device, precision: str = "f32") -> Readings:
    """The cell's first ``steps`` steps from ``seed`` on ``device``:
    ``arch`` and ``recipe`` are the cell's plug-ins, ``split`` what the
    recipe's ``read`` gave."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    chunk = chunk_rows(arch, traffic)
    world = traffic["world"]
    per = traffic["global_batch"] // world
    sgd = traffic["sgd"]
    q = _FP8.apply if precision == "fp8" else (lambda t: t)
    streams = rank_rows(recipe.examples(traffic["dataset"]), world, seed)
    params, stats = arch.init(config, seed, device)
    for p in params:
        p.requires_grad_(True)
    p0 = [p.detach().clone() for p in params]
    s0 = [s.clone() for s in stats]
    velocity = [torch.zeros_like(p) for p in params]
    losses, grad1, stats1 = [], None, None
    for step in range(steps):
        gsum, lsum, ssum = None, 0.0, None
        for r in range(world):
            rows = streams[r][step * per:(step + 1) * per]
            x, y = recipe.batch(split, rows, traffic, seed, r, step, device)
            mine = [s.clone() for s in stats]
            with _tf32(precision == "tf32"):
                loss, grads = _loss_and_grads(arch, config, params, mine, x,
                                              y, q, chunk)
            gsum = list(grads) if gsum is None else \
                [a + b for a, b in zip(gsum, grads)]
            ssum = mine if ssum is None else \
                [a + b for a, b in zip(ssum, mine)]
            lsum += float(loss.detach())
        grads = [g / world for g in gsum]
        stats = [s / world for s in ssum]
        losses.append(lsum / world)
        if step == 0:
            grad1 = norms(grads)
            stats1 = norms(s - a for s, a in zip(stats, s0))
        with torch.no_grad():
            for p, g, v in zip(params, grads, velocity):
                d = g + sgd["weight_decay"] * p
                v.mul_(sgd["momentum"]).add_(d)
                p.sub_(sgd["lr"] * v)
    return Readings(losses, grad1,
                    norms(p - a for p, a in zip(params, p0)), stats1)
