"""The strong-scaling elastic step: an update that is bitwise world-invariant
(the reference package's ``elastic/step_elastic.py``).

The standard step (``train/step.py``) depends on the world in three
places: the gradient reduction sums per-rank means (the float order
changes with the rank count), BatchNorm normalizes with the rank's batch,
and the augmentation draws are keyed by the rank.  All three follow the
reference training script, and all three make a world resize change the
trajectory.  This step's update is a function of the GLOBAL batch alone:

* every global batch of B examples is cut into S fixed microshards (S a
  power of two, B/S examples each) in canonical order, and rank r of
  world M (M | S) holds microshards ``r*k .. r*k + k - 1``, k = S/M
  (``train/loop.py`` stages rank r's contiguous columns of each batch);
* for each of its microshards the rank restores the step's starting BN
  buffers and runs prepare -> forward -> CE -> ``autograd.grad``, the
  BatchNorm statistics those of the microshard alone, the draws keyed by
  the batch index and the GLOBAL microshard index ``m = r*k + j``, never
  the rank; the loss, the gradients and the new BN running statistics go
  into row j of a preallocated ``[k, L]`` buffer;
* ONE ``all_gather`` of that buffer gives the ``[S, L]`` rows in global
  microshard order on every rank, and a fixed pairwise tree
  (``tree_combine_mean``) means them: one float order at every world;
* one SGD update from the meaned gradients; the running statistics become
  the meaned ones and ``num_batches_tracked`` goes up by one.

Eager PyTorch launches the same kernels for a microshard whatever k is,
so the rows are the same bits at every world (on the card with
deterministic cuDNN).  The strategy's reduction is not used: the combine
IS the reduction, and a compressed strategy's comm state is carried
through unchanged, as in the reference.  The gather moves S rows of every
gradient to every rank (S times an all-reduce's bytes): the price of a
pinned trajectory, and why this step is opt-in.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..data import augment as aug
from ..ops import sgd
from ..ops.loss import cross_entropy
from ..parallel.mesh import Group
from ..train.step import StepOut, TrainState, _input_stats, prepare


def tree_combine_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading axis with a FIXED pairwise summation tree:
    ``x[0::2] + x[1::2]`` until one row is left, then ``/ S``, so
    (((x0+x1)+(x2+x3))...)/S whatever else the program does."""
    s = x.shape[0]
    if s & (s - 1):
        raise ValueError(f"tree combine needs a power-of-two count, got {s}")
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0] / s


def _slices(tensors: List[torch.Tensor], start: int
            ) -> Tuple[List[Tuple[int, int]], int]:
    out = []
    for t in tensors:
        out.append((start, t.numel()))
        start += t.numel()
    return out, start


class MicroshardStep:
    """``step(state, images, labels, epoch, idx) -> StepOut``: the body of
    ``train/step.py``'s windows for elastic strong scaling (see the module
    docstring); ``images``/``labels`` are this rank's ``B/M`` rows of the
    batch, its ``k`` microshards one after the other.

    ``local_rows`` computes this rank's ``[k, L]`` rows and leaves the
    model as it found it; ``combine`` means ``[S, L]`` rows and updates the
    state.  ``group`` None (world 1, or ranks simulated in one process,
    whose rows the caller concatenates) skips the gather.  Row layout: the
    loss, every parameter's gradient flattened, every BN running mean and
    variance.  Nothing is fetched; every buffer is made here, before any
    capture."""

    guard = None            # the windows read it: no non-finite guard

    def __init__(self, model: nn.Module,
                 cfg: sgd.SGDConfig = sgd.SGDConfig(), *, microshards: int,
                 world: int = 1, rank: int = 0,
                 group: Optional[Group] = None, augment=True, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        if augment in ("host", "host_u8"):
            raise ValueError("elastic strong scaling requires on-device "
                             "augmentation (host streams are rank-shaped)")
        s = int(microshards)
        if s < 1 or (s & (s - 1)):
            raise ValueError(f"microshards must be a power of two, got {s}")
        if s % world:
            raise ValueError(f"microshards {s} not divisible by world "
                             f"{world} — this world size cannot run the "
                             f"pinned program")
        if group is not None and (group.world, group.rank) != (world, rank):
            raise ValueError(f"the group is rank {group.rank} of world "
                             f"{group.world}, not {rank} of {world}")
        self.model, self.cfg, self.group = model, cfg, group
        self.microshards, self.world, self.rank = s, world, rank
        self.k = s // world
        self.augment, self.compute_dtype = augment, compute_dtype
        self.key = aug.stream_key(seed, 0)
        self.params = list(model.parameters())
        named = dict(model.named_buffers())
        self.stats = [b for n, b in named.items()
                      if n.endswith(("running_mean", "running_var"))]
        self.counters = [b for n, b in named.items()
                         if n.endswith("num_batches_tracked")]
        self.buffers = list(named.values())
        self.grad_slices, end = _slices(self.params, 1)
        self.stat_slices, self.row_len = _slices(self.stats, end)
        dev = self.params[0].device
        self.norm = _input_stats(augment, dev)
        self.rows = torch.zeros((self.k, self.row_len), dtype=torch.float32,
                                device=dev)
        self.gathered = None if group is None else torch.zeros(
            (s, self.row_len), dtype=torch.float32, device=dev)
        self.start = [torch.empty_like(b) for b in self.buffers]

    def local_rows(self, images: torch.Tensor, labels: torch.Tensor,
                   epoch: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """This rank's ``[k, L]`` rows of the batch at ``idx`` of
        ``epoch``; the model's buffers are restored to the step's start
        before every microshard and after the last."""
        if images.shape[0] % self.k:
            raise ValueError(f"{images.shape[0]} rows do not split into "
                             f"{self.k} microshards")
        mb = images.shape[0] // self.k
        with torch.no_grad():
            for s, b in zip(self.start, self.buffers):
                s.copy_(b)
        self.model.train()
        for j in range(self.k):
            rows = slice(j * mb, (j + 1) * mb)
            x = prepare(images[rows], self.augment, self.key, epoch, idx,
                        self.norm, self.compute_dtype,
                        micro=self.rank * self.k + j)
            loss = cross_entropy(self.model(x), labels[rows])
            grads = torch.autograd.grad(loss, self.params)
            with torch.no_grad():
                row = self.rows[j]
                row[0:1].copy_(loss.reshape(1))
                for g, p, (o, n) in zip(grads, self.params,
                                        self.grad_slices):
                    row[o:o + n].view(p.shape).copy_(g)
                for b, (o, n) in zip(self.stats, self.stat_slices):
                    row[o:o + n].copy_(b)
                for s, b in zip(self.start, self.buffers):
                    b.copy_(s)
        return self.rows

    def combine(self, state: TrainState, gathered: torch.Tensor) -> StepOut:
        """Mean the ``[S, L]`` rows with the tree, write the running
        statistics, count the step in ``num_batches_tracked`` and update
        the parameters and momentum in place."""
        mean = tree_combine_mean(gathered)
        grads = [mean[o:o + n].view(p.shape)
                 for p, (o, n) in zip(self.params, self.grad_slices)]
        with torch.no_grad():
            for b, (o, n) in zip(self.stats, self.stat_slices):
                b.copy_(mean[o:o + n])
            for c in self.counters:
                c.add_(1)
        sgd.update(self.params, grads, state.opt_state, self.cfg)
        return StepOut(mean[0], grads, None, None)

    def __call__(self, state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor, epoch: torch.Tensor,
                 idx: torch.Tensor) -> StepOut:
        rows = self.local_rows(images, labels, epoch, idx)
        if self.group is None:
            if self.k != self.microshards:
                raise ValueError("a step of world > 1 needs its process "
                                 "group for the gather")
            return self.combine(state, rows)
        self.group.reset_step()
        self.group.all_gather(self.gathered, rows)
        return self.combine(state, self.gathered)
