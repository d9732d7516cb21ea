"""Training driver: the reference training script's ``run`` /
``train_model`` / ``test_model`` with its print schedule, on one rank of a
``torch.distributed`` process group (one process per GPU).

  * Each rank trains its own rows of every global batch: rank r of world w
    takes positions ``r::w`` of the sampler's epoch order, ``global_batch
    // w`` at a time (the reference package's ``_shard_batch_cols``).
  * The ragged final batch is trained at its own size (the script's
    DataLoader has drop_last=False): 80 rows at world 1, 40 per rank at
    world 2, 20 at world 4.
  * Each rank draws augmentation from its own generator, seeded from
    (seed, rank); rank 0's is the ``single`` strategy's.
  * Evaluation covers the test set in global batches, each rank its slice
    of every batch; the last batch is padded with label -1, which the eval
    step masks out, and the counts are summed over the ranks.
  * Only rank 0 prints.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import models as model_zoo
from ..data import cifar10, sharding
from ..device import resolve_device, set_f32_parity
from ..ops import sgd
from ..parallel import Group, get_strategy, initialize_distributed
from ..parallel import strategies
from ..utils.metrics import WindowedTimers
from . import step as steplib

GLOBAL_BATCH = 256      # the reference's batch_size
SEED = 0                # the reference's torch.manual_seed(0)
STRATEGIES = tuple(strategies.STRATEGIES)


def _train_batches(split: cifar10.Split, global_batch: int, epoch: int,
                   seed: int, world: int = 1, rank: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Rank ``rank``'s rows of the epoch's global batches in sampler order;
    the last one may be short."""
    per = global_batch // world
    idx = sharding.global_epoch_indices(len(split.labels), world, seed=seed,
                                        epoch=epoch)[rank]
    for start in range(0, len(idx), per):
        cols = idx[start:start + per]
        yield split.images[cols], split.labels[cols]


def _eval_batches(split: cifar10.Split, global_batch: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The test set in order, the final batch padded with label -1."""
    n = len(split.labels)
    for start in range(0, n, global_batch):
        imgs = split.images[start:start + global_batch]
        labs = split.labels[start:start + global_batch]
        if len(labs) < global_batch:
            pad = global_batch - len(labs)
            imgs = np.concatenate([imgs, np.zeros((pad, 32, 32, 3), np.uint8)])
            labs = np.concatenate([labs, np.full((pad,), -1, np.int32)])
        yield imgs, labs


def _silent(_: str) -> None:
    pass


def generator_seed(seed: int, rank: int) -> int:
    """The augmentation seed of ``rank``: ``seed`` itself on rank 0."""
    return seed + (rank << 32)


class Trainer:
    """Data + model + strategy on this process's rank.

    Any strategy but ``single`` needs a process group; a process that has
    none gets a world-1 group (NCCL on cuda, gloo on cpu), so every
    strategy runs on one device.  ``single`` refuses a world above 1."""

    def __init__(self, model: str = "vgg11", strategy: str = "allreduce", *,
                 compress_rank: Optional[int] = None,
                 global_batch: int = GLOBAL_BATCH, data_dir: str = "./data",
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = SEED, augment: bool = True,
                 sgd_cfg: sgd.SGDConfig = sgd.SGDConfig(),
                 limit_train_batches: Optional[int] = None,
                 limit_eval_batches: Optional[int] = None,
                 log: Callable[[str], None] = print):
        strat = get_strategy(strategy, **({} if compress_rank is None
                                          else {"compress_rank":
                                                compress_rank}))
        for name, lim in (("limit_train_batches", limit_train_batches),
                          ("limit_eval_batches", limit_eval_batches)):
            if lim is not None and lim < 1:
                raise ValueError(f"{name} must be >= 1, got {lim}")
        self.device = resolve_device(device)
        if strat is strategies.local:
            if dist.is_initialized() and dist.get_world_size() > 1:
                raise ValueError(
                    "'single' strategy requires world 1 (reference Part 1 "
                    f"is world_size==1), got world {dist.get_world_size()}")
            self.group = None
            self.world, self.rank = 1, 0
        else:
            if not dist.is_initialized():
                initialize_distributed(device=self.device)
            self.group = Group(self.device)
            self.world, self.rank = self.group.world, self.group.rank
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
            set_f32_parity()
        if global_batch % self.world:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"world size {self.world}")
        self.global_batch = global_batch
        self.per_rank_batch = global_batch // self.world
        self.seed = seed
        self.limit_train_batches = limit_train_batches
        self.limit_eval_batches = limit_eval_batches
        self.log = log if self.rank == 0 else _silent

        self.train_split, self.test_split, _ = cifar10.load(data_dir)
        # The script prints len(loader), the per-rank batch count; its test
        # loader takes the per-rank batch over the whole test set.
        per_rank_samples = -(-len(self.train_split.labels) // self.world)
        self.log(f"Size of training set is "
                 f"{-(-per_rank_samples // self.per_rank_batch)}")
        self.log(f"Size of test set is "
                 f"{-(-len(self.test_split.labels) // self.per_rank_batch)}")

        net = model_zoo.get_model(model, seed).to(
            self.device, memory_format=torch.channels_last)
        self.state = steplib.init_train_state(net, strat)
        self.train_step = steplib.make_train_step(
            net, strat, sgd_cfg, augment=augment, group=self.group)
        self.eval_step = steplib.make_eval_step(net, self.group)
        self.generator = torch.Generator(device=self.device).manual_seed(
            generator_seed(seed, self.rank))
        self.last_epoch_timers: Optional[WindowedTimers] = None

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        # Copies: the cached synthetic split is read-only.
        return (torch.tensor(images, device=self.device),
                torch.tensor(labels, dtype=torch.int64, device=self.device))

    def train_model(self, epoch: int) -> WindowedTimers:
        """One training epoch with the reference's print/timing schedule.
        Each step is fenced by fetching its loss."""
        timers = WindowedTimers(self.log)
        for it, (imgs, labs) in enumerate(_train_batches(
                self.train_split, self.global_batch, epoch, self.seed,
                self.world, self.rank)):
            if self.limit_train_batches is not None and \
                    it >= self.limit_train_batches:
                break
            x, y = self._to_device(imgs, labs)
            t0 = time.time()
            loss = float(self.train_step(self.state, x, y, self.generator))
            timers.record(loss, time.time() - t0,
                          steady=len(labs) == self.per_rank_batch)
        self.last_epoch_timers = timers
        return timers

    def test_model(self) -> Tuple[float, int, float]:
        """Evaluate and print the script's line: average CE per example,
        correct/total, percent."""
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        rows = slice(self.rank * self.per_rank_batch,
                     (self.rank + 1) * self.per_rank_batch)
        for b, (imgs, labs) in enumerate(_eval_batches(self.test_split,
                                                       self.global_batch)):
            if self.limit_eval_batches is not None and \
                    b >= self.limit_eval_batches:
                break
            ls, c = self.eval_step(*self._to_device(imgs[rows], labs[rows]))
            loss_sum += ls
            correct += c
        n = len(self.test_split.labels)
        if self.limit_eval_batches is not None:
            n = min(n, self.limit_eval_batches * self.global_batch)
        avg_loss = float(loss_sum) / n
        correct = int(correct)
        acc = 100.0 * correct / n
        self.log("Test set: Average loss: {:.4f}, Accuracy: {}/{} ({:.0f}%)\n"
                 .format(avg_loss, correct, n, acc))
        return avg_loss, correct, acc

    def run(self, epochs: int = 1) -> None:
        """Epochs of train + eval with the epoch timing line."""
        for epoch in range(epochs):
            t0 = time.time()
            self.train_model(epoch)
            self.log(f"Training time after {epoch + 1} epoch is "
                     f"{time.time() - t0}")
            self.test_model()
