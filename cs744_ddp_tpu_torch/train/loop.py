"""Training driver: the reference training script's ``run`` /
``train_model`` / ``test_model`` with its print schedule, for the ``single``
strategy on one device.

  * The epoch order is the sampler's at world 1 (``data/sharding.py``);
    batches are gathered with NumPy and copied to the device per step.
  * The ragged final batch (50,000 mod 256 = 80 examples) is trained at its
    own size (the script's DataLoader has drop_last=False).
  * Evaluation covers the test set in order; the last batch is padded with
    label -1, which the eval step masks out.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import models as model_zoo
from ..data import cifar10, sharding
from ..device import resolve_device, set_f32_parity
from ..ops import sgd
from ..utils.metrics import WindowedTimers
from . import step as steplib

GLOBAL_BATCH = 256      # the reference's batch_size
SEED = 0                # the reference's torch.manual_seed(0)
STRATEGIES = ("single",)


def _train_batches(split: cifar10.Split, global_batch: int, epoch: int,
                   seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The epoch's batches in sampler order; the last one may be short."""
    idx = sharding.global_epoch_indices(len(split.labels), 1, seed=seed,
                                        epoch=epoch)[0]
    for start in range(0, len(idx), global_batch):
        cols = idx[start:start + global_batch]
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


class Trainer:
    """Data + model + the ``single`` strategy, on one device."""

    def __init__(self, model: str = "vgg11", strategy: str = "single", *,
                 global_batch: int = GLOBAL_BATCH, data_dir: str = "./data",
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = SEED, augment: bool = True,
                 sgd_cfg: sgd.SGDConfig = sgd.SGDConfig(),
                 limit_train_batches: Optional[int] = None,
                 limit_eval_batches: Optional[int] = None,
                 log: Callable[[str], None] = print):
        if strategy not in STRATEGIES:
            raise NotImplementedError(
                f"strategy {strategy!r} is not yet ported; the PyTorch port "
                f"has {STRATEGIES}")
        for name, lim in (("limit_train_batches", limit_train_batches),
                          ("limit_eval_batches", limit_eval_batches)):
            if lim is not None and lim < 1:
                raise ValueError(f"{name} must be >= 1, got {lim}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_parity()
        self.global_batch = global_batch
        self.seed = seed
        self.limit_train_batches = limit_train_batches
        self.limit_eval_batches = limit_eval_batches
        self.log = log

        self.train_split, self.test_split, _ = cifar10.load(data_dir)
        # The script prints len(loader): the number of batches.
        self.log(f"Size of training set is "
                 f"{-(-len(self.train_split.labels) // global_batch)}")
        self.log(f"Size of test set is "
                 f"{-(-len(self.test_split.labels) // global_batch)}")

        net = model_zoo.get_model(model, seed).to(
            self.device, memory_format=torch.channels_last)
        self.state = steplib.init_train_state(net)
        self.train_step = steplib.make_train_step(net, sgd_cfg,
                                                  augment=augment)
        self.eval_step = steplib.make_eval_step(net)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
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
                self.train_split, self.global_batch, epoch, self.seed)):
            if self.limit_train_batches is not None and \
                    it >= self.limit_train_batches:
                break
            x, y = self._to_device(imgs, labs)
            t0 = time.time()
            loss = float(self.train_step(self.state, x, y, self.generator))
            timers.record(loss, time.time() - t0,
                          steady=len(labs) == self.global_batch)
        self.last_epoch_timers = timers
        return timers

    def test_model(self) -> Tuple[float, int, float]:
        """Evaluate and print the script's line: average CE per example,
        correct/total, percent."""
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for b, (imgs, labs) in enumerate(_eval_batches(self.test_split,
                                                       self.global_batch)):
            if self.limit_eval_batches is not None and \
                    b >= self.limit_eval_batches:
                break
            ls, c = self.eval_step(*self._to_device(imgs, labs))
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
