"""Training driver: the reference training script's ``run`` /
``train_model`` / ``test_model`` with its print schedule, on one rank of a
``torch.distributed`` process group (one process per GPU).

  * Each rank trains its own rows of every global batch: rank r of world w
    takes positions ``r::w`` of the sampler's epoch order, ``global_batch
    // w`` at a time (the reference package's ``_shard_batch_cols``).
  * The epoch is staged on the device once (``_stage_train_epoch``) and
    trained in 20-step windows (``train/step.py::TrainWindow``): on the
    card each window is replays of one captured CUDA graph of the step,
    and the host reads the device once per window — the metric ring or the
    window's losses, which also fences the window's timing.
  * The ragged final batch is trained at its own size (the script's
    DataLoader has drop_last=False) as one eager step: 80 rows at world 1,
    40 per rank at world 2, 20 at world 4.
  * ``profile_phases=True`` is the per-step path instead: one eager step
    per batch, its loss fetched, with a forward-only program timed before
    it for the reference's fwd/bwd split.
  * Augmentation is counter-keyed by (seed, rank, epoch, batch index), so
    both paths draw the same crops and flips.
  * Evaluation stages the test set once, each rank its slice of every
    global batch, the last batch padded with label -1; ONE program over
    all of it, counts summed over the ranks, one fetch.
  * ``host_round_trips`` counts device-to-host fetches: a windowed epoch
    makes at most windows + 2 (the windows, the tail, the eval), the
    per-step path one or two per step.
  * Only rank 0 prints.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import models as model_zoo
from ..data import cifar10, sharding
from ..device import resolve_device, set_f32_parity
from ..obs import ringbuf
from ..ops import sgd
from ..parallel import Group, get_strategy, initialize_distributed
from ..parallel import strategies
from ..utils.metrics import WINDOW, WindowedTimers
from . import step as steplib

GLOBAL_BATCH = 256      # the reference's batch_size
SEED = 0                # the reference's torch.manual_seed(0)
STRATEGIES = tuple(strategies.STRATEGIES)
# --precision -> the activations' dtype (None: f32 throughout).
PRECISIONS = {"f32": None, "bf16": torch.bfloat16}


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


def ring_capacity(metrics_ring: Optional[int], profile_phases: bool) -> int:
    """The metric ring's capacity, as the reference validates it: None is
    on at ``DEFAULT_CAPACITY``, 0 off, and a capacity below the 20-step
    window is refused (rows would be overwritten before the drain).  Off
    under ``profile_phases``, whose every step is fetched anyway."""
    if metrics_ring is None:
        cap = ringbuf.DEFAULT_CAPACITY
    else:
        cap = int(metrics_ring)
        if cap < 0:
            raise ValueError(f"metrics_ring must be >= 0, got {metrics_ring}")
        if cap and cap < WINDOW:
            raise ValueError(
                f"metrics_ring capacity {cap} is below the window length "
                f"{WINDOW}: rows would be overwritten before the per-window "
                f"drain")
    return 0 if profile_phases else cap


class StagedEpoch(NamedTuple):
    images: torch.Tensor    # [NB, b, 32, 32, 3] uint8: the full batches
    labels: torch.Tensor    # [NB, b] int64
    tail: Optional[Tuple[torch.Tensor, torch.Tensor]]   # the ragged batch


class Trainer:
    """Data + model + strategy on this process's rank.

    Any strategy but ``single`` needs a process group; a process that has
    none gets a world-1 group (NCCL on cuda, gloo on cpu), so every
    strategy runs on one device.  ``single`` refuses a world above 1.

    ``metrics_ring``: the capacity of the device metric ring the windows
    write (None: on, at 64; 0: off, the window's losses are fetched
    instead).  ``profile_phases``: the per-step path with the forward
    timed apart (the ring is then off).

    ``model``: any name of the zoo (``models.get_model``).  ``precision``:
    ``"f32"`` (reference parity, the default) or ``"bf16"`` (mixed
    precision: bf16 activations, convolutions and matmuls; f32 master
    weights, gradients, optimizer and comm state, BN statistics and
    loss)."""

    def __init__(self, model: str = "vgg11", strategy: str = "allreduce", *,
                 precision: str = "f32",
                 compress_rank: Optional[int] = None,
                 global_batch: int = GLOBAL_BATCH, data_dir: str = "./data",
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = SEED, augment: bool = True,
                 sgd_cfg: sgd.SGDConfig = sgd.SGDConfig(),
                 limit_train_batches: Optional[int] = None,
                 limit_eval_batches: Optional[int] = None,
                 profile_phases: bool = False,
                 metrics_ring: Optional[int] = None,
                 log: Callable[[str], None] = print):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of "
                             f"{sorted(PRECISIONS)}, got {precision!r}")
        self.precision = precision
        self.compute_dtype = PRECISIONS[precision]
        strat = get_strategy(strategy, **({} if compress_rank is None
                                          else {"compress_rank":
                                                compress_rank}))
        for name, lim in (("limit_train_batches", limit_train_batches),
                          ("limit_eval_batches", limit_eval_batches)):
            if lim is not None and lim < 1:
                raise ValueError(f"{name} must be >= 1, got {lim}")
        self.metrics_ring = ring_capacity(metrics_ring, profile_phases)
        self.profile_phases = profile_phases
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
        self.augment = augment
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
        dtype = self.compute_dtype
        self.train_step = steplib.make_train_step(
            net, strat, sgd_cfg, augment=augment, group=self.group,
            seed=seed, compute_dtype=dtype)
        self.forward_step = steplib.make_forward_step(net, self.group, dtype)
        self.evaluate = steplib.make_eval_window(net, self.group, dtype)
        self.host_round_trips = 0
        self._staged_train = None       # (cache key, StagedEpoch)
        self._staged_eval = None
        self._train_window: Optional[steplib.TrainWindow] = None
        self._fwd_window: Optional[steplib.FwdWindow] = None
        self.last_epoch_timers: Optional[WindowedTimers] = None

    # -- on-device staging --------------------------------------------------

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        # Copies: the cached synthetic split is read-only.
        return (torch.tensor(images, device=self.device),
                torch.tensor(labels, dtype=torch.int64, device=self.device))

    def _stage_train_epoch(self, epoch: int) -> StagedEpoch:
        """This rank's rows of every full batch of ``epoch`` in persistent
        device buffers ``[NB, b, 32, 32, 3]`` / ``[NB, b]``, the ragged
        tail batch apart (None when the epoch has none within the limit).
        Cached on the split and the sampler's order; another order is
        restaged by ``copy_`` into the same buffers, so that a captured
        window's addresses hold."""
        split = self.train_split
        order = sharding.global_epoch_indices(
            len(split.labels), self.world, seed=self.seed,
            epoch=epoch)[self.rank]
        key = (id(split), order.tobytes())
        if self._staged_train is not None and self._staged_train[0] == key:
            return self._staged_train[1]
        per = self.per_rank_batch
        nbatches = -(-len(order) // per)
        if self.limit_train_batches is not None:
            nbatches = min(nbatches, self.limit_train_batches)
        nfull = min(len(order) // per, nbatches)
        cols = order[:nfull * per]
        images = torch.from_numpy(
            split.images[cols].reshape(nfull, per, 32, 32, 3))
        labels = torch.from_numpy(
            split.labels[cols].astype(np.int64).reshape(nfull, per))
        tail = None
        if nfull < nbatches:
            tail = self._to_device(*(a[order[nfull * per:]] for a in split))
        if self._staged_train is None:
            staged = StagedEpoch(images.to(self.device),
                                 labels.to(self.device), tail)
        else:
            staged = self._staged_train[1]
            if staged.images.shape != images.shape:
                raise ValueError(f"epoch {epoch} stages {tuple(images.shape)}"
                                 f" batches; the buffers hold "
                                 f"{tuple(staged.images.shape)}")
            staged.images.copy_(images)
            staged.labels.copy_(labels)
            staged = staged._replace(tail=tail)
        self._staged_train = (key, staged)
        return staged

    def _stage_eval(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The test set's global batches, this rank's slice of each, as
        ``[T, b, 32, 32, 3]`` / ``[T, b]`` on the device, staged once."""
        if self._staged_eval is None:
            rows = slice(self.rank * self.per_rank_batch,
                         (self.rank + 1) * self.per_rank_batch)
            imgs, labs = [], []
            for imgs_b, labs_b in _eval_batches(self.test_split,
                                                self.global_batch):
                if self.limit_eval_batches is not None and \
                        len(imgs) >= self.limit_eval_batches:
                    break
                imgs.append(imgs_b[rows])
                labs.append(labs_b[rows])
            self._staged_eval = self._to_device(np.stack(imgs),
                                                np.stack(labs))
        return self._staged_eval

    def _staged_buffers(self) -> StagedEpoch:
        """The staged epoch's buffers: whatever epoch is staged, else epoch
        0.  Every epoch is staged into the same buffers, so a window made
        over them serves every epoch."""
        if self._staged_train is None:
            return self._stage_train_epoch(0)
        return self._staged_train[1]

    def train_window(self) -> steplib.TrainWindow:
        """The window over the staged buffers (made at its first use)."""
        if self._train_window is None:
            staged = self._staged_buffers()
            self._train_window = steplib.TrainWindow(
                self.train_step.body, self.state, staged.images,
                staged.labels, group=self.group,
                ring_capacity=self.metrics_ring)
        return self._train_window

    def fwd_window(self) -> steplib.FwdWindow:
        if self._fwd_window is None:
            staged = self._staged_buffers()
            self._fwd_window = steplib.FwdWindow(
                self.state.model, staged.images, staged.labels,
                augment=self.augment, group=self.group, seed=self.seed,
                compute_dtype=self.compute_dtype)
        return self._fwd_window

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One device-to-host round trip."""
        self.host_round_trips += 1
        return t.cpu().numpy()

    # -- reference-parity loops ---------------------------------------------

    def train_model(self, epoch: int) -> WindowedTimers:
        """One training epoch with the reference's print/timing schedule.

        Windows of ``w = min(20 - start % 20, NB - start)`` steps, each
        timed up to its single fetch, which is also its fence; every step
        of a window is recorded at ``elapsed / w``.  Then the ragged tail
        as one eager step (``steady=False``).  ``profile_phases`` takes the
        per-step path instead."""
        if self.profile_phases:
            return self._train_model_per_step(epoch)
        timers = WindowedTimers(self.log)
        staged = self._stage_train_epoch(epoch)
        window = self.train_window()
        nbatches = staged.images.shape[0]
        start = 0
        while start < nbatches:
            w = min(WINDOW - start % WINDOW, nbatches - start)
            t0 = time.time()
            fetched = self._fetch(window(epoch, start, w))
            per_iter = (time.time() - t0) / w
            for loss in window.losses_of(fetched, start, w):
                timers.record(float(loss), per_iter)
            start += w
        if staged.tail is not None:
            t0 = time.time()
            loss = self._fetch(self.train_step(self.state, *staged.tail,
                                               epoch, nbatches))
            timers.record(float(loss), time.time() - t0, steady=False)
        self.last_epoch_timers = timers
        return timers

    def _train_model_per_step(self, epoch: int) -> WindowedTimers:
        """One eager step per batch, its loss fetched after it, and the
        forward-only program timed (and fetched) before it."""
        timers = WindowedTimers(self.log)
        for it, (imgs, labs) in enumerate(_train_batches(
                self.train_split, self.global_batch, epoch, self.seed,
                self.world, self.rank)):
            if self.limit_train_batches is not None and \
                    it >= self.limit_train_batches:
                break
            x, y = self._to_device(imgs, labs)
            t0 = time.time()
            self._fetch(self.forward_step(x, y))
            fwd_time = time.time() - t0
            t0 = time.time()
            loss = self._fetch(self.train_step(self.state, x, y, epoch, it))
            timers.record(float(loss), time.time() - t0, fwd_time,
                          steady=len(labs) == self.per_rank_batch)
        self.last_epoch_timers = timers
        return timers

    def test_model(self) -> Tuple[float, int, float]:
        """Evaluate and print the script's line: average CE per example,
        correct/total, percent."""
        loss_sum, correct = self.evaluate(*self._stage_eval())
        # One fetch; the f32 sum and a count below 2**53 are exact in f64.
        loss_sum, correct = self._fetch(
            torch.stack([loss_sum.double(), correct.double()]))
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

    # -- measurement ----------------------------------------------------------

    def _full_batches(self, what: str) -> int:
        nbatches = self._staged_buffers().images.shape[0]
        if nbatches == 0:
            raise ValueError(f"{what} needs at least one full global batch "
                             f"({self.global_batch})")
        return nbatches

    def steady_state_throughput(self, max_iters: int = 3 * WINDOW,
                                window_iters=None) -> Tuple[float, float]:
        """(images/s, images/s per GPU) of the windowed path in steady
        state, as the reference package measures it: a first window
        (capture and warm-up) excluded, then ``max(2, ceil(max_iters /
        w))`` windows back to back, each on a fresh augmentation key, with
        one fetch after the last.  ``window_iters``: steps per window,
        ``"epoch"`` for the whole staged epoch, None for
        ``min(epoch, max(max_iters, 20))``.  It trains: the state moves."""
        nbatches = self._full_batches("steady_state_throughput")
        if window_iters == "epoch":
            w = nbatches
        else:
            w = min(window_iters or max(max_iters, WINDOW), nbatches)
        nwin = max(2, -(-max_iters // w))
        starts = [i * w for i in range(max(nbatches // w, 1))]
        window = self.train_window()
        self._fetch(window(0, 0, w))
        t0 = time.time()
        for i in range(nwin):
            out = window(1 + i, starts[(1 + i) % len(starts)], w)
        self._fetch(out)        # the stream orders every window before it
        elapsed = time.time() - t0
        ips = self.global_batch * w * nwin / elapsed
        return ips, ips / self.world

    def measure_phase_split(self, window_iters: int = 100,
                            windows: int = 3) -> dict:
        """The reference's fwd/bwd split, window-amortized: the forward
        window and the train window timed alternately over the same staged
        batches, each at two sizes (w and w // 2); the per-step cost of
        each is the slope between the sizes (the fixed cost of a window
        cancels), each total the min of ``windows`` timings, and
        backward (+ sync + update) is train - forward.  The train windows
        really train; the state is restored bit for bit afterwards."""
        nbatches = self._full_batches("measure_phase_split")
        w = min(window_iters, nbatches)
        half = max(w // 2, 1)
        if w == half:
            raise ValueError("measure_phase_split needs window_iters >= 2 "
                             "for the two-size slope")
        train, fwd = self.train_window(), self.fwd_window()
        writes = None if train.ring is None else train.ring.writes
        totals = {("fwd", w): [], ("fwd", half): [],
                  ("step", w): [], ("step", half): []}
        with steplib.preserved(train.tensors()):
            for n in (w, half):                 # capture and warm both
                self._fetch(fwd(0, 0, n))
                self._fetch(train(0, 0, n))
            for i in range(windows):
                start = (i % max(nbatches // w, 1)) * w
                for n in (w, half):
                    for prog, window in (("fwd", fwd), ("step", train)):
                        t0 = time.time()
                        self._fetch(window(0, start, n))
                        totals[(prog, n)].append(time.time() - t0)
        if writes is not None:
            train.ring.writes = writes
        span = w - half
        mins_ms = {f"{prog}_{n}": min(ts) * 1e3
                   for (prog, n), ts in totals.items()}
        fwd_ms = (mins_ms[f"fwd_{w}"] - mins_ms[f"fwd_{half}"]) / span
        step_ms = (mins_ms[f"step_{w}"] - mins_ms[f"step_{half}"]) / span
        return {"window_iters": w, "windows": windows,
                "forward_ms_per_iter": fwd_ms,
                "step_ms_per_iter": step_ms,
                "backward_ms_per_iter": step_ms - fwd_ms,
                "dispatch_ms_fwd_window": mins_ms[f"fwd_{w}"] - fwd_ms * w,
                "dispatch_ms_step_window": (
                    mins_ms[f"step_{w}"] - step_ms * w),
                "window_totals_ms": mins_ms}
