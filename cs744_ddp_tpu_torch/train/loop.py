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
  * Fault tolerance (``ft=FTConfig(...)``, ``run(checkpoint_dir=...)``):
    a checkpoint after every epoch and an emergency one on SIGTERM at the
    next window boundary, each resumed bitwise (``train/checkpoint.py``);
    the non-finite guard inside the step, its flags read after the
    window's one fetch and acted on by the policy; the chaos plan's
    ``nonfinite_grad`` and ``preempt`` sites.  A restore ``copy_``s into
    the tensors the captured step holds: ``self.state`` is never rebound.
"""

from __future__ import annotations

import os
import signal
import time
from typing import (Callable, Dict, Iterator, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist

from .. import models as model_zoo
from ..data import cifar10, sharding
from ..device import resolve_device, set_f32_parity
from ..ft import (NULL_CHAOS, FTConfig, NonFiniteError, POLICIES,
                  PreemptedError, PreemptionGuard, check_sites)
from ..obs import ringbuf
from ..ops import sgd
from ..parallel import Group, get_strategy, initialize_distributed
from ..parallel import strategies
from ..utils.metrics import WINDOW, WindowedTimers
from . import step as steplib
from .checkpoint import CheckpointManager, state_digest, validate_rank_keys

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
    loss).

    ``ft``: the fault-tolerance config (None: no guard, no chaos; the
    step is built as without it).  Its plan may name only the sites the
    port fires (``ft.check_sites``)."""

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
                 log: Callable[[str], None] = print,
                 ft: Optional[FTConfig] = None):
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
        # Fault tolerance: ft=None keeps every hot path as without it.
        self.ft = ft
        self.chaos = ft.chaos if ft is not None else NULL_CHAOS
        check_sites(self.chaos)
        self._nf_policy = ft.nonfinite if ft is not None else "off"
        if self._nf_policy not in POLICIES:
            raise ValueError(f"nonfinite policy must be one of {POLICIES}, "
                             f"got {self._nf_policy!r}")
        self._guard_on = self._nf_policy != "off"
        self._nf_chaos_steps = self.chaos.steps("nonfinite_grad")
        if self._nf_chaos_steps and not self._guard_on:
            raise ValueError(
                "chaos nonfinite_grad injection requires a nonfinite policy "
                "(halt/skip/restore) — injecting NaNs with the guard off "
                "just corrupts the run")
        self.preempted = False
        self._preempt_guard: Optional[PreemptionGuard] = None
        self._rollback: Optional[Dict[str, torch.Tensor]] = None
        self.nonfinite_skipped = 0       # run totals (each epoch's are
        self.nonfinite_restored = 0      # logged after it)
        self._epoch_nf = [0, 0]          # this epoch's skipped, restored
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
        self.model_name = model
        self.strategy_name = strategy
        self.compress_rank = compress_rank
        self.sgd_cfg = sgd_cfg
        self.limit_train_batches = limit_train_batches
        self.limit_eval_batches = limit_eval_batches
        self.log = log if self.rank == 0 else _silent

        self.train_split, self.test_split, self.real_data = \
            cifar10.load(data_dir)
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
            seed=seed, compute_dtype=dtype, nonfinite_guard=self._guard_on,
            nonfinite_chaos_steps=self._nf_chaos_steps)
        self.forward_step = steplib.make_forward_step(net, self.group, dtype)
        self.evaluate = steplib.make_eval_window(net, self.group, dtype)
        self.host_round_trips = 0
        self._staged_train = None       # (cache key, StagedEpoch)
        self._staged_eval = None
        self._train_window: Optional[steplib.TrainWindow] = None
        self._fwd_window: Optional[steplib.FwdWindow] = None
        self.last_epoch_timers: Optional[WindowedTimers] = None
        if self._nf_policy == "restore":
            # "The last checkpoint" before any save is the initial state.
            self._snapshot_rollback()

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

    # -- fault tolerance (ft/) ----------------------------------------------

    def _snapshot_rollback(self) -> None:
        """Host copy of every tensor the step carries: the
        ``--nonfinite=restore`` rollback target, refreshed after every
        checkpoint save."""
        self._rollback = {k: t.detach().to("cpu", copy=True) for k, t in
                          steplib.named_state_tensors(self.state).items()}

    def _restore_rollback(self) -> None:
        live = steplib.named_state_tensors(self.state)
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(self._rollback[k])

    def _handle_nonfinite(self, oks, epoch: int) -> None:
        """The host's reaction to the fetched per-step ``ok`` flags.  The
        on-device select already kept the prior state for every bad step;
        this counts and applies the policy."""
        oks = np.asarray(oks)
        bad = int(oks.size - np.count_nonzero(oks))
        if bad == 0:
            return
        if self._nf_policy == "halt":
            raise NonFiniteError(
                f"non-finite loss/grad-norm in epoch {epoch} "
                f"(policy=halt; the bad update was NOT applied)")
        if self._nf_policy == "skip":
            self._epoch_nf[0] += bad
            self.nonfinite_skipped += bad
            return
        # restore: the select already skipped the bad update; also rewind
        # to the last checkpoint snapshot: the steps since it are lost
        # (training goes on with the NEXT batch, not a replay).
        self._epoch_nf[1] += bad
        self.nonfinite_restored += bad
        self._restore_rollback()
        self.log(f"Non-finite step: state rolled back to the last "
                 f"checkpoint snapshot (epoch {epoch})")

    def _record_chaos(self, site: str, step: int) -> None:
        self.log(f"chaos: injected {site} at step {step}")

    def _check_preempt(self, epoch: int, step: int) -> None:
        """Window-boundary preemption poll: fire a planned chaos SIGTERM
        once progress reaches its step, then raise ``PreemptedError`` if a
        signal has arrived (real or injected).  ``step`` is the number of
        batches already trained this epoch: the resume point.  Each rank
        polls its own flag; every rank holds the same plan, so a chaos
        preemption stops them all at one boundary."""
        if self.chaos.enabled and self.chaos.fire_reached("preempt", step):
            if self._preempt_guard is None:
                raise RuntimeError(
                    "chaos preempt requires run(checkpoint_dir=...) — "
                    "without the guard installed SIGTERM would kill the "
                    "process uncheckpointed")
            self._record_chaos("preempt", step)
            os.kill(os.getpid(), signal.SIGTERM)
        g = self._preempt_guard
        if g is not None and g.requested:
            raise PreemptedError(epoch, step)

    def _step_fetch(self, x: torch.Tensor, y: torch.Tensor, epoch: int,
                    idx: int) -> Tuple[float, Optional[float]]:
        """One eager step; its loss and guard flag in ONE fetch."""
        out = self.train_step.with_ok(self.state, x, y, epoch, idx)
        if out.ok is None:
            return float(self._fetch(out.loss)), None
        loss, ok = self._fetch(torch.stack((out.loss,
                                            out.ok.to(torch.float32))))
        return float(loss), float(ok)

    # -- reference-parity loops ---------------------------------------------

    def train_model(self, epoch: int, start_step: int = 0) -> WindowedTimers:
        """One training epoch with the reference's print/timing schedule.

        Windows of ``w = min(20 - start % 20, NB - start)`` steps, each
        timed up to its single fetch, which is also its fence; every step
        of a window is recorded at ``elapsed / w``.  Then the ragged tail
        as one eager step (``steady=False``).  ``profile_phases`` takes the
        per-step path instead.

        ``start_step`` (mid-epoch resume) skips the first batches; the
        windows realign to the absolute 20-step grid, so a resumed run
        trains the same windows as an uninterrupted one."""
        self._epoch_nf = [0, 0]
        if self.profile_phases:
            timers = self._train_model_per_step(epoch, start_step)
        else:
            timers = self._train_model_windowed(epoch, start_step)
        if any(self._epoch_nf):
            self.log(f"Non-finite guard (epoch {epoch}): "
                     f"{self._epoch_nf[0]} update(s) skipped, "
                     f"{self._epoch_nf[1]} rollback(s)")
        return timers

    def _train_model_windowed(self, epoch: int,
                              start_step: int) -> WindowedTimers:
        timers = WindowedTimers(self.log)
        staged = self._stage_train_epoch(epoch)
        window = self.train_window()
        nbatches = staged.images.shape[0]
        start = start_step
        self._check_preempt(epoch, start)
        while start < nbatches:
            w = min(WINDOW - start % WINDOW, nbatches - start)
            t0 = time.time()
            fetched = self._fetch(window(epoch, start, w))
            per_iter = (time.time() - t0) / w
            losses, oks = window.columns(fetched, start, w)
            for loss in losses:
                timers.record(float(loss), per_iter)
            if self._nf_chaos_steps and \
                    self.chaos.fire_range("nonfinite_grad", start, start + w):
                self._record_chaos("nonfinite_grad", next(
                    s for s in self._nf_chaos_steps if start <= s < start + w))
            start += w
            if oks is not None:
                self._handle_nonfinite(oks, epoch)
            self._check_preempt(epoch, start)
        if staged.tail is not None and start_step <= nbatches:
            t0 = time.time()
            if self._nf_chaos_steps and \
                    self.chaos.fire("nonfinite_grad", nbatches):
                self._record_chaos("nonfinite_grad", nbatches)
            loss, ok = self._step_fetch(*staged.tail, epoch, nbatches)
            timers.record(loss, time.time() - t0, steady=False)
            if ok is not None:
                self._handle_nonfinite([ok], epoch)
        self.last_epoch_timers = timers
        return timers

    def _train_model_per_step(self, epoch: int,
                              start_step: int = 0) -> WindowedTimers:
        """One eager step per batch, its loss fetched after it, and the
        forward-only program timed (and fetched) before it."""
        timers = WindowedTimers(self.log)
        self._check_preempt(epoch, start_step)
        for it, (imgs, labs) in enumerate(_train_batches(
                self.train_split, self.global_batch, epoch, self.seed,
                self.world, self.rank)):
            if self.limit_train_batches is not None and \
                    it >= self.limit_train_batches:
                break
            if it < start_step:
                continue
            x, y = self._to_device(imgs, labs)
            t0 = time.time()
            self._fetch(self.forward_step(x, y))
            fwd_time = time.time() - t0
            if self._nf_chaos_steps and \
                    self.chaos.fire("nonfinite_grad", it):
                self._record_chaos("nonfinite_grad", it)
            t0 = time.time()
            loss, ok = self._step_fetch(x, y, epoch, it)
            timers.record(loss, time.time() - t0, fwd_time,
                          steady=len(labs) == self.per_rank_batch)
            if ok is not None:
                self._handle_nonfinite([ok], epoch)
            self._check_preempt(epoch, it + 1)
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

    # -- checkpoints ---------------------------------------------------------

    def checkpoint_config(self) -> dict:
        """The run's identity, as the config guard compares it."""
        return {
            "model": self.model_name, "strategy": self.strategy_name,
            "compress_rank": self.compress_rank, "seed": self.seed,
            "precision": self.precision, "global_batch": self.global_batch,
            "world": self.world, "augment": self.augment,
            "reshuffle_each_epoch": False,
            "lr": self.sgd_cfg.lr, "momentum": self.sgd_cfg.momentum,
            "weight_decay": self.sgd_cfg.weight_decay,
            "limit_train_batches": self.limit_train_batches,
            "real_data": self.real_data,
            "state_digest": state_digest(
                steplib.named_state_tensors(self.state))}

    def _epoch_meta(self, epoch: int) -> dict:
        """The topology and data-order sidecar of every save."""
        return {
            "world": self.world, "global_batch": self.global_batch,
            "seed": self.seed, "reshuffle_each_epoch": False,
            "rank_keys": list(sharding.rank_data_keys(
                len(self.train_split.labels), self.world, seed=self.seed,
                epoch=epoch))}

    def _data_order_meta(self, epoch: int, step: int) -> dict:
        """The mid-epoch sidecar's ``data_order``."""
        return {"seed": self.seed, "epoch": epoch, "step": step,
                "reshuffle_each_epoch": False, **self._epoch_meta(epoch)}

    def checkpoint_tensors(self) -> Dict[str, torch.Tensor]:
        """What a save writes: a CPU copy of every tensor the step
        carries, the comm state stacked over the ranks ``(world, ...)``.
        A collective at world > 1 (every rank calls it); it goes to
        ``torch.distributed`` directly, not through the counted
        ``Group``."""
        live = steplib.named_state_tensors(self.state)
        comm = [k for k in live if k.startswith("comm/")]
        out = {k: t.detach().to("cpu", copy=True) for k, t in live.items()
               if k not in comm}
        if not comm:
            return out
        if self.world == 1:
            out.update((k, live[k].detach().to("cpu", copy=True)[None])
                       for k in comm)
            return out
        flat = torch.cat([live[k].reshape(-1) for k in comm])
        rows = [torch.empty_like(flat) for _ in range(self.world)]
        dist.all_gather(rows, flat)
        stacked = torch.stack(rows).cpu()
        off = 0
        for k in comm:
            n = live[k].numel()
            out[k] = stacked[:, off:off + n].reshape(
                (self.world,) + tuple(live[k].shape)).clone()
            off += n
        return out

    def load_checkpoint(self, tensors: Dict[str, torch.Tensor]) -> None:
        """``copy_`` a checkpoint (``checkpoint_tensors``' layout; this
        rank takes its row of the comm state) into the tensors the step
        carries.  Raises, before writing anything, if it does not fit
        them name for name, shape for shape and dtype for dtype."""
        live = steplib.named_state_tensors(self.state)
        if set(tensors) != set(live):
            raise ValueError(
                f"the checkpoint's tensors do not fit this Trainer's: "
                f"missing {sorted(set(live) - set(tensors))}, unexpected "
                f"{sorted(set(tensors) - set(live))}")
        src = {}
        for k, t in live.items():
            v = tensors[k]
            if k.startswith("comm/"):
                if v.dim() == 0 or v.shape[0] != self.world:
                    raise ValueError(f"{k}: {tuple(v.shape)} is not stacked "
                                     f"over {self.world} rank(s)")
                v = v[self.rank]
            if v.shape != t.shape or v.dtype != t.dtype:
                raise ValueError(f"{k}: the checkpoint holds {v.dtype}"
                                 f"{list(v.shape)}, the Trainer "
                                 f"{t.dtype}{list(t.shape)}")
            src[k] = v
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(src[k])

    def _save(self, mngr: CheckpointManager, epoch: int,
              step: Optional[int] = None) -> None:
        """An epoch save (``step`` None; it clears the mid-epoch save) or
        an emergency save after ``step`` batches of ``epoch``.  Every rank
        gathers, rank 0 writes, and every rank passes a barrier after the
        write, so no rank goes on before the save exists."""
        tensors = self.checkpoint_tensors()
        if self.rank == 0:
            if step is None:
                mngr.save(epoch, tensors, meta=self._epoch_meta(epoch))
                mngr.clear_mid_epoch()
            else:
                mngr.save_mid_epoch(epoch, step, tensors,
                                    data_order=self._data_order_meta(
                                        epoch, step))
        if self.world > 1:
            dist.barrier()

    def _resume(self, mngr: CheckpointManager) -> Tuple[int, int]:
        """Restore the newest save, if any: (start epoch, start step).  A
        mid-epoch save outranks the epoch series only when it is AHEAD of
        it (a crash between an epoch save and its clear leaves a stale
        one behind)."""
        n = len(self.train_split.labels)
        mid, le = mngr.latest_mid_epoch(), mngr.latest_epoch()
        if mid is not None and (le is None or mid[0] > le):
            tensors, epoch, step = mngr.restore_mid_epoch()
            validate_rank_keys(mngr.mid_epoch_meta(), n)
            self.load_checkpoint(tensors)
            self.log(f"Resumed from mid-epoch checkpoint: epoch {epoch}, "
                     f"step {step}")
            return epoch, step
        if le is not None:
            tensors, epoch = mngr.restore()
            validate_rank_keys(mngr.epoch_meta(), n)
            self.load_checkpoint(tensors)
            self.log(f"Resumed from checkpoint: epoch {epoch}")
            return epoch, 0
        return 0, 0

    def run(self, epochs: int = 1,
            checkpoint_dir: Optional[str] = None) -> None:
        """Epochs of train + eval with the epoch timing line.

        With ``checkpoint_dir``: resume from its newest save (the config
        guard refuses another run's directory), and save after every
        epoch's eval.  While it runs (with a checkpoint dir or an ``ft``
        config), SIGTERM/SIGINT request a stop at the next window
        boundary: an emergency mid-epoch save (with a checkpoint dir), and
        a return with ``self.preempted`` set; a later ``run`` on the same
        directory resumes from that step, bitwise.  A SIGTERM to one rank
        alone leaves its peers waiting at their next collective: a
        scheduler signals every rank of a job."""
        start_epoch, start_step = 0, 0
        mngr = None
        if checkpoint_dir is not None:
            mngr = CheckpointManager(checkpoint_dir,
                                     config=self.checkpoint_config())
            start_epoch, start_step = self._resume(mngr)
        if self._nf_policy == "restore":
            self._snapshot_rollback()
        try:
            if mngr is not None or self.ft is not None:
                self._preempt_guard = PreemptionGuard(log=self.log).install()
            if start_epoch >= epochs:
                self.log(f"All {epochs} epoch(s) already checkpointed; "
                         f"nothing to run")
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                try:
                    self.train_model(epoch, start_step=start_step)
                except PreemptedError as e:
                    self.preempted = True
                    if mngr is not None:
                        self._save(mngr, e.epoch, e.step)
                        self.log(f"Preempted at epoch {e.epoch} step "
                                 f"{e.step}; emergency checkpoint saved")
                    else:
                        self.log(f"Preempted at epoch {e.epoch} step "
                                 f"{e.step}; no checkpoint dir — progress "
                                 f"since the last save is lost")
                    return
                start_step = 0
                self.log(f"Training time after {epoch + 1} epoch is "
                         f"{time.time() - t0}")
                self.test_model()
                if mngr is not None:
                    self._save(mngr, epoch)
                    if self._nf_policy == "restore":
                        self._snapshot_rollback()
                if self._preempt_guard is not None and \
                        self._preempt_guard.requested:
                    # The signal landed during eval or the save: the epoch
                    # boundary just saved is the resume point.
                    self.preempted = True
                    self.log(f"Preemption requested; stopping after epoch "
                             f"{epoch} completed")
                    return
        finally:
            if self._preempt_guard is not None:
                self._preempt_guard.uninstall()
                self._preempt_guard = None

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
