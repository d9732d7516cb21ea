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
  * ``host_augment=True`` moves the crop/flip to the C++ host pipeline
    (``data/native.py``; the reference script's DataLoader workers): a
    producer thread gathers and augments each batch into a pinned arena
    slot, copies it to a device chunk on a copy stream, and the window
    trains from one window buffer the chunks are assembled into
    (``_train_model_host_windowed``); the per-step path and the ragged
    tail take f32 host-normalized batches.  The crop/flip stream is the
    reference's ``np.random.default_rng([seed, epoch, it])`` over the
    global batch, each rank taking its rows, so every host path trains the
    same bits.  Under an ``FTConfig`` the staging is supervised: retried
    puts, a watchdog, checksums, a stall deadline, a producer restart and
    then a degraded synchronous mode (``ft/supervisor.py``).
  * ``elastic`` (``"weak"``, ``"strong"`` or an ``ElasticConfig``;
    ``elastic/``): a checkpoint of another world size is resumed, its
    progress re-planned (``elastic.protocol.plan_resume``) and its comm
    state resharded.  ``"strong"`` pins the global batch: batch b is
    canonical positions ``[b*B, (b+1)*B)``, wrap-padded to whole batches,
    rank r of world M staging its contiguous columns
    ``[r*B/M, (r+1)*B/M)``, and the window's body is the microshard step
    (``elastic/step_elastic.py``) whose update is bitwise the same at every
    world.  At every window boundary (with ``elastic`` or an ``FTConfig``)
    the ranks exchange their window times for the straggler detector, and
    the ``slow_rank`` and ``rank_death`` chaos sites fire; a death saves an
    emergency checkpoint and ``run`` returns with ``rank_death`` set, for
    the coordinator (``elastic/coordinator.py``) to relaunch a smaller
    world.
  * ``telemetry`` (``obs/telemetry.py``; ``NULL`` by default): the
    reference's structured record of the run, on rank 0 alone — the run
    manifest, one step event per trained step (on the windowed paths with
    the metric ring's ``grad_sqnorm`` and absolute ``step_index``, from the
    window's one fetch), spans (windows, warm-up and capture, eval, saves,
    the host pipeline's stages on its producer thread), counters (host
    round trips, faults, the collectives of one step) and gauges (memory,
    queue depths, the ranks' step times).  Every record is built from what
    the host already holds: no record adds a fetch, a sync or a kernel.
    ``run(profile_dir=...)`` traces the first trained epoch with
    ``torch.profiler`` into a Chrome trace JSON.
"""

from __future__ import annotations

import contextlib
import os
import queue
import resource
from collections import Counter
import signal
import threading
import time
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

from .. import models as model_zoo
from ..data import cifar10, native, sharding
from ..device import resolve_device, set_f32_parity
from ..elastic.protocol import (PROTOCOLS, ElasticConfig, flat_meta,
                                plan_resume)
from ..elastic.step_elastic import MicroshardStep
from ..elastic.straggler import StragglerDetector
from ..ft import (NULL_CHAOS, ChaosError, FTConfig, NonFiniteError, POLICIES,
                  PreemptedError, PreemptionGuard, RankDeathError,
                  check_sites)
from ..ft import supervisor as ftsup
from ..obs import NULL, git_sha, ringbuf
from ..ops import sgd
from ..parallel import Group, get_strategy, initialize_distributed
from ..parallel import strategies
from ..parallel.mesh import all_gather_into
from ..utils.metrics import WINDOW, WindowedTimers
from . import step as steplib
from ..publish import WeightPublisher
from .checkpoint import (CheckpointManager, publish_fingerprint,
                         state_digest, validate_rank_keys)

GLOBAL_BATCH = 256      # the reference's batch_size
SEED = 0                # the reference's torch.manual_seed(0)
STRATEGIES = tuple(strategies.STRATEGIES)
# --precision -> the activations' dtype (None: f32 throughout).
PRECISIONS = {"f32": None, "bf16": torch.bfloat16}
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rank_batch_cols(n_examples: int, global_batch: int, epoch: int,
                     seed: int, world: int = 1, rank: int = 0,
                     reshuffle_each_epoch: bool = False
                     ) -> Iterator[np.ndarray]:
    """Rank ``rank``'s example indices of each of the epoch's global
    batches in sampler order (the reference package's
    ``_shard_batch_cols``, this rank's block of each); the last may be
    short."""
    per = global_batch // world
    idx = sharding.global_epoch_indices(
        n_examples, world, seed=seed, epoch=epoch,
        reshuffle_each_epoch=reshuffle_each_epoch)[rank]
    for start in range(0, len(idx), per):
        yield idx[start:start + per]


def _train_batches(split: cifar10.Split, global_batch: int, epoch: int,
                   seed: int, world: int = 1, rank: int = 0,
                   reshuffle_each_epoch: bool = False
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Rank ``rank``'s rows of the epoch's global batches in sampler order;
    the last one may be short."""
    for cols in _rank_batch_cols(len(split.labels), global_batch, epoch,
                                 seed, world, rank, reshuffle_each_epoch):
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


def emit_memory_gauges(telemetry, device: torch.device, **attrs) -> None:
    """Host and device memory at a window or epoch boundary: the peak
    host RSS (``resource.getrusage``) and, on the card, the bytes the
    caching allocator holds live (``torch.cuda.memory_allocated``, a host
    count: no sync).  On the CPU the host field alone, as the reference's
    on a backend without a device memory API.  The guard is inside, so a
    call site is one line and the NULL recorder costs one attribute
    check."""
    if not telemetry.enabled:
        return
    rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    payload = {"host_rss_peak_mib": round(rss_kib / 1024.0, 1)}
    if device.type == "cuda":
        payload["device_live_mib"] = round(
            torch.cuda.memory_allocated(device) / 2 ** 20, 2)
    telemetry.gauge("memory", payload, **attrs)


def elastic_config(elastic, global_batch: int, *, host_augment: bool = False,
                   profile_phases: bool = False,
                   nonfinite_guard: bool = False) -> Optional[ElasticConfig]:
    """``elastic`` as an ``ElasticConfig`` (a protocol name stands for its
    default config; None stays None), refused as the reference's Trainer
    refuses it: an unknown protocol, and under strong scaling a global
    batch the microshards do not divide, the host pipeline (its streams
    are rank-shaped), the per-step path and the non-finite guard (the
    microshard step has neither)."""
    if elastic is None:
        return None
    if isinstance(elastic, str):
        elastic = ElasticConfig(protocol=elastic)
    if elastic.protocol not in PROTOCOLS:
        raise ValueError(f"elastic protocol must be one of {PROTOCOLS}, "
                         f"got {elastic.protocol!r}")
    if elastic.protocol == "strong":
        s = elastic.microshards
        if global_batch % s:
            raise ValueError(
                f"elastic strong scaling: global batch {global_batch} not "
                f"divisible by microshards {s}")
        if host_augment:
            raise ValueError(
                "elastic strong scaling requires device-side augmentation "
                "(host streams are rank-shaped)")
        if profile_phases:
            raise ValueError(
                "elastic strong scaling is windowed-only; profile_phases "
                "uses the per-step programs")
        if nonfinite_guard:
            raise ValueError(
                "elastic strong scaling does not support the non-finite "
                "guard (the pinned window carries no guarded variant)")
    return elastic


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


class Chunk(NamedTuple):
    """A staged chunk of ``k`` consecutive batches from absolute batch
    ``lo``; ``last`` closes a window.  Its rows are in ``slot`` of the
    device chunks once ``ready`` (the copy stream's event; None on the
    CPU) has passed, or, ``slot`` None (the degraded mode), in the host
    arrays ``host``."""
    k: int
    lo: int
    last: bool
    slot: Optional[int]
    ready: Optional[torch.cuda.Event]
    host: Optional[Tuple[np.ndarray, np.ndarray]] = None


class ChunkSlots:
    """The device side of the staging arena: for each arena slot, a device
    chunk (images ``[cap, b, 32, 32, 3]`` uint8, labels ``[cap, b]``
    int64) and a host label buffer (pinned on the card), all allocated
    here, before any capture.

    A slot is lent to the producer (``claim``) and given back by the
    consumer once a window's assembly has read its device chunk
    (``release``, with the event recorded after the assembly, which the
    copy stream waits on before it writes the chunk again).  The arena
    hands slots out in turn and fences their host memory; this is what
    keeps a producer that has run ahead from overwriting a device chunk
    the consumer has not assembled yet."""

    def __init__(self, nslots: int, cap: int, batch: int,
                 device: torch.device):
        pin = device.type == "cuda"
        self.images = [torch.empty((cap, batch, 32, 32, 3),
                                   dtype=torch.uint8, device=device)
                       for _ in range(nslots)]
        self.labels = [torch.empty((cap, batch), dtype=torch.int64,
                                   device=device) for _ in range(nslots)]
        self.host_labels = [torch.empty((cap, batch), dtype=torch.int64,
                                        pin_memory=pin)
                            for _ in range(nslots)]
        self._free = [threading.Event() for _ in range(nslots)]
        self._after: List[Optional[torch.cuda.Event]] = [None] * nslots
        self.release_all()

    def claim(self, slot: int, stop: threading.Event) -> bool:
        """Wait until ``slot`` is free and lend it; False if ``stop`` was
        set first."""
        while not self._free[slot].wait(0.05):
            if stop.is_set():
                return False
        self._free[slot].clear()
        return True

    def after(self, slot: int) -> Optional[torch.cuda.Event]:
        """The event the copy stream waits on before writing ``slot``'s
        device chunk (None: nothing read it yet)."""
        return self._after[slot]

    def release(self, slot: int, after: Optional[torch.cuda.Event]) -> None:
        self._after[slot] = after
        self._free[slot].set()

    def release_all(self) -> None:
        """Free every slot (no producer runs): a window given up, or an
        iterator closed, leaves no slot lent."""
        for ev in self._free:
            ev.set()


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

    ``ft``: the fault-tolerance config (None: no guard, no chaos, no
    staging supervision; the step is built as without it).  Its plan may
    name only the sites the port fires (``ft.check_sites``; the publish
    sites with ``run(publish_dir=)`` only).

    ``host_augment``: the C++ host pipeline crops and flips (see the
    module docstring), each window staged in ``host_chunks`` chunks.
    ``reshuffle_each_epoch``: another sampler order every epoch (the
    reference script keeps one order).  Both as the reference's
    ``Trainer`` takes them.

    ``elastic``: ``"weak"``, ``"strong"`` or an ``ElasticConfig`` (see the
    module docstring; ``elastic_config`` says what strong scaling
    refuses).  After a ``rank_death``, ``run`` returns with
    ``rank_death = (rank, epoch, step)``; ``resume_plan`` is the
    ``ResumePlan`` of an elastic mid-epoch resume.

    ``telemetry``: the recorder (``obs.Telemetry``), kept on rank 0 alone
    (the others get ``NULL``, as the reference's one controller writes one
    stream); the manifest is written here."""

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
                 ft: Optional[FTConfig] = None,
                 host_augment: bool = False, host_chunks: int = 4,
                 reshuffle_each_epoch: bool = False, elastic=None,
                 telemetry=NULL):
        if host_chunks < 1:
            raise ValueError(f"host_chunks must be >= 1, got {host_chunks}")
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
        # The publish sites need run(publish_dir=), which refuses them
        # without one.
        check_sites(self.chaos, host_augment, elastic is not None,
                    publish=True)
        self.host_augment = host_augment
        self.host_chunks = int(host_chunks)
        self.reshuffle_each_epoch = reshuffle_each_epoch
        # Staging supervision, as the reference's: on with any FTConfig.
        self._supervise = ft is not None
        self._verify_chunks = bool(ft is not None and (
            ft.verify_chunks or self.chaos.steps("corrupt_slot")))
        self.staging_degraded = bool(ft is not None and ft.degrade_staging)
        self.producer_failures = 0
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
        self.elastic = elastic_config(
            elastic, global_batch, host_augment=host_augment,
            profile_phases=profile_phases, nonfinite_guard=self._guard_on)
        self._strong = self.elastic is not None and \
            self.elastic.protocol == "strong"
        self.rank_death: Optional[Tuple[int, int, int]] = None
        self.resume_plan = None
        self._straggler: Optional[StragglerDetector] = None
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
        # Process-wide, as the switch is: bitwise world invariance is the
        # strong protocol's contract, and cuDNN's nondeterministic
        # algorithms would break it.
        turn_deterministic = self._strong and self.device.type == "cuda" \
            and not torch.backends.cudnn.deterministic
        if turn_deterministic:
            torch.backends.cudnn.deterministic = True
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
        self.telemetry = telemetry if self.rank == 0 else NULL
        if turn_deterministic:
            self.log("elastic strong: deterministic cuDNN turned on (the "
                     "update must be bitwise the same at every world)")

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
        step_kw = dict(group=self.group, seed=seed, compute_dtype=dtype,
                       nonfinite_guard=self._guard_on,
                       nonfinite_chaos_steps=self._nf_chaos_steps)
        # With host_augment the per-step path and the ragged tail take the
        # host pipeline's f32 batches, and the window its uint8 ones.
        self.train_step = steplib.make_train_step(
            net, strat, sgd_cfg, augment="host" if host_augment else augment,
            **step_kw)
        self._window_body = self._make_window_body(
            net, strat, self.group, shared=self.train_step.body,
            nonfinite_chaos_steps=self._nf_chaos_steps)
        self.forward_step = steplib.make_forward_step(
            net, self.group, dtype, augment="host" if host_augment else False)
        self.evaluate = steplib.make_eval_window(net, self.group, dtype)
        self.host_round_trips = 0
        self._staged_train = None       # (cache key, StagedEpoch)
        self._staged_eval = None
        self._train_window: Optional[steplib.TrainWindow] = None
        self._fwd_window: Optional[steplib.FwdWindow] = None
        # The host path's staging (made at its first use, before the
        # producer starts and the window is captured).
        self._copy_stream = torch.cuda.Stream(self.device) \
            if host_augment and self.device.type == "cuda" else None
        self._staging_arena: Optional[native.StagingArena] = None
        self._chunk_slots: Optional[ChunkSlots] = None
        self._producer: Optional[threading.Thread] = None
        self.last_epoch_timers: Optional[WindowedTimers] = None
        # The last host windowed epoch: seconds the consumer waited for
        # each window's chunks, and the producer's seconds by phase.
        self.last_chunk_waits: List[float] = []
        self.last_producer_times: Counter = Counter()
        self._window_prepared = False
        self._collective_stats_emitted = False
        self.profile_trace: Optional[str] = None
        if self._nf_policy == "restore":
            # "The last checkpoint" before any save is the initial state.
            self._snapshot_rollback()
        if self.telemetry.enabled:
            self._write_manifest(precision, host_augment, host_chunks,
                                 profile_phases)

    # -- telemetry (obs/) ---------------------------------------------------

    def _write_manifest(self, precision: str, host_augment: bool,
                        host_chunks: int, profile_phases: bool) -> None:
        """The run header, with the reference's keys; ``torch_version``,
        ``cuda_version`` and the device's own ``backend`` in place of its
        JAX version and backend."""
        ft = self.ft
        ft_manifest = None
        if ft is not None:
            ft_manifest = {
                "nonfinite": self._nf_policy,
                "chaos": self.chaos.spec() if self.chaos.enabled else [],
                "put_timeout_s": ft.put_timeout_s,
                "put_retries": ft.put_retries,
                "stall_timeout_s": ft.stall_timeout_s,
                "producer_restarts": ft.producer_restarts,
                "verify_chunks": self._verify_chunks,
                "degrade_staging": ft.degrade_staging,
            }
        cuda = self.device.type == "cuda"
        self.telemetry.write_manifest({
            "fault_tolerance": ft_manifest,
            "model": self.model_name,
            "strategy": self.strategy_name,
            "world_size": self.world,
            "global_batch": self.global_batch,
            "precision": precision,
            "augment": self.augment,
            "host_augment": host_augment,
            "host_chunks": host_chunks,
            "elastic": (None if self.elastic is None else
                        {"protocol": self.elastic.protocol,
                         "microshards": self.elastic.microshards}),
            "profile_phases": profile_phases,
            "metrics_ring": self.metrics_ring,
            "seed": self.seed,
            "reshuffle_each_epoch": self.reshuffle_each_epoch,
            "real_data": self.real_data,
            "lr": self.sgd_cfg.lr, "momentum": self.sgd_cfg.momentum,
            "weight_decay": self.sgd_cfg.weight_decay,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "backend": self.device.type,
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if cuda else "cpu"),
            "num_devices": self.world,
            "native_loader": {"available": native.available(),
                              "error": native.load_error()},
            "git_sha": git_sha(REPO_ROOT),
        })

    def _emit_device_gauges(self, epoch: int) -> None:
        """The card's memory at an epoch's end: the bytes the allocator
        holds live and at its peak, and the device's total (nothing on the
        CPU, as the reference's CPU backend has no ``memory_stats``)."""
        if self.device.type != "cuda":
            return
        _, total = torch.cuda.mem_get_info(self.device)
        self.telemetry.gauge("device_memory", {
            "bytes_in_use": torch.cuda.memory_allocated(self.device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.device),
            "bytes_limit": total}, device=self.device.index, epoch=epoch)

    def _emit_collective_telemetry(self) -> None:
        """Once per Trainer, after its first trained step: the collectives
        of one step under the reference's op names (``Group.OP_NAMES``),
        counted and sized by the ``Group`` (``step_counts`` and
        ``step_bytes``; after a replay, the captured step's), their totals,
        and what a compressed tier saves against every f32 gradient byte
        once.  ``chain_depth`` is None: there is no HLO to read it from."""
        if self._collective_stats_emitted:
            return
        self._collective_stats_emitted = True
        ops: Dict[str, Dict[str, int]] = {}
        if self.group is not None:
            for kind, n in self.group.step_counts.items():
                entry = ops.setdefault(Group.OP_NAMES[kind],
                                       {"count": 0, "bytes": 0})
                entry["count"] += n
                entry["bytes"] += self.group.step_bytes[kind]
        mib = {op: round(e["bytes"] / 2 ** 20, 2) for op, e in ops.items()}
        for op, entry in ops.items():
            self.telemetry.counter(f"collective_{op}_count", entry["count"])
            self.telemetry.counter(f"collective_{op}_result_mib", mib[op])
        total_mib = round(sum(mib.values()), 2)
        self.telemetry.gauge("collective_totals", {
            "total_count": sum(e["count"] for e in ops.values()),
            "total_result_mib": total_mib, "chain_depth": None})
        grad_mib = sum(p.numel() * 4 for p in
                       self.state.model.parameters()) / 2 ** 20
        sent_mib = sum(e["bytes"] for e in ops.values()) / 2 ** 20
        self.telemetry.gauge("comm_bytes_saved", {
            "strategy": self.strategy_name,
            "baseline_grad_mib": round(grad_mib, 3),
            "strategy_result_mib": total_mib,
            "saved_mib": round(max(0.0, grad_mib - sent_mib), 3)})

    def _record_window(self, timers: WindowedTimers,
                       cols: steplib.WindowColumns, per_iter: float) -> None:
        """Feed a drained window into the timers, each step at the
        window's mean time; with telemetry on and the ring, each step event
        also carries the ring's ``grad_sqnorm`` and the step's absolute
        index (the reference's ``_consume_ring``)."""
        if self.telemetry.enabled:
            self._emit_collective_telemetry()
            if cols.grad_sqnorm is not None:
                for loss, gsq, step in zip(cols.loss, cols.grad_sqnorm,
                                           cols.steps):
                    timers.record(float(loss), per_iter,
                                  extra={"grad_sqnorm": float(gsq),
                                         "step_index": int(step)})
                return
        for loss in cols.loss:
            timers.record(float(loss), per_iter)

    def _prepare_window(self, window: steplib.TrainWindow) -> None:
        """Before the window's first run: its step warmed up and captured
        (on the card; the CPU runs it eagerly), inside a ``compile_warmup``
        span naming the program, as the reference compiles its window
        ahead of time."""
        if self._window_prepared:
            return
        program = "train_window_host" if self.host_augment \
            else "train_window"
        with self.telemetry.span("compile_warmup", program=program,
                                 graph=self.device.type == "cuda"):
            window.step.prepare()
        self._window_prepared = True

    @contextlib.contextmanager
    def _profiled(self, profile_dir: str, epoch: int) -> Iterator[None]:
        """``torch.profiler`` over the block (CPU activity, and the card's
        on CUDA), written as a Chrome trace JSON into ``profile_dir`` when
        it ends, however it ends; on rank 0 (the others run unprofiled).
        ``profile_trace`` is the file's path."""
        if self.rank != 0:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            path = os.path.join(profile_dir,
                                f"trace_epoch{epoch}_rank{self.rank}.json")
            prof.export_chrome_trace(path)
            self.profile_trace = path

    # -- on-device staging --------------------------------------------------

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        # Copies: the cached synthetic split is read-only.
        return (torch.tensor(images, device=self.device),
                torch.tensor(labels, dtype=torch.int64, device=self.device))

    def _epoch_cols(self, epoch: int
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """This rank's example indices of the epoch's full batches within
        the limit ``[nfull, b]``, and of its ragged tail batch (None when
        it has none within the limit).  Rank r of world w takes positions
        ``r::w`` of the sampler's order; under strong scaling batch b is
        canonical positions ``[b*B, (b+1)*B)``, wrap-padded to whole
        batches (no tail at any world), and rank r its contiguous columns,
        so that it holds microshards ``r*k .. r*k + k - 1``."""
        n, per = len(self.train_split.labels), self.per_rank_batch
        if self._strong:
            nb = -(-n // self.global_batch)
            if self.limit_train_batches is not None:
                nb = min(nb, self.limit_train_batches)
            order = sharding.canonical_epoch_order(
                n, seed=self.seed, epoch=epoch,
                reshuffle_each_epoch=self.reshuffle_each_epoch,
                pad_to=nb * self.global_batch)
            cols = order[:nb * self.global_batch].reshape(
                nb, self.global_batch)
            return cols[:, self.rank * per:(self.rank + 1) * per], None
        order = sharding.global_epoch_indices(
            n, self.world, seed=self.seed, epoch=epoch,
            reshuffle_each_epoch=self.reshuffle_each_epoch)[self.rank]
        nbatches = -(-len(order) // per)
        if self.limit_train_batches is not None:
            nbatches = min(nbatches, self.limit_train_batches)
        nfull = min(len(order) // per, nbatches)
        tail = order[nfull * per:] if nfull < nbatches else None
        return order[:nfull * per].reshape(nfull, per), tail

    def _stage_train_epoch(self, epoch: int) -> StagedEpoch:
        """This rank's rows of every full batch of ``epoch`` in persistent
        device buffers ``[NB, b, 32, 32, 3]`` / ``[NB, b]``, the ragged
        tail batch apart (``_epoch_cols``).  Cached on the split and the
        columns; another order is restaged by ``copy_`` into the same
        buffers, so that a captured window's addresses hold."""
        split = self.train_split
        cols, tail_cols = self._epoch_cols(epoch)
        key = (id(split), cols.tobytes(),
               None if tail_cols is None else tail_cols.tobytes())
        if self._staged_train is not None and self._staged_train[0] == key:
            return self._staged_train[1]
        nfull, per = cols.shape
        images = torch.from_numpy(
            split.images[cols.reshape(-1)].reshape(nfull, per, 32, 32, 3))
        labels = torch.from_numpy(
            split.labels[cols].astype(np.int64))
        tail = None
        if tail_cols is not None:
            tail = self._to_device(*(a[tail_cols] for a in split))
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
        """The window over the staged buffers (made at its first use);
        with ``host_augment``, over the host path's window buffer."""
        if self._train_window is None:
            if self.host_augment:
                per = self.per_rank_batch
                images = torch.empty((WINDOW, per, 32, 32, 3),
                                     dtype=torch.uint8, device=self.device)
                labels = torch.zeros((WINDOW, per), dtype=torch.int64,
                                     device=self.device)
            else:
                staged = self._staged_buffers()
                images, labels = staged.images, staged.labels
            self._train_window = steplib.TrainWindow(
                self._window_body, self.state, images, labels,
                group=self.group, ring_capacity=self.metrics_ring,
                buffered=self.host_augment)
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
        """One device-to-host round trip.  On the card the host first waits
        for the queued work on a blocking-sync event, so that the copy finds
        the stream idle: a device-to-host copy that waits holds up every
        other thread's host-to-device copies until the window ends (the
        staging producer's; ``utils/profile_host.py`` measures it)."""
        self.host_round_trips += 1
        if t.is_cuda:
            done = torch.cuda.Event(blocking=True)
            done.record(torch.cuda.current_stream(t.device))
            done.synchronize()
        return t.cpu().numpy()

    def _count_round_trip(self, site: str, **attrs) -> None:
        """The telemetry of one ``_fetch`` of training or eval, tagged with
        its ``site`` (the reference's names: ``window_drain``,
        ``window_fetch``, ``step_fetch``, ``eval``; and ``forward_fetch``,
        the per-step path's forward, which the reference fetches
        uncounted)."""
        if self.telemetry.enabled:
            self.telemetry.counter("host_round_trips", 1, site=site, **attrs)

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
            self.telemetry.counter("nonfinite_skipped", bad, epoch=epoch)
            return
        # restore: the select already skipped the bad update; also rewind
        # to the last checkpoint snapshot: the steps since it are lost
        # (training goes on with the NEXT batch, not a replay).
        self._epoch_nf[1] += bad
        self.nonfinite_restored += bad
        self.telemetry.counter("nonfinite_restored", bad, epoch=epoch)
        self._restore_rollback()
        self.log(f"Non-finite step: state rolled back to the last "
                 f"checkpoint snapshot (epoch {epoch})")

    def _record_chaos(self, site: str, step: int) -> None:
        self.telemetry.counter("chaos_injected", 1, site=site, step=step)
        self.log(f"chaos: injected {site} at step {step}")

    def _rank_step_times(self, t: float) -> List[float]:
        """Every rank's window step time, in rank order: ONE all-gather of
        one number, outside the captured step and not through the counted
        ``Group`` (a device tensor: NCCL moves no host memory)."""
        if self.world == 1:
            return [t]
        mine = torch.full((1,), t, dtype=torch.float64, device=self.device)
        every = torch.empty(self.world, dtype=torch.float64,
                            device=self.device)
        all_gather_into(every, mine)
        return every.tolist()

    def _rank_boundary(self, epoch: int, step: int, per_iter: float) -> None:
        """Window-boundary rank bookkeeping (with ``elastic`` or an
        ``FTConfig``; else nothing): the ranks' step-time gauges, the
        straggler detector, and the rank-level chaos sites.  Each rank
        measured its own window (``per_iter``) before it gets here, so a
        rank that waits below for a slow peer does not count the wait.
        ``slow_rank`` stalls its target rank, which adds the stall to its
        own gauge; the detector, fed every rank's gauge, must flag it
        alone.  ``rank_death`` raises ``RankDeathError`` on every rank (a
        step boundary: ``step`` batches are what the emergency checkpoint
        records)."""
        if self.elastic is None and not self._supervise:
            return
        stall = 0.0
        if self.chaos.enabled and self.chaos.fire_reached("slow_rank", step):
            planned = self.chaos.fired[-1][1]
            self._record_chaos("slow_rank", step)
            if self.chaos.seed_of("slow_rank", planned) == self.rank:
                stall = (self.ft or FTConfig()).slow_rank_stall_s
                time.sleep(stall)   # the rank really straggles
        if self._straggler is None:
            self._straggler = StragglerDetector(self.world)
        for r, t in enumerate(self._rank_step_times(per_iter + stall)):
            if self.telemetry.enabled:
                self.telemetry.gauge("rank_step_time_s", t, rank=r,
                                     epoch=epoch, step=step)
            self._straggler.observe(r, t)
        for r in self._straggler.check():
            self.log(f"elastic: rank {r} straggling "
                     f"(EWMA {self._straggler.ewma(r):.3f}s vs peers)")
            if self.telemetry.enabled:
                self.telemetry.counter("straggler_flagged", 1, rank=r,
                                       epoch=epoch, step=step)
        if self.chaos.enabled and \
                self.chaos.fire_reached("rank_death", step):
            planned = self.chaos.fired[-1][1]
            self._record_chaos("rank_death", step)
            raise RankDeathError(self.chaos.seed_of("rank_death", planned),
                                 epoch, step)

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
            loss, ok = self._fetch(out.loss), None
        else:
            loss, ok = self._fetch(torch.stack((out.loss,
                                                out.ok.to(torch.float32))))
        self._count_round_trip("step_fetch")
        return float(loss), None if ok is None else float(ok)

    # -- the host-augment pipeline -------------------------------------------

    def _rank_cols(self, epoch: int) -> Iterator[np.ndarray]:
        """This rank's example indices of each global batch of ``epoch``."""
        return _rank_batch_cols(len(self.train_split.labels),
                                self.global_batch, epoch, self.seed,
                                self.world, self.rank,
                                self.reshuffle_each_epoch)

    def _host_aug_params(self, n: int, epoch: int, it: int):
        """The reference's counter-based host augmentation stream:
        (offsets [n,2] int32 in [0,8], flips [n] uint8) of batch ``it`` of
        ``epoch``, a function of (seed, epoch, it) alone, so every host
        path (per-step f32, windowed uint8, any chunking, any thread
        timing) trains the same crops and flips."""
        rng = np.random.default_rng([self.seed, epoch, it])
        return (rng.integers(0, 9, (n, 2), dtype=np.int32),
                rng.integers(0, 2, (n,), dtype=np.uint8))

    def _host_rank_params(self, k: int, epoch: int, it: int):
        """This rank's ``k`` rows of batch ``it``'s draws.  The reference
        draws for the whole global batch (``world * k`` rows, device
        major) and mesh position ``d`` takes rows ``d*k .. (d+1)*k - 1``;
        rank ``d`` takes the same rows here."""
        offsets, flips = self._host_aug_params(k * self.world, epoch, it)
        rows = slice(self.rank * k, (self.rank + 1) * k)
        return offsets[rows], flips[rows]

    def _host_transform(self, imgs: np.ndarray, epoch: int,
                        it: int) -> np.ndarray:
        """The C++ pipeline's transform of this rank's rows, f32 out (the
        per-step format: ToTensor + Normalize's product)."""
        if self.augment:
            return native.augment(
                imgs, *self._host_rank_params(len(imgs), epoch, it))
        return native.normalize(imgs)

    def _host_transform_u8(self, imgs: np.ndarray, epoch: int,
                           it: int) -> np.ndarray:
        """The same crops and flips, uint8 out (the windowed staging
        format; normalized on the device, 4x fewer bytes to copy)."""
        if self.augment:
            return native.augment_u8(
                imgs, *self._host_rank_params(len(imgs), epoch, it))
        return imgs

    def _fill_row(self, out: np.ndarray, cols: np.ndarray, epoch: int,
                  it: int) -> None:
        """``_host_transform_u8`` of the rows ``cols`` of the split,
        gathered and augmented in one pass straight into ``out``."""
        images = self.train_split.images
        if self.augment:
            native.gather_augment_u8(
                images, cols, *self._host_rank_params(len(cols), epoch, it),
                out=out)
        else:
            native.gather(images, cols, out=out)

    def _put_host_augmented(self, imgs: np.ndarray, labs: np.ndarray,
                            epoch: int, it: int):
        """Host-transform one batch (f32) and copy it and its labels to the
        device: (x, y, ready).  On the card the copies run on the copy
        stream and ``ready`` is the event after them (``_ready`` orders the
        compute stream after it); on the CPU ``ready`` is None."""
        with self.telemetry.span("host_augment"):
            xh = self._host_transform(imgs, epoch, it)
        yh = np.asarray(labs, np.int64)
        with self.telemetry.span("prefetch_put"):
            if self._copy_stream is None:
                return torch.from_numpy(xh), torch.from_numpy(yh), None
            with torch.cuda.stream(self._copy_stream):
                x = torch.from_numpy(xh).to(self.device, non_blocking=True)
                y = torch.from_numpy(yh).to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return x, y, ready

    def _ready(self, ready: Optional[torch.cuda.Event],
               *tensors: torch.Tensor) -> None:
        """Order the compute stream after a producer's copies and hand it
        their memory (``record_stream``): the blocks, allocated on the copy
        stream, are not reused before the compute stream is done with
        them."""
        if ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for t in tensors:
            t.record_stream(stream)

    # Batches queued ahead of the consumer: one ready and one in the
    # producer's hands, as the reference script's num_workers=2 keeps.
    PREFETCH_DEPTH = 2
    # How often the consumer looks at the stall deadline while it waits.
    STALL_POLL_S = 0.2

    def _prefetch_iter(self, fill, depth: Optional[int] = None,
                       stall_timeout_s: Optional[float] = None,
                       stop: Optional[threading.Event] = None):
        """The producer thread both host paths share: runs ``fill(emit)``
        on a daemon thread (``emit(item)`` enqueues it and returns False
        once the consumer has gone away, as ``stop`` then says) and yields
        the emitted items in order.  ``depth`` bounds the queue.  Every
        exit of the producer enqueues a sentinel (an exception included,
        re-raised here), so the consumer never blocks for ever; it polls
        and drains the queue before calling a producer dead without one.
        ``stall_timeout_s`` (ft supervision) is the consumer's deadline: no
        item within it while the producer is alive raises
        ``StagingStalled``.  Closing the generator stops the producer and
        joins it (``self._producer`` is the thread)."""
        q: queue.Queue = queue.Queue(maxsize=depth or self.PREFETCH_DEPTH)
        stop = stop if stop is not None else threading.Event()

        def safe_put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            if self.device.type == "cuda":      # a new thread starts on
                torch.cuda.set_device(self.device)   # device 0
            try:
                fill(lambda item: safe_put(("item", item)))
                safe_put(("done", None))
            except BaseException as e:  # noqa: BLE001 - re-raised by the
                safe_put(("err", e))    # consumer, below

        t = threading.Thread(target=produce, daemon=True,
                             name="host-augment-prefetch")
        self._producer = t
        t.start()
        last_item_t = time.time()
        try:
            while True:
                if self.telemetry.enabled:
                    # Before the blocking get: 0 means the consumer is
                    # about to wait on the producer.
                    self.telemetry.gauge("prefetch_queue_depth", q.qsize())
                try:
                    kind, payload = q.get(timeout=self.STALL_POLL_S)
                    last_item_t = time.time()
                except queue.Empty:
                    if t.is_alive():
                        stalled = time.time() - last_item_t
                        if stall_timeout_s is not None and \
                                stalled > stall_timeout_s:
                            raise ftsup.StagingStalled(
                                f"no staged item for {stalled:.1f}s "
                                f"(deadline {stall_timeout_s}s) with the "
                                f"producer thread alive but stuck")
                        continue
                    # The producer's last put may have raced the timeout.
                    try:
                        kind, payload = q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "host-augment prefetch thread exited without "
                            "delivering a batch or a completion sentinel")
                if kind == "done":
                    break
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            t.join(timeout=10)
            if t.is_alive():
                self.log("warning: host-augment prefetch thread did not "
                         "exit within 10s")

    def _stall_timeout(self) -> Optional[float]:
        return self.ft.stall_timeout_s if self._supervise else None

    def _iter_host_batches(self, epoch: int, start_it: int = 0):
        """The per-step host path's batches, double-buffered: yields
        ``(it, x, y, ready)``, batch ``it + 1`` gathered, C++-augmented
        (f32) and copied to the device on the producer thread while step
        ``it`` runs.  ``start_it`` (a mid-epoch resume) skips earlier
        batches; the absolute ``it`` keys the stream."""
        split = self.train_split

        def fill(emit):
            for it, cols in enumerate(self._rank_cols(epoch)):
                if self.limit_train_batches is not None and \
                        it >= self.limit_train_batches:
                    break
                if it < start_it:
                    continue
                if not emit((it, *self._put_host_augmented(
                        native.gather(split.images, cols),
                        split.labels[cols], epoch, it))):
                    return

        return self._prefetch_iter(fill,
                                   stall_timeout_s=self._stall_timeout())

    def _chunk_cap(self) -> int:
        """Batches per staging chunk: WINDOW split into ``host_chunks``
        copies (ceil: a window's last chunk may be short,
        ``_chunk_plan``)."""
        return -(-WINDOW // self.host_chunks)

    def _chunk_plan(self, w: int) -> List[int]:
        """The chunk sizes the producer emits for a ``w``-batch window."""
        cap = self._chunk_cap()
        sizes = [cap] * (w // cap)
        if w % cap:
            sizes.append(w % cap)
        return sizes

    def _chunk_arena(self, cap: int) -> native.StagingArena:
        """The staging arena and its device chunks (``ChunkSlots``), made
        at first use and again when the chunk shape changes (a test that
        changes WINDOW).  Slots: the queue holds up to two windows' worth
        of chunks while one more fills, +2 so the producer stalls only on a
        full pipe."""
        arena = self._staging_arena
        if arena is not None and arena.chunk_batches == cap:
            return arena
        nslots = 2 * len(self._chunk_plan(WINDOW)) + 2
        self._staging_arena = native.StagingArena(
            nslots, cap, self.per_rank_batch,
            pin=self.device.type == "cuda")
        self._chunk_slots = ChunkSlots(nslots, cap, self.per_rank_batch,
                                       self.device)
        return self._staging_arena

    def _release_chunks(self) -> None:
        if self._chunk_slots is not None:
            self._chunk_slots.release_all()

    # The log lines below are the reference's, word for word ("device_put"
    # is its name for a chunk's copy to the device).

    def _on_put_timeout(self, elapsed_s: float) -> None:
        """Watchdog callback: a chunk put overran its deadline — detection
        only (the put may still complete)."""
        if self.telemetry.enabled:
            self.telemetry.counter("staging_put_timeout")
        self.log(f"ft: chunk device_put exceeded its "
                 f"{self.ft.put_timeout_s}s watchdog deadline "
                 f"({elapsed_s:.1f}s elapsed)")

    def _on_put_retry(self, attempt: int, exc: BaseException) -> None:
        if self.telemetry.enabled:
            self.telemetry.counter("staging_put_retry")
        self.log(f"ft: chunk device_put attempt {attempt + 1} failed "
                 f"({exc!r}); retrying with backoff")

    def _copy_chunk(self, slot: int, k: int) -> Optional[torch.cuda.Event]:
        """Copy the first ``k`` rows of arena slot ``slot`` and its labels
        into the slot's device chunk; on the card asynchronously on the
        copy stream, after the last assembly that read the chunk, and the
        event after the copies (the arena's fence and the consumer's
        wait); on the CPU synchronously, None."""
        arena, slots = self._staging_arena, self._chunk_slots
        pairs = ((slots.images[slot][:k], arena.tensor(slot)[:k]),
                 (slots.labels[slot][:k], slots.host_labels[slot][:k]))
        if self._copy_stream is None:
            for dst, src in pairs:
                dst.copy_(src)
            return None
        with torch.cuda.stream(self._copy_stream):
            after = slots.after(slot)
            if after is not None:
                self._copy_stream.wait_event(after)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self._copy_stream)
        return ready

    def _supervised_put(self, put: Callable, lo: int, hi: int):
        """``put()``, a chunk's copy to the device, under ft supervision:
        chaos injection (``put_fail`` raises once, ``put_delay`` sleeps
        past the watchdog once — both keyed to the chunk's absolute batch
        range [lo, hi)), a detection-only watchdog on the put, and bounded
        retry with exponential backoff.  Without an FTConfig, ``put()``."""
        if not self._supervise:
            return put()

        def attempt():
            if self.chaos.enabled and \
                    self.chaos.fire_range("put_fail", lo, hi):
                self._record_chaos("put_fail", lo)
                raise ChaosError(
                    f"injected transient chunk device_put failure "
                    f"(batches [{lo}, {hi}))")
            delay = self.chaos.enabled and \
                self.chaos.fire_range("put_delay", lo, hi)
            with ftsup.Watchdog(self.ft.put_timeout_s,
                                on_timeout=self._on_put_timeout):
                if delay:
                    self._record_chaos("put_delay", lo)
                    time.sleep(2.0 * self.ft.put_timeout_s)
                return put()

        return ftsup.call_with_retry(
            attempt, attempts=self.ft.put_retries,
            backoff_base_s=self.ft.backoff_base_s,
            on_retry=self._on_put_retry)

    def _per_rank_batch_counts(self) -> Tuple[int, int]:
        """(full batches, rows of the ragged batch) of this rank's epoch,
        from the sampler's wrap-padding to a multiple of the world."""
        per_rank = -(-len(self.train_split.labels) // self.world)
        return divmod(per_rank, self.per_rank_batch)

    def _host_full_batches(self) -> int:
        """Full batches the host path trains this epoch, within the
        limit: the last window closes at it."""
        nfull, _ = self._per_rank_batch_counts()
        if self.limit_train_batches is not None:
            nfull = min(nfull, self.limit_train_batches)
        return nfull

    def _iter_host_window_chunks(self, epoch: int, start_it: int = 0):
        """The chunked windowed host pipeline.  A producer thread fills
        arena rows with the fused C++ gather + crop/flip
        (``native.gather_augment_u8``: one host copy from the resident
        dataset) and copies each chunk of ``_chunk_cap()`` batches to its
        device chunk, so that the next window's copies overlap this
        window's replays; the consumer assembles a window's chunks into
        the window buffer (``_assemble``).  uint8 all the way: the
        normalize runs on the device.

        Yields ``("chunk", Chunk)`` — ``last`` marks a window boundary —
        and ``("tail", (it, x, y, ready))`` for the ragged final batch
        (f32, the per-step format).  Each batch is augmented at its
        absolute index, so the stream is the per-step path's whatever
        ``host_chunks`` or the thread timing; ``start_it`` (a resume, a
        producer restart) skips earlier batches, and windows close on the
        absolute grid.  Under an FTConfig the puts are supervised
        (``_supervised_put``), the arena's fence wait has a watchdog, and
        ``verify_chunks`` checksums every row at fill time and re-stages
        any row whose bytes changed by flush time (what the
        ``corrupt_slot`` site injects) at the same absolute index, so the
        repaired stream is bitwise the same."""
        cap = self._chunk_cap()
        arena = self._chunk_arena(cap)
        slots = self._chunk_slots
        nlim = self._host_full_batches()
        fence_timeout = self.ft.put_timeout_s if self._supervise else None
        stop = threading.Event()
        split = self.train_split

        times = self.last_producer_times
        clock = time.perf_counter

        def fill(emit):
            chunk_x = None       # the arena rows of the chunk being filled
            slot = -1
            chunk_meta: list = []   # (absolute it, cols) per filled row
            chunk_sums: list = []   # fill-time crc32 per row

            def on_fence_timeout(elapsed_s):
                if self.telemetry.enabled:
                    self.telemetry.counter("staging_fence_timeout")
                self.log(f"ft: arena slot fence exceeded its "
                         f"{fence_timeout}s watchdog deadline")

            def inject_and_verify(k: int, lo: int) -> None:
                """Chaos byte corruption, then the checksum check and
                repair, between fill and put — where a buffer-reuse bug
                would strike."""
                if self.chaos.enabled:
                    for s in self.chaos.steps("corrupt_slot"):
                        if lo <= s < lo + k and \
                                self.chaos.fire("corrupt_slot", s):
                            self._record_chaos("corrupt_slot", s)
                            rng = self.chaos.rng("corrupt_slot", s)
                            flat = chunk_x[s - lo].reshape(-1)
                            pos = rng.integers(0, flat.size, size=8)
                            flat[pos] ^= np.uint8(rng.integers(1, 256))
                if not self._verify_chunks:
                    return
                for j in ftsup.verify_checksums(chunk_x[:k], chunk_sums):
                    it_j, cols_j = chunk_meta[j]
                    if self.telemetry.enabled:
                        self.telemetry.counter("staging_corruption_repaired")
                    self.log(f"ft: staged batch {it_j} failed its checksum; "
                             f"re-staging from the resident dataset")
                    self._fill_row(chunk_x[j], cols_j, epoch, it_j)
                    if ftsup.verify_checksums([chunk_x[j]],
                                              [chunk_sums[j]]):
                        raise ftsup.StagingStalled(
                            f"staged batch {it_j} fails its checksum even "
                            f"after re-staging — arena memory is unsafe")

            def flush(last: bool) -> bool:
                nonlocal chunk_x, slot
                k = len(chunk_meta)
                if k == 0:
                    return True
                lo = chunk_meta[0][0]
                t0 = clock()
                inject_and_verify(k, lo)
                t1 = clock()
                with self.telemetry.span("chunk_put", batches=k, last=last):
                    ready = self._supervised_put(
                        lambda: self._copy_chunk(slot, k), lo, lo + k)
                arena.retire(slot, ready)
                item = Chunk(k, lo, last, slot, ready)
                chunk_x, slot = None, -1
                chunk_meta.clear()
                chunk_sums.clear()
                t2 = clock()
                sent = emit(("chunk", item))
                times["verify"] += t1 - t0
                times["put"] += t2 - t1
                times["emit"] += clock() - t2
                return sent

            for it, cols in enumerate(self._rank_cols(epoch)):
                if self.limit_train_batches is not None and \
                        it >= self.limit_train_batches:
                    break
                if it < start_it:
                    continue
                if self.chaos.enabled and \
                        self.chaos.fire("producer_crash", it):
                    self._record_chaos("producer_crash", it)
                    raise ChaosError(
                        f"injected staging producer crash at batch {it}")
                if len(cols) < self.per_rank_batch:   # the ragged tail
                    if flush(last=True):
                        emit(("tail", (it, *self._put_host_augmented(
                            native.gather(split.images, cols),
                            split.labels[cols], epoch, it))))
                    return
                if chunk_x is None:
                    t0 = clock()
                    slot, chunk_x = arena.acquire(
                        fence_timeout_s=fence_timeout,
                        on_timeout=on_fence_timeout)
                    t1 = clock()
                    if not slots.claim(slot, stop):
                        return
                    times["fence"] += t1 - t0
                    times["claim"] += clock() - t1
                t0 = clock()
                row = len(chunk_meta)
                with self.telemetry.span("host_augment"):
                    self._fill_row(chunk_x[row], cols, epoch, it)
                slots.host_labels[slot].numpy()[row] = split.labels[cols]
                chunk_meta.append((it, cols))
                t1 = clock()
                if self._verify_chunks:
                    chunk_sums.append(ftsup.batch_checksums(
                        [chunk_x[row]])[0])
                times["fill"] += t1 - t0
                times["verify"] += clock() - t1
                boundary = (it + 1) % WINDOW == 0 or (it + 1) == nlim
                if (row + 1 == cap or boundary) and \
                        not flush(last=boundary):
                    return

        return self._prefetch_iter(
            fill, depth=2 * len(self._chunk_plan(WINDOW)),
            stall_timeout_s=self._stall_timeout(), stop=stop)

    def _iter_host_window_chunks_sync(self, epoch: int, start_it: int = 0):
        """The degraded staging mode: ``_iter_host_window_chunks``' items,
        made on the consumer's thread, one batch a chunk, from a private
        host buffer that ``_assemble`` copies straight into the window
        buffer (no thread, no arena).  What a staging failure degrades to
        once its restart budget is spent: the overlap is lost, the stream
        is the same bits (absolute keys; a window does not depend on how
        it was chunked)."""
        nlim = self._host_full_batches()
        split = self.train_split
        for it, cols in enumerate(self._rank_cols(epoch)):
            if self.limit_train_batches is not None and \
                    it >= self.limit_train_batches:
                break
            if it < start_it:
                continue
            if len(cols) < self.per_rank_batch:   # the ragged tail
                yield ("tail", (it, *self._put_host_augmented(
                    native.gather(split.images, cols), split.labels[cols],
                    epoch, it)))
                return
            x = np.empty((1, self.per_rank_batch, 32, 32, 3), np.uint8)
            with self.telemetry.span("host_augment"):
                self._fill_row(x[0], cols, epoch, it)
            last = (it + 1) % WINDOW == 0 or (it + 1) == nlim
            yield ("chunk", Chunk(1, it, last, None, None, (
                x, np.asarray(split.labels[cols], np.int64)[None])))

    def _assemble(self, chunks: List[Chunk], start: int) -> int:
        """Copy a window's chunks, in order, into the window buffer's rows
        ``0 .. w-1`` (on the card after each chunk's copy event, device to
        device), then give their slots back with the event after the
        copies; w.  The chunks must be the batches ``start ..``."""
        window = self.train_window()
        slots = self._chunk_slots
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        row = 0
        for c in chunks:
            if c.lo != start + row:
                raise RuntimeError(f"a chunk of batches from {c.lo} arrived "
                                   f"where the window expects batch "
                                   f"{start + row}")
            dst = (window.images[row:row + c.k], window.labels[row:row + c.k])
            if c.slot is None:
                # The degraded mode's chunk: this copy is its put.
                with self.telemetry.span("chunk_put", batches=c.k,
                                         degraded=True):
                    for d, a in zip(dst, c.host):
                        d.copy_(torch.from_numpy(a))
            else:
                if c.ready is not None:
                    stream.wait_event(c.ready)
                for d, s_ in zip(dst, (slots.images[c.slot][:c.k],
                                       slots.labels[c.slot][:c.k])):
                    d.copy_(s_)
            row += c.k
        after = None
        if stream is not None:
            after = torch.cuda.Event()
            after.record(stream)
        for c in chunks:
            if c.slot is not None:
                slots.release(c.slot, after)
        return row

    def _train_model_host_windowed(self, epoch: int,
                                   start_step: int = 0) -> WindowedTimers:
        """A windowed host-augment epoch: the window's replays over the
        chunk-staged C++-augmented buffer (``_iter_host_window_chunks``),
        with the reference's print and timing schedule; the ragged tail
        through the per-step f32 step.

        Under an FTConfig this is the supervised path: a staging failure
        (the producer died, by chaos or for real; the consumer's stall
        deadline passed) drops the window being assembled and restarts the
        producer from the last TRAINED batch — once — then degrades to the
        synchronous mode (``_iter_host_window_chunks_sync``).  Both keep
        the training stream bitwise: batches are keyed by absolute index,
        and ``trained`` advances a whole window at a time."""
        timers = WindowedTimers(self.log, telemetry=self.telemetry,
                                epoch=epoch)
        # The arena, the device chunks and the window buffer exist before
        # the producer starts and before the window's capture.
        window = self.train_window()
        self._chunk_arena(self._chunk_cap())
        self.last_chunk_waits = []
        self.last_producer_times = Counter()
        trained = start_step
        restarts_left = self.ft.producer_restarts if self._supervise else 0
        self._check_preempt(epoch, trained)

        def make_iter(start):
            if self.staging_degraded:
                return self._iter_host_window_chunks_sync(epoch, start)
            return self._iter_host_window_chunks(epoch, start)

        chunk_iter = make_iter(trained)
        pending: List[Chunk] = []
        waited = 0.0
        try:
            while True:
                t_wait = time.time()
                try:
                    # chunk_wait: how long the consumer waits on the
                    # producer, ~0 but for the first window when the
                    # staging overlaps.
                    with self.telemetry.span("chunk_wait"):
                        item = next(chunk_iter, None)
                except Exception as e:
                    if not self._supervise:
                        raise
                    self.producer_failures += 1
                    if self.telemetry.enabled:
                        self.telemetry.counter("producer_failure",
                                               error=type(e).__name__)
                    chunk_iter.close()
                    self._release_chunks()
                    pending = []
                    if restarts_left > 0:
                        restarts_left -= 1
                        if self.telemetry.enabled:
                            self.telemetry.counter("producer_restart")
                        self.log(f"ft: staging failed at step {trained} "
                                 f"({type(e).__name__}: {e}); restarting "
                                 f"the producer from step {trained}")
                    else:
                        self.staging_degraded = True
                        if self.telemetry.enabled:
                            self.telemetry.counter("staging_degraded")
                        self.log(f"ft: staging failed again at step "
                                 f"{trained} ({type(e).__name__}: {e}); "
                                 f"restart budget exhausted — degrading to "
                                 f"synchronous per-batch staging (stream "
                                 f"unchanged, overlap lost)")
                    chunk_iter = make_iter(trained)
                    continue
                waited += time.time() - t_wait
                if item is None:
                    break
                kind, payload = item
                if kind == "tail":
                    it, x, y, ready = payload
                    self._ready(ready, x, y)
                    if self._nf_chaos_steps and \
                            self.chaos.fire("nonfinite_grad", it):
                        self._record_chaos("nonfinite_grad", it)
                    t0 = time.time()
                    loss, ok = self._step_fetch(x, y, epoch, it)
                    timers.record(loss, time.time() - t0, steady=False)
                    if self.telemetry.enabled:
                        self._emit_collective_telemetry()
                    trained = it + 1
                    if ok is not None:
                        self._handle_nonfinite([ok], epoch)
                    self._check_preempt(epoch, trained)
                    continue
                pending.append(payload)
                if self.telemetry.enabled:
                    self.telemetry.gauge("window_chunks_pending",
                                         len(pending))
                if not payload.last:
                    continue
                w = self._assemble(pending, trained)
                pending = []
                self.last_chunk_waits.append(waited)
                waited = 0.0
                self._prepare_window(window)
                t0 = time.time()
                fetched = self._fetch(window(epoch, trained, w))
                per_iter = (time.time() - t0) / w
                self._count_round_trip(self._window_site(), epoch=epoch)
                cols = window.columns(fetched, trained, w)
                self._record_window(timers, cols, per_iter)
                if self._nf_chaos_steps and self.chaos.fire_range(
                        "nonfinite_grad", trained, trained + w):
                    self._record_chaos("nonfinite_grad", next(
                        s for s in self._nf_chaos_steps
                        if trained <= s < trained + w))
                trained += w
                if cols.ok is not None:
                    self._handle_nonfinite(cols.ok, epoch)
                self._rank_boundary(epoch, trained, per_iter)
                emit_memory_gauges(self.telemetry, self.device, epoch=epoch,
                                   step=trained)
                self._check_preempt(epoch, trained)
        finally:
            chunk_iter.close()
            self._release_chunks()
        self.last_epoch_timers = timers
        return timers

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
        trains the same windows as an uninterrupted one.  With
        ``host_augment`` the windows train from the host pipeline's staged
        chunks (``_train_model_host_windowed``)."""
        self._epoch_nf = [0, 0]
        if self.profile_phases:
            timers = self._train_model_per_step(epoch, start_step)
        elif self.host_augment:
            timers = self._train_model_host_windowed(epoch, start_step)
        else:
            timers = self._train_model_windowed(epoch, start_step)
        if any(self._epoch_nf):
            self.log(f"Non-finite guard (epoch {epoch}): "
                     f"{self._epoch_nf[0]} update(s) skipped, "
                     f"{self._epoch_nf[1]} rollback(s)")
        return timers

    def _window_site(self) -> str:
        """The round-trip site of a window's fetch, as the reference names
        it: the ring's drain, or the window's losses without the ring."""
        return "window_drain" if self.metrics_ring else "window_fetch"

    def _train_model_windowed(self, epoch: int,
                              start_step: int) -> WindowedTimers:
        timers = WindowedTimers(self.log, telemetry=self.telemetry,
                                epoch=epoch)
        staged = self._stage_train_epoch(epoch)
        window = self.train_window()
        nbatches = staged.images.shape[0]
        start = start_step
        self._check_preempt(epoch, start)
        while start < nbatches:
            w = min(WINDOW - start % WINDOW, nbatches - start)
            self._prepare_window(window)
            t0 = time.time()
            # Tagged with the strategy, so that the timeline attributes a
            # window's wall time to its tier.
            with self.telemetry.span("train_window",
                                     strategy=self.strategy_name,
                                     start=start, batches=w):
                fetched = self._fetch(window(epoch, start, w))
            per_iter = (time.time() - t0) / w
            self._count_round_trip(self._window_site(), epoch=epoch)
            cols = window.columns(fetched, start, w)
            self._record_window(timers, cols, per_iter)
            if self._nf_chaos_steps and \
                    self.chaos.fire_range("nonfinite_grad", start, start + w):
                self._record_chaos("nonfinite_grad", next(
                    s for s in self._nf_chaos_steps if start <= s < start + w))
            start += w
            if cols.ok is not None:
                self._handle_nonfinite(cols.ok, epoch)
            self._rank_boundary(epoch, start, per_iter)
            emit_memory_gauges(self.telemetry, self.device, epoch=epoch,
                               step=start)
            self._check_preempt(epoch, start)
        if staged.tail is not None and start_step <= nbatches:
            t0 = time.time()
            if self._nf_chaos_steps and \
                    self.chaos.fire("nonfinite_grad", nbatches):
                self._record_chaos("nonfinite_grad", nbatches)
            loss, ok = self._step_fetch(*staged.tail, epoch, nbatches)
            timers.record(loss, time.time() - t0, steady=False)
            if self.telemetry.enabled:
                self._emit_collective_telemetry()
            if ok is not None:
                self._handle_nonfinite([ok], epoch)
        self.last_epoch_timers = timers
        return timers

    def _device_batches(self, epoch: int, start_step: int = 0):
        """The per-step path's batches without ``host_augment``: ``(it, x,
        y, None)``, this rank's uint8 rows copied to the device."""
        for it, (imgs, labs) in enumerate(_train_batches(
                self.train_split, self.global_batch, epoch, self.seed,
                self.world, self.rank, self.reshuffle_each_epoch)):
            if self.limit_train_batches is not None and \
                    it >= self.limit_train_batches:
                break
            if it < start_step:
                continue
            yield (it, *self._to_device(imgs, labs), None)

    def _train_model_per_step(self, epoch: int,
                              start_step: int = 0) -> WindowedTimers:
        """One eager step per batch, its loss fetched after it, and the
        forward-only program timed (and fetched) before it.  With
        ``host_augment`` the batches are the host pipeline's f32 ones,
        prepared on the producer thread while the step before runs
        (``_iter_host_batches``)."""
        timers = WindowedTimers(self.log, telemetry=self.telemetry,
                                epoch=epoch)
        self._check_preempt(epoch, start_step)
        batches = self._iter_host_batches(epoch, start_step) \
            if self.host_augment else self._device_batches(epoch, start_step)
        with contextlib.closing(batches):
            for it, x, y, ready in batches:
                self._ready(ready, x, y)
                t0 = time.time()
                self._fetch(self.forward_step(x, y))
                fwd_time = time.time() - t0
                self._count_round_trip("forward_fetch")
                if self._nf_chaos_steps and \
                        self.chaos.fire("nonfinite_grad", it):
                    self._record_chaos("nonfinite_grad", it)
                t0 = time.time()
                loss, ok = self._step_fetch(x, y, epoch, it)
                timers.record(loss, time.time() - t0, fwd_time,
                              steady=x.shape[0] == self.per_rank_batch)
                if self.telemetry.enabled:
                    self._emit_collective_telemetry()
                if ok is not None:
                    self._handle_nonfinite([ok], epoch)
                self._check_preempt(epoch, it + 1)
        self.last_epoch_timers = timers
        return timers

    def test_model(self) -> Tuple[float, int, float]:
        """Evaluate and print the script's line: average CE per example,
        correct/total, percent."""
        with self.telemetry.span("eval"):
            loss_sum, correct = self.evaluate(*self._stage_eval())
            # One fetch; the f32 sum and a count below 2**53 are exact in
            # f64.
            loss_sum, correct = self._fetch(
                torch.stack([loss_sum.double(), correct.double()]))
            self._count_round_trip("eval")
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
            "reshuffle_each_epoch": self.reshuffle_each_epoch,
            "lr": self.sgd_cfg.lr, "momentum": self.sgd_cfg.momentum,
            "weight_decay": self.sgd_cfg.weight_decay,
            "limit_train_batches": self.limit_train_batches,
            "real_data": self.real_data,
            "state_digest": state_digest(
                steplib.named_state_tensors(self.state))}

    def _epoch_meta(self, epoch: int) -> dict:
        """The topology and data-order sidecar of every save: enough for
        ``elastic.protocol.plan_resume`` to map its progress onto another
        world, and the per-rank data-order keys a resume checks."""
        meta = {
            "world": self.world, "global_batch": self.global_batch,
            "seed": self.seed,
            "reshuffle_each_epoch": self.reshuffle_each_epoch,
            "rank_keys": list(sharding.rank_data_keys(
                len(self.train_split.labels), self.world, seed=self.seed,
                epoch=epoch,
                reshuffle_each_epoch=self.reshuffle_each_epoch))}
        if self.elastic is not None:
            meta["protocol"] = self.elastic.protocol
            if self._strong:
                meta["microshards"] = self.elastic.microshards
        return meta

    def _data_order_meta(self, epoch: int, step: int) -> dict:
        """The mid-epoch sidecar's ``data_order``."""
        return {"seed": self.seed, "epoch": epoch, "step": step,
                "reshuffle_each_epoch": self.reshuffle_each_epoch,
                **self._epoch_meta(epoch)}

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
        carries.  A comm state stacked over another world (an elastic
        resume) is resharded onto this one first
        (``strategies.reshard_comm``: residuals keep their sum, Q factors
        their mean).  Raises, before writing anything, if it does not fit
        them name for name, shape for shape and dtype for dtype."""
        live = steplib.named_state_tensors(self.state)
        if set(tensors) != set(live):
            raise ValueError(
                f"the checkpoint's tensors do not fit this Trainer's: "
                f"missing {sorted(set(live) - set(tensors))}, unexpected "
                f"{sorted(set(tensors) - set(live))}")
        comm = {k: v for k, v in tensors.items() if k.startswith("comm/")}
        worlds = {v.shape[0] if v.dim() else None for v in comm.values()}
        if len(worlds) > 1 or None in worlds:
            raise ValueError(f"the comm state is not stacked over one "
                             f"world: {sorted(map(str, worlds))}")
        if worlds and worlds != {self.world}:
            tensors = {**tensors, **self._reshard(comm)}
        src = {}
        for k, t in live.items():
            v = tensors[k]
            if k.startswith("comm/"):
                v = v[self.rank]
            if v.shape != t.shape or v.dtype != t.dtype:
                raise ValueError(f"{k}: the checkpoint holds {v.dtype}"
                                 f"{list(v.shape)}, the Trainer "
                                 f"{t.dtype}{list(t.shape)}")
            src[k] = v
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(src[k])

    def _reshard(self, comm: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """``checkpoint_tensors``' comm entries, stacked over another
        world, resharded onto this one."""
        groups = {"residual": {}, "q": {}}
        for k, v in comm.items():
            _, kind, name = k.split("/", 2)
            groups[kind][name] = v
        if not groups["q"]:
            del groups["q"]
        out = strategies.reshard_comm(groups, self.world)
        return {f"comm/{kind}/{name}": v
                for kind, named in out.items() for name, v in named.items()}

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

    def _plan_elastic_resume(self, meta: Optional[dict],
                             start_step: int) -> int:
        """Map a mid-epoch checkpoint's progress onto THIS world:
        unchanged under strong scaling (batch b is the same canonical
        positions at every world), re-derived from example progress under
        weak."""
        flat = flat_meta(meta)
        if not flat:
            return start_step
        plan = plan_resume(
            flat, self.world, protocol=self.elastic.protocol,
            microshards=self.elastic.microshards if self._strong else None,
            default_global_batch=self.global_batch)
        self.resume_plan = plan
        if plan.old_world != plan.new_world:
            self.log(
                f"elastic: resuming world {plan.old_world} -> "
                f"{plan.new_world} ({plan.protocol}); start step "
                f"{start_step} -> {plan.start_step}"
                + (f", {plan.examples_replayed} example(s) replayed"
                   if plan.examples_replayed else ""))
        return plan.start_step

    def _resume(self, mngr: CheckpointManager) -> Tuple[int, int]:
        """Restore the newest save, if any: (start epoch, start step).  A
        mid-epoch save outranks the epoch series only when it is AHEAD of
        it (a crash between an epoch save and its clear leaves a stale
        one behind).  Under ``elastic`` the save may be of another world:
        its step is re-planned and its comm state resharded."""
        n = len(self.train_split.labels)
        mid, le = mngr.latest_mid_epoch(), mngr.latest_epoch()
        if mid is not None and (le is None or mid[0] > le):
            tensors, epoch, step = mngr.restore_mid_epoch()
            validate_rank_keys(mngr.mid_epoch_meta(), n)
            self.load_checkpoint(tensors)
            if self.elastic is not None:
                step = self._plan_elastic_resume(mngr.mid_epoch_meta(), step)
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

    def run(self, epochs: int = 1, checkpoint_dir: Optional[str] = None,
            profile_dir: Optional[str] = None,
            publish_dir: Optional[str] = None,
            publish_every: int = 1) -> None:
        """Epochs of train + eval with the epoch timing line.

        With ``profile_dir``: the first epoch this run trains, under
        ``torch.profiler``, into a Chrome trace JSON there (rank 0;
        ``profile_trace`` is its path).

        With ``checkpoint_dir``: resume from its newest save (the config
        guard refuses another run's directory), and save after every
        epoch's eval.  While it runs (with a checkpoint dir or an ``ft``
        config), SIGTERM/SIGINT request a stop at the next window
        boundary: an emergency mid-epoch save (with a checkpoint dir), and
        a return with ``self.preempted`` set; a later ``run`` on the same
        directory resumes from that step, bitwise.  A SIGTERM to one rank
        alone leaves its peers waiting at their next collective: a
        scheduler signals every rank of a job.

        With ``publish_dir``: the serving half of the state (parameters +
        BatchNorm statistics) is published as a versioned, crc-checksummed
        CCWB1 bundle every ``publish_every`` completed epochs, after the
        eval and the save, by rank 0 alone (``publish/``): a serving
        process watching the directory (``--serve-publish-dir``) installs
        each version between dispatches.  The publish chaos sites are
        refused without it."""
        publisher = None
        if publish_dir is None:
            check_sites(self.chaos, self.host_augment,
                        self.elastic is not None)
        else:
            if publish_every < 1:
                raise ValueError(f"publish_every must be >= 1, "
                                 f"got {publish_every}")
            if self.rank == 0:
                publisher = WeightPublisher(
                    publish_dir,
                    fingerprint=publish_fingerprint(
                        self.checkpoint_config()),
                    telemetry=self.telemetry, chaos=self.chaos)
        start_epoch, start_step = 0, 0
        mngr = None
        if checkpoint_dir is not None:
            mngr = CheckpointManager(checkpoint_dir,
                                     config=self.checkpoint_config(),
                                     elastic=self.elastic is not None)
            start_epoch, start_step = self._resume(mngr)
        if self._nf_policy == "restore":
            self._snapshot_rollback()
        try:
            if mngr is not None or self.ft is not None:
                self._preempt_guard = PreemptionGuard(log=self.log).install()
            if start_epoch >= epochs:
                self.log(f"All {epochs} epoch(s) already checkpointed; "
                         f"nothing to run"
                         + (" (profile_dir ignored)" if profile_dir else ""))
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                try:
                    if profile_dir is not None and epoch == start_epoch:
                        with self._profiled(profile_dir, epoch):
                            self.train_model(epoch, start_step=start_step)
                    else:
                        self.train_model(epoch, start_step=start_step)
                except PreemptedError as e:
                    self.preempted = True
                    if self.telemetry.enabled:
                        self.telemetry.counter("preemptions", epoch=e.epoch,
                                               step=e.step)
                    if mngr is not None:
                        with self.telemetry.span("checkpoint_save_mid_epoch",
                                                 epoch=e.epoch, step=e.step):
                            self._save(mngr, e.epoch, e.step)
                        self.log(f"Preempted at epoch {e.epoch} step "
                                 f"{e.step}; emergency checkpoint saved")
                    else:
                        self.log(f"Preempted at epoch {e.epoch} step "
                                 f"{e.step}; no checkpoint dir — progress "
                                 f"since the last save is lost")
                    return
                except RankDeathError as e:
                    if self.telemetry.enabled:
                        self.telemetry.counter("rank_deaths", rank=e.rank,
                                               epoch=e.epoch, step=e.step)
                    if mngr is not None:
                        with self.telemetry.span("checkpoint_save_mid_epoch",
                                                 epoch=e.epoch, step=e.step):
                            self._save(mngr, e.epoch, e.step)
                        self.log(f"Rank {e.rank} died at epoch {e.epoch} "
                                 f"step {e.step}; emergency checkpoint "
                                 f"saved")
                    else:
                        self.log(f"Rank {e.rank} died at epoch {e.epoch} "
                                 f"step {e.step}; no checkpoint dir — "
                                 f"progress since the last save is lost")
                    self.rank_death = (e.rank, e.epoch, e.step)
                    return
                start_step = 0
                self.log(f"Training time after {epoch + 1} epoch is "
                         f"{time.time() - t0}")
                if self.telemetry.enabled:
                    self.telemetry.gauge("epoch_time_s", time.time() - t0,
                                         epoch=epoch)
                    self._emit_device_gauges(epoch)
                    emit_memory_gauges(self.telemetry, self.device,
                                       epoch=epoch)
                self.test_model()
                if mngr is not None:
                    with self.telemetry.span("checkpoint_save", epoch=epoch):
                        self._save(mngr, epoch)
                    if self._nf_policy == "restore":
                        self._snapshot_rollback()
                if publisher is not None \
                        and (epoch + 1) % publish_every == 0:
                    with self.telemetry.span("publish", epoch=epoch):
                        rec = publisher.publish(self.state)
                    self.log(f"Published weights v{rec['version']} "
                             f"({rec['bytes']} B, {rec['leaves']} leaves) "
                             f"to {publish_dir}")
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

    def _make_window_body(self, net, strat, group, shared=None,
                          **step_kw):
        """The body the train windows replay, chosen here for the windows
        (``__init__``) and for the cost model (``step_cost``) alike: under
        strong scaling the microshard step (the strategy still names the
        eval and the comm state it carries); with ``host_augment`` a body
        over the host pipeline's uint8 batches; else ``shared``, the
        per-step path's body that the windows share, or a body made as
        that one is."""
        if self._strong:
            return MicroshardStep(
                net, self.sgd_cfg, microshards=self.elastic.microshards,
                world=self.world, rank=self.rank, group=group,
                augment=self.augment, seed=self.seed,
                compute_dtype=self.compute_dtype)
        if shared is not None and not self.host_augment:
            return shared
        return steplib.make_step_body(
            net, strat, self.sgd_cfg,
            augment="host_u8" if self.host_augment else self.augment,
            group=group, seed=self.seed, compute_dtype=self.compute_dtype,
            nonfinite_guard=self._guard_on, **step_kw)

    def step_cost(self):
        """The cost model's ``CostReport`` (``analysis/costmodel.py``) of
        one train step of this rank at the per-rank batch, as the windowed
        path runs it: the input transform (the counter-keyed augment, or
        the host path's normalize), forward, backward, the strategy's sync
        and the rank mean, the guard and the SGD update, under this
        Trainer's model, precision, tier and world.  Counted on a meta twin
        of the model (the same zoo model and seed, nothing computed), with
        a ``CountingGroup`` in place of the process group."""
        from ..analysis import costmodel
        net = costmodel.meta_model(self.model_name, self.seed)
        strat = get_strategy(self.strategy_name, **(
            {} if self.compress_rank is None
            else {"compress_rank": self.compress_rank}))
        group = None if strat is strategies.local \
            else costmodel.CountingGroup(self.world, self.rank)
        state = steplib.init_train_state(net, strat)
        body = self._make_window_body(net, strat, group)
        b = self.per_rank_batch
        zero = torch.zeros((), dtype=torch.int64, device="meta")
        images = torch.empty((b, 32, 32, 3), dtype=torch.uint8,
                             device="meta")
        labels = torch.empty((b,), dtype=torch.int64, device="meta")
        return costmodel.count(
            body, state, images, labels, zero, zero,
            name=f"{self.model_name}/{self.strategy_name}/train_step",
            group=group)

    def step_flops_per_image(self, log: Optional[Callable[[str], None]] = None
                             ) -> Optional[float]:
        """FLOPs per trained image of one whole train step (``step_cost``)
        over the per-rank batch: a report counts one rank's step, which
        trains ``global_batch // world`` images.  None, with the reason
        logged (``log`` overrides the trainer's logger), when an operator
        of the step cannot be counted on meta tensors."""
        log = log or self.log
        try:
            report = self.step_cost()
        except NotImplementedError as e:
            log(f"MFU accounting unavailable: the cost model could not "
                f"count the train step on meta tensors: {e}")
            return None
        return report.flops / self.per_rank_batch

    def steady_state_throughput(self, max_iters: int = 3 * WINDOW,
                                window_iters=None) -> Tuple[float, float]:
        """(images/s, images/s per GPU) of the windowed path in steady
        state, as the reference package measures it: a first window
        (capture and warm-up) excluded, then ``max(2, ceil(max_iters /
        w))`` windows back to back, each on a fresh augmentation key, with
        one fetch after the last.  ``window_iters``: steps per window,
        ``"epoch"`` for the whole staged epoch, None for
        ``min(epoch, max(max_iters, 20))``.  It trains: the state moves.
        The device-augment path only, as the reference's."""
        if self.host_augment:
            raise ValueError(
                "steady_state_throughput measures the windowed path "
                "(device-side transform); it does not support "
                "host_augment=True — construct a separate Trainer for "
                "throughput measurement")
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
        really train; the state is restored bit for bit afterwards.  The
        device-augment path only, as the reference's."""
        if self.host_augment:
            raise ValueError(
                "measure_phase_split times the windowed path (device-side "
                "transform); it does not support host_augment=True — "
                "construct a separate Trainer for the phase split")
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
