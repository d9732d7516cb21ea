"""Train, forward and eval programs: prepare -> forward in train mode ->
mean CE -> backward -> gradient sync -> SGD, then the BN running statistics
and the loss meaned over the ranks; and their windows.

The reference package compiles the step as one jitted ``shard_map``
program (``train/step.py::make_train_step``) and a window of steps as a
``lax.scan`` over the staged epoch (``make_train_window``).  Here the step
runs eagerly on each rank's own rows of the batch, the strategy's
collectives go over the process group (``parallel/``), and the
pool-preceded BN blocks' backward launches the fused CUDA kernels.

A window (``TrainWindow``, ``FwdWindow``) reads its batches from the
staged epoch (or, on the host-augment path, from one window's buffer that
the host refills) at a DEVICE index and writes its results to persistent
device tensors, so that one step is a function of fixed addresses only: on
the card it is captured once into a CUDA graph and each step of a window
is a replay of it (``GraphStep``); on the CPU the same body runs eagerly
(gloo collectives cannot be captured).  Everything the step carries across
steps is updated in place: the parameters and momentum (``ops/sgd.py``), the BN
running statistics (``copy_`` in the modules), a compressed strategy's
residuals and Q factors (``copy_comm``).  So a restore (a checkpoint, a
mid-epoch resume, a rollback) ``copy_``s into those same tensors.

The non-finite guard (``nonfinite_guard``, ``ft/guard.py``) is part of the
body, so the window, the per-step path and the eager tail step share it:
its flag ``ok`` stays on the device, and the window writes it into the
ring's ``ok`` column (or a per-batch ``oks`` vector when the ring is off).

Mixed precision (``compute_dtype=torch.bfloat16``, the reference's
``compute_dtype``): every program casts its input after the transform,
the modules compute in the activation dtype from f32 master weights, and
what the step carries stays f32 — so nothing new is carried and a graph's
snapshot and restore are the same as in f32.

Training-mode BN uses the rank's own batch statistics.  The ``single``
strategy is the plain step with no process group, as the reference's
Part 1 has no ``torch.distributed`` code.

A token model (``augment="tokens"``) takes int ids [B, S] as they are,
is handed the activation dtype, and returns logits [B * S, V]; its loss is
the mean over every position (the labels [B, S] flattened alike).
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.nn as nn

from ..data import augment as aug
from ..ft import guard as ftguard
from ..obs import ringbuf
from ..ops import sgd
from ..ops.loss import cross_entropy, masked_eval_counts
from ..parallel import strategies
from ..parallel.mesh import Group

# Eager iterations before a capture: the first NCCL collective, cuDNN's
# handles and the autograd engine's threads initialise lazily, and none of
# that may happen inside a capture.
WARMUP_ITERS = 3

Index = Union[int, torch.Tensor]


class TrainState(NamedTuple):
    model: nn.Module          # parameters; BN running statistics as buffers
    opt_state: sgd.SGDState   # momentum buffers, a strategy's comm state


class StepOut(NamedTuple):
    """What the step body returns, all on the device, nothing fetched."""
    loss: torch.Tensor                    # 0-d, meaned over the ranks
    grads: Sequence[torch.Tensor]         # the post-sync gradients
    ok: Optional[torch.Tensor]            # 0-d bool; None: guard off
    grad_sqnorm: Optional[torch.Tensor]   # ok's squared norm; None: off


def init_train_state(model: nn.Module, strategy=None) -> TrainState:
    """A STATEFUL ``strategy`` (the compressed tiers) adds this rank's comm
    state to ``SGDState.comm``; the others leave it None."""
    opt = sgd.init(list(model.parameters()))
    if strategy is not None and getattr(strategy, "stateful", False):
        opt = opt._replace(comm=strategy.init_comm(model.named_parameters()))
    return TrainState(model, opt)


def named_state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor the step carries from one step to the next, by name:
    ``model/<name>`` for the parameters and buffers (BN running
    statistics), ``momentum/<parameter>``, and a stateful strategy's
    ``comm/residual/<parameter>`` and ``comm/q/<parameter>``.  The live
    tensors, not copies."""
    model, opt = state
    names = [n for n, _ in model.named_parameters()]
    out = {f"model/{n}": t.detach() for n, t in model.named_parameters()}
    out.update((f"model/{n}", b) for n, b in model.named_buffers())
    out.update((f"momentum/{n}", v)
               for n, v in zip(names, opt.momentum, strict=True))
    if opt.comm is not None:
        out.update((f"comm/residual/{n}", r)
                   for n, r in zip(names, opt.comm["residual"], strict=True))
        out.update((f"comm/q/{n}", q)
                   for n, q in opt.comm.get("q", {}).items())
    return out


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """``named_state_tensors``' tensors: parameters, buffers, momentum,
    comm state."""
    return list(named_state_tensors(state).values())


@contextlib.contextmanager
def preserved(tensors: Sequence[torch.Tensor]
              ) -> Iterator[Callable[[], None]]:
    """Restore ``tensors`` in place, bit for bit, when the block ends.  The
    block gets ``restore``, which does the same at once: one snapshot
    serves any number of restores."""
    saved = [t.clone() for t in tensors]

    def restore() -> None:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
    try:
        yield restore
    finally:
        restore()


def apply_strategy(strategy, grads, group: Group, comm):
    """Run the gradient-sync strategy, threading comm state: stateful
    strategies are ``(grads, group, comm) -> (grads, comm')``, stateless
    ones ``(grads, group) -> grads`` and pass ``comm`` through."""
    if getattr(strategy, "stateful", False):
        return strategy(grads, group, comm)
    return strategy(grads, group), comm


@torch.no_grad()
def copy_comm(comm: Dict, new_comm: Dict,
              ok: Optional[torch.Tensor] = None) -> None:
    """Write a stateful strategy's new comm state into ``comm``'s own
    tensors (where ``ok``, a 0-d bool device tensor, when given).  The
    strategies return fresh tensors; a captured step must find its state
    at the addresses it was captured with, so the step copies instead of
    rebinding."""
    if "q" in comm and comm["q"].keys() != new_comm["q"].keys():
        raise ValueError("the strategy returned Q factors for other "
                         "parameters than the comm state holds")
    pairs = list(zip(comm["residual"], new_comm["residual"], strict=True))
    pairs += [(q, new_comm["q"][name])
              for name, q in comm.get("q", {}).items()]
    for old, new in pairs:
        if ok is None:
            old.copy_(new)
        else:
            torch.where(ok, new, old, out=old)


# What a program's input is, and what ``prepare`` does with it:
#   True      uint8; the counter-keyed crop/flip of batch ``idx`` of
#             ``epoch`` and the normalize, on the device;
#   False     uint8; normalize only;
#   "host"    f32, already cropped, flipped and normalized by the C++ host
#             pipeline (the reference's ``augment="host"``): passed through;
#   "host_u8" uint8, cropped and flipped by the C++ host pipeline (the
#             windowed host path's staged format): the pipeline's own
#             affine normalize on the device (``aug.normalize_affine``), so
#             the step sees bit for bit what "host" hands it;
#   "tokens"  a token model's int ids [B, S]: passed through.
AUGMENT_MODES = (True, False, "host", "host_u8", "tokens")


def _check_augment(augment) -> None:
    if augment not in AUGMENT_MODES:
        raise ValueError(f"augment must be one of {AUGMENT_MODES}, got "
                         f"{augment!r}")


def _input_stats(augment, device
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The per-channel constants ``prepare`` takes for ``augment`` (none
    for token ids)."""
    if augment == "tokens":
        return None
    return aug.affine_stats(device) if augment == "host_u8" \
        else aug.channel_stats(device)


def logits_and_targets(model: nn.Module, x: torch.Tensor,
                       labels: torch.Tensor, tokens: bool,
                       compute_dtype: Optional[torch.dtype]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's logits of the prepared input ``x`` and the labels they
    answer: an image model computes in x's dtype (``prepare`` cast it); a
    token model is handed the activation dtype, and its labels [B, S] are
    flattened as its logits [B * S, V] are."""
    if tokens:
        return model(x, compute_dtype), labels.reshape(-1)
    return model(x), labels


def prepare(images: torch.Tensor, augment, key: int,
            epoch: torch.Tensor, idx: torch.Tensor,
            stats: Tuple[torch.Tensor, torch.Tensor],
            compute_dtype: Optional[torch.dtype] = None,
            micro: Optional[int] = None) -> torch.Tensor:
    """A batch [B,32,32,3] -> the model's input [B,3,32,32] (channels_last)
    in f32, as ``augment`` (``AUGMENT_MODES``) says; then cast to
    ``compute_dtype`` (None: stays f32), as the reference's
    ``fold_and_prepare`` casts after the transform.  ``micro`` keys the
    draws of an elastic microshard (``aug.draws``).  Token ids are passed
    through as they are."""
    if augment == "tokens":
        return images
    if augment == "host":
        x = images
    elif augment == "host_u8":
        x = aug.normalize_affine(images, stats)
    elif augment:
        x = aug.augment(images, key, epoch, idx, stats, micro)
    else:
        x = aug.normalize(images, stats)
    return aug.cast(aug.to_model_input(x), compute_dtype)


def _bn_statistics(model: nn.Module) -> List[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def mean_over_ranks(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Replace each tensor by its mean over the ranks, in place, through ONE
    all-reduce of one flat buffer.  Not a strategy collective: it stays out
    of the strategy's count (``Group.all_reduce_uncounted``)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    group.all_reduce_uncounted(flat)
    flat.div_(group.world)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def _index(v: Index, device: torch.device) -> torch.Tensor:
    """An int64 0-d tensor on ``device``: made by a fill, not a copy."""
    if torch.is_tensor(v):
        return v
    return torch.full((), int(v), dtype=torch.int64, device=device)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _stream_key(seed: int, group: Optional[Group]) -> int:
    return aug.stream_key(seed, 0 if group is None else group.rank)


def make_step_body(model: nn.Module, strategy=strategies.local,
                   cfg: sgd.SGDConfig = sgd.SGDConfig(), *,
                   augment=True, group: Optional[Group] = None,
                   seed: int = 0,
                   compute_dtype: Optional[torch.dtype] = None,
                   nonfinite_guard: bool = False,
                   nonfinite_chaos_steps: Tuple[int, ...] = ()) -> Callable:
    """body(state, images, labels, epoch, idx) -> ``StepOut``: one train
    step on this rank's rows, ``epoch`` and ``idx`` int64 0-d tensors on
    the model's device that key the augmentation draws.  ``augment`` says
    what ``images`` is (``AUGMENT_MODES``): uint8 by default, f32 host-
    augmented batches with ``"host"``.
    ``compute_dtype`` (None: f32) is the activations' dtype; parameters,
    gradients, momentum, comm state, BN statistics and the loss stay f32.

    It updates the parameters, BN running statistics, momentum and comm
    state in place and returns the loss (meaned over the ranks, a 0-d
    tensor, not synchronised) and the post-sync gradients.  No value goes
    to the host.  ``group.step_counts`` holds the step's strategy
    collectives afterwards.

    ``nonfinite_guard``: also return ``ok`` (finite loss and post-sync
    gradient norm) and its squared norm, and update only where ``ok``
    (``ft/guard.py``); the buffers are restored where not.
    ``nonfinite_chaos_steps``: absolute batch indices at which NaN is
    added to this rank's gradients before the strategy (the overlap tier
    launches its buckets from inside backward, so there after it);
    needs the guard.  ``body.guard`` is the ``StepGuard``, None when the
    guard is off."""
    if nonfinite_chaos_steps and not nonfinite_guard:
        raise ValueError("NaN injection (nonfinite_chaos_steps) needs the "
                         "non-finite guard")
    _check_augment(augment)
    params = list(model.parameters())
    single = strategy is strategies.local
    if single and group is not None and group.world != 1:
        raise ValueError("'single' strategy requires world 1 (reference "
                         "Part 1 is world_size==1), got world "
                         f"{group.world}")
    if not single and group is None:
        raise ValueError("a gradient-sync strategy needs a process group")
    stats = _bn_statistics(model)
    overlap = strategy.attach(params, group) \
        if hasattr(strategy, "attach") else None
    key = _stream_key(seed, group)
    norm = _input_stats(augment, _device_of(model))
    tokens = augment == "tokens"
    guard = None
    if nonfinite_guard:
        guard = ftguard.StepGuard(list(model.buffers()), params,
                                  nonfinite_chaos_steps)

    def body(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor, epoch: torch.Tensor,
             idx: torch.Tensor) -> StepOut:
        if guard is not None:
            guard.save(state.opt_state)
        x = prepare(images_u8, augment, key, epoch, idx, norm,
                    compute_dtype)
        model.train()
        loss = cross_entropy(*logits_and_targets(model, x, labels, tokens,
                                                 compute_dtype))
        comm = new_comm = None
        if single:
            grads = torch.autograd.grad(loss, params)
            if guard is not None:
                guard.inject(grads, idx)
            loss = loss.detach()
        else:
            group.reset_step()
            if overlap is not None:
                overlap.begin()
                torch.autograd.grad(loss, params)
                grads = overlap.finish()
                if guard is not None:
                    guard.inject(grads, idx)
            else:
                grads = list(torch.autograd.grad(loss, params))
                if guard is not None:
                    guard.inject(grads, idx)
                comm = state.opt_state.comm
                grads, new_comm = apply_strategy(strategy, grads, group,
                                                 comm)
            loss = loss.detach().reshape(1)
            with torch.no_grad():
                mean_over_ranks(list(stats) + [loss], group)
            loss = loss[0]
        if guard is None:
            if new_comm is not None:
                copy_comm(comm, new_comm)
            sgd.update(params, grads, state.opt_state, cfg)
            return StepOut(loss, grads, None, None)
        gsq = grad_sqnorm(grads)
        ok = ftguard.finite_ok(loss, gsq)
        if new_comm is not None:
            copy_comm(comm, new_comm, ok)
        guard.update(params, grads, state.opt_state, cfg, ok)
        return StepOut(loss, grads, ok, gsq)

    body.guard = guard
    return body


def make_train_step(model: nn.Module, strategy=strategies.local,
                    cfg: sgd.SGDConfig = sgd.SGDConfig(), *,
                    augment=True,
                    group: Optional[Group] = None, seed: int = 0,
                    compute_dtype: Optional[torch.dtype] = None,
                    nonfinite_guard: bool = False,
                    nonfinite_chaos_steps: Tuple[int, ...] = ()
                    ) -> Callable:
    """step(state, images [B,32,32,3], labels [B], epoch=0, idx=0) ->
    loss: ``make_step_body`` on a batch the caller hands over, ``epoch``
    and ``idx`` (ints or int64 0-d device tensors) keying the augmentation.
    ``step.body`` is the body, for a window that shares it;
    ``step.with_ok`` returns the body's whole ``StepOut``."""
    body = make_step_body(model, strategy, cfg, augment=augment,
                          group=group, seed=seed,
                          compute_dtype=compute_dtype,
                          nonfinite_guard=nonfinite_guard,
                          nonfinite_chaos_steps=nonfinite_chaos_steps)

    def with_ok(state: TrainState, images_u8: torch.Tensor,
                labels: torch.Tensor, epoch: Index = 0, idx: Index = 0
                ) -> StepOut:
        dev = images_u8.device
        return body(state, images_u8, labels, _index(epoch, dev),
                    _index(idx, dev))

    def step(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor, epoch: Index = 0, idx: Index = 0
             ) -> torch.Tensor:
        return with_ok(state, images_u8, labels, epoch, idx).loss

    step.body = body
    step.with_ok = with_ok
    return step


def make_forward_body(model: nn.Module, *, augment=True,
                      group: Optional[Group] = None, seed: int = 0,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> Callable:
    """fwd(images_u8, labels, epoch, idx) -> loss: the train step's input
    transform, forward in train mode (batch statistics) and loss, meaned
    over the ranks; no backward, no update.  The forward updates the BN
    running statistics in place, as every train-mode forward of the
    modules does: a caller that must leave them unchanged, as the
    reference's forward-only programs do, restores the model's buffers
    (running statistics and ``num_batches_tracked``)."""
    _check_augment(augment)
    key = _stream_key(seed, group)
    norm = _input_stats(augment, _device_of(model))

    @torch.no_grad()
    def fwd(images_u8: torch.Tensor, labels: torch.Tensor,
            epoch: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        model.train()
        loss = cross_entropy(*logits_and_targets(
            model, prepare(images_u8, augment, key, epoch, idx, norm,
                           compute_dtype),
            labels, augment == "tokens", compute_dtype))
        if group is not None and group.world > 1:
            loss = loss.reshape(1)
            mean_over_ranks([loss], group)
            loss = loss[0]
        return loss

    return fwd


def make_forward_step(model: nn.Module, group: Optional[Group] = None,
                      compute_dtype: Optional[torch.dtype] = None,
                      augment=False) -> Callable:
    """fwd(images, labels) -> loss: the reference's per-step forward-only
    program of ``profile_phases`` (normalize, forward in train mode, loss
    meaned over the ranks), BN running statistics left as they were.
    ``augment="host"`` takes the host path's f32 batches, as the
    reference's does under ``host_augment``."""
    body = make_forward_body(model, augment=augment, group=group,
                             compute_dtype=compute_dtype)
    buffers = list(model.buffers())

    def fwd(images_u8: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        zero = _index(0, images_u8.device)
        with preserved(buffers):
            return body(images_u8, labels, zero, zero)

    return fwd


def grad_sqnorm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum over parameters of sum(g*g), f32, 0-d."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).square().sum()


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

class GraphStep:
    """``fn()``, a step that reads and writes persistent tensors only, run
    eagerly on the CPU and as replays of ONE CUDA graph on the card.

    The first call on the card captures it, on a side stream:
      1. snapshot every tensor of ``state()`` (all the step carries);
      2. run ``WARMUP_ITERS`` eager iterations, each from the snapshot;
      3. restore the snapshot, and ``Group``'s collective counts as they
         were;
      4. capture ``fn`` into a graph with a private memory pool.
    So warm-up leaves no trace in the trajectory, and the capture itself
    executes nothing.  A capture that fails raises; nothing falls back to
    the eager step.

    ``Group`` counts a collective on the host, which a replay does not
    reach: each replay adds the captured step's collectives (and sets its
    link record), so that its counts mean "issued to the process group"
    on either path.  The bnpool
    kernels count their own runs on the device (``bnpool.executed_counts``);
    their wrappers' host counts see the warm-up and the capture only.
    ``replays`` counts the calls (each an eager step on the CPU) and
    ``captures`` the graphs captured."""

    def __init__(self, fn: Callable[[], None],
                 state: Callable[[], Sequence[torch.Tensor]],
                 group: Optional[Group], device: torch.device):
        self.fn = fn
        self.state = state
        self.group = group
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.captures = 0

    def prepare(self) -> None:
        """Warm up and capture now, if not done yet (on the card; the CPU
        runs the step eagerly and has nothing to capture)."""
        if self.device.type == "cuda" and self.graph is None:
            self._capture()

    def _capture(self) -> None:
        self.captures += 1
        tensors = list(self.state())
        counts = self._collectives()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        # One snapshot, restored after every warm-up iteration: a second
        # copy of the state would cost as much memory as the state.
        with torch.cuda.stream(side), preserved(tensors) as restore:
            for _ in range(WARMUP_ITERS):
                self.fn()
                restore()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._rewind(counts)
        graph = torch.cuda.CUDAGraph()
        # thread_local: NCCL's watchdog thread queries events while the
        # capture runs; that is no capture error of this thread's.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.fn()
        after = self._collectives()
        links = [] if self.group is None else list(self.group.step_links)
        self.collectives = tuple(a - b for a, b in zip(after, counts)) \
            + (links,)
        self._rewind(counts)
        self.graph = graph

    def _collectives(self) -> Tuple[Counter, Counter]:
        """The group's totals: (collectives by kind, their result bytes)."""
        if self.group is None:
            return Counter(), Counter()
        return (Counter(self.group.total_counts),
                Counter(self.group.total_bytes))

    def _rewind(self, total: Tuple[Counter, Counter]) -> None:
        if self.group is not None:
            self.group.total_counts = Counter(total[0])
            self.group.total_bytes = Counter(total[1])
            self.group.reset_step()

    def __call__(self) -> None:
        self.replays += 1
        if self.device.type != "cuda":
            self.fn()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        if self.group is not None:
            self.group.add_replayed(*self.collectives)


class _Window:
    """What the train and forward windows share: the batches (``images
    [NB,b,32,32,3]``, ``labels [NB,b]`` int64, persistent), the device
    scalars ``epoch``, ``idx`` (the absolute batch index of the next step)
    and ``pos`` (the step's place in the window), a loss vector of one
    slot per batch, and the ``GraphStep`` of ``_step``.

    The batches are the staged epoch, read at ``idx``; or, ``buffered``,
    one window's buffer (the host path's: the window's batches in rows
    ``0 .. w-1``, refilled before each window), read at ``pos`` while
    ``idx`` stays absolute, as the guard's injection and the ring's
    markers key on it."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor,
                 group: Optional[Group], buffered: bool = False):
        dev = images.device
        self.images, self.labels = images, labels
        self.buffered = buffered
        self.epoch = torch.zeros((), dtype=torch.int64, device=dev)
        self.idx = torch.zeros((), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses = torch.zeros(max(images.shape[0], 1),
                                  dtype=torch.float32, device=dev)
        self.step = GraphStep(self._step, self.tensors, group, dev)

    def named_tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor the step carries from one step to the next, by
        name (``GraphStep`` snapshots them; the audit holds each to its
        storage)."""
        return {"window/epoch": self.epoch, "window/idx": self.idx,
                "window/pos": self.pos, "window/losses": self.losses}

    def tensors(self) -> List[torch.Tensor]:
        return list(self.named_tensors().values())

    def _batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        i = (self.pos if self.buffered else self.idx).reshape(1)
        return (self.images.index_select(0, i)[0],
                self.labels.index_select(0, i)[0])

    def _record_loss(self, loss: torch.Tensor) -> None:
        self.losses.index_copy_(0, self.pos.reshape(1), loss.reshape(1))

    def _advance(self) -> None:
        """The end of every step: on to the next batch and place."""
        self.idx.add_(1)
        self.pos.add_(1)

    def _step(self) -> None:
        raise NotImplementedError

    def _run(self, epoch: int, start: int, w: int) -> None:
        nb = self.images.shape[0]
        if w < 1 or start < 0 or (w if self.buffered else start + w) > nb:
            raise ValueError(f"window of {w} from batch {start} does not fit "
                             f"the {nb} staged batches")
        self.epoch.fill_(epoch)
        self.idx.fill_(start)
        self.pos.fill_(0)
        for _ in range(w):
            self.step()


class WindowColumns(NamedTuple):
    """A drained window, one entry per step (``TrainWindow.columns``)."""
    loss: np.ndarray
    ok: Optional[np.ndarray]            # the guard's flags; None: off
    grad_sqnorm: Optional[np.ndarray]   # the ring's column; None: no ring
    steps: np.ndarray                   # absolute batch indices


class TrainWindow(_Window):
    """The reference's ``make_train_window``: ``window(epoch, start, w)``
    trains the staged batches ``start .. start + w - 1`` of ``epoch`` and
    returns, without synchronising, the device tensor the host drains once:
    the metric ring's buffer (``ring_capacity`` > 0; one (loss, grad
    sqnorm, ok, marker) row per step) or the window's losses (with the
    guard on, stacked over its ``oks``).  ``buffered``: the batches are
    one window's buffer, and the window trains its rows ``0 .. w - 1`` as
    the batches ``start ..`` (``_Window``).

    ``body`` is ``make_step_body``'s (the per-step path's own, so the two
    share the step and its hooks).  Each step reads its batch at the device
    index, runs the body, writes its row, and advances the index: on the
    card, one replay of the captured step.  ``ok`` is the body's guard
    flag, 1.0 when the guard is off."""

    def __init__(self, body: Callable, state: TrainState,
                 images: torch.Tensor, labels: torch.Tensor, *,
                 group: Optional[Group] = None,
                 ring_capacity: int = ringbuf.DEFAULT_CAPACITY,
                 buffered: bool = False):
        self.body = body
        self.state = state
        self.guarded = getattr(body, "guard", None) is not None
        self.ring = ringbuf.Ring(ring_capacity, images.device) \
            if ring_capacity else None
        super().__init__(images, labels, group, buffered)
        # The guard's flags when no ring holds them: one slot per batch.
        self.oks = torch.ones_like(self.losses) \
            if self.guarded and self.ring is None else None

    def named_tensors(self) -> Dict[str, torch.Tensor]:
        out = {**named_state_tensors(self.state), **super().named_tensors()}
        if self.ring is not None:
            out.update({"ring/buf": self.ring.buf,
                        "ring/count": self.ring.count})
        if self.oks is not None:
            out["window/oks"] = self.oks
        return out

    def _step(self) -> None:
        out = self.body(self.state, *self._batch(), self.epoch, self.idx)
        with torch.no_grad():
            if self.ring is not None:
                gsq = out.grad_sqnorm if out.grad_sqnorm is not None \
                    else grad_sqnorm(out.grads)
                self.ring.write((out.loss, gsq,
                                 1.0 if out.ok is None else out.ok,
                                 self.idx))
            else:
                if self.oks is not None:
                    self.oks.index_copy_(0, self.pos.reshape(1),
                                         out.ok.to(torch.float32)
                                         .reshape(1))
                self._record_loss(out.loss)
            self._advance()

    def __call__(self, epoch: int, start: int, w: int) -> torch.Tensor:
        self._run(epoch, start, w)
        if self.ring is None:
            if self.oks is not None:
                return torch.stack((self.losses[:w], self.oks[:w]))
            return self.losses[:w]
        self.ring.writes += w
        return self.ring.buf

    def columns(self, fetched, start: int, w: int) -> WindowColumns:
        """The window of ``w`` steps from batch ``start``, per step, from
        the host copy of what ``__call__`` returned: the losses, the
        guard's flags (1.0 finite, 0.0 not; None when it is off), the
        ring's ``grad_sqnorm`` column (None without the ring) and the
        steps' absolute batch indices (the ring's markers).  Nothing more
        is fetched: the rows are in ``fetched``."""
        steps = np.arange(start, start + w)
        if self.ring is None:
            if self.oks is None:
                return WindowColumns(fetched, None, None, steps)
            return WindowColumns(fetched[0], fetched[1], None, steps)
        loss, gsq, ok, marked = ringbuf.split_columns(
            ringbuf.drain_rows(fetched, self.ring.writes, w))
        if not np.array_equal(marked, steps):
            raise RuntimeError(f"the ring holds the rows of batches "
                               f"{marked.tolist()}, not of the window's "
                               f"{start}..{start + w - 1}")
        return WindowColumns(loss, ok if self.guarded else None, gsq, marked)

    def losses_of(self, fetched, start: int, w: int):
        """The losses of the window of ``w`` steps from batch ``start``, in
        step order, from the host copy of what ``__call__`` returned.  The
        ring's markers must be the window's batch indices: a step that did
        not run on the device leaves a row out."""
        return self.columns(fetched, start, w).loss


class FwdWindow(_Window):
    """The reference's ``make_fwd_window``: ``window(epoch, start, w)`` runs
    the train step's input transform, forward (train-mode BN) and loss over
    the same staged batches, no backward or update, and returns the losses
    [w] without synchronising.  The BN running statistics are restored
    when the window ends (the reference discards them)."""

    def __init__(self, model: nn.Module, images: torch.Tensor,
                 labels: torch.Tensor, *, augment: bool = True,
                 group: Optional[Group] = None, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        self.body = make_forward_body(model, augment=augment, group=group,
                                      seed=seed, compute_dtype=compute_dtype)
        self.buffers = list(model.buffers())
        super().__init__(images, labels, None)

    def named_tensors(self) -> Dict[str, torch.Tensor]:
        return {**{f"buffer/{i}": b for i, b in enumerate(self.buffers)},
                **super().named_tensors()}

    def _step(self) -> None:
        loss = self.body(*self._batch(), self.epoch, self.idx)
        self._record_loss(loss)
        self._advance()

    def __call__(self, epoch: int, start: int, w: int) -> torch.Tensor:
        with preserved(self.buffers):
            self._run(epoch, start, w)
        return self.losses[:w]


def make_eval_window(model: nn.Module, group: Optional[Group] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     tokens: bool = False) -> Callable:
    """evaluate(images [T,b,32,32,3] uint8, labels [T,b]) -> (loss_sum,
    correct): the reference's ``make_eval_window``, the whole staged test
    set with running statistics in BN, the normalized input cast to
    ``compute_dtype``, over the examples with label >= 0 (label -1 marks
    padding; counts from f32 logits), accumulated on the device and summed
    over the ranks by ONE all-reduce at the end.  Nothing is
    synchronised.  ``tokens``: a token model's ids [T,b,S] and targets
    [T,b,S], counted a position at a time."""
    norm = None if tokens else aug.channel_stats(_device_of(model))

    @torch.no_grad()
    def evaluate(images: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        loss_sum = torch.zeros((), dtype=torch.float32, device=images.device)
        correct = torch.zeros((), dtype=torch.int64, device=images.device)
        for t in range(images.shape[0]):
            x = images[t] if tokens else aug.cast(aug.to_model_input(
                aug.normalize(images[t], norm)), compute_dtype)
            ls, c = masked_eval_counts(*logits_and_targets(
                model, x, labels[t], tokens, compute_dtype))
            loss_sum += ls
            correct += c
        if group is None or group.world == 1:
            return loss_sum, correct
        # Counts up to 2**24 are exact in f32.
        both = torch.stack([loss_sum, correct.float()])
        group.all_reduce_uncounted(both)
        return both[0], both[1].long()

    return evaluate
