"""Batch-bucketed single-GPU inference engine -- the reference package's
``serve/engine.py``, with a ladder of captured CUDA graphs in place of its
ahead-of-time compiled XLA executables.

A fixed LADDER of batch buckets (e.g. {1, 8, 32, 128, 256}) is captured at
startup; a request batch of n images is padded to the smallest covering
bucket and the pad rows are masked out of every reduced quantity with the
label -1 convention of eval (``ops/loss.py::masked_eval_counts``), so
serving and eval accounting cannot drift apart.  Per-row outputs (logits)
are sliced back to n; with eval-mode BatchNorm (running statistics) every
row is computed independently of its batchmates.  The forward is
``models/serving.py::make_u8_forward``: uint8 in, the normalize inside the
program, optional bf16 compute with f32 logits out.  Eval-mode BN runs the
library chain (``models/layers.py``), so serving launches no bnpool kernel.

On the card each rung is one CUDA graph per (bucket, precision, pipeline
slot), ``PIPELINE_SLOTS`` (2) slots in all.  A slot owns static tensors,
allocated outside any capture: the uint8 images and int64 labels of the
largest bucket, the packed outputs (loss_sum, correct, then the logits
rows) and their pinned host copy.  Each graph reads rows ``[:bucket]`` of
its slot's inputs and writes its slot's outputs; the graphs share one
memory pool, which holds intermediates only, and replay one at a time on
the engine's stream.  So two dispatches, of the same bucket or not, are in
flight at once in the two slots, and neither overwrites the other's input
or output.  A slot is refilled only after its previous dispatch's fence
was seen on the host: a third issue with two in flight waits on it, as the
reference's two-slot arena bounds its depth.  A capture or replay that
fails raises; nothing falls back to eager or CPU execution.  On the CPU
(only when the caller passes ``device="cpu"``) each rung runs
``make_u8_forward`` eagerly at the bucket's shape.

What has no counterpart: the reference's warm-start executable cache
(``serve/cache.py``), since a CUDA graph has no serialized form, so
``cache_dir`` is refused and each rung's capture time is the cold start;
and ``lowered`` / ``lowered_hlo``, the XLA IR of a rung: the port's cost
model counts a rung's forward on meta tensors instead
(``scheduler.py::cost_model_weights``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, set_f32_parity
from ..models import convert, get_model
from ..models.serving import make_u8_forward
from ..obs import NULL
from ..train.step import WARMUP_ITERS
from .ingest import StagedIngest

BUCKETS = (1, 8, 32, 128, 256)
# Dispatches in flight per engine: the staging arena's depth (the
# reference keeps it in serve/scheduler.py).
PIPELINE_SLOTS = 2
NUM_CLASSES = 10

_DTYPES = {"f32": None, "bf16": torch.bfloat16}


class DispatchHandle:
    """One in-flight asynchronous dispatch (``infer_counts_async``): its
    pipeline slot and the metadata ``complete`` needs to fence, slice and
    attribute it.  ``result`` is filled when the engine reads the slot
    back, at ``complete`` or when a later issue needs the slot.  Opaque to
    callers."""

    __slots__ = ("slot", "n", "bucket", "traces", "t_issue", "result")

    def __init__(self, slot, n, bucket, traces, t_issue):
        self.slot = slot
        self.n = n
        self.bucket = bucket
        self.traces = traces
        self.t_issue = t_issue
        self.result = None


class _Slot:
    """The static tensors of one pipeline slot, which every rung of the
    slot reads and writes: images uint8 [max_batch, 32, 32, 3] and labels
    int64 [max_batch] on the device; ``out`` f32 [2 + 10 * max_batch] on
    the device (loss_sum, correct, then the logits rows; a count of at most
    max_batch is exact in f32); on the card the pinned host copy of
    ``out``, the pinned labels the device's are copied from, and the event
    recorded after the copy back.  ``handle`` is the dispatch last issued
    on the slot while it is not yet read back."""

    def __init__(self, index: int, max_batch: int, device: torch.device):
        self.index = index
        self.images = torch.zeros((max_batch, 32, 32, 3), dtype=torch.uint8,
                                  device=device)
        self.labels = torch.full((max_batch,), -1, dtype=torch.int64,
                                 device=device)
        self.out = torch.zeros(2 + NUM_CLASSES * max_batch,
                               dtype=torch.float32, device=device)
        if device.type == "cuda":
            self.host_labels = torch.empty(max_batch, dtype=torch.int64,
                                           pin_memory=True)
            self.host_out = torch.empty(self.out.shape, dtype=torch.float32,
                                        pin_memory=True)
            self.done = torch.cuda.Event()
        else:
            self.host_labels = self.labels
            self.host_out = self.out
            self.done = None
        self.handle: Optional[DispatchHandle] = None


class InferenceEngine:
    """The rung ladder + padded/masked dispatch for one model.

    ``state`` is the port's ``state_dict`` of ``model`` (for example
    ``models.convert.from_jax`` of the reference's parameters, or a
    trained model's); when omitted the model is seed-initialized
    (``get_model(model, seed)``: the demo's mode, where latency is the
    subject and weights are irrelevant).  ``device=None`` is the GPU and
    raises without one.
    """

    def __init__(self, model: str = "vgg11", *,
                 buckets: Sequence[int] = BUCKETS,
                 precisions: Sequence[str] = ("f32",),
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, telemetry=NULL,
                 cache_dir: Optional[str] = None,
                 use_staging: bool = True, device=None):
        if not buckets:
            raise ValueError("need at least one bucket")
        if sorted(set(buckets)) != list(buckets):
            raise ValueError(f"buckets must be strictly increasing, got "
                             f"{tuple(buckets)}")
        for p in precisions:
            _check_precision(p)
        if cache_dir is not None:
            raise ValueError(
                f"cache_dir={cache_dir!r}: the port keeps no executable "
                f"cache, because a CUDA graph has no serialized form; each "
                f"rung is captured at startup (its capture time is the "
                f"cold start)")
        self.device = resolve_device(device)
        set_f32_parity()
        self.model_name = model
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.precisions: Tuple[str, ...] = tuple(precisions)
        self.telemetry = telemetry
        net = get_model(model, seed)
        if state is not None:
            net.load_state_dict(state)
        self.model = net.to(self.device, memory_format=torch.channels_last)
        self.model.eval()
        # The tensors the rungs read, by name: install_weights copies into
        # them in place.
        self._weights = self.model.state_dict()
        # What a published bundle must match (publish/watcher.py): the
        # abstract signature in the reference's layout, (treedef string,
        # ((shape, dtype), ...)) of convert.serving_leaves, under the
        # reference engine's key.
        self._key_fields = {
            "abstract": convert.serving_signature(self._weights)}
        # Bumped by install_weights() (publish/ hot-swap); tagged into
        # every Reply so the A/B pin is checkable per request.
        self.weights_version = 0
        self._forward = {p: make_u8_forward(self.model, dt)
                         for p, dt in _DTYPES.items()}
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._slots = [_Slot(i, self.max_batch, self.device)
                       for i in range(PIPELINE_SLOTS)]
        self._next_slot = 0
        self._rungs: Dict[Tuple[int, str, int], Callable[[], None]] = {}
        self._ingest = (StagedIngest(self.max_batch, PIPELINE_SLOTS,
                                     self.device) if use_staging else None)

    # -- weight hot-swap ----------------------------------------------------

    def install_weights(self, state_dict: Dict[str, torch.Tensor],
                        version: int, *, assume_staged: bool = False) -> None:
        """Copy a new weight version into the tensors the rungs read.

        The graphs read the model's parameters and buffers where they were
        captured, so this is an in-place ``copy_`` under ``no_grad``: no
        rung is recaptured, and the bf16 rungs, which cast the f32 weights
        inside their graphs, read the new version too.  A state whose
        names, shapes or dtypes differ from the ladder's is refused here
        rather than at the next dispatch.

        NOT internally synchronized: the caller guarantees that no dispatch
        is in flight (the scheduler runs installs through
        ``request_install`` when its pipeline is drained).  ``assume_staged=True``
        says the tensors are already on the engine's device (staged off
        the serving path beforehand); one that is not is refused.
        """
        got = {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()}
        want = {k: (tuple(v.shape), v.dtype)
                for k, v in self._weights.items()}
        if got != want:
            raise ValueError(
                f"install_weights: tree does not match the abstract "
                f"signature the executable ladder was compiled against "
                f"(model {self.model_name!r})")
        if assume_staged:
            off = [k for k, v in state_dict.items()
                   if v.device != self.device]
            if off:
                raise ValueError(f"install_weights: assume_staged, but "
                                 f"{off[:3]} are not on {self.device}")
        with torch.no_grad(), self._on_stream():
            for name, target in self._weights.items():
                target.copy_(state_dict[name])
        if self._stream is not None:
            self._stream.synchronize()     # the sources may be freed next
        self.weights_version = int(version)
        if self.telemetry.enabled:
            self.telemetry.counter("weights_installed", version=version)

    # -- ladder -------------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` requests."""
        if n < 1:
            raise ValueError(f"need at least one image, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"request batch {n} exceeds the largest bucket "
                         f"{self.buckets[-1]}; split it upstream "
                         f"(the micro-batcher never builds one this big)")

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def startup(self) -> dict:
        """Build the whole ladder (capture every (bucket, precision) rung
        in every pipeline slot); returns the startup timing report."""
        t0 = time.time()
        per: Dict[str, dict] = {}
        source = "capture" if self._stream is not None else "eager"
        for prec in self.precisions:
            for b in self.buckets:
                t1 = time.time()
                if self.telemetry.enabled:
                    with self.telemetry.span("serve_compile", bucket=b,
                                             precision=prec):
                        self._build_rung(b, prec)
                else:
                    self._build_rung(b, prec)
                name = f"{b}/{prec}" if len(self.precisions) > 1 else str(b)
                per[name] = {"seconds": round(time.time() - t1, 4),
                             "source": source}
        report = {
            "startup_s": round(time.time() - t0, 4),
            "per_bucket": per,
            "warm": False,
            "executable_cache": {"dir": None, "supported": False,
                                 "hits": 0, "misses": 0},
            "backend": self.device.type,
        }
        if self.telemetry.enabled:
            self.telemetry.gauge("serve_startup_s", report["startup_s"],
                                 warm=False)
        return report

    def _build_rung(self, bucket: int, precision: str) -> None:
        for slot in self._slots:
            self._rung(bucket, precision, slot)

    def _rung(self, bucket: int, precision: str,
              slot: _Slot) -> Callable[[], None]:
        """The rung's run: its graph's replay on the card (captured at
        first use when ``startup`` did not), the eager forward on the
        CPU."""
        key = (bucket, precision, slot.index)
        run = self._rungs.get(key)
        if run is None:
            run = self._rung_fn(bucket, precision, slot)
            if self._stream is not None:
                run = self._capture(run).replay
            self._rungs[key] = run
        return run

    def _rung_fn(self, bucket: int, precision: str,
                 slot: _Slot) -> Callable[[], None]:
        forward = self._forward[precision]
        images, labels = slot.images[:bucket], slot.labels[:bucket]
        out = slot.out
        logits_out = out[2:2 + NUM_CLASSES * bucket].view(bucket, NUM_CLASSES)

        def run() -> None:
            logits, loss_sum, correct = forward(images, labels)
            logits_out.copy_(logits)
            out[0].copy_(loss_sum)
            out[1].copy_(correct)
        return run

    def _capture(self, fn: Callable[[], None]) -> torch.cuda.CUDAGraph:
        """Warm ``fn`` up on a side stream (cuDNN's handles and workspaces
        initialise lazily, which no capture may do), then capture it on
        that stream into a graph on the shared pool.  The engine's card is
        the current device throughout and the capture stream is passed
        explicitly: ``torch.cuda.graph``'s own default stream is made
        once per process, on whichever card was current then, so an
        engine on another card would capture onto a foreign stream.  A
        failure raises."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(self._stream)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERS):
                    fn()
            self._stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                fn()
        return graph

    # -- dispatch -----------------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _take_slot(self) -> _Slot:
        """The next pipeline slot, once its previous dispatch (if still
        unread) is read back: the wait that bounds the depth."""
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        pending = slot.handle
        if pending is not None:
            pending.result = self._read(pending)
        return slot

    def _stage(self, slot: _Slot, images: np.ndarray, labels,
               bucket: int) -> None:
        """The request's images, zero-padded to ``bucket``, and its labels,
        -1-padded, into the slot's device inputs."""
        n = images.shape[0]
        host = slot.host_labels[:bucket]
        host.fill_(-1)
        if labels is not None:
            host[:n] = torch.from_numpy(np.asarray(labels, np.int64))
        dst = slot.images[:bucket]
        if self._ingest is not None:
            event = self._ingest.stage(images, bucket, dst)
            if event is not None:
                self._stream.wait_event(event)
        else:
            padded = np.zeros((bucket, 32, 32, 3), np.uint8)
            padded[:n] = images
            with self._on_stream():
                dst.copy_(torch.from_numpy(padded))
        if self._stream is not None:
            with self._on_stream():
                slot.labels[:bucket].copy_(host, non_blocking=True)

    def _launch(self, slot: _Slot, bucket: int, precision: str,
                n: int) -> None:
        """Run the rung on the slot; on the card, then copy its outputs'
        first n rows back to the pinned host copy and record the slot's
        fence after it."""
        run = self._rung(bucket, precision, slot)
        if self._stream is None:
            run()
            return
        used = 2 + NUM_CLASSES * n
        with self._on_stream():
            run()
            slot.host_out[:used].copy_(slot.out[:used], non_blocking=True)
            slot.done.record(self._stream)

    def _fence(self, handle: DispatchHandle) -> float:
        """Wait for the slot's fence (its event, not a device-wide
        synchronize); the time it was seen."""
        done = self._slots[handle.slot].done
        if done is not None:
            done.synchronize()
        return time.time()

    def _fetch(self, handle: DispatchHandle, t_ready: float):
        """Read a fenced slot's outputs: (logits [n, 10] f32 numpy,
        loss_sum, correct, t_ready); the slot is free again."""
        slot = self._slots[handle.slot]
        out = slot.host_out.numpy()
        n = handle.n
        logits = out[2:2 + NUM_CLASSES * n].reshape(n, NUM_CLASSES).copy()
        slot.handle = None
        return logits, float(out[0]), int(out[1]), t_ready

    def _read(self, handle: DispatchHandle):
        return self._fetch(handle, self._fence(handle))

    def _issue(self, images: np.ndarray, labels, precision: str,
               traces: Tuple[int, ...], *, serial: bool) -> DispatchHandle:
        n = images.shape[0]
        bucket = self.bucket_for(n)
        _check_precision(precision)
        tel = self.telemetry
        if tel.enabled:
            tel.counter(f"serve_bucket_{bucket}")
            with tel.span("serve_stage", bucket=bucket, n=n,
                          traces=list(traces)):
                slot = self._take_slot()
                self._stage(slot, images, labels, bucket)
        else:
            slot = self._take_slot()
            self._stage(slot, images, labels, bucket)
        handle = DispatchHandle(slot.index, n, bucket, traces, time.time())
        if serial and tel.enabled:
            with tel.span("serve_dispatch", bucket=bucket, n=n,
                          traces=list(traces)):
                self._launch(slot, bucket, precision, n)
        else:
            self._launch(slot, bucket, precision, n)
        slot.handle = handle
        return handle

    def infer_counts(self, images: np.ndarray, labels=None, *,
                     precision: str = "f32",
                     trace_ids: Sequence[int] = ()):
        """Forward a request batch of n <= max_batch images.

        Returns ``(logits[n, 10] f32, loss_sum, correct)``; pad rows carry
        label -1 and contribute NOTHING to loss_sum/correct (the
        ``masked_eval_counts`` convention).  Unlabeled requests (labels
        None) get all -1 labels, so both counts are exactly 0.

        ``trace_ids`` (micro-batcher, telemetry runs) are the riding
        requests' trace ids; the dispatch/fetch spans carry them so every
        device dispatch is attributable to the exact requests it served.
        """
        images = np.ascontiguousarray(images, np.uint8)
        traces = tuple(trace_ids)
        handle = self._issue(images, labels, precision, traces, serial=True)
        tel = self.telemetry
        if tel.enabled:
            with tel.span("serve_fetch", bucket=handle.bucket,
                          traces=list(traces)):
                out = self._read(handle)
        else:
            out = self._read(handle)
        return out[0], out[1], out[2]

    # -- pipelined dispatch (issue / complete split) ------------------------

    def infer_counts_async(self, images: np.ndarray, labels=None, *,
                           precision: str = "f32",
                           trace_ids: Sequence[int] = ()) -> DispatchHandle:
        """Issue one padded bucket dispatch WITHOUT fencing it.

        The replay and the copy back are queued on the engine's stream and
        this returns, so the caller can stage and issue the NEXT batch (the
        other pipeline slot) while this one computes.  At most
        ``PIPELINE_SLOTS`` dispatches are in flight: a further issue first
        waits for the oldest one's fence and reads it back into its handle.
        Resolve with ``complete(handle)``: every issued handle MUST be
        completed, in issue order.
        """
        images = np.ascontiguousarray(images, np.uint8)
        return self._issue(images, labels, precision, tuple(trace_ids),
                           serial=False)

    def complete(self, handle: DispatchHandle,
                 prev_done: Optional[float] = None):
        """Fence one in-flight dispatch and fetch its results.

        Returns ``(logits[n, 10] f32, loss_sum, correct, t_ready)`` —
        bitwise-identical rows to the serial ``infer_counts`` path (the
        same rung, the same staged bytes).  ``prev_done`` (the previous
        completion's ``t_ready``) clips this dispatch's telemetry span to
        the window the device actually worked on it: with two in flight,
        batch N+1's wall interval overlaps batch N's, and the honest
        per-dispatch occupancy is ``t_ready - max(t_issue, prev_done)``.
        """
        tel = self.telemetry
        if not tel.enabled:
            if handle.result is None:
                handle.result = self._read(handle)
            return handle.result
        t_ready = self._fence(handle) if handle.result is None \
            else handle.result[3]
        start = handle.t_issue if prev_done is None \
            else max(handle.t_issue, float(prev_done))
        tel.span_event("serve_dispatch", start, max(t_ready - start, 0.0),
                       bucket=handle.bucket, n=handle.n,
                       traces=list(handle.traces))
        with tel.span("serve_fetch", bucket=handle.bucket,
                      traces=list(handle.traces)):
            if handle.result is None:
                handle.result = self._fetch(handle, t_ready)
        return handle.result

    def infer(self, images: np.ndarray, *,
              precision: str = "f32") -> np.ndarray:
        """Logits [n, 10] f32 for n <= max_batch uint8 images."""
        logits, _, _ = self.infer_counts(images, precision=precision)
        return logits


def _check_precision(p: str) -> None:
    if p not in _DTYPES:
        raise ValueError(f"unknown precision {p!r}")
