"""Bounded-queue micro-batcher: coalesce concurrent requests into buckets
-- the reference package's ``serve/batcher.py``, whose policy is
framework-free and is copied unchanged.

Batching policy (one page, deterministic):

  * requests join a FIFO queue bounded by ``max_queue_images`` — a full
    queue REJECTS (``QueueFull``) instead of buffering unboundedly, the
    standard bounded-staleness choice (Clipper, NSDI'17: reject early so
    tail latency stays bounded);
  * a batch is the longest FIFO prefix whose image total fits the largest
    bucket (requests are atomic — never split across batches);
  * the batch dispatches when the LARGEST bucket is exactly filled, when
    the next queued request cannot fit (the prefix is maximal), or when the
    OLDEST queued request has waited ``max_wait_ms`` — whichever comes
    first.  Latency-throughput tradeoff in one knob: max_wait 0 degenerates
    to per-request dispatch, max_wait inf to full-bucket batching;
  * the dispatched total is padded up to the smallest covering bucket by
    the engine (masked pad rows, ``engine.py``).

The policy lives in two PURE functions — ``coalesce`` (prefix selection)
and ``plan_batches`` (virtual-time replay of a whole arrival trace) — used
by both the threaded runtime and the tests, so batch composition under a
seeded trace is deterministic and CI-pinnable even though thread scheduling
is not.

Telemetry: spans ``serve_enqueue`` -> ``serve_batch`` (assembly) ->
``serve_dispatch`` -> ``serve_fetch`` (the last two in the engine), gauges
``queue_depth`` (images waiting) and ``serve_latency_ms`` per request
(attr ``bucket``), counters ``serve_bucket_<B>`` — all guarded on
``telemetry.enabled`` so the NULL recorder path allocates nothing.

Causality (round 8): every request gets a process-unique ``trace`` id at
submit; the enqueue span carries it, the batch/dispatch/fetch spans carry
the riding batch's full ``traces`` list, and two per-request gauges split
end-to-end latency into ``serve_queue_wait_ms`` (enqueue -> dispatch
start) vs ``serve_service_ms`` (dispatch start -> logits handed back) —
the instrumentation ROADMAP item 1's SLO curves read.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..obs import NULL


class QueueFull(RuntimeError):
    """The bounded request queue is at capacity; shed load upstream.

    ``retry_after_ms`` is the backpressure hint: the estimated time for
    the backlog to drain enough to admit the rejected request (queue
    depth x measured service-time EWMA).  The socket front-end forwards
    it verbatim in the wire protocol's overload reply, so clients can
    back off by measurement instead of by guess.
    """

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


def coalesce(sizes: Sequence[int], max_batch: int) -> Tuple[int, int]:
    """Longest FIFO prefix of request ``sizes`` whose total fits
    ``max_batch`` -> (request_count, image_total)."""
    total = 0
    k = 0
    for s in sizes:
        if total + s > max_batch:
            break
        total += s
        k += 1
    return k, total


def smallest_bucket(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} images exceed the largest bucket {buckets[-1]}")


def plan_batches(trace: Sequence[Tuple[float, int]],
                 buckets: Sequence[int],
                 max_wait_s: float) -> List[dict]:
    """Deterministic virtual-time replay of the batching policy over an
    arrival trace ``[(t_arrival, n_images), ...]`` (sorted by time).

    Assumes dispatch itself is instantaneous — this plans batch
    COMPOSITION (which requests ride together, in which bucket, released
    when), the part that must be reproducible under a seeded trace; wall
    clock enters only through the arrival stamps.  Returns
    ``[{"t": dispatch_time, "requests": [trace indices], "images": n,
    "bucket": B}, ...]``.
    """
    max_batch = buckets[-1]
    for t, n in trace:
        if n > max_batch:
            raise ValueError(f"request of {n} images exceeds the largest "
                             f"bucket {max_batch}")
    plan: List[dict] = []
    pending: List[int] = []      # trace indices
    pending_total = 0
    i = 0
    while i < len(trace) or pending:
        if not pending:
            pending = [i]
            pending_total = trace[i][1]
            i += 1
        deadline = trace[pending[0]][0] + max_wait_s
        dispatch_t = None
        while True:
            if pending_total == max_batch:
                dispatch_t = max(trace[pending[-1]][0],
                                 trace[pending[0]][0])
                break
            if i < len(trace) and trace[i][0] <= deadline:
                if pending_total + trace[i][1] > max_batch:
                    # Next request cannot fit: the prefix is maximal.
                    dispatch_t = trace[i][0]
                    break
                pending.append(i)
                pending_total += trace[i][1]
                i += 1
                continue
            dispatch_t = deadline
            break
        plan.append({"t": round(dispatch_t, 9), "requests": pending,
                     "images": pending_total,
                     "bucket": smallest_bucket(buckets, pending_total)})
        pending = []
        pending_total = 0
    return plan


_trace_lock = threading.Lock()
_trace_counter = itertools.count(1)


def next_trace_id() -> int:
    """Process-unique request trace id — the causality key threaded
    through enqueue -> batch -> dispatch -> fetch spans and the
    per-request latency-split gauges."""
    with _trace_lock:
        return next(_trace_counter)


class _Request:
    __slots__ = ("images", "labels", "future", "t_enqueue", "n", "trace",
                 "ctx")

    def __init__(self, images, labels, trace: int, ctx=None):
        self.images = images
        self.labels = labels
        self.n = len(images)
        self.future: Future = Future()
        self.t_enqueue = time.time()
        self.trace = trace
        self.ctx = ctx               # upstream TraceContext, or None


class MicroBatcher:
    """Threaded runtime around the pure policy: one worker drains the
    bounded queue into engine dispatches; ``submit`` returns a Future of
    the request's own logits rows."""

    def __init__(self, engine, *, max_wait_ms: float = 5.0,
                 max_queue_images: int = 1024, telemetry=None,
                 precision: str = "f32"):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue_images = max_queue_images
        self.telemetry = telemetry if telemetry is not None \
            else getattr(engine, "telemetry", NULL)
        self.precision = precision
        self._pending: List[_Request] = []
        self._pending_images = 0
        self._cond = threading.Condition()
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        self._svc_ewma_s: Optional[float] = None   # measured dispatch EWMA

    # -- lifecycle ----------------------------------------------------------

    def _assert_owned(self) -> None:
        """Assertion-mode lock-ownership check: every mutation of the
        condition-guarded state (_pending/_pending_images/_stop/_worker)
        must hold ``self._cond``.  ``_enqueue`` reads ``_stop``/``_worker``
        under the lock, so an unlocked writer (the historical
        ``start()``) races; compiled out under ``python -O`` like any
        assert."""
        assert getattr(self._cond, "_is_owned", lambda: True)(), \
            "MicroBatcher shared state mutated without holding self._cond"

    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._worker is not None:
                raise RuntimeError("already started")
            self._assert_owned()
            self._stop = False
            # The worker's first action is to take self._cond, so starting
            # it while we still hold the lock publishes _stop/_worker
            # before it can observe either.
            self._worker = threading.Thread(target=self._run,
                                            name="serve-microbatcher",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self) -> None:
        """Drain what is queued, then stop the worker."""
        with self._cond:
            self._assert_owned()
            self._stop = True
            worker = self._worker
            self._cond.notify_all()
        if worker is not None:
            worker.join()
            with self._cond:
                self._assert_owned()
                self._worker = None

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client side --------------------------------------------------------

    def submit(self, images: np.ndarray, labels=None, *,
               ctx=None) -> Future:
        """Enqueue one request (n <= largest bucket images); the Future
        resolves to this request's logits [n, 10].  Raises ``QueueFull``
        when accepting it would exceed the image bound.  ``ctx``
        (upstream ``TraceContext``) parents this request's queue span
        into the caller's distributed trace."""
        images = np.ascontiguousarray(images, np.uint8)
        n = len(images)
        if n > self.engine.max_batch:
            raise ValueError(f"request of {n} images exceeds the largest "
                             f"bucket {self.engine.max_batch}")
        tel = self.telemetry
        trace = next_trace_id()
        if tel.enabled:
            with tel.span("serve_enqueue", n=n, trace=trace):
                fut = self._enqueue(images, labels, n, trace, ctx)
            with self._cond:
                tel.gauge("queue_depth", self._pending_images)
            return fut
        return self._enqueue(images, labels, n, trace, ctx)

    def _enqueue(self, images, labels, n: int, trace: int,
                 ctx=None) -> Future:
        req = _Request(images, labels, trace, ctx)
        with self._cond:
            if self._worker is None or self._stop:
                raise RuntimeError("micro-batcher is not running")
            if self._pending_images + n > self.max_queue_images:
                raise QueueFull(
                    f"queue holds {self._pending_images} images; adding "
                    f"{n} would exceed the {self.max_queue_images} bound",
                    retry_after_ms=self._retry_after_ms_locked(n))
            self._assert_owned()
            self._pending.append(req)
            self._pending_images += n
            self._cond.notify_all()
        return req.future

    def _retry_after_ms_locked(self, n: int) -> float:
        """Backpressure hint for a rejected request: time for the backlog
        to drain enough to admit ``n`` more images, at one max-bucket
        dispatch per measured service-time EWMA (a conservative 10 ms
        prior before the first dispatch).  Caller holds ``self._cond``."""
        svc = self._svc_ewma_s if self._svc_ewma_s is not None else 0.010
        max_b = self.engine.max_batch
        need = self._pending_images + n - self.max_queue_images
        return round(1e3 * svc * max(1.0, need / float(max_b)), 3)

    # -- worker side --------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until the policy says dispatch; returns the FIFO prefix
        to dispatch, or None when stopped and drained."""
        max_batch = self.engine.max_batch
        with self._cond:
            while True:
                if self._pending:
                    k, total = coalesce([r.n for r in self._pending],
                                        max_batch)
                    now = time.time()
                    deadline = self._pending[0].t_enqueue + self.max_wait_s
                    if (total == max_batch or k < len(self._pending)
                            or now >= deadline or self._stop):
                        self._assert_owned()
                        batch = self._pending[:k]
                        del self._pending[:k]
                        self._pending_images -= total
                        return batch
                    self._cond.wait(timeout=deadline - now)
                elif self._stop:
                    return None
                else:
                    self._cond.wait()

    def _run(self) -> None:
        tel = self.telemetry
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                n_images = sum(r.n for r in batch)
                bucket = smallest_bucket(self.engine.buckets, n_images)
                traces = [r.trace for r in batch]
                if tel.enabled:
                    with tel.span("serve_batch", requests=len(batch),
                                  images=n_images, bucket=bucket,
                                  traces=traces):
                        images, labels = self._assemble(batch)
                else:
                    images, labels = self._assemble(batch)
                t_svc0 = time.time()
                if tel.enabled:
                    # trace_ids rides only on the telemetry path: engine
                    # stubs (tests) implement the bare 3-arg signature.
                    logits, _, _ = self.engine.infer_counts(
                        images, labels, precision=self.precision,
                        trace_ids=tuple(traces))
                else:
                    logits, _, _ = self.engine.infer_counts(
                        images, labels, precision=self.precision)
                t_done = time.time()
                with self._cond:
                    prev = self._svc_ewma_s
                    self._svc_ewma_s = (t_done - t_svc0) if prev is None \
                        else 0.7 * prev + 0.3 * (t_done - t_svc0)
                off = 0
                for r in batch:
                    r.future.set_result(logits[off:off + r.n])
                    off += r.n
                    if tel.enabled:
                        tel.gauge("serve_latency_ms",
                                  round((t_done - r.t_enqueue) * 1e3, 3),
                                  bucket=bucket, n=r.n, trace=r.trace)
                        tel.gauge("serve_queue_wait_ms",
                                  round((t_svc0 - r.t_enqueue) * 1e3, 3),
                                  bucket=bucket, n=r.n, trace=r.trace)
                        tel.gauge("serve_service_ms",
                                  round((t_done - t_svc0) * 1e3, 3),
                                  bucket=bucket, n=r.n, trace=r.trace)
                        if r.ctx is not None:
                            tel.span_event(
                                "sched_queue", r.t_enqueue,
                                t_svc0 - r.t_enqueue, trace=r.trace,
                                bucket=bucket,
                                **r.ctx.child("batcher").attrs())
                if tel.enabled:
                    with self._cond:
                        tel.gauge("queue_depth", self._pending_images)
            except BaseException as e:   # noqa: BLE001 - failures go to callers
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    @staticmethod
    def _assemble(batch: List[_Request]):
        images = np.concatenate([r.images for r in batch], axis=0)
        labels = np.concatenate([
            np.asarray(r.labels, np.int32) if r.labels is not None
            else np.full((r.n,), -1, np.int32) for r in batch])
        return images, labels
