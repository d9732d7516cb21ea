"""Continuous-batching SLO scheduler over the bucket ladder -- the
reference package's ``serve/scheduler.py``.  The policy (``admit``, the
virtual-time planners, ``ServiceModel``) is framework-free and copied
unchanged; the threaded worker drives the port's ``InferenceEngine`` (a
ladder of captured CUDA graphs) through the same ``infer_counts`` and
``infer_counts_async`` / ``complete`` surface.

The micro-batcher (``batcher.MicroBatcher``) drains its queue into one
batch per dispatch: requests that arrive while the engine is busy wait for
the NEXT drain, and a 256-image bulk request parks every 1-image request
behind multi-millisecond service no matter how tight their deadlines are.
This module replaces that drain policy with the two serving-systems ideas
this scheduler follows:

* **Continuous batching** (Orca, Yu et al., OSDI 2022): admission is
  re-decided at every engine-free instant over whatever is queued *now*,
  so new arrivals join the next bucket dispatch instead of waiting for a
  queue drain.  (Orca's per-iteration KV state does not apply here — the
  CNN ladder is stateless — so "iteration-level" degenerates to
  "dispatch-level", which is exactly ``admit()``.)
* **Deadline-aware admission + load shedding** (Clipper, Crankshaw et
  al., NSDI 2017): per-request deadlines and priority tiers; under
  overload the scheduler sheds deterministically — lowest tier first,
  earliest-to-miss first — and every shed request gets an explicit reply.

The policy itself is the pure function ``admit()`` (unit-testable, no
clocks, no locks); ``SLOScheduler`` is the thin threaded shell that runs
it against a real ``InferenceEngine``.  ``plan_continuous`` /
``plan_drain`` replay the same policy (and the old drain policy) in
virtual time over a seeded arrival trace — the deterministic substrate
for the continuous-vs-drain comparison in tests.

Dispatch pipeline: with ``pipeline=True`` (the default for engines
exposing ``infer_counts_async``/``complete``) the worker keeps up to
``PIPELINE_SLOTS`` (= 2, the engine's slots and the StagedIngest arena
depth) dispatches in flight: batch N+1 is staged into the second slot and
issued while batch N's graph replays, and completions resolve strictly in
issue order, so that the host tax (assemble + stage + issue + fetch) of
batch N+1 can overlap batch N's compute.  Honesty obligations that ride
along:

* ``admit(free_at=...)`` deadline-checks a second-slot batch against the
  predicted drain of the work ahead of it, not the admission instant;
* the EWMA observes per-dispatch DEVICE OCCUPANCY
  (``t_ready - max(t_issue, prev_done)``), not the overlapped wall
  interval, so predictions stay additive across slots;
* weight installs (``request_install``) run only when the pipeline is
  fully DRAINED — the engine-free instant between in-flight pairs — so
  the hot-swap A/B pin (no torn weights, per-batch version tag) holds
  under pipelining: each reply carries the engine's ``weights_version``
  read at issue;
* a fault surfacing at completion of slot N (the ``dispatch_fault``
  chaos site) resolves slot N's requests as explicit errors and slot
  N+1's normally — never a silent drop.

What the card adds (the port's own):

* the worker runs with the engine's card as its thread's current CUDA
  device (``torch.cuda.device``), so replicas on ``cuda:0`` and
  ``cuda:1`` each replay, record and stage on their own card; two
  replicas on one card share it, each on its own stream, graph pool and
  staging arena;
* the fence of a dispatch is its slot's event, never a device-wide
  synchronize: the pipelined loop makes no synchronizing call;
* a worker that dies with dispatches in flight hands their requests to
  ``on_death`` first and then fences those dispatches, discarding their
  results, before its thread ends: nothing the engine owns is reused or
  freed under a running replay, ``stop()`` (which joins the worker) waits
  on the fences, and no future is resolved twice.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import NULL
from .batcher import QueueFull, next_trace_id, smallest_bucket
# Depth of the per-replica dispatch pipeline: one batch computing on the
# device plus one staged-and-issued behind it (defined once, by the
# engine, whose slots bound it; re-exported here as the reference does).
from .engine import _DTYPES, PIPELINE_SLOTS

_seq_counter = itertools.count(1)


class SchedRequest:
    """One admitted unit of work: ``n`` images + tier + absolute deadline.

    ``deadline`` is a wall-clock time (``math.inf`` = no SLO); ``seq`` is
    the admission-order tiebreak that makes every policy decision total —
    two requests never compare equal, so ``admit()`` is deterministic.
    """

    __slots__ = ("images", "labels", "n", "tier", "deadline", "t_arrival",
                 "seq", "trace", "future", "ctx", "t_defer")

    def __init__(self, images, labels, n, tier, deadline, t_arrival, seq,
                 trace, future, ctx=None):
        self.images = images
        self.labels = labels
        self.n = n
        self.tier = tier
        self.deadline = deadline
        self.t_arrival = t_arrival
        self.seq = seq
        self.trace = trace
        self.future = future
        self.ctx = ctx            # upstream TraceContext (None = untraced)
        self.t_defer = None       # first admit-deferral wall time


class Reply(NamedTuple):
    """Terminal outcome of one request — every accepted request gets
    exactly one (ok/late/shed/error); the front-end adds "overload" for
    requests rejected at admission."""
    status: str                      # "ok" | "late" | "shed" | "error"
    trace: int = 0
    tier: int = 0
    logits: Optional[np.ndarray] = None
    reason: str = ""
    retry_after_ms: float = 0.0
    queue_wait_ms: float = 0.0
    service_ms: float = 0.0
    latency_ms: float = 0.0
    replica: int = -1
    # Engine weights_version that served this request (publish/ hot-swap
    # A/B pin); -1 for replies that never reached a dispatch (shed/error).
    model_version: int = -1


class Admission(NamedTuple):
    """One ``admit()`` decision: the batch to dispatch now, its bucket,
    the requests shed (with reasons), and the requests DEFERRED back to
    the queue by miss repair (observable for trace attribution — they
    stay pending, so deferral is otherwise invisible queue wait)."""
    batch: Tuple[SchedRequest, ...]
    bucket: Optional[int]
    shed: Tuple[Tuple[SchedRequest, str], ...]
    predicted_done: Optional[float]
    deferred: Tuple[SchedRequest, ...] = ()


def make_request(images, labels=None, *, tier: int = 0,
                 slo_ms: Optional[float] = None, now: Optional[float] = None,
                 seq: Optional[int] = None, trace: Optional[int] = None,
                 max_batch: int = 256, ctx=None) -> SchedRequest:
    """Build a live request (numpy-ified images, fresh Future/trace/seq).
    ``ctx`` is the upstream hop's ``TraceContext`` (or None)."""
    images = np.ascontiguousarray(images, np.uint8)
    n = int(images.shape[0])
    if n < 1:
        raise ValueError("empty request")
    if n > max_batch:
        raise ValueError(f"request of {n} images exceeds the largest "
                         f"bucket {max_batch}; split it client-side")
    if labels is not None:
        labels = np.asarray(labels, np.int32)
        if labels.shape != (n,):
            raise ValueError(f"labels shape {labels.shape} != ({n},)")
    t = time.time() if now is None else float(now)
    deadline = float("inf") if slo_ms is None else t + float(slo_ms) / 1e3
    return SchedRequest(images, labels, n, int(tier), deadline, t,
                        next(_seq_counter) if seq is None else int(seq),
                        next_trace_id() if trace is None else int(trace),
                        Future(), ctx)


def virtual_requests(trace: Sequence[Tuple[float, int, int, float]]
                     ) -> List[SchedRequest]:
    """Futureless requests from a load-trace ``[(t, n, tier, slo_ms), ...]``
    — the input to the virtual-time planners."""
    out = []
    for i, (t, n, tier, slo_ms) in enumerate(trace):
        deadline = float("inf") if slo_ms is None or slo_ms <= 0 \
            else t + slo_ms / 1e3
        out.append(SchedRequest(None, None, int(n), int(tier), deadline,
                                float(t), i, i + 1, None))
    return out


def admit(pending: Sequence[SchedRequest], now: float, *,
          buckets: Sequence[int],
          predict_s: Callable[[int], float],
          shed: bool = True,
          free_at: Optional[float] = None) -> Admission:
    """The continuous-batching admission policy — pure and deterministic.

    Orders the queue by ``(tier, deadline, seq)`` (EDF within tier),
    sheds already-late requests, greedily packs the ladder's largest
    bucket, then repairs predicted misses — re-predicting the (possibly
    smaller) bucket after each removal:

    * first by DEFERRING (back to the queue, not shed) the lowest-
      priority batchmate that is not itself missing — shrinking the
      bucket trades batch throughput for the tight deadline, so a bulk
      background request cannot drag an interactive request past its
      SLO (the Clipper latency/batch-size tradeoff);
    * only when no lower-priority batchmate is left to defer is a miss
      actually shed — always the lowest tier among the missing,
      earliest deadline first.

    Requests that don't fit (or were deferred) stay queued for the next
    admission — that is the "continuous" part.  With ``shed=False``
    nothing is dropped or deferred: late requests are dispatched anyway
    and reported ``late``.

    ``free_at`` (pipelined two-slot admission) is the predicted wall time
    the engine frees a slot for THIS batch: predicted completions are
    measured from ``max(now, free_at)`` instead of ``now``, so a batch
    admitted into the second in-flight slot is deadline-checked against
    when it will actually run, not the admission instant.  ``None`` (the
    serial scheduler, an idle pipeline) keeps the single-slot policy
    bit-for-bit.
    """
    start = now if free_at is None else max(now, float(free_at))
    order = sorted(pending, key=lambda r: (r.tier, r.deadline, r.seq))
    shed_list: List[Tuple[SchedRequest, str]] = []
    live: List[SchedRequest] = []
    if shed:
        for r in order:
            if r.deadline < now:
                shed_list.append((r, "deadline"))
            else:
                live.append(r)
    else:
        live = order
    max_b = buckets[-1]
    batch: List[SchedRequest] = []
    total = 0
    for r in live:
        if total + r.n <= max_b:
            batch.append(r)
            total += r.n
    done = None
    deferred: List[SchedRequest] = []
    while batch:
        done = start + predict_s(smallest_bucket(buckets, total))
        if not shed:
            break
        misses = [r for r in batch if r.deadline < done]
        if not misses:
            break
        urgent = min(r.tier for r in misses)
        defer = [r for r in batch
                 if r.tier > urgent and r.deadline >= done]
        if defer:
            victim = max(defer, key=lambda r: (r.tier, r.deadline, r.seq))
            batch.remove(victim)
            total -= victim.n
            deferred.append(victim)
            done = None
            continue
        worst = max(r.tier for r in misses)
        victim = min((r for r in misses if r.tier == worst),
                     key=lambda r: (r.deadline, r.seq))
        batch.remove(victim)
        total -= victim.n
        shed_list.append((victim, "predicted_miss"))
        done = None
    bucket = smallest_bucket(buckets, total) if batch else None
    return Admission(tuple(batch), bucket, tuple(shed_list), done,
                     tuple(deferred))


# -- virtual-time planners (deterministic replay over a trace) --------------


def _record(r: SchedRequest, status: str, start: float, done: float,
            reason: str = "") -> dict:
    return {"trace": r.trace, "tier": r.tier, "n": r.n, "status": status,
            "reason": reason,
            "queue_wait_ms": round((start - r.t_arrival) * 1e3, 6),
            "t_done": round(done, 9)}


def _summarize_plan(records: List[dict], dispatches: List[dict]) -> dict:
    from ..obs.telemetry import percentile
    waits = sorted(rec["queue_wait_ms"] for rec in records
                   if rec["status"] in ("ok", "late"))
    served = len(waits)
    met = sum(1 for rec in records if rec["status"] == "ok")
    shed = [rec for rec in records if rec["status"] == "shed"]
    return {
        "records": records,
        "dispatches": dispatches,
        "served": served,
        "met": met,
        "shed": [(rec["trace"], rec["tier"], rec["reason"]) for rec in shed],
        "attainment": round(met / len(records), 6) if records else None,
        "p50_wait_ms": round(percentile(waits, 50), 6) if waits else None,
        "p99_wait_ms": round(percentile(waits, 99), 6) if waits else None,
    }


def plan_continuous(requests: Sequence[SchedRequest], *,
                    buckets: Sequence[int],
                    predict_s: Callable[[int], float],
                    shed: bool = True) -> dict:
    """Virtual-time replay of ``admit()`` over an arrival trace: at every
    engine-free instant, re-admit over everything queued.  Deterministic —
    the same trace yields the same dispatches and the same shed set."""
    pend = sorted(requests, key=lambda r: (r.t_arrival, r.seq))
    i, queue = 0, []
    t_free = 0.0
    records: Dict[int, dict] = {}
    dispatches: List[dict] = []
    while i < len(pend) or queue:
        t_now = t_free if queue else max(t_free, pend[i].t_arrival)
        while i < len(pend) and pend[i].t_arrival <= t_now:
            queue.append(pend[i])
            i += 1
        adm = admit(queue, t_now, buckets=buckets, predict_s=predict_s,
                    shed=shed)
        taken = {id(r) for r in adm.batch}
        taken.update(id(r) for r, _ in adm.shed)
        queue = [r for r in queue if id(r) not in taken]
        for r, reason in adm.shed:
            records[r.seq] = _record(r, "shed", t_now, t_now, reason)
        if adm.batch:
            svc = predict_s(adm.bucket)
            done = t_now + svc
            dispatches.append({"t": round(t_now, 9), "bucket": adm.bucket,
                               "traces": tuple(r.trace for r in adm.batch)})
            for r in adm.batch:
                status = "ok" if done <= r.deadline else "late"
                records[r.seq] = _record(r, status, t_now, done)
            t_free = done
        # progress: each iteration dispatches (t_free advances past the
        # next arrival or drains the queue) or sheds >= 1 request.
    ordered = [records[r.seq] for r in pend]
    return _summarize_plan(ordered, dispatches)


def plan_drain(requests: Sequence[SchedRequest], *,
               buckets: Sequence[int],
               predict_s: Callable[[int], float],
               max_wait_s: float = 0.005) -> dict:
    """Virtual-time replay of the micro-batcher's drain policy (FIFO
    prefix-coalesce; dispatch when the prefix is bucket-maximal or the
    oldest request has waited ``max_wait_s``) — the baseline the
    continuous planner is measured against.  No deadlines, no shedding:
    requests that finish past their deadline are simply ``late``."""
    from .batcher import coalesce
    pend = sorted(requests, key=lambda r: (r.t_arrival, r.seq))
    i, queue = 0, []
    t, t_free = 0.0, 0.0
    records: Dict[int, dict] = {}
    dispatches: List[dict] = []
    max_b = buckets[-1]
    while i < len(pend) or queue:
        if not queue:
            t = max(t, pend[i].t_arrival)
            while i < len(pend) and pend[i].t_arrival <= t:
                queue.append(pend[i])
                i += 1
            continue
        k, total = coalesce([r.n for r in queue], max_b)
        expire = queue[0].t_arrival + max_wait_s
        if k < len(queue) or total == max_b:
            start = max(t, t_free)
        elif i < len(pend) and pend[i].t_arrival <= expire:
            t = pend[i].t_arrival
            while i < len(pend) and pend[i].t_arrival <= t:
                queue.append(pend[i])
                i += 1
            continue
        else:
            start = max(expire, t_free, t)
        absorbed = False
        while i < len(pend) and pend[i].t_arrival <= start:
            queue.append(pend[i])
            i += 1
            absorbed = True
        if absorbed:        # engine-busy accumulation: re-coalesce
            t = start
            continue
        batch, queue = queue[:k], queue[k:]
        bucket = smallest_bucket(buckets, total)
        done = start + predict_s(bucket)
        dispatches.append({"t": round(start, 9), "bucket": bucket,
                           "traces": tuple(r.trace for r in batch)})
        for r in batch:
            records[r.seq] = _record(
                r, "ok" if done <= r.deadline else "late", start, done)
        t, t_free = start, done
    ordered = [records[r.seq] for r in pend]
    return _summarize_plan(ordered, dispatches)


# -- service-time model -----------------------------------------------------


class ServiceModel:
    """Per-bucket service-time prior, corrected online by measurement.

    The prior is a *shape*: relative weights per bucket (HLO cost-model
    flops via ``cost_model_weights``, or the bucket sizes themselves)
    anchored at ``anchor_s`` for the smallest bucket.  Every dispatch
    feeds ``observe()``; ``predict()`` prefers the measured EWMA for the
    bucket, then scales from the most-observed measured bucket by the
    weight ratio, then falls back to the anchored prior — so the router's
    outstanding-work estimate starts sane and converges to reality.
    """

    _lock_owned = ("_ewma", "_nobs")

    def __init__(self, buckets: Sequence[int], *,
                 weights: Optional[Dict[int, float]] = None,
                 anchor_s: float = 2e-3, alpha: float = 0.3):
        self.buckets = tuple(int(b) for b in buckets)
        if weights is None:
            weights = {b: float(b) for b in self.buckets}
        missing = [b for b in self.buckets if b not in weights]
        if missing:
            raise ValueError(f"weights missing buckets {missing}")
        self.weights = {b: float(weights[b]) for b in self.buckets}
        self.anchor_s = float(anchor_s)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma: Dict[int, float] = {}
        self._nobs: Dict[int, int] = {}

    def observe(self, bucket: int, service_s: float) -> None:
        b, s = int(bucket), float(service_s)
        with self._lock:
            prev = self._ewma.get(b)
            self._ewma[b] = s if prev is None \
                else (1.0 - self.alpha) * prev + self.alpha * s
            self._nobs[b] = self._nobs.get(b, 0) + 1

    def predict(self, bucket: int) -> float:
        b = int(bucket)
        with self._lock:
            got = self._ewma.get(b)
            if got is not None:
                return got
            if self._nobs:
                ref = max(self._nobs, key=lambda k: (self._nobs[k], k))
                return self._ewma[ref] * self.weights[b] / self.weights[ref]
        return self.anchor_s * self.weights[b] / self.weights[self.buckets[0]]

    def snapshot(self) -> Dict[int, float]:
        """Frozen ``{bucket: predicted_s}`` — a deterministic ``predict_s``
        for the virtual planners."""
        return {b: self.predict(b) for b in self.buckets}


def cost_model_weights(engine, precision: str = "f32") -> Dict[int, float]:
    """Per-bucket cost-model flops, the static service-time *shape* for
    ``ServiceModel``: each rung's forward (``models/serving.py::
    make_u8_forward`` at that bucket and precision) counted by
    ``analysis/costmodel.py`` on a meta twin of the engine's model, with a
    floor of 1.0."""
    from ..analysis import costmodel
    from ..models.serving import make_u8_forward
    forward = make_u8_forward(costmodel.meta_model(engine.model_name),
                              _DTYPES[precision])
    out = {}
    for b in engine.buckets:
        images = torch.empty((b, 32, 32, 3), dtype=torch.uint8,
                             device="meta")
        labels = torch.empty((b,), dtype=torch.int64, device="meta")
        rep = costmodel.count(forward, images, labels, name=f"serve_b{b}")
        out[int(b)] = max(float(rep.flops), 1.0)
    return out


# -- the threaded scheduler shell ------------------------------------------


class SLOScheduler:
    """Continuous-batching worker over one ``InferenceEngine``.

    One daemon thread re-runs ``admit()`` at every engine-free instant;
    accepted requests resolve their Future with a ``Reply`` exactly once
    (ok / late / shed / error — never silently dropped).  A worker crash
    (including the ``replica_death`` chaos site) hands every unfinished
    request to ``on_death`` — the router's failover hook — or resolves
    them as explicit errors when unattended.

    ``pipeline`` selects the double-buffered worker (module docstring):
    ``None`` auto-enables it when the engine exposes the async dispatch
    API (``infer_counts_async``/``complete``); ``False`` forces the
    serial worker (the A/B baseline and the path engine stubs
    exercise).  ``complete_hook(dispatch_no, bucket)`` runs at each
    dispatch's COMPLETION point; an exception it raises (the
    ``dispatch_fault`` chaos site) is isolated to that one batch —
    explicit error replies, the worker keeps serving — unlike
    ``dispatch_hook`` exceptions, which kill the worker (replica death).
    """

    _lock_owned = ("_pending", "_pending_images", "_inflight", "_stop",
                   "_dead", "_busy_s", "_busy_until", "_worker",
                   "_t0_wall", "_installs")

    def __init__(self, engine, *, svc: Optional[ServiceModel] = None,
                 shed: bool = True, max_queue_images: int = 1024,
                 precision: str = "f32", telemetry=None, replica: int = 0,
                 dispatch_hook=None, complete_hook=None, on_death=None,
                 pipeline: Optional[bool] = None):
        self.engine = engine
        self.buckets = tuple(engine.buckets)
        self.svc = svc if svc is not None else ServiceModel(self.buckets)
        self.shed = bool(shed)
        self.max_queue_images = int(max_queue_images)
        self.precision = precision
        self.telemetry = telemetry if telemetry is not None else NULL
        self.replica = int(replica)
        self.dispatch_hook = dispatch_hook
        self.complete_hook = complete_hook
        self.on_death = on_death
        if pipeline is None:
            pipeline = hasattr(engine, "infer_counts_async")
        elif pipeline and not hasattr(engine, "infer_counts_async"):
            raise ValueError(
                "pipeline=True requires an engine with the async dispatch "
                "API (infer_counts_async/complete)")
        self.pipeline = bool(pipeline)
        self._cond = threading.Condition()
        self._pending: List[SchedRequest] = []
        self._pending_images = 0
        self._inflight: Tuple[SchedRequest, ...] = ()
        self._stop = False
        self._dead = False
        self._busy_s = 0.0
        # Predicted wall time the in-flight pipeline drains (0.0 = idle);
        # feeds admit(free_at=...) and the overload retry hint.
        self._busy_until = 0.0
        self._worker: Optional[threading.Thread] = None
        self._t0_wall: Optional[float] = None
        self._dispatches = 0          # worker-thread-local dispatch index
        # Engine-free-instant work queue (weight installs): closures the
        # worker runs between dispatches, each with its Future.
        self._installs: List[Tuple[Callable[[], object], Future]] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SLOScheduler":
        with self._cond:
            if self._worker is not None:
                raise RuntimeError("scheduler already started")
            if self._dead:
                raise RuntimeError("scheduler is dead")
            self._stop = False
            self._worker = threading.Thread(
                target=self._run, name=f"slo-sched-{self.replica}",
                daemon=True)
            self._t0_wall = time.time()
            worker = self._worker
        worker.start()
        return self

    def stop(self) -> None:
        """Drain the queue, then stop the worker (idempotent).  Joining
        the worker waits for every fence it owes: the drained pipeline's,
        or after a death its orphaned dispatches' (``_fence_orphans``)."""
        with self._cond:
            worker = self._worker
            self._stop = True
            self._cond.notify_all()
        if worker is not None:
            worker.join()
        # Installs queued after the worker's last boundary check would be
        # stranded — run them inline (the worker is gone, so this thread
        # IS the engine-free instant).
        with self._cond:
            leftovers = self._installs
            self._installs = []
        self._run_installs(leftovers)
        t_now = time.time()
        with self._cond:
            self._worker = None
            t0 = self._t0_wall
            busy = self._busy_s
        if t0 is not None and self.telemetry.enabled:
            wall = max(t_now - t0, 1e-9)
            self.telemetry.gauge("replica_busy_s", round(busy, 6),
                                 replica=self.replica)
            self.telemetry.gauge("replica_util",
                                 round(min(busy / wall, 1.0), 6),
                                 replica=self.replica)

    def __enter__(self) -> "SLOScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def alive(self) -> bool:
        return self._worker is not None and not self._dead

    # -- admission ---------------------------------------------------------

    def submit(self, images, labels=None, *, tier: int = 0,
               slo_ms: Optional[float] = None, ctx=None) -> Future:
        """Accept one request; returns a Future resolving to a ``Reply``.
        Raises ``QueueFull`` (with a retry-after hint) when the bounded
        queue cannot take it.  ``ctx`` is the upstream ``TraceContext``
        (the frontend hop's), threaded into dispatch-time spans."""
        req = make_request(images, labels, tier=tier, slo_ms=slo_ms,
                           max_batch=self.engine.max_batch, ctx=ctx)
        return self.enqueue(req)

    def enqueue(self, req: SchedRequest) -> Future:
        """Admit an already-built request (the router's failover path
        re-enqueues the SAME object so trace/deadline/Future survive)."""
        tel = self.telemetry
        hint = None
        with self._cond:
            if self._dead or self._stop:
                raise RuntimeError(
                    f"replica {self.replica} not accepting requests")
            if self._pending_images + req.n > self.max_queue_images:
                hint = self._retry_hint_ms_locked(req.n)
            else:
                self._pending.append(req)
                self._pending_images += req.n
                depth = self._pending_images
                self._cond.notify_all()
        if hint is None and tel.enabled:
            # Queue-depth watermark signal for the alert engine.
            tel.gauge("serve_queue_depth", depth, replica=self.replica)
        if hint is not None:
            if tel.enabled:
                tel.counter("serve_overload", tier=req.tier,
                            replica=self.replica)
            raise QueueFull(
                f"replica {self.replica} queue full "
                f"({self.max_queue_images} images)", retry_after_ms=hint)
        if tel.enabled:
            tel.counter("serve_admitted", tier=req.tier, replica=self.replica)
        return req.future

    def request_install(self, fn: Callable[[], object]) -> Future:
        """Queue ``fn`` (a weight-flip closure from the publish watcher)
        to run at the worker's next engine-free instant — between
        dispatches, so no batch can observe a torn weight tree.  Returns
        a Future resolving to ``fn()``'s result (or its exception).

        With no live worker (not started, stopped, or dead) there is no
        dispatcher to race, so ``fn`` runs inline right here.  Safe to
        call from inside a dispatch hook (the ``swap_mid_batch`` chaos
        probe): the hook runs ON the worker thread, the install is merely
        queued, and it lands after the current dispatch completes — the
        caller must not block on the Future from that context.
        """
        fut: Future = Future()
        inline = False
        with self._cond:
            if self._worker is None or self._dead or self._stop:
                inline = True
            else:
                self._installs.append((fn, fut))
                self._cond.notify_all()
        if inline:
            self._run_installs([(fn, fut)])
        return fut

    @staticmethod
    def _run_installs(installs) -> None:
        for fn, fut in installs:
            if fut.done():
                continue
            try:
                fut.set_result(fn())
            except Exception as exc:   # install failure must not kill serving
                fut.set_exception(exc)

    def _retry_hint_ms_locked(self, n: int) -> float:
        """Time for the backlog to drain enough to admit ``n`` more images
        (queue depth x per-max-bucket service-time estimate, plus the
        predicted drain of any in-flight pipeline slots).  Caller holds
        ``self._cond``."""
        max_b = self.buckets[-1]
        need = self._pending_images + n - self.max_queue_images
        batches = max(1.0, need / float(max_b))
        hint = 1e3 * self.svc.predict(max_b) * batches
        inflight_s = self._busy_until - time.time()
        if inflight_s > 0.0:
            hint += 1e3 * inflight_s
        return round(hint, 3)

    def outstanding_s(self) -> float:
        """Predicted seconds of queued + in-flight work — the router's
        least-loaded signal."""
        with self._cond:
            reqs = list(self._pending) + list(self._inflight)
        pred = self.svc.predict
        return sum(pred(smallest_bucket(self.buckets, r.n)) for r in reqs)

    def queue_depth(self) -> int:
        with self._cond:
            return self._pending_images

    # -- worker ------------------------------------------------------------

    def _device_scope(self):
        """The worker thread's current CUDA device: the engine's card (a
        thread's current device is its own, and ``torch.cuda.stream``
        does not switch it).  A CPU engine or a stub needs none."""
        device = getattr(self.engine, "device", None)
        if getattr(device, "type", None) == "cuda":
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    def _run(self) -> None:
        # The pipelined worker's issued-but-uncompleted dispatches, oldest
        # first: after a death, fenced here (module docstring).
        inflight: List[dict] = []
        with self._device_scope():
            try:
                if self.pipeline:
                    self._run_pipelined(inflight)
                    return
                while True:
                    item = self._next_admission()
                    if item is None:
                        return
                    adm, now = item
                    if adm.deferred:
                        self._note_deferred(adm.deferred, now)
                    if adm.shed:
                        self._resolve_shed(adm.shed, now)
                    if adm.batch:
                        self._dispatch(adm.batch, adm.bucket)
            except Exception as exc:   # replica death: hand off, never drop
                self._die(exc)
                self._fence_orphans(inflight)

    def _fence_orphans(self, inflight: List[dict]) -> None:
        """Fence, in issue order, the dispatches a dead worker had issued
        and not completed, and discard their results: their requests were
        handed to ``on_death`` (or resolved as errors) by ``_die``.  Until
        these fences are seen, the replays may still read the engine's
        slots and staging buffers."""
        while inflight:
            self.engine.complete(inflight.pop(0)["handle"])

    def _next_admission(self):
        while True:
            with self._cond:
                installs = self._installs
                self._installs = []
                if not installs:
                    if self._pending:
                        now = time.time()
                        adm = admit(self._pending, now, buckets=self.buckets,
                                    predict_s=self.svc.predict,
                                    shed=self.shed)
                        taken = {id(r) for r in adm.batch}
                        taken.update(id(r) for r, _ in adm.shed)
                        self._pending = [r for r in self._pending
                                         if id(r) not in taken]
                        self._pending_images = sum(r.n for r in self._pending)
                        self._inflight = adm.batch
                        return adm, now
                    if self._stop:
                        return None
                    self._cond.wait()
                    continue
            # Engine-free instant: no dispatch in flight, lock released
            # (an install copies into the engine's weights and waits for
            # it — admission and enqueue must not stall behind it).
            self._run_installs(installs)

    # -- pipelined worker (two in-flight slots) -----------------------------

    def _run_pipelined(self, inflight: List[dict]) -> None:
        """Double-buffered dispatch loop: admit-and-issue into a free slot
        while the oldest dispatch computes; complete strictly in issue
        order.  ``inflight`` (worker-local, oldest first) holds at most
        ``PIPELINE_SLOTS`` issued-but-uncompleted dispatch records."""
        tel = self.telemetry
        prev_done: Optional[float] = None
        while True:
            op, payload = self._next_pipeline_op(len(inflight))
            if op == "exit":
                return
            if op == "installs":
                # Pipeline fully drained: the engine-free instant between
                # in-flight pairs — the only point a weight flip may land
                # (lock released; an install may take its time).
                self._run_installs(payload)
                continue
            if op == "complete":
                prev_done = self._complete_oldest(inflight, prev_done)
            else:  # "admit"
                adm, now = payload
                if adm.deferred:
                    self._note_deferred(adm.deferred, now)
                if adm.shed:
                    self._resolve_shed(adm.shed, now)
                if adm.batch:
                    inflight.append(self._issue(adm.batch, adm.bucket))
            if tel.enabled:
                tel.gauge("serve_inflight", len(inflight),
                          replica=self.replica)

    def _next_pipeline_op(self, have: int):
        """Pick the worker's next action under the lock.  Priority: drain
        toward queued installs; admit-and-issue into a free slot; complete
        the oldest in-flight dispatch; exit when stopped and drained."""
        while True:
            with self._cond:
                if self._installs:
                    if have:
                        return "complete", None
                    installs = self._installs
                    self._installs = []
                    return "installs", installs
                if self._pending and have < PIPELINE_SLOTS:
                    now = time.time()
                    adm = admit(self._pending, now, buckets=self.buckets,
                                predict_s=self.svc.predict, shed=self.shed,
                                free_at=self._busy_until if have else None)
                    taken = {id(r) for r in adm.batch}
                    taken.update(id(r) for r, _ in adm.shed)
                    self._pending = [r for r in self._pending
                                     if id(r) not in taken]
                    self._pending_images = sum(r.n for r in self._pending)
                    self._inflight = self._inflight + adm.batch
                    if adm.batch:
                        self._busy_until = max(self._busy_until, now) \
                            + self.svc.predict(adm.bucket)
                    return "admit", (adm, now)
                if have:
                    return "complete", None
                if self._stop:
                    return "exit", None
                self._cond.wait()

    def _issue(self, batch, bucket: int) -> dict:
        """Issue one admitted batch without fencing it: hook, version tag,
        assemble, stage into the next arena slot, async dispatch."""
        t0 = time.time()
        dno = self._dispatches
        hook = self.dispatch_hook
        if hook is not None:
            hook(dno, bucket)
        self._dispatches += 1
        # The version serving THIS batch, read once at issue.  Installs
        # only land when the pipeline is drained, so no install can flip
        # weights between this read and the graph replay reading them.
        version = int(getattr(self.engine, "weights_version", -1))
        images, labels = self._assemble(batch)
        traces = tuple(r.trace for r in batch)
        handle = self.engine.infer_counts_async(
            images, labels, precision=self.precision,
            trace_ids=traces if self.telemetry.enabled else ())
        return {"batch": batch, "bucket": bucket, "handle": handle,
                "t0": t0, "version": version, "dispatch": dno,
                "traces": traces}

    def _complete_oldest(self, inflight: List[dict],
                         prev_done: Optional[float]) -> float:
        """Fence, fetch, account, and reply the OLDEST in-flight dispatch.
        A ``complete_hook`` exception (the ``dispatch_fault`` chaos site)
        is isolated to this batch: its requests get explicit error
        replies, the newer in-flight dispatch is untouched, and the old
        weights keep serving.  Returns this completion's ``t_ready`` (the
        next call's ``prev_done``)."""
        rec = inflight.pop(0)
        batch, bucket = rec["batch"], rec["bucket"]
        tel = self.telemetry
        fault = None
        chook = self.complete_hook
        if chook is not None:
            try:
                chook(rec["dispatch"], bucket)
            except Exception as exc:    # isolated: this batch only
                fault = exc
        # Fence and fetch even on a fault: the arena slot and the
        # completion clock must stay consistent (the result is discarded).
        logits, _, _, t_ready = self.engine.complete(
            rec["handle"], prev_done=prev_done)
        t0 = rec["t0"]
        start = t0 if prev_done is None else max(t0, prev_done)
        occ_s = max(t_ready - start, 0.0)   # device occupancy, not wall
        self.svc.observe(bucket, occ_s)
        svc_ms = round((t_ready - t0) * 1e3, 3)
        batch_ids = {id(r) for r in batch}
        with self._cond:
            self._inflight = tuple(r for r in self._inflight
                                   if id(r) not in batch_ids)
            self._busy_s += occ_s
            self._busy_until = t_ready + sum(
                self.svc.predict(r2["bucket"]) for r2 in inflight)
        if tel.enabled:
            tel.gauge("serve_service_ms", round(occ_s * 1e3, 3),
                      bucket=bucket, replica=self.replica,
                      traces=list(rec["traces"]))
            if fault is not None:
                tel.counter("serve_dispatch_fault", bucket=bucket,
                            replica=self.replica,
                            error=type(fault).__name__)
        off = 0
        for r in batch:
            out = logits[off:off + r.n]
            off += r.n
            met = t_ready <= r.deadline
            qw_ms = round((t0 - r.t_arrival) * 1e3, 3)
            lat_ms = round((t_ready - r.t_arrival) * 1e3, 3)
            if tel.enabled:
                tel.gauge("serve_latency_ms", lat_ms, trace=r.trace,
                          tier=r.tier, met=met, replica=self.replica)
                tel.gauge("serve_queue_wait_ms", qw_ms, trace=r.trace,
                          tier=r.tier, replica=self.replica)
                if not met and fault is None:
                    tel.counter("serve_deadline_miss", tier=r.tier,
                                replica=self.replica)
                if r.ctx is not None:
                    tel.span_event("sched_queue", r.t_arrival,
                                   t0 - r.t_arrival, trace=r.trace,
                                   tier=r.tier, replica=self.replica,
                                   bucket=bucket,
                                   **r.ctx.child("sched").attrs())
                    if r.t_defer is not None:
                        tel.span_event("sched_defer", r.t_defer,
                                       t0 - r.t_defer, trace=r.trace,
                                       **r.ctx.child("sched").attrs())
            if r.future is not None and not r.future.done():
                if fault is not None:
                    r.future.set_result(Reply(
                        status="error", trace=r.trace, tier=r.tier,
                        reason=f"{type(fault).__name__}: {fault}",
                        queue_wait_ms=qw_ms, service_ms=svc_ms,
                        latency_ms=lat_ms, replica=self.replica,
                        model_version=rec["version"]))
                else:
                    r.future.set_result(Reply(
                        status="ok" if met else "late", trace=r.trace,
                        tier=r.tier, logits=out, queue_wait_ms=qw_ms,
                        service_ms=svc_ms, latency_ms=lat_ms,
                        replica=self.replica,
                        model_version=rec["version"]))
        return t_ready

    def _note_deferred(self, deferred, now: float) -> None:
        """Stamp first-deferral time on requests miss-repair pushed back
        to the queue — at dispatch the deferral renders as the
        ``sched_defer`` slice of their queue wait."""
        tel = self.telemetry
        for r in deferred:
            if r.t_defer is None:
                r.t_defer = now
            if tel.enabled:
                tel.counter("serve_deferred", tier=r.tier,
                            replica=self.replica)

    def _resolve_shed(self, shed, now: float) -> None:
        tel = self.telemetry
        for req, reason in shed:
            if tel.enabled:
                tel.counter("serve_shed", tier=req.tier, reason=reason,
                            replica=self.replica)
            if req.future is not None and not req.future.done():
                req.future.set_result(Reply(
                    status="shed", trace=req.trace, tier=req.tier,
                    reason=reason, replica=self.replica,
                    queue_wait_ms=round((now - req.t_arrival) * 1e3, 3)))

    @staticmethod
    def _assemble(batch):
        images = np.concatenate([r.images for r in batch], axis=0)
        labels = None
        if any(r.labels is not None for r in batch):
            labels = np.concatenate(
                [r.labels if r.labels is not None
                 else np.full((r.n,), -1, np.int32) for r in batch])
        return images, labels

    def _dispatch(self, batch, bucket: int) -> None:
        tel = self.telemetry
        hook = self.dispatch_hook
        # The service clock starts BEFORE the dispatch hook: a hook stall
        # (``slow_replica`` — a straggling chip) is service time the
        # router's EWMA must learn, not queue wait.
        t0 = time.time()
        dno = self._dispatches
        if hook is not None:
            hook(dno, bucket)
        self._dispatches += 1
        # The version serving THIS batch, read once at dispatch.  Installs
        # only land at loop boundaries (never mid-dispatch), so the value
        # read here is exactly the weights the replay will read — the
        # per-request A/B pin.  A swap_mid_batch probe fired by the hook
        # above only QUEUES an install; this batch still runs (and is
        # tagged) on the old weights.
        version = int(getattr(self.engine, "weights_version", -1))
        images, labels = self._assemble(batch)
        traces = tuple(r.trace for r in batch)
        if tel.enabled:
            logits, _, _ = self.engine.infer_counts(
                images, labels, precision=self.precision, trace_ids=traces)
        else:
            logits, _, _ = self.engine.infer_counts(
                images, labels, precision=self.precision)
        # Completion point: the serial twin of the pipelined worker's
        # complete-side hook, so the dispatch_fault chaos site fires (and
        # pins bitwise) identically in both modes.  A hook exception is
        # isolated to this batch — explicit error replies, worker lives.
        fault = None
        chook = self.complete_hook
        if chook is not None:
            try:
                chook(dno, bucket)
            except Exception as exc:
                fault = exc
        t_done = time.time()
        svc_s = t_done - t0
        self.svc.observe(bucket, svc_s)
        with self._cond:
            self._inflight = ()
            self._busy_s += svc_s
        if tel.enabled:
            tel.gauge("serve_service_ms", round(svc_s * 1e3, 3),
                      bucket=bucket, replica=self.replica, traces=list(traces))
            if fault is not None:
                tel.counter("serve_dispatch_fault", bucket=bucket,
                            replica=self.replica,
                            error=type(fault).__name__)
        off = 0
        for r in batch:
            out = logits[off:off + r.n]
            off += r.n
            met = t_done <= r.deadline
            qw_ms = round((t0 - r.t_arrival) * 1e3, 3)
            lat_ms = round((t_done - r.t_arrival) * 1e3, 3)
            if tel.enabled:
                tel.gauge("serve_latency_ms", lat_ms, trace=r.trace,
                          tier=r.tier, met=met, replica=self.replica)
                tel.gauge("serve_queue_wait_ms", qw_ms, trace=r.trace,
                          tier=r.tier, replica=self.replica)
                if not met and fault is None:
                    tel.counter("serve_deadline_miss", tier=r.tier,
                                replica=self.replica)
                if r.ctx is not None:
                    # The scheduler hop's spans, parented under the
                    # frontend's context: queue wait (arrival ->
                    # dispatch) and, when miss repair pushed the request
                    # back, the deferred slice of that wait.
                    tel.span_event("sched_queue", r.t_arrival,
                                   t0 - r.t_arrival, trace=r.trace,
                                   tier=r.tier, replica=self.replica,
                                   bucket=bucket,
                                   **r.ctx.child("sched").attrs())
                    if r.t_defer is not None:
                        tel.span_event("sched_defer", r.t_defer,
                                       t0 - r.t_defer, trace=r.trace,
                                       **r.ctx.child("sched").attrs())
            if r.future is not None and not r.future.done():
                if fault is not None:
                    r.future.set_result(Reply(
                        status="error", trace=r.trace, tier=r.tier,
                        reason=f"{type(fault).__name__}: {fault}",
                        queue_wait_ms=qw_ms,
                        service_ms=round(svc_s * 1e3, 3),
                        latency_ms=lat_ms, replica=self.replica,
                        model_version=version))
                else:
                    r.future.set_result(Reply(
                        status="ok" if met else "late", trace=r.trace,
                        tier=r.tier, logits=out, queue_wait_ms=qw_ms,
                        service_ms=round(svc_s * 1e3, 3), latency_ms=lat_ms,
                        replica=self.replica, model_version=version))

    def _die(self, exc: Exception) -> None:
        with self._cond:
            self._dead = True
            self._stop = True
            unfinished = list(self._inflight) + list(self._pending)
            self._inflight = ()
            self._pending = []
            self._pending_images = 0
            installs = self._installs
            self._installs = []
            self._cond.notify_all()
        for _, fut in installs:        # a dead replica installs nothing
            if not fut.done():
                fut.set_exception(RuntimeError(
                    f"replica {self.replica} died before install: {exc}"))
        if self.telemetry.enabled:
            self.telemetry.counter("replica_dead", replica=self.replica,
                                   error=type(exc).__name__)
        cb = self.on_death
        if cb is not None:
            cb(self, unfinished, exc)
            return
        for r in unfinished:
            if r.future is not None and not r.future.done():
                r.future.set_result(Reply(
                    status="error", trace=r.trace, tier=r.tier,
                    reason=f"{type(exc).__name__}: {exc}",
                    replica=self.replica))
