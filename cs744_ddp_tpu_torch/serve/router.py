"""Least-loaded router over N independent engine replicas -- the
reference package's ``serve/router.py``, framework-free and copied.

Routing signal: each replica's ``outstanding_s()`` — predicted seconds
of queued + in-flight work from its ``ServiceModel`` (a per-bucket prior
corrected by the measured device-occupancy EWMA), so the
router is load-aware from the first request and converges to measured
reality.  Ties break by replica index: routing over equal loads is
deterministic.

Failover contract (pinned in tests): when a replica dies mid-flight,
every unfinished request it held — in-flight AND queued — is re-enqueued
on the least-loaded survivor with its original trace id, deadline, and
Future intact; requests that cannot be placed anywhere resolve as
explicit ``error`` replies.  An accepted request always gets exactly one
reply; nothing is silently dropped.  The dead replica's own dispatch
still in flight on the device is fenced by its worker after the hand-off
and its result discarded (``SLOScheduler._die``), so no future is
resolved twice.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..obs import NULL
from .batcher import QueueFull
from .scheduler import Reply, SchedRequest, make_request


class ReplicaRouter:
    """Route requests to the least-loaded live replica.

    ``replicas`` may be ``EngineReplica`` objects or bare ``SLOScheduler``
    instances (anything exposing ``scheduler`` or being one) — tests
    exercise the routing policy against stub schedulers.
    """

    _lock_owned = ("_routed", "_failovers")

    def __init__(self, replicas, *, telemetry=None):
        self.replicas = tuple(replicas)
        if not self.replicas:
            raise ValueError("need at least one replica")
        self.telemetry = telemetry if telemetry is not None else NULL
        self._scheds = tuple(getattr(r, "scheduler", r)
                             for r in self.replicas)
        self._lock = threading.Lock()
        self._routed = 0
        self._failovers = 0
        for sched in self._scheds:
            sched.on_death = self._handle_death

    @property
    def max_batch(self) -> int:
        return self._scheds[0].engine.max_batch

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaRouter":
        for r in self.replicas:
            r.start()
        return self

    def stop(self) -> None:
        for r in self.replicas:
            r.stop()

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- routing -----------------------------------------------------------

    def _ranked(self, exclude=None) -> List:
        """Live schedulers, least predicted outstanding work first;
        deterministic tiebreak by replica index."""
        live = [s for s in self._scheds
                if s.alive and s is not exclude]
        return sorted(live, key=lambda s: (s.outstanding_s(), s.replica))

    def submit(self, images, labels=None, *, tier: int = 0,
               slo_ms: Optional[float] = None, ctx=None):
        """Admit one request onto the least-loaded replica; falls through
        to the next-loaded on ``QueueFull``.  Raises ``QueueFull`` with
        the smallest retry hint when every replica is saturated, or
        ``RuntimeError`` when none is alive.  ``ctx`` (upstream
        ``TraceContext``) rides the request into dispatch-time spans —
        failover re-placement keeps it, like the trace id."""
        req = make_request(images, labels, tier=tier, slo_ms=slo_ms,
                           max_batch=self.max_batch, ctx=ctx)
        return self._place(req)

    def _place(self, req: SchedRequest, exclude=None):
        tel = self.telemetry
        hint = None
        for sched in self._ranked(exclude=exclude):
            try:
                fut = sched.enqueue(req)
            except QueueFull as e:
                h = getattr(e, "retry_after_ms", 0.0)
                hint = h if hint is None else min(hint, h)
                continue
            except RuntimeError:
                continue          # died between ranking and enqueue
            with self._lock:
                self._routed += 1
            if tel.enabled:
                tel.gauge("replica_outstanding_s",
                          round(sched.outstanding_s(), 6),
                          replica=sched.replica)
            return fut
        if hint is not None:
            raise QueueFull("all replicas at capacity",
                            retry_after_ms=hint)
        raise RuntimeError("no live replicas")

    # -- failover ----------------------------------------------------------

    def _handle_death(self, dead_sched, unfinished, exc) -> None:
        """``on_death`` hook: re-place every unfinished request from the
        dead replica; unplaceable ones resolve as explicit errors."""
        tel = self.telemetry
        if tel.enabled:
            tel.counter("replica_death", replica=dead_sched.replica,
                        error=type(exc).__name__)
        for req in unfinished:
            try:
                self._place(req, exclude=dead_sched)
            except (QueueFull, RuntimeError) as e2:
                if req.future is not None and not req.future.done():
                    req.future.set_result(Reply(
                        status="error", trace=req.trace, tier=req.tier,
                        reason=f"failover failed: {e2}",
                        replica=dead_sched.replica))
                continue
            with self._lock:
                self._failovers += 1
            if tel.enabled:
                tel.counter("serve_failover", tier=req.tier,
                            replica=dead_sched.replica)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            routed, failovers = self._routed, self._failovers
        return {
            "routed": routed,
            "failovers": failovers,
            "replicas": [{
                "replica": s.replica,
                "alive": s.alive,
                "weights_version": int(getattr(
                    getattr(s, "engine", None), "weights_version", -1)),
                "outstanding_s": round(s.outstanding_s(), 6),
                "svc_ms": {b: round(s.svc.predict(b) * 1e3, 4)
                           for b in s.buckets},
            } for s in self._scheds],
        }
