"""One serving replica: a device-pinned engine + its SLO scheduler -- the
reference package's ``serve/replica.py``.

Each replica owns an ``InferenceEngine`` on one ``torch.device`` (its
ladder of CUDA graphs captured there, the weights resident there;
``device=None`` is the card, as the engine's is) plus a ``ServiceModel``
and an ``SLOScheduler`` worker thread, which replays, records and stages
with that card as its current device.  Replicas are independent — no
shared queue, no shared graphs, streams or staging arenas — so the router
can treat them as interchangeable, two of them can share one card, and
one replica dying (the ``replica_death`` chaos site) takes down exactly
its own worker.  Every replica's ``startup()`` captures its whole ladder
before any worker starts (``start`` refuses an uncaptured card ladder):
no capture runs while another thread replays.

Chaos wiring: the scheduler's ``dispatch_hook`` fires this replica's
sites against its OWN dispatch counter — ``slow_replica:STEP:REPLICA``
stalls dispatch STEP by ``slow_stall_s`` (a straggler),
``replica_death:STEP:REPLICA`` raises ``ChaosError`` inside the worker,
exercising the router's failover path (no accepted request is silently
dropped), ``swap_mid_batch:STEP:REPLICA`` calls the attached
``WeightWatcher``'s non-blocking poll (``swap_probe``) inside dispatch
STEP's hook, racing a pending publish against that dispatch: the racing
dispatch is answered wholly by the old weights, the next by the new.

``dispatch_fault:STEP:REPLICA`` fires on the scheduler's COMPLETION
hook instead: dispatch STEP's device result is discarded at its fence
point (with the pipelined worker, while dispatch STEP+1 is already in
flight).  The scheduler isolates the fault — STEP's requests get
explicit error replies, STEP+1 resolves normally on the same weights.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ..ft.chaos import NULL_CHAOS, ChaosError
from ..obs import NULL
from .engine import BUCKETS, InferenceEngine
from .scheduler import ServiceModel, SLOScheduler, cost_model_weights


class EngineReplica:
    """Engine + scheduler pinned to one device.

    ``cost_prior=True`` weighs each bucket of the scheduler's
    ``ServiceModel`` by its rung's flops (``cost_model_weights``); the
    default prior weighs it by its size."""

    def __init__(self, index: int, model: str = "vgg11", *,
                 device=None, buckets: Sequence[int] = BUCKETS,
                 precision: str = "f32", seed: int = 0, state=None,
                 telemetry=None, cache_dir: Optional[str] = None,
                 svc: Optional[ServiceModel] = None, cost_prior: bool = False,
                 shed: bool = True, max_queue_images: int = 1024,
                 chaos=NULL_CHAOS, slow_stall_s: float = 0.25,
                 use_staging: bool = True,
                 pipeline: Optional[bool] = None):
        tel = telemetry if telemetry is not None else NULL
        self.index = int(index)
        self.telemetry = tel
        self.chaos = chaos
        self.slow_stall_s = float(slow_stall_s)
        self._captured = False
        # Non-blocking weight-watcher poll (publish.WeightWatcher attaches
        # it); the swap_mid_batch chaos site calls it inside the dispatch
        # hook to race a publish against a live dispatch.
        self.swap_probe = None
        self.engine = InferenceEngine(
            model, buckets=buckets, precisions=(precision,), state=state,
            seed=seed, telemetry=tel, cache_dir=cache_dir, device=device,
            use_staging=use_staging)
        if svc is None:
            weights = cost_model_weights(self.engine, precision) \
                if cost_prior else None
            svc = ServiceModel(self.engine.buckets, weights=weights)
        self.scheduler = SLOScheduler(
            self.engine, svc=svc, shed=shed,
            max_queue_images=max_queue_images, precision=precision,
            telemetry=tel, replica=self.index,
            dispatch_hook=self._chaos_hook,
            complete_hook=self._complete_chaos_hook,
            pipeline=pipeline)

    def _chaos_hook(self, dispatch_no: int, bucket: int) -> None:
        ch = self.chaos
        if not ch.enabled:
            return
        if dispatch_no in ch.steps("slow_replica") \
                and ch.seed_of("slow_replica", dispatch_no) == self.index \
                and ch.fire("slow_replica", dispatch_no):
            self._note_chaos("slow_replica", dispatch_no)
            time.sleep(self.slow_stall_s)
        if dispatch_no in ch.steps("swap_mid_batch") \
                and ch.seed_of("swap_mid_batch", dispatch_no) == self.index \
                and ch.fire("swap_mid_batch", dispatch_no) \
                and self.swap_probe is not None:
            self._note_chaos("swap_mid_batch", dispatch_no)
            self.swap_probe()
        if dispatch_no in ch.steps("replica_death") \
                and ch.seed_of("replica_death", dispatch_no) == self.index \
                and ch.fire("replica_death", dispatch_no):
            self._note_chaos("replica_death", dispatch_no)
            raise ChaosError(
                f"chaos: replica {self.index} died at dispatch "
                f"{dispatch_no} (bucket {bucket})")

    def _complete_chaos_hook(self, dispatch_no: int, bucket: int) -> None:
        """Completion-side chaos: ``dispatch_fault`` discards dispatch
        ``dispatch_no``'s result at its fence point.  The scheduler
        isolates the raise to that one batch (explicit error replies,
        worker keeps serving) — unlike ``replica_death``, which kills the
        worker from the issue-side hook."""
        ch = self.chaos
        if not ch.enabled:
            return
        if dispatch_no in ch.steps("dispatch_fault") \
                and ch.seed_of("dispatch_fault", dispatch_no) == self.index \
                and ch.fire("dispatch_fault", dispatch_no):
            self._note_chaos("dispatch_fault", dispatch_no)
            raise ChaosError(
                f"chaos: replica {self.index} dispatch {dispatch_no} "
                f"(bucket {bucket}) faulted at completion")

    def _note_chaos(self, site: str, dispatch_no: int) -> None:
        """Chaos firings are themselves telemetry: trace aggregation
        attributes orphaned spans (a death's unfinished requests) and
        straggler stalls to the injection that caused them, instead of
        leaving them indistinguishable from real faults."""
        if self.telemetry.enabled:
            self.telemetry.counter("chaos_fired", site=site,
                                   replica=self.index, dispatch=dispatch_no)

    # -- passthroughs ------------------------------------------------------

    def startup(self) -> dict:
        """Capture the engine's whole ladder (before any worker starts);
        the engine's startup report."""
        report = self.engine.startup()
        self._captured = True
        return report

    def start(self) -> "EngineReplica":
        if self.engine.device.type == "cuda" and not self._captured:
            raise RuntimeError(
                f"replica {self.index}: startup() first: its ladder of CUDA "
                f"graphs is captured before any worker starts, so that no "
                f"capture runs while another thread replays")
        self.scheduler.start()
        return self

    def stop(self) -> None:
        self.scheduler.stop()

    def __enter__(self) -> "EngineReplica":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def alive(self) -> bool:
        return self.scheduler.alive

    def outstanding_s(self) -> float:
        return self.scheduler.outstanding_s()

    def enqueue(self, req):
        return self.scheduler.enqueue(req)
