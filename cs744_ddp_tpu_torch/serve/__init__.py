"""Single-GPU serving and the serving tier -- the reference package's
``serve/``.

A ladder of CUDA graphs over a fixed set of batch buckets, captured at
startup (``engine``), a bounded-queue micro-batcher that coalesces
concurrent requests into the largest ready bucket (``batcher``),
double-buffered pinned uint8 staging over the training arena (``ingest``),
and a seeded open-loop demo and load generator (``demo``).  The engine
splits issue from completion (``infer_counts_async`` / ``complete``) with
``PIPELINE_SLOTS`` (= 2) dispatches in flight.

The serving tier: a continuous-batching SLO scheduler with priority-tiered
admission and deterministic load shedding, whose worker keeps two
dispatches in flight (``scheduler``), device-pinned engine replicas with
chaos hooks (``replica``) behind a least-loaded router with death
failover (``router``), a socket front-end speaking the reference's
length-prefixed binary protocol byte for byte (``frontend``, ``wire``),
and the load driver that replays a seeded trace against it (``load``).
The reference's warm-start executable cache has no counterpart
(``engine``'s docstring says why).
"""

from .batcher import MicroBatcher, QueueFull, coalesce, plan_batches
from .engine import BUCKETS, DispatchHandle, InferenceEngine
from .frontend import FrontendClient, LoopbackClient, ServingFrontend
from .ingest import StagedIngest
from .replica import EngineReplica
from .router import ReplicaRouter
from .scheduler import (PIPELINE_SLOTS, Reply, SchedRequest, ServiceModel,
                        SLOScheduler, admit, cost_model_weights,
                        make_request, plan_continuous, plan_drain,
                        virtual_requests)

__all__ = [
    "BUCKETS", "DispatchHandle", "EngineReplica", "FrontendClient",
    "InferenceEngine", "LoopbackClient", "MicroBatcher", "PIPELINE_SLOTS",
    "QueueFull", "Reply", "ReplicaRouter", "SLOScheduler", "SchedRequest",
    "ServiceModel", "ServingFrontend", "StagedIngest", "admit", "coalesce",
    "cost_model_weights", "make_request", "plan_batches", "plan_continuous",
    "plan_drain", "virtual_requests",
]
