"""Single-GPU serving fast path -- the engine slice of the reference
package's ``serve/``.

A ladder of CUDA graphs over a fixed set of batch buckets, captured at
startup (``engine``), a bounded-queue micro-batcher that coalesces
concurrent requests into the largest ready bucket (``batcher``),
double-buffered pinned uint8 staging over the training arena (``ingest``),
and a seeded open-loop demo and load generator (``demo``).  The engine
splits issue from completion (``infer_counts_async`` / ``complete``) with
``PIPELINE_SLOTS`` (= 2) dispatches in flight.  The reference's serving
tier (scheduler, router, replicas, front-end) is ROADMAP queue 1 item 5b;
its warm-start executable cache has no counterpart (``engine``'s
docstring says why).
"""

from .batcher import MicroBatcher, QueueFull, coalesce, plan_batches
from .engine import BUCKETS, PIPELINE_SLOTS, DispatchHandle, InferenceEngine
from .ingest import StagedIngest

__all__ = [
    "BUCKETS", "DispatchHandle", "InferenceEngine", "MicroBatcher",
    "PIPELINE_SLOTS", "QueueFull", "StagedIngest", "coalesce",
    "plan_batches",
]
