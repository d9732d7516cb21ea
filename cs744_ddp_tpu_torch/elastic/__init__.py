"""Elastic training: checkpoint-based world-resize resume (the reference
package's ``elastic/``).

A run interrupted at world=N resumes at world=M with re-sharded data order:

* ``protocol``     — resume planning (weak/strong scaling), shrink
                     planning, the per-rank data-order keys and the
                     ``world_of`` default;
* ``step_elastic`` — the strong-scaling microshard step, whose update is
                     bitwise world-invariant;
* ``coordinator``  — membership and the retry -> shrink -> single-rank
                     degradation ladder over the rank-level chaos sites,
                     one launch of ``world`` processes per generation;
* ``straggler``    — EWMA-vs-peers outlier detection over the per-rank
                     step times the trainer exchanges at each window
                     boundary.
"""

from .coordinator import ElasticCoordinator, Generation          # noqa: F401
from .protocol import (ElasticConfig, PROTOCOLS, ResumePlan,     # noqa: F401
                       flat_meta, plan_resume, plan_shrink,
                       rank_data_keys, validate_rank_keys, world_of)
from .step_elastic import MicroshardStep, tree_combine_mean      # noqa: F401
from .straggler import StragglerDetector                         # noqa: F401

__all__ = [
    "ElasticConfig", "ElasticCoordinator", "Generation", "MicroshardStep",
    "PROTOCOLS", "ResumePlan", "StragglerDetector", "flat_meta",
    "plan_resume", "plan_shrink", "rank_data_keys", "tree_combine_mean",
    "validate_rank_keys", "world_of",
]
