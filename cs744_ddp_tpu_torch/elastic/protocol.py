"""Elastic resume planning: map a checkpoint taken at world=N onto world=M.

A copy of the reference package's ``elastic/protocol.py`` (pure NumPy and
Python).  The layer rides one invariant of ``data/sharding.py``: the
canonical epoch order is a pure function of (seed, epoch), so "which
examples has the run consumed" is world-independent, and a resume plan only
has to translate the step counter between batch geometries.

Two declared protocols:

* ``strong`` — the global batch is pinned and re-bucketed across the new
  world.  Under the microshard step (``step_elastic.py``) the update is
  bitwise world-invariant, so the step counter carries over unchanged:
  ``start_step = step``, zero replay.
* ``weak``   — the PER-RANK batch is pinned, so the global batch scales with
  the world.  Progress is measured in examples; the new step counter is
  ``examples_done // new_global_batch`` (floor), which re-processes up to one
  new batch of examples rather than skipping any; the replayed-example count
  is reported in the plan.

``world_of`` is the compatibility seam: a sidecar without a ``world`` key
restores as ``world=1`` with a one-time warning.  ``rank_data_keys`` and
``validate_rank_keys`` live beside the sampler and the checkpoints
(``data/sharding.py``, ``train/checkpoint.py``) and are re-exported here.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

from ..data.sharding import rank_data_keys
from ..train.checkpoint import validate_rank_keys

PROTOCOLS = ("weak", "strong")

_warned_missing_world = False


class ElasticConfig(NamedTuple):
    """Elastic-mode knobs carried by the Trainer.

    protocol    : "strong" (pinned global batch, bitwise world-invariant
                  update) or "weak" (pinned per-rank batch).
    microshards : S — the fixed decomposition of every strong-protocol
                  global batch.  A power of two that divides the global
                  batch; every world M with M | S runs the SAME
                  per-microshard math (rank r computes S/M microshards).
    """

    protocol: str = "strong"
    microshards: int = 4


class ResumePlan(NamedTuple):
    """The output of ``plan_resume``: everything the trainer needs to
    continue a run at a different world size."""

    protocol: str
    old_world: int
    new_world: int
    old_global_batch: int
    new_global_batch: int
    start_epoch: int
    start_step: int
    examples_replayed: int  # weak protocol floor-rounding; 0 under strong
    steps_lost: int         # completed old steps whose work is re-executed


def flat_meta(meta: Optional[dict]) -> dict:
    """One flat view over both sidecar shapes: the mid-epoch sidecar nests
    the topology and data-order keys under ``data_order``, the epoch
    sidecar keeps them top-level.  Returns {} for None."""
    if not meta:
        return {}
    flat = {k: v for k, v in meta.items() if k != "data_order"}
    flat.update(meta.get("data_order") or {})
    return flat


def world_of(meta: Optional[dict]) -> int:
    """The world size recorded in checkpoint metadata; a sidecar without
    one restores as world=1, warning once per process."""
    global _warned_missing_world
    if meta and "world" in meta:
        return int(meta["world"])
    if not _warned_missing_world:
        _warned_missing_world = True
        warnings.warn(
            "checkpoint metadata carries no world size (pre-elastic "
            "format); assuming world=1 — re-save to record topology",
            stacklevel=2)
    return 1


def plan_resume(meta: Optional[dict], new_world: int, *,
                protocol: Optional[str] = None,
                microshards: Optional[int] = None,
                default_global_batch: Optional[int] = None) -> ResumePlan:
    """Translate checkpoint progress at ``world_of(meta)`` into a start
    position at ``new_world`` under the declared protocol."""
    meta = meta or {}
    old_world = world_of(meta)
    proto = protocol or meta.get("protocol") or "strong"
    if proto not in PROTOCOLS:
        raise ValueError(f"unknown elastic protocol {proto!r}; "
                         f"expected one of {PROTOCOLS}")
    if new_world < 1:
        raise ValueError(f"new world must be >= 1, got {new_world}")
    old_gb = meta.get("global_batch", default_global_batch)
    if old_gb is None:
        raise ValueError("checkpoint metadata carries no global_batch and "
                         "no default was provided")
    old_gb = int(old_gb)
    epoch = int(meta.get("epoch", 0))
    step = int(meta.get("step", 0))

    if proto == "strong":
        if old_gb % new_world:
            raise ValueError(
                f"strong scaling: global batch {old_gb} not divisible by "
                f"new world {new_world}")
        if microshards is not None:
            if microshards % new_world:
                raise ValueError(
                    f"strong scaling: microshards {microshards} not "
                    f"divisible by new world {new_world}")
            if old_gb % microshards:
                raise ValueError(
                    f"strong scaling: global batch {old_gb} not divisible "
                    f"by microshards {microshards}")
        # Global batch b covers canonical positions [b*B, (b+1)*B) at
        # EVERY world size, so the step counter is world-invariant.
        return ResumePlan(proto, old_world, new_world, old_gb, old_gb,
                          epoch, step, 0, 0)

    # weak scaling: pinned per-rank batch, example-measured progress.
    if old_gb % old_world:
        raise ValueError(f"weak scaling: saved global batch {old_gb} not "
                         f"divisible by saved world {old_world}")
    per_chip = old_gb // old_world
    new_gb = per_chip * new_world
    examples_done = step * old_gb
    start_step = examples_done // new_gb
    replayed = examples_done - start_step * new_gb
    steps_lost = step - (start_step * new_gb) // old_gb
    return ResumePlan(proto, old_world, new_world, old_gb, new_gb,
                      epoch, start_step, replayed, steps_lost)


def plan_shrink(world: int, global_batch: int, *,
                microshards: Optional[int] = None) -> int:
    """The shrink rung of the degradation ladder: the LARGEST world
    w <= world-1 the batch geometry admits (global batch divisible, and
    under strong scaling w | microshards).  Always reaches 1."""
    if world < 2:
        raise ValueError(f"cannot shrink below world 1 (world={world})")
    for w in range(world - 1, 0, -1):
        if global_batch % w:
            continue
        if microshards is not None and microshards % w:
            continue
        return w
    return 1


__all__ = ["ElasticConfig", "PROTOCOLS", "ResumePlan", "flat_meta",
           "plan_resume", "plan_shrink", "rank_data_keys",
           "validate_rank_keys", "world_of"]
