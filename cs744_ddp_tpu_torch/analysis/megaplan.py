"""Closed-form feasibility planner for a K-epoch mega-program: the
reference package's ``analysis/megaplan.py``, with the H100's 80 GB as
its budget and the port's memory certificate as its input.

A mega-program fuses K whole epochs (train windows, eval, the metrics
ring) into ONE dispatch, collapsing the per-epoch host round-trips
(:func:`dispatch.epoch_round_trip_bound`) to the O(1) of
:func:`dispatch.mega_round_trip_bound`.  The blocking question is sizing:
every staged epoch parks its uint8 batches and its ring rows in device
memory for the whole dispatch, so K is bounded by the card.  This module
answers ``max_feasible_K`` in closed form, composing:

- the window program's memory certificate (:func:`memlife.mem_report`
  of one replay of the train window on meta tensors, ``audit.
  train_program``): the state bytes and the transient peak the step
  needs on top of them;
- the ring carry growth model (one ``(N_METRICS,)`` f32 row per step,
  :mod:`obs.ringbuf`: a K-epoch ring must hold every row until the single
  drain);
- the staging slab: ``ceil(nbatches/window) * window`` per-rank batches
  per epoch (window padding included).

All byte models are per RANK: the slab and labels are data-sharded
(``global_batch / world`` rows a rank), the state and ring replicated.
``plan_k_epochs`` is pure arithmetic; ``max_feasible_K`` traces the real
window program for its state and transient bytes, then delegates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import costmodel, dispatch, memlife
from ..obs import ringbuf

#: CIFAR-10 sample footprint on the stage path: u8 HWC image + a label.
#: The ingest contract keeps images uint8 end to end, so the staged slab is
#: 1 byte/px (the reference's 4-byte label, which its plan counts).
IMG_BYTES = 32 * 32 * 3
LABEL_BYTES = 4

#: One ring row per step: N_METRICS f32 columns.
RING_ROW_BYTES = 4 * ringbuf.N_METRICS
#: The ring's write counter (the port's is int64).
RING_COUNTER_BYTES = 8

#: CIFAR-10 train-split size, the default epoch length numerator.
TRAIN_EXAMPLES = 50_000


@dataclass
class KEpochPlan:
    """Feasibility certificate for fusing K epochs into one dispatch."""

    model: str
    world: int
    window: int
    global_batch: int
    nbatches: int                    # full batches per epoch
    hbm_budget_bytes: int
    state_bytes: int                 # donated train state, replicated
    transient_bytes: int             # window-program compute peak
    fixed_bytes: int                 # K-independent residency
    slab_bytes_per_epoch: int        # staged u8 images + labels, a rank
    ring_bytes_per_epoch: int        # metric rows appended per epoch
    per_epoch_bytes: int
    max_k: int
    windowed_round_trips_per_epoch: int
    mega_round_trips: int            # for max_k epochs fused into one
    notes: List[str] = field(default_factory=list)

    @property
    def round_trips_saved(self) -> int:
        """Host round-trips the max-K mega-program erases vs dispatching
        the same epochs down the windowed path."""
        if self.max_k <= 0:
            return 0
        return (self.max_k * self.windowed_round_trips_per_epoch
                - self.mega_round_trips)

    def to_dict(self) -> Dict:
        return {
            "model": self.model,
            "world": self.world,
            "window": self.window,
            "global_batch": self.global_batch,
            "nbatches": self.nbatches,
            "hbm_budget_mib": round(self.hbm_budget_bytes / 2**20, 1),
            "state_mib": round(self.state_bytes / 2**20, 3),
            "transient_mib": round(self.transient_bytes / 2**20, 3),
            "fixed_mib": round(self.fixed_bytes / 2**20, 3),
            "slab_mib_per_epoch": round(
                self.slab_bytes_per_epoch / 2**20, 3),
            "ring_kib_per_epoch": round(
                self.ring_bytes_per_epoch / 2**10, 3),
            "max_k": self.max_k,
            "windowed_round_trips_per_epoch":
                self.windowed_round_trips_per_epoch,
            "mega_round_trips": self.mega_round_trips,
            "round_trips_saved": self.round_trips_saved,
            "notes": list(self.notes),
        }


def ring_bytes_for_steps(steps: int) -> int:
    """Ring rows for ``steps`` scanned steps with no wraparound — the
    K-epoch ring must keep every row until its single drain."""
    return steps * RING_ROW_BYTES


def slab_bytes_per_epoch(nbatches: int, window: int, global_batch: int,
                         world: int) -> int:
    """Per-rank staged bytes for one epoch: windows are cut at WINDOW
    boundaries, so the stage pads to ``ceil(nbatches/window) * window``
    batches of data-sharded u8 images + i32 labels."""
    if nbatches <= 0 or window <= 0 or world <= 0:
        raise ValueError(f"bad slab query: nbatches={nbatches} "
                         f"window={window} world={world}")
    padded_steps = math.ceil(nbatches / window) * window
    per_chip_batch = max(1, global_batch // world)
    return padded_steps * per_chip_batch * (IMG_BYTES + LABEL_BYTES)


def plan_k_epochs(*, model: str = "vgg11", world: int = 4, window: int = 20,
                  global_batch: int = 256, nbatches: Optional[int] = None,
                  state_bytes: int, transient_bytes: int = 0,
                  hbm_budget_bytes: Optional[int] = None) -> KEpochPlan:
    """The closed form.  K-independent residency = state + the window
    transient peak + the ring counter; each staged epoch adds its slab
    and its ring rows.  ``max_k`` is the largest K whose total fits the
    budget (0 when even the fixed residency does not fit)."""
    budget = (costmodel.H100_HBM_CAPACITY_BYTES
              if hbm_budget_bytes is None else hbm_budget_bytes)
    if nbatches is None:
        nbatches = max(1, TRAIN_EXAMPLES // global_batch)
    fixed = state_bytes + transient_bytes + RING_COUNTER_BYTES
    slab = slab_bytes_per_epoch(nbatches, window, global_batch, world)
    ring = ring_bytes_for_steps(nbatches)
    per_epoch = slab + ring
    max_k = max(0, (budget - fixed) // per_epoch) if per_epoch else 0
    plan = KEpochPlan(
        model=model, world=world, window=window,
        global_batch=global_batch, nbatches=nbatches,
        hbm_budget_bytes=budget, state_bytes=state_bytes,
        transient_bytes=transient_bytes, fixed_bytes=fixed,
        slab_bytes_per_epoch=slab, ring_bytes_per_epoch=ring,
        per_epoch_bytes=per_epoch, max_k=int(max_k),
        windowed_round_trips_per_epoch=dispatch.epoch_round_trip_bound(
            "window", nbatches, window, include_eval=True),
        mega_round_trips=dispatch.mega_round_trip_bound(
            int(max_k), include_eval=True))
    if max_k <= 0:
        plan.notes.append(
            f"infeasible: fixed residency {fixed} B + one epoch "
            f"{per_epoch} B exceed the {budget} B budget")
    return plan


def window_mem_report(model: str = "vgg11", *, world: int = 4,
                      window: int = 20, global_batch: int = 256,
                      strategy: str = "ddp", metrics_ring: bool = True,
                      precision: str = "f32") -> memlife.MemReport:
    """The memory certificate of one replay of the train window (the
    program the audit zoo certifies), with its state leaves' bytes in
    ``state_bytes``."""
    from . import audit
    program = audit.train_program(
        model, strategy if world > 1 else "single", "window", world=world,
        global_batch=global_batch, window=window, precision=precision,
        metrics_ring=metrics_ring)
    return audit.trace_program(program)[0].mem


def state_bytes_for(model: str, *, world: int = 4,
                    strategy: str = "ddp") -> int:
    """Carried train-state bytes (parameters, BN buffers, momentum, comm
    state) of one rank, on meta tensors: the replicated, K-independent
    carry."""
    from ..parallel import get_strategy
    from ..train import step as steplib
    strat = get_strategy(strategy if world > 1 else "single")
    state = steplib.init_train_state(costmodel.meta_model(model), strat)
    return sum(t.numel() * t.element_size()
               for t in steplib.state_tensors(state))


def max_feasible_K(model: str = "vgg11", world: int = 4, window: int = 20,
                   hbm_budget_bytes: Optional[int] = None, *,
                   global_batch: int = 256, nbatches: Optional[int] = None,
                   strategy: str = "ddp",
                   window_report: Optional[memlife.MemReport] = None,
                   ) -> int:
    """The go/no-go number: the largest K epochs of ``model`` at
    ``world`` ranks and ``window``-step windows that fit one card's
    budget.  Tracing the window (for the transient peak) is skipped when
    the caller supplies ``window_report``."""
    return plan_feasibility(
        model, world, window, hbm_budget_bytes, global_batch=global_batch,
        nbatches=nbatches, strategy=strategy,
        window_report=window_report).max_k


def plan_feasibility(model: str = "vgg11", world: int = 4, window: int = 20,
                     hbm_budget_bytes: Optional[int] = None, *,
                     global_batch: int = 256,
                     nbatches: Optional[int] = None, strategy: str = "ddp",
                     window_report: Optional[memlife.MemReport] = None,
                     ) -> KEpochPlan:
    """Full :class:`KEpochPlan` behind :func:`max_feasible_K`."""
    if window_report is None:
        window_report = window_mem_report(
            model, world=world, window=window, global_batch=global_batch,
            strategy=strategy)
    plan = plan_k_epochs(
        model=model, world=world, window=window, global_batch=global_batch,
        nbatches=nbatches,
        state_bytes=state_bytes_for(model, world=world, strategy=strategy),
        transient_bytes=window_report.transient_peak_bytes,
        hbm_budget_bytes=hbm_budget_bytes)
    plan.notes.append(
        f"transient peak from {window_report.name}: "
        f"{window_report.transient_peak_bytes} B (the tensors of one "
        f"replay on meta tensors; no workspace, no allocator rounding)")
    return plan
