"""Static host-round-trip certifier: the reference package's
``analysis/dispatch.py`` (its closed forms copied) over the port's window
structure.

``host_round_trips`` is a COUNTED quantity (the Trainer's ``_fetch``
counter and its telemetry counter, ``train/loop.py::_count_round_trip``);
this module derives the same number STATICALLY, a closed form over the
trainer's dispatch structure:

* ``step`` path (``--profile-phases``): one blocking ``_step_fetch`` per
  batch (``step_fetch``), the ragged tail batch among them, plus one
  ``eval`` fetch per ``test_model()``.  The per-step path also fetches its
  forward-only program once a batch (``forward_fetch``), which the
  reference fetches uncounted: it is not one of ``TRIP_SITES``;
* ``window``/``host_window`` paths: one fetch per window (``window_drain``
  with the metric ring, ``window_fetch`` without), windows cut at WINDOW
  boundaries, so ``ceil(nbatches / window)`` per epoch, plus the tail
  batch (one eager step) and the eval as above.  The per-step rows the
  window writes are device-side ring updates: the audit's host-sync rule
  certifies the captured step has no host transfer, which is what makes
  the closed form exact rather than an estimate.

Where the reference reads a scan's trip count from the HLO, the port's
window is ``w`` replays of one captured step with one fetch after them:
``certify_program`` runs a ``TrainWindow`` of the zoo with its step
replaced by a counter and checks that a window dispatch replays its step
``window`` times and returns one tensor to fetch, and that the step keeps
its state in place (the audit's ``donation`` record): a step that rebinds
its state could not be replayed at all.

``certify_zoo`` runs the certificate over an audited zoo
(``audit.audit_zoo``); tests pin the static bound against the live
counter EXACTLY for every path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .pylint_rules import LintFinding

#: Counter sites the trainer attributes round-trips to (the reference's).
TRIP_SITES = ("step_fetch", "window_fetch", "window_drain", "eval")

#: Paths whose epoch cost is one fetch per WINDOW dispatch.
WINDOWED_PATHS = ("window", "host_window")

#: Serving-ladder zoo prefix (``serve/b{bucket}/{precision}``).  A serving
#: rung must be STRAIGHT-LINE: one dispatch = one replay = one fetch.  That
#: is the premise of the pipelined scheduler's two-in-flight bound.
SERVING_PATHS = ("serve",)


def serving_inflight_bound() -> int:
    """The static per-replica in-flight dispatch bound (= the engine's
    ``PIPELINE_SLOTS`` = the ``StagedIngest`` arena depth).  Tests pin the
    runtime occupancy (``max_serving_inflight``) against this exactly."""
    from ..serve.engine import PIPELINE_SLOTS
    return PIPELINE_SLOTS


def max_serving_inflight(records: Iterable[Dict]) -> int:
    """Max observed pipeline occupancy from a recording telemetry's
    ``serve_inflight`` gauges — the runtime half of the bound pin (0 when
    the run never pipelined)."""
    m = 0
    for r in records:
        if r.get("kind") == "gauge" and r.get("name") == "serve_inflight":
            m = max(m, int(r.get("value", 0)))
    return m


def epoch_round_trip_bound(path: str, nbatches: int, window: int = 0, *,
                           tail_batch: bool = False,
                           include_eval: bool = False) -> int:
    """Closed-form host round-trips for ONE epoch of ``nbatches`` full
    batches on ``path`` (+1 for a ragged tail batch, which always runs
    per-step; +1 for the post-epoch eval fetch).  This is an upper bound
    that the runtime counter meets exactly: every dispatch fetches once
    and nothing else touches the host (audited)."""
    if nbatches < 0 or (path in WINDOWED_PATHS and window <= 0):
        raise ValueError(f"bad bound query: path={path!r} "
                         f"nbatches={nbatches} window={window}")
    if path == "step":
        trips = nbatches
    elif path in WINDOWED_PATHS:
        trips = math.ceil(nbatches / window)
    elif path == "eval":
        trips = 1 if nbatches else 0
    else:
        raise ValueError(f"unknown dispatch path {path!r}")
    return trips + (1 if tail_batch else 0) + (1 if include_eval else 0)


def mega_round_trip_bound(k_epochs: int, *, include_eval: bool = True) -> int:
    """Closed-form host round-trips for a K-epoch MEGA-program: the whole
    run is ONE dispatch whose ring drain is the single fetch, plus the
    final eval fetch when the run evals on device.  The windowed baseline
    pays ``k_epochs x epoch_round_trip_bound(...)``; this is the O(1) the
    mega-program buys, and :func:`megaplan.plan_k_epochs` certifies how
    large K can grow before HBM takes it back."""
    if k_epochs <= 0:
        return 0
    return 1 + (1 if include_eval else 0)


@dataclass
class ProgramCert:
    """Static dispatch facts for one program of the zoo."""

    program: str                  # zoo name, e.g. "train/window/ddp"
    path: str                     # "step" | "window" | "host_window" | ...
    window: Optional[int]         # replays of the step per fetch
    fetches: int                  # tensors a dispatch returns to fetch
    in_place: bool                # the state kept its storage


def _split_zoo_name(name: str) -> Tuple[str, str]:
    """zoo program name -> (path, strategy)."""
    parts = name.split("/")
    if parts[0] == "train" and len(parts) == 3:
        return parts[1], parts[2]
    if parts[0] == "eval":
        return "eval", "eval"
    return parts[0], "/".join(parts[1:])


def certify_program(program, report) -> ProgramCert:
    """The facts of one ``audit.Program`` and its ``AuditReport``: a
    windowed program's window is dispatched once with its step replaced
    by a counter (the state is not touched)."""
    path, _ = _split_zoo_name(program.name)
    window, fetches = None, 1
    win = program.window
    if win is not None:
        replays = []
        step, win.step = win.step, lambda: replays.append(1)
        writes = None if win.ring is None else win.ring.writes
        try:
            out = win(0, 0, win.images.shape[0])
        finally:
            win.step = step
            if writes is not None:
                win.ring.writes = writes
        window = len(replays)
        fetches = 1 if isinstance(out, torch.Tensor) else len(out)
    return ProgramCert(program=program.name, path=path, window=window,
                       fetches=fetches,
                       in_place=report.stats.get("rebound", 0) == 0)


def check_cert(cert: ProgramCert, *, expect_window: Optional[int] = None
               ) -> List[LintFinding]:
    """Static conformance of one program: a windowed program must replay
    the window it claims behind ONE fetch and keep its state in place."""
    findings: List[LintFinding] = []
    if cert.path in WINDOWED_PATHS:
        if cert.window is None:
            findings.append(LintFinding(
                "dispatch-no-window", cert.program, 0,
                f"{cert.program} is not a window of replays: every step "
                f"would round-trip the host"))
        elif expect_window is not None and cert.window != expect_window:
            findings.append(LintFinding(
                "dispatch-window-mismatch", cert.program, 0,
                f"{cert.program} replays its step {cert.window} times a "
                f"dispatch but the trainer dispatches windows of "
                f"{expect_window} — the closed-form round-trip bound "
                f"would be wrong"))
        if cert.fetches != 1:
            findings.append(LintFinding(
                "dispatch-window-mismatch", cert.program, 0,
                f"{cert.program} returns {cert.fetches} tensors a window; "
                f"the bound counts one fetch"))
        if not cert.in_place:
            findings.append(LintFinding(
                "dispatch-state-rebound", cert.program, 0,
                f"{cert.program} rebinds its carried state — a captured "
                f"step replays on the addresses it was captured with"))
    if cert.path in SERVING_PATHS and cert.window is not None:
        findings.append(LintFinding(
            "dispatch-serving-window", cert.program, 0,
            f"{cert.program} replays a window — a serving rung must be "
            f"straight-line (one dispatch = one fetch), or the pipelined "
            f"two-in-flight bound is unsound"))
    return findings


def certify_zoo(result, *, window: int, nbatches: int,
                include_eval: bool = True) -> Dict:
    """The full certificate over an audited zoo (``audit.audit_zoo``):
    per-program window/fetch/in-place facts and the static per-epoch
    round-trip bound for ``nbatches`` full batches, plus any findings."""
    if not result.programs:
        raise ValueError("audit result carries no programs; re-run "
                         "audit_zoo")
    reports = {r.program: r for r in result.reports}
    programs: Dict[str, Dict] = {}
    findings: List[LintFinding] = []
    for name in sorted(result.programs):
        cert = certify_program(result.programs[name], reports[name])
        expect = window if cert.path in WINDOWED_PATHS else None
        findings.extend(check_cert(cert, expect_window=expect))
        entry: Dict = {"path": cert.path, "window": cert.window,
                       "in_place": cert.in_place}
        if cert.path in ("step",) + WINDOWED_PATHS:
            entry["epoch_round_trips"] = epoch_round_trip_bound(
                cert.path, nbatches, window, include_eval=include_eval)
        programs[name] = entry
    return {
        "window": window,
        "nbatches": nbatches,
        "include_eval": include_eval,
        "programs": programs,
        "findings": [{"rule": f.rule, "program": f.path,
                      "message": f.message} for f in findings],
        "clean": not findings,
    }


def count_runtime_trips(records: Iterable[Dict]) -> Dict[str, int]:
    """Per-site totals of the live ``host_round_trips`` counter from a
    recording telemetry's event list."""
    sites: Dict[str, int] = {}
    for r in records:
        if r.get("kind") == "counter" and r.get("name") == "host_round_trips":
            site = r.get("site", "?")
            sites[site] = sites.get(site, 0) + int(r.get("inc", 1))
    return sites


def total_runtime_trips(records: Iterable[Dict]) -> int:
    """The counter's total over ``TRIP_SITES``: the number the static
    bound must meet exactly (the per-step path's ``forward_fetch`` is
    left out, as the reference fetches that program uncounted)."""
    sites = count_runtime_trips(records)
    return sum(sites.get(s, 0) for s in TRIP_SITES)
