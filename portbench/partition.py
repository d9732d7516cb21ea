"""The program's own profiler ranges in the traced epoch, and the per-layer
metrics that read them (``pending/metrics/``).

The program names what its host is doing with ranges on the profiler's
timeline, ``cs744.<name>``: ``stage_epoch``; each window's
``train_window``, inside it ``window_dispatch`` (the window's fills and
graph launches) and ``window_fetch`` (the wait and the copy), then
``after_window`` (the host's work up to the next dispatch); and
``tail_step``, the eager tail with its fetch.  ``Trainer.trace_counts()``
counts fetches, graph replays and captures, eager steps and restages.

``summarize`` reads a traced epoch as ``trace.summarize`` does, and more:
each idle gap is named by the innermost range of either prefix
(``portbench.`` or ``cs744.``) around the host's launch call of the work
that ended it (around the window's end for the last gap, around the
gap's middle where no launch call is known), and put in one of four
parts, which add up to the epoch's wall minus its busy time:

  ``tail``         under ``tail_step``: the eager tail step;
  ``replay``       outside it, ending at a kernel of a graph replay: the
                   gaps between a replayed graph's kernels;
  ``window_edge``  every other gap inside ``portbench.epoch``: the
                   staging, the dispatch's fills, the fetch's copy, the
                   host's work after a window;
  ``harness``      the rest: the benchmark's ``rank_barrier``, the gap
                   before the window's end, anything outside the epoch.

A gap is placed by its launch call, not by its middle, because the
profiler's host and device clocks can drift apart within one epoch (by
milliseconds): a correlation id does not depend on
either clock.  ``summarize`` also totals each ``cs744.`` range (count,
µs, self µs) and counts the kernels stamped more than ``EARLY_US`` before
their own launch call (``misstamped``), the mark of such a drift.

The parts are those of a profiled epoch.  The profiler lengthens the
eager tail, the edges and the gaps between a replay's kernels, so a part
reads more than the same part of an epoch run without it.

The benchmark's own traced epoch (``worker._traced_epoch``) keeps the
trace counts (its ``counters["trainer"]``) but not the profiler's events,
so until the benchmark reads them itself (then ``traced_epoch``,
``rank_entry``, ``wired`` and ``main`` go) these metrics are read by a run
of their own:

    python -m portbench.partition --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell as ``python -m portbench.run ... --trace 1`` does, with
``traced_epoch`` in the worker's place and the pending metrics beside the
others, and prints the result line; each rank's partition, counts and
``misstamped`` go to standard error.
"""

from __future__ import annotations

import contextlib
import functools
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from . import launch, run, trace, worker, yardstick

PROGRAM = "cs744."
PREFIXES = (trace.SPAN, PROGRAM)
PARTS = ("tail", "replay", "window_edge", "harness")
EARLY_US = 5.0
PENDING = run.ROOT / "pending"


def _self_us(ranges: List[tuple]) -> Dict[str, List[float]]:
    """Per range name: [count, total µs, self µs], where self time is a
    range's duration less the union of the ranges of its thread inside
    it."""
    out: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
    for s, e, name, tid in ranges:
        inner = yardstick.busy_us(
            (cs, ce) for cs, ce, cn, ct in ranges
            if ct == tid and s <= cs and ce <= e
            and (cs, ce, cn) != (s, e, name))
        row = out[name]
        row[0] += 1
        row[1] += e - s
        row[2] += e - s - inner
    return dict(out)


def _parse(events):
    """The device's kernels (start, end, name, correlation), the spans of
    either prefix (start, end, full name), the program's ranges (start,
    end, name, thread) and the host's launch calls by correlation (name,
    start, duration), all in µs."""
    from torch.autograd import DeviceType
    kernels, spans, ranges = [], [], []
    launched: Dict[int, tuple] = {}
    for e in events:
        start = e.start_ns() / 1e3
        dur = e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIXES):
                kernels.append((start, start + dur, name, e.correlation_id()
                                or e.linked_correlation_id()))
        elif name.startswith(PREFIXES):
            spans.append((start, start + dur, name))
            if name.startswith(PROGRAM):
                tid = getattr(e, "start_thread_id", lambda: 0)()
                ranges.append((start, start + dur, name[len(PROGRAM):], tid))
        elif name.startswith("cu"):
            launched[e.correlation_id()] = (name, start, dur)
    return kernels, sorted(spans), ranges, launched


def summarize(events) -> dict:
    """``trace.summarize`` of the events without the program's ranges'
    device shadows (its wall, busy, families and kernels), with ``gaps``
    named by the innermost range of either prefix around what ended them,
    and ``partition`` (µs by part), ``ranges`` (the program's, by name)
    and ``misstamped``."""
    from torch.autograd import DeviceType
    events = [e for e in events if not (
        e.device_type() == DeviceType.CUDA and e.name().startswith(PROGRAM))]
    out = _harness_summarize(events)
    kernels, spans, ranges, launched = _parse(events)
    (ws, we, _), = [s for s in spans if s[2] == trace.SPAN + "window"]
    kernels = sorted(k for k in kernels if k[1] > ws and k[0] < we)
    out["misstamped"] = sum(
        1 for s, _, _, corr in kernels
        if corr in launched and launched[corr][1] - s > EARLY_US)
    out["ranges"] = _self_us([r for r in ranges
                              if r[0] >= ws and r[1] <= we])
    gaps: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    parts = dict.fromkeys(PARTS, 0.0)
    around: Dict[tuple, tuple] = {}    # what ended a gap -> its ranges
    cur = ws
    for s, e, _, corr in kernels + [(we, we, "", None)]:
        if s > cur:
            end = corr is None and s == we
            # The host's time of what ended the gap: the launch call, or
            # the window's end; the gap's middle where neither is known.
            key = ("launch", corr) if corr in launched else \
                ("end", we) if end else ("middle", 0.5 * (cur + s))
            if key not in around:
                t = launched[corr][1] if corr in launched else key[1]
                enclosing = [sp for sp in spans if sp[0] <= t <= sp[1]]
                inner = min(enclosing, key=lambda sp: sp[1] - sp[0])[2] \
                    if enclosing else "outside"
                around[key] = (inner.split(".", 1)[-1],
                               {sp[2] for sp in enclosing})
            inner, names = around[key]
            what = "window end" if end else trace._launch_kind(
                launched.get(corr, (None,))[0])
            row = gaps[f"{inner}: idle before {what}"]
            row[0] += s - cur
            row[1] += 1
            if end or trace.SPAN + "epoch" not in names:
                part = "harness"
            elif PROGRAM + "tail_step" in names:
                part = "tail"
            elif what == "graph replay":
                part = "replay"
            else:
                part = "window_edge"
            parts[part] += s - cur
        cur = max(cur, e)
    out["gaps"] = dict(gaps)
    out["partition"] = parts
    return out


def traced_epoch(trainer, epoch: int, stop, plan: int) -> dict:
    """``worker._traced_epoch`` with ``summarize`` in place of
    ``trace.summarize``, and ``harness_agrees``: whether
    ``trace.summarize`` of the same events reads the same wall, busy time,
    families and kernels.

    Raises where the traced epoch is not a steady one (a capture, a
    restaging, or a round trip beside one a window and one an eager step):
    its parts would then hold that work too."""
    held = {}

    def read(events):
        events = list(events)
        held["agrees"] = _harness_summarize(events)
        return summarize(events)

    trace.summarize = read
    try:
        summary = _harness_traced_epoch(trainer, epoch, stop, plan)
    finally:
        trace.summarize = _harness_summarize
    summary["harness_agrees"] = all(
        held["agrees"][k] == summary[k]
        for k in ("wall_us", "busy_us", "families", "kernels"))
    got = summary["counters"]["trainer"]
    windows = summary["ranges"].get("window_dispatch", [0])[0]
    if got["captures"] or got["restages"] or \
            got["host_round_trips"] != windows + got["eager_steps"]:
        raise RuntimeError(f"rank {trainer.rank}: the traced epoch is not a "
                           f"steady one: {got}, {windows} window(s)")
    idle = summary["wall_us"] - summary["busy_us"]
    parts = {k: round(v, 1) for k, v in summary["partition"].items()}
    ranges = {k: [round(x, 1) for x in v]
              for k, v in summary["ranges"].items()}
    print(f"[partition] rank {trainer.rank}: wall {summary['wall_us']:.1f} "
          f"us, idle {idle:.1f} us = parts {parts} (sum "
          f"{sum(summary['partition'].values()):.1f}); misstamped "
          f"{summary['misstamped']}; harness agrees "
          f"{summary['harness_agrees']}; trace counts {got}; ranges (count, us, self us) "
          f"{ranges}", file=sys.stderr, flush=True)
    return summary


def rank_entry(*args) -> None:
    """A spawned rank's target: ``launch.rank_entry`` with
    ``traced_epoch`` in the worker's place, in the rank's own process."""
    worker._traced_epoch = traced_epoch
    launch.rank_entry(*args)


def _metrics(root=run.ROOT) -> dict:
    return {**_load_metrics(root), **_load_metrics(PENDING)}


_load_metrics = run.load_metrics
_measure = run.measure
_harness_summarize = trace.summarize
_harness_traced_epoch = worker._traced_epoch


@contextlib.contextmanager
def wired():
    """Inside: the harness runs ``traced_epoch`` on every rank and reads
    the pending metrics beside its own."""
    saved = worker._traced_epoch, run.load_metrics, run.measure
    worker._traced_epoch = traced_epoch
    run.load_metrics = _metrics
    run.measure = functools.partial(_measure, rank_target=rank_entry)
    try:
        yield
    finally:
        worker._traced_epoch, run.load_metrics, run.measure = saved


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    with wired():
        return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
