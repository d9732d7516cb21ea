"""The traced epoch: ``torch.profiler`` over one whole epoch of the timed
path, reduced on the rank that traced it to the few numbers the per-layer
metrics and the breakdown read.

The benchmark's own spans (``torch.profiler.record_function``, named
``portbench.<span>``) mark what the host was in: ``window`` around the
traced epoch and its stop check, ``epoch`` around ``Trainer.train_model``,
``rank_barrier`` around the ranks' agreement to stop.  An idle gap of the
device is named by the innermost span around it and by the host call that
launched the work which ended it: a CUDA graph launch (a window's replays),
an eager kernel launch (the epoch's tail step, a restage), a copy or a
memset.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import yardstick

SPAN = "portbench."
_LAUNCHES = (("GraphLaunch", "graph replay"), ("LaunchKernel", "eager kernel"),
             ("Memcpy", "copy"), ("Memset", "memset"))


def _launch_kind(runtime: Optional[str]) -> str:
    if runtime is None:
        return "unmatched launch"
    for frag, kind in _LAUNCHES:
        if frag in runtime:
            return kind
    return runtime


def summarize(events) -> dict:
    """Reduce the profiler's kineto events of one traced window (the
    ``portbench.window`` span) to: its wall and busy microseconds, device
    microseconds by kernel family and by kernel name (with counts), and
    the idle gaps' microseconds by name (with counts)."""
    from torch.autograd import DeviceType
    kernels: List[Tuple[float, float, str, int]] = []
    runtime: Dict[int, str] = {}
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN):       # a span's shadow on the device
                continue
            corr = e.correlation_id() or e.linked_correlation_id()
            kernels.append((start, end, name, corr))
        elif name.startswith(SPAN):
            spans.append((start, end, name[len(SPAN):]))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = name
    window = [s for s in spans if s[2] == "window"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    ws, we, _ = window[0]
    kernels = sorted(k for k in kernels if k[1] > ws and k[0] < we)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name, _ in kernels:
        by_name[name][0] += e - s
        by_name[name][1] += 1
    busy = yardstick.busy_us((max(s, ws), min(e, we))
                             for s, e, _, _ in kernels)
    gaps: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    cur = ws
    for s, e, _, corr in kernels + [(we, we, "", None)]:
        if s > cur:
            mid = 0.5 * (cur + s)
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            span = min(inner, key=lambda sp: sp[1] - sp[0])[2] \
                if inner else "outside"
            what = "window end" if corr is None and s == we \
                else _launch_kind(runtime.get(corr))
            key = f"{span}: idle before {what}"
            gaps[key][0] += s - cur
            gaps[key][1] += 1
        cur = max(cur, e)
    return {"wall_us": we - ws, "busy_us": busy,
            "families": yardstick.family_us(
                (n, v[0]) for n, v in by_name.items()),
            "kernels": {n: v for n, v in by_name.items()},
            "gaps": dict(gaps)}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the four largest kernel families
    and the six largest kernels by device seconds, and the ten idle-gap
    names with the most seconds, each with its count in the name."""
    fams = sorted(summary["families"].items(), key=lambda kv: -kv[1])[:4]
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:6]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[f"family {n}", us / 1e6] for n, us in fams]
            + [[f"{n[:150]} (x{c})", us / 1e6] for n, (us, c) in top],
            "idle_gaps": [[f"{n} (x{c})", us / 1e6]
                          for n, (us, c) in gaps]}
