"""The telemetry recorder: JSONL events, wall-clock spans, manifest, summary.

A copy of the reference package's ``obs/telemetry.py`` (pure Python; the
port imports nothing of the reference), record for record: a run directory
the port writes is one that the reference's ``tools/telemetry_report.py``
renders unchanged.

Three primitives, one file format:

* **events**  — per-step records (``kind: "step"``): loss, step/forward wall
  time, the steady flag (first 20-iteration window and ragged-tail steps
  excluded, mirroring ``WindowedTimers``), epoch and iteration number; on
  the windowed path also the metric ring's ``grad_sqnorm`` and the step's
  absolute ``step_index``.
* **spans**   — named wall-clock regions (``kind: "span"``): host augment,
  chunk put and wait, train window, eval, warm-up and capture, checkpoint
  save.  Spans nest; each record carries its depth and parent name.  The
  span stack is thread-local because the host-augment producer runs on its
  own thread.
* **gauges/counters** — point-in-time values (``kind: "gauge"``) and
  monotonic tallies (``kind: "counter"``): prefetch queue depth, host and
  device memory, the collectives of one step by kind, host round trips.

A run directory holds three files: ``manifest.json`` (the run header,
written once at trainer construction), ``events.jsonl`` (one JSON object per
line, append-only), and ``summary.json`` (steady-state percentiles, written
by ``finalize()``).  Construct with ``out_dir=None`` for an in-memory
recorder — same API, events kept in ``.records``.

The DISABLED path is ``NULL``: a stateless singleton whose methods do
nothing and whose ``span()`` returns a shared no-op context manager, so a
run without ``--telemetry-out`` performs zero file writes and zero per-step
allocations (hot call sites guard on ``telemetry.enabled`` so even the
argument dicts are never built).  Nothing here touches the device: a
record is built from values the host already holds.

Every span, of either recorder and on every rank, is also a range named
``cs744.<name>`` on ``torch.profiler``'s timeline while a profiler records
(``profiler_range``), so that a device trace can put each idle gap down to
what the host was doing.  The ranges add no record to the JSONL stream.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, IO, List, Optional, Tuple

_SCHEMA_VERSION = 1


def atomic_write_json(path: str, obj, indent: Optional[int] = 2) -> None:
    """Complete-or-absent JSON write: dump to a unique temp file in the
    same directory, then ``os.replace`` into place.  A crash or preemption
    signal mid-write leaves either the previous file or the new one —
    never a torn half-document."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, default=str)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _rotated_paths(path: str) -> List[str]:
    """The rotated set behind ``path``, OLDEST FIRST: ``events.N.jsonl``
    down to ``events.1.jsonl`` (rotation keeps the numbering contiguous,
    so the scan stops at the first hole)."""
    base, ext = os.path.splitext(path)
    found = []
    n = 1
    while os.path.exists(f"{base}.{n}{ext}"):
        found.append(f"{base}.{n}{ext}")
        n += 1
    return list(reversed(found))


def read_events_jsonl(path: str,
                      warn=None) -> Tuple[List[Dict[str, Any]], int]:
    """Read an events.jsonl -> (events, n_bad), INCLUDING any rotated
    predecessors (``events.N.jsonl`` ... ``events.1.jsonl``, oldest
    first — size-aware rotation).  A run killed mid-write
    (preemption is a NORMAL exit path for this codebase) legitimately
    leaves a truncated final line; undecodable lines are counted and
    reported through ``warn`` (callable, e.g. ``log``) instead of failing
    the whole report."""
    events: List[Dict[str, Any]] = []
    n_bad = 0

    def _read_one(p: str) -> None:
        nonlocal n_bad
        with open(p) as f:
            for lineno, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    n_bad += 1
                    if warn is not None:
                        warn(f"{p}:{lineno}: undecodable event line "
                             f"(truncated write?) — skipped")

    for p in _rotated_paths(path):
        _read_one(p)
    if os.path.exists(path):
        _read_one(path)
    return events, n_bad


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolation percentile of an UNSORTED sample, q in [0, 100].

    Matches numpy's default ("linear") method: sorted [1..10] gives
    p50 = 5.5, p95 = 9.55, p99 = 9.91.  Pure-python on purpose — the
    summary path must not pull numpy into report-only tooling.
    """
    if not values:
        raise ValueError("percentile of empty sample")
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    if xs[lo] == xs[hi]:
        # Exact, not interpolated: a*(1-f) + a*f can drift a ulp, which
        # breaks p50 <= p95 <= p99 monotonicity on repeated samples.
        return float(xs[lo])
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Current commit sha, or None outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


class _NullSpan:
    """Shared no-op context manager — one instance for the whole process."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

PROFILER_PREFIX = "cs744."


def profiler_range(name: str):
    """A range named ``cs744.<name>`` on ``torch.profiler``'s timeline while
    a profiler records on this process, else the shared no-op span: one
    flag check when none does.

    The range is a host-side record only (``_RecordFunctionFast``, a plain
    function scope): ``torch.profiler.record_function``'s user scope also
    leaves a shadow event on the device's timeline, which a sum of the
    card's busy time would count as a kernel.  torch is reached through
    ``sys.modules`` and never imported here, so the run-directory report
    still loads without it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _NULL_SPAN
    return torch._C._profiler._RecordFunctionFast(PROFILER_PREFIX + name)


class NullTelemetry:
    """The disabled recorder: every method is a no-op, ``enabled`` is False;
    ``span`` is only ``profiler_range``, a no-op while no profiler records.

    Stateless (``__slots__ = ()``): recording through it cannot grow any
    per-step list, and it never touches the filesystem.  Hot call sites
    should still guard on ``.enabled`` so argument construction is skipped
    too.
    """
    __slots__ = ()
    enabled = False

    def step(self, **fields) -> None:
        pass

    def gauge(self, name: str, value, **attrs) -> None:
        pass

    def counter(self, name: str, inc=1, **attrs) -> None:
        pass

    def span(self, name: str, **attrs):
        return profiler_range(name)

    def span_event(self, name: str, t0: float, dur_s: float,
                   **attrs) -> None:
        pass

    def alert(self, rule: str, severity: str, **attrs) -> None:
        pass

    def add_tap(self, fn) -> None:
        pass

    def counter_totals(self) -> Dict[str, float]:
        return {}

    def write_manifest(self, fields: Dict[str, Any]) -> None:
        pass

    def update_manifest(self, fields: Dict[str, Any]) -> None:
        pass

    def finalize(self, **extra) -> Optional[Dict[str, Any]]:
        return None


NULL = NullTelemetry()


class _Span:
    __slots__ = ("_tel", "name", "attrs", "t0", "_range")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self._range = _NULL_SPAN

    def __enter__(self):
        self._range = profiler_range(self.name)
        self._range.__enter__()
        self._tel._push(self.name)
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, *exc):
        dur = time.time() - self.t0
        self._range.__exit__(exc_type, *exc)
        parent, depth = self._tel._pop()
        rec = {"kind": "span", "name": self.name, "t": self.t0,
               "dur_s": dur, "depth": depth}
        if parent is not None:
            rec["parent"] = parent
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec.update(self.attrs)
        self._tel._emit(rec)
        return False


class Telemetry:
    """The enabled recorder.  ``out_dir=None`` keeps events in memory."""

    enabled = True

    def __init__(self, out_dir: Optional[str] = None, *,
                 rotate_bytes: int = 64 * 2 ** 20, rotate_keep: int = 3):
        """``rotate_bytes`` caps the live ``events.jsonl``: past it the
        file rotates to ``events.1.jsonl`` (older generations shift up,
        at most ``rotate_keep`` kept) so a multi-hour run cannot grow the
        log unbounded.  0 disables rotation.  The 64 MiB default is far
        above any CI run — short runs never rotate (the run-directory
        listing stays exactly its three files)."""
        self.out_dir = out_dir
        self.records: List[Dict[str, Any]] = []  # in-memory mirror when no dir
        self.manifest: Optional[Dict[str, Any]] = None
        self.summary: Optional[Dict[str, Any]] = None
        self._fh: Optional[IO[str]] = None
        self._lock = threading.Lock()  # producer thread emits spans too
        self._tls = threading.local()
        self._counters: Dict[str, float] = {}
        self._taps: List = []   # live record observers (alert engine)
        if rotate_keep < 1:
            raise ValueError(f"rotate_keep must be >= 1, got {rotate_keep}")
        self._rotate_bytes = int(rotate_bytes)
        self._rotate_keep = int(rotate_keep)
        self._events_path: Optional[str] = None
        self._event_bytes = 0
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._events_path = os.path.join(out_dir, "events.jsonl")
            if os.path.exists(self._events_path):   # append to a prior run
                self._event_bytes = os.path.getsize(self._events_path)
            self._fh = open(self._events_path, "a", buffering=1)

    # -- span stack (per thread) -------------------------------------------

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, name: str) -> None:
        self._stack().append(name)

    def _pop(self) -> Tuple[Optional[str], int]:
        st = self._stack()
        st.pop()
        return (st[-1] if st else None), len(st)

    # -- emission -----------------------------------------------------------

    def _emit(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if self._fh is not None:
                line = json.dumps(rec) + "\n"
                self._fh.write(line)
                self._event_bytes += len(line)
                if self._rotate_bytes and \
                        self._event_bytes >= self._rotate_bytes:
                    self._rotate_locked()
            else:
                self.records.append(rec)
        # Taps run OUTSIDE the writer lock: a tap that emits (the alert
        # engine firing through ``alert()``) re-enters ``_emit`` on the
        # same thread, which would deadlock under the held lock.
        for tap in self._taps:
            tap(rec)

    def add_tap(self, fn) -> None:
        """Register a live record observer, called once per emitted
        record (after it is written).  Taps must be fast and must not
        raise — the serve path runs through them."""
        self._taps.append(fn)

    def _rotate_locked(self) -> None:
        """Shift the rotated generations up one slot (dropping the one
        past ``rotate_keep``) and reopen a fresh live file.  Caller holds
        the lock; every move is an ``os.replace`` so a crash mid-rotation
        leaves whole files, never torn ones."""
        self._fh.close()
        base, ext = os.path.splitext(self._events_path)
        oldest = f"{base}.{self._rotate_keep}{ext}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for k in range(self._rotate_keep - 1, 0, -1):
            src = f"{base}.{k}{ext}"
            if os.path.exists(src):
                os.replace(src, f"{base}.{k + 1}{ext}")
        os.replace(self._events_path, f"{base}.1{ext}")
        self._fh = open(self._events_path, "a", buffering=1)
        self._event_bytes = 0

    def step(self, *, epoch: int, iter: int, loss: float, step_time: float,
             forward_time: Optional[float] = None, steady: bool = True,
             **extra) -> None:
        rec = {"kind": "step", "t": time.time(), "epoch": epoch, "iter": iter,
               "loss": float(loss), "step_time_s": float(step_time),
               "steady": bool(steady)}
        if forward_time is not None:
            rec["forward_time_s"] = float(forward_time)
        if extra:
            rec.update(extra)
        self._emit(rec)

    def gauge(self, name: str, value, **attrs) -> None:
        rec = {"kind": "gauge", "name": name, "t": time.time(),
               "value": value}
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def counter(self, name: str, inc=1, **attrs) -> None:
        with self._lock:
            total = self._counters.get(name, 0) + inc
            self._counters[name] = total
        rec = {"kind": "counter", "name": name, "t": time.time(),
               "inc": inc, "total": total}
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def span_event(self, name: str, t0: float, dur_s: float,
                   **attrs) -> None:
        """Record an ALREADY-MEASURED interval as a span event.  Unlike
        ``span()`` (a context manager bound to one thread's span stack)
        this suits asynchronous intervals whose endpoints live on
        different threads or came off the wire — a client round-trip, a
        queue wait — so depth is 0 and parenting comes from the caller's
        trace attrs, not the thread-local stack."""
        rec = {"kind": "span", "name": name, "t": float(t0),
               "dur_s": float(dur_s), "depth": 0}
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def alert(self, rule: str, severity: str, **attrs) -> None:
        """Record a structured alert event (``kind: "alert"``) — the
        ``obs/alerts.py`` rules engine emits these; ``summarize_events``
        rolls them up under ``summary["alerts"]``."""
        rec = {"kind": "alert", "rule": rule, "severity": severity,
               "t": time.time()}
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def counter_totals(self) -> Dict[str, float]:
        """Current counter totals (a copy) without draining the event log
        — live introspection for the serving demo's bucket histogram."""
        with self._lock:
            return dict(self._counters)

    # -- run header / footer -------------------------------------------------

    def write_manifest(self, fields: Dict[str, Any]) -> None:
        man = {"schema_version": _SCHEMA_VERSION, "created_at": time.time()}
        man.update(fields)
        self.manifest = man
        if self.out_dir is not None:
            atomic_write_json(os.path.join(self.out_dir, "manifest.json"),
                              man)

    def update_manifest(self, fields: Dict[str, Any]) -> None:
        """Merge ``fields`` into the manifest and rewrite it — for facts
        only known at the END of a run (whether the CUDA kernels were
        built or loaded, an elastic report) joining a header written at
        construction."""
        man = dict(self.manifest) if self.manifest else \
            {"schema_version": _SCHEMA_VERSION, "created_at": time.time()}
        man.update(fields)
        self.manifest = man
        if self.out_dir is not None:
            atomic_write_json(os.path.join(self.out_dir, "manifest.json"),
                              man)

    def finalize(self, **extra) -> Dict[str, Any]:
        """Compute the steady-state summary; write ``summary.json`` if the
        recorder is file-backed.  Safe to call once at the end of a run —
        also closes the event log."""
        events = self._drain_events()
        summary = summarize_events(events, **extra)
        self.summary = summary
        if self.out_dir is not None:
            atomic_write_json(os.path.join(self.out_dir, "summary.json"),
                              summary)
            with self._lock:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
        return summary

    def _drain_events(self) -> List[Dict[str, Any]]:
        if self.out_dir is None:
            return list(self.records)
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        events, _ = read_events_jsonl(
            os.path.join(self.out_dir, "events.jsonl"))
        return events


def summarize_events(events: List[Dict[str, Any]],
                     global_batch: Optional[int] = None,
                     **extra) -> Dict[str, Any]:
    """Steady-state summary of an event list: step-time percentiles,
    throughput, span totals, final counter values."""
    steps = [e for e in events if e.get("kind") == "step"]
    steady = [e["step_time_s"] for e in steps if e.get("steady")]
    spans: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("kind") == "span":
            agg = spans.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += e.get("dur_s", 0.0)
    counters: Dict[str, float] = {}
    for e in events:
        if e.get("kind") == "counter":
            counters[e["name"]] = e["total"]
    gauges: Dict[str, Any] = {}
    for e in events:
        if e.get("kind") == "gauge":
            gauges[e["name"]] = e["value"]   # last write wins
    # Per-rank step-time aggregation (elastic runs emit one
    # ``rank_step_time_s`` gauge per rank per window boundary).
    ranks: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("kind") == "gauge" and e.get("name") == "rank_step_time_s" \
                and "rank" in e:
            agg = ranks.setdefault(str(e["rank"]), {
                "count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += e["value"]
            agg["max_s"] = max(agg["max_s"], e["value"])
    for agg in ranks.values():
        agg["mean_s"] = agg["total_s"] / agg["count"]

    summary: Dict[str, Any] = {
        "schema_version": _SCHEMA_VERSION,
        "num_events": len(events),
        "num_steps": len(steps),
        "num_steady_steps": len(steady),
        "spans": spans,
        "counters": counters,
        "gauges": gauges,
    }
    if ranks:
        summary["ranks"] = ranks
    # Serving latency split: the per-request queue-wait vs
    # service-time gauges the micro-batcher emits, aggregated so SLO
    # reading needs only the summary.
    qw = [e["value"] for e in events if e.get("kind") == "gauge"
          and e.get("name") == "serve_queue_wait_ms"]
    svc = [e["value"] for e in events if e.get("kind") == "gauge"
           and e.get("name") == "serve_service_ms"]
    if qw or svc:
        def _pct(vals):
            if not vals:
                return None
            return {"p50": percentile(vals, 50),
                    "p95": percentile(vals, 95),
                    "mean": sum(vals) / len(vals)}
        summary["serving_latency_split"] = {
            "requests": max(len(qw), len(svc)),
            "queue_wait_ms": _pct(qw),
            "service_ms": _pct(svc),
        }
    # SLO attainment by tier: the scheduler's per-request
    # ``serve_latency_ms`` gauges carry ``tier``/``met`` attrs and its
    # shed decisions are ``serve_shed`` counter events with
    # ``tier``/``reason`` — aggregated so the report's ``== slo ==``
    # section reads only the summary.
    slo_tiers: Dict[str, Dict[str, int]] = {}
    for e in events:
        if e.get("kind") == "gauge" and e.get("name") == "serve_latency_ms" \
                and "met" in e and "tier" in e:
            agg = slo_tiers.setdefault(str(e["tier"]),
                                       {"served": 0, "met": 0, "shed": 0})
            agg["served"] += 1
            agg["met"] += 1 if e["met"] else 0
    shed_reasons: Dict[str, int] = {}
    for e in events:
        if e.get("kind") == "counter" and e.get("name") == "serve_shed":
            if "tier" in e:
                agg = slo_tiers.setdefault(str(e["tier"]),
                                           {"served": 0, "met": 0, "shed": 0})
                agg["shed"] += int(e.get("inc", 1))
            reason = str(e.get("reason", "unknown"))
            shed_reasons[reason] = shed_reasons.get(reason, 0) \
                + int(e.get("inc", 1))
    if slo_tiers:
        for agg in slo_tiers.values():
            offered = agg["served"] + agg["shed"]
            agg["late"] = agg["served"] - agg["met"]
            agg["attainment"] = round(agg["met"] / offered, 4) \
                if offered else None
        replica_util = {
            str(e["replica"]): e["value"] for e in events
            if e.get("kind") == "gauge" and e.get("name") == "replica_util"
            and "replica" in e}
        summary["slo"] = {"by_tier": slo_tiers,
                          "shed_by_reason": shed_reasons}
        if replica_util:
            summary["slo"]["replica_util"] = replica_util
    # Alert roll-up: structured ``kind: "alert"`` events from
    # the obs/alerts.py rules engine, grouped by deterministic rule id so
    # chaos drills can pin exactly which rules fired from the summary.
    alerts: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("kind") == "alert":
            agg = alerts.setdefault(str(e.get("rule", "unknown")), {
                "count": 0, "severity": str(e.get("severity", "warn"))})
            agg["count"] += 1
    if alerts:
        summary["alerts"] = alerts
    if steps:
        summary["final_loss"] = steps[-1]["loss"]
        summary["mean_loss"] = sum(s["loss"] for s in steps) / len(steps)
    if steady:
        summary["steady_step_time_s"] = {
            "p50": percentile(steady, 50),
            "p95": percentile(steady, 95),
            "p99": percentile(steady, 99),
            "mean": sum(steady) / len(steady),
            "min": min(steady),
            "max": max(steady),
        }
        if global_batch:
            summary["steady_images_per_sec"] = (
                global_batch * len(steady) / sum(steady))
    if global_batch:
        summary["global_batch"] = global_batch
    if extra:
        summary.update(extra)
    return summary


def read_run(out_dir: str) -> Tuple[Optional[Dict[str, Any]],
                                    List[Dict[str, Any]],
                                    Optional[Dict[str, Any]]]:
    """Load a run directory -> (manifest, events, summary); missing files
    come back as None / empty list so partial runs still render."""
    def _load(name):
        path = os.path.join(out_dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    manifest = _load("manifest.json")
    summary = _load("summary.json")
    events, _ = read_events_jsonl(os.path.join(out_dir, "events.jsonl"))
    return manifest, events, summary
