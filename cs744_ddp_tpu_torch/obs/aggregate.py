"""Cross-process trace aggregation: merge, skew-correct, waterfall.  The
reference package's ``obs/aggregate.py`` (the port imports nothing of the
reference), with its tool's rendering (``tools/trace_waterfall.py``) as
this module's entry point:

    python -m cs744_ddp_tpu_torch.obs.aggregate RUN_DIR [RUN_DIR ...]
        [--json] [--reference NAME] [--max-waterfalls N]
        [--prior-flops FILE.json]

prints what ``tools/trace_waterfall.py`` prints for the same directories.

Each process in a traced serving run writes spans into its OWN
``events.jsonl`` (rotation-aware, torn-tail tolerant — the reader is
``read_events_jsonl``).  This module stitches those per-process streams
back into per-request **latency waterfalls**:

1. **merge** — group every span carrying a ``trace_id`` attribute
   (stamped from ``TraceContext.attrs()``) across all streams.
2. **clock skew** — processes have independent clocks.  For every trace
   observed by both a client (``trace_client`` span: t1..t4 on the
   client clock) and the server (``frontend_request`` span: t2..t3 on
   the server clock) the NTP midpoint method gives the server-minus-
   client offset ``((t2-t1)+(t3-t4))/2`` with error bounded by half the
   round-trip residual ``rtt = (t4-t1)-(t3-t2)``.  The per-process
   offset is the MEDIAN over all matched pairs, applied to every
   timestamp from that process before reconstruction.
3. **waterfall** — per request, the ordered stage durations: wire
   decode, queue wait, admit deferral, staging, device compute, fetch,
   reply encode, plus the frontend window and the client-measured
   round-trip; per-batch engine spans (``serve_dispatch``/
   ``serve_fetch``/``serve_stage``) are joined to requests through the
   batcher trace id each carries in its ``traces`` attribute.  A trace
   whose process died mid-request (chaos ``replica_death``) renders as
   ``complete: False`` with whatever stages its surviving spans attest.

The device-compute stage optionally joins a COST-MODEL PRIOR
(``analysis/costmodel.py`` flop counts per bucket, ``serve/scheduler.py::
cost_model_weights``): a single rate
``k = sum(f*m)/sum(f*f)`` is least-squares fitted across buckets and the
per-bucket predicted-vs-measured ratio reported, so a bucket whose
measured time diverges from its flop share stands out.

Everything here is pure python over dicts (same rule as
``telemetry.percentile``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from .telemetry import percentile, read_events_jsonl

# Span names the serve path emits (the aggregation contract).
CLIENT_SPAN = "trace_client"          # client round-trip, t1..t4
FRONTEND_SPAN = "frontend_request"    # server window, t_recv..t_send
STAGE_SPANS = ("wire_decode", "sched_queue", "sched_defer", "serve_stage",
               "serve_dispatch", "serve_fetch", "reply_encode")
# Stage display order in a waterfall (request wall-clock order).
STAGE_ORDER = ("wire_decode", "queue_wait", "admit_defer", "staging",
               "device_compute", "fetch", "reply_encode")
_SPAN_TO_STAGE = {"wire_decode": "wire_decode", "sched_queue": "queue_wait",
                  "sched_defer": "admit_defer", "serve_stage": "staging",
                  "serve_dispatch": "device_compute", "serve_fetch": "fetch",
                  "reply_encode": "reply_encode"}
# Batch-level engine spans join requests via their ``traces`` attr.
_BATCH_SPANS = ("serve_stage", "serve_dispatch", "serve_fetch")


class ProcessStream(NamedTuple):
    """One process's event stream plus its read health."""
    name: str
    events: List[Dict[str, Any]]
    n_bad: int = 0


class ClockEstimate(NamedTuple):
    """Per-process clock offset onto the reference clock."""
    offset_s: float         # ADD to this process's timestamps
    rtt_bound_s: float      # |error| <= rtt/2 (median matched pair)
    n_pairs: int
    estimated: bool         # False -> no matched pairs, offset fell to 0


def load_streams(run_dirs: Sequence[str], warn=None) -> List[ProcessStream]:
    """Read N run directories (rotated + torn-tail tolerant) into
    named streams; the stream name is the directory basename."""
    streams = []
    for d in run_dirs:
        events, n_bad = read_events_jsonl(os.path.join(d, "events.jsonl"),
                                          warn=warn)
        streams.append(ProcessStream(os.path.basename(os.path.normpath(d))
                                     or d, events, n_bad))
    return streams


def _traced_spans(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [e for e in events
            if e.get("kind") == "span" and e.get("trace_id")]


def _windows(events, name) -> Dict[int, Tuple[float, float]]:
    """trace_id -> (t_start, t_end) for the given span name."""
    out = {}
    for e in _traced_spans(events):
        if e.get("name") == name:
            out[e["trace_id"]] = (e["t"], e["t"] + e.get("dur_s", 0.0))
    return out


def estimate_offsets(streams: Sequence[ProcessStream],
                     reference: Optional[str] = None
                     ) -> Dict[str, ClockEstimate]:
    """Per-stream clock offsets onto the reference stream's clock.

    The reference defaults to the first stream that carries
    ``frontend_request`` spans (the server — the hub every client pairs
    with).  A stream with no matched request/reply pairs against the
    reference keeps offset 0 with ``estimated=False``.
    """
    by_name = {s.name: s for s in streams}
    if reference is None:
        reference = next((s.name for s in streams
                          if _windows(s.events, FRONTEND_SPAN)), None)
        if reference is None and streams:
            reference = streams[0].name
    ref = by_name.get(reference)
    out: Dict[str, ClockEstimate] = {}
    ref_server = _windows(ref.events, FRONTEND_SPAN) if ref else {}
    ref_client = _windows(ref.events, CLIENT_SPAN) if ref else {}
    for s in streams:
        if ref is None or s.name == reference:
            out[s.name] = ClockEstimate(0.0, 0.0, 0, s.name == reference)
            continue
        offsets, rtts = [], []
        # This stream is the client, the reference the server ...
        mine_c = _windows(s.events, CLIENT_SPAN)
        for tid, (t1, t4) in mine_c.items():
            if tid in ref_server:
                t2, t3 = ref_server[tid]
                offsets.append(((t2 - t1) + (t3 - t4)) / 2.0)
                rtts.append((t4 - t1) - (t3 - t2))
        # ... or the reference is the client and this stream the server.
        mine_s = _windows(s.events, FRONTEND_SPAN)
        for tid, (t2, t3) in mine_s.items():
            if tid in ref_client:
                t1, t4 = ref_client[tid]
                offsets.append(-(((t2 - t1) + (t3 - t4)) / 2.0))
                rtts.append((t4 - t1) - (t3 - t2))
        if offsets:
            out[s.name] = ClockEstimate(
                percentile(offsets, 50),
                max(0.0, percentile(rtts, 50)) / 2.0,
                len(offsets), True)
        else:
            out[s.name] = ClockEstimate(0.0, 0.0, 0, False)
    return out


def merge_traces(streams: Sequence[ProcessStream],
                 offsets: Optional[Dict[str, ClockEstimate]] = None
                 ) -> Dict[int, List[Dict[str, Any]]]:
    """Group skew-corrected spans by trace_id.  Each returned span is a
    COPY with ``t`` shifted onto the reference clock and a ``proc``
    field naming its source stream."""
    offsets = offsets if offsets is not None else estimate_offsets(streams)
    traces: Dict[int, List[Dict[str, Any]]] = {}
    for s in streams:
        off = offsets.get(s.name, ClockEstimate(0.0, 0.0, 0, False)).offset_s
        for e in _traced_spans(s.events):
            rec = dict(e)
            rec["t"] = e["t"] + off
            rec["proc"] = s.name
            traces.setdefault(e["trace_id"], []).append(rec)
    for spans in traces.values():
        spans.sort(key=lambda r: r["t"])
    return traces


def batch_span_index(streams: Sequence[ProcessStream],
                     offsets: Optional[Dict[str, ClockEstimate]] = None
                     ) -> Dict[Any, List[Dict[str, Any]]]:
    """Batcher-trace-id -> skew-corrected batch-level engine spans.
    ``serve_stage``/``serve_dispatch``/``serve_fetch`` cover a whole
    bucket dispatch, so they carry the member requests' batcher trace
    ids in a ``traces`` attribute instead of one ``trace_id``."""
    offsets = offsets if offsets is not None else estimate_offsets(streams)
    index: Dict[Any, List[Dict[str, Any]]] = {}
    for s in streams:
        off = offsets.get(s.name, ClockEstimate(0.0, 0.0, 0, False)).offset_s
        for e in s.events:
            if e.get("kind") != "span" or e.get("name") not in _BATCH_SPANS:
                continue
            rec = dict(e)
            rec["t"] = e.get("t", 0.0) + off
            rec["proc"] = s.name
            for bt in (e.get("traces") or ()):
                index.setdefault(bt, []).append(rec)
    return index


def _build_waterfall(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One trace's spans -> one waterfall dict (pure, single trace)."""
    stages: Dict[str, float] = {}
    batch: Dict[str, Dict[str, Any]] = {}
    client_ms = frontend_ms = None
    bucket = None
    batcher_trace = None
    procs, origins = set(), set()
    for e in spans:
        procs.add(e.get("proc", "?"))
        if e.get("origin"):
            origins.add(e["origin"])
        name = e.get("name")
        dur_ms = e.get("dur_s", 0.0) * 1e3
        if name == CLIENT_SPAN:
            client_ms = dur_ms
        elif name == FRONTEND_SPAN:
            frontend_ms = dur_ms
        elif name in _BATCH_SPANS:
            batch[name] = e
            if e.get("bucket") is not None:
                bucket = e["bucket"]
        elif name in _SPAN_TO_STAGE:
            stage = _SPAN_TO_STAGE[name]
            stages[stage] = stages.get(stage, 0.0) + dur_ms
            if e.get("trace") is not None:
                batcher_trace = e["trace"]
    # Per-request spans carry the batcher trace id; batch-level engine
    # spans were pre-joined by the caller (their ``traces`` attr).
    for name, e in batch.items():
        stage = _SPAN_TO_STAGE[name]
        stages[stage] = stages.get(stage, 0.0) + e.get("dur_s", 0.0) * 1e3
    ordered = {s: round(stages[s], 3) for s in STAGE_ORDER if s in stages}
    total = sum(ordered.values())
    # Complete = the client saw a reply AND the device ran the request.
    complete = client_ms is not None and "device_compute" in ordered
    out: Dict[str, Any] = {
        "trace_id": spans[0]["trace_id"] if spans else 0,
        "complete": complete,
        "stages": ordered,
        "sum_ms": round(total, 3),
        "procs": sorted(procs),
        "origins": sorted(origins),
        "n_spans": len(spans),
    }
    if bucket is not None:
        out["bucket"] = bucket
    if batcher_trace is not None:
        out["trace"] = batcher_trace
    if frontend_ms is not None:
        out["frontend_ms"] = round(frontend_ms, 3)
        out["server_residual_ms"] = round(frontend_ms - total, 3)
    if client_ms is not None:
        out["client_ms"] = round(client_ms, 3)
        # wire + skew residual: client round-trip minus the server window
        if frontend_ms is not None:
            out["wire_ms"] = round(client_ms - frontend_ms, 3)
    return out


def build_waterfalls(traces: Dict[int, List[Dict[str, Any]]],
                     batch_index: Optional[Dict[Any, List[Dict[str, Any]]]]
                     = None) -> List[Dict[str, Any]]:
    """All traces -> waterfalls, joining batch-level engine spans to each
    member request via the batcher trace id its per-request spans carry
    (``trace`` attribute on ``sched_queue``/``trace_client``/...)."""
    batch_index = batch_index or {}
    waterfalls = []
    for tid, spans in sorted(traces.items()):
        bt = next((e.get("trace") for e in spans
                   if e.get("trace") is not None), None)
        joined = list(spans)
        if bt is not None:
            joined += batch_index.get(bt, [])
        waterfalls.append(_build_waterfall(joined))
    return waterfalls


def fit_cost_prior(waterfalls: List[Dict[str, Any]],
                   prior_flops: Dict[int, float]) -> Optional[Dict[str, Any]]:
    """Least-squares one-rate fit of measured device-compute time against
    the cost model's per-bucket flop counts: ``ms ~= k * flops``.  The
    per-bucket predicted/measured ratio flags buckets whose measured
    time diverges from their flop share."""
    by_bucket: Dict[int, List[float]] = {}
    for w in waterfalls:
        b = w.get("bucket")
        ms = w["stages"].get("device_compute")
        if b in prior_flops and ms is not None:
            by_bucket.setdefault(b, []).append(ms)
    if not by_bucket:
        return None
    med = {b: percentile(v, 50) for b, v in by_bucket.items()}
    sfm = sum(prior_flops[b] * m for b, m in med.items())
    sff = sum(prior_flops[b] ** 2 for b in med)
    k = sfm / sff if sff else 0.0
    buckets = {}
    for b, m in sorted(med.items()):
        pred = k * prior_flops[b]
        buckets[str(b)] = {
            "measured_ms_p50": round(m, 3),
            "prior_ms": round(pred, 3),
            "measured_over_prior": round(m / pred, 3) if pred else None,
            "n": len(by_bucket[b]),
        }
    return {"rate_ms_per_flop": k, "by_bucket": buckets}


def aggregate_streams(streams: Sequence[ProcessStream], *,
                      reference: Optional[str] = None,
                      prior_flops: Optional[Dict[int, float]] = None,
                      max_waterfalls: int = 8) -> Dict[str, Any]:
    """The full aggregation: streams -> skew estimates, waterfalls,
    per-stage p50/p99 attribution, critical-path shares, residuals."""
    offsets = estimate_offsets(streams, reference=reference)
    traces = merge_traces(streams, offsets)
    waterfalls = build_waterfalls(traces, batch_span_index(streams, offsets))
    complete = [w for w in waterfalls if w["complete"]]
    stage_ms: Dict[str, List[float]] = {}
    for w in waterfalls:
        for s, ms in w["stages"].items():
            stage_ms.setdefault(s, []).append(ms)
    attribution = {
        s: {"p50": round(percentile(v, 50), 3),
            "p99": round(percentile(v, 99), 3),
            "mean": round(sum(v) / len(v), 3), "count": len(v)}
        for s, v in ((s, stage_ms[s]) for s in STAGE_ORDER if s in stage_ms)}
    # Critical-path share: per complete waterfall, each stage's fraction
    # of the stage sum (stages are sequential per request, so the "path"
    # is the whole chain; the share says which link dominates).
    shares: Dict[str, List[float]] = {}
    for w in complete:
        total = w["sum_ms"] or 1e-9
        for s, ms in w["stages"].items():
            shares.setdefault(s, []).append(ms / total)
    critical = {s: round(sum(v) / len(v), 4)
                for s, v in ((s, shares[s])
                             for s in STAGE_ORDER if s in shares)}
    dominant = max(critical.items(), key=lambda kv: kv[1])[0] \
        if critical else None
    residuals = [w["client_ms"] - w["sum_ms"] for w in complete
                 if w.get("client_ms") is not None]
    # The reference stream's estimate is the only (estimated, 0-pair) one.
    ref_name = next((n for n, c in offsets.items()
                     if c.estimated and c.n_pairs == 0), None)
    out: Dict[str, Any] = {
        "reference": ref_name,
        "processes": {
            s.name: {
                "events": len(s.events), "bad_lines": s.n_bad,
                "clock_offset_s": round(offsets[s.name].offset_s, 6),
                "rtt_bound_s": round(offsets[s.name].rtt_bound_s, 6),
                "skew_pairs": offsets[s.name].n_pairs,
                "skew_estimated": offsets[s.name].estimated,
            } for s in streams},
        "traces": len(waterfalls),
        "complete": len(complete),
        "orphaned": len(waterfalls) - len(complete),
        "stage_ms": attribution,
        "critical_path": {"share": critical, "dominant": dominant},
        # Complete waterfalls first: the sample should show reconstructed
        # requests, not a page of shed/orphaned stubs.
        "waterfalls": sorted(
            waterfalls, key=lambda w: (not w["complete"], -w["n_spans"])
        )[:max_waterfalls],
    }
    if residuals:
        out["client_minus_stages_ms"] = {
            "p50": round(percentile(residuals, 50), 3),
            "p99": round(percentile(residuals, 99), 3)}
    if prior_flops:
        prior = fit_cost_prior(waterfalls, prior_flops)
        if prior is not None:
            out["cost_prior"] = prior
    return out


def aggregate_run_dirs(run_dirs: Sequence[str], *, warn=None,
                       **kwargs) -> Dict[str, Any]:
    """Convenience wrapper: N telemetry run dirs -> aggregation report."""
    return aggregate_streams(load_streams(run_dirs, warn=warn), **kwargs)


# -- rendering (tools/trace_waterfall.py's) -----------------------------------

_BAR_WIDTH = 40


def _bars(stages: dict) -> list:
    """One waterfall's stages as proportional ASCII bars."""
    total = sum(stages.values()) or 1e-9
    lines = []
    for stage in STAGE_ORDER:
        if stage not in stages:
            continue
        ms = stages[stage]
        n = max(1, int(round(_BAR_WIDTH * ms / total)))
        lines.append(f"    {stage:<16} {'#' * n:<{_BAR_WIDTH}} "
                     f"{ms:9.3f} ms")
    return lines


def render(report: dict) -> str:
    lines = ["cross-process trace waterfall", ""]
    lines.append("== processes ==")
    for name, p in sorted(report["processes"].items()):
        if name == report.get("reference"):
            skew = "reference clock"
        elif p["skew_estimated"]:
            skew = (f"offset {p['clock_offset_s'] * 1e3:+.3f} ms "
                    f"(+/- {p['rtt_bound_s'] * 1e3:.3f} ms, "
                    f"{p['skew_pairs']} pairs)")
        else:
            skew = "no skew estimate (no matched request pairs)"
        bad = f"  !! {p['bad_lines']} bad lines" if p["bad_lines"] else ""
        lines.append(f"  {name:<20} {p['events']:>7} events  {skew}{bad}")
    lines.append("")

    lines.append("== traces ==")
    lines.append(f"  reconstructed          {report['traces']} "
                 f"({report['complete']} complete, "
                 f"{report['orphaned']} orphaned/partial)")
    res = report.get("client_minus_stages_ms")
    if res:
        lines.append(f"  client - stage sum     p50 {res['p50']:+.3f} ms  "
                     f"p99 {res['p99']:+.3f} ms "
                     f"(wire + scheduling residual)")
    lines.append("")

    if report["stage_ms"]:
        lines.append("== stage attribution (all traces) ==")
        for stage, a in report["stage_ms"].items():
            lines.append(f"  {stage:<16} x{a['count']:<6} "
                         f"p50 {a['p50']:8.3f} ms  "
                         f"p99 {a['p99']:8.3f} ms  "
                         f"mean {a['mean']:8.3f} ms")
        dom = report["critical_path"].get("dominant")
        if dom:
            share = report["critical_path"]["share"].get(dom)
            lines.append(f"  critical path          {dom} "
                         f"({share:.0%} of stage time)")
        lines.append("")

    prior = report.get("cost_prior")
    if prior:
        lines.append("== device compute vs cost-model prior ==")
        for b, rec in prior["by_bucket"].items():
            ratio = rec["measured_over_prior"]
            lines.append(f"  bucket {b:<6} measured p50 "
                         f"{rec['measured_ms_p50']:8.3f} ms  prior "
                         f"{rec['prior_ms']:8.3f} ms  ratio "
                         f"{ratio if ratio is not None else '-'}")
        lines.append("")

    for w in report["waterfalls"]:
        flag = "" if w["complete"] else "  [incomplete]"
        who = ",".join(w.get("procs", []))
        lines.append(f"== waterfall trace {w['trace_id']:#x}{flag} "
                     f"({who}) ==")
        lines.extend(_bars(w["stages"]))
        tail = [f"stage sum {w['sum_ms']:.3f} ms"]
        if w.get("frontend_ms") is not None:
            tail.append(f"server window {w['frontend_ms']:.3f} ms")
        if w.get("client_ms") is not None:
            tail.append(f"client round-trip {w['client_ms']:.3f} ms")
        lines.append("    " + "  |  ".join(tail))
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="merge N telemetry run dirs into cross-process "
                    "request waterfalls")
    p.add_argument("run_dirs", nargs="+",
                   help="telemetry run directories (one per process)")
    p.add_argument("--json", action="store_true",
                   help="emit the aggregation report as JSON")
    p.add_argument("--reference", default=None,
                   help="stream name (dir basename) whose clock is the "
                        "reference; default: the first with server spans")
    p.add_argument("--max-waterfalls", type=int, default=8,
                   help="individual waterfalls to render (default 8)")
    p.add_argument("--prior-flops", default=None, metavar="FILE.json",
                   help="json {bucket: flops} from the cost model "
                        "(serve/scheduler.py::cost_model_weights); joins "
                        "device compute against the analytic prior")
    args = p.parse_args(argv)
    for d in args.run_dirs:
        if not os.path.isdir(d):
            p.error(f"not a directory: {d}")
    prior = None
    if args.prior_flops:
        with open(args.prior_flops, encoding="utf-8") as f:
            prior = {int(k): float(v) for k, v in json.load(f).items()}
    report = aggregate_run_dirs(
        args.run_dirs,
        warn=lambda msg: print(f"warning: {msg}", file=sys.stderr),
        reference=args.reference, prior_flops=prior,
        max_waterfalls=args.max_waterfalls)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
