"""Render a ``--telemetry-out`` run directory into a human summary.  The
reference package's ``tools/telemetry_report.py`` (the port imports
nothing of the reference), as this module's entry point:

    python -m cs744_ddp_tpu_torch.obs.report RUN_DIR [--json]

prints what ``tools/telemetry_report.py`` prints for the same directory,
line for line, with one difference: the run manifest shows the port's
``torch_version`` and ``cuda_version`` where the reference's shows its
``jax_version``.

A run directory holds ``manifest.json`` (the run header), ``events.jsonl``
(per-step events, spans, gauges, counters, alerts) and ``summary.json``
(steady-state percentiles).  The report prints the run header, the
step-time table, span totals, counters, one section for each subsystem
whose records the run holds (wire extensions, serving, elastic, program
audit, attribution, memory, traces, SLO tiers, publishing, the dispatch
pipeline, waterfalls, alerts) and the last value of every gauge.  It
recomputes the summary from the raw events when ``summary.json`` is
missing (an interrupted run), and counts undecodable event lines (a run
killed mid-write) with a warning on stderr.  ``--json`` prints the
(recomputed) summary instead.

Pure Python over dicts: it runs wherever the run directory is, the card's
host included.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import aggregate
from .telemetry import percentile, read_events_jsonl, read_run, \
    summarize_events

# The run header's keys, in the order they print: the reference's order,
# with the port's two version keys in the place of its ``jax_version``.
MANIFEST_ORDER = ("model", "strategy", "world_size", "global_batch",
                  "precision", "augment", "host_augment", "torch_version",
                  "cuda_version", "backend", "device_kind", "git_sha")


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:.2f} ms"


def _serving_lines(events) -> list:
    """The queue-depth trace and per-bucket client-latency percentiles,
    both rebuilt from raw gauge events (``queue_depth``;
    ``serve_latency_ms`` with its ``bucket`` attr).  [] for runs with no
    serving events."""
    depth, lat = [], {}
    for e in events:
        if e.get("kind") != "gauge":
            continue
        if e.get("name") == "queue_depth":
            depth.append(e["value"])
        elif e.get("name") == "serve_latency_ms":
            lat.setdefault(e.get("bucket", "?"), []).append(e["value"])
    if not depth and not lat:
        return []
    lines = ["== serving =="]
    if depth:
        lines.append(f"  queue_depth (images)   samples {len(depth)}  "
                     f"max {max(depth)}  "
                     f"mean {sum(depth) / len(depth):.1f}  "
                     f"last {depth[-1]}")
    if lat:
        lines.append("  request latency by bucket (client-side, "
                     "enqueue -> logits):")
        for b in sorted(lat, key=str):
            v = lat[b]
            lines.append(f"    bucket {b!s:<6} x{len(v):<6} "
                         f"p50 {percentile(v, 50):8.2f} ms  "
                         f"p95 {percentile(v, 95):8.2f} ms  "
                         f"p99 {percentile(v, 99):8.2f} ms")
    lines.append("")
    return lines


def _wire_ext_lines(events) -> list:
    """Unknown TLV tags skipped and torn trailing fields dropped by the
    wire codec (``wire_ext_skipped`` counter, per frame kind): a peer on
    another protocol build.  [] when no frame skipped a field."""
    per = {}
    for e in events:
        if e.get("kind") == "counter" and e.get("name") == "wire_ext_skipped":
            key = e.get("frame", "?")
            unknown, torn = per.get(key, (0, 0))
            per[key] = (unknown + e.get("unknown", 0),
                        torn + e.get("torn", 0))
    if not per:
        return []
    lines = ["== wire extension skips =="]
    for frame in sorted(per):
        unknown, torn = per[frame]
        lines.append(f"  {frame:<10} unknown tags skipped {unknown:<6} "
                     f"torn fields dropped {torn}")
    lines.append("")
    return lines


def _elastic_lines(events, manifest) -> list:
    """``--elastic`` runs: per-rank step-time percentiles from the raw
    ``rank_step_time_s`` gauges, straggler flags and the rank-death
    count.  [] for runs with no elastic signal."""
    per, flags, deaths = {}, {}, 0
    for e in events:
        kind, name = e.get("kind"), e.get("name")
        if kind == "gauge" and name == "rank_step_time_s":
            per.setdefault(e.get("rank", "?"), []).append(e["value"])
        elif kind == "counter" and name == "straggler_flagged":
            flags[e.get("rank", "?")] = \
                flags.get(e.get("rank", "?"), 0) + e.get("inc", 1)
        elif kind == "counter" and name == "rank_deaths":
            deaths = e["total"]
    cfg = (manifest or {}).get("elastic")
    if not per and not flags and not deaths and not cfg:
        return []
    lines = ["== elastic =="]
    if cfg:
        proto = cfg.get("protocol")
        ms = cfg.get("microshards")
        lines.append(f"  protocol               {proto}"
                     + (f" (microshards {ms})" if ms else ""))
    if per:
        lines.append("  per-rank step time (window-boundary attribution):")
        for r in sorted(per, key=str):
            v = per[r]
            mark = f"  straggler x{flags[r]}" if r in flags else ""
            lines.append(f"    rank {r!s:<4} x{len(v):<6} "
                         f"p50 {_fmt_ms(percentile(v, 50)):>12}  "
                         f"max {_fmt_ms(max(v)):>12}{mark}")
    if deaths:
        lines.append(f"  rank deaths            {deaths}")
    lines.append("")
    return lines


def _audit_lines(manifest) -> list:
    """``manifest["audit"]`` (``analysis/audit.py::record_audit``): the
    verdict, each program's rules and chain depth, any findings.  [] when
    the manifest holds no audit."""
    audit = (manifest or {}).get("audit")
    if not isinstance(audit, dict):
        return []
    lines = ["== program audit =="]
    verdict = "CLEAN" if audit.get("clean") else "DIRTY"
    lines.append(f"  {verdict}: {audit.get('n_programs', 0)} programs, "
                 f"{audit.get('n_findings', 0)} findings, "
                 f"{audit.get('n_waived', 0)} waived")
    for prog, rec in sorted((audit.get("programs") or {}).items()):
        rules = rec.get("rules") or {}
        failed = sorted(r for r, v in rules.items() if v == "fail")
        waived = sorted(r for r, v in rules.items() if v == "waived")
        status = "FAIL " + ",".join(failed) if failed else "pass"
        if waived:
            status += f"  (waived {','.join(waived)})"
        depth = rec.get("chain_depth")
        lines.append(f"  {prog:<28} depth {depth!s:<4} {status}")
    for f in audit.get("findings") or []:
        lines.append(f"    !! {f.get('program')}: [{f.get('rule')}] "
                     f"{f.get('message')}")
    ladder = audit.get("ladder")
    if ladder:
        lines.append(f"  strategy depth ladder    {ladder}")
    lines.append("")
    return lines


def _attribution_lines(manifest) -> list:
    """``manifest["attribution"]`` (``--audit-zoo`` with a telemetry
    directory): each program's analytic FLOPs, HBM and wire bytes with
    its roofline side, the measured join when present, and overlap's
    exposed-comm bound against ddp.  [] when the manifest holds none."""
    attr = (manifest or {}).get("attribution")
    if not isinstance(attr, dict):
        return []
    lines = ["== attribution (static cost model) =="]
    progs = attr.get("programs") or {}
    if progs:
        lines.append(f"  {'program':<28} {'gflops':>9} {'hbm_mib':>9} "
                     f"{'wire_mib':>9}  bound      comm/compute")
        for name, rec in sorted(progs.items()):
            ratio = rec.get("comm_compute_ratio")
            lines.append(
                f"  {name:<28} {rec.get('gflops', 0):>9} "
                f"{rec.get('hbm_mib', 0):>9} {rec.get('wire_mib', 0):>9}  "
                f"{rec.get('roofline_bound', '?'):<9}  "
                f"{ratio if ratio is not None else '-'}")
    measured = attr.get("measured")
    if isinstance(measured, dict):
        lines.append(f"  measured join          {measured.get('program')}: "
                     f"{measured.get('images_per_sec_per_chip')} img/s/chip, "
                     f"mfu {measured.get('mfu_vs_bf16_peak')}, "
                     f"{measured.get('roofline_bound')}-bound")
    ov = attr.get("overlap_vs_ddp")
    if isinstance(ov, dict):
        lines.append(f"  overlap exposed comm   <= "
                     f"{ov.get('overlap_exposed_bytes_upper_bound')} B vs "
                     f"ddp chained {ov.get('ddp_chained_bytes')} B "
                     f"(hiding ratio >= {ov.get('hiding_ratio_lower_bound')})")
    lines.append("")
    return lines


def _memory_lines(events, manifest) -> list:
    """The ``memory`` gauges (peak host RSS, live device MiB) against the
    static peak the audit certifies for each program (``peak_mib``): a
    measured residency above the fattest certified peak is flagged.  []
    for runs with neither."""
    rss, live_mib, live_n = [], [], []
    for e in events:
        if e.get("kind") != "gauge" or e.get("name") != "memory":
            continue
        v = e.get("value")
        if not isinstance(v, dict):
            continue
        if "host_rss_peak_mib" in v:
            rss.append(v["host_rss_peak_mib"])
        if "device_live_mib" in v:
            live_mib.append(v["device_live_mib"])
        if "device_live_arrays" in v:
            live_n.append(v["device_live_arrays"])
    certified = {}
    for prog, rec in (((manifest or {}).get("audit") or {})
                      .get("programs") or {}).items():
        if isinstance(rec, dict) and rec.get("peak_mib") is not None:
            certified[prog] = rec["peak_mib"]
    if not rss and not live_mib and not certified:
        return []
    lines = ["== memory (measured vs certified) =="]
    if live_mib:
        lines.append(f"  device live (gauge)    x{len(live_mib):<6} "
                     f"max {max(live_mib):10.2f} MiB  "
                     f"last {live_mib[-1]:10.2f} MiB"
                     + (f"  ({live_n[-1]} arrays)" if live_n else ""))
    if rss:
        lines.append(f"  host RSS peak          x{len(rss):<6} "
                     f"max {max(rss):10.1f} MiB")
    if certified:
        fattest = max(certified, key=certified.get)
        lines.append(f"  certified peak (max)   {certified[fattest]:10.3f} "
                     f"MiB  ({fattest}, static liveness bound)")
        if live_mib:
            if max(live_mib) <= certified[fattest]:
                lines.append(f"  verdict                measured within "
                             f"certificate (headroom "
                             f"{certified[fattest] - max(live_mib):.2f} MiB)")
            else:
                lines.append(f"  !! measured device residency "
                             f"{max(live_mib):.2f} MiB EXCEEDS the "
                             f"certified peak — liveness model missed "
                             f"a buffer")
    lines.append("")
    return lines


def _trace_lines(events) -> list:
    """Request causality: the trace ids on the enqueue and dispatch spans,
    and client latency split into queue wait and service time.  [] for
    runs with no trace signal."""
    trace_reqs = set()
    dispatch_spans = 0
    dispatch_traced = 0
    qw, svc = [], []
    for e in events:
        kind, name = e.get("kind"), e.get("name")
        if kind == "span" and name == "serve_enqueue" and "trace" in e:
            trace_reqs.add(e["trace"])
        elif kind == "span" and name == "serve_dispatch":
            dispatch_spans += 1
            if e.get("traces"):
                dispatch_traced += 1
        elif kind == "gauge" and name == "serve_queue_wait_ms":
            qw.append(e["value"])
        elif kind == "gauge" and name == "serve_service_ms":
            svc.append(e["value"])
    if not trace_reqs and not qw and not svc:
        return []
    lines = ["== traces (request causality) =="]
    if trace_reqs:
        lines.append(f"  traced requests        {len(trace_reqs)}")
    if dispatch_spans:
        lines.append(f"  dispatch spans         {dispatch_spans} "
                     f"({dispatch_traced} carrying trace ids)")
    for label, v in (("queue wait", qw), ("service time", svc)):
        if v:
            lines.append(f"  {label:<12} x{len(v):<6} "
                         f"p50 {percentile(v, 50):8.2f} ms  "
                         f"p95 {percentile(v, 95):8.2f} ms  "
                         f"mean {sum(v) / len(v):8.2f} ms")
    lines.append("")
    return lines


def _slo_lines(events) -> list:
    """Per-tier attainment from the scheduler's ``serve_latency_ms``
    gauges (``tier``/``met`` attrs), sheds by tier and reason, failovers
    and each replica's utilization.  [] for runs with no SLO signal."""
    tiers = {}
    shed_reasons = {}
    failovers = 0
    deaths = 0
    util = {}
    for e in events:
        kind, name = e.get("kind"), e.get("name")
        if kind == "gauge" and name == "serve_latency_ms" and "met" in e \
                and "tier" in e:
            agg = tiers.setdefault(e["tier"], {"served": 0, "met": 0,
                                                 "shed": 0})
            agg["served"] += 1
            agg["met"] += 1 if e["met"] else 0
        elif kind == "counter" and name == "serve_shed":
            if "tier" in e:
                agg = tiers.setdefault(e["tier"], {"served": 0, "met": 0,
                                                     "shed": 0})
                agg["shed"] += int(e.get("inc", 1))
            reason = str(e.get("reason", "unknown"))
            shed_reasons[reason] = shed_reasons.get(reason, 0) \
                + int(e.get("inc", 1))
        elif kind == "counter" and name == "serve_failover":
            failovers += int(e.get("inc", 1))
        elif kind == "counter" and name == "replica_death":
            deaths += int(e.get("inc", 1))
        elif kind == "gauge" and name == "replica_util" and "replica" in e:
            util[e["replica"]] = e["value"]
    if not tiers and not shed_reasons and not util:
        return []
    lines = ["== slo (tiered attainment) =="]
    for tier in sorted(tiers):
        agg = tiers[tier]
        offered = agg["served"] + agg["shed"]
        att = agg["met"] / offered if offered else 0.0
        lines.append(f"  tier {tier!s:<4} served {agg['served']:<6} "
                     f"met {agg['met']:<6} late "
                     f"{agg['served'] - agg['met']:<5} "
                     f"shed {agg['shed']:<5} attainment {att:7.2%}")
    if shed_reasons:
        detail = ", ".join(f"{r} {n}" for r, n in sorted(shed_reasons.items()))
        lines.append(f"  shed by reason         {detail}")
    if deaths or failovers:
        lines.append(f"  replica deaths         {deaths} "
                     f"({failovers} requests failed over)")
    if util:
        detail = "  ".join(f"r{k} {v:.2f}" for k, v in sorted(util.items()))
        lines.append(f"  replica utilization    {detail}")
    lines.append("")
    return lines


_PUBLISH_COUNTERS = ("publish_count", "publish_installed", "publish_rejected",
                     "publish_stale_skipped", "publish_chaos_injected",
                     "weights_installed")


def _publish_lines(events) -> list:
    """Weight hot-swap: the publisher's and the watcher's counters,
    per-replica ``swap_ms`` percentiles, and the last published and
    installed versions.  [] for runs with no publish signal."""
    counts = {}
    swap_ms = []
    published = installed = None
    for e in events:
        kind, name = e.get("kind"), e.get("name")
        if kind == "counter" and name in _PUBLISH_COUNTERS:
            counts[name] = e["total"]
        elif kind == "gauge" and name == "swap_ms":
            swap_ms.append(e["value"])
        elif kind == "gauge" and name == "publish_version":
            published = e["value"]
        elif kind == "gauge" and name == "installed_version":
            installed = e["value"]
    if not counts and not swap_ms and published is None \
            and installed is None:
        return []
    lines = ["== publish (weight hot-swap) =="]
    for name in _PUBLISH_COUNTERS:
        if name in counts:
            lines.append(f"  {name:<22} {counts[name]}")
    if published is not None or installed is not None:
        lines.append(f"  version                published {published}  "
                     f"installed {installed}")
    if swap_ms:
        lines.append(f"  swap latency x{len(swap_ms):<6} "
                     f"p50 {percentile(swap_ms, 50):8.2f} ms  "
                     f"p99 {percentile(swap_ms, 99):8.2f} ms  "
                     f"max {max(swap_ms):8.2f} ms")
    lines.append("")
    return lines


def _pipeline_lines(events) -> list:
    """The scheduler's ``serve_inflight`` gauge (each replica's pipeline
    occupancy after every issue and completion) as a distribution, and
    ``serve_dispatch_fault`` (faults isolated to one batch).  [] for runs
    with no pipeline signal."""
    occ = {}
    faults = 0
    for e in events:
        kind, name = e.get("kind"), e.get("name")
        if kind == "gauge" and name == "serve_inflight":
            per = occ.setdefault(e.get("replica", "?"), {})
            v = int(e.get("value", 0))
            per[v] = per.get(v, 0) + 1
        elif kind == "counter" and name == "serve_dispatch_fault":
            faults += int(e.get("inc", 1))
    if not occ and not faults:
        return []
    lines = ["== dispatch pipeline =="]
    for replica in sorted(occ, key=str):
        per = occ[replica]
        n = sum(per.values())
        detail = "  ".join(f"{d} slots {per[d] / n:.0%}"
                           for d in sorted(per))
        lines.append(f"  replica {replica!s:<4} occupancy x{n:<6} "
                     f"max {max(per)}  {detail}")
    if faults:
        lines.append(f"  dispatch faults        {faults} "
                     f"(isolated: error replies, worker survived)")
    lines.append("")
    return lines


def _waterfall_lines(out_dir: str, events) -> list:
    """This one stream's request waterfalls (``obs/aggregate.py``), when
    the run holds ``trace_id``-stamped spans; ``python -m
    cs744_ddp_tpu_torch.obs.aggregate`` merges several directories with
    their clock skew.  [] for untraced runs."""
    if not any(e.get("kind") == "span" and e.get("trace_id")
               for e in events):
        return []
    rep = aggregate.aggregate_streams(
        [aggregate.ProcessStream(
            os.path.basename(os.path.normpath(out_dir)) or out_dir,
            events)])
    lines = ["== waterfall (distributed traces, this stream) =="]
    lines.append(f"  traces                 {rep['traces']} "
                 f"({rep['complete']} complete, {rep['orphaned']} "
                 f"orphaned/partial)")
    for stage, a in rep["stage_ms"].items():
        lines.append(f"  {stage:<16} x{a['count']:<6} "
                     f"p50 {a['p50']:8.2f} ms  p99 {a['p99']:8.2f} ms")
    dom = rep["critical_path"].get("dominant")
    if dom:
        share = rep["critical_path"]["share"].get(dom)
        lines.append(f"  critical path          {dom} "
                     f"({share:.0%} of stage time)")
    lines.append("")
    return lines


def _alert_lines(events) -> list:
    """``kind: "alert"`` records (``obs/alerts.py``) grouped by rule id.
    [] for runs with no alerts."""
    by_rule = {}
    for e in events:
        if e.get("kind") != "alert":
            continue
        agg = by_rule.setdefault(e.get("rule", "?"), {
            "count": 0, "severity": e.get("severity", "?"),
            "first_t": e.get("t")})
        agg["count"] += 1
        agg["last_t"] = e.get("t")
    if not by_rule:
        return []
    lines = ["== alerts =="]
    for rule, agg in sorted(by_rule.items()):
        span_s = (agg["last_t"] or 0) - (agg["first_t"] or 0)
        lines.append(f"  {rule:<14} [{agg['severity']}]  x{agg['count']:<5}"
                     f" over {span_s:.1f} s")
    lines.append("")
    return lines


def _summary(manifest, events, summary):
    """``summary.json``, or the summary of the events when the run has
    none (an interrupted run)."""
    if summary is not None:
        return summary
    return summarize_events(
        events, global_batch=(manifest or {}).get("global_batch"))


def render(out_dir: str) -> str:
    """The report of the run directory ``out_dir``, as one string."""
    manifest, events, summary = read_run(out_dir)
    # A preempted or killed run may end in a torn event line: count it
    # and say so rather than fail (the report may be the only diagnostic
    # such a run leaves).
    _, n_bad = read_events_jsonl(
        os.path.join(out_dir, "events.jsonl"),
        warn=lambda msg: print(f"warning: {msg}", file=sys.stderr))
    summary = _summary(manifest, events, summary)
    lines = [f"telemetry run: {out_dir}", ""]
    if n_bad:
        lines.append(f"  !! {n_bad} undecodable event line(s) skipped "
                     f"(run killed mid-write?)")
        lines.append("")

    if manifest:
        lines.append("== run manifest ==")
        for k in MANIFEST_ORDER:
            if k in manifest:
                lines.append(f"  {k:<22} {manifest[k]}")
        native = manifest.get("native_loader")
        if native is not None:
            status = "available" if native.get("available") else \
                f"UNAVAILABLE ({native.get('error')})"
            lines.append(f"  {'native_loader':<22} {status}")
        lines.append("")

    lines.append("== steady-state steps ==")
    lines.append(f"  steps recorded         {summary.get('num_steps', 0)} "
                 f"({summary.get('num_steady_steps', 0)} steady)")
    st = summary.get("steady_step_time_s")
    if st:
        for q in ("p50", "p95", "p99", "mean", "min", "max"):
            lines.append(f"  step time {q:<12} {_fmt_ms(st[q])}")
    ips = summary.get("steady_images_per_sec")
    if ips:
        lines.append(f"  images/sec             {ips:,.0f}")
    if "final_loss" in summary:
        lines.append(f"  final loss             {summary['final_loss']:.4f}")
    lines.append("")

    if summary.get("spans"):
        lines.append("== spans (total wall clock) ==")
        for name, agg in sorted(summary["spans"].items(),
                                key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"  {name:<22} x{agg['count']:<5} "
                         f"{_fmt_ms(agg['total_s'])}")
        lines.append("")

    if summary.get("counters"):
        lines.append("== counters (final) ==")
        for name, total in sorted(summary["counters"].items()):
            lines.append(f"  {name:<34} {total}")
        lines.append("")

    lines.extend(_wire_ext_lines(events))
    lines.extend(_serving_lines(events))
    lines.extend(_elastic_lines(events, manifest))
    lines.extend(_audit_lines(manifest))
    lines.extend(_attribution_lines(manifest))
    lines.extend(_memory_lines(events, manifest))
    lines.extend(_trace_lines(events))
    lines.extend(_slo_lines(events))
    lines.extend(_publish_lines(events))
    lines.extend(_pipeline_lines(events))
    lines.extend(_waterfall_lines(out_dir, events))
    lines.extend(_alert_lines(events))

    gauges = {}
    for e in events:
        if e.get("kind") == "gauge":
            gauges[e["name"]] = e["value"]   # last write wins
    if gauges:
        lines.append("== gauges (last value) ==")
        for name, value in sorted(gauges.items()):
            lines.append(f"  {name:<22} {value}")
        lines.append("")

    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="render a --telemetry-out run directory")
    p.add_argument("run_dir", help="directory holding manifest.json / "
                                   "events.jsonl / summary.json")
    p.add_argument("--json", action="store_true",
                   help="emit the (re)computed summary as JSON instead of "
                        "the human table")
    args = p.parse_args(argv)
    if not os.path.isdir(args.run_dir):
        p.error(f"not a directory: {args.run_dir}")
    if args.json:
        print(json.dumps(_summary(*read_run(args.run_dir)), indent=2))
    else:
        print(render(args.run_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
