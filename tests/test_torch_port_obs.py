"""The port's serving observability (cs744_ddp_tpu_torch/obs/alerts.py,
obs/aggregate.py, the CLI's ``--serve-alerts``), on the CPU, against the
reference package's.

  * (a) The alert engine: the reference's drill event lists (a healthy
    run, the slow replica, the torn publish, the time-driven publish lag
    that cools down on event time, a replica that joins late and
    straggles) through both packages' ``AlertEngine``s give the same
    ``(rule, severity, t, attrs)`` sequence, the same ``summary()`` and the
    same alert records; live (``observe``) and replayed (``run``) alike.
  * (b) The live tap drill on the port's CPU replicas: ``slow_replica`` on
    replica 0, shedding off, an unmeetable SLO: exactly ``SLO_BURN`` and
    ``STRAGGLER`` fire, as ``kind: "alert"`` records in the stream.
  * (c) Aggregation: the same synthetic client and server streams (skewed
    clocks, asymmetric legs; rotated and torn files; only rotated
    generations; a cost-model prior) give equal reports and renderings
    from both packages.
  * (d) Two processes: the port's front-end, and ``python -m
    cs744_ddp_tpu_torch.serve.load replay --telemetry-out`` in a second
    process, reconstruct skew-corrected waterfalls that span both;
    ``tools/trace_waterfall.py --json`` over the two directories equals
    ``python -m cs744_ddp_tpu_torch.obs.aggregate --json``.
  * (e) The CLI: ``--serve-frontend --serve-alerts on`` puts the summary in
    the JSON line and the manifest; ``tools/telemetry_report.py`` renders
    ``== alerts ==``; ``--serve-alerts off`` attaches nothing.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cs744_ddp_tpu.obs import AlertEngine as JAlertEngine
from cs744_ddp_tpu.obs import Telemetry as JTelemetry
from cs744_ddp_tpu.obs import aggregate as jagg
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.data import cifar10
from cs744_ddp_tpu_torch.ft import ChaosPlan
from cs744_ddp_tpu_torch.models import vgg as tvgg
from cs744_ddp_tpu_torch.obs import AlertEngine, Telemetry, TraceContext
from cs744_ddp_tpu_torch.obs import aggregate
from cs744_ddp_tpu_torch.serve import EngineReplica, ReplicaRouter
from cs744_ddp_tpu_torch.serve.frontend import LoopbackClient, ServingFrontend

import torch_dist_worker as worker

tvgg.CFG["VGGT"] = worker.NARROW_VGG
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the narrow model's ops are too
    small to share out, and the suite runs its files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) the alert engine against the reference's -----------------------------

def _healthy_events(t0=0.0):
    evs = []
    for i in range(80):
        t = t0 + 0.05 * i
        evs.append({"kind": "gauge", "name": "serve_latency_ms", "t": t,
                    "value": 5.0, "met": True, "tier": 0})
        evs.append({"kind": "gauge", "name": "serve_queue_depth", "t": t,
                    "value": 4, "replica": i % 2})
        evs.append({"kind": "gauge", "name": "serve_service_ms", "t": t,
                    "value": 2.0 + (i % 2), "replica": i % 2})
    evs.append({"kind": "gauge", "name": "publish_version", "t": t0 + 4.0,
                "value": 3})
    evs.append({"kind": "gauge", "name": "installed_version",
                "t": t0 + 4.1, "value": 3})
    return evs


def _slow_replica_events():
    evs = []
    for i in range(70):
        t = 0.1 * i
        evs.append({"kind": "gauge", "name": "serve_service_ms", "t": t,
                    "value": 500.0 if i % 2 == 0 else 5.0,
                    "replica": i % 2})
        evs.append({"kind": "gauge", "name": "serve_latency_ms", "t": t,
                    "value": 400.0, "met": False, "tier": 0})
    return evs


def _publish_torn_events():
    return _healthy_events() + [{"kind": "counter", "name":
                                 "publish_rejected", "t": 4.2, "inc": 1,
                                 "why": "crc"}]


def _publish_lag_events():
    evs = [{"kind": "gauge", "name": "publish_version", "t": 0.0,
            "value": 2},
           {"kind": "gauge", "name": "installed_version", "t": 0.1,
            "value": 1}]
    return evs + [{"kind": "gauge", "name": "serve_queue_depth", "t": t,
                   "value": 1} for t in (2.0, 6.0, 7.0, 12.0)]


def _late_joiner_events():
    """Replicas 0 and 1 serve alike; replica 2 appears later and is slow:
    the detector grows from world 2 to 3, keeping the first two's
    EWMAs and counts, and flags replica 2 alone.  Shed and NaN counters
    ride along."""
    evs = []
    for i in range(12):
        evs.append({"kind": "gauge", "name": "serve_service_ms",
                    "t": 0.1 * i, "value": 4.0 + (i % 2), "replica": i % 2})
    for i in range(8):
        t = 1.2 + 0.1 * i
        evs.append({"kind": "gauge", "name": "serve_service_ms", "t": t,
                    "value": 60.0, "replica": 2})
        evs.append({"kind": "gauge", "name": "serve_service_ms", "t": t,
                    "value": 4.0, "replica": i % 2})
    evs.append({"kind": "counter", "name": "serve_shed", "t": 2.1,
                "inc": 3, "tier": 1})
    evs.append({"kind": "counter", "name": "nonfinite_skipped", "t": 2.2,
                "inc": 1})
    evs.append({"kind": "gauge", "name": "serve_queue_depth", "t": 2.3,
                "value": 300})
    return evs


DRILLS = {
    "healthy": (_healthy_events, {}, []),
    "slow_replica": (_slow_replica_events, {}, ["SLO_BURN", "STRAGGLER"]),
    "publish_torn": (_publish_torn_events, {}, ["PUBLISH_LAG"]),
    "publish_lag": (_publish_lag_events,
                    {"publish_lag_s": 5.0, "cooldown_s": 5.0},
                    ["PUBLISH_LAG"]),
    "late_joiner": (_late_joiner_events, {},
                    ["NONFINITE", "QUEUE_DEPTH", "STRAGGLER"]),
}


def _alerts(engine):
    return [(a.rule, a.severity, a.t, a.attrs) for a in engine.alerts]


def _alert_records(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records
            if r.get("kind") == "alert"]


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_alert_drills_match_reference(drill):
    make, kw, fired = DRILLS[drill]
    evs = make()
    tel, jtel = Telemetry(), JTelemetry()
    live, ref = AlertEngine(tel, **kw), JAlertEngine(jtel, **kw)
    got = [(a.rule, a.t) for e in evs for a in live.observe(e)]
    want = [(a.rule, a.t) for e in evs for a in ref.observe(e)]
    assert got == want
    assert _alerts(live) == _alerts(ref)
    assert live.fired_rules() == ref.fired_rules() == fired
    assert live.summary() == ref.summary()
    assert _alert_records(tel.records) == _alert_records(jtel.records)
    assert len(_alert_records(tel.records)) == len(live.alerts)
    replay = AlertEngine(**kw)
    assert [(a.rule, a.t) for a in replay.run(evs)] == got
    if drill == "publish_lag":        # event time: t=6 then t=12
        assert got == [("PUBLISH_LAG", 6.0), ("PUBLISH_LAG", 12.0)]
    if drill == "late_joiner":
        det = live._detector
        assert det.world == 3 and det._count == [10, 10, 8]
        assert {a.attrs["replica"] for a in live.alerts
                if a.rule == "STRAGGLER"} == {2}


# -- (b) the live tap drill on the port's CPU replicas ------------------------

def test_alert_live_tap_slow_replica_chaos():
    pool = cifar10._synthetic_split(8, seed=3)
    tel = Telemetry()
    alerts = AlertEngine(tel, burn_window=4, straggler_min_steps=1,
                         cooldown_s=0.0)
    tel.add_tap(alerts.observe)
    chaos = ChaosPlan.parse(["slow_replica:0:0"])
    replicas = [EngineReplica(i, "vggt", buckets=(2,), seed=0,
                              device="cpu", chaos=chaos, slow_stall_s=0.3,
                              shed=False, telemetry=tel)
                for i in range(2)]
    for r in replicas:
        r.startup()
    with ReplicaRouter(replicas, telemetry=tel) as router:
        client = LoopbackClient(router, telemetry=tel)
        futs = [client.submit(pool.images[:2], slo_ms=0.01)
                for _ in range(6)]
        statuses = [f.result(WAIT)["status"] for f in futs]
    assert statuses == ["late"] * 6            # served, never dropped
    assert ("slow_replica", 0) in chaos.fired
    assert alerts.fired_rules() == ["SLO_BURN", "STRAGGLER"]
    assert any(a.rule == "STRAGGLER" and a.attrs["replica"] == 0
               for a in alerts.alerts)
    assert any(e.get("kind") == "alert" and e.get("rule") == "SLO_BURN"
               for e in tel.records)


# -- (c) aggregation against the reference's ----------------------------------

def _span(name, t, dur, ctx, **extra):
    return {"kind": "span", "name": name, "t": t, "dur_s": dur,
            **ctx.attrs(), **extra}


def _stream_pair(n=20, offset=5.0, d_req=0.001, d_rep=0.009):
    """Client and server streams with a known clock offset and asymmetric
    legs, every request a full waterfall on the server."""
    client, server = [], []
    for i in range(n):
        root = TraceContext.new_root("client")
        sched = root.child("sched")
        t1 = 100.0 + i
        t2 = t1 + d_req + offset          # server clock
        t3 = t2 + 0.002 + 0.0001 * i
        t4 = (t3 - offset) + d_rep
        client.append(_span("trace_client", t1, t4 - t1, root, trace=i))
        server += [
            _span("frontend_request", t2, t3 - t2, root.child("frontend")),
            _span("wire_decode", t2, 0.0001, root.child("frontend")),
            _span("sched_queue", t2 + 0.0001, 0.0003, sched, trace=i,
                  bucket=2 << (i % 2)),
            {"kind": "span", "name": "serve_dispatch", "t": t2 + 0.0005,
             "dur_s": 0.001 * (1 + i % 2), "traces": [i],
             "bucket": 2 << (i % 2)},
            _span("reply_encode", t3 - 0.0002, 0.0001,
                  root.child("frontend"))]
    return client, server


def _write(d, lines, name="events.jsonl", tail=""):
    d.mkdir(exist_ok=True)
    (d / name).write_text("\n".join(json.dumps(e) for e in lines) + "\n"
                          + tail)


def _case_dirs(tmp_path, case):
    client, server = _stream_pair()
    srv, cli_dir = tmp_path / "server", tmp_path / "client"
    if case == "rotated_and_torn":
        _write(srv, server[:40], "events.1.jsonl")
        _write(srv, server[40:], tail='{"kind": "span", "name": "torn')
    elif case == "only_rotated":
        _write(srv, server[:50], "events.2.jsonl")
        _write(srv, server[50:], "events.1.jsonl")
    else:
        _write(srv, server)
    _write(cli_dir, client)
    return [str(srv), str(cli_dir)]


@pytest.mark.parametrize("case", ["plain", "rotated_and_torn",
                                  "only_rotated", "prior"])
def test_aggregation_matches_reference(tmp_path, case):
    dirs = _case_dirs(tmp_path, case)
    kw = {"prior_flops": {2: 1e6, 4: 2e6}} if case == "prior" else {}
    got = aggregate.aggregate_run_dirs(dirs, max_waterfalls=5, **kw)
    want = jagg.aggregate_run_dirs(dirs, max_waterfalls=5, **kw)
    assert got == want
    assert got["complete"] == 20 and got["reference"] == "server"
    assert got["processes"]["client"]["skew_pairs"] == 20
    assert got["processes"]["server"]["bad_lines"] == (
        1 if case == "rotated_and_torn" else 0)
    assert ("cost_prior" in got) == (case == "prior")
    assert aggregate.render(got) == _tool("trace_waterfall").render(want)


# -- (d) two processes: the front-end and the load client ---------------------

def _json_of(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_two_process_waterfall(tmp_path, capsys):
    srv_dir, cli_dir = str(tmp_path / "server"), str(tmp_path / "client")
    stel = Telemetry(srv_dir)
    replica = EngineReplica(0, "vggt", buckets=(2, 4), seed=0, device="cpu",
                            telemetry=stel)
    replica.startup()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    with ReplicaRouter([replica], telemetry=stel) as router:
        with ServingFrontend(router, telemetry=stel) as fe:
            warm = LoopbackClient(router)
            for b in (2, 4):
                warm.submit(np.zeros((b, 32, 32, 3), np.uint8),
                            slo_ms=None).result(WAIT)
            proc = subprocess.run(
                [sys.executable, "-m", "cs744_ddp_tpu_torch.serve.load",
                 "replay", "--port", str(fe.address[1]), "--rps", "40",
                 "--requests", "12", "--max-size", "4",
                 "--telemetry-out", cli_dir, "--timeout", "60"],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=180)
    assert proc.returncode == 0, proc.stderr[-800:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["replies"] == 12 and stats["unresolved"] == 0
    stel.finalize()
    report = aggregate.aggregate_run_dirs([srv_dir, cli_dir])
    assert report["reference"] == "server"
    cli_proc = report["processes"]["client"]
    assert cli_proc["skew_estimated"] and cli_proc["skew_pairs"] >= 10
    assert report["complete"] >= 10
    spanning = [w for w in report["waterfalls"]
                if w["complete"] and set(w["procs"]) == {"client",
                                                         "server"}]
    assert spanning
    for w in spanning:
        assert "device_compute" in w["stages"]
        assert {"client", "frontend", "sched"} <= set(w["origins"])
        assert w["sum_ms"] <= w["client_ms"] + 2e3 * cli_proc["rtt_bound_s"]
    res = report["client_minus_stages_ms"]
    assert -2e3 * cli_proc["rtt_bound_s"] < res["p50"] < 250.0
    argv = [srv_dir, cli_dir, "--json"]
    tool = _json_of(_tool("trace_waterfall").main, argv, capsys)
    mine = _json_of(aggregate.main, argv, capsys)
    assert tool == mine == json.loads(json.dumps(report))


# -- (e) the CLI --------------------------------------------------------------

def _cli(capsys, tmp_path, alerts):
    srv = tmp_path / f"server_{alerts}"
    cli.main(["--serve-frontend", "--device", "cpu", "--model", "vggt",
              "--serve-buckets", "2,4,8", "--serve-replicas", "2",
              "--serve-requests", "80", "--serve-load", "400",
              "--chaos", "slow_replica:0:0", "--serve-shed", "off",
              "--serve-slo-ms", "0.01", "--telemetry-out", str(srv),
              "--serve-alerts", alerts])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, json.loads((srv / "manifest.json").read_text()), str(srv)


def test_cli_serve_alerts(capsys, tmp_path):
    out, man, srv = _cli(capsys, tmp_path, "on")
    st = out["load"]["400rps"]
    assert st["replies"] == 80 and st["unresolved"] == 0
    assert out["alerts"]["fired"] == ["SLO_BURN", "STRAGGLER"]
    assert out["alerts"]["by_rule"]["STRAGGLER"]["last_attrs"][
        "replica"] == 0
    assert man["alerts"] == out["alerts"]
    text = _tool("telemetry_report").render(srv)
    assert "== alerts ==" in text
    assert "SLO_BURN" in text and "STRAGGLER" in text
    out, man, srv = _cli(capsys, tmp_path, "off")
    assert "alerts" not in out and "alerts" not in man
    assert "== alerts ==" not in _tool("telemetry_report").render(srv)
