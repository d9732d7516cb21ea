"""The port's run-directory report (cs744_ddp_tpu_torch/obs/report.py), on
the CPU, against the reference package's ``tools/telemetry_report.py``.

  * (a) Run directories written with the port's ``Telemetry``, one for each
    section's records: a training run; the same run interrupted (no
    ``summary.json``); one whose live event file ends in a torn line after
    a rotated generation; one with only a manifest; elastic; a dirty audit
    with attribution and a memory gauge above the certificate; serving and
    request traces with wire-extension skips; the SLO tier, its pipeline,
    publishing and alerts; traced spans that make waterfalls.  For each,
    the port's ``render`` is the tool's, once the port's ``torch_version``
    and ``cuda_version`` lines are taken out, with the same warnings on
    stderr; ``main([d, "--json"])`` prints the tool's object.
  * (b) A real CPU CLI run of the narrow VGG with ``--audit warn
    --telemetry-out``, held the same way.
  * (c) ``main`` refuses a path that is not a directory, as the tool does.
  * (d) ``python -m cs744_ddp_tpu_torch.obs.report`` runs with ``jax``,
    ``cs744_ddp_tpu`` and ``torch`` blocked (it needs none of them), and
    prints what ``render`` returns.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.models import vgg as tvgg
from cs744_ddp_tpu_torch.obs import Telemetry, TraceContext, read_run, report

import torch_dist_worker as worker

tvgg.CFG["VGGT"] = worker.NARROW_VGG
REPO = worker.REPO
VERSION_KEYS = ("torch_version", "cuda_version")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the narrow model's ops are too
    small to share out, and the suite runs its files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(REPO, "tools",
                                         "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_renders_as_the_tool(run_dir, tool_text):
    """The port's render of ``run_dir`` is ``tool_text`` (the reference
    tool's ``render`` of it) but for the manifest's ``torch_version`` and
    ``cuda_version`` lines, which the tool's key order has no place for.
    Returns the port's render."""
    mine = report.render(str(run_dir)).split("\n")
    manifest = read_run(str(run_dir))[0] or {}
    versions = [f"  {k:<22} {manifest[k]}" for k in VERSION_KEYS
                if k in manifest]
    kept = [line for line in mine if line not in versions]
    assert len(kept) == len(mine) - len(versions)
    assert "\n".join(kept) == tool_text
    return "\n".join(mine)


# -- (a) a run directory for each section -------------------------------------

def _manifest(tel, **extra):
    tel.write_manifest({
        "model": "vggt", "strategy": "allreduce", "world_size": 2,
        "global_batch": 16, "precision": "f32", "augment": True,
        "host_augment": False, "torch_version": torch.__version__,
        "cuda_version": None, "backend": "cpu", "device_kind": "cpu",
        "native_loader": {"available": False, "error": "no g++"},
        "git_sha": "0" * 40, **extra})


def _train(tel):
    _manifest(tel)
    for i in range(1, 26):
        with tel.span("train_window", window=(i - 1) // 20):
            with tel.span("host_augment"):
                pass
        tel.step(epoch=0, iter=i, loss=2.5 - 0.01 * i,
                 step_time=0.010 + 0.0001 * (i % 7), steady=i > 20,
                 step_index=i - 1, grad_sqnorm=1.0 / i)
        tel.gauge("prefetch_depth", i % 3)
    tel.counter("host_round_trips", 2)
    tel.counter("collective_all-reduce_count", 22)
    tel.gauge("memory", {"host_rss_peak_mib": 812.25,
                         "device_live_mib": 3.5, "device_live_arrays": 41})
    tel.gauge("device_memory", {"bytes_in_use": 1024})


def _elastic(tel):
    _manifest(tel, elastic={"protocol": "strong", "microshards": 4})
    for i in range(1, 5):
        tel.step(epoch=0, iter=i, loss=2.0, step_time=0.02, steady=True)
        for r in (0, 1):
            tel.gauge("rank_step_time_s", 0.02 + 0.03 * r, rank=r)
    tel.counter("straggler_flagged", rank=1, step=3)
    tel.counter("straggler_flagged", rank=1, step=4)
    tel.counter("rank_deaths", rank=1, epoch=0, step=4)


def _audit(tel):
    programs = {
        "train/step/allreduce": {"rules": {"host_sync": "pass",
                                           "donation": "fail"},
                                 "chain_depth": 22, "peak_mib": 1.5},
        "train/window/allreduce": {"rules": {"host_sync": "waived",
                                             "donation": "pass"},
                                   "chain_depth": 22, "peak_mib": 2.25},
        "eval/window": {"rules": {}, "chain_depth": 0, "peak_mib": None}}
    _manifest(tel, audit={
        "clean": False, "n_programs": 3, "n_findings": 1, "n_waived": 1,
        "programs": programs, "ladder": {"single": 0, "allreduce": 22},
        "findings": [{"program": "train/step/allreduce",
                      "rule": "donation", "message": "state copied"}]},
        attribution={
            "programs": {"train/step/allreduce": {
                "gflops": 1.25, "hbm_mib": 30.5, "wire_mib": 0.5,
                "roofline_bound": "memory", "comm_compute_ratio": 0.02},
                "eval/window": {"gflops": 0.5, "hbm_mib": 3.0,
                                "wire_mib": 0.0, "roofline_bound":
                                "compute", "comm_compute_ratio": None}},
            "measured": {"program": "train/step/allreduce",
                         "images_per_sec_per_chip": 1234.5,
                         "mfu_vs_bf16_peak": 0.01,
                         "roofline_bound": "memory"},
            "overlap_vs_ddp": {"overlap_exposed_bytes_upper_bound": 100,
                               "ddp_chained_bytes": 400,
                               "hiding_ratio_lower_bound": 0.75}})
    tel.step(epoch=0, iter=1, loss=2.3, step_time=0.01, steady=False)
    for mib in (1.0, 2.75):
        tel.gauge("memory", {"device_live_mib": mib,
                             "host_rss_peak_mib": 700.0})


def _serving(tel):
    tel.write_manifest({"mode": "serve", "buckets": [2, 4]})
    for i in range(30):
        tel.gauge("queue_depth", (i * 7) % 11)
        tel.gauge("serve_latency_ms", 1.0 + 0.37 * i, bucket=2 << (i % 2))
        tel.span_event("serve_enqueue", 10.0 + i, 0.0001, trace=i)
        tel.gauge("serve_queue_wait_ms", 0.2 * i)
        tel.gauge("serve_service_ms", 2.0 + 0.1 * (i % 5), replica=0)
        if i % 3 == 0:
            tel.span_event("serve_dispatch", 10.0 + i, 0.002,
                           traces=[i, i + 1], bucket=4)
    tel.span_event("serve_dispatch", 50.0, 0.002, traces=[], bucket=2)
    tel.counter("wire_ext_skipped", frame="request", unknown=2, torn=0)
    tel.counter("wire_ext_skipped", frame="reply", unknown=0, torn=1)
    tel.counter("wire_ext_skipped", frame="request", unknown=1, torn=1)


def _tier(tel):
    tel.write_manifest({"mode": "serve-frontend", "replicas": 2})
    for i in range(40):
        tel.gauge("serve_latency_ms", 3.0 + i, tier=i % 3, met=i % 4 != 0,
                  bucket=8)
        tel.gauge("serve_inflight", i % 3, replica=i % 2)
    tel.counter("serve_shed", tier=0, reason="deadline")
    tel.counter("serve_shed", 2, tier=2, reason="overload")
    tel.counter("serve_shed", reason="draining")
    tel.counter("serve_failover", 3)
    tel.counter("replica_death", replica=1)
    tel.counter("serve_dispatch_fault", replica=0)
    tel.gauge("replica_util", 0.4375, replica=0)
    tel.gauge("replica_util", 0.125, replica=1)
    for name in ("publish_count", "publish_installed", "publish_rejected",
                 "publish_stale_skipped", "publish_chaos_injected",
                 "weights_installed"):
        tel.counter(name)
    tel.gauge("publish_version", 2)
    tel.gauge("installed_version", 1)
    for ms in (0.9, 1.4, 13.1):
        tel.gauge("swap_ms", ms, replica=0)
    tel.alert("SLO_BURN", "page", tier=0)
    tel.alert("STRAGGLER", "warn", replica=1)
    tel.alert("SLO_BURN", "page", tier=0)


def _waterfall(tel):
    """A client and a server in one stream: each request its client
    round trip and the frontend, queue, dispatch and reply spans
    (``obs/aggregate.py``'s contract), one with its frontend span alone."""
    for i in range(12):
        root = TraceContext.new_root("client")
        fe, sched = root.child("frontend"), root.child("sched")
        t = 100.0 + i
        tel.span_event("frontend_request", t, 0.004 + 0.0002 * i,
                       **fe.attrs())
        if i == 11:
            continue
        tel.span_event("trace_client", t - 0.0005, 0.0052 + 0.0002 * i,
                       trace=i, **root.attrs())
        tel.span_event("wire_decode", t, 0.0001, **fe.attrs())
        tel.span_event("sched_queue", t + 0.0001, 0.0003 * (1 + i % 3),
                       trace=i, **sched.attrs())
        tel.span_event("serve_dispatch", t + 0.001, 0.002, traces=[i],
                       bucket=2)
        tel.span_event("reply_encode", t + 0.0035, 0.0001, **fe.attrs())


def _torn(tel, d):
    _train(tel)
    tel.finalize(global_batch=16)
    live = d / "events.jsonl"
    lines = live.read_text().splitlines(keepends=True)
    (d / "events.1.jsonl").write_text("".join(lines[:30]))
    live.write_text("".join(lines[30:]) + '{"kind": "step", "it')


WRITERS = {"train": _train, "elastic": _elastic, "audit": _audit,
            "serving": _serving, "tier": _tier, "waterfall": _waterfall}


def _write(case, d):
    if case == "manifest_only":
        tel = Telemetry()
        _manifest(tel)
        d.mkdir()
        (d / "manifest.json").write_text(json.dumps(tel.manifest))
        return str(d)
    tel = Telemetry(str(d))
    if case == "torn":
        _torn(tel, d)
    else:
        WRITERS["train" if case == "interrupted" else case](tel)
        tel.finalize(global_batch=16)
    if case == "interrupted":        # a run cut before its summary
        os.unlink(d / "summary.json")
    return str(d)


SECTIONS = {
    "train": ["== run manifest ==", "== steady-state steps ==",
              "== spans (total wall clock) ==", "== counters (final) ==",
              "== memory (measured vs certified) ==",
              "== gauges (last value) =="],
    "interrupted": ["== run manifest ==", "== spans (total wall clock) ==",
                    "== memory (measured vs certified) =="],
    "torn": ["undecodable event line(s) skipped", "== run manifest =="],
    "manifest_only": ["== run manifest ==", "== steady-state steps =="],
    "elastic": ["== elastic ==", "straggler x2", "rank deaths"],
    "audit": ["== program audit ==", "DIRTY", "FAIL donation",
              "== attribution (static cost model) ==", "EXCEEDS"],
    "serving": ["== wire extension skips ==", "== serving ==",
                "== traces (request causality) =="],
    "tier": ["== slo (tiered attainment) ==", "== dispatch pipeline ==",
             "== publish (weight hot-swap) ==", "== alerts ==",
             "replica deaths"],
    "waterfall": ["== waterfall (distributed traces, this stream) ==",
                  "critical path"],
}


@pytest.mark.parametrize("case", sorted(SECTIONS))
def test_render_equals_the_tool(tmp_path, capsys, case):
    d = _write(case, tmp_path / case)
    tool = _tool()
    want = tool.render(d)
    tool_err = capsys.readouterr().err
    text = assert_renders_as_the_tool(d, want)
    assert capsys.readouterr().err == tool_err
    assert (tool_err != "") == (case == "torn")
    for header in SECTIONS[case]:
        assert header in text, text
    assert ("summary.json" in os.listdir(d)) == (
        case not in ("interrupted", "manifest_only"))

    assert report.main([d, "--json"]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert tool.main([d, "--json"]) == 0
    assert mine == json.loads(capsys.readouterr().out)
    assert report.main([d]) == 0
    assert capsys.readouterr().out == text + "\n"


# -- (b) the CLI --------------------------------------------------------------

def test_cli_run_directory_renders_as_the_tool(tmp_path, capsys):
    run = str(tmp_path / "run")
    cli.main(["--device", "cpu", "--model", "vggt", "--strategy",
              "allreduce", "--batch-size", "8", "--limit-train-batches",
              "22", "--limit-eval-batches", "1", "--data-dir",
              worker.ASSETS, "--audit", "warn", "--telemetry-out", run])
    capsys.readouterr()
    text = assert_renders_as_the_tool(run, _tool().render(run))
    manifest, events, summary = read_run(run)
    assert f"  torch_version          {torch.__version__}" in text
    steps = [e for e in events if e["kind"] == "step"]
    assert f"steps recorded         {len(steps)} " \
        f"({summary['num_steady_steps']} steady)" in text
    for header in ("== run manifest ==", "== program audit ==",
                   "== memory (measured vs certified) ==",
                   "== counters (final) =="):
        assert header in text
    assert "  CLEAN: " in text
    assert report.main([run, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == summary


# -- (c) the refusal ----------------------------------------------------------

def test_main_refuses_a_path_that_is_not_a_directory(tmp_path, capsys):
    f = tmp_path / "events.jsonl"
    f.write_text("")
    for path in (str(f), str(tmp_path / "absent")):
        with pytest.raises(SystemExit) as exc:
            report.main([path])
        assert exc.value.code == 2
        assert f"not a directory: {path}" in capsys.readouterr().err


# -- (d) no JAX ---------------------------------------------------------------

def test_module_runs_without_jax_or_torch(tmp_path):
    d = _write("waterfall", tmp_path / "waterfall")
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['cs744_ddp_tpu'] = None\n"
            "sys.modules['torch'] = None\n"
            "sys.argv = ['report'] + sys.argv[1:]\n"
            "runpy.run_module('cs744_ddp_tpu_torch.obs.report', "
            "run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, d], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr == ""
    assert proc.stdout == report.render(d) + "\n"
