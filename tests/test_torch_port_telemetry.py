"""The port's training telemetry (cs744_ddp_tpu_torch/obs/telemetry.py, the
Trainer's records in train/loop.py, utils/metrics.py, the CLI's
``--telemetry-out`` and ``--profile-dir``), on the CPU, against the
reference package's.

  * (a) The recorder: the same calls to the reference's ``Telemetry`` and
    the port's, in memory, file-backed and rotating, give the same
    records, manifest and summary apart from wall-clock fields; the
    readers and ``percentile`` agree on rotated and torn files.
  * (b) ``NULL`` makes no writes and holds no state.
  * (c) The port's Trainer prints the same lines with telemetry on and
    off, and its event stream is the reference Trainer's for the same
    configuration and weights (narrow VGG, augmentation off): the same
    steps, ``iter``, ``epoch``, ``steady`` and ``step_index``, losses and
    ``grad_sqnorm`` within the window tests' tolerances over the first 3
    steps (ROADMAP queue 3: near-tie drift beyond), and the same span,
    counter and gauge names, windowed and per-step; (d) the same names on
    the ``host_augment`` path.
  * (e) ``--nonfinite skip`` with ``nonfinite_grad`` and ``preempt``
    chaos: the same fault counters at the same steps as the reference.
  * (f) The CLI's run directory, rendered by the reference's
    ``tools/telemetry_report.py`` and, the same, by the port's
    ``obs.report``, also without ``summary.json``;
    (g) ``--profile-dir`` writes a Chrome trace.
  * (h) World 2 over gloo (the CLI's ranks): rank 0 alone writes, every
    rank's step time is there, and the collective counters against the
    reference's ``_emit_collective_telemetry``; the elastic CLI's
    directory across its generations.
"""

import builtins
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax

import cs744_ddp_tpu.ft as jft
from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.obs import telemetry as jtel
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.train import loop as jloop
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.obs import NULL, NullTelemetry, Telemetry
from cs744_ddp_tpu_torch.obs import telemetry as ttel
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.train import loop

import torch_dist_worker as worker
from test_torch_port_report import assert_renders_as_the_tool

LR = 0.01
BATCH = 8
STEPS = 40          # two 20-step windows: one window shape to compile
FIRST = 3           # steps held to the reference's values
LOSS_RTOL, GSQ_RTOL = 1e-3, 1e-2   # test_torch_port_window.py's bounds

jvgg.CFG["VGGT"] = worker.NARROW_VGG
tvgg.CFG["VGGT"] = worker.NARROW_VGG
jmodels.register_model("vggt", lambda: jvgg.make("VGGT"))

WALL_CLOCK = ("t", "dur_s", "created_at")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the narrow model's ops are too
    small to share out, and the suite runs its files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the recorder --------------------------------------------------------

def _drive(mod, tel):
    """One scripted sequence of every recorder call; the summary."""
    tel.write_manifest({"model": "vggt", "world_size": 2})
    tel.step(epoch=0, iter=1, loss=2.5, step_time=0.02, forward_time=0.004)
    for i in range(30):
        tel.step(epoch=0, iter=i + 2, loss=2.0 - i / 50, step_time=0.001 * (
            1 + i % 7), steady=i >= 19, grad_sqnorm=300.0 + i,
            step_index=i + 1)
    with tel.span("train_window", strategy="allreduce", start=0, batches=20):
        with tel.span("compile_warmup", program="train_window"):
            pass
    with pytest.raises(ValueError):
        with tel.span("eval"):
            raise ValueError("boom")
    worker_thread = threading.Thread(
        target=lambda: tel.span("host_augment").__enter__().__exit__(
            None, None, None))
    with tel.span("chunk_wait"):
        worker_thread.start()
        worker_thread.join(timeout=10)
    tel.span_event("client_rtt", 100.0, 0.25, trace_id="t1")
    for r in (0, 1, 0, 1):
        tel.gauge("rank_step_time_s", 0.01 * (r + 1), rank=r, epoch=0)
    tel.gauge("memory", {"host_rss_peak_mib": 12.5}, epoch=0, step=20)
    tel.gauge("serve_queue_wait_ms", 3.0)
    tel.gauge("serve_service_ms", 7.0)
    tel.gauge("serve_latency_ms", 9.0, tier="gold", met=True)
    tel.counter("serve_shed", 1, tier="gold", reason="overload")
    for site in ("window_drain", "eval"):
        tel.counter("host_round_trips", 1, site=site)
    tel.counter("collective_all-reduce_count", 34)
    tel.alert("staging_stall", "warn", step=3)
    tel.update_manifest({"cuda_kernels": {}})
    return tel.finalize(global_batch=BATCH, extra_field=1)


def _strip(rec):
    """A record without its wall-clock fields."""
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items()
                if k not in WALL_CLOCK and k != "total_s"}
    if isinstance(rec, list):
        return [_strip(v) for v in rec]
    return rec


@pytest.mark.parametrize("backing", ["memory", "file", "rotated"])
def test_recorder_matches_reference(tmp_path, backing):
    out = {}
    for name, mod in (("ref", jtel), ("port", ttel)):
        kw = {"rotate_bytes": 2048, "rotate_keep": 2} \
            if backing == "rotated" else {}
        d = None if backing == "memory" else str(tmp_path / name)
        tel = mod.Telemetry(d, **kw)
        summary = _drive(mod, tel)
        if d is None:
            records = tel.records
            files = []
        else:
            records, bad = mod.read_events_jsonl(
                os.path.join(d, "events.jsonl"))
            assert bad == 0
            files = sorted(os.listdir(d))
            with open(os.path.join(d, "manifest.json")) as f:
                assert json.load(f) == tel.manifest
            with open(os.path.join(d, "summary.json")) as f:
                assert json.load(f) == summary
        out[name] = (records, tel.manifest, summary, files)
    (r_ref, m_ref, s_ref, f_ref), (r_port, m_port, s_port, f_port) = \
        out["ref"], out["port"]
    assert _strip(r_port) == _strip(r_ref)
    assert _strip(m_port) == _strip(m_ref)
    assert _strip(s_port) == _strip(s_ref)
    assert f_port == f_ref
    if backing == "rotated":
        assert "events.1.jsonl" in f_port and "events.3.jsonl" not in f_port


def _write_events(d, rotated: bool, torn: bool):
    """An events.jsonl (with ``rotated`` predecessors, a ``torn`` last
    line) in ``d``."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    lines = [json.dumps({"kind": "step", "epoch": 0, "iter": i + 1,
                         "loss": float(rng.random()),
                         "step_time_s": float(rng.random() / 100),
                         "steady": i >= 20}) for i in range(45)]
    lines += [json.dumps({"kind": "counter", "name": "host_round_trips",
                          "inc": 1, "total": 1, "site": "eval"})]
    chunks = [lines[:15], lines[15:30], lines[30:]] if rotated \
        else [lines]
    names = ["events.2.jsonl", "events.1.jsonl", "events.jsonl"][-len(
        chunks):]
    for name, chunk in zip(names, chunks):
        with open(os.path.join(d, name), "w") as f:
            f.write("\n".join(chunk) + "\n")
    if torn:
        with open(os.path.join(d, "events.jsonl"), "a") as f:
            f.write('{"kind": "step", "epoch": 0, "it')
    return os.path.join(d, "events.jsonl")


@pytest.mark.parametrize("case", ["plain", "rotated", "torn",
                                  "rotated_torn"])
def test_readers_and_summary_match_reference(tmp_path, case):
    path = _write_events(str(tmp_path), "rotated" in case, "torn" in case)
    warned = {"ref": [], "port": []}
    got = {name: mod.read_events_jsonl(path, warn=warned[name].append)
           for name, mod in (("ref", jtel), ("port", ttel))}
    assert got["port"] == got["ref"]
    assert got["port"][1] == int("torn" in case)
    assert len(warned["port"]) == len(warned["ref"]) == got["port"][1]
    events = got["port"][0]
    assert len(events) == 46
    assert ttel.summarize_events(events, global_batch=BATCH) == \
        jtel.summarize_events(events, global_batch=BATCH)
    assert ttel.read_run(str(tmp_path))[1:] == \
        jtel.read_run(str(tmp_path))[1:]


@pytest.mark.parametrize("values", [
    [4.0, 9.0, 1.0, 6.0, 10.0, 3.0, 7.0, 2.0, 8.0, 5.0], [7.25],
    [0.5, 0.5, 0.5, 2.0], list(np.random.default_rng(3).random(101))])
def test_percentile_matches_reference(values):
    for q in (0, 50, 95, 99, 100):
        assert ttel.percentile(values, q) == jtel.percentile(values, q)
        assert ttel.percentile(values, q) == pytest.approx(
            np.percentile(values, q))
    with pytest.raises(ValueError):
        ttel.percentile([], 50)


# -- (b) the disabled recorder -------------------------------------------------

def test_null_recorder_makes_no_writes_and_holds_no_state(monkeypatch):
    assert isinstance(NULL, NullTelemetry) and NULL.enabled is False
    assert NullTelemetry.__slots__ == ()
    with pytest.raises(AttributeError):
        NULL.records = []
    opened = []
    real_open = builtins.open
    monkeypatch.setattr(builtins, "open",
                        lambda *a, **k: (opened.append(a),
                                         real_open(*a, **k))[1])
    for _ in range(50):
        NULL.step(epoch=0, iter=1, loss=1.0, step_time=0.1)
        NULL.gauge("g", 1)
        NULL.counter("c")
        with NULL.span("s"):
            pass
    NULL.write_manifest({"model": "x"})
    NULL.update_manifest({"elastic_report": {}})
    assert NULL.finalize(global_batch=64) is None
    assert NULL.counter_totals() == {}
    assert opened == []
    assert NULL.span("a") is NULL.span("b") is ttel._NULL_SPAN
    assert NULL.span("chunk_put", batches=3, last=True) is ttel._NULL_SPAN


# -- (c), (d), (e): the Trainer against the reference's ------------------------

def _reference_trainer(**kw):
    args = dict(model="vggt", strategy="single", mesh=make_mesh(1),
                global_batch=BATCH, data_dir=worker.ASSETS, augment=False,
                limit_train_batches=STEPS, limit_eval_batches=1,
                sgd_cfg=jsgd.SGDConfig(lr=LR), log=lambda s: None)
    args.update(kw)
    return jloop.Trainer(**args)


def _weights(reference):
    """The reference Trainer's weights, in the port's layout."""
    return convert.from_jax(
        jax.tree.map(np.asarray, reference.state.params),
        jax.tree.map(np.asarray, reference.state.bn_state))


def _port_trainer(weights=None, strategy="single", **kw):
    """The port's Trainer of the same configuration, from ``weights``
    (``_weights`` of an untrained reference Trainer) when given."""
    args = dict(global_batch=BATCH, data_dir=worker.ASSETS, device="cpu",
                augment=False, limit_train_batches=STEPS,
                limit_eval_batches=1, sgd_cfg=tsgd.SGDConfig(lr=LR),
                log=lambda s: None)
    args.update(kw)
    tr = loop.Trainer("vggt", strategy, **args)
    if weights is not None:
        tr.state.model.load_state_dict(weights)
    return tr


PATHS = {"windowed": {}, "per-step": {"profile_phases": True},
         "host": {"host_augment": True}}


def _normalize(lines):
    """The print schedule without its wall-clock values."""
    return [re.sub(r"is [0-9.e+-]+$", "is <t>", ln) if "time" in ln else ln
            for ln in lines]


@pytest.fixture(scope="module")
def runs():
    """Each path run by the reference's Trainer and the port's (from the
    same weights) with an in-memory recorder, and by the port's without
    one: records and printed lines."""
    out = {}
    for path, kw in PATHS.items():
        ref_tel = jtel.Telemetry()
        ref = _reference_trainer(telemetry=ref_tel, **kw)
        weights = _weights(ref)
        port_tel = Telemetry()
        port_lines, plain_lines = [], []
        ref.run(1)
        _port_trainer(weights, telemetry=port_tel, log=port_lines.append,
                      **kw).run(1)
        _port_trainer(weights, log=plain_lines.append, **kw).run(1)
        out[path] = {"ref": ref_tel.records, "port": port_tel.records,
                     "lines": port_lines, "plain": plain_lines}
    return out


def _steps(records):
    return [r for r in records if r["kind"] == "step"]


def _names(records):
    return {(r["kind"], r.get("name")) for r in records
            if r["kind"] != "step"}


@pytest.mark.parametrize("path", ["windowed", "per-step", "host"])
def test_trainer_prints_the_same_with_telemetry_on_and_off(runs, path):
    run = runs[path]
    assert _normalize(run["lines"]) == _normalize(run["plain"])
    assert any("Training loss after 20 iterations is" in ln
               for ln in run["lines"])


@pytest.mark.parametrize("path", ["windowed", "per-step", "host"])
def test_event_stream_matches_reference(runs, path):
    ref, port = _steps(runs[path]["ref"]), _steps(runs[path]["port"])
    assert len(port) == len(ref) == STEPS
    for field in ("iter", "epoch", "steady", "step_index"):
        assert [s.get(field) for s in port] == [s.get(field) for s in ref]
    assert [sorted(s) for s in port] == [sorted(s) for s in ref]
    assert [s["iter"] for s in port] == list(range(1, STEPS + 1))
    assert sum(s["steady"] for s in port) == STEPS - 20
    np.testing.assert_allclose([s["loss"] for s in port[:FIRST]],
                               [s["loss"] for s in ref[:FIRST]],
                               rtol=LOSS_RTOL)
    if path != "per-step":      # the ring's column, windowed paths only
        assert [s["step_index"] for s in port] == list(range(STEPS))
        np.testing.assert_allclose(
            [s["grad_sqnorm"] for s in port[:FIRST]],
            [s["grad_sqnorm"] for s in ref[:FIRST]], rtol=GSQ_RTOL)
        assert all(np.isfinite(s["grad_sqnorm"]) for s in port)


@pytest.mark.parametrize("path", ["windowed", "per-step", "host"])
def test_span_counter_and_gauge_names_match_reference(runs, path):
    ref, port = runs[path]["ref"], runs[path]["port"]
    assert _names(port) == _names(ref)
    sites = [r["site"] for r in port if r.get("name") == "host_round_trips"]
    ref_sites = [r["site"] for r in ref
                 if r.get("name") == "host_round_trips"]
    if path == "per-step":
        # The reference fetches the forward's loss unfenced by its count;
        # the port counts every fetch it makes.
        assert sites == ["forward_fetch", "step_fetch"] * STEPS + ["eval"]
        assert ref_sites == ["step_fetch"] * STEPS + ["eval"]
    else:
        assert sites == ref_sites == ["window_drain"] * 2 + ["eval"]
    if path == "host":
        for r in port:
            if r.get("name") == "host_augment":    # the producer thread
                assert r["depth"] == 0 and "parent" not in r


@pytest.mark.parametrize("path", ["windowed", "per-step"])
def test_fault_counters_match_reference(tmp_path, path):
    """``--nonfinite skip --chaos nonfinite_grad:5 --chaos preempt:7``:
    the same nonfinite, chaos and preemption counters at the same steps,
    and the emergency save's span."""
    chaos = ["nonfinite_grad:5", "preempt:7"]
    kw = PATHS[path]
    ref_tel, port_tel = jtel.Telemetry(), Telemetry()
    ref = _reference_trainer(telemetry=ref_tel, ft=jft.FTConfig(
        nonfinite="skip", chaos=jft.ChaosPlan.parse(chaos)), **kw)
    port = _port_trainer(_weights(ref), telemetry=port_tel, ft=FTConfig(
        nonfinite="skip", chaos=ChaosPlan.parse(chaos)), **kw)
    ref.run(1, checkpoint_dir=str(tmp_path / "ref"))
    port.run(1, checkpoint_dir=str(tmp_path / "port"))
    assert ref.preempted and port.preempted

    def faults(records):
        keep = ("nonfinite_skipped", "nonfinite_restored", "chaos_injected",
                "preemptions")
        return [_strip(r) for r in records
                if r["kind"] == "counter" and r["name"] in keep]

    got = faults(port_tel.records)
    assert got == faults(ref_tel.records)
    stop = 20 if path == "windowed" else 7     # a boundary at or after 7
    assert got == [
        {"kind": "counter", "name": "chaos_injected", "inc": 1, "total": 1,
         "site": "nonfinite_grad", "step": 5},
        {"kind": "counter", "name": "nonfinite_skipped", "inc": 1,
         "total": 1, "epoch": 0},
        {"kind": "counter", "name": "chaos_injected", "inc": 1, "total": 2,
         "site": "preempt", "step": stop},
        {"kind": "counter", "name": "preemptions", "inc": 1, "total": 1,
         "epoch": 0, "step": stop}]
    saves = [r for r in port_tel.records
             if r.get("name") == "checkpoint_save_mid_epoch"]
    assert [(s["epoch"], s["step"]) for s in saves] == [(0, stop)]
    assert _names(port_tel.records) == _names(ref_tel.records)


# -- (f), (g): the CLI -------------------------------------------------------

def _report_tool():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(worker.REPO, "tools",
                                         "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_run_directory_renders_in_the_reference_report(tmp_path,
                                                          capsys):
    run_dir = str(tmp_path / "run")
    cli.main(["--device", "cpu", "--model", "vggt", "--strategy", "single",
              "--batch-size", str(BATCH), "--no-augment",
              "--limit-train-batches", str(STEPS),
              "--limit-eval-batches", "1", "--data-dir", worker.ASSETS,
              "--telemetry-out", run_dir])
    capsys.readouterr()
    assert sorted(os.listdir(run_dir)) == ["events.jsonl", "manifest.json",
                                           "summary.json"]
    manifest, events, summary = ttel.read_run(run_dir)
    assert summary == ttel.summarize_events(events, global_batch=BATCH)
    assert (manifest["backend"], manifest["device_kind"],
            manifest["world_size"], manifest["model"]) == \
        ("cpu", "cpu", 1, "vggt")
    assert manifest["cuda_kernels"] == {}     # the CPU loads no kernel
    assert manifest["native_loader"] == {"available": True, "error": None}
    assert manifest["torch_version"] == torch.__version__
    assert summary["num_steps"] == STEPS
    assert summary["counters"]["host_round_trips"] == 3   # windows + eval

    tool = _report_tool()
    renders = {}
    for label in ("with summary", "without summary"):
        if label == "without summary":     # an interrupted run's directory
            os.unlink(os.path.join(run_dir, "summary.json"))
        assert tool.main([run_dir]) == 0
        text = capsys.readouterr().out
        assert_renders_as_the_tool(run_dir, text[:-1])   # less print's "\n"
        assert tool.main([run_dir, "--json"]) == 0
        renders[label] = (text, json.loads(capsys.readouterr().out))
    for text, js in renders.values():
        assert js == summary
        for line in ("== run manifest ==", "backend                cpu",
                     f"steps recorded         {STEPS} ({STEPS - 20} steady)",
                     "== spans (total wall clock) ==", "host_round_trips",
                     "== memory (measured vs certified) =="):
            assert line in text, text
    assert renders["with summary"][0].split("== spans")[0] == \
        renders["without summary"][0].split("== spans")[0]


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    tr = _port_trainer(limit_train_batches=3)
    tr.run(1, profile_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["trace_epoch0_rank0.json"]
    assert tr.profile_trace == str(tmp_path / "trace_epoch0_rank0.json")
    with open(tr.profile_trace) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


# -- (h): world 2 over gloo ----------------------------------------------------

CHILD = '''
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch_dist_worker as worker
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.models import vgg
vgg.CFG["VGGT"] = worker.NARROW_VGG        # also in the spawned ranks,
if __name__ == "__main__":                  # which import this file
    cli.main(sys.argv[1:])
'''


def _cli(tmp_path, *argv):
    script = tmp_path / "telemetry_child.py"
    script.write_text(CHILD.format(
        repo=worker.REPO, tests=os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, str(script), "--device", "cpu", "--model", "vggt",
           "--batch-size", str(BATCH), "--data-dir", worker.ASSETS,
           "--no-augment", "--limit-eval-batches", "1"] + list(argv)
    proc = subprocess.run(cmd, cwd=worker.REPO, env=env, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout
    return proc.stdout


def _reference_collectives(strategy):
    """The reference's collective records of ``strategy`` at world 2."""
    tel = jtel.Telemetry()
    ref = _reference_trainer(strategy=strategy, mesh=make_mesh(2),
                             telemetry=tel,
                             ft=jft.FTConfig(nonfinite="skip"))
    ref._emit_collective_telemetry()
    return tel.records


# Narrow VGG: 5 conv blocks (weight, bias, BN gamma and beta) and the
# classifier's weight and bias.
N_PARAMS = 4 * 5 + 2
N_BN = 5


@pytest.mark.parametrize("strategy", ["allreduce", "ddp"])
def test_world_2_rank_0_writes_every_rank_step_time_and_collectives(
        tmp_path, strategy):
    """Two gloo ranks of the CLI (``--nonfinite skip`` turns the window
    boundary's rank bookkeeping on).  The reference counts the HLO's
    all-reduces: one per gradient leaf plus the BN statistics' and the
    loss's means (``2 * N_BN + 1``), before XLA combines any, so ``ddp``
    counts as many as ``allreduce``.  The port counts the calls its
    strategy makes: one per gradient under ``allreduce``, one per bucket
    under ``ddp`` (one 25 MiB bucket holds the narrow VGG's 1.25 MiB); its
    statistics' mean is one all-reduce the ``Group`` records uncounted.
    The op's name, the gradients' MiB, the chain depth and the bytes a
    compressed tier would save agree."""
    run_dir = str(tmp_path / "run")
    _cli(tmp_path, "--num-devices", "2", "--strategy", strategy,
         "--nonfinite", "skip", "--limit-train-batches", str(STEPS),
         "--telemetry-out", run_dir)
    assert sorted(os.listdir(run_dir)) == ["events.jsonl", "manifest.json",
                                           "summary.json"]
    manifest, events, summary = ttel.read_run(run_dir)
    assert manifest["world_size"] == 2 and manifest["strategy"] == strategy
    # One stream: every step once, the manifest written once.
    assert [e["iter"] for e in _steps(events)] == list(range(1, STEPS + 1))
    boundaries = [(e["rank"], e["step"]) for e in events
                  if e.get("name") == "rank_step_time_s"]
    assert boundaries == [(0, 20), (1, 20), (0, STEPS), (1, STEPS)]
    assert set(summary["ranks"]) == {"0", "1"}
    assert summary == ttel.summarize_events(events, global_batch=BATCH)

    counters = summary["counters"]
    gauges = summary["gauges"]
    want = {"allreduce": N_PARAMS, "ddp": 1}[strategy]
    assert counters["collective_all-reduce_count"] == want
    # One link a gradient (allreduce) or a bucket (ddp): the chain depth
    # of the reference's step HLO.
    assert gauges["collective_totals"] == {
        "total_count": want, "chain_depth": want,
        "total_result_mib": counters["collective_all-reduce_result_mib"]}
    ref = jtel.summarize_events(_reference_collectives(strategy))
    assert ref["gauges"]["collective_totals"]["chain_depth"] == want
    assert {k for k in ref["counters"]} == \
        {k for k in counters if k.startswith("collective_")}
    assert ref["counters"]["collective_all-reduce_count"] == \
        N_PARAMS + 2 * N_BN + 1
    grad_bytes = sum(p.numel() * 4 for p in
                     tvgg.VGG("VGGT").parameters())
    assert counters["collective_all-reduce_result_mib"] == \
        round(grad_bytes / 2 ** 20, 2)
    # The reference's all-reduces also carry the BN statistics (mean and
    # variance of each channel) and the loss; each side rounds to 0.01.
    stats_mib = (2 * sum(c for c in worker.NARROW_VGG if c != "M") + 1) \
        * 4 / 2 ** 20
    assert abs(ref["counters"]["collective_all-reduce_result_mib"]
               - counters["collective_all-reduce_result_mib"]) <= \
        stats_mib + 0.01 + 1e-9
    saved, ref_saved = gauges["comm_bytes_saved"], \
        ref["gauges"]["comm_bytes_saved"]
    assert saved["baseline_grad_mib"] == ref_saved["baseline_grad_mib"]
    assert saved["saved_mib"] == ref_saved["saved_mib"] == 0.0


def test_elastic_cli_directory_spans_every_generation(tmp_path):
    """``--elastic strong`` at world 2 with ``rank_death:3:1``: the first
    generation's rank 0 and the second's append to one directory, and the
    coordinator's process adds the report and the summary over both."""
    run_dir = str(tmp_path / "run")
    out = _cli(tmp_path, "--num-devices", "2", "--elastic", "strong",
               "--batch-size", "16", "--limit-train-batches", "6",
               "--checkpoint-dir", str(tmp_path / "ck"),
               "--chaos", "rank_death:3:1", "--telemetry-out", run_dir)
    report = json.loads(out.splitlines()[-1].split("elastic report: ")[1])
    manifest, events, summary = ttel.read_run(run_dir)
    assert manifest["elastic_report"] == report
    assert manifest["elastic"] == {"protocol": "strong", "microshards": 4}
    assert manifest["world_size"] == 1          # the last generation's
    assert summary == ttel.summarize_events(events, global_batch=16)
    assert summary["counters"]["rank_deaths"] == 1
    deaths = [e for e in events if e.get("name") == "rank_deaths"]
    assert [(d["rank"], d["epoch"], d["step"]) for d in deaths] == \
        [(1, 0, 6)]
    assert {e["rank"] for e in events
            if e.get("name") == "rank_step_time_s"} == {0, 1}
    assert "checkpoint_save_mid_epoch" in summary["spans"]
    # The death came at the epoch's last boundary: the second generation
    # resumes there, trains no step and evaluates.
    assert [e["iter"] for e in _steps(events)] == list(range(1, 7))
    assert summary["spans"]["eval"]["count"] == 1
    assert "Resumed from mid-epoch checkpoint: epoch 0, step 6" in out
