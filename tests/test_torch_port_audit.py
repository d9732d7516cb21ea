"""The port's program audit (cs744_ddp_tpu_torch/analysis/: ``audit``,
``stats``, ``memlife``, ``dispatch``, ``megaplan``), the CLI's
``--audit`` / ``--audit-zoo`` / ``--verify-static`` and the Trainer's
``chain_depth``, on the CPU, against seeded violations, hand counts and the
reference package.

  * (a) A seeded violation for each audit rule, and the waivers.
  * (b) The VGG-11 zoo (8 strategies x 3 train paths, the eval, the
    serving ladder) at batch 256, world 4, f32 and bf16, clean on meta
    tensors; its dispatch certificate and its attribution.
  * (c) The step-path chain depth of each strategy against the JAX
    ``audit_zoo(paths=("step",), num_devices=4)`` at batch 64: equal for
    the strategy's collectives; the port's blocking mean of the BN
    statistics and the loss after them is one link more
    (``chain_depth_all``), which the reference's HLO has in parallel
    with the gradient chain.
  * (d) ``epoch_round_trip_bound`` and ``plan_k_epochs`` equal to the
    reference's over a grid; the bound equal to the CPU Trainer's round
    trips exactly on the windowed, per-step and host paths, with a tail
    and an eval.
  * (e) The memory report hand-computed; the in-place against the
    rebinding step, apart by exactly the leaf's bytes.
  * (f) A real ``Group``'s record of one step equal to the counted one.
  * (g) The CLI: ``--audit strict`` exits 2 on a seeded finding,
    ``--verify-static`` gives the reference's summary, a ``--audit`` run
    directory renders under ``== program audit ==`` in
    ``tools/telemetry_report.py`` (and the port's ``obs.report`` prints
    the same), and ``chain_depth`` is a number there.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from cs744_ddp_tpu.analysis import audit as jaudit
from cs744_ddp_tpu.analysis import dispatch as jdispatch
from cs744_ddp_tpu.analysis import megaplan as jmegaplan
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch import models as tmodels
from cs744_ddp_tpu_torch.analysis import (audit, costmodel, dispatch,
                                          megaplan, memlife, stats)
from cs744_ddp_tpu_torch.models import layers
from cs744_ddp_tpu_torch.obs import Telemetry, read_run
from cs744_ddp_tpu_torch.parallel import get_strategy, mesh
from cs744_ddp_tpu_torch.train import loop
from cs744_ddp_tpu_torch.train import step as steplib
from cs744_ddp_tpu_torch.utils.metrics import WINDOW

import torch_dist_worker as worker
from test_torch_port_report import assert_renders_as_the_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 12                  # 320 examples: 26 full batches and 8 rows
NFULL = 320 // BATCH
# The reference's step-path chain depths of VGG-11 at world 4.
JAX_DEPTHS = {"single": 0, "gather": 68, "allreduce": 34, "ddp": 2,
              "overlap": 1, "compress-bf16": 34, "compress-int8": 35,
              "powersgd": 43}


def _tiny():
    return nn.Sequential(layers.conv3x3(3, 8), layers.BnReluPool2d(8),
                         nn.MaxPool2d(2), nn.Flatten(),
                         layers.linear(512, 10))


class _SyncNet(nn.Module):
    """The tiny net with a host sync in its forward (``.item()``)."""

    def __init__(self):
        super().__init__()
        self.net = _tiny()

    def forward(self, x):
        return self.net(x) * float(x.abs().max() > 0)


tmodels.register_model("tinyaudit", _tiny)
tmodels.register_model("syncnet", _SyncNet)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo():
    """The VGG-11 zoo at batch 256, world 4: f32 (with the cost reports)
    and bf16, each with the serving ladder."""
    return {p: audit.audit_zoo(precision=p, serve_buckets=(1, 8, 32, 128,
                                                           256),
                               collect_costs=p == "f32")
            for p in ("f32", "bf16")}


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _program(fn, name="p", leaves=None, inputs=None, group=None, **kw):
    state = leaves if leaves is not None else {}
    return audit.Program(name, fn, lambda: dict(state), inputs or {},
                         audit.ProgramContract(name, **kw), group)


def _failed(report):
    return sorted(r for r, v in report.rules.items() if v == "fail")


# -- (a) seeded violations ---------------------------------------------------

def test_rule_collective_contract_seeded():
    g = costmodel.CountingGroup(4)
    x = _meta(10)
    single = _program(lambda: g.all_reduce(x), group=g, strategy="single")
    assert _failed(audit.audit_program(single)) == ["collective-contract"]

    def per_bucket_blocking():
        for _ in range(3):
            g.all_reduce(x)
    rep = audit.audit_program(_program(
        per_bucket_blocking, group=g, strategy="overlap", world=4,
        nbuckets=3))
    assert _failed(rep) == ["collective-contract"]
    assert "chain depth 3 > 1" in rep.findings[0].message
    rep = audit.audit_program(_program(
        per_bucket_blocking, group=g, strategy="allreduce", world=4,
        nleaves=4))
    assert "3 all_reduce < 4 leaves" in rep.findings[0].message
    ok = audit.audit_program(_program(
        per_bucket_blocking, group=g, strategy="ddp", world=4, nbuckets=3,
        nleaves=10))
    assert ok.passed, ok.findings


def test_rule_overlap_issues_a_bucket_inside_backward():
    """The port's overlap tier launches a bucket from inside backward;
    the same buckets launched after it (``OverlappedDDP`` called on
    finished gradients) keep depth 1 but fail the issue-position check."""
    good = audit.train_program("vgg11", "overlap", "step", world=4,
                               global_batch=64, window=WINDOW)
    good.contract = audit.ProgramContract(good.name, strategy="overlap",
                                          world=4, nbuckets=2)
    assert audit.audit_program(good).passed

    class AfterBackward:            # no ``attach``: launched post-backward
        def __init__(self):
            self.impl = get_strategy("overlap")

        def __call__(self, grads, group):
            return self.impl(grads, group)

    net = costmodel.meta_model("vgg11")
    g = costmodel.CountingGroup(4)
    state = steplib.init_train_state(net)
    step = steplib.make_train_step(net, AfterBackward(), group=g)
    args = (_meta(64, 32, 32, 3, dtype=torch.uint8),
            _meta(64, dtype=torch.int64), _meta(dtype=torch.int64),
            _meta(dtype=torch.int64))
    late = audit.Program(
        "late", lambda: step.with_ok(state, *args),
        lambda: steplib.named_state_tensors(state), {},
        audit.ProgramContract("late", strategy="overlap", world=4,
                              nbuckets=2), g)
    rep = audit.audit_program(late)
    assert rep.stats["chain_depth"] == 1
    assert _failed(rep) == ["collective-contract"]
    assert "before the step's last convolution_backward" in \
        rep.findings[0].message


def test_rule_compressed_bytes_and_ladder_seeded():
    p = audit.train_program("vgg11", "compress-bf16", "step", world=4,
                            global_batch=64, window=WINDOW)
    params = sum(t.numel() * 4 for t in
                 costmodel.meta_model("vgg11").parameters())
    for ratio, ok in ((2.0, True), (4.0, False)):
        p.contract = audit.ProgramContract(
            p.name, strategy="compress-bf16", world=4, nleaves=34,
            param_bytes=params, compress_ratio=ratio, aux_bytes=100_000)
        assert audit.audit_program(p).passed is ok
    _, bad = audit._certify_ladder({"gather": 5, "allreduce": 5, "ddp": 5},
                                   nleaves=5, nbuckets=1, program="l")
    assert len(bad) == 2


def test_rule_dtype_leak():
    w = _meta(8, 3, 3, 3, grad=True)

    def conv(dtype):
        return lambda: F.conv2d(_meta(2, 3, 8, 8, dtype=dtype),
                                w.to(dtype))
    leak = audit.audit_program(_program(conv(torch.float32),
                                        precision="bf16"))
    assert _failed(leak) == ["dtype-leak"]
    assert audit.audit_program(_program(conv(torch.bfloat16),
                                        precision="bf16")).passed
    # The same f32 product on f32 gradients (a strategy's) is not leaked.
    grads = _meta(16, 8)
    assert audit.audit_program(_program(lambda: grads.t() @ grads,
                                        precision="bf16")).passed


def test_rule_donation_and_peak_memory():
    state = {"w": _meta(64, 32), "mom": _meta(64, 32)}
    x = _meta(16, 64)

    def rebind():
        state["mom"] = torch.add(x.t() @ (x @ state["w"]), state["mom"])

    prog = audit.Program("r", rebind, lambda: dict(state), {"x": x},
                         audit.ProgramContract("r", donates_state=True))
    rep = audit.audit_program(prog)
    assert _failed(rep) == ["donation"]
    assert "mom" in rep.findings[0].message and "+8192 B" in \
        rep.findings[0].message
    tiny = audit.Program("m", lambda: x @ state["w"], lambda: dict(state),
                         {"x": x}, audit.ProgramContract(
                             "m", hbm_budget_bytes=1000))
    rep = audit.audit_program(tiny)
    assert _failed(rep) == ["peak-memory"]
    assert "mm#0" in rep.findings[0].message


@pytest.mark.parametrize("sync", ["item", "cpu", "nonzero"])
def test_rule_host_sync(sync):
    x = _meta(4)
    fn = {"item": lambda: x.sum().item(), "cpu": lambda: x.cpu(),
          "nonzero": lambda: x.nonzero()}[sync]
    rep = audit.audit_program(_program(fn))
    assert _failed(rep) == ["host-sync"]


def test_rule_baked_constants_and_waivers():
    host = torch.from_numpy(np.zeros(300_000, np.float32))
    rep = audit.audit_program(_program(lambda: host.to("meta"), "train/x"))
    assert _failed(rep) == ["baked-constants"]
    small = torch.zeros(10)
    assert audit.audit_program(_program(lambda: small.to("meta"))).passed
    for waiver, waived in (("baked-constants", True),
                           ("baked-constants@train/*", True),
                           ("baked-constants@serve/*", False),
                           ("host-sync", False)):
        rep = audit.audit_program(
            _program(lambda: host.to("meta"), "train/x"), waive=(waiver,))
        assert rep.passed is waived
        assert rep.rules["baked-constants"] == ("waived" if waived
                                                else "fail")


def test_rule_ingest_edge():
    ok = audit.serve_program("tinyaudit", 4)
    assert audit.audit_program(ok).passed
    f32 = audit.serve_program("tinyaudit", 4)
    f32.inputs["images"] = _meta(4, 32, 32, 3)
    rep = audit.audit_program(_program(
        lambda: f32.inputs["images"] * 2, inputs=f32.inputs, u8_edge=True))
    assert _failed(rep) == ["ingest-edge"]
    u8 = {"images": _meta(4, 32, 32, 3, dtype=torch.uint8)}
    rep = audit.audit_program(_program(lambda: u8["images"] + 1,
                                       inputs=u8, u8_edge=True))
    assert "no in-program u8 -> float" in rep.findings[0].message


# -- (b) the zoo ------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_zoo_is_clean(zoo, precision):
    result = zoo[precision]
    assert result.clean, "\n".join(result.format_lines())
    names = [r.program for r in result.reports]
    assert len(names) == 8 * 3 + 1 + 5
    assert names[:3] == ["train/step/single", "train/window/single",
                         "train/host_window/single"]
    assert names[-6:] == ["eval/window"] + [
        f"serve/b{b}/{precision}" for b in (1, 8, 32, 128, 256)]
    assert result.ladder == JAX_DEPTHS
    summary = result.summary()
    json.dumps(summary)
    for name, rec in summary["programs"].items():
        assert set(rec["rules"]) == set(audit.RULES)
        assert rec["rebound"] == 0 and 0 < rec["peak_mib"] < 80e9 / 2**20
    lines = result.format_lines()
    assert lines[-1] == "[audit] CLEAN: 30 programs, 0 findings, 0 waived"


def test_zoo_dispatch_certificate_and_attribution(zoo):
    result = zoo["f32"]
    cert = dispatch.certify_zoo(result, window=WINDOW, nbatches=195)
    assert cert["clean"], cert["findings"]
    progs = cert["programs"]
    assert progs["train/window/ddp"] == {
        "path": "window", "window": WINDOW, "in_place": True,
        "epoch_round_trips": 10 + 1}
    assert progs["train/step/ddp"]["epoch_round_trips"] == 195 + 1
    assert progs["serve/b8/f32"]["window"] is None
    # A window of the wrong size is caught.
    bad = dispatch.certify_zoo(result, window=WINDOW + 1, nbatches=195)
    assert {f["rule"] for f in bad["findings"]} == \
        {"dispatch-window-mismatch"}
    attr = audit.zoo_attribution(result)
    assert set(attr["programs"]) == set(result.costs)
    win = attr["programs"]["train/window/single"]
    assert win["roofline_bound"] in ("compute", "bandwidth")
    assert win["peak_hbm_mib"] == round(result.mem[
        "train/window/single"].peak_bytes / 2**20, 3)
    ov = attr["overlap_vs_ddp"]
    assert ov["ddp_chained_bytes"] == sum(
        result.costs["train/window/ddp"].collective_sizes)


# -- (c) chain depth against the JAX audit ---------------------------------------

def test_step_chain_depths_match_the_reference(zoo):
    ref = jaudit.audit_zoo(model="vgg11", global_batch=64, paths=("step",),
                           include_eval=False, num_devices=4)
    theirs = {r.program.split("/")[-1]: r.stats["chain_depth"]
              for r in ref.reports}
    assert theirs == JAX_DEPTHS
    mine = {r.program.split("/")[-1]: r.stats for r in zoo["f32"].reports
            if r.program.startswith("train/step/")}
    assert {s: m["chain_depth"] for s, m in mine.items()} == theirs
    # Pinned difference: the blocking mean of the BN statistics and the
    # loss runs after the strategy's last collective, one link more.
    assert {s: m["chain_depth_all"] for s, m in mine.items()} == \
        {s: d + (s != "single") for s, d in theirs.items()}


# -- (d) round trips and the K-epoch plan ------------------------------------

def test_closed_forms_equal_the_reference():
    for path in ("step", "window", "host_window", "eval"):
        for nb in (0, 1, 19, 20, 21, 195):
            for w in (1, 4, 20):
                for tail in (False, True):
                    for ev in (False, True):
                        assert dispatch.epoch_round_trip_bound(
                            path, nb, w, tail_batch=tail, include_eval=ev) \
                            == jdispatch.epoch_round_trip_bound(
                                path, nb, w, tail_batch=tail,
                                include_eval=ev)
    for k in (0, 1, 7):
        assert dispatch.mega_round_trip_bound(k) == \
            jdispatch.mega_round_trip_bound(k)
    with pytest.raises(ValueError):
        dispatch.epoch_round_trip_bound("window", 10, 0)
    assert dispatch.serving_inflight_bound() == 2
    # The plan, given the same budget; the port's ring counter is int64,
    # 4 bytes more than the reference's, passed to it as transient.
    for world in (1, 4, 8):
        for window in (4, 20):
            for state in (10**6, 74 * 10**6):
                for budget in (10**8, 16 * 2**30, 80 * 10**9):
                    mine = megaplan.plan_k_epochs(
                        world=world, window=window, state_bytes=state,
                        transient_bytes=5000, hbm_budget_bytes=budget)
                    theirs = jmegaplan.plan_k_epochs(
                        world=world, window=window, state_bytes=state,
                        transient_bytes=5004, hbm_budget_bytes=budget)
                    a, b = mine.to_dict(), theirs.to_dict()
                    for d in (a, b):
                        d.pop("transient_mib")
                    assert a == b
    assert megaplan.plan_k_epochs(state_bytes=0).hbm_budget_bytes == \
        80 * 10**9


def test_max_feasible_K_from_the_window_certificate():
    rep = megaplan.window_mem_report("vgg11", world=4, global_batch=256)
    assert rep.name == "train/window/ddp" and rep.rebound_bytes == 0
    plan = megaplan.plan_feasibility("vgg11", 4, window_report=rep)
    state = megaplan.state_bytes_for("vgg11", world=4)
    assert plan.state_bytes == state
    assert plan.max_k == (80 * 10**9 - state - rep.transient_peak_bytes
                          - 8) // plan.per_epoch_bytes
    assert megaplan.max_feasible_K("vgg11", 4, window_report=rep) == \
        plan.max_k


@pytest.mark.parametrize("path, kw", [
    ("window", {}), ("step", {"profile_phases": True}),
    ("host_window", {"host_augment": True})])
def test_round_trip_bound_equals_the_trainer(path, kw):
    tel = Telemetry()
    tr = loop.Trainer("tinyaudit", "single", global_batch=BATCH,
                      data_dir=worker.ASSETS, device="cpu",
                      limit_eval_batches=1, log=lambda s: None,
                      telemetry=tel, **kw)
    tr.run(1)
    bound = dispatch.epoch_round_trip_bound(
        path, NFULL, WINDOW, tail_batch=True, include_eval=True)
    assert dispatch.total_runtime_trips(tel.records) == bound
    sites = dispatch.count_runtime_trips(tel.records)
    forward = sites.pop("forward_fetch", 0)
    assert forward == (NFULL + 1 if path == "step" else 0)
    assert tr.host_round_trips == bound + forward
    assert set(sites) <= set(dispatch.TRIP_SITES)


# -- (e) the memory report ----------------------------------------------------------

def test_mem_report_hand_counted():
    """The seeded step: w and its momentum (64x32 f32, 8192 B each) held
    by the caller; ``x @ w`` (16x32, 2048 B) and the gradient (8192 B)
    live together at the second product: the peak.  Rebinding the
    momentum adds its 8192 B for the whole call."""
    inplace, rebind = memlife.donation_delta()
    assert inplace.entry_bytes == 2 * 8192
    assert inplace.transient_peak_bytes == 2048 + 8192
    assert inplace.peak_bytes == 2 * 8192 + 2048 + 8192
    assert rebind.peak_bytes == inplace.peak_bytes + 8192
    assert rebind.rebound_bytes == 8192 and inplace.rebound_bytes == 0
    assert inplace.top_sets[0]["members"] == [("mm#2", 8192),
                                              ("mm#1", 2048)]
    # A module: Linear(8, 4) without bias over 16 rows, forward only: the
    # weight (128 B) held, the output (256 B) the only allocation.
    lin = nn.Linear(8, 4, bias=False).to("meta")
    x = _meta(16, 8)
    with torch.no_grad():
        rep = memlife.mem_report(lin, x, state=dict(lin.named_parameters()))
    assert (rep.entry_bytes, rep.transient_peak_bytes, rep.peak_bytes) == \
        (128, 256, 384)


# -- (f) the real Group's record -------------------------------------------------

@pytest.mark.parametrize("strategy", ["allreduce", "ddp", "overlap"])
def test_group_record_equals_the_counted_step(strategy):
    tr = loop.Trainer("tinyaudit", strategy, global_batch=BATCH,
                      data_dir=worker.ASSETS, device="cpu",
                      limit_train_batches=1, log=lambda s: None)
    try:
        x = torch.zeros((BATCH, 32, 32, 3), dtype=torch.uint8)
        y = torch.zeros((BATCH,), dtype=torch.int64)
        tr.train_step(tr.state, x, y)
        real = list(tr.group.step_links)
    finally:
        del tr
        mesh.destroy_distributed()
    program = audit.train_program("tinyaudit", strategy, "step", world=1,
                                  global_batch=BATCH, window=WINDOW)
    traced, _ = audit.trace_program(program)
    assert real == traced.links and real
    assert stats.collective_chain_depth(real) == \
        {"allreduce": 6, "ddp": 1, "overlap": 1}[strategy]
    assert stats.collective_chain_depth(real, counted_only=False) == \
        stats.collective_chain_depth(real) + 1


# -- (g) the CLI -------------------------------------------------------------------

def test_cli_audit_strict_exits_2_on_a_seeded_finding(tmp_path, capsys):
    base = ["--model", "syncnet", "--serve-buckets", "1,8"]
    with pytest.raises(SystemExit) as e:
        cli.main(base + ["--audit-zoo", "--audit", "strict"])
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert "host-sync: host sync _local_scalar_dense" in out
    # One sync a forward: 8 strategies x 3 train programs, the eval's 20
    # staged batches, 2 rungs.
    assert out.strip().splitlines()[-1] == \
        "[audit] DIRTY: 27 programs, 46 findings, 0 waived"
    cli.main(base + ["--audit-zoo", "--audit", "strict", "--audit-waive",
                     "host-sync"])
    assert "[audit] CLEAN: 27 programs, 0 findings, 46 waived" in \
        capsys.readouterr().out
    # A training run stops before any step.
    run = str(tmp_path / "run")
    with pytest.raises(SystemExit) as e:
        cli.main(["--model", "syncnet", "--strategy", "single", "--device",
                  "cpu", "--data-dir", worker.ASSETS, "--batch-size",
                  str(BATCH), "--audit", "strict", "--telemetry-out", run])
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert "Training loss" not in out and not os.path.exists(run)


def test_cli_verify_static_summary(capsys):
    cli.main(["--verify-static", "--model", "tinyaudit", "--batch-size",
              "64", "--serve-buckets", "1,8"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert lines[-2] == "[audit] CLEAN: 27 programs, 0 findings, 0 waived"
    assert set(summary) == {"clean", "lint_findings", "lock_graph",
                            "wire_schema", "audit", "dispatch", "memory"}
    assert summary["clean"] and summary["lint_findings"] == 0
    assert summary["memory"]["budget_mib"] == round(80e9 / 2**20, 1)
    assert summary["dispatch"]["clean"]
    assert summary["audit"] == {"clean": True, "n_programs": 27,
                                "n_findings": 0}


def test_cli_audit_run_directory_renders(tmp_path, capsys):
    run = str(tmp_path / "run")
    cli.main(["--model", "tinyaudit", "--strategy", "allreduce",
              "--device", "cpu", "--data-dir", worker.ASSETS,
              "--batch-size", str(BATCH), "--limit-train-batches", "20",
              "--limit-eval-batches", "1", "--audit", "warn",
              "--telemetry-out", run])
    out = capsys.readouterr().out
    assert "[audit] CLEAN: 4 programs, 0 findings, 0 waived" in out
    manifest, events, summary = read_run(run)
    assert manifest["audit"]["clean"] and \
        set(manifest["audit"]["programs"]) == {
            "train/step/allreduce", "train/window/allreduce",
            "train/host_window/allreduce", "eval/window"}
    # The strategy's six gradient leaves, one link each.
    assert summary["gauges"]["collective_totals"]["chain_depth"] == 6
    proc = subprocess.run([sys.executable, "tools/telemetry_report.py", run],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert_renders_as_the_tool(run, proc.stdout[:-1])   # less print's "\n"
    assert "== program audit ==" in proc.stdout
    assert "CLEAN: 4 programs" in proc.stdout
    assert "== memory (measured vs certified) ==" in proc.stdout
