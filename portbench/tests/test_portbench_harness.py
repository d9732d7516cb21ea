"""The harness on the CPU: it finds a cell, a configuration, a traffic mix
and a metric by name from files; a run's result line has its documented
shape; the command refuses a host without a card; and a run with a fault planted
under the timed path comes out not correct, once for each fault a cell
can have."""

import argparse
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import faults, run
from portbench.tests.cells import narrow_models, small_spec  # noqa: F401

REPO = Path(__file__).resolve().parents[2]


def _args(seed=2 ** 31 + 11, seconds=0.2, trace=0):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)


def test_finds_cell_config_traffic_and_metric_by_name(tmp_path):
    for kind in ("configs", "traffic", "workloads", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "cfg_a.json").write_text(json.dumps({"x": 1}))
    (tmp_path / "traffic" / "mix_b.json").write_text(json.dumps({"y": 2}))
    (tmp_path / "workloads" / "cell-c.json").write_text(json.dumps(
        {"config": "cfg_a", "traffic": "mix_b", "chips": 1, "limits": {}}))
    (tmp_path / "metrics" / "answer.train.py").write_text(
        "LAYER = 'l'\nUNIT = 'ms'\nBETTER = 'lower'\n"
        "MOVES = 'train_images_per_s'\nSOURCE = 'device_trace'\n"
        "def read(ctx):\n    return 42.0\n")
    spec = run.load_cell("cell-c", tmp_path)
    assert spec["config"] == {"x": 1} and spec["traffic"] == {"y": 2}
    metrics = run.load_metrics(tmp_path)
    assert list(metrics) == ["answer.train"]
    assert metrics["answer.train"].read(None) == 42.0
    with pytest.raises(ValueError):
        run.load_cell("../workloads/cell-c", tmp_path)


def test_benchmark_json_names_what_the_folder_holds():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    metrics = run.load_metrics()
    for m in bench["per_layer"]:
        reader = metrics[m["name"]]
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES,
                reader.SOURCE) == (m["layer"], m["unit"], m["better"],
                                   m["moves"], m["source"])
    assert {m["name"] for m in bench["per_layer"]} == set(metrics)
    for w in bench["workloads"]:
        spec = run.load_cell(w["name"])
        assert spec["cell"]["config"] == w["config"]
        assert spec["cell"]["traffic"] == w["traffic"]
        assert spec["cell"]["chips"] == w["chips"] == spec["traffic"]["world"]
        assert spec["config"]["name"] == w["config"]
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == \
            c["reduced"]


def _assert_shape(res, trace):
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][key]) <= 10
    else:
        assert set(res["metrics"]) == set(run.END_TO_END)
    for value, limit in res["checks"].values():
        assert isinstance(value, float)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct_and_well_formed(trace, narrow_models):
    res = run.measure(small_spec(), _args(trace=trace), device_type="cpu")
    res.pop("_forbidden")
    _assert_shape(res, trace)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    json.loads(json.dumps(res))


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
def test_a_fault_under_the_timed_path_is_not_correct(fault, narrow_models):
    with faults.FAULTS[fault]():
        res = run.measure(small_spec(), _args(), device_type="cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks_over_gloo(fault):
    """The multi-chip cell's path at world 4 on the CPU (gloo, full VGG-11,
    two rows a rank): sound, and with the exchange left out."""
    target = None if fault is None else \
        functools.partial(faults.faulty_rank_main, fault)
    spec = small_spec(world=4, batch=8, images=40, cell="vgg11_bf16_ddp_w4")
    spec["traffic"]["precision"] = "f32"
    spec["cell"]["limits"] = small_spec()["cell"]["limits"]
    res = run.measure(spec, _args(seconds=0.1), device_type="cpu",
                      deadline_s=240, rank_target=target)
    assert res["correct"] is (fault is None), res["checks"]


def test_the_command_refuses_a_host_without_a_card():
    """No fallback to the CPU: exit code 2 and nothing on standard
    output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "vgg11_bf16_single", "--seed", str(2 ** 31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no result" in proc.stderr
