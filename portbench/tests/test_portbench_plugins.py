"""The harness's extension points (``plugins.py``) on the CPU: the CIFAR
classifiers read, through their plug-ins, exactly what they read before
the plug-ins existed; and a new architecture, a new image recipe, a
configuration, a traffic, a cell and a metric, all new files under a
root of their own, make a run that is well formed and correct, and not
correct with a fault planted."""

import argparse
import hashlib
import json
import tempfile
import textwrap
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from portbench import check, faults, plugins, run, worker, yardstick
from portbench.tests.cells import (_json, narrow_models,  # noqa: F401
                                   small_spec)
from portbench.tests.test_portbench_harness import _assert_shape

# sha256 (first 16 hex digits) of the JSON of each reading, taken with the
# harness as it was before the plug-ins: at one CPU thread, the narrow
# models of ``cells.py``, 72 images, batch 16, three steps; the reference
# at world 1 and 2 in each precision, the program's first steps at world 1
# in f32 and bf16, and the numbers compared between them.
PARENT = {
    "ref/vgg/3/w1/f32": "45130f77b3567c00",
    "ref/vgg/3/w1/fp8": "f0c1ed37ec4eb489",
    "ref/vgg/3/w1/tf32": "45130f77b3567c00",
    "ref/vgg/3/w2/f32": "415dc8698bd1c29b",
    "ref/vgg/3/w2/fp8": "92488af2fa675e75",
    "ref/vgg/3/w2/tf32": "415dc8698bd1c29b",
    "prog/vgg/3/f32": "3a4ee49444d0bb01",
    "checks/vgg/3/f32": "4422d7446628a402",
    "prog/vgg/3/bf16": "3448167094dfb4d6",
    "checks/vgg/3/bf16": "8438cbccfe89d8bb",
    "ref/vgg/2147483725/w1/f32": "2aae502725f1b048",
    "ref/vgg/2147483725/w1/fp8": "910b0fdd90ee7d6f",
    "ref/vgg/2147483725/w1/tf32": "2aae502725f1b048",
    "ref/vgg/2147483725/w2/f32": "7ec3c4c55b75d868",
    "ref/vgg/2147483725/w2/fp8": "5a7437a421ddaee8",
    "ref/vgg/2147483725/w2/tf32": "7ec3c4c55b75d868",
    "prog/vgg/2147483725/f32": "3f43a65dbc7913fe",
    "checks/vgg/2147483725/f32": "bbe4916237e6d3f9",
    "prog/vgg/2147483725/bf16": "004981663af2a3c7",
    "checks/vgg/2147483725/bf16": "f4a5ca0f5bfa2467",
    "ref/resnet/3/w1/f32": "fe8fb859da0830fa",
    "ref/resnet/3/w1/fp8": "b2d09c22ac7814b2",
    "ref/resnet/3/w1/tf32": "fe8fb859da0830fa",
    "ref/resnet/3/w2/f32": "4a42a1c7d796c3f9",
    "ref/resnet/3/w2/fp8": "3e0c52621413ad7d",
    "ref/resnet/3/w2/tf32": "4a42a1c7d796c3f9",
    "prog/resnet/3/f32": "b1656d14ad405ebd",
    "checks/resnet/3/f32": "c961bd13a6bb724b",
    "prog/resnet/3/bf16": "a408ba9c66e194ad",
    "checks/resnet/3/bf16": "b9479f7988009c58",
    "ref/resnet/2147483725/w1/f32": "43820df4a58fafbc",
    "ref/resnet/2147483725/w1/fp8": "a6102ed62c95f2e5",
    "ref/resnet/2147483725/w1/tf32": "43820df4a58fafbc",
    "ref/resnet/2147483725/w2/f32": "c9b34f7e4f86a090",
    "ref/resnet/2147483725/w2/fp8": "33281229416e07e2",
    "ref/resnet/2147483725/w2/tf32": "c9b34f7e4f86a090",
    "prog/resnet/2147483725/f32": "47ecb16b9574ffbe",
    "checks/resnet/2147483725/f32": "0ea7ce9bc81da06c",
    "prog/resnet/2147483725/bf16": "274bbe3cfd1a43b5",
    "checks/resnet/2147483725/bf16": "7cdbfb313ae33553",
}


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's reductions then sum in one order."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("arch", ["vgg", "resnet"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_readings_are_the_parents_bit_for_bit(arch, seed, narrow_models,
                                              one_thread):
    got = {}
    for world in (1, 2):
        for precision in ("f32", "fp8", "tf32"):
            spec = small_spec(arch)
            spec["traffic"]["world"] = world
            with tempfile.TemporaryDirectory() as d:
                worker.make_data(spec, seed, d, "cpu")
                ref = worker.reference_readings(spec, seed, d, "cpu",
                                                precision)
            got[f"ref/{arch}/{seed}/w{world}/{precision}"] = \
                _digest(ref._asdict())
    for precision in ("f32", "bf16"):
        spec = small_spec(arch, precision=precision)
        with tempfile.TemporaryDirectory() as d:
            worker.make_data(spec, seed, d, "cpu")
            trainer = worker.build_trainer(spec, seed, d, "cpu", [])
            prog = worker.checked_steps(
                trainer, 3, plugins.architecture(spec["config"]))
            ref = worker.reference_readings(spec, seed, d, "cpu")
        got[f"prog/{arch}/{seed}/{precision}"] = _digest(prog._asdict())
        got[f"checks/{arch}/{seed}/{precision}"] = _digest(
            check.numbers(prog, ref))
    assert got == {k: v for k, v in PARENT.items()
                   if k.split("/")[1:3] == [arch, str(seed)]}


@pytest.mark.parametrize("config,flops", [("vgg11_bn_cifar10", 916_617_216),
                                          ("resnet18_cifar10", 3_332_536_320)])
def test_flops_are_the_parents(config, flops):
    traffic = _json("traffic", "bf16_single_b256")
    assert yardstick.model_flops_per_image(_json("configs", config),
                                           traffic) == flops


# A new architecture, recipe, configuration, traffic, cell and metric, as
# a later change would add them: files only.
MLP_ARCH = '''
"""A two-layer perceptron over the flattened image: linear, ReLU,
linear."""

import torch.nn.functional as F

from portbench.reference.layers import init as init_leaves, linear_leaves

BATCH_STATISTICS = False


def _inputs(config):
    h, w, c = config["input"]
    return h * w * c


def leaves(config):
    return (linear_leaves("fc1", _inputs(config), config["hidden"])
            + linear_leaves("fc2", config["hidden"], config["num_classes"]))


def init(config, seed, device):
    return init_leaves(leaves(config), seed, device)


def forward(config, params, state, x, q=lambda t: t):
    w1, b1, w2, b2 = params
    h = F.relu(q(F.linear(q(x.flatten(1)), q(w1), b1)))
    return q(F.linear(h, q(w2), b2))


def macs_per_example(config, traffic):
    return _inputs(config) * config["hidden"] \\
        + config["hidden"] * config["num_classes"]
'''

STRIPES_RECIPE = '''
"""Noise images with a bright band of rows whose place is the class, in
CIFAR-10's files; the reference's batches augmented as the program's."""

import numpy as np
import torch

from portbench import data
from portbench.reference import augment


def _split(n, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    labels = torch.randint(0, 10, (n,), generator=gen, device=device)
    noise = torch.randint(0, 128, (n, 32, 32, 3), generator=gen,
                          device=device)
    rows = torch.arange(32, device=device)
    band = (rows[None, :] // 3 == labels[:, None])[:, :, None, None]
    images = (noise + 127 * band).to(torch.uint8)
    return data.Split(images.cpu().numpy(),
                      labels.to(torch.int32).cpu().numpy())


def make(dataset, seed, data_dir, device):
    data.write_cifar10(data_dir, _split(dataset["train_images"], seed, device),
                       _split(dataset["test_images"], seed + 1, device))


def examples(dataset):
    return dataset["train_images"]


def read(data_dir):
    return data.read_cifar10(data_dir)


def batch(split, rows, traffic, seed, rank, step, device):
    x = augment.transform(split.images[rows], seed, rank, 0, step, device)
    y = torch.from_numpy(split.labels[rows].astype(np.int64)).to(device)
    return x, y
'''

ROUND_TRIPS_METRIC = '''
"""The Trainer's device-to-host round trips over the traced epoch, from
the traced summary's counters."""

LAYER = "host loop"
UNIT = "count"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "program_counter"


def read(ctx):
    return float(ctx.trace["counters"]["trainer"]["host_round_trips"])
'''


class TinyMLP(nn.Module):
    """The program's side of ``mlp``: the zoo's linear layers."""

    def __init__(self, hidden: int):
        super().__init__()
        from cs744_ddp_tpu_torch.models import layers
        self.fc1 = layers.linear(32 * 32 * 3, hidden)
        self.fc2 = layers.linear(hidden, 10)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.flatten(1))))


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


@pytest.fixture
def new_root(tmp_path, monkeypatch):
    """A root of new files only, the program's ``mlptiny`` registered for
    the test, and the run's temporary files under ``tmp_path``."""
    from cs744_ddp_tpu_torch import models
    monkeypatch.setattr(models, "_CUSTOM", dict(models._CUSTOM))
    models.register_model("mlptiny", lambda: TinyMLP(32))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    root = tmp_path / "bench"
    _write(root / "arch" / "mlp.py", textwrap.dedent(MLP_ARCH))
    _write(root / "recipes" / "stripes.py", textwrap.dedent(STRIPES_RECIPE))
    _write(root / "metrics" / "round_trips.train.py",
           textwrap.dedent(ROUND_TRIPS_METRIC))
    _write(root / "configs" / "mlp_tiny.json", json.dumps({
        "name": "mlp_tiny", "architecture": "mlp", "port_model": "mlptiny",
        "input": [32, 32, 3], "hidden": 32, "num_classes": 10,
        "reduced": []}))
    traffic = _json("traffic", "f32_single_b256")
    traffic.update(name="f32_b16_stripes", global_batch=16,
                   dataset={"recipe": "stripes", "train_images": 72,
                            "test_images": 8},
                   reference_chunk_rows=5, deadline_s=60,
                   program={"limit_eval_batches": 1})
    _write(root / "traffic" / "f32_b16_stripes.json", json.dumps(traffic))
    limits = dict(_json("workloads", "vgg11_f32_single")["limits"])
    del limits["stats1_gap"]
    _write(root / "workloads" / "mlp_tiny_f32.json", json.dumps({
        "config": "mlp_tiny", "traffic": "f32_b16_stripes", "chips": 1,
        "limits": limits}))
    return root


def _files(root: Path):
    return sorted((str(p.relative_to(root)), p.stat().st_size,
                   p.stat().st_mtime_ns)
                  for p in root.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def _args(trace=0):
    return argparse.Namespace(seed=2 ** 31 + 21, seconds=0.2, trace=trace)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_architecture_and_recipe_are_new_files_only(trace, new_root,
                                                          tmp_path):
    before = _files(plugins.ROOT)
    spec = run.load_cell("mlp_tiny_f32", new_root)
    res = run.measure(spec, _args(trace), device_type="cpu")
    res.pop("_forbidden")
    _assert_shape(res, trace)
    assert res["correct"] is True, res["checks"]
    assert "stats1_gap" not in res["checks"]
    assert set(res["checks"]) == set(spec["cell"]["limits"])
    if trace:
        # 72 images in batches of 16: one window of four and a tail.
        assert res["metrics"] == {"round_trips.train": {"value": 2.0,
                                                        "unit": "count"}}
    assert _files(plugins.ROOT) == before
    assert list((tmp_path / "tmp").glob("portbench-*")) == []


def test_the_new_architectures_flops(new_root):
    spec = run.load_cell("mlp_tiny_f32", new_root)
    flops = yardstick.model_flops_per_image(spec["config"], spec["traffic"],
                                            new_root)
    assert flops == 6 * (3072 * 32 + 32 * 10)
    assert yardstick.pool_block_shapes(spec["config"], new_root) == []


def test_a_fault_in_the_new_cell_is_not_correct(new_root):
    spec = run.load_cell("mlp_tiny_f32", new_root)
    with faults.half_batch():
        res = run.measure(spec, _args(), device_type="cpu")
    assert res["correct"] is False, res["checks"]


def test_chunked_reference_is_the_whole_one(new_root):
    """Chunks of 5 rows against a rank's 16 in one piece: the same
    gradient to f32 summation order."""
    spec = run.load_cell("mlp_tiny_f32", new_root)
    whole = dict(spec, traffic=dict(spec["traffic"]))
    del whole["traffic"]["reference_chunk_rows"]
    seed = 2 ** 31 + 23
    with tempfile.TemporaryDirectory() as d:
        worker.make_data(spec, seed, d, "cpu")
        a = worker.reference_readings(spec, seed, d, "cpu")
        b = worker.reference_readings(whole, seed, d, "cpu")
    assert a.stats_change1 == b.stats_change1 == []
    got = check.numbers(a, b)
    assert max(got.values()) < 1e-5, got


def test_chunks_are_refused_where_the_architecture_keeps_batch_statistics():
    spec = small_spec()
    spec["traffic"]["reference_chunk_rows"] = 4
    with pytest.raises(ValueError, match="batch statistics"):
        run.measure(spec, _args(), device_type="cpu")


def test_the_traffics_program_object_reaches_the_trainer(narrow_models):
    spec = small_spec()
    with tempfile.TemporaryDirectory() as d:
        worker.make_data(spec, 2 ** 31 + 29, d, "cpu")
        plain = worker.build_trainer(spec, 2 ** 31 + 29, d, "cpu", [])
        spec["traffic"]["program"] = {"limit_eval_batches": 2}
        given = worker.build_trainer(spec, 2 ** 31 + 29, d, "cpu", [])
    assert plain.limit_eval_batches is None
    assert given.limit_eval_batches == 2


def _with(root: Path, kind: str, name: str, **changes) -> None:
    path = root / kind / f"{name}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    **changes)))


def test_a_limit_the_run_does_not_give_is_not_correct(new_root):
    """The new cell lists a limit for ``stats1_gap``, which its
    architecture, naming no state, never gives."""
    limits = dict(_json("workloads", "vgg11_f32_single")["limits"])
    _with(new_root, "workloads", "mlp_tiny_f32", limits=limits)
    spec = run.load_cell("mlp_tiny_f32", new_root)
    res = run.measure(spec, _args(), device_type="cpu")
    assert res["correct"] is False
    assert res["checks"]["stats1_gap"] == [None, limits["stats1_gap"]]
    assert all(v <= lim for k, (v, lim) in res["checks"].items()
               if k != "stats1_gap" and lim is not None)


@pytest.mark.parametrize("given", [{"limit_train_batches": 1},
                                   {"compress_rank": 2},
                                   {"profile_phases": True},
                                   {"seed": 1},
                                   {"metrics_ring": 4}])
def test_program_keys_outside_the_allowed_are_refused(new_root, given):
    """Keys that change the epoch the rate counts or the checked step,
    the harness's own, and any that neither the harness nor the
    architecture names."""
    _with(new_root, "traffic", "f32_b16_stripes", program=given)
    spec = run.load_cell("mlp_tiny_f32", new_root)
    with pytest.raises(ValueError, match="refused"):
        run.measure(spec, _args(), device_type="cpu")


@pytest.mark.parametrize("given,arch_keys,refused", [
    ({}, (), []),
    ({"limit_eval_batches": 1}, (), []),
    ({"metrics_ring": 4}, ("metrics_ring",), []),
    ({"metrics_ring": 4}, (), ["metrics_ring"]),
    ({"limit_train_batches": 1}, ("limit_train_batches",),
     ["limit_train_batches"]),
])
def test_an_architecture_adds_program_keys_but_not_refused_ones(
        given, arch_keys, refused):
    arch = argparse.Namespace(PROGRAM_KEYS=arch_keys)
    if not refused:
        assert worker.program_keywords(arch, {"program": given}) == given
        return
    with pytest.raises(ValueError, match=str(refused).replace("[", r"\[")):
        worker.program_keywords(arch, {"program": given})


def test_a_program_that_trains_another_epoch_is_refused(new_root,
                                                        monkeypatch):
    """A Trainer that trains three steps an epoch where the recipe's 72
    examples make five: the rate would count examples never trained."""
    build = worker.build_trainer

    def limited(*a, **k):
        trainer = build(*a, **k)
        trainer.limit_train_batches = 3
        return trainer

    monkeypatch.setattr(worker, "build_trainer", limited)
    spec = run.load_cell("mlp_tiny_f32", new_root)
    with pytest.raises(RuntimeError, match="the recipe's epoch is 5 steps a rank"):
        run.measure(spec, _args(), device_type="cpu")


def test_a_missing_plugin_is_named():
    with pytest.raises(ValueError, match="no arch plug-in 'nothing'"):
        plugins.load("arch", "nothing")
    with pytest.raises(ValueError, match="not a name"):
        plugins.load("recipes", "../arch/vgg")
