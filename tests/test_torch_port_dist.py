"""The port's data-parallel train step, Trainer and CLI over
``torch.distributed`` (cs744_ddp_tpu_torch/train, parallel, cli), on the
CPU over gloo.

  * The whole step at world 2 and 4 against the reference package's
    ``make_train_step`` on ``make_mesh(world)``: a narrow VGG registered on
    both sides, the reference's initial weights, augmentation off, lr
    0.01, three steps.  Losses to rtol 1e-3; parameters and BN running
    statistics to rtol 1e-2 / atol 2e-3 (the bound of
    test_torch_port_train.py for f32 summation order over three steps);
    every rank's state bitwise equal to every other's.
  * The collective counts of one step at VGG-11's full width, world 2.
  * World 1 in this process: every stateless tier bitwise equal to
    ``single``.
  * The CLI spawning two gloo ranks.
"""

import inspect
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.parallel import strategies as jstrategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
from cs744_ddp_tpu_torch.parallel import initialize_distributed, mesh
from cs744_ddp_tpu_torch.train.loop import Trainer

import torch_dist_worker as worker

REPO = worker.REPO
STEPS, BATCH, LR = 3, 32, 0.01
STEP_CASES = [(2, "gather"), (2, "allreduce"), (2, "ddp"), (4, "allreduce"),
              (4, "overlap")]
# One step of VGG-11 (34 parameters, two buckets, 9 low-rank), by kind:
# all_reduce, all_reduce_max, gather, scatter, all_gather.
VGG11_COUNTS = {"gather": [0, 0, 34, 34, 0], "allreduce": [34, 0, 0, 0, 0],
                "ddp": [2, 0, 0, 0, 0], "overlap": [2, 0, 0, 0, 0],
                "compress-bf16": [34, 0, 0, 0, 0],
                "compress-int8": [34, 1, 0, 0, 0],
                "powersgd": [2 * 9 + 25, 0, 0, 0, 0]}


def _reference_run(world, name, batches):
    init_fn, apply_fn = jvgg.make("VGGT")
    state = jstep.init_train_state(init_fn, jax.random.PRNGKey(0))
    step = jstep.make_train_step(apply_fn, jstrategies.get_strategy(name),
                                 make_mesh(world), jsgd.SGDConfig(lr=LR),
                                 augment=False)
    losses = []
    for s in range(STEPS):
        state, loss = step(state, jax.random.PRNGKey(s),
                           batches["images"][s], batches["labels"][s])
        losses.append(float(loss))
    return (np.array(losses), jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.bn_state))


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_dist"))
    jvgg.CFG["VGGT"] = worker.NARROW_VGG
    init_fn, _ = jvgg.make("VGGT")
    params, bn_state = jax.tree.map(np.asarray,
                                    init_fn(jax.random.PRNGKey(0)))
    np.savez(os.path.join(tmp, "weights.npz"),
             **{k: v.numpy() for k, v in
                convert.from_jax(params, bn_state).items()})
    rng = np.random.default_rng(0)
    np.savez(os.path.join(tmp, "batches.npz"),
             images=rng.integers(0, 256, (STEPS, BATCH, 32, 32, 3), np.uint8),
             labels=rng.integers(0, 10, (STEPS, BATCH)).astype(np.int32))
    step_task = {"kind": "step", "steps": STEPS, "lr": LR,
                 "global_batch": BATCH,
                 "weights": os.path.join(tmp, "weights.npz"),
                 "batches": os.path.join(tmp, "batches.npz")}
    tasks = {
        2: [{**step_task, "strategies": [n for w, n in STEP_CASES if w == 2]},
            {"kind": "counts", "strategies": list(VGG11_COUNTS)},
            {"kind": "single"}],
        4: [{**step_task, "strategies": [n for w, n in STEP_CASES if w == 4]}],
    }
    ranks = {}
    for world, ts in tasks.items():
        os.makedirs(os.path.join(tmp, f"w{world}"))
        ranks[world] = worker.start({
            "world": world, "rdzv": f"file://{tmp}/rdzv_w{world}",
            "out": os.path.join(tmp, f"w{world}"), "tasks": ts}, tmp)
    batches = np.load(os.path.join(tmp, "batches.npz"))
    reference = {(w, n): _reference_run(w, n, batches)
                 for w, n in STEP_CASES}
    for r in ranks.values():
        r.wait(timeout=400)
    return tmp, reference


def _load(tmp, world, name):
    return [np.load(os.path.join(tmp, f"w{world}", f"{name}_r{r}.npz"))
            for r in range(world)]


@pytest.mark.parametrize("world,name", STEP_CASES)
def test_whole_step_matches_reference(dist_runs, world, name):
    tmp, reference = dist_runs
    want_losses, want_params, want_bn = reference[world, name]
    ranks = _load(tmp, world, "step")
    sds = [{k[len(f"{name}/sd/"):]: torch.from_numpy(npz[k])
            for k in npz.files if k.startswith(f"{name}/sd/")}
           for npz in ranks]
    for npz in ranks:
        np.testing.assert_allclose(npz[f"{name}/losses"], want_losses,
                                   rtol=1e-3)
    for sd in sds[1:]:                    # the ranks agree bit for bit
        assert sd.keys() == sds[0].keys()
        for k in sd:
            assert torch.equal(sd[k], sds[0][k]), k
    got_params, got_bn = convert.to_jax(sds[0])
    for got, want in zip(jax.tree.leaves((got_params, got_bn)),
                         jax.tree.leaves((want_params, want_bn))):
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("name", list(VGG11_COUNTS))
def test_collective_counts_per_step_at_vgg11_width(dist_runs, name):
    tmp, _ = dist_runs
    for npz in _load(tmp, 2, "counts"):
        assert npz[f"{name}/counts"].tolist() == VGG11_COUNTS[name]
        launched = int(npz[f"{name}/launched_before_block0"])
        if name == "overlap":
            # Bucket 0 (fc1 and the last blocks) went out while backward
            # had not yet reached the first convolution's weight.
            assert launched == 1
        else:
            assert launched == 0


def test_single_refuses_a_world_above_one(dist_runs):
    tmp, _ = dist_runs
    for r in range(2):
        with open(os.path.join(tmp, "w2", f"single_r{r}.json")) as f:
            assert "requires world 1" in json.load(f)["refused"]


@pytest.fixture(scope="module")
def world1_runs():
    """The stateless tiers and ``single`` in this process, on a world-1
    gloo group: three augmented steps each from the same seed."""
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    created = not dist.is_initialized()
    initialize_distributed(device="cpu")
    try:
        out = {}
        for name in ("single", "gather", "allreduce", "ddp", "overlap"):
            tr = Trainer("vggt", name, global_batch=16,
                         data_dir=worker.ASSETS, device="cpu",
                         sgd_cfg=SGDConfig(lr=LR), limit_train_batches=3,
                         log=lambda s: None)
            assert (tr.world, tr.rank) == (1, 0)
            tr.train_model(0)
            out[name] = (tr.state.model.state_dict(),
                         tr.last_epoch_timers.losses)
        return out
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.parametrize("name", ["gather", "allreduce", "ddp", "overlap"])
def test_world1_tier_is_bitwise_single(world1_runs, name):
    sd, losses = world1_runs[name]
    want_sd, want_losses = world1_runs["single"]
    assert losses == want_losses
    for k, v in want_sd.items():
        assert torch.equal(sd[k], v), k


def test_defaults_are_allreduce_on_the_card():
    assert inspect.signature(Trainer).parameters["strategy"].default == \
        "allreduce"
    args = cli.parse_args([])
    assert (args.strategy, args.device, args.num_devices) == \
        ("allreduce", None, None)
    with pytest.raises(ValueError, match="master"):
        initialize_distributed(None, 2, 0, device="cpu")
    # The backend follows the device, and a group of the other backend is
    # refused rather than used.
    assert mesh.backend_for(torch.device("cuda")) == "nccl"
    assert mesh.backend_for(torch.device("cpu")) == "gloo"
    created = not dist.is_initialized()
    initialize_distributed(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="needs nccl"):
            mesh.Group(torch.device("cuda"))
        assert mesh.Group(torch.device("cpu")).world == 1
    finally:
        if created:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_spawns_two_gloo_ranks_with_the_reference_schedule(tmp_path):
    world, batch = 2, 16
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "cs744_ddp_tpu_torch.cli", "--device", "cpu",
         "--num-devices", str(world), "--strategy", "ddp",
         "--batch-size", str(batch), "--limit-train-batches", "20",
         "--limit-eval-batches", "1", "--data-dir", worker.ASSETS,
         "--port", str(_free_port()), "--save", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    per_rank = batch // world
    num = r"[-+0-9.e]+"
    expected = [
        # ceil(ceil(320 / 2) / (16 / 2)) and ceil(64 / (16 / 2)): the
        # reference package's lines for world 2 on the fixture data.
        rf"Size of training set is {-(-(-(-320 // world)) // per_rank)}",
        rf"Size of test set is {-(-64 // per_rank)}",
        rf"Training loss after 20 iterations is {num}",
        rf"Training time after 1 epoch is {num}",
        rf"Test set: Average loss: {num}, Accuracy: \d+/{batch} \({num}%\)",
    ]
    lines = [l for l in out.stdout.splitlines() if l]
    assert len(lines) == len(expected), out.stdout   # rank 0 prints alone
    for line, pattern in zip(lines, expected):
        assert re.fullmatch(pattern, line), (pattern, line)
    sds = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert sds[0].keys() == sds[1].keys()
    for k in sds[0]:
        assert torch.equal(sds[0][k], sds[1][k]), k
