"""The port's checkpoints and resume (cs744_ddp_tpu_torch/train/
checkpoint.py, ``Trainer.run(checkpoint_dir=...)``, the preemption path of
ft/), on the CPU, held to the port's own bitwise identity as
tests/test_checkpoint.py and tests/test_ft.py hold the reference's, and
to the reference where the two compare: the config guard's refusals, the
data-order keys, the saved tensors' leaf shapes against the reference's
``TrainState``, a directory the reference wrote.

  * Resume after an epoch and mid-epoch (a chaos ``preempt``, windowed and
    per-step) bitwise equal to the uninterrupted run at world 1; at world 2
    over gloo for ``allreduce`` and ``compress-int8`` (residuals nonzero
    at the save); a real SIGTERM to the CLI in a subprocess.
  * A restore goes into the tensors the window captured: a Trainer whose
    window already ran trains on from the restored bits; one that does
    not fit raises.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.elastic import protocol as jprotocol
from cs744_ddp_tpu.parallel import strategies as jstrategies
from cs744_ddp_tpu.train import checkpoint as jcheckpoint
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch.data import sharding as tsharding
from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import initialize_distributed
from cs744_ddp_tpu_torch.train import checkpoint as ckpt
from cs744_ddp_tpu_torch.train import loop
from cs744_ddp_tpu_torch.train import step as tstep

import torch_dist_worker as worker

LR = 0.01
LIMIT = 7


@pytest.fixture
def small_window(monkeypatch):
    monkeypatch.setattr(loop, "WINDOW", 3)


def _trainer(log=None, **kw):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    args = dict(global_batch=4, data_dir=worker.ASSETS, device="cpu",
                sgd_cfg=tsgd.SGDConfig(lr=LR), limit_train_batches=LIMIT,
                limit_eval_batches=1, log=log or (lambda s: None))
    args.update(kw)
    return loop.Trainer("vggt", "single", **args)


def _assert_states_equal(a, b):
    na, nb = tstep.named_state_tensors(a.state), \
        tstep.named_state_tensors(b.state)
    assert list(na) == list(nb)
    for k in na:
        assert torch.equal(na[k], nb[k]), k


def test_epoch_resume_is_bitwise(tmp_path, small_window):
    """run(2) against run(1) saved + a fresh Trainer's resumed run(2);
    then a third run(2) has nothing left to do."""
    base = _trainer()
    base.run(2)
    first = _trainer()
    first.run(1, checkpoint_dir=str(tmp_path))
    lines = []
    resumed = _trainer(lines.append)
    resumed.run(2, checkpoint_dir=str(tmp_path))
    assert "Resumed from checkpoint: epoch 1" in lines
    _assert_states_equal(resumed, base)
    mngr = ckpt.CheckpointManager(str(tmp_path))
    assert mngr.latest_epoch() == 1 and mngr.latest_mid_epoch() is None
    assert mngr.epoch_meta()["epoch"] == 1
    lines.clear()
    again = _trainer(lines.append)
    again.run(2, checkpoint_dir=str(tmp_path))
    assert "All 2 epoch(s) already checkpointed; nothing to run" in lines
    _assert_states_equal(again, base)


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["windowed", "per-step"])
def test_mid_epoch_resume_is_bitwise(tmp_path, small_window, per_step):
    """A chaos SIGTERM once progress reaches batch 5: the windowed path
    stops at the boundary at 6 (WINDOW=3 grid), the per-step path at 5; a
    fresh Trainer resumes there and finishes the epoch bitwise equal to
    an uninterrupted one; the epoch save clears the emergency one."""
    lines = []
    cut = _trainer(lines.append, profile_phases=per_step,
                   ft=FTConfig(chaos=ChaosPlan.parse(["preempt:5"])))
    cut.run(1, checkpoint_dir=str(tmp_path))
    at = 5 if per_step else 6
    assert cut.preempted
    assert f"Preempted at epoch 0 step {at}; emergency checkpoint saved" \
        in lines
    mngr = ckpt.CheckpointManager(str(tmp_path))
    assert mngr.latest_mid_epoch() == (0, at)
    assert mngr.latest_epoch() is None
    meta = mngr.mid_epoch_meta()
    assert (meta["epoch"], meta["step"]) == (0, at)
    assert meta["data_order"]["rank_keys"] == list(
        tsharding.rank_data_keys(len(cut.train_split.labels), 1))

    resumed = _trainer(lines.append, profile_phases=per_step)
    resumed.run(1, checkpoint_dir=str(tmp_path))
    assert not resumed.preempted
    assert f"Resumed from mid-epoch checkpoint: epoch 0, step {at}" in lines
    base = _trainer(profile_phases=per_step)
    base.run(1)
    _assert_states_equal(resumed, base)
    assert resumed.last_epoch_timers.losses == \
        base.last_epoch_timers.losses[at:]
    assert mngr.latest_epoch() == 0 and mngr.latest_mid_epoch() is None


def test_restore_into_a_trainer_whose_window_ran(tmp_path, small_window):
    """The window holds the state's tensors: a restore copies into them,
    and the next window trains from the restored bits."""
    saver = _trainer()
    saver.train_model(0)
    saved = saver.checkpoint_tensors()
    ref = _trainer()
    ref.train_model(0)
    ref.train_model(1)

    tr = _trainer()
    tr.train_model(0)
    tr.train_model(0)                    # somewhere else
    before = [t.data_ptr() for t in tstep.state_tensors(tr.state)]
    tr.load_checkpoint(saved)
    assert [t.data_ptr() for t in tstep.state_tensors(tr.state)] == before
    assert tr.train_window().tensors()[0].data_ptr() == before[0]
    tr.train_model(1)
    _assert_states_equal(tr, ref)


def test_restore_that_does_not_fit_raises():
    tr = _trainer()
    before = [t.clone() for t in tstep.state_tensors(tr.state)]
    saved = tr.checkpoint_tensors()
    wrong_shape = dict(saved)
    k = next(iter(wrong_shape))
    wrong_shape[k] = torch.zeros(3)
    with pytest.raises(ValueError, match="the Trainer"):
        tr.load_checkpoint(wrong_shape)
    missing = dict(saved)
    missing.pop(k)
    with pytest.raises(ValueError, match="do not fit"):
        tr.load_checkpoint(missing)
    wrong_dtype = {**saved, k: saved[k].double()}
    with pytest.raises(ValueError, match="float64"):
        tr.load_checkpoint(wrong_dtype)
    for a, b in zip(before, tstep.state_tensors(tr.state)):
        assert torch.equal(a, b)


# -- world 2 over gloo ---------------------------------------------------------

@pytest.fixture(scope="module")
def gloo_ft(tmp_path_factory):
    """Two gloo ranks: each tier's uninterrupted epoch, its preempted epoch
    and its resumed epoch (WINDOW=3, preempt:2 -> saved at batch 3), and
    the guard under NaN gradients at batch 4."""
    tmp = str(tmp_path_factory.mktemp("port_ft"))
    os.makedirs(os.path.join(tmp, "w2"))
    ranks = worker.start({
        "world": 2, "rdzv": f"file://{tmp}/rdzv_w2",
        "out": os.path.join(tmp, "w2"),
        "tasks": [{"kind": "resume", "strategies": ["allreduce",
                                                    "compress-int8"],
                   "global_batch": 8, "steps": LIMIT, "lr": LR,
                   "window": 3, "preempt": 2,
                   "dir": os.path.join(tmp, "ck")},
                  {"kind": "guard", "strategies": ["allreduce",
                                                   "compress-int8",
                                                   "powersgd"],
                   "global_batch": 8, "steps": LIMIT, "lr": LR,
                   "bad": 4}]}, tmp)
    ranks.wait(timeout=300)
    return [{kind: np.load(os.path.join(tmp, "w2", f"{kind}_r{r}.npz"))
             for kind in ("resume", "guard")} for r in range(2)]


@pytest.mark.parametrize("name", ["allreduce", "compress-int8"])
def test_mid_epoch_resume_is_bitwise_at_world_2(gloo_ft, name):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    names = [n for n, _ in tvgg.VGG("VGGT").named_parameters()]
    for rank, out in enumerate(gloo_ft):
        npz = out["resume"]
        assert npz[f"{name}/saved_at"].tolist() == [0, 3]
        assert npz[f"{name}/preempted"].tolist() == [True, False]
        log = npz[f"{name}/log"].tolist()
        if rank == 0:
            assert "Preempted at epoch 0 step 3; emergency checkpoint " \
                   "saved" in log
            assert "Resumed from mid-epoch checkpoint: epoch 0, step 3" \
                   in log
        else:
            assert log == []            # only rank 0 prints
        keys = [k for k in npz.files if k.startswith(f"{name}/base/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                npz[k], npz[k.replace("/base/", "/resumed/")])
    if name == "compress-int8":
        # The residuals, listed last, one per parameter, are each rank's
        # own and nonzero at the save.
        a, b = (out["resume"] for out in gloo_ft)
        n = sum(k.startswith(f"{name}/at_save/") for k in a.files)
        res = range(n - len(names), n)
        for npz in (a, b):
            assert all(np.abs(npz[f"{name}/at_save/{i}"]).max() > 0
                       for i in res)
        assert any(not np.array_equal(a[f"{name}/at_save/{i}"],
                                      b[f"{name}/at_save/{i}"])
                   for i in res)


@pytest.mark.parametrize("name", ["allreduce", "compress-int8", "powersgd"])
def test_nan_reaches_the_guard_through_every_tier_at_world_2(gloo_ft, name):
    """NaN gradients at batch 4 on both ranks: the post-sync gradients are
    non-finite on every rank (int8 carries it through the scale), so the
    ring's ok column is 0 at exactly batch 4, one update is skipped, and
    the state stays finite."""
    for out in gloo_ft:
        npz = out["guard"]
        rows = npz[f"{name}/rows"]
        np.testing.assert_array_equal(rows[:, 3], np.arange(LIMIT))
        np.testing.assert_array_equal(
            rows[:, 2], [0.0 if i == 4 else 1.0 for i in range(LIMIT)])
        assert np.isfinite(rows[:, 0]).all()
        assert int(npz[f"{name}/skipped"]) == 1
        assert bool(npz[f"{name}/finite"])


# -- a real SIGTERM ------------------------------------------------------------

CHILD = """\
import runpy, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch_dist_worker as worker
from cs744_ddp_tpu_torch.models import vgg
vgg.CFG["VGGT"] = worker.NARROW_VGG
sys.argv = ["cs744_ddp_tpu_torch.cli"] + sys.argv[3:]
runpy.run_module("cs744_ddp_tpu_torch.cli", run_name="__main__")
"""


def _cli(tmp_path, *extra):
    script = tmp_path / "cli_child.py"
    script.write_text(CHILD)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, str(script), worker.REPO,
           os.path.dirname(os.path.abspath(__file__)),
           "--device", "cpu", "--model", "vggt", "--strategy", "single",
           "--batch-size", "2", "--data-dir", worker.ASSETS,
           "--limit-eval-batches", "1", "--lr", str(LR)] + list(extra)
    return subprocess.Popen(cmd, cwd=worker.REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc, timeout=240):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out


def test_sigterm_to_the_cli_saves_and_the_rerun_resumes_bitwise(tmp_path):
    """The CLI as a scheduler preempts it: SIGTERM mid-epoch, after the
    first 20-step window's print.  It finishes the window in flight, saves
    and exits 0; the same command again resumes there and its final
    ``--save`` is bitwise an uninterrupted run's."""
    ck = str(tmp_path / "ck")
    args = ("--checkpoint-dir", ck, "--save", str(tmp_path / "cut"))
    proc = _cli(tmp_path, *args)
    reaper = threading.Timer(240, proc.kill)       # a hang's backstop only
    reaper.start()
    lines, signaled = [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if not signaled and "Training loss after 20 iterations" in line:
                proc.send_signal(signal.SIGTERM)
                signaled = True
        proc.wait(timeout=120)
    finally:
        reaper.cancel()
    out = "".join(lines)
    assert signaled, out
    assert proc.returncode == 0, out
    assert "SIGTERM received" in out
    assert "emergency checkpoint saved" in out
    assert not os.path.exists(tmp_path / "cut")     # no --save when cut
    mid = ckpt.CheckpointManager(ck).latest_mid_epoch()
    # 160 batches: a window boundary from 20 (the signal came before its
    # poll) on; the 140 steps left give the signal ample time to land.
    assert mid is not None and mid[0] == 0, out
    assert mid[1] % 20 == 0 and 20 <= mid[1] < 160, out

    out = _finish(_cli(tmp_path, *args))
    assert f"Resumed from mid-epoch checkpoint: epoch 0, step {mid[1]}" \
        in out, out
    out_full = _finish(_cli(tmp_path, "--save", str(tmp_path / "full")))
    assert "Test set" in out_full, out_full
    got = torch.load(tmp_path / "cut" / "rank0.pt")
    want = torch.load(tmp_path / "full" / "rank0.pt")
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- the config guard and the format -------------------------------------------

@pytest.fixture(scope="module")
def saved_dir(tmp_path_factory):
    """A directory holding one epoch of the narrow VGG, and its config."""
    d = str(tmp_path_factory.mktemp("guard") / "ck")
    tr = _trainer(limit_train_batches=2)
    tr.run(1, checkpoint_dir=d)
    return d, tr.checkpoint_config()


def _changed(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if value is None:
        return 3
    return value + "x"


def _snapshot(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[p] = fh.read()
    return out


@pytest.mark.parametrize("key", [
    "model", "strategy", "compress_rank", "seed", "precision",
    "global_batch", "world", "augment", "reshuffle_each_epoch", "lr",
    "momentum", "weight_decay", "limit_train_batches", "real_data",
    "state_digest"])
def test_config_guard_refuses_each_key(saved_dir, key):
    d, config = saved_dir
    assert key in config
    before = _snapshot(d)
    with pytest.raises(ValueError, match="different training config"):
        ckpt.CheckpointManager(d, config={**config, key: _changed(
            config[key])})
    assert _snapshot(d) == before
    ckpt.CheckpointManager(d, config=config)     # the run's own: accepted


def test_config_guard_refuses_another_format_version(saved_dir, tmp_path):
    d, config = saved_dir
    with open(os.path.join(d, "trainer_config.json")) as f:
        saved = json.load(f)
    assert saved["state_format_version"] == ckpt.STATE_FORMAT_VERSION
    other = str(tmp_path / "v0")
    os.makedirs(other)
    with open(os.path.join(other, "trainer_config.json"), "w") as f:
        json.dump({**saved, "state_format_version": 0}, f)
    with pytest.raises(ValueError, match="state-format version 0"):
        ckpt.CheckpointManager(other, config=config)


def test_corrupt_config_is_refused_and_nothing_is_written(saved_dir,
                                                         tmp_path):
    _, config = saved_dir
    d = str(tmp_path / "torn")
    os.makedirs(d)
    with open(os.path.join(d, "trainer_config.json"), "w") as f:
        f.write('{"model": "vg')
    before = _snapshot(d)
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.CheckpointManager(d, config=config)
    assert _snapshot(d) == before
    with pytest.raises(ValueError, match="corrupt"):
        _trainer().run(1, checkpoint_dir=d)
    assert _snapshot(d) == before


def test_a_directory_the_reference_wrote_is_refused(saved_dir, tmp_path):
    """The reference's orbax layout and its config (version 3, its
    digest): refused whole, with or without its config file."""
    _, config = saved_dir
    d = str(tmp_path / "jax")
    m = jcheckpoint.CheckpointManager(d, config={**config})
    state = {"w": jnp.arange(4.0)}
    m.save(0, state)
    m.save_mid_epoch(1, 3, state)
    m.close()
    before = _snapshot(d)
    with pytest.raises(ValueError, match="another checkpoint format"):
        ckpt.CheckpointManager(d, config=config)
    os.unlink(os.path.join(d, "trainer_config.json"))
    with pytest.raises(ValueError, match="another checkpoint format"):
        ckpt.CheckpointManager(d, config=config)
    os.rename(os.path.join(d, "0"), os.path.join(d, "zero"))
    for sub in os.listdir(os.path.join(d, "mid_epoch")):
        os.rename(os.path.join(d, "mid_epoch", sub),
                  os.path.join(d, "mid_epoch", "x" + sub))
    with open(os.path.join(d, "trainer_config.json"), "w") as f:
        json.dump({**config, "state_format_version":
                   jcheckpoint.STATE_FORMAT_VERSION}, f)
    with pytest.raises(ValueError, match="state-format version 3"):
        ckpt.CheckpointManager(d, config=config)
    assert before  # the reference's files were there to refuse


def test_atomic_write_json_leaves_no_temp_on_error(tmp_path):
    path = str(tmp_path / "meta.json")
    with pytest.raises(TypeError):
        ckpt._atomic_write_json(path, {"bad": object()})
    assert os.listdir(tmp_path) == []
    ckpt._atomic_write_json(path, {"ok": 1})
    assert ckpt.read_epoch_meta(str(tmp_path)) is None
    with open(path) as f:
        assert json.load(f) == {"ok": 1}
    assert os.listdir(tmp_path) == ["meta.json"]


def test_keeps_the_newest_epochs_and_one_mid_epoch_save(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for e in range(4):
        m.save(e, {"x": torch.full((2,), float(e))}, meta={"world": 1})
    assert sorted(os.listdir(tmp_path)) == ["epoch_2.pt", "epoch_3.pt",
                                            "epoch_meta.json"]
    tensors, nxt = m.restore()
    assert nxt == 4 and torch.equal(tensors["x"], torch.full((2,), 3.0))
    assert m.restore(2)[1] == 3
    with pytest.raises(FileNotFoundError):
        m.restore(0)
    m.save_mid_epoch(4, 20, {"x": torch.zeros(2)})
    m.save_mid_epoch(4, 40, {"x": torch.ones(2)})
    assert m.latest_mid_epoch() == (4, 40)
    assert os.listdir(tmp_path / "mid_epoch") == [f"{4 * 10 ** 6 + 40}.pt"]
    assert m.mid_epoch_meta() == {"epoch": 4, "step": 40}
    m.clear_mid_epoch()
    assert m.latest_mid_epoch() is None and m.mid_epoch_meta() is None


@pytest.mark.parametrize("n,world,seed,epoch", [
    (320, 1, 0, 0), (320, 2, 0, 3), (50000, 4, 7, 1), (101, 3, 1, 0)])
def test_rank_data_keys_match_reference(n, world, seed, epoch):
    assert tsharding.rank_data_keys(n, world, seed=seed, epoch=epoch) == \
        jprotocol.rank_data_keys(n, world, seed=seed, epoch=epoch)
    meta = {"world": world, "seed": seed, "epoch": epoch,
            "rank_keys": list(jprotocol.rank_data_keys(
                n, world, seed=seed, epoch=epoch))}
    ckpt.validate_rank_keys(meta, n)
    ckpt.validate_rank_keys({"data_order": meta}, n)
    with pytest.raises(ValueError, match="data-order keys"):
        ckpt.validate_rank_keys(meta, n + 1)


@pytest.mark.parametrize("model,strategy", [
    ("vgg11", "single"), ("vgg11", "compress-int8"),
    ("resnet18", "powersgd")])
def test_saved_tensors_have_the_reference_train_state_leaves(model,
                                                            strategy):
    """The tensors a save writes, carried across with ``convert``, have
    exactly the leaf shapes and dtypes of the reference's ``TrainState``
    for the same model and tier (comm stacked over world 1)."""
    created = not dist.is_initialized()
    if strategy != "single":
        initialize_distributed(device="cpu")
    try:
        tr = loop.Trainer(model, strategy, global_batch=4,
                          data_dir=worker.ASSETS, device="cpu",
                          log=lambda s: None)
        saved = tr.checkpoint_tensors()
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    names = [n for n, _ in tr.state.model.named_parameters()]
    sd = {k[len("model/"):]: v for k, v in saved.items()
          if k.startswith("model/")}
    params, bn = convert.to_jax(sd)
    momentum = convert.params_to_jax(
        {n: saved[f"momentum/{n}"] for n in names})
    port = {"params": params, "bn_state": bn, "momentum": momentum}
    init_fn, _ = jmodels.get_model(model)
    strat = jstrategies.get_strategy(strategy)
    jstate = jstep.init_train_state(init_fn, jax.random.PRNGKey(0), strat,
                                    world=1)
    want = {"params": jstate.params, "bn_state": jstate.bn_state,
            "momentum": jstate.opt_state.momentum}
    if strategy != "single":
        comm = {"residual": [saved[f"comm/residual/{n}"][0] for n in names]}
        if strategy == "powersgd":
            comm["q"] = {n[len("comm/q/"):]: v[0] for n, v in saved.items()
                         if n.startswith("comm/q/")}
        port["comm"] = convert.comm_to_jax([comm], names)
        want["comm"] = jstate.opt_state.comm
    got_leaves = jax.tree_util.tree_flatten_with_path(port)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert (np.shape(a), np.asarray(a).dtype) == \
            (tuple(b.shape), np.dtype(b.dtype)), path
