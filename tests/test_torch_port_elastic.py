"""The port's elastic layer (cs744_ddp_tpu_torch/elastic/, the Trainer's
``elastic`` mode, ``parallel.strategies.reshard_comm``, the CLI's
``--elastic``), on the CPU.

  * The planner, the straggler detector, ``tree_combine_mean``,
    ``reshard_comm`` and the coordinator's ladder against the reference's,
    exactly (the coordinator driven by stand-ins on both sides).
  * World 1's strong step against an oracle of reference pieces: the
    reference model's ``value_and_grad`` of CE on each microshard, its
    ``tree_combine_mean`` of the losses, gradients and BN statistics, its
    ``sgd.update`` (augmentation off, weights carried by
    ``models/convert.py``).  The reference's own elastic window cannot be
    the oracle on this toolchain (ROADMAP queue 3, R3).
  * Over gloo (tests/torch_dist_worker.py, one thread a rank): a narrow VGG
    at global batch 64, S = 4, seed 3, ``loop.WINDOW`` 3, augmentation on,
    trained 2 epochs at worlds 1, 2 and 4: bitwise the same state; the
    ``rank_death`` ladder (world 2 -> 1, also with ``coordinator_loss``)
    and ``slow_rank`` at world 4 bitwise the same again; a compress-bf16
    residual stack carried through a 2 -> 1 resume by its sum; the CLI's
    ladder against the CLI's fault-free world-1 run.
  * The refusals, each with its message, and the weak protocol's resume
    plan at a world resize through the Trainer (ROADMAP queue 3).
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs744_ddp_tpu.data import augment as jaug
from cs744_ddp_tpu.elastic import coordinator as jcoordinator
from cs744_ddp_tpu.elastic import protocol as jprotocol
from cs744_ddp_tpu.elastic import step_elastic as jstep_elastic
from cs744_ddp_tpu.elastic import straggler as jstraggler
from cs744_ddp_tpu.ft import chaos as jchaos
from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.ops import loss as jloss
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.parallel import strategies as jstrategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch import elastic as telastic
from cs744_ddp_tpu_torch.elastic import protocol as tprotocol
from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import mesh as tmesh
from cs744_ddp_tpu_torch.parallel import strategies as tstrategies
from cs744_ddp_tpu_torch.train import loop
from cs744_ddp_tpu_torch.train import step as tstep

import torch_dist_worker as worker

GLOBAL_BATCH, MICROSHARDS, SEED, WINDOW, EPOCHS = 64, 4, 3, 3, 2
BASE = {"kind": "elastic", "strategy": "allreduce", "protocol": "strong",
        "global_batch": GLOBAL_BATCH, "microshards": MICROSHARDS,
        "seed": SEED, "window": WINDOW, "epochs": EPOCHS}


# -- the planner and the detector against the reference's -------------------

def _outcome(fn, *args, **kw):
    """fn's result, or its exception's type and message."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return (type(e).__name__, str(e))


METAS = [dict(world=w, global_batch=gb, epoch=e, step=s, **extra)
         for w in (1, 2, 3, 4, 8) for gb in (64, 48, 256)
         for e, s in ((0, 0), (1, 3), (2, 7)) for extra in ({}, {
             "protocol": "weak"})] + [{}, {"step": 5}, {"epoch": 1}]


@pytest.mark.parametrize("protocol", [None, "strong", "weak", "superlinear"])
def test_plan_resume_matches_reference(protocol):
    """Every meta of the grid, both sidecar shapes, worlds 0-8, with and
    without microshards and a default global batch."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # world_of's missing-world note
        n = 0
        for meta in METAS:
            nested = {"epoch": meta.get("epoch", 0),
                      "step": meta.get("step", 0), "data_order": meta}
            for m in (meta, nested):
                flat_t = tprotocol.flat_meta(m)
                assert flat_t == jprotocol.flat_meta(m)
                assert tprotocol.world_of(flat_t) == \
                    jprotocol.world_of(flat_t)
                for new in range(0, 9):
                    for micro in (None, 2, 4, 8):
                        for dgb in (None, 32):
                            kw = dict(protocol=protocol, microshards=micro,
                                      default_global_batch=dgb)
                            got = _outcome(tprotocol.plan_resume, flat_t,
                                           new, **kw)
                            want = _outcome(jprotocol.plan_resume, flat_t,
                                            new, **kw)
                            assert tuple(got) == tuple(want), (m, new, kw)
                            n += 1
    assert n == len(METAS) * 2 * 9 * 4 * 2
    assert tprotocol.flat_meta(None) == jprotocol.flat_meta(None) == {}
    assert tprotocol.PROTOCOLS == jprotocol.PROTOCOLS
    assert tprotocol.ElasticConfig() == tuple(jprotocol.ElasticConfig())
    assert tprotocol.ResumePlan._fields == jprotocol.ResumePlan._fields


def test_plan_shrink_and_keys_match_reference():
    for world in range(0, 10):
        for gb in (64, 48, 7, 256):
            for micro in (None, 2, 4, 8):
                assert _outcome(tprotocol.plan_shrink, world, gb,
                                microshards=micro) == \
                    _outcome(jprotocol.plan_shrink, world, gb,
                             microshards=micro)
    # The data-order keys are re-exported, not copied again.
    from cs744_ddp_tpu_torch.data import sharding
    from cs744_ddp_tpu_torch.train import checkpoint
    assert tprotocol.rank_data_keys is sharding.rank_data_keys
    assert tprotocol.validate_rank_keys is checkpoint.validate_rank_keys
    for w in (1, 2, 4):
        assert tprotocol.rank_data_keys(320, w, seed=SEED) == \
            jprotocol.rank_data_keys(320, w, seed=SEED)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_straggler_detector_matches_reference(world):
    """The same streams of step times, one observation a rank a round,
    with an outlier now and then: the same flags, EWMAs and summaries."""
    rng = np.random.default_rng(world)
    kw = dict(alpha=0.3, threshold=2.0, min_steps=3)
    port = telastic.StragglerDetector(world, **kw)
    ref = jstraggler.StragglerDetector(world, **kw)
    flagged = 0
    for _ in range(40):
        times = rng.uniform(0.09, 0.11, world)
        if rng.random() < 0.3:
            times[rng.integers(world)] += rng.uniform(0.0, 1.5)
        for r, t in enumerate(times):
            port.observe(r, float(t))
            ref.observe(r, float(t))
        got = port.check()
        assert got == ref.check()
        flagged += len(got)
        assert [port.ewma(r) for r in range(world)] == \
            [ref.ewma(r) for r in range(world)]
    assert port.summary() == ref.summary()
    assert (flagged > 0) == (world > 1)
    for bad in (dict(world=0), dict(world=2, threshold=1.0),
                dict(world=2, alpha=0.0)):
        assert _outcome(telastic.StragglerDetector, **bad) == \
            _outcome(jstraggler.StragglerDetector, **bad)


# -- the combine and the reshard against the reference's ---------------------

@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_tree_combine_mean_matches_reference_bitwise(s):
    x = np.random.default_rng(s).normal(size=(s, 33, 5)).astype(np.float32)
    x *= np.float32(10.0) ** np.random.default_rng(s + 9).integers(
        -3, 4, size=(s, 1, 1)).astype(np.float32)
    got = telastic.tree_combine_mean(torch.from_numpy(x)).numpy()
    want = np.asarray(jstep_elastic.tree_combine_mean(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    if s == 4:
        np.testing.assert_array_equal(got, ((x[0] + x[1]) + (x[2] + x[3]))
                                      / np.float32(4))
    with pytest.raises(ValueError, match="power-of-two"):
        telastic.tree_combine_mean(torch.zeros((3, 2)))


@pytest.mark.parametrize("old,new", [(2, 1), (4, 1), (1, 2), (4, 2), (3, 2),
                                     (2, 4), (3, 5)])
def test_reshard_comm_matches_reference_bitwise(old, new):
    """A residual stack and a Q stack of the narrow VGG's shapes, values
    spread over nine decades: the reference's numpy reshard bit for bit."""
    rng = np.random.default_rng(old * 10 + new)

    def stack(shape):
        v = rng.normal(size=(old,) + shape).astype(np.float32)
        return v * (np.float32(10.0) ** rng.integers(
            -4, 5, size=v.shape)).astype(np.float32)

    residual = {f"p{i}": stack(sh) for i, sh in
                enumerate([(8, 3, 3, 3), (8,), (512, 10), (10,)])}
    q = {"p0": stack((27, 4)), "p2": stack((10, 4))}
    want = jstrategies.reshard_comm({"residual": residual, "q": q}, new)
    got = tstrategies.reshard_comm(
        {"residual": {k: torch.from_numpy(v) for k, v in residual.items()},
         "q": {k: torch.from_numpy(v) for k, v in q.items()}}, new)
    for kind in ("residual", "q"):
        assert set(got[kind]) == set(want[kind])
        for k, v in want[kind].items():
            assert got[kind][k].shape == (new,) + v.shape[1:]
            np.testing.assert_array_equal(got[kind][k].numpy(), v)
    no_q = tstrategies.reshard_comm(
        {"residual": {"p1": torch.from_numpy(residual["p1"])}}, new)
    assert set(no_q) == {"residual"}


# -- world 1's strong step against reference pieces --------------------------

def _reference_pieces_steps(params, bn_state, images, labels, lr, s):
    """The strong step as the reference's pieces compute it, one step per
    batch: per microshard ``value_and_grad`` of CE through the reference
    model in train mode, ``tree_combine_mean`` of the losses, gradients
    and new BN statistics, ``sgd.update``.  The reference's window does
    this too, but fails to trace on this toolchain (R3)."""
    _, apply_fn = jvgg.make("VGGT")
    opt = jsgd.init(params)
    cfg = jsgd.SGDConfig(lr=lr)

    @jax.jit
    def micro(params, bn_state, x, y):
        def loss_fn(p):
            logits, new_bn = apply_fn(p, bn_state, x, train=True)
            return jloss.cross_entropy(logits, y), new_bn
        (loss, new_bn), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return loss, grads, new_bn

    losses = []
    for imgs, labs in zip(images, labels):
        mb = imgs.shape[0] // s
        outs = [micro(params, bn_state,
                      jaug.normalize(jnp.asarray(imgs[j * mb:(j + 1) * mb])),
                      jnp.asarray(labs[j * mb:(j + 1) * mb]))
                for j in range(s)]
        stacked = jax.tree.map(lambda *a: jnp.stack(a), *outs)
        loss, grads, bn_state = jax.tree.map(
            jstep_elastic.tree_combine_mean, stacked)
        params, opt = jsgd.update(params, grads, opt, cfg)
        losses.append(float(loss))
    return np.array(losses), params, bn_state


@pytest.mark.parametrize("data_seed", [0, 1])
def test_world1_strong_steps_match_reference_pieces(data_seed):
    """Narrow VGG, batch 16 in S = 4 microshards of 4, lr 0.01,
    augmentation off, 3 steps through a ``TrainWindow`` of the
    ``MicroshardStep``: losses rtol 1e-3, parameters and BN statistics at
    test_torch_port_window.py's bound (rtol 1e-2 / atol 2e-3: f32
    summation order at lr 0.01, the window short for queue 3's near-tie
    drift)."""
    lr, batch, steps = 0.01, 16, 3
    jvgg.CFG["VGGT"] = worker.NARROW_VGG
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    init_fn, _ = jvgg.make("VGGT")
    params, bn_state = init_fn(jax.random.PRNGKey(data_seed))
    rng = np.random.default_rng(data_seed)
    images = rng.integers(0, 256, (steps, batch, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (steps, batch)).astype(np.int32)
    want_losses, want_p, want_bn = _reference_pieces_steps(
        params, bn_state, images, labels, lr, MICROSHARDS)

    model = tvgg.VGG("VGGT").to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(
        jax.tree.map(np.array, params), jax.tree.map(np.array, bn_state)))
    body = telastic.MicroshardStep(model, tsgd.SGDConfig(lr=lr),
                                   microshards=MICROSHARDS, augment=False)
    window = tstep.TrainWindow(body, tstep.init_train_state(model),
                               torch.from_numpy(images.copy()),
                               torch.from_numpy(labels.astype(np.int64)))
    fetched = window(0, 0, steps).numpy()
    np.testing.assert_allclose(window.losses_of(fetched, 0, steps),
                               want_losses, rtol=1e-3)
    pj, sj = convert.to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves((pj, sj)),
                    jax.tree.leaves((want_p, want_bn))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=2e-3)
    for bn in (m for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)):
        assert int(bn.num_batches_tracked) == steps     # once a step


def test_microshard_rows_restore_the_model_and_key_on_the_global_index():
    """A rank's rows leave the parameters and buffers as they were; the
    rows of rank r of world M are rows ``r*k ..`` of world 1's, bitwise,
    augmentation on (the draws keyed by the global microshard index)."""
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    model = tvgg.VGG("VGGT").to(memory_format=torch.channels_last)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (16, 32, 32, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, 16))
    epoch, idx = torch.tensor(1), torch.tensor(2)
    before = [t.clone() for t in tstep.state_tensors(
        tstep.init_train_state(model))]
    whole = telastic.MicroshardStep(model, microshards=4).local_rows(
        images, labels, epoch, idx).clone()
    for t, b in zip(tstep.state_tensors(tstep.init_train_state(model)),
                    before):
        assert torch.equal(t, b)
    for world in (2, 4):
        k = 4 // world
        for r in range(world):
            rows = telastic.MicroshardStep(
                model, microshards=4, world=world, rank=r).local_rows(
                images[r * 4 * k:(r + 1) * 4 * k],
                labels[r * 4 * k:(r + 1) * 4 * k], epoch, idx)
            assert torch.equal(rows, whole[r * k:(r + 1) * k])
    assert not torch.equal(whole[0], whole[1])


# -- the coordinator against the reference's ---------------------------------

class _RefStandIn:
    """A reference trainer stand-in: dies as scripted, writing the
    mid-epoch sidecar a real death leaves."""

    def __init__(self, world, script, ckdir):
        self.mesh = make_mesh(world)
        self.world, self.script, self.ckdir = world, script, ckdir
        self.rank_death = None

    def run(self, epochs, checkpoint_dir):
        self.rank_death = self.script.pop(0)
        if self.rank_death is not None:
            _write_mid_meta(checkpoint_dir, self.world, self.rank_death)


def _write_mid_meta(ckdir, world, death):
    os.makedirs(ckdir, exist_ok=True)
    with open(os.path.join(ckdir, "mid_epoch_meta.json"), "w") as f:
        json.dump({"epoch": death[1], "step": death[2],
                   "data_order": {"world": world}}, f)


def _without_times(report):
    return {**report, "events": [
        {k: v for k, v in e.items() if not k.endswith("_s")}
        for e in report["events"]]}


SCRIPTS = {
    "shrink": (2, None, [(1, 0, 3), None], []),
    "retry-shrink-shrink": (4, 1, [(1, 0, 3), (2, 0, 6), (0, 1, 2), None],
                            ["coordinator_loss:2"]),
    "loss-then-fallback": (4, None, [(3, 0, 1), (1, 0, 4), None],
                           ["coordinator_loss:0", "coordinator_loss:1"]),
    "death-at-world-1": (2, None, [(0, 0, 3), (0, 0, 5)], []),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_coordinator_matches_reference_on_scripted_deaths(tmp_path, name):
    """The ladder over a scripted sequence of deaths, the reference's
    coordinator driven by stand-in trainers and the port's by stand-in
    launches: the same log, events (times aside) and report, or the same
    error at world 1.  ``retries`` on: a trusted probe retries once."""
    world, retries, script, chaos = SCRIPTS[name]
    trust = retries is not None
    outcome = {}
    for side in ("ref", "port"):
        ck = str(tmp_path / side)
        lines, deaths = [], list(script)
        worlds = []
        if side == "ref":
            coord = jcoordinator.ElasticCoordinator(
                lambda w: (worlds.append(w),
                           _RefStandIn(w, deaths, ck))[1],
                world=world, global_batch=GLOBAL_BATCH,
                chaos=jchaos.ChaosPlan.parse(chaos) if chaos
                else jchaos.NULL_CHAOS, trust_probe=trust,
                max_retries=retries or 1, log=lines.append)
        else:
            def launch(w, members, epochs, ckdir, pending):
                worlds.append(w)
                death = deaths.pop(0)
                if death is not None:
                    _write_mid_meta(ckdir, w, death)
                return telastic.Generation(death)

            coord = telastic.ElasticCoordinator(
                launch, world=world, global_batch=GLOBAL_BATCH,
                chaos=ChaosPlan.parse(chaos), trust_probe=trust,
                max_retries=retries or 1,
                probe=lambda m: tmesh.probe_devices(m, "cpu"),
                log=lines.append)
        try:
            coord.run(1, ck)
            err = None
        except RuntimeError as e:
            err = str(e)
        outcome[side] = (lines, worlds, err, _without_times(coord.report()))
    assert outcome["port"] == outcome["ref"]
    if name == "shrink":
        assert outcome["port"][3]["members"] == [0]


def test_coordinator_maps_a_dead_rank_to_its_member():
    """After a shrink, a rank is a position in the surviving members: the
    port shrinks away the member that died.  (The reference removes the
    member whose id equals the rank, ROADMAP queue 3.)"""
    script = [(0, 0, 3), (1, 0, 6), None]
    coord = telastic.ElasticCoordinator(
        lambda w, members, *a: telastic.Generation(script.pop(0)),
        world=4, global_batch=GLOBAL_BATCH,
        probe=lambda m: [], log=lambda s: None)
    coord.run(1, "unused")
    # world 4 -> 2 on members (1, 2); rank 1 of those is member 2 -> (1,)
    assert coord.report()["members"] == [1]
    assert tmesh.surviving_members((0, 1, 2, 3), 2, (1,)) == (0, 2)
    with pytest.raises(ValueError, match="only 1 of 2 members"):
        tmesh.surviving_members((0, 1), 2, (0,))
    assert tmesh.probe_devices((0, 1, 2), "cpu") == []


def test_pending_chaos_hands_on_the_unfired_entries():
    plan = ChaosPlan.parse(["rank_death:3:1", "slow_rank:2:2",
                            "coordinator_loss:0"])
    assert plan.pending() == ["rank_death:3:1", "slow_rank:2:2",
                              "coordinator_loss:0:0"]
    assert plan.fire_reached("rank_death", 4)
    assert plan.pending() == ["slow_rank:2:2", "coordinator_loss:0:0"]
    again = ChaosPlan.parse(plan.pending())
    assert again.spec() == plan.spec()[1:]


# -- the refusals -------------------------------------------------------------

def _narrow(**kw):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    args = dict(global_batch=GLOBAL_BATCH, data_dir=worker.ASSETS,
                device="cpu", limit_train_batches=2, log=lambda s: None)
    args.update(kw)
    return loop.Trainer("vggt", "single", **args)


TRAINER_REFUSALS = {
    "protocol": (dict(elastic="superlinear"), "protocol must be one of"),
    "microshards": (dict(elastic="strong", global_batch=50),
                    "not divisible by microshards 4"),
    "host": (dict(elastic="strong", host_augment=True), "device-side"),
    "per-step": (dict(elastic="strong", profile_phases=True),
                 "windowed-only"),
    "guard": (dict(elastic="strong", ft=FTConfig(nonfinite="skip")),
              "non-finite guard"),
    "power-of-two": (dict(elastic=telastic.ElasticConfig("strong", 6),
                          global_batch=48), "power of two"),
    "coordinator_loss": (dict(ft=FTConfig(chaos=ChaosPlan.parse(
        ["coordinator_loss:0"]))), "needs elastic"),
}


@pytest.mark.parametrize("case", list(TRAINER_REFUSALS))
def test_trainer_refuses(case):
    kw, why = TRAINER_REFUSALS[case]
    with pytest.raises(ValueError, match=why):
        _narrow(**kw)


def test_microshard_step_refusals():
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    model = tvgg.VGG("VGGT")
    for kw, why in ((dict(microshards=2, world=4), "not divisible by world"),
                    (dict(microshards=4, augment="host"), "on-device"),
                    (dict(microshards=3), "power of two")):
        with pytest.raises(ValueError, match=why):
            telastic.MicroshardStep(model, **kw)
    step = telastic.MicroshardStep(model, microshards=4, world=2)
    with pytest.raises(ValueError, match="process group"):
        step(tstep.init_train_state(model),
             torch.zeros((8, 32, 32, 3), dtype=torch.uint8),
             torch.zeros(8, dtype=torch.int64), torch.tensor(0),
             torch.tensor(0))


CLI_REFUSALS = {
    "resume-world": (["--resume-world", "2"], "requires --elastic"),
    "checkpoint-dir": (["--elastic", "strong"], "requires --checkpoint-dir"),
    "num-nodes": (["--elastic", "strong", "--checkpoint-dir", "ck",
                   "--num-nodes", "2", "--master", "h"], "one host"),
    "coordinator_loss": (["--nonfinite", "skip", "--chaos",
                          "coordinator_loss:0"], "needs elastic"),
    "strong-host": (["--elastic", "strong", "--checkpoint-dir", "ck",
                     "--host-augment"], "device-side"),
    "strong-guard": (["--elastic", "strong", "--checkpoint-dir", "ck",
                      "--nonfinite", "skip"], "non-finite guard"),
}


@pytest.mark.parametrize("case", list(CLI_REFUSALS))
def test_cli_refuses(case):
    argv, why = CLI_REFUSALS[case]
    with pytest.raises(SystemExit, match=why):
        cli.main(["--device", "cpu", "--data-dir", worker.ASSETS] + argv)


def test_weak_resize_plans_in_batches_of_the_resized_world():
    """The weak protocol through the Trainer, as the CLI builds every
    generation (the same global batch): a world-2 save at step 3 of
    global batch 64 resumed at world 1 plans ``3 * 64 // 32 = 6`` steps
    of the per-rank batch of 32, while the Trainer trains batches of 64
    from there.  The reference's CLI does the same; ROADMAP queue 3 holds
    the difference."""
    tr = _narrow(elastic="weak", log=lambda s: None)
    meta = {"epoch": 0, "step": 3, "data_order": {
        "world": 2, "global_batch": 64, "protocol": "weak"}}
    assert tr._plan_elastic_resume(meta, 3) == 6
    plan = tr.resume_plan
    assert (plan.old_world, plan.new_world, plan.new_global_batch) == \
        (2, 1, 32)
    assert tr.global_batch == 64           # what it trains from step 6
    want = jprotocol.plan_resume(tprotocol.flat_meta(meta), 1,
                                 protocol="weak", default_global_batch=64)
    assert tuple(plan) == tuple(want)


# -- over gloo: worlds 1, 2 and 4 --------------------------------------------

def _run_worlds(tmp, specs):
    """Start every ``tag: (world, tasks)`` at once, then wait for all."""
    ranks = []
    for tag, (world, tasks) in specs.items():
        out = os.path.join(tmp, tag)
        os.makedirs(out, exist_ok=True)
        ranks.append(worker.start({"world": world,
                                   "rdzv": f"file://{out}/rdzv",
                                   "out": out, "tasks": tasks}, out))
    for r in ranks:
        r.wait(timeout=300)


def _load(tmp, tag, name, rank=0):
    return np.load(os.path.join(tmp, tag, f"elastic_{name}_r{rank}.npz"))


def _state(npz):
    return {k: npz[k] for k in npz.files if k.startswith("state/")}


def _assert_same_state(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One narrow-VGG strong run at each of worlds 1, 2 and 4 (world 4
    saving into a checkpoint directory), ``slow_rank:3:2`` at world 4, and
    a compress-bf16 run at world 2 with planted residuals, all at once;
    then that run's checkpoint resumed at world 1."""
    tmp = str(tmp_path_factory.mktemp("port_elastic"))
    residual = {**BASE, "strategy": "compress-bf16", "limit": 3,
                "epochs": 1, "dir": os.path.join(tmp, "ck_residual")}
    _run_worlds(tmp, {
        "w1": (1, [{**BASE, "name": "w1"}]),
        "w2": (2, [{**BASE, "name": "w2"}]),
        "w4": (4, [{**BASE, "name": "w4", "dir": os.path.join(tmp, "ck4")},
                   {**BASE, "name": "slow", "chaos": ["slow_rank:3:2"],
                    "stall": 2.0}]),
        "r2": (2, [{**residual, "name": "r2", "plant": True}])})
    _run_worlds(tmp, {"r1": (1, [{**residual, "name": "r1"}])})
    return tmp


@pytest.mark.parametrize("world", [2, 4])
def test_strong_trajectory_is_bitwise_the_same_at_worlds_1_2_4(worlds,
                                                               world):
    """Every rank's state after 2 epochs (parameters, BN buffers,
    momentum) bitwise world 1's, the losses too; one all-gather a step
    and no other collective of the Group at any world."""
    want = _load(worlds, "w1", "w1")
    assert want["counts"].tolist() == [0, 0, 0, 0, 2 * 5]
    for r in range(world):
        got = _load(worlds, f"w{world}", f"w{world}", r)
        _assert_same_state(_state(got), _state(want))
        np.testing.assert_array_equal(got["losses"], want["losses"])
        assert got["counts"].tolist() == want["counts"].tolist()
    assert np.isfinite(want["losses"]).all() and len(want["losses"]) == 5
    bn = [k for k in _state(want) if k.endswith("num_batches_tracked")]
    assert bn and all(int(want[k]) == 2 * 5 for k in bn)


def test_epoch_sidecar_carries_world_protocol_and_microshards(worlds):
    meta = json.loads(str(_load(worlds, "w4", "w4")["sidecar"]))
    assert (meta["world"], meta["global_batch"], meta["protocol"],
            meta["microshards"], meta["epoch"]) == (4, 64, "strong", 4, 1)
    assert meta["rank_keys"] == list(jprotocol.rank_data_keys(
        320, 4, seed=SEED))


def test_slow_rank_flags_its_target_alone_and_leaves_the_state(worlds):
    """``slow_rank:3:2`` at world 4: rank 2 sleeps 2 s at the boundary at
    step 3 and adds it to its own gauge; every rank's detector flags rank
    2 alone, and the state is bitwise world 1's."""
    want = _state(_load(worlds, "w1", "w1"))
    flags = set()
    for r in range(4):
        npz = _load(worlds, "w4", "slow", r)
        flags.add(npz["flags"].item())
        _assert_same_state(_state(npz), want)
    (only,) = flags
    assert set(json.loads(only)) == {"2"} and json.loads(only)["2"] >= 1
    log = _load(worlds, "w4", "slow")["log"].tolist()
    assert "chaos: injected slow_rank at step 3" in log
    assert any(ln.startswith("elastic: rank 2 straggling") for ln in log)
    assert not any("straggling" in ln and "rank 2" not in ln for ln in log)


def test_compress_bf16_residuals_survive_a_2_to_1_resume_summed(worlds):
    """The residual stack of a compress-bf16 strong run at world 2
    (planted per rank; the microshard step carries it unchanged) is
    resumed at world 1 as its sum, bitwise; the parameters as saved."""
    from cs744_ddp_tpu_torch.train.checkpoint import CheckpointManager
    r2 = [_load(worlds, "r2", "r2", r) for r in range(2)]
    names = [k for k in r2[0].files if k.startswith("state/comm/residual/")]
    assert names
    for r, npz in enumerate(r2):
        planted = worker.planted_residuals(
            [npz[k].shape for k in names], r)
        for k, v in zip(names, planted):
            np.testing.assert_array_equal(npz[k], v)      # carried
    r1 = _load(worlds, "r1", "r1")
    for k in names:
        np.testing.assert_array_equal(r1[k], r2[0][k] + r2[1][k])
    for k in _state(r1):
        if not k.startswith("state/comm/"):
            np.testing.assert_array_equal(r1[k], r2[0][k])
    log = r1["log"].tolist()
    assert "Resumed from checkpoint: epoch 1" in log
    assert CheckpointManager(os.path.join(worlds, "ck_residual")
                             ).latest_epoch() == 0


# -- over gloo: the ladder ----------------------------------------------------

@pytest.fixture(scope="module")
def ladders(tmp_path_factory):
    """The coordinator over real launches of gloo ranks: ``rank_death:3:1``
    at world 2, alone and with ``coordinator_loss:0``."""
    tmp = str(tmp_path_factory.mktemp("port_ladder"))
    out = {}
    for tag, chaos in (("death", ["rank_death:3:1"]),
                       ("loss", ["rank_death:3:1", "coordinator_loss:0"])):
        plan, lines, gens = ChaosPlan.parse(chaos), [], []

        def launch(world, members, epochs, ckdir, pending, tag=tag,
                   gens=gens):
            name = f"{tag}{len(gens)}"
            _run_worlds(tmp, {name: (world, [{
                **BASE, "name": name, "epochs": epochs, "dir": ckdir,
                "chaos": pending}])})
            npz = _load(tmp, name, name)
            gens.append((world, tuple(members), list(pending), npz))
            return telastic.Generation(
                tuple(npz["rank_death"].tolist()) or None,
                tuple(map(tuple, json.loads(str(npz["fired"])))))

        coord = telastic.ElasticCoordinator(
            launch, world=2, global_batch=GLOBAL_BATCH,
            microshards=MICROSHARDS, chaos=plan,
            probe=lambda m: tmesh.probe_devices(m, "cpu"), log=lines.append)
        coord.run(EPOCHS, os.path.join(tmp, f"ck_{tag}"))
        out[tag] = (coord, plan, lines, gens)
    return out


@pytest.mark.parametrize("tag", ["death", "loss"])
def test_rank_death_ladder_shrinks_and_ends_bitwise_world_1(worlds, ladders,
                                                            tag):
    coord, plan, lines, gens = ladders[tag]
    assert [(w, m) for w, m, _, _ in gens] == [(2, (0, 1)), (1, (0,))]
    first, second = gens[0][3], gens[1][3]
    assert first["rank_death"].tolist() == [1, 0, 3]
    assert "Rank 1 died at epoch 0 step 3; emergency checkpoint saved" in \
        first["log"].tolist()
    assert ("rank_death", 3) in plan.fired
    # The dead generation's fired entry is not handed on.
    assert not any(s.startswith("rank_death") for s in gens[1][2])
    assert [e["kind"] for e in coord.events] == ["shrink"]
    assert any("shrinking world 2 -> 1" in ln for ln in lines)
    rep = coord.report()
    assert (rep["world"], rep["degraded"], rep["generation"],
            rep["members"]) == (1, True, 1, [0])
    plan_r = json.loads(str(second["plan"]))
    assert (plan_r["old_world"], plan_r["new_world"], plan_r["start_step"],
            plan_r["examples_replayed"]) == (2, 1, 3, 0)
    assert "Resumed from mid-epoch checkpoint: epoch 0, step 3" in \
        second["log"].tolist()
    if tag == "loss":
        assert ("coordinator_loss", 0) in plan.fired
        assert any("re-deriving from checkpoint metadata" in ln
                   for ln in lines)
    _assert_same_state(_state(second), _state(_load(worlds, "w1", "w1")))


CHILD = '''
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch_dist_worker as worker
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.models import vgg
from cs744_ddp_tpu_torch.train import loop
vgg.CFG["VGGT"] = worker.NARROW_VGG        # also in the spawned ranks,
loop.WINDOW = {window}                      # which import this file
if __name__ == "__main__":
    cli.main(sys.argv[1:])
'''


def _cli(tmp_path, *extra):
    script = tmp_path / "elastic_child.py"
    script.write_text(CHILD.format(
        repo=worker.REPO, tests=os.path.dirname(os.path.abspath(__file__)),
        window=WINDOW))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, str(script), "--device", "cpu", "--model", "vggt",
           "--batch-size", str(GLOBAL_BATCH), "--data-dir", worker.ASSETS,
           "--limit-eval-batches", "1", "--epochs", str(EPOCHS),
           "--elastic", "strong"] + list(extra)
    proc = subprocess.run(cmd, cwd=worker.REPO, env=env, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout
    return proc.stdout


def test_cli_ladder_ends_bitwise_the_cli_world_1_run(tmp_path):
    """``--num-devices 2 --elastic strong --chaos rank_death:3:1``: two
    gloo processes, the death, a launch of one process that resumes; its
    ``--save`` bitwise the fault-free ``--num-devices 1`` run's (the same
    thread count in every rank of every generation)."""
    out = _cli(tmp_path, "--num-devices", "2", "--checkpoint-dir",
               str(tmp_path / "ck"), "--save", str(tmp_path / "ladder"),
               "--chaos", "rank_death:3:1")
    for line in ("Rank 1 died at epoch 0 step 3; emergency checkpoint saved",
                 "elastic: rank 1 died at epoch 0 step 3; shrinking world "
                 "2 -> 1 (single-rank fallback)",
                 "elastic: resuming world 2 -> 1 (strong); start step 3 -> 3",
                 "Resumed from mid-epoch checkpoint: epoch 0, step 3"):
        assert line in out.splitlines(), out
    report = json.loads(out.splitlines()[-1].split("elastic report: ", 1)[1])
    assert (report["world"], report["members"], report["generation"],
            [e["kind"] for e in report["events"]]) == (1, [0], 1, ["shrink"])
    _cli(tmp_path, "--num-devices", "1", "--checkpoint-dir",
         str(tmp_path / "ck1"), "--save", str(tmp_path / "full"))
    got = torch.load(tmp_path / "ladder" / "rank0.pt")
    want = torch.load(tmp_path / "full" / "rank0.pt")
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not (tmp_path / "ladder" / "rank1.pt").exists()
