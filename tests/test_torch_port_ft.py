"""The port's fault-tolerance layer (cs744_ddp_tpu_torch/ft/, the guard in
train/step.py::make_step_body, the policies in train/loop.py), on the CPU.

  * The chaos plan against the reference's: the same entries, one-shot
    firings, payload draws, refusals and site names.
  * The guarded window against the reference's guarded window on
    full-width VGG-11 with NaN gradients planned at batch 1: the ring's
    ``ok`` column, losses, parameters; on the port the bad step leaves the
    state bitwise as it was.
  * The guard off builds nothing; on, with no fault, it trains bitwise as
    off.  The policies (``skip``, ``halt``, ``restore``) and the
    refusals, as tests/test_ft.py pins the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs744_ddp_tpu.ft import chaos as jchaos
from cs744_ddp_tpu.obs import ringbuf as jringbuf
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh, strategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch import ft
from cs744_ddp_tpu_torch.ft import (ChaosPlan, FTConfig, NonFiniteError,
                                    chaos as tchaos, guard as tguard)
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.obs import ringbuf
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import strategies as tstrategies
from cs744_ddp_tpu_torch.train import loop
from cs744_ddp_tpu_torch.train import step as tstep

import torch_dist_worker as worker
from test_torch_port_window import _reference_vgg11

LR = 0.01
LIMIT = 7


# -- the chaos plan against the reference's ----------------------------------

SPECS = [
    ["put_fail:2", "corrupt_slot:3:7"],
    ["producer_crash:4"],
    ["put_fail:5", "preempt:3"],
    ["put_fail:1", "put_fail:9", "preempt:2"],
    ["nonfinite_grad:30", "preempt:25:1", "rank_death:3:1"],
    ["replica_death:2:1", "publish_torn:0:9", "slow_rank:4:2"],
]
# (method, site, args) calls, run in order on both plans.
CALLS = [(m, site, args) for site in jchaos.SITES
         for m, args in (("fire", (3,)), ("fire_range", (0, 5)),
                         ("fire_reached", (2,)), ("fire", (4,)),
                         ("fire_range", (5, 10)), ("fire_reached", (40,)),
                         ("fire", (9,)))]


@pytest.mark.parametrize("specs", SPECS, ids=lambda s: ",".join(s))
def test_chaos_plan_matches_reference(specs):
    ref, port = jchaos.ChaosPlan.parse(specs), ChaosPlan.parse(specs)
    assert port.enabled and port.spec() == ref.spec()
    for site in jchaos.SITES:
        assert port.steps(site) == ref.steps(site)
    for e in ref.spec():
        assert port.seed_of(e["site"], e["step"]) == \
            ref.seed_of(e["site"], e["step"])
        draws = [p.rng(e["site"], e["step"]).integers(0, 2 ** 31, 16)
                 for p in (ref, port)]
        np.testing.assert_array_equal(*draws)
    got = [getattr(port, m)(site, *a) for m, site, a in CALLS]
    want = [getattr(ref, m)(site, *a) for m, site, a in CALLS]
    assert got == want and any(want)
    assert port.fired == ref.fired
    assert port.steps(ref.fired[0][0])        # fired entries stay listed


@pytest.mark.parametrize("bad", [["put_fail"], ["put_fail:x"],
                                 ["meteor_strike:3"], ["put_fail:-1"],
                                 ["preempt:1:2:3"], ["preempt:1:z"]])
def test_bad_chaos_specs_raise_the_reference_errors(bad):
    with pytest.raises(ValueError) as want:
        jchaos.ChaosPlan.parse(bad)
    with pytest.raises(ValueError) as got:
        ChaosPlan.parse(bad)
    assert str(got.value) == str(want.value)


def test_null_chaos_and_site_names_match_reference():
    for name in ("SITES", "RANK_SITES", "REPLICA_SITES", "PUBLISH_SITES"):
        assert getattr(tchaos, name) == getattr(jchaos, name)
    assert ChaosPlan.parse(None) is ft.NULL_CHAOS
    assert ChaosPlan.parse([]) is ft.NULL_CHAOS
    assert tchaos.NullChaos.__slots__ == ()
    with pytest.raises(AttributeError):
        ft.NULL_CHAOS.fired = []
    for m, site, a in CALLS:
        assert getattr(ft.NULL_CHAOS, m)(site, *a) is False
    assert ft.NULL_CHAOS.steps("preempt") == () and \
        ft.NULL_CHAOS.spec() == []
    assert FTConfig() == (("off", ft.NULL_CHAOS))
    assert FTConfig._fields == ("nonfinite", "chaos")
    assert tguard.POLICIES == ("off", "halt", "skip", "restore")


def _narrow(log=None, **kw):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    args = dict(global_batch=4, data_dir=worker.ASSETS, device="cpu",
                sgd_cfg=tsgd.SGDConfig(lr=LR), limit_train_batches=LIMIT,
                log=log or (lambda s: None))
    args.update(kw)
    return loop.Trainer("vggt", "single", **args)


@pytest.mark.parametrize("site", [s for s in jchaos.SITES
                                  if s not in ft.FIRED_SITES])
def test_trainer_refuses_a_site_it_cannot_fire(site):
    plan = ChaosPlan.parse([f"{site}:3"])
    with pytest.raises(ValueError, match=r"not ported yet.*queue 1 item"):
        _narrow(ft=FTConfig(nonfinite="skip", chaos=plan))
    with pytest.raises(SystemExit, match="queue 1 item"):
        cli.ft_config_from_args(cli.parse_args(
            ["--nonfinite", "skip", "--chaos", f"{site}:3"]))


# -- the guarded window against the reference's ------------------------------

def _states_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("data_seed", [0, 1])
def test_guarded_window_matches_reference_guarded_window(data_seed):
    """Full-width VGG-11, batch 8, augment off, lr 0.01, 3 steps with NaN
    gradients planned at batch 1, against the reference's guarded window
    with its ring (tests/test_torch_port_window.py's comparison, at its
    tolerances): the ``ok`` columns equal, [1, 0, 1]; losses rtol 1e-3;
    the squared gradient norms rtol 1e-2 where finite, NaN at batch 1 in
    both; parameters rtol 1e-2 / atol 2e-3.  On the port, the state after
    the bad step is bitwise the state before it."""
    batch, steps = 8, 3
    jstate, apply_fn, model = _reference_vgg11()
    rng = np.random.default_rng(data_seed)
    images = rng.integers(0, 256, (steps, batch, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (steps, batch))

    j_window = jstep.make_train_window(
        apply_fn, strategies.local, make_mesh(1), jsgd.SGDConfig(lr=LR),
        augment=False, metrics_ring=True, nonfinite_guard=True,
        nonfinite_chaos_steps=(1,))
    jstate, jring = j_window(jstate, jringbuf.make_ring(16),
                             jax.random.PRNGKey(0), images,
                             labels.astype(np.int32), jnp.int32(0),
                             jnp.zeros((steps,), jnp.int8))
    want = jringbuf.drain_rows(np.asarray(jring[0]), steps, steps)

    state = tstep.init_train_state(model)
    body = tstep.make_train_step(
        model, tstrategies.local, tsgd.SGDConfig(lr=LR), augment=False,
        nonfinite_guard=True, nonfinite_chaos_steps=(1,)).body
    window = tstep.TrainWindow(body, state, torch.from_numpy(images.copy()),
                               torch.from_numpy(labels.astype(np.int64)),
                               ring_capacity=16)
    after = []
    for i in range(steps):
        fetched = window(0, i, 1).numpy()
        after.append([t.clone() for t in tstep.state_tensors(state)])
    got = ringbuf.drain_rows(fetched, window.ring.writes, steps)
    assert _states_equal(after[1], after[0])
    assert not _states_equal(after[2], after[1])

    g_loss, g_gsq, g_ok, g_steps = ringbuf.split_columns(got)
    w_loss, w_gsq, w_ok, w_steps = jringbuf.split_columns(want)
    np.testing.assert_array_equal(g_ok, [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(g_ok, w_ok)
    np.testing.assert_array_equal(g_steps, w_steps)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-3)
    assert np.isnan(g_gsq[1]) and np.isnan(w_gsq[1])
    np.testing.assert_allclose(g_gsq[[0, 2]], w_gsq[[0, 2]], rtol=1e-2)
    pj, sj = convert.to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves((pj, sj)),
                    jax.tree.leaves((jstate.params, jstate.bn_state))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=2e-3)


# -- the guard off builds nothing; on, with no fault, it is exact ------------

@pytest.mark.parametrize("kw", [{}, {"metrics_ring": 0},
                                {"profile_phases": True}],
                         ids=["windowed", "windowed-no-ring", "per-step"])
def test_guard_off_builds_nothing_and_on_without_fault_is_exact(kw):
    off = _narrow(**kw)
    empty = _narrow(ft=FTConfig(), **kw)
    on = _narrow(ft=FTConfig(nonfinite="skip"), **kw)
    for tr in (off, empty):
        assert tr.train_step.body.guard is None
        w = tr.train_window()
        assert not w.guarded and w.oks is None
    assert on.train_step.body.guard is not None
    assert on.train_step.body.guard.chaos_steps == ()
    w = on.train_window()
    assert w.guarded and (w.oks is not None) == (w.ring is None)
    for tr in (off, empty, on):
        tr.train_model(0)
    assert on.last_epoch_timers.losses == off.last_epoch_timers.losses
    assert on.nonfinite_skipped == 0
    for tr in (empty, on):
        assert _states_equal(tstep.state_tensors(tr.state),
                             tstep.state_tensors(off.state))


def test_guarded_update_is_sgd_update_where_ok():
    """Same bits as ops/sgd.update when ok; nothing written when not."""
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    grads = [torch.randn_like(p) for p in params]
    st = tsgd.SGDState([torch.randn_like(p) for p in params])
    cfg = tsgd.SGDConfig()
    want_p = [p.clone() for p in params]
    want_st = tsgd.SGDState([v.clone() for v in st.momentum])
    tsgd.update(want_p, grads, want_st, cfg)
    before = [t.clone() for t in params + st.momentum]
    tguard.guarded_update(params, grads, st, cfg, torch.tensor(False))
    assert _states_equal(params + st.momentum, before)
    tguard.guarded_update(params, grads, st, cfg, torch.tensor(True))
    assert _states_equal(params + st.momentum,
                         want_p + want_st.momentum)


# -- policies and refusals (WINDOW=3 grid: windows at 3, 6) ------------------

@pytest.fixture
def small_window(monkeypatch):
    monkeypatch.setattr(loop, "WINDOW", 3)


def _finite(tr):
    return all(bool(torch.isfinite(t.float()).all())
               for t in tstep.state_tensors(tr.state))


def test_nonfinite_skip_counts_and_keeps_the_state_finite(small_window):
    plan = ChaosPlan.parse(["nonfinite_grad:2"])
    lines = []
    tr = _narrow(lines.append, ft=FTConfig(nonfinite="skip", chaos=plan))
    timers = tr.train_model(0)
    assert ("nonfinite_grad", 2) in plan.fired
    assert "chaos: injected nonfinite_grad at step 2" in lines
    assert "Non-finite guard (epoch 0): 1 update(s) skipped, 0 rollback(s)" \
        in lines
    assert (tr.nonfinite_skipped, tr.nonfinite_restored) == (1, 0)
    assert np.isfinite(timers.losses).all()
    assert _finite(tr)


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["windowed", "per-step"])
def test_nonfinite_halt_raises(small_window, per_step):
    tr = _narrow(profile_phases=per_step, ft=FTConfig(
        nonfinite="halt", chaos=ChaosPlan.parse(["nonfinite_grad:2"])))
    with pytest.raises(NonFiniteError, match="policy=halt"):
        tr.train_model(0)
    assert _finite(tr)


def test_nonfinite_restore_rolls_back_to_the_snapshot(small_window):
    """NaN at batch 2: the first window's fetch sees it and the state goes
    back to the snapshot (the initial state, no checkpoint yet); training
    goes on with batch 3.  So the epoch ends bitwise where a fresh
    Trainer's epoch from batch 3 does."""
    lines = []
    tr = _narrow(lines.append, ft=FTConfig(
        nonfinite="restore", chaos=ChaosPlan.parse(["nonfinite_grad:2"])))
    tr.train_model(0)
    assert tr.nonfinite_restored == 1
    assert any("rolled back" in ln for ln in lines)
    ref = _narrow()
    ref.train_model(0, start_step=3)
    assert _states_equal(tstep.state_tensors(tr.state),
                         tstep.state_tensors(ref.state))


def test_refusals(small_window, tmp_path):
    with pytest.raises(ValueError, match="requires a nonfinite policy"):
        _narrow(ft=FTConfig(chaos=ChaosPlan.parse(["nonfinite_grad:2"])))
    with pytest.raises(ValueError, match="nonfinite policy must be"):
        _narrow(ft=FTConfig(nonfinite="maybe"))
    with pytest.raises(ValueError, match="needs the non-finite guard"):
        tstep.make_step_body(tvgg.VGG("VGGT"), nonfinite_chaos_steps=(1,))
    tr = _narrow(ft=FTConfig(chaos=ChaosPlan.parse(["preempt:0"])))
    with pytest.raises(RuntimeError, match="chaos preempt requires"):
        tr.train_model(0)                 # no guard installed
    for argv, match in (
            (["--chaos", "nonfinite_grad:2"], "requires --nonfinite"),
            (["--chaos", "preempt:2"], "requires --checkpoint-dir"),
            (["--chaos", "preempt"], "SITE:step")):
        with pytest.raises(SystemExit, match=match):
            cli.ft_config_from_args(cli.parse_args(argv))
    assert cli.ft_config_from_args(cli.parse_args([])) is None
    cfg = cli.ft_config_from_args(cli.parse_args(
        ["--nonfinite", "skip", "--chaos", "nonfinite_grad:2", "--chaos",
         "preempt:4", "--checkpoint-dir", str(tmp_path)]))
    assert cfg.nonfinite == "skip"
    assert cfg.chaos.spec() == [{"site": "nonfinite_grad", "step": 2,
                                 "seed": 0},
                                {"site": "preempt", "step": 4, "seed": 0}]
