"""The port's windowed train path (cs744_ddp_tpu_torch/train/step.py's
windows, train/loop.py's Trainer, obs/ringbuf.py, data/augment.py's
counter-keyed draws), on the CPU, where a window runs its step eagerly.

  * The windowed Trainer against its own per-step path (``profile_phases``):
    parameters, buffers, momentum and comm state bitwise equal, at world 1
    (``single``) and at world 2 over gloo (``allreduce`` and
    ``compress-int8``, whose residuals the step updates in place).
  * Full-width VGG-11 against the reference's ``make_train_window`` with
    its metric ring, and the eval window against ``make_eval_window``, the
    weights carried across with ``convert.from_jax``.
  * The ring's device write and host functions against the reference's;
    the draws; the fetch count; the print schedule; ``metrics_ring``
    validation; ``measure_phase_split`` restoring the state.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.obs import ringbuf as jringbuf
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh, strategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch.data import augment as taug
from cs744_ddp_tpu_torch.data import cifar10 as tcifar
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.obs import ringbuf
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import strategies as tstrategies
from cs744_ddp_tpu_torch.train import step as tstep
from cs744_ddp_tpu_torch.train.loop import Trainer

import torch_dist_worker as worker

LR = 0.01


def _narrow_trainer(**kw):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    args = dict(global_batch=4, data_dir=worker.ASSETS, device="cpu",
                sgd_cfg=tsgd.SGDConfig(lr=LR), log=lambda s: None)
    args.update(kw)
    return Trainer("vggt", "single", **args)


def _assert_states_equal(a, b):
    sa, sb = tstep.state_tensors(a.state), tstep.state_tensors(b.state)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


def test_window_is_bitwise_the_per_step_path():
    """7 augmented batches: one window of 7 against 7 eager steps."""
    win = _narrow_trainer(limit_train_batches=7)
    per = _narrow_trainer(limit_train_batches=7, profile_phases=True)
    win.train_model(0)
    per.train_model(0)
    assert win.train_window().images.shape[0] == 7
    assert win.last_epoch_timers.losses == per.last_epoch_timers.losses
    _assert_states_equal(win, per)
    # The BN running statistics moved, and did so identically.
    assert not torch.equal(win.state.model.blocks[0].bn.running_mean,
                           torch.zeros(8))


@pytest.fixture(scope="module")
def gloo_windows(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_window"))
    os.makedirs(os.path.join(tmp, "w2"))
    ranks = worker.start({
        "world": 2, "rdzv": f"file://{tmp}/rdzv_w2",
        "out": os.path.join(tmp, "w2"),
        "tasks": [{"kind": "window", "strategies": ["allreduce",
                                                    "compress-int8"],
                   "global_batch": 8, "steps": 7, "lr": LR}]}, tmp)
    ranks.wait(timeout=300)
    return [np.load(os.path.join(tmp, "w2", f"window_r{r}.npz"))
            for r in range(2)]


@pytest.mark.parametrize("name", ["allreduce", "compress-int8"])
def test_window_is_bitwise_the_per_step_path_at_world_2(gloo_windows, name):
    for npz in gloo_windows:
        keys = [k for k in npz.files if k.startswith(f"{name}/window/state/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                npz[k], npz[k.replace("/window/", "/per-step/")])
        np.testing.assert_array_equal(npz[f"{name}/window/losses"],
                                      npz[f"{name}/per-step/losses"])
        np.testing.assert_array_equal(npz[f"{name}/window/counts"],
                                      npz[f"{name}/per-step/counts"])
    # The ranks agree on all but the residuals (each rank's own), which
    # state_tensors lists last, one per parameter.
    a, b = gloo_windows
    n = sum(k.startswith("allreduce/window/state/") for k in a.files)
    m = sum(k.startswith(f"{name}/window/state/") for k in a.files)
    for i in range(n):
        np.testing.assert_array_equal(a[f"{name}/window/state/{i}"],
                                      b[f"{name}/window/state/{i}"])
    if name == "compress-int8":
        residuals = [a[f"{name}/window/state/{i}"] for i in range(n, m)]
        convs = sum(v != "M" for v in worker.NARROW_VGG)
        assert len(residuals) == 4 * convs + 2    # conv w, b, BN γ, β; fc
        assert all(np.abs(r).max() > 0 for r in residuals)


def _reference_vgg11(seed=0):
    init_fn, apply_fn = jmodels.get_model("vgg11")
    jstate = jstep.init_train_state(init_fn, jax.random.PRNGKey(seed))
    model = tvgg.VGG("VGG11").to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(
        jax.tree.map(np.array, jstate.params),
        jax.tree.map(np.array, jstate.bn_state)))
    return jstate, apply_fn, model


@pytest.mark.parametrize("data_seed", [0, 1, 2, 3])
def test_train_window_matches_reference_train_window(data_seed):
    """Full-width VGG-11, batch 8, augment off, lr 0.01: the port's window
    of 3 steps, metric ring on, against the reference's scanned window
    with its ring, on uniform random pixels drawn from ``data_seed``.
    Loss rtol 1e-3 and grad sqnorm rtol 1e-2 (f32 summation order; the
    port's sqnorm squares per-parameter norms); parameters at
    test_three_train_steps_match_reference's bound (rtol 1e-2 / atol
    2e-3), which bounds f32 summation order at lr 0.01.

    Measured on seeds 0-7: loss within 7e-6, sqnorm within 9e-4.  The
    window is short on purpose: at this lr the loss climbs (squared
    gradient norm ~5e3 at init), so once gamma and beta have moved, a
    near-tie in a pool window that the fused op (x̂·γ+β rounded twice)
    routes otherwise than XLA's multiply-add grows by about 10x a step,
    to 1e-3-1e-2 in the loss by step 4-6 on some seeds (ROADMAP queue
    3).  Uniform pixels keep the exact ties of flat image regions out."""
    batch, steps = 8, 3
    jstate, apply_fn, model = _reference_vgg11()
    rng = np.random.default_rng(data_seed)
    images = rng.integers(0, 256, (steps, batch, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (steps, batch))

    j_window = jstep.make_train_window(
        apply_fn, strategies.local, make_mesh(1), jsgd.SGDConfig(lr=LR),
        augment=False, metrics_ring=True)
    jstate, jring = j_window(jstate, jringbuf.make_ring(16),
                             jax.random.PRNGKey(0), images,
                             labels.astype(np.int32), jnp.int32(0),
                             jnp.zeros((steps,), jnp.int8))
    want = jringbuf.drain_rows(np.asarray(jring[0]), steps, steps)

    state = tstep.init_train_state(model)
    body = tstep.make_train_step(model, tstrategies.local,
                                 tsgd.SGDConfig(lr=LR), augment=False).body
    window = tstep.TrainWindow(body, state, torch.from_numpy(images.copy()),
                               torch.from_numpy(labels.astype(np.int64)),
                               ring_capacity=16)
    fetched = window(0, 0, steps).numpy()
    got = ringbuf.drain_rows(fetched, window.ring.writes, steps)

    g_loss, g_gsq, g_ok, g_steps = ringbuf.split_columns(got)
    w_loss, w_gsq, w_ok, w_steps = jringbuf.split_columns(want)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-3)
    np.testing.assert_allclose(g_gsq, w_gsq, rtol=1e-2)
    np.testing.assert_array_equal(g_ok, w_ok)
    np.testing.assert_array_equal(g_steps, w_steps)
    np.testing.assert_array_equal(window.losses_of(fetched, 0, steps), g_loss)
    with pytest.raises(RuntimeError, match="not of the window's"):
        window.losses_of(fetched, 1, steps)
    pj, sj = convert.to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves((pj, sj)),
                    jax.tree.leaves((jstate.params, jstate.bn_state))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=2e-3)


def test_eval_window_matches_reference_eval_window():
    """Three batches of 8, the last padded with label -1, running
    statistics drawn away from (0, 1): correct exact, loss rtol 1e-5."""
    jstate, apply_fn, _ = _reference_vgg11(1)
    rng = np.random.default_rng(0)
    bn = jax.tree.map(np.array, jstate.bn_state)
    for layer in bn["bn"]:
        layer["mean"] = rng.normal(0, 0.1, layer["mean"].shape
                                   ).astype(np.float32)
        layer["var"] = rng.uniform(0.5, 2.0, layer["var"].shape
                                   ).astype(np.float32)
    params = jax.tree.map(np.array, jstate.params)
    jstate = jstate._replace(bn_state=bn)
    model = tvgg.VGG("VGG11").to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(params, bn))

    split = tcifar._synthetic_split(20, 4)
    images = np.zeros((3, 8, 32, 32, 3), np.uint8)
    labels = np.full((3, 8), -1, np.int32)
    images.reshape(24, 32, 32, 3)[:20] = split.images
    labels.reshape(24)[:20] = split.labels
    want_loss, want_correct = jstep.make_eval_window(apply_fn, make_mesh(1))(
        jstate, images, labels)
    loss, correct = tstep.make_eval_window(model)(
        torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64)))
    assert int(correct) == int(want_correct)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_ring_write_and_host_functions_match_reference():
    cap, n = 5, 8
    ring = ringbuf.Ring(cap)
    for v in range(n):
        t = torch.tensor(float(v))
        ring.write((t, 2 * t, 1.0, torch.tensor(v + 100)))
    assert int(ring.count) == n                  # total writes, not mod cap

    @jax.jit
    def fill(r, vals):
        def one(r, v):
            return jringbuf.ring_write(r, (v, 2 * v, 1.0, v + 100.0)), None
        return jax.lax.scan(one, r, vals)[0]

    jring = fill(jringbuf.make_ring(cap), jnp.arange(n, dtype=jnp.float32))
    np.testing.assert_array_equal(ring.buf.numpy(), np.asarray(jring[0]))
    buf = ring.buf.numpy()
    for count in (1, 4, 5):
        got = ringbuf.drain_rows(buf, n, count)
        np.testing.assert_array_equal(got, jringbuf.drain_rows(buf, n, count))
        for a, b in zip(ringbuf.split_columns(got),
                        jringbuf.split_columns(got)):
            np.testing.assert_array_equal(a, b)
    assert list(ringbuf.marker_steps(ringbuf.drain_rows(buf, n, 4))) == \
        [104, 105, 106, 107]
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        ringbuf.drain_rows(buf, n, 6)
    with pytest.raises(ValueError, match="exceeds total writes"):
        ringbuf.drain_rows(np.zeros((5, ringbuf.N_METRICS)), 2, 3)
    rows = np.zeros((2, ringbuf.N_METRICS), np.float32)
    rows[:, ringbuf.METRICS.index("marker")] = [2.0 ** 24 - 1, 2.0 ** 24]
    with pytest.raises(ValueError, match="exact-f32"):
        ringbuf.marker_steps(rows)
    with pytest.raises(ValueError, match=">= 1"):
        ringbuf.Ring(0)
    with pytest.raises(ValueError, match="expected 4 metrics"):
        ringbuf.Ring(2).write((1.0, 2.0))


def test_counter_keyed_draws_are_pinned_and_in_range():
    key = taug.stream_key(0, 0)
    assert key == 2778424467
    epoch, idx = torch.tensor(1), torch.tensor(5)
    offsets, flips = taug.draws(6, key, epoch, idx)
    assert offsets.tolist() == [[3, 6], [8, 4], [8, 7], [7, 4], [7, 7],
                                [3, 8]]
    assert flips.tolist() == [True, True, True, True, False, True]
    # Another rank, batch or epoch draws otherwise; the same key the same.
    again = taug.draws(6, key, torch.tensor(1), torch.tensor(5))
    assert torch.equal(again[0], offsets) and torch.equal(again[1], flips)
    for other in (taug.draws(6, taug.stream_key(0, 1), epoch, idx),
                  taug.draws(6, key, epoch, torch.tensor(6)),
                  taug.draws(6, key, torch.tensor(2), idx)):
        assert not torch.equal(other[0], offsets)
    offsets, flips = taug.draws(4096, key, epoch, idx)
    assert offsets.dtype == torch.int64 and flips.dtype == torch.bool
    assert int(offsets.min()) == 0 and int(offsets.max()) == 8
    assert 0.45 < float(flips.float().mean()) < 0.55


def test_windowed_epoch_fetches_once_per_window():
    win = _narrow_trainer(limit_train_batches=40, limit_eval_batches=1)
    win.run(1)
    windows = 2
    assert win.host_round_trips <= windows + 2
    per = _narrow_trainer(limit_train_batches=40, limit_eval_batches=1,
                          profile_phases=True)
    per.run(1)
    assert per.host_round_trips >= 40


def test_profile_phases_prints_the_forward_and_backward_lines():
    lines = []
    tr = _narrow_trainer(limit_train_batches=40, profile_phases=True,
                         log=lines.append)
    assert tr.metrics_ring == 0
    tr.train_model(0)
    num = r"[-+0-9.e]+"
    expected = [
        r"Size of training set is 80", r"Size of test set is 16",
        rf"Training loss after 20 iterations is {num}",
        rf"Training loss after 40 iterations is {num}",
        rf"Forward Pass time in iter 40 is {num}",
        rf"Backward Pass time in iter 40 is {num}",
        rf"Average Pass time in iter 40 is {num}"]
    assert len(lines) == len(expected), lines
    for line, pattern in zip(lines, expected):
        assert re.fullmatch(pattern, line), (pattern, line)
    assert len(tr.last_epoch_timers.steady_forward_times) == 20


@pytest.mark.parametrize("capacity", [1, 19, -1])
def test_metrics_ring_capacity_is_validated(capacity):
    with pytest.raises(ValueError, match="metrics_ring"):
        _narrow_trainer(metrics_ring=capacity)


def test_metrics_ring_off_fetches_the_window_losses():
    on = _narrow_trainer(limit_train_batches=5)
    off = _narrow_trainer(limit_train_batches=5, metrics_ring=0)
    assert (on.metrics_ring, off.metrics_ring) == (64, 0)
    on.train_model(0)
    off.train_model(0)
    assert off.train_window().ring is None
    assert on.last_epoch_timers.losses == off.last_epoch_timers.losses
    _assert_states_equal(on, off)


def test_measure_phase_split_restores_the_state():
    tr = _narrow_trainer(limit_train_batches=6)
    tr.train_model(0)
    before = [t.clone() for t in tstep.state_tensors(tr.state)]
    writes = tr.train_window().ring.writes
    split = tr.measure_phase_split(window_iters=4, windows=1)
    assert split["window_iters"] == 4
    assert set(split["window_totals_ms"]) == {"fwd_4", "fwd_2", "step_4",
                                              "step_2"}
    for a, b in zip(before, tstep.state_tensors(tr.state)):
        assert torch.equal(a, b)
    assert tr.train_window().ring.writes == writes


def test_steady_state_throughput_runs_back_to_back_windows():
    """The first window is left out, the rest run back to back with one
    fetch after the last; the windows train (the ring moved on)."""
    tr = _narrow_trainer(limit_train_batches=6)
    ips, per_device = tr.steady_state_throughput(max_iters=4, window_iters=2)
    assert ips > 0 and per_device == ips
    assert tr.host_round_trips == 2
    assert tr.train_window().ring.writes == 2 * (1 + 2)
    with pytest.raises(ValueError, match="full global batch"):
        _narrow_trainer(global_batch=512).steady_state_throughput()


def test_window_is_bitwise_the_per_step_path_from_a_later_epoch():
    """A fresh Trainer whose first call is ``train_model(1)`` (a resume):
    the window trains epoch 1's rows, as the per-step path does.  The
    sampler's order is the same every epoch (the reference script never
    calls ``set_epoch``), so it is reshuffled per epoch here
    (``reshuffle_each_epoch``): epoch 1 then stages other rows than epoch
    0 into the same buffers."""
    win = _narrow_trainer(limit_train_batches=5, reshuffle_each_epoch=True)
    per = _narrow_trainer(limit_train_batches=5, profile_phases=True,
                          reshuffle_each_epoch=True)
    win.train_model(1)
    per.train_model(1)
    assert win.last_epoch_timers.losses == per.last_epoch_timers.losses
    _assert_states_equal(win, per)
    # Epoch 1's rows are not epoch 0's.
    first = win._stage_train_epoch(1).labels.clone()
    assert not torch.equal(win._stage_train_epoch(0).labels, first)
