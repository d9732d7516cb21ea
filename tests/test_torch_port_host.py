"""The port's host-augment path (``Trainer(host_augment=True)``,
``--host-augment``) and its supervised staging, on the CPU: a narrow VGG,
global batch 4 (8 at world 2), ``WINDOW`` set to 3, the fixture data.

  (a) The window buffers the port stages, and the ragged tail's f32 batch,
      bitwise the reference package's host stream
      (``native.gather_augment_u8`` over ``_shard_batch_cols`` with the
      reference Trainer's ``_host_aug_params``): at world 1, and per rank
      at world 2 over gloo (each rank its row block of the global draw).
  (b) Augmentation on, against the reference: the host f32 step against
      ``make_train_step(augment="host")`` and the uint8 window against
      ``make_train_window(augment=False)``, 3 steps of full-width VGG-11
      on the same host-augmented batches.
  (c) The host windowed epoch bitwise the host per-step path, and
      ``host_chunks`` 1, 2 and 4 bitwise the same.
  (d) Every staging chaos recovery, and the degraded mode, bitwise the
      healthy run, with the reference's log lines and counters.
  (e) A stall past ``stall_timeout_s`` raises ``StagingStalled``; the
      producer thread has exited; in training it restarts, bitwise.
  (f) ``reshuffle_each_epoch``: another order each epoch, in the config
      and the sidecars, and a resume with the other value refused.
  (g) A mid-epoch resume on the host path, bitwise.
  (h) ``--require-real-data``; the CLI's flags and ``FTConfig``.
  (i) The measurements refuse ``host_augment``.
  (j) The staging sites are accepted with ``host_augment``.
"""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs744_ddp_tpu.data import cifar10 as jcifar
from cs744_ddp_tpu.data import native as jnative
from cs744_ddp_tpu.obs import ringbuf as jringbuf
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh, strategies
from cs744_ddp_tpu.train import loop as jloop
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.data import cifar10 as tcifar
from cs744_ddp_tpu_torch.data import native
from cs744_ddp_tpu_torch.ft import (ChaosPlan, FTConfig, STAGING_SITES,
                                    StagingStalled)
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.obs import ringbuf
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import strategies as tstrategies
from cs744_ddp_tpu_torch.train import checkpoint as ckpt
from cs744_ddp_tpu_torch.train import loop
from cs744_ddp_tpu_torch.train import step as tstep

import torch_dist_worker as worker
from test_torch_port_window import _reference_vgg11

LR = 0.01
LIMIT = 7
# 30 examples at batch 4: 7 full batches and a ragged tail of 2.
EXAMPLES = 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the narrow model's ops are too
    small to share out, and the suite runs its files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_window(monkeypatch):
    monkeypatch.setattr(loop, "WINDOW", 3)


def _trainer(log=None, cut=False, **kw):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    args = dict(global_batch=4, data_dir=worker.ASSETS, device="cpu",
                sgd_cfg=tsgd.SGDConfig(lr=LR), limit_train_batches=LIMIT,
                limit_eval_batches=1, log=log or (lambda s: None),
                host_augment=True)
    args.update(kw)
    tr = loop.Trainer("vggt", "single", **args)
    if cut:
        tr.train_split = tcifar.Split(tr.train_split.images[:EXAMPLES],
                                      tr.train_split.labels[:EXAMPLES])
    return tr


def _assert_states_equal(a, b):
    na, nb = tstep.named_state_tensors(a.state), \
        tstep.named_state_tensors(b.state)
    assert list(na) == list(nb)
    for k in na:
        assert torch.equal(na[k], nb[k]), k


def _record_stream(tr):
    """Wrap the Trainer so it keeps each window buffer after assembly and
    the ragged tail's f32 batch."""
    rows, tails = [], []
    assemble, step_fetch = tr._assemble, tr._step_fetch

    def record_assemble(chunks, start):
        w = assemble(chunks, start)
        rows.append(tr.train_window().images[:w].clone().numpy())
        return w

    def record_step(x, y, epoch, it):
        if x.shape[0] < tr.per_rank_batch:
            tails.append(x.clone().numpy())
        return step_fetch(x, y, epoch, it)

    tr._assemble, tr._step_fetch = record_assemble, record_step
    return rows, tails


def _reference_stream(images, n, world, global_batch, epoch, seed):
    """The reference package's host stream, per global batch: the uint8
    full batches and the f32 ragged tail, device-major rows."""
    ref = SimpleNamespace(seed=seed)
    full, tail = [], None
    for it, cols in enumerate(jloop._shard_batch_cols(
            n, world, global_batch, epoch, shuffle=True, seed=seed)):
        draws = jloop.Trainer._host_aug_params(ref, len(cols), epoch, it)
        if len(cols) == global_batch:
            full.append(jnative.gather_augment_u8(images, cols, *draws))
        else:
            tail = jnative.augment(jnative.gather(images, cols), *draws)
    return np.stack(full), tail


# -- (a) the stream's bytes ---------------------------------------------------

@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (3, 0)])
def test_staged_windows_are_the_reference_host_stream(small_window, seed,
                                                      epoch):
    tr = _trainer(cut=True, limit_train_batches=None, seed=seed,
                  host_chunks=2)
    rows, tails = _record_stream(tr)
    tr.train_model(epoch)
    assert [len(r) for r in rows] == [3, 3, 1]      # WINDOW 3, 7 batches
    want_full, want_tail = _reference_stream(
        jcifar.load(worker.ASSETS)[0].images, EXAMPLES, 1, 4, epoch, seed)
    np.testing.assert_array_equal(np.concatenate(rows), want_full)
    assert len(tails) == 1 and tails[0].tobytes() == want_tail.tobytes()
    # The Trainer's own serial transforms give the same bytes.
    for it, cols in enumerate(tr._rank_cols(epoch)):
        imgs = tr.train_split.images[cols]
        if it < 7:
            np.testing.assert_array_equal(
                tr._host_transform_u8(imgs, epoch, it), want_full[it])
        else:
            assert tr._host_transform(imgs, epoch, it).tobytes() == \
                want_tail.tobytes()


@pytest.fixture(scope="module")
def gloo_host(tmp_path_factory):
    """Two gloo ranks, ``allreduce``, global batch 8, 60 examples (per
    rank 7 full batches and a tail of 2), WINDOW 3: the host windowed and
    per-step epochs."""
    tmp = str(tmp_path_factory.mktemp("port_host"))
    os.makedirs(os.path.join(tmp, "w2"))
    ranks = worker.start({
        "world": 2, "rdzv": f"file://{tmp}/rdzv_w2",
        "out": os.path.join(tmp, "w2"),
        "tasks": [{"kind": "host", "strategy": "allreduce",
                   "global_batch": 8, "lr": LR, "window": 3,
                   "examples": 60}]}, tmp)
    ranks.wait(timeout=300)
    return [np.load(os.path.join(tmp, "w2", f"host_r{r}.npz"))
            for r in range(2)]


def test_each_rank_stages_its_rows_of_the_global_draw_at_world_2(gloo_host):
    """The trap: a rank drawing its own ``per`` rows gets another stream at
    world > 1.  Each rank's window rows and tail are its block of the
    reference's draws over the whole global batch."""
    want_full, want_tail = _reference_stream(
        jcifar.load(worker.ASSETS)[0].images, 60, 2, 8, 0, 0)
    for rank, npz in enumerate(gloo_host):
        rows = npz["window/rows"]
        assert rows.shape == (7, 4, 32, 32, 3)
        np.testing.assert_array_equal(rows, want_full[:, 4 * rank:
                                                      4 * (rank + 1)])
        for path in ("window", "per-step"):
            assert npz[f"{path}/tail"].tobytes() == \
                want_tail[2 * rank:2 * (rank + 1)].tobytes()
    assert not np.array_equal(gloo_host[0]["window/rows"],
                              gloo_host[1]["window/rows"])


def test_host_windowed_is_bitwise_the_per_step_path_at_world_2(gloo_host):
    for npz in gloo_host:
        np.testing.assert_array_equal(npz["window/losses"],
                                      npz["per-step/losses"])
        keys = [k for k in npz.files if k.startswith("window/state/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                npz[k], npz[k.replace("window/", "per-step/")])
    a, b = gloo_host
    for k in (k for k in a.files if k.startswith("window/state/")):
        np.testing.assert_array_equal(a[k], b[k])      # the ranks agree


# -- (b) against the reference, augmentation on -------------------------------

def _host_batches(seed, steps, batch):
    """Host-augmented batches of the synthetic split: (uint8, f32 from the
    library, labels) per step, the crops drawn by the reference's
    stream."""
    split = tcifar._synthetic_split(steps * batch, 3)
    out = []
    for i in range(steps):
        imgs = split.images[i * batch:(i + 1) * batch]
        draws = jloop.Trainer._host_aug_params(
            SimpleNamespace(seed=seed), batch, 0, i)
        out.append((native.augment_u8(imgs, *draws),
                    native.augment(imgs, *draws),
                    split.labels[i * batch:(i + 1) * batch]))
    return out


def _reference_state_of(model, state):
    """The reference's TrainState holding copies of the port's
    parameters, BN statistics and momentum (copies: the reference's CPU
    client may read NumPy memory in place, after the port's next step has
    written it)."""
    names = [n for n, _ in model.named_parameters()]
    params, bn = convert.to_jax(model.state_dict())
    momentum = convert.params_to_jax(
        dict(zip(names, state.opt_state.momentum)))
    return jax.tree.map(np.array, jstep.TrainState(
        params, bn, jsgd.SGDState(momentum=momentum)))


def _assert_close_to_reference(model, jstate):
    pj, sj = convert.to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves((pj, sj)),
                    jax.tree.leaves((jstate.params, jstate.bn_state))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-2, atol=2e-3)


# Why each step starts the reference from the port's state: zero-padded
# crops put near-ties in the pool windows, and a tie that the fused op's
# two roundings of x̂·γ+β route otherwise than XLA's multiply-add (ROADMAP
# queue 3) grows ~10x a step.  Run free on crops of uniform pixels, the
# third step's loss was off by 6e-3-7e-3 on 3 of data seeds 0-7 at lr
# 0.01, while the first step agreed to 1e-6.  From the same state, every
# step agrees at the stated tolerances.

@pytest.mark.parametrize("data_seed", [0, 1])
def test_host_f32_step_matches_reference_host_step(data_seed):
    """Full-width VGG-11, batch 8, lr 0.01, 3 steps on f32 batches the
    library cropped, flipped and normalized: the port's
    ``augment="host"`` step against the reference's, each step from the
    port's state, at test_torch_port_train.py's tolerances (loss rtol
    1e-3; parameters and BN statistics after the step rtol 1e-2 / atol
    2e-3)."""
    batch, steps = 8, 3
    _, apply_fn, model = _reference_vgg11()
    j_train = jstep.make_train_step(apply_fn, strategies.local, make_mesh(1),
                                    jsgd.SGDConfig(lr=LR), augment="host")
    state = tstep.init_train_state(model)
    t_train = tstep.make_train_step(model, tstrategies.local,
                                    tsgd.SGDConfig(lr=LR), augment="host")
    key = jax.random.PRNGKey(0)
    for i, (_, x, y) in enumerate(_host_batches(data_seed, steps, batch)):
        jstate, jl = j_train(_reference_state_of(model, state), key, x, y)
        tl = t_train(state, torch.from_numpy(x.copy()),
                     torch.from_numpy(y.astype(np.int64)), 0, i)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
        _assert_close_to_reference(model, jstate)


@pytest.mark.parametrize("data_seed", [0, 1])
def test_host_window_matches_reference_window(data_seed):
    """The port's window over a host buffer (``buffered``, ``"host_u8"``:
    the library's affine normalize on the device) against the
    reference's ``augment=False`` window with its ring, on the same
    uint8 batches the library cropped and flipped, 3 steps, each a
    one-step window from the port's state with its batch in the buffer's
    row 0 and its absolute index 40 + i: losses rtol 1e-3, squared
    gradient norms rtol 1e-2, parameters rtol 1e-2 / atol 2e-3
    (test_torch_port_window.py's tolerances), the ring's markers the
    absolute indices.  The two normalizes differ by at most an f32 ulp of
    the input."""
    batch, steps = 8, 3
    _, apply_fn, model = _reference_vgg11()
    j_window = jstep.make_train_window(
        apply_fn, strategies.local, make_mesh(1), jsgd.SGDConfig(lr=LR),
        augment=False, metrics_ring=True)
    state = tstep.init_train_state(model)
    body = tstep.make_step_body(model, tstrategies.local,
                                tsgd.SGDConfig(lr=LR), augment="host_u8")
    buf = torch.zeros((5, batch, 32, 32, 3), dtype=torch.uint8)
    lab = torch.zeros((5, batch), dtype=torch.int64)
    window = tstep.TrainWindow(body, state, buf, lab, ring_capacity=16,
                               buffered=True)
    for i, (u8, _, y) in enumerate(_host_batches(data_seed, steps, batch)):
        jstate, jring = j_window(
            _reference_state_of(model, state), jringbuf.make_ring(16),
            jax.random.PRNGKey(0), u8[None], y[None].astype(np.int32),
            jnp.int32(0), jnp.zeros((1,), jnp.int8))
        want = jringbuf.drain_rows(np.asarray(jring[0]), 1, 1)
        buf[0] = torch.from_numpy(u8)
        lab[0] = torch.from_numpy(y.astype(np.int64))
        fetched = window(0, 40 + i, 1).numpy()
        g_loss, g_gsq, g_ok, g_steps = ringbuf.split_columns(
            ringbuf.drain_rows(fetched, window.ring.writes, 1))
        w_loss, w_gsq, w_ok, _ = jringbuf.split_columns(want)
        np.testing.assert_allclose(g_loss, w_loss, rtol=1e-3)
        np.testing.assert_allclose(g_gsq, w_gsq, rtol=1e-2)
        np.testing.assert_array_equal(g_ok, w_ok)
        np.testing.assert_array_equal(g_steps, [40 + i])
        _assert_close_to_reference(model, jstate)


def test_buffered_window_reads_rows_while_idx_stays_absolute():
    """A 3-step window from batch 40 over a buffer: row r is batch 40 + r,
    bitwise the per-step host steps on the same f32 batches."""
    batch, steps = 4, 3
    data = _host_batches(5, steps, batch)
    losses = []
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    for buffered in (True, False):
        model = loop.model_zoo.get_model("vggt", 0).to(
            memory_format=torch.channels_last)
        state = tstep.init_train_state(model)
        if buffered:
            body = tstep.make_step_body(model, augment="host_u8")
            window = tstep.TrainWindow(
                body, state,
                torch.from_numpy(np.stack([u8 for u8, _, _ in data])),
                torch.from_numpy(np.stack([y for _, _, y in data])
                                 .astype(np.int64)),
                ring_capacity=16, buffered=True)
            fetched = window(0, 40, steps).numpy()
            losses.append(window.losses_of(fetched, 40, steps).tolist())
        else:
            step = tstep.make_train_step(model, augment="host")
            losses.append([float(step(state, torch.from_numpy(x.copy()),
                                      torch.from_numpy(y.astype(np.int64)),
                                      0, 40 + i))
                           for i, (_, x, y) in enumerate(data)])
    assert losses[0] == losses[1]


def test_buffered_window_refuses_more_steps_than_rows():
    _, _, model = _reference_vgg11()
    body = tstep.make_step_body(model, augment="host_u8")
    window = tstep.TrainWindow(
        body, tstep.init_train_state(model),
        torch.zeros((2, 2, 32, 32, 3), dtype=torch.uint8),
        torch.zeros((2, 2), dtype=torch.int64), buffered=True)
    with pytest.raises(ValueError, match="does not fit"):
        window(0, 0, 3)
    with pytest.raises(ValueError, match="augment must be"):
        tstep.make_step_body(model, augment="device")


# -- (c) the paths and the chunking, bitwise ---------------------------------

@pytest.fixture(scope="module")
def healthy():
    """The healthy host windowed epoch (WINDOW 3, 7 batches + the tail)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "WINDOW", 3)
    try:
        tr = _trainer(cut=True, limit_train_batches=None)
        tr.train_model(0)
    finally:
        mp.undo()
    return tr


@pytest.mark.parametrize("kw", [{"profile_phases": True},
                                {"host_chunks": 1}, {"host_chunks": 2},
                                {"host_chunks": 4}],
                         ids=["per-step", "chunks1", "chunks2", "chunks4"])
def test_host_paths_and_chunkings_are_bitwise_one_trajectory(
        small_window, healthy, kw):
    tr = _trainer(cut=True, limit_train_batches=None, **kw)
    tr.train_model(0)
    assert len(tr.last_epoch_timers.losses) == 8
    assert tr.last_epoch_timers.losses == healthy.last_epoch_timers.losses
    _assert_states_equal(tr, healthy)
    if not kw.get("profile_phases"):
        # 3 windows (3, 3, 1) and the tail: one fetch each.
        assert tr.host_round_trips == 4
        assert len(tr.last_chunk_waits) == 3
        assert tr._chunk_plan(3) == {1: [3], 2: [2, 1],
                                     4: [1, 1, 1]}[tr.host_chunks]


def test_arena_slots_are_reused_and_the_stream_holds(monkeypatch):
    """WINDOW 2 and 2 chunks a window: 1-batch chunks, 6 slots, 13 batches:
    every slot is lent and given back twice; the epoch is bitwise the
    whole-window staging's."""
    monkeypatch.setattr(loop, "WINDOW", 2)
    a = _trainer(limit_train_batches=13, host_chunks=2)
    a.train_model(0)
    assert a._staging_arena.nslots == 6
    b = _trainer(limit_train_batches=13, host_chunks=1)
    b.train_model(0)
    assert a.last_epoch_timers.losses == b.last_epoch_timers.losses
    _assert_states_equal(a, b)


def test_host_window_replays_one_window_per_trainer(small_window):
    """One window object over one buffer for the whole run: the same
    tensors after two epochs, and the producer joined after each."""
    tr = _trainer()
    tr.train_model(0)
    window, buf = tr.train_window(), tr.train_window().images
    tr.train_model(1)
    assert tr.train_window() is window and window.images is buf
    assert window.buffered and buf.shape == (3, 4, 32, 32, 3)
    assert not tr._producer.is_alive()


def test_a_loader_that_cannot_load_stops_the_trainer(small_window,
                                                     monkeypatch):
    """No NumPy path is reachable from the Trainer."""
    def broken(*a, **k):
        raise native.NativeLoaderError("no library")
    monkeypatch.setattr(native, "load_library", broken)
    for kw in ({}, {"profile_phases": True}):
        tr = _trainer(**kw)
        with pytest.raises(native.NativeLoaderError, match="no library"):
            tr.train_model(0)
        assert not tr._producer.is_alive()


# -- (d) staging chaos, each bitwise the healthy run -------------------------

CHAOS = {
    "put_fail": (["put_fail:2"], {"backoff_base_s": 0.001}, 0, False,
                 ["chaos: injected put_fail at step 2",
                  "ft: chunk device_put attempt 1 failed (ChaosError("
                  "'injected transient chunk device_put failure (batches "
                  "[2, 3))')); retrying with backoff"]),
    "put_delay": (["put_delay:2"], {"put_timeout_s": 0.05}, 0, False,
                  ["chaos: injected put_delay at step 2"]),
    "producer_crash": (["producer_crash:4"], {}, 1, False,
                       ["chaos: injected producer_crash at step 4",
                        "ft: staging failed at step 3 (ChaosError: "
                        "injected staging producer crash at batch 4); "
                        "restarting the producer from step 3"]),
    "producer_crash_twice": (
        ["producer_crash:2", "producer_crash:2"], {}, 2, True,
        ["chaos: injected producer_crash at step 2",
         "ft: staging failed at step 0 (ChaosError: injected staging "
         "producer crash at batch 2); restarting the producer from step 0",
         "chaos: injected producer_crash at step 2",
         "ft: staging failed again at step 0 (ChaosError: injected staging "
         "producer crash at batch 2); restart budget exhausted — degrading "
         "to synchronous per-batch staging (stream unchanged, overlap "
         "lost)"]),
    "corrupt_slot": (["corrupt_slot:3"], {"verify_chunks": True}, 0, False,
                     ["chaos: injected corrupt_slot at step 3",
                      "ft: staged batch 3 failed its checksum; re-staging "
                      "from the resident dataset"]),
    "degrade_staging": ([], {"degrade_staging": True}, 0, True, []),
}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_staging_chaos_recovers_bitwise(small_window, healthy, case):
    specs, kw, failures, degraded, want_lines = CHAOS[case]
    plan = ChaosPlan.parse(specs)
    lines = []
    tr = _trainer(lines.append, cut=True, limit_train_batches=None,
                  ft=FTConfig(chaos=plan, **kw))
    assert tr._supervise
    tr.train_model(0)
    assert tr.producer_failures == failures
    assert tr.staging_degraded is degraded
    if specs:
        assert sorted(plan.fired) == sorted((s.split(":")[0],
                                             int(s.split(":")[1]))
                                            for s in specs)
    for line in want_lines:
        assert line in lines, (line, lines)
    if case == "put_delay":
        assert any("watchdog deadline" in ln for ln in lines)
    assert tr.last_epoch_timers.losses == healthy.last_epoch_timers.losses
    _assert_states_equal(tr, healthy)


def test_corrupt_slot_turns_verification_on_and_without_it_corrupts(
        small_window, healthy):
    """The site turns ``verify_chunks`` on by itself, as the reference's
    does; the repair is what keeps the run bitwise."""
    tr = _trainer(cut=True, limit_train_batches=None, ft=FTConfig(
        chaos=ChaosPlan.parse(["corrupt_slot:3"])))
    assert tr._verify_chunks
    plain = _trainer(cut=True, limit_train_batches=None, ft=FTConfig(
        chaos=ChaosPlan.parse(["corrupt_slot:3"])))
    plain._verify_chunks = False
    plain.train_model(0)
    assert plain.last_epoch_timers.losses[:3] == \
        healthy.last_epoch_timers.losses[:3]
    assert plain.last_epoch_timers.losses[3] != \
        healthy.last_epoch_timers.losses[3]
    assert not _trainer(ft=FTConfig())._verify_chunks


# -- (e) the stall deadline ---------------------------------------------------

def test_a_stall_raises_staging_stalled_and_the_thread_exits():
    tr = _trainer(ft=FTConfig())

    def wedged_fill(emit):
        emit("first")
        time.sleep(1.0)                  # alive but stuck

    it = tr._prefetch_iter(wedged_fill, stall_timeout_s=0.1)
    assert next(it) == "first"
    with pytest.raises(StagingStalled, match="deadline"):
        next(it)
    it.close()
    tr._producer.join(timeout=5)
    assert not tr._producer.is_alive()


def test_a_stalled_producer_is_restarted_bitwise(small_window, healthy,
                                                 monkeypatch):
    lines = []
    tr = _trainer(lines.append, cut=True, limit_train_batches=None,
                  ft=FTConfig(stall_timeout_s=0.3))
    fill_row, fetch = tr._fill_row, tr._fetch
    stalled, trained = [], threading.Event()

    def fetch_then_tell(t):
        out = fetch(t)
        trained.set()            # the consumer now waits for batch 4
        return out

    def slow_fill(out, cols, epoch, it):
        if it == 4 and not stalled:
            # Stuck past the deadline while the consumer waits.
            stalled.append(it)
            trained.wait(timeout=60)
            time.sleep(1.0)
        fill_row(out, cols, epoch, it)

    tr._fill_row, tr._fetch = slow_fill, fetch_then_tell
    tr.train_model(0)
    assert stalled == [4] and tr.producer_failures == 1
    assert not tr.staging_degraded
    assert any("StagingStalled" in ln and "restarting the producer from "
               "step 3" in ln for ln in lines), lines
    assert tr.last_epoch_timers.losses == healthy.last_epoch_timers.losses
    _assert_states_equal(tr, healthy)


def test_an_unsupervised_staging_failure_propagates(small_window):
    tr = _trainer()

    def crash(out, cols, epoch, it):
        raise OSError("disk gone")

    tr._fill_row = crash
    with pytest.raises(OSError, match="disk gone"):
        tr.train_model(0)
    assert tr.producer_failures == 0 and not tr._producer.is_alive()


# -- (f) reshuffle_each_epoch -------------------------------------------------

def test_reshuffle_each_epoch_orders_each_epoch_anew(tmp_path, small_window):
    fixed, shuffled = _trainer(), _trainer(reshuffle_each_epoch=True)
    assert [c.tolist() for c in fixed._rank_cols(0)] == \
        [c.tolist() for c in fixed._rank_cols(1)]
    assert [c.tolist() for c in shuffled._rank_cols(0)] == \
        [c.tolist() for c in fixed._rank_cols(0)]
    assert [c.tolist() for c in shuffled._rank_cols(0)] != \
        [c.tolist() for c in shuffled._rank_cols(1)]
    # The device path stages each epoch's order too.
    dev = _trainer(host_augment=False, reshuffle_each_epoch=True)
    first = dev._stage_train_epoch(0).labels.clone()
    assert not torch.equal(dev._stage_train_epoch(1).labels, first)

    d = str(tmp_path / "ck")
    shuffled.run(1, checkpoint_dir=d)
    assert shuffled.checkpoint_config()["reshuffle_each_epoch"] is True
    mngr = ckpt.CheckpointManager(d)
    meta = mngr.epoch_meta()
    assert meta["reshuffle_each_epoch"] is True
    n = len(shuffled.train_split.labels)
    assert meta["rank_keys"] == list(tsharding_keys(n, 0, True))
    assert list(tsharding_keys(n, 0, True)) != list(tsharding_keys(n, 1,
                                                                   True))
    assert shuffled._data_order_meta(0, 3)["reshuffle_each_epoch"] is True
    with pytest.raises(ValueError, match="different training config"):
        _trainer().run(2, checkpoint_dir=d)
    lines = []
    _trainer(lines.append, reshuffle_each_epoch=True).run(
        2, checkpoint_dir=d)
    assert "Resumed from checkpoint: epoch 1" in lines


def tsharding_keys(n, epoch, reshuffle):
    from cs744_ddp_tpu_torch.data import sharding
    return sharding.rank_data_keys(n, 1, epoch=epoch,
                                   reshuffle_each_epoch=reshuffle)


# -- (g) mid-epoch resume ----------------------------------------------------

@pytest.mark.parametrize("per_step", [False, True],
                         ids=["windowed", "per-step"])
def test_mid_epoch_resume_on_the_host_path_is_bitwise(tmp_path, small_window,
                                                      per_step):
    lines = []
    cut = _trainer(lines.append, profile_phases=per_step,
                   ft=FTConfig(chaos=ChaosPlan.parse(["preempt:5"])))
    cut.run(1, checkpoint_dir=str(tmp_path))
    at = 5 if per_step else 6
    assert cut.preempted and not cut._producer.is_alive()
    assert f"Preempted at epoch 0 step {at}; emergency checkpoint saved" \
        in lines
    resumed = _trainer(lines.append, profile_phases=per_step)
    resumed.run(1, checkpoint_dir=str(tmp_path))
    assert f"Resumed from mid-epoch checkpoint: epoch 0, step {at}" in lines
    base = _trainer(profile_phases=per_step)
    base.run(1)
    _assert_states_equal(resumed, base)
    assert resumed.last_epoch_timers.losses == \
        base.last_epoch_timers.losses[at:]


# -- (h) the CLI -------------------------------------------------------------

def test_require_real_data_refuses_a_directory_without_batches(tmp_path,
                                                               capsys):
    with pytest.raises(SystemExit, match="--require-real-data: no CIFAR-10"):
        cli.main(["--require-real-data", "--data-dir", str(tmp_path),
                  "--device", "cpu"])
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    cli.main(["--require-real-data", "--data-dir", worker.ASSETS,
              "--device", "cpu", "--model", "vggt", "--strategy", "single",
              "--batch-size", "4", "--limit-train-batches", "3",
              "--limit-eval-batches", "1", "--host-augment",
              "--ft-verify-chunks"])
    out = capsys.readouterr().out
    assert "Size of training set is 80" in out and "Test set:" in out


def test_cli_flags_match_the_reference_and_reach_ftconfig():
    from cs744_ddp_tpu import cli as jcli
    ref = {a.dest: a for a in jcli.build_parser()._actions}
    args = cli.parse_args([])
    for dest in ("host_augment", "require_real_data", "ft_put_timeout",
                 "ft_put_retries", "ft_stall_timeout", "ft_verify_chunks"):
        assert getattr(args, dest) == ref[dest].default, dest
        flag = ref[dest].option_strings[0]
        value = [] if ref[dest].nargs == 0 else ["2"]
        assert getattr(cli.parse_args([flag] + value), dest) != \
            ref[dest].default, flag       # the reference's flag name
    assert cli.ft_config_from_args(args) is None
    got = cli.ft_config_from_args(cli.parse_args(
        ["--ft-put-timeout", "1.5", "--ft-put-retries", "5",
         "--ft-stall-timeout", "7", "--ft-verify-chunks"]))
    assert got == FTConfig(put_timeout_s=1.5, put_retries=5,
                           stall_timeout_s=7.0, verify_chunks=True)


# -- (i) the measurements -----------------------------------------------------

@pytest.mark.parametrize("what", ["measure_phase_split",
                                  "steady_state_throughput"])
def test_measurements_refuse_host_augment(what):
    with pytest.raises(ValueError, match="host_augment"):
        getattr(_trainer(), what)()


# -- (j) the staging sites ----------------------------------------------------

@pytest.mark.parametrize("site", STAGING_SITES)
def test_staging_sites_are_accepted_with_host_augment(site):
    plan = ChaosPlan.parse([f"{site}:3"])
    tr = _trainer(ft=FTConfig(chaos=plan))
    assert tr.chaos is plan and tr.host_augment
    got = cli.ft_config_from_args(cli.parse_args(
        ["--host-augment", "--chaos", f"{site}:3"]))
    assert got.chaos.spec() == plan.spec()
    with pytest.raises(ValueError, match="host_augment"):
        _trainer(ft=FTConfig(chaos=plan), host_augment=False)
    with pytest.raises(ValueError, match="host_chunks"):
        _trainer(host_chunks=0)
