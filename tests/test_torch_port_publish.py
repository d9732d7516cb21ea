"""The port's train-to-serve weight publishing (cs744_ddp_tpu_torch/publish/,
``models/convert.py``'s serving tree, ``Trainer.run(publish_dir=)``, the
scheduler's install queue and the replica's swap probe), on the CPU,
against the reference package's ``publish/``.

  * (a) The CCWB1 bundle: byte-identical to the reference's for the same
    leaves, every corruption class rejected (tests/test_publish.py:77,
    :92); the treedef string equal to JAX's ``str(treedef)`` for every
    model of both zoos, and the serving leaves' round trip.
  * (b) The publisher: monotonic versions, ``LATEST`` last (:142); the
    Trainer's ``publish_every`` and fingerprint (:222).
  * (c) Interop: a port bundle installed by the reference's
    ``WeightWatcher`` into a JAX ``EngineReplica``, a reference bundle by
    the port's into a port replica; logits within 1e-4 (f32).
  * (d) The bitwise A/B pin through the router (:250), f32 and bf16, with
    nothing recaptured; the pipelined drain pin (:410); the install
    queue's inline, ``stop`` and death paths, and under more concurrent
    callers than cores; ``poll_once(wait=False)`` "busy".
  * (e) Chaos (tests/test_ft.py:792-900): ``publish_torn`` (offsets, and
    so the torn file, equal to the reference's), ``publish_stale``,
    ``swap_mid_batch``.
  * (f) The CLI's four flags and their refusals, a publishing training run
    and a ``--serve-publish-dir`` tier, rendered by
    ``tools/telemetry_report.py`` under ``== publish ==`` (the port's
    ``obs.report`` the same).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.ft import ChaosPlan as JChaosPlan
from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.publish import WeightPublisher as JPublisher
from cs744_ddp_tpu.publish import WeightWatcher as JWatcher
from cs744_ddp_tpu.publish import write_bundle as jwrite_bundle
from cs744_ddp_tpu.serve import EngineReplica as JReplica
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import cli, ft
from cs744_ddp_tpu_torch.data import cifar10
from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
from cs744_ddp_tpu_torch.models import convert, get_model, vgg as tvgg
from cs744_ddp_tpu_torch.obs import Telemetry, read_run
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.publish import (BundleError, WeightPublisher,
                                         WeightWatcher, bundle_nbytes,
                                         leaf_signature, read_bundle,
                                         read_latest, read_manifest,
                                         write_bundle)
from cs744_ddp_tpu_torch.serve import (EngineReplica, InferenceEngine,
                                       ReplicaRouter)
from cs744_ddp_tpu_torch.train import loop

import torch_dist_worker as worker
from test_torch_port_report import assert_renders_as_the_tool

jvgg.CFG["VGGT"] = worker.NARROW_VGG
tvgg.CFG["VGGT"] = worker.NARROW_VGG
jmodels.register_model("vggt", lambda: jvgg.make("VGGT"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ("vgg11", "vgg13", "vgg16", "vgg19", "resnet18", "resnet34", "vggt")
# tests/test_torch_port_serve.py's bounds for the engine against the
# reference's.
RTOL = {"f32": 1e-4, "bf16": 1e-2}
WAIT = 60.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the narrow model's ops are too
    small to share out, and the suite runs its files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    return cifar10._synthetic_split(64, seed=5)


def _jstate(seed):
    init_fn, _ = jmodels.get_model("vggt")
    return jstep.init_train_state(init_fn, jax.random.PRNGKey(seed))


def _jleaves(jstate):
    leaves, treedef = jax.tree_util.tree_flatten(
        (jstate.params, jstate.bn_state))
    return [np.asarray(l) for l in leaves], str(treedef)


def _sd(seed):
    return get_model("vggt", seed).state_dict()


def _replica(index=0, **kw):
    kw.setdefault("buckets", (2, 4))
    rep = EngineReplica(index, "vggt", seed=0, device="cpu", **kw)
    rep.startup()
    return rep


def _engine(state=None, precision="f32"):
    eng = InferenceEngine("vggt", buckets=(2, 4), precisions=(precision,),
                          state=state, device="cpu")
    eng.startup()
    return eng


def _install(engine, pub_dir, version):
    """Bundle ``version`` into a port engine through the entry point a
    live swap uses."""
    _, leaves = read_bundle(os.path.join(pub_dir, f"v{version:06d}.ccwb"))
    engine.install_weights(
        convert.state_dict_from_leaves(leaves, engine._weights), version)


def _ladder(engine):
    """What a recapture would change: each rung's run and each captured
    weight's address."""
    return ({k: id(v) for k, v in engine._rungs.items()},
            {k: v.data_ptr() for k, v in engine._weights.items()})


def _narrow(log=None, **kw):
    args = dict(global_batch=4, data_dir=worker.ASSETS, device="cpu",
                sgd_cfg=tsgd.SGDConfig(lr=0.01), limit_train_batches=6,
                limit_eval_batches=1, log=log or (lambda s: None))
    args.update(kw)
    return loop.Trainer("vggt", "single", **args)


# -- (a) the bundle and the serving tree --------------------------------------


def _leaves():
    return [np.arange(12, dtype=np.float32).reshape(3, 4),
            np.array([1, -2], dtype=np.int32)]


def test_bundle_byte_identical_to_the_reference(tmp_path):
    leaves, treedef = _jleaves(_jstate(3))
    fp = {"model": "vggt", "seed": 3}
    for name, write in (("port", write_bundle), ("ref", jwrite_bundle)):
        write(str(tmp_path / name), leaves, version=7, treedef=treedef,
              fingerprint=fp)
    port = (tmp_path / "port").read_bytes()
    assert port == (tmp_path / "ref").read_bytes()
    assert port.startswith(b"CCWB1\n")
    man, out = read_bundle(str(tmp_path / "port"))
    assert man["version"] == 7 and man["treedef"] == treedef
    assert bundle_nbytes(man) == sum(l.nbytes for l in leaves)
    assert leaf_signature(out) == leaf_signature(leaves)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, out))


def test_bundle_rejects_every_corruption_class(tmp_path):
    path = str(tmp_path / "b.ccwb")

    def fresh():
        write_bundle(path, _leaves(), version=1, treedef="TD")
        return os.path.getsize(path)

    size = fresh()
    with open(path, "r+b") as f:
        f.seek(size - 1)
        b = f.read(1)
        f.seek(size - 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(BundleError, match="leaf 1 crc32 mismatch"):
        read_bundle(path)
    assert read_manifest(path)["version"] == 1
    size = fresh()
    with open(path, "r+b") as f:
        f.truncate(size - 4)
    with pytest.raises(BundleError, match="leaf 1 truncated"):
        read_bundle(path)
    fresh()
    with open(path, "ab") as f:
        f.write(b"x")
    with pytest.raises(BundleError, match="trailing bytes"):
        read_bundle(path)
    fresh()
    with open(path, "r+b") as f:
        f.write(b"Z")
    with pytest.raises(BundleError, match="bad magic"):
        read_bundle(path)
    (tmp_path / "LATEST").write_text("{not json")
    with pytest.raises(BundleError, match="malformed LATEST"):
        read_latest(str(tmp_path))
    (tmp_path / "LATEST").write_text('{"version": 1}')
    with pytest.raises(BundleError, match="missing version/file"):
        read_latest(str(tmp_path))


@pytest.mark.parametrize("model", ZOO)
def test_serving_signature_is_the_reference_treedef(model):
    """The port renders JAX's ``str(treedef)`` and the leaves' (shape,
    dtype) of ``tree_flatten((params, bn_state))`` from its own names."""
    init_fn, _ = jmodels.get_model(model)
    abstract = jax.eval_shape(
        lambda k: jstep.init_train_state(init_fn, k), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(
        (abstract.params, abstract.bn_state))
    sd = get_model(model).state_dict()
    assert convert.serving_signature(sd) == (
        str(treedef), tuple((tuple(l.shape), str(l.dtype)) for l in leaves))
    if model == "vggt":
        got, td = convert.serving_leaves(sd)
        assert td == str(treedef) and leaf_signature(got) == tuple(
            (tuple(l.shape), str(l.dtype)) for l in leaves)


def test_serving_leaves_round_trip_bitwise():
    """The reference's leaves -> the port's state_dict -> the same leaves,
    bitwise; ``num_batches_tracked`` comes from the template."""
    leaves, treedef = _jleaves(_jstate(4))
    template = _sd(0)
    template["blocks.0.bn.num_batches_tracked"].fill_(5)
    sd = convert.state_dict_from_leaves(leaves, template)
    assert set(sd) == set(template)
    assert sd["blocks.0.bn.num_batches_tracked"] is \
        template["blocks.0.bn.num_batches_tracked"]
    back, td = convert.serving_leaves(sd)
    assert td == treedef
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(leaves, back))
    with pytest.raises(ValueError, match="leaves for a tree"):
        convert.state_dict_from_leaves(leaves[:-1], template)


# -- (b) the publisher and the Trainer ------------------------------------------


def test_publisher_monotonic_versions_latest_last(tmp_path):
    d = str(tmp_path / "pub")
    pub = WeightPublisher(d, fingerprint={"model": "vggt"})
    assert pub.latest_version() == 0
    r1, r2 = pub.publish(_sd(1)), pub.publish(get_model("vggt", 2))
    assert (r1["version"], r2["version"]) == (1, 2)
    assert read_latest(d) == {"version": 2, "file": "v000002.ccwb"}
    assert WeightPublisher(d).publish(_sd(3))["version"] == 3
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    man = read_manifest(os.path.join(d, "v000001.ccwb"))
    assert man["version"] == 1 and man["fingerprint"]["model"] == "vggt"
    _, leaves = read_bundle(os.path.join(d, "v000002.ccwb"))
    want, _ = convert.serving_leaves(_sd(2))
    assert all(np.array_equal(a, b) for a, b in zip(leaves, want))


def test_trainer_publishes_every_k_epochs(tmp_path):
    pub_dir = str(tmp_path / "pub")
    lines = []
    tr = _narrow(log=lines.append, seed=3)
    tr.run(2, publish_dir=pub_dir, publish_every=2)
    latest = read_latest(pub_dir)
    assert latest["version"] == 1          # one publish, after epoch 2
    man, leaves = read_bundle(os.path.join(pub_dir, latest["file"]))
    fp = man["fingerprint"]
    assert fp["model"] == "vggt" and fp["global_batch"] == 4
    assert fp["seed"] == 3 and fp["strategy"] == "single"
    assert "state_digest" in fp and "state_format_version" in fp
    want, _ = convert.serving_leaves(tr.state.model.state_dict())
    assert all(np.array_equal(a, b) for a, b in zip(leaves, want))
    assert [ln for ln in lines if ln.startswith("Published")] == [
        f"Published weights v1 ({bundle_nbytes(man)} B, {len(leaves)} "
        f"leaves) to {pub_dir}"]
    with pytest.raises(ValueError, match="publish_every"):
        tr.run(1, publish_dir=pub_dir, publish_every=0)


# -- (c) interop with the reference ---------------------------------------------


def test_reference_watcher_installs_a_port_bundle(tmp_path, pool):
    d = str(tmp_path / "pub")
    sd = _sd(7)
    WeightPublisher(d, fingerprint={"model": "vggt"}).publish(sd)
    jrep = JReplica(0, model="vggt", buckets=(2, 4), seed=0)
    jrep.startup()
    watcher = JWatcher(d, [jrep])
    assert watcher.poll_once() == "installed"
    assert jrep.engine.weights_version == 1
    imgs = pool.images[:4]
    want, _, _ = _engine(sd).infer_counts(imgs)
    got, _, _ = jrep.engine.infer_counts(imgs)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL["f32"],
                               atol=RTOL["f32"])


def test_port_watcher_installs_a_reference_bundle(tmp_path, pool):
    d = str(tmp_path / "pub")
    jstate = _jstate(8)
    JPublisher(d, fingerprint={"model": "vggt"}).publish(jstate)
    rep = _replica()
    before = _ladder(rep.engine)
    watcher = WeightWatcher(d, [rep])
    assert watcher.poll_once() == "installed"
    assert rep.engine.weights_version == 1 and _ladder(rep.engine) == before
    leaves, _ = _jleaves(jstate)
    back, _ = convert.serving_leaves(rep.engine._weights)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, back))
    jrep = JReplica(0, model="vggt", buckets=(2, 4), seed=0, state=jstate)
    jrep.startup()
    imgs = pool.images[:4]
    got, _, _ = rep.engine.infer_counts(imgs)
    want, _, _ = jrep.engine.infer_counts(imgs)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL["f32"],
                               atol=RTOL["f32"])


def test_watcher_rejects_a_mismatched_bundle(tmp_path):
    rep = _replica(buckets=(2,))
    d = str(tmp_path / "pub")
    WeightPublisher(d).publish(get_model("vgg11").state_dict())
    watcher = WeightWatcher(d, [rep])
    assert watcher.poll_once() == "rejected"
    assert watcher.report()["rejected"] == 1
    assert rep.engine.weights_version == 0
    d2 = str(tmp_path / "pub2")
    WeightPublisher(d2, fingerprint={"model": "vgg11"}).publish(_sd(1))
    assert WeightWatcher(d2, [rep]).poll_once() == "rejected"
    assert rep.engine.weights_version == 0


# -- (d) the A/B pin and the install queue ------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_hot_swap_ab_pin_end_to_end(tmp_path, pool, precision):
    pub_dir = str(tmp_path / "pub")
    tr = _narrow()
    tr.run(1, publish_dir=pub_dir)                    # trains + publishes v1
    replicas = [_replica(i, precision=precision) for i in range(2)]
    watcher = WeightWatcher(pub_dir, replicas)
    assert watcher.poll_once() == "installed"
    ladders = [_ladder(r.engine) for r in replicas]
    router = ReplicaRouter(replicas)
    with router:
        pre = [(pool.images[2 * i:2 * i + 2],
                router.submit(pool.images[2 * i:2 * i + 2], slo_ms=None))
               for i in range(6)]
        pre = [(imgs, f.result(WAIT)) for imgs, f in pre]
        tr.run(1, publish_dir=pub_dir)                # publishes v2
        assert watcher.poll_once() == "installed"
        post = [(pool.images[2 * i:2 * i + 2],
                 router.submit(pool.images[2 * i:2 * i + 2], slo_ms=None))
                for i in range(6, 12)]
        post = [(imgs, f.result(WAIT)) for imgs, f in post]
    replies = pre + post
    assert [r.status for _, r in replies] == ["ok"] * 12
    assert len({r.trace for _, r in replies}) == 12
    assert [r.model_version for _, r in pre] == [1] * 6
    assert [r.model_version for _, r in post] == [2] * 6
    assert [_ladder(r.engine) for r in replicas] == ladders
    assert watcher.report()["installed_version"] == 2
    ref = _engine(precision=precision)
    probe = {}
    for v in (1, 2):
        _install(ref, pub_dir, v)
        probe[v] = ref.infer_counts(pool.images[:2],
                                    precision=precision)[0]
        for imgs, r in replies:
            if r.model_version == v:
                want = ref.infer_counts(imgs, precision=precision)[0]
                np.testing.assert_array_equal(r.logits, want)
    assert not np.array_equal(probe[1], probe[2])


def test_hot_swap_lands_at_pipeline_drain_between_pairs(tmp_path, pool):
    """A flip queued while two dispatches are in flight lands only at the
    drain between in-flight pairs: both answer on the old weights, the
    next on the new, from the same rungs."""
    pub_dir = str(tmp_path / "pub")
    pub = WeightPublisher(pub_dir, fingerprint={"model": "vggt"})
    pub.publish(_sd(1))
    plan = ChaosPlan.parse(["slow_replica:1:0"])
    rep = _replica(chaos=plan, slow_stall_s=1.0, pipeline=True)
    watcher = WeightWatcher(pub_dir, [rep])
    assert watcher.poll_once() == "installed"
    ladder = _ladder(rep.engine)
    futs = [rep.scheduler.submit(pool.images[4 * i:4 * i + 4], slo_ms=None)
            for i in range(3)]
    pub.publish(_sd(2))
    rep.start()
    try:
        deadline = time.time() + 10.0
        while ("slow_replica", 1) not in plan.fired:
            assert time.time() < deadline, "chaos stall never fired"
            time.sleep(0.01)
        assert watcher.poll_once(wait=False) == "pending"
        replies = [f.result(WAIT) for f in futs]
    finally:
        rep.stop()
    assert [r.status for r in replies] == ["ok"] * 3
    assert [r.model_version for r in replies] == [1, 1, 2]
    assert rep.engine.weights_version == 2 and _ladder(rep.engine) == ladder
    ref = _engine()
    for i, (v, r) in enumerate(zip((1, 1, 2), replies)):
        _install(ref, pub_dir, v)
        want = ref.infer_counts(pool.images[4 * i:4 * i + 4])[0]
        np.testing.assert_array_equal(r.logits, want)


def test_install_queue_inline_stop_and_death(pool):
    rep = _replica()
    sched = rep.scheduler
    ran = []
    # No worker: inline, on this thread.
    assert sched.request_install(lambda: ran.append("a") or 1).result(1) == 1
    # Queued while the worker waits, run at its next boundary.
    with rep:
        assert sched.request_install(lambda: ran.append("b")).result(WAIT) \
            is None
        boom = sched.request_install(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            boom.result(WAIT)
        assert sched.submit(pool.images[:2]).result(WAIT).status == "ok"
    assert ran == ["a", "b"]
    # A dying worker runs none of the installs queued behind it.
    plan = ChaosPlan.parse(["replica_death:0:0"])
    dead = _replica(chaos=plan, pipeline=False)
    entered, gate = threading.Event(), threading.Event()
    orig = dead._chaos_hook

    def hook(dno, bucket):
        entered.set()
        gate.wait(WAIT)
        orig(dno, bucket)
    dead.scheduler.dispatch_hook = hook
    with dead:
        reply = dead.scheduler.submit(pool.images[:2])
        assert entered.wait(WAIT)
        fut = dead.scheduler.request_install(lambda: ran.append("c"))
        gate.set()
        assert reply.result(WAIT).status == "error"
        with pytest.raises(RuntimeError, match="died before install"):
            fut.result(WAIT)
    assert ran == ["a", "b"] and not dead.alive


@pytest.mark.parametrize("pipeline", [False, True])
def test_install_queue_under_concurrent_callers(pool, pipeline):
    """More install callers than cores, requests served meanwhile, a short
    switch interval: every install runs exactly once, each with no
    dispatch in flight, and every request gets one ok reply."""
    rep = _replica(buckets=(2,), pipeline=pipeline)
    runs, drained = [], []

    def install(key):
        drained.append(all(s.handle is None for s in rep.engine._slots))
        runs.append(key)

    callers = min(2 * (os.cpu_count() or 1) + 1, 24)
    futures = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with rep:
            replies = [rep.scheduler.submit(pool.images[:2])
                       for _ in range(16)]

            def caller(i):
                for j in range(4):
                    futures.append(rep.scheduler.request_install(
                        lambda k=(i, j): install(k)))
            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(callers)]
            for t in threads:
                t.start()
            replies += [rep.scheduler.submit(pool.images[:2])
                        for _ in range(16)]
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
            for f in futures:
                f.result(WAIT)
            statuses = [f.result(WAIT).status for f in replies]
    finally:
        sys.setswitchinterval(old)
    assert sorted(runs) == [(i, j) for i in range(callers) for j in range(4)]
    assert all(drained) and statuses == ["ok"] * 32


def test_poll_once_without_waiting_reports_busy(tmp_path):
    rep = _replica(buckets=(2,))
    watcher = WeightWatcher(str(tmp_path), [rep])
    with watcher._lock:
        assert watcher.poll_once(wait=False) == "busy"
    assert watcher.poll_once(wait=False) == "none"
    assert rep.swap_probe == watcher._probe
    # The background thread polls and stops.
    WeightPublisher(str(tmp_path)).publish(_sd(1))
    watcher.poll_interval_s = 0.005
    watcher.start()
    deadline = time.time() + WAIT
    while watcher.installed_version != 1:
        assert time.time() < deadline
        time.sleep(0.005)
    watcher.stop()
    assert watcher.report()["installed"] == 1


# -- (e) chaos ------------------------------------------------------------------


def test_publish_torn_same_file_as_the_reference(tmp_path):
    """The same plan tears the same bytes in both packages: their torn
    files are identical, and both watchers reject them."""
    jstate = _jstate(1)
    sd = convert.from_jax(*_np_tree(jstate))
    spec = ["publish_torn:1:7"]
    jpub = JPublisher(str(tmp_path / "ref"), fingerprint={"model": "vggt"},
                      chaos=JChaosPlan.parse(spec))
    pub = WeightPublisher(str(tmp_path / "port"),
                          fingerprint={"model": "vggt"},
                          chaos=ChaosPlan.parse(spec))
    for _ in range(2):
        jrec, rec = jpub.publish(jstate), pub.publish(sd)
    assert (jrec["torn"], rec["torn"]) == (True, True)
    with open(jrec["file"], "rb") as f, open(rec["file"], "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(BundleError, match="crc32 mismatch"):
        read_bundle(rec["file"])


def _np_tree(jstate):
    return jax.tree_util.tree_map(np.asarray,
                                  (jstate.params, jstate.bn_state))


def _publish_stack(tmp_path, chaos):
    pub = WeightPublisher(str(tmp_path / "pub"), chaos=chaos,
                          fingerprint={"model": "vggt"})
    replica = _replica(buckets=(2,), chaos=chaos)
    return pub, replica, WeightWatcher(pub.directory, [replica])


def test_publish_torn_rejected_by_crc_old_version_serves(tmp_path, pool):
    plan = ChaosPlan.parse(["publish_torn:1"])
    pub, replica, watcher = _publish_stack(tmp_path, plan)
    assert pub.publish(_sd(1))["torn"] is False
    assert watcher.poll_once() == "installed"
    imgs = pool.images[:2]
    before, _, _ = replica.engine.infer_counts(imgs)
    rec = pub.publish(_sd(2))
    assert rec["torn"] is True and ("publish_torn", 1) in plan.fired
    assert watcher.poll_once() == "rejected"
    rep = watcher.report()
    assert rep["rejected"] == 1 and rep["installed_version"] == 1
    assert replica.engine.weights_version == 1
    np.testing.assert_array_equal(replica.engine.infer_counts(imgs)[0],
                                  before)


def test_publish_stale_skipped_current_version_keeps_serving(tmp_path):
    plan = ChaosPlan.parse(["publish_stale:1"])
    pub, replica, watcher = _publish_stack(tmp_path, plan)
    assert pub.publish(_sd(1))["version"] == 1
    assert watcher.poll_once() == "installed"
    rec = pub.publish(_sd(2))
    assert rec["stale"] is True and rec["version"] == 1
    assert rec["file"].endswith(".dup.ccwb")
    assert ("publish_stale", 1) in plan.fired
    assert watcher.poll_once() == "stale"
    rep = watcher.report()
    assert rep["stale"] == 1 and rep["installed_version"] == 1
    assert replica.engine.weights_version == 1


@pytest.mark.parametrize("pipeline", [False, True])
def test_swap_mid_batch_probe_never_mixes_weights(tmp_path, pool, pipeline):
    plan = ChaosPlan.parse(["swap_mid_batch:1:0"])
    pub, replica, watcher = _publish_stack(tmp_path, plan)
    replica.scheduler.pipeline = pipeline
    pub.publish(_sd(1))
    assert watcher.poll_once() == "installed"
    imgs = pool.images[:2]
    replica.start()
    try:
        r0 = replica.scheduler.submit(imgs, slo_ms=None).result(WAIT)
        pub.publish(_sd(2))   # v2 on disk; only the probe polls
        r1 = replica.scheduler.submit(imgs, slo_ms=None).result(WAIT)
        r2 = replica.scheduler.submit(imgs, slo_ms=None).result(WAIT)
    finally:
        replica.stop()
    assert ("swap_mid_batch", 1) in plan.fired
    assert (r0.model_version, r1.model_version, r2.model_version) == (1, 1, 2)
    np.testing.assert_array_equal(r1.logits, r0.logits)
    ref = _engine(_sd(2))
    np.testing.assert_array_equal(r2.logits, ref.infer_counts(imgs)[0])


# -- (f) the CLI and the report -------------------------------------------------


def test_cli_flags_defaults_and_refusals(tmp_path):
    args = cli.parse_args([])
    assert (args.publish_dir, args.publish_every, args.serve_publish_dir,
            args.serve_publish_poll_ms) == (None, 1, None, 50.0)
    for site in ft.PUBLISH_SITES:
        with pytest.raises(SystemExit, match="--publish-dir"):
            cli.ft_config_from_args(cli.parse_args(
                ["--chaos", f"{site}:1"]))
        ftc = cli.ft_config_from_args(cli.parse_args(
            ["--chaos", f"{site}:1", "--publish-dir", str(tmp_path)]))
        assert ftc.chaos.spec() == [{"site": site, "step": 1, "seed": 0}]
        with pytest.raises(ValueError, match="publish_dir"):
            _narrow(ft=FTConfig(chaos=ChaosPlan.parse([f"{site}:1"]))).run(1)
    with pytest.raises(SystemExit, match="--serve-publish-dir"):
        cli.ft_config_from_args(cli.parse_args(
            ["--serve-frontend", "--chaos", "swap_mid_batch:1:0"]))
    ftc = cli.ft_config_from_args(cli.parse_args(
        ["--serve-frontend", "--chaos", "swap_mid_batch:1:0",
         "--serve-publish-dir", str(tmp_path)]))
    assert ftc.chaos.steps("swap_mid_batch") == (1,)
    with pytest.raises(SystemExit, match="--publish-every"):
        cli.main(["--device", "cpu", "--model", "vggt", "--publish-dir",
                  str(tmp_path), "--publish-every", "0"])


def test_cli_train_publishes_and_the_tier_installs(tmp_path, capsys,
                                                   monkeypatch):
    """A publishing training run, then a ``--serve-publish-dir`` tier over
    its directory; both run directories render ``== publish ==``."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import telemetry_report

    pub, train_run, serve_run = (str(tmp_path / n)
                                 for n in ("pub", "train", "serve"))
    cli.main(["--device", "cpu", "--model", "vggt", "--strategy", "single",
              "--batch-size", "4", "--limit-train-batches", "4",
              "--limit-eval-batches", "1", "--data-dir", worker.ASSETS,
              "--epochs", "2", "--publish-dir", pub,
              "--chaos", "publish_stale:1", "--telemetry-out", train_run])
    out = capsys.readouterr().out
    assert "Published weights v1 " in out and read_latest(pub) == {
        "version": 1, "file": "v000001.dup.ccwb"}
    text = telemetry_report.render(train_run)
    assert_renders_as_the_tool(train_run, text)
    assert "== publish (weight hot-swap) ==" in text
    assert "publish_count" in text and "publish_chaos_injected" in text
    cli.main(["--serve-frontend", "--device", "cpu", "--model", "vggt",
              "--serve-buckets", "1,8", "--serve-requests", "12",
              "--serve-load", "300", "--serve-publish-dir", pub,
              "--serve-publish-poll-ms", "5", "--telemetry-out", serve_run])
    last = __import__("json").loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert last["publish"]["installed_version"] == 1
    assert last["publish"]["installed"] == 1
    assert last["load"]["300rps"]["replies"] == 12
    manifest, _, _ = read_run(serve_run)
    assert manifest["publish"]["installed_version"] == 1
    text = telemetry_report.render(serve_run)
    assert_renders_as_the_tool(serve_run, text)
    assert "== publish (weight hot-swap) ==" in text
    assert "publish_installed" in text and "swap latency" in text
    assert "installed 1" in text


def test_telemetry_report_publish_section(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import telemetry_report

    run = tmp_path / "pubrun"
    tel = Telemetry(out_dir=str(run))
    pub = WeightPublisher(str(tmp_path / "pub"), telemetry=tel,
                          fingerprint={"model": "vggt"})
    replica = _replica(buckets=(2,), telemetry=tel)
    watcher = WeightWatcher(pub.directory, [replica], telemetry=tel)
    pub.publish(_sd(1))
    assert watcher.poll_once() == "installed"
    tel.finalize()
    text = telemetry_report.render(str(run))
    assert_renders_as_the_tool(run, text)
    assert "== publish (weight hot-swap) ==" in text
    assert "publish_count" in text and "publish_installed" in text
    assert "swap latency" in text and "weights_installed" in text
    assert "published 1" in text and "installed 1" in text
