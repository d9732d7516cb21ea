"""The port's serving tier (cs744_ddp_tpu_torch/serve/: scheduler, replica,
router), on the CPU, against the reference package's ``serve/``.

  * (a) The framework-free policy (``admit``, ``plan_continuous``,
    ``plan_drain``, ``ServiceModel``, ``make_request``,
    ``virtual_requests``) equal to the reference's, exactly, over seeded
    tiered traces, with and without shedding and ``free_at``.
  * (b) The threaded ``SLOScheduler`` over a CPU engine on the reference
    engine's weights (``models.convert.from_jax``), narrow VGG, buckets
    (2, 4, 8): each request's logits within rtol/atol 1e-4 (f32) and 1e-2
    (bf16) of the reference ``SLOScheduler``'s over the reference engine,
    its correct count equal; the pipelined worker bitwise the serial one
    over a seeded trace; never more than ``PIPELINE_SLOTS`` in flight, and
    the engine's third-issue wait never fires; the reference's accounting
    pins (late, shed, ``QueueFull``'s hint, the pipeline's requirements).
  * (c) The router against the reference router on the same stub
    schedulers: least-loaded placement, the index tie-break, fall-through
    on ``QueueFull``, and failover that resolves every request once.
  * (d) Chaos through ``EngineReplica``: ``replica_death`` (also with a
    dispatch in flight, which the dead worker fences after the hand-off),
    ``slow_replica`` (a stall the EWMA learns; tight SLOs shed or late),
    ``dispatch_fault`` (that batch's requests get explicit errors, the
    next batch the serial bits), serial and pipelined.
  * (e) ``EngineReplica()`` is the GPU by default and raises without one;
    ``cost_model_weights`` gives per-bucket flops, and a replica with the
    cost-model prior (``cost_prior=True``) starts and serves.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.serve import InferenceEngine as JEngine
from cs744_ddp_tpu.serve import QueueFull as JQueueFull
from cs744_ddp_tpu.serve import ReplicaRouter as JRouter
from cs744_ddp_tpu.serve import SLOScheduler as JScheduler
from cs744_ddp_tpu.serve import demo as jdemo
from cs744_ddp_tpu.serve import scheduler as jsched
from cs744_ddp_tpu_torch.data import cifar10
from cs744_ddp_tpu_torch.ft import ChaosPlan, ChaosError
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.serve import (PIPELINE_SLOTS, EngineReplica,
                                       InferenceEngine, QueueFull,
                                       ReplicaRouter, ServiceModel,
                                       SLOScheduler, admit,
                                       cost_model_weights, make_request,
                                       plan_continuous, plan_drain,
                                       virtual_requests)
from cs744_ddp_tpu_torch.serve import engine as tengine
from cs744_ddp_tpu_torch.serve import scheduler as tsched

import torch_dist_worker as worker

jvgg.CFG["VGGT"] = worker.NARROW_VGG
tvgg.CFG["VGGT"] = worker.NARROW_VGG
jmodels.register_model("vggt", lambda: jvgg.make("VGGT"))

TEST_BUCKETS = (2, 4, 8)
PRECISIONS = ("f32", "bf16")
# test_torch_port_serve.py's bounds for the engine against the reference.
RTOL = {"f32": 1e-4, "bf16": 1e-2}
LADDER = (1, 8, 32, 128, 256)
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
def jengine():
    return JEngine("vggt", buckets=TEST_BUCKETS, precisions=PRECISIONS,
                   seed=0)


@pytest.fixture(scope="module")
def state(jengine):
    tree = jax.tree_util.tree_map(np.asarray, (jengine.params,
                                               jengine.bn_state))
    return convert.from_jax(*tree)


@pytest.fixture(scope="module")
def pool():
    return cifar10._synthetic_split(64, seed=3)


def _imgs(n):
    return np.zeros((n, 32, 32, 3), np.uint8)


def _sizes(seed, n, max_size=8):
    """Request sizes of a seeded tiered trace, capped at ``max_size``."""
    sizes = tuple(s for s in jdemo.SIZE_CHOICES if s <= max_size)
    return [s for _, s, _, _ in jdemo.synthetic_load_trace(
        n, offered_rps=500.0, seed=seed, size_choices=sizes)]


def _slices(pool, sizes):
    out, off = [], 0
    for n in sizes:
        if off + n > len(pool.images):
            off = 0
        out.append((pool.images[off:off + n], pool.labels[off:off + n]))
        off += n
    return out


# -- (a) the framework-free policy --------------------------------------------

def _adm_key(adm):
    """An admission by request seq: comparable across the two packages."""
    return ([r.seq for r in adm.batch], adm.bucket,
            [(r.seq, why) for r, why in adm.shed], adm.predicted_done,
            [r.seq for r in adm.deferred])


def _predict(seed):
    rng = np.random.default_rng(seed)
    per = np.sort(rng.uniform(5e-4, 0.08, len(LADDER)))
    return dict(zip(LADDER, (float(v) for v in per))).get


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("shed", [True, False])
def test_admit_matches_reference(seed, shed):
    """Every admission over growing queues of a seeded tiered trace, at
    their arrival instants, idle and with a busy slot ahead (``free_at``)."""
    trace = jdemo.synthetic_load_trace(80, offered_rps=1500.0, seed=seed)
    mine, ref = virtual_requests(trace), jsched.virtual_requests(trace)
    predict = _predict(seed)
    rng = np.random.default_rng(seed + 100)
    for k in range(1, len(trace) + 1, 3):
        now = trace[k - 1][0] + float(rng.uniform(0.0, 0.05))
        for free_at in (None, now - 0.01, now + float(rng.uniform(0, 0.1))):
            got = admit(mine[:k], now, buckets=LADDER, predict_s=predict,
                        shed=shed, free_at=free_at)
            want = jsched.admit(ref[:k], now, buckets=LADDER,
                                predict_s=predict, shed=shed,
                                free_at=free_at)
            assert _adm_key(got) == _adm_key(want)


@pytest.mark.parametrize("seed", [1, 5])
@pytest.mark.parametrize("rps", [300.0, 3000.0])
def test_planners_match_reference(seed, rps):
    trace = jdemo.synthetic_load_trace(150, offered_rps=rps, seed=seed)
    predict = _predict(seed)
    for shed in (True, False):
        got = plan_continuous(virtual_requests(trace), buckets=LADDER,
                              predict_s=predict, shed=shed)
        want = jsched.plan_continuous(jsched.virtual_requests(trace),
                                      buckets=LADDER, predict_s=predict,
                                      shed=shed)
        assert got == want
    for wait in (0.0, 0.005, 0.02):
        got = plan_drain(virtual_requests(trace), buckets=LADDER,
                         predict_s=predict, max_wait_s=wait)
        want = jsched.plan_drain(jsched.virtual_requests(trace),
                                 buckets=LADDER, predict_s=predict,
                                 max_wait_s=wait)
        assert got == want


@pytest.mark.parametrize("seed", [0, 2])
def test_service_model_matches_reference(seed):
    rng = np.random.default_rng(seed)
    weights = {b: float(w) for b, w in
               zip(LADDER, np.sort(rng.uniform(1.0, 300.0, len(LADDER))))}
    for kw in ({}, {"weights": weights, "anchor_s": 1e-3, "alpha": 0.5}):
        got, want = ServiceModel(LADDER, **kw), jsched.ServiceModel(
            LADDER, **kw)
        assert got.snapshot() == want.snapshot()
        for _ in range(40):
            b = int(rng.choice(LADDER))
            s = float(rng.uniform(1e-4, 0.1))
            got.observe(b, s)
            want.observe(b, s)
            assert got.snapshot() == want.snapshot()
    with pytest.raises(ValueError, match="weights missing"):
        ServiceModel(LADDER, weights={1: 1.0})


def test_requests_match_reference(pool):
    trace = jdemo.synthetic_load_trace(40, offered_rps=800.0, seed=4)
    fields = ("n", "tier", "deadline", "t_arrival", "seq", "trace")
    for a, b in zip(virtual_requests(trace),
                    jsched.virtual_requests(trace)):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
    for slo in (None, 75.0):
        got = make_request(pool.images[:3], pool.labels[:3], tier=2,
                           slo_ms=slo, now=10.0, seq=5, trace=9)
        want = jsched.make_request(pool.images[:3], pool.labels[:3],
                                   tier=2, slo_ms=slo, now=10.0, seq=5,
                                   trace=9)
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields]
        assert np.array_equal(got.images, want.images)
        assert np.array_equal(got.labels, want.labels)
        assert isinstance(got.future, Future) and got.ctx is None
    with pytest.raises(ValueError, match="empty"):
        make_request(_imgs(0))
    with pytest.raises(ValueError, match="exceeds the largest"):
        make_request(_imgs(9), max_batch=8)
    with pytest.raises(ValueError, match="labels shape"):
        make_request(_imgs(2), labels=np.zeros(3, np.int32))
    assert tsched.PIPELINE_SLOTS is tengine.PIPELINE_SLOTS \
        == jsched.PIPELINE_SLOTS


# -- (b) the threaded scheduler -------------------------------------------------

def _serve(sched, requests, **kw):
    """Submit every request before the worker starts, then serve them."""
    futs = [sched.submit(x, y, **kw) for x, y in requests]
    with sched:
        return [f.result(WAIT) for f in futs]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_scheduler_matches_reference(jengine, state, pool, precision,
                                     pipeline):
    requests = _slices(pool, _sizes(11, 14))
    engine = InferenceEngine("vggt", buckets=TEST_BUCKETS,
                             precisions=(precision,), state=state,
                             device="cpu")
    got = _serve(SLOScheduler(engine, precision=precision,
                              pipeline=pipeline), requests)
    want = _serve(JScheduler(jengine, precision=precision,
                             pipeline=pipeline), requests)
    rtol = RTOL[precision]
    for (x, y), g, w in zip(requests, got, want):
        assert g.status == w.status == "ok"
        assert g.logits.shape == (len(x), 10)
        np.testing.assert_allclose(g.logits, np.asarray(w.logits),
                                   rtol=rtol, atol=rtol)
        assert int((g.logits.argmax(1) == y).sum()) == \
            int((np.asarray(w.logits).argmax(1) == y).sum())
        assert g.latency_ms == pytest.approx(
            g.queue_wait_ms + g.service_ms, abs=1.0)
        assert g.model_version == 0


class _Counting:
    """Wraps an engine: in-flight depth of the async dispatch API, and
    whether an issue ever found its slot still unread (the engine's
    third-issue wait)."""

    def __init__(self, engine):
        self.engine = engine
        self.buckets = engine.buckets
        self.max_batch = engine.max_batch
        self.device = engine.device
        self.weights_version = engine.weights_version
        self.depth = self.max_depth = self.waits = 0

    def infer_counts(self, *a, **kw):
        return self.engine.infer_counts(*a, **kw)

    def infer_counts_async(self, *a, **kw):
        eng = self.engine
        self.waits += eng._slots[eng._next_slot].handle is not None
        handle = eng.infer_counts_async(*a, **kw)
        self.depth += 1
        self.max_depth = max(self.max_depth, self.depth)
        return handle

    def complete(self, handle, prev_done=None):
        self.depth -= 1
        return self.engine.complete(handle, prev_done=prev_done)


def test_pipelined_is_bitwise_serial_and_bounded(state, pool):
    """A seeded trace of mixed sizes: the pipelined worker's replies equal
    the serial worker's bit for bit, it keeps two dispatches in flight and
    never more, and the engine's third-issue wait never fires."""
    requests = _slices(pool, _sizes(5, 24))
    out = {}
    for pipeline in (False, True):
        engine = _Counting(InferenceEngine(
            "vggt", buckets=TEST_BUCKETS, state=state, device="cpu"))
        sched = SLOScheduler(engine, pipeline=pipeline)
        assert sched.pipeline is pipeline
        out[pipeline] = _serve(sched, requests)
        assert engine.waits == 0 and engine.depth == 0
        assert engine.max_depth == (PIPELINE_SLOTS if pipeline else 0)
    for a, b in zip(out[False], out[True]):
        assert a.status == b.status == "ok"
        assert np.array_equal(a.logits, b.logits)


class StubEngine:
    """Engine stand-in (the reference's tests' ``StubEngine``): a fixed
    service sleep, zero logits, a dispatch log."""

    def __init__(self, buckets=(1, 2, 4), service_s=0.0, fail_at=None):
        self.buckets = tuple(buckets)
        self.max_batch = self.buckets[-1]
        self.service_s = service_s
        self.fail_at = fail_at
        self.calls = []

    def infer_counts(self, images, labels=None, *, precision="f32",
                     trace_ids=None):
        if self.fail_at is not None and len(self.calls) >= self.fail_at:
            raise RuntimeError("stub engine exploded")
        self.calls.append(int(images.shape[0]))
        if self.service_s:
            time.sleep(self.service_s)
        return np.zeros((images.shape[0], 10), np.float32), 0, 0


class AsyncStub(StubEngine):
    """A stub with the async dispatch API: handles complete in issue
    order; ``completed`` logs each handle's dispatch number."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.completed = []

    def infer_counts_async(self, images, labels=None, *, precision="f32",
                           trace_ids=()):
        logits = self.infer_counts(images, labels)[0]
        return (len(self.calls) - 1, logits, time.time())

    def complete(self, handle, prev_done=None):
        self.completed.append(handle[0])
        return handle[1], 0.0, 0, time.time()


def test_scheduler_accounting_matches_reference():
    """The reference's scheduler pins on both packages' schedulers: late
    requests served and reported late, doomed ones shed with a reason,
    the bounded queue's ``QueueFull`` hint."""
    for Sched in (SLOScheduler, JScheduler):
        with Sched(StubEngine(service_s=0.05), shed=False) as sched:
            late = sched.submit(_imgs(1), slo_ms=1.0)
            ok = sched.submit(_imgs(1), slo_ms=10_000.0)
            r_late, r_ok = late.result(5.0), ok.result(5.0)
        assert r_late.status == "late" and r_ok.status == "ok"
        with Sched(StubEngine(service_s=0.05), shed=True) as sched:
            first = sched.submit(_imgs(1), slo_ms=10_000.0)
            doomed = sched.submit(_imgs(1), slo_ms=0.001)
            r = doomed.result(5.0)
        assert r.status == "shed" and r.reason in ("deadline",
                                                   "predicted_miss")
        assert first.result(5.0).status == "ok"
        sched = Sched(StubEngine(buckets=(1, 2, 4)), max_queue_images=4)
        sched.submit(_imgs(4), slo_ms=None)
        with pytest.raises(QueueFull if Sched is SLOScheduler else
                           JQueueFull) as ei:
            sched.submit(_imgs(2), slo_ms=None)
        assert ei.value.retry_after_ms > 0.0
        assert sched.queue_depth() == 4
    with pytest.raises(ValueError, match="infer_counts_async"):
        SLOScheduler(StubEngine(), pipeline=True)
    assert SLOScheduler(StubEngine()).pipeline is False
    assert SLOScheduler(AsyncStub()).pipeline is True


# -- (c) the router against the reference router ------------------------------

class StubSched:
    """Bare scheduler stand-in for the routing policy (the reference's
    tests' ``StubSched``), usable under either package's router: it
    raises that package's ``QueueFull`` (``full_exc``) when full."""

    class _Eng:
        max_batch = 8

    def __init__(self, replica, outstanding=0.0, alive=True, full=False,
                 full_exc=QueueFull):
        self.engine = self._Eng()
        self.replica = replica
        self.buckets = (8,)
        self.svc = ServiceModel((8,))
        self.alive = alive
        self.full = full
        self._outstanding = outstanding
        self.got = []
        self.on_death = None
        self.full_exc = full_exc

    def outstanding_s(self):
        return self._outstanding

    def enqueue(self, req):
        if self.full:
            raise self.full_exc(f"stub {self.replica} full",
                            retry_after_ms=10.0 * (self.replica + 1))
        self.got.append(req)
        return req.future


ROUTERS = ((ReplicaRouter, QueueFull), (JRouter, JQueueFull))


def _routing(Router, full_exc, seed):
    """Placements of a seeded sequence of loads, fills and deaths."""
    rng = np.random.default_rng(seed)
    scheds = [StubSched(i, full_exc=full_exc) for i in range(4)]
    router = Router(scheds)
    log = []
    for _ in range(60):
        for s in scheds:
            s._outstanding = float(rng.choice([0.0, 0.1, 0.2, 0.3]))
            s.full = bool(rng.random() < 0.3)
            s.alive = bool(rng.random() < 0.85)
        before = [len(s.got) for s in scheds]
        try:
            router.submit(_imgs(1))
            placed = [len(s.got) for s in scheds]
            log.append(next(i for i in range(4) if placed[i] > before[i]))
        except RuntimeError as e:   # QueueFull is one
            log.append((type(e).__name__, str(e),
                        getattr(e, "retry_after_ms", None)))
    return log, router.stats()["routed"]


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_router_matches_reference(seed):
    got, want = (_routing(*r, seed) for r in ROUTERS)
    assert got == want
    assert any(isinstance(p, tuple) and p[0] == "QueueFull" for p in got[0])


def test_router_least_loaded_tie_break_and_fall_through():
    for Router, exc in ROUTERS:
        scheds = [StubSched(0, 0.3, full_exc=exc),
                  StubSched(1, 0.1, full_exc=exc),
                  StubSched(2, 0.2, full_exc=exc)]
        router = Router(scheds)
        router.submit(_imgs(1))
        assert [len(s.got) for s in scheds] == [0, 1, 0]
        scheds[1].full = True
        router.submit(_imgs(1))
        assert [len(s.got) for s in scheds] == [0, 1, 1]
        for s in scheds:
            s.full = True
        with pytest.raises(exc) as ei:
            router.submit(_imgs(1))
        assert ei.value.retry_after_ms == pytest.approx(10.0)
        for s in scheds:
            s.full, s.alive = False, False
        with pytest.raises(RuntimeError, match="no live replicas"):
            router.submit(_imgs(1))
        ties = [StubSched(0, 0.0), StubSched(1, 0.0)]
        router = Router(ties)
        for _ in range(3):
            router.submit(_imgs(1))
        assert [len(s.got) for s in ties] == [3, 0]


class OnceFuture(Future):
    """A Future that counts every attempt to resolve it."""

    def __init__(self):
        super().__init__()
        self.sets = 0

    def set_result(self, result):
        self.sets += 1
        super().set_result(result)


def _failover(Sched, Router, engines, n=10):
    scheds = [Sched(e, replica=i) for i, e in enumerate(engines)]
    router = Router(scheds)
    reqs = []
    with router:
        for _ in range(n):
            req = (make_request if Sched is SLOScheduler
                   else jsched.make_request)(_imgs(1))
            req.future = OnceFuture()
            reqs.append(req)
            router._place(req)
        replies = [r.future.result(10.0) for r in reqs]
    return scheds, router, reqs, replies


@pytest.mark.parametrize("async_engine", [False, True])
def test_router_failover_resolves_every_request_once(async_engine):
    """Replica 0's engine dies on its FIRST dispatch with more queued
    behind it: every request fails over to replica 1 and resolves ok,
    each future exactly once, as under the reference router."""
    Engine = AsyncStub if async_engine else StubEngine
    for Sched, Router in ((SLOScheduler, ReplicaRouter),
                          (JScheduler, JRouter)):
        scheds, router, reqs, replies = _failover(
            Sched, Router, [Engine(service_s=0.02, fail_at=0),
                            Engine(service_s=0.0)])
        assert [r.status for r in replies] == ["ok"] * 10
        assert all(r.replica == 1 for r in replies)
        assert len({r.trace for r in replies}) == 10
        assert all(req.future.sets == 1 for req in reqs)
        assert router.stats()["failovers"] >= 1
        assert not scheds[0].alive


# -- (d) chaos through EngineReplica ------------------------------------------

def _replicas(state, n, chaos, **kw):
    return [EngineReplica(i, "vggt", buckets=TEST_BUCKETS, state=state,
                          device="cpu", chaos=chaos, **kw)
            for i in range(n)]


@pytest.mark.parametrize("pipeline", [True, False])
def test_replica_death_fails_over_without_loss(state, pool, pipeline):
    """``replica_death:1:0`` kills replica 0 at its second dispatch: every
    request gets exactly one reply and each one's logits are the serial
    bits.  Serial, dispatch 0 was answered by replica 0 before the death;
    pipelined, it was still in flight, so its request fails over with the
    rest and the dead worker fences (completes) the orphaned dispatch,
    discarding its result, which frees both engine slots."""
    chaos = ChaosPlan.parse(["replica_death:1:0"])
    reps = _replicas(state, 2, chaos, pipeline=pipeline)
    completes = []
    orig = reps[0].engine.complete
    reps[0].engine.complete = lambda h, prev_done=None: (
        completes.append(h), orig(h, prev_done=prev_done))[1]
    requests = [(pool.images[8 * i:8 * i + 8], None) for i in range(6)]
    router = ReplicaRouter(reps)
    reqs = []
    for x, _ in requests:
        req = make_request(x)
        req.future = OnceFuture()
        reqs.append(req)
        reps[0].enqueue(req)          # all on replica 0: it must fail over
    with router:
        replies = [r.future.result(WAIT) for r in reqs]
        assert not reps[0].alive and reps[1].alive
    assert ("replica_death", 1) in chaos.fired
    assert [r.status for r in replies] == ["ok"] * 6
    assert all(req.future.sets == 1 for req in reqs)
    assert router.stats()["failovers"] >= 1
    for (x, _), r in zip(requests, replies):
        assert np.array_equal(r.logits, reps[1].engine.infer(x))
    assert [r.replica for r in replies] == [1 if pipeline else 0] \
        + [1] * 5
    assert len(completes) == (1 if pipeline else 0)
    assert reps[0].engine._slots[0].handle is None
    assert reps[0].engine._slots[1].handle is None


def test_dead_worker_fences_its_orphaned_dispatch():
    """Pipelined, replica 0 dies issuing dispatch 1 while dispatch 0 is
    in flight: dispatch 0's requests are handed to replica 1, and only
    then is dispatch 0 completed (fenced) by the dead worker, its result
    discarded; ``stop()`` returns after that fence."""
    gate = threading.Event()
    order = []

    class Gated(AsyncStub):
        def complete(self, handle, prev_done=None):
            order.append(("fence", handle[0]))
            return super().complete(handle, prev_done)

    dead, live = Gated(buckets=(4,)), AsyncStub(buckets=(4,))

    def hook(dno, bucket):
        if dno == 1:
            gate.wait(5.0)
            raise ChaosError("chaos: replica 0 died at dispatch 1")

    s0 = SLOScheduler(dead, replica=0, dispatch_hook=hook)
    s1 = SLOScheduler(live, replica=1)
    router = ReplicaRouter([s0, s1])
    orig = router._handle_death

    def on_death(sched, unfinished, exc):
        order.append(("handoff", len(unfinished)))
        orig(sched, unfinished, exc)

    s0.on_death = on_death
    reqs = [make_request(_imgs(4)) for _ in range(3)]
    for r in reqs:
        r.future = OnceFuture()
        s0.enqueue(r)
    with router:
        gate.set()
        replies = [r.future.result(10.0) for r in reqs]
    assert [r.status for r in replies] == ["ok"] * 3
    assert [r.replica for r in replies] == [1, 1, 1]
    assert all(r.future.sets == 1 for r in reqs)
    assert order == [("handoff", 3), ("fence", 0)]
    assert dead.completed == [0] and not s0.alive


def test_slow_replica_stalls_and_tight_slos_shed_or_late(state, pool):
    """``slow_replica:0:0`` stalls replica 0's first dispatch: the stalled
    request is served, its service time holds the stall, and tier-0
    requests with a 75 ms SLO queued behind the stall are shed (with a
    reason) or served late, never dropped."""
    chaos = ChaosPlan.parse(["slow_replica:0:0"])
    (rep,) = _replicas(state, 1, chaos, slow_stall_s=0.3)
    first = rep.scheduler.submit(pool.images[:8], slo_ms=None)
    with rep:
        deadline = time.time() + WAIT
        while ("slow_replica", 0) not in chaos.fired:   # in the stall
            assert time.time() < deadline
            time.sleep(0.001)
        tight = [rep.scheduler.submit(pool.images[i:i + 1], tier=0,
                                      slo_ms=75.0) for i in range(4)]
        r0 = first.result(WAIT)
        rs = [f.result(WAIT) for f in tight]
    assert ("slow_replica", 0) in chaos.fired
    assert r0.status == "ok" and r0.service_ms >= 300.0
    assert all(r.status in ("shed", "late") for r in rs)
    assert all(r.reason in ("deadline", "predicted_miss")
               for r in rs if r.status == "shed")
    assert rep.scheduler.svc.predict(8) >= 0.3


@pytest.mark.parametrize("pipeline", [True, False])
def test_dispatch_fault_errors_only_its_batch(state, pool, pipeline):
    """``dispatch_fault:1:0``: dispatch 1's requests get explicit error
    replies, every other dispatch resolves with the serial bits, on the
    pipelined and the serial worker alike (and as under the reference
    scheduler's isolation)."""
    chaos = ChaosPlan.parse(["dispatch_fault:1:0"])
    (rep,) = _replicas(state, 1, chaos, pipeline=pipeline)
    requests = [(pool.images[8 * i:8 * i + 8], None) for i in range(4)]
    replies = _serve(rep.scheduler, requests)
    assert ("dispatch_fault", 1) in chaos.fired
    assert [r.status for r in replies] == ["ok", "error", "ok", "ok"]
    assert replies[1].reason.startswith("ChaosError: chaos: replica 0 "
                                        "dispatch 1")
    assert replies[1].logits is None
    for (x, _), r in zip(requests, replies):
        if r.status == "ok":
            assert np.array_equal(r.logits, rep.engine.infer(x))
    assert rep.alive is False         # stopped, not dead
    assert not rep.scheduler._dead


@pytest.mark.parametrize("pipeline", [True, False])
def test_completion_fault_isolation_matches_reference(jengine, state, pool,
                                                      pipeline):
    """A completion hook raising at dispatch 1 under both packages'
    schedulers: the same replies fail, with the same reason."""
    def hook(dno, bucket):
        if dno == 1:
            raise ChaosError(f"fault at {dno}")

    requests = [(pool.images[8 * i:8 * i + 8], None) for i in range(3)]
    engine = InferenceEngine("vggt", buckets=TEST_BUCKETS, state=state,
                             device="cpu")
    got = _serve(SLOScheduler(engine, complete_hook=hook,
                              pipeline=pipeline), requests)
    want = _serve(JScheduler(jengine, complete_hook=hook,
                             pipeline=pipeline), requests)
    assert [(r.status, r.reason) for r in got] == \
        [(r.status, r.reason) for r in want] == \
        [("ok", ""), ("error", "ChaosError: fault at 1"), ("ok", "")]


def test_chaos_fired_is_counted(state, pool):
    from cs744_ddp_tpu_torch.obs import Telemetry
    tel = Telemetry()
    chaos = ChaosPlan.parse(["dispatch_fault:0:0", "slow_replica:1:0"])
    (rep,) = _replicas(state, 1, chaos, telemetry=tel, slow_stall_s=0.01)
    _serve(rep.scheduler, [(pool.images[:8], None)] * 2)
    fired = sorted((e["site"], e["dispatch"]) for e in tel.records
                   if e.get("name") == "chaos_fired")
    assert fired == [("dispatch_fault", 0), ("slow_replica", 1)]
    assert tel.counter_totals()["serve_dispatch_fault"] == 1


# -- (e) the device default and what is not ported ----------------------------

def test_replica_defaults_to_the_gpu_and_cost_prior_raises(state, pool):
    """Named for what the cost-model prior did before the cost model was
    ported (it raised); now it gives per-bucket flops and serves."""
    weights = cost_model_weights(
        InferenceEngine("vggt", buckets=(2, 4), device="cpu"))
    assert sorted(weights) == [2, 4] and weights[4] == 2 * weights[2] > 1.0
    prior = EngineReplica(0, "vggt", buckets=(2, 4), device="cpu",
                          state=state, cost_prior=True)
    assert prior.scheduler.svc.weights == weights
    prior.startup()
    with prior:
        reply = prior.scheduler.submit(pool.images[:3], slo_ms=None) \
            .result(WAIT)
    assert reply.status == "ok" and reply.logits.shape == (3, 10)
    rep = EngineReplica(0, "vggt", buckets=(2,), device="cpu", state=state)
    assert rep.engine.device.type == "cpu" and rep.startup()["backend"] \
        == "cpu"
    with pytest.raises(ValueError, match="no serialized form"):
        EngineReplica(0, "vggt", buckets=(2,), device="cpu",
                      cache_dir="cache")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineReplica(0, "vggt", buckets=(2,))
