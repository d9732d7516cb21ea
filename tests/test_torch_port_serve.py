"""The port's serving engine (cs744_ddp_tpu_torch/serve/: engine, ingest,
batcher, demo, and the CLI's ``--serve-demo``), on the CPU, against the
reference package's ``serve/``.

  * (a) The port's ``InferenceEngine`` on the reference engine's own
    weights (``models.convert.from_jax``), narrow VGG, buckets (2, 4, 8):
    logits, loss_sum and correct of every request size 1..8 against the
    reference's, f32 within rtol/atol 1e-4 and bf16 within 1e-2 (the
    bounds of test_torch_port_precision.py's fused-ingest forward),
    correct exact; the serial, async and ``use_staging=False`` paths give
    the same bits.
  * (b) The reference's engine pins (tests/test_serve.py) against the
    port's engine: bucket edges, config validation (and ``cache_dir``
    refused: a CUDA graph has no serialized form), padded rows bitwise the
    direct forward at the exact size (n >= 2), batchmate invariance,
    staging against the plain copy, unlabeled counts, and a disabled
    recorder never touched.
  * (c) The framework-free policy (``coalesce``, ``smallest_bucket``,
    ``plan_batches``, the seeded traces, ``parse_buckets``, the request
    pool) equal to the reference's functions, exactly.
  * (d) The threaded ``MicroBatcher``: each request's own rows, its
    lifecycle, the bounded queue's ``retry_after_ms``, engine failures
    handed to the callers.
  * (e) The pipeline: two dispatches of one bucket in flight give the
    serial bits; a third issue reads the oldest back first and reuses its
    slot; the staging arena's slots cycle without corrupting a batch.
  * (f) ``install_weights``: in place, equal to a fresh engine on the new
    state, a mismatched state refused, ``weights_version`` bumped.
  * (g) The CLI's ``--serve-demo`` and ``serve.demo``'s main; the run
    directory rendered by the reference's ``tools/telemetry_report.py``
    and, the same, by the port's ``obs.report``.
  * (h) ``device=None`` is the GPU, and raises without one.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.serve import BUCKETS as JBUCKETS
from cs744_ddp_tpu.serve import PIPELINE_SLOTS as JSLOTS
from cs744_ddp_tpu.serve import InferenceEngine as JEngine
from cs744_ddp_tpu.serve import batcher as jbatcher
from cs744_ddp_tpu.serve import demo as jdemo
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.data import cifar10
from cs744_ddp_tpu_torch.models import convert, get_model, vgg as tvgg
from cs744_ddp_tpu_torch.obs import NULL, Telemetry
from cs744_ddp_tpu_torch.serve import (BUCKETS, PIPELINE_SLOTS,
                                       InferenceEngine, MicroBatcher,
                                       QueueFull, StagedIngest, coalesce,
                                       plan_batches)
from cs744_ddp_tpu_torch.serve import batcher, demo

import torch_dist_worker as worker
from test_torch_port_report import assert_renders_as_the_tool

jvgg.CFG["VGGT"] = worker.NARROW_VGG
tvgg.CFG["VGGT"] = worker.NARROW_VGG
jmodels.register_model("vggt", lambda: jvgg.make("VGGT"))

TEST_BUCKETS = (2, 4, 8)
PRECISIONS = ("f32", "bf16")
# test_torch_port_precision.py's bounds for the fused-ingest forward.
RTOL = {"f32": 1e-4, "bf16": 1e-2}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the narrow model's ops are too
    small to share out, and the suite runs its files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jengine():
    return JEngine("vggt", buckets=TEST_BUCKETS, precisions=PRECISIONS,
                   seed=0)


@pytest.fixture(scope="module")
def state(jengine):
    return convert.from_jax(_np_tree(jengine.params),
                            _np_tree(jengine.bn_state))


@pytest.fixture(scope="module")
def engine(state):
    return InferenceEngine("vggt", buckets=TEST_BUCKETS,
                           precisions=PRECISIONS, state=state, device="cpu")


@pytest.fixture(scope="module")
def plain_engine(state):
    return InferenceEngine("vggt", buckets=TEST_BUCKETS,
                           precisions=PRECISIONS, state=state,
                           use_staging=False, device="cpu")


@pytest.fixture(scope="module")
def pool():
    return cifar10._synthetic_split(64, seed=3)


def _direct(engine, images, labels=None, precision="f32"):
    """The engine's forward run eagerly at the exact request size."""
    n = len(images)
    y = np.full((n,), -1, np.int64) if labels is None \
        else np.asarray(labels, np.int64)
    out = engine._forward[precision](torch.from_numpy(np.array(images)),
                                     torch.from_numpy(y))
    return out[0].numpy(), float(out[1]), int(out[2])


# -- (a) against the reference engine -----------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_matches_reference(jengine, engine, plain_engine, pool,
                                  precision, n):
    images, labels = pool.images[:n], pool.labels[:n]
    want = jengine.infer_counts(images, labels, precision=precision)
    got = engine.infer_counts(images, labels, precision=precision)
    rtol = RTOL[precision]
    assert got[0].shape == (n, 10) and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=rtol,
                               atol=rtol)
    np.testing.assert_allclose(got[1], float(want[1]), rtol=rtol)
    assert got[2] == int(want[2])
    handle = engine.infer_counts_async(images, labels, precision=precision)
    piped = engine.complete(handle)
    plain = plain_engine.infer_counts(images, labels, precision=precision)
    for other in (piped[:3], plain):
        assert np.array_equal(other[0], got[0])
        assert other[1:] == got[1:]


# -- (b) the reference's engine pins ------------------------------------------

def test_bucket_for_edges(engine):
    assert engine.bucket_for(1) == 2
    assert engine.bucket_for(2) == 2
    assert engine.bucket_for(3) == 4
    assert engine.bucket_for(8) == 8
    assert engine.max_batch == 8
    with pytest.raises(ValueError, match="at least one"):
        engine.bucket_for(0)
    with pytest.raises(ValueError, match="exceeds the largest"):
        engine.bucket_for(9)


def test_engine_validates_config():
    with pytest.raises(ValueError, match="strictly increasing"):
        InferenceEngine("vggt", buckets=(4, 2), device="cpu")
    with pytest.raises(ValueError, match="strictly increasing"):
        InferenceEngine("vggt", buckets=(2, 2, 4), device="cpu")
    with pytest.raises(ValueError, match="at least one bucket"):
        InferenceEngine("vggt", buckets=(), device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        InferenceEngine("vggt", buckets=(2,), precisions=("f16",),
                        device="cpu")
    with pytest.raises(ValueError, match="no serialized form"):
        InferenceEngine("vggt", buckets=(2,), cache_dir="cache",
                        device="cpu")
    assert BUCKETS == JBUCKETS and PIPELINE_SLOTS == JSLOTS


def test_bucketed_output_bitwise_equals_direct_forward(engine, pool):
    """Every ragged fill of every bucket: the sliced logits are bitwise
    the forward at the exact request size with no padding.  n=1 is left
    to the batchmate test, as in the reference: the batch-1 direct forward
    is the outlier there (measured 3.7e-8 on the narrow model)."""
    for n in (2, 3, 5, 7, 8):
        imgs, labs = pool.images[:n], pool.labels[:n]
        logits, loss, correct = engine.infer_counts(imgs, labs)
        d_logits, d_loss, d_correct = _direct(engine, imgs, labs)
        assert logits.shape == (n, 10) and logits.dtype == np.float32
        assert np.array_equal(logits, d_logits), \
            f"bucketed logits differ from direct forward at n={n}"
        assert correct == d_correct
        assert loss == pytest.approx(d_loss, rel=1e-6)


def test_request_rows_are_batchmate_invariant(engine, pool):
    solo = engine.infer(pool.images[:1])
    paired = engine.infer(pool.images[:2])[:1]
    assert np.array_equal(solo, paired)
    full = engine.infer(np.concatenate([pool.images[:5],
                                        pool.images[20:23]]))[:5]
    assert np.array_equal(engine.infer(pool.images[:5]), full)
    d_logits, _, _ = _direct(engine, pool.images[:1])
    np.testing.assert_allclose(solo, d_logits, rtol=1e-5)


def test_staging_and_plain_copy_paths_identical(engine, plain_engine, pool):
    for n in (1, 3, 6):
        assert np.array_equal(engine.infer(pool.images[:n]),
                              plain_engine.infer(pool.images[:n]))


def test_unlabeled_request_counts_are_zero(engine, pool):
    logits, loss, correct = engine.infer_counts(pool.images[:3])
    assert logits.shape == (3, 10)
    assert loss == 0.0 and correct == 0


class _ExplodingRecorder:
    """enabled=False recorder whose every method call fails the test."""

    enabled = False

    def __getattr__(self, name):
        raise AssertionError(
            f"telemetry.{name} touched with telemetry disabled")


def test_disabled_telemetry_is_never_touched(pool):
    eng = InferenceEngine("vggt", buckets=(2, 4), seed=0, device="cpu",
                          telemetry=_ExplodingRecorder())
    eng.startup()
    eng.infer_counts(pool.images[:3], pool.labels[:3])
    eng.complete(eng.infer_counts_async(pool.images[:2]))
    with MicroBatcher(eng, max_wait_ms=1.0) as mb:
        futs = [mb.submit(pool.images[:2]) for _ in range(4)]
        for f in futs:
            f.result(timeout=30)
    assert not hasattr(NULL, "records")
    assert NULL.counter_totals() == {}


def test_startup_report_and_spans(state):
    tel = Telemetry()
    eng = InferenceEngine("vggt", buckets=(2, 4), precisions=PRECISIONS,
                          state=state, device="cpu", telemetry=tel)
    report = eng.startup()
    assert set(report) == {"startup_s", "per_bucket", "warm",
                           "executable_cache", "backend"}
    assert set(report["per_bucket"]) == {"2/f32", "4/f32", "2/bf16",
                                         "4/bf16"}
    assert report["warm"] is False and report["backend"] == "cpu"
    assert report["executable_cache"] == {"dir": None, "supported": False,
                                          "hits": 0, "misses": 0}
    eng.infer_counts(np.zeros((3, 32, 32, 3), np.uint8), trace_ids=(7,))
    eng.complete(eng.infer_counts_async(np.zeros((1, 32, 32, 3), np.uint8)))
    spans = [(r["name"], r.get("bucket")) for r in tel.records
             if r["kind"] == "span"]
    assert spans.count(("serve_compile", 2)) == 2
    assert ("serve_stage", 4) in spans and ("serve_dispatch", 4) in spans
    assert ("serve_fetch", 4) in spans and ("serve_dispatch", 2) in spans
    assert tel.counter_totals() == {"serve_bucket_4": 1, "serve_bucket_2": 1}
    assert [r["name"] for r in tel.records if r["kind"] == "gauge"] \
        == ["serve_startup_s"]


# -- (c) the framework-free policy against the reference ----------------------

@pytest.mark.parametrize("seed", range(4))
def test_coalesce_and_smallest_bucket_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        sizes = [int(s) for s in rng.integers(1, 12, size=rng.integers(
            0, 8))]
        for cap in (1, 4, 8, 16):
            assert coalesce(sizes, cap) == jbatcher.coalesce(sizes, cap)
    for n in range(1, 9):
        assert batcher.smallest_bucket(TEST_BUCKETS, n) \
            == jbatcher.smallest_bucket(TEST_BUCKETS, n)
    with pytest.raises(ValueError, match="exceed"):
        batcher.smallest_bucket(TEST_BUCKETS, 9)


@pytest.mark.parametrize("max_wait_s", [0.0, 0.001, 0.004, 0.02])
@pytest.mark.parametrize("seed", [1, 5])
def test_plan_batches_matches_reference(seed, max_wait_s):
    trace = demo.synthetic_trace(64, offered_rps=300.0, seed=seed,
                                 size_choices=(1, 1, 2, 4, 8))
    assert trace == jdemo.synthetic_trace(64, offered_rps=300.0, seed=seed,
                                          size_choices=(1, 1, 2, 4, 8))
    plan = plan_batches(trace, TEST_BUCKETS, max_wait_s)
    assert plan == jbatcher.plan_batches(trace, TEST_BUCKETS, max_wait_s)
    assert [i for b in plan for i in b["requests"]] \
        == list(range(len(trace)))
    with pytest.raises(ValueError, match="exceeds the largest"):
        plan_batches([(0.0, 9)], TEST_BUCKETS, max_wait_s)


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_traces_and_pool_match_reference(seed):
    assert demo.SIZE_CHOICES == jdemo.SIZE_CHOICES
    assert demo.DEFAULT_TIERS == jdemo.DEFAULT_TIERS
    for rps in (20.0, 2000.0):
        assert demo.synthetic_trace(50, offered_rps=rps, seed=seed) \
            == jdemo.synthetic_trace(50, offered_rps=rps, seed=seed)
        assert demo.synthetic_load_trace(50, offered_rps=rps, seed=seed) \
            == jdemo.synthetic_load_trace(50, offered_rps=rps, seed=seed)
    for spec in ("8,1,32", "4,4", "1,8,32,128,256", " 2, 4 ,"):
        assert demo.parse_buckets(spec) == jdemo.parse_buckets(spec)
    got, want = demo.request_pool(96, seed=seed), \
        jdemo.request_pool(96, seed=seed)
    assert np.array_equal(got.images, np.asarray(want.images))
    assert np.array_equal(got.labels, np.asarray(want.labels))


class _LoopbackStub:
    """A serving client whose replies are a pure function of the request,
    resolved at once: ``replay_load``'s accounting is then deterministic."""

    def __init__(self):
        self.trace = 0

    def submit(self, images, *, tier, slo_ms):
        from concurrent.futures import Future
        self.trace += 1
        fut = Future()
        if len(images) == 32:
            fut.set_exception(RuntimeError("dropped"))
            return fut
        status = ("ok", "late", "shed", "overload")[
            (len(images) + tier) % 4]
        fut.set_result({"status": status, "trace": self.trace,
                        "queue_wait_ms": float(len(images))})
        return fut


def test_replay_load_matches_reference():
    trace = demo.synthetic_load_trace(60, offered_rps=5000.0, seed=3)
    pool = demo.request_pool(128, seed=5)
    got = demo.replay_load(_LoopbackStub(), trace, pool=pool, seed=2)
    want = jdemo.replay_load(_LoopbackStub(), trace, pool=pool, seed=2)
    timed = ("wall_s", "goodput_rps", "goodput_ips", "driver_lag_ms_max")
    for key in timed:
        got.pop(key), want.pop(key)
    assert got == want
    assert got["replies"] + got["unresolved"] == 60 and got["unresolved"]


# -- (d) the threaded micro-batcher -------------------------------------------

def test_microbatcher_returns_each_request_its_own_rows(engine, pool):
    rng = np.random.default_rng(0)
    sizes = [1, 3, 2, 8, 1, 4, 5, 2]
    reqs = [pool.images[rng.integers(0, len(pool.images), size=s)]
            for s in sizes]
    with MicroBatcher(engine, max_wait_ms=2.0) as mb:
        futs = [mb.submit(imgs) for imgs in reqs]
        outs = [f.result(timeout=30) for f in futs]
    for imgs, out in zip(reqs, outs):
        assert out.shape == (len(imgs), 10)
        assert np.array_equal(out, engine.infer(imgs))


def test_microbatcher_lifecycle_and_bounds(engine, pool):
    mb = MicroBatcher(engine)
    with pytest.raises(RuntimeError, match="not running"):
        mb.submit(pool.images[:1])
    with mb:
        with pytest.raises(ValueError, match="exceeds the largest"):
            mb.submit(pool.images[:9])
    with pytest.raises(RuntimeError, match="already started"):
        mb.start() and mb.start()
    mb.stop()


class _GatedEngine:
    buckets = (8,)
    max_batch = 8
    telemetry = NULL

    def __init__(self):
        self.gate = threading.Event()
        self.calls = []

    def infer_counts(self, images, labels, precision="f32"):
        self.gate.wait(timeout=30)
        self.calls.append(len(images))
        return np.zeros((len(images), 10), np.float32), 0.0, 0


def test_microbatcher_bounded_queue_rejects():
    eng = _GatedEngine()
    with MicroBatcher(eng, max_wait_ms=0.0, max_queue_images=8) as mb:
        first = mb.submit(np.zeros((8, 32, 32, 3), np.uint8))
        deadline = time.time() + 5
        while time.time() < deadline:
            with mb._cond:
                if not mb._pending:
                    break
            time.sleep(0.001)
        second = mb.submit(np.zeros((8, 32, 32, 3), np.uint8))
        with pytest.raises(QueueFull) as ei:
            mb.submit(np.zeros((1, 32, 32, 3), np.uint8))
        assert ei.value.retry_after_ms > 0.0
        eng.gate.set()
        first.result(timeout=30)
        second.result(timeout=30)
    assert eng.calls == [8, 8]


class _FailingEngine:
    buckets = (4,)
    max_batch = 4
    telemetry = NULL

    def infer_counts(self, images, labels, precision="f32"):
        raise RuntimeError("device fell over")


def test_microbatcher_propagates_engine_failure():
    with MicroBatcher(_FailingEngine(), max_wait_ms=0.0) as mb:
        fut = mb.submit(np.zeros((2, 32, 32, 3), np.uint8))
        with pytest.raises(RuntimeError, match="fell over"):
            fut.result(timeout=30)


# -- (e) the pipeline -----------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
def test_two_in_flight_give_the_serial_bits(engine, pool, precision):
    reqs = [(pool.images[i * 8:i * 8 + 8], pool.labels[i * 8:i * 8 + 8])
            for i in range(3)]
    serial = [engine.infer_counts(x, y, precision=precision)
              for x, y in reqs]
    h = [engine.infer_counts_async(x, y, precision=precision)
         for x, y in reqs[:2]]
    assert h[0].slot != h[1].slot
    for hd, want in zip(h, serial):
        got = engine.complete(hd)
        assert np.array_equal(got[0], want[0]) and got[1:3] == want[1:]
    # A third issue with two in flight reads the oldest back first and
    # reuses its slot (and its arena slot).
    h = [engine.infer_counts_async(x, y, precision=precision)
         for x, y in reqs]
    assert h[2].slot == h[0].slot
    assert h[0].result is not None and h[1].result is None
    prev = None
    for hd, want in zip(h, serial):
        got = engine.complete(hd, prev)
        prev = got[3]
        assert np.array_equal(got[0], want[0]) and got[1:3] == want[1:]


def test_staged_ingest_roundtrip_and_slot_reuse(pool):
    ing = StagedIngest(8, nslots=2, device="cpu")
    batches = [pool.images[i * 8:i * 8 + n]
               for i, n in enumerate((3, 8, 5))]
    dsts = [torch.full((8, 32, 32, 3), 7, dtype=torch.uint8)
            for _ in batches]
    for b, dst in zip(batches, dsts):
        assert ing.stage(b, 8, dst) is None
    for src, dst in zip(batches, dsts):
        got = dst.numpy()
        assert np.array_equal(got[:len(src)], src)
        assert not got[len(src):].any()


def test_staged_ingest_bounds(pool):
    ing = StagedIngest(8, device="cpu")
    dst = torch.empty((16, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cannot stage"):
        ing.stage(pool.images[:0], 8, dst[:8])
    with pytest.raises(ValueError, match="cannot stage"):
        ing.stage(pool.images[:9], 8, dst[:8])
    with pytest.raises(ValueError, match="cannot stage"):
        ing.stage(pool.images[:4], 16, dst)


# -- (f) install_weights --------------------------------------------------------

def test_install_weights_in_place(state, pool):
    tel = Telemetry()
    eng = InferenceEngine("vggt", buckets=TEST_BUCKETS,
                          precisions=PRECISIONS, state=state, device="cpu",
                          telemetry=tel)
    eng.startup()
    before = eng.infer(pool.images[:5])
    ptrs = {k: v.data_ptr() for k, v in eng.model.state_dict().items()}
    new = get_model("vggt", seed=1).state_dict()
    eng.install_weights(new, 3)
    assert eng.weights_version == 3
    assert {k: v.data_ptr()
            for k, v in eng.model.state_dict().items()} == ptrs
    fresh = InferenceEngine("vggt", buckets=TEST_BUCKETS,
                            precisions=PRECISIONS, state=new, device="cpu")
    for prec in PRECISIONS:
        got = eng.infer_counts(pool.images[:5], pool.labels[:5],
                               precision=prec)
        want = fresh.infer_counts(pool.images[:5], pool.labels[:5],
                                  precision=prec)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert not np.array_equal(eng.infer(pool.images[:5]), before)
    assert tel.counter_totals()["weights_installed"] == 1


def test_install_weights_refuses_a_mismatched_state(state):
    eng = InferenceEngine("vggt", buckets=(2,), state=state, device="cpu")
    dropped = dict(state)
    dropped.pop(next(iter(dropped)))
    reshaped = dict(state)
    name = next(k for k, v in state.items() if v.dim() == 4)
    reshaped[name] = torch.zeros(state[name].shape[:-1] + (1,))
    retyped = {k: v.double() if v.is_floating_point() else v
               for k, v in state.items()}
    for bad in (dropped, reshaped, retyped):
        with pytest.raises(ValueError, match="does not match"):
            eng.install_weights(bad, 1)
    assert eng.weights_version == 0
    eng.install_weights(dict(state), 2, assume_staged=True)
    assert eng.weights_version == 2


# -- (g) the CLI and the demo's main --------------------------------------------

def test_cli_serve_demo_end_to_end(capsys, tmp_path, monkeypatch):
    cli.main(["--serve-demo", "--device", "cpu", "--model", "vggt",
              "--serve-buckets", "2,4", "--serve-requests", "12",
              "--serve-load", "300", "--serve-max-wait-ms", "2",
              "--serve-seed", "1", "--telemetry-out", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"startup", "demo"}
    assert set(out["startup"]["per_bucket"]) == {"2", "4"}
    stats = out["demo"]["300rps"]
    assert stats["completed"] + stats["rejected"] == 12
    assert stats["completed"] > 0 and "latency_ms" in stats
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import telemetry_report
    text = telemetry_report.render(str(tmp_path))
    assert_renders_as_the_tool(tmp_path, text)
    assert "== serving ==" in text
    assert "request latency by bucket" in text
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["mode"] == "serve" and man["buckets"] == [2, 4]
    assert (tmp_path / "summary.json").exists()


def test_cli_refuses_the_executable_cache(tmp_path):
    with pytest.raises(SystemExit, match="no serialized form"):
        cli.main(["--serve-demo", "--device", "cpu", "--model", "vggt",
                  "--serve-cache-dir", str(tmp_path)])


def test_demo_main(capsys):
    assert demo.main(["--device", "cpu", "--model", "vggt", "--buckets",
                      "2,4", "--requests", "6", "--load", "300",
                      "--max-wait-ms", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["demo"]["completed"] + out["demo"]["rejected"] == 6
    assert set(out["demo"]["bucket_counts"]) <= {"2", "4"}
    assert demo.main(["--device", "cpu", "--model", "vggt", "--buckets",
                      "2", "--startup-probe"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report["per_bucket"]) == {"2"}


# -- (h) the GPU by default -------------------------------------------------------

def test_engine_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine("vggt", buckets=(2,))
