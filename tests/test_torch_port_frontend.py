"""The port's wire, tracing and socket front-end (cs744_ddp_tpu_torch/
serve/: frontend, wire, load; obs/tracing.py) and the CLI's
``--serve-frontend``, on the CPU, against the reference package's.

  * (a) The trace context and the TLV extension block: lineage, and
    ``pack_ext`` / ``unpack_ext_ex`` equal to the reference's byte for
    byte (unknown tags carried and counted, torn fields dropped).
  * (b) The frames: ``encode_request`` and ``encode_reply`` byte-equal to
    the reference's, with and without the extension block, and each
    side decodes the other's; ``wire.verify_runtime()`` is clean and the
    schema the reference's.
  * (c) Sockets both ways: the reference's ``FrontendClient`` against the
    port's ``ServingFrontend`` and the port's client against the
    reference's front-end, over a stub backend: replies, logits,
    ``retry_after_ms`` and the server times intact; the port's front-end
    over the port's router and CPU replicas serving the engine's bits;
    ``MicroBatcher.submit(ctx=)`` spans carrying the context's attrs.
  * (d) The CLI: ``--serve-frontend --device cpu --model vggt
    --serve-replicas 2`` prints the four keys; its run directory and a
    ``--serve-trace-client`` pair rendered by the reference's
    ``tools/telemetry_report.py`` (the port's ``obs.report`` the same)
    and ``tools/trace_waterfall.py``;
    ``--chaos replica_death`` failing over; the replica sites accepted
    there and refused in training, the publishing sites refused
    everywhere; ``--serve-cache-dir`` refused; without ``--device cpu``
    it raises where there is no GPU.
  * (e) ``python -m cs744_ddp_tpu_torch.serve.load``: ``gen`` with JAX
    blocked, equal to ``tools/serve_load.py gen``; ``replay`` against a
    live front-end; ``utils/profile_serve_tier.run_load``, the smoke's
    load driver, accounting for every request.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from cs744_ddp_tpu.obs import Telemetry as JTelemetry
from cs744_ddp_tpu.obs import TraceContext as JTraceContext
from cs744_ddp_tpu.obs import tracing as jtracing
from cs744_ddp_tpu.serve import QueueFull as JQueueFull
from cs744_ddp_tpu.serve import Reply as JReply
from cs744_ddp_tpu.serve import batcher as jbatcher
from cs744_ddp_tpu.serve import frontend as jfrontend
from cs744_ddp_tpu.serve import wire as jwire
from cs744_ddp_tpu_torch import cli, ft
from cs744_ddp_tpu_torch.data import cifar10
from cs744_ddp_tpu_torch.ft import ChaosPlan
from cs744_ddp_tpu_torch.models import vgg as tvgg
from cs744_ddp_tpu_torch.obs import Telemetry, TraceContext, tracing
from cs744_ddp_tpu_torch.serve import (EngineReplica, InferenceEngine,
                                       LoopbackClient, MicroBatcher,
                                       QueueFull, Reply, ReplicaRouter,
                                       ServingFrontend, frontend, load, wire)

import torch_dist_worker as worker
from test_torch_port_report import assert_renders_as_the_tool

tvgg.CFG["VGGT"] = worker.NARROW_VGG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _ctx_pair(seed):
    """The same context in both packages, ids from a seed."""
    rng = np.random.default_rng(seed)
    ids = [int(v) for v in rng.integers(1, 2 ** 63, size=3,
                                        dtype=np.int64)]
    origin = ("client", "frontend", "sched", "é" * 200)[seed % 4]
    return TraceContext(*ids, origin), JTraceContext(*ids, origin)


# -- (a) the trace context and the extension block -----------------------------

def test_trace_context_lineage():
    root = TraceContext.new_root("client")
    assert root.trace_id and root.span_id and root.parent_span_id == 0
    child = root.child("frontend")
    assert child.trace_id == root.trace_id
    assert child.parent_span_id == root.span_id
    assert child.span_id not in (0, root.span_id)
    assert child.attrs() == {"trace_id": child.trace_id,
                             "span_id": child.span_id,
                             "parent_span_id": root.span_id,
                             "origin": "frontend"}
    assert all(tracing.new_id() != 0 for _ in range(64))
    for name in ("EXT_MAGIC", "EXT_VERSION", "TAG_TRACE",
                 "TAG_SERVER_TIMES", "KNOWN_TAGS"):
        assert getattr(tracing, name) == getattr(jtracing, name)


@pytest.mark.parametrize("seed", range(4))
def test_ext_block_matches_reference(seed):
    ctx, jctx = _ctx_pair(seed)
    rng = np.random.default_rng(seed)
    extra = {int(t): rng.bytes(int(n)) for t, n in
             zip(rng.integers(3, 250, size=3), rng.integers(0, 40, size=3))}
    assert tracing.pack_trace(ctx) == jtracing.pack_trace(jctx)
    assert tracing.pack_server_times(1.25, 2.5) == \
        jtracing.pack_server_times(1.25, 2.5)
    for fields in ({}, {tracing.TAG_TRACE: tracing.pack_trace(ctx)},
                   {tracing.TAG_TRACE: tracing.pack_trace(ctx), **extra},
                   {tracing.TAG_SERVER_TIMES:
                    tracing.pack_server_times(10.5, 10.75), **extra}):
        blob = tracing.pack_ext(fields)
        assert blob == jtracing.pack_ext(fields)
        for cut in (len(blob), len(blob) - 1, 6, 2, 0):
            assert tracing.unpack_ext_ex(blob[:cut]) == \
                jtracing.unpack_ext_ex(blob[:cut])
        assert tracing.unpack_ext_ex(b"\x00" + blob[1:]) == ({}, 0, 0)
    got = tracing.unpack_trace(tracing.pack_trace(ctx))
    assert tuple(got) == tuple(
        jtracing.unpack_trace(jtracing.pack_trace(jctx)))
    # The origin is cut at 255 bytes on the wire (here mid-character).
    assert got == ctx or (len(ctx.origin.encode()) > 255
                          and got[:3] == ctx[:3])
    with pytest.raises(ValueError, match="too large"):
        tracing.pack_ext({9: b"x" * 70000})


# -- (b) the frames ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_request_frames_are_byte_identical(pool, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    imgs = pool.images[rng.integers(0, 64, size=n)]
    ctx, jctx = _ctx_pair(seed)
    for slo in (None, 75.0, 0.0):
        for c, jc in ((None, None), (ctx, jctx)):
            mine = frontend.encode_request(7 + seed, imgs, tier=seed,
                                           slo_ms=slo, ctx=c)
            ref = jfrontend.encode_request(7 + seed, imgs, tier=seed,
                                           slo_ms=slo, ctx=jc)
            assert mine == ref
            for dec, other in ((frontend.decode_request_ex, ref),
                               (jfrontend.decode_request_ex, mine)):
                rid, out, tier, s, got_ctx = dec(other)
                assert (rid, tier, s) == (7 + seed, seed,
                                          None if not slo else slo)
                assert np.array_equal(out, imgs)
                assert (None if got_ctx is None else tuple(got_ctx)) == \
                    (None if c is None else tuple(c))
            assert frontend.decode_request(ref)[0] == 7 + seed
    with pytest.raises(ValueError, match="not an extension block"):
        frontend.decode_request_ex(mine[:len(mine) - len(
            tracing.pack_ext({1: tracing.pack_trace(ctx)}))] + b"garbage!")


def _replies(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    logits = rng.standard_normal((n, 10)).astype(np.float32)
    base = {"trace": int(rng.integers(1, 2 ** 40)), "retry_after_ms": 0.0,
            "queue_wait_ms": float(rng.uniform(0, 9)),
            "service_ms": float(rng.uniform(0, 9))}
    return [
        dict(base, status="ok", reason="", logits=logits, model_version=3),
        dict(base, status="late", reason="", logits=logits),
        dict(base, status="shed", reason="predicted_miss"),
        dict(base, status="overload", reason="queue_full",
             retry_after_ms=42.5),
        dict(base, status="error", reason="ChaosError: replica 0 died"),
    ]


@pytest.mark.parametrize("seed", range(3))
def test_reply_frames_are_byte_identical(seed):
    for rep in _replies(seed):
        fields = {k: v for k, v in rep.items() if k in Reply._fields}
        forms = ((rep, rep), (Reply(**fields), JReply(**fields)))
        for mine_rep, ref_rep in forms:
            for times in ({}, {"t_recv": 10.5, "t_send": 10.75}):
                mine = frontend.encode_reply(3, mine_rep, **times)
                ref = jfrontend.encode_reply(3, ref_rep, **times)
                assert mine == ref
                a = frontend.decode_reply(ref)
                b = jfrontend.decode_reply(mine)
                assert (a["logits"] is None) == (b["logits"] is None)
                if a["logits"] is not None:
                    assert np.array_equal(a["logits"], b["logits"])
                a.pop("logits"), b.pop("logits")
                assert a == b and a["status"] == rep["status"]
                if times:
                    assert (a["t_recv"], a["t_send"]) == (10.5, 10.75)


def test_wire_schema_is_the_reference_and_verified():
    assert wire.verify_runtime() == []
    assert wire.schema_summary() == jwire.schema_summary()
    assert wire.REGISTERED_FORMATS == jwire.REGISTERED_FORMATS
    assert wire.REGISTERED_TAGS == jwire.REGISTERED_TAGS


# -- (c) sockets, both ways -----------------------------------------------------------

class StubBackend:
    """A backend whose reply is a pure function of the request: tier 1 is
    overloaded (that package's ``QueueFull``), tier 2 errors, else ok with
    logits made from the images' bytes."""

    def __init__(self, queue_full, reply_cls):
        self.queue_full = queue_full
        self.reply_cls = reply_cls
        self.ctx = []

    def submit(self, images, labels=None, *, tier=0, slo_ms=None,
               ctx=None):
        self.ctx.append(ctx)
        if tier == 1:
            raise self.queue_full("full", retry_after_ms=42.0 + len(images))
        fut = Future()
        if tier == 2:
            fut.set_result(self.reply_cls(status="shed", trace=11,
                                          reason="deadline"))
            return fut
        logits = images.reshape(len(images), -1)[:, :10].astype(np.float32)
        fut.set_result(self.reply_cls(
            status="ok", trace=int(images.sum()) + 1, logits=logits,
            queue_wait_ms=1.5, service_ms=2.5, model_version=7))
        return fut


@pytest.mark.parametrize("direction", ["ref_client_port_server",
                                       "port_client_ref_server"])
@pytest.mark.parametrize("traced", [False, True])
def test_sockets_interoperate_both_ways(pool, direction, traced, tmp_path):
    if direction == "ref_client_port_server":
        backend = StubBackend(QueueFull, Reply)
        server = ServingFrontend(backend, telemetry=Telemetry()
                                 if traced else None)
        client_cls, tel_cls = jfrontend.FrontendClient, JTelemetry
    else:
        backend = StubBackend(JQueueFull, JReply)
        server = jfrontend.ServingFrontend(
            backend, telemetry=JTelemetry() if traced else None)
        client_cls, tel_cls = frontend.FrontendClient, Telemetry
    client_tel = tel_cls() if traced else None
    with server:
        with client_cls(server.address, timeout=WAIT,
                        telemetry=client_tel) as client:
            futs = [client.submit(pool.images[i:i + 1 + i % 3],
                                  tier=i % 3, slo_ms=50.0)
                    for i in range(9)]
            reps = [f.result(WAIT) for f in futs]
    for i, rep in enumerate(reps):
        imgs = pool.images[i:i + 1 + i % 3]
        if i % 3 == 0:
            assert rep["status"] == "ok" and rep["model_version"] == 7
            assert rep["trace"] == int(imgs.sum()) + 1
            assert np.array_equal(rep["logits"], imgs.reshape(
                len(imgs), -1)[:, :10].astype(np.float32))
            assert (rep["queue_wait_ms"], rep["service_ms"]) == (1.5, 2.5)
        elif i % 3 == 1:
            assert rep["status"] == "overload"
            assert rep["reason"] == "queue_full"
            assert rep["retry_after_ms"] == 42.0 + len(imgs)
        else:
            assert (rep["status"], rep["reason"]) == ("shed", "deadline")
        assert ("t_recv" in rep) is traced
    assert all((c is not None) is traced for c in backend.ctx)
    if traced:
        roots = [e for e in client_tel.records
                 if e.get("name") == "trace_client"]
        assert len(roots) == 9
        assert {e["trace_id"] for e in roots} == {c.trace_id
                                                  for c in backend.ctx}


def test_port_frontend_serves_the_engines_bits(pool):
    """The port's front-end over the port's router and two CPU replicas:
    every reply's logits are the engine's own, the requests land on both
    replicas, and an overloaded router answers with the hint."""
    reps = [EngineReplica(i, "vggt", buckets=(2, 4, 8), device="cpu")
            for i in range(2)]
    router = ReplicaRouter(reps)
    with router:
        with ServingFrontend(router) as fe:
            with frontend.FrontendClient(fe.address, timeout=WAIT) as c:
                futs = [c.submit(pool.images[i:i + 1 + i % 8], slo_ms=None)
                        for i in range(16)]
                got = [f.result(WAIT) for f in futs]
    for i, rep in enumerate(got):
        assert rep["status"] == "ok" and rep["model_version"] == 0
        assert np.array_equal(rep["logits"], reps[0].engine.infer(
            pool.images[i:i + 1 + i % 8]))
    assert len({r["trace"] for r in got}) == 16
    assert router.stats()["routed"] == 16
    full = LoopbackClient(StubBackend(QueueFull, Reply))
    rep = full.request(pool.images[:1], tier=1)
    assert rep["status"] == "overload" and rep["retry_after_ms"] == 43.0


@pytest.mark.parametrize("pipeline", [True, False])
def test_profile_load_driver_accounts_every_request(pool, pipeline):
    """``utils/profile_serve_tier.run_load`` (the smoke's serve_tier loads)
    over two CPU replicas: one reply a request, the replica and bucket of
    each served request read from the telemetry, each reply's logits
    bitwise its replica's serial dispatch of the request padded to that
    bucket, one dispatch record a ``serve_service_ms``."""
    from cs744_ddp_tpu_torch.serve import demo
    from cs744_ddp_tpu_torch.utils import profile_serve_tier as pst
    tel = Telemetry()
    # No shedding: on a loaded host the 75 ms tier would shed some.
    reps = [EngineReplica(i, "vggt", buckets=(2, 4, 8), device="cpu",
                          telemetry=tel, pipeline=pipeline, shed=False)
            for i in range(2)]
    for rep in reps:
        rep.startup()
    trace = demo.synthetic_load_trace(30, offered_rps=300.0, seed=2,
                                      size_choices=(1, 2, 4, 8))
    out = pst.run_load(reps, trace, pool=pool, seed=2, telemetry=tel,
                       profile=False)
    st = out["stats"]
    assert st["replies"] == 30 and st["unresolved"] == 0
    assert out["device_busy"] is None and len(out["host_busy"]) == 2
    assert len(out["dispatches"]) == sum(
        r.get("name") == "serve_service_ms" for r in tel.records)
    for e in out["sent"]:
        reply = e["reply"]
        assert reply["status"] in ("ok", "late")
        index, bucket = out["served"][reply["trace"]]
        n = len(e["images"])
        assert bucket in (2, 4, 8) and bucket >= n
        pad = np.zeros((bucket - n, 32, 32, 3), np.uint8)
        want = reps[index].engine.infer_counts(
            np.concatenate([e["images"], pad]))[0][:n]
        assert np.array_equal(reply["logits"], want)
    assert "server latency" in pst.describe(out, (2, 4, 8))


def test_microbatcher_spans_carry_the_context(pool):
    """``MicroBatcher.submit(ctx=)``: the queue span of each request
    carries the context's child attrs under origin ``batcher``, as the
    reference's does."""
    tel = Telemetry()
    engine = InferenceEngine("vggt", buckets=(2, 4), device="cpu",
                             telemetry=tel)
    ctx = TraceContext.new_root("frontend")
    with MicroBatcher(engine, max_wait_ms=1.0) as mb:
        mb.submit(pool.images[:2], ctx=ctx).result(WAIT)
        mb.submit(pool.images[:1]).result(WAIT)
    spans = [e for e in tel.records if e.get("name") == "sched_queue"]
    assert len(spans) == 1
    (s,) = spans
    assert s["trace_id"] == ctx.trace_id and s["origin"] == "batcher"
    assert s["parent_span_id"] == ctx.span_id and s["span_id"] not in (
        0, ctx.span_id)
    assert set(jbatcher.MicroBatcher.submit.__code__.co_varnames) >= {
        "ctx"}


# -- (d) the CLI ------------------------------------------------------------------------

def _cli(capsys, *args):
    cli.main(["--serve-frontend", "--device", "cpu", "--model", "vggt",
              "--serve-buckets", "2,4,8", *args])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_serve_frontend_end_to_end(capsys, tmp_path, monkeypatch):
    srv, client = tmp_path / "server", tmp_path / "client"
    out = _cli(capsys, "--serve-replicas", "2", "--serve-requests", "24",
               "--serve-load", "400", "--serve-seed", "1",
               "--telemetry-out", str(srv),
               "--serve-trace-client", str(client))
    # The alert engine rides --telemetry-out by default (--serve-alerts).
    assert set(out) == {"address", "startup", "router", "load", "alerts"}
    assert set(out["alerts"]) == {"fired", "by_rule", "total"}
    assert set(out["startup"]) == {"replica0", "replica1"}
    assert all(r["backend"] == "cpu" for r in out["startup"].values())
    st = out["load"]["400rps"]
    assert st["replies"] == st["n_requests"] == 24 and st["unresolved"] == 0
    assert st["unique_traces"] == st["traced"]
    assert out["router"]["routed"] == 24
    assert [r["replica"] for r in out["router"]["replicas"]] == [0, 1]
    man = json.loads((srv / "manifest.json").read_text())
    assert man["mode"] == "serve-frontend" and man["replicas"] == 2
    assert man["devices"] == ["cpu", "cpu"] and man["pipeline"] is True
    assert man["router"]["routed"] == 24
    assert man["alerts"] == out["alerts"]
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import telemetry_report
    import trace_waterfall
    text = telemetry_report.render(str(srv))
    assert_renders_as_the_tool(srv, text)
    assert "== slo (tiered attainment) ==" in text
    assert "== dispatch pipeline ==" in text
    assert "replica 0" in text and "replica 1" in text
    printed = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: printed.append(
        " ".join(str(x) for x in a)))
    assert trace_waterfall.main([str(srv), str(client), "--json"]) == 0
    report = json.loads("\n".join(printed))
    assert report["reference"] == "server"
    assert report["processes"]["client"]["skew_pairs"] == 24
    # A waterfall is complete once it holds a device dispatch: every served
    # (ok or late) request's; a loaded host may shed some tier-0 ones.
    served = sum(c["ok"] + c["late"] for c in st["by_tier"].values())
    assert served > 0 and report["complete"] == served
    assert all({"client", "frontend", "sched"} <= set(w["origins"])
               for w in report["waterfalls"] if w["complete"])


@pytest.mark.parametrize("pipeline", ["on", "off"])
def test_cli_replica_death_fails_over(capsys, pipeline):
    out = _cli(capsys, "--serve-replicas", "2", "--serve-requests", "16",
               "--serve-load", "500", "--serve-slo-ms", "60000",
               "--serve-pipeline", pipeline,
               "--chaos", "replica_death:0:0")
    st = out["load"]["500rps"]
    assert st["replies"] == 16 and st["unresolved"] == 0
    assert st["by_tier"]["0"]["error"] == 0
    assert st["by_tier"]["0"]["ok"] + st["by_tier"]["0"]["late"] == 16
    assert out["router"]["failovers"] >= 1
    assert [r["alive"] for r in out["router"]["replicas"]] == [False,
                                                               False]


@pytest.mark.parametrize("site", sorted(ft.SERVE_SITES))
def test_serving_takes_the_replica_sites_and_training_refuses_them(site,
                                                                   tmp_path):
    # swap_mid_batch probes the weight watcher: it needs one.
    watch = (["--serve-publish-dir", str(tmp_path)]
             if site == "swap_mid_batch" else [])
    plan = cli.ft_config_from_args(cli.parse_args(
        ["--serve-frontend", "--chaos", f"{site}:3:1"] + watch)).chaos
    assert plan.spec() == [{"site": site, "step": 3, "seed": 1}]
    with pytest.raises(SystemExit, match="--serve-frontend"):
        cli.ft_config_from_args(cli.parse_args(["--chaos", f"{site}:3:1"]))
    with pytest.raises(ValueError, match="no replica runs in training"):
        ft.check_sites(ChaosPlan.parse([f"{site}:3"]))


@pytest.mark.parametrize("site", ["swap_mid_batch", "publish_torn",
                                  "publish_stale", "preempt",
                                  "producer_crash", "rank_death"])
def test_serving_refuses_the_other_sites(site):
    """The training sites, and ``swap_mid_batch`` without a weight watcher
    to probe (tests/test_torch_port_publish.py takes it with one)."""
    why = ("needs --serve-publish-dir" if site == "swap_mid_batch"
           else "fires in training only")
    with pytest.raises(SystemExit, match=why):
        cli.ft_config_from_args(cli.parse_args(
            ["--serve-frontend", "--chaos", f"{site}:3:1"]))


def test_cli_serve_frontend_refusals(tmp_path):
    with pytest.raises(SystemExit, match="no serialized form"):
        cli.main(["--serve-frontend", "--device", "cpu", "--model", "vggt",
                  "--serve-cache-dir", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--serve-frontend", "--model", "vggt"])


# -- (e) the load driver --------------------------------------------------------------

def test_load_gen_runs_without_jax_and_matches_the_tool(tmp_path):
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['cs744_ddp_tpu'] = None\n"
            "from cs744_ddp_tpu_torch.serve import load\n"
            "sys.exit(load.main(sys.argv[1:]))\n")
    args = ["gen", "--requests", "40", "--rps", "900", "--seed", "3",
            "--tier", "0:1:50", "--tier", "2:3:400", "--max-size", "32"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    mine = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert mine.returncode == 0, mine.stderr
    ref = subprocess.run([sys.executable,
                          os.path.join(REPO, "tools", "serve_load.py"),
                          *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr
    assert json.loads(mine.stdout) == json.loads(ref.stdout)
    out = tmp_path / "trace.json"
    assert load.main([*args, "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == json.loads(mine.stdout)


def test_load_replay_against_a_live_frontend(capsys, tmp_path):
    trace = tmp_path / "trace.json"
    assert load.main(["gen", "--requests", "12", "--rps", "300",
                      "--max-size", "8", "-o", str(trace)]) == 0
    capsys.readouterr()
    rep = EngineReplica(0, "vggt", buckets=(2, 4, 8), device="cpu")
    with ReplicaRouter([rep]) as router:
        with ServingFrontend(router) as fe:
            assert load.main(["replay", str(trace), "--port",
                              str(fe.address[1]), "--timeout", "60",
                              "--telemetry-out",
                              str(tmp_path / "client")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["n_requests"] == stats["replies"] == 12
    assert stats["unresolved"] == 0 and stats["unique_traces"] == 12
    with pytest.raises(SystemExit, match="needs a trace file or --rps"):
        load.main(["replay", "--port", "1"])
