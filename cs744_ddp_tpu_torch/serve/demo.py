"""Seeded synthetic request traces + the open-loop serving demo --
the reference package's ``serve/demo.py``.

The serving numbers (``cli.py --serve-demo``, ``chip_smoke.py`` phase
``serve``) come from replaying a DETERMINISTIC trace: Poisson arrivals at a
configured offered load, request sizes drawn from a fixed mixture skewed
toward small requests (the shape batched serving exists for), images
sampled from the synthetic CIFAR stand-in.  Open loop: requests are
submitted at their scheduled arrival times regardless of completion
(offered load is the independent variable; queueing shows up in latency,
not in a throttled arrival rate).  The load generator records
client-side latency (submit -> result) plus its own scheduling lag so a
saturated host cannot silently masquerade as a fast server.

    python -m cs744_ddp_tpu_torch.serve.demo                 # the GPU
    python -m cs744_ddp_tpu_torch.serve.demo --device cpu --model vgg11 \
        --buckets 1,8 --requests 20
    python -m cs744_ddp_tpu_torch.serve.demo --startup-probe  # ladder only

``--startup-probe`` prints one JSON line with the engine's startup report
(each rung's capture time: a CUDA graph has no serialized form, so every
start is cold).
"""

from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data import cifar10
from ..obs import Telemetry
from ..obs.telemetry import percentile
from .batcher import MicroBatcher, QueueFull
from .engine import BUCKETS, InferenceEngine

# Request-size mixture: mostly singletons and small groups, occasional
# bulk requests — uniform over this tuple (seeded), mean ~8 images.
SIZE_CHOICES = (1, 1, 1, 2, 4, 8, 16, 32)


def request_pool(n_images: int = 2048, seed: int = 123) -> cifar10.Split:
    """A small labeled image pool requests sample from (synthetic split —
    generation is deterministic in ``seed``)."""
    return cifar10._synthetic_split(n_images, seed=seed)


def synthetic_trace(n_requests: int, *, offered_rps: float, seed: int,
                    size_choices: Sequence[int] = SIZE_CHOICES
                    ) -> List[Tuple[float, int]]:
    """Seeded open-loop arrival trace: ``[(t_arrival_s, n_images), ...]``
    with Exp(1/offered_rps) inter-arrivals, t starting at 0."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / offered_rps, size=n_requests)
    gaps[0] = 0.0
    times = np.cumsum(gaps)
    sizes = rng.choice(np.asarray(size_choices, np.int64), size=n_requests)
    return [(float(t), int(s)) for t, s in zip(times, sizes)]


# Priority tiers for the serving-load traces: (tier, weight, slo_ms).
# Tier 0 is interactive (tight SLO, small share), tier 2 is background
# bulk (loose SLO) — the mix Clipper-style shedding is judged against.
DEFAULT_TIERS = ((0, 2, 75.0), (1, 5, 200.0), (2, 3, 600.0))


def synthetic_load_trace(n_requests: int, *, offered_rps: float, seed: int,
                         size_choices: Sequence[int] = SIZE_CHOICES,
                         tiers=DEFAULT_TIERS
                         ) -> List[Tuple[float, int, int, float]]:
    """Seeded tiered open-loop trace ``[(t_s, n_images, tier, slo_ms),...]``
    — ``synthetic_trace`` arrivals with priority tiers drawn from the
    weighted ``tiers`` mixture.  Deterministic in (seed, offered_rps)."""
    base = synthetic_trace(n_requests, offered_rps=offered_rps, seed=seed,
                           size_choices=size_choices)
    rng = np.random.default_rng(seed + 17)
    weights = np.asarray([w for _, w, _ in tiers], np.float64)
    picks = rng.choice(len(tiers), size=n_requests, p=weights / weights.sum())
    return [(t, n, int(tiers[k][0]), float(tiers[k][2]))
            for (t, n), k in zip(base, picks)]


def replay_load(client, trace, *, pool: Optional[cifar10.Split] = None,
                seed: int = 0, drain_timeout_s: float = 120.0) -> dict:
    """Open-loop replay of a tiered load trace against a serving client
    (``LoopbackClient`` or ``FrontendClient`` — anything whose
    ``submit(images, tier=, slo_ms=)`` returns a Future of a reply dict).

    Every submitted request is awaited to a terminal reply — the
    accounting fields (``replies`` == ``n_requests``, ``unresolved`` == 0,
    unique trace ids) are the no-silent-drop CI pin.  Goodput counts only
    requests served WITHIN their SLO (status ``ok``)."""
    pool = pool if pool is not None else request_pool()
    rng = np.random.default_rng(seed + 1)
    batches = [pool.images[rng.integers(0, len(pool.images), size=n)]
               for (_t, n, _tier, _slo) in trace]
    entries = []
    driver_lag_max = 0.0
    t0 = time.time()
    for (t_arr, n, tier, slo_ms), imgs in zip(trace, batches):
        delay = t0 + t_arr - time.time()
        if delay > 0:
            time.sleep(delay)
        else:
            driver_lag_max = max(driver_lag_max, -delay)
        fut = client.submit(imgs, tier=tier, slo_ms=slo_ms)
        entries.append((tier, n, fut))
    hard_deadline = time.time() + drain_timeout_s
    replies = []
    unresolved = 0
    for tier, n, fut in entries:
        try:
            rep = fut.result(timeout=max(0.1, hard_deadline - time.time()))
        except Exception:
            rep, unresolved = None, unresolved + 1
        replies.append((tier, n, rep))
    t_end = time.time()

    tiers_seen = sorted({tier for tier, _n, _r in replies})
    by_tier = {}
    for t in tiers_seen:
        mine = [(n, r) for tier, n, r in replies if tier == t]
        counts = {"offered": len(mine)}
        for status in ("ok", "late", "shed", "overload", "error"):
            counts[status] = sum(1 for _n, r in mine
                                 if r is not None and r["status"] == status)
        counts["attainment"] = round(counts["ok"] / counts["offered"], 4)
        by_tier[t] = counts
    ok = [(tier, n, r) for tier, n, r in replies
          if r is not None and r["status"] == "ok"]
    waits = sorted(r["queue_wait_ms"] for _t, _n, r in ok)
    traces = [r["trace"] for _t, _n, r in replies
              if r is not None and r.get("trace")]
    span = trace[-1][0] if trace else 0.0
    wall = max(t_end - t0, 1e-9)
    out = {
        "n_requests": len(trace),
        "offered_rps": round(len(trace) / max(span, 1e-9), 2),
        "wall_s": round(wall, 3),
        "goodput_rps": round(len(ok) / wall, 2),
        "goodput_ips": round(sum(n for _t, n, _r in ok) / wall, 2),
        "attainment": round(len(ok) / len(trace), 4) if trace else None,
        "by_tier": by_tier,
        "shed": sum(c["shed"] for c in by_tier.values()),
        "overload": sum(c["overload"] for c in by_tier.values()),
        "driver_lag_ms_max": round(driver_lag_max * 1e3, 3),
        # No-silent-drop accounting: one terminal reply per submit, and
        # the served/shed replies carry process-unique trace ids.
        "replies": len(replies) - unresolved,
        "unresolved": unresolved,
        "unique_traces": len(set(traces)),
        "traced": len(traces),
    }
    if waits:
        out["queue_wait_ms"] = {"p50": round(percentile(waits, 50), 3),
                                "p99": round(percentile(waits, 99), 3)}
    return out


def run_demo(engine: InferenceEngine, *, n_requests: int = 200,
             offered_rps: float = 20.0, seed: int = 0,
             max_wait_ms: float = 5.0, max_queue_images: int = 1024,
             pool: Optional[cifar10.Split] = None,
             precision: str = "f32") -> dict:
    """Replay one seeded open-loop trace through the micro-batcher;
    returns the latency/throughput stats sheet."""
    pool = pool if pool is not None else request_pool()
    sizes = tuple(s for s in SIZE_CHOICES if s <= engine.max_batch)
    trace = synthetic_trace(n_requests, offered_rps=offered_rps, seed=seed,
                            size_choices=sizes)
    rng = np.random.default_rng(seed + 1)
    requests = []
    for _, size in trace:
        idx = rng.integers(0, len(pool.images), size=size)
        requests.append((pool.images[idx], pool.labels[idx]))

    results: List[Optional[float]] = [None] * len(trace)
    rejected = 0
    driver_lag_max = 0.0

    def make_cb(i: int, t_submit: float):
        def cb(fut):
            if fut.exception() is None:
                results[i] = time.time() - t_submit
        return cb

    with MicroBatcher(engine, max_wait_ms=max_wait_ms,
                      max_queue_images=max_queue_images,
                      precision=precision) as mb:
        t0 = time.time()
        for i, ((t_arr, _size), (imgs, labs)) in enumerate(
                zip(trace, requests)):
            delay = t0 + t_arr - time.time()
            if delay > 0:
                time.sleep(delay)
            else:
                driver_lag_max = max(driver_lag_max, -delay)
            try:
                fut = mb.submit(imgs, labs)
            except QueueFull:
                rejected += 1
                continue
            fut.add_done_callback(make_cb(i, time.time()))
        # stop() drains the queue before returning.
    t_end = time.time()

    lat_ms = [r * 1e3 for r in results if r is not None]
    total_images = sum(s for _, s in trace)
    done_images = sum(s for (_, s), r in zip(trace, results)
                      if r is not None)
    out = {
        "n_requests": n_requests,
        "offered_rps": offered_rps,
        "seed": seed,
        "max_wait_ms": max_wait_ms,
        "completed": len(lat_ms),
        "rejected": rejected,
        "total_images": total_images,
        "achieved_rps": round(len(lat_ms) / (t_end - t0), 2),
        "images_per_sec": round(done_images / (t_end - t0), 2),
        "driver_lag_ms_max": round(driver_lag_max * 1e3, 3),
    }
    if lat_ms:
        out["latency_ms"] = {
            "p50": round(percentile(lat_ms, 50), 3),
            "p95": round(percentile(lat_ms, 95), 3),
            "p99": round(percentile(lat_ms, 99), 3),
            "mean": round(sum(lat_ms) / len(lat_ms), 3),
            "max": round(max(lat_ms), 3),
        }
    tel = engine.telemetry
    if tel.enabled:
        totals = getattr(tel, "counter_totals", lambda: {})()
        out["bucket_counts"] = {
            k.replace("serve_bucket_", ""): int(v)
            for k, v in sorted(totals.items())
            if k.startswith("serve_bucket_")}
    return out


def parse_buckets(spec: str) -> Tuple[int, ...]:
    return tuple(sorted({int(b) for b in spec.split(",") if b.strip()}))


def startup_probe(model: str, *, buckets=BUCKETS, precisions=("f32",),
                  seed: int = 0, telemetry=None, device=None) -> dict:
    """Build the ladder once and report the startup timing sheet."""
    engine = InferenceEngine(model, buckets=buckets, precisions=precisions,
                             seed=seed, telemetry=telemetry or Telemetry(),
                             device=device)
    return engine.startup()


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser("serve.demo")
    p.add_argument("--startup-probe", action="store_true",
                   help="build the rung ladder, print the startup timing "
                        "report as one JSON line, exit")
    p.add_argument("--model", default="vgg11")
    p.add_argument("--buckets", default=",".join(map(str, BUCKETS)))
    p.add_argument("--precisions", default="f32",
                   help="comma list from {f32, bf16}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--load", type=float, default=20.0,
                   help="offered load, requests/sec (open loop)")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    buckets = parse_buckets(args.buckets)
    precisions = tuple(args.precisions.split(","))
    tel = Telemetry()
    engine = InferenceEngine(args.model, buckets=buckets,
                             precisions=precisions, seed=args.seed,
                             telemetry=tel, device=args.device)
    report = engine.startup()
    if args.startup_probe:
        print(json.dumps(report))
        return 0
    stats = run_demo(engine, n_requests=args.requests,
                     offered_rps=args.load, seed=args.seed,
                     max_wait_ms=args.max_wait_ms, precision=precisions[0])
    print(json.dumps({"startup": report, "demo": stats}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
