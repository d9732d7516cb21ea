"""Where the serving tier's time goes under an open-loop load, on the card.

    python -m cs744_ddp_tpu_torch.utils.profile_serve_tier [--requests N]
        [--rps R [R ...]]

Builds two VGG-11 f32 ``EngineReplica``s with seed-0 weights and the
default buckets, replica i on card ``i % device_count`` as the CLI places
them, captures every ladder, warms each replica's service model, and puts
them behind the router and a ``ServingFrontend`` on localhost.  A
``FrontendClient`` then replays the seeded ``DEFAULT_TIERS`` trace of N
(4000) requests at each rate R (2000 rps), in turn: pipeline on under
``torch.profiler``, pipeline on without it (the profiler's own cost),
pipeline off, replica 0 alone, pipeline on with the interpreter's switch
interval at ``SWITCH_MS`` (0.5 ms, against 5), and pipeline on and off
with the client in another process (``python -m
cs744_ddp_tpu_torch.serve.load replay``), so that the client's encoding,
reader and pacing leave the server's interpreter (there the "driver"
group is the main thread sampling the threads' CPU).
For each load it prints the client's round trip by percentile (in-process
loads), the server's latency from the router's arrival to the device's
result, the achieved rate, the driver's lag, the dispatches and their
images, the median host time of a staging, and three shares of the
load's wall time:

  * the device's busy share, by card: the union of the kernels' intervals
    that ``torch.profiler`` recorded over the load (copies excluded: the
    copy engines run beside the kernels);
  * the replicas' host busy share: their schedulers' ``serve_service_ms``
    (an in-memory ``Telemetry``) over the wall.  It is the scheduler's
    clock on the host, so it holds the workers' waits for the interpreter
    lock as well as the device's work;
  * the CPU seconds of each group of threads over the wall
    (``/proc/self/task``): the schedulers' workers, the front-end's
    connection threads, the client's reader, the load driver (the main
    thread) and the rest (native threads).  Threads that hold the
    interpreter lock cannot sum past 1.0 of Python work; a fence wait
    spins in the CUDA driver without the lock, and counts here too.

``run_load``, ``warm`` and ``describe`` are also what ``chip_smoke.py``'s
``serve_tier`` phase drives and prints its loads with.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import Telemetry, percentile
from ..serve import (EngineReplica, FrontendClient, ReplicaRouter,
                     ServingFrontend, demo)
from .profile_step import busy_us
from .profile_telemetry import card

WARM = 3                        # dispatches a bucket a replica, before loads
REPLICAS = 2
SWITCH_MS = 0.5
SEED = 0
THREAD_GROUPS = (("slo-sched", "workers"), ("serve-conn", "front-end"),
                 ("serve-accept", "front-end"),
                 ("serve-client", "client reader"),
                 ("MainThread", "driver"))


class Recorder:
    """A serving client that records each request it submits: its images
    and tier, the submit and reply times on the host's clock, and its
    reply (``demo.replay_load`` drives it like any client)."""

    def __init__(self, client):
        self.client = client
        self.sent: List[dict] = []

    def submit(self, images, *, tier=0, slo_ms=None):
        entry = {"images": images, "tier": tier, "t0": time.perf_counter()}
        fut = self.client.submit(images, tier=tier, slo_ms=slo_ms)

        def done(f, e=entry):
            e["t1"] = time.perf_counter()
            e["reply"] = f.result()
        fut.add_done_callback(done)
        self.sent.append(entry)
        return fut


def devices(n: int) -> List[torch.device]:
    """Replica i on card ``i % count``, as the CLI places them."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def warm(replicas, pool, rng, per_bucket: int = WARM) -> None:
    """``per_bucket`` dispatches of each bucket on each replica, one at a
    time: the service model's first reads."""
    for rep in replicas:
        with rep:
            for b in rep.engine.buckets:
                for _ in range(per_bucket):
                    idx = rng.integers(0, len(pool.images), b)
                    fut = rep.scheduler.submit(pool.images[idx])
                    if fut.result(120).status != "ok":
                        raise RuntimeError(f"replica {rep.index} warm-up: "
                                           f"bucket {b} not served ok")


def _task_cpu() -> Dict[int, tuple]:
    """(thread name, CPU seconds, user + system) of each of this
    process's threads, by native id."""
    tick = os.sysconf("SC_CLK_TCK")
    names = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:          # the thread ended meanwhile
            continue
        out[int(tid)] = (names.get(int(tid), ""),
                         (int(fields[11]) + int(fields[12])) / tick)
    return out


def _thread_groups(before: Dict[int, tuple], after: Dict[int, tuple],
                   wall: float) -> Dict[str, float]:
    shares: Dict[str, float] = {}
    for tid, (name, cpu) in after.items():
        group = next((g for prefix, g in THREAD_GROUPS
                      if name.startswith(prefix)), "other")
        shares[group] = shares.get(group, 0.0) \
            + (cpu - before.get(tid, ("", 0.0))[1]) / wall
    return {k: round(v, 4) for k, v in sorted(shares.items())}


def _device_busy(prof, wall_us: float) -> Dict[int, float]:
    """Each card's busy share of ``wall_us``: the union of its kernels'
    intervals in the profiler's records."""
    from torch.autograd import DeviceType
    spans: Dict[int, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and not e.name.startswith(("Memcpy", "Memset")):
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    if not spans:
        raise RuntimeError("the profiler recorded no kernel over the load")
    return {d: round(busy_us(s) / wall_us, 4) for d, s in sorted(spans.items())}


def run_load(replicas: Sequence[EngineReplica], trace, *, pool, seed: int,
             telemetry: Telemetry, profile: bool = True,
             sync_debug: bool = False) -> dict:
    """One open-loop replay of ``trace`` through a router over
    ``replicas`` (which record into ``telemetry``, in memory) and a
    ``ServingFrontend`` on localhost, by a ``FrontendClient`` behind a
    ``Recorder``; under ``torch.profiler`` when ``profile``, and with
    ``torch.cuda.set_sync_debug_mode("error")`` over the replay when
    ``sync_debug``.  Returns ``stats`` (``replay_load``'s), ``sent`` (the
    recorder's entries), ``served`` ({trace: (replica, bucket)}),
    ``dispatches`` ([(replica, bucket)]), ``wall_s``,
    ``images_a_dispatch``, ``server_ms`` (the schedulers'
    ``serve_latency_ms``: router arrival to device ready), ``device_busy``
    ({card: share}, None unprofiled), ``host_busy`` (a share a replica),
    ``stage_ms`` (the engines' ``serve_stage`` spans, median host ms),
    ``threads`` ({group: CPU share}) and ``router`` (its stats)."""
    from torch.profiler import ProfilerActivity, profile as profiler
    first = len(telemetry.records)
    router = ReplicaRouter(replicas)
    traced = (profiler(activities=[ProfilerActivity.CUDA]) if profile
              else contextlib.nullcontext())
    with router, ServingFrontend(router) as fe, \
            FrontendClient(fe.address) as client, traced as prof:
        rec = Recorder(client)
        if sync_debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            cpu0 = _task_cpu()
            t0 = time.perf_counter()
            stats = demo.replay_load(rec, trace, pool=pool, seed=seed)
            wall = time.perf_counter() - t0
            threads = _thread_groups(cpu0, _task_cpu(), wall)
        finally:
            if sync_debug:
                torch.cuda.set_sync_debug_mode("default")
    out = _summarize(telemetry.records[first:], replicas, wall, prof)
    out.update(stats=stats, sent=rec.sent, threads=threads,
               router=router.stats())
    return out


def run_external(replicas: Sequence[EngineReplica], *, rps: float,
                 requests: int, seed: int, telemetry: Telemetry) -> dict:
    """The same load from another process: the router over ``replicas``
    and a ``ServingFrontend`` here, under ``torch.profiler``, and
    ``python -m cs744_ddp_tpu_torch.serve.load replay`` of the seeded
    trace against it, so the client's encoding, reader and pacing run on
    their own interpreter.  The shares are over the load's window on the
    server's clock (first arrival to last completion, from the
    ``serve_latency_ms`` records); ``stats`` is the client's JSON line.
    Returns ``run_load``'s keys but ``sent``."""
    from torch.profiler import ProfilerActivity, profile as profiler
    first = len(telemetry.records)
    router = ReplicaRouter(replicas)
    cmd = [sys.executable, "-m", "cs744_ddp_tpu_torch.serve.load", "replay",
           "--requests", str(requests), "--rps", str(rps), "--seed",
           str(seed), "--max-size", str(replicas[0].engine.max_batch)]
    with router, ServingFrontend(router) as fe, \
            profiler(activities=[ProfilerActivity.CUDA]) as prof:
        cpu0 = _task_cpu()
        proc = subprocess.Popen(cmd + ["--port", str(fe.address[1])],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        # Sampled while the client runs: a connection thread's counts
        # leave /proc with the thread when the client hangs up.
        cpu1 = {}
        while proc.poll() is None:
            cpu1.update(_task_cpu())
            time.sleep(0.05)
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"load replay exited {proc.returncode}: "
                               f"{stderr[-2000:]}")
    records = telemetry.records[first:]
    lat = [r for r in records if r.get("name") == "serve_latency_ms"]
    window = max(r["t"] for r in lat) \
        - min(r["t"] - r["value"] / 1e3 for r in lat)
    out = _summarize(records, replicas, window, prof)
    out.update(stats=json.loads(stdout.strip().splitlines()[-1]),
               threads=_thread_groups(cpu0, cpu1, window),
               router=router.stats())
    return out


def _summarize(records, replicas, wall: float, prof) -> dict:
    """What a load's telemetry records and profiler say; see run_load."""
    served, dispatches = {}, []
    busy = {rep.index: 0.0 for rep in replicas}
    for r in records:
        if r.get("name") == "serve_service_ms":
            for t in r["traces"]:
                served[t] = (r["replica"], r["bucket"])
            dispatches.append((r["replica"], r["bucket"]))
            busy[r["replica"]] += r["value"] / 1e3

    def named(name, key):
        return [r[key] for r in records if r.get("name") == name]
    stage = named("serve_stage", "dur_s")
    images = named("serve_dispatch", "n")
    return {
        "served": served, "dispatches": dispatches, "wall_s": wall,
        "images_a_dispatch": sum(images) / max(len(images), 1),
        "server_ms": named("serve_latency_ms", "value"),
        "device_busy": (_device_busy(prof, wall * 1e6)
                        if prof is not None else None),
        "host_busy": [round(busy[rep.index] / wall, 4) for rep in replicas],
        "stage_ms": 1e3 * statistics.median(stage) if stage else None,
    }


def latency_ms(sent, statuses=("ok", "late")) -> Dict[int, List[float]]:
    """Client round trips in ms of the replies in ``statuses``, by tier."""
    by_tier: Dict[int, List[float]] = {}
    for e in sent:
        if e["reply"]["status"] in statuses:
            by_tier.setdefault(e["tier"], []).append(
                1e3 * (e["t1"] - e["t0"]))
    return by_tier


def describe(out: dict, buckets: Sequence[int]) -> str:
    """One load's numbers on one line."""
    st, wall = out["stats"], out["wall_s"]
    counts = {k: sum(c[k] for c in st["by_tier"].values())
              for k in ("ok", "late", "shed", "overload")}
    parts = [f"{st['n_requests']} requests at {st['offered_rps']} rps in "
             f"the trace"]
    if "sent" in out:
        by_tier = latency_ms(out["sent"])
        every = [v for vs in by_tier.values() for v in vs]
        parts.append(
            f"latency (client round trip, served) all p50 "
            f"{percentile(every, 50):.3f} p95 {percentile(every, 95):.3f} "
            f"p99 {percentile(every, 99):.3f} ms; " + "; ".join(
                f"tier {t} ({len(v)} served) p50 {percentile(v, 50):.3f} "
                f"p95 {percentile(v, 95):.3f} p99 {percentile(v, 99):.3f} ms"
                for t, v in sorted(by_tier.items())))
    server = out["server_ms"]
    disp = out["dispatches"]
    stage = out["stage_ms"]
    parts += [
        f"server latency (router arrival to device ready) p50 "
        f"{percentile(server, 50):.3f} p99 {percentile(server, 99):.3f} ms",
        f"attainment {st['attainment']} (by tier "
        f"{ {t: c['attainment'] for t, c in st['by_tier'].items()} }), ok "
        f"{counts['ok']}, late {counts['late']}, shed {counts['shed']}, "
        f"overload {counts['overload']}",
        f"achieved {(counts['ok'] + counts['late']) / st['wall_s']:.1f} "
        f"rps over the client's {st['wall_s']} s, driver_lag_ms_max "
        f"{st['driver_lag_ms_max']}",
        f"router routed {out['router']['routed']}, failovers "
        f"{out['router']['failovers']}",
        f"over the {wall:.3f} s window: device busy share by card "
        f"(kernels' union, torch.profiler) "
        f"{out['device_busy'] if out['device_busy'] is not None else 'not measured'}, "
        f"host busy share by replica (service clock) {out['host_busy']}, "
        f"thread CPU {out['threads']}",
        f"{len(disp)} dispatches, by replica "
        f"{ {i: sum(d[0] == i for d in disp) for i in sorted({d[0] for d in disp})} }, "
        f"{out['images_a_dispatch']:.1f} images a dispatch, by bucket "
        f"{ {b: sum(d[1] == b for d in disp) for b in buckets} }",
        f"serve_stage median "
        f"{'%.3f ms' % stage if stage is not None else 'none'} on the host"]
    return "; ".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4000)
    ap.add_argument("--rps", type=float, nargs="+", default=[2000.0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    line = card()
    tel = Telemetry()
    replicas = [EngineReplica(i, "vgg11", device=d, telemetry=tel, seed=0)
                for i, d in enumerate(devices(REPLICAS))]
    for rep in replicas:
        report = rep.startup()
        print(f"replica {rep.index} on {rep.engine.device}: ladder "
              f"{rep.engine.buckets} captured in {report['startup_s']:.3f} s"
              f"  [{line}]", flush=True)
    pool = demo.request_pool()
    warm(replicas, pool, np.random.default_rng(12))
    buckets = replicas[0].engine.buckets
    sizes = tuple(s for s in demo.SIZE_CHOICES if s <= buckets[-1])
    switch = sys.getswitchinterval()
    for rps in args.rps:
        trace = demo.synthetic_load_trace(args.requests, offered_rps=rps,
                                          seed=SEED, size_choices=sizes)
        loads = [("pipeline on", replicas, True, "profiled", switch),
                 ("pipeline on, unprofiled", replicas, True, "unprofiled",
                  switch),
                 ("pipeline off", replicas, False, "profiled", switch),
                 ("pipeline on, replica 0 alone", replicas[:1], True,
                  "profiled", switch)]
        loads.append((f"pipeline on, switch interval {SWITCH_MS:g} ms",
                      replicas, True, "profiled", SWITCH_MS / 1e3))
        loads += [(f"pipeline {'on' if p else 'off'}, the client in another "
                   f"process", replicas, p, "external", switch)
                  for p in (True, False)]
        for label, serving, pipeline, mode, interval in loads:
            for rep in replicas:
                rep.scheduler.pipeline = pipeline
            sys.setswitchinterval(interval)
            try:
                if mode == "external":
                    out = run_external(serving, rps=rps,
                                       requests=args.requests,
                                       seed=SEED, telemetry=tel)
                else:
                    out = run_load(serving, trace, pool=pool, seed=SEED,
                                   telemetry=tel,
                                   profile=mode == "profiled")
            finally:
                sys.setswitchinterval(switch)
            print(f"{rps:g} rps, {label}, {len(serving)} replica(s): "
                  f"{describe(out, buckets)}  [{line}]", flush=True)


if __name__ == "__main__":
    main()
