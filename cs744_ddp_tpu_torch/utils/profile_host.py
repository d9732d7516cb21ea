"""Where the host-augment path's time goes, on one GPU.

    python -m cs744_ddp_tpu_torch.utils.profile_host [--precision f32|bf16]

VGG-11 ``single``, batch 256, ``--host-augment``, ``host_chunks`` 4:

  * a warmed host windowed epoch of ``STEPS`` steps: the steady step, the
    consumer's wait for each window's chunks (``chunk_wait``) and the
    producer thread's seconds by phase (``Trainer.last_producer_times``:
    the arena fence, the slot claim, the C++ fill, the checksums, the
    copy to the device, the queue);
  * what a replayed window does to other threads, on the device-augment
    window of the same model: how far a pure-Python counting thread gets
    (the interpreter lock) and how long one 3.9 MB pinned host-to-device
    ``copy_(non_blocking=True)`` on a side stream takes to return, each
    while the main thread launches the window's 20 replays and while it
    waits for the window — in ``.cpu()``, polling an event, or in a
    blocking-sync event's ``synchronize`` — against the same time idle;
  * the C++ gather + crop/flip (uint8) and crop/flip/normalize (f32) of
    one batch of 256 at 1, 2, 4 and all threads.
"""

from __future__ import annotations

import argparse
import os
import statistics
import threading
import time

import numpy as np
import torch

from ..data import native
from ..train import loop

STEPS = 100
PROBE_WINDOWS = 3


def producer_breakdown(precision: str) -> None:
    tr = loop.Trainer("vgg11", "single", precision=precision,
                      limit_train_batches=STEPS, host_augment=True,
                      host_chunks=4, log=lambda s: None)
    tr.train_model(0)                   # capture, first epoch
    timers = tr.train_model(1)
    step = 1e3 * statistics.mean(timers.steady_step_times)
    times = {k: round(v, 4) for k, v in tr.last_producer_times.items()}
    print(f"[host] {precision}: steady step {step:.4f} ms; chunk_wait per "
          f"window (s) {[round(v, 4) for v in tr.last_chunk_waits]}; "
          f"producer seconds by phase over {STEPS} batches {times}")


class Probe:
    """A thread that repeats ``op`` and records when each call returned."""

    def __init__(self, op):
        self.op = op
        self.stamps = [time.perf_counter()]
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            self.op()
            self.stamps.append(time.perf_counter())

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()

    def between(self, t0, t1):
        """(calls returned in [t0, t1), the longest gap between returns
        that overlaps it, in ms)."""
        s = np.asarray(self.stamps)
        n = int(((s >= t0) & (s < t1)).sum())
        gaps = [(b - a) for a, b in zip(s[:-1], s[1:]) if b > t0 and a < t1]
        return n, 1e3 * max(gaps, default=0.0)


def interference(precision: str) -> None:
    tr = loop.Trainer("vgg11", "single", precision=precision,
                      limit_train_batches=STEPS, log=lambda s: None)
    window = tr.train_window()
    window(0, 0, loop.WINDOW).cpu()     # capture
    count = [0]

    def tick():
        for _ in range(1000):
            count[0] += 1

    src = torch.empty((5, 256, 32, 32, 3), dtype=torch.uint8,
                      pin_memory=True)
    dst = torch.empty_like(src, device=tr.device)
    side = torch.cuda.Stream(tr.device)

    def copy():
        with torch.cuda.stream(side):
            dst.copy_(src, non_blocking=True)

    for name, op in (("python thread", tick), ("pinned copy_", copy)):
        for wait in ("cpu", "poll", "event"):
            phases = {"launch": [], "wait": [], "idle": []}
            with Probe(op) as probe:
                for _ in range(PROBE_WINDOWS):
                    t0 = time.perf_counter()
                    out = window(0, loop.WINDOW, loop.WINDOW)
                    t1 = time.perf_counter()
                    if wait == "poll":
                        done = torch.cuda.Event()
                        done.record()
                        while not done.query():
                            time.sleep(0.0002)
                    elif wait == "event":
                        done = torch.cuda.Event(blocking=True)
                        done.record()
                        done.synchronize()
                    out.cpu()
                    t2 = time.perf_counter()
                    time.sleep(t2 - t0)
                    t3 = time.perf_counter()
                    for key, a, b in (("launch", t0, t1), ("wait", t1, t2),
                                      ("idle", t2, t3)):
                        phases[key].append((b - a,) + probe.between(a, b))
            cells = []
            for key, rows in phases.items():
                ms = 1e3 * sum(r[0] for r in rows)
                calls = sum(r[1] for r in rows)
                gap = max(r[2] for r in rows)
                cells.append(f"{key} {ms:.1f} ms: {calls} returns, longest "
                             f"gap {gap:.2f} ms")
            how = {"cpu": ".cpu()", "poll": "event polling",
                   "event": "a blocking event's synchronize"}[wait]
            print(f"[interference] {precision} window, main thread waits "
                  f"by {how}; {name}: " + "; ".join(cells))
    torch.cuda.synchronize()


def fill_threads() -> None:
    split = loop.cifar10.load("./data")[0]
    rng = np.random.default_rng(0)
    default = native._nthreads(256)
    lib = native.load_library()
    u8 = np.empty((256, 32, 32, 3), np.uint8)
    f32 = np.empty((256, 32, 32, 3), np.float32)
    mean = np.ascontiguousarray(loop.cifar10.MEAN, np.float32)
    std = np.ascontiguousarray(loop.cifar10.STD, np.float32)
    p = native._ptr
    c = native.ctypes

    def gather_augment(cols, off, fl, n):
        lib.fl_gather_augment_u8(
            p(split.images, c.c_uint8), p(cols, c.c_int64), 256,
            p(off, c.c_int32), p(fl, c.c_uint8), p(u8, c.c_uint8), n)

    def augment(cols, off, fl, n):
        imgs = split.images[cols]
        lib.fl_augment_f32(p(imgs, c.c_uint8), 256, p(off, c.c_int32),
                           p(fl, c.c_uint8), p(mean, c.c_float),
                           p(std, c.c_float), p(f32, c.c_float), n)

    for name, fn in (("fl_gather_augment_u8", gather_augment),
                     ("fl_augment_f32", augment)):
        for n in sorted({1, 2, 4, 8, len(os.sched_getaffinity(0))}):
            ts = []
            for _ in range(40):
                cols = np.ascontiguousarray(
                    rng.integers(0, len(split.labels), 256), np.int64)
                off = rng.integers(0, 9, (256, 2), dtype=np.int32)
                fl = rng.integers(0, 2, 256, dtype=np.uint8)
                t0 = time.perf_counter()
                fn(cols, off, fl, n)
                ts.append(time.perf_counter() - t0)
            print(f"[fill] {name}, one batch of 256 at {n} thread(s): "
                  f"median {1e3 * statistics.median(ts[5:]):.3f} ms "
                  f"(the wrappers use {default}; os.cpu_count "
                  f"{os.cpu_count()}, affinity "
                  f"{len(os.sched_getaffinity(0))})")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--precision", default=None,
                        choices=sorted(loop.PRECISIONS),
                        help="one precision (default: both)")
    args = parser.parse_args(argv)
    print(f"[host] {torch.cuda.get_device_name(0)}")
    fill_threads()
    for precision in ([args.precision] if args.precision
                      else sorted(loop.PRECISIONS)):
        producer_breakdown(precision)
        interference(precision)


if __name__ == "__main__":
    main()
