r"""Does ``torch.profiler`` see every kernel run of a replayed window?

    KINETO_LOG_LEVEL=0 \
      python -m cs744_ddp_tpu_torch.utils.profile_window_counts \
      [--reps 10] [--window 20] 2> kineto.log

Trains ``single`` (VGG-11, batch 256) for one window, which captures the
step, then traces more windows of replays in three ways, ``--reps`` times
each, and prints per trace the runs of each bnpool kernel that the trace
holds against those the kernels counted on the device:

  * ``schedule``: CPU and CUDA activity, ``schedule(warmup=1, active=1)``,
    one window traced as warm-up and the next as the active step;
  * ``plain``: CUDA activity only, the profiler started and stopped around
    one window;
  * ``padded``: as ``plain``, with ``PAD_S`` of idle host time traced
    before and after the window (``chip_smoke.py``'s check).

With ``KINETO_LOG_LEVEL=0`` kineto logs, per trace, ``Record counts:
Out-of-range = N``: the records it dropped as stamped outside the traced
span.
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from ..ops import bnpool
from ..train import loop

PAD_S = 0.25


def traced(prof) -> dict:
    names = Counter(e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    seen = bnpool.profiled_runs(names)
    seen["device events"] = sum(names.values())
    return seen


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--window", type=int, default=20)
    args = parser.parse_args(argv)
    w = args.window
    trainer = loop.Trainer("vgg11", "single", limit_train_batches=w,
                           log=lambda s: None)
    window = trainer.train_window()
    window(0, 0, w).cpu()                       # warm-up and capture
    card = torch.cuda.get_device_name(0)
    short = Counter()
    for rep in range(args.reps):
        for how in ("schedule", "plain", "padded"):
            torch.cuda.synchronize()
            if how == "schedule":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1)) as prof:
                    window(0, 0, w).cpu()
                    prof.step()
                    bnpool.reset_launch_counts()
                    window(0, 0, w).cpu()
                    prof.step()
            else:
                pad = PAD_S if how == "padded" else 0.0
                bnpool.reset_launch_counts()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    time.sleep(pad)
                    window(0, 0, w).cpu()
                    time.sleep(pad)
            seen, runs = traced(prof), bnpool.executed_counts()
            missing = any(seen[k] != runs[k] for k in runs)
            short[how] += missing
            print(f"[profile counts] {card}: {how:8s} trace {rep}: {seen}; "
                  f"counted on the device {runs}"
                  f"{'  SHORT' if missing else ''}", flush=True)
    print(f"[profile counts] {card}: short traces of {args.reps}, "
          f"{w}-step windows: {dict(short)}")


if __name__ == "__main__":
    main()
