r"""What does the non-finite guard cost a windowed step, and where?

    python -m cs744_ddp_tpu_torch.utils.profile_guard [--precision bf16]

VGG-11 ``single``, batch 256, windowed, four Trainers on the card: the
guard off, and ``--nonfinite skip`` (no fault) with three ways of keeping
the prior state, by ``ft/guard.py::StepGuard.SMALL``:

  * ``split``: the parameters under ``SMALL`` elements (and their
    momentum) join the buffers' flat snapshot, the others take a
    ``where`` each (the default);
  * ``where``: every parameter takes a ``where`` (``SMALL = 0``);
  * ``snapshot``: every parameter joins the snapshot (``SMALL`` above
    any size).

Each Trainer's steady step (``steady_state_throughput``, 20-step windows)
is timed in turns, four times each (off, split, where, snapshot, then
backwards, twice); then one replayed window of the guard off and of
``split`` is traced with ``torch.profiler`` and the kernels whose count
or device time a step differs are listed.
"""

from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..ft import FTConfig
from ..ft.guard import StepGuard
from ..train import loop

WINDOW = 20
VARIANTS = {"split": StepGuard.SMALL, "where": 0, "snapshot": 1 << 62}


def device_kernels(window) -> dict:
    """{kernel name: [runs, device us]} over one replayed window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.25)
        window(0, WINDOW, WINDOW).cpu()
        time.sleep(0.25)
    out = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name[:100]][0] += 1
            out[e.name[:100]][1] += e.time_range.elapsed_us()
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--precision", default="f32",
                        choices=sorted(loop.PRECISIONS))
    args = parser.parse_args(argv)
    card = torch.cuda.get_device_name(0)

    def trainer(ft=None):
        return loop.Trainer("vgg11", "single", precision=args.precision,
                            limit_train_batches=3 * WINDOW,
                            log=lambda s: None, ft=ft)

    trainers = {"off": trainer()}
    for name, small in VARIANTS.items():
        StepGuard.SMALL = small
        trainers[name] = trainer(FTConfig(nonfinite="skip"))
    StepGuard.SMALL = VARIANTS["split"]
    order = list(trainers) + list(trainers)[::-1]
    ms = {k: [] for k in trainers}
    for k in order + order:
        ips, _ = trainers[k].steady_state_throughput(
            max_iters=2 * WINDOW, window_iters=WINDOW)
        ms[k].append(1e3 * trainers[k].global_batch / ips)
    off = statistics.median(ms["off"])
    for k, v in ms.items():
        print(f"[guard] {card}: vgg11 {args.precision} {k:8s} steady step "
              f"median {statistics.median(v):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in v)}); "
              f"{statistics.median(v) - off:+.4f} ms against off")

    prof = {k: device_kernels(trainers[k].train_window())
            for k in ("off", "split")}
    for k, kernels in prof.items():
        print(f"[guard] {card}: {k:5s} a step: "
              f"{sum(n for n, _ in kernels.values()) / WINDOW:.1f} kernels, "
              f"{sum(us for _, us in kernels.values()) / WINDOW:.2f} us "
              f"of device time")
    rows = []
    for name in set(prof["off"]) | set(prof["split"]):
        (n0, t0), (n1, t1) = (prof[k].get(name, (0, 0.0))
                              for k in ("off", "split"))
        if n0 != n1 or abs(t1 - t0) > 5 * WINDOW:
            rows.append(((t1 - t0) / WINDOW, n0 / WINDOW, n1 / WINDOW,
                         name))
    for dt, n0, n1, name in sorted(rows, reverse=True):
        print(f"[guard]   {dt:+8.2f} us a step, runs {n0:5.1f} -> "
              f"{n1:5.1f}: {name}")


if __name__ == "__main__":
    main()
