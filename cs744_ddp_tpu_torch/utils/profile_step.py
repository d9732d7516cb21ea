"""Where the device time of the VGG-11 ``single`` train step goes, on one GPU.

    python -m cs744_ddp_tpu_torch.utils.profile_step

Runs the Trainer's step exactly as ``Trainer.train_model`` does (batch 256,
augmentation on, loss fetched after every step), warms up, then traces
``STEPS`` steady steps with ``torch.profiler`` and prints: the wall time per
step, the device's busy share of it (union of kernel intervals over wall
time), device time per step by kernel family, each of the port's own
kernels, and the top kernels.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..train import loop

WARMUP = 25
STEPS = 10
# Kernel families by name fragment, first match wins.
FAMILIES = (
    ("bnpool kernels", ("sums_kernel", "dx_kernel")),
    ("convolution", ("conv", "cudnn", "implicit", "gemm", "winograd", "xmma",
                     "cutlass", "wgrad", "dgrad", "sm90", "sm80")),
    ("batch norm", ("batch_norm", "batchnorm", "welford", "bn_")),
    ("max pool", ("max_pool", "maxpool")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("copy", "memcpy", "memset")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> None:
    trainer = loop.Trainer("vgg11", "single", log=lambda s: None)
    batches = loop._train_batches(trainer.train_split, trainer.global_batch,
                                  0, trainer.seed)

    def step() -> float:
        imgs, labs = next(batches)
        x, y = trainer._to_device(imgs, labs)
        return float(trainer.train_step(trainer.state, x, y,
                                        trainer.generator))

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    card = torch.cuda.get_device_name(0)
    print(f"[profile] {card}: {STEPS} steps, wall {wall_us / STEPS / 1e3:.3f}"
          f" ms/step")
    if not kernels:
        print("[profile] the profiler recorded no device events")
        return
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_family = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_family[family(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    print(f"[profile] device busy {busy / STEPS / 1e3:.3f} ms/step = "
          f"{100 * busy / wall_us:.1f}% of wall; idle "
          f"{100 * (1 - busy / wall_us):.1f}%")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile] family {fam}: {us / STEPS / 1e3:.4f} ms/step "
              f"({100 * us / busy:.1f}% of device time)")
    for name, (us, n) in sorted(by_name.items()):
        if family(name) == "bnpool kernels":
            print(f"[profile] bnpool kernel {us / STEPS / 1e3:.4f} ms/step "
                  f"x{n // STEPS}/step  {name[:110]}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"[profile] kernel {us / STEPS / 1e3:.4f} ms/step "
              f"x{n // STEPS}/step  {name[:110]}")


if __name__ == "__main__":
    main()
