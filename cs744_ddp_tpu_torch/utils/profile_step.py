"""Where the device time of a train step goes, on one GPU.

    python -m cs744_ddp_tpu_torch.utils.profile_step [--strategy NAME]
        [--model vgg11|vgg13|vgg16|vgg19|resnet18|resnet34]
        [--precision f32|bf16] [--elastic strong] [--deterministic]

Runs the Trainer's step of ``--model`` (VGG-11 by default) in
``--precision`` with the given strategy (``single`` by default; any
other runs at world 1, over NCCL in a world-1 group, so its collectives are
in the trace), batch 256, augmentation on, along both of the Trainer's
paths: the per-step path (one eager step per batch, its loss fetched after
it) and the windowed path (one window of ``STEPS`` replays of the captured
step, one fetch).  Each is warmed up, then ``STEPS`` steady steps are traced
with ``torch.profiler``, and it prints: the wall time per step, the
device's busy share of it (union of kernel intervals over wall time),
device time per step by kernel family, each of the port's own kernels, and
the top kernels.  A model with no pool block (the ResNets) runs no bnpool
kernel: its bnpool family is reported absent, not as zero time.
``--elastic strong``: the window's step is the elastic microshard step
(``elastic/step_elastic.py``; it has no per-step path, so only the
windowed path is traced, with deterministic cuDNN, which the protocol
turns on); ``--deterministic``: deterministic cuDNN for the others, to
compare with it.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.layers import BnReluPool2d
from ..train import loop

WARMUP = 25
STEPS = 10
# Kernel families by name fragment, first match wins: cuDNN's own batch
# norm and layout kernels are named ``cudnn::...`` too, so they are
# matched before the convolutions.
FAMILIES = (
    ("bnpool kernels", ("sums_kernel", "dx_kernel")),
    ("collectives", ("nccl",)),
    ("batch norm", ("batch_norm", "batchnorm", "welford", "bn_")),
    ("layout transpose", ("nhwctonchw", "nchwtonhwc")),
    ("convolution", ("conv", "cudnn", "implicit", "gemm", "winograd", "xmma",
                     "cutlass", "wgrad", "dgrad", "sm90", "sm80", "fft")),
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


def report(label: str, run, steps: int, pool_blocks: bool = True) -> None:
    """Trace ``run()``, which trains ``steps`` steps and fetches, and print
    the wall time per step, the device's busy share, device time per step
    by kernel family, the port's own kernels and the top kernels.
    ``pool_blocks``: whether the model has the fused op's blocks (else
    the bnpool family is reported absent)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"[profile] {label}: {steps} steps, wall "
          f"{wall_us / steps / 1e3:.3f} ms/step")
    if not kernels:
        print(f"[profile] {label}: the profiler recorded no device events")
        return
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_family = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_family[family(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    print(f"[profile] {label}: device busy {busy / steps / 1e3:.3f} ms/step "
          f"= {100 * busy / wall_us:.1f}% of wall; idle "
          f"{100 * (1 - busy / wall_us):.1f}%; {len(kernels) // steps} "
          f"kernels/step")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: family {fam}: {us / steps / 1e3:.4f} "
              f"ms/step ({100 * us / busy:.1f}% of device time)")
    if not pool_blocks:
        print(f"[profile] {label}: family bnpool kernels: absent (the "
              f"model has no pool block)")
    for name, (us, n) in sorted(by_name.items()):
        if family(name) == "bnpool kernels":
            print(f"[profile] {label}: bnpool kernel {us / steps / 1e3:.4f} "
                  f"ms/step x{n // steps}/step  {name[:110]}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"[profile] {label}: kernel {us / steps / 1e3:.4f} ms/step "
              f"x{n // steps}/step  {name[:110]}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--strategy", default="single",
                        choices=loop.STRATEGIES)
    parser.add_argument("--model", default="vgg11",
                        help="any name of the model zoo")
    parser.add_argument("--precision", default="f32",
                        choices=sorted(loop.PRECISIONS))
    parser.add_argument("--elastic", choices=["strong"], default=None)
    parser.add_argument("--deterministic", action="store_true")
    args = parser.parse_args(argv)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
    trainer = loop.Trainer(args.model, args.strategy,
                           precision=args.precision, log=lambda s: None,
                           elastic=args.elastic)
    pools = any(isinstance(m, BnReluPool2d)
                for m in trainer.state.model.modules())
    head = (f"{torch.cuda.get_device_name(0)}, {args.model}, "
            f"{args.precision}"
            + (", --elastic strong" if args.elastic else "")
            + (", deterministic cuDNN" if
               torch.backends.cudnn.deterministic else ""))
    batches = enumerate(loop._train_batches(
        trainer.train_split, trainer.global_batch, 0, trainer.seed))

    def step() -> float:
        it, (imgs, labs) = next(batches)
        x, y = trainer._to_device(imgs, labs)
        return float(trainer.train_step(trainer.state, x, y, 0, it))

    def steps() -> None:
        for _ in range(STEPS):
            step()

    if args.elastic is None:
        for _ in range(WARMUP):
            step()
        report(f"{head}, {args.strategy}, per-step path", steps, STEPS,
               pools)

    window = trainer.train_window()
    for start in range(0, WARMUP, STEPS):       # capture, then warm
        window(0, start, STEPS).cpu()
    report(f"{head}, {args.strategy}, windowed path (graph replays)",
           lambda: window(0, WARMUP, STEPS).cpu(), STEPS, pools)
    print(f"[profile] {head}, {args.strategy}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():   # the Trainer's world-1 group
            torch.distributed.destroy_process_group()
