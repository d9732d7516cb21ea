"""The experts' grouped products against their roofline: the FLOPs of
every product the program ran in the traced epoch (``counters["moe"]
["flops"]``: 2 x the held rows x K x N of each run, the backward's
recomputed forward included, counted on the device) over rank 0's device
time in the kernels named here x the bf16 dense peak.  The products are
the library's grouped GEMM (``torch._grouped_mm``): CUTLASS's grouped
kernel, whose name holds its problem shape's type, and the kernel that
lays out each group's problem from the device offsets.  At the cell's
shapes the products are compute-bound.  Nothing to read where no such
kernel ran."""

from portbench import yardstick

LAYER = "expert kernels (ops/moe.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_images_per_s"
SOURCE = "device_trace"
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(ctx):
    flops = ctx.trace["counters"].get("moe", {}).get("flops", 0)
    us = sum(v[0] for name, v in ctx.trace["kernels"].items()
             if any(k in name for k in KERNELS))
    if flops <= 0 or us <= 0:
        return None
    return 100.0 * flops / (us / 1e6 * yardstick.H100_BF16_PEAK_FLOPS)
