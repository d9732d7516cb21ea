"""The pool blocks' BN -> ReLU -> MaxPool backward against its roofline:
the least time of the operation's bytes at the HBM rate
(``yardstick.bnpool_bwd_bytes``, from the pool blocks' shapes at each
traced step's per-rank rows) over rank 0's device time in the kernels
named here, over the traced epoch.  Nothing to read where no such kernel
ran (an architecture without pool blocks)."""

from portbench import yardstick

LAYER = "kernels (ops/bnpool.py, ops/csrc/bnpool.cu)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_images_per_s"
SOURCE = "device_trace"
KERNELS = ("sums_kernel", "dx_kernel")


def read(ctx):
    us = sum(v[0] for name, v in ctx.trace["kernels"].items()
             if any(k in name for k in KERNELS))
    if us <= 0:
        return None
    bound_s = yardstick.bnpool_bwd_bound_s(
        ctx.config, ctx.step_batches, ctx.traffic["precision"], ctx.root)
    return 100.0 * bound_s / (us / 1e6)
