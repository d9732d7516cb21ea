"""Rank 0's device-busy milliseconds over the traced epoch outside the
convolution, collective and bnpool kernel families, per step of a full
per-rank batch: the augment, the casts, library BN, the fused op's
forward, the loss, the f32 SGD."""

LAYER = "train step (train/step.py, ops/sgd.py, ops/loss.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"
APART = ("convolution", "collectives", "bnpool kernels")


def read(ctx):
    fams = ctx.trace["families"]
    us = ctx.trace["busy_us"] - sum(fams.get(f, 0.0) for f in APART)
    return us / 1e3 / ctx.steps if ctx.trace["busy_us"] > 0 else None
