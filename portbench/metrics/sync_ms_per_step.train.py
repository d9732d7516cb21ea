"""Rank 0's device milliseconds in NCCL kernels over the traced epoch, per
step of a full per-rank batch: the gradient sync's collectives, waiting
for the peers included.  Nothing to read on one rank."""

LAYER = "gradient sync (parallel/strategies.py, bucketing.py, mesh.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.traffic["world"] == 1:
        return None
    us = ctx.trace["families"].get("collectives", 0.0)
    return us / 1e3 / ctx.steps if us > 0 else None
