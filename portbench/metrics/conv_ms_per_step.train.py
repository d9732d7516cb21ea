"""Rank 0's device milliseconds in the convolution family (cuDNN's
convolution and GEMM kernels) over the traced epoch, per step of a full
per-rank batch."""

LAYER = "model (models/vgg.py, models/resnet.py, models/layers.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    us = ctx.trace["families"].get("convolution", 0.0)
    return us / 1e3 / ctx.steps if us > 0 else None
