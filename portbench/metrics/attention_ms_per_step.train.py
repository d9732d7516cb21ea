"""Rank 0's device milliseconds in the fused attention kernels (forward
and backward) over the traced epoch, per step of a full per-rank batch.
The kernels are found by name: on the H100 the program's attention runs on
PyTorch's cuDNN backend (``cudnn_generated_fort_native_sdpa_sm90_flash_
fprop_...`` and ``..._bprop_...``, with the backward's
``cudnn::fusion::compute_dot_do_o`` and ``convert_dq_to_16bits``); the
names of its flash and memory-efficient backends are listed too.  Nothing
to read where none ran."""

LAYER = "attention (models/moonlight.py MLA)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"
KERNELS = ("fort_native_sdpa", "cudnn::fusion::compute_dot_do_o",
           "cudnn::fusion::convert_dq_to_16bits", "flash_fwd", "flash_bwd",
           "fmha_cutlass")


def read(ctx):
    us = sum(v[0] for name, v in ctx.trace["kernels"].items()
             if any(k in name for k in KERNELS))
    return us / 1e3 / ctx.steps if us > 0 else None
