"""PyTorch/CUDA port of the CS744 data-parallel CIFAR-10 trainer.

The JAX package ``cs744_ddp_tpu`` is the reference; this package mirrors
its module names (``data/``, ``ops/``, ``models/``, ``train/``,
``utils/``) so each port module has an obvious counterpart.  It imports
neither ``jax`` nor anything of the reference package.

Entry points run on the GPU (``cuda``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise
(``device.resolve_device``).  The fused BN->ReLU->MaxPool backward runs two
hand-written CUDA kernels (``ops/csrc/bnpool.cu``) on CUDA tensors and their
plain PyTorch version on CPU tensors.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # ``resolve_device`` is imported on first use, so that a module that
    # needs no torch (the run-directory report, ``obs/report.py``) starts
    # without loading it.
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
