"""The yardstick: what a step of a configuration costs, counted from the
architecture's shapes alone, the card's peaks, and the arithmetic that
turns a profiler's kernel intervals into device time.

Nothing here reads a count the program makes: a later change to the
program that fuses or splits operators leaves every number here as it is.
What depends on the architecture comes from its plug-in
(``arch/<architecture>.py``, found under ``root``).

  * ``model_flops_per_image``: 2 x the multiply-accumulates of one
    example's forward (the plug-in's ``macs_per_example``: for the CIFAR
    classifiers every convolution and linear layer of an image), x 3 for
    the forward and the backward pass (the input gradient and the weight
    gradient each cost a forward's MACs).
  * ``bnpool_bwd_bytes``: the bytes the backward of the pool blocks'
    BN -> ReLU -> MaxPool needs: the pre-pool activation read once, the
    pooled gradient read once, dx written once, in the activation dtype;
    and per block and channel gamma, beta and 1/sigma read and the two
    sums written, in f32.
  * ``FAMILIES``, ``family``, ``busy_us``: kernel families by name and the
    union of kernel intervals (copied from the port's
    ``utils/profile_step.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from . import plugins

# NVIDIA H100 SXM data sheet, dense rates at 700 W.  Every precision's MFU
# is taken against the bf16 tensor-core peak, so the yardstick never moves.
H100_BF16_PEAK_FLOPS = 989.4e12
H100_HBM_BYTES_PER_S = 3.35e12

ITEMSIZE = {"f32": 4, "bf16": 2}
_F32 = 4


def model_macs_per_image(config: dict, traffic: dict,
                         root: Path = plugins.ROOT) -> int:
    """Multiply-accumulates of one example's forward pass (an image of the
    CIFAR classifiers), from the architecture's plug-in."""
    return plugins.architecture(config, root).macs_per_example(config,
                                                               traffic)


def model_flops_per_image(config: dict, traffic: dict,
                          root: Path = plugins.ROOT) -> int:
    """2 x MACs x 3 (forward, input gradient, weight gradient)."""
    return 6 * model_macs_per_image(config, traffic, root)


def pool_block_shapes(config: dict, root: Path = plugins.ROOT
                      ) -> List[Tuple[int, int, int]]:
    """(channels, height, width) before each pool of the fused
    BN -> ReLU -> MaxPool blocks; none for an architecture without them."""
    arch = plugins.architecture(config, root)
    return arch.pool_blocks(config) if hasattr(arch, "pool_blocks") else []


def bnpool_bwd_bytes(config: dict, batch: int, precision: str,
                     root: Path = plugins.ROOT) -> int:
    """Bytes one step's pool-block backward needs at ``batch`` rows."""
    s = ITEMSIZE[precision]
    total = 0
    for c, h, w in pool_block_shapes(config, root):
        n = batch * c * h * w
        total += n * s + (n // 4) * s + n * s     # x read, dP read, dx
        total += 5 * c * _F32                     # gamma, beta, 1/sigma; sums
    return total


def bnpool_bwd_bound_s(config: dict, batches: Iterable[int],
                       precision: str, root: Path = plugins.ROOT) -> float:
    """The least time at the HBM rate for the pool-block backward of every
    step in ``batches`` (each step's per-rank rows)."""
    return sum(bnpool_bwd_bytes(config, b, precision, root)
               for b in batches) / H100_HBM_BYTES_PER_S


def mfu_pct(examples_per_s_per_chip: float, config: dict, traffic: dict,
            root: Path = plugins.ROOT) -> float:
    return 100.0 * examples_per_s_per_chip \
        * model_flops_per_image(config, traffic, root) / H100_BF16_PEAK_FLOPS


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


def family_us(kernels: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Device microseconds by family of (name, microseconds) pairs."""
    out: Dict[str, float] = {}
    for name, us in kernels:
        fam = family(name)
        out[fam] = out.get(fam, 0.0) + us
    return out
