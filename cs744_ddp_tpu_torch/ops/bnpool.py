"""Fused BatchNorm(train) -> ReLU -> MaxPool2x2/2 in CUDA kernels.

The counterpart of the reference package's ``ops/bnpool_pallas.py``.  On
CUDA tensors the forward is two hand-written CUDA kernels
(``csrc/bnpool.cu``), which the reference left to XLA:

  ``bnpool_stats``: per-channel mean, biased var and inv = rsqrt(var + eps)
      (``batch_stats``' semantics);
  ``bnpool_norm_pool``: the residual xhat in the activation dtype and the
      pooled output (``normalize_relu_pool``'s roundings);

on CPU and ``meta`` tensors it is their plain PyTorch version, so the cost
model (``analysis/costmodel.py``) counts the plain forward's operators.
The backward is two hand-written CUDA kernels on CUDA tensors, their plain
PyTorch version on CPU tensors, and one operator each, of the kernels'
shapes, on the ``meta`` tensors the cost model counts:

  phase 1 (``bnpool_sums``): recompute the pool routing and the ReLU gate
      from the stored BN residual xhat, reduce sum(dy) and sum(dy*xhat)
      per channel;
  phase 2 (``bnpool_dx``): dx = (gamma*inv/n)(n*dy - sum_dy -
      xhat*sum_dy_xhat) through the same routing.

Semantics, shared by the forward, both kernels and the plain version:

  * the pool gradient goes to the FIRST maximal element of each window in
    row-major order 00, 01, 10, 11 (torch's convention);
  * the ReLU gate is (pre-ReLU z > 0): no gradient at exactly 0;
  * z is rebuilt as act(f32(act(xhat)) * gamma + beta), product and sum
    rounded separately, and compared after rounding to the activation dtype
    — exactly the values the forward's pool compared;
  * reductions accumulate in f32 whatever the activation dtype.

Tensors are NCHW-logical in ``torch.channels_last`` memory (NHWC
physically), so C is the contiguous dimension for the kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

BN_EPS = 1e-5
_SOURCE = "bnpool.cu"
# The sums kernel (csrc/bnpool.cu): 256 threads a block, each on one
# 16-byte vector of channels (so C / (16 / itemsize) <= 256), in at most
# _SUM_BLOCKS blocks.  Fewer blocks mean fewer partials to add up after the
# grid barrier; more give a small shape more loads in flight.  The grid is
# launched cooperatively, so it must fit on the card at once: 256 blocks at
# four a streaming multiprocessor take 64 of an H100's 132.
_SUM_THREADS = 256
_SUM_BLOCKS = 256
# The dx kernel: each thread on one 16-byte channel vector and up to
# _DX_WINDOWS[itemsize] pool windows (more windows spread a thread's setup,
# its channels' five values, over more work; a bf16 thread has twice the
# channels and the arithmetic of an f32 one), fewer where the grid would
# keep fewer than _DX_GRID_THREADS threads (248 a streaming multiprocessor
# of an H100); blocks of at most _DX_THREADS threads, halved, down to
# _DX_MIN_THREADS, until the grid has at least _DX_MIN_BLOCKS blocks, one
# for each of an H100's 132 streaming multiprocessors.  Tuned on the card
# (chip_smoke.py --tune-dx, PERF.md).
_DX_WINDOWS = {4: 2, 2: 8}
_DX_GRID_THREADS = 32768
_DX_THREADS = 256
_DX_MIN_THREADS = 32
_DX_MIN_BLOCKS = 132
# The forward's statistics kernel: the sums kernel's lanes (one 16-byte
# channel vector a thread, so again C / (16 / itemsize) <= 256), at least
# _STATS_ROWS rows a thread, at most _STATS_BLOCKS blocks (two an H100
# streaming multiprocessor; the launch is cooperative, like the sums
# kernel's).
_STATS_THREADS = 256
_STATS_ROWS = 4
_STATS_BLOCKS = 264
# The normalize -> ReLU -> pool kernel: dx_partition's rule with windows a
# thread of its own.
_POOL_WINDOWS = {4: 2, 2: 4}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Each kernel's wrapper, backward then forward.
BACKWARD = ("bnpool_sums", "bnpool_dx")
FORWARD = ("bnpool_stats", "bnpool_norm_pool")
# The kernels by variant, each wrapper at each dtype: the keys of
# ``launch_counts`` and ``executed_counts``.
KERNELS = ("bnpool_sums", "bnpool_dx", "bnpool_sums_bf16", "bnpool_dx_bf16",
           "bnpool_stats", "bnpool_norm_pool", "bnpool_stats_bf16",
           "bnpool_norm_pool_bf16")
# Each wrapper's kernel in a torch.profiler trace, by name fragment (the
# template names: ``sums_kernel<float>``, ``norm_pool_kernel<__nv_bfloat16>``).
PROFILED = {"bnpool_sums": "sums_kernel", "bnpool_dx": "dx_kernel",
            "bnpool_stats": "stats_kernel",
            "bnpool_norm_pool": "norm_pool_kernel"}


def kernel_name(wrapper: str, dtype: torch.dtype) -> str:
    """The variant of ``wrapper`` (one of ``BACKWARD`` or ``FORWARD``) that
    runs on tensors of ``dtype``."""
    return wrapper if dtype == torch.float32 else f"{wrapper}_bf16"


def _c(v: torch.Tensor) -> torch.Tensor:
    """[C] -> [1,C,1,1] for broadcasting over NCHW."""
    return v.reshape(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# Forward: plain PyTorch version (the reference's _fwd_impl)
# ---------------------------------------------------------------------------

def batch_stats(x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased var, inv = rsqrt(var + eps)) per channel, in f32.

    Centered two-pass statistics for f32 input; the one-pass
    E[x^2] - E[x]^2 form, clamped at 0, for bf16 — the reference's BN
    (``models/layers.py::_bn_train_fwd_impl``)."""
    xf = x.to(torch.float32)
    axes = (0, 2, 3)
    mean = xf.mean(dim=axes)
    if x.dtype == torch.bfloat16:
        var = (xf.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
    else:
        var = (xf - _c(mean)).square().mean(dim=axes)
    return mean, var, torch.rsqrt(var + BN_EPS)


def normalize_relu_pool(x: torch.Tensor, mean: torch.Tensor,
                        inv: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, xhat) for given statistics.  z is rebuilt from the ROUNDED
    residual act(xhat), so the backward's routing sees what the pool
    compared."""
    xhat = (x.to(torch.float32) - _c(mean)) * _c(inv)
    xhat_act = xhat.to(x.dtype).to(torch.float32)
    z = (xhat_act * _c(gamma) + _c(beta)).to(x.dtype)
    y = z.clamp_min(0)
    return F.max_pool2d(y, kernel_size=2, stride=2), xhat


def _check_even(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"bn_relu_pool needs [N,C,H,W] with even H and W "
                         f"(2x2/2 pool windows), got {tuple(x.shape)}")


def bn_relu_pool_forward(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor):
    """(pooled, xhat, mean, var, inv) of train-mode BN -> ReLU -> 2x2 pool.

    x: [N,C,H,W] f32 or bf16 with even H and W; gamma, beta: f32 [C].
    CUDA tensors launch the two forward kernels (``bnpool_stats``,
    ``bnpool_norm_pool``; xhat in x's dtype) or raise; CPU and meta
    tensors run the plain version (``batch_stats``,
    ``normalize_relu_pool``; xhat in f32)."""
    _check_even(x)
    mean, var, inv = bnpool_stats(x)
    pooled, xhat = bnpool_norm_pool(x, mean, inv, gamma, beta)
    return pooled, xhat, mean, var, inv


# ---------------------------------------------------------------------------
# Backward: plain PyTorch version (the reference's _routed and dx formula)
# ---------------------------------------------------------------------------

def _quadrants(t: torch.Tensor) -> List[torch.Tensor]:
    """The four [N,C,H/2,W/2] window positions, order 00, 01, 10, 11."""
    return [t[:, :, 0::2, 0::2], t[:, :, 0::2, 1::2],
            t[:, :, 1::2, 0::2], t[:, :, 1::2, 1::2]]


def _routed_reference(xhat, dp, gamma, beta):
    """(dy, x) per window position: dP routed to the first maximal y and
    gated by z > 0, and the f32 residual."""
    act = xhat.dtype
    xq = [q.to(torch.float32) for q in _quadrants(xhat)]
    zq = [(x * _c(gamma) + _c(beta)).to(act).to(torch.float32) for x in xq]
    yq = [z.clamp_min(0.0) for z in zq]
    wmax = torch.maximum(torch.maximum(yq[0], yq[1]),
                         torch.maximum(yq[2], yq[3]))
    dpf = dp.to(torch.float32)
    taken = torch.zeros_like(wmax, dtype=torch.bool)
    dyq = []
    for y, z in zip(yq, zq):
        hit = (y == wmax) & ~taken
        taken = taken | hit
        dyq.append(torch.where(hit & (z > 0), dpf, 0.0))
    return dyq, xq


def bnpool_sums_reference(xhat, dp, gamma, beta) -> torch.Tensor:
    """[2, C] f32: (sum dy, sum dy*xhat) over N, H, W."""
    dyq, xq = _routed_reference(xhat, dp, gamma, beta)
    dy_tot = ((dyq[0] + dyq[1]) + dyq[2]) + dyq[3]
    dyx_tot = dyq[0] * xq[0] + dyq[1] * xq[1] + dyq[2] * xq[2] \
        + dyq[3] * xq[3]
    return torch.stack([dy_tot.sum(dim=(0, 2, 3)),
                        dyx_tot.sum(dim=(0, 2, 3))])


def bnpool_dx_reference(xhat, dp, gamma, beta, inv, sums) -> torch.Tensor:
    """dx in the residual's dtype and memory format."""
    n_, _, h, w = xhat.shape
    n = float(n_ * h * w)
    dyq, xq = _routed_reference(xhat, dp, gamma, beta)
    scale = _c(gamma * inv * (1.0 / n))
    sum_dy, sum_dy_xhat = _c(sums[0]), _c(sums[1])
    dx = torch.empty_like(xhat)
    for out, dy, x in zip(_quadrants(dx), dyq, xq):
        out.copy_(scale * (n * dy - sum_dy - x * sum_dy_xhat))
    return dx


def bnpool_backward_reference(xhat, dp, gamma, beta, inv):
    """(dx, sum_dy, sum_dy_xhat): the plain version of both kernels."""
    sums = bnpool_sums_reference(xhat, dp, gamma, beta)
    dx = bnpool_dx_reference(xhat, dp, gamma, beta, inv, sums)
    return dx, sums[0], sums[1]


# ---------------------------------------------------------------------------
# Backward: kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(xhat, dp, channel_vectors, sums=None) -> None:
    if xhat.dim() != 4 or xhat.shape[2] % 2 or xhat.shape[3] % 2:
        raise ValueError(f"xhat must be [N,C,H,W] with even H, W; "
                         f"got {tuple(xhat.shape)}")
    n, c, h, w = xhat.shape
    if tuple(dp.shape) != (n, c, h // 2, w // 2):
        raise ValueError(f"dp shape {tuple(dp.shape)} does not match xhat "
                         f"{tuple(xhat.shape)} pooled 2x2")
    if xhat.dtype not in _SUFFIX or dp.dtype != xhat.dtype:
        raise TypeError(f"xhat and dp must share a dtype in f32/bf16; got "
                        f"{xhat.dtype}, {dp.dtype}")
    vectors = list(channel_vectors) + ([] if sums is None else [sums])
    for v in vectors:
        want = (2, c) if v is sums else (c,)
        if tuple(v.shape) != want:
            raise ValueError(f"expected shape {want}, got {tuple(v.shape)}")
        if v.dtype != torch.float32:
            raise TypeError(f"channel vectors must be f32, got {v.dtype}")
    tensors = [xhat, dp] + vectors
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if xhat.is_cuda:
        for t in (xhat, dp):
            if not t.is_contiguous(memory_format=torch.channels_last):
                raise ValueError("xhat and dp must be channels_last "
                                 "contiguous for the CUDA kernels")
        for v in vectors:
            if not v.is_contiguous():
                raise ValueError("channel vectors must be contiguous")
        if xhat.numel() >= 2 ** 31:
            raise ValueError("the kernels index with 32-bit ints; xhat has "
                             f"{xhat.numel()} elements")
    elif xhat.device.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {xhat.device}")


def sums_partition(n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Blocks of the sums kernel for xhat [n, c, h, w] of ``itemsize``-byte
    elements: one window per thread, at most one block per pooled row, at
    most _SUM_BLOCKS.  It follows from the shape alone, so the kernel sums
    in the same order on every card."""
    lanes = _SUM_THREADS // (c // (16 // itemsize))
    rows_per_block = max(1, lanes // (w // 2))
    return min(-(-(n * (h // 2)) // rows_per_block), _SUM_BLOCKS)


def dx_partition(n: int, c: int, h: int, w: int, itemsize: int,
                 per_thread: Optional[int] = None) -> Tuple[int, int]:
    """(threads, blocks) of the dx kernel for xhat [n, c, h, w] of
    ``itemsize``-byte elements.  A block is L = min(C/V, threads) channel-
    vector lanes (V = 16 / itemsize) by threads / L groups of windows, and
    the grid is ceil(C/V / L) chunks of channel vectors by enough tiles for
    ``per_thread`` windows a thread (by default the rule above;
    chip_smoke.py --tune-dx times others).  It follows from the shape
    alone, never from the card."""
    return _window_partition(n, c, h, w, itemsize, per_thread,
                             _DX_WINDOWS[itemsize])


def norm_pool_partition(n: int, c: int, h: int, w: int,
                        itemsize: int) -> Tuple[int, int]:
    """(threads, blocks) of the normalize -> ReLU -> pool kernel for x
    [n, c, h, w]: ``dx_partition``'s rule (the kernel walks the windows as
    the dx kernel does) with up to ``_POOL_WINDOWS[itemsize]`` windows a
    thread."""
    return _window_partition(n, c, h, w, itemsize, None,
                             _POOL_WINDOWS[itemsize])


def _window_partition(n, c, h, w, itemsize, per_thread, most):
    vectors = c // (16 // itemsize)
    windows = n * (h // 2) * (w // 2)
    if per_thread is None:
        per_thread = most
        while (per_thread > 1
               and vectors * windows // per_thread < _DX_GRID_THREADS):
            per_thread //= 2
    threads = _DX_THREADS
    while True:
        lanes = min(vectors, threads)
        groups = threads // lanes
        blocks = -(-vectors // lanes) * -(-windows // (groups * per_thread))
        if blocks >= _DX_MIN_BLOCKS or threads <= _DX_MIN_THREADS:
            return threads, blocks
        threads //= 2


def stats_partition(n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Blocks of the statistics kernel for x [n, c, h, w] of
    ``itemsize``-byte elements: 256 // (C / V) rows at a time a block (V =
    16 / itemsize), at least ``_STATS_ROWS`` rows a thread, at most
    ``_STATS_BLOCKS`` blocks.  It follows from the shape alone, so the
    kernel sums in the same order on every card."""
    groups = _STATS_THREADS // (c // (16 // itemsize))
    return min(-(-(n * h * w) // (groups * _STATS_ROWS)), _STATS_BLOCKS)


def _check_vector_path(kernel: str, xhat, tensors,
                       max_vectors: Optional[int] = None) -> None:
    """What ``kernel``'s 16-byte accesses need of the CUDA tensors it
    reads and writes: C a whole number of 16-byte channel vectors (at most
    ``max_vectors`` of them, where the kernel has such a limit) and every
    tensor 16-byte aligned."""
    vec = 16 // xhat.element_size()
    c = xhat.shape[1]
    if c % vec:
        raise ValueError(f"{kernel} reads {vec} channels of {xhat.dtype} "
                         f"per 16-byte vector: C must be a multiple of "
                         f"{vec}, got {c}")
    if max_vectors is not None and c // vec > max_vectors:
        raise ValueError(f"{kernel} takes at most {max_vectors} channel "
                         f"vectors: C must be at most {vec * max_vectors} "
                         f"in {xhat.dtype}, got {c}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} needs 16-byte aligned tensors; one "
                             f"starts at {t.data_ptr():#x}")


# Kernel runs counted on the device, by device index: int64, one for each
# of ``KERNELS``.  Each run of a kernel adds one, so a launch inside a CUDA
# graph counts on every replay (the wrappers' host count ``_LAUNCHES``
# sees it once, at capture).
_EXECUTED: Dict[int, torch.Tensor] = {}
_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def _executed(device: torch.device, name: str) -> int:
    """The address of the device counter of kernel variant ``name``."""
    counter = _EXECUTED.get(device.index)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the bnpool kernels' run counter is made at "
                               "their first eager launch on a device; a "
                               "CUDA graph capture came first")
        counter = torch.zeros(len(KERNELS), dtype=torch.int64, device=device)
        _EXECUTED[device.index] = counter
    return counter.data_ptr() + KERNELS.index(name) * counter.element_size()


# The kernels as operators of their own on ``meta`` tensors, defined at the
# first meta call: the cost model (``analysis/costmodel.py``) counts a
# step on the meta device, where each kernel must be ONE operator, charged
# its operands' and results' bytes and none of the plain version's
# arithmetic, as the reference's cost model charges a Pallas call.
META_NAMESPACE = "cs744_bnpool"
_META_LIBRARY: List[torch.library.Library] = []


def _meta_op(name: str):
    if not _META_LIBRARY:
        lib = torch.library.Library(META_NAMESPACE, "DEF")
        lib.define("bnpool_sums(Tensor xhat, Tensor dp, Tensor gamma, "
                   "Tensor beta) -> Tensor")
        lib.define("bnpool_dx(Tensor xhat, Tensor dp, Tensor gamma, "
                   "Tensor beta, Tensor inv, Tensor sums) -> Tensor")
        lib.impl("bnpool_sums", lambda xhat, *_: xhat.new_empty(
            (2, xhat.shape[1]), dtype=torch.float32), "Meta")
        lib.impl("bnpool_dx", lambda xhat, *_: torch.empty_like(
            xhat, memory_format=torch.channels_last), "Meta")
        _META_LIBRARY.append(lib)
    return getattr(getattr(torch.ops, META_NAMESPACE), name)


def bnpool_sums(xhat, dp, gamma, beta) -> torch.Tensor:
    """Phase 1: [2, C] f32 (sum dy, sum dy*xhat).  CUDA tensors launch the
    kernel once (``launch_counts`` counts it; the kernel counts its runs in
    ``executed_counts``) or raise; CPU tensors take the plain version; meta
    tensors one operator of the kernel's shapes (``_meta_op``)."""
    _check_inputs(xhat, dp, (gamma, beta))
    if xhat.is_meta:
        return _meta_op("bnpool_sums")(xhat, dp, gamma, beta)
    if not xhat.is_cuda:
        return bnpool_sums_reference(xhat, dp, gamma, beta)
    name = kernel_name("bnpool_sums", xhat.dtype)
    _check_vector_path(name, xhat, (xhat, dp, gamma, beta),
                       max_vectors=_SUM_THREADS)
    n, c, h, w = xhat.shape
    blocks = sums_partition(n, c, h, w, xhat.element_size())
    partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                          device=xhat.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=xhat.device)
    lib = _build.library(_SOURCE)
    fn = getattr(lib, f"bnpool_sums_{_SUFFIX[xhat.dtype]}")
    with torch.cuda.device(xhat.device):
        stream = torch.cuda.current_stream(xhat.device).cuda_stream
        err = fn(xhat.data_ptr(), dp.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), partial.data_ptr(), sums.data_ptr(), n, h,
                 w, c, blocks, _executed(xhat.device, name), stream)
    _build.check(lib, err, "bnpool_sums")
    _LAUNCHES[name] += 1
    return sums


def bnpool_dx(xhat, dp, gamma, beta, inv, sums) -> torch.Tensor:
    """Phase 2: dx in xhat's dtype, channels_last.  CUDA tensors launch the
    kernel (``launch_counts`` counts it, ``executed_counts`` its runs); CPU
    tensors take the plain version; meta tensors one operator."""
    _check_inputs(xhat, dp, (gamma, beta, inv), sums)
    if xhat.is_meta:
        return _meta_op("bnpool_dx")(xhat, dp, gamma, beta, inv, sums)
    if not xhat.is_cuda:
        return bnpool_dx_reference(xhat, dp, gamma, beta, inv, sums)
    name = kernel_name("bnpool_dx", xhat.dtype)
    n, c, h, w = xhat.shape
    dx = torch.empty_like(xhat, memory_format=torch.channels_last)
    _check_vector_path(name, xhat, (xhat, dp, gamma, beta, inv, sums, dx))
    threads, blocks = dx_partition(n, c, h, w, xhat.element_size())
    lib = _build.library(_SOURCE)
    fn = getattr(lib, f"bnpool_dx_{_SUFFIX[xhat.dtype]}")
    with torch.cuda.device(xhat.device):
        stream = torch.cuda.current_stream(xhat.device).cuda_stream
        err = fn(xhat.data_ptr(), dp.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), inv.data_ptr(), sums.data_ptr(),
                 dx.data_ptr(), n, h, w, c, threads, blocks,
                 _executed(xhat.device, name), stream)
    _build.check(lib, err, "bnpool_dx")
    _LAUNCHES[name] += 1
    return dx


# ---------------------------------------------------------------------------
# Forward: kernel wrappers
# ---------------------------------------------------------------------------

def _check_forward(kernel: str, x, vectors=(), max_vectors=None) -> None:
    """What the forward kernels take: x [N,C,H,W] f32 or bf16 with even H
    and W, channels_last contiguous, indexable with 32-bit ints, C a whole
    number of 16-byte channel vectors (at most ``max_vectors``), and each
    of ``vectors`` f32 [C], contiguous, on x's device; every tensor
    16-byte aligned."""
    _check_even(x)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} takes f32 or bf16 x, got {x.dtype}")
    c = x.shape[1]
    for v in vectors:
        if tuple(v.shape) != (c,):
            raise ValueError(f"expected shape {(c,)}, got {tuple(v.shape)}")
        if v.dtype != torch.float32:
            raise TypeError(f"channel vectors must be f32, got {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"inputs on several devices: {x.device}, "
                             f"{v.device}")
        if not v.is_contiguous():
            raise ValueError("channel vectors must be contiguous")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{kernel} needs x channels_last contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError("the kernels index with 32-bit ints; x has "
                         f"{x.numel()} elements")
    _check_vector_path(kernel, x, (x, *vectors), max_vectors=max_vectors)


def bnpool_stats(x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased var, inv), f32 [C] each, of x [N,C,H,W].  CUDA tensors
    launch the statistics kernel once (``launch_counts``,
    ``executed_counts``) or raise; other tensors take ``batch_stats``.
    The kernel's sums are bitwise reproducible run to run: f32 within each
    thread, f64 across threads and blocks, in an order that follows from
    the shape alone (``stats_partition``)."""
    if not x.is_cuda:
        return batch_stats(x)
    name = kernel_name("bnpool_stats", x.dtype)
    _check_forward(name, x, max_vectors=_STATS_THREADS)
    n, c, h, w = x.shape
    blocks = stats_partition(n, c, h, w, x.element_size())
    partial = torch.empty((blocks, 2, c), dtype=torch.float64,
                          device=x.device)
    stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    lib = _build.library(_SOURCE)
    fn = getattr(lib, f"bnpool_stats_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), partial.data_ptr(), stats.data_ptr(), n, h, w,
                 c, blocks, _executed(x.device, name), stream)
    _build.check(lib, err, name)
    _LAUNCHES[name] += 1
    return stats[0], stats[1], stats[2]


def bnpool_norm_pool(x, mean, inv, gamma, beta
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, xhat) for given statistics.  CUDA tensors launch the
    normalize -> ReLU -> pool kernel once (``launch_counts``,
    ``executed_counts``) or raise: xhat in x's dtype, both channels_last,
    rounded as ``normalize_relu_pool`` rounds.  Other tensors take
    ``normalize_relu_pool`` (xhat in f32)."""
    if not x.is_cuda:
        return normalize_relu_pool(x, mean, inv, gamma, beta)
    name = kernel_name("bnpool_norm_pool", x.dtype)
    _check_forward(name, x, (mean, inv, gamma, beta))
    n, c, h, w = x.shape
    xhat = torch.empty_like(x, memory_format=torch.channels_last)
    pooled = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype,
                         device=x.device, memory_format=torch.channels_last)
    _check_vector_path(name, x, (xhat, pooled))
    threads, blocks = norm_pool_partition(n, c, h, w, x.element_size())
    lib = _build.library(_SOURCE)
    fn = getattr(lib, f"bnpool_norm_pool_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), xhat.data_ptr(),
                 pooled.data_ptr(), n, h, w, c, threads, blocks,
                 _executed(x.device, name), stream)
    _build.check(lib, err, name)
    _LAUNCHES[name] += 1
    return pooled, xhat


def reset_launch_counts() -> None:
    """Zero the wrappers' launch counts and the kernels' run counters."""
    _LAUNCHES.update(dict.fromkeys(KERNELS, 0))
    for counter in _EXECUTED.values():
        counter.zero_()


def launch_counts() -> Dict[str, int]:
    """Launches so far, by kernel variant (``KERNELS``): eager launches and
    launches recorded into a CUDA graph, each once."""
    return dict(_LAUNCHES)


def executed_counts() -> Dict[str, int]:
    """Runs of each kernel variant so far (``KERNELS``), counted by the
    kernels on the device, over every device (a graph's replays
    included).  It synchronises."""
    total = [0] * len(KERNELS)
    for counter in _EXECUTED.values():
        for i, v in enumerate(counter.tolist()):
            total[i] += v
    return dict(zip(KERNELS, total))


def profiled_runs(names: Dict[str, int]) -> Dict[str, int]:
    """Runs of each kernel variant in a ``torch.profiler`` trace, from the
    counts of its device events by name (``PROFILED``)."""
    runs = dict.fromkeys(KERNELS, 0)
    for event, n in names.items():
        for wrapper, frag in PROFILED.items():
            if frag in event:
                dtype = torch.bfloat16 if "bfloat16" in event \
                    else torch.float32
                runs[kernel_name(wrapper, dtype)] += n
    return runs


def bnpool_backward(xhat, dp, gamma, beta, inv):
    """(dx, sum_dy, sum_dy_xhat) through the two phases.

    On CUDA tensors this launches the kernels or raises; on CPU tensors it
    runs the plain version.  ``dp`` arrives from autograd in whatever
    layout the next op produced and is converted to channels_last (a layout
    conversion: the kernels index NHWC)."""
    dp = dp.contiguous(memory_format=torch.channels_last)
    sums = bnpool_sums(xhat, dp, gamma, beta)
    dx = bnpool_dx(xhat, dp, gamma, beta, inv, sums)
    return dx, sums[0], sums[1]


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class BnReluPool(torch.autograd.Function):
    """(pooled, mean, var) = BN(train) -> ReLU -> MaxPool2x2 of x, with the
    fused two-phase backward.  mean and var are the batch statistics (biased
    var) for the running-statistics update."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        pooled, xhat, mean, var, inv = bn_relu_pool_forward(x, gamma, beta)
        # Residual in the activation dtype, as the reference stores it (the
        # kernel writes it so; the plain version's f32 xhat is cast here).
        ctx.save_for_backward(xhat.to(x.dtype), inv, gamma, beta)
        ctx.set_materialize_grads(False)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, d_pooled, d_mean, d_var):
        xhat, inv, gamma, beta = ctx.saved_tensors
        n_, c, h, w = xhat.shape
        if d_pooled is None:
            d_pooled = xhat.new_zeros((n_, c, h // 2, w // 2))
        dx, sum_dy, sum_dy_xhat = bnpool_backward(
            xhat, d_pooled.to(xhat.dtype), gamma, beta, inv)
        if d_mean is not None or d_var is not None:
            # Exact cotangent terms of the statistics outputs (they normally
            # feed only the running-statistics update and carry none):
            # d mean/d x_i = 1/n, d var/d x_i = 2 (x_i - mean)/n.
            n = n_ * h * w
            dxf = dx.to(torch.float32)
            if d_mean is not None:
                dxf = dxf + _c(d_mean.to(torch.float32)) / n
            if d_var is not None:
                dxf = dxf + (2.0 / n) * _c(d_var.to(torch.float32)) * (
                    xhat.to(torch.float32) / _c(inv))
            dx = dxf.to(xhat.dtype)
        return dx, sum_dy_xhat, sum_dy
