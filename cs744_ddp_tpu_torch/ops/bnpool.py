"""Fused BatchNorm(train) -> ReLU -> MaxPool2x2/2 with a CUDA backward.

The counterpart of the reference package's ``ops/bnpool_pallas.py``.  The
forward is plain PyTorch; the backward is two hand-written CUDA kernels
(``csrc/bnpool.cu``) on CUDA tensors and their plain PyTorch version on CPU
tensors:

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

from typing import List, Tuple

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
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _c(v: torch.Tensor) -> torch.Tensor:
    """[C] -> [1,C,1,1] for broadcasting over NCHW."""
    return v.reshape(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# Forward (plain PyTorch; the reference's _fwd_impl)
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


def bn_relu_pool_forward(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor):
    """(pooled, xhat, mean, var, inv) of train-mode BN -> ReLU -> 2x2 pool.

    x: [N,C,H,W] f32 or bf16 with even H and W; gamma, beta: f32 [C]."""
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"bn_relu_pool needs [N,C,H,W] with even H and W "
                         f"(2x2/2 pool windows), got {tuple(x.shape)}")
    mean, var, inv = batch_stats(x)
    pooled, xhat = normalize_relu_pool(x, mean, inv, gamma, beta)
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
    elif xhat.device.type != "cpu":
        raise ValueError(f"unsupported device {xhat.device}")


def sums_partition(n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Blocks of the sums kernel for xhat [n, c, h, w] of ``itemsize``-byte
    elements: one window per thread, at most one block per pooled row, at
    most _SUM_BLOCKS.  It follows from the shape alone, so the kernel sums
    in the same order on every card."""
    lanes = _SUM_THREADS // (c // (16 // itemsize))
    rows_per_block = max(1, lanes // (w // 2))
    return min(-(-(n * (h // 2)) // rows_per_block), _SUM_BLOCKS)


def _check_vector_path(xhat, tensors) -> None:
    """What the sums kernel's 16-byte accesses need of CUDA inputs."""
    vec = 16 // xhat.element_size()
    c = xhat.shape[1]
    if c % vec or c // vec > _SUM_THREADS:
        raise ValueError(f"the sums kernel reads {vec} channels of "
                         f"{xhat.dtype} per 16-byte vector: C must be a "
                         f"multiple of {vec} and at most "
                         f"{vec * _SUM_THREADS}, got {c}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the sums kernel needs 16-byte aligned "
                             f"tensors; one starts at {t.data_ptr():#x}")


def bnpool_sums(xhat, dp, gamma, beta) -> torch.Tensor:
    """Phase 1: [2, C] f32 (sum dy, sum dy*xhat).  CUDA tensors launch the
    kernel once (``bnpool_sums.launches`` counts it) or raise; CPU tensors
    take the plain version."""
    _check_inputs(xhat, dp, (gamma, beta))
    if not xhat.is_cuda:
        return bnpool_sums_reference(xhat, dp, gamma, beta)
    _check_vector_path(xhat, (xhat, dp, gamma, beta))
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
                 w, c, blocks, stream)
    _build.check(lib, err, "bnpool_sums")
    bnpool_sums.launches += 1
    return sums


bnpool_sums.launches = 0


def bnpool_dx(xhat, dp, gamma, beta, inv, sums) -> torch.Tensor:
    """Phase 2: dx in xhat's dtype, channels_last.  CUDA tensors launch the
    kernel (``bnpool_dx.launches`` counts it); CPU tensors take the plain
    version."""
    _check_inputs(xhat, dp, (gamma, beta, inv), sums)
    if not xhat.is_cuda:
        return bnpool_dx_reference(xhat, dp, gamma, beta, inv, sums)
    n, c, h, w = xhat.shape
    dx = torch.empty_like(xhat, memory_format=torch.channels_last)
    lib = _build.library(_SOURCE)
    fn = getattr(lib, f"bnpool_dx_{_SUFFIX[xhat.dtype]}")
    with torch.cuda.device(xhat.device):
        stream = torch.cuda.current_stream(xhat.device).cuda_stream
        err = fn(xhat.data_ptr(), dp.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), inv.data_ptr(), sums.data_ptr(),
                 dx.data_ptr(), n, h, w, c, stream)
    _build.check(lib, err, "bnpool_dx")
    bnpool_dx.launches += 1
    return dx


bnpool_dx.launches = 0


def reset_launch_counts() -> None:
    bnpool_sums.launches = 0
    bnpool_dx.launches = 0


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
        # Residual in the activation dtype, as the reference stores it.
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
