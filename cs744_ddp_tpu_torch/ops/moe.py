"""Grouped matrix products over the experts a rank holds, for the expert
layer of a mixture of experts (``models/moonlight.py``), with row offsets
that never leave the device.

The rows are ordered by held expert: group g is rows ``[offsets[g],
offsets[g+1])`` of ``x`` (``offsets`` int32 ``[G+1]`` on ``x``'s device,
``offsets[0] == 0``), and rows past ``offsets[-1]`` belong to no group.
The windowed train path replays one captured CUDA graph of the step
(``train/step.py`` ``GraphStep``), so the per-expert row counts, which the
router decides on the device, can never reach the host: every buffer has
the static worst case's rows, and the products read the offsets on the
device.

  ``grouped_mm(x, w, offsets)``: ``Y_g = X_g W_g`` (an autograd function;
      its backward ``dX_g = dY_g W_g^T`` and ``dW_g = X_g^T dY_g``);
  ``routed_experts(...)``: the held experts' SwiGLU over their rows, each
      row scaled by its router weight and added back to token order, with
      a backward that keeps only token-order tensors, the row order and the
      offsets, and recomputes the rows' gate-and-up product;
  ``sort_rows(expert, groups)``: the row order and the offsets, from a
      device histogram.

No kernel of the TPU package corresponds (the JAX package runs no expert
layer).  On CUDA tensors each product is one call of the library's grouped
GEMM (``torch._grouped_mm``, CUTLASS on the H100), which reads the group
ends from the device and sizes its work from them: bf16 operands, f32
accumulation, the output in bf16 (``dW`` too, cast to f32 for the f32
master gradient).  Other dtypes are refused on the card.  The library
leaves rows past ``offsets[-1]`` unwritten, so ``_mm`` zeroes them, and
``_dw`` zeroes the gradient of a group of no rows.  CPU and ``meta``
tensors take the plain version, a masked loop over the groups that reads
no offset on the host.

Every product on CUDA counts its runs and FLOPs on the device
(``executed_counts``) just before its launch, so a graph's replays count
and the plain version counts nothing; the expert layer counts its held
rows and its largest group's rows once a forward, on any device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# What ``executed_counts`` reports: runs of each product on CUDA (the
# forward, the backward's input and weight gradients, and the forward
# recomputed in the expert layer's backward), the FLOPs of every such run
# (2 x rows x K x N), and per expert-layer forward its held rows and its
# largest group's rows.
RUNS = ("fwd", "dx", "dw", "fwd_recompute")
KEYS = RUNS + ("flops", "rows", "rows_max")

# Counters by device index: int64 [len(KEYS)], made at the first eager
# call on a device.
_COUNTERS: Dict[object, torch.Tensor] = {}


def _counter(device: torch.device) -> torch.Tensor:
    key = (device.type, device.index)
    counter = _COUNTERS.get(key)
    if counter is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the grouped products' counter is made at "
                               "their first eager call on a device; a CUDA "
                               "graph capture came first")
        counter = torch.zeros(len(KEYS), dtype=torch.int64, device=device)
        _COUNTERS[key] = counter
    return counter


def _count_run(run: str, offsets: torch.Tensor, k: int, n: int) -> None:
    counter = _counter(offsets.device)
    counter.narrow(0, KEYS.index(run), 1).add_(1)
    counter.narrow(0, KEYS.index("flops"), 1).add_(
        offsets[-1:].to(torch.int64), alpha=2 * k * n)


def count_rows(offsets: torch.Tensor) -> None:
    """Add one expert layer's held rows and its largest group's rows."""
    if offsets.is_meta:
        return
    counter = _counter(offsets.device)
    counter.narrow(0, KEYS.index("rows"), 1).add_(
        offsets[-1:].to(torch.int64))
    counter.narrow(0, KEYS.index("rows_max"), 1).add_(
        (offsets[1:] - offsets[:-1]).max().reshape(1).to(torch.int64))


def reset_counts() -> None:
    """Zero every device's counter (in place: a captured graph keeps
    adding to it)."""
    for counter in _COUNTERS.values():
        counter.zero_()


def executed_counts() -> Dict[str, int]:
    """Every key of ``KEYS`` so far, over every device (a graph's replays
    included).  It synchronises."""
    total = [0] * len(KEYS)
    for counter in _COUNTERS.values():
        for i, v in enumerate(counter.tolist()):
            total[i] += v
    return dict(zip(KEYS, total))


# ---------------------------------------------------------------------------
# Row order
# ---------------------------------------------------------------------------

def sort_rows(group: torch.Tensor, groups: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of ``group`` [R] int64, each row's group in
    ``0 .. groups`` (``groups`` marks a row of no group): ``order`` [R]
    int64 the rows by group, stably, the rows of no group last; ``offsets``
    int32 [groups + 1] from a device histogram (no host read)."""
    order = torch.sort(group, stable=True).indices
    hist = torch.zeros(groups + 1, dtype=torch.int64, device=group.device)
    hist.scatter_add_(0, group, torch.ones_like(group))
    offsets = torch.zeros(groups + 1, dtype=torch.int32, device=group.device)
    offsets[1:] = torch.cumsum(hist[:groups], 0)
    return order, offsets


# ---------------------------------------------------------------------------
# Plain version (CPU and meta)
# ---------------------------------------------------------------------------

def _inside(m: int, offsets: torch.Tensor, g: int) -> torch.Tensor:
    rows = torch.arange(m, device=offsets.device)
    return ((rows >= offsets[g]) & (rows < offsets[g + 1]))[:, None]


def grouped_mm_reference(x, w, offsets) -> torch.Tensor:
    """[M, N] in x's dtype: each group's rows times its [K, N] matrix of
    ``w`` [G, K, N] (a view may be transposed), rows of no group zero."""
    out = x.new_zeros((x.shape[0], w.shape[2]))
    for g in range(w.shape[0]):
        out = torch.where(_inside(x.shape[0], offsets, g),
                          torch.matmul(x, w[g].to(x.dtype)), out)
    return out


def grouped_dw_reference(x, dy, offsets, groups: int) -> torch.Tensor:
    """[G, K, N] f32: each group's ``X_g^T dY_g``, summed in f32; no row
    of another group or of none is read."""
    xf, dyf = x.float(), dy.float()
    out = []
    for g in range(groups):
        inside = _inside(x.shape[0], offsets, g)
        out.append(torch.matmul(torch.where(inside, xf, 0.0).t(),
                                torch.where(inside, dyf, 0.0)))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# CUDA: the library's grouped GEMM
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, others, offsets: torch.Tensor, groups: int
           ) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped products take f32 or bf16, got {x.dtype}")
    for t in others:
        if t.dtype != x.dtype:
            raise TypeError(f"operands of several dtypes: {x.dtype}, "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on several devices: {x.device}, "
                             f"{t.device}")
    if offsets.dtype != torch.int32 or offsets.device != x.device \
            or tuple(offsets.shape) != (groups + 1,):
        raise ValueError(f"offsets must be int32 [{groups + 1}] on "
                         f"{x.device}, got {offsets.dtype} "
                         f"{tuple(offsets.shape)} on {offsets.device}")
    if x.is_cuda and x.dtype != torch.bfloat16:
        raise TypeError("on CUDA the grouped products run the library's "
                        f"bf16 grouped GEMM only, got {x.dtype}")


def _mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
        run: str) -> torch.Tensor:
    """[M, N] = each group's rows of ``x`` [M, K] times ``w`` [G, K, N] (any
    strides), in x's dtype.  Rows of no group: zero from the plain
    version, left unwritten by the library (``_zero_past``)."""
    g, k, n = w.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} against w {tuple(w.shape)}")
    _check(x, (w,), offsets, g)
    if not x.is_cuda:
        return grouped_mm_reference(x, w, offsets)
    _count_run(run, offsets, k, n)
    return torch._grouped_mm(x, w, offsets[1:])


def _zero_past(y: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``y`` with its rows past the last group zeroed, in place."""
    past = torch.arange(y.shape[0], device=y.device) >= offsets[-1]
    return y.masked_fill_(past[:, None], 0)


def _dw(x: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
        groups: int) -> torch.Tensor:
    """[G, K, N] f32: each group's ``X_g^T dY_g`` over its rows (on CUDA
    summed in f32 and rounded once to bf16)."""
    _check(x, (dy,), offsets, groups)
    k, n = x.shape[1], dy.shape[1]
    if not x.is_cuda:
        return grouped_dw_reference(x, dy, offsets, groups)
    _count_run("dw", offsets, k, n)
    dw = torch._grouped_mm(x.t(), dy, offsets[1:])
    # A group of no rows: nothing summed, nothing the library writes.
    empty = offsets[1:] == offsets[:-1]
    return dw.masked_fill_(empty[:, None, None], 0).float()


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class GroupedMM(torch.autograd.Function):
    """``Y_g = X_g W_g``; ``w`` (e.g. an f32 master) is cast to x's dtype
    for the products, and its gradient, summed in f32, is returned in
    w's dtype."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc, offsets)
        ctx.w_dtype = w.dtype
        return _zero_past(_mm(x, wc, offsets, "fwd"), offsets)

    @staticmethod
    def backward(ctx, dy):
        x, wc, offsets = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = _zero_past(_mm(dy, wc.transpose(1, 2), offsets, "dx"), offsets)
        dw = _dw(x, dy, offsets, wc.shape[0]).to(ctx.w_dtype)
        return dx, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """[M, N] in x's dtype: rows ``[offsets[g], offsets[g+1])`` of ``x``
    [M, K] times ``w[g]`` [K, N]; rows past ``offsets[-1]`` zero."""
    return GroupedMM.apply(x, w, offsets)


# Rows a step of the expert layer's f32 row-wise work takes: the static
# worst case is tokens x top-k rows (294,912 at the Moonlight cell), whose
# f32 [rows, hidden] products would each take 2.4 GB at once.
CHUNK_ROWS = 1 << 16


def _chunks(n: int):
    return [slice(lo, min(lo + CHUNK_ROWS, n))
            for lo in range(0, n, CHUNK_ROWS)]


def _swiglu(gu: torch.Tensor, width: int) -> torch.Tensor:
    return F.silu(gu[:, :width]) * gu[:, width:]


def _destinations(token: torch.Tensor, offsets: torch.Tensor, tokens: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each row's token for a scatter back to token order, the rows past
    the last group sent to row ``tokens``; those rows' mask)."""
    past = torch.arange(token.shape[0], device=token.device) >= offsets[-1]
    return torch.where(past, tokens, token), past


class RoutedExperts(torch.autograd.Function):
    """The held experts' part of an expert layer, f32 ``[T, H]``:

        out[t] = sum over rows r of token t:  weight[r] * Y_r,
        Y = grouped(SwiGLU(grouped(X[token] , W13)), W2)

    ``x`` [T, H] the layer's input in the activation dtype, ``weight`` [R]
    f32 each row's router weight (0 for a row of no group), ``token`` [R]
    int64 each row's token, rows ordered by held expert (``sort_rows``),
    ``w13`` [E, H, 2I] (gate then up) and ``w2`` [E, I, H] f32 masters.
    Saved for the backward: ``x`` (which the shared expert keeps anyway),
    the row weights, order and offsets, and the weights' casts; the rows'
    gate-and-up product is recomputed there.  The products take a row's
    router weight by the identity d weight_r = <dout[token_r] W2^T, h_r>,
    so the backward recomputes no down product.  Row-wise f32 work goes
    ``CHUNK_ROWS`` rows at a time, and each temporary is freed once used:
    the worst-case buffers are 8x the mean load.  The rows past the last
    group are never zeroed: on CUDA the library leaves them unwritten, so
    the scatters back to token order send them to one row past the tokens
    (``_destinations``), which is dropped, and their router-weight
    gradient is zero."""

    @staticmethod
    def forward(ctx, x, weight, w13, w2, token, offsets):
        dt, tokens = x.dtype, x.shape[0]
        w13c, w2c = w13.to(dt), w2.to(dt)
        xs = x.index_select(0, token)
        h = _swiglu(_mm(xs, w13c, offsets, "fwd"), w2.shape[1])
        del xs
        ys = _mm(h, w2c, offsets, "fwd")
        dest, _ = _destinations(token, offsets, tokens)
        out = torch.zeros((tokens + 1, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        for rows in _chunks(token.shape[0]):
            out.index_add_(0, dest[rows], ys[rows] * weight[rows, None])
        ctx.save_for_backward(x, weight, w13c, w2c, token, offsets)
        return out[:tokens]

    @staticmethod
    def backward(ctx, dout):
        x, weight, w13c, w2c, token, offsets = ctx.saved_tensors
        dt, width, groups = x.dtype, w2c.shape[1], w2c.shape[0]
        xs = x.index_select(0, token)
        gu = _mm(xs, w13c, offsets, "fwd_recompute")
        g, u = gu[:, :width], gu[:, width:]
        s = F.silu(g)
        h = s * u
        # The combine's gradient at each row, before its router weight.
        dyu = dout.to(dt).index_select(0, token)
        dh_unit = _mm(dyu, w2c.transpose(1, 2), offsets, "dx")
        d_weight = torch.empty(token.shape, dtype=torch.float32,
                               device=x.device)
        dh, hw = torch.empty_like(dh_unit), torch.empty_like(h)
        for rows in _chunks(token.shape[0]):
            d_weight[rows] = (dh_unit[rows] * h[rows].float()).sum(-1)
            dh[rows] = dh_unit[rows] * weight[rows, None]
            hw[rows] = h[rows] * weight[rows, None]
        del dh_unit, h
        dest, past = _destinations(token, offsets, x.shape[0])
        d_weight.masked_fill_(past, 0)
        dw2 = _dw(hw, dyu, offsets, groups)
        del hw, dyu
        dgu = torch.empty_like(gu)
        torch.mul(dh, s, out=dgu[:, width:])
        dgu[:, :width] = torch.ops.aten.silu_backward(dh * u, g)
        del dh, s, gu, g, u
        dxs = _mm(dgu, w13c.transpose(1, 2), offsets, "dx")
        dw13 = _dw(xs, dgu, offsets, groups)
        del dgu, xs
        dx = torch.zeros((x.shape[0] + 1, x.shape[1]), dtype=torch.float32,
                         device=x.device)
        for rows in _chunks(token.shape[0]):
            dx.index_add_(0, dest[rows], dxs[rows].float())
        return dx[:-1].to(dt), d_weight, dw13, dw2, None, None


def routed_experts(x, weight, w13, w2, token, offsets) -> torch.Tensor:
    return RoutedExperts.apply(x, weight, w13, w2, token, offsets)
