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
  ``sort_rows(expert, groups)``: the row order, the offsets (from a
      device histogram) and the inverse permutation.

The expert layer's row-wise work (gathers, SwiGLU, the weighted combine
back to token order and the backward's fused row pass) runs on CUDA
tensors as hand-written kernels (``csrc/moe_rows.cu``) that read the held
count ``offsets[-1]`` on the device and touch no row past it; each has its
plain PyTorch version beside it (``*_reference``), which CPU and ``meta``
tensors take and which works over every row of the static buffers.

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
rows and its largest group's rows once a forward, on any device; every
row kernel adds the held rows and its buffer's static rows as it runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build

# What ``executed_counts`` reports: runs of each product on CUDA (the
# forward, the backward's input and weight gradients, and the forward
# recomputed in the expert layer's backward), the FLOPs of every such run
# (2 x rows x K x N), per expert-layer forward its held rows and its
# largest group's rows, and over every row kernel's run the held rows it
# worked on and the static rows of its buffers (adjacent: the kernels add
# to both through one pointer).
RUNS = ("fwd", "dx", "dw", "fwd_recompute")
KEYS = RUNS + ("flops", "rows", "rows_max", "row_rows", "row_capacity")

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
    adding to it) and the row kernels' launch counts."""
    for counter in _COUNTERS.values():
        counter.zero_()
    _LAUNCHES.update(dict.fromkeys(ROW_KERNELS, 0))


def launch_counts() -> Dict[str, int]:
    """Launches of each row kernel's wrapper so far (``ROW_KERNELS``):
    eager launches and launches recorded into a CUDA graph, each once."""
    return dict(_LAUNCHES)


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
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, offsets, inv) of ``group`` [R] int64, each row's group in
    ``0 .. groups`` (``groups`` marks a row of no group): ``order`` [R]
    int64 the rows by group, stably, the rows of no group last; ``offsets``
    int32 [groups + 1] from a device histogram; ``inv`` int32 [R] each
    row's position in ``order`` (``inv[order] == arange(R)``).  No host
    read."""
    order = torch.sort(group, stable=True).indices
    hist = torch.zeros(groups + 1, dtype=torch.int64, device=group.device)
    hist.scatter_add_(0, group, torch.ones_like(group))
    offsets = torch.zeros(groups + 1, dtype=torch.int32, device=group.device)
    offsets[1:] = torch.cumsum(hist[:groups], 0)
    inv = torch.empty(order.shape, dtype=torch.int32, device=group.device)
    inv.scatter_(0, order, torch.arange(order.shape[0], dtype=torch.int32,
                                        device=group.device))
    return order, offsets, inv


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


# Rows a step of the plain version's f32 row-wise work takes: the static
# worst case is tokens x top-k rows (294,912 at the Moonlight cell), whose
# f32 [rows, hidden] products would each take 2.4 GB at once.
CHUNK_ROWS = 1 << 16


def _chunks(n: int):
    return [slice(lo, min(lo + CHUNK_ROWS, n))
            for lo in range(0, n, CHUNK_ROWS)]


def _destinations(token: torch.Tensor, offsets: torch.Tensor, tokens: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each row's token for a scatter back to token order, the rows past
    the last group sent to row ``tokens``; those rows' mask)."""
    past = torch.arange(token.shape[0], device=token.device) >= offsets[-1]
    return torch.where(past, tokens, token), past


# ---------------------------------------------------------------------------
# Row-wise work: plain version (CPU and meta), over every row
# ---------------------------------------------------------------------------

def gather_rows_reference(src, token, offsets, dtype) -> torch.Tensor:
    """[R, H] in ``dtype``: row p is ``src[token[p]]`` rounded once."""
    return src.to(dtype).index_select(0, token)


def swiglu_rows_reference(gu, width: int, offsets) -> torch.Tensor:
    """[R, width]: ``silu(g) * u`` of ``gu = [g | u]``, each rounded."""
    return F.silu(gu[:, :width]) * gu[:, width:]


def combine_tokens_reference(ys, weight, token, inv, offsets,
                             tokens: int) -> torch.Tensor:
    """[T, H] f32: each token's rows of ``ys`` times their router weights,
    summed; the rows past the last group sent to a dropped row."""
    dest, _ = _destinations(token, offsets, tokens)
    out = torch.zeros((tokens + 1, ys.shape[1]), dtype=torch.float32,
                      device=ys.device)
    for rows in _chunks(token.shape[0]):
        out.index_add_(0, dest[rows], ys[rows] * weight[rows, None])
    return out[:tokens]


def combine_token_grads_reference(dxs, token, inv, offsets, tokens: int,
                                  dtype) -> torch.Tensor:
    """[T, H] in ``dtype``: each token's rows of ``dxs`` summed in f32."""
    dest, _ = _destinations(token, offsets, tokens)
    dx = torch.zeros((tokens + 1, dxs.shape[1]), dtype=torch.float32,
                     device=dxs.device)
    for rows in _chunks(token.shape[0]):
        dx.index_add_(0, dest[rows], dxs[rows].float())
    return dx[:-1].to(dtype)


def rows_backward_reference(gu, dh_unit, weight, offsets
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(d_weight [R] f32, hw [R, I], dgu [R, 2I]) from the rows' gate and
    up product ``gu``, their gradient before the router weight
    ``dh_unit`` and the weights: d_weight = <dh_unit, h> (zero past the
    last group), hw = h * weight, dgu the SwiGLU's backward of
    dh = dh_unit * weight."""
    width = dh_unit.shape[1]
    g, u = gu[:, :width], gu[:, width:]
    s = F.silu(g)
    h = s * u
    d_weight = torch.empty(weight.shape, dtype=torch.float32,
                           device=gu.device)
    dh, hw = torch.empty_like(dh_unit), torch.empty_like(h)
    for rows in _chunks(weight.shape[0]):
        d_weight[rows] = (dh_unit[rows] * h[rows].float()).sum(-1)
        dh[rows] = dh_unit[rows] * weight[rows, None]
        hw[rows] = h[rows] * weight[rows, None]
    del h
    past = torch.arange(weight.shape[0], device=gu.device) >= offsets[-1]
    d_weight.masked_fill_(past, 0)
    dgu = torch.empty_like(gu)
    torch.mul(dh, s, out=dgu[:, width:])
    dgu[:, :width] = torch.ops.aten.silu_backward(dh * u, g)
    return d_weight, hw, dgu


# ---------------------------------------------------------------------------
# Row-wise work: CUDA kernels (csrc/moe_rows.cu), held rows only
# ---------------------------------------------------------------------------

_SOURCE = "moe_rows.cu"
# Each kernel: blocks of _ROW_THREADS threads, one row (or token) a warp,
# walking its rows grid-stride in at most _ROW_BLOCKS blocks (eight for
# each of an H100's 132 streaming multiprocessors).  The grid comes from
# the buffer's static shape, so a captured graph replays it; a warp past
# the held count stops at once.
_ROW_THREADS = 256
_ROW_BLOCKS = 132 * 8
_MAX_TOP_K = 8
# Each wrapper: the keys of ``launch_counts``.
ROW_KERNELS = ("gather_rows", "swiglu_rows", "combine_tokens",
               "combine_token_grads", "rows_backward")
# Each wrapper's kernel in a torch.profiler trace, by name fragment.
PROFILED = {"gather_rows": "gather_rows_kernel",
            "swiglu_rows": "swiglu_rows_kernel",
            "combine_tokens": "combine_tokens_kernel<true>",
            "combine_token_grads": "combine_tokens_kernel<false>",
            "rows_backward": "rows_backward_kernel"}
_LAUNCHES: Dict[str, int] = dict.fromkeys(ROW_KERNELS, 0)


def _blocks(rows: int) -> int:
    return max(1, min(-(-rows // (_ROW_THREADS // 32)), _ROW_BLOCKS))


def _check_rows(name: str, width: int, offsets: torch.Tensor, *tensors
                ) -> None:
    """What the row kernels take: rows a whole number of 16-byte bf16
    vectors wide, int32 offsets, every tensor contiguous, 16-byte aligned
    and on one card."""
    if width % 8:
        raise ValueError(f"{name}: rows of {width} elements; the kernel "
                         f"takes a multiple of 8")
    if offsets.dtype != torch.int32:
        raise TypeError(f"{name}: offsets must be int32, got {offsets.dtype}")
    for t in (offsets,) + tensors:
        if t.device != offsets.device:
            raise ValueError(f"{name}: tensors on several devices: "
                             f"{offsets.device}, {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"16-byte aligned")


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Launch C entry point ``entry`` on the current stream with the row
    counters; count the launch."""
    counter = _counter(device)
    rows_at = counter.data_ptr() + counter.element_size() * \
        KEYS.index("row_rows")
    lib = _build.library(_SOURCE)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, rows_at, stream)
    _build.check(lib, err, name)
    _LAUNCHES[name] += 1


def _refuse(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 rows, got {t.dtype}")


def gather_rows(src, token, offsets, dtype) -> torch.Tensor:
    """[R, H] in ``dtype``: row p is ``src[token[p]]`` (``src`` [T, H]),
    rounded once.  CUDA tensors launch the gather kernel (bf16 out, ``src``
    bf16 or f32), which writes rows ``p < offsets[-1]`` only; other tensors
    take ``gather_rows_reference``."""
    if not src.is_cuda:
        return gather_rows_reference(src, token, offsets, dtype)
    if dtype != torch.bfloat16 or src.dtype not in (torch.bfloat16,
                                                    torch.float32):
        raise TypeError(f"gather_rows: bf16 rows from bf16 or f32, got "
                        f"{src.dtype} -> {dtype}")
    src = src.contiguous()
    rows, width = token.shape[0], src.shape[1]
    dst = torch.empty((rows, width), dtype=dtype, device=src.device)
    _check_rows("gather_rows", width, offsets, src, token, dst)
    if token.dtype != torch.int64:
        raise TypeError(f"gather_rows: token must be int64, got "
                        f"{token.dtype}")
    suffix = "bf16" if src.dtype == torch.bfloat16 else "f32"
    _launch("gather_rows", f"moe_gather_rows_{suffix}", src.device,
            src.data_ptr(), token.data_ptr(), offsets.data_ptr(),
            offsets.shape[0] - 1, dst.data_ptr(), rows, width, _blocks(rows))
    return dst


def swiglu_rows(gu, width: int, offsets) -> torch.Tensor:
    """[R, width]: ``bf16(bf16(silu(g)) * u)`` of ``gu = [g | u]``.  CUDA
    tensors launch the SwiGLU kernel over rows ``p < offsets[-1]``;
    other tensors take ``swiglu_rows_reference``."""
    if not gu.is_cuda:
        return swiglu_rows_reference(gu, width, offsets)
    _refuse("swiglu_rows", gu)
    rows = gu.shape[0]
    if gu.shape[1] != 2 * width:
        raise ValueError(f"swiglu_rows: gu {tuple(gu.shape)} is not "
                         f"[rows, 2 x {width}]")
    h = torch.empty((rows, width), dtype=gu.dtype, device=gu.device)
    _check_rows("swiglu_rows", width, offsets, gu, h)
    _launch("swiglu_rows", "moe_swiglu_rows", gu.device, gu.data_ptr(),
            offsets.data_ptr(), offsets.shape[0] - 1, h.data_ptr(), rows,
            width, _blocks(rows))
    return h


def _top_k(name: str, rows: int, tokens: int) -> int:
    k = rows // max(tokens, 1)
    if k * tokens != rows or not 0 < k <= _MAX_TOP_K:
        raise ValueError(f"{name}: {rows} rows are not 1 to {_MAX_TOP_K} "
                         f"slots of {tokens} tokens")
    return k


def combine_tokens(ys, weight, token, inv, offsets, tokens: int
                   ) -> torch.Tensor:
    """[T, H] f32: ``out[t]`` the sum over token t's slots j, in order, of
    ``weight[p] * ys[p]`` with ``p = inv[t*k + j]``, held rows only.  CUDA
    tensors launch the combine kernel (each token row written once, no
    atomics); other tensors take ``combine_tokens_reference``."""
    if not ys.is_cuda:
        return combine_tokens_reference(ys, weight, token, inv, offsets,
                                        tokens)
    _refuse("combine_tokens", ys)
    k = _top_k("combine_tokens", ys.shape[0], tokens)
    out = torch.empty((tokens, ys.shape[1]), dtype=torch.float32,
                      device=ys.device)
    _check_rows("combine_tokens", ys.shape[1], offsets, ys, weight, inv, out)
    _launch("combine_tokens", "moe_combine_tokens", ys.device, ys.data_ptr(),
            weight.data_ptr(), inv.data_ptr(), offsets.data_ptr(),
            offsets.shape[0] - 1, out.data_ptr(), tokens, k, ys.shape[1],
            _blocks(tokens))
    return out


def combine_token_grads(dxs, token, inv, offsets, tokens: int, dtype
                        ) -> torch.Tensor:
    """[T, H] in ``dtype``: each token's held rows of ``dxs`` summed in
    f32 in slot order, rounded once.  CUDA tensors launch the combine
    kernel unweighted (bf16 out); other tensors take
    ``combine_token_grads_reference``."""
    if not dxs.is_cuda:
        return combine_token_grads_reference(dxs, token, inv, offsets,
                                             tokens, dtype)
    _refuse("combine_token_grads", dxs)
    if dtype != torch.bfloat16:
        raise TypeError(f"combine_token_grads: bf16 out, got {dtype}")
    k = _top_k("combine_token_grads", dxs.shape[0], tokens)
    dx = torch.empty((tokens, dxs.shape[1]), dtype=dtype, device=dxs.device)
    _check_rows("combine_token_grads", dxs.shape[1], offsets, dxs, inv, dx)
    _launch("combine_token_grads", "moe_combine_token_grads", dxs.device,
            dxs.data_ptr(), inv.data_ptr(), offsets.data_ptr(),
            offsets.shape[0] - 1, dx.data_ptr(), tokens, k, dxs.shape[1],
            _blocks(tokens))
    return dx


def rows_backward(gu, dh_unit, weight, offsets
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_weight, hw, dgu) as ``rows_backward_reference`` gives them.  CUDA
    tensors launch one fused pass over the held rows (d_weight zero past
    them, hw and dgu unwritten there); other tensors take the plain
    version."""
    if not gu.is_cuda:
        return rows_backward_reference(gu, dh_unit, weight, offsets)
    _refuse("rows_backward", gu)
    _refuse("rows_backward", dh_unit)
    rows, width = dh_unit.shape
    if tuple(gu.shape) != (rows, 2 * width):
        raise ValueError(f"rows_backward: gu {tuple(gu.shape)} against "
                         f"dh_unit {tuple(dh_unit.shape)}")
    d_weight = torch.empty(rows, dtype=torch.float32, device=gu.device)
    hw, dgu = torch.empty_like(dh_unit), torch.empty_like(gu)
    _check_rows("rows_backward", width, offsets, gu, dh_unit, weight,
                d_weight, hw, dgu)
    _launch("rows_backward", "moe_rows_backward", gu.device, gu.data_ptr(),
            dh_unit.data_ptr(), weight.data_ptr(), offsets.data_ptr(),
            offsets.shape[0] - 1, d_weight.data_ptr(), hw.data_ptr(),
            dgu.data_ptr(), rows, width, _blocks(rows))
    return d_weight, hw, dgu


# ---------------------------------------------------------------------------
# The expert layer
# ---------------------------------------------------------------------------

class RoutedExperts(torch.autograd.Function):
    """The held experts' part of an expert layer, f32 ``[T, H]``:

        out[t] = sum over rows r of token t:  weight[r] * Y_r,
        Y = grouped(SwiGLU(grouped(X[token] , W13)), W2)

    ``x`` [T, H] the layer's input in the activation dtype, ``weight`` [R]
    f32 each row's router weight (0 for a row of no group), ``token`` [R]
    int64 each row's token, rows ordered by held expert, and ``inv`` [R]
    int32 the sorted position of flat row t*k + j (``sort_rows``); ``w13``
    [E, H, 2I] (gate then up) and ``w2`` [E, I, H] f32 masters.  Saved for
    the backward: ``x`` (which the shared expert keeps anyway), the row
    weights, order, inverse and offsets, and the weights' casts; the rows'
    gate-and-up product is recomputed there.  The products take a row's
    router weight by the identity d weight_r = <dout[token_r] W2^T, h_r>,
    so the backward recomputes no down product.  Each row-wise pass is a
    kernel of held rows on CUDA, its plain version elsewhere.  The rows
    past the last group are never zeroed: the library and the kernels
    leave them unwritten and nothing reads them (the plain version's
    scatters send them to a dropped row), and their router-weight gradient
    is zero."""

    @staticmethod
    def forward(ctx, x, weight, w13, w2, token, offsets, inv):
        dt, tokens = x.dtype, x.shape[0]
        w13c, w2c = w13.to(dt), w2.to(dt)
        xs = gather_rows(x, token, offsets, dt)
        h = swiglu_rows(_mm(xs, w13c, offsets, "fwd"), w2.shape[1], offsets)
        del xs
        ys = _mm(h, w2c, offsets, "fwd")
        del h
        ctx.save_for_backward(x, weight, w13c, w2c, token, offsets, inv)
        return combine_tokens(ys, weight, token, inv, offsets, tokens)

    @staticmethod
    def backward(ctx, dout):
        x, weight, w13c, w2c, token, offsets, inv = ctx.saved_tensors
        dt, groups = x.dtype, w2c.shape[0]
        xs = gather_rows(x, token, offsets, dt)
        gu = _mm(xs, w13c, offsets, "fwd_recompute")
        # The combine's gradient at each row, before its router weight.
        dyu = gather_rows(dout, token, offsets, dt)
        dh_unit = _mm(dyu, w2c.transpose(1, 2), offsets, "dx")
        d_weight, hw, dgu = rows_backward(gu, dh_unit, weight, offsets)
        del gu, dh_unit
        dw2 = _dw(hw, dyu, offsets, groups)
        del hw, dyu
        dxs = _mm(dgu, w13c.transpose(1, 2), offsets, "dx")
        dw13 = _dw(xs, dgu, offsets, groups)
        del dgu, xs
        dx = combine_token_grads(dxs, token, inv, offsets, x.shape[0], dt)
        return dx, d_weight, dw13, dw2, None, None, None


def routed_experts(x, weight, w13, w2, token, offsets, inv) -> torch.Tensor:
    return RoutedExperts.apply(x, weight, w13, w2, token, offsets, inv)
