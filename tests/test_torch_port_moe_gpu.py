"""The expert layer's grouped products (ops/moe.py, the library's grouped
GEMM on CUDA tensors), its row kernels (ops/csrc/moe_rows.cu) against
their plain versions, and the Moonlight model's attention
(models/moonlight.py) on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
CUDA path has no CPU mode; tests/test_torch_port_moonlight.py holds the
plain version and the model on the CPU).  The file imports no JAX, so it
runs on the card, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -rs \\
        tests/test_torch_port_moe_gpu.py
"""

import pytest
import torch
import torch.nn.functional as F

from cs744_ddp_tpu_torch.models import layers, moonlight
from cs744_ddp_tpu_torch.ops import moe

# The products at the published widths: gate-and-up (2048 -> 2 x 1408) and
# down (1408 -> 2048) over the 8 experts a chip holds.
WIDTHS = [(2048, 2816), (1408, 2048)]
GROUPS = 8
ROWS = 6144
# Loads: (rows of each group; the rest of the buffer belongs to none).
LOADS = {
    "uneven": [1000, 3, 517, 0, 2048, 129, 64, 1],
    "empty_groups": [0, 0, 700, 0, 0, 1300, 0, 0],
    "one_hot": [0, 0, 0, 0, 0, ROWS, 0, 0],
}
# The library against torch.matmul of the same bf16 operands: both sum in
# f32 in another order, then the products round once to bf16 (dW too,
# before its cast to f32), so a few elements differ by one bf16 step; the
# relative L2 gap of the whole output stays within a bf16 rounding (2^-8).
BF16_RTOL = 4e-3
# The row kernels at the published widths over 1,024 tokens' top 6: loads
# of held rows per held expert, the rest of the 6,144 rows of no group.
TOKENS, TOP_K, HIDDEN, WIDTH = 1024, 6, 2048, 1408
SLOTS = TOKENS * TOP_K
ROUTE_LOADS = {
    "uneven": [1000, 3, 517, 0, 2048, 129, 64, 1],
    "empty_groups": [0, 0, 700, 0, 0, 1300, 0, 0],
    "one_hot": [0, 0, 0, 0, 0, 3000, 0, 0],
    "all_held": [SLOTS // GROUPS] * GROUPS,
}
# f32 sums of the same products in another order (the plain version's
# atomics, its reduction tree): a few f32 roundings of the largest term.
SUM_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _offsets(counts, device):
    out = torch.zeros(len(counts) + 1, dtype=torch.int32)
    out[1:] = torch.cumsum(torch.tensor(counts), 0)
    return out.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", WIDTHS)
@pytest.mark.parametrize("load", sorted(LOADS))
def test_grouped_mm_matches_per_group_matmul(cuda, k, n, load):
    counts = LOADS[load]
    gen = torch.Generator(device=cuda).manual_seed(k + n + len(load))
    x = torch.randn(ROWS + 128, k, device=cuda, generator=gen).bfloat16()
    w = (torch.randn(GROUPS, k, n, device=cuda, generator=gen) * 0.02)
    dy = torch.randn(ROWS + 128, n, device=cuda, generator=gen).bfloat16()
    offsets = _offsets(counts, cuda)
    before = moe.executed_counts()
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    y = moe.grouped_mm(xr, wr, offsets)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    torch.cuda.synchronize()
    total = sum(counts)
    assert torch.count_nonzero(y[total:]) == 0
    assert torch.count_nonzero(dx[total:]) == 0
    assert dw.dtype == torch.float32
    lo = 0
    for g, c in enumerate(counts):
        wg = w[g].bfloat16()
        if c:
            rows = slice(lo, lo + c)
            assert _rel(y[rows], x[rows] @ wg) < BF16_RTOL
            assert _rel(dx[rows], dy[rows] @ wg.t()) < BF16_RTOL
            assert _rel(dw[g], x[rows].float().t() @ dy[rows].float()) \
                < BF16_RTOL
        else:
            assert torch.count_nonzero(dw[g]) == 0
        lo += c
    after = moe.executed_counts()
    assert {r: after[r] - before[r] for r in ("fwd", "dx", "dw")} == \
        {"fwd": 1, "dx": 1, "dw": 1}
    assert after["flops"] - before["flops"] == 3 * 2 * total * k * n


@pytest.mark.gpu
def test_grouped_mm_refuses_f32_on_the_card(cuda):
    """The library's grouped GEMM takes bf16 only; f32 operands on the
    card are refused, not run another way, and count no run."""
    x = torch.randn(64, 256, device=cuda)
    w = torch.randn(2, 256, 128, device=cuda)
    offsets = _offsets([30, 20], cuda)
    before = moe.executed_counts()
    with pytest.raises(TypeError, match="bf16"):
        moe.grouped_mm(x, w, offsets)
    assert moe.executed_counts() == before


def _moe_layer(device):
    c = moonlight.MoonlightConfig(num_hidden_layers=2, held_experts=8,
                                  vocab_size=1024)
    layer = moonlight.MoE(c)
    layers.reset_parameters(layer, torch.Generator().manual_seed(5))
    return layer.to(device)


@pytest.mark.gpu
def test_captured_moe_step_replays_new_routing(cuda):
    """Forward and backward of the expert layer at the published widths,
    captured once into a CUDA graph; replayed on new inputs (another
    routing, other row counts) it gives what the eager layer gives on
    them, and its row kernels work on each step's held rows."""
    layer = _moe_layer(cuda)
    params = list(layer.parameters())
    tokens = 4096
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(tokens, 2048, device=cuda, generator=gen).bfloat16()
    probe = torch.randn(tokens, 2048, device=cuda, generator=gen)
    grads = [torch.zeros_like(p) for p in params]
    out = torch.zeros(tokens, 2048, device=cuda)

    def step():
        xi = x.detach().requires_grad_(True)
        y = layer(xi)
        got = torch.autograd.grad((y.float() * probe).sum(), [xi] + params)
        out.copy_(y.float())
        for g, d in zip(grads, got[1:]):
            g.copy_(d)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    before = moe.executed_counts()
    for seed in (12, 13):
        gen.manual_seed(seed)
        x.copy_(torch.randn(tokens, 2048, device=cuda, generator=gen)
                .bfloat16() * (1 + seed % 2))
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone(), [g.clone() for g in grads]
        step()
        torch.cuda.synchronize()
        assert _rel(replayed[0], out) < 1e-3
        for a, b in zip(replayed[1], grads):
            assert _rel(a, b) < 1e-3
    after = moe.executed_counts()
    # Two replays and two eager steps, each 2 forward products a layer.
    assert after["fwd"] - before["fwd"] == 8
    assert after["rows"] - before["rows"] > 0
    # Each step's 7 row kernels (3 gathers, the SwiGLU, 2 combines, the
    # fused backward) worked on that step's held rows, of 4096 x 6 each.
    assert after["row_rows"] - before["row_rows"] == \
        7 * (after["rows"] - before["rows"])
    assert after["row_capacity"] - before["row_capacity"] == \
        4 * 7 * tokens * 6


def _routing(counts, device, seed):
    """(token, offsets, inv, weight) of a routing whose held experts get
    ``counts`` rows, placed at random among the ``SLOTS`` flat rows, the
    rest of no group; router weights in (0, 2.446)."""
    gen = torch.Generator().manual_seed(seed)
    group = torch.full((SLOTS,), GROUPS, dtype=torch.int64)
    perm = torch.randperm(SLOTS, generator=gen)
    lo = 0
    for g, c in enumerate(counts):
        group[perm[lo:lo + c]] = g
        lo += c
    order, offsets, inv = moe.sort_rows(group.to(device), GROUPS)
    weight = torch.where(group < GROUPS,
                         torch.rand(SLOTS, generator=gen) * 2.446, 0.0)
    token = torch.div(order, TOP_K, rounding_mode="floor")
    return token, offsets, inv, weight.to(device).index_select(0, order)


def _poisoned(t, held):
    """``t`` with every row past the held ones NaN."""
    t = t.clone()
    t[held:] = float("nan")
    return t


def _ulps(a, b):
    """Largest distance in bf16 steps between two bf16 tensors."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _row_operands(cuda, held, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(TOKENS, HIDDEN, device=cuda, generator=gen).bfloat16()
    dout = torch.randn(TOKENS, HIDDEN, device=cuda, generator=gen)
    gu = torch.randn(SLOTS, 2 * WIDTH, device=cuda, generator=gen) * 2
    dh_unit = torch.randn(SLOTS, WIDTH, device=cuda, generator=gen) * 0.1
    rows = torch.randn(SLOTS, HIDDEN, device=cuda, generator=gen)
    return x, dout, *(_poisoned(t.bfloat16(), held)
                      for t in (gu, dh_unit, rows))


@pytest.mark.gpu
@pytest.mark.parametrize("load", sorted(ROUTE_LOADS))
def test_row_kernels_match_plain(cuda, load):
    """Each row kernel against its plain version on the same inputs, every
    input row past the held ones NaN: the gathers bit for bit, the SwiGLU
    and the fused backward's bf16 outputs within one bf16 step, the f32
    sums within ``SUM_RTOL``; the router-weight gradient zero past the
    held rows; the device counters add the held and the static rows of
    each launch, the wrappers count each launch."""
    token, offsets, inv, weight = _routing(ROUTE_LOADS[load], cuda, 3)
    held = int(offsets[-1])
    x, dout, gu, dh_unit, rows = _row_operands(cuda, held, 4)
    bf16 = torch.bfloat16
    before, launched = moe.executed_counts(), moe.launch_counts()
    for src in (x, dout):
        got = moe.gather_rows(src, token, offsets, bf16)
        want = moe.gather_rows_reference(src, token, offsets, bf16)
        assert torch.equal(got[:held], want[:held])
    got = moe.swiglu_rows(gu, WIDTH, offsets)
    want = moe.swiglu_rows_reference(gu, WIDTH, offsets)
    assert torch.isfinite(got[:held]).all()
    assert _ulps(got[:held], want[:held]) <= 1
    out = moe.combine_tokens(rows, weight, token, inv, offsets, TOKENS)
    torch.testing.assert_close(
        out, moe.combine_tokens_reference(rows, weight, token, inv, offsets,
                                          TOKENS),
        rtol=SUM_RTOL, atol=SUM_RTOL)
    dx = moe.combine_token_grads(rows, token, inv, offsets, TOKENS, bf16)
    want = moe.combine_token_grads_reference(rows, token, inv, offsets,
                                             TOKENS, bf16)
    assert torch.isfinite(dx).all() and _ulps(dx, want) <= 1
    d_weight, hw, dgu = moe.rows_backward(gu, dh_unit, weight, offsets)
    rd_weight, rhw, rdgu = moe.rows_backward_reference(gu, dh_unit, weight,
                                                       offsets)
    assert torch.count_nonzero(d_weight[held:]) == 0
    torch.testing.assert_close(d_weight, rd_weight, rtol=SUM_RTOL,
                               atol=SUM_RTOL)
    for a, b in ((hw, rhw), (dgu, rdgu)):
        assert torch.isfinite(a[:held]).all()
        assert _ulps(a[:held], b[:held]) <= 1
    torch.cuda.synchronize()
    after, now = moe.executed_counts(), moe.launch_counts()
    assert after["row_rows"] - before["row_rows"] == 6 * held
    assert after["row_capacity"] - before["row_capacity"] == 6 * SLOTS
    assert {k: now[k] - launched[k] for k in now} == {
        "gather_rows": 2, "swiglu_rows": 1, "combine_tokens": 1,
        "combine_token_grads": 1, "rows_backward": 1}


def _layer_operands(cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(TOKENS, HIDDEN, device=cuda, generator=gen).bfloat16()
    w13 = torch.randn(GROUPS, HIDDEN, 2 * WIDTH, device=cuda,
                      generator=gen) * 0.02
    w2 = torch.randn(GROUPS, WIDTH, HIDDEN, device=cuda, generator=gen) \
        * 0.02
    probe = torch.randn(TOKENS, HIDDEN, device=cuda, generator=gen)
    return x, w13, w2, probe


def _layer(x, weight, w13, w2, token, offsets, inv, probe):
    """The expert layer's output and its gradients of x, the router
    weights and both masters."""
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, w13, w2)]
    out = moe.routed_experts(*leaves, token, offsets, inv)
    grads = torch.autograd.grad((out * probe).sum(), leaves)
    torch.cuda.synchronize()
    return [out.detach()] + list(grads)


def _plain_rows(monkeypatch):
    for name in moe.ROW_KERNELS:
        monkeypatch.setattr(moe, name, getattr(moe, f"{name}_reference"))


@pytest.mark.gpu
@pytest.mark.parametrize("load", sorted(ROUTE_LOADS))
def test_routed_experts_matches_plain_rows(cuda, load, monkeypatch):
    """The expert layer's forward and backward with the row kernels against
    the same layer with the plain row-wise passes (the library's products
    in both): the f32 output and router-weight gradient within the f32
    sums' order, the bf16-derived gradients within a bf16 rounding."""
    token, offsets, inv, weight = _routing(ROUTE_LOADS[load], cuda, 5)
    x, w13, w2, probe = _layer_operands(cuda, 6)
    args = (x, weight, w13, w2, token, offsets, inv, probe)
    got = _layer(*args)
    _plain_rows(monkeypatch)
    want = _layer(*args)
    names = ("out", "dx", "d_weight", "dw13", "dw2")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and torch.isfinite(a).all(), name
        limit = 1e-4 if a.dtype == torch.float32 and name in (
            "out", "d_weight") else BF16_RTOL
        assert _rel(a, b) < limit, (name, _rel(a, b))


@pytest.mark.gpu
def test_rows_past_the_held_ones_are_never_read(cuda, monkeypatch):
    """Every row buffer's rows past ``offsets[-1]`` NaN, as each product
    and row kernel hands it on: the layer's output and every gradient are
    bit for bit those of the unpoisoned layer."""
    token, offsets, inv, weight = _routing(ROUTE_LOADS["uneven"], cuda, 7)
    held = int(offsets[-1])
    x, w13, w2, probe = _layer_operands(cuda, 8)
    args = (x, weight, w13, w2, token, offsets, inv, probe)
    want = _layer(*args)

    def poison(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if isinstance(out, tuple):       # rows_backward: hw and dgu
                return (out[0],) + tuple(_poisoned(t, held)
                                         for t in out[1:])
            return _poisoned(out, held) if out.shape[0] == SLOTS else out
        return wrapped
    for name in ("_mm", "gather_rows", "swiglu_rows", "rows_backward"):
        monkeypatch.setattr(moe, name, poison(getattr(moe, name)))
    got = _layer(*args)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.gpu
def test_combine_is_bitwise_run_to_run(cuda):
    """Both combines, and the whole layer's output and gradients, are the
    same bits on every run: each token row is written once, its slots
    summed in order, no atomics."""
    token, offsets, inv, weight = _routing(ROUTE_LOADS["all_held"], cuda, 9)
    _, _, _, _, rows = _row_operands(cuda, SLOTS, 10)
    runs = [(moe.combine_tokens(rows, weight, token, inv, offsets, TOKENS),
             moe.combine_token_grads(rows, token, inv, offsets, TOKENS,
                                     torch.bfloat16)) for _ in range(3)]
    for a, b in runs[1:]:
        assert torch.equal(a, runs[0][0]) and torch.equal(b, runs[0][1])
    x, w13, w2, probe = _layer_operands(cuda, 11)
    args = (x, weight, w13, w2, token, offsets, inv, probe)
    first = _layer(*args)
    for a, b in zip(_layer(*args), first):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_layer_runs_no_plain_row_pass_on_the_card(cuda):
    """On CUDA the expert layer's forward and backward call no
    ``index_add_`` or ``index_select`` and no cast, product or activation
    over a [rows, width] buffer: every row-wise pass is a kernel of
    csrc/moe_rows.cu (and the products the library's)."""
    from torch.profiler import ProfilerActivity, profile
    token, offsets, inv, weight = _routing(ROUTE_LOADS["uneven"], cuda, 12)
    x, w13, w2, probe = _layer_operands(cuda, 13)
    _layer(x, weight, w13, w2, token, offsets, inv, probe)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _layer(x, weight, w13, w2, token, offsets, inv, probe)
    allowed = ("aten::empty", "aten::empty_like", "aten::_grouped_mm",
               "aten::t",
               "aten::transpose", "aten::as_strided", "aten::detach",
               "aten::slice", "aten::view", "aten::reshape", "aten::alias",
               "aten::contiguous", "aten::empty_strided", "aten::resize_",
               "aten::clone", "aten::result_type")
    bad = []
    for e in prof.events():
        if e.device_type.name != "CPU" or not e.name.startswith("aten::"):
            continue
        if e.name in ("aten::index_add_", "aten::index_select"):
            bad.append(e.name)
        wide = any(len(s) == 2 and s[0] == SLOTS and s[1] > 1
                   for s in e.input_shapes if isinstance(s, list))
        if wide and e.name not in allowed:
            bad.append((e.name, e.input_shapes))
    assert not bad, bad
    kernels = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    assert not any("indexFunc" in k for k in kernels), kernels
    for fragment in moe.PROFILED.values():
        assert any(fragment in k for k in kernels), (fragment, kernels)


@pytest.mark.gpu
def test_attention_runs_a_fused_backend(cuda):
    """The MLA attention at the cell's sizes (16 heads, 192-wide q and k,
    v padded to 192, causal over 8,192 positions) runs forward and
    backward on a fused kernel, never on the math backend (which would
    build 16 x 8192^2 scores)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = (torch.randn(1, 16, 8192, 192, device=cuda,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = moonlight._fused_attention(q, k, v, 192 ** -0.5)
        o.float().sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    fused = [n for n in names if any(f in n for f in (
        "flash", "fmha", "sdpa", "attention"))]
    assert fused, names
    assert not any("softmax" in n.lower() for n in names), names
    ref = F.scaled_dot_product_attention(q.float()[:, :2, :512],
                                         k.float()[:, :2, :512],
                                         v.float()[:, :2, :512],
                                         is_causal=True,
                                         scale=192 ** -0.5)
    assert _rel(o[:, :2, :512], ref) < 1e-2
