"""The expert layer's grouped products (ops/moe.py, the library's grouped
GEMM on CUDA tensors) and the Moonlight model's attention
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
    them, within the atomics' f32 summation order."""
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
