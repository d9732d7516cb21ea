"""The fused BN->ReLU->MaxPool's forward kernels (ops/bnpool.py
``bnpool_stats``, ``bnpool_norm_pool``; csrc/bnpool.cu) against their plain
PyTorch version, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode; tests/test_torch_port_bnpool.py holds their
partitions and checks on the CPU).  The file imports no JAX, so it runs on
the card, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -rs \\
        tests/test_torch_port_bnpool_gpu.py
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from cs744_ddp_tpu_torch.ops import bnpool

# [N, C, H, W] of VGG-11's five pool blocks at batch 256.
SHAPES = [(256, 64, 32, 32), (256, 128, 16, 16), (256, 256, 8, 8),
          (256, 512, 4, 4), (256, 512, 2, 2)]
DTYPES = [torch.float32, torch.bfloat16]
# The statistics against exact (f64) ones, relative to each channel's scale
# |mean| + std for the mean, var for the f32 two-pass var and E[x^2] for the
# bf16 one-pass var (its E[x^2] - mean^2 cancels that much): f32 sums of at
# most a few dozen rows a thread, added in f64, then one f32 rounding, are
# within a few 1e-7.
STATS_RTOL = 1e-6
# The same against batch_stats, whose own f32 reductions add their error.
PLAIN_STATS_RTOL = 1e-5
# A whole VGG-11 step, kernel forward against plain forward, as L2 over
# every leaf (the gradients; the BN running statistics).  The two forwards'
# statistics differ in their last bits, and each block of the network
# makes such a difference about ten times larger (a pool window routed to
# another near-equal element moves every leaf below it), so the yardstick
# is what equally valid statistics do to the same step: in f32 (TF32 off,
# as the f32 cell trains) the plain forward with the statistics computed
# in f64 and rounded once; in bf16 tests/test_torch_port_precision.py's
# rule, the plain forward's bf16 step against its f32 step.  The kernel
# forward may be no further from the plain forward than STEP_FACTOR times
# that; the loss within LOSS_RTOL (the kernel test's f32 tolerance, the
# precision test's bf16 one).
STEP_FACTOR = 1.5
LOSS_RTOL = {torch.float32: 5e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, dtype, seed, device):
    """x as a convolution leaves it (channels_last, each channel with its
    own offset and scale, 30% of the values rounded to halves: exact ties
    in the pool windows), gamma and beta."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device=device)
    x = x * (torch.rand(c, generator=g, device=device) * 2 + 0.2) \
        + torch.randn(c, generator=g, device=device) * 3
    tie = torch.rand((n, h, w, c), generator=g, device=device) < 0.3
    x = torch.where(tie, torch.round(x * 2) / 2, x).to(dtype)
    gamma = torch.randn(c, generator=g, device=device) * 0.5 + 1.0
    beta = torch.randn(c, generator=g, device=device) * 0.2
    return x.permute(0, 3, 1, 2), gamma, beta


def _counts(dtype, runs):
    want = dict.fromkeys(bnpool.KERNELS, 0)
    want.update({bnpool.kernel_name(k, dtype): runs for k in bnpool.FORWARD})
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_kernels_round_as_the_plain_version(cuda, shape, dtype):
    """pooled and xhat bit for bit the plain version's given the kernel's
    own statistics; one launch and one run of each forward kernel; the
    statistics bitwise equal run to run."""
    x, gamma, beta = _inputs(shape, dtype, 1, cuda)
    bnpool.reset_launch_counts()
    pooled, xhat, mean, var, inv = bnpool.bn_relu_pool_forward(x, gamma,
                                                               beta)
    torch.cuda.synchronize()
    assert bnpool.launch_counts() == _counts(dtype, 1)
    assert bnpool.executed_counts() == _counts(dtype, 1)
    want_pooled, want_xhat = bnpool.normalize_relu_pool(x, mean, inv, gamma,
                                                        beta)
    assert xhat.dtype == pooled.dtype == dtype
    for t in (xhat, pooled):
        assert t.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(xhat, want_xhat.to(dtype))
    assert torch.equal(pooled, want_pooled)
    again = bnpool.bnpool_stats(x)
    for a, b in zip(again, (mean, var, inv)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_statistics_within_tolerance(cuda, shape, dtype):
    """mean, var and inv against f64 statistics of the same x within
    STATS_RTOL of each channel's scale, and against batch_stats within
    PLAIN_STATS_RTOL (both reasons above)."""
    x, _, _ = _inputs(shape, dtype, 2, cuda)
    mean, var, inv = bnpool.bnpool_stats(x)
    x64 = x.to(torch.float64)
    m64 = x64.mean((0, 2, 3))
    sq64 = x64.square().mean((0, 2, 3))
    v64 = (x64 - m64.view(1, -1, 1, 1)).square().mean((0, 2, 3))
    var_scale = v64 if dtype == torch.float32 else sq64
    mean_scale = m64.abs() + v64.sqrt()
    ve = v64 + bnpool.BN_EPS

    def errors(got, want):
        """Each statistic's largest error in its scale; inv's as the error
        of var + eps that it amounts to (d inv / inv = -d var / 2 ve)."""
        (m, v, i), (wm, wv, wi) = got, want
        return {"mean": ((m - wm).abs() / mean_scale).max().item(),
                "var": ((v - wv).abs() / var_scale).max().item(),
                "inv": ((i - wi).abs() / wi * 2 * ve / var_scale
                        ).max().item()}

    exact = errors((mean, var, inv), (m64, v64, ve.rsqrt()))
    assert max(exact.values()) <= STATS_RTOL, exact
    plain = errors((mean, var, inv), bnpool.batch_stats(x))
    assert max(plain.values()) <= PLAIN_STATS_RTOL, plain


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_in_x_propagates_as_in_the_plain_version(cuda, dtype):
    """A NaN in x makes its channel's statistics, xhat and every pooled
    value NaN, as the plain version's do; the other channels are
    untouched."""
    x, gamma, beta = _inputs(SHAPES[1], dtype, 3, cuda)
    c = 5
    x = x.clone()
    x[3, c, 7, 9] = float("nan")
    got = bnpool.bn_relu_pool_forward(x, gamma, beta)
    plain_mean, _, plain_inv = bnpool.batch_stats(x)
    plain_pooled, plain_xhat = bnpool.normalize_relu_pool(
        x, plain_mean, plain_inv, gamma, beta)
    pooled, xhat = got[0], got[1]
    for kernel, plain in ((pooled, plain_pooled),
                          (xhat, plain_xhat.to(dtype))):
        assert torch.equal(kernel.isnan(), plain.isnan())
        assert bool(kernel[:, c].isnan().all())
    for v in got[2:]:
        assert bool(v[c].isnan()) and not bool(v[:c].isnan().any())
    others = [i for i in range(x.shape[1]) if i != c]
    want_pooled, _ = bnpool.normalize_relu_pool(x, got[2], got[4], gamma,
                                                beta)
    assert torch.equal(pooled[:, others], want_pooled[:, others])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_in_a_cuda_graph_replayed_on_another_stream(cuda, dtype):
    """The statistics kernel's grid barriers keep no state between
    launches, and the wrappers allocate and never synchronise: the forward
    captured on one stream and replayed on another, beside an eager call,
    gives the eager outputs bit for bit."""
    x, gamma, beta = _inputs(SHAPES[0], dtype, 4, cuda)
    eager = bnpool.bn_relu_pool_forward(x, gamma, beta)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        captured = bnpool.bn_relu_pool_forward(x, gamma, beta)
    replay = torch.cuda.Stream()
    for _ in range(3):
        replay.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(replay):
            graph.replay()
        alongside = bnpool.bn_relu_pool_forward(x, gamma, beta)
        torch.cuda.synchronize()
        for a, b, e in zip(captured, alongside, eager):
            assert torch.equal(a, e) and torch.equal(b, e)


@pytest.mark.gpu
def test_vgg11_step_matches_the_plain_forward(cuda, monkeypatch):
    """One VGG-11 training step at batch 256 in f32 and in bf16 with the
    forward kernels against the plain forward's: the loss, every
    parameter's gradient and the BN running statistics (yardsticks
    above)."""
    from cs744_ddp_tpu_torch.models import get_model
    for name, value in (("deterministic", True), ("benchmark", False),
                        ("allow_tf32", False)):
        monkeypatch.setattr(torch.backends.cudnn, name, value)
    model = get_model("vgg11", seed=0).to(cuda).to(
        memory_format=torch.channels_last).train()
    g = torch.Generator(device=cuda).manual_seed(5)
    images = torch.randn((256, 3, 32, 32), generator=g, device=cuda
                         ).contiguous(memory_format=torch.channels_last)
    labels = torch.randint(0, 10, (256,), generator=g, device=cuda)

    def step(dtype):
        m = copy.deepcopy(model)
        loss = F.cross_entropy(m(images.to(dtype)).float(), labels)
        loss.backward()
        stats = [b for n, b in m.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
        return (loss.item(), torch.cat([p.grad.flatten()
                                        for p in m.parameters()]),
                torch.cat([b.flatten() for b in stats]))

    def exact_stats(x):
        x64 = x.to(torch.float64)
        mean = x64.mean((0, 2, 3))
        var = (x64 - mean.view(1, -1, 1, 1)).square().mean((0, 2, 3))
        return (mean.float(), var.float(),
                (var.float().double() + bnpool.BN_EPS).rsqrt().float())

    bnpool.reset_launch_counts()
    kernel = {dtype: step(dtype) for dtype in DTYPES}
    assert bnpool.launch_counts() == dict.fromkeys(bnpool.KERNELS, 5)
    monkeypatch.setattr(bnpool, "bnpool_norm_pool",
                        bnpool.normalize_relu_pool)
    monkeypatch.setattr(bnpool, "bnpool_stats", exact_stats)
    exact = step(torch.float32)
    monkeypatch.setattr(bnpool, "bnpool_stats", bnpool.batch_stats)
    plain = {dtype: step(dtype) for dtype in DTYPES}
    f32, bf16 = DTYPES
    for dtype in DTYPES:
        assert abs(kernel[dtype][0] - plain[dtype][0]) \
            <= LOSS_RTOL[dtype] * plain[dtype][0]
    for i in (1, 2):
        gap = {d: (kernel[d][i] - plain[d][i]).norm().item() for d in DTYPES}
        scale = {f32: (exact[i] - plain[f32][i]).norm().item(),
                 bf16: (plain[bf16][i] - plain[f32][i]).norm().item()}
        print(f"step gap {'grads' if i == 1 else 'stats'}: kernel vs plain "
              f"{gap}, yardstick {scale}")
        assert all(gap[d] <= STEP_FACTOR * scale[d] for d in DTYPES), \
            (gap, scale)
