"""The port's fused BN->ReLU->MaxPool (cs744_ddp_tpu_torch/ops/bnpool.py)
against the reference package's JAX functions, on the CPU.

The oracle for the gradients is plain ``jax.grad`` through the same forward
math as ``bnpool_pallas._fwd_impl`` (``_ref_chain``, as
tests/test_bnpool_pallas.py uses it): the Pallas kernels themselves are not
needed.  On CPU tensors the port's wrappers run the kernels' plain PyTorch
version; the CUDA kernels are held against it by the GPU-only case here and
by chip_smoke.py.

Two places where bitwise identity with JAX cannot hold, and what is pinned
instead:
  * batch statistics: the two frameworks sum in different orders, so mean
    and var agree to f32 summation error (1e-5), not bitwise;
  * z = xhat*gamma + beta: XLA's CPU backend fuses it into one
    multiply-add, the port rounds product and sum separately (in its
    forward and in its kernels alike), so z — and the pooled output —
    agree within that one rounding.
Given the same statistics, the port's xhat is bitwise equal to JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from cs744_ddp_tpu.ops import bnpool_pallas as bp
from cs744_ddp_tpu_torch.ops import bnpool

SHAPES = [(16, 32, 32, 64), (8, 16, 16, 128), (4, 8, 8, 64)]


def _ref_chain(x, gamma, beta):
    """Autodiff oracle mirroring _fwd_impl (tests/test_bnpool_pallas.py)."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, (0, 1, 2))
    if x.dtype == jnp.bfloat16:
        var = jnp.maximum(
            jnp.mean(jnp.square(xf), (0, 1, 2)) - jnp.square(mean), 0.0)
    else:
        var = jnp.mean(jnp.square(xf - mean), (0, 1, 2))
    inv = lax.rsqrt(var + bp.BN_EPS)
    xhat = (xf - mean) * inv
    xhat_act = xhat.astype(x.dtype).astype(jnp.float32)
    z = (xhat_act * gamma + beta).astype(x.dtype)
    y = jnp.maximum(z, jnp.zeros((), x.dtype))
    return lax.reduce_window(y, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


def _inputs(shape, seed):
    """x with injected exact ties (values rounded to halves), gamma, beta
    and the pooled-output weights, from numpy."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    x = np.where(rng.random(shape) < 0.3, np.round(x * 2) / 2, x)
    gamma = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.2).astype(np.float32)
    wts = rng.standard_normal((n, h // 2, w // 2, c)).astype(np.float32)
    return x.astype(np.float32), gamma, beta, wts


def _nchw(a, dtype=torch.float32):
    """NHWC numpy -> NCHW-logical channels_last torch."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(
        0, 3, 1, 2)


def _nhwc(t):
    return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_fns():
    fwd = jax.jit(bp._fwd_impl)

    def loss_ref(x, g, b, w):
        return jnp.sum(_ref_chain(x, g, b).astype(jnp.float32) * w)

    grad = jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2)))
    return fwd, grad


def _port_grads(x, gamma, beta, wts, dtype):
    xt = _nchw(x, dtype).requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    pooled, _, _ = bnpool.BnReluPool.apply(xt, g, b)
    (pooled.to(torch.float32) * _nchw(wts)).sum().backward()
    return pooled, xt.grad, g.grad, b.grad


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_fwd_impl(jax_fns, shape):
    fwd, _ = jax_fns
    x, gamma, beta, _ = _inputs(shape, 0)
    pj, xhj, mj, vj, ij = (np.array(a) for a in fwd(x, gamma, beta))
    pooled, xhat, mean, var, inv = bnpool.bn_relu_pool_forward(
        _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    assert pooled.is_contiguous(memory_format=torch.channels_last)
    # f32 sums over up to 16k elements, in different orders.
    np.testing.assert_allclose(mean.numpy(), mj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), vj, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(pooled), pj, rtol=1e-5, atol=1e-5)
    # Same statistics -> the residual is bitwise equal, and the pooled
    # output differs from XLA's fused multiply-add by at most the one
    # rounding of the product xhat*gamma that the port does and XLA skips.
    p2, xh2 = bnpool.normalize_relu_pool(
        _nchw(x), torch.from_numpy(mj), torch.from_numpy(ij),
        torch.from_numpy(gamma), torch.from_numpy(beta))
    np.testing.assert_array_equal(_nhwc(xh2), xhj)
    one_rounding = np.spacing(np.float32(np.abs(xhj).max()
                                         * np.abs(gamma).max()))
    np.testing.assert_allclose(_nhwc(p2), pj, rtol=0, atol=one_rounding)


def test_forward_rejects_odd_spatial_dims():
    x = torch.zeros((2, 4, 6, 5))
    with pytest.raises(ValueError, match="even H and W"):
        bnpool.bn_relu_pool_forward(x, torch.ones(4), torch.zeros(4))


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_backward_matches_autodiff_f32(jax_fns, shape):
    _, grad = jax_fns
    x, gamma, beta, wts = _inputs(shape, 1)
    want = grad(x, gamma, beta, wts)
    _, dx, dg, db = _port_grads(x, gamma, beta, wts, torch.float32)
    # f32 reduction order (and the stats' last ulps) are the only
    # differences: the tolerance of tests/test_bnpool_pallas.py.
    for got, ref, name in ((_nhwc(dx), want[0], "dx"),
                           (dg.numpy(), want[1], "dgamma"),
                           (db.numpy(), want[2], "dbeta")):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-4,
                                   atol=1e-4, err_msg=name)


def test_fused_backward_bf16_routing_flips_are_rare_and_tie_shaped(jax_fns):
    """bf16 dx may differ from the oracle only at routing flips between
    window elements within a couple of bf16 ulps; the flip fraction stays
    tiny and every flip site is a genuine near-tie."""
    _, grad = jax_fns
    shape = (16, 32, 32, 64)
    x, gamma, beta, wts = _inputs(shape, 2)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    dref = np.asarray(grad(jnp.asarray(x).astype(jnp.bfloat16), gamma, beta,
                           wts)[0], np.float32)
    _, dx, _, _ = _port_grads(np.asarray(xb, np.float32), gamma, beta, wts,
                              torch.bfloat16)
    d = np.abs(_nhwc(dx) - dref)
    flip_sites = np.argwhere(d > 0.05)
    assert len(flip_sites) <= 2e-4 * d.size, len(flip_sites)
    xf = np.asarray(xb, np.float32)
    mean = xf.mean((0, 1, 2))
    var = np.maximum((xf ** 2).mean((0, 1, 2)) - mean ** 2, 0.0)
    inv = 1.0 / np.sqrt(var + bp.BN_EPS)
    xhat_act = np.asarray(jnp.asarray((xf - mean) * inv
                                      ).astype(jnp.bfloat16), np.float32)
    z = np.asarray(jnp.asarray(xhat_act * gamma + beta).astype(jnp.bfloat16),
                   np.float32)
    y = np.maximum(z, 0.0)
    for (n, h, wq, c) in flip_sites[:64]:
        win = y[n, (h // 2) * 2:(h // 2) * 2 + 2,
                (wq // 2) * 2:(wq // 2) * 2 + 2, c].reshape(-1)
        top2 = np.sort(win)[-2:]
        rel = abs(top2[1] - top2[0]) / (abs(top2[1]) + 1e-9)
        assert rel < 2e-2, (tuple(int(v) for v in (n, h, wq, c)),
                            win.tolist())


def test_backward_statistics_cotangents():
    """Gradients that flow through the mean/var outputs get the exact
    terms d mean/dx = 1/n and d var/dx = 2(x - mean)/n."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 4, 4)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    g = torch.ones(8)
    b = torch.zeros(8)
    wm = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    wv = torch.from_numpy(rng.standard_normal(8).astype(np.float32))

    xa = x.clone().requires_grad_(True)
    _, mean, var = bnpool.BnReluPool.apply(xa, g, b)
    ((mean * wm).sum() + (var * wv).sum()).backward()
    xb = x.clone().requires_grad_(True)
    m = xb.mean((0, 2, 3))
    v = (xb - m.reshape(1, -1, 1, 1)).square().mean((0, 2, 3))
    ((m * wm).sum() + (v * wv).sum()).backward()
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_wrapper_counts_only_kernel_launches_and_checks_inputs():
    x, gamma, beta, wts = _inputs((2, 4, 4, 8), 4)
    xhat, dp = _nchw(x), _nchw(wts)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    inv = torch.ones(8)
    bnpool.reset_launch_counts()
    dx, s_dy, s_dyx = bnpool.bnpool_backward(xhat, dp, g, b, inv)
    # CPU tensors take the plain version: no launch is counted.
    assert (bnpool.bnpool_sums.launches, bnpool.bnpool_dx.launches) == (0, 0)
    ref = bnpool.bnpool_backward_reference(xhat, dp, g, b, inv)
    for got, want in zip((dx, s_dy, s_dyx), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dp shape"):
        bnpool.bnpool_sums(xhat, dp[:, :, :1], g, b)
    with pytest.raises(TypeError, match="share a dtype"):
        bnpool.bnpool_sums(xhat, dp.to(torch.bfloat16), g, b)


# [N, C, H, W]: the five VGG-11 pool blocks at batch 256, then ragged ones
# (C not a multiple of 32, odd pooled widths, a single row, tiny C).
PARTITION_SHAPES = [(256, 64, 32, 32), (256, 128, 16, 16), (256, 256, 8, 8),
                    (256, 512, 4, 4), (256, 512, 2, 2), (3, 96, 6, 6),
                    (129, 96, 6, 6), (5, 24, 10, 2), (1, 8, 2, 2)]


def _kernel_windows(n, c, h, w, itemsize):
    """The (pooled row, wo, channel vector) triples each thread of the
    sums kernel takes, by the kernel's own stepping (csrc/bnpool.cu::sweep):
    windows grid-stride in (row, wo) order."""
    blocks = bnpool.sums_partition(n, c, h, w, itemsize)
    cv_count = c // (16 // itemsize)
    groups = bnpool._SUM_THREADS // cv_count
    rows, wo_count = n * (h // 2), w // 2
    step_r, step_w = divmod(blocks * groups, wo_count)
    taken = []
    for b in range(blocks):
        for g in range(groups):
            r, wo = divmod(b * groups + g, wo_count)
            while r < rows:
                taken += [(r, wo, cv) for cv in range(cv_count)]
                r, wo = r + step_r, wo + step_w
                if wo >= wo_count:
                    r, wo = r + 1, wo - wo_count
    return blocks, rows * wo_count * cv_count, taken


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", PARTITION_SHAPES)
def test_sums_partition_covers_every_window_once(shape, itemsize):
    n, c, h, w = shape
    blocks, windows, taken = _kernel_windows(n, c, h, w, itemsize)
    assert 1 <= blocks <= min(bnpool._SUM_BLOCKS, n * (h // 2))
    assert len(taken) == windows
    assert len(set(taken)) == windows
    # The partition is a function of the shape alone.
    assert blocks == bnpool.sums_partition(n, c, h, w, itemsize)


def test_sums_vector_path_checks():
    x = torch.zeros((2, 12, 4, 4)).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="multiple of 4"):
        bnpool._check_vector_path(x[:, :10], [x])
    wide = torch.zeros((1, 1032, 2, 2))
    with pytest.raises(ValueError, match="at most 1024"):
        bnpool._check_vector_path(wide, [wide])
    flat = torch.zeros(64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bnpool._check_vector_path(x, [x, flat[1:13]])
    bnpool._check_vector_path(x, [x, flat[4:16]])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 32, 32, 64), (129, 6, 6, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_version(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, gamma, beta, wts = _inputs(shape, 5)
    c = shape[-1]
    dev = torch.device("cuda")
    xhat = _nchw(x, dtype).to(dev)
    dp = _nchw(wts, dtype).to(dev)
    g = torch.from_numpy(gamma).to(dev)
    b = torch.from_numpy(beta).to(dev)
    inv = torch.full((c,), 0.5, device=dev)
    bnpool.reset_launch_counts()
    got = bnpool.bnpool_backward(xhat, dp, g, b, inv)
    torch.cuda.synchronize()
    assert (bnpool.bnpool_sums.launches, bnpool.bnpool_dx.launches) == (1, 1)
    want = bnpool.bnpool_backward_reference(xhat, dp, g, b, inv)
    tol = dict(rtol=5e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    # One launch, no float atomics: the sums are bitwise equal run to run.
    sums = bnpool.bnpool_sums(xhat, dp, g, b)
    assert torch.equal(sums, bnpool.bnpool_sums(xhat, dp, g, b))
    assert torch.equal(sums, torch.stack(got[1:]))


@pytest.mark.gpu
def test_cuda_sums_kernel_in_a_cuda_graph_replayed_on_another_stream():
    """The sums kernel's grid barrier keeps no state between launches: a
    graph captured on one stream and replayed on another, next to an eager
    launch on a third, gives the eager launch's sums bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, gamma, beta, wts = _inputs((16, 32, 32, 64), 6)
    dev = torch.device("cuda")
    xhat = _nchw(x, torch.float32).to(dev)
    dp = _nchw(wts, torch.float32).to(dev)
    g = torch.from_numpy(gamma).to(dev)
    b = torch.from_numpy(beta).to(dev)
    eager = bnpool.bnpool_sums(xhat, dp, g, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        captured = bnpool.bnpool_sums(xhat, dp, g, b)
    replay = torch.cuda.Stream()
    for _ in range(3):
        replay.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(replay):
            graph.replay()
        alongside = bnpool.bnpool_sums(xhat, dp, g, b)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        assert torch.equal(alongside, eager)
