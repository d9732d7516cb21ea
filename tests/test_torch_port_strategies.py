"""The port's gradient-sync strategies (cs744_ddp_tpu_torch/parallel)
against the reference package's, on the same per-rank gradients.

The reference runs each strategy under ``shard_map`` on ``make_mesh(world)``
(as tests/test_strategies.py does); the port runs its counterpart in
``world`` gloo processes (tests/torch_dist_worker.py), on the same
gradients and comm state, carried across with ``models/convert.py``.  The
gradients are those of a narrow VGG (conv HWIO/OIHW, BN vectors, a linear
layer).  Tolerances:

  * stateless tiers: atol 1e-6 (summation order of the f32 sums);
  * compress-int8: bitwise in output and residual (integer sums of the
    same quantized values, the same max'd scale, round-half-even on both
    sides);
  * compress-bf16, and powersgd's bf16 leaves: the residual bitwise; the
    output bitwise at world 2 (one rounded addition on both sides); at
    world 4 the bf16 partial sums are added in another order, each of the
    3 additions rounding by at most half a bf16 ulp of a partial sum, so
    the two sums differ by at most 3 ulps of sum_r |q_r|, which bounds
    every partial sum (one ulp of the sum itself is not a bound: where
    the ranks' values cancel, a partial sum is far larger than the sum);
  * powersgd's low-rank leaves: rtol 1e-4 / atol 1e-5 in output, residual
    and new Q, with the reference's Q carried across (f32 products in
    another order, then Gram-Schmidt).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
try:
    from jax import shard_map
except ImportError:                      # jax < 0.6: experimental namespace
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from cs744_ddp_tpu.parallel import bucketing as jbucketing
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.parallel import strategies as jstrategies
from cs744_ddp_tpu.parallel.mesh import DATA_AXIS
from cs744_ddp_tpu.train.step import _SHARD_MAP_KW
from cs744_ddp_tpu_torch.models import convert, get_model
from cs744_ddp_tpu_torch.models import vgg as tvgg
from cs744_ddp_tpu_torch.parallel import bucketing, get_strategy, strategies

import torch_dist_worker as worker

TIERS = ("gather", "allreduce", "ddp", "overlap", "compress-bf16",
         "compress-int8", "powersgd")
WORLDS = (2, 4)
STATELESS = ("gather", "allreduce", "ddp", "overlap")
# Collectives per call on the narrow VGG's 22 leaves (one bucket; 6
# low-rank leaves), by kind: all_reduce, all_reduce_max, gather, scatter,
# all_gather.
NARROW_COUNTS = {"gather": [0, 0, 22, 22, 0],
                 "allreduce": [22, 0, 0, 0, 0],
                 "ddp": [1, 0, 0, 0, 0], "overlap": [1, 0, 0, 0, 0],
                 "compress-bf16": [22, 0, 0, 0, 0],
                 "compress-int8": [22, 1, 0, 0, 0],
                 "powersgd": [2 * 6 + 16, 0, 0, 0, 0]}
CHANNELS = [3, 8, 16, 32, 64, 512]      # worker.NARROW_VGG's convolutions


def narrow_tree(rng, lead=()):
    """A params-like pytree of the narrow VGG, reference layout, normal
    entries, with leading axes ``lead``."""
    def n(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)
    pairs = list(zip(CHANNELS[:-1], CHANNELS[1:]))
    return {"conv": [{"w": n(3, 3, ci, co), "b": n(co)} for ci, co in pairs],
            "bn": [{"gamma": n(co), "beta": n(co)} for _, co in pairs],
            "fc1": {"w": n(512, 10), "b": n(10)}}


# The narrow VGG's parameter names in the reference's leaf order, the
# order of port_inputs' gradients and residuals.
NAMES = list(convert.params_from_jax(narrow_tree(np.random.default_rng(0))))


def jax_run(tier, world, grads, comm):
    strat = jstrategies.get_strategy(tier)
    mesh = make_mesh(world)
    if getattr(strat, "stateful", False):
        f = shard_map(
            lambda g, c: strat(jax.tree.map(lambda a: a[0], g), DATA_AXIS,
                               comm=c),
            mesh=mesh, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(), P(DATA_AXIS)), **_SHARD_MAP_KW)
        out, new = jax.jit(f)(grads, comm)
        return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, new)
    f = shard_map(lambda g: strat(jax.tree.map(lambda a: a[0], g), DATA_AXIS),
                  mesh=mesh, in_specs=(P(DATA_AXIS),), out_specs=P(),
                  **_SHARD_MAP_KW)
    return jax.tree.map(np.asarray, jax.jit(f)(grads)), None


def port_inputs(grads, comm, world, path):
    """Per-rank gradients and comm state in the port's layout, to ``path``;
    the parameter names in order and the Q factors' names."""
    arrays = {}
    for r in range(world):
        g = convert.params_from_jax(jax.tree.map(lambda a: a[r], grads))
        c = convert.comm_from_jax(comm, r, list(g))
        for n, t in g.items():
            arrays[f"g{r}/{n}"] = t.numpy()
        for n, t in zip(g, c["residual"]):
            arrays[f"r{r}/{n}"] = t.numpy()
        for n, t in c["q"].items():
            arrays[f"q{r}/{n}"] = t.numpy()
    np.savez(path, **arrays)
    return list(g), list(c["q"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, tier): (reference (out, comm), port per-rank npz)}."""
    tmp = str(tmp_path_factory.mktemp("port_strategies"))
    rng = np.random.default_rng(0)
    ranks, inputs = {}, {}
    for world in WORLDS:
        grads = narrow_tree(rng, (world,))
        comm = jstrategies.get_strategy("powersgd").init_comm(
            narrow_tree(rng), world)
        comm = {"residual": narrow_tree(rng, (world,)),
                "q": jax.tree.map(np.asarray, comm["q"])}
        names, q_names = port_inputs(grads, comm, world,
                                     os.path.join(tmp, f"in_w{world}.npz"))
        out = os.path.join(tmp, f"w{world}")
        os.makedirs(out)
        ranks[world] = worker.start({
            "world": world, "rdzv": f"file://{tmp}/rdzv_w{world}",
            "out": out, "tasks": [{
                "kind": "strategies", "tiers": list(TIERS), "names": names,
                "q_names": q_names,
                "inputs": os.path.join(tmp, f"in_w{world}.npz")}]}, tmp)
        inputs[world] = (grads, comm)
    results, bounds = {}, {}
    for world in WORLDS:                  # the reference, while ranks run
        grads, comm = inputs[world]
        for tier in TIERS:
            c = None
            if tier.startswith("compress"):
                c = {"residual": comm["residual"]}
            elif tier == "powersgd":
                c = comm
            results[world, tier] = jax_run(tier, world, grads, c)
        bounds[world] = bf16_abs_sum(grads, comm, world)
    for world in WORLDS:
        ranks[world].wait(timeout=300)
    port = {w: [np.load(os.path.join(tmp, f"w{w}", f"strategies_r{r}.npz"))
                for r in range(w)] for w in WORLDS}
    return results, port, bounds


def _port_tree(npz, prefix):
    return convert.params_to_jax(
        {k[len(prefix):]: npz[k] for k in npz.files if k.startswith(prefix)})


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.abs(x.astype(np.float64))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-300)))
                                   - 7), 2.0 ** -133)


def bf16_abs_sum(grads, comm, world):
    """Per element, the sum over the ranks of |bf16(g + residual)|: it
    bounds every partial sum of the bf16 all-reduce."""
    total = None
    for r in range(world):
        v = jax.tree.map(lambda g, c: g[r] + c[r], grads, comm["residual"])
        q = jax.tree.map(lambda a: np.abs(torch.from_numpy(a).to(
            torch.bfloat16).double().numpy()), v)
        total = q if total is None else jax.tree.map(np.add, total, q)
    return total


def _low_rank_leaves(tree):
    strat = jstrategies.get_strategy("powersgd")
    return jax.tree.map(lambda a: strat._low_rank(a.shape), tree)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("world", WORLDS)
def test_tier_matches_reference_on_the_same_gradients(runs, world, tier):
    results, port, bounds = runs
    (want, want_comm) = results[world, tier]
    low = _low_rank_leaves(want) if tier == "powersgd" else \
        jax.tree.map(lambda a: False, want)
    for npz in port[world]:
        assert npz[f"{tier}/counts"].tolist() == NARROW_COUNTS[tier]
    outs = [_port_tree(npz, f"{tier}/out/") for npz in port[world]]
    for r, got in enumerate(outs):
        for g, w, lr, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                               jax.tree.leaves(low),
                               jax.tree.leaves(bounds[world])):
            msg = f"{tier} world {world} rank {r}"
            if tier in STATELESS:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=msg)
            elif tier == "compress-int8":
                np.testing.assert_array_equal(g, w, err_msg=msg)
            elif lr:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=msg)
            elif world == 2:
                np.testing.assert_array_equal(g, w, err_msg=msg)
            else:
                diff = np.abs(g.astype(np.float64) - w) * world
                assert np.all(diff <= (world - 1) * bf16_ulp(b)), msg
    # Every rank holds the same result, bit for bit.
    for got in outs[1:]:
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(outs[0])):
            np.testing.assert_array_equal(a, b)
    if want_comm is None:
        return
    per_rank = []
    for npz in port[world]:
        c = {"residual": [npz[f"{tier}/res/{n}"] for n in NAMES]}
        if tier == "powersgd":
            c["q"] = {k[len(f"{tier}/q/"):]: npz[k] for k in npz.files
                      if k.startswith(f"{tier}/q/")}
        per_rank.append(c)
    got_comm = convert.comm_to_jax(per_rank, NAMES)
    for g, w, lr in zip(jax.tree.leaves(got_comm["residual"]),
                        jax.tree.leaves(want_comm["residual"]),
                        jax.tree.leaves(low)):
        if lr:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)
    if tier == "powersgd":
        assert sorted(got_comm["q"]) == sorted(want_comm["q"])
        for k, w in want_comm["q"].items():
            np.testing.assert_allclose(got_comm["q"][k], w, rtol=1e-4,
                                       atol=1e-5)


def test_comm_state_round_trips_through_the_reference_layout():
    rng = np.random.default_rng(5)
    comm = {"residual": narrow_tree(rng, (3,)),
            "q": {f"{i:03d}": rng.standard_normal((3, 9, 4)).astype(
                np.float32) for i in (11, 13, 21)}}
    # The narrow VGG's registration order (blocks.i.conv, blocks.i.bn, ...,
    # fc1), which is not the reference's leaf order (every bn, every conv).
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    registered = [n for n, _ in tvgg.VGG("VGGT").named_parameters()]
    assert registered != NAMES and sorted(registered) == sorted(NAMES)
    assert convert.leaf_order(registered) == NAMES
    per_rank = [convert.comm_from_jax(comm, r, registered) for r in range(3)]
    back = convert.comm_to_jax(per_rank, registered)
    assert jax.tree.structure(back) == jax.tree.structure(comm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(comm)):
        np.testing.assert_array_equal(a, b)
    # Reference leaves 11, 13, 21: conv.0.w, conv.1.w, fc1.w.
    port = per_rank[1]
    assert list(port["q"]) == [NAMES[i] for i in (11, 13, 21)] == \
        ["blocks.0.conv.weight", "blocks.1.conv.weight", "fc1.weight"]
    np.testing.assert_array_equal(port["q"][NAMES[11]].numpy(),
                                  comm["q"]["011"][1])
    np.testing.assert_array_equal(
        port["residual"][registered.index(NAMES[11])].numpy(),
        convert.params_from_jax(jax.tree.map(
            lambda a: a[1], comm["residual"]))[NAMES[11]].numpy())


@pytest.mark.parametrize("bucket_bytes", [64, 4096, 100_000,
                                          bucketing.DEFAULT_BUCKET_BYTES])
def test_make_plan_equals_reference_on_the_same_sizes(bucket_bytes):
    rng = np.random.default_rng(bucket_bytes)
    shapes = [tuple(int(d) for d in rng.integers(1, 40, rng.integers(1, 5)))
              for _ in range(30)]
    leaves = [np.zeros(s, np.float32) for s in shapes]
    want = jbucketing.make_plan(leaves, bucket_bytes)
    got = bucketing.make_plan([torch.empty(s) for s in shapes], bucket_bytes)
    assert got.buckets == want.buckets
    assert bucketing.make_schedule(got) == jbucketing.make_schedule(want)


def test_vgg11_plan_has_two_buckets_with_pinned_bytes():
    params = list(get_model("vgg11").parameters())
    plan = bucketing.make_plan(params)
    assert plan.num_buckets == 2
    sizes = [sum(bucketing.leaf_bytes(params[i]) for i in b)
             for b in plan.buckets]
    assert sizes == [18_913_320, 18_011_136]
    assert sorted(i for b in plan.buckets for i in b) == list(range(34))
    # The reference's plan over its own (sorted-key) leaf order.
    from cs744_ddp_tpu import models as jmodels
    init_fn, _ = jmodels.get_model("vgg11")
    jparams, _ = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    jplan = jbucketing.make_plan(jparams)
    jleaves = jax.tree.leaves(jparams)
    assert [sum(int(np.prod(jleaves[i].shape)) * 4 for i in b)
            for b in jplan.buckets] == [18_898_984, 18_025_472]


def test_registry_and_powersgd_matrix_view():
    for name in jstrategies.STRATEGIES:
        assert get_strategy(name) is not None
    assert set(strategies.STRATEGIES) == set(jstrategies.STRATEGIES)
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("zero_redundancy")
    assert get_strategy("powersgd").rank == strategies.DEFAULT_COMPRESS_RANK
    assert get_strategy("powersgd", compress_rank=2).rank == 2
    assert get_strategy("ddp", bucket_bytes=64).keywords["bucket_bytes"] == 64
    assert get_strategy("overlap", bucket_bytes=64).bucket_bytes == 64
    with pytest.raises(ValueError):
        strategies.PowerSGD(rank=0)
    with pytest.raises(ValueError):
        strategies.CompressedPsum("fp4")
    # Low rank is decided on the reference layout: for VGG-11, the 8 conv
    # weights and fc1's, 9 leaves; the other 25 take the bf16 path.
    psgd = strategies.PowerSGD()
    named = list(get_model("vgg11").named_parameters())
    low = [n for n, p in named
           if psgd._low_rank(strategies.reference_shape(p.shape))]
    assert len(low) == 9 and len(named) - len(low) == 25
    assert low == [f"blocks.{i}.conv.weight" for i in range(8)] + \
        ["fc1.weight"]
    comm = psgd.init_comm(named)
    assert list(comm["q"]) == low
    assert comm["q"]["fc1.weight"].shape == (10, 4)
    assert comm["q"]["blocks.7.conv.weight"].shape == (512, 4)
    again = psgd.init_comm(named)
    for n in low:
        assert torch.equal(comm["q"][n], again["q"][n])


@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (512, 10), (6,)])
def test_matrix_view_is_the_reference_layout(shape):
    rng = np.random.default_rng(1)
    ref = rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 4:
        port = torch.from_numpy(np.transpose(ref, (3, 2, 0, 1)).copy())
    elif len(shape) == 2:
        port = torch.from_numpy(ref.T.copy())
    else:
        port = torch.from_numpy(ref.copy())
    assert strategies.reference_shape(port.shape) == shape
    mat = strategies._to_matrix(port)
    np.testing.assert_array_equal(
        mat.numpy(), ref.reshape(-1, shape[-1]))
    assert torch.equal(strategies._from_matrix(mat, port), port)


@pytest.mark.parametrize("case", ["random", "dependent", "zero"])
def test_orthonormalize_matches_reference(case):
    rng = np.random.default_rng(3)
    p = rng.standard_normal((64, 4)).astype(np.float32)
    if case == "dependent":
        p[:, 2] = 2.0 * p[:, 0]       # inside the span: dropped to zero
    elif case == "zero":
        p[:, 1] = 0.0
    got = strategies._orthonormalize(torch.from_numpy(p)).numpy()
    want = np.asarray(jstrategies._orthonormalize(jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if case == "dependent":
        assert not got[:, 2].any()
