"""The port's model zoo (cs744_ddp_tpu_torch/models: ResNet-18/34 and the
VGG family, ``convert``, ``get_model``) against the reference package's
``models/`` on the CPU, from transplanted weights, in f32.

  * Transplant round trips, bit for bit, and the parameter counts.
  * ResNet-18/34 forward against ``resnet.apply`` in eval and train mode:
    logits and the new BN running statistics.  Inputs are 16x16 (the
    global average pool takes any size the strides divide): the compile
    of the reference's programs is the cost, not the width.
  * One ResNet-18 train step against the reference's ``make_train_step``
    at world 1, and one at world 2 over gloo for ``allreduce`` and
    ``powersgd``, whose comm state goes through ``convert.comm_from_jax``
    and ``comm_to_jax`` on the ResNet tree.
  * ResNet-18 trained by every strategy tier at world 1 (in this process,
    gloo), the stateless tiers bitwise ``single``.

Tolerances are those of f32 summation order: the frameworks sum the
convolutions and BN statistics in other orders (measured below each).
"""

import os

import numpy as np
import pytest
import torch

import jax

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.parallel import strategies as jstrategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import models as tmodels
from cs744_ddp_tpu_torch.models import convert, get_model, resnet
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import strategies as tstrategies
from cs744_ddp_tpu_torch.train import step as tstep

import torch_dist_worker as worker

LR = 0.01
COUNTS = {"resnet18": (11_173_962, 62), "resnet34": (21_282_122, 110),
          "vgg13": (9_416_010, 42), "vgg16": (14_728_266, 54),
          "vgg19": (20_040_522, 66)}


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _reference(name, seed=0):
    init_fn, apply_fn = jmodels.get_model(name)
    params, state = init_fn(jax.random.PRNGKey(seed))
    return _np_tree(params), _np_tree(state), apply_fn


def _port(name, params, state):
    model = get_model(name).to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(params, state))
    return model


def _nhwc_to_port(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", list(COUNTS))
def test_transplant_round_trip_and_parameter_count(name):
    params, state, _ = _reference(name)
    model = _port(name, params, state)
    n, tensors = COUNTS[name]
    named = list(model.named_parameters())
    assert sum(p.numel() for _, p in named) == n == sum(
        a.size for a in jax.tree.leaves(params))
    assert len(named) == tensors == len(jax.tree.leaves(params))
    p2, s2 = convert.to_jax(model.state_dict())
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((p2, s2)),
                    jax.tree.leaves((params, state))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The reference's leaf order, derived from the names alone.
    names = [k for k, _ in named]
    want = [convert.port_name(p) for p, _ in convert._walk(params)]
    assert convert.leaf_order(names) == want


def test_resnet_structure_and_zoo():
    model = get_model("resnet-18")
    assert isinstance(model, resnet.ResNet) and model.name == "ResNet18"
    downs = [i for i, b in enumerate(model.blocks)
             if b.down_conv is not None]
    assert downs == [2, 4, 6]            # first block of stages 2-4
    assert model.blocks[2].down_conv.kernel_size == (1, 1)
    assert model.blocks[2].down_conv.stride == (2, 2)
    assert all(m.bias is None for m in model.modules()
               if isinstance(m, torch.nn.Conv2d))
    assert len(get_model("resnet34").blocks) == 16
    # No block ends in a pool: the fused op is absent.
    assert not any(type(m).__name__ == "BnReluPool2d"
                   for m in model.modules())
    for a, b in zip(get_model("resnet18", 5).parameters(),
                    get_model("resnet18", 5).parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown model 'resnet50'.*"
                                         "resnet18"):
        get_model("resnet50")
    tmodels.register_model("Tiny", lambda: torch.nn.Sequential(
        torch.nn.Flatten(), tmodels.layers.linear(3 * 32 * 32, 10)))
    try:
        assert "tiny" in tmodels.model_names()
        assert get_model("tiny")[1].weight.shape == (10, 3072)
    finally:
        tmodels._CUSTOM.pop("tiny")


@pytest.mark.parametrize("name", ["resnet18", "resnet34"])
def test_resnet_forward_matches_reference(name):
    """Logits in eval and train mode, and train mode's new running
    statistics; batch 4 at 16x16.  Measured max |diff|: logits ~2e-6
    (eval) and ~5e-6 (train), statistics ~1e-6."""
    params, state, apply_fn = _reference(name)
    model = _port(name, params, state)
    x = np.random.default_rng(1).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    for train in (False, True):
        logits, new_state = jax.jit(
            lambda p, s, x: apply_fn(p, s, x, train=train))(params, state, x)
        model.train(train)
        with torch.no_grad():
            got = model(_nhwc_to_port(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                   rtol=1e-4, atol=1e-4)
        _, got_state = convert.to_jax(model.state_dict())
        for a, b in zip(jax.tree.leaves(got_state),
                        jax.tree.leaves(new_state)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


def _batches(steps, batch, hw, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (steps, batch, hw, hw, 3), np.uint8),
            rng.integers(0, 10, (steps, batch)).astype(np.int32))


def _assert_update_matches(before, got, want):
    """Leaf by leaf, the port's update (``got - before``: the SGD step of
    a parameter, the move of a BN statistic) against the reference's
    (``want - before``) to rtol 1e-4, atol 1e-4 of the leaf's largest
    reference update plus two f32 ulps of its largest ``before`` (both
    results are rounded to f32 at the parameter's magnitude).  Measured
    on one ResNet-18 step: at most 1.3e-5 of the update's scale beyond
    that rounding, which is up to 7e-4 of it where a parameter near 1
    (BN scale, running variance) moves by ~2e-4."""
    for b, g, w in zip(jax.tree.leaves(before), jax.tree.leaves(got),
                       jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        d_port = np.asarray(g, np.float64) - b
        d_ref = np.asarray(w, np.float64) - b
        scale = float(np.abs(d_ref).max())
        assert scale > 0, "the reference left a leaf unchanged"
        atol = 1e-4 * scale + 2 * float(np.spacing(np.abs(b).max()))
        np.testing.assert_allclose(d_port, d_ref, rtol=1e-4, atol=atol)


def test_resnet18_train_step_matches_reference():
    """One step, batch 4 at 16x16, augment off, lr 0.01: loss rtol 1e-4
    (measured 2e-7); the update of every parameter and BN statistic held
    against the reference's update (``_assert_update_matches``), not the
    parameters themselves, which the update moves by less than an f32
    summation-order tolerance would admit."""
    params, state, apply_fn = _reference("resnet18")
    jtrain = jstep.make_train_step(apply_fn, jstrategies.local, make_mesh(1),
                                   jsgd.SGDConfig(lr=LR), augment=False)
    images, labels = _batches(1, 4, 16)
    jstate = jstep.TrainState(params, state, jsgd.init(params))
    jstate, jloss = jtrain(jstate, jax.random.PRNGKey(0), images[0],
                           labels[0])

    model = _port("resnet18", params, state)
    tstate = tstep.init_train_state(model)
    step = tstep.make_train_step(model, tstrategies.local,
                                 tsgd.SGDConfig(lr=LR), augment=False)
    loss = step(tstate, torch.from_numpy(images[0]),
                torch.from_numpy(labels[0].astype(np.int64)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    _assert_update_matches((params, state),
                           convert.to_jax(model.state_dict()),
                           _np_tree((jstate.params, jstate.bn_state)))


@pytest.fixture(scope="module")
def resnet_tiers():
    """ResNet-18 trained 3 windowed steps (batch 4, fixture data,
    augmentation on) by every tier, in this process on a world-1 gloo
    group: {tier: (state tensors, losses)}."""
    import torch.distributed as dist
    from cs744_ddp_tpu_torch.parallel import initialize_distributed
    from cs744_ddp_tpu_torch.train.loop import STRATEGIES, Trainer

    created = not dist.is_initialized()
    initialize_distributed(device="cpu")
    try:
        out = {}
        for tier in STRATEGIES:
            tr = Trainer("resnet18", tier, global_batch=4,
                         data_dir=worker.ASSETS, device="cpu",
                         sgd_cfg=tsgd.SGDConfig(lr=LR),
                         limit_train_batches=3, log=lambda s: None)
            tr.train_model(0)
            out[tier] = (tstep.state_tensors(tr.state),
                         tr.last_epoch_timers.losses)
        return out
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.parametrize("tier", ["gather", "allreduce", "ddp", "overlap",
                                  "compress-bf16", "compress-int8",
                                  "powersgd"])
def test_resnet18_trains_with_every_tier_at_world_1(resnet_tiers, tier):
    """At world 1 a stateless tier is bitwise ``single`` (its mean over one
    rank is the gradient itself); a compressed tier trains finite losses
    and carries a non-zero residual for each of the 62 parameters."""
    got, losses = resnet_tiers[tier]
    want, want_losses = resnet_tiers["single"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    if tier in ("gather", "allreduce", "ddp", "overlap"):
        assert losses == want_losses
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        residuals = got[len(want):len(want) + 62]
        assert len(residuals) == 62
        assert all(float(r.abs().max()) > 0 for r in residuals)


WORLD, STEPS, GLOBAL = 2, 1, 8
DIST_TIERS = ("allreduce", "powersgd")


@pytest.fixture(scope="module")
def resnet_world2(tmp_path_factory):
    """One ResNet-18 step of each tier at world 2: the port's gloo ranks
    (tests/torch_dist_worker.py) and, while they run, the reference's
    ``make_train_step`` on ``make_mesh(2)`` from the same weights, batches
    and comm state."""
    tmp = str(tmp_path_factory.mktemp("port_resnet_w2"))
    params, state, apply_fn = _reference("resnet18")
    names = [n for n, _ in get_model("resnet18").named_parameters()]
    np.savez(os.path.join(tmp, "weights.npz"),
             **{k: v.numpy() for k, v in convert.from_jax(params,
                                                          state).items()})
    images, labels = _batches(STEPS, GLOBAL, 16, seed=2)
    np.savez(os.path.join(tmp, "batches.npz"), images=images, labels=labels)
    psgd = jstrategies.get_strategy("powersgd")
    jcomm = _np_tree(psgd.init_comm(params, WORLD))
    # Residuals to start from: the vectors (bf16 on the wire) in [1, 2),
    # so that one bf16 ulp of what a rank sends is at most 2**-6 (see the
    # test); the matrices (low rank) small and normal.
    rng = np.random.default_rng(3)
    jcomm["residual"] = jax.tree.map(
        lambda a: (1.0 + rng.random(a.shape) if a.ndim == 2 else
                   rng.standard_normal(a.shape) * 1e-3).astype(np.float32),
        jcomm["residual"])
    arrays = {}
    for r in range(WORLD):
        c = convert.comm_from_jax(jcomm, r, names)
        arrays.update({f"r{r}/{n}": t.numpy()
                       for n, t in zip(names, c["residual"])})
        arrays.update({f"q{r}/{n}": t.numpy() for n, t in c["q"].items()})
    np.savez(os.path.join(tmp, "comm.npz"), **arrays)
    os.makedirs(os.path.join(tmp, "out"))
    ranks = worker.start({
        "world": WORLD, "rdzv": f"file://{tmp}/rdzv", "out":
        os.path.join(tmp, "out"), "tasks": [{
            "kind": "step", "model": "resnet18", "steps": STEPS, "lr": LR,
            "global_batch": GLOBAL, "strategies": list(DIST_TIERS),
            "weights": os.path.join(tmp, "weights.npz"),
            "batches": os.path.join(tmp, "batches.npz"),
            "comm": os.path.join(tmp, "comm.npz")}]}, tmp)
    reference = {}
    for tier in DIST_TIERS:
        strat = jstrategies.get_strategy(tier)
        train = jstep.make_train_step(apply_fn, strat, make_mesh(WORLD),
                                      jsgd.SGDConfig(lr=LR), augment=False)
        opt = jsgd.init(params)
        if tier == "powersgd":
            opt = opt._replace(comm=jcomm)
        js = jstep.TrainState(params, state, opt)
        losses = []
        for s in range(STEPS):
            js, loss = train(js, jax.random.PRNGKey(s), images[s], labels[s])
            losses.append(float(loss))
        reference[tier] = (np.array(losses), _np_tree(js))
    ranks.wait(timeout=400)
    port = [np.load(os.path.join(tmp, "out", f"step_r{r}.npz"))
            for r in range(WORLD)]
    return reference, port, names, (params, state)


@pytest.mark.parametrize("tier", DIST_TIERS)
def test_resnet18_world2_step_matches_reference(resnet_world2, tier):
    """Losses rtol 1e-3 (tests/test_torch_port_dist.py's f32 bound); the
    update of every parameter and BN statistic against the reference's
    (``_assert_update_matches``).  powersgd's comm state,
    carried back by ``comm_to_jax``: the Q factors and the low-rank
    leaves' residuals to rtol 1e-3 / atol 1e-4 (f32 products in another
    order, then Gram-Schmidt; measured max |diff| below 1e-4).  A vector
    leaf's residual is ``v - bf16(v)``: where f32 summation order moves
    ``v`` across a bf16 rounding boundary the two residuals differ by one
    bf16 ulp of ``v``, at most 2**-6 for ``v`` in [1, 4).  (After a
    second step the warm-started power iteration amplifies f32 noise in
    ill-conditioned leaves to percents, so the test takes one.)"""
    reference, port, names, before = resnet_world2
    want_losses, want = reference[tier]
    for npz in port:
        np.testing.assert_allclose(npz[f"{tier}/losses"], want_losses,
                                   rtol=1e-3)
    sds = [{k[len(f"{tier}/sd/"):]: npz[k] for k in npz.files
            if k.startswith(f"{tier}/sd/")} for npz in port]
    for k in sds[0]:                      # the ranks agree bit for bit
        np.testing.assert_array_equal(sds[1][k], sds[0][k])
    got = convert.to_jax({k: torch.from_numpy(v) for k, v in sds[0].items()})
    _assert_update_matches(before, got, (want.params, want.bn_state))
    if tier != "powersgd":
        assert not any(k.startswith(f"{tier}/res/") for k in port[0].files)
        return
    per_rank = [{"residual": [npz[f"{tier}/res/{n}"] for n in names],
                 "q": {n: npz[f"{tier}/q/{n}"] for n in names
                       if f"{tier}/q/{n}" in npz.files}} for npz in port]
    got_comm = convert.comm_to_jax(per_rank, names)
    want_comm = want.opt_state.comm
    assert jax.tree.structure(got_comm) == jax.tree.structure(want_comm)
    assert len(got_comm["q"]) == 21       # the 20 convs and fc
    for a, b in zip(jax.tree.leaves(got_comm), jax.tree.leaves(want_comm)):
        if a.ndim == 2 and a.shape[0] == WORLD:     # a vector's residuals
            np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
