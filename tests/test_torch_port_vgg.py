"""The port's VGG-11 (cs744_ddp_tpu_torch/models) against the reference
package's ``models/vgg.py`` on the CPU, from transplanted weights.

The port runs its five pool-preceded blocks through the fused
BN->ReLU->MaxPool op; the reference runs the unfused chain.  In f32 the two
compute the same function; what differs is summation order (convolutions,
BN statistics, reductions), so values agree to ~1e-4 relative, not bitwise.
"""

import numpy as np
import pytest
import torch

import jax

from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu_torch.models import convert, get_model
from cs744_ddp_tpu_torch.models import vgg as tvgg
from cs744_ddp_tpu_torch.ops.loss import cross_entropy as t_ce
from cs744_ddp_tpu.ops.loss import cross_entropy as j_ce

BATCH = 8
# Summation-order tolerance for f32 values that pass through 8 conv+BN
# layers (measured max relative error ~1e-5; an order of magnitude spare).
RTOL, ATOL = 1e-3, 1e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_vgg():
    params, state = jvgg.init(jax.random.PRNGKey(0), "VGG11")

    def loss_fn(p, s, x, y):
        logits, new_state = jvgg.apply(p, s, x, train=True)
        return j_ce(logits, y), (logits, new_state)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    evaluate = jax.jit(lambda p, s, x: jvgg.apply(p, s, x, train=False)[0])
    return _np_tree(params), _np_tree(state), grad, evaluate


def _port_model(params, state):
    model = tvgg.VGG("VGG11").to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(params, state))
    return model


def test_transplant_round_trip_and_parameter_count(jax_vgg):
    params, state, _, _ = jax_vgg
    sd = convert.from_jax(params, state)
    model = _port_model(params, state)
    n_jax = sum(a.size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 9_231_114
    p2, s2 = convert.to_jax(sd)
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((params,
                                                                state))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The five blocks that end in a pool hold the fused op.
    pools = [type(b.bn).__name__ == "BnReluPool2d" for b in model.blocks]
    assert pools == [True, True, False, True, False, True, False, True]


def test_get_model_is_seeded_and_rejects_unported():
    a, b = get_model("vgg11", seed=3), get_model("vgg11", seed=3)
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.fc1.weight, get_model("vgg11", 4).fc1.weight)
    bound = 1 / np.sqrt(3 * 9)
    w = a.blocks[0].conv.weight.detach()
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    with pytest.raises(ValueError, match="not yet ported"):
        get_model("resnet18")


def test_train_and_eval_match_reference(jax_vgg):
    params, state, grad, evaluate = jax_vgg
    # Seed 1's forward has no pool window whose top two values lie within
    # one rounding of each other.  Seed 0 has one in the s2 block: the fused
    # op's separately rounded z ties two values that the unfused chain keeps
    # apart, so one dP entry goes to the other element and the gradients
    # below that block follow it — a tie flip, which
    # test_torch_port_bnpool.py bounds for the op itself.
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    (loss_j, (logits_j, new_state_j)), grads_j = grad(params, state, x, y)

    model = _port_model(params, state)
    model.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    logits = model(xt)
    loss = t_ce(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=RTOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)

    sd_grads = {k: p.grad for k, p in model.named_parameters()}
    pj, _ = convert.to_jax({**model.state_dict(), **sd_grads})
    for i in range(len(pj["conv"])):
        # A conv bias followed by BatchNorm has a zero gradient in exact
        # arithmetic; both sides return rounding noise there.
        assert np.abs(pj["conv"][i].pop("b")).max() < 1e-5
        assert np.abs(grads_j["conv"][i].pop("b")).max() < 1e-5
    for got, want in zip(jax.tree.leaves(pj), jax.tree.leaves(grads_j)):
        want = np.asarray(want)
        # Gradient leaves span orders of magnitude: hold each to the
        # tolerance scaled by its own largest entry.
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    _, new_state = convert.to_jax(model.state_dict())
    for got, want in zip(jax.tree.leaves(new_state),
                         jax.tree.leaves(new_state_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)

    # Eval mode uses the running statistics; feed both sides the updated
    # ones so the comparison also covers them.
    model.eval()
    with torch.no_grad():
        logits_e = model(xt).numpy()
    want_e = evaluate(params, _np_tree(new_state_j), x)
    np.testing.assert_allclose(logits_e, np.asarray(want_e), rtol=RTOL,
                               atol=ATOL)
