"""bf16 mixed precision in the port (``Trainer(precision="bf16")``,
``compute_dtype`` of cs744_ddp_tpu_torch/train/step.py,
``models/serving.py::make_u8_forward``) against the reference package's
``compute_dtype=jnp.bfloat16`` programs on the CPU, on seeds 0-3.

The two frameworks round bf16 at other places (convolution accumulation
and output rounding, XLA's fusion of elementwise chains in f32, the
non-pool BN's statistics), so a bf16 value is compared with the size of
bf16 rounding itself, which the reference's own bf16 program shows
against its f32 program on the same inputs:

  * the loss and the logits, computed in the forward, to rtol 1e-2
    (measured at most 5.1e-3 on the loss);
  * parameters and BN statistics after one SGD step: the port's bf16
    result may be no further from the reference's bf16 result than 1.5x
    the distance of the reference's bf16 result from its f32 result (L2
    over every leaf; measured 1.00-1.24x).  At batch 4 a bf16 gradient
    differs from the f32 one by ~30% in either framework (BN's backward
    cancels), so a plain elementwise tolerance would either say nothing
    or fail on rounding.

The dtype every convolution and linear layer of the port computes in is
recorded by hooks and must be the program's compute dtype: the tolerances
above alone would also pass an f32 computation.

Also: parameters, momentum and BN statistics stay f32 in the port's state;
the ResNet-18 windowed path is bitwise its per-step path, f32 and bf16;
``precision`` other than f32/bf16 is refused.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.models import serving as jserving
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.parallel import strategies as jstrategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch import cli
from cs744_ddp_tpu_torch.models import convert, get_model, serving
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.parallel import strategies as tstrategies
from cs744_ddp_tpu_torch.train import step as tstep
from cs744_ddp_tpu_torch.train.loop import Trainer

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
SEEDS = [0, 1, 2, 3]
LR = 0.01
# Image side per model: the VGG's five pools need 32; the ResNet's global
# average pool takes 16, which keeps the reference's CPU programs cheap.
SIDE = {"vgg11": 32, "resnet18": 16}
LOSS_RTOL = 1e-2
DRIFT_RATIO = 1.5


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree.leaves(tree)])


@contextlib.contextmanager
def _compute_dtypes(model):
    """The set of dtypes the inputs of ``model``'s Conv2d and Linear layers
    had while the block ran: the dtypes the model computed in."""
    seen = set()
    handles = [m.register_forward_pre_hook(
        lambda m, args: seen.add(args[0].dtype)) for m in model.modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


@pytest.fixture(scope="module", params=list(SIDE))
def reference(request):
    """(name, init_fn, {program: jitted reference program}): the train
    step in f32 and bf16, the bf16 eval window, the u8 forward in f32 and
    bf16, each made once for every seed."""
    name = request.param
    init_fn, apply_fn = jmodels.get_model(name)
    progs = {}
    for p, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        progs[p] = jstep.make_train_step(
            apply_fn, jstrategies.local, make_mesh(1),
            jsgd.SGDConfig(lr=LR), augment=False, compute_dtype=dt)
        progs["u8/" + p] = jax.jit(jserving.make_u8_forward(apply_fn, dt))
    progs["eval/bf16"] = jstep.make_eval_window(apply_fn, make_mesh(1),
                                                compute_dtype=jnp.bfloat16)
    return name, init_fn, progs


def _inputs(name, seed, batch=4, batches=None):
    rng = np.random.default_rng(seed)
    lead = (batch,) if batches is None else (batches, batch)
    side = SIDE[name]
    return (rng.integers(0, 256, lead + (side, side, 3), np.uint8),
            rng.integers(0, 10, lead).astype(np.int32))


def _transplant(name, init_fn, seed):
    params, state = _np_tree(init_fn(jax.random.PRNGKey(seed)))
    model = get_model(name).to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(params, state))
    return params, state, model


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_train_step_matches_reference(reference, seed):
    name, init_fn, progs = reference
    params, state, model = _transplant(name, init_fn, seed)
    images, labels = _inputs(name, seed)
    want = {}
    for prec in ("f32", "bf16"):
        step = progs[prec]
        js = jstep.TrainState(params, state, jsgd.init(params))
        js, loss = step(js, jax.random.PRNGKey(0), images, labels)
        want[prec] = (float(loss), _flat(js.params), _flat(js.bn_state))

    tstate = tstep.init_train_state(model)
    step = tstep.make_train_step(model, tstrategies.local,
                                 tsgd.SGDConfig(lr=LR), augment=False,
                                 compute_dtype=torch.bfloat16)
    with _compute_dtypes(model) as seen:
        loss = step(tstate, torch.from_numpy(images),
                    torch.from_numpy(labels.astype(np.int64)))
    assert seen == {torch.bfloat16}
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), want["bf16"][0],
                               rtol=LOSS_RTOL)
    got_params, got_stats = convert.to_jax(model.state_dict())
    for i, got in ((1, _flat(got_params)), (2, _flat(got_stats))):
        drift = np.linalg.norm(got - want["bf16"][i])
        rounding = np.linalg.norm(want["bf16"][i] - want["f32"][i])
        assert drift <= DRIFT_RATIO * rounding, (name, seed, i, drift,
                                                 rounding)
    # Master weights, momentum and BN statistics stay f32.
    for t in tstep.state_tensors(tstate):
        assert t.dtype in (torch.float32, torch.int64), t.dtype


def _eval_batches(name, seed):
    """Two batches of 8, the last 3 rows of the second labelled -1."""
    images, labels = _inputs(name, seed, batch=8, batches=2)
    labels[1, -3:] = -1
    return images, labels


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_eval_window_matches_reference(reference, seed):
    """The staged eval window in bf16, the running statistics moved off
    their initial values first (one f32 step) so that eval-mode BN
    normalizes with something other than (0, 1): loss sum to rtol 1e-2
    (measured at most 2e-5), the count exact."""
    name, init_fn, progs = reference
    params, state, _ = _transplant(name, init_fn, seed)
    images, labels = _inputs(name, seed)
    js, _ = progs["f32"](jstep.TrainState(params, state, jsgd.init(params)),
                         jax.random.PRNGKey(0), images, labels)
    params, state = _np_tree(js.params), _np_tree(js.bn_state)
    model = get_model(name).to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(params, state))
    ev_images, ev_labels = _eval_batches(name, seed)
    want_loss, want_correct = progs["eval/bf16"](js, ev_images, ev_labels)
    with _compute_dtypes(model) as seen:
        got_loss, got_correct = tstep.make_eval_window(
            model, compute_dtype=torch.bfloat16)(
            torch.from_numpy(ev_images),
            torch.from_numpy(ev_labels.astype(np.int64)))
    assert seen == {torch.bfloat16}
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert int(got_correct) == int(want_correct)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_u8_forward_matches_reference(reference, precision, seed):
    """Logits, loss sum and count of a batch of 8 whose last 3 rows are
    padding (-1): f32 to rtol/atol 1e-4 (summation order; measured max
    |diff| 6e-9 for the VGG, 4e-8 for the ResNet), bf16 to 1e-2 (measured
    1.2e-4 and 3.7e-4)."""
    name, init_fn, progs = reference
    params, state, model = _transplant(name, init_fn, seed)
    images, labels = _inputs(name, seed, batch=8)
    labels[-3:] = -1
    want = progs["u8/" + precision](params, state, images, labels)
    tdt = None if precision == "f32" else torch.bfloat16
    with _compute_dtypes(model) as seen:
        got = serving.make_u8_forward(model, tdt)(
            torch.from_numpy(images),
            torch.from_numpy(labels.astype(np.int64)))
    assert seen == {tdt or torch.float32}
    assert serving.INGEST_VERSION == jserving.INGEST_VERSION
    assert got[0].dtype == torch.float32 and got[0].shape == (8, 10)
    rtol = 1e-4 if precision == "f32" else LOSS_RTOL
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=rtol)
    assert int(got[2]) == int(want[2])


def _resnet_trainer(precision, **kw):
    return Trainer("resnet18", "single", precision=precision,
                   global_batch=4, data_dir=ASSETS, device="cpu",
                   sgd_cfg=tsgd.SGDConfig(lr=LR), limit_train_batches=3,
                   log=lambda s: None, **kw)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_resnet18_window_is_bitwise_the_per_step_path(precision):
    """3 augmented batches of 4: one window of 3 against 3 eager steps."""
    win = _resnet_trainer(precision)
    per = _resnet_trainer(precision, profile_phases=True)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    for tr in (win, per):
        with _compute_dtypes(tr.state.model) as seen:
            tr.train_model(0)
        assert seen == {dtype}
    assert win.last_epoch_timers.losses == per.last_epoch_timers.losses
    a, b = tstep.state_tensors(win.state), tstep.state_tensors(per.state)
    # Parameters, the 20 BNs' three buffers, momentum.
    assert len(a) == len(b) == 62 + 3 * 20 + 62
    for x, y in zip(a, b):
        assert x.dtype != torch.bfloat16 and torch.equal(x, y)
    assert not torch.equal(win.state.model.stem_bn.running_mean,
                           torch.zeros(64))


def test_precision_is_validated():
    with pytest.raises(ValueError, match="precision"):
        Trainer("vgg11", "single", precision="fp16", device="cpu",
                data_dir=ASSETS)
    assert cli.parse_args([]).precision == "f32"
    assert cli.parse_args(["--precision", "bf16", "--model",
                           "resnet34"]).model == "resnet34"
    with pytest.raises(SystemExit):
        cli.parse_args(["--precision", "fp16"])
    with pytest.raises(ValueError, match="unknown model"):
        cli.main(["--model", "resnet50", "--device", "cpu"])
