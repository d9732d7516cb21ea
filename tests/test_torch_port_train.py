"""The port's optimizer, loss, train step and Trainer
(cs744_ddp_tpu_torch/ops, train) against the reference package's, on the
CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.ops import loss as jloss
from cs744_ddp_tpu.ops import sgd as jsgd
from cs744_ddp_tpu.parallel import make_mesh, strategies
from cs744_ddp_tpu.train import step as jstep
from cs744_ddp_tpu_torch.data import cifar10 as tcifar
from cs744_ddp_tpu_torch.models import convert, vgg as tvgg
from cs744_ddp_tpu_torch.ops import loss as tloss
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.train import step as tstep
from cs744_ddp_tpu_torch.train.loop import Trainer

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1])
def test_sgd_update_is_element_equal(seed):
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, 4, 8), (8,), (17, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg = tsgd.SGDConfig(lr=0.1, momentum=0.9, weight_decay=1e-4)
    jcfg = jsgd.SGDConfig(lr=0.1, momentum=0.9, weight_decay=1e-4)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = tsgd.init(tp)
    jp, jstate = list(params), jsgd.init(list(params))
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        tsgd.update(tp, [torch.from_numpy(g) for g in grads], tstate, cfg)
        jp, jstate = jsgd.update(jp, grads, jstate, jcfg)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tstate.momentum, jstate.momentum):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cross_entropy_and_masked_eval_counts_match():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((32, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    np.testing.assert_allclose(
        float(tloss.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))),
        float(jloss.cross_entropy(logits, labels)), rtol=1e-6)
    labels[-5:] = -1
    ls, c = tloss.masked_eval_counts(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    jls, jc = jstep.masked_eval_counts(jnp.asarray(logits),
                                       jnp.asarray(labels))
    np.testing.assert_allclose(float(ls), float(jls), rtol=1e-6)
    assert int(c) == int(jc)


def test_three_train_steps_match_reference():
    """Full-width VGG-11, batch 16, augment off, transplanted weights: the
    port's single step (fused BN->ReLU->MaxPool blocks) against the
    reference's jitted ``local`` step (unfused).

    lr is 0.01: at lr 0.1 a batch of 16 drives the loss from 2.3 to ~28
    within 3 steps, and so chaotic a trajectory amplifies summation-order
    differences to ~1e-2.  At lr 0.01 PyTorch's own unfused chain differs
    from the reference by up to 9e-4 in parameters after 3 steps (measured
    on data seeds 3-5), so 2e-3 bounds f32 summation order, not the op."""
    batch = 16
    cfg = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)
    init_fn, apply_fn = jmodels.get_model("vgg11")
    jstate = jstep.init_train_state(init_fn, jax.random.PRNGKey(0))
    j_train = jstep.make_train_step(apply_fn, strategies.local, make_mesh(1),
                                    jsgd.SGDConfig(**cfg), augment=False)
    params = jax.tree.map(np.array, jstate.params)
    bn_state = jax.tree.map(np.array, jstate.bn_state)

    model = tvgg.VGG("VGG11").to(memory_format=torch.channels_last)
    model.load_state_dict(convert.from_jax(params, bn_state))
    tstate = tstep.init_train_state(model)
    t_train = tstep.make_train_step(model, tsgd.SGDConfig(**cfg),
                                    augment=False)

    split = tcifar._synthetic_split(3 * batch, 3)
    key = jax.random.PRNGKey(0)
    for i in range(3):
        imgs = split.images[i * batch:(i + 1) * batch]
        labs = split.labels[i * batch:(i + 1) * batch]
        jstate, jl = j_train(jstate, key, imgs, labs)
        tl = t_train(tstate, torch.from_numpy(imgs.copy()),
                     torch.from_numpy(labs.astype(np.int64)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    pj, sj = convert.to_jax(model.state_dict())
    for got, want in zip(jax.tree.leaves((pj, sj)),
                         jax.tree.leaves((jstate.params, jstate.bn_state))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-2,
                                   atol=2e-3)


def test_trainer_prints_the_reference_schedule():
    lines = []
    trainer = Trainer("vgg11", "single", global_batch=4, data_dir=ASSETS,
                      device="cpu", limit_train_batches=40,
                      limit_eval_batches=2,
                      sgd_cfg=tsgd.SGDConfig(lr=0.01), log=lines.append)
    trainer.run(1)
    num = r"[-+0-9.e]+"
    expected = [
        r"Size of training set is 80",          # 320 fixture images / 4
        r"Size of test set is 16",              # 64 / 4
        rf"Training loss after 20 iterations is {num}",
        rf"Training loss after 40 iterations is {num}",
        rf"Average Pass time in iter 40 is {num}",   # window 1 is warmup
        rf"Training time after 1 epoch is {num}",
        rf"Test set: Average loss: {num}, Accuracy: \d+/8 \({num}%\)\n"]
    assert len(lines) == len(expected), lines
    for line, pattern in zip(lines, expected):
        assert re.fullmatch(pattern, line), (pattern, line)
    losses = trainer.last_epoch_timers.losses
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert len(trainer.last_epoch_timers.steady_step_times) == 20


def test_trainer_refuses_cpu_fallback_and_unported_strategies():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Trainer("vgg11", "allreduce", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer()


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cs744_ddp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cs744_ddp_tpu' or m.startswith('cs744_ddp_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
