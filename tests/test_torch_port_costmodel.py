"""The port's cost model (cs744_ddp_tpu_torch/analysis/costmodel.py), its
join with measured time (obs/attribution.py), ``mfu_fields``,
``Trainer.step_flops_per_image`` and ``serve/scheduler.py::
cost_model_weights``, on the CPU, against hand counts and the reference
package's.

  * (a) Hand counts, exact: the VGG-11 forward at batch 8 (conv
    2,444,230,656, dot 81,920), the 32->16->10 MLP SGD step (dot 24,064),
    and VGG-11's whole train step at batch 256 (its convolutions 3x the
    forward's, less the first layer's input gradient: 913,047,552 an
    image).
  * (b) The same programs through the reference's ``cost_report``:
    convolution and dot FLOPs equal; elementwise, reduce and HBM bytes at
    the ratios measured here (aten's operators against XLA's
    instructions), within 10%.
  * (c) The Trainer's step against the reference Trainer's (narrow VGG and
    the tiny net, augmentation off): convolution and dot equal to
    ``cost_report`` of the reference's train step; ``step_flops_per_image``
    against the reference's (XLA's ``cost_analysis`` of the optimized
    program) at the measured ratio, within 10%.
  * (d) Wire bytes from the ``CountingGroup`` at world 2 (0 at world 1),
    and the bnpool kernels as single operators of bytes and no flops.
  * (e) ``attribute`` and ``overlap_vs_ddp`` fed the reference report's
    numbers and its v5e constants return the reference functions' dicts
    exactly; ``mfu_fields`` against the H100 bf16 peak.
  * (f) ``cost_model_weights`` on buckets (2, 4) against the reference's.
"""

import sys
from collections import namedtuple

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cs744_ddp_tpu import models as jmodels
from cs744_ddp_tpu.analysis import costmodel as jcm
from cs744_ddp_tpu.models import vgg as jvgg
from cs744_ddp_tpu.obs import attribution as jattr
from cs744_ddp_tpu.parallel import make_mesh
from cs744_ddp_tpu.serve import InferenceEngine as JEngine
from cs744_ddp_tpu.serve import scheduler as jsched
from cs744_ddp_tpu.train import loop as jloop
from cs744_ddp_tpu_torch import models as tmodels
from cs744_ddp_tpu_torch.analysis import costmodel as cm
from cs744_ddp_tpu_torch.models import layers, vgg as tvgg
from cs744_ddp_tpu_torch.obs import attribution
from cs744_ddp_tpu_torch.ops import bnpool
from cs744_ddp_tpu_torch.parallel import get_strategy
from cs744_ddp_tpu_torch.serve import InferenceEngine, cost_model_weights
from cs744_ddp_tpu_torch.train import loop
from cs744_ddp_tpu_torch.train import step as steplib
from cs744_ddp_tpu_torch.utils import metrics

import torch_dist_worker as worker
from tinynet import tiny_cnn

jvgg.CFG["VGGT"] = worker.NARROW_VGG
tvgg.CFG["VGGT"] = worker.NARROW_VGG
jmodels.register_model("vggt", lambda: jvgg.make("VGGT"))
jmodels.register_model("tiny", tiny_cnn)
# tests/tinynet.py's net in the port's layers: conv(3->8) + BN + relu +
# pool(4x) + fc.
tmodels.register_model("tiny", lambda: nn.Sequential(
    layers.conv3x3(3, 8), layers.BnReluPool2d(8), nn.MaxPool2d(2),
    nn.Flatten(), layers.linear(512, 10)))

BATCH = 8
MLP = (8, 32, 16, 10)          # batch, in, hidden, out
# Measured ratios, port / reference, of what the two cost models charge
# differently, each held within RATIO_RTOL.  Elementwise: aten's fused
# operators (eval batch norm, log_softmax) are charged the passes they
# fuse, where XLA spells out every convert, broadcast and rsqrt; reduce:
# the port's log_softmax takes two passes over the logits, XLA's a max, a
# sum and the one-hot's; HBM: XLA's instructions each materialize their
# result (every broadcast, convert and bias add apart), where an aten
# convolution or addmm carries its bias in the one operator.
RATIOS = {
    "vgg11_forward": {"elementwise": 0.8327, "reduce": 1.0, "hbm": 0.4260},
    "mlp_step": {"elementwise": 1.0068, "reduce": 1.1120, "hbm": 0.6018},
}
# Port / reference ``step_flops_per_image`` (XLA's cost_analysis of the
# optimized CPU program, which counts convolutions, pooling and the BN
# fusions by its own rules: below the analytic conv count for the narrow
# VGG, above the port's total for the pooling-heavy tiny net).
STEP_RATIOS = {"vggt": 1.4210, "tiny": 0.6945}
RATIO_RTOL = 0.10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (the suite runs its files in
    parallel); nothing here computes much, everything is counted."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ratio(got, want, expected, what):
    assert got / want == pytest.approx(expected, rel=RATIO_RTOL), what


# -- the programs, in both packages -------------------------------------------

def _reference_vgg11_forward():
    init_fn, apply_fn = jvgg.VGG11()
    params, state = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((BATCH, 32, 32, 3), jnp.float32)
    hlo = jax.jit(lambda p, s, xx: apply_fn(p, s, xx, train=False)[0]) \
        .lower(params, state, x).compiler_ir(dialect="hlo").as_hlo_text()
    return jcm.cost_report(hlo, "vgg11/fwd")


def _port_vgg11_forward():
    net = cm.meta_model("vgg11").eval()
    x = _meta((BATCH, 3, 32, 32), torch.float32).contiguous(
        memory_format=torch.channels_last)
    return cm.count(net, x, name="vgg11/fwd")


def _reference_mlp_step():
    b, i, h, o = MLP

    def loss_fn(params, x, y):
        hid = jax.nn.relu(x @ params["w0"] + params["b0"])
        logits = hid @ params["w1"] + params["b1"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(y, o) * logp, axis=-1))

    def train_step(params, x, y):
        grads = jax.grad(loss_fn)(params, x, y)
        return jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)

    params = {"w0": jax.ShapeDtypeStruct((i, h), jnp.float32),
              "b0": jax.ShapeDtypeStruct((h,), jnp.float32),
              "w1": jax.ShapeDtypeStruct((h, o), jnp.float32),
              "b1": jax.ShapeDtypeStruct((o,), jnp.float32)}
    hlo = jax.jit(train_step).lower(
        params, jax.ShapeDtypeStruct((b, i), jnp.float32),
        jax.ShapeDtypeStruct((b,), jnp.int32)
    ).compiler_ir(dialect="hlo").as_hlo_text()
    return jcm.cost_report(hlo, "mlp/train_step")


def _port_mlp_step():
    b, i, h, o = MLP

    def train_step(params, x, y):
        w0, b0, w1, b1 = params
        logits = torch.relu(x @ w0 + b0) @ w1 + b1
        logp = torch.log_softmax(logits, -1)
        loss = -torch.mean(torch.sum(F.one_hot(y, o) * logp, -1))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            return [p - 0.1 * g for p, g in zip(params, grads)]

    params = [_meta(s, torch.float32).requires_grad_()
              for s in ((i, h), (h,), (h, o), (o,))]
    return cm.count(train_step, params, _meta((b, i), torch.float32),
                    _meta((b,), torch.int64), name="mlp/train_step")


PROGRAMS = {"vgg11_forward": (_reference_vgg11_forward, _port_vgg11_forward),
            "mlp_step": (_reference_mlp_step, _port_mlp_step)}


# -- (a) hand counts ----------------------------------------------------------

def test_vgg11_forward_flops_hand_count():
    rep = _port_vgg11_forward()
    stages = [(32, 3, 64), (16, 64, 128), (8, 128, 256), (8, 256, 256),
              (4, 256, 512), (4, 512, 512), (2, 512, 512), (2, 512, 512)]
    expected = sum(2 * BATCH * h * h * cout * 9 * cin
                   for h, cin, cout in stages)
    assert expected == 2_444_230_656
    assert rep.flops_by_op["convolution"] == float(expected)
    assert rep.flops_by_op["dot"] == 2.0 * BATCH * 10 * 512
    assert rep.hbm_bytes > 0 and rep.wire_bytes == 0
    assert rep.trip_counts == {} and rep.notes == []


def test_mlp_step_dots_hand_count():
    b, i, h, o = MLP
    fwd = 2 * b * i * h + 2 * b * h * o
    dw = 2 * b * i * h + 2 * b * h * o
    dx = 2 * b * h * o                    # layer 1 only: x needs no grad
    assert fwd + dw + dx == 24_064
    assert _port_mlp_step().flops_by_op["dot"] == float(fwd + dw + dx)


def test_vgg11_train_step_flops_hand_count():
    """The whole windowed step of ``Trainer("vgg11", "single")`` at batch
    256: the convolutions are the forward's three times (forward, input
    and weight gradients), less the first layer's input gradient; the
    rest (augment, BN, head, SGD) adds well under 2%."""
    tr = loop.Trainer("vgg11", "single", data_dir=worker.ASSETS,
                      device="cpu", log=lambda s: None)
    rep = tr.step_cost()
    fwd = 2_444_230_656 // BATCH                    # 305,528,832 an image
    first_dgrad = 2 * 32 * 32 * 64 * 9 * 3          # 3,538,944
    assert 3 * fwd - first_dgrad == 913_047_552
    assert rep.flops_by_op["convolution"] == 256.0 * 913_047_552
    per_image = tr.step_flops_per_image()
    assert per_image == rep.flops / 256
    assert 913_047_552 < per_image < 1.02 * 913_047_552
    assert rep.wire_bytes == 0 and rep.collective_sizes == []


# -- (b) against the reference's cost_report ----------------------------------

@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_costs_against_reference_cost_report(program):
    ref_fn, port_fn = PROGRAMS[program]
    ref, port = ref_fn(), port_fn()
    for kind in ("convolution", "dot"):
        assert port.flops_by_op.get(kind) == ref.flops_by_op.get(kind), kind
    want = RATIOS[program]
    for kind in ("elementwise", "reduce"):
        _ratio(port.flops_by_op[kind], ref.flops_by_op[kind], want[kind],
               kind)
    _ratio(port.hbm_bytes, ref.hbm_bytes, want["hbm"], "hbm")


# -- (c) the Trainer's step against the reference Trainer's -------------------

@pytest.mark.parametrize("model", ["vggt", "tiny"])
def test_step_flops_against_reference_trainer(model):
    ref = jloop.Trainer(model=model, strategy="single", mesh=make_mesh(1),
                        global_batch=BATCH, data_dir=worker.ASSETS,
                        augment=False, log=lambda s: None)
    x = jax.ShapeDtypeStruct((BATCH, 32, 32, 3), jnp.uint8,
                             sharding=ref._batch_sharding)
    y = jax.ShapeDtypeStruct((BATCH,), jnp.int32,
                             sharding=ref._batch_sharding)
    lowered = ref.train_step.lower(ref.state, jax.random.PRNGKey(0), x, y)
    ref_rep = jcm.cost_report(lowered.compiler_ir(dialect="hlo")
                              .as_hlo_text(), "train_step")
    port = loop.Trainer(model, "single", global_batch=BATCH,
                        data_dir=worker.ASSETS, device="cpu", augment=False,
                        log=lambda s: None)
    rep = port.step_cost()
    for kind in ("convolution", "dot"):
        assert rep.flops_by_op[kind] == ref_rep.flops_by_op[kind], kind
    _ratio(port.step_flops_per_image(), ref.step_flops_per_image(),
           STEP_RATIOS[model], "step_flops_per_image")


def test_step_flops_per_image_logs_when_uncountable(monkeypatch):
    tr = loop.Trainer("tiny", "single", global_batch=BATCH,
                      data_dir=worker.ASSETS, device="cpu",
                      log=lambda s: None)

    def uncountable():
        raise NotImplementedError("no meta kernel for aten::foo")

    monkeypatch.setattr(tr, "step_cost", uncountable)
    lines = []
    assert tr.step_flops_per_image(log=lines.append) is None
    assert len(lines) == 1 and "aten::foo" in lines[0]


# -- (d) wire bytes and the kernels -------------------------------------------

def _step_at(world, strategy):
    """The narrow VGG's step body at ``world``, rank 0, counted."""
    net = cm.meta_model("vggt")
    strat = get_strategy(strategy)
    group = cm.CountingGroup(world, 0)
    body = steplib.make_step_body(net, strat, augment=False, group=group)
    zero = _meta((), torch.int64)
    rep = cm.count(body, steplib.init_train_state(net, strat),
                   _meta((BATCH, 32, 32, 3), torch.uint8),
                   _meta((BATCH,), torch.int64), zero, zero,
                   name=strategy, group=group)
    return rep, net, group


@pytest.mark.parametrize("strategy", ["allreduce", "ddp"])
def test_wire_bytes_from_the_counting_group(strategy):
    rep, net, group = _step_at(2, strategy)
    grads = [4 * p.numel() for p in net.parameters()]
    stats = 4 * sum(b.numel() for n, b in net.named_buffers()
                    if n.endswith(("running_mean", "running_var")))
    if strategy == "allreduce":
        assert rep.collective_sizes == grads + [stats + 4]
    else:
        assert sum(rep.collective_sizes) == sum(grads) + stats + 4
        assert len(rep.collective_sizes) == group.step_counts[
            "all_reduce"] + 1
    assert rep.wire_bytes == sum(grads) + stats + 4
    assert rep.wire_by_collective == {"all-reduce": rep.wire_bytes}
    # The rank mean stays out of the strategy's counts, as on a real group.
    assert group.step_bytes["all_reduce"] == sum(grads)
    one, _, _ = _step_at(1, strategy)
    assert one.wire_bytes == 0 and one.collective_sizes == []
    assert one.flops_by_op == rep.flops_by_op
    overlap, _, _ = _step_at(2, "overlap")
    got = attribution.overlap_vs_ddp(overlap, rep)
    assert got["ddp_chained_bytes"] == rep.wire_bytes
    assert got["overlap_exposed_bytes_upper_bound"] == max(
        overlap.collective_sizes)


def test_a_written_destination_is_charged_once():
    """A copy moves its tensor twice (the source read, the destination
    written), as the reference's copy does; so does a fill, once; an
    ``out=`` operator charges its operands and its result once each; an
    in-place update reads and writes its operand."""
    a, b = _meta((64, 32), torch.float32), _meta((64, 32), torch.float32)
    nb = 64 * 32 * 4
    assert cm.count(lambda: a.copy_(b)).hbm_bytes == 2 * nb
    assert cm.count(lambda: a.zero_()).hbm_bytes == nb
    assert cm.count(lambda: torch.add(a, b, out=torch.empty_like(a))
                    ).hbm_bytes == 3 * nb
    assert cm.count(lambda: a.add_(b)).hbm_bytes == 3 * nb


def test_bnpool_kernels_are_one_operator_of_bytes():
    """The fused backward on meta tensors: the two kernels' operators and
    nothing of the plain version, 0 flops, and the bytes of each kernel's
    operands and results."""
    n, c, h, w = 4, 16, 8, 8
    xhat = _meta((n, c, h, w), torch.float32).contiguous(
        memory_format=torch.channels_last)
    dp = _meta((n, c, h // 2, w // 2), torch.float32).contiguous(
        memory_format=torch.channels_last)
    vec = [_meta((c,), torch.float32) for _ in range(3)]
    rep = cm.count(bnpool.bnpool_backward, xhat, dp, *vec)
    big, small = 4 * n * c * h * w, 4 * n * c * h * w // 4
    sums = 4 * 2 * c
    assert rep.flops == 0 and rep.flops_by_op == {}
    assert rep.hbm_bytes == (big + small + 2 * 4 * c + sums) \
        + (big + small + 3 * 4 * c + sums + big)


# -- (e) attribution and mfu_fields -------------------------------------------

def _port_report(ref):
    return cm.CostReport(name=ref.name, flops=ref.flops,
                         flops_by_op=dict(ref.flops_by_op),
                         hbm_bytes=ref.hbm_bytes, wire_bytes=ref.wire_bytes,
                         collective_sizes=list(ref.collective_sizes))


def test_attribution_matches_reference_on_its_numbers():
    ref = _reference_mlp_step()
    ref.wire_bytes, ref.collective_sizes = 3.0e6, [1_000_000, 2_000_000]
    mem = namedtuple("Mem", "peak_bytes")(123_456_789)
    v5e = dict(peak_flops=jcm.V5E_BF16_PEAK_FLOPS,
               hbm_bytes_per_s=jcm.V5E_HBM_BYTES_PER_S,
               hbm_capacity_bytes=jcm.V5E_HBM_CAPACITY_BYTES,
               ici_bytes_per_s=jcm.V5E_ICI_BYTES_PER_S)
    port = _port_report(ref)
    for kw in ({}, {"measured_s": 2.5e-6}, {"measured_s": 2.5e-6,
                                            "mem_report": mem}):
        assert attribution.attribute(
            port, bf16_peak_flops=jcm.V5E_BF16_PEAK_FLOPS, **v5e, **kw) \
            == jattr.attribute(ref, **kw)
    other = _port_report(ref)
    other.collective_sizes = [500_000, 4_000_000, 250_000]
    ref_other = _reference_mlp_step()
    ref_other.collective_sizes = list(other.collective_sizes)
    assert attribution.overlap_vs_ddp(
        port, other, ici_bytes_per_s=jcm.V5E_ICI_BYTES_PER_S) \
        == jattr.overlap_vs_ddp(ref, ref_other)


def test_attribution_defaults_are_the_h100s():
    rep = _port_vgg11_forward()
    step_s = 1e-3
    f32 = attribution.attribute(rep, measured_s=step_s,
                                peak_flops=cm.H100_F32_PEAK_FLOPS)
    bf16 = attribution.attribute(rep, measured_s=step_s)
    achieved = rep.flops / step_s
    # Always against the bf16 peak; the roofline side against the caller's.
    assert f32["mfu_vs_bf16_peak"] == bf16["mfu_vs_bf16_peak"] == round(
        achieved / 989.4e12, 6)
    assert f32["analytic_compute_s"] == rep.flops / 66.9e12
    assert bf16["analytic_hbm_s"] == rep.hbm_bytes / 3.35e12
    assert f32["roofline_bound"] == "compute"
    assert bf16["mfu_roofline_ceiling"] == round(
        min(1.0, (rep.flops / 989.4e12) / (rep.hbm_bytes / 3.35e12)), 4)
    mem = attribution.attribute(rep, mem_report=namedtuple(
        "Mem", "peak_bytes")(40 * 10 ** 9))
    assert mem["hbm_capacity_utilization"] == 0.5


def test_mfu_fields_against_the_h100_bf16_peak():
    f = cm.mfu_fields(1000.0, 2e9)
    assert f == {"tflops_per_sec": 2.0,
                 "mfu_vs_bf16_peak": round(2e12 / 989.4e12, 4)}
    assert cm.mfu_fields(1000.0, None) == {}
    assert metrics.mfu_fields(1000.0, 2e9) == f
    assert attribution.mfu_fields is cm.mfu_fields
    assert not any(k.startswith("V5E") for k in vars(cm))


# -- (f) cost_model_weights ---------------------------------------------------

def test_cost_model_weights_against_reference():
    ref = jsched.cost_model_weights(
        JEngine("vggt", buckets=(2, 4), precisions=("f32",), seed=0), "f32")
    got = cost_model_weights(
        InferenceEngine("vggt", buckets=(2, 4), device="cpu"), "f32")
    assert sorted(got) == [2, 4]
    # The rungs' shape: flops scale with the bucket alike (eval rows are
    # independent); each within 1% of the reference's HLO count.
    assert got[4] / got[2] == pytest.approx(ref[4] / ref[2], rel=1e-3)
    for b in (2, 4):
        assert got[b] == pytest.approx(ref[b], rel=0.01)
