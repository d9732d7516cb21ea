"""The port's Moonlight-16B-A3B (models/moonlight.py), its expert layer's
grouped products (ops/moe.py), the token path of the step and the Trainer
(train/step.py, train/loop.py, data/tokens.py) and the chunked
cross-entropy (ops/loss.py), on the CPU, at a narrow preset of the same
code: hidden 64, 4 heads, qk 16 + 8, v 16, kv rank 32, one dense and two
expert layers, 16 experts of which 4 are held, top 4, vocabulary 256,
32 positions.  The yardstick is the benchmark's plain f32 reference
``portbench/arch/moonlight.py`` (written from the published description,
with nothing of the program or of JAX).

  * (a) logits, loss and every parameter's gradient against the reference;
  * (b) the four chips' shares of an expert layer, with the shared expert
    counted once, add up to the uncut layer;
  * (c) ``grouped_mm``'s forward and both gradients against a per-group
    ``torch.matmul``: uneven counts, empty groups, every row in one group
    (the plain version; the library's on the card is in the gpu file);
  * (d) the model's forward and backward read nothing on the host;
  * (e) three windowed ``Trainer`` steps on a token split against the
    reference's losses and parameters, and eval's per-position loss;
  * (f) what the Trainer refuses for a token model.

The tests marked ``gpu`` for the card are in test_torch_port_moe_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cs744_ddp_tpu_torch import models
from cs744_ddp_tpu_torch.data import tokens
from cs744_ddp_tpu_torch.models import layers, moonlight
from cs744_ddp_tpu_torch.ops import loss as tloss
from cs744_ddp_tpu_torch.ops import moe
from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
from cs744_ddp_tpu_torch.train import loop, step as tstep
from cs744_ddp_tpu_torch.train.loop import Trainer
from portbench import plugins

ref = plugins.load("arch", "moonlight")

# The narrow preset, in the keys of the benchmark's configuration file.
NARROW = dict(
    hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
    intermediate_size=96, moe_intermediate_size=32, num_attention_heads=4,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rope_theta=50000.0, n_routed_experts=16, num_experts_per_tok=4,
    n_shared_experts=2, routed_scaling_factor=2.446, norm_topk_prob=True,
    rms_norm_eps=1e-5, vocab_size=256, n_routed_experts_held=4,
    first_held=0, initializer_range=0.02, router_bias_std=0.1)
SEQ = 32
# f32 against the reference: the same arithmetic summed in other orders
# (attention through scaled_dot_product_attention against the written-out
# softmax, the held experts' rows masked against gathered, atomics-free
# index_add in another order), each about 1e-7 relative, through three
# layers and their backward: measured at most 6e-7 on the logits and the
# gradients' leaves.
RTOL = 1e-5
# Three SGD steps at lr 0.01 compound those: measured at most 1e-6.
STEPS_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (the suite runs its files in
    parallel)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**kw) -> moonlight.MoonlightConfig:
    c = dict(NARROW, **kw)
    held = c.pop("n_routed_experts_held")
    names = {f.name for f in dataclasses.fields(moonlight.MoonlightConfig)}
    return moonlight.MoonlightConfig(held_experts=held, **{
        k: v for k, v in c.items() if k in names})


def _model(seed: int, **kw) -> moonlight.Moonlight:
    model = moonlight.Moonlight(_config(**kw))
    layers.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _ref_init(seed: int):
    """The reference's (parameters, router biases): each bias travels as
    its router weight's ``router_bias``."""
    params, _ = ref.init(NARROW, seed, "cpu")
    return params, [p.router_bias for p in params
                    if hasattr(p, "router_bias")]


def _ref_forward(params, ids):
    return ref.forward(NARROW, params, [], ids)


def _ref_loss_and_grads(params, ids, targets):
    """(mean cross-entropy over every position, each parameter's
    gradient) of the reference, f32."""
    leaves = []
    for p in params:
        leaf = p.detach().requires_grad_(True)
        if hasattr(p, "router_bias"):
            leaf.router_bias = p.router_bias
        leaves.append(leaf)
    loss = F.cross_entropy(_ref_forward(leaves, ids), targets.reshape(-1))
    # A held expert that no token chose is left out of the reference's
    # graph: its gradient is zero.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _plain(t):
    return t


def _ids(seed: int, rows: int = 2):
    seqs = torch.randint(0, NARROW["vocab_size"], (rows, SEQ + 1),
                         generator=torch.Generator().manual_seed(seed))
    return seqs[:, :-1], seqs[:, 1:]


def test_draws_are_the_references():
    """The zoo's draw in module order is the reference's, leaf for leaf,
    the router biases included; the full cut has the configuration's
    970,107,392 parameters."""
    model = _model(7)
    params, biases = _ref_init(7)
    names = [leaf.name for leaf in ref.leaves(NARROW)]
    assert [n for n, _ in model.named_parameters()] == names
    for p, r in zip(model.parameters(), params):
        assert torch.equal(p.detach(), r)
    got = [b for n, b in model.named_buffers()
           if n.endswith("e_score_correction_bias")]
    assert len(got) == len(biases) == 2
    for b, r in zip(got, biases):
        assert torch.equal(b, r)
    with torch.device("meta"):
        full = models.moonlight.Moonlight(
            models.MOONLIGHT["moonlight-16b-a3b-ep8"])
    assert sum(p.numel() for p in full.parameters()) == 970_107_392
    assert models.input_kind("moonlight-16b-a3b-ep8") == "tokens"
    assert models.input_kind("vgg11") == "images"


def test_zoo_cut_is_the_benchmark_configuration():
    """The zoo's ``moonlight-16b-a3b-ep8`` is the benchmark configuration
    the reference is run at, key for key (the router bias's spread
    included), and the widths are the published ones."""
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "portbench" / "configs" \
        / "moonlight_16b_a3b_ep8.json"
    cfg = json.loads(path.read_text())
    cut = models.MOONLIGHT["moonlight-16b-a3b-ep8"]
    for field in dataclasses.fields(cut):
        key = "n_routed_experts_held" if field.name == "held_experts" \
            else field.name
        assert getattr(cut, field.name) == cfg[key], key
    assert cfg["port_model"] == "moonlight-16b-a3b-ep8"
    assert cut.router_bias_std == 0.0
    assert (cut.hidden_size, cut.moe_intermediate_size,
            cut.n_routed_experts) == (2048, 1408, 64)


@pytest.mark.parametrize("chunk", [None, 5])
def test_model_matches_reference_f32(chunk, monkeypatch):
    """(a) Logits, loss and every gradient, f32, within RTOL; with the
    expert layer's row-wise work in its own chunks (``CHUNK_ROWS``) or in
    chunks of 5 rows."""
    if chunk is not None:
        monkeypatch.setattr(moe, "CHUNK_ROWS", chunk)
    model = _model(3)
    params, _ = _ref_init(3)
    x, y = _ids(1)
    with torch.no_grad():
        assert _rel(model(x), _ref_forward(params, x)) < RTOL
    loss, grads = _ref_loss_and_grads(params, x, y)
    got = tloss.cross_entropy(model(x, torch.float32), y.reshape(-1))
    assert abs(float(got.detach()) - float(loss)) <= RTOL * float(loss)
    mine = torch.autograd.grad(got, list(model.parameters()))
    for (name, _), a, b in zip(model.named_parameters(), mine, grads):
        assert _rel(a, b) < RTOL, name


def test_expert_shares_add_up_to_the_uncut_layer():
    """(b) Four chips each holding 4 of the 16 experts: their layers'
    outputs, less the shared expert on all but one, are the uncut
    reference layer's routed experts plus its shared expert."""
    full = moonlight.MoE(_config(n_routed_experts_held=16))
    layers.reset_parameters(full, torch.Generator().manual_seed(9))
    x = torch.randn(48, NARROW["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    shared = full.shared_experts
    w = [p.detach() for p in shared.parameters()]
    uncut = ref.experts(dict(NARROW, n_routed_experts_held=16),
                        full.w13.detach(), full.w2.detach(),
                        full.gate.weight.detach(),
                        full.gate.e_score_correction_bias, x, _plain) \
        + ref.swiglu(x, *w, _plain)
    total = torch.zeros_like(uncut)
    for chip in range(4):
        part = moonlight.MoE(_config(first_held=4 * chip))
        with torch.no_grad():
            part.w13.copy_(full.w13[4 * chip:4 * chip + 4])
            part.w2.copy_(full.w2[4 * chip:4 * chip + 4])
            part.gate.load_state_dict(full.gate.state_dict())
            part.shared_experts.load_state_dict(shared.state_dict())
            total += part(x)
    with torch.no_grad():
        total -= 3 * shared(x)
    assert _rel(total, uncut) < RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [[5, 0, 9, 2], [0, 0, 0, 0],
                                    [0, 16, 0, 0], [3, 0, 0, 13]])
def test_grouped_mm_matches_per_group_matmul(dtype, counts):
    """(c) Forward, dX and dW of the plain version against per-group
    matmuls (bf16: the same rounding of f32 sums; dW f32), rows past the
    groups zero; no run counted."""
    gen = torch.Generator().manual_seed(sum(counts) + len(counts))
    m, k, n = 20, 24, 40
    x = torch.randn(m, k, generator=gen).to(dtype).requires_grad_(True)
    w = torch.randn(len(counts), k, n, generator=gen).requires_grad_(True)
    dy = torch.randn(m, n, generator=gen).to(dtype)
    offsets = torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int32)
    before = moe.executed_counts()
    y = moe.grouped_mm(x, w, offsets)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    lo, tol = 0, 0 if dtype == torch.float32 else 1e-2
    for g, c in enumerate(counts):
        rows = slice(lo, lo + c)
        wg = w[g].detach().to(dtype)
        torch.testing.assert_close(y[rows], x[rows].detach() @ wg,
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(dx[rows], dy[rows] @ wg.t(),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(
            dw[g], x[rows].detach().float().t() @ dy[rows].float(),
            rtol=1e-5, atol=1e-5)
        lo += c
    assert not y[lo:].any() and not dx[lo:].any()
    # Runs are counted at the library's launch on the card, never here.
    assert moe.executed_counts() == before


def test_rows_past_the_groups_never_reach_the_layer(monkeypatch):
    """On the card the library leaves the rows past the last group
    unwritten: with NaN in them, the model's loss and every gradient are
    those of the plain version's zeros, bit for bit."""
    model = _model(3)
    x, y = _ids(1)

    def loss_and_grads():
        loss = tloss.cross_entropy(model(x, torch.float32), y.reshape(-1))
        return [loss.detach()] + list(torch.autograd.grad(
            loss, list(model.parameters())))

    want = loss_and_grads()
    plain = moe._mm
    past = []

    def unwritten(x, w, offsets, run):
        out = plain(x, w, offsets, run).clone()
        out[int(offsets[-1]):] = float("nan")
        past.append(out.shape[0] - int(offsets[-1]))
        return out
    monkeypatch.setattr(moe, "_mm", unwritten)
    got = loss_and_grads()
    assert min(past) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sort_rows_orders_by_group_with_device_offsets():
    group = torch.tensor([2, 4, 0, 2, 4, 1, 0, 2])
    order, offsets, _ = moe.sort_rows(group, 4)
    assert order.tolist() == [2, 6, 5, 0, 3, 7, 1, 4]
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 2, 3, 6, 6]


@pytest.mark.parametrize("rows,groups", [(8, 4), (96, 4), (1, 1), (50, 7)])
def test_sort_rows_inverse_permutation(rows, groups):
    """``inv`` is int32 and each row's position in ``order``:
    ``inv[order] == arange``, so slot t*k + j of a token finds its sorted
    row."""
    group = torch.randint(0, groups + 1, (rows,),
                          generator=torch.Generator().manual_seed(rows))
    order, _, inv = moe.sort_rows(group, groups)
    assert inv.dtype == torch.int32 and inv.shape == order.shape
    assert torch.equal(inv[order], torch.arange(rows, dtype=torch.int32))
    assert torch.equal(order[inv.long()], torch.arange(rows))


def test_row_counters_present_and_zero_after_reset():
    """``executed_counts`` carries the row kernels' held and static rows
    (adjacent: the kernels add to both through one pointer); reset zeroes
    them with every other count and the wrappers' launch counts."""
    keys = moe.KEYS
    assert keys.index("row_capacity") == keys.index("row_rows") + 1
    counter = moe._counter(torch.device("cpu"))
    counter.add_(3)
    moe._LAUNCHES["gather_rows"] += 1
    assert moe.executed_counts()["row_rows"] >= 3
    moe.reset_counts()
    counts = moe.executed_counts()
    assert set(counts) == set(keys)
    assert counts["row_rows"] == counts["row_capacity"] == 0
    assert all(v == 0 for v in counts.values())
    assert moe.launch_counts() == dict.fromkeys(moe.ROW_KERNELS, 0)


class _FrozenRoutedExperts(torch.autograd.Function):
    """The expert layer's row-wise work as the port wrote it before the
    row kernels (plain PyTorch over every row): the yardstick that the
    plain version stays bit for bit what it was."""

    @staticmethod
    def forward(ctx, x, weight, w13, w2, token, offsets):
        dt, tokens = x.dtype, x.shape[0]
        w13c, w2c = w13.to(dt), w2.to(dt)
        xs = x.index_select(0, token)
        gu = moe._mm(xs, w13c, offsets, "fwd")
        h = F.silu(gu[:, :w2.shape[1]]) * gu[:, w2.shape[1]:]
        ys = moe._mm(h, w2c, offsets, "fwd")
        dest, _ = moe._destinations(token, offsets, tokens)
        out = torch.zeros((tokens + 1, x.shape[1]), dtype=torch.float32)
        for rows in moe._chunks(token.shape[0]):
            out.index_add_(0, dest[rows], ys[rows] * weight[rows, None])
        ctx.save_for_backward(x, weight, w13c, w2c, token, offsets)
        return out[:tokens]

    @staticmethod
    def backward(ctx, dout):
        x, weight, w13c, w2c, token, offsets = ctx.saved_tensors
        dt, width, groups = x.dtype, w2c.shape[1], w2c.shape[0]
        xs = x.index_select(0, token)
        gu = moe._mm(xs, w13c, offsets, "fwd_recompute")
        g, u = gu[:, :width], gu[:, width:]
        s = F.silu(g)
        h = s * u
        dyu = dout.to(dt).index_select(0, token)
        dh_unit = moe._mm(dyu, w2c.transpose(1, 2), offsets, "dx")
        d_weight = torch.empty(token.shape, dtype=torch.float32)
        dh, hw = torch.empty_like(dh_unit), torch.empty_like(h)
        for rows in moe._chunks(token.shape[0]):
            d_weight[rows] = (dh_unit[rows] * h[rows].float()).sum(-1)
            dh[rows] = dh_unit[rows] * weight[rows, None]
            hw[rows] = h[rows] * weight[rows, None]
        dest, past = moe._destinations(token, offsets, x.shape[0])
        d_weight.masked_fill_(past, 0)
        dw2 = moe._dw(hw, dyu, offsets, groups)
        dgu = torch.empty_like(gu)
        torch.mul(dh, s, out=dgu[:, width:])
        dgu[:, :width] = torch.ops.aten.silu_backward(dh * u, g)
        dxs = moe._mm(dgu, w13c.transpose(1, 2), offsets, "dx")
        dw13 = moe._dw(xs, dgu, offsets, groups)
        dx = torch.zeros((x.shape[0] + 1, x.shape[1]), dtype=torch.float32)
        for rows in moe._chunks(token.shape[0]):
            dx.index_add_(0, dest[rows], dxs[rows].float())
        return dx[:-1].to(dt), d_weight, dw13, dw2, None, None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [None, 7])
def test_plain_routed_experts_unchanged(chunk, dtype, monkeypatch):
    """The plain version (CPU) of the expert layer, its row-wise passes
    now split into the row kernels' plain versions: output and every
    gradient bit for bit the frozen formulas', at the default chunk and at
    chunks of 7 rows; rows of no group among the rows."""
    if chunk is not None:
        monkeypatch.setattr(moe, "CHUNK_ROWS", chunk)
    gen = torch.Generator().manual_seed(23)
    tokens, k, hidden, width, groups = 24, 4, 32, 16, 4
    group = torch.randint(0, groups + 1, (tokens * k,), generator=gen)
    order, offsets, inv = moe.sort_rows(group, groups)
    weight = torch.where(group < groups, torch.rand(tokens * k,
                                                    generator=gen), 0.0)
    weight = weight.index_select(0, order)
    token = torch.div(order, k, rounding_mode="floor")
    x = torch.randn(tokens, hidden, generator=gen).to(dtype)
    w13 = torch.randn(groups, hidden, 2 * width, generator=gen) * 0.2
    w2 = torch.randn(groups, width, hidden, generator=gen) * 0.2
    probe = torch.randn(tokens, hidden, generator=gen)

    def run(fn, *extra):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight, w13,
                                                           w2)]
        out = fn(*leaves, token, offsets, *extra)
        return [out.detach()] + list(torch.autograd.grad(
            (out * probe).sum(), leaves))

    want = run(_FrozenRoutedExperts.apply)
    got = run(moe.routed_experts, inv)
    assert int(offsets[-1]) < tokens * k
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_model_step_reads_nothing_on_the_host(monkeypatch):
    """(d) The whole forward and backward in bf16, the expert layers'
    routing, sort, grouped products and combine included, with every
    Tensor method that would read a value on the host made to raise."""
    model = _model(4)
    x, y = _ids(5)

    def refused(*a, **k):
        raise AssertionError("a host read in the step")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    loss = tloss.cross_entropy(model(x, torch.bfloat16), y.reshape(-1))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    monkeypatch.undo()
    assert all(torch.isfinite(g).all() for g in grads)


def test_chunked_cross_entropy_equals_the_plain_mean(monkeypatch):
    """Above CHUNKED_ABOVE logits the mean and its gradient are those of
    the plain f32 formula, chunk by chunk."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(50, 37, generator=gen).bfloat16().requires_grad_(
        True)
    labels = torch.randint(0, 37, (50,), generator=gen)
    plain = tloss.cross_entropy(logits, labels)
    (g_plain,) = torch.autograd.grad(plain, logits)
    monkeypatch.setattr(tloss, "CHUNKED_ABOVE", 0)
    monkeypatch.setattr(tloss, "CHUNK_ROWS", 7)
    chunked = tloss.cross_entropy(logits, labels)
    (g_chunked,) = torch.autograd.grad(chunked, logits)
    torch.testing.assert_close(chunked, plain, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_chunked, g_plain, rtol=1e-2, atol=1e-6)
    expected = F.cross_entropy(logits.float(), labels)
    torch.testing.assert_close(chunked, expected, rtol=1e-6, atol=0)


@pytest.fixture
def token_model(tmp_path, monkeypatch):
    """The narrow preset as ``mnarrow`` in the zoo, and a token split of
    18 training sequences (6 steps of 3) and 4 test sequences."""
    monkeypatch.setitem(models._CUSTOM, "mnarrow",
                        moonlight.factory(_config()))
    rng = np.random.default_rng(1)
    train = rng.integers(0, NARROW["vocab_size"], (18, SEQ + 1))
    test = rng.integers(0, NARROW["vocab_size"], (4, SEQ + 1))
    tokens.write(str(tmp_path), train.astype(np.int32),
                 test.astype(np.int32))
    return str(tmp_path), train, test


def _trainer(data_dir, **kw):
    args = dict(global_batch=3, data_dir=data_dir, device="cpu", seed=11,
                augment=False, sgd_cfg=SGDConfig(lr=0.01),
                log=lambda s: None)
    args.update(kw)
    return Trainer("mnarrow", "single", **args)


def test_windowed_steps_match_reference(token_model):
    """(e) Three steps through the window's own call: each step's loss and
    the parameters after them equal the reference's (the sampler's order,
    inputs ids[:, :-1], targets ids[:, 1:], SGD with L2 decay and
    momentum); the eval window gives the per-position mean loss."""
    data_dir, train, test = token_model
    trainer = _trainer(data_dir)
    window = trainer.train_window()
    fetched = window(0, 0, 3).cpu().numpy()
    losses = window.columns(fetched, 0, 3).loss
    params, _ = _ref_init(11)
    velocity = [torch.zeros_like(p) for p in params]
    order = np.random.default_rng(11).permutation(len(train))
    cfg = trainer.sgd_cfg
    for step in range(3):
        seqs = torch.from_numpy(train[order[3 * step:3 * step + 3]])
        loss, grads = _ref_loss_and_grads(params, seqs[:, :-1],
                                          seqs[:, 1:])
        assert abs(losses[step] - float(loss)) <= RTOL * float(loss)
        for p, g, v in zip(params, grads, velocity):
            v.mul_(cfg.momentum).add_(g + cfg.weight_decay * p)
            p.sub_(cfg.lr * v)
    for (name, p), r in zip(trainer.state.model.named_parameters(), params):
        assert _rel(p.detach(), r) < STEPS_RTOL, name
    avg, correct, _ = trainer.test_model()
    seqs = torch.from_numpy(test)
    with torch.no_grad():
        logits = _ref_forward(params, seqs[:, :-1])
    expected = F.cross_entropy(logits, seqs[:, 1:].reshape(-1))
    assert abs(avg - float(expected)) <= 1e-4 * float(expected)
    assert correct == int((logits.argmax(-1) == seqs[:, 1:].reshape(-1))
                          .sum())


def test_token_epoch_trains_its_windows(token_model):
    """A whole epoch: one window of the 6 full batches, one round trip,
    the ids staged as int32 [batches, rows, S] and the targets int64."""
    data_dir, _, _ = token_model
    trainer = _trainer(data_dir, precision="bf16")
    before = trainer.trace_counts()
    trainer.train_model(0)
    after = trainer.trace_counts()
    assert after["replays"] - before["replays"] == 6
    assert after["host_round_trips"] - before["host_round_trips"] == 1
    staged = trainer._staged_buffers()
    assert staged.images.shape == (6, 3, SEQ)
    assert staged.images.dtype == torch.int32
    assert staged.labels.shape == (6, 3, SEQ)
    assert staged.tail is None
    assert all(torch.isfinite(p).all()
               for p in trainer.state.model.parameters())


@pytest.mark.parametrize("kw,match", [
    (dict(augment=True), "augment"),
    (dict(host_augment=True), "host_augment"),
    (dict(elastic="weak"), "elastic"),
    (dict(profile_phases=True), "profile_phases"),
])
def test_trainer_refuses_for_token_models(token_model, kw, match):
    """(f) Augmentation, the host pipeline, elastic resizing and the
    per-step path are refused, each by name."""
    with pytest.raises(ValueError, match=f"token model.*{match}"):
        _trainer(token_model[0], **kw)


def test_trainer_refuses_world_above_one(token_model, monkeypatch):
    """(f) A process group of two ranks is refused before any data is
    read."""
    class TwoRanks:
        world, rank = 2, 0

        def __init__(self, device):
            pass
    monkeypatch.setattr(loop.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(loop, "Group", TwoRanks)
    with pytest.raises(ValueError, match="world 1 only.*world 2"):
        Trainer("mnarrow", "allreduce", data_dir=token_model[0],
                device="cpu", augment=False, global_batch=4)


def test_token_split_files_round_trip(tmp_path):
    seqs = np.arange(3 * 9, dtype=np.int32).reshape(3, 9)
    tokens.write(str(tmp_path), seqs, seqs[:1])
    train, test = tokens.load(str(tmp_path))
    assert np.array_equal(train.images, seqs[:, :-1])
    assert np.array_equal(train.labels, seqs[:, 1:])
    assert test.images.shape == (1, 8)
    with pytest.raises(FileNotFoundError, match="token model"):
        tokens.load(str(tmp_path / "none"))
    np.save(tmp_path / "tokens" / "train.npy", seqs.astype(np.int64))
    with pytest.raises(ValueError, match="int32"):
        tokens.load(str(tmp_path))


def test_step_prepare_passes_ids_and_flattens_targets():
    ids = torch.randint(0, 9, (2, 5), dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int64)
    assert tstep.prepare(ids, "tokens", 0, zero, zero, None,
                         torch.bfloat16) is ids
    model = _model(0)
    logits, targets = tstep.logits_and_targets(model, ids, ids.long(), True,
                                               torch.bfloat16)
    assert logits.shape == (10, NARROW["vocab_size"])
    assert logits.dtype == torch.bfloat16
    assert targets.shape == (10,)
