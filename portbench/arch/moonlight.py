"""Moonlight-16B-A3B as one chip of an expert-parallel deployment (the
DeepSeek-V3 layer of arXiv:2412.19437 at the widths of
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json):
its plain forward in f32, its parameters and its costs, written from the
published description and Hugging Face's ``modeling_deepseek.py``.  It
imports nothing of the program (``cs744_ddp_tpu_torch/models/
moonlight.py``) or of JAX; the program's CPU tests hold the program
against it at a narrow preset.

The forward (``forward``) on token ids [rows, S]: the embedding; per layer
x + MLA(RMSNorm(x)) (no q LoRA; RoPE on the 64-wide parts in DeepSeek's
interleaved layout; softmax(Q K^T / sqrt(192) + causal mask) V written
out), then x + MLP(RMSNorm(x)) (a dense SwiGLU in the first
``first_k_dense_replace`` layers; else the router, sigmoid scores over all
``n_routed_experts``, the top ``num_experts_per_tok`` of scores plus the
router bias, weights the chosen scores over their sum times the routed
scaling factor, a Python loop over the ``n_routed_experts_held`` experts
held here from ``first_held``, plus the shared experts' SwiGLU); a final
RMSNorm and the untied head: logits [rows * S, vocab_size].  Each decoder
layer runs under ``torch.utils.checkpoint``, so only one layer's heads x
S^2 f32 scores live at a time.  ``q`` rounds what the bf16 program stores
in bf16: the embedding's output, each linear layer's input, weight and
output, each RMSNorm's normalized input, weight and output, the RoPE
tables and outputs, the attention's output, the SwiGLU products, each held
expert's products, the routed sum and every residual sum (the router
computes in f32 from its f32 weight, as the program does).

Departures from the published training (the configuration's ``assumed``),
each forced by the benchmark's comparison, whose reference loss is the
cross-entropy alone and whose forward runs once per chunk of rows:

  * the bias update speed gamma is 0 (DeepSeek-V3's setting for its last
    500 B tokens, section 4.2): the router bias is constant, drawn as
    N(0, router_bias_std^2) (0 in the cell, the published start);
  * no sequence-wise balance loss (DeepSeek-V3's alpha = 1e-4);
  * the cut of ``reduced``: one chip holds a contiguous block of the
    experts, the router still routes over all ``n_routed_experts``, and
    what the experts held elsewhere would add is left out; the vocabulary
    is the chip's slice; fewer layers.

The router biases are constant, and the harness compares a state only
where the architecture names one (``CHECKED_STATE``, none here): so each
travels with its router's weight, as that tensor's ``router_bias``
attribute, and ``init``'s state is empty.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.layers import Leaf, Quant

BATCH_STATISTICS = False


def _draws(c: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor in the order the program's modules draw it, with how
    it is drawn: "normal" (N(0, initializer_range)), "ones", or "bias"
    (a router bias, N(0, router_bias_std), state not parameter)."""
    h, heads = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])

    def mlp(p, width):
        return [(f"{p}.gate_proj.weight", (width, h), "normal"),
                (f"{p}.up_proj.weight", (width, h), "normal"),
                (f"{p}.down_proj.weight", (h, width), "normal")]

    out = [("embed_tokens.weight", (c["vocab_size"], h), "normal")]
    for i in range(c["num_hidden_layers"]):
        a = f"layers.{i}.self_attn"
        out += [(f"{a}.q_proj.weight", (heads * (nope + rope), h), "normal"),
                (f"{a}.kv_a_proj_with_mqa.weight",
                 (c["kv_lora_rank"] + rope, h), "normal"),
                (f"{a}.kv_a_layernorm.weight", (c["kv_lora_rank"],), "ones"),
                (f"{a}.kv_b_proj.weight",
                 (heads * (nope + dv), c["kv_lora_rank"]), "normal"),
                (f"{a}.o_proj.weight", (h, heads * dv), "normal")]
        m = f"layers.{i}.mlp"
        if i < c["first_k_dense_replace"]:
            out += mlp(m, c["intermediate_size"])
        else:
            e, w = c["n_routed_experts_held"], c["moe_intermediate_size"]
            out += [(f"{m}.w13", (e, h, 2 * w), "normal"),
                    (f"{m}.w2", (e, w, h), "normal"),
                    (f"{m}.gate.weight", (c["n_routed_experts"], h),
                     "normal"),
                    (f"{m}.gate.e_score_correction_bias",
                     (c["n_routed_experts"],), "bias")]
            out += mlp(f"{m}.shared_experts", w * c["n_shared_experts"])
        out += [(f"layers.{i}.input_layernorm.weight", (h,), "ones"),
                (f"layers.{i}.post_attention_layernorm.weight", (h,),
                 "ones")]
    return out + [("norm.weight", (h,), "ones"),
                  ("lm_head.weight", (c["vocab_size"], h), "normal")]


def leaves(config: dict) -> List[Leaf]:
    return [Leaf(name, shape, 0, 1.0 if draw == "ones" else 0.0)
            for name, shape, draw in _draws(config) if draw != "bias"]


def init(config: dict, seed: int, device):
    """(parameters, no state), f32 on ``device``, drawn on the host from
    one generator in the program's module order; each router's bias is
    its weight's ``router_bias``."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for _, shape, draw in _draws(config):
        if draw == "ones":
            params.append(torch.ones(shape).to(device))
            continue
        std = config["router_bias_std"] if draw == "bias" \
            else config["initializer_range"]
        t = torch.empty(shape).normal_(0.0, std, generator=gen).to(device)
        if draw == "bias":
            params[-1].router_bias = t      # the router weight, drawn last
        else:
            params.append(t)
    return params, []


def _rms_norm(x, w, eps, q: Quant):
    return q(q(w) * q(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                      + eps)))


def _linear(x, w, q: Quant):
    return q(F.linear(q(x), q(w)))


def _rope(x, theta: float, q: Quant):
    b, s, h, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device)
                                .float() / d))
    freqs = torch.outer(torch.arange(s, device=x.device).float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = q(emb.cos())[None, :, None, :]
    sin = q(emb.sin())[None, :, None, :]
    x = x.reshape(b, s, h, d // 2, 2).transpose(3, 4).reshape(b, s, h, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return q(x * cos + rotated * sin)


def _attention(c, p, x, q: Quant):
    wq, wkva, wnorm, wkvb, wo = p
    b, s, _ = x.shape
    heads = c["num_attention_heads"]
    nope, rdim, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    qh = _linear(x, wq, q).view(b, s, heads, nope + rdim)
    q_nope, q_pe = qh.split([nope, rdim], dim=-1)
    latent, k_pe = _linear(x, wkva, q).split([c["kv_lora_rank"], rdim], -1)
    kv = _linear(_rms_norm(latent, wnorm, c["rms_norm_eps"], q), wkvb, q)
    k_nope, v = kv.view(b, s, heads, nope + dv).split([nope, dv], dim=-1)
    qh = torch.cat([q_nope, _rope(q_pe, c["rope_theta"], q)], dim=-1)
    k_pe = _rope(k_pe.reshape(b, s, 1, rdim), c["rope_theta"], q)
    k = torch.cat([k_nope, k_pe.expand(b, s, heads, rdim)], dim=-1)
    qh, k, v = (t.transpose(1, 2) for t in (qh, k, v))     # [B, h, S, d]
    scores = torch.matmul(qh, k.transpose(-1, -2))
    scores.mul_((nope + rdim) ** -0.5)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores.masked_fill_(~causal, float("-inf"))
    probs = torch.softmax(scores, -1)
    o = q(torch.matmul(probs, v)).transpose(1, 2).reshape(b, s, heads * dv)
    return _linear(o, wo, q)


def swiglu(x, gate, up, down, q: Quant):
    return _linear(q(F.silu(_linear(x, gate, q)) * _linear(x, up, q)), down,
                   q)


def experts(c, w13, w2, wr, bias, x, q: Quant):
    scores = torch.sigmoid(x @ wr.t())
    chosen = torch.topk(scores + bias, c["num_experts_per_tok"],
                        dim=-1).indices
    weights = scores.gather(1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20) \
        * c["routed_scaling_factor"]
    width = c["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts_held"]):
        mine = chosen == c["first_held"] + e
        tokens = mine.any(-1).nonzero()[:, 0]
        if tokens.numel() == 0:       # no rows: nothing to add, no gradient
            continue
        xe = q(x[tokens])
        gu = q(xe @ q(w13[e]))
        h = q(F.silu(gu[:, :width]) * gu[:, width:])
        y = q(h @ q(w2[e]))
        weight = (weights * mine).sum(-1)[tokens]
        out = out.index_add(0, tokens, y * weight[:, None])
    return q(out)


def _layer(c, i, lp, x, q: Quant):
    eps = c["rms_norm_eps"]
    b, s, h = x.shape
    attn, mlp, n_in, n_post = lp
    x = q(x + _attention(c, attn, _rms_norm(x, n_in, eps, q), q))
    y = _rms_norm(x, n_post, eps, q).reshape(b * s, h)
    if i < c["first_k_dense_replace"]:
        y = swiglu(y, *mlp, q)
    else:
        w13, w2, wr, shared = mlp
        y = q(experts(c, w13, w2, wr, wr.router_bias, y, q)
              + swiglu(y, *shared, q))
    return q(x + y.reshape(b, s, h))


def forward(config: dict, params, state, x, q: Quant = lambda t: t):
    """Logits [rows * S, vocab_size] of token ids ``x`` [rows, S]
    (``state`` is empty: ``init``)."""
    c = config
    it = iter(params)
    h = q(F.embedding(x, next(it)))
    for i in range(c["num_hidden_layers"]):
        attn = [next(it) for _ in range(5)]
        if i < c["first_k_dense_replace"]:
            mlp = [next(it) for _ in range(3)]
        else:
            w13, w2, wr = next(it), next(it), next(it)
            mlp = [w13, w2, wr, [next(it) for _ in range(3)]]
        lp = (attn, mlp, next(it), next(it))
        h = checkpoint(_layer, c, i, lp, h, q, use_reentrant=False)
    h = _rms_norm(h, next(it), c["rms_norm_eps"], q)
    return _linear(h, next(it), q).reshape(-1, c["vocab_size"])


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

def _seq_len(traffic: dict) -> int:
    return traffic["dataset"]["seq_len"]


def routed_macs_per_row(config: dict) -> int:
    """One held expert's SwiGLU on one row: gate, up and down."""
    return 3 * config["hidden_size"] * config["moe_intermediate_size"]


def mean_routed_rows_per_token(config: dict) -> float:
    """Held rows a token makes on average under uniform routing: each of
    its experts held here with probability held / routed."""
    return config["num_experts_per_tok"] * config["n_routed_experts_held"] \
        / config["n_routed_experts"]


def macs_per_token_parts(config: dict, traffic: dict) -> Dict[str, float]:
    """Multiply-accumulates of one token's forward by part, at the
    sequence length of ``traffic``: the attention's projections, its
    causal scores and weighted values (a token at position i attends i + 1
    positions: (S + 1) / 2 on average), the dense SwiGLU, the shared
    experts, the router, the routed experts at the mean load, the head."""
    c = config
    h, heads = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    layers = c["num_hidden_layers"]
    moe_layers = layers - c["first_k_dense_replace"]
    s = _seq_len(traffic)
    proj = h * heads * (nope + rope) + h * (c["kv_lora_rank"] + rope) \
        + c["kv_lora_rank"] * heads * (nope + dv) + heads * dv * h
    return {
        "attention_projections": layers * proj,
        "attention_scores": layers * heads * (nope + rope + dv)
        * (s + 1) / 2,
        "dense_mlp": c["first_k_dense_replace"] * 3 * h
        * c["intermediate_size"],
        "shared_experts": moe_layers * 3 * h * c["moe_intermediate_size"]
        * c["n_shared_experts"],
        "router": moe_layers * h * c["n_routed_experts"],
        "routed_experts": moe_layers * routed_macs_per_row(c)
        * mean_routed_rows_per_token(c),
        "head": h * c["vocab_size"],
    }


def macs_per_example(config: dict, traffic: dict) -> int:
    """A training sequence's forward MACs at the mean expert load."""
    return round(sum(macs_per_token_parts(config, traffic).values())
                 * _seq_len(traffic))


def macs_per_example_unrouted(config: dict, traffic: dict) -> int:
    """A sequence's forward MACs without the routed experts' products."""
    parts = macs_per_token_parts(config, traffic)
    parts.pop("routed_experts")
    return round(sum(parts.values()) * _seq_len(traffic))
