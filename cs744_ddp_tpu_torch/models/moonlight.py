"""Moonlight-16B-A3B (moonshotai/Moonlight-16B-A3B, ``model_type``
``deepseek_v3``; the DeepSeek-V3 layer of arXiv:2412.19437) as one chip
of an expert-parallel deployment: every width as published, the experts
and the vocabulary this chip holds, and fewer layers (``MoonlightConfig``).

The module tree and its parameter order follow Hugging Face's
``modeling_deepseek.py``: the token embedding; decoder layers of
pre-RMSNorm -> multi-head latent attention (MLA) -> residual ->
pre-RMSNorm -> MLP (a dense SwiGLU in the first ``first_k_dense_replace``
layers, else the expert layer) -> residual; a final RMSNorm; an untied
head.

  * RMSNorm computes in f32 and returns the input dtype times the weight
    (``DeepseekV3RMSNorm``); its backward keeps the input and each row's
    1/rms only.
  * MLA without a q LoRA: ``q_proj`` to ``heads x (nope + rope)``;
    ``kv_a_proj_with_mqa`` to ``kv_lora_rank + rope``, the latent through
    an RMSNorm and ``kv_b_proj`` to ``heads x (nope + v)``; RoPE on the
    rope parts in DeepSeek's layout (``apply_rotary_pos_emb``: interleaved
    pairs, then rotate-half), the key's rope part shared by the heads;
    causal attention over each whole sequence (positions 0 .. S-1, no
    document mask) at scale ``(nope + rope)^-1/2`` through
    ``F.scaled_dot_product_attention``; on CUDA only its fused backends
    (flash, cuDNN, memory-efficient: the math backend would build
    heads x S^2 scores), v padded to the query's head size.
  * The router: f32 logits, ``s = sigmoid``, the top ``k`` of ``s + b``
    (``noaux_tc`` with one group; ``b`` a buffer, no gradient parameter),
    weights ``s`` of the chosen over their sum, times the routed scaling
    factor.  It routes over every expert of the layer.
  * The expert layer (``MoE``) is told which experts it holds
    (``held_experts``, the first of them ``first_held``): it keeps the
    (token, expert) pairs of held experts, orders them by expert on the
    device (``ops/moe.py``), runs the held experts' SwiGLU as two grouped
    products over fused gate-and-up and down weights, adds each row times
    its router weight back to token order, and adds the shared experts'
    SwiGLU on every token.  Nothing stands in for the experts held
    elsewhere: a token with none of its experts here gets the shared part
    alone.  No host read anywhere in it, so the step can be captured.

Weights are f32 masters cast to the activation dtype at use (``dtype`` of
``forward``; the model's input is token ids, so it is told the dtype).
``draw_parameters`` draws every linear and embedding weight from
N(0, ``initializer_range``), RMSNorm weights 1, and the router bias from
N(0, ``router_bias_std``) (0 by default: DeepSeek-V3 starts the bias at
zero; the tests draw it wider so that routing by score plus bias and
weighting by score alone both show), through
``layers.reset_parameters``' generator in module order.

The ``cs744.mla``, ``cs744.moe_route``, ``cs744.moe_experts`` and
``cs744.moe_combine`` profiler ranges mark those parts of each layer (the
eager steps show them; a graph replay hides host ranges).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..obs.telemetry import profiler_range
from ..ops import moe
from . import layers

# What the model's input is: the Trainer stages token sequences for it.
INPUT_KIND = "tokens"


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """The keys of the published ``config.json`` that the layer reads, and
    the chip's share: ``held_experts`` of ``n_routed_experts`` from
    ``first_held``, and the vocabulary slice ``vocab_size``."""
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    vocab_size: int = 163840
    held_experts: int = 64
    first_held: int = 0
    initializer_range: float = 0.02
    router_bias_std: float = 0.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# One chip of eight sharing every layer by expert parallelism: experts
# 0-7 of 64 and ids 0-20479 of 163,840; the dense layer and 8 expert
# layers (the others would be further pipeline stages).
MOONLIGHT_16B_A3B_EP8 = MoonlightConfig(
    num_hidden_layers=9, held_experts=8, first_held=0, vocab_size=20480)


class NormalLinear(layers.Linear):
    """A bias-free ``layers.Linear`` drawn from N(0, std)."""

    def __init__(self, cin: int, cout: int, std: float):
        super().__init__(cin, cout, bias=False)
        self.std = std

    def reset_parameters(self) -> None:
        """Nothing at construction: ``draw_parameters`` draws the weight
        (``layers.reset_parameters``), so a model of a billion parameters
        is not drawn twice."""

    def draw_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=gen)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        xf = x.float()
        rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        xhat = (xf * rstd).to(x.dtype)
        ctx.save_for_backward(x, rstd, weight)
        return weight.to(x.dtype) * xhat

    @staticmethod
    def backward(ctx, dy):
        x, rstd, weight = ctx.saved_tensors
        xf = x.float()
        xhat = xf * rstd
        dyf = dy.float()
        dweight = (dyf * xhat.to(x.dtype).float()).reshape(
            -1, x.shape[-1]).sum(0)
        dxhat = dyf * weight.to(x.dtype).float()
        dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dweight.to(weight.dtype), None


class RMSNorm(nn.Module):
    """``DeepseekV3RMSNorm``: x / rms(x) in f32, cast back to x's dtype,
    times the weight cast to it."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def draw_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _RMSNormFn.apply(x, self.weight, self.eps)


class _SwiGLUFn(torch.autograd.Function):
    """silu(g) * u in the inputs' dtype, keeping g and u only."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return F.silu(g) * u

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        return torch.ops.aten.silu_backward(dy * u, g), dy * F.silu(g)


class MLP(nn.Module):
    """``DeepseekV3MLP``: down(silu(gate(x)) * up(x))."""

    def __init__(self, hidden: int, width: int, std: float):
        super().__init__()
        self.gate_proj = NormalLinear(hidden, width, std)
        self.up_proj = NormalLinear(hidden, width, std)
        self.down_proj = NormalLinear(width, hidden, std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(_SwiGLUFn.apply(self.gate_proj(x),
                                              self.up_proj(x)))


def rope_tables(seq: int, dim: int, theta: float, device, dtype):
    """(cos, sin) [seq, dim] of positions 0 .. seq-1, as
    ``DeepseekV3RotaryEmbedding`` makes them (f32, then the activation
    dtype)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device)
                                .float() / dim))
    t = torch.arange(seq, device=device, dtype=inv_freq.dtype)
    emb = torch.cat([torch.outer(t, inv_freq)] * 2, dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """``apply_rotary_pos_emb`` on x [B, S, heads, d]: the interleaved
    pairs de-interleaved, then x * cos + rotate_half(x) * sin."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, h, d // 2, 2).transpose(3, 4).reshape(b, s, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[None, :, None, :] + half * sin[None, :, None, :]


def _fused_attention(q, k, v, scale):
    """Causal attention of [B, heads, S, d] q, k, v; on CUDA through the
    fused backends only (a sequence that none of them takes raises)."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)


class MLA(nn.Module):
    """``DeepseekV3Attention`` without a q LoRA."""

    def __init__(self, c: MoonlightConfig):
        super().__init__()
        std = c.initializer_range
        heads = c.num_attention_heads
        self.c = c
        self.q_proj = NormalLinear(c.hidden_size, heads * c.qk_head_dim, std)
        self.kv_a_proj_with_mqa = NormalLinear(
            c.hidden_size, c.kv_lora_rank + c.qk_rope_head_dim, std)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = NormalLinear(
            c.kv_lora_rank, heads * (c.qk_nope_head_dim + c.v_head_dim), std)
        self.o_proj = NormalLinear(heads * c.v_head_dim, c.hidden_size, std)

    def forward(self, x, cos, sin):
        c = self.c
        b, s, _ = x.shape
        h, nope, rope, dv = (c.num_attention_heads, c.qk_nope_head_dim,
                             c.qk_rope_head_dim, c.v_head_dim)
        q = self.q_proj(x).view(b, s, h, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split(
            [c.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(
            b, s, h, nope + dv)
        k_nope, v = kv.split([nope, dv], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.reshape(b, s, 1, rope), cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
        if dv < nope + rope:
            v = F.pad(v, (0, nope + rope - dv))
        o = _fused_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), c.qk_head_dim ** -0.5)
        o = o.transpose(1, 2)[..., :dv].reshape(b, s, h * dv)
        return self.o_proj(o)


class _F32Linear(torch.autograd.Function):
    """x W^T in f32 of an activation-dtype x, keeping x (not its f32
    copy) for the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.linear(x.float(), w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = (dy @ w).to(x.dtype)
        dw = dy.reshape(-1, dy.shape[-1]).t() @ x.reshape(
            -1, x.shape[-1]).float()
        return dx, dw


class Router(nn.Module):
    """``MoEGate`` with ``scoring_func`` sigmoid and ``topk_method``
    ``noaux_tc`` at one group: (experts [T, k] int64, weights [T, k] f32)."""

    def __init__(self, c: MoonlightConfig):
        super().__init__()
        self.c = c
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts,
                                               c.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(c.n_routed_experts))

    def draw_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, self.c.initializer_range, generator=gen)
        self.e_score_correction_bias.normal_(0.0, self.c.router_bias_std,
                                             generator=gen)

    def forward(self, x: torch.Tensor):
        scores = _F32Linear.apply(x, self.weight).sigmoid()
        experts = torch.topk(scores + self.e_score_correction_bias,
                             self.c.num_experts_per_tok, dim=-1,
                             sorted=False).indices
        weights = scores.gather(1, experts)
        if self.c.norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        return experts, weights * self.c.routed_scaling_factor


class MoE(nn.Module):
    """``DeepseekV3MoE`` of one chip: the held experts' part of the routed
    output plus the shared experts (module docstring)."""

    def __init__(self, c: MoonlightConfig):
        super().__init__()
        if not 0 <= c.first_held <= c.n_routed_experts - c.held_experts:
            raise ValueError(f"experts {c.first_held} .. "
                             f"{c.first_held + c.held_experts - 1} are not "
                             f"among the layer's {c.n_routed_experts}")
        self.c = c
        hidden, width = c.hidden_size, c.moe_intermediate_size
        # The held experts' gate and up projections side by side, and
        # their down projections, [in, out] per expert.
        self.w13 = nn.Parameter(torch.empty(c.held_experts, hidden,
                                            2 * width))
        self.w2 = nn.Parameter(torch.empty(c.held_experts, width, hidden))
        self.gate = Router(c)
        self.shared_experts = MLP(hidden, width * c.n_shared_experts,
                                  c.initializer_range)

    def draw_parameters(self, gen: torch.Generator) -> None:
        self.w13.normal_(0.0, self.c.initializer_range, generator=gen)
        self.w2.normal_(0.0, self.c.initializer_range, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        with profiler_range("moe_route"):
            experts, weights = self.gate(x)
            local = experts - c.first_held
            held = (local >= 0) & (local < c.held_experts)
            group = torch.where(held, local, c.held_experts).reshape(-1)
            order, offsets = moe.sort_rows(group, c.held_experts)
            moe.count_rows(offsets)
            row_weight = torch.where(held.reshape(-1), weights.reshape(-1),
                                     0.0).index_select(0, order)
            token = torch.div(order, c.num_experts_per_tok,
                              rounding_mode="floor")
        with profiler_range("moe_experts"):
            routed = moe.routed_experts(x, row_weight, self.w13, self.w2,
                                        token, offsets)
        with profiler_range("moe_combine"):
            out = routed.to(x.dtype) + self.shared_experts(x)
        return out.reshape(shape)


class DecoderLayer(nn.Module):
    def __init__(self, c: MoonlightConfig, index: int):
        super().__init__()
        self.self_attn = MLA(c)
        self.mlp = MLP(c.hidden_size, c.intermediate_size,
                       c.initializer_range) \
            if index < c.first_k_dense_replace else MoE(c)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden_size,
                                                c.rms_norm_eps)

    def forward(self, x, cos, sin):
        with profiler_range("mla"):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Embedding(nn.Module):
    def __init__(self, vocab: int, hidden: int, std: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, hidden))
        self.std = std

    def draw_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=gen)

    def forward(self, ids: torch.Tensor, dtype) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(dtype)


class Moonlight(nn.Module):
    """Token ids [B, S] -> logits [B * S, vocab_size], sequence-major, in
    the activation dtype ``dtype`` (None: f32)."""

    def __init__(self, c: MoonlightConfig):
        super().__init__()
        self.config = c
        self.embed_tokens = Embedding(c.vocab_size, c.hidden_size,
                                      c.initializer_range)
        self.layers = nn.ModuleList(DecoderLayer(c, i)
                                    for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.lm_head = NormalLinear(c.hidden_size, c.vocab_size,
                                    c.initializer_range)

    def forward(self, ids: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        c = self.config
        dtype = dtype or torch.float32
        x = self.embed_tokens(ids, dtype)
        cos, sin = rope_tables(ids.shape[1], c.qk_rope_head_dim,
                               c.rope_theta, ids.device, dtype)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.lm_head(self.norm(x)).reshape(-1, c.vocab_size)


def factory(config: MoonlightConfig):
    """A zoo factory for ``config`` (``models.register_model``), marked
    with the model's input kind."""
    def make() -> Moonlight:
        return Moonlight(config)
    make.input_kind = INPUT_KIND
    return make
