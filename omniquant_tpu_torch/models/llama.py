"""LLaMA / Llama-2 inference forward.

Counterpart of ``omniquant_tpu/models/llama.py`` without the calibration
half (the LET/LWC transforms and their initialisers). Parameters are plain
dicts of tensors in the JAX package's layout: per block
``input_layernorm`` / ``post_attention_layernorm`` {'weight'} and
``q_proj`` ... ``down_proj`` {'weight' (out, in), 'bias'} or PackedWeight.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.packing import PackedWeight
from .common import (
    NO_ACT_QUANT, ActQuantSpec, attention_core, causal_mask, linear,
    repeat_kv, rms_norm)

LINEAR_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def n_rep(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """cos/sin tables (..., seq, head_dim) in the duplicated-halves layout,
    computed in f32 and cast to dtype."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: (b, heads, s, hd); cos/sin: (s, hd) or (b, s, hd)."""
    if cos.ndim == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def block_forward(p: dict, x: torch.Tensor, cfg: LlamaConfig,
                  mask: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  spec: ActQuantSpec = NO_ACT_QUANT,
                  kv_cache: Optional[tuple] = None):
    """One decoder block: pre-norm attention with RoPE and GQA, pre-norm
    SwiGLU MLP. Returns (y, (k, v)) with k/v including ``kv_cache``."""
    b, s, _ = x.shape
    hd, n_heads, n_kv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    residual = x
    hidden = rms_norm(x, p["input_layernorm"], cfg.rms_norm_eps)

    def heads(y, n):
        return y.reshape(b, s, n, hd).transpose(1, 2)

    q = heads(linear(hidden, p["q_proj"], spec.act), n_heads)
    k = heads(linear(hidden, p["k_proj"], spec.act), n_kv)
    v = heads(linear(hidden, p["v_proj"], spec.act), n_kv)
    if positions is None:
        offset = 0 if kv_cache is None else kv_cache[0].shape[2]
        positions = torch.arange(s, device=x.device) + offset
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, dtype=x.dtype)
    q, k = apply_rope(q, k, cos, sin)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    new_cache = (k, v)
    k_r, v_r = repeat_kv(k, cfg.n_rep), repeat_kv(v, cfg.n_rep)
    if mask is None:
        mask = causal_mask(s, k_r.shape[2], dtype=x.dtype, device=x.device)
    attn = attention_core(q, k_r, v_r, mask, 1.0 / (hd ** 0.5), spec)
    attn = attn.transpose(1, 2).reshape(b, s, n_heads * hd)
    x = residual + linear(attn, p["o_proj"], spec.act)

    residual = x
    hidden = rms_norm(x, p["post_attention_layernorm"], cfg.rms_norm_eps)
    gate = linear(hidden, p["gate_proj"], spec.act)
    up = linear(hidden, p["up_proj"], spec.act)
    mlp_out = linear(torch.nn.functional.silu(gate) * up, p["down_proj"],
                     spec.act)
    return residual + mlp_out, new_cache


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][tokens]


def head(params: dict, hidden: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Final norm, then the tied, dense or packed lm_head."""
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["embed_tokens"]
    if isinstance(lm_head, PackedWeight):
        from ..kernels.quant_matmul import quant_matmul

        return quant_matmul(hidden, lm_head)
    return hidden @ lm_head.t()


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            spec: ActQuantSpec = NO_ACT_QUANT) -> torch.Tensor:
    """Full causal-LM forward -> logits (b, s, vocab)."""
    x = embed(params, tokens)
    s = tokens.shape[1]
    mask = causal_mask(s, s, dtype=x.dtype, device=x.device)
    positions = torch.arange(s, device=x.device)
    for layer in params["layers"]:
        x, _ = block_forward(layer, x, cfg, mask, positions, spec)
    return head(params, x, cfg)


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                dtype=torch.float32, device="cuda") -> dict:
    """Random init (N(0, 0.02) weights, unit norms) from ``generator``, which
    must live on ``device``."""
    from .. import resolve_device

    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=dtype) * 0.02

    def lin(out_f, in_f):
        return {"weight": normal(out_f, in_f), "bias": None}

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    h, i = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    layers = [{
        "input_layernorm": {"weight": ones(h)},
        "post_attention_layernorm": {"weight": ones(h)},
        "q_proj": lin(h, h), "k_proj": lin(kv, h), "v_proj": lin(kv, h),
        "o_proj": lin(h, h), "gate_proj": lin(i, h), "up_proj": lin(i, h),
        "down_proj": lin(h, i),
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "embed_tokens": normal(cfg.vocab_size, h),
        "layers": layers,
        "norm": {"weight": ones(h)},
        "lm_head": None if cfg.tie_word_embeddings else normal(cfg.vocab_size, h),
    }
