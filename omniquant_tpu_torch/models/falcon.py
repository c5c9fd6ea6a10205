"""Falcon: the forward and the LWC half of calibration.

Counterpart of ``omniquant_tpu/models/falcon.py``. Parameters are plain
dicts of tensors in the JAX package's layout: per block
``input_layernorm`` (and ``post_attention_layernorm`` without parallel
attention) or, for the new decoder architecture, ``ln_attn`` / ``ln_mlp``,
each {'weight', 'bias'}; ``query_key_value``, ``dense``, ``dense_h_to_4h``
and ``dense_4h_to_h`` {'weight' (out, in), 'bias'} or PackedWeight.

The fused query_key_value projection splits three ways: multi-query (n
query heads, then one k and one v head), classic multi-head (q, k, v
interleaved per head) and the new decoder architecture (per kv head, its
n_rep query heads then its k and v). Positions are rotary, or ALiBi folded
into the additive mask. The attention matmuls are never quantized (only
the linears' inputs are), and the MLP is an exact-GELU one. LET does not
apply to this family: ``effective_block_weights`` rejects it and
``init_let_params`` raises, so calibration is LWC only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..quant.packing import PackedWeight
from ..quant.quantizer import QuantConfig, fake_quant_weight, init_lwc_params
from .common import (
    NO_ACT_QUANT, ActQuantSpec, attention_core, causal_mask, layer_norm,
    linear)
from .llama import apply_rope, rope_cos_sin

LINEAR_NAMES = ("query_key_value", "dense", "dense_h_to_4h", "dense_4h_to_h")


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: Optional[int] = None
    multi_query: bool = True
    new_decoder_architecture: bool = False
    parallel_attn: bool = True
    alibi: bool = False
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def effective_kv_heads(self) -> int:
        """The kv heads the model holds: num_kv_heads (or every head) in
        the new decoder architecture, 1 under multi-query, else every
        head."""
        if self.new_decoder_architecture:
            return self.num_kv_heads or self.num_attention_heads
        if self.multi_query:
            return 1
        return self.num_attention_heads

    @classmethod
    def from_hf(cls, hf_config) -> "FalconConfig":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_hidden_layers=hf_config.num_hidden_layers,
            num_attention_heads=hf_config.num_attention_heads,
            num_kv_heads=getattr(hf_config, "num_kv_heads", None),
            multi_query=getattr(hf_config, "multi_query", True),
            new_decoder_architecture=getattr(
                hf_config, "new_decoder_architecture", False),
            parallel_attn=getattr(hf_config, "parallel_attn", True),
            alibi=getattr(hf_config, "alibi", False),
            layer_norm_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5),
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
            bias=getattr(hf_config, "bias", False))


def split_heads_kv(fused_qkv: torch.Tensor, cfg: FalconConfig):
    """Fused qkv (b, s, qkv_out) -> q (b, s, n_heads, hd) and k, v (b, s,
    n_kv, hd) at the model's true kv head count (what the serving engine
    caches: one kv head for multi-query)."""
    b, s, _ = fused_qkv.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    if cfg.new_decoder_architecture:
        n_kv = cfg.effective_kv_heads
        qkv = fused_qkv.reshape(b, s, n_kv, nh // n_kv + 2, hd)
        return (qkv[:, :, :, :-2].reshape(b, s, nh, hd), qkv[:, :, :, -2],
                qkv[:, :, :, -1])
    if not cfg.multi_query:
        qkv = fused_qkv.reshape(b, s, nh, 3, hd)
        return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    qkv = fused_qkv.reshape(b, s, nh + 2, hd)
    return qkv[..., :-2, :], qkv[..., -2:-1, :], qkv[..., -1:, :]


def split_heads(fused_qkv: torch.Tensor, cfg: FalconConfig):
    """Fused qkv -> (q, k, v), each (b, s, n_heads, hd): split_heads_kv
    with each kv head repeated for its n_rep query heads."""
    q, k, v = split_heads_kv(fused_qkv, cfg)
    n_rep = cfg.num_attention_heads // k.shape[2]
    if n_rep == 1:
        return q, k, v
    return (q, k.repeat_interleave(n_rep, dim=2),
            v.repeat_interleave(n_rep, dim=2))


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """The standard ALiBi head slopes (f32): the geometric sequence of the
    largest power of two at most n_heads, then every other slope of twice
    that many."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = (pow2_slopes(closest)
                  + pow2_slopes(2 * closest)[0::2][: n_heads - closest])
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi_bias(cfg: FalconConfig, kv_len: int, device=None,
               slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1, n_heads, 1, kv_len) f32 additive bias slope_h * key_position /
    sqrt(hd): the ALiBi term with the score scale folded in (the mask is
    added after scaling). It stays f32, and so do the scores it is added
    to: in bf16 the bias at key position p would round by up to 2^-9 of
    itself, about a tenth of a unit of score at position 512 for the first
    head and 0.4 at 2048 (the JAX package adds it in the model's dtype).
    ``slopes``, when given, are alibi_slopes already on ``device``."""
    if slopes is None:
        slopes = alibi_slopes(cfg.num_attention_heads, device)
    dist = torch.arange(kv_len, dtype=torch.float32, device=device)
    bias = (slopes[:, None, None]
            * dist[None, None, :] * (1.0 / cfg.head_dim ** 0.5))
    return bias[None]


def block_forward(p: dict, x: torch.Tensor, cfg: FalconConfig,
                  mask: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  spec: ActQuantSpec = NO_ACT_QUANT,
                  kv_cache: Optional[tuple] = None,
                  tap: Optional[dict] = None):
    """One block: LayerNorm (two for the new decoder architecture), the
    fused qkv, rotary or ALiBi attention, the dense projection, and a
    GELU MLP in parallel with the attention or after it (then with a
    post-attention LayerNorm). Returns (y, (k, v)) with k/v per query head,
    including ``kv_cache``; ``tap``, when a dict, receives each linear's
    input under its name."""
    b, s, _ = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    residual = x
    if cfg.new_decoder_architecture:
        attn_ln_out = layer_norm(x, p["ln_attn"], cfg.layer_norm_eps)
        mlp_ln_out = layer_norm(x, p["ln_mlp"], cfg.layer_norm_eps)
    else:
        attn_ln_out = layer_norm(x, p["input_layernorm"], cfg.layer_norm_eps)
        mlp_ln_out = None

    if tap is not None:
        tap["query_key_value"] = attn_ln_out
    fused = linear(attn_ln_out, p["query_key_value"], spec.act)
    q, k, v = (t.transpose(1, 2) for t in split_heads(fused, cfg))

    if positions is None:
        offset = 0 if kv_cache is None else kv_cache[0].shape[2]
        positions = torch.arange(s, device=x.device) + offset
    if not cfg.alibi:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, dtype=x.dtype)
        q, k = apply_rope(q, k, cos, sin)

    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    new_cache = (k, v)
    kv_len = k.shape[2]

    if mask is None:
        mask = causal_mask(s, kv_len, dtype=x.dtype, device=x.device)
    if cfg.alibi:
        mask = mask + alibi_bias(cfg, kv_len, x.device)

    attn = attention_core(q, k, v, mask, 1.0 / (hd ** 0.5), NO_ACT_QUANT)
    attn = attn.transpose(1, 2).reshape(b, s, nh * hd)
    if tap is not None:
        tap["dense"] = attn
    attn_out = linear(attn, p["dense"], spec.act)

    if not cfg.new_decoder_architecture:
        if cfg.parallel_attn:
            mlp_ln_out = attn_ln_out
        else:
            residual = residual + attn_out
            mlp_ln_out = layer_norm(residual, p["post_attention_layernorm"],
                                    cfg.layer_norm_eps)

    if tap is not None:
        tap["dense_h_to_4h"] = mlp_ln_out
    hmid = torch.nn.functional.gelu(
        linear(mlp_ln_out, p["dense_h_to_4h"], spec.act))
    if tap is not None:
        tap["dense_4h_to_h"] = hmid
    mlp_out = linear(hmid, p["dense_4h_to_h"], spec.act)

    if cfg.new_decoder_architecture or cfg.parallel_attn:
        mlp_out = mlp_out + attn_out
    return residual + mlp_out, new_cache


def effective_block_weights(p: dict, wcfg: Optional[QuantConfig],
                            lwc_params: Optional[dict] = None,
                            let_params: Optional[dict] = None,
                            cfg: Optional[FalconConfig] = None,
                            quantize: bool = True) -> dict:
    """The block's weights after LWC fake quantization, differentiable
    w.r.t. ``lwc_params``; LET raises (this family is LWC only)."""
    if let_params:
        raise NotImplementedError("falcon does not support LET (LWC only)")
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in p.items()}
    if quantize and wcfg is not None and wcfg.enabled:
        for name in LINEAR_NAMES:
            lwc = lwc_params.get(name) if lwc_params else None
            p[name] = dict(p[name])
            p[name]["weight"] = fake_quant_weight(p[name]["weight"], wcfg, lwc)
    return p


def init_let_params(p, cfg, act_scales, act_shifts=None, alpha=0.5,
                    dtype=torch.float32):
    raise NotImplementedError("falcon is LWC-only (no LET)")


def init_lwc_params_block(p: dict, wcfg: QuantConfig,
                          dtype=torch.float32) -> dict:
    """LWC factors (init 4.0) for each linear of a block, on its device."""
    return {name: init_lwc_params(wcfg, p[name]["weight"].shape, dtype,
                                  p[name]["weight"].device)
            for name in LINEAR_NAMES}


def embed(params: dict, tokens: torch.Tensor, cfg=None) -> torch.Tensor:
    return params["word_embeddings"][tokens]


def head(params: dict, hidden: torch.Tensor, cfg: FalconConfig) -> torch.Tensor:
    """Final LayerNorm, then the tied, dense or packed lm_head."""
    hidden = layer_norm(hidden, params["ln_f"], cfg.layer_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["word_embeddings"]
    if isinstance(lm_head, PackedWeight):
        from ..kernels.quant_matmul import quant_matmul

        return quant_matmul(hidden, lm_head)
    return hidden @ lm_head.t()


def forward(params: dict, tokens: torch.Tensor, cfg: FalconConfig,
            spec: ActQuantSpec = NO_ACT_QUANT) -> torch.Tensor:
    """Full causal-LM forward -> logits (b, s, vocab)."""
    x = embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for layer in params["layers"]:
        x, _ = block_forward(layer, x, cfg, None, positions, spec)
    return head(params, x, cfg)


def qkv_out_features(cfg: FalconConfig) -> int:
    """Rows of the fused query_key_value weight."""
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    if cfg.new_decoder_architecture:
        n_kv = cfg.effective_kv_heads
        return n_kv * (nh // n_kv + 2) * hd
    if cfg.multi_query:
        return (nh + 2) * hd
    return 3 * cfg.hidden_size


def init_params(generator: torch.Generator, cfg: FalconConfig,
                dtype=torch.float32, device="cuda") -> dict:
    """Random init (N(0, 0.02) weights and embeddings, zero biases where
    ``cfg.bias``, unit LayerNorms, tied lm_head) from ``generator``, which
    must live on ``device``."""
    from .. import resolve_device

    device = resolve_device(device)
    h = cfg.hidden_size

    def lin(out_f, in_f):
        w = torch.randn(out_f, in_f, generator=generator, device=device,
                        dtype=dtype) * 0.02
        b = torch.zeros(out_f, dtype=dtype, device=device) if cfg.bias else None
        return {"weight": w, "bias": b}

    def norm():
        return {"weight": torch.ones(h, dtype=dtype, device=device),
                "bias": torch.zeros(h, dtype=dtype, device=device)}

    def block():
        out = {"query_key_value": lin(qkv_out_features(cfg), h),
               "dense": lin(h, cfg.num_attention_heads * cfg.head_dim),
               "dense_h_to_4h": lin(4 * h, h),
               "dense_4h_to_h": lin(h, 4 * h)}
        if cfg.new_decoder_architecture:
            out["ln_attn"], out["ln_mlp"] = norm(), norm()
        else:
            out["input_layernorm"] = norm()
            if not cfg.parallel_attn:
                out["post_attention_layernorm"] = norm()
        return out

    emb = torch.randn(cfg.vocab_size, h, generator=generator, device=device,
                      dtype=dtype) * 0.02
    return {"word_embeddings": emb,
            "layers": [block() for _ in range(cfg.num_hidden_layers)],
            "ln_f": norm(),
            "lm_head": None}  # tied


def from_hf_state_dict(sd: dict, cfg: FalconConfig, dtype=torch.float32,
                       device="cuda") -> dict:
    """An HF FalconForCausalLM state dict (tensors or numpy arrays) in this
    package's layout, on ``device``."""
    from .. import resolve_device

    device = resolve_device(device)

    def arr(name):
        return torch.as_tensor(sd[name]).detach().to(device=device,
                                                     dtype=dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return {"weight": arr(prefix + ".weight"),
                "bias": arr(bias) if bias in sd else None}

    def norm(prefix):
        return {"weight": arr(prefix + ".weight"),
                "bias": arr(prefix + ".bias")}

    t = "transformer."
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"{t}h.{i}."
        blk = {"query_key_value": lin(pre + "self_attention.query_key_value"),
               "dense": lin(pre + "self_attention.dense"),
               "dense_h_to_4h": lin(pre + "mlp.dense_h_to_4h"),
               "dense_4h_to_h": lin(pre + "mlp.dense_4h_to_h")}
        if cfg.new_decoder_architecture:
            blk["ln_attn"] = norm(pre + "ln_attn")
            blk["ln_mlp"] = norm(pre + "ln_mlp")
        else:
            blk["input_layernorm"] = norm(pre + "input_layernorm")
            if not cfg.parallel_attn:
                blk["post_attention_layernorm"] = norm(
                    pre + "post_attention_layernorm")
        layers.append(blk)
    return {"word_embeddings": arr(t + "word_embeddings.weight"),
            "layers": layers,
            "ln_f": norm(t + "ln_f"),
            "lm_head": arr("lm_head.weight") if "lm_head.weight" in sd else None}
