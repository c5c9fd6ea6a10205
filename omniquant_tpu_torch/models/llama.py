"""LLaMA / Llama-2: the forward and the calibration transforms.

Counterpart of ``omniquant_tpu/models/llama.py``. Parameters are plain
dicts of tensors in the JAX package's layout: per block
``input_layernorm`` / ``post_attention_layernorm`` {'weight', optional
'bias'} and ``q_proj`` ... ``down_proj`` {'weight' (out, in), 'bias'} or
PackedWeight. ``effective_block_weights`` applies LET then LWC to a block as
a differentiable function of the trainables. LET sites: input_layernorm ->
{q, k, v}, post_attention_layernorm -> {up, gate}, v -> o, q <-> k;
down_proj is not transformed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.packing import PackedWeight
from ..quant.quantizer import QuantConfig, fake_quant_weight, init_lwc_params
from ..quant.transform import (
    smooth_fc_fc_gqa, smooth_ln_fcs, smooth_q_k, truncate_number)
from .common import (
    NO_ACT_QUANT, ActQuantSpec, attention_core, causal_mask, linear,
    repeat_kv, rms_norm)

LINEAR_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
)
# the linears whose input activation scales seed LET's qkv, fc1 and out
# (v -> o) smoothing scales, in that order
LET_SCALE_KEYS = ("q_proj", "up_proj", "o_proj")


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
                  kv_cache: Optional[tuple] = None,
                  tap: Optional[dict] = None, attn_impl=None):
    """One decoder block: pre-norm attention with RoPE and GQA, pre-norm
    SwiGLU MLP. Returns (y, (k, v)) with k/v including ``kv_cache``.
    ``tap``, when a dict, receives each linear's input activation under the
    linear's name (the activation statistics read them). ``attn_impl``,
    when given, replaces the attention core: attn_impl(q, k, v, spec) ->
    (b, heads, s, hd), with k/v repeated to the query heads; sequence-
    parallel calibration runs ring attention through it, and ``positions``
    are then the global positions of this shard's rows."""
    b, s, _ = x.shape
    hd, n_heads, n_kv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    residual = x
    hidden = rms_norm(x, p["input_layernorm"], cfg.rms_norm_eps)
    if tap is not None:
        tap["q_proj"] = tap["k_proj"] = tap["v_proj"] = hidden

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
    if attn_impl is not None:
        attn = attn_impl(q, k_r, v_r, spec)
    else:
        if mask is None:
            mask = causal_mask(s, k_r.shape[2], dtype=x.dtype,
                               device=x.device)
        attn = attention_core(q, k_r, v_r, mask, 1.0 / (hd ** 0.5), spec)
    attn = attn.transpose(1, 2).reshape(b, s, n_heads * hd)
    if tap is not None:
        tap["o_proj"] = attn
    x = residual + linear(attn, p["o_proj"], spec.act)

    residual = x
    hidden = rms_norm(x, p["post_attention_layernorm"], cfg.rms_norm_eps)
    if tap is not None:
        tap["gate_proj"] = tap["up_proj"] = hidden
    gate = linear(hidden, p["gate_proj"], spec.act)
    up = linear(hidden, p["up_proj"], spec.act)
    mlp_in = torch.nn.functional.silu(gate) * up
    if tap is not None:
        tap["down_proj"] = mlp_in
    return residual + linear(mlp_in, p["down_proj"], spec.act), new_cache


def init_let_params(p: dict, cfg: LlamaConfig, act_scales: Optional[dict],
                    alpha: float = 0.5, dtype=torch.float32) -> dict:
    """LET scales and shifts of one block, on the block's device.

    A smoothing scale is act_scale^alpha / colmax(W)^(1 - alpha), at least
    1e-5, where colmax is the PLAIN per-column max of the weight clamped at
    1e-5 (not the absolute max); ``act_scales`` is read at LET_SCALE_KEYS,
    and without it the activation side is ones. Shifts start at zero, the q/k scale at ones, and under GQA the
    v -> o scale at ones too."""
    def scale_for(name, fallback_dim):
        w = p[name]["weight"]
        wmax = w.amax(dim=0).clamp(min=1e-5)
        if act_scales is not None and name in act_scales:
            a = torch.as_tensor(act_scales[name], dtype=dtype,
                                device=w.device).clamp(min=1e-5)
        else:
            a = torch.ones(fallback_dim, dtype=dtype, device=w.device)
        return (a ** alpha / wmax ** (1 - alpha)).clamp(min=1e-5).to(dtype)

    qkv, fc1, out = LET_SCALE_KEYS
    dev = p[qkv]["weight"].device
    h = cfg.hidden_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    return {
        "qkv_smooth_scale": scale_for(qkv, h),
        "qkv_smooth_shift": zeros(h),
        "fc1_smooth_scale": scale_for(fc1, h),
        "fc1_smooth_shift": zeros(h),
        "out_smooth_scale": (
            scale_for(out, kv_dim)[:kv_dim] if cfg.n_rep == 1
            else torch.ones(kv_dim, dtype=dtype, device=dev)),
        "out_smooth_shift": zeros(kv_dim),
        "qkt_smooth_scale": torch.ones(kv_dim, dtype=dtype, device=dev),
    }


def init_lwc_params_block(p: dict, wcfg: QuantConfig,
                          dtype=torch.float32) -> dict:
    """LWC factors (init 4.0) for each linear of a block, on its device."""
    return {name: init_lwc_params(wcfg, p[name]["weight"].shape, dtype,
                                  p[name]["weight"].device)
            for name in LINEAR_NAMES}


def effective_block_weights(p: dict, wcfg: Optional[QuantConfig],
                            lwc_params: Optional[dict] = None,
                            let_params: Optional[dict] = None,
                            cfg: Optional[LlamaConfig] = None,
                            quantize: bool = True) -> dict:
    """The block's weights after LET smoothing, then LWC fake quantization;
    differentiable w.r.t. ``let_params`` and ``lwc_params``. With
    ``quantize=False`` only the smoothing is applied (the fold)."""
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in p.items()}
    if let_params is not None:
        t = {k: (truncate_number(v) if "smooth_scale" in k else v)
             for k, v in let_params.items()}
        ln, fcs = smooth_ln_fcs(
            p["input_layernorm"], [p["q_proj"], p["k_proj"], p["v_proj"]],
            t["qkv_smooth_scale"], t["qkv_smooth_shift"])
        p["input_layernorm"], (p["q_proj"], p["k_proj"], p["v_proj"]) = ln, fcs
        ln, fcs = smooth_ln_fcs(
            p["post_attention_layernorm"], [p["up_proj"], p["gate_proj"]],
            t["fc1_smooth_scale"], t["fc1_smooth_shift"])
        p["post_attention_layernorm"], (p["up_proj"], p["gate_proj"]) = (
            ln, fcs)
        p["v_proj"], p["o_proj"] = smooth_fc_fc_gqa(
            p["v_proj"], p["o_proj"], t["out_smooth_scale"],
            t["out_smooth_shift"], head_dim=cfg.head_dim, n_rep=cfg.n_rep)
        p["q_proj"], p["k_proj"] = smooth_q_k(
            p["q_proj"], p["k_proj"], t["qkt_smooth_scale"],
            head_dim=cfg.head_dim, n_rep=cfg.n_rep)
    if quantize and wcfg is not None and wcfg.enabled:
        for name in LINEAR_NAMES:
            lwc = lwc_params.get(name) if lwc_params else None
            p[name] = dict(p[name])
            p[name]["weight"] = fake_quant_weight(p[name]["weight"], wcfg, lwc)
    return p


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


def from_hf_state_dict(sd: dict, cfg: LlamaConfig, dtype=torch.float32,
                       device="cuda") -> dict:
    """An HF LlamaForCausalLM state dict (tensors or numpy arrays) in this
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

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        layers.append({
            "input_layernorm": {"weight": arr(pre + "input_layernorm.weight")},
            "post_attention_layernorm": {
                "weight": arr(pre + "post_attention_layernorm.weight")},
            **{n: lin(pre + "self_attn." + n) for n in LINEAR_NAMES[:4]},
            **{n: lin(pre + "mlp." + n) for n in LINEAR_NAMES[4:]}})
    return {
        "embed_tokens": arr("model.embed_tokens.weight"),
        "layers": layers,
        "norm": {"weight": arr("model.norm.weight")},
        "lm_head": arr("lm_head.weight") if "lm_head.weight" in sd else None,
    }
