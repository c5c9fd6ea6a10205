"""OPT: the forward and the calibration transforms.

Counterpart of ``omniquant_tpu/models/opt.py``. Parameters are plain dicts
of tensors in the JAX package's layout: per block ``self_attn_layer_norm``
/ ``final_layer_norm`` {'weight', 'bias'} and ``q_proj`` ... ``fc2``
{'weight' (out, in), 'bias'} or PackedWeight; the model has learned
positions (offset by 2), optional ``project_in`` / ``project_out`` and a
final LayerNorm.

Where OPT differs from LLaMA in the quantized forward: q is scaled by
head_dim**-0.5 and then quantized, and q, k and v are fake-quantized per
token over the full hidden dim, before the head reshape; the attention core
then gets a spec with only the softmax quantizer and scale 1.0. LET sites:
self_attn_layer_norm -> {q, k, v}, final_layer_norm -> {fc1}, v -> out_proj,
q <-> k; fc2 is not transformed. LET starts from the activation shifts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.packing import PackedWeight
from ..quant.quantizer import QuantConfig, fake_quant_weight, init_lwc_params
from ..quant.transform import (
    smooth_fc_fc, smooth_ln_fcs, smooth_q_k, truncate_number)
from .common import (
    NO_ACT_QUANT, ActQuantSpec, attention_core, causal_mask, layer_norm,
    linear, maybe_quant)

LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
# the linears whose input activation scales seed LET's qkv, fc1 and out
# (v -> out_proj) smoothing scales, in that order
LET_SCALE_KEYS = ("q_proj", "fc1", "out_proj")


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None  # != hidden_size => project_in/out
    do_layer_norm_before: bool = True
    enable_bias: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf_config) -> "OPTConfig":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            ffn_dim=hf_config.ffn_dim,
            num_hidden_layers=hf_config.num_hidden_layers,
            num_attention_heads=hf_config.num_attention_heads,
            max_position_embeddings=hf_config.max_position_embeddings,
            word_embed_proj_dim=(
                hf_config.word_embed_proj_dim
                if hf_config.word_embed_proj_dim != hf_config.hidden_size
                else None),
            do_layer_norm_before=hf_config.do_layer_norm_before,
            enable_bias=getattr(hf_config, "enable_bias", True))


def block_forward(p: dict, x: torch.Tensor, cfg: OPTConfig,
                  mask: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  spec: ActQuantSpec = NO_ACT_QUANT,
                  kv_cache: Optional[tuple] = None,
                  tap: Optional[dict] = None):
    """One decoder block: LayerNorm before (or, with
    ``do_layer_norm_before=False``, after) the attention and the ReLU MLP.
    Returns (y, (k, v)) with k/v including ``kv_cache``. ``positions`` is
    unused (positions live in ``embed``); ``tap``, when a dict, receives
    each linear's input activation under the linear's name."""
    del positions
    b, s, h = x.shape
    n_heads, hd = cfg.num_attention_heads, cfg.head_dim

    residual = x
    hidden = x
    if cfg.do_layer_norm_before:
        hidden = layer_norm(hidden, p["self_attn_layer_norm"],
                            cfg.layer_norm_eps)
    if tap is not None:
        tap["q_proj"] = tap["k_proj"] = tap["v_proj"] = hidden

    q = maybe_quant(linear(hidden, p["q_proj"], spec.act) * (hd ** -0.5),
                    spec.q)
    k = maybe_quant(linear(hidden, p["k_proj"], spec.act), spec.k)
    v = maybe_quant(linear(hidden, p["v_proj"], spec.act), spec.v)

    def heads(y):
        return y.reshape(b, s, n_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    new_cache = (k, v)

    if mask is None:
        mask = causal_mask(s, k.shape[2], dtype=x.dtype, device=x.device)
    # q/k/v are quantized already: only the softmax quantizer is left
    attn = attention_core(q, k, v, mask, 1.0, ActQuantSpec(p=spec.p))
    attn = attn.transpose(1, 2).reshape(b, s, h)
    if tap is not None:
        tap["out_proj"] = attn
    x = residual + linear(attn, p["out_proj"], spec.act)
    if not cfg.do_layer_norm_before:
        x = layer_norm(x, p["self_attn_layer_norm"], cfg.layer_norm_eps)

    residual = x
    hidden = x
    if cfg.do_layer_norm_before:
        hidden = layer_norm(hidden, p["final_layer_norm"], cfg.layer_norm_eps)
    if tap is not None:
        tap["fc1"] = hidden
    hidden = torch.relu(linear(hidden, p["fc1"], spec.act))
    if tap is not None:
        tap["fc2"] = hidden
    x = residual + linear(hidden, p["fc2"], spec.act)
    if not cfg.do_layer_norm_before:
        x = layer_norm(x, p["final_layer_norm"], cfg.layer_norm_eps)
    return x, new_cache


def init_let_params(p: dict, cfg: OPTConfig, act_scales: Optional[dict],
                    act_shifts: Optional[dict], alpha: float = 0.5,
                    dtype=torch.float32) -> dict:
    """LET scales and shifts of one block, on the block's device.

    A smoothing scale is act_scale^alpha / colmax(W)^(1 - alpha), at least
    1e-5, where colmax is the PLAIN per-column max of the weight clamped at
    1e-5 (not the absolute max); without ``act_scales`` the activation side
    is ones. The shifts start at ``act_shifts`` (the EMA mid-range of each
    linear's input), or at zero without them; the q/k scale at ones."""
    dev = p[LET_SCALE_KEYS[0]]["weight"].device
    h = cfg.hidden_size

    def scale_for(name):
        wmax = p[name]["weight"].amax(dim=0).clamp(min=1e-5)
        if act_scales is not None and name in act_scales:
            a = torch.as_tensor(act_scales[name], dtype=dtype,
                                device=dev).clamp(min=1e-5)
        else:
            a = torch.ones(h, dtype=dtype, device=dev)
        return (a ** alpha / wmax ** (1 - alpha)).clamp(min=1e-5).to(dtype)

    def shift_for(name):
        if act_shifts is not None and name in act_shifts:
            return torch.as_tensor(act_shifts[name], dtype=dtype,
                                   device=dev).clone()
        return torch.zeros(h, dtype=dtype, device=dev)

    qkv, fc1, out = LET_SCALE_KEYS
    return {
        "qkv_smooth_scale": scale_for(qkv),
        "qkv_smooth_shift": shift_for(qkv),
        "fc1_smooth_scale": scale_for(fc1),
        "fc1_smooth_shift": shift_for(fc1),
        "out_smooth_scale": scale_for(out),
        "out_smooth_shift": shift_for(out),
        "qkt_smooth_scale": torch.ones(h, dtype=dtype, device=dev),
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
                            cfg: Optional[OPTConfig] = None,
                            quantize: bool = True) -> dict:
    """The block's weights after LET smoothing, then LWC fake quantization;
    differentiable w.r.t. ``let_params`` and ``lwc_params``. With
    ``quantize=False`` only the smoothing is applied (the fold)."""
    p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in p.items()}
    if let_params is not None:
        t = {k: (truncate_number(v) if "smooth_scale" in k else v)
             for k, v in let_params.items()}
        ln, fcs = smooth_ln_fcs(
            p["self_attn_layer_norm"], [p["q_proj"], p["k_proj"], p["v_proj"]],
            t["qkv_smooth_scale"], t["qkv_smooth_shift"])
        p["self_attn_layer_norm"], (p["q_proj"], p["k_proj"], p["v_proj"]) = (
            ln, fcs)
        ln, fcs = smooth_ln_fcs(p["final_layer_norm"], [p["fc1"]],
                                t["fc1_smooth_scale"], t["fc1_smooth_shift"])
        p["final_layer_norm"], (p["fc1"],) = ln, fcs
        p["v_proj"], p["out_proj"] = smooth_fc_fc(
            p["v_proj"], p["out_proj"], t["out_smooth_scale"],
            t["out_smooth_shift"])
        p["q_proj"], p["k_proj"] = smooth_q_k(p["q_proj"], p["k_proj"],
                                              t["qkt_smooth_scale"])
    if quantize and wcfg is not None and wcfg.enabled:
        for name in LINEAR_NAMES:
            lwc = lwc_params.get(name) if lwc_params else None
            p[name] = dict(p[name])
            p[name]["weight"] = fake_quant_weight(p[name]["weight"], wcfg, lwc)
    return p


def embed(params: dict, tokens: torch.Tensor, cfg: OPTConfig,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (through ``project_in`` where there is one) plus the
    learned positions, offset by 2; ``positions`` defaults to 0..s-1 and
    may be a device tensor broadcastable to ``tokens`` (no host sync)."""
    x = params["embed_tokens"][tokens]
    if params.get("project_in") is not None:
        x = linear(x, params["project_in"])
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    return x + params["embed_positions"][positions + 2]


def head(params: dict, hidden: torch.Tensor, cfg: OPTConfig) -> torch.Tensor:
    """Final LayerNorm (pre-LN models), ``project_out``, then the tied,
    dense or packed lm_head."""
    if params.get("final_layer_norm") is not None and cfg.do_layer_norm_before:
        hidden = layer_norm(hidden, params["final_layer_norm"],
                            cfg.layer_norm_eps)
    if params.get("project_out") is not None:
        hidden = linear(hidden, params["project_out"])
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["embed_tokens"]
    if isinstance(lm_head, PackedWeight):
        from ..kernels.quant_matmul import quant_matmul

        return quant_matmul(hidden, lm_head)
    return hidden @ lm_head.t()


def forward(params: dict, tokens: torch.Tensor, cfg: OPTConfig,
            spec: ActQuantSpec = NO_ACT_QUANT) -> torch.Tensor:
    """Full causal-LM forward -> logits (b, s, vocab)."""
    x = embed(params, tokens, cfg)
    s = tokens.shape[1]
    mask = causal_mask(s, s, dtype=x.dtype, device=x.device)
    for layer in params["layers"]:
        x, _ = block_forward(layer, x, cfg, mask, spec=spec)
    return head(params, x, cfg)


def init_params(generator: torch.Generator, cfg: OPTConfig,
                dtype=torch.float32, device="cuda") -> dict:
    """Random init (N(0, 0.02) weights and embeddings, zero biases, unit
    LayerNorms, tied lm_head) from ``generator``, which must live on
    ``device``."""
    from .. import resolve_device

    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=dtype) * 0.02

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def lin(out_f, in_f):
        return {"weight": normal(out_f, in_f), "bias": zeros(out_f)}

    def norm(n):
        return {"weight": torch.ones(n, dtype=dtype, device=device),
                "bias": zeros(n)}

    h, f = cfg.hidden_size, cfg.ffn_dim
    layers = [{
        "self_attn_layer_norm": norm(h), "final_layer_norm": norm(h),
        "q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h),
        "out_proj": lin(h, h), "fc1": lin(f, h), "fc2": lin(h, f),
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "embed_tokens": normal(cfg.vocab_size, h),
        "embed_positions": normal(cfg.max_position_embeddings + 2, h),
        "project_in": None,
        "project_out": None,
        "layers": layers,
        "final_layer_norm": norm(h),
        "lm_head": None,  # tied to embed_tokens
    }


def from_hf_state_dict(sd: dict, cfg: OPTConfig, dtype=torch.float32,
                       device="cuda") -> dict:
    """An HF OPTForCausalLM state dict (tensors or numpy arrays) in this
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

    d = "model.decoder."
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"{d}layers.{i}."
        layers.append({
            "self_attn_layer_norm": norm(pre + "self_attn_layer_norm"),
            "final_layer_norm": norm(pre + "final_layer_norm"),
            **{n: lin(pre + "self_attn." + n) for n in LINEAR_NAMES[:4]},
            "fc1": lin(pre + "fc1"), "fc2": lin(pre + "fc2")})
    return {
        "embed_tokens": arr(d + "embed_tokens.weight"),
        "embed_positions": arr(d + "embed_positions.weight"),
        "project_in": (lin(d + "project_in")
                       if d + "project_in.weight" in sd else None),
        "project_out": (lin(d + "project_out")
                        if d + "project_out.weight" in sd else None),
        "layers": layers,
        "final_layer_norm": (norm(d + "final_layer_norm")
                             if d + "final_layer_norm.weight" in sd else None),
        "lm_head": arr("lm_head.weight") if "lm_head.weight" in sd else None,
    }
