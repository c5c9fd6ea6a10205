"""AutoGPTQ-format checkpoint export: the port's counterpart of
``omniquant_tpu/serving/export_autogptq.py``, the same tensors bit for bit.

The reference packs calibrated weights into AutoGPTQ CUDA QuantLinear
modules (reference quantize/omniquant.py:255-277: per-linear
`qlinear_cuda.QuantLinear(wbits, group_size, in, out, bias).pack(module,
scales, zeros)`) and saves/loads those as its real-quant checkpoint format
(falcon notebook cells 6/15). This module turns the port's packed model
(``serving/export.py::pack_model``: torch tensors, on the card or the CPU)
into a state dict in AutoGPTQ's on-disk tensor layout. Everything here runs
on the host in numpy: each linear's tensors are read once, to the CPU
(``_host``: codes through ``quant/packing.py::unpack_codes``, scales,
zeros and bias as f32).

Wire format (AutoGPTQ qlinear_cuda v1 tensors, per linear):
  qweight: int32 (in_features*bits/32, out) — codes packed row-major along
           in_features at `bits` per value, values straddling a 32-bit
           word boundary split across adjacent words (only 3-bit
           straddles; 2/4/8 divide 32).
  qzeros:  int32 (n_groups, out*bits/32) — per-group integer zero points
           packed the same way along the OUT axis.
  scales:  f16 (n_groups, out)
  g_idx:   int32 (in_features,) — group index of each in-feature row
           (i // group_size; AutoGPTQ's act-order support, identity here).
  bias:    f16 (out,) when present.

Zero-point convention: upstream AutoGPTQ stores `zero - 1` and its kernels
add 1 back after unpack — which CORRUPTS asymmetric checkpoints whose zero
point is 0 (uint wraparound; the very bug the reference's pinned fork
`ChenMnZ/AutoGPTQ-bugfix` exists to fix, README.md:38-42). We therefore
default to the fork's convention (store the true zero point,
zeros_offset=0); pass zeros_offset=-1 only for kernels that expect the
upstream off-by-one wire format.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.packing import PackedWeight, unpack_codes


def _np32(t) -> np.ndarray:
    """A tensor (any device or float type) as f32 numpy on the host."""
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _host(pw: PackedWeight) -> tuple:
    """The PackedWeight adapter: (codes (in, out) uint32, scales and zeros
    (out, n_groups) f32, bias f32 or None) read from the port's tensors."""
    codes = unpack_codes(pw.qweight, pw.bits, pw.in_features, pw.group_size,
                         pw.tile_k, pw.layout)
    return (codes.cpu().numpy().astype(np.uint32), _np32(pw.scales),
            _np32(pw.zeros), None if pw.bias is None else _np32(pw.bias))


def _pack_bits(vals: np.ndarray, bits: int) -> np.ndarray:
    """Pack uint (n, m) along axis 0 into int32 words, row-major at `bits`
    per value, straddling values split across adjacent words (the
    AutoGPTQ layout — NOT our TPU planar/pairs layouts)."""
    n, m = vals.shape
    assert (n * bits) % 32 == 0, (n, bits)
    v = vals.astype(np.uint32) & np.uint32(2**bits - 1)
    out = np.zeros((n * bits // 32, m), np.uint32)
    for i in range(n):
        w, o = divmod(i * bits, 32)
        out[w] |= (v[i] << np.uint32(o)) & np.uint32(0xFFFFFFFF)
        if o + bits > 32:
            out[w + 1] |= v[i] >> np.uint32(32 - o)
    return out.view(np.int32)


def _unpack_bits(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of _pack_bits -> uint32 (n, m)."""
    w32 = words.view(np.uint32) if words.dtype != np.uint32 else words
    mask = np.uint32(2**bits - 1)
    m = w32.shape[1]
    out = np.zeros((n, m), np.uint32)
    for i in range(n):
        w, o = divmod(i * bits, 32)
        v = w32[w] >> np.uint32(o)
        if o + bits > 32:
            v = v | (w32[w + 1] << np.uint32(32 - o))
        out[i] = v & mask
    return out


def pack_autogptq_linear(pw: PackedWeight,
                         zeros_offset: int = 0) -> dict:
    """PackedWeight (the port's planar or pairs words) -> AutoGPTQ v1
    tensors (numpy)."""
    bits = pw.bits
    in_f, out_f = pw.in_features, pw.out_features
    assert (in_f * bits) % 32 == 0, (
        f"AutoGPTQ qweight needs in_features*bits divisible by 32 "
        f"(got {in_f} x {bits})")
    assert (out_f * bits) % 32 == 0, (
        f"AutoGPTQ qzeros needs out_features*bits divisible by 32 "
        f"(got {out_f} x {bits})")
    codes, scales, zeros, bias = _host(pw)
    qweight = _pack_bits(codes, bits)  # (in*bits/32, out)
    # zeros/scales: ours are (out, n_groups); AutoGPTQ wants (n_groups, out)
    zeros = zeros.T  # (G, out)
    scales = scales.T
    zint = (np.round(zeros).astype(np.int64) + zeros_offset) % (2**bits)
    qzeros = _pack_bits(zint.T.astype(np.uint32), bits).T  # (G, out*bits/32)
    gs = pw.group_size or in_f
    g_idx = (np.arange(in_f, dtype=np.int32) // gs).astype(np.int32)
    out = {
        "qweight": qweight,
        "qzeros": np.ascontiguousarray(qzeros),
        "scales": scales.astype(np.float16),
        "g_idx": g_idx,
    }
    if bias is not None:
        out["bias"] = bias.astype(np.float16)
    return out


def unpack_autogptq(tensors: dict, bits: int,
                    zeros_offset: int = 0) -> np.ndarray:
    """Reference oracle: AutoGPTQ tensors -> dequantized weight (in, out),
    evaluated exactly as the AutoGPTQ torch fallback / CUDA kernels do:
    w[i, j] = (codes[i, j] - zero[g_idx[i], j]) * scales[g_idx[i], j]."""
    qweight = tensors["qweight"]
    scales = tensors["scales"].astype(np.float32)
    g_idx = tensors["g_idx"]
    in_f = g_idx.shape[0]
    out_f = scales.shape[1]
    codes = _unpack_bits(qweight, bits, in_f).astype(np.float32)
    zint = _unpack_bits(
        np.ascontiguousarray(tensors["qzeros"].T), bits, out_f).T
    zeros = ((zint.astype(np.int64) - zeros_offset) % (2**bits)).astype(
        np.float32)  # (G, out)
    return (codes - zeros[g_idx]) * scales[g_idx]


# HF module-path templates per family: {our block key: HF submodule path}.
_LINEAR_NAMES = {
    "llama": {
        "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
        "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
        "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
        "down_proj": "mlp.down_proj",
    },
    "opt": {
        "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
        "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
        "fc1": "fc1", "fc2": "fc2",
    },
    "falcon": {
        "query_key_value": "self_attention.query_key_value",
        "dense": "self_attention.dense",
        "dense_h_to_4h": "mlp.dense_h_to_4h",
        "dense_4h_to_h": "mlp.dense_4h_to_h",
    },
}

_NORM_NAMES = {
    "llama": ("input_layernorm", "post_attention_layernorm"),
    "opt": ("self_attn_layer_norm", "final_layer_norm"),
    "falcon": ("input_layernorm", "post_attention_layernorm",
               "ln_attn", "ln_mlp"),
}

_LAYER_PREFIX = {
    "llama": "model.layers.{i}.",
    "opt": "model.decoder.layers.{i}.",
    "falcon": "transformer.h.{i}.",
}

_TOP_LEVEL = {
    "llama": {"embed_tokens": "model.embed_tokens.weight",
              "norm": "model.norm", "lm_head": "lm_head.weight"},
    "opt": {"embed_tokens": "model.decoder.embed_tokens.weight",
            "embed_positions": "model.decoder.embed_positions.weight",
            "final_layer_norm": "model.decoder.final_layer_norm",
            "lm_head": "lm_head.weight"},
    "falcon": {"embed_tokens": "transformer.word_embeddings.weight",
               "norm": "transformer.ln_f", "ln_f": "transformer.ln_f",
               "lm_head": "lm_head.weight"},
}


def export_autogptq_state_dict(family: str, packed_params: dict,
                               zeros_offset: int = 0) -> dict:
    """Packed model (serving/export.pack_model output) -> flat
    state dict of numpy tensors under HF module names with AutoGPTQ
    per-linear tensors — the layout the reference's deployment notebook
    loads (`load_checkpoint_in_model` over a skeleton whose linears were
    swapped for qlinear_cuda.QuantLinear, falcon nb cell 15)."""
    lin = _LINEAR_NAMES[family]
    norms = _NORM_NAMES[family]
    sd = {}
    for i, block in enumerate(packed_params["layers"]):
        prefix = _LAYER_PREFIX[family].format(i=i)
        for key, sub in block.items():
            if isinstance(sub, PackedWeight):
                if key not in lin:  # fused helper entries etc.
                    continue
                for tname, t in pack_autogptq_linear(
                        sub, zeros_offset).items():
                    sd[prefix + lin[key] + "." + tname] = t
            elif key in norms and isinstance(sub, dict):
                for p in ("weight", "bias"):
                    if sub.get(p) is not None:
                        sd[prefix + key + "." + p] = _np32(
                            sub[p]).astype(np.float16)
    top = _TOP_LEVEL[family]
    for key, path in top.items():
        v = packed_params.get(key)
        if v is None:
            continue
        if isinstance(v, dict):
            for p in ("weight", "bias"):
                if v.get(p) is not None:
                    sd[path + "." + p] = _np32(v[p]).astype(np.float16)
        else:
            sd[path] = _np32(v).astype(np.float16)
    return sd


def save_autogptq_checkpoint(family: str, packed_params: dict, path: str,
                             zeros_offset: int = 0) -> None:
    """Write the AutoGPTQ-format state dict as a torch .pt file (the
    reference loads real-quant checkpoints with torch/accelerate)."""
    sd = export_autogptq_state_dict(family, packed_params, zeros_offset)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
