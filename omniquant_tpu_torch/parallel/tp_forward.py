"""Tensor-parallel block forwards over packed or dense weights.

Counterpart of ``omniquant_tpu/parallel/tp_forward.py``. JAX runs the
whole block inside ``shard_map`` with explicit collectives; here each
shard of a ``parallel.mesh.Mesh`` runs the block in its own thread on its
local weights and meets the others at ``Mesh.all_reduce``:

  row-parallel (no comms):   llama q/k/v/gate/up, OPT q/k/v/fc1,
                             falcon query_key_value/dense_h_to_4h
  column-parallel (all-reduce): llama o/down, OPT out_proj/fc2,
                             falcon dense/dense_4h_to_h
  attention:                 head-parallel (each shard owns n_heads/tp heads)

Column-parallel biases are added ONCE after the all-reduce (adding one per
shard would multiply them by tp).

Shard alignment: row-parallel out dims split per shard on head
boundaries; column-parallel packed rows split on whole pack tiles and
quant groups (``_ensure_col_splittable`` repacks to a smaller tile where a
shard boundary would cut one). ``pad_intermediate_packed`` pads the MLP
intermediate dimension to a multiple of tp x lcm(tile, 128) with
contributions that are exactly zero: padded gate/up/fc1 output channels
carry scale-0 groups (dequant -> exact 0, so silu(0)*0 = 0, relu(0) = 0,
gelu(0) = 0 activations), and the padded down/fc2 input rows multiply those
zeros. This is how LLaMA-7B's intermediate 11008 runs at tp 2, 4 and 8.

Activation quantizers (an ``ActQuantSpec``, as the family forward takes)
stay exact under the split (``tp_act_quant``, which the TP engine shares):
a row-parallel input is whole on every shard, so its per-token quantizer
is local; a column-parallel input is split over its features, so its
per-token min and max are all-reduced over the shards before the
fake-quant, bit-identical to the unsplit quantizer on the gathered tensor;
OPT's q/k/v, quantized per token over the whole hidden before the head
split, likewise; LLaMA's q/k/v quantizers act per head, on the shard's
own heads. On packed weights the row-parallel sites take the integer
route of ``linear`` (K8 + K9, or K7 at small m) and the column-parallel
sites the fake-quantized input into K1, as in the TP engine; on dense
weights every site multiplies fake-quantized inputs.

``make_tp_forward`` is the tensor-parallel trunk (the CLI's ``--eval_ppl
--tp``); ``serving/tp_engine.py`` places an engine's params with the same
helpers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels.quant_matmul import quant_matmul
from ..models import falcon as tfalcon
from ..models import llama as tllama
from ..models.common import (
    NO_ACT_QUANT, ActQuantSpec, causal_mask, layer_norm, linear, maybe_quant,
    repeat_kv, rms_norm)
from ..quant.packing import (
    PackedWeight, pack_codes, rows_per_words, unpack_codes)
from ..quant.quantizer import _fake_quant_core, _scale_zp
from .sharding import COL_PARALLEL, ROW_PARALLEL, local_packed, split


def words_per_rows(bits: int, rows: int, layout: str = "planar") -> int:
    """int32 words storing ``rows`` codes at ``bits`` each (10 codes a word
    in the pairs 3-bit layout)."""
    if bits == 3 and layout == "pairs":
        if rows % 10:
            raise ValueError(f"{rows} rows do not fill pairs 3-bit words")
        return rows // 10
    if (rows * bits) % 32:
        raise ValueError(f"{rows} rows of {bits} bits do not fill words")
    return rows * bits // 32


# ---------------------------------------------------------------------------
# packed-weight padding (intermediate dim -> tp x tile multiples)
# ---------------------------------------------------------------------------

def _pad(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``t`` with n zeros appended along ``axis``."""
    pad = [0, 0] * (t.dim() - 1 - axis) + [0, n]
    return torch.nn.functional.pad(t, pad)


def _pad_packed_out(pw: PackedWeight, new_out: int) -> PackedWeight:
    """Pad a row-parallel PackedWeight's OUT dim (qweight lanes, scale/zero
    rows, bias) to ``new_out``. Padded channels get scale-0 groups, so their
    dequantized weights -- and their activations -- are exactly 0."""
    pad = new_out - pw.out_features
    if pad == 0:
        return pw
    if pad < 0:
        raise ValueError(f"cannot pad {pw.out_features} lanes to {new_out}")
    return dataclasses.replace(
        pw, qweight=_pad(pw.qweight, 1, pad), scales=_pad(pw.scales, 0, pad),
        zeros=_pad(pw.zeros, 0, pad),
        bias=None if pw.bias is None else _pad(pw.bias, 0, pad),
        out_features=new_out)


def _pad_packed_in(pw: PackedWeight, new_in: int) -> PackedWeight:
    """Pad a column-parallel PackedWeight's IN dim (packed word rows and
    scale groups) to ``new_in``, a multiple of tile_k. The padded rows hold
    zero words with scale-0 groups; their inputs are the exact zeros of the
    padded row-parallel partner, so they contribute exactly 0."""
    if new_in == pw.in_features:
        return pw
    if not (new_in > pw.in_features and new_in % pw.tile_k == 0):
        raise ValueError(f"cannot pad {pw.in_features} rows to {new_in} "
                         f"(tile {pw.tile_k})")
    new_words = words_per_rows(pw.bits, new_in, pw.layout)
    qweight = _pad(pw.qweight, 0, new_words - pw.qweight.shape[0])
    scales, zeros = pw.scales, pw.zeros
    if pw.group_size:
        g_pad = new_in // pw.group_size - scales.shape[1]
        if g_pad:
            scales, zeros = _pad(scales, 1, g_pad), _pad(zeros, 1, g_pad)
    return dataclasses.replace(pw, qweight=qweight, scales=scales,
                               zeros=zeros, in_features=new_in)


def _retile_packed(pw: PackedWeight, new_tile: int) -> PackedWeight:
    """Repack with another layout tile (tile_k is a layout parameter, not
    semantics): unpack the whole padded row range and pack it again. Used
    where a column-parallel shard boundary would not land on a tile's."""
    k_total = rows_per_words(pw.bits, pw.qweight.shape[0], pw.layout)
    codes = unpack_codes(pw.qweight, pw.bits, k_total, pw.group_size,
                         pw.tile_k, pw.layout)  # layout pad rows included
    if k_total % new_tile:
        raise ValueError(f"{k_total} rows do not split into tiles of "
                         f"{new_tile}")
    qweight = pack_codes(codes.t(), pw.bits, pw.group_size, new_tile,
                         pw.layout)
    return dataclasses.replace(pw, qweight=qweight, tile_k=new_tile)


def _min_tile(bits: int, group_size: Optional[int],
              layout: str = "planar") -> int:
    """The smallest pack tile a column-parallel shard may hold (JAX's
    ``_min_tile``)."""
    if bits == 3 and layout == "pairs":
        base = 80  # 10 codes a word x 8 words (quant/packing.pack_tile)
    elif bits == 3:
        base = 256
    else:
        base = 8 * (32 // bits)
    if group_size:
        base = base * group_size // math.gcd(base, group_size)
    return base


def _ensure_col_splittable(pw: PackedWeight, tp: int) -> PackedWeight:
    """Make a column-parallel PackedWeight's packed rows split into tp
    shards of whole tiles, repacking to a smaller tile where needed."""
    k_total = rows_per_words(pw.bits, pw.qweight.shape[0], pw.layout)
    if k_total % tp == 0 and (k_total // tp) % pw.tile_k == 0:
        return pw
    base = _min_tile(pw.bits, pw.group_size, pw.layout)
    k_local = k_total // tp
    if k_total % tp or k_local % base:
        raise ValueError(
            f"in_features {k_total} cannot split into {tp} shards of whole "
            f"{base}-row pack tiles (bits={pw.bits}, group={pw.group_size})")
    # the largest multiple of base dividing the local row count, at most
    # the original tile, so the K step never grows
    tile = base
    while tile * 2 <= pw.tile_k and k_local % (tile * 2) == 0:
        tile *= 2
    return _retile_packed(pw, tile)


def _pad_dense_out(w: dict, new_out: int) -> dict:
    pad = new_out - w["weight"].shape[0]
    if pad == 0:
        return w
    return {"weight": _pad(w["weight"], 0, pad),
            "bias": None if w.get("bias") is None else _pad(w["bias"], 0, pad)}


def _pad_dense_in(w: dict, new_in: int) -> dict:
    pad = new_in - w["weight"].shape[1]
    if pad == 0:
        return w
    return {"weight": _pad(w["weight"], 1, pad), "bias": w.get("bias")}


_MLP_NAMES = {
    "llama": (("gate_proj", "up_proj"), "down_proj"),
    "opt": (("fc1",), "fc2"),
    "falcon": (("dense_h_to_4h",), "dense_4h_to_h"),
}


def pad_intermediate_packed(block: dict, cfg, tp: int,
                            family: str = "llama") -> dict:
    """Pad the MLP so that the intermediate dim splits on tp x pack-tile
    boundaries with exactly zero pad contributions (module docstring).
    Takes PackedWeight and dense linears alike; returns a new block."""
    row_names, col_name = _MLP_NAMES[family]
    col = block[col_name]
    if isinstance(col, PackedWeight):
        tile = col.tile_k
        inter = block[row_names[0]].out_features
        # a shard's rows must be whole pack tiles, its lanes a multiple of
        # 128 (the kernel's column block)
        unit = tp * (tile * 128 // math.gcd(tile, 128))
    else:
        inter = block[row_names[0]]["weight"].shape[0]
        unit = tp  # dense shards only need an even split
    inter_pad = -(-inter // unit) * unit
    if inter_pad == inter and (
            not isinstance(col, PackedWeight)
            or rows_per_words(col.bits, col.qweight.shape[0],
                              col.layout) == inter_pad):
        return block
    out = dict(block)
    for name in row_names:
        w = out[name]
        out[name] = (_pad_packed_out(w, inter_pad)
                     if isinstance(w, PackedWeight)
                     else _pad_dense_out(w, inter_pad))
    out[col_name] = (_pad_packed_in(col, inter_pad)
                     if isinstance(col, PackedWeight)
                     else _pad_dense_in(col, inter_pad))
    return out


def restructure_falcon_mqa(block: dict, cfg, tp: int) -> dict:
    """Rewrite Falcon's multi-query fused qkv [q0..q{nh-1}, k, v] into
    per-shard blocks [q-slice_i, k, v], so a plain row split hands every
    shard its own replica of the shared k/v head. A host-side relayout of
    output channels (lanes for a PackedWeight), done once at placement; a
    shard then computes standard MQA with nh/tp heads."""
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    if nh % tp:
        raise ValueError(
            f"falcon MQA TP needs num_heads % tp == 0 (got {nh} % {tp}); "
            "pad heads or choose a tp that divides the head count")
    nh_l = nh // tp
    qkv = block["query_key_value"]

    def relayout(take):
        parts = []
        for i in range(tp):
            parts.append(take(i * nh_l * hd, nh_l * hd))  # q slice
            parts.append(take(nh * hd, 2 * hd))            # shared k, v
        return parts

    out = dict(block)
    if isinstance(qkv, PackedWeight):
        bias = None
        if qkv.bias is not None:
            bias = torch.cat(relayout(lambda s, n: qkv.bias[s: s + n]))
        out["query_key_value"] = dataclasses.replace(
            qkv,
            qweight=torch.cat(relayout(lambda s, n: qkv.qweight[:, s: s + n]),
                              dim=1),
            scales=torch.cat(relayout(lambda s, n: qkv.scales[s: s + n])),
            zeros=torch.cat(relayout(lambda s, n: qkv.zeros[s: s + n])),
            bias=bias, out_features=tp * (nh_l + 2) * hd)
    else:
        w = qkv["weight"]
        bias = None
        if qkv.get("bias") is not None:
            bias = torch.cat(relayout(lambda s, n: qkv["bias"][s: s + n]))
        out["query_key_value"] = {
            "weight": torch.cat(relayout(lambda s, n: w[s: s + n])),
            "bias": bias}
    return out


# ---------------------------------------------------------------------------
# sharded placement
# ---------------------------------------------------------------------------

def local_spec(w, row: bool) -> dict:
    """The split of one linear's tensors on a tensor-parallel mesh (JAX's
    ``_pw_sharded_row`` / ``_pw_sharded_col`` and the dense placements):
    column-parallel per-channel scales stay whole."""
    if isinstance(w, PackedWeight):
        if row:
            return {"qweight": 1, "scales": 0, "zeros": 0, "bias": 0}
        sc = 1 if w.group_size else None
        return {"qweight": 0, "scales": sc, "zeros": sc, "bias": None}
    return {"weight": 0 if row else 1, "bias": 0 if row else None}


def place_linear(w, row: bool, mesh) -> list:
    """One linear's shards, one per shard of ``mesh``, on its device: split
    over a row's tp shards (shard p takes part p % tp), the same on every
    dp row. A column-parallel PackedWeight must hold exactly its
    in_features in packed rows: tile pad rows at its end would shift every
    shard's rows against its part of the input."""
    spec = local_spec(w, row)
    n = mesh.tp
    if isinstance(w, PackedWeight):
        if not row and n > 1 and w.k_pad != w.in_features:
            raise ValueError(
                f"a column-parallel PackedWeight of {w.in_features} rows in "
                f"{w.k_pad} packed rows does not split over {n} shards")
        return mesh.each(lambda p, d: local_packed(w, spec, n, p % n, d))
    return mesh.each(lambda p, d: {
        "weight": split(w["weight"], spec["weight"], n, p % n, d),
        "bias": None if w.get("bias") is None else
        split(w["bias"], spec["bias"], n, p % n, d)})


def replicate(tree, mesh) -> list:
    """``tree`` whole on every local shard's device (a device's copy is made
    once and shared by the shards on it); None at other ranks' shards."""
    copies = {}

    def put(x, d):
        if isinstance(x, PackedWeight):
            return x.map_tensors(lambda t: put(t, d))
        if isinstance(x, torch.Tensor):
            return x.to(d)
        if isinstance(x, dict):
            return {k: put(v, d) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [put(v, d) for v in x]
        return x

    def copy(p, d):
        if d not in copies:
            copies[d] = put(tree, d)
        return copies[d]

    return mesh.each(copy)


def place_block(block: dict, mesh, rows, cols) -> list:
    """A block's params on the mesh, one dict per local shard (None at
    other ranks' shards): row- and column-parallel linears split,
    everything else whole."""
    shards = mesh.each(lambda p, d: {})
    for name, w in block.items():
        if name in rows or name in cols:
            parts = place_linear(w, name in rows, mesh)
        else:
            parts = replicate(w, mesh)
        for s, part in zip(shards, parts):
            if s is not None:
                s[name] = part
    return shards


def _make_shard_block(mesh, family: str, cfg, tp: int):
    rows, cols = ROW_PARALLEL[family], COL_PARALLEL[family]

    def shard_block(block: dict) -> list:
        """Pad and place one calibrated block's weights for TP: one block
        per shard."""
        block = pad_intermediate_packed(block, cfg, tp, family)
        if (family == "falcon" and cfg.multi_query
                and not cfg.new_decoder_architecture and tp > 1):
            block = restructure_falcon_mqa(block, cfg, tp)
        block = {name: (_ensure_col_splittable(w, tp)
                        if name in cols and isinstance(w, PackedWeight)
                        else w) for name, w in block.items()}
        return place_block(block, mesh, rows, cols)

    return shard_block


# ---------------------------------------------------------------------------
# shard-local compute
# ---------------------------------------------------------------------------

def _fix_local_pw(w: PackedWeight) -> PackedWeight:
    """A shard's PackedWeight with its logical dims taken from its own
    tensors (row-parallel shrank out; column-parallel shrank in)."""
    local_rows = rows_per_words(w.bits, w.qweight.shape[0], w.layout)
    return dataclasses.replace(
        w, out_features=w.qweight.shape[1],
        in_features=min(w.in_features, local_rows))


def tp_act_quant(mesh, p: int, x, qcfg):
    """Per-token fake-quant of shard p's part of a tensor split over its
    features: the min and max of each token span every shard's features
    (an all-reduce), so the result is bit-identical to the unsplit
    quantizer's on the gathered tensor. Elementwise quantizers stay
    local; grouped ones are refused (their groups would straddle
    shards)."""
    if qcfg is None or not qcfg.enabled:
        return x
    if qcfg.metric == "fix0to1":
        return maybe_quant(x, qcfg)  # elementwise: shard-local is exact
    if qcfg.group_size:
        raise NotImplementedError(
            "grouped activation quantization over a tp-split feature "
            "axis (its groups would straddle shards)")
    xmin = mesh.all_reduce(p, x.amin(dim=-1, keepdim=True), "min")
    xmax = mesh.all_reduce(p, x.amax(dim=-1, keepdim=True), "max")
    return _fake_quant_core(x, *_scale_zp(xmin, xmax, qcfg), qcfg)


def _row_linear(x, w, act=None):
    """Row-parallel local matmul (its bias shard added locally) on the
    whole input, quantized per token by ``act`` (the integer route on
    packed weights)."""
    if isinstance(w, PackedWeight):
        w = _fix_local_pw(w)
    return linear(x, w, act)


def _slice_packed_out(pw: PackedWeight, n0: int, n1: int) -> PackedWeight:
    """Columns [n0, n1) of a PackedWeight (qweight lanes, scale/zero rows,
    bias): packing runs along in, so any column range is whole words."""
    return dataclasses.replace(
        pw, qweight=pw.qweight[:, n0:n1].contiguous(),
        scales=pw.scales[n0:n1], zeros=pw.zeros[n0:n1],
        bias=None if pw.bias is None else pw.bias[n0:n1],
        out_features=n1 - n0)


def effective_overlap_chunks(n: int, chunks: int) -> int:
    """The largest c <= chunks such that every chunk keeps the kernel's
    128-column blocks (n % (c * 128) == 0); 1 when n is too small."""
    c = max(1, chunks)
    while c > 1 and n % (c * 128) != 0:
        c -= 1
    return c


def _col_linear_q(x, w, mesh, p: int, overlap_chunks: int, act):
    """A column-parallel site: the exact input quantizer (``tp_act_quant``),
    then ``_col_linear_psum``."""
    return _col_linear_psum(tp_act_quant(mesh, p, x, act), w, mesh, p,
                            overlap_chunks)


def _col_linear_psum(x, w, mesh, p: int, overlap_chunks: int = 1):
    """Column-parallel linear of shard p: the local partial product, the
    all-reduce, then the (replicated) bias exactly once.

    overlap_chunks > 1 splits the OUT dim into that many (matmul ->
    all-reduce) pairs, chunk k's all-reduce depending only on its own
    product (JAX's latency-hiding overlap of collective k with matmul
    k + 1). The sum of each output column is the same either way, so the
    result equals the unchunked one exactly."""
    if isinstance(w, PackedWeight):
        wl = dataclasses.replace(_fix_local_pw(w), bias=None)
        n = wl.out_features
        c = effective_overlap_chunks(n, overlap_chunks)
        if c > 1:
            step = n // c
            y = torch.cat([
                mesh.all_reduce(p, quant_matmul(
                    x, _slice_packed_out(wl, i * step, (i + 1) * step)))
                for i in range(c)], dim=-1)
        else:
            y = mesh.all_reduce(p, quant_matmul(x, wl))
        if w.bias is not None:
            y = y + w.bias.to(y.dtype)
        return y
    n = w["weight"].shape[0]
    c = effective_overlap_chunks(n, overlap_chunks)
    if c > 1:
        step = n // c
        y = torch.cat([
            mesh.all_reduce(p, x @ w["weight"][i * step:(i + 1) * step].t())
            for i in range(c)], dim=-1)
    else:
        y = mesh.all_reduce(p, x @ w["weight"].t())
    if w.get("bias") is not None:
        y = y + w["bias"]
    return y


def _attend(q, k, v, mask, scale, dtype, spec: ActQuantSpec = NO_ACT_QUANT):
    """Dense attention with an f32 softmax (JAX's block functions); the
    spec's q/k quantizers on the scores' inputs, its p/v quantizers on the
    probabilities and values (per head: a shard's own)."""
    q, k = maybe_quant(q, spec.q), maybe_quant(k, spec.k)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    probs = torch.softmax((scores + mask).float(), dim=-1).to(dtype)
    return torch.matmul(maybe_quant(probs, spec.p), maybe_quant(v, spec.v))


def _llama_block_fn(cfg, tp, mesh, overlap_chunks: int = 1,
                    spec: ActQuantSpec = NO_ACT_QUANT):
    hd = cfg.head_dim
    act = spec.act
    if cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp:
        raise ValueError("heads and kv heads must divide into tp shards")
    n_heads_l = cfg.num_attention_heads // tp
    n_kv_l = cfg.num_key_value_heads // tp

    def block_fn(p_idx, p, x, mask, positions):
        b, s, _ = x.shape
        residual = x
        hidden = rms_norm(x, p["input_layernorm"], cfg.rms_norm_eps)
        q = _row_linear(hidden, p["q_proj"], act).reshape(
            b, s, n_heads_l, hd).transpose(1, 2)
        k = _row_linear(hidden, p["k_proj"], act).reshape(
            b, s, n_kv_l, hd).transpose(1, 2)
        v = _row_linear(hidden, p["v_proj"], act).reshape(
            b, s, n_kv_l, hd).transpose(1, 2)
        cos, sin = tllama.rope_cos_sin(positions, hd, cfg.rope_theta,
                                       dtype=x.dtype)
        q, k = tllama.apply_rope(q, k, cos, sin)
        k = repeat_kv(k, n_heads_l // n_kv_l)
        v = repeat_kv(v, n_heads_l // n_kv_l)
        attn = _attend(q, k, v, mask, hd ** -0.5, x.dtype, spec)
        attn = attn.transpose(1, 2).reshape(b, s, n_heads_l * hd)
        x = residual + _col_linear_q(attn, p["o_proj"], mesh, p_idx,
                                     overlap_chunks, act)
        residual = x
        hidden = rms_norm(x, p["post_attention_layernorm"], cfg.rms_norm_eps)
        gate = _row_linear(hidden, p["gate_proj"], act)
        up = _row_linear(hidden, p["up_proj"], act)
        mlp = _col_linear_q(torch.nn.functional.silu(gate) * up,
                            p["down_proj"], mesh, p_idx, overlap_chunks, act)
        return residual + mlp

    return block_fn


def _opt_block_fn(cfg, tp, mesh, overlap_chunks: int = 1,
                  spec: ActQuantSpec = NO_ACT_QUANT):
    hd = cfg.head_dim
    act = spec.act
    if cfg.num_attention_heads % tp:
        raise ValueError("heads must divide into tp shards")
    n_heads_l = cfg.num_attention_heads // tp

    def block_fn(p_idx, p, x, mask, positions):
        b, s, _ = x.shape
        residual = x
        hidden = x
        if cfg.do_layer_norm_before:
            hidden = layer_norm(hidden, p["self_attn_layer_norm"],
                                cfg.layer_norm_eps)
        # q/k/v are quantized per token over the whole hidden, before the
        # head split: their ranges span the shards
        q = tp_act_quant(mesh, p_idx, _row_linear(hidden, p["q_proj"], act)
                         * (hd ** -0.5), spec.q)
        k = tp_act_quant(mesh, p_idx, _row_linear(hidden, p["k_proj"], act),
                         spec.k)
        v = tp_act_quant(mesh, p_idx, _row_linear(hidden, p["v_proj"], act),
                         spec.v)
        q, k, v = (t.reshape(b, s, n_heads_l, hd).transpose(1, 2)
                   for t in (q, k, v))
        attn = _attend(q, k, v, mask, 1.0, x.dtype, ActQuantSpec(p=spec.p))
        attn = attn.transpose(1, 2).reshape(b, s, n_heads_l * hd)
        x = residual + _col_linear_q(attn, p["out_proj"], mesh, p_idx,
                                     overlap_chunks, act)
        if not cfg.do_layer_norm_before:
            x = layer_norm(x, p["self_attn_layer_norm"], cfg.layer_norm_eps)
        residual = x
        hidden = x
        if cfg.do_layer_norm_before:
            hidden = layer_norm(hidden, p["final_layer_norm"],
                                cfg.layer_norm_eps)
        hidden = torch.relu(_row_linear(hidden, p["fc1"], act))
        x = residual + _col_linear_q(hidden, p["fc2"], mesh, p_idx,
                                     overlap_chunks, act)
        if not cfg.do_layer_norm_before:
            x = layer_norm(x, p["final_layer_norm"], cfg.layer_norm_eps)
        return x

    return block_fn


def local_falcon_config(cfg, tp: int):
    """A shard's FalconConfig: nh/tp query heads of the global head_dim;
    the new decoder architecture's kv heads / tp; multi-query keeps its one
    kv head (every shard a replica after restructure_falcon_mqa), classic
    multi-head its per-head (q, k, v) triplets."""
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    if nh % tp:
        raise ValueError("heads must divide into tp shards")
    nh_l = nh // tp
    if cfg.new_decoder_architecture:
        n_kv = cfg.effective_kv_heads
        if n_kv % tp:
            raise ValueError("kv heads must divide into tp shards")
        return dataclasses.replace(cfg, num_attention_heads=nh_l,
                                   num_kv_heads=n_kv // tp,
                                   hidden_size=nh_l * hd)
    return dataclasses.replace(cfg, num_attention_heads=nh_l,
                               hidden_size=nh_l * hd)


def _falcon_block_fn(cfg, tp, mesh, overlap_chunks: int = 1,
                     spec: ActQuantSpec = NO_ACT_QUANT):
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    act = spec.act
    nh_l = nh // tp
    cfg_l = local_falcon_config(cfg, tp)
    slopes_all = tfalcon.alibi_slopes(nh) if cfg.alibi else None

    def block_fn(p_idx, p, x, mask, positions):
        b, s, _ = x.shape
        residual = x
        if cfg.new_decoder_architecture:
            attn_ln = layer_norm(x, p["ln_attn"], cfg.layer_norm_eps)
            mlp_ln = layer_norm(x, p["ln_mlp"], cfg.layer_norm_eps)
        else:
            attn_ln = layer_norm(x, p["input_layernorm"], cfg.layer_norm_eps)
            mlp_ln = None
        fused = _row_linear(attn_ln, p["query_key_value"], act)
        q, k, v = (t.transpose(1, 2)
                   for t in tfalcon.split_heads(fused, cfg_l))
        if not cfg.alibi:
            cos, sin = tllama.rope_cos_sin(positions, hd, cfg.rope_theta,
                                           dtype=x.dtype)
            q, k = tllama.apply_rope(q, k, cos, sin)
        m = mask
        if cfg.alibi:
            # this shard owns heads [p_idx * nh_l, (p_idx + 1) * nh_l)
            slopes = slopes_all[p_idx * nh_l:(p_idx + 1) * nh_l].to(x.device)
            dist = torch.arange(k.shape[2], dtype=torch.float32,
                                device=x.device)
            bias = (slopes[:, None, None] * dist[None]
                    * (1.0 / hd ** 0.5)).to(x.dtype)
            m = m + bias[None]
        attn = _attend(q, k, v, m, hd ** -0.5, x.dtype)
        attn = attn.transpose(1, 2).reshape(b, s, nh_l * hd)
        attn_out = _col_linear_q(attn, p["dense"], mesh, p_idx,
                                 overlap_chunks, act)
        if not cfg.new_decoder_architecture:
            if cfg.parallel_attn:
                mlp_ln = attn_ln
            else:
                residual = residual + attn_out
                mlp_ln = layer_norm(residual, p["post_attention_layernorm"],
                                    cfg.layer_norm_eps)
        hmid = torch.nn.functional.gelu(_row_linear(
            mlp_ln, p["dense_h_to_4h"], act))
        mlp_out = _col_linear_q(hmid, p["dense_4h_to_h"], mesh, p_idx,
                                overlap_chunks, act)
        if cfg.new_decoder_architecture or cfg.parallel_attn:
            mlp_out = mlp_out + attn_out
        return residual + mlp_out

    return block_fn


_BLOCK_FNS = {
    "llama": _llama_block_fn,
    "opt": _opt_block_fn,
    "falcon": _falcon_block_fn,
}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def make_tp_forward(family: str, mesh, cfg, overlap_chunks: int = 1,
                    spec: ActQuantSpec = NO_ACT_QUANT):
    """(make_forward, shard_block): ``shard_block`` pads and places one
    calibrated block's weights (PackedWeight or dense) for TP, one block
    per shard; ``make_forward(layers)`` gives the tensor-parallel trunk
    ``fwd(layers, x)`` over such blocks: x (B, S, H) in, replicated, the
    output of the last block out, on the first local shard's device.
    Embeddings and the head stay outside (replicated). ``spec`` holds the
    activation quantizers (module docstring). The blocks split
    over a row's tp shards; the dp rows of a (dp, tp) mesh are replicas. On
    a mesh that spans processes a rank places and runs only its own
    shards."""
    tp = mesh.tp
    shard_block = _make_shard_block(mesh, family, cfg, tp)
    block_fn = _BLOCK_FNS[family](cfg, tp, mesh, overlap_chunks, spec)

    def make_forward(layers):
        del layers  # JAX traces its specs from them; nothing to do here

        def fwd(layers, x):
            def shard(p, x_p):
                s = x_p.shape[1]
                mask = causal_mask(s, s, dtype=x_p.dtype, device=x_p.device)
                positions = torch.arange(s, device=x_p.device)
                for block in layers:
                    x_p = block_fn(p, block[p], x_p, mask, positions)
                return x_p

            return mesh.first(mesh.run(
                shard, mesh.each(lambda p, d: x.to(d))))

        return fwd

    return make_forward, shard_block


def make_tp_model_forward(family, params: dict, cfg, mesh,
                          overlap_chunks: int = 1,
                          spec: ActQuantSpec = NO_ACT_QUANT):
    """A causal-LM forward ``tokens (B, S) -> logits`` whose decoder blocks
    run tensor-parallel on ``mesh`` (``make_tp_forward``, with the
    activation quantizers of ``spec``), with the family's embedding and
    head on the tokens' device: what ``--eval_ppl --tp`` scores windows
    with. The blocks are placed once, here (``forward.layers``)."""
    from ..models import opt as topt

    make_forward, shard_block = make_tp_forward(family.name, mesh, cfg,
                                                overlap_chunks, spec)
    layers = [shard_block(b) for b in params["layers"]]
    trunk = make_forward(layers)
    rest = {k: v for k, v in params.items() if k != "layers"}
    modules = {"llama": tllama, "opt": topt, "falcon": tfalcon}
    mod = modules[family.name]

    def forward(tokens):
        x = (mod.embed(rest, tokens, cfg) if family.name == "opt"
             else mod.embed(rest, tokens))
        return mod.head(rest, trunk(layers, x).to(x.device), cfg)

    forward.layers = layers  # the placed blocks: a list of shards a layer
    return forward
