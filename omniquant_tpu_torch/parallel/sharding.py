"""Tensor-parallel parameter layout and placement.

Counterpart of ``omniquant_tpu/parallel/sharding.py``. JAX describes a
layout with a ``PartitionSpec`` per parameter and lets ``device_put``
shard it over a mesh; here a spec is a plain per-leaf description, the
axis that the tp shards split (``0`` or ``1``) or ``None`` for a leaf
every shard holds whole, and ``shard_params`` returns one tree per shard,
its tensors on the shard's device.

Tensor-parallel layout (Megatron-style, quantization-aware):
  q/k/v/gate/up: row-parallel (out axis split) -- head-aligned
  o/down:        column-parallel (in axis split), output all-reduced
  norms/embeds:  replicated
Dense weights are (out, in): row-parallel splits axis 0, column-parallel
axis 1; a bias is split on a row-parallel linear and replicated on a
column-parallel one (added once, after the all-reduce). A PackedWeight's
``qweight`` is (k_words, out), the transposed layout: row-parallel splits
its lanes (axis 1) with the scale and zero rows (axis 0) and the bias;
column-parallel splits its packed rows (axis 0) and the scale groups
(axis 1). A shard's PackedWeight carries its local dims (``out_features``
of its lanes, ``in_features`` at most its rows).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.packing import PackedWeight, rows_per_words

ROW_PARALLEL = {
    "llama": ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"),
    "opt": ("q_proj", "k_proj", "v_proj", "fc1"),
    "falcon": ("query_key_value", "dense_h_to_4h"),
}
COL_PARALLEL = {
    "llama": ("o_proj", "down_proj"),
    "opt": ("out_proj", "fc2"),
    "falcon": ("dense", "dense_4h_to_h"),
}

_PACKED_FIELDS = ("qweight", "scales", "zeros", "bias")


def _replicated(sub):
    """A spec that splits nothing, shaped like ``sub`` (None leaves stay
    None)."""
    if isinstance(sub, dict):
        return {k: _replicated(v) for k, v in sub.items()}
    if isinstance(sub, (list, tuple)):
        return [_replicated(v) for v in sub]
    return None


def _linear_spec(row_parallel: bool, sub) -> dict:
    """The spec of one linear: {'weight', 'bias'} for a dense one,
    {'qweight', 'scales', 'zeros', 'bias'} for a PackedWeight."""
    if not isinstance(sub, PackedWeight):
        return {"weight": 0, "bias": 0} if row_parallel else {
            "weight": 1, "bias": None}
    if row_parallel:
        return {"qweight": 1, "scales": 0, "zeros": 0,
                "bias": 0 if sub.bias is not None else None}
    return {"qweight": 0, "scales": 1, "zeros": 1, "bias": None}


def block_specs(family_name: str, block: dict) -> dict:
    """The spec tree of one decoder block's params."""
    specs = {}
    rows = ROW_PARALLEL[family_name]
    cols = COL_PARALLEL[family_name]
    for name, sub in block.items():
        if name in rows or name in cols:
            specs[name] = _linear_spec(name in rows, sub)
        else:  # norms
            specs[name] = _replicated(sub)
        if isinstance(sub, dict) and isinstance(specs[name], dict):
            if "bias" in sub and sub["bias"] is None:
                specs[name]["bias"] = None
            elif "bias" not in sub:
                specs[name].pop("bias", None)
    return specs


def model_specs(family_name: str, params: dict) -> dict:
    """The spec tree of a whole model's params (embeddings, heads and
    norms replicated)."""
    specs = {}
    for key, val in params.items():
        if key == "layers":
            specs["layers"] = [block_specs(family_name, b) for b in val]
        else:
            specs[key] = _replicated(val)
    return specs


def split(t: torch.Tensor, axis: Optional[int], n: int, p: int,
          device) -> torch.Tensor:
    """Shard p of n of ``t`` along ``axis`` (all of it for None), on
    ``device``, contiguous. The axis must split evenly."""
    if axis is not None:
        size = t.shape[axis]
        if size % n:
            raise ValueError(f"axis {axis} of a {tuple(t.shape)} tensor does "
                             f"not split into {n} shards")
        t = t.narrow(axis, p * (size // n), size // n)
    return t.to(device).contiguous()


def local_packed(pw: PackedWeight, spec: dict, n: int, p: int,
                 device) -> PackedWeight:
    """Shard p of n of a PackedWeight under ``spec``, with its local dims:
    the lanes it holds as out_features, at most its packed rows as
    in_features."""
    t = {f: None if getattr(pw, f) is None else
         split(getattr(pw, f), spec[f], n, p, device)
         for f in _PACKED_FIELDS}
    local_rows = rows_per_words(pw.bits, t["qweight"].shape[0], pw.layout)
    return dataclasses.replace(
        pw, **t, out_features=t["qweight"].shape[1],
        in_features=min(pw.in_features, local_rows))


def _shard(x, spec, n: int, p: int, device):
    if x is None:
        return None
    if isinstance(x, PackedWeight):
        if spec is None:  # a packed head: every shard holds it whole
            return x.map_tensors(lambda t: t.to(device))
        return local_packed(x, spec, n, p, device)
    if isinstance(x, dict):
        return {k: _shard(v, spec.get(k) if isinstance(spec, dict) else None,
                          n, p, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_shard(v, s, n, p, device) for v, s in zip(
            x, spec if isinstance(spec, (list, tuple)) else [spec] * len(x))]
    if isinstance(x, torch.Tensor):
        return split(x, spec, n, p, device)
    return x


def shard_params(params, mesh, specs) -> list:
    """One tree per local shard of ``mesh`` (None at other ranks' shards):
    every tensor of ``params`` split by its spec over a row's tp shards
    (shard p takes part p % tp; whole where the spec is None), on the
    shard's device."""
    return mesh.each(lambda p, d: _shard(params, specs, mesh.tp,
                                         p % mesh.tp, d))
