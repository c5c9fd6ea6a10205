"""Carry weights from the JAX package into this one.

``from_jax_params`` takes the JAX package's parameter tree with its arrays
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree of tensors. A packed linear is recognised by duck typing (it
has ``qweight``, ``scales``, ``zeros``, ``bias``, ``bits``, ``group_size``,
``in_features``, ``out_features``, ``tile_k`` and ``layout``), so nothing
of the JAX package is imported.

``load_packed_npz`` reads the JAX package's npz checkpoints (packed format
v2, written by its ``utils/checkpoint.py::save_pytree``), so one exported
artifact feeds both packages. The format's constants are copied here.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .. import resolve_device
from ..quant.packing import PackedWeight

# wire-format constants of the JAX package's packed npz checkpoints
_SEP = "||"
_NONE = "__none__"
_PACKED_FORMAT_VERSION = 2
_LAYOUTS = ("planar", "pairs")  # index order is part of the wire format
_PACKED_FIELDS = ("qweight", "scales", "zeros", "bias", "bits", "group_size",
                  "in_features", "out_features", "tile_k", "layout")


def _is_packed(x) -> bool:
    return all(hasattr(x, f) for f in _PACKED_FIELDS)


def from_jax_params(tree, device="cuda", dtype=torch.float32):
    """The JAX parameter tree (numpy leaves) as tensors on ``device``.
    Floating arrays, packed scales/zeros/bias included, become ``dtype``;
    integer arrays keep their type."""
    device = resolve_device(device)

    def tensor(a):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":  # numpy has no bf16 torch can take
            a = a.astype(np.float32)  # exact widening
        t = torch.from_numpy(a).to(device)
        return t.to(dtype) if t.is_floating_point() else t

    def conv(x):
        if x is None:
            return None
        if _is_packed(x):
            return PackedWeight(
                qweight=tensor(x.qweight).to(torch.int32),
                scales=tensor(x.scales), zeros=tensor(x.zeros),
                bias=None if x.bias is None else tensor(x.bias),
                bits=int(x.bits),
                group_size=int(x.group_size) if x.group_size else None,
                in_features=int(x.in_features),
                out_features=int(x.out_features), tile_k=int(x.tile_k),
                layout=str(x.layout))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return tensor(x)

    return conv(tree)


def _unflatten(flat: dict):
    """The JAX package's flattened-npz layout back into a tree with numpy
    leaves; packed linears become namespaces with the PackedWeight fields."""
    if _NONE in flat:
        return None
    if "__leaf__" in flat:
        return flat["__leaf__"]
    if "__empty_dict__" in flat:
        return {}
    if "__packed__" in flat:
        body = _unflatten({k: v for k, v in flat.items() if k != "__packed__"})
        meta = [int(x) for x in body["meta"]]
        if len(meta) < 7:
            raise ValueError(
                "packed checkpoint predates the versioned meta format "
                "(missing layout field); re-export it")
        if meta[5] != _PACKED_FORMAT_VERSION:
            raise ValueError(
                f"packed checkpoint format v{meta[5]} != supported "
                f"v{_PACKED_FORMAT_VERSION}; re-export it")
        bits, gs, in_f, out_f, tile = meta[:5]
        return types.SimpleNamespace(
            qweight=body["qweight"], scales=body["scales"],
            zeros=body["zeros"], bias=body["bias"], bits=bits,
            group_size=gs or None, in_features=in_f, out_features=out_f,
            tile_k=tile, layout=_LAYOUTS[meta[6]])
    if "__list__" in flat or "__tuple__" in flat:
        is_list = "__list__" in flat
        n = int(flat["__list__" if is_list else "__tuple__"])
        children = {}
        for k, v in flat.items():
            if k in ("__list__", "__tuple__"):
                continue
            head, rest = k.split(_SEP, 1)
            children.setdefault(head, {})[rest] = v
        items = [_unflatten(children[str(i)]) for i in range(n)]
        return items if is_list else tuple(items)
    children = {}
    for k, v in flat.items():
        head, rest = k.split(_SEP, 1)
        children.setdefault(head, {})[rest] = v
    return {k: _unflatten(v) for k, v in children.items()}


def load_packed_npz(path: str, device="cuda", dtype=torch.float32):
    """Read a JAX-package npz checkpoint (packed format v2 included) into
    the port's parameter tree on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return from_jax_params(_unflatten(flat), device=device, dtype=dtype)
