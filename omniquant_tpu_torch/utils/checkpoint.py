"""npz checkpoints of parameter trees, in the JAX package's format.

Counterpart of ``omniquant_tpu/utils/checkpoint.py``: a tree of dicts,
lists, tuples, None and arrays is flattened to one npz entry per leaf,
keyed by its path joined with ``||``; a packed linear is stored as its
fields plus a versioned ``meta`` row (format v2). So one file, such as a
calibration's ``omni_parameters.npz`` or a packed model, feeds both
packages. The format's constants are copied here.

``load_pytree`` returns numpy leaves (packed linears as namespaces with the
PackedWeight fields); ``utils.convert.from_jax_params`` turns such a tree
into tensors.
"""
from __future__ import annotations

import io
import os
import types
from typing import Any

import numpy as np
import torch

# wire-format constants of the JAX package's npz checkpoints
_SEP = "||"
_NONE = "__none__"
_PACKED_FORMAT_VERSION = 2
_LAYOUTS = ("planar", "pairs")  # index order is part of the wire format
_PACKED_FIELDS = ("qweight", "scales", "zeros", "bias", "bits", "group_size",
                  "in_features", "out_features", "tile_k", "layout")


def _is_packed(x) -> bool:
    return all(hasattr(x, f) for f in _PACKED_FIELDS)


def _numpy(x) -> np.ndarray:
    """A leaf as numpy; bf16 tensors widen to f32 (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if tree is None:
        out[prefix + _NONE] = np.asarray(0)
    elif _is_packed(tree):
        out[prefix + "__packed__"] = np.asarray(1)
        body = {
            "qweight": tree.qweight, "scales": tree.scales,
            "zeros": tree.zeros, "bias": tree.bias,
            "meta": np.asarray([
                tree.bits, tree.group_size or 0, tree.in_features,
                tree.out_features, tree.tile_k, _PACKED_FORMAT_VERSION,
                _LAYOUTS.index(tree.layout)]),
        }
        out.update(_flatten(body, prefix))
    elif isinstance(tree, dict):
        if not tree:
            out[prefix + "__empty_dict__"] = np.asarray(0)
        for k, v in tree.items():
            out.update(_flatten(v, prefix + str(k) + _SEP))
    elif isinstance(tree, (list, tuple)):
        tag = "__list__" if isinstance(tree, list) else "__tuple__"
        out[prefix + tag] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + str(i) + _SEP))
    else:
        out[prefix + "__leaf__"] = _numpy(tree)
    return out


def _unflatten(flat: dict):
    """The flattened-npz layout back into a tree with numpy leaves; packed
    linears become namespaces with the PackedWeight fields."""
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


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (tensor or numpy leaves) to the npz at ``path``."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_pytree(path: str) -> Any:
    """The tree saved at ``path``, with numpy leaves."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
