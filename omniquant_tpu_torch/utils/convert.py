"""Carry weights from the JAX package into this one.

``from_jax_params`` takes the JAX package's parameter tree with its arrays
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree of tensors. A packed linear is recognised by duck typing (it
has ``qweight``, ``scales``, ``zeros``, ``bias``, ``bits``, ``group_size``,
``in_features``, ``out_features``, ``tile_k`` and ``layout``), so nothing
of the JAX package is imported.

It also carries a calibration's ``omni_parameters`` tree ({layer index:
{'let': ..., 'lwc': ..., 'qparams': ...}} with numpy leaves), so both
packages can be handed the same trainables.

``load_packed_npz`` reads the JAX package's npz checkpoints (packed format
v2, written by its ``utils/checkpoint.py::save_pytree``; the port's copy of
the format is ``utils/checkpoint.py``), so one exported artifact feeds both
packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..quant.packing import PackedWeight
from .checkpoint import _is_packed, load_pytree


def _tensor(a, device, dtype, copy: bool = True) -> torch.Tensor:
    """A numpy array (or a tensor already converted) as a tensor on
    ``device``: floating in ``dtype``, integers in their own type. With
    ``copy`` a CPU tensor never shares the caller's array."""
    if not isinstance(a, torch.Tensor):
        a = np.array(a, copy=copy)
        if a.dtype.name == "bfloat16":  # numpy has no bf16 torch can take
            a = a.astype(np.float32)  # exact widening
        a = torch.from_numpy(a)
    t = a.to(device)
    return t.to(dtype) if t.is_floating_point() else t


def from_jax_params(tree, device="cuda", dtype=torch.float32):
    """The JAX parameter tree (numpy leaves) as tensors on ``device``.
    Floating arrays, packed scales/zeros/bias included, become ``dtype``;
    integer arrays keep their type."""
    device = resolve_device(device)

    def tensor(a):
        return _tensor(a, device, dtype)

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


def load_packed_npz(path: str, device="cuda", dtype=torch.float32):
    """Read a JAX-package npz checkpoint (packed format v2 included) into
    the port's parameter tree on ``device``, each array converted as it is
    read (a model is never held twice on the host)."""
    device = resolve_device(device)
    tree = load_pytree(path, leaf=lambda a: _tensor(a, device, dtype,
                                                    copy=False))
    return from_jax_params(tree, device=device, dtype=dtype)
