"""Real-quant export: pack (already folded, fake-quantized) weights into
int32 storage. Counterpart of ``omniquant_tpu/serving/export.py``."""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..models.registry import ModelFamily
from ..quant.packing import pack_weight
from ..quant.quantizer import QuantConfig


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def pack_model(family: ModelFamily, params: dict, wcfg: QuantConfig,
               omni_parameters: Optional[dict] = None,
               tile_k: Optional[int] = None, layout: str = "auto",
               device="cuda") -> dict:
    """Returns {'layers': [{linear_name: PackedWeight, ...}, ...], plus the
    non-layer params}, all on ``device``.

    With ``omni_parameters`` (from calibration) each linear is packed
    against its recorded scale/zero grid; without, scale and zero point are
    re-derived from the weight values."""
    if wcfg is None or not wcfg.enabled:
        raise ValueError("pack_model needs an enabled weight quant config")
    device = resolve_device(device)
    pack_cfg = QuantConfig(n_bits=wcfg.n_bits, symmetric=wcfg.symmetric,
                           group_size=wcfg.group_size, lwc=False)
    out = {k: _to(v, device) for k, v in params.items() if k != "layers"}
    packed_layers = []
    for i, block in enumerate(params["layers"]):
        qp = (omni_parameters or {}).get(i, {}).get("qparams", {})
        pb = {}
        for name, sub in block.items():
            if name not in family.linear_names:
                pb[name] = _to(sub, device)
                continue
            kw = {}
            if name in qp:
                kw = {"scale": torch.as_tensor(qp[name]["scale"], device=device),
                      "rzp": torch.as_tensor(qp[name]["zero"], device=device)}
            bias = sub.get("bias")
            pb[name] = pack_weight(
                sub["weight"].to(device), pack_cfg,
                bias=None if bias is None else bias.to(device),
                tile_k=tile_k, layout=layout, **kw)
        packed_layers.append(pb)
    out["layers"] = packed_layers
    return out
