"""Activation statistics that seed the LET scales and shifts.

Counterpart of ``omniquant_tpu/calib/act_stats.py``: each block's forward
hands its linears' inputs to a ``tap`` dict, and per linear, over batches
of calibration windows:

  scales[name] = running per-channel max of |x|
  shifts[name] = EMA (0.99 old, 0.01 new) of the per-channel (max + min) / 2
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..models.common import causal_mask
from ..models.registry import ModelFamily
from .engine import _embed_all, _to


def collect_act_stats(family: ModelFamily, params: dict, model_cfg,
                      calib_tokens, batch: int = 4, logger=None,
                      device="cuda"):
    """(scales, shifts): one dict per layer of per-linear input-channel
    statistics (f32 tensors on ``device``), keyed by the linear names.
    Blocks run ``batch`` windows at a time on ``device``, in f32."""
    log = logger.info if logger else (lambda *a: None)
    device = resolve_device(device)
    tokens = torch.as_tensor(calib_tokens, device=device)
    n, seqlen = tokens.shape
    mask = causal_mask(seqlen, seqlen, device=device)
    positions = torch.arange(seqlen, device=device)
    scales, shifts = [], []
    with torch.no_grad():
        xs = _embed_all(family, params, model_cfg, tokens, None, device)
        for li, layer in enumerate(params["layers"]):
            layer = _to(layer, device)
            layer_scales, layer_shifts = {}, {}
            for i in range(0, n, batch):
                tap = {}
                ys, _ = family.block_forward(layer, xs[i: i + batch],
                                             model_cfg, mask, positions,
                                             tap=tap)
                for name, act in tap.items():
                    flat = act.reshape(-1, act.shape[-1]).float()
                    absmax = flat.abs().amax(dim=0)
                    mid = (flat.amax(dim=0) + flat.amin(dim=0)) / 2.0
                    if name not in layer_scales:
                        layer_scales[name], layer_shifts[name] = absmax, mid
                    else:
                        layer_scales[name] = torch.maximum(
                            layer_scales[name], absmax)
                        layer_shifts[name] = (0.99 * layer_shifts[name]
                                              + 0.01 * mid)
                xs[i: i + batch] = ys
            scales.append(layer_scales)
            shifts.append(layer_shifts)
            log(f"act stats: layer {li} done")
    return scales, shifts
