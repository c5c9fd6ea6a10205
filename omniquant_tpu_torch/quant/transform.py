"""Learnable Equivalent Transformation (LET): the smoothing algebra.

PyTorch counterpart of ``omniquant_tpu/quant/transform.py``: functions from
dicts of weights to dicts of transformed weights, differentiable w.r.t. the
scales and shifts. The same functions give the temporary weights of a
calibration step and the folded weights afterwards (under ``no_grad``).

The identities (the block's output is unchanged in exact arithmetic):
  ln -> fcs : ln_w' = ln_w / s; ln_b' = (ln_b - d) / s (a bias appears on an
              RMSNorm that had none); fc_w' = fc_w * s (per input column);
              fc_b' = fc_b + fc_w @ d
  fc1 -> fc2: fc1_w' = fc1_w / s (per output row); fc1_b' = (fc1_b - d) / s;
              fc2_w' = fc2_w * s (per input column); fc2_b' = fc2_b + fc2_w @ d
  q <-> k   : q_w' = q_w / s (rows); q_b' = q_b / s; k_w' = k_w * s;
              k_b' = k_b * s
Linear weights are (out_features, in_features); y = x @ W.T + b.
"""
from __future__ import annotations

from typing import Optional

import torch


def _truncate_fwd_value(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """|x| below ``threshold`` becomes sign(x) * threshold; exact zeros stay
    zero (sign(0) = 0)."""
    return torch.where(x.abs() < threshold, torch.sign(x) * threshold, x)


class _Truncate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, threshold):
        return _truncate_fwd_value(x, threshold)

    @staticmethod
    def backward(ctx, g):
        return g, None


def truncate_number(x: torch.Tensor, threshold: float = 1e-2) -> torch.Tensor:
    """``_truncate_fwd_value`` with an identity gradient."""
    return _Truncate.apply(x, threshold)


def _bias_plus(b: Optional[torch.Tensor], delta: torch.Tensor):
    return delta if b is None else b + delta


def smooth_ln_fcs(ln: dict, fcs: list, scales: torch.Tensor,
                  shifts: torch.Tensor):
    """Move a norm's per-channel scale and shift into the linears it feeds.
    ``ln`` is {'weight' (h,), optional 'bias'}; each fc {'weight' (out, h),
    optional 'bias'}. Returns (ln', [fc', ...]); the norm always gets a
    bias."""
    ln_bias = ln.get("bias")
    new_ln = dict(ln)
    new_ln["bias"] = ((-shifts) if ln_bias is None
                      else (ln_bias - shifts)) / scales
    new_ln["weight"] = ln["weight"] / scales
    new_fcs = []
    for fc in fcs:
        new_fc = dict(fc)
        w = fc["weight"]
        # the bias takes the ORIGINAL weight's product with the shift
        new_fc["bias"] = _bias_plus(fc.get("bias"), w @ shifts)
        new_fc["weight"] = w * scales[None, :]
        new_fcs.append(new_fc)
    return new_ln, new_fcs


def _fc1_scaled(fc1: dict, scales, shifts) -> dict:
    new_fc1 = dict(fc1)
    b1 = fc1.get("bias")
    if b1 is None:
        b1 = torch.zeros(fc1["weight"].shape[0], dtype=fc1["weight"].dtype,
                         device=fc1["weight"].device)
    new_fc1["bias"] = (b1 - shifts) / scales
    new_fc1["weight"] = fc1["weight"] / scales[:, None]
    return new_fc1


def _fc2_scaled(fc2: dict, scales, shifts) -> dict:
    new_fc2 = dict(fc2)
    w2 = fc2["weight"]
    new_fc2["bias"] = _bias_plus(fc2.get("bias"), w2 @ shifts)
    new_fc2["weight"] = w2 * scales[None, :]
    return new_fc2


def smooth_fc_fc(fc1: dict, fc2: dict, scales: torch.Tensor,
                 shifts: Optional[torch.Tensor] = None):
    """v_proj -> o_proj smoothing (MHA: fc1's outputs are fc2's inputs):
    fc1's output rows divided by ``scales``, fc2's input columns
    multiplied."""
    if shifts is None:
        shifts = torch.zeros_like(scales)
    return _fc1_scaled(fc1, scales, shifts), _fc2_scaled(fc2, scales, shifts)


def _repeat_heads(v: torch.Tensor, head_dim: int, n_rep: int):
    """(n_kv * head_dim,) -> (n_kv * n_rep * head_dim,): each kv head's
    entries repeated for its n_rep query heads."""
    n_kv = v.shape[0] // head_dim
    return v.reshape(n_kv, 1, head_dim).expand(n_kv, n_rep, head_dim
                                               ).reshape(-1)


def smooth_fc_fc_gqa(fc1: dict, fc2: dict, scales: torch.Tensor,
                     shifts: Optional[torch.Tensor], head_dim: int,
                     n_rep: int):
    """v_proj -> o_proj smoothing under GQA: ``scales`` (n_kv * head_dim,)
    divide v_proj's rows and, repeated per query head, multiply o_proj's
    columns."""
    if n_rep == 1:
        return smooth_fc_fc(fc1, fc2, scales, shifts)
    if shifts is None:
        shifts = torch.zeros_like(scales)
    return _fc1_scaled(fc1, scales, shifts), _fc2_scaled(
        fc2, _repeat_heads(scales, head_dim, n_rep),
        _repeat_heads(shifts, head_dim, n_rep))


def smooth_q_k(q_proj: dict, k_proj: dict, scales: torch.Tensor,
               head_dim: int = 0, n_rep: int = 1):
    """q <-> k smoothing: q's rows divided, k's multiplied, so q . k per head
    is unchanged. ``scales`` has k_proj's length; under GQA each kv head's
    scales are repeated for its n_rep query heads."""
    q_scales = scales if n_rep == 1 else _repeat_heads(scales, head_dim, n_rep)
    new_q, new_k = dict(q_proj), dict(k_proj)
    new_q["weight"] = q_proj["weight"] / q_scales[:, None]
    new_k["weight"] = k_proj["weight"] * scales[:, None]
    if q_proj.get("bias") is not None:
        new_q["bias"] = q_proj["bias"] / q_scales
    if k_proj.get("bias") is not None:
        new_k["bias"] = k_proj["bias"] * scales
    return new_q, new_k
