"""Uniform affine quantization: the inference half of the quantizer.

PyTorch counterpart of ``omniquant_tpu/quant/quantizer.py``. It keeps the
same semantics (qmin = 0, qmax = 2**n - 1; the symmetric scale clamp; the
asymmetric path that skips the [1e-5, 1e4] clamp and only guards an exact
zero scale; "deficiency" zero padding for symmetric groups; bits >= 16 is
the identity; the ``fix0to1`` metric for softmax probabilities).

The straight-through estimators and the learnable weight clipping (LWC)
gradients belong to calibration and are not here; ``weight_scale_zp`` still
applies fixed LWC factors when they are given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

CLIPMIN = 1e-5


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration for one quantizer."""

    n_bits: int = 8
    symmetric: bool = False
    group_size: Optional[int] = None
    lwc: bool = False
    metric: str = "minmax"  # "minmax" | "fix0to1"

    @property
    def enabled(self) -> bool:
        return self.n_bits < 16

    def __post_init__(self):
        if not (2 <= self.n_bits <= 16):
            raise ValueError(f"bitwidth {self.n_bits} not supported (need 2..16)")

    @property
    def qmax(self) -> int:
        return 2**self.n_bits - 1

    @property
    def qmin(self) -> int:
        return 0

    def deficiency(self, in_features: int) -> int:
        """Zero-padding needed to make in_features a multiple of group_size."""
        if not self.group_size:
            return 0
        rem = in_features % self.group_size
        if rem == 0:
            return 0
        if not self.symmetric:
            raise ValueError(
                "group_size must divide in_features for asymmetric quantization "
                "(deficiency padding is symmetric-only, for packed-format compat)"
            )
        return self.group_size - rem

    def num_groups(self, shape) -> int:
        """Number of scale rows for a weight of `shape` (out, in)."""
        if self.group_size:
            return int(shape[0] * math.ceil(shape[1] / self.group_size))
        return int(shape[0])


def _scale_zp(xmin: torch.Tensor, xmax: torch.Tensor, cfg: QuantConfig):
    """(scale, round_zero_point) from per-row/group min and max.

    The asymmetric branch deliberately has no [CLIPMIN, 1e4] clamp, exactly
    as the JAX package (which follows the reference quantizer, where the
    clamped scale is overwritten by the raw one); only an exact zero scale
    is replaced to avoid 0/0."""
    if cfg.symmetric:
        abs_max = torch.maximum(xmax.abs(), xmin.abs())
        scale = (abs_max / (2 ** (cfg.n_bits - 1) - 1)).clamp(CLIPMIN, 1e4)
        zero_point = torch.full_like(scale, float(2 ** (cfg.n_bits - 1) - 1))
    else:
        scale = (xmax - xmin) / (2**cfg.n_bits - 1)
        scale = torch.where(scale == 0, torch.full_like(scale, CLIPMIN), scale)
        zero_point = -xmin / scale
    return scale, torch.round(zero_point.clamp(-1e4, 1e4))


def _grouped(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """(out, in) -> deficiency-padded rows of one quant group each."""
    deficiency = cfg.deficiency(w.shape[1])
    if deficiency:
        w = torch.nn.functional.pad(w, (0, deficiency))
    return w.reshape(-1, cfg.group_size) if cfg.group_size else w


def weight_scale_zp(w: torch.Tensor, cfg: QuantConfig,
                    lwc_params: Optional[dict] = None):
    """(scale, round_zero_point) for a weight (out, in), each (num_groups, 1)."""
    xq = _grouped(w, cfg)
    xmin = xq.amin(dim=-1, keepdim=True)
    xmax = xq.amax(dim=-1, keepdim=True)
    if cfg.lwc and lwc_params is not None:
        xmax = torch.sigmoid(lwc_params["upbound_factor"]) * xmax
        xmin = torch.sigmoid(lwc_params["lowbound_factor"]) * xmin
    return _scale_zp(xmin, xmax, cfg)


def quantize_weight_int(w: torch.Tensor, cfg: QuantConfig,
                        lwc_params: Optional[dict] = None):
    """Hard-quantize a weight (out, in) to integer codes.

    Returns (codes int32 (out, in_padded), scale, round_zero_point)."""
    out_f, in_f = w.shape
    grouped = _grouped(w, cfg)
    scale, rzp = weight_scale_zp(w, cfg, lwc_params)
    codes = torch.clamp(torch.round(grouped / scale) + rzp, cfg.qmin, cfg.qmax)
    return codes.reshape(out_f, -1).to(torch.int32), scale, rzp


def dequantize_weight_int(codes: torch.Tensor, scale: torch.Tensor,
                          rzp: torch.Tensor, cfg: QuantConfig,
                          in_features: int) -> torch.Tensor:
    """Inverse of quantize_weight_int (strips the deficiency padding)."""
    out_f = codes.shape[0]
    grouped = codes.reshape(-1, cfg.group_size) if cfg.group_size else codes
    deq = (grouped.to(scale.dtype) - rzp) * scale
    return deq.reshape(out_f, -1)[:, :in_features]


def fake_quant_act(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Per-token dynamic fake quantization over the last axis (any rank),
    optionally grouped; ``fix0to1`` rounds onto a fixed [0, 1] grid."""
    if not cfg.enabled:
        return x
    if cfg.metric == "fix0to1":
        q = 2**cfg.n_bits - 1
        return torch.round(x * q) / q
    orig_shape = x.shape
    if cfg.group_size:
        deficiency = cfg.deficiency(orig_shape[-1])
        if deficiency:
            x = torch.nn.functional.pad(x, (0, deficiency))
        x = x.reshape(-1, cfg.group_size)
    xmin = x.amin(dim=-1, keepdim=True)
    xmax = x.amax(dim=-1, keepdim=True)
    scale, rzp = _scale_zp(xmin, xmax, cfg)
    x_int = torch.clamp(torch.round(x / scale) + rzp, cfg.qmin, cfg.qmax)
    xdq = (x_int - rzp) * scale
    if cfg.group_size:
        xdq = xdq.reshape(*orig_shape[:-1], -1)[..., : orig_shape[-1]]
    return xdq
