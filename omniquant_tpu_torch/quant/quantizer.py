"""Uniform affine quantization, differentiable for calibration.

PyTorch counterpart of ``omniquant_tpu/quant/quantizer.py``. It keeps the
same semantics (qmin = 0, qmax = 2**n - 1; the symmetric scale clamp; the
asymmetric path that skips the [1e-5, 1e4] clamp and only guards an exact
zero scale; "deficiency" zero padding for symmetric groups; bits >= 16 is
the identity; the ``fix0to1`` metric for softmax probabilities).

Gradients are JAX's: rounding is straight-through (``round_ste``), the
code clamp passes the gradient on [qmin, qmax] inclusive and nowhere else,
the rounded zero point has none, and the min/max reductions split it
evenly among ties (``amin``/``amax``). ``fake_quant_weight`` is
differentiable w.r.t. the weight and both learnable weight clipping (LWC)
factors. Where autograd records nothing, the functions run plain
``torch.round`` (the same bits, fewer launches on the serving path).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

CLIPMIN = 1e-5


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through (identity) gradient.
    ``x + (round(x) - x)`` is ``round(x)`` bit for bit: the difference is
    exact."""
    return x + (torch.round(x) - x).detach()


def clamp_ste(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clamp with a straight-through (identity) gradient."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def _round(x: torch.Tensor) -> torch.Tensor:
    """``round_ste`` where autograd records through ``x``, else the plain
    ``torch.round`` (same values)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return round_ste(x)
    return torch.round(x)


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


def init_lwc_params(cfg: QuantConfig, weight_shape, dtype=torch.float32,
                    device="cuda") -> dict:
    """LWC clipping factors for a weight of ``weight_shape``, each
    (num_groups, 1) and initialised to 4.0."""
    dim1 = cfg.num_groups(weight_shape)
    return {name: torch.full((dim1, 1), 4.0, dtype=dtype, device=device)
            for name in ("upbound_factor", "lowbound_factor")}


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


def _fake_quant_core(x, scale, rzp, cfg: QuantConfig) -> torch.Tensor:
    """(clamp(round(x / scale) + rzp) - rzp) * scale. torch.clamp's gradient
    is 1 on [qmin, qmax] inclusive and 0 outside, which is exactly the JAX
    package's ``_clip_torch_grad`` (codes often land on qmin/qmax exactly)."""
    x_int = torch.clamp(_round(x / scale) + rzp, cfg.qmin, cfg.qmax)
    return (x_int - rzp) * scale


def _weight_grid(w: torch.Tensor, cfg: QuantConfig,
                 lwc_params: Optional[dict]):
    """(grouped weight, scale, round_zero_point); with LWC factors the
    group's max and min are scaled by their sigmoids."""
    xq = _grouped(w, cfg)
    xmin = xq.amin(dim=-1, keepdim=True)
    xmax = xq.amax(dim=-1, keepdim=True)
    if cfg.lwc and lwc_params is not None:
        xmax = torch.sigmoid(lwc_params["upbound_factor"]) * xmax
        xmin = torch.sigmoid(lwc_params["lowbound_factor"]) * xmin
    return (xq, *_scale_zp(xmin, xmax, cfg))


def weight_scale_zp(w: torch.Tensor, cfg: QuantConfig,
                    lwc_params: Optional[dict] = None):
    """(scale, round_zero_point) for a weight (out, in), each (num_groups, 1)."""
    return _weight_grid(w, cfg, lwc_params)[1:]


def fake_quant_weight(w: torch.Tensor, cfg: QuantConfig,
                      lwc_params: Optional[dict] = None) -> torch.Tensor:
    """Fake-quantize a weight (out, in), per output channel or by groups of
    ``cfg.group_size`` inputs; differentiable w.r.t. ``w`` and, with
    ``cfg.lwc``, both clipping factors."""
    if not cfg.enabled:
        return w
    if cfg.lwc and lwc_params is None:
        raise ValueError("cfg.lwc=True requires lwc_params")
    out_f, in_f = w.shape
    xdq = _fake_quant_core(*_weight_grid(w, cfg, lwc_params), cfg)
    return xdq.reshape(out_f, -1)[:, :in_f]


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
    optionally grouped; ``fix0to1`` rounds onto a fixed [0, 1] grid. Its
    gradient is the straight-through one (through the codes and the
    per-token scale), as in the JAX package."""
    if not cfg.enabled:
        return x
    if cfg.metric == "fix0to1":
        q = 2**cfg.n_bits - 1
        return _round(x * q) / q
    orig_shape = x.shape
    if cfg.group_size:
        deficiency = cfg.deficiency(orig_shape[-1])
        if deficiency:
            x = torch.nn.functional.pad(x, (0, deficiency))
        x = x.reshape(-1, cfg.group_size)
    xmin = x.amin(dim=-1, keepdim=True)
    xmax = x.amax(dim=-1, keepdim=True)
    xdq = _fake_quant_core(x, *_scale_zp(xmin, xmax, cfg), cfg)
    if cfg.group_size:
        xdq = xdq.reshape(*orig_shape[:-1], -1)[..., : orig_shape[-1]]
    return xdq
