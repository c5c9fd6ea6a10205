"""Shared building blocks for decoder-only LMs (inference).

Counterpart of ``omniquant_tpu/models/common.py``. Linear weights use the
(out_features, in_features) layout, y = x @ W.T + b; a PackedWeight runs the
packed matmul instead. RMSNorm takes its variance in f32, casts back, then
multiplies by the weight in the working dtype; attention softmax is f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.packing import PackedWeight
from ..quant.quantizer import QuantConfig, fake_quant_act


@dataclasses.dataclass(frozen=True)
class ActQuantSpec:
    """Activation-quantization sites of a block forward; None disables one."""

    act: Optional[QuantConfig] = None  # inputs of every quantized linear
    q: Optional[QuantConfig] = None    # query entering q@k^T
    k: Optional[QuantConfig] = None    # key entering q@k^T
    v: Optional[QuantConfig] = None    # value entering p@v
    p: Optional[QuantConfig] = None    # softmax probs entering p@v

    @staticmethod
    def from_bits(abits: int) -> "ActQuantSpec":
        """Per-token asymmetric quant at abits for act/q/k/v and a 16-bit
        (identity) fix0to1 quantizer for the softmax probabilities."""
        if abits >= 16:
            return ActQuantSpec()
        a = QuantConfig(n_bits=abits, symmetric=False)
        return ActQuantSpec(
            act=a, q=a, k=a, v=a, p=QuantConfig(n_bits=16, metric="fix0to1"))


NO_ACT_QUANT = ActQuantSpec()


def maybe_quant(x: torch.Tensor, cfg: Optional[QuantConfig]) -> torch.Tensor:
    return x if cfg is None else fake_quant_act(x, cfg)


def linear(x: torch.Tensor, fc, act_cfg: Optional[QuantConfig] = None):
    """Linear forward: fake-quant the input per token when act_cfg is set,
    then x @ W.T + b; a PackedWeight runs the packed matmul kernel."""
    if isinstance(fc, PackedWeight):
        if act_cfg is not None and act_cfg.enabled:
            raise NotImplementedError(
                "packed weights with quantized activations take the integer "
                "(W4A4/W6A6) path, which is not ported yet")
        from ..kernels.quant_matmul import quant_matmul

        return quant_matmul(x, fc)
    x = maybe_quant(x, act_cfg)
    y = x @ fc["weight"].t()
    b = fc.get("bias")
    return y if b is None else y + b


def rms_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """RMSNorm with f32 variance; supports a bias folded in by LET."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["weight"]
    b = p.get("bias")
    return y if b is None else y + b


def causal_mask(q_len: int, kv_len: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal mask (0 allowed, dtype-min on the future), shape
    (1, 1, q_len, kv_len), queries aligned to the end of the keys."""
    neg = torch.finfo(dtype).min
    i = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    j = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    m = torch.where(j <= i, zero, torch.full((), neg, dtype=dtype, device=device))
    return m[None, None]


def attention_core(q, k, v, mask: Optional[torch.Tensor], scale: float,
                   spec: ActQuantSpec,
                   scale_before_quant: bool = False) -> torch.Tensor:
    """Fake-quant-aware dense attention: q/k quantized entering q@k^T,
    scores (in dtype) + mask, f32 softmax cast back, probs and v quantized
    entering p@v. q (b, h, q_len, hd); k/v (b, h, kv_len, hd)."""
    dtype = q.dtype
    if scale_before_quant:
        q = q * scale
    q = maybe_quant(q, spec.q)
    k = maybe_quant(k, spec.k)
    scores = torch.matmul(q, k.transpose(-1, -2))
    if not scale_before_quant:
        scores = scores * scale
    if mask is not None:
        scores = torch.clamp(scores + mask, min=torch.finfo(dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    probs = maybe_quant(probs, spec.p)
    v = maybe_quant(v, spec.v)
    return torch.matmul(probs, v)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, n_kv, s, hd) -> (b, n_kv*n_rep, s, hd), each kv head repeated
    n_rep consecutive times."""
    if n_rep == 1:
        return x
    b, n_kv, s, hd = x.shape
    return x[:, :, None].expand(b, n_kv, n_rep, s, hd).reshape(
        b, n_kv * n_rep, s, hd)
