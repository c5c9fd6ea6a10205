"""Blockwise (flash) attention for long prompts.

Counterpart of ``omniquant_tpu/kernels/flash_attention.py::flash_attention``
(without ``return_stats``, which only ring attention needs). Same semantics:
q (B, H, Sq, D), k/v (B, Hkv, Skv, D) with H % Hkv == 0 (kv head h // n_rep),
keys at or beyond Skv masked, the causal mask aligned at position 0 (valid
where Sq == Skv, as every caller has it), optional ALiBi adding
slope[h] * key_position * sm_scale, f32 softmax, output in q.dtype.

On a CUDA tensor it launches the hand-written kernel in
``csrc/flash_attention.cu`` (bf16; head_dim a multiple of 8 up to 128,
run by the 64- or 128-column instance with the columns past head_dim
zero-filled by the loads, never padded in memory; TMA loads need every
tensor at a 16-byte aligned address) or raises; on a CPU tensor it runs
the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30


def flash_attention_plain(q, k, v, sm_scale: Optional[float] = None,
                          causal: bool = True,
                          alibi_slopes: Optional[torch.Tensor] = None):
    """Plain version: dense f32 scores, the kernel's mask, f32 softmax."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    rep = H // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    key = torch.arange(Skv, device=q.device)
    if alibi_slopes is not None:
        slope = alibi_slopes.to(device=q.device, dtype=torch.float32)
        s = s + (slope * sm_scale)[None, :, None, None] * key.float()
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        s = torch.where(key[None, :] <= qi, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def flash_attention(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = True,
                    alibi_slopes: Optional[torch.Tensor] = None):
    """Blockwise attention; returns (B, H, Sq, D) in q.dtype."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group onto {Hkv} kv heads")
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, sm_scale, causal, alibi_slopes)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("the CUDA flash kernel takes bf16 q, k and v")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"the CUDA flash kernel takes a head_dim that is a "
                         f"multiple of 8 up to 128, not {D}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA flash kernel loads {name} by TMA, "
                             f"which needs a 16-byte aligned address")
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32)
        slopes = slopes.contiguous()
    out = torch.empty_like(q)
    _build.launch("flash_attention", "flash_attention_bf16", "pppppiiiiiifi",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if slopes is None else slopes.data_ptr(), out.data_ptr(),
                  B, H, Hkv, Sq, Skv, D, float(sm_scale), int(causal))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
