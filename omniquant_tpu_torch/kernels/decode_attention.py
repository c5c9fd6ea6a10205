"""One-query decode attention over an int8 KV cache.

Counterpart of ``omniquant_tpu/kernels/decode_attention.py::
decode_attention_int8`` (without ``return_stats``, which only ring attention
would need). Same semantics: q (B, n_heads, hd) with n_heads = n_kv * n_rep
(kv head h // n_rep); per-token symmetric int8 codes (B, n_kv, max_len, hd)
with f32 scales (B, n_kv, max_len); the window [0, kv_len) attended at
positions <= lengths[b]; an optional ring of R staged tokens, positions
0..ring_n of which are attended after the window; f32 softmax with masked
scores at -1e30.

On a CUDA tensor it launches the hand-written kernel in
``csrc/decode_attention.cu`` (bf16 q and output, head_dim 64 or 128, at
most 8 query heads per kv head) or raises; the kernel reads only the live
part of each slot's window and never dequantizes the cache. On a CPU tensor
it runs the plain version, which dequantizes in f32 and attends densely.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_NEG = -1e30


def decode_attention_int8_plain(q, k_codes, k_scale, v_codes, v_scale,
                                lengths, kv_len: int, score_scale: float,
                                out_dtype=torch.bfloat16,
                                ring_kv: Optional[Tuple] = None,
                                ring_n: int = -1):
    """Plain version: dequantize the window (and the ring) in f32, dense
    masked f32 attention, output cast to out_dtype."""
    B, n_heads, hd = q.shape
    n_kv, max_len = k_codes.shape[1:3]
    kv_len = min(kv_len, max_len)
    k = k_codes[:, :, :kv_len].float() * k_scale[:, :, :kv_len, None]
    v = v_codes[:, :, :kv_len].float() * v_scale[:, :, :kv_len, None]
    pos = torch.arange(kv_len, device=q.device)
    mask = pos[None, None, :] <= lengths.to(q.device)[:, None, None]
    if ring_n >= 0:
        rk_c, rk_s, rv_c, rv_s = ring_kv
        R = rk_c.shape[2]
        k = torch.cat([k, rk_c.float() * rk_s[..., None]], dim=2)
        v = torch.cat([v, rv_c.float() * rv_s[..., None]], dim=2)
        ring = (torch.arange(R, device=q.device) <= ring_n)[None, None, :]
        mask = torch.cat([mask, ring.expand(B, 1, R)], dim=-1)
    n_rep = n_heads // n_kv
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k) * score_scale
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, v).to(out_dtype)


def decode_attention_int8(q, k_codes, k_scale, v_codes, v_scale, lengths,
                          kv_len: int, score_scale: float,
                          out_dtype=torch.bfloat16,
                          ring_kv: Optional[Tuple] = None, ring_n: int = -1):
    """Decode attention over the int8 window; returns (B, n_heads, hd).

    k_codes/v_codes are the full (B, n_kv, max_len, hd) cache buffers (only
    the window is read); ring_kv = (rk_codes (B, n_kv, R, hd), rk_scale
    (B, n_kv, R), rv_codes, rv_scale) with ring_n < R the last staged index,
    or ring_n = -1 for no ring."""
    B, n_heads, hd = q.shape
    _, n_kv, max_len, _ = k_codes.shape
    if n_heads % n_kv:
        raise ValueError(f"{n_heads} query heads do not group onto {n_kv} "
                         "kv heads")
    if ring_n >= 0 and ring_kv is None:
        raise ValueError("ring_n >= 0 needs ring_kv")
    kv_len = min(kv_len, max_len)
    if not q.is_cuda:
        return decode_attention_int8_plain(
            q, k_codes, k_scale, v_codes, v_scale, lengths, kv_len,
            score_scale, out_dtype, ring_kv, ring_n)
    n_rep = n_heads // n_kv
    if q.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise ValueError("the CUDA decode attention takes bf16 q and gives "
                         "bf16 out")
    if hd not in (64, 128) or n_rep > 8:
        raise ValueError(f"the CUDA decode attention takes head_dim 64 or "
                         f"128 and at most 8 query heads per kv head; got "
                         f"{hd} and {n_rep}")
    bufs = [k_codes, k_scale, v_codes, v_scale]
    shapes = [(B, n_kv, max_len, hd), (B, n_kv, max_len)] * 2
    R = 0
    if ring_n >= 0:
        R = ring_kv[0].shape[2]
        bufs += list(ring_kv)
        shapes += [(B, n_kv, R, hd), (B, n_kv, R)] * 2
    for t, shape, want in zip(bufs, shapes, (torch.int8, torch.float32) * 4):
        if tuple(t.shape) != shape:
            raise ValueError(f"a cache buffer is {tuple(t.shape)}, not {shape}")
        if not (t.is_cuda and t.dtype == want and t.is_contiguous()):
            raise ValueError("codes must be contiguous int8 and scales "
                             "contiguous f32 CUDA tensors")
        if want == torch.int8 and t.data_ptr() % 16:
            raise ValueError("code buffers must be 16-byte aligned")
    q = q.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    ring_ptrs = ([t.data_ptr() for t in ring_kv] if ring_n >= 0
                 else [None] * 4)
    out = torch.empty_like(q)
    _build.launch("decode_attention", "decode_attention_int8",
                  "pppppppppppiiiiiiiif",
                  q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
                  v_codes.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
                  *ring_ptrs, out.data_ptr(), B, n_kv, n_rep, hd, max_len,
                  kv_len, R, ring_n, float(score_scale))
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
