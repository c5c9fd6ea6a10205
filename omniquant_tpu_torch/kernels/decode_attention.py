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
``csrc/decode_attention.cu`` (bf16 q and output, head_dim 64, 80 or 128,
any number of query heads per kv head) or raises; the kernel reads only the
live part of each slot's window and never dequantizes the cache. It splits
the window into spans per ``decode_attention_plan`` (one CTA a span, kv
head, group of up to 8 query heads and slot; the ring a split of its own)
and merges the spans' partial softmax sums in the same launch, in split
order. On a CPU tensor it runs the plain version, which dequantizes in f32
and attends densely.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .quant_matmul import _device_buffer, _sm_count

_NEG = -1e30
_THREADS = 128  # threads of a CTA of csrc/decode_attention.cu
_GROUP = 8      # query heads a CTA holds (MAX_REP there)
_K6_CTAS: dict = {}       # (device, hd, rep class) -> CTAs an SM holds
_K6_WORKSPACE: dict = {}  # device -> f32 partials, grown
_K6_TICKETS: dict = {}    # device -> int32 tickets, zeroed once, grown


def head_groups(n_rep: int) -> Tuple[int, int]:
    """(groups, heads a group holds) of a kv head's n_rep query heads: one
    group of n_rep up to 8, else ceil(n_rep / 8) groups of 8, the last
    masked."""
    cap = min(n_rep, _GROUP)
    return -(-n_rep // cap), cap


def rep_class(n_rep: int) -> int:
    """The kernel instance (its REP) for n_rep >= 1 query heads a kv head:
    the least of 1, 2, 4 and 8 that holds them, 8 above (head groups)."""
    if n_rep < 1:
        raise ValueError(f"n_rep must be at least 1, not {n_rep}")
    return min(_GROUP, 1 << (n_rep - 1).bit_length())


class DecodeAttnPlan(NamedTuple):
    """How K6 cuts a window of ``kv_len`` positions: ``win_splits`` spans
    of ``per`` positions (the last may be shorter), a multiple of the
    kernel's ``chunk`` of rows, one CTA each per (kv head, head group,
    slot); the ring, when there is one, is one more split, merged last."""
    chunk: int
    per: int
    win_splits: int
    ring: bool

    @property
    def splits(self) -> int:
        return self.win_splits + int(self.ring)

    def spans(self, kv_len: int) -> list:
        """(first position, end position) of each window split."""
        return [(s * self.per, min((s + 1) * self.per, kv_len))
                for s in range(self.win_splits)]


_HEAD_DIMS = (64, 80, 128)  # the kernel's instances


def decode_chunk(hd: int) -> int:
    """Rows of one ring stage of the kernel: 64 at hd 128, 128 at hd 64
    and 80 (two lanes score a K row at hd 128, one at hd 64 and 80: the
    kernel's ``lanes_per_k_row``)."""
    return _THREADS // (2 if hd == 128 else 1)


class DecodeGeometry(NamedTuple):
    """``csrc/decode_attention.cu``'s ``Geo<HD, REP>``: rows a chunk, lanes
    scoring a K row, the K row stride in bytes, lanes taking a V row and
    V rows a warp step in P.V, and the shared memory of the instance
    (``decode_attention_info`` reports the kernel's)."""
    chunk: int
    k_lanes: int
    k_stride: int
    v_lanes: int
    v_rows: int
    smem: int


def decode_geometry(hd: int, rep: int) -> DecodeGeometry:
    """The kernel's geometry at head_dim ``hd`` (64, 80 or 128) and ``rep``
    query heads a CTA (its instance, ``rep_class``). K rows are an odd
    number of 16-byte pieces (free of bank conflicts for the 16-byte reads
    of a quarter warp); at hd 80 a V row takes 20 lanes, the other 12 of
    the warp repeat lanes 0..11 and are never stored."""
    chunk = decode_chunk(hd)
    k_stride = hd if (hd // 16) % 2 else hd + 16
    v_lanes = hd // 4
    stage = chunk * (k_stride + hd + 8)  # K and V codes, both scales
    smem = 2 * stage + rep * (hd + 8) * 4 + 16  # 2 stages, q in f32, flag
    return DecodeGeometry(chunk, _THREADS // chunk, k_stride, v_lanes,
                          32 // v_lanes, smem)


def decode_attention_plan(kv_len: int, B: int, n_kv: int, R: int, hd: int,
                          sm_count: int, ctas_per_sm: int,
                          n_rep: int) -> DecodeAttnPlan:
    """K6's split of a ``kv_len`` window for B slots of n_kv kv heads of
    n_rep query heads each (``head_groups`` CTAs a kv head) and a ring of
    R rows (0: none) on a card of ``sm_count`` SMs that hold
    ``ctas_per_sm`` CTAs each. A pure function of the shapes: it never
    reads ``lengths`` (splits past a slot's live positions leave at once
    on the device), so planning needs no host synchronisation.

    Spans are a power of two times the chunk. It takes the longest span
    (the fewest splits: each costs a partial and its share of the merge)
    whose CTAs, were every window full, still give each of the card's CTA
    slots (SMs x CTAs an SM holds) one. Fit to the card's times of every
    span at chip_smoke.py's five cases (NVIDIA H100 80GB HBM3): one split
    at batch 32 with windows 256 and 512, four at batch 8 with 2048."""
    chunk = decode_chunk(hd)
    kv_len = max(kv_len, 1)
    split_ctas = B * n_kv * head_groups(n_rep)[0]
    per = chunk
    while per < kv_len:
        per *= 2
    while (per > chunk
           and split_ctas * -(-kv_len // per) < sm_count * ctas_per_sm):
        per //= 2
    return DecodeAttnPlan(chunk, per, -(-kv_len // per), R > 0)


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
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the CUDA decode attention takes head_dim 64, 80 "
                         f"or 128, not {hd}")
    bufs = [k_codes, k_scale, v_codes, v_scale]
    shapes = [(B, n_kv, max_len, hd), (B, n_kv, max_len)] * 2
    R = ring_kv[0].shape[2] if ring_n >= 0 else 0
    if ring_n >= 0:
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
    plan = decode_attention_launch(q.device, kv_len, B, n_kv, n_rep, hd, R)
    q = q.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    ring_ptrs = ([t.data_ptr() for t in ring_kv] if ring_n >= 0
                 else [None] * 4)
    # with more than one split the partials go to the device's workspace
    # and the merge takes the (slot, kv head, head group)'s ticket, which
    # the merging CTA leaves zeroed: no call launches a memset
    ws = tickets = None
    if plan.win_splits + (ring_n >= 0) > 1:
        groups, cap = head_groups(n_rep)
        ws = _device_buffer(
            _K6_WORKSPACE, q.device,
            B * n_kv * groups * (plan.win_splits + 1) * cap * (hd + 2),
            torch.float32).data_ptr()
        tickets = _device_buffer(_K6_TICKETS, q.device,
                                 B * n_kv * groups).data_ptr()
    out = torch.empty_like(q)
    _build.launch("decode_attention", "decode_attention_int8",
                  "p" * 13 + "iiiiiiiiii" + "f",
                  q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
                  v_codes.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
                  *ring_ptrs, out.data_ptr(), ws, tickets, B, n_kv, n_rep,
                  hd, max_len, kv_len, R, ring_n, plan.per, plan.win_splits,
                  float(score_scale))
    _build.count(decode_attention_int8, "launches")
    return out


def _decode_info(hd: int, n_rep: int, ctas: bool) -> int:
    """The kernel's shared memory for hd and n_rep, or (``ctas``) the CTAs
    of it an SM holds, from ``csrc/decode_attention.cu`` (the card's
    occupancy)."""
    n = _build.fn("decode_attention", "decode_attention_info", "iii")(
        hd, n_rep, int(ctas), None)
    if n < 1:
        raise RuntimeError(f"decode_attention: info query failed ({n})")
    return n


def _decode_ctas(device, hd: int, n_rep: int) -> int:
    """``_decode_info``'s CTAs per SM, asked of the card once per instance
    (``rep_class``)."""
    rep = rep_class(n_rep)
    key = (device.index or 0, hd, rep)
    if key not in _K6_CTAS:
        _K6_CTAS[key] = _decode_info(hd, rep, True)
    return _K6_CTAS[key]


def decode_attention_launch(device, kv_len: int, B: int, n_kv: int,
                            n_rep: int, hd: int, R: int) -> DecodeAttnPlan:
    """The plan K6 runs on ``device``'s card for these shapes (R ring rows,
    0 for none)."""
    return decode_attention_plan(kv_len, B, n_kv, R, hd, _sm_count(device),
                                 _decode_ctas(device, hd, n_rep), n_rep)


decode_attention_int8.launches = 0
