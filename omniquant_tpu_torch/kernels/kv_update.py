"""In-place KV-cache writes: whole prefilled sequences, one decode row per
slot, and a span of contiguous rows per slot; plus the per-token scale
planes of an int8 cache.

Counterparts of ``omniquant_tpu/kernels/kv_update.py::kv_cache_prefill_write``
(K3), ``kv_cache_write`` (K4, both its ``"rows"`` and ``"flat"`` kinds) and
``kv_cache_write_span`` (K5). JAX arrays are immutable, so the JAX functions
return aliased buffers; these update the cache tensors in place and return
them. On a CUDA tensor each call launches the hand-written kernel in
``csrc/kv_update.cu`` (and raises if it cannot); on a CPU tensor it runs the
plain PyTorch version. A row whose slot or position lies outside the cache
is dropped, never clamped.

Scale planes: the JAX package stores an int8 cache's per-token f32 scales
as (B, H, s8, 128) planes, a tiling that exists only for TPU DMA; here a
plane is (B, H, max_len) f32, holding the values of JAX's
``scale_plane_view(plane)[..., :max_len]``. K4 and K5 take planes beside
the value caches (a plane row is one f32), so one launch writes the K and V
codes and both planes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import _build

MAX_BUFFERS = 4  # K and V codes, K and V scale planes


def _check_rows(cache: torch.Tensor, new: torch.Tensor) -> int:
    """Validate a CUDA copy into ``cache`` (``new`` already contiguous);
    returns the number of 16-byte vectors a row of head_dim elements takes."""
    if not (cache.is_cuda and new.is_cuda):
        raise ValueError("cache and new rows must both lie on the card")
    if cache.dtype != new.dtype:
        raise ValueError(f"dtype mismatch: cache {cache.dtype}, new {new.dtype}")
    if not cache.is_contiguous():
        raise ValueError("the cache must be contiguous (it is written in place)")
    row_bytes = cache.shape[-1] * cache.element_size()
    if row_bytes % 16 or cache.data_ptr() % 16 or new.data_ptr() % 16:
        raise ValueError("rows must be whole, aligned 16-byte vectors")
    return row_bytes // 16


def scale_plane_init(B: int, H: int, S: int, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """A zeroed per-token scale plane, (B, H, S)."""
    return torch.zeros((B, H, S), dtype=dtype, device=device)


def scale_plane_view(plane: torch.Tensor, kv_len: int = None) -> torch.Tensor:
    """(B, H, S) plane -> its (B, H, kv_len) window."""
    return plane if kv_len is None else plane[:, :, :kv_len]


def kv_cache_prefill_write_plain(cache: torch.Tensor, new: torch.Tensor,
                                 slots: torch.Tensor) -> torch.Tensor:
    """Plain version: cache[slots[n], :, :S_p] = new[n], in place."""
    keep = (slots >= 0) & (slots < cache.shape[0])
    cache[slots[keep].long(), :, : new.shape[2]] = new[keep]
    return cache


def kv_cache_prefill_write(cache: torch.Tensor, new: torch.Tensor,
                           slots: torch.Tensor) -> torch.Tensor:
    """Write N prefilled sequences into their cache slots, in place.

    cache: (B, H, S, D); new: (N, H, S_p, D), S_p <= S, lands at
    cache[slot, :, :S_p, :]; slots: (N,) int32. Returns ``cache``."""
    N, H, S_p, _ = new.shape
    B, Hc, S, _ = cache.shape
    if H != Hc or S_p > S:
        raise ValueError(f"new {tuple(new.shape)} does not fit cache "
                         f"{tuple(cache.shape)}")
    if not cache.is_cuda:
        return kv_cache_prefill_write_plain(cache, new, slots)
    new = new.contiguous()
    row_vecs = _check_rows(cache, new)
    slots = slots.to(device=cache.device, dtype=torch.int32).contiguous()
    _build.launch("kv_update", "kv_prefill_write", "pppiiiiii",
                  new.data_ptr(), cache.data_ptr(), slots.data_ptr(),
                  N, H, S, S_p, B, row_vecs)
    kv_cache_prefill_write.launches += 1
    return cache


kv_cache_prefill_write.launches = 0


def kv_cache_write_plain(cache: torch.Tensor, new: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: cache[b, :, lengths[b]] = new[b] where in range; a
    value row (cache (B, H, S, D), new (B, H, D)) or a plane entry (cache
    (B, H, S), new (B, H))."""
    keep = (lengths >= 0) & (lengths < cache.shape[2])
    b = torch.nonzero(keep).flatten()
    cache[b, :, lengths[b].long()] = new[b]
    return cache


def kv_cache_write_span_plain(cache: torch.Tensor, new: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: cache[b, :, lengths[b] + j] = new[b, :, j] for each
    j < span where that position is in range; new (B, H, span, D) for a
    value cache, (B, H, span) for a plane."""
    for j in range(new.shape[2]):
        kv_cache_write_plain(cache, new[:, :, j], lengths + j)
    return cache


# ``omniquant_tpu/kernels/kv_update.py::scale_plane_write_span`` is a
# one-hot XLA write of a span into a plane; here it is the plain span write
scale_plane_write_span = kv_cache_write_span_plain


def _check_buffers(caches, news, span: int) -> None:
    """Shapes of a K4/K5 call: 1..4 caches sharing (B, H, S), each a value
    cache (B, H, S, D) with news (B, H, span, D) or a plane (B, H, S) with
    news (B, H, span)."""
    if not 1 <= len(caches) == len(news) <= MAX_BUFFERS:
        raise ValueError(f"takes 1 to {MAX_BUFFERS} caches and as many "
                         "new-row tensors")
    B, H, S = caches[0].shape[:3]
    for cache, new in zip(caches, news):
        want = (B, H, span) + tuple(cache.shape[3:])
        if tuple(cache.shape[:3]) != (B, H, S) or tuple(new.shape) != want:
            raise ValueError(f"new rows {tuple(new.shape)} do not fit cache "
                             f"{tuple(cache.shape)} (span {span})")


def _launch_rows(caches, news, lengths, span: int) -> None:
    """One launch of csrc/kv_update.cu's row writer over every buffer."""
    B, H, S = caches[0].shape[:3]
    news = [new.contiguous() for new in news]
    for cache, new in zip(caches, news):
        if not (cache.is_cuda and new.is_cuda):
            raise ValueError("caches and new rows must all lie on the card")
        if cache.dtype != new.dtype:
            raise ValueError(f"dtype mismatch: cache {cache.dtype}, new "
                             f"{new.dtype}")
        if not cache.is_contiguous():
            raise ValueError("a cache must be contiguous (written in place)")
    n = len(caches)
    pad = [0] * (MAX_BUFFERS - n)
    srcs = (ctypes.c_void_p * MAX_BUFFERS)(
        *[t.data_ptr() for t in news], *pad)
    dsts = (ctypes.c_void_p * MAX_BUFFERS)(
        *[t.data_ptr() for t in caches], *pad)
    row_bytes = (ctypes.c_int * MAX_BUFFERS)(
        *[math.prod(c.shape[3:]) * c.element_size() for c in caches], *pad)
    lens = lengths.to(device=caches[0].device, dtype=torch.int32).contiguous()
    _build.launch("kv_update", "kv_write_rows", "pppipiiii",
                  ctypes.addressof(srcs), ctypes.addressof(dsts),
                  ctypes.addressof(row_bytes), n, lens.data_ptr(), B, H, S,
                  span)


def kv_cache_write(caches: Sequence[torch.Tensor],
                   news: Sequence[torch.Tensor],
                   lengths: torch.Tensor) -> tuple:
    """Write one new row per slot into each cache, in place.

    caches: 1 to 4 tensors sharing (B, H, S): value caches (B, H, S, D),
    whose news are (B, H, D) (the "rows" kind), and scale planes (B, H, S),
    whose news are (B, H) (the "flat" kind); lengths: (B,) int32, the
    position written for each slot. On the card one launch writes every
    cache. Returns the caches."""
    spans = [new.unsqueeze(2) for new in news]
    _check_buffers(caches, spans, 1)
    if not caches[0].is_cuda:
        for cache, new in zip(caches, news):
            kv_cache_write_plain(cache, new, lengths)
        return tuple(caches)
    _launch_rows(caches, spans, lengths, 1)
    kv_cache_write.launches += 1
    return tuple(caches)


kv_cache_write.launches = 0


def kv_cache_write_span(caches: Sequence[torch.Tensor],
                        news: Sequence[torch.Tensor],
                        lengths: torch.Tensor) -> tuple:
    """Write ``span`` contiguous rows per slot into each cache, in place.

    caches: as for ``kv_cache_write``; news: (B, H, span, D) for a value
    cache, (B, H, span) for a plane. Row j of slot b lands at position
    lengths[b] + j, or is dropped where that lies outside [0, S). On the
    card one launch writes every cache. Returns the caches."""
    span = news[0].shape[2]
    _check_buffers(caches, news, span)
    if not caches[0].is_cuda:
        for cache, new in zip(caches, news):
            kv_cache_write_span_plain(cache, new, lengths)
        return tuple(caches)
    _launch_rows(caches, news, lengths, span)
    kv_cache_write_span.launches += 1
    return tuple(caches)


kv_cache_write_span.launches = 0
