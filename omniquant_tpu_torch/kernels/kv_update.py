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

import math
import struct
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


def _lead(bhs: tuple, span) -> tuple:
    """The leading dims of a K4 (``span`` None) or K5 call's new rows."""
    return bhs[:2] if span is None else bhs[:2] + (span,)


def _check_buffers(caches, news, span) -> None:
    """Shapes of a K4/K5 call: 1..4 caches sharing (B, H, S), each a value
    cache (B, H, S, D) whose news are lead + (D,) or a plane (B, H, S) whose
    news are lead; lead is (B, H) for K4 (``span`` None) and (B, H, span)
    for K5."""
    if not 1 <= len(caches) == len(news) <= MAX_BUFFERS:
        raise ValueError(f"takes 1 to {MAX_BUFFERS} caches and as many "
                         "new-row tensors")
    bhs = tuple(caches[0].shape)[:3]
    for cache, new in zip(caches, news):
        _check_shape(tuple(cache.shape), new, bhs, _lead(bhs, span))


def _check_shape(shape: tuple, new, bhs: tuple, lead: tuple) -> None:
    if shape[:3] != bhs or new.shape != lead + shape[3:]:
        raise ValueError(f"new rows {tuple(new.shape)} do not fit cache "
                         f"{shape} (want {lead + shape[3:]})")


# csrc/kv_update.cu::RowArgs, kv_write_rows' one argument: 4 sources, 4
# caches, 4 row sizes in bytes (0: no buffer), lengths, B, H, S, span, as
# int64 (one bytes object costs the host less to pass than 17 scalars)
_ROW_ARGS = struct.Struct("17q")


def _row_args(caches, news, lengths, span) -> tuple:
    """Check a K4 (``span`` None) or K5 call on the card; return
    kv_write_rows' packed arguments and the tensors they point to that the
    caller must hold until the launch is queued.

    Every check that guards a wrong write: the shapes (as
    ``_check_buffers``, in the same single pass over the buffers that
    gathers the pointers: the host's time per call is most of a row
    write's cost), each cache contiguous, each new-rows tensor of its
    cache's dtype, all of them and ``lengths`` (B,) on one card, and each
    source below 2^31 elements (the kernel's source index is 32-bit). A
    new-rows tensor that is not contiguous is copied, and ``lengths`` made
    int32 where it is not."""
    n = len(caches)
    if not 1 <= n == len(news) <= MAX_BUFFERS:
        raise ValueError(f"takes 1 to {MAX_BUFFERS} caches and as many "
                         "new-row tensors")
    B, H, S = bhs = tuple(caches[0].shape)[:3]
    lead = _lead(bhs, span)
    span = 1 if span is None else span
    dev = caches[0].get_device()
    if dev < 0:
        raise ValueError("caches and new rows must all lie on one card")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 slots")
    args = [0] * (3 * MAX_BUFFERS)  # sources, caches, row bytes
    held = []
    for k in range(n):
        cache, new = caches[k], news[k]
        shape = tuple(cache.shape)
        _check_shape(shape, new, bhs, lead)
        if cache.get_device() != dev or new.get_device() != dev:
            raise ValueError("caches and new rows must all lie on one card")
        dtype = cache.dtype
        if new.dtype != dtype:
            raise ValueError(f"dtype mismatch: cache {dtype}, new "
                             f"{new.dtype}")
        if not cache.is_contiguous():
            raise ValueError("a cache must be contiguous (written in place)")
        if not new.is_contiguous():
            new = new.contiguous()
            held.append(new)
        row = math.prod(shape[3:])
        if B * H * span * row >= 1 << 31:
            raise ValueError("new rows of 2^31 elements or more")
        args[k] = new.data_ptr()
        args[MAX_BUFFERS + k] = cache.data_ptr()
        args[2 * MAX_BUFFERS + k] = row * dtype.itemsize
    if (lengths.dtype != torch.int32 or lengths.get_device() != dev
            or not lengths.is_contiguous()):
        lengths = lengths.to(device=caches[0].device,
                             dtype=torch.int32).contiguous()
        held.append(lengths)
    if lengths.dim() != 1 or len(lengths) != B:
        raise ValueError(f"lengths {tuple(lengths.shape)} for {B} slots")
    return _ROW_ARGS.pack(*args, lengths.data_ptr(), B, H, S, span), held


def _launch_rows(caches, news, lengths, span) -> None:
    """One launch of csrc/kv_update.cu's row writer over every buffer."""
    args, _held = _row_args(caches, news, lengths, span)
    _build.launch("kv_update", "kv_write_rows", "b", args)


def kv_cache_write(caches: Sequence[torch.Tensor],
                   news: Sequence[torch.Tensor],
                   lengths: torch.Tensor) -> tuple:
    """Write one new row per slot into each cache, in place.

    caches: 1 to 4 tensors sharing (B, H, S): value caches (B, H, S, D),
    whose news are (B, H, D) (the "rows" kind), and scale planes (B, H, S),
    whose news are (B, H) (the "flat" kind); lengths: (B,) int32, the
    position written for each slot. On the card one launch writes every
    cache (a (B, H, D) row is a span of one row in memory). Returns the
    caches."""
    if caches and not caches[0].is_cuda:
        _check_buffers(caches, news, None)
        for cache, new in zip(caches, news):
            kv_cache_write_plain(cache, new, lengths)
        return tuple(caches)
    _launch_rows(caches, news, lengths, None)
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
    if caches and not caches[0].is_cuda:
        _check_buffers(caches, news, span)
        for cache, new in zip(caches, news):
            kv_cache_write_span_plain(cache, new, lengths)
        return tuple(caches)
    _launch_rows(caches, news, lengths, span)
    kv_cache_write_span.launches += 1
    return tuple(caches)


kv_cache_write_span.launches = 0
