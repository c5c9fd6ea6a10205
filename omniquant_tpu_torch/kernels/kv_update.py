"""In-place KV-cache writes: whole prefilled sequences and one decode row per
slot.

Counterparts of ``omniquant_tpu/kernels/kv_update.py::kv_cache_prefill_write``
and ``kv_cache_write`` (its ``"rows"`` kind). JAX arrays are immutable, so
the JAX functions return aliased buffers; these update the cache tensors in
place and return them. On a CUDA tensor each call launches the hand-written
kernel in ``csrc/kv_update.cu`` (and raises if it cannot); on a CPU tensor
it runs the plain PyTorch version. A write whose slot or position lies
outside the cache is dropped, never clamped.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import _build


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
    """Plain version: cache[b, :, lengths[b]] = new[b] where in range."""
    keep = (lengths >= 0) & (lengths < cache.shape[2])
    b = torch.nonzero(keep).flatten()
    cache[b, :, lengths[b].long()] = new[b]
    return cache


def kv_cache_write(caches: Sequence[torch.Tensor],
                   news: Sequence[torch.Tensor],
                   lengths: torch.Tensor) -> tuple:
    """Write one new row per slot into each cache, in place ("rows" kind).

    caches: one or two (the K and the V cache), each (B, H, S, D) of one
    shape and dtype; news: each (B, H, D); lengths: (B,) int32, the position
    written for each slot. On the card one launch writes every cache.
    Returns the caches."""
    if len(caches) != len(news) or len(caches) not in (1, 2):
        raise ValueError("kv_cache_write takes one or two caches and as many "
                         "new-row tensors")
    shape = tuple(caches[0].shape)
    B, H, S, D = shape
    for cache, new in zip(caches, news):
        if tuple(cache.shape) != shape or tuple(new.shape) != (B, H, D):
            raise ValueError(f"new row {tuple(new.shape)} does not fit cache "
                             f"{tuple(cache.shape)}")
    if not caches[0].is_cuda:
        for cache, new in zip(caches, news):
            kv_cache_write_plain(cache, new, lengths)
        return tuple(caches)
    news = [new.contiguous() for new in news]
    if caches[-1].dtype != caches[0].dtype:
        raise ValueError("the caches must share a dtype")
    row_vecs = [_check_rows(c, n) for c, n in zip(caches, news)][0]
    lens = lengths.to(device=caches[0].device, dtype=torch.int32).contiguous()
    ptrs = [t.data_ptr() for pair in zip(news, caches) for t in pair]
    if len(caches) == 1:
        ptrs += ptrs  # the second pair is never read
    _build.launch("kv_update", "kv_write_rows", "pppppiiiii", *ptrs,
                  lens.data_ptr(), len(caches), B, H, S, row_vecs)
    kv_cache_write.launches += 1
    return tuple(caches)


kv_cache_write.launches = 0
