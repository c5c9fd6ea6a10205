"""The port's in-place KV-cache writes (plain versions on the CPU) against
the JAX package's Pallas kernels in interpret mode: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.kernels import kv_update as jkv
from omniquant_tpu_torch.kernels import kv_update as tkv


def _data(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_write_matches_jax(dtype):
    B, H, S, D = 4, 2, 16, 128
    k, v = _data((B, H, S, D), 0), _data((B, H, S, D), 1)
    kn, vn = _data((B, H, D), 2), _data((B, H, D), 3)
    lengths = np.asarray([0, 15, 7, 8], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jkv.kv_cache_write(
        (jnp.asarray(k, jd), jnp.asarray(v, jd)),
        (jnp.asarray(kn, jd), jnp.asarray(vn, jd)), jnp.asarray(lengths))
    tk = torch.from_numpy(k).to(td)
    tv = torch.from_numpy(v).to(td)
    got = tkv.kv_cache_write((tk, tv), (torch.from_numpy(kn).to(td),
                                         torch.from_numpy(vn).to(td)),
                             torch.from_numpy(lengths))
    assert got[0] is tk and got[1] is tv  # updated in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


def test_kv_cache_prefill_write_matches_jax():
    B, H, S, D = 6, 2, 32, 128
    N, S_p = 3, 16
    cache, new = _data((B, H, S, D), 4), _data((N, H, S_p, D), 5)
    slots = np.asarray([4, 0, 2], np.int32)
    want = jkv.kv_cache_prefill_write(jnp.asarray(cache), jnp.asarray(new),
                                      jnp.asarray(slots))
    tc = torch.from_numpy(cache.copy())
    got = tkv.kv_cache_prefill_write(tc, torch.from_numpy(new),
                                     torch.from_numpy(slots))
    assert got is tc
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_out_of_range_writes_are_dropped():
    """A write at pos >= S (or a slot outside the cache) leaves the cache
    untouched rather than landing on a clamped row."""
    B, H, S, D = 2, 2, 8, 8
    cache = torch.from_numpy(_data((B, H, S, D), 6))
    before = cache.clone()
    tkv.kv_cache_write((cache,), (torch.zeros(B, H, D),),
                       torch.tensor([S, 3], dtype=torch.int32))
    assert torch.equal(cache[0], before[0])
    assert torch.equal(cache[1, :, 3], torch.zeros(H, D))
    tkv.kv_cache_prefill_write(cache, torch.ones(1, H, 4, D),
                               torch.tensor([B], dtype=torch.int32))
    assert torch.equal(cache[0], before[0])
