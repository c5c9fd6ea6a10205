"""The port's in-place KV-cache writes (plain versions on the CPU) against
the JAX package's Pallas kernels in interpret mode, and its (B, H, S) scale
planes against the JAX planes through ``scale_plane_view``: exact."""
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


def _plane_pair(B, H, S, seed):
    """The same random scales as a JAX (B, H, s8, 128) plane and a port
    (B, H, S) plane."""
    jplane = jkv.scale_plane_init(B, H, S)
    vals = _data(jplane.shape, seed)
    jplane = jplane + jnp.asarray(vals)
    tplane = torch.from_numpy(vals.reshape(B, H, -1)[:, :, :S].copy())
    return jplane, tplane


@pytest.mark.parametrize("S,lengths", [
    (1024, [1, 0, 1023]),
    # 1536 rounds the JAX plane up to 16 sublanes; positions past 1024
    (1536, [1100, 1535, 1023]),
    (1536, [1024, 5, 1534]),
])
def test_kv_cache_write_mixed_kinds_matches_jax(S, lengths):
    """int8 codes and scale planes ("rows" and "flat" kinds) in one call,
    compared through scale_plane_view: exact."""
    B, H, D = 3, 2, 128
    rng = np.random.default_rng(S)
    kc = rng.integers(-127, 127, (B, H, S, D)).astype(np.int8)
    kcn = rng.integers(-127, 127, (B, H, D)).astype(np.int8)
    ksn = _data((B, H), 7)
    jplane, tplane = _plane_pair(B, H, S, 8)
    lens = np.asarray(lengths, np.int32)
    want_c, want_s = jkv.kv_cache_write(
        (jnp.asarray(kc), jplane), (jnp.asarray(kcn), jnp.asarray(ksn)),
        jnp.asarray(lens))
    tc = torch.from_numpy(kc.copy())
    got_c, got_s = tkv.kv_cache_write(
        (tc, tplane), (torch.from_numpy(kcn), torch.from_numpy(ksn)),
        torch.from_numpy(lens))
    assert got_c is tc and got_s is tplane
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(
        tkv.scale_plane_view(got_s).numpy(),
        np.asarray(jkv.scale_plane_view(want_s, S)))


@pytest.mark.parametrize("span", [1, 4, 8])
def test_kv_cache_write_span_matches_jax(span):
    """K5 on int8 codes, bf16 rows and both scale planes in one call,
    against the JAX span kernel (codes, rows) and its one-hot plane write:
    exact, with positions up to S - span."""
    B, H, S, D = 4, 2, 64, 128
    rng = np.random.default_rng(span)
    kc = rng.integers(-127, 127, (B, H, S, D)).astype(np.int8)
    kcn = rng.integers(-127, 127, (B, H, span, D)).astype(np.int8)
    vb = _data((B, H, S, D), 9)
    vbn = _data((B, H, span, D), 10)
    ksn, vsn = _data((B, H, span), 11), _data((B, H, span), 12)
    jks, tks = _plane_pair(B, H, S, 13)
    jvs, tvs = _plane_pair(B, H, S, 14)
    lens = np.asarray([0, S - span, 17, 40], np.int32)
    want_c, want_v = jkv.kv_cache_write_span(
        (jnp.asarray(kc), jnp.asarray(vb, jnp.bfloat16)),
        (jnp.asarray(kcn), jnp.asarray(vbn, jnp.bfloat16)), jnp.asarray(lens))
    want_ks = jkv.scale_plane_write_span(jks, jnp.asarray(ksn),
                                         jnp.asarray(lens))
    want_vs = jkv.scale_plane_write_span(jvs, jnp.asarray(vsn),
                                         jnp.asarray(lens))
    bufs = (torch.from_numpy(kc.copy()),
            torch.from_numpy(vb).to(torch.bfloat16), tks, tvs)
    got = tkv.kv_cache_write_span(
        bufs, (torch.from_numpy(kcn), torch.from_numpy(vbn).to(torch.bfloat16),
               torch.from_numpy(ksn), torch.from_numpy(vsn)),
        torch.from_numpy(lens))
    assert all(g is b for g, b in zip(got, bufs))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(
        got[1].float().numpy(), np.asarray(want_v.astype(jnp.float32)))
    for g, w in ((got[2], want_ks), (got[3], want_vs)):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jkv.scale_plane_view(w, S)))
    # the port's scale_plane_write_span is the same write on a plane
    plane = _plane_pair(B, H, S, 13)[1]
    tkv.scale_plane_write_span(plane, torch.from_numpy(ksn),
                               torch.from_numpy(lens))
    assert torch.equal(plane, got[2])


def test_span_rows_outside_the_cache_are_dropped():
    """Rows of a span that fall at positions >= S or < 0 are dropped, the
    rest written: no clamp onto live rows."""
    B, H, S, D, span = 3, 2, 16, 8, 4
    cache = torch.from_numpy(_data((B, H, S, D), 15))
    plane = torch.from_numpy(_data((B, H, S), 16))
    before, before_p = cache.clone(), plane.clone()
    new = torch.from_numpy(_data((B, H, span, D), 17))
    new_p = torch.from_numpy(_data((B, H, span), 18))
    lengths = torch.tensor([S - 2, -2, 5], dtype=torch.int32)
    tkv.kv_cache_write_span((cache, plane), (new, new_p), lengths)
    want, want_p = before.clone(), before_p.clone()
    for b, base in enumerate(lengths.tolist()):
        for j in range(span):
            if 0 <= base + j < S:
                want[b, :, base + j] = new[b, :, j]
                want_p[b, :, base + j] = new_p[b, :, j]
    assert torch.equal(cache, want) and torch.equal(plane, want_p)
    assert torch.equal(cache[0, :, : S - 2], before[0, :, : S - 2])
    assert torch.equal(cache[1, :, 2:], before[1, :, 2:])
