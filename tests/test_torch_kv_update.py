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


# --------------------------------------------------------------------------
# csrc/kv_update.cu::write_rows_kernel (K4, K5) emulated thread by thread:
# plan_rows' unit sizes and grid, which thread loads which unit of which
# buffer (before it reads lengths), and which stores the range check keeps.

ROWS_BLOCK = 64  # csrc/kv_update.cu


def _plan_rows(row_bytes, srcs, dsts, B, H, span):
    """plan_rows: per buffer (units per row, log2 of the unit), log2 of the
    threads per (slot, head), grid. Takes no lengths."""
    bufs, units = [], 0
    for rb, src, dst in zip(row_bytes, srcs, dsts):
        if rb < 1:
            bufs.append((0, 0))
            continue
        bits, lg = rb | src | dst, 4
        while lg > 0 and bits & ((1 << lg) - 1):
            lg -= 1
        bufs.append((rb >> lg, lg))
        units = max(units, span * (rb >> lg))
    lg_lanes = 0
    while (1 << lg_lanes) < units:
        lg_lanes += 1
    return bufs, lg_lanes, (-(-(H << lg_lanes) // ROWS_BLOCK), B)


def _thread_loads(plan, H, span):
    """Every live thread's (slot, head, unit u) and its loads: (buffer,
    source unit) for each buffer whose run reaches u. Takes no lengths."""
    bufs, lg_lanes, (gx, gy) = plan
    for b in range(gy):
        for x in range(gx * ROWS_BLOCK):
            h = x >> lg_lanes
            if h >= H:
                continue
            u = x & ((1 << lg_lanes) - 1)
            loads = [(k, (b * H + h) * span * ru + u)
                     for k, (ru, _) in enumerate(bufs) if u < span * ru]
            yield b, h, u, loads


def _kept_stores(plan, H, S, span, lengths):
    """The stores the range check keeps: (buffer, source unit, cache
    unit); each thread stores only what it loaded."""
    bufs = plan[0]
    stores = []
    for b, h, u, loads in _thread_loads(plan, H, span):
        ln = int(lengths[b])
        t_lo = 0 if ln >= 0 else (span if ln <= -span else -ln)
        t_hi = 0 if ln >= S else (span if ln <= S - span else S - ln)
        for k, src in loads:
            ru = bufs[k][0]
            if t_lo * ru <= u < t_hi * ru:
                stores.append((k, src, ((b * H + h) * S + ln) * ru + u))
    return stores


def _emulate_rows(caches, news, lengths, span, addrs):
    """write_rows_kernel on numpy copies of ``caches`` (byte for byte);
    ``addrs`` are (source, cache) base addresses that set each unit."""
    B, H, S = caches[0].shape[:3]
    row_bytes = [int(np.prod(c.shape[3:], dtype=np.int64)) * c.itemsize
                 for c in caches]
    plan = _plan_rows(row_bytes, [a[0] for a in addrs],
                      [a[1] for a in addrs], B, H, span)
    out = [c.copy() for c in caches]
    flat_out = [o.reshape(-1).view(np.uint8) for o in out]
    flat_new = [np.ascontiguousarray(n).reshape(-1).view(np.uint8)
                for n in news]
    for k, src, dst in _kept_stores(plan, H, S, span, lengths):
        w = 1 << plan[0][k][1]
        flat_out[k][dst * w:(dst + 1) * w] = flat_new[k][src * w:(src + 1) * w]
    return out, plan


def _rows_case(span, seed):
    """int8 hd 128 rows, bf16 hd 128 rows, bf16 hd 64 rows and an f32 plane
    sharing (B, H, S), with their new rows (numpy; bf16 as float32 holding
    bf16 values)."""
    B, H, S = 8, 3, 24
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy(_data(shape, int(rng.integers(1 << 30)))).to(
            torch.bfloat16)

    caches = [torch.from_numpy(
        rng.integers(-127, 128, (B, H, S, 128)).astype(np.int8)),
        bf16((B, H, S, 128)), bf16((B, H, S, 64)),
        torch.from_numpy(_data((B, H, S), int(rng.integers(1 << 30))))]
    news = [torch.from_numpy(
        rng.integers(-127, 128, (B, H, span, 128)).astype(np.int8)),
        bf16((B, H, span, 128)), bf16((B, H, span, 64)),
        torch.from_numpy(_data((B, H, span), int(rng.integers(1 << 30))))]
    # before the cache, at its first and last rows, past it, across its
    # end, wholly before it, and two spans inside it
    lengths = np.asarray([-1, 0, S - 1, S, S - 2, -span, 5, S - span],
                         np.int32)
    return caches, news, lengths


def _as_bytes(t):
    """A tensor's bytes as numpy (bf16 through int16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


# source / cache base addresses: 16-byte aligned, then offsets that force
# units of 8, 2 and 1 byte on some buffers (cache rows stay aligned)
ALIGNED = [(0x1000, 0x9000)] * 4
OFFSET = [(0x1001, 0x9000), (0x1002, 0x9000), (0x1008, 0x9000),
          (0x1004, 0x9000)]


@pytest.mark.parametrize("addrs", [ALIGNED, OFFSET],
                         ids=["aligned", "offset"])
@pytest.mark.parametrize("span", [1, 3, 8])
def test_write_rows_emulation_matches_plain_and_jax(span, addrs):
    """The kernel's index map, emulated, writes what the plain versions
    write (rows dropped at both ends, a span across S), and what JAX's
    kv_cache_write / kv_cache_write_span (interpret mode) write for the
    slots whose rows all land inside the cache."""
    caches, news, lengths = _rows_case(span, 100 * span + len(addrs[0]))
    B, H, S = caches[0].shape[:3]
    got, plan = _emulate_rows([_as_bytes(c) for c in caches],
                              [_as_bytes(n) for n in news], lengths, span,
                              addrs)
    units = [lg for _, lg in plan[0]]
    assert units == ([4, 4, 4, 2] if addrs is ALIGNED else [0, 1, 3, 2])
    want = [c.clone() for c in caches]
    tl = torch.from_numpy(lengths)
    if span == 1:
        tkv.kv_cache_write(want, [n[:, :, 0] for n in news], tl)
    else:
        tkv.kv_cache_write_span(want, news, tl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, _as_bytes(w))
    # JAX on the slots whose span lies inside the cache; the others write
    # at 0 there and are not compared (JAX clamps where the port drops)
    inside = (lengths >= 0) & (lengths + span <= S)
    jl = jnp.asarray(np.where(inside, lengths, 0))
    jd = [jnp.asarray(caches[0].numpy()),
          jnp.asarray(caches[1].float().numpy(), jnp.bfloat16),
          jnp.asarray(caches[2].float().numpy(), jnp.bfloat16)]
    jn = [jnp.asarray(news[0].numpy()),
          jnp.asarray(news[1].float().numpy(), jnp.bfloat16),
          jnp.asarray(news[2].float().numpy(), jnp.bfloat16)]
    jplane = jkv.scale_plane_init(B, H, S)
    jplane = jplane.reshape(B, H, -1).at[:, :, :S].set(
        jnp.asarray(caches[3].numpy())).reshape(jplane.shape)
    if span == 1:
        jout = jkv.kv_cache_write(
            (*jd, jplane), (*(x[:, :, 0] for x in jn),
                            jnp.asarray(news[3].numpy()[:, :, 0])), jl)
    else:
        jout = (*jkv.kv_cache_write_span(tuple(jd), tuple(jn), jl),
                jkv.scale_plane_write_span(
                    jplane, jnp.asarray(news[3].numpy()), jl))
    jout = [np.asarray(jout[0]),
            np.asarray(jout[1].astype(jnp.float32)),
            np.asarray(jout[2].astype(jnp.float32)),
            np.asarray(jkv.scale_plane_view(jout[3], S))]
    mine = [got[0], got[1].view(np.uint16).astype(np.uint32) << 16,
            got[2].view(np.uint16).astype(np.uint32) << 16, got[3]]
    mine[1], mine[2] = mine[1].view(np.float32), mine[2].view(np.float32)
    assert inside.sum() >= 3
    for m, j in zip(mine, jout):
        np.testing.assert_array_equal(m[inside], j[inside])


@pytest.mark.parametrize("span", [1, 2, 3, 8, 33])
@pytest.mark.parametrize("row_bytes", [(128, 128, 4, 4), (256, 256, 0, 0),
                                       (128, 512, 96, 2), (12, 0, 0, 0)])
def test_write_rows_plan_covers_every_unit_once(span, row_bytes):
    """plan_rows' grid gives every unit of every buffer's runs exactly one
    load (no gap, no overlap), from threads that never read lengths; each
    thread's kept stores are its own loads, and together they land on the
    plain version's cache units."""
    B, H, S = 3, 5, 40
    n = sum(r > 0 for r in row_bytes)
    plan = _plan_rows(row_bytes, [0x100] * 4, [0x800] * 4, B, H, span)
    seen = {}
    for b, h, u, loads in _thread_loads(plan, H, span):
        for k, src in loads:
            assert (k, src) not in seen, (k, src)
            seen[(k, src)] = (b, h, u)
    for k, (ru, lg) in enumerate(plan[0][:n]):
        assert ru << lg == row_bytes[k]
        assert {s for kk, s in seen if kk == k} == set(range(B * H * span * ru))
    assert len(seen) == sum(B * H * span * ru for ru, _ in plan[0])
    lengths = np.asarray([-2, S - 1, 7], np.int32)
    stores = _kept_stores(plan, H, S, span, lengths)
    assert all((k, src) in seen for k, src, _ in stores)
    want = set()
    for k, (ru, _) in enumerate(plan[0][:n]):
        for b in range(B):
            for h in range(H):
                for t in range(span):
                    pos = int(lengths[b]) + t
                    if 0 <= pos < S:
                        for c in range(ru):
                            want.add((k, ((b * H + h) * span + t) * ru + c,
                                      ((b * H + h) * S + pos) * ru + c))
    assert set(stores) == want and len(stores) == len(want)
