"""The port's integer-activation path (W4A4 / W6A6) against the JAX
package's on numpy-seeded inputs, on the CPU: ``quantize_act_int`` bit for
bit, K8's plain version exactly (its codes K-major, JAX's transposed), K9's
operands (xsum, sc, off2) bit for bit, K7's and K9's plain versions
(through the public functions) against the Pallas kernels in interpret
mode, the route each call takes, the per-element rule the card holds K7 and
K9 to, and numpy emulations of K7's, K8's and K9's index math and of K7's
split plan (the kernels in ``csrc/quant_matmul_int.cu`` run only on the
card).

Tolerance of the products: both sides evaluate the same algebra in f32
(exact int dots, then f32 sums of dot * sc and xsum * off2 over the groups,
times the per-token scale) in orders that differ only inside XLA's and
PyTorch's dots, so rtol 1e-5 plus 1e-6 of the largest output."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import common as jcommon
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import pack_weight as j_pack_weight
from omniquant_tpu_torch.kernels import quant_matmul as tqm
from omniquant_tpu_torch.kernels import tolerance
from omniquant_tpu_torch.models import common as tcommon
from omniquant_tpu_torch.quant import QuantConfig as TQuantConfig
from omniquant_tpu_torch.utils.convert import from_jax_params

jqm = importlib.import_module("omniquant_tpu.kernels.quant_matmul")


def packed_pair(bits, group_size, out_f, in_f, layout, bias=False, seed=0,
                tile_k=None):
    """A JAX PackedWeight and the same carried into the port."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32) * 0.5
    b = rng.standard_normal(out_f).astype(np.float32) if bias else None
    jw = j_pack_weight(jnp.asarray(w), JQuantConfig(n_bits=bits,
                                                    group_size=group_size),
                       bias=None if b is None else jnp.asarray(b),
                       layout=layout, tile_k=tile_k)
    return jw, from_jax_params(jw, device="cpu")


def acts(abits):
    return (JQuantConfig(n_bits=abits, symmetric=False),
            TQuantConfig(n_bits=abits, symmetric=False))


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("abits", [4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_int_bit_exact(abits, dtype):
    """Codes and scales equal JAX's bit for bit, computed in x's dtype:
    random rows, a row of equal values (zero range: the CLIPMIN scale, a
    zero point clamped at -1e4, so the code saturates at 127 as XLA's int8
    conversion does) and rows whose x / scale lands exactly on halves
    (round half to even)."""
    q = 2 ** abits - 1
    x = np.random.default_rng(abits).standard_normal((5, 96)) * 3
    x[1] = 0.75
    x[2] = np.arange(96) % (q + 1)           # range [0, q]: scale 1
    x[2, 10:20] = np.arange(10) + 0.5        # exact ties
    x[3] = -x[2]
    jcfg, tcfg = acts(abits)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jc, js = jqm.quantize_act_int(jx, jcfg)
    tc, ts = tqm.quantize_act_int(tx, tcfg)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.abs(np.delete(tc.numpy(), 1, axis=0)).max() <= q
    assert (tc.numpy()[1] == 127).all()


@pytest.mark.parametrize("bits,layout", [
    (2, "planar"), (3, "planar"), (4, "planar"), (6, "planar"),
    (8, "planar"), (2, "pairs"), (3, "pairs"), (4, "pairs")])
def test_unpack_to_int8_exact(bits, layout):
    """K8's plain version equals the JAX kernel's codes transposed, K-major
    (N, k_pad), for every layout and width, with in_features padded up to
    the pack tile."""
    gs = 128 if bits != 8 else None
    jw, tw = packed_pair(bits, gs, 256, 640, layout, seed=bits)
    want = jqm._unpack_to_int8(jw.qweight, jnp.zeros((1, 1), jnp.int32),
                               bits, jw.tile_k, layout, True)
    got = tqm._unpack_to_int8(tw)
    assert got.dtype == torch.int8 and got.shape == (256, tw.k_pad)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
    assert tqm._unpack_to_int8.launches == 0  # no kernel on a CPU tensor


@pytest.mark.parametrize("bits,group_size,abits", [
    (2, 128, 4), (3, 64, 4), (4, 32, 4), (6, 128, 6), (6, None, 6),
    (8, None, 4), (4, 64, 6), (3, 128, 6)])
def test_fused_int_matches_jax(bits, group_size, abits):
    """Small m, planar: K7's plain version through ``quant_matmul_int``
    against the JAX kernel; 3-D input, K 640 packed to a padded k_pad."""
    jw, tw = packed_pair(bits, group_size, 256, 640, "planar",
                         seed=10 * bits + abits)
    assert tw.k_pad > 640
    x = np.random.default_rng(abits).standard_normal((2, 5, 640)).astype(
        np.float32)
    jcfg, tcfg = acts(abits)
    assert tqm.int_route(10, tw, tcfg) == "fused"
    want = np.asarray(jqm.quant_matmul_int(jnp.asarray(x), jw, jcfg,
                                           interpret=True))
    got = tqm.quant_matmul_int(torch.from_numpy(x), tw, tcfg)
    assert got.shape == (2, 5, 256)
    assert_close(got.numpy(), want)
    assert tqm.quant_matmul_int.launches == 0


def test_fused_int_bias_through_linear():
    """models.common.linear takes the integer path for a PackedWeight with
    an enabled act quantizer (it raised before the path was ported), and
    adds the bias after the product in x's dtype, as JAX does."""
    jw, tw = packed_pair(6, 64, 128, 256, "planar", bias=True, seed=3)
    x = np.random.default_rng(4).standard_normal((3, 256)).astype(np.float32)
    spec_j = jcommon.ActQuantSpec.from_bits(6)
    spec_t = tcommon.ActQuantSpec.from_bits(6)
    want = np.asarray(jcommon.linear(jnp.asarray(x), jw, spec_j.act))
    got = tcommon.linear(torch.from_numpy(x), tw, spec_t.act)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("bits,group_size,layout,tile_k", [
    (4, 32, "planar", 32), (4, 32, "pairs", None), (3, 32, "pairs", None),
    (6, 32, "planar", 32), (4, None, "planar", 32), (4, 128, "pairs", None),
    (6, 128, "planar", None)])
def test_dense_int_matches_jax(bits, group_size, layout, tile_k):
    """K8 + K9's plain versions through ``_quant_matmul_int_dense`` against
    the JAX route called directly, as its own test calls it: both layouts,
    grouped and per channel, K padded up to the pack tile."""
    in_f = 160 if group_size != 128 else 640
    jw, tw = packed_pair(bits, group_size, 128, in_f, layout, seed=50 + bits,
                         tile_k=tile_k)
    x = np.random.default_rng(7).standard_normal((40, in_f)).astype(
        np.float32)
    jcfg, tcfg = acts(4)
    want = np.asarray(jqm._quant_matmul_int_dense(jnp.asarray(x), jw, jcfg,
                                                  True))
    got = tqm._quant_matmul_int_dense(torch.from_numpy(x), tw, tcfg)
    assert_close(got.numpy(), want)
    assert tqm._quant_matmul_int_dense.launches == 0


def _jax_route(monkeypatch, x, jw, jcfg):
    seen = []

    def spy(name):
        def f(*a, **k):
            seen.append(name)
            return jnp.zeros(x.shape[:-1] + (jw.qweight.shape[1],))
        return f

    monkeypatch.setattr(jqm, "_quant_matmul_int_dense", spy("dense"))
    monkeypatch.setattr(jqm, "_qmm_int_call", spy("fused"))
    monkeypatch.setattr(jqm, "quant_matmul", spy("fake_quant"))
    jqm.quant_matmul_int(x, jw, jcfg, interpret=True)
    monkeypatch.undo()
    return seen


def _port_route(monkeypatch, x, tw, tcfg):
    seen = []

    def spy(name):
        def f(*a, **k):
            seen.append(name)
            return torch.zeros(x.shape[:-1] + (tw.qweight.shape[1],))
        return f

    monkeypatch.setattr(tqm, "_quant_matmul_int_dense", spy("dense"))
    monkeypatch.setattr(tqm, "quant_matmul_int_plain", spy("fused"))
    monkeypatch.setattr(tqm, "quant_matmul", spy("fake_quant"))
    tqm.quant_matmul_int(x, tw, tcfg)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("act", ["a4", "a6", "a8", "a4_grouped", "a16",
                                 "fix0to1"])
@pytest.mark.parametrize("layout,out_f", [("planar", 128), ("pairs", 128),
                                          ("planar", 192)])
def test_routes_match_jax(monkeypatch, act, layout, out_f):
    """For m on both sides of the dense threshold (1, 2047, 2048), the
    route of every call equals JAX's, fallbacks included: 8-bit and grouped
    activation quantizers, N % 128 != 0 and pairs weights at small m take
    fake-quant + K1."""
    kw = {"a4": dict(n_bits=4), "a6": dict(n_bits=6), "a8": dict(n_bits=8),
          "a4_grouped": dict(n_bits=4, group_size=32),
          "a16": dict(n_bits=16), "fix0to1": dict(n_bits=4,
                                                  metric="fix0to1")}[act]
    jcfg = JQuantConfig(symmetric=False, **kw)
    tcfg = TQuantConfig(symmetric=False, **kw)
    jw, tw = packed_pair(4, 32, out_f, 64, layout, seed=1)
    for m in (1, 2047, 2048):
        x = np.zeros((m, 64), np.float32)
        want = _jax_route(monkeypatch, jnp.asarray(x), jw, jcfg)
        got = _port_route(monkeypatch, torch.from_numpy(x), tw, tcfg)
        assert got == want == [tqm.int_route(m, tw, tcfg)], (m, got, want)


def _emulate_int_kernel(xc, xs, w8, pw, splits, fault=None):
    """K7's arithmetic in PyTorch: per split-K slice of the pack tiles, per
    group: exact int dot (f32 here: integers below 2^24), accf += dot * sc
    + xsum * off2 with off2 rounded through bf16 as the kernel forms it;
    the slices added in order, times xs, rounded to bf16. ``fault`` plants a
    bug: "lost_group" skips the third group, "no_off2" leaves the offset
    term out, "xs_twice" applies the per-token scale twice."""
    k_pad = w8.shape[1]
    xc = torch.nn.functional.pad(xc, (0, k_pad - xc.shape[1])).float()
    gs = pw.group_size or pw.tile_k
    n_tiles = k_pad // pw.tile_k
    sc = pw.scales.float().t()
    z = pw.zeros.float().t()
    half = 2.0 ** (pw.bits - 1)
    off2 = ((half - z).bfloat16().float() * sc).bfloat16().float()
    total = torch.zeros(xc.shape[0], w8.shape[0])
    for s in range(splits):
        accf = torch.zeros_like(total)
        for t in range(s * n_tiles // splits, (s + 1) * n_tiles // splits):
            for g in range(t * pw.tile_k // gs, (t + 1) * pw.tile_k // gs):
                if fault == "lost_group" and g == 2:
                    continue
                rows = slice(g * gs, (g + 1) * gs)
                gi = min(g, sc.shape[0] - 1)
                dot = xc[:, rows] @ w8[:, rows].float().t()
                term = dot * sc[gi]
                if fault != "no_off2":
                    term = term + xc[:, rows].sum(-1, keepdim=True) * off2[gi]
                accf = accf + term
        total = total + accf
    scale = xs * xs if fault == "xs_twice" else xs
    return (total * scale).bfloat16()


@pytest.mark.parametrize("fault", [None, "lost_group", "no_off2",
                                   "xs_twice"])
def test_card_tolerance_admits_rounding_and_rejects_faults(fault):
    """The rule the card holds K7 and K9 to (2 bf16 ulps of each element
    plus 2^-14 of xs * sum_g (|dot_g| sc_g + |xsum_g off2_g|)) admits the
    kernels' arithmetic (3 split-K slices, bf16 scales and zeros) and
    rejects a lost group, a missing offset term and xs applied twice, on a
    W6A6 projection with K = 1536 (12 groups)."""
    jw, tw = packed_pair(6, 128, 256, 1536, "planar", seed=9)
    tw = tw.map_tensors(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (8, 1536)).astype(np.float32)).to(torch.bfloat16)
    xc, xs = tqm.quantize_act_int(x, TQuantConfig(n_bits=6))
    want, mag = tqm.quant_matmul_int_plain(xc, xs, tw, magnitude=True)
    w8 = tqm.unpack_to_int8_plain(tw)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jqm._unpack_to_int8(
        jw.qweight, jnp.zeros((1, 1), jnp.int32), 6, jw.tile_k, "planar",
        True)).T)
    got = _emulate_int_kernel(xc, xs, w8, tw, splits=3, fault=fault)
    ok, _, worst = tolerance.bf16_close(
        got, want, tolerance.INT_MATMUL_SLACK * mag)
    assert ok == (fault is None), worst


def _jax_dense_operands(x, jw, jcfg):
    """What JAX's ``_quant_matmul_int_dense`` forms outside its kernel
    (omniquant_tpu/kernels/quant_matmul.py:698-736), rebuilt with jnp: the
    codes padded to k_pad, the per-group code sums (m, n_groups) and the
    scale and off2 slabs, flattened from (tile, group of the tile, N) to
    (n_groups, N)."""
    xc, _ = jqm.quantize_act_int(x, jcfg)
    m = xc.shape[0]
    k_pad, n = jw.k_pad, jw.qweight.shape[1]
    xc = jnp.pad(xc, ((0, 0), (0, k_pad - xc.shape[1])))
    gs = jw.group_size or jw.tile_k
    n_g = jw.tile_k // gs
    nk = k_pad // jw.tile_k
    scales_t = jw.scales.T.astype(jnp.float32)
    off2_t = ((2 ** (jw.bits - 1) - jw.zeros) * jw.scales).T.astype(
        jnp.float32)

    def to_slabs(a):
        if jw.group_size:
            if a.shape[0] < nk * n_g:
                a = jnp.concatenate(
                    [a, jnp.repeat(a[-1:], nk * n_g - a.shape[0], 0)])
            a = a.reshape(nk, n_g, n)
        else:
            a = jnp.broadcast_to(a[None], (nk, 1, n))
        return a.reshape(nk * n_g, n)

    xsum = jnp.sum(xc.astype(jnp.int32).reshape(m, k_pad // gs, gs), -1)
    return xc, xsum, to_slabs(scales_t), to_slabs(off2_t)


@pytest.mark.parametrize("layout,bits,group_size,in_f", [
    ("pairs", 4, 128, 640), ("pairs", 4, 64, 320), ("pairs", 3, None, 700),
    ("planar", 6, 128, 640), ("planar", 4, 64, 320), ("planar", 2, None, 700),
    ("planar", 8, 128, 1152)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int_dense_operands_match_jax(layout, bits, group_size, in_f, dtype):
    """The codes, xsum, sc and off2 that the port's wrapper hands K9
    (``int_dense_operands``) equal what JAX's dense route forms with XLA,
    bit for bit, for pairs and planar weights at g64, g128 and per channel,
    with f32 or bf16 scales (off2 rounded at each step in bf16), K padded
    up to the pack tile and the layout-padding groups on the last scale."""
    jw, tw = packed_pair(bits, group_size, 256, in_f, layout,
                         seed=bits + in_f)
    if dtype == "bfloat16":
        jw = dataclasses.replace(jw, scales=jw.scales.astype(jnp.bfloat16),
                                 zeros=jw.zeros.astype(jnp.bfloat16))
        tw = tw.map_tensors(lambda t: t.to(torch.bfloat16)
                            if t.is_floating_point() else t)
    assert tw.k_pad > in_f
    x = np.random.default_rng(bits).standard_normal((37, in_f)).astype(
        np.float32)
    jcfg, tcfg = acts(4)
    want = _jax_dense_operands(jnp.asarray(x), jw, jcfg)
    xc, _ = tqm.quantize_act_int(torch.from_numpy(x), tcfg)
    got = tqm.int_dense_operands(xc, tw)
    assert got.xsum.dtype == torch.int32
    assert got.sc.dtype == got.off2.dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# K8 and K9 tiles (csrc/quant_matmul_int.cu) emulated lane by lane in numpy:
# the index math of the kernels, checked here before any launch on the card


def _k8_emulate(pw):
    """unpack_int8_kernel: per CTA (32 columns, one pack tile), phase 1
    reads four consecutive words of a column and stores each slot's four
    codes (planar: rows v*P + w..w+3; pairs: two words per 4-byte store,
    rows j*2P + 2w..2w+7) into a (32, T + 4) byte tile; phase 2 writes 16-
    byte chunks, 4 columns x 8 chunks per warp, to out (N, k_pad)."""
    qw = pw.qweight.numpy().view(np.uint32)
    N, T, bits, k_pad = qw.shape[1], pw.tile_k, pw.bits, pw.k_pad
    half = 1 << (bits - 1)
    pairs = pw.layout == "pairs"
    lo_bits = {3: 2, 6: 4}.get(bits, bits)
    P = tqm._unpack_words(pw)
    wpt = P if pairs else T * bits // 32
    out = np.full((N, k_pad), 99, np.int64)
    LD = T + 4
    for t in range(k_pad // T):
        for c0 in range(0, N, 32):
            sm = np.full(32 * LD, 77, np.int64)
            for i in range(P // 4 * 32):
                c, q = i % 32, i // 32
                lo = [int(qw[t * wpt + 4 * q + e, c0 + c]) for e in range(4)]
                base = c * LD
                if pairs:
                    fields = 5 if bits == 3 else 16 // bits
                    for j in range(fields):
                        codes = [((lo[e] >> (bits * j + 16 * h))
                                  & ((1 << bits) - 1)) - half
                                 for e in range(4) for h in range(2)]
                        off = base + j * 2 * P + 8 * q
                        assert off % 4 == 0
                        sm[off:off + 8] = codes
                else:
                    hp = P // 2
                    hi = [int(qw[t * wpt + P + (4 * q + e) % hp, c0 + c])
                          if bits in (3, 6) else 0 for e in range(4)]
                    sel = [(4 * q + e) // hp for e in range(4)]
                    for v in range(32 // lo_bits):
                        codes = []
                        for e in range(4):
                            cd = (lo[e] >> (lo_bits * v)) & ((1 << lo_bits) - 1)
                            if bits in (3, 6):
                                hb = bits - lo_bits
                                cd |= ((hi[e] >> (hb * (2 * v + sel[e])))
                                       & ((1 << hb) - 1)) << lo_bits
                            codes.append(cd - half)
                        off = base + v * P + 4 * q
                        assert off % 4 == 0
                        sm[off:off + 4] = codes
            CH = T // 16
            for e in range(32 // 4 * -(-CH // 8) * 32):
                sub, b = e % 32, e // 32
                c = (b % 8) * 4 + sub // 8
                ch = (b // 8) * 8 + sub % 8
                if ch >= CH:
                    continue
                src = c * LD + ch * 16
                assert src % 4 == 0 and (t * T + ch * 16) % 16 == 0
                out[c0 + c, t * T + ch * 16:t * T + ch * 16 + 16] = \
                    sm[src:src + 16]
    return out


@pytest.mark.parametrize("bits,layout,group_size,in_f", [
    (4, "pairs", 128, 640), (3, "pairs", 128, 640), (2, "pairs", None, 300),
    (2, "planar", 64, 320), (3, "planar", 128, 640), (4, "planar", 64, 320),
    (6, "planar", 128, 640), (8, "planar", None, 200)])
def test_unpack_tile_emulation_writes_every_code(bits, layout, group_size,
                                                 in_f):
    """K8's index math writes every code of (N, k_pad) once, equal to the
    plain version (which equals JAX's, transposed), for every layout and
    width; the shared stores are 4-byte aligned and the global ones 16."""
    _, tw = packed_pair(bits, group_size, 64, in_f, layout, seed=bits)
    assert tqm._unpack_words(tw) % 4 == 0
    got = _k8_emulate(tw)
    np.testing.assert_array_equal(got, tqm.unpack_to_int8_plain(tw).numpy())


K9_BK, K9_STAGES, K9_STAGE_BYTES, K9_SC = 128, 6, 33792, 512


def _k9_scale_slots(s, k_pad, gs):
    """{slot: group} of K stage s: the producer copies the scales of a group
    starting at half h of the stage (row 128 s + 64 h) into slot h."""
    return {h: (s * K9_BK + 64 * h) // gs for h in (0, 1)
            if s * K9_BK + 64 * h < k_pad and (s * K9_BK + 64 * h) % gs == 0}


def _k9_n_off(k_pad, gs):
    """Ring positions of the offset term: 3 bf16 columns per group, 64 a
    stage."""
    return -(-3 * (k_pad // gs) // 64)


def _k9_consumer(k_pad, gs):
    """A consumer warpgroup's program in qmm_int_dense_kernel: the offset
    term's stages (bf16 wgmmas into the f32 sums, each waited for, then
    freed), then chunks of CHUNK bytes of k (128 where gs and k_pad are
    multiples of 128, else 64), each its own wgmma commit group; at a
    group's first chunk, read its scales from slot j of the stage into
    registers (slot = the half of the stage where the group starts); after
    each chunk, wait for it, free its stage if the chunk ends the stage,
    close the group after its gs / CHUNK chunks. Ring slot and phase and
    the chunks of a group are counters, as in the kernel."""
    n_off = _k9_n_off(k_pad, gs)
    ev = []
    for p in range(n_off):
        ev += [("wait_full", p), ("issue_offset", p), ("wait", 0),
               ("release", p)]
    chunk = 128 if gs % K9_BK == 0 and k_pad % K9_BK == 0 else 64
    p, in_g, g = n_off, 0, 0
    for c in range(k_pad // chunk):
        k0, k1 = c * chunk, (c + 1) * chunk
        half = (k0 % K9_BK) // 64
        if half == 0:
            ev.append(("wait_full", p))
        if in_g == 0:
            ev.append(("read_scales", g, p, half))
        ev.append(("issue", g, p, k0, k1))
        ev.append(("wait", 0))
        if k1 % K9_BK == 0 or k1 == k_pad:
            ev.append(("release", p))
            p += 1
        in_g += 1
        if in_g == gs // chunk:
            ev.append(("close", g))
            in_g, g = 0, g + 1
    return ev


K9_CASES = [(4096, 128), (4096, 64), (11264, 128), (1088, 64), (1152, 64),
            (1280, 640), (320, 64), (960, 320), (768, 192), (512, 512)]


@pytest.mark.parametrize("k_pad,gs", K9_CASES)
def test_k9_schedule_closes_every_group_once(k_pad, gs):
    """A consumer issues every k32 step of [0, k_pad) once, inside one
    stage and one group, zeroing the accumulator (scale-d 0) at a group's
    first step only; it closes each group once, after all of its wgmmas
    completed, with the scales it read at the group's start from the slot
    where the producer put them; it frees each ring position once, after
    every wgmma and scale read of it. g64, g128, per channel (groups of a pack tile, over several
    stages), k_pad % 128 == 64 (a half stage at the end) and groups of 192
    and 320 rows."""
    ev = _k9_consumer(k_pad, gs)
    n_off = _k9_n_off(k_pad, gs)
    steps, pending, done, closed, released = [], [], [], [], []
    scales = {}
    for e in ev:
        if e[0] == "read_scales":
            _, g, p, h = e
            assert p not in released
            assert _k9_scale_slots(p - n_off, k_pad, gs)[h] == g
            scales[g] = p
        if e[0] == "issue":
            _, g, p, k0, k1 = e
            assert k0 // gs == (k1 - 1) // gs == g
            assert n_off + k0 // K9_BK == n_off + (k1 - 1) // K9_BK == p
            for k in range(k0, k1, 32):
                steps.append((k, g, k == g * gs))
        if e[0] in ("issue", "issue_offset"):
            pending.append(e)
        elif e[0] == "wait":
            done += pending
            pending = []
        elif e[0] == "close":
            g = e[1]
            assert g not in closed and g in scales
            assert all(d in done for d in ev if d[0] == "issue" and d[1] == g)
            closed.append(g)
        elif e[0] == "release":
            p = e[1]
            assert all(d in done for d in ev
                       if d[0] in ("issue", "issue_offset") and d[2 if d[0]
                                                             == "issue"
                                                             else 1] == p)
            assert p not in released
            released.append(p)
    assert [k for k, _, _ in steps] == list(range(0, k_pad, 32))
    assert all(first == (k % gs == 0) for k, _, first in steps)
    assert closed == list(range(k_pad // gs))
    assert released == list(range(n_off + -(-k_pad // K9_BK)))
    # every group's scales are copied into exactly one stage
    owners = [g for s in range(-(-k_pad // K9_BK))
              for g in _k9_scale_slots(s, k_pad, gs).values()]
    assert owners == list(range(k_pad // gs))


class _MBarrier:
    """An mbarrier: a phase completes when its pending arrivals and its
    transaction bytes both reach 0; try_wait.parity(p) passes once the
    phase of parity p has completed (at first, parity 1)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, n=1, tx=0):
        self.tx += tx
        self.pending -= n
        self._flip()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._flip()

    def _flip(self):
        assert self.pending >= 0
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


@pytest.mark.parametrize("k_pad,gs", K9_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k9_ring_phase_bits(k_pad, gs, seed):
    """The ring's full/empty barriers and their phase bits under random
    interleavings of the producer (waits empty[slot] at parity
    (round & 1) ^ 1, arms full[slot] with its two 16 KB boxes and 512
    bytes per group starting in a K stage), the copies landing in any order and the two consumer warpgroups (wait full[slot]
    at parity round & 1; 128 arrivals each on empty): no deadlock, every
    wait passes only once its position's bytes have landed, and no slot is
    overwritten while a wgmma or a scale read still reads it."""
    rng = np.random.default_rng(seed)
    n_off = _k9_n_off(k_pad, gs)
    n_pos = n_off + -(-k_pad // K9_BK)
    full = [_MBarrier(1) for _ in range(K9_STAGES)]
    empty = [_MBarrier(256) for _ in range(K9_STAGES)]
    held = [None] * K9_STAGES  # the ring position whose data a slot holds
    copies = []

    def producer():
        for p in range(n_pos):
            slot, rnd = p % K9_STAGES, p // K9_STAGES
            while not empty[slot].passed((rnd & 1) ^ 1):
                yield
            held[slot] = None  # the copies below overwrite it
            parts = [16384, 16384] + ([K9_SC] * len(_k9_scale_slots(
                p - n_off, k_pad, gs)) if p >= n_off else [])
            full[slot].arrive(1, tx=sum(parts))
            copies.extend((slot, p, b, i == len(parts) - 1)
                          for i, b in enumerate(parts))
            yield

    def consumer():
        inflight = []
        for e in _k9_consumer(k_pad, gs):
            if e[0] == "wait_full":
                p = e[1]
                slot = p % K9_STAGES
                while not full[slot].passed((p // K9_STAGES) & 1):
                    yield
                assert held[slot] == p
            elif e[0] == "read_scales":
                assert held[e[2] % K9_STAGES] == e[2]
            elif e[0] in ("issue", "issue_offset"):
                inflight.append(e[2] if e[0] == "issue" else e[1])
            elif e[0] == "wait":
                for p in inflight:
                    assert held[p % K9_STAGES] == p
                inflight = []
            elif e[0] == "release":
                empty[e[1] % K9_STAGES].arrive(128)
            yield

    actors = [producer(), consumer(), consumer()]
    live = list(range(3))
    for _ in range(200000):
        moves = [("actor", a) for a in live] + [("copy", i)
                                                for i in range(len(copies))]
        if not moves:
            break
        kind, i = moves[rng.integers(len(moves))]
        if kind == "copy":
            slot, p, nbytes, last = copies.pop(i)
            if last:
                held[slot] = p
            full[slot].complete_tx(nbytes)
        else:
            try:
                next(actors[i])
            except StopIteration:
                live.remove(i)
    assert not live and not copies, "the ring deadlocked"


@pytest.mark.parametrize("n_groups", [1, 32, 88])
def test_k9_offset_operands_are_exact(n_groups):
    """K9's offset term on the bf16 tensor cores: xo @ wo.T equals
    xsum @ off2 exactly (in f64, where every bf16 product and their sum are
    exact) for code sums across the int32 range K9 meets (the split's parts
    are exact in bf16) and bf16 off2; ko is a multiple of 64."""
    rng = np.random.default_rng(n_groups)
    xsum = rng.integers(-2 ** 23, 2 ** 23, (37, n_groups)).astype(np.int32)
    xsum[0, 0], xsum[1, 0] = -2 ** 23, 2 ** 23 - 1
    off2 = torch.from_numpy(rng.standard_normal((n_groups, 256)).astype(
        np.float32)).to(torch.bfloat16).float()
    ops = tqm.IntDenseOperands(None, torch.from_numpy(xsum), None, off2)
    xo, wo = tqm._k9_offset_operands(ops)
    assert xo.dtype == wo.dtype == torch.bfloat16
    assert xo.shape[1] == wo.shape[1] and xo.shape[1] % 64 == 0
    assert xo.shape[1] >= 3 * n_groups
    np.testing.assert_array_equal(
        (xo.double() @ wo.double().t()).numpy(),
        (torch.from_numpy(xsum).double() @ off2.double()).numpy())


def _swizzle128(addr):
    """The 128-byte swizzle TMA writes and wgmma reads: 16-byte chunk bits
    [4:6] of a shared address XOR its 128-byte row bits [7:9]."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _k9_desc(addr):
    """csrc/sm90.cuh desc_k_sw128: a K-major, 128B-swizzled wgmma operand
    at a shared address: start >> 4 in bits [0:14), LBO 16 B, SBO 1024 B
    (8 rows of 128 bytes) in bits [32:46), layout 1 (128B swizzle) in bits
    [62:64)."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32)
            | (1 << 62))


@pytest.mark.parametrize("rows,wg_rows", [(128, 64), (128, 128)])
def test_k9_swizzle_and_descriptors_reach_every_byte(rows, wg_rows):
    """A stage's box (rows x 128 k-bytes: 128 int8 codes or 64 bf16 values)
    as TMA writes it with the 128-byte swizzle at a 1024-aligned address,
    and the bytes each wgmma reads through its descriptor (A: a
    warpgroup's 64 rows, m64 x k32 int8 or k16 bf16, 32 bytes either way;
    B: the CTA's 128 columns) at start + 64 * (second half of the stage)
    + 32 * q: each (row, k) byte of the box is read once, by the step that
    covers it, from where TMA put it."""
    base = 5 * K9_STAGE_BYTES + 16384  # a B box of slot 5: 1024-aligned
    assert base % 1024 == 0
    smem = {}
    for r in range(rows):
        for k in range(K9_BK):
            smem[base + _swizzle128(r * 128 + k)] = (r, k)
    assert len(smem) == rows * K9_BK
    seen = {}
    for w0 in range(0, rows, wg_rows):
        for h in (0, 64):
            for q in range(2):
                desc = _k9_desc(base + w0 * 128 + h + 32 * q)
                start = (desc & 0x3FFF) << 4
                sbo = ((desc >> 32) & 0x3FFF) << 4
                assert desc >> 62 == 1 and sbo == 1024
                for i in range(wg_rows):
                    for kk in range(32):
                        lin = start + (i // 8) * sbo + (i % 8) * 128 + kk
                        got = smem[base + _swizzle128(lin - base)]
                        want = (w0 + i, h + 32 * q + kk)
                        assert got == want, (w0, h, q, i, kk, got)
                        seen[want] = seen.get(want, 0) + 1
    assert len(seen) == rows * K9_BK and set(seen.values()) == {1}


def test_k9_accumulator_map_covers_the_tile_once():
    """The m64n128 s32 accumulator (thread t of a warpgroup, register i:
    row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
    2 (t % 4) + i % 2) covers a warpgroup's 64 x 128 tile once and the two
    consumer warpgroups the CTA's 128 x 128 tile once; the close scales it
    by its column's scale (the thread's 16 float2 scales at columns
    8 j + 2 (lane % 4), j = i / 4) and the epilogue by its row's xs (rows
    r0 and r0 + 8)."""
    cover = np.zeros((128, 128), int)
    for cw in range(2):
        for t in range(128):
            warp, lane = t // 32, t % 32
            r0 = cw * 64 + warp * 16 + lane // 4
            for i in range(64):
                row = cw * 64 + 16 * (t // 32) + (t % 32) // 4 + 8 * (
                    (i // 2) % 2)
                col = 8 * (i // 4) + 2 * (t % 4) + i % 2
                j, h, e = i // 4, (i // 2) % 2, i % 2
                assert row == r0 + 8 * h
                assert col == 8 * j + 2 * (lane % 4) + e
                cover[row, col] += 1
    assert (cover == 1).all()


def test_k9_grid_raster_covers_every_tile_once():
    """The 1-D grid walks bands of 16 row tiles, rows fastest inside a
    band (csrc k9_tile): every (row tile, column tile) once, ragged last
    band included."""
    for m_tiles, n_tiles in ((32, 96), (33, 32), (1, 2), (17, 172)):
        seen = set()
        for idx in range(m_tiles * n_tiles):
            band_sz = 16 * n_tiles
            first = idx // band_sz * 16
            gm = min(m_tiles - first, 16)
            mt = first + (idx % band_sz) % gm
            nt = (idx % band_sz) // gm
            assert 0 <= mt < m_tiles and 0 <= nt < n_tiles
            seen.add((mt, nt))
        assert len(seen) == m_tiles * n_tiles


# ---------------------------------------------------------------------------
# K7's tile (csrc/quant_matmul_int.cu::qmm_int_planar_kernel) emulated lane
# by lane in numpy: its plan, ring, word staging, A-register unpack, B
# fragments, MMAs, code sums, group closes and epilogue


def _bperm(x, y, sel):
    """__byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the eight bytes of (x, y), x's first."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _transpose4(w):
    """transpose4: t[q] holds byte q of w[0..3], w[0]'s in the low byte."""
    l01, h01 = _bperm(w[0], w[1], 0x5140), _bperm(w[0], w[1], 0x7362)
    l23, h23 = _bperm(w[2], w[3], 0x5140), _bperm(w[2], w[3], 0x7362)
    return [_bperm(l01, l23, 0x5410), _bperm(l01, l23, 0x7632),
            _bperm(h01, h23, 0x5410), _bperm(h01, h23, 0x7632)]


def _gather4(w):
    return _bperm(_bperm(w[0], w[1], 0x0040), _bperm(w[2], w[3], 0x0040),
                  0x5410)


def _k7_word(r, col):
    """k7_word: the staged word of row r, column col (chunks of 4 columns
    swizzled by the row)."""
    return r * 64 + (((col >> 2) ^ (2 * ((r >> 2) & 3))) << 2) + (col & 3)


def _off2_bf16(s, z, half):
    d = torch.tensor(half - float(z)).bfloat16().float()
    return float((d * float(s)).bfloat16().float())


class _K7Cta:
    """One CTA of K7 (64 columns from bx * 64, rows from rz * 128, slice
    ``split``), emulated lane by lane. ``run`` returns its f32 sums
    (tokens, 64) before the token scale and records what each MMA's A
    elements were and which (tile row, column) they met."""

    def __init__(self, xc, pw, plan, bx, split, rz):
        self.xc, self.pw, self.plan = xc.numpy(), pw, plan
        geo = plan.geometry
        self.geo = geo
        bits = pw.bits
        self.LO = {3: 2, 6: 4}.get(bits, bits)
        self.HI = bits - self.LO
        self.NSEL = 2 if self.HI else 1
        self.NBLK = self.NSEL + (1 if self.HI else 0)
        self.T, self.k_pad = pw.tile_k, pw.k_pad
        self.P = self.T * self.LO // 32
        self.B = self.P // self.NSEL
        self.WPT = self.T * bits // 32
        self.MN, self.MR = geo.mn, 8 * geo.mn
        self.HALF = 1 << (bits - 1)
        self.m, self.K = self.xc.shape
        self.N = pw.qweight.shape[1]
        self.G = pw.scales.shape[1]
        self.gs = pw.group_size or pw.k_pad
        self.kx = geo.kx
        self.H = 1 if self.MN <= 4 else self.MN // 4
        self.spw = self.H if geo.fast else (self.T // 32) // self.kx
        self.wpt = self.B // 32 if geo.fast else 1
        self.LDX = self.kx * 32 + 16
        self.words = pw.qweight.numpy().view(np.uint32)
        self.col0, self.r0 = bx * 64, rz * 128
        n_tiles = self.k_pad // self.T
        self.t_begin = split * plan.per
        self.t_end = min(self.t_begin + plan.per, n_tiles)
        self.n_win = (self.t_end - self.t_begin) * self.wpt
        self.n_steps = self.n_win * self.spw
        self.g0 = self.t_begin * self.T // self.gs
        self.ng = (self.t_end * self.T - 1) // self.gs - self.g0 + 1
        codes = unpack_codes_np(pw)  # (k_pad, N)
        self.codes = codes
        # the thread grid: warp, lane
        tid = np.arange(128)
        self.lane, self.warp = tid & 31, tid >> 5
        self.g, self.t4 = self.lane >> 2, self.lane & 3
        self.cw = self.warp * 16
        self.met = np.zeros((self.k_pad, 64), np.int64)  # (row, col) met
        self.closes = []

    def load_words(self, w, slot):
        t = self.t_begin + w // self.wpt
        w0 = 32 * (w % self.wpt)
        rows = self.NBLK * 32 if self.geo.fast else self.WPT
        assert rows * 64 * 4 <= self.geo.word_slot
        for i in range(rows * 16):
            r, c = i >> 4, (i & 15) << 2
            row = r
            if self.geo.fast:
                b = r >> 5
                row = (b * self.B if b < self.NSEL else self.P) + w0 + (r & 31)
            dst = _k7_word(r, c)
            assert dst % 4 == 0  # 16-byte cp.async
            slot[dst:dst + 4] = self.words[t * self.WPT + row,
                                           self.col0 + c:self.col0 + c + 4]

    def load_x(self, s, slot):
        row0 = self.step_row(s)
        stride = self.B if self.geo.fast else 32
        for i in range(self.MR * self.kx * 2):
            r, rem = divmod(i, self.kx * 2)
            k = row0 + (rem >> 1) * stride + 16 * (rem & 1)
            tok = self.r0 + r
            d = r * self.LDX + 16 * rem
            assert d % 16 == 0
            v = np.zeros(16, np.int8)
            if tok < self.m:
                n_in = max(0, min(16, self.K - k))
                v[:n_in] = self.xc[tok, k:k + n_in]
            slot[d:d + 16] = v

    def step_row(self, s):
        w, sw = divmod(s, self.spw)
        wt = w // self.wpt
        stride = self.B if self.geo.fast else 32
        return ((self.t_begin + wt) * self.T
                + 32 * (w - wt * self.wpt) * self.geo.fast
                + sw * self.kx * stride)

    def xsum_pass(self, s, xsm, sums):
        """Each (k32 block, token) adds its 32 codes into the sum of its
        group's rank among the step's groups, (lo + kb * stride) /
        max(group, stride) by the kernel's float estimate and its two
        corrections, in the zeroed buffer ``sums``; records each group's
        rank for the closes."""
        row0 = self.step_row(s)
        lo = row0 - row0 // self.gs * self.gs
        stride = self.B if self.geo.fast else 32
        rdiv = max(self.gs, stride)
        inv = np.float32(1.0) / np.float32(rdiv)
        groups = [(row0 + kb * stride) // self.gs for kb in range(self.kx)]
        ranks = sorted(set(groups))
        self.rank_of = {}
        for i in range(self.kx * self.MR):
            kb, r = divmod(i, self.MR)
            v = lo + kb * stride
            gi = int(np.float32(v) * inv)
            gi += (gi + 1) * rdiv <= v
            gi -= gi * rdiv > v
            assert gi == v // rdiv
            assert gi == ranks.index(groups[kb]) and 0 <= gi < self.kx
            self.rank_of[groups[kb]] = gi
            o = r * self.LDX + 32 * kb
            sums[gi * self.MR + r] += int(xsm[o:o + 32].astype(np.int64).sum())

    def lds64(self, wsm, r, col, banks=False):
        """LDS.64 of (row r, columns col, col + 1) per lane; checks 8-byte
        alignment and, with ``banks``, that each half-warp phase hits
        distinct banks (the fast path's reads; the generic path's may
        conflict)."""
        idx = _k7_word(r, col)
        assert (idx % 2 == 0).all()
        for wp in range(4 if banks else 0):
            for ph in range(2):
                sel = (self.warp == wp) & ((self.lane >> 4) == ph)
                words = np.unique(np.concatenate([idx[sel], idx[sel] + 1]))
                assert len(np.unique(words % 32)) == len(words), "conflict"
        return wsm[idx], wsm[idx + 1]

    def fast_regs(self, wsm):
        tl = {}
        for b in range(self.NBLK):
            for h in range(2):
                vx, vy = [], []
                for e in range(4):
                    r = 32 * b + 16 * h + 4 * self.t4 + e
                    x, y = self.lds64(wsm, r, self.cw + 2 * self.g, True)
                    vx.append(x)
                    vy.append(y)
                tl[b, 0, h] = _transpose4(vx)
                tl[b, 1, h] = _transpose4(vy)
        return tl

    def fast_a(self, tl, f):
        p, b = divmod(f, self.NSEL)
        LO, HI = self.LO, self.HI
        q, sh = LO * p // 8, LO * p % 8
        a = []
        for r in range(4):
            c = tl[b, r & 1, r >> 1][q]
            if LO < 8:
                c = (c >> sh) & (((1 << LO) - 1) * 0x01010101)
            if HI:
                fh = 2 * p + b
                qh, shh = HI * fh // 8, HI * fh % 8
                c = c | (((tl[self.NSEL, r & 1, r >> 1][qh] >> shh)
                          & (((1 << HI) - 1) * 0x01010101)) << LO)
            a.append(c)
        return a

    def generic_a(self, wsm, kb):
        LO, HI, B, P = self.LO, self.HI, self.B, self.P
        a = [None] * 4
        for h in range(2):
            rr = 32 * kb + 16 * h + 4 * self.t4
            f, j4 = rr // B, rr % B
            p, b = f // self.NSEL, f % self.NSEL
            lx, ly, hx, hy = [], [], [], []
            for e in range(4):
                x, y = self.lds64(wsm, b * B + j4 + e, self.cw + 2 * self.g)
                lx.append(x >> (LO * p))
                ly.append(y >> (LO * p))
                if HI:
                    x, y = self.lds64(wsm, P + j4 + e, self.cw + 2 * self.g)
                    hx.append(x >> (HI * (2 * p + b)))
                    hy.append(y >> (HI * (2 * p + b)))
            mlo = ((1 << LO) - 1) * 0x01010101
            cx, cy = _gather4(lx) & mlo, _gather4(ly) & mlo
            if HI:
                mhi = ((1 << HI) - 1) * 0x01010101
                cx = cx | ((_gather4(hx) & mhi) << LO)
                cy = cy | ((_gather4(hy) & mhi) << LO)
            a[2 * h], a[2 * h + 1] = cx, cy
        return a

    def mma_block(self, a, xsm, kb, row0):
        """ldmatrix B fragments and the MMAs of k32 block kb (tile rows
        row0 ..); checks each A element against the code of the (row,
        column) its k meets."""
        lm_tok = ((self.lane >> 4) << 3) + (self.lane & 7)
        lm_off = ((self.lane >> 3) & 1) << 4
        for wp in range(4):
            sel = self.warp == wp
            A = np.zeros((16, 32), np.int64)
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                for reg in range(4):
                    v = int(a[reg][wp * 32 + lane])
                    for e in range(4):
                        A[g + 8 * (reg & 1), 4 * t4 + 16 * (reg >> 1) + e] = \
                            (v >> (8 * e)) & 0xFF
            for arow in range(16):
                col = 2 * (arow % 8) + arow // 8 + wp * 16
                for k in range(32):
                    assert A[arow, k] == self.codes[row0 + k,
                                                    self.col0 + col]
                self.met[row0:row0 + 32, col] += 1
            for nt in range(0, self.MN, 2):
                addr = (nt * 8 + lm_tok[sel]) * self.LDX + 32 * kb + lm_off[sel]
                regs = []
                for j in range(4 if self.MN > 1 else 2):
                    regs.append(np.array([
                        xsm[addr[8 * j + (l >> 2)] + 4 * (l & 3):
                            addr[8 * j + (l >> 2)] + 4 * (l & 3) + 4]
                        for l in range(32)]))
                for tile, (b0, b1) in enumerate(
                        [(0, 1)] + ([(2, 3)] if self.MN > 1 else [])):
                    Bm = np.zeros((32, 8), np.int64)
                    for l in range(32):
                        Bm[4 * (l & 3):4 * (l & 3) + 4, l >> 2] = regs[b0][l]
                        Bm[16 + 4 * (l & 3):20 + 4 * (l & 3), l >> 2] = \
                            regs[b1][l]
                    D = A @ Bm
                    for l in range(32):
                        g, t4 = l >> 2, l & 3
                        acc = self.acc[wp * 32 + l, nt + tile]
                        acc += [D[g, 2 * t4], D[g, 2 * t4 + 1],
                                D[g + 8, 2 * t4], D[g + 8, 2 * t4 + 1]]
                        assert (np.abs(acc) < 2 ** 31).all()

    def close(self, sums, grp, rank):
        self.closes.append(grp)
        assert self.rank_of[grp] == rank
        gi = grp - self.g0
        assert 0 <= gi < self.ng
        for tid in range(128):
            g, t4, cw = self.g[tid], self.t4[tid], self.cw[tid]
            s0, o0 = self.scl[gi, cw + 2 * g]
            s1, o1 = self.scl[gi, cw + 2 * g + 1]
            for nt in range(self.MN):
                xa = sums[rank * self.MR + nt * 8 + 2 * t4]
                xb = sums[rank * self.MR + nt * 8 + 2 * t4 + 1]
                d = self.acc[tid, nt]
                f = self.accf[tid, nt]
                f32 = np.float32
                f[0] = f32(f32(d[0] - self.HALF * xa) * s0) + f32(
                    f32(xa) * o0 + f[0])
                f[1] = f32(f32(d[1] - self.HALF * xb) * s0) + f32(
                    f32(xb) * o0 + f[1])
                f[2] = f32(f32(d[2] - self.HALF * xa) * s1) + f32(
                    f32(xa) * o1 + f[2])
                f[3] = f32(f32(d[3] - self.HALF * xb) * s1) + f32(
                    f32(xb) * o1 + f[3])
                d[:] = 0

    def run(self, ring_log=None):
        pw = self.pw
        # the staged scales: (s, off2) [group][column], padded groups on the
        # last scale column
        self.scl = np.zeros((self.ng, 64, 2), np.float32)
        sc, z = pw.scales.float().numpy(), pw.zeros.float().numpy()
        for gi in range(self.ng):
            gg = min(self.g0 + gi, self.G - 1)
            for c in range(64):
                s = sc[self.col0 + c, gg]
                self.scl[gi, c] = (s, _off2_bf16(s, z[self.col0 + c, gg],
                                                 float(self.HALF)))
        self.acc = np.zeros((128, self.MN, 4), np.int64)
        self.accf = np.zeros((128, self.MN, 4), np.float32)
        wslot = [np.zeros(self.geo.word_slot // 4, np.uint32)
                 for _ in range(2)]
        xslot = [np.zeros(self.geo.x_slot, np.int8) for _ in range(2)]
        wtag, xtag = [None, None], [None, None]
        sumbuf = [np.zeros(self.kx * self.MR, np.int64) for _ in range(2)]
        last_reader = {}  # ("w"/"x", slot) -> last step that reads it
        pending = []  # copies of the group in flight: (kind, slot, tag)

        def issue(kind, slot, tag, s):
            # a slot is refilled only after every step that reads it
            key = (kind, slot)
            assert last_reader.get(key, -1) < s, (kind, slot, tag, s)
            pending.append((kind, slot, tag))
            if ring_log is not None:
                ring_log.append((s, kind, slot, tag))

        fast = self.geo.fast
        self.load_words(0, wslot[0])
        self.load_x(0, xslot[0])
        issue("w", 0, 0, 0)
        issue("x", 0, 0, 0)
        for s in range(self.n_steps):
            w, sw = divmod(s, self.spw)
            ws = 0 if fast else w & 1  # the fast path has one word slot
            # wait_group 0 + barrier: every copy issued so far has landed
            for kind, slot, tag in pending:
                (wtag if kind == "w" else xtag)[slot] = tag
            pending.clear()
            new_win = s + 1 < self.n_steps and (s + 1) % self.spw == 0
            if s + 1 < self.n_steps:
                if new_win and not fast:
                    w1 = (s + 1) // self.spw
                    issue("w", w1 & 1, w1, s)
                    self.load_words(w1, wslot[w1 & 1])
                issue("x", (s + 1) & 1, s + 1, s)
                self.load_x(s + 1, xslot[(s + 1) & 1])
            assert xtag[s & 1] == s and wtag[ws] == w
            last_reader[("x", s & 1)] = s
            wsm = wslot[ws]
            if fast:  # the words into registers, before the sums' barrier
                tl = self.fast_regs(wsm)
            else:  # read throughout the step
                last_reader[("w", ws)] = s
            xsm = xslot[s & 1]
            # the sums buffer s & 1, zeroed during step s - 1 (or before
            # the first)
            sums = sumbuf[s & 1]
            assert not sums.any()
            self.xsum_pass(s, xsm, sums)
            sumbuf[(s + 1) & 1][:] = 0
            # barrier; then the fast path refills its word slot
            if fast and new_win:
                w1 = (s + 1) // self.spw
                issue("w", 0, w1, s)
                self.load_words(w1, wslot[0])
                wsm = None  # the step reads no word from shared memory now
            row = self.step_row(s)
            grp = row // self.gs
            g_hi, rank = (grp + 1) * self.gs, 0
            for i in range(self.kx):
                kb = sw * self.kx + i
                a = (self.fast_a(tl, kb) if self.geo.fast
                     else self.generic_a(wsm, kb))
                self.mma_block(a, xsm, i, row)
                nxt = row + (self.B if self.geo.fast else 32)
                if i == self.kx - 1 or nxt >= g_hi:
                    self.close(sums, grp, rank)
                    rank += 1
                    while nxt >= g_hi:
                        grp, g_hi = grp + 1, g_hi + self.gs
                row = nxt
        assert not pending
        out = np.zeros((self.MR, 64), np.float32)
        for tid in range(128):
            g, t4, cw = self.g[tid], self.t4[tid], self.cw[tid]
            for nt in range(self.MN):
                for e in range(2):
                    out[nt * 8 + 2 * t4 + e, cw + 2 * g] = self.accf[tid, nt, e]
                    out[nt * 8 + 2 * t4 + e, cw + 2 * g + 1] = \
                        self.accf[tid, nt, e + 2]
        return out


def unpack_codes_np(pw):
    """Every (tile row, column) code of a planar weight, (k_pad, N)."""
    from omniquant_tpu_torch.quant.packing import unpack_codes
    return unpack_codes(pw.qweight, pw.bits, pw.k_pad, pw.group_size,
                        pw.tile_k, pw.layout).numpy().astype(np.int64)


def _k7_emulate(xc, xs, pw, plan):
    """Every CTA of K7's grid, then the slices summed in slice order
    (splitk_sum.cuh) times xs, rounded to bf16. Checks that each CTA's MMAs
    meet every (row, column) of its slice once."""
    m = xc.shape[0]
    n = pw.qweight.shape[1]
    geo = plan.geometry
    part = np.zeros((plan.splits, m, n), np.float32)
    for bx in range(n // 64):
        for split in range(plan.splits):
            for rz in range(geo.row_blocks):
                cta = _K7Cta(xc, pw, plan, bx, split, rz)
                got = cta.run()
                t0, t1 = plan.slices()[split]
                met = cta.met[t0 * pw.tile_k:t1 * pw.tile_k]
                assert (met == 1).all() and cta.met.sum() == met.sum()
                rows = slice(rz * 128, min(m, rz * 128 + geo.mn * 8))
                part[split, rows, bx * 64:(bx + 1) * 64] = \
                    got[:rows.stop - rows.start]
    tot = np.zeros((m, n), np.float32)
    for s in range(plan.splits):
        tot = tot + part[s]
    return (torch.from_numpy(tot) * xs).bfloat16()


K7_EMU_CASES = [
    # bits, group, in_f, tile_k, m, x columns K, pack tiles per slice
    # (None: int_plan's for 132 SMs), the generic path forced
    (6, 128, 1024, None, 5, 1024, None, False),   # W6 g128: fast, a window
    (6, 128, 1536, None, 32, 1000, 2, False),     # K % 16 != 0, two slices
    (6, None, 1100, None, 9, 1100, 1, False),     # per-channel, padded rows
    (6, 128, 640, None, 24, 640, 1, False),       # groups 5-7 padded
    (4, 64, 1024, None, 40, 1024, 1, False),      # two windows, two steps
    (2, 128, 512, None, 8, 512, None, False),     # 16 slots a word
    (8, None, 640, None, 130, 640, None, False),  # four windows, 2 row blocks
    (8, 64, 1024, 512, 8, 1024, None, False),     # B = 128 > g64: a group a
    (8, 64, 1024, 512, 60, 1024, 1, False),       # k32 block, groups 2 apart
    (4, 64, 1024, 1024, 40, 1024, None, False),   # B = 128 > g64, two steps
    (8, 128, 1024, 1024, 3, 1024, None, False),   # B = 256 > g128
    (3, 128, 512, None, 12, 512, None, False),    # B = 16: the generic path
    (4, 64, 640, 320, 3, 640, 1, False),          # B = 40: generic
    (6, 64, 128, None, 17, 120, None, False),     # B = 8: generic, tiny tile
    (2, 64, 192, 192, 2, 192, None, False),       # B = 12: generic
    (6, 128, 1024, None, 5, 1024, None, True),    # fast tiles, generic path
    (8, 64, 1024, 512, 33, 1000, 1, True),
]


@pytest.mark.parametrize("bits,group_size,in_f,tile_k,m,K,per,generic",
                         K7_EMU_CASES)
def test_k7_tile_emulation_matches_plain(bits, group_size, in_f, tile_k, m,
                                         K, per, generic):
    """K7's tile, emulated lane by lane: the word -> A-register unpack puts
    every code at its (column, k) once (fast and generic paths, 2/3/4/6/8
    bits), ldmatrix gives the token -> B-fragment map, the staged-word
    reads are 8-byte aligned and bank-conflict free, every group closes
    with its staged scale and the code sums of its rank in the step
    (per-channel and padded groups, and groups further apart than a step's
    k32 blocks, included); the product with the slices summed in order is
    held to ``quant_matmul_int_plain`` by the rule the card uses."""
    _, tw = packed_pair(bits, group_size, 64 if m > 64 else 128, in_f,
                        "planar", seed=bits + m, tile_k=tile_k)
    tw = tw.map_tensors(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, K)).astype(np.float32)).to(torch.bfloat16)
    xc, xs = tqm.quantize_act_int(x, TQuantConfig(n_bits=6))
    gr = tw.group_size or tw.k_pad
    plan = tqm.int_plan(m, tw.qweight.shape[1], tw.k_pad, tw.tile_k, bits,
                        gr, 132, 3, generic)
    if per is not None:
        splits = -(-plan.n_tiles // per)
        plan = plan._replace(
            geometry=tqm._k7_geometry(bits, m, tw.tile_k, tw.k_pad, gr, per,
                                      generic),
            splits=splits, per=per,
            workspace=(splits, m, tw.qweight.shape[1]) if splits > 1
            else None)
    assert tw.scales.shape[1] * (group_size or tw.k_pad) <= tw.k_pad
    assert plan.geometry.fast == (not generic and (
        tw.tile_k * {3: 2, 6: 4}.get(bits, bits) // 32
        // (2 if bits in (3, 6) else 1)) % 32 == 0)
    got = _k7_emulate(xc, xs, tw, plan)
    want, mag = tqm.quant_matmul_int_plain(xc, xs, tw, magnitude=True)
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.INT_MATMUL_SLACK * mag)
    assert ok, (err, worst)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("n_win,spw", [(1, 1), (3, 1), (2, 4), (5, 2),
                                       (1, 3), (4, 2)])
def test_k7_ring_schedule(n_win, spw, fast):
    """The ring, as a timeline of each step's phases: 0 wait_group 0 and
    the top barrier (every copy issued so far has landed), 1 the next
    step's x codes issued (and on the generic path the next window's words,
    into the other of two slots), 2 the fast path's words read into
    registers, 3 the sums' barrier, 4 the fast path's next window's words
    issued into its one slot, 5 the MMAs (x codes; the generic path's words
    from shared memory). Every copy lands before its first reader and
    overwrites a slot only after the last reader of what it held."""
    n_steps = n_win * spw
    reads = {}   # (slot kind, slot) -> [(time, tag)]
    writes = []  # (time, slot kind, slot, tag)
    writes += [((-1, 9), "w", 0, 0), ((-1, 9), "x", 0, 0)]
    for s in range(n_steps):
        w = s // spw
        new_win = s + 1 < n_steps and (s + 1) % spw == 0
        if s + 1 < n_steps:
            writes.append(((s, 1), "x", (s + 1) & 1, s + 1))
            if new_win and not fast:
                writes.append(((s, 1), "w", (w + 1) & 1, w + 1))
        if fast:
            reads.setdefault(("w", 0), []).append(((s, 2), w))
            if new_win:
                writes.append(((s, 4), "w", 0, w + 1))
        else:
            reads.setdefault(("w", w & 1), []).append(((s, 5), w))
        reads.setdefault(("x", s & 1), []).append(((s, 5), s))
    for key, rs in reads.items():
        ws = sorted((t, tag) for t, kind, slot, tag in writes
                    if (kind, slot) == key)
        for t_read, tag in rs:
            # the latest copy into the slot issued before the top barrier
            # of the reading step is the one read, and it carries the tag
            before = [(t, g) for t, g in ws if t < (t_read[0], 0)]
            assert before and before[-1][1] == tag, (key, t_read, tag)
            # and no later copy overwrites it before the read
            assert not [t for t, g in ws
                        if (t_read[0], 0) <= t < t_read], (key, t_read)


@pytest.mark.parametrize("m", [1, 8, 32, 33, 128, 300, 2047])
@pytest.mark.parametrize("bits,group_size,K,N,tile_k", [
    (6, 128, 4096, 12288, None), (6, 128, 11008, 4096, None),
    (6, 128, 4096, 22016, None), (4, 64, 4096, 4096, None),
    (8, None, 11008, 4096, None), (3, 128, 4096, 4096, None),
    (2, 64, 192, 128, 192), (8, 64, 4096, 4096, None),
    (4, 64, 4096, 4096, 1024), (8, 128, 4096, 4096, 1024)])
def test_k7_plan_covers_every_tile_once(bits, group_size, K, N, tile_k, m):
    """int_plan's slices cover every pack tile once, none empty, each within
    the slice's group budget, and the kernel's shared memory fits a block;
    rows past 128 take row blocks, so each word is read once per 128
    rows."""
    from omniquant_tpu_torch.quant.packing import pack_tile
    T = tile_k or pack_tile(bits, group_size, K)
    k_pad = -(-K // T) * T
    gr = group_size or k_pad
    plan = tqm.int_plan(m, N, k_pad, T, bits, gr, 132, 3)
    tiles = [t for a, b in plan.slices() for t in range(a, b)]
    assert tiles == list(range(k_pad // T))
    assert all(b > a for a, b in plan.slices())
    assert plan.geometry.smem <= tqm._K7_SMEM
    assert plan.geometry.row_blocks == -(-m // 128)
    assert plan.geometry.mn * 8 >= min(m, 128)
    if plan.per > 1 and gr != k_pad:
        assert plan.per * T // gr <= tqm._K7_SLICE_GROUPS
    assert plan.workspace == ((plan.splits, m, N) if plan.splits > 1
                              else None)


def test_bf16_close_counts_an_exact_zero_as_within():
    """The per-element rule: an element equal to its plain value passes
    even where its bound is 0 (plain 0 with no magnitude: a W3 column whose
    zero point is 2^{b-1} and whose dot is 0), and a nonzero error there
    fails."""
    want = torch.tensor([0.0, 1.0, 0.0])
    slack = torch.tensor([0.0, 0.0, 0.0])
    assert tolerance.bf16_close(want.clone(), want, slack)[0]
    assert not tolerance.bf16_close(torch.tensor([1e-6, 1.0, 0.0]), want,
                                    slack)[0]
