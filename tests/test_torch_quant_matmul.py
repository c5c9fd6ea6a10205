"""The port's packed matmul (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, in f32.

Tolerance: rtol 1e-4 plus an absolute 1e-5 of the output's largest
magnitude. The two sum in different orders, and the JAX pairs path folds
the zero point into a rank-1 term whose f32 cancellation leaves an error
proportional to the output scale rather than to each element."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import pack_weight as j_pack_weight
from omniquant_tpu_torch.kernels import quant_matmul as tqm
from omniquant_tpu_torch.kernels.tolerance import bf16_ulp
from omniquant_tpu_torch.quant import QuantConfig, pack_weight
from omniquant_tpu_torch.quant.packing import unpack_codes
from omniquant_tpu_torch.utils.convert import from_jax_params

# the JAX package's kernels/__init__ re-exports the function under the
# module's name
jqm = importlib.import_module("omniquant_tpu.kernels.quant_matmul")


def packed_pair(bits, group_size, out_f, in_f, layout, bias=False, seed=0):
    """A JAX PackedWeight and the same carried into the port."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32)
    b = rng.standard_normal(out_f).astype(np.float32) if bias else None
    jw = j_pack_weight(jnp.asarray(w), JQuantConfig(n_bits=bits,
                                                    group_size=group_size),
                       bias=None if b is None else jnp.asarray(b),
                       layout=layout)
    return jw, from_jax_params(jw, device="cpu")


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("bits,group_size,layout", [
    (4, 128, "pairs"), (3, 128, "pairs"), (2, None, "pairs"),
    (4, 64, "planar"), (6, 128, "planar"), (8, None, "planar"),
    (2, 64, "planar"), (3, 64, "planar"), (4, 32, "planar"),
    (6, 64, "planar"), (8, 128, "planar"),
])
def test_matches_jax_kernel(bits, group_size, layout, m):
    jw, tw = packed_pair(bits, group_size, 256, 640, layout, seed=bits)
    x = np.random.default_rng(m).standard_normal((m, 640)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert_close(got.numpy(), want)


def test_k_padding_bias_and_3d_input():
    """in_features 640 packs to k_pad 1024 (x is zero-padded, the groups
    past in_features reuse the last scale); bias added in x.dtype."""
    jw, tw = packed_pair(4, 128, 384, 640, "pairs", bias=True, seed=5)
    assert tw.k_pad == 1024 and tw.scales.shape == (384, 5)
    x = np.random.default_rng(6).standard_normal((2, 3, 640)).astype(
        np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 384)
    assert_close(got.numpy(), want)


def test_odd_n_routes_to_reference():
    """N % 128 != 0 goes to the dense reference in both packages."""
    jw, tw = packed_pair(4, 128, 200, 256, "pairs", seed=9)
    x = np.random.default_rng(10).standard_normal((5, 256)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul_reference(jnp.asarray(x), jw))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert_close(got.numpy(), want)
    np.testing.assert_allclose(
        tqm.quant_matmul_reference(torch.from_numpy(x), tw).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_large_m_dequant_once_route():
    """m >= 4096 with a column block below 1024 dequantizes once and calls
    a dense matmul, as the JAX package hands that case to XLA."""
    jw, tw = packed_pair(4, 128, 384, 512, "pairs", seed=41)
    x = np.random.default_rng(42).standard_normal((4096, 512)).astype(
        np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=False))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert_close(got.numpy(), want)
    assert tqm.quant_matmul.launches == 0  # no kernel on a CPU tensor


def test_bf16_input_close_to_f32_reference():
    """bf16 activations (the serving dtype) stay within bf16 rounding of
    the f32 product."""
    jw, tw = packed_pair(4, 128, 256, 512, "pairs", seed=3)
    x = np.random.default_rng(4).standard_normal((8, 512)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tqm.quant_matmul(xb, tw).float().numpy()
    want = np.asarray(jqm.quant_matmul(jnp.asarray(xb.float().numpy()), jw,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(
        want).max())


def test_planar_bf16_input_within_jax_weight_rounding():
    """bf16 activations on a planar W2 g64 weight. JAX's fine-group branch
    builds w = c*s + off in bf16 (s and off = -z*s rounded to bf16, the
    product and the sum rounded again), the port sums exact products in f32
    from the exact dequantized weight. Each step moves w by at most 2^-9 of
    its operand, so |w_jax - w| <= (3|c| + 2|z|) |s| 2^-9 (+ higher order)
    <= 2^-7 (|c| + |z|) |s|, and the outputs differ by at most 2^-7
    sum_k |x_k| (|c_k| + |z|) |s| plus a rounding step of each (2 bf16 ulps
    of JAX's output); the f32 order of the sums is far below that."""
    jw, tw = packed_pair(2, 64, 256, 640, "planar", seed=7)
    assert jw.layout == tw.layout == "planar"
    x = np.random.default_rng(8).standard_normal((8, 640)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tqm.quant_matmul(xb, tw).float().numpy()
    want = np.asarray(jqm.quant_matmul(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jw,
        interpret=True).astype(jnp.float32))
    codes = unpack_codes(tw.qweight, 2, 640, 64, tw.tile_k).numpy()  # (K, N)
    s = np.repeat(tw.scales.numpy().T, 64, axis=0)[:640]
    z = np.repeat(tw.zeros.numpy().T, 64, axis=0)[:640]
    mag = np.abs(xb.float().numpy()) @ ((np.abs(codes) + np.abs(z)) * np.abs(s))
    bound = 2.0 ** -7 * mag + 2 * bf16_ulp(torch.tensor(want)).numpy()
    assert np.all(np.abs(got - want) <= bound)
    assert np.abs(got - want).max() > 0  # JAX's rounding of w shows


SEVEN_B = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
           "down": (11008, 4096)}


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("shape", sorted(SEVEN_B))
def test_decode_plan_covers_every_tile_once(shape, m, sm_count):
    """K1's split-K plan for the decode tile (m <= 32), on the four 7B
    projections packed W4 g128: its slices lie on pack-tile boundaries,
    cover every tile exactly once and in order, hold at most
    _K1_SLICE_GROUPS quant groups, and the workspace is the (splits, m, N)
    f32 block the kernel writes (none for one slice)."""
    K, N = SEVEN_B[shape]
    tile_k = 512
    k_pad = -(-K // tile_k) * tile_k
    plan = tqm.decode_plan(m, N, k_pad, tile_k, 128, sm_count)
    slices = plan.slices()
    assert plan.n_tiles == k_pad // tile_k
    assert len(slices) == plan.splits >= 1
    covered = [t for lo, hi in slices for t in range(lo, hi)]
    assert covered == list(range(plan.n_tiles))
    assert all(hi > lo for lo, hi in slices)
    assert all((hi - lo) * tile_k // 128 <= tqm._K1_SLICE_GROUPS
               for lo, hi in slices)
    # the kernel takes slice s as tiles [s * per, min((s + 1) * per, n))
    assert (plan.splits - 1) * plan.per < plan.n_tiles <= plan.splits * plan.per
    assert plan.workspace == ((plan.splits, m, N) if plan.splits > 1
                              else None)
    # enough CTAs of 128 columns to put work on every SM
    assert (N // tqm._K1_BN) * plan.splits >= min(
        sm_count, (N // tqm._K1_BN) * plan.n_tiles)


def test_decode_plan_prefill_and_per_channel():
    """m > 32 (the prefill tile) runs unsplit; per-channel scales (one group
    over k_pad) put no cap on a slice's tiles."""
    plan = tqm.decode_plan(33, 4096, 11264, 512, 128, 132)
    assert plan.splits == 1 and plan.workspace is None
    assert plan.slices() == [(0, 22)]
    grouped = tqm.decode_plan(8, 22016, 11264, 512, 128, 132)
    chan = tqm.decode_plan(8, 22016, 11264, 512, 11264, 132)
    assert grouped.per * 512 // 128 <= tqm._K1_SLICE_GROUPS
    assert chan.per > grouped.per
    assert chan.slices() == [(0, 8), (8, 16), (16, 22)]


def test_cuda_wrapper_refuses_a_tile_of_other_than_8_word_multiples():
    """Both CUDA tiles take pack tiles of a multiple of 8 words per column,
    as pack_tile makes them; the wrapper refuses any other before it looks
    for the card."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 64)).astype(np.float32))
    pw = pack_weight(w, QuantConfig(n_bits=4, group_size=None),
                     layout="pairs", tile_k=32)  # 4 words per column
    pw = pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="8 words"):
        tqm._qmm_cuda(x, pw)


@pytest.mark.parametrize("group_rows", [32, 64, 11264])
@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("shape", sorted(SEVEN_B))
def test_decode_plan_planar_groups(shape, m, group_rows):
    """The plan for planar weights (512-row tiles at every width): g32 and
    g64 groups, and per-channel scales (one group over k_pad). A slice holds
    at most _K1_SLICE_GROUPS groups, or one tile where a tile holds more
    (g32: 16), so its scale block fits in shared memory (at most 16 groups
    x 128 columns x 4 bytes = 8 KB)."""
    K, N = SEVEN_B[shape]
    k_pad = -(-K // 512) * 512
    plan = tqm.decode_plan(m, N, k_pad, 512, min(group_rows, k_pad), 132)
    slices = plan.slices()
    assert [t for lo, hi in slices for t in range(lo, hi)] == list(
        range(plan.n_tiles))
    groups = [-(-(hi - lo) * 512 // min(group_rows, k_pad)) for lo, hi in slices]
    assert max(groups) <= max(tqm._K1_SLICE_GROUPS, 512 // group_rows)
    assert max(groups) * 128 * 4 <= 8 * 1024
    assert plan.workspace == ((plan.splits, m, N) if plan.splits > 1
                              else None)


def _bf16_packed(bits, group_size, in_f, layout, tile_k=None, out_f=128):
    w = torch.from_numpy(np.random.default_rng(bits).standard_normal(
        (out_f, in_f)).astype(np.float32))
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout=layout, tile_k=tile_k)
    return pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)


@pytest.mark.parametrize("bits,group_size,layout", [
    (2, 32, "planar"), (2, 64, "planar"), (3, 64, "planar"),
    (4, 32, "planar"), (6, 64, "planar"), (6, 128, "planar"),
    (8, 128, "planar"), (8, None, "planar"), (3, None, "planar"),
    (4, 64, "pairs"), (2, 128, "pairs"), (3, None, "pairs")])
def test_cuda_wrapper_takes_each_layout(bits, group_size, layout):
    """Every weight K1 takes passes its per-layout checks: on the CPU the
    wrapper then stops only at the card (a CPU qweight)."""
    pw = _bf16_packed(bits, group_size, 1024, layout)
    assert pw.layout == layout
    x = torch.zeros(4, 1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tqm._qmm_cuda(x, pw)


@pytest.mark.parametrize("bits,group_size,layout,tile_k,match", [
    (4, 32, "pairs", None, "multiple of 64"),
    (4, 16, "planar", None, "multiple of 32"),
    (8, None, "planar", 16, "8 low-plane words"),
    (4, 128, "planar", None, "bf16 scales"),
    (4, 128, "planar", None, "bf16 x")])
def test_cuda_wrapper_refuses_per_layout(bits, group_size, layout, tile_k,
                                         match):
    """What K1 does not take raises with its reason before the wrapper looks
    for the card: pairs groups below 64 rows, planar groups below 32, a
    planar tile of fewer than 8 low-plane words per column, f32 scales and
    f32 x."""
    pw = _bf16_packed(bits, group_size, 256, layout, tile_k)
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    if match == "bf16 scales":
        pw = pw.map_tensors(
            lambda t: t.float() if t.is_floating_point() else t)
    if match == "bf16 x":
        x = x.float()
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tqm._qmm_cuda(x, pw)


@pytest.mark.parametrize("bits,in_f,decode", [
    (2, 4096, True), (3, 4096, True), (4, 4096, True), (6, 11008, True),
    (8, 4096, True), (2, 256, True), (3, 256, False), (6, 256, True),
    (2, 128, False), (4, 64, False), (8, 32, False)])
def test_planar_decode_tile_geometry(bits, in_f, decode):
    """The decode tile takes a planar weight whose low blocks hold whole
    steps (every width at the 7B tiles of 512 rows); smaller tiles run on
    the prefill tile at every m."""
    pw = _bf16_packed(bits, None, in_f, "planar")
    assert tqm._planar_decode(pw) == decode


def _codes_bf16x2(v, sh, bits):
    """The kernel's pairs unpack: a word shifted to a field, both 16-bit
    halves masked (row k in the low half, row k + 1 in the high half)."""
    v = (v >> sh) & (((1 << bits) - 1) * 0x00010001)
    return v & 0xFFFF, v >> 16


def _byte_perm(a, b, sel):
    """__byte_perm for the two selectors the kernel uses: 0x5410 puts the
    low 16-bit halves of a and b side by side, 0x7632 the high ones."""
    if sel == 0x5410:
        return (a & 0xFFFF) | ((b & 0xFFFF) << 16)
    return (a >> 16) | (b & 0xFFFF0000)


def _permute_pairs(ws):
    """The prefill tile's in-place permute of a planar tile's word pairs
    (rows 2r, 2r + 1): row 2r takes their low 16-bit halves side by side,
    row 2r + 1 their high halves."""
    out = ws.copy()
    out[0::2] = _byte_perm(ws[0::2], ws[1::2], 0x5410)
    out[1::2] = _byte_perm(ws[0::2], ws[1::2], 0x7632)
    return out


def _planar_pair(wp, w, hw, p, sel, bits, cols):
    """The prefill tile's planar unpack of a k-pair from the permuted words
    wp: slot p of pair w (w even) is in row w (slots below half a word's)
    or w + 1, shifted and masked; with two planes the high pair at row hw,
    slot f = 2p + sel, likewise, above the low bits."""
    lo_bits = {3: 2, 6: 4}.get(bits, bits)
    hi_bits = bits - lo_bits
    hs = 32 // lo_bits // 2
    assert w % 2 == 0 and hw % 2 == 0
    c = (wp[w + (p >= hs), cols] >> (lo_bits * (p if p < hs else p - hs))) & (
        ((1 << lo_bits) - 1) * 0x00010001)
    if hi_bits:
        hf, f = 16 // hi_bits, 2 * p + sel
        hi = (wp[hw + (f >= hf), cols] >> (hi_bits * (f if f < hf else f - hf))
              ) & (((1 << hi_bits) - 1) * 0x00010001)
        c = c | (hi << lo_bits)
    return c & 0xFFFF, c >> 16


def _emulate_prefill(pw, group_rows):
    """K1's prefill tile, emulated lane by lane for one CTA's 128 columns:
    per pack tile the resident words, per step kc x columns, per k16 block
    the run counters (run, rr) that pick each B register's word rows and
    bit offset, the group counters (gl, rg) that close groups, and the
    tile's (scale, zero) group per close. Returns (codes the MMAs see at
    each row, times each row was fed, closes as (first row, end row, scale
    group)) and checks the counters end each tile where the kernel resets
    them."""
    plan = tqm.prefill_plan(pw.layout, pw.bits, pw.tile_k, group_rows,
                            pw.k_pad)
    T, k_pad, bits, PR = pw.tile_k, pw.k_pad, pw.bits, plan.run_rows
    words = pw.qweight.numpy().astype(np.int64) & 0xFFFFFFFF
    cols = np.arange(128)  # cw + nt * 8 + g over the warps, tiles, lanes
    G = pw.scales.shape[1]
    gse = min(group_rows, T)
    codes = np.full((k_pad, 128), -1, dtype=np.int64)
    fed = np.zeros(k_pad, dtype=np.int64)
    closes = []
    for t in range(k_pad // T):
        ws = words[t * plan.words:(t + 1) * plan.words]
        if pw.layout == "planar":
            ws = _permute_pairs(ws)
        run = rr = gl = rg = 0
        open_row = t * T
        for step in range(plan.steps):
            for kk in range(plan.kc // 16):
                k16 = t * T + step * plan.kc + kk * 16  # the x columns
                for h in range(2):
                    for t4 in range(4):
                        row = k16 + 2 * t4 + 8 * h
                        if pw.layout == "pairs":
                            lo, hi = _codes_bf16x2(
                                ws[rr // 2 + t4 + 4 * h, cols], bits * run,
                                bits)
                        else:
                            wrap = int(rr + 8 >= PR)
                            p = run + (wrap if h else 0)
                            w = rr + 8 * h - (PR if h and wrap else 0) + (
                                2 * t4)
                            sel, hw = 0, w
                            if bits in (3, 6):
                                sel = int(w >= PR // 2)
                                hw = PR + w - sel * (PR // 2)
                            lo, hi = _planar_pair(ws, w, hw, p, sel, bits,
                                                  cols)
                        codes[row], codes[row + 1] = lo, hi
                        fed[row] += 1
                        fed[row + 1] += 1
                rr += 16
                while rr >= PR:
                    rr, run = rr - PR, run + 1
                # a group closes after the block where its rows end: inside
                # the step (every kg blocks) or with it
                rg += 16
                if (plan.kg and (kk + 1) % plan.kg == 0) or (
                        not plan.kg and kk + 1 == plan.kc // 16
                        and rg == gse):
                    assert rg == gse
                    end = k16 + 16
                    closes.append((open_row, end,
                                   min(t * T // group_rows + gl, G - 1)))
                    open_row, rg, gl = end, 0, gl + 1
        assert (rr, rg, gl) == (0, 0, plan.groups)
        assert run * PR == T
    return codes, fed, closes


def _ring_waits_hold(n_tiles, spt, stages, full_wait_short=True):
    """The cp.async schedule: group s + stages - 1 carries step s's x
    columns, and a tile's first step also carries the next tile's words;
    step s waits with wait_group<stages - 2> (wait_group<0> at a tile's
    first step when a tile has fewer steps than the ring holds). Whether
    every step finds its x columns and its tile's words landed."""
    n_steps = n_tiles * spt
    words_group = {0: 0}  # tile -> the group that carries its words
    committed = stages - 1
    for s in range(n_steps):
        t, first = divmod(s, spt)[0], s % spt == 0
        pending = (0 if full_wait_short and first and spt < stages - 1
                   else stages - 2)
        done = committed - 1 - pending  # every group up to this one landed
        if s > done or words_group[t] > done:
            return False
        if first and t + 1 < n_tiles:
            words_group[t + 1] = committed
        committed += 1
    return True


PREFILL_CASES = [
    # pairs: 4-bit g128 (7B), g64 (two groups per field), per-channel;
    # 3-bit (640-row tiles, 5 fields); 2-bit (8 fields, 64-row runs);
    # per-channel tiles of 160 and 80 rows (16-column steps) and 64 rows
    ("pairs", 4, 128, 1408), ("pairs", 4, 64, 1408), ("pairs", 4, None, 1408),
    ("pairs", 3, 128, 1408), ("pairs", 3, None, 1408), ("pairs", 2, 128, 1408),
    ("pairs", 2, 256, 1280), ("pairs", 3, None, 160), ("pairs", 3, None, 80),
    ("pairs", 4, None, 64),
    # planar at every width and group, 512-row tiles and k_pad > K
    *[("planar", b, g, 1408) for b in (2, 3, 4, 6, 8)
      for g in (32, 64, 128, None)],
    # tiles too small for a decode step (slots of 8 rows: a k16 block spans
    # two slots), and 2-bit g192 (384-row tiles, slots of 24 rows)
    ("planar", 3, None, 256), ("planar", 2, None, 128), ("planar", 8, None, 32),
    ("planar", 4, None, 64), ("planar", 6, None, 256), ("planar", 2, 192, 768),
]


@pytest.mark.parametrize("layout,bits,group_size,in_f", PREFILL_CASES)
def test_prefill_tile_emulation_feeds_every_code(layout, bits, group_size,
                                                 in_f):
    """K1's prefill tile (m > 32) in numpy, lane by lane: each B register's
    word rows and bit offset, from the run counters, give the codes
    unpack_codes gives for the rows of the x columns the step holds, for
    every row of k_pad exactly once; each group closes once, where its rows
    end (per-channel: at each tile's end), with the scales of its own group
    (the padding past in_features reuses the last); and the cp.async ring
    finds every step's x columns and words landed."""
    w = torch.from_numpy(np.random.default_rng(bits * 7 + in_f).integers(
        -8, 8, (128, in_f)).astype(np.float32))
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout=layout)
    assert pw.layout == layout
    group_rows = group_size or pw.k_pad
    codes, fed, closes = _emulate_prefill(pw, group_rows)
    want = unpack_codes(pw.qweight, bits, pw.k_pad, group_size, pw.tile_k,
                        layout).numpy()
    assert np.array_equal(fed, np.ones(pw.k_pad))
    assert np.array_equal(codes, want)
    assert [c[0] for c in closes[1:]] == [c[1] for c in closes[:-1]]
    assert closes[0][0] == 0 and closes[-1][1] == pw.k_pad
    G = pw.scales.shape[1]
    for lo, hi, grp in closes:
        if group_size:
            assert hi - lo == group_size
            assert grp == min(lo // group_size, G - 1)
        else:
            assert hi - lo == pw.tile_k and grp == 0
    plan = tqm.prefill_plan(layout, bits, pw.tile_k, group_rows, pw.k_pad)
    assert _ring_waits_hold(pw.k_pad // pw.tile_k, plan.steps, plan.stages)


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 22])
@pytest.mark.parametrize("spt", [1, 2, 3, 4, 5, 8, 16, 20])
def test_prefill_ring_schedule(n_tiles, spt, stages):
    """The ring's waits hold for every tile length, and the shortcut that
    waits for the group of the first step alone would not hold for tiles
    shorter than the ring."""
    assert _ring_waits_hold(n_tiles, spt, stages)
    assert _ring_waits_hold(n_tiles, spt, stages, full_wait_short=False) == (
        n_tiles == 1 or spt >= stages - 1)


def test_prefill_plan_refuses_what_the_tile_does_not_take():
    """A pack tile of more than 128 words per column (pairs W4 g2048) or
    with more than 16 groups raises with its reason before the wrapper
    looks for the card; the 7B tiles pass."""
    assert tqm.prefill_plan("pairs", 4, 512, 128, 4096)[:7] == (
        128, 8, 4, 2, 128, 64, 4)
    assert tqm.prefill_plan("pairs", 4, 512, 4096, 4096)[:2] == (128, 0)
    # 128-column steps close g64 groups every 4 k16 blocks inside a step
    assert tqm.prefill_plan("planar", 2, 512, 64, 11264)[:7] == (
        128, 4, 4, 2, 32, 32, 8)
    assert tqm.prefill_plan("planar", 2, 512, 32, 11264)[:2] == (128, 2)
    # 192-row groups: a 128-column step would split one
    assert tqm.prefill_plan("planar", 2, 384, 192, 768)[:2] == (64, 0)
    assert tqm.prefill_plan("pairs", 3, 80, 80, 80).kc == 16
    # 128 words per column and 16 groups (pairs W2 g128 in 2048-row tiles)
    # leave no room for 128-column steps: 64
    w2 = tqm.prefill_plan("pairs", 2, 2048, 128, 4096)
    assert (w2.words, w2.groups, w2.kc) == (128, 16, 64)
    assert w2.smem <= tqm._K1_PF_SMEM < tqm._prefill_smem(128, 128, False, 16)
    assert tqm.prefill_plan("planar", 8, 512, 11264, 11264).words == 128
    with pytest.raises(NotImplementedError, match="128 words"):
        tqm.prefill_plan("pairs", 4, 2048, 2048, 4096)
    with pytest.raises(NotImplementedError, match="16 whole groups"):
        tqm.prefill_plan("planar", 4, 1024, 32, 2048)
    pw = _bf16_packed(4, 2048, 4096, "pairs")
    assert pw.tile_k == 2048
    with pytest.raises(NotImplementedError, match="prefill tile"):
        tqm._qmm_cuda(torch.zeros(64, 4096, dtype=torch.bfloat16), pw)
    with pytest.raises(ValueError, match="CUDA tensor"):  # decode tile
        tqm._qmm_cuda(torch.zeros(8, 4096, dtype=torch.bfloat16), pw)
