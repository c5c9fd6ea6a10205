"""The port's packed matmul (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, in f32.

Tolerance: rtol 1e-4 plus an absolute 1e-5 of the output's largest
magnitude. The two sum in different orders, and the JAX pairs path folds
the zero point into a rank-1 term whose f32 cancellation leaves an error
proportional to the output scale rather than to each element."""
import dataclasses
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
    """The planar decode tile's plan (W2, 512-row tiles) for g32 and g64
    groups and per-channel scales (one group over k_pad): its slices are
    whole steps of the K walk, cover every step exactly once and in order,
    and the slice count, set by the card (the CTAs an SM holds) and not by
    the group size, is the one of least modelled time on the busiest SM;
    the workspace is the (splits, m, N) f32 block the kernel writes."""
    K, N = SEVEN_B[shape]
    k_pad = -(-K // 512) * 512
    G = -(-K // min(group_rows, K))
    geo = tqm.planar_decode_geometry(2, m, 512, min(group_rows, k_pad), G)
    n_steps = k_pad // 512 * geo.spt
    plans = {}
    for ctas in (2, 3, 4):
        plan = tqm.planar_decode_plan(m, N, n_steps, 132, ctas)
        slices = plan.slices()
        assert [s for lo, hi in slices for s in range(lo, hi)] == list(
            range(n_steps))
        assert all(hi > lo for lo, hi in slices)
        assert (plan.splits - 1) * plan.per < n_steps <= plan.splits * plan.per
        assert plan.workspace == ((plan.splits, m, N) if plan.splits > 1
                                  else None)

        def cost(splits, per):
            c = -(-(N // 128) * splits // 132)
            return (-(-c // ctas) * max(min(c, ctas),
                                        tqm._K1_PL_MIN_LOAD[m > 8])
                    * (per + tqm._K1_PL_CTA_STEPS))
        every = {-(-n_steps // (-(-n_steps // s))): -(-n_steps // s)
                 for s in range(1, n_steps + 1)}
        assert cost(plan.splits, plan.per) == min(
            cost(sp, per) for sp, per in every.items())
        plans[ctas] = plan
    # the group size does not enter the plan
    other = tqm.planar_decode_geometry(2, m, 512, k_pad, 1)
    assert other.spt == geo.spt
    assert tqm.planar_decode_plan(m, N, n_steps, 132, 3) == plans[3]


# split counts an H100 (NVIDIA H100 80GB HBM3) ran fastest, by 3 % or more
# over the next, for 7B products (W2/W3/W4 g64, W6 g128, W8 per-channel at
# m = 32 and 8, each timed at every split count), where the plan's model
# reaches them: (m, N, steps of the K walk, CTAs an SM held) -> splits
CARD_SPLITS = {(8, 4096, 8, 3): 8, (8, 4096, 8, 4): 8, (8, 4096, 16, 3): 8,
               (8, 4096, 22, 3): 11, (8, 4096, 22, 4): 11,
               (8, 4096, 44, 3): 11, (8, 4096, 44, 4): 11,
               (8, 12288, 8, 3): 4, (8, 12288, 16, 3): 4,
               (8, 12288, 32, 5): 4, (8, 22016, 8, 3): 2,
               (32, 4096, 8, 2): 8, (32, 4096, 8, 3): 8,
               (32, 4096, 16, 3): 8, (32, 4096, 22, 2): 8,
               (32, 4096, 32, 3): 8, (32, 12288, 8, 3): 4,
               (32, 12288, 16, 3): 4, (32, 12288, 32, 3): 4,
               (32, 22016, 8, 2): 3, (32, 22016, 8, 3): 2,
               (32, 22016, 16, 3): 2}


@pytest.mark.parametrize("key", sorted(CARD_SPLITS))
def test_planar_decode_plan_takes_the_cards_splits(key):
    """The plan's model gives the split count the card ran fastest for the
    7B shapes where the model reaches it."""
    m, n, n_steps, ctas = key
    plan = tqm.planar_decode_plan(m, n, n_steps, 132, ctas)
    assert plan.splits == CARD_SPLITS[key]


@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("bits,group_size", [
    (2, 64), (3, 64), (4, 64), (6, 128), (8, None), (2, 32), (3, None)])
def test_planar_decode_geometry_fits_two_ctas(bits, group_size, m):
    """At the 7B tiles (512 rows) every width puts two or more CTAs of the
    decode tile on an SM by shared memory (228 KB an SM, 1 KB reserved per
    CTA), three at 2, 4, 6 and 8 bits and m = 32; a sub-step stages at most
    16 KB of x, and the steps of a tile cover its low plane."""
    K = 4096
    G = K // group_size if group_size else 1
    geo = tqm.planar_decode_geometry(bits, m, 512, group_size or K, G)
    fits = 233472 // (geo.smem + 1024)
    assert fits >= 2 and geo.smem <= tqm._K1_PF_SMEM
    if m == 32 and bits != 3 and group_size != 32:
        assert fits >= 3
    assert geo.x_bytes <= 16384
    assert geo.spt * geo.ws * geo.nsel == 512 * {3: 2, 6: 4}.get(
        bits, bits) // 32


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


def _planar_fragments(ws, hh, r0, col_ids):
    """The decode tile's word pairs as registers (``planar_words``): for
    block rows r0 and r0 + 1 (rows 16kb + 2*t4 + 8*(e >> 1)), half hh of
    each word side by side."""
    return _byte_perm(ws[r0][col_ids], ws[r0 + 1][col_ids],
                      0x7632 if hh else 0x5410)


def _ldmatrix_b(xsm, q, kb, ws_, mn):
    """B fragments of one k16 block of run q from the swizzled x stage:
    lane L of the ldmatrix addresses row nt*8 + (L >> 4)*8 + (L & 7) at
    chunk (q*ws/8 + 2kb + ((L >> 3) & 1)) XOR (L & 7); lane L receives
    elements 2*(L & 3), +1 of matrix i's row L >> 2. Returns the (8*mn, 16)
    x block the MMA's B operand holds: B[k][n] at [n][k]."""
    xb = np.zeros((8 * mn, 16), dtype=xsm.dtype)
    lanes = np.arange(32)
    for nt in range(0, mn, 2):
        rows = nt * 8 + (lanes >> 4) * 8 + (lanes & 7)
        chunks = ((q * (ws_ // 8) + 2 * kb + ((lanes >> 3) & 1))
                  ^ (lanes & 7))
        for i in range(4 if mn > 1 else 2):
            src = 8 * i + (lanes >> 2)  # the lane whose address gives the row
            vals = np.stack([xsm[rows[src], chunks[src] * 8 + 2 * (lanes & 3)
                                 + d] for d in range(2)], 1)
            g, t4 = lanes >> 2, lanes & 3
            tile = nt + (i >> 1)  # (nt, 0), (nt, 1), (nt + 1, 0), (nt + 1, 1)
            kh = 8 * (i & 1)
            xb[tile * 8 + g, kh + 2 * t4] = vals[:, 0]
            xb[tile * 8 + g, kh + 2 * t4 + 1] = vals[:, 1]
    return xb


def _emulate_planar_decode(pw, x, sm_count, ctas, order_seed):
    """K1's planar decode tile in numpy, CTA by CTA: the ring's loads
    (a step's words, a sub-step's x columns swizzled by row, a pack tile's
    (scale, zero) planes copied in 4-byte words from the element before an
    odd first one), each load issued before the sub-step ahead of it is
    computed, as on the card; per half of a step the word pairs permuted
    into registers that shift in place one slot a run; the A fragments'
    codes, the B fragments by ldmatrix; the group closes with the staged
    pairs; then each column block's slices finish in a random order, take
    tickets, and the last adds every slice's sums in slice order. Returns y
    (m, N) in f64, how often each code was fed, and the closes as
    (column block, slice, first row, end row, group)."""
    bits, T, k_pad = pw.bits, pw.tile_k, pw.k_pad
    N, G = pw.qweight.shape[1], pw.scales.shape[1]
    gs = pw.group_size or k_pad
    m, K = x.shape
    geo = tqm.planar_decode_geometry(bits, m, T, gs, G)
    P, _, nsel = tqm._planar_geometry(bits, T)
    B, WS, KB, NSUB, RUNS = P // nsel, geo.ws, geo.kb, geo.nsub, geo.runs
    lo_b = {3: 2, 6: 4}.get(bits, bits)
    hi_b, V = bits - lo_b, 32 // lo_b
    HS, WPT, spt = V // 2, T * bits // 32, geo.spt
    n_steps = k_pad // T * spt
    plan = tqm.planar_decode_plan(m, N, n_steps, sm_count, ctas)
    mn = next(n for n in (1, 2, 4) if m <= 8 * n)
    MR = 8 * mn
    words = pw.qweight.numpy().astype(np.int64) & 0xFFFFFFFF
    s_el = (pw.scales.view(torch.int16).numpy().astype(np.int64)
            & 0xFFFF).reshape(-1)
    z_el = (pw.zeros.view(torch.int16).numpy().astype(np.int64)
            & 0xFFFF).reshape(-1)
    bf = lambda v: (v.astype(np.uint32) << 16).view(np.float32).astype(
        np.float64)
    xpad = np.zeros((MR, k_pad))
    xpad[:m, :K] = x
    want_codes = unpack_codes(pw.qweight, bits, k_pad, pw.group_size, T,
                              "planar").numpy()
    fed = np.zeros((k_pad, N), dtype=np.int64)
    y = np.zeros((MR, N))
    closes = []
    rng = np.random.default_rng(order_seed)
    # the A-fragment lanes: column g + 8*(e & 1) + 16*mc + 32*w
    w_, g_ = np.arange(4)[:, None], np.arange(8)[None, :]
    lane_cols = {(mc, e1): (32 * w_ + 16 * mc + g_ + 8 * e1).reshape(-1)
                 for mc in range(2) for e1 in range(2)}
    mlo, mhi = (1 << lo_b) - 1, (1 << hi_b) - 1
    for cb in range(N // 128):
        col0 = 128 * cb
        partial = []
        for s, (s0, s1) in enumerate(plan.slices()):
            n_sub, t_first = (s1 - s0) * NSUB, s0 // spt
            wst, xst, szs, szt = [None] * 2, [None] * 2, [None] * 2, [None] * 2

            def load_sub(j):
                step, h = s0 + j // NSUB, j % NSUB
                t, w0 = step // spt, (step % spt) * WS
                if h == 0:
                    rows = [b * B + w0 + r for b in range(nsel)
                            for r in range(WS)]
                    rows += [P + w0 + r for r in range(WS)] if nsel == 2 else []
                    wst[(step - s0) & 1] = words[t * WPT + np.array(rows),
                                                 col0:col0 + 128]
                    if step == s0 or w0 == 0:
                        gt0 = t * T // gs
                        nv = min(((t + 1) * T - 1) // gs, G - 1) - gt0 + 1
                        slot = np.full((2, 128, geo.ngp), -1, dtype=np.int64)
                        nw0 = (nv + 2) >> 1
                        for i in range(128 * nw0):
                            c, w = divmod(i, nw0)
                            e0 = (col0 + c) * G + gt0
                            e = (e0 & ~1) + 2 * w
                            if e < e0 + nv:
                                for d in range(2):
                                    ok = e + d < N * G
                                    slot[0, c, 2 * w + d] = s_el[e + d] if ok else 0
                                    slot[1, c, 2 * w + d] = z_el[e + d] if ok else 0
                        szs[(t - t_first) & 1] = slot
                        szt[(t - t_first) & 1] = t
                xsm = np.zeros((MR, RUNS * WS))
                for q in range(RUNS):
                    u = h * RUNS + q
                    gc = t * T + w0 + (u // nsel) * P + (u % nsel) * B
                    for c8 in range(0, WS, 8):
                        for r in range(MR):
                            ch = ((q * WS + c8) >> 3) ^ (r & 7)
                            xsm[r, ch * 8:ch * 8 + 8] = xpad[r, gc + c8:gc + c8 + 8]
                xst[j & 1] = xsm

            load_sub(0)
            acc = np.zeros((128, MR))
            for step in range(s0, s1):
                t, w0 = step // spt, (step % spt) * WS
                gt0 = t * T // gs
                nv = min(((t + 1) * T - 1) // gs, G - 1) - gt0 + 1
                assert szt[(t - t_first) & 1] == t  # its own tile's pairs
                slot = szs[(t - t_first) & 1]
                krow = t * T + w0
                gi, g_hi = krow // gs, (krow // gs + 1) * gs
                pt, xs = np.zeros((128, MR)), np.zeros(MR)
                open_rows = []
                for h in range(NSUB):
                    j = (step - s0) * NSUB + h
                    if j + 1 < n_sub:
                        load_sub(j + 1)  # issued before this sub-step's MMAs
                    ws_all, xsm = wst[(step - s0) & 1], xst[j & 1]
                    for hh in ([h] if NSUB == 2 else [0, 1]):
                        # registers per (block, kb, mc, e, t4): 32 lanes' words
                        cl = {(b, kb, mc, e, t4): _planar_fragments(
                            ws_all[b * WS:], hh, 16 * kb + 2 * t4 + 8 * (e >> 1),
                            lane_cols[(mc, e & 1)])
                            for b in range(nsel) for kb in range(KB)
                            for mc in range(2) for e in range(4) for t4 in range(4)}
                        chh = {(kb, mc, e, t4): _planar_fragments(
                            ws_all[2 * WS:], hh, 16 * kb + 2 * t4 + 8 * (e >> 1),
                            lane_cols[(mc, e & 1)])
                            for kb in range(KB) for mc in range(2)
                            for e in range(4) for t4 in range(4)} if nsel == 2 else {}
                        for p in range(hh * HS, (hh + 1) * HS):
                            for b in range(nsel):
                                u = p * nsel + b
                                q = u - h * RUNS
                                rrow = krow + p * P + b * B  # the run's first row
                                for kb in range(KB):
                                    a = np.zeros((128, 16), dtype=np.int64)
                                    for (bb, k2, mc, e, t4), reg in cl.items():
                                        if bb != b or k2 != kb:
                                            continue
                                        c = reg & (mlo * 0x00010001)
                                        if nsel == 2:
                                            hreg = chh[(kb, mc, e, t4)]
                                            c = c | ((hreg & (mhi * 0x00010001)) << lo_b)
                                            chh[(kb, mc, e, t4)] = hreg >> hi_b
                                        k = 2 * t4 + 8 * (e >> 1)
                                        cols = lane_cols[(mc, e & 1)]
                                        a[cols, k], a[cols, k + 1] = c & 0xFFFF, c >> 16
                                    rows = rrow + 16 * kb + np.arange(16)
                                    assert np.array_equal(
                                        a.T, want_codes[rows, col0:col0 + 128])
                                    fed[rows, col0:col0 + 128] += 1
                                    xb = _ldmatrix_b(xsm, q, kb, WS, mn)
                                    assert np.array_equal(xb, xpad[:, rows])
                                    pt += a.astype(np.float64) @ xb.T
                                    xs += xb.sum(1)
                                    open_rows.append(rows[0])
                                nxt = krow + ((u + 1) // nsel) * P + ((u + 1) % nsel) * B
                                if u + 1 == nsel * V or nxt >= g_hi:
                                    # every run in the sums lies in group gi
                                    assert {r // gs for r in open_rows} == {gi}
                                    gl = min(gi - gt0, nv - 1)
                                    cols = np.arange(128)
                                    sh = ((col0 + cols) * G + gt0) & 1
                                    sv = bf(slot[0, cols, sh + gl])
                                    zv = bf(slot[1, cols, sh + gl])
                                    want_g = np.minimum(gi, G - 1)
                                    assert np.array_equal(sv, bf(s_el[(col0 + cols) * G + want_g]))
                                    assert np.array_equal(zv, bf(z_el[(col0 + cols) * G + want_g]))
                                    acc += pt * sv[:, None] + xs[None, :] * (-zv * sv)[:, None]
                                    closes.append((cb, s, min(open_rows),
                                                   max(open_rows) + 16, gi))
                                    pt, xs, open_rows = np.zeros((128, MR)), np.zeros(MR), []
                                    while nxt >= g_hi:
                                        gi, g_hi = gi + 1, g_hi + gs
                            for key in cl:
                                cl[key] = cl[key] >> lo_b
            partial.append(acc.T)
        # tickets: the slices finish in any order; the last adds in order
        ticket, done = 0, None
        for s in rng.permutation(plan.splits):
            mine, ticket = ticket, ticket + 1
            if mine == plan.splits - 1:
                total = np.zeros((MR, 128))
                for k in range(plan.splits):
                    total = total + partial[k]
                y[:, col0:col0 + 128], done, ticket = total, s, 0
        assert done is not None and ticket == 0
    return y[:m], fed, closes, plan


PLANAR_DECODE_CASES = [(b, g) for b in (2, 3, 4, 6, 8)
                       for g in (32, 64, 128, None)]


@pytest.mark.parametrize("sm_count,ctas", [(132, 3), (1, 1)])
@pytest.mark.parametrize("m", [1, 17, 32])
@pytest.mark.parametrize("bits,group_size", PLANAR_DECODE_CASES)
def test_planar_decode_tile_emulation(bits, group_size, m, sm_count, ctas):
    """K1's planar decode tile (m <= 32) emulated lane by lane
    (``_emulate_planar_decode``) on a weight of in_features 640 (k_pad
    1024: x is zero past 640, the groups past it reuse the last group's
    scales): every code reaches its A fragment exactly once, every x
    element its B fragment, every group closes once with its own (scale,
    zero) pair, and the slices' sums, added by whichever slice takes the
    last ticket, give what the plain version and the JAX kernel give. At
    132 SMs of three CTAs the plan takes every step as a slice of its own,
    at one SM of one CTA a single slice."""
    w = torch.from_numpy(np.random.default_rng(bits * 31 + m).standard_normal(
        (256, 640)).astype(np.float32))
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout="planar")
    pw = pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    assert tqm._planar_decode(pw)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, 640)).astype(np.float32)).to(torch.bfloat16).float()
    got, fed, closes, plan = _emulate_planar_decode(pw, x.numpy(), sm_count,
                                                     ctas, order_seed=m)
    assert np.array_equal(fed, np.ones_like(fed))
    assert plan.splits == (1 if sm_count == 1 else plan.n_steps)
    gs = group_size or pw.k_pad
    for cb, s, lo, hi, gi in closes:
        assert lo // gs == gi and (hi - 1) // gs == gi
    want = tqm.quant_matmul_reference(x, pw.map_tensors(
        lambda t: t.float() if t.is_floating_point() else t)).numpy()
    assert_close(got, want)
    if m == 17 and ctas == 3:  # the JAX kernel, same bf16 scales
        jw = j_pack_weight(jnp.asarray(w.numpy()), JQuantConfig(
            n_bits=bits, group_size=group_size), layout="planar")
        jw = dataclasses.replace(
            jw, scales=jnp.asarray(pw.scales.float().numpy()),
            zeros=jnp.asarray(pw.zeros.float().numpy()))
        jy = np.asarray(jqm.quant_matmul(jnp.asarray(x.numpy()), jw,
                                         interpret=True))
        assert_close(got, jy)
