"""The port's flash attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, in f32 (rtol/atol 2e-5: the
blockwise online softmax and the dense one sum in different orders)."""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models.falcon import alibi_slopes
from omniquant_tpu_torch.kernels import flash_attention as tfa
from omniquant_tpu_torch.kernels import tolerance

jfa = importlib.import_module("omniquant_tpu.kernels.flash_attention")


def _qkv(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,alibi", [
    (2, 4, 4, 128, 64, True, False),
    (1, 4, 2, 200, 64, True, False),   # GQA, S no block multiple
    (1, 4, 1, 96, 32, True, True),     # MQA with ALiBi
    (1, 2, 2, 70, 128, False, False),  # not causal, ragged
    (1, 8, 2, 130, 128, True, True),   # GQA with ALiBi, ragged
])
def test_matches_jax_kernel(B, H, Hkv, S, D, causal, alibi):
    q, k, v = _qkv(B, H, Hkv, S, D, seed=S + H)
    slopes = np.array(alibi_slopes(H)) if alibi else None
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=128,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        interpret=True)
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_output_dtype_and_sm_scale():
    q, k, v = _qkv(1, 2, 2, 64, 64, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, sm_scale=0.3)
    assert got.dtype == torch.bfloat16
    want = jfa.flash_attention_reference(
        jnp.asarray(tq.float().numpy()), jnp.asarray(tk.float().numpy()),
        jnp.asarray(tv.float().numpy()), sm_scale=0.3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


def _emulate_cuda_kernel(q, k, v, sm_scale, fault=None, block=128,
                         causal=True, slopes=None):
    """The CUDA kernel's arithmetic in PyTorch: 128-row query tiles against
    128-key tiles (only up to the diagonal when causal), raw scores
    s = q.k in f32, the online softmax in the exp2 domain (m the running
    max of s, p = exp2(s*c - m*c), c = sm_scale * log2(e)), masks only on
    the causal diagonal tile and the tile holding key Skv - 1, each
    unnormalised p rounded to bf16 before p.v, the output rounded to bf16.
    ``fault`` plants a bug: "drop_tile" loses keys 256..383 for the rows
    from 512 on (a key tile lost on the long rows), "no_rescale" skips the
    rescale of the output accumulator. ``slopes`` (H,): ALiBi, folded in
    as s*c + slope*c*key, the max and exponent then taken on that."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    c = sm_scale * math.log2(math.e)
    rep = H // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    cs = 1.0 if slopes is not None else c
    out = torch.zeros(B, H, Sq, D)
    n_kv = -(-Skv // block)
    for iq in range(-(-Sq // block)):
        rows = torch.arange(iq * block, min(iq * block + block, Sq))[:, None]
        m = torch.full((B, H, len(rows), 1), -math.inf)
        l = torch.zeros(B, H, len(rows), 1)
        o = torch.zeros(B, H, len(rows), D)
        for jt in range(min(n_kv, iq + 1) if causal else n_kv):
            j0 = jt * block
            keys = torch.arange(j0, min(j0 + block, Skv))[None, :]
            s = qf[:, :, rows[:, 0]] @ kf[:, :, j0:j0 + block].transpose(
                -1, -2)
            if slopes is not None:
                s = s * c + (slopes.float() * c)[None, :, None, None] * (
                    keys.float())
            if (causal and jt == iq) or (jt == n_kv - 1 and Skv % block):
                ok = keys < Skv
                if causal:
                    ok = ok & (keys <= rows)
                s = torch.where(ok, s, torch.full_like(s, -math.inf))
            if fault == "drop_tile" and j0 == 256:
                s = torch.where(rows < 512, s, torch.full_like(s, -math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m * cs - m_new * cs)
            p = torch.exp2(s * cs - m_new * cs)
            l = l * alpha + p.sum(-1, keepdim=True)
            if fault != "no_rescale":
                o = o * alpha
            o = o + p.bfloat16().float() @ vf[:, :, j0:j0 + block]
            m = m_new
        out[:, :, rows[:, 0]] = o / l.clamp_min(1e-30)
    return out.bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_tile", "no_rescale"])
def test_card_tolerance_admits_rounding_and_rejects_faults(fault):
    """The per-element rule the card checks hold the CUDA kernel to admits
    what the kernel rounds (p to bf16 before p.v) and rejects a kernel that
    loses a key tile on the long rows or skips the rescale, at a prompt
    length where late rows' outputs are far below the row-0 magnitudes."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 4, 4, 1024, 128, seed=3))
    scale = 128 ** -0.5
    want = tfa.flash_attention(q, k, v, sm_scale=scale)
    got = _emulate_cuda_kernel(q, k, v, scale, fault)
    ok, _, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(q, k, v, sm_scale=scale))
    assert ok == (fault is None), worst


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,alibi", [
    (1, 2, 2, 256, 256, 128, True, False),   # two full tiles, the diagonal
    (1, 4, 2, 129, 129, 128, True, False),   # one past a 128 edge, GQA
    (1, 2, 2, 255, 255, 64, True, False),    # one short of a 128 edge
    (1, 4, 2, 300, 300, 64, True, True),     # ALiBi, ragged, GQA
    (1, 2, 2, 70, 300, 128, False, False),   # q and k extents apart
    (1, 2, 1, 1, 1, 128, True, False),       # a single query
])
def test_emulated_kernel_matches_plain(B, H, Hkv, Sq, Skv, D, causal, alibi):
    """The kernel's tiling with masks only on the causal diagonal tile and
    the tile holding key Skv - 1 (every other tile runs unmasked), the
    exp2-domain softmax with ALiBi folded in, and GQA by h // (H / Hkv),
    held to the card's per-element rule against the plain version."""
    rng = np.random.default_rng(Sq + Skv + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in (
        (B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    slopes = torch.from_numpy(np.array(alibi_slopes(H))) if alibi else None
    scale = D ** -0.5
    want = tfa.flash_attention(q, k, v, sm_scale=scale, causal=causal,
                               alibi_slopes=slopes)
    got = _emulate_cuda_kernel(q, k, v, scale, causal=causal, slopes=slopes)
    ok, _, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(
            q, k, v, sm_scale=scale, causal=causal, alibi_slopes=slopes))
    assert ok, worst


# ---------------------------------------------------------------------------
# The kernel's shared-memory and register layouts, emulated element by
# element: where TMA's 128-byte swizzle puts each element of a Q, K and V
# tile, which element each wgmma descriptor reads (K-major for Q and K,
# MN-major with the transpose bit for V), how the S accumulator becomes the
# register A fragment of P.V, and where the epilogue writes each output
# element for the TMA store. Mirrors csrc/flash_attention.cu and sm90.cuh.
FA_BOX = 128 * 128  # one box: 128 rows x 64 bf16 (128 bytes)


def _swizzle128(addr):
    """The 128-byte swizzle TMA writes and wgmma reads: 16-byte chunk bits
    [4:6] of a shared address XOR its 128-byte row bits [7:9]."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_tile(base, rows, D, tag):
    """Shared memory after TMA loads a (rows, D) bf16 tile as D / 64 boxes
    of rows x 128 bytes at base + box * rows * 128, each box's row r with
    its 16-byte chunks XORed by r % 8: {address: element}. That agrees
    with the address bits wgmma swizzles by only where each box starts on
    a 1024-byte boundary."""
    smem = {}
    for cb in range(D // 64):
        for r in range(rows):
            for col in range(64):
                chunk, within = divmod(2 * col, 16)
                addr = (base + cb * rows * 128 + r * 128
                        + (chunk ^ (r % 8)) * 16 + within)
                smem[addr] = (tag, r, 64 * cb + col)
    return smem


def _desc_k(addr):
    """sm90.cuh desc_k_sw128: start >> 4, LBO 16 B, SBO 1024 B, layout 1."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32)
            | (1 << 62))


def _desc_mn(addr, lbo):
    """sm90.cuh desc_mn_sw128: start >> 4, LBO lbo (next 64 n), SBO 1024 B
    (next 8 k), layout 1."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | ((1024 >> 4) << 32) | (1 << 62))


def _wgmma_read(smem, desc, rows, k16, mn_major):
    """The operand elements a bf16 wgmma reads through ``desc``, as a
    (rows, 16) array of smem entries: element (i, kk) of a K-major operand
    at start + (i // 8) SBO + (i % 8) 128 + 2 kk; of an MN-major one
    (transpose bit set) at start + (i // 64) LBO + (kk // 8) SBO
    + (kk % 8) 128 + 2 (i % 64); each address then swizzled."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    out = np.empty((rows, k16), dtype=object)
    for i in range(rows):
        for kk in range(k16):
            if mn_major:
                lin = (start + (i // 64) * lbo + (kk // 8) * sbo
                       + (kk % 8) * 128 + 2 * (i % 64))
            else:
                lin = start + (i // 8) * sbo + (i % 8) * 128 + 2 * kk
            out[i, kk] = smem.get(_swizzle128(lin))
    return out


def _qk_offset(kk):
    """qk_issue: k16 step kk reads column 32 (kk % 4) of box kk / 4."""
    return (kk // 4) * FA_BOX + 32 * (kk % 4)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("fault", [None, "swizzle_phase", "v_no_transpose"])
def test_tma_swizzle_and_descriptors_feed_both_products(D, fault):
    """Q (128 rows), K and V (128 keys) as TMA writes them into the
    kernel's layout (two Q tiles, then per ring slot a K and a V tile, each
    D / 64 boxes of 16 KB), read through the descriptors qk_issue and
    pv_issue build: consumer cw's S step kk reads Q[64 cw + i, 16 kk + j]
    and K[n, 16 kk + j]; its P.V step kk reads V[16 kk + j, n] for every
    output column n < D (MN-major: LBO one box to the next 64 columns).
    Planted faults are caught: the layout's base 512 bytes off the
    1024-byte swizzle phase (as without the kernel's round-up), and V read
    K-major (no transpose bit)."""
    tile = D // 64 * FA_BOX
    assert FA_BOX % 1024 == 0 and (64 * 128) % 1024 == 0
    base = 512 if fault == "swizzle_phase" else 0
    q_s = base + tile      # the second query tile's Q: q_s(1)
    k_s = base + 4 * tile  # ring slot 1's K: k_s(1)
    v_s = base + 5 * tile  # ring slot 1's V: v_s(1)
    smem = {}
    smem.update(_tma_tile(q_s, 128, D, "q"))
    smem.update(_tma_tile(k_s, 128, D, "k"))
    smem.update(_tma_tile(v_s, 128, D, "v"))
    bad = 0
    for cw in range(2):
        q_w = q_s + cw * 64 * 128
        for kk in range(D // 16):
            a = _wgmma_read(smem, _desc_k(q_w + _qk_offset(kk)), 64, 16,
                            False)
            b = _wgmma_read(smem, _desc_k(k_s + _qk_offset(kk)), 128, 16,
                            False)
            for i in range(64):
                for j in range(16):
                    bad += a[i, j] != ("q", 64 * cw + i, 16 * kk + j)
            for n in range(128):
                for j in range(16):
                    bad += b[n, j] != ("k", n, 16 * kk + j)
    for kk in range(8):
        b = _wgmma_read(smem, _desc_mn(v_s + 2048 * kk, FA_BOX), D, 16,
                        fault != "v_no_transpose")
        for n in range(D):
            for j in range(16):
                bad += b[n, j] != ("v", 16 * kk + j, n)
    assert (bad == 0) == (fault is None), bad


def _acc_map(t, i):
    """The m64nN f32 accumulator of wgmma: thread t of the warpgroup,
    register i holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
    column 8 (i / 4) + 2 (t % 4) + i % 2."""
    return (16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (t % 4) + i % 2)


def _a_frag_map(t, r, e):
    """wgmma's register A fragment (bf16, k16): each warp's 16 rows as
    mma.m16n8k16's A; register r of thread t, half e (low first): row
    16 (t / 32) + g + 8 (r % 2), column 2 (t % 4) + e + 8 (r / 2)."""
    g, t4 = (t % 32) // 4, t % 4
    return 16 * (t // 32) + g + 8 * (r % 2), 2 * t4 + e + 8 * (r // 2)


def test_score_accumulator_is_the_pv_a_fragment():
    """The kernel packs p[kk][r] = (s[8 kk + 2 r], s[8 kk + 2 r + 1]) into
    bf16 pairs: through the accumulator map and the A fragment map that
    gives every thread exactly the P entries of step kk (keys 16 kk..) that
    the P.V wgmma takes from it, so P.V computed from the fragments is
    P @ V; the 64 x D output accumulator covers the warpgroup's tile once.
    Pairing the halves the other way round is caught."""
    rng = np.random.default_rng(0)
    P = rng.standard_normal((64, 128))
    V = rng.standard_normal((128, 128))

    def product(swap):
        regs = np.empty((128, 64))
        for t in range(128):
            for i in range(64):
                regs[t, i] = P[_acc_map(t, i)]
        O = np.zeros((64, 128))
        for kk in range(8):
            A = np.full((64, 16), np.nan)
            for t in range(128):
                for r in range(4):
                    pair = (regs[t, 8 * kk + 2 * r],
                            regs[t, 8 * kk + 2 * r + 1])
                    for e in range(2):
                        A[_a_frag_map(t, r, e)] = pair[e ^ swap]
            assert not np.isnan(A).any()
            O += A @ V[16 * kk:16 * kk + 16]
        return O

    np.testing.assert_allclose(product(0), P @ V, rtol=1e-12, atol=1e-12)
    assert not np.allclose(product(1), P @ V)
    cover = np.zeros((64, 128), int)
    for t in range(128):
        for i in range(64):
            cover[_acc_map(t, i)] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("D", [64, 128])
def test_epilogue_writes_what_the_tma_store_reads(D):
    """The epilogue's shared-memory writes (thread t, output register pair
    (4 j + 2 h, + 1) at box j / 8 of the warpgroup's rows, row
    r = 16 (t / 32) + g + 8 h, 16-byte chunk (j % 8) ^ g, + 4 (t % 4)
    bytes) land where the TMA store of each 64-row x 64-column box,
    swizzled like the loads, reads output element (r, col); a warp's 32
    4-byte writes of one j and h hit 32 distinct banks."""
    for cw in range(2):
        q_w = cw * 64 * 128
        stored = {}
        for cb in range(D // 64):
            for r in range(64):
                for col in range(64):
                    chunk, within = divmod(2 * col, 16)
                    addr = (q_w + cb * FA_BOX + r * 128
                            + (chunk ^ (r % 8)) * 16 + within)
                    stored[addr] = (r, 64 * cb + col)
        seen = set()
        for j in range(D // 8):
            for h in range(2):
                banks = set()
                for t in range(128):
                    g, t4 = (t % 32) // 4, t % 4
                    r = 16 * (t // 32) + g + 8 * h
                    off = ((j // 8) * FA_BOX + r * 128 + ((j % 8) ^ g) * 16
                           + 4 * t4)
                    for e in range(2):
                        row, col = _acc_map(t, 4 * j + 2 * h + e)
                        assert stored[q_w + off + 2 * e] == (row, col)
                        seen.add((row, col))
                    if t < 32:
                        banks.add((off // 4) % 32)
                assert len(banks) == 32
        assert len(seen) == 64 * D


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


def _pair_tiles(n_q, x):
    """The query tiles CTA x takes: n_q - 1 - x, then x (once if equal)."""
    return [n_q - 1 - x] if 2 * x + 1 == n_q else [n_q - 1 - x, x]


@pytest.mark.parametrize("n_q", [1, 2, 3, 8, 9, 32])
def test_query_tile_pairs_cover_once_and_balance(n_q):
    """The grid's (n_q + 1) / 2 CTAs of a head take each query tile once,
    the longest causal rows (the later tile) first, and every CTA with two
    tiles has the same causal work (n_q + 1 key tiles)."""
    seen = []
    for x in range((n_q + 1) // 2):
        tiles = _pair_tiles(n_q, x)
        assert tiles[0] == max(tiles)
        seen += tiles
        if len(tiles) == 2:
            assert sum(t + 1 for t in tiles) == n_q + 1
    assert sorted(seen) == list(range(n_q))


class _NamedBarrier:
    """bar.sync / bar.arrive with a count of 256: a generation completes
    when 256 threads have arrived (bar.sync waits for it, bar.arrive does
    not)."""

    def __init__(self):
        self.count, self.gen = 0, 0

    def arrive(self, n=128):
        self.count += n
        assert self.count <= 256, "more arrivals than the barrier's count"
        if self.count == 256:
            self.count, self.gen = 0, self.gen + 1


@pytest.mark.parametrize("n_q,x,causal", [
    (1, 0, True), (2, 0, True), (3, 1, True), (8, 0, True), (8, 3, True),
    (3, 0, False), (9, 4, True)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_and_turns(n_q, x, causal, seed):
    """The kernel's ring and turns under random interleavings, over the
    key tiles f of both query tiles of CTA x: thread 0 loads both Q tiles
    (q_full) and K_f, V_f for f < 2; each consumer waits q_full at parity
    0, then per query tile: K_f0 (k_full[f % 2] at parity (f / 2) & 1),
    its turn (bar.sync 3 + cw), S_f0, the other's turn (bar.arrive 4 - cw;
    consumer 1 skips its last), release K_f0; then per later tile f: K_f,
    its turn, S_f, V_{f-1}, P.V_{f-1}, the other's turn, release K_f, then
    V_{f-1}; at the end V and release of the last. A release counts in
    shared memory; the second consumer to release a slot's K (or V) loads
    tile f + 2 into it. The boxes land in any order. No deadlock, every
    wait passes only once its tile has landed, no slot is overwritten
    while a consumer reads it, and the turns alternate."""
    rng = np.random.default_rng(seed)
    n_kv = 8 if not causal else n_q
    tiles = _pair_tiles(n_q, x)
    counts = [min(n_kv, t + 1) if causal else n_kv for t in tiles]
    n_all = sum(counts)
    stages, nb = 2, 2
    q_full = _MBarrier(1)
    full = {(kind, i): _MBarrier(1) for kind in "kv" for i in range(stages)}
    done = {(kind, i): 0 for kind in "kv" for i in range(stages)}
    turn = {3: _NamedBarrier(), 4: _NamedBarrier()}
    held, landed, copies, issued = {}, {}, [], []

    def load(kind, f):
        slot = f % stages
        held[kind, slot], landed[kind, slot] = None, 0
        full[kind, slot].arrive(1, tx=nb * FA_BOX)
        copies.extend((kind, slot, f) for _ in range(nb))

    held["q", 0], landed["q", 0] = None, 0
    q_full.arrive(1, tx=len(tiles) * nb * FA_BOX)
    copies.extend(("q", 0, -1) for _ in range(len(tiles) * nb))
    for f in range(min(n_all, stages)):
        load("k", f)
        load("v", f)

    def wait_full(kind, f):
        while not full[kind, f % stages].passed((f // stages) & 1):
            yield
        assert held[kind, f % stages] == f

    def release(kind, f):
        assert held[kind, f % stages] == f  # read until now
        done[kind, f % stages] += 1
        if done[kind, f % stages] == 2:
            done[kind, f % stages] = 0
            if f + stages < n_all:
                load(kind, f + stages)

    def consumer(cw):
        def take_turn():
            gen = turn[3 + cw].gen
            turn[3 + cw].arrive()
            while turn[3 + cw].gen == gen:
                yield
            issued.append(cw)

        def pass_turn(f):
            if cw == 0 or f < n_all - 1:
                turn[4 - cw].arrive()

        if cw == 0:
            turn[3].arrive()
        while not q_full.passed(0):
            yield
        assert held["q", 0] == -1
        f = 0
        for nk in counts:
            yield from wait_full("k", f)
            yield from take_turn()
            pass_turn(f)
            yield
            release("k", f)
            for f in range(f + 1, f + nk):
                yield from wait_full("k", f)
                yield from take_turn()
                yield from wait_full("v", f - 1)
                pass_turn(f)
                yield
                release("k", f)
                yield
                release("v", f - 1)
            yield from wait_full("v", f)
            yield
            release("v", f)
            f += 1

    actors = [consumer(0), consumer(1)]
    live = [0, 1]
    for _ in range(200000):
        moves = [("actor", a) for a in live] + [
            ("copy", i) for i in range(len(copies))]
        if not moves:
            break
        kind, i = moves[rng.integers(len(moves))]
        if kind == "copy":
            what, slot, f = copies.pop(i)
            landed[what, slot] += 1
            if what == "q":
                if landed[what, slot] == len(tiles) * nb:
                    held[what, slot] = f
                q_full.complete_tx(FA_BOX)
            else:
                if landed[what, slot] == nb:
                    held[what, slot] = f
                full[what, slot].complete_tx(FA_BOX)
        else:
            try:
                next(actors[i])
            except StopIteration:
                live.remove(i)
    assert not live and not copies, "the ring deadlocked"
    assert issued == [0, 1] * n_all  # the turns alternate, consumer 0 first
    assert turn[3].count == turn[4].count == 0
