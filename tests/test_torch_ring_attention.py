"""K2's softmax stats and ring attention (``parallel/ring_attention.py``)
against the JAX package, on the CPU.

- ``flash_attention(..., return_stats=True)``: the port's plain version
  against JAX's Pallas kernel in interpret mode (causal and not, GQA,
  ALiBi, head_dim 32 and 80), out within 2e-5 (f32: the blockwise and the
  dense softmax sum in different orders), m within 2e-5 absolute (scores
  of order 1-10) and l within 2e-5 relative.
- the CUDA kernel's stats, emulated in PyTorch (its tiling, raw-score max
  and exp2 domain, the conversion to JAX's units in its epilogue), against
  the plain version at the rule the card holds them to.
- the ring, both implementations, at sp 2, 4 and 8 (every shard on the
  CPU), against JAX's ``ring_attention`` on the conftest's 8-device CPU
  mesh and against dense attention: causal and not, OPT's sm_scale 1.0,
  and GQA (the plain ring repeats the kv heads, the flash one hands them
  to K2), within 2e-5; and against JAX's flash ring (its Pallas kernel in
  interpret mode, with stats and the gate).
- the plain ring's gradient against ``jax.grad`` of JAX's "jnp" ring.
- the skipped fully-masked blocks against JAX's gated merge, bit for bit.
- ``SPMesh``: its collective under a short switch interval with more shards
  than cores, and an error in one shard raised without a hang.

JAX's results are computed once per configuration (``functools.cache``).
"""
import functools
import importlib
import math
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from omniquant_tpu.kernels import flash_attention as jfa
from omniquant_tpu.models.falcon import alibi_slopes
from omniquant_tpu_torch.kernels import flash_attention as tfa
from omniquant_tpu_torch.kernels import tolerance
from omniquant_tpu_torch.parallel import SPMesh

# the modules (each package's parallel/__init__ exports a function of the
# same name)
jring = importlib.import_module("omniquant_tpu.parallel.ring_attention")
tring = importlib.import_module("omniquant_tpu_torch.parallel.ring_attention")

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny ops: one intra-op thread keeps them fast under the suite's
    parallel workers (as tests/test_torch_cli.py does). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


STATS_CASES = [  # B, H, Hkv, S, D, causal, alibi
    (2, 4, 4, 128, 32, True, False),
    (1, 4, 2, 200, 32, True, False),    # GQA, S no block multiple
    (1, 4, 4, 96, 32, False, False),    # an off-diagonal ring block
    (1, 4, 1, 130, 32, True, True),     # MQA with ALiBi, ragged
    (1, 4, 4, 160, 80, True, False),    # OPT-2.7B's head_dim
    (1, 2, 2, 64, 80, False, True),     # hd 80, ALiBi, not causal
]


@functools.cache
def _jax_stats(B, H, Hkv, S, D, causal, alibi):
    q, k, v = _qkv(B, H, Hkv, S, D, seed=S + H + D)
    slopes = np.array(alibi_slopes(H)) if alibi else None
    out, m, l = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=128,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        return_stats=True, interpret=True)
    return q, k, v, slopes, np.asarray(out), np.asarray(m), np.asarray(l)


@pytest.mark.parametrize("case", STATS_CASES)
def test_stats_match_jax_kernel(case):
    q, k, v, slopes, j_out, j_m, j_l = _jax_stats(*case)
    causal = case[5]
    out, m, l = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        return_stats=True)
    assert m.dtype == l.dtype == torch.float32
    assert m.shape == l.shape == q.shape[:3]
    np.testing.assert_allclose(out.numpy(), j_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m.numpy(), j_m, rtol=0, atol=TOL)
    np.testing.assert_allclose(l.numpy(), j_l, rtol=TOL, atol=0)
    # without stats: the same output, bit for bit
    alone = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    assert torch.equal(alone, out)


def _emulate_kernel_stats(q, k, sm_scale, causal, slopes=None, block=128):
    """The CUDA kernel's stats (csrc/flash_attention.cu): per 128-key tile,
    raw f32 scores s = q.k (with ALiBi: s*c + slope*c*key, the exp2 domain),
    masks on the causal diagonal tile and on the tile holding key Skv - 1,
    the running max m of those, l = sum exp2(s*cs - m*cs) rescaled tile by
    tile (cs = c, or 1 with ALiBi); the epilogue writes m * cs * ln 2
    (-1e30 where m is -inf) and l."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    c = sm_scale * math.log2(math.e)
    cs = 1.0 if slopes is not None else c
    kf = k.float().repeat_interleave(H // k.shape[1], dim=1)
    m_out = torch.empty(B, H, Sq)
    l_out = torch.empty(B, H, Sq)
    n_kv = -(-Skv // block)
    for iq in range(-(-Sq // block)):
        rows = torch.arange(iq * block, min(iq * block + block, Sq))[:, None]
        m = torch.full((B, H, len(rows), 1), -math.inf)
        l = torch.zeros(B, H, len(rows), 1)
        for jt in range(min(n_kv, iq + 1) if causal else n_kv):
            j0 = jt * block
            keys = torch.arange(j0, min(j0 + block, Skv))[None, :]
            s = q.float()[:, :, rows[:, 0]] @ kf[:, :, j0:j0 + block].transpose(
                -1, -2)
            if slopes is not None:
                s = s * c + (slopes.float() * c)[None, :, None, None] * (
                    keys.float())
            if (causal and jt == iq) or (jt == n_kv - 1 and Skv % block):
                ok = keys < Skv
                if causal:
                    ok = ok & (keys <= rows)
                s = torch.where(ok, s, torch.full_like(s, -math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            mc = torch.where(m_new == -math.inf, 0.0, m_new * cs)
            alpha = torch.exp2(m * cs - mc)
            l = l * alpha + torch.exp2(s * cs - mc).sum(-1, keepdim=True)
            m = m_new
        m_out[:, :, rows[:, 0]] = torch.where(
            m == -math.inf, -1e30, m * (cs * math.log(2)))[..., 0]
        l_out[:, :, rows[:, 0]] = l[..., 0]
    return m_out, l_out


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,alibi", [
    (1, 2, 2, 256, 128, True, False),   # the ring's diagonal block
    (1, 2, 2, 256, 128, False, False),  # an off-diagonal block
    (1, 4, 2, 300, 64, True, True),     # ALiBi, ragged, GQA
    (1, 2, 2, 129, 80, False, False),   # hd 80, one past a 128 edge
])
def test_emulated_kernel_stats_within_the_card_rule(B, H, Hkv, S, D, causal,
                                                    alibi):
    """The kernel's stats arithmetic, emulated, within the rule the card
    holds K2's stats to (tolerance.flash_stats_close); the same rule
    rejects m in raw-score (or exp2-domain) units, a first key tile of
    other keys and an l 1 % off."""
    rng = np.random.default_rng(S + D)
    q, k, _ = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in (
        (B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    slopes = torch.from_numpy(np.array(alibi_slopes(H))) if alibi else None
    scale = D ** -0.5
    _, m_p, l_p = tfa.flash_attention(q, k, k, sm_scale=scale, causal=causal,
                                      alibi_slopes=slopes, return_stats=True)
    m_k, l_k = _emulate_kernel_stats(q, k, scale, causal, slopes)
    ok, _, _, worst = tolerance.flash_stats_close(m_k, l_k, m_p, l_p)
    assert ok, worst
    # planted faults: m unconverted, other keys in the first tile, l off
    raw = m_k / scale if not alibi else m_k * 2
    assert not tolerance.flash_stats_close(raw, l_k, m_p, l_p)[0]
    kk = k.clone()
    kk[:, :, :128] = -kk[:, :, :128]  # a different first key tile
    m_x, l_x = _emulate_kernel_stats(q, kk, scale, causal, slopes)
    assert not tolerance.flash_stats_close(m_x, l_x, m_p, l_p)[0]
    assert not tolerance.flash_stats_close(m_k, l_k * 1.01, m_p, l_p)[0]


def _jax_ring_fn(sp, sm_scale, causal):
    """JAX's ``ring_attention`` over sp devices of the conftest's CPU mesh,
    its "jnp" ring, under jit (shard_map outside jit dispatches op by op,
    8-21 s a configuration here)."""
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    return jax.jit(lambda q, k, v: jring.ring_attention(
        q, k, v, mesh, axis="sp", sm_scale=sm_scale, causal=causal,
        impl="jnp"))


@functools.cache
def _jax_ring(B, H, S, D, sp, causal, sm_scale, seed):
    q, k, v = _qkv(B, H, H, S, D, seed)
    got = _jax_ring_fn(sp, sm_scale, causal)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return q, k, v, np.asarray(got)


def _dense(q, k, v, sm_scale, causal):
    """Dense f32 attention in numpy (float64 sums, cast back)."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * sm_scale
    if causal:
        S = q.shape[2]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v.astype(np.float64)).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["flash", "plain"])
@pytest.mark.parametrize("sp,causal,sm_scale", [
    (2, True, None), (4, True, None), (8, True, None), (4, False, None),
    (4, True, 1.0)])   # 1.0: OPT's q arrives pre-scaled
def test_ring_matches_jax_ring_and_dense(impl, sp, causal, sm_scale):
    """The port's ring against JAX's on the 8-device CPU mesh and against
    dense attention."""
    B, H, S, D = 2, 4, 64, 32
    q, k, v, want = _jax_ring(B, H, S, D, sp, causal, sm_scale, 0)
    scale = D ** -0.5 if sm_scale is None else sm_scale
    got = tring.ring_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        ["cpu"] * sp, sm_scale=sm_scale, causal=causal, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _dense(q, k, v, scale, causal),
                               rtol=TOL, atol=TOL)


@functools.cache
def _jax_flash_ring():
    q, k, v = _qkv(1, 2, 2, 256, 32, seed=1)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    want = jax.jit(lambda a, b, c: jring.ring_attention(
        a, b, c, mesh, axis="sp", impl="flash"))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return q, k, v, want


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_ring_matches_jax_flash_ring(impl):
    """JAX's flash ring (its Pallas kernel in interpret mode with stats, the
    masked blocks gated) on the mesh at sp 4."""
    q, k, v, want = _jax_flash_ring()
    got = tring.ring_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        ["cpu"] * 4, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_ring_takes_grouped_kv_heads(impl):
    """GQA: 8 query heads on 2 kv heads through the ring at sp 4, against
    dense attention on the kv heads repeated (as JAX's callers hand them
    to its ring)."""
    B, H, Hkv, S, D = 1, 8, 2, 64, 16
    q, k, v = _qkv(B, H, Hkv, S, D, seed=3)
    want = _dense(q, np.repeat(k, 4, axis=1), np.repeat(v, 4, axis=1),
                  D ** -0.5, True)
    got = tring.ring_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        ["cpu"] * 4, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_default_impl_follows_the_device():
    """'plain' on a CPU tensor (JAX's rule: the kernel's ring only on the
    accelerator); an unknown impl raises."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 32, 8, seed=4))
    calls = dict(tring.ring_attention_local.calls)
    tring.ring_attention(q, k, v, ["cpu"] * 2)
    assert tring.ring_attention_local.calls["plain"] == calls["plain"] + 1
    assert tring.ring_attention_local.calls["flash"] == calls["flash"]
    with pytest.raises(ValueError, match="impl must be"):
        tring.ring_attention(q, k, v, ["cpu"] * 2, impl="jnp")
    with pytest.raises(ValueError, match="does not split"):
        tring.ring_attention(q, k, v, ["cpu"] * 3)


def test_plain_ring_gradient_matches_jax_grad():
    """d/d(q, k, v) of sum(ring * w) through the plain ring at sp 4 against
    jax.grad of JAX's "jnp" ring on the mesh, within 2e-5."""
    B, H, S, D = 1, 2, 64, 16
    q, k, v = _qkv(B, H, H, S, D, seed=5)
    w = np.random.default_rng(6).standard_normal((B, H, S, D)).astype(
        np.float32)
    ring = _jax_ring_fn(4, None, True)

    def j_loss(q, k, v):
        return jnp.sum(ring(q, k, v) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tring.ring_attention(tq, tk, tv, ["cpu"] * 4, impl="plain")
    (out * torch.from_numpy(w)).sum().backward()
    for got, j in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


def _gated_flash_ring(qs, ks, vs, sm_scale):
    """JAX's flash ring schedule spelled out: every block computed, the
    masked ones (shard p < step i) merged with gated stats (-1e30, 0)."""
    n = len(qs)
    out = []
    for p in range(n):
        B, H, s, D = qs[p].shape
        m = torch.full((B, H, s, 1), -1e30)
        l = torch.zeros(B, H, s, 1)
        acc = torch.zeros(B, H, s, D)
        for i in range(n):
            src = (p - i) % n
            o_b, m_b, l_b = tfa.flash_attention(
                qs[p], ks[src], vs[src], sm_scale=sm_scale, causal=i == 0,
                return_stats=True)
            if i > 0 and p < i:
                m_b = torch.full_like(m_b, -1e30)
                l_b = torch.zeros_like(l_b)
            m, l, acc = tring._merge(m, l, acc, o_b, m_b[..., None],
                                     l_b[..., None])
        out.append(acc / l.clamp_min(1e-30))
    return out


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_skipped_blocks_equal_gated_ones(sp):
    """The port skips the fully masked blocks JAX computes and gates: the
    gated merge is the identity, so the outputs agree bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 64, 16, seed=sp))
    blocks = [t.chunk(sp, dim=2) for t in (q, k, v)]
    got = tring.ring_attention_local(*blocks, impl="flash")
    want = _gated_flash_ring(*blocks, sm_scale=16 ** -0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mesh_collective_under_thread_switches():
    """16 shards (more than this machine's cores) calling the collective 20
    times each under a 1 us switch interval: every shard gets its own
    block of the ring's result each time."""
    n, rounds = 16, 20
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 64, 8, seed=7))
    blocks = [t.chunk(n, dim=2) for t in (q, k, v)]
    want = tring.ring_attention_local(*blocks, impl="plain")
    mesh = SPMesh(["cpu"] * n)

    def shard(p, qb, kb, vb):
        return [mesh.ring_attention(p, qb, kb * (1 + r), vb, impl="plain")
                for r in range(rounds)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = mesh.run(shard, *blocks)
    finally:
        sys.setswitchinterval(old)
    again = [tring.ring_attention_local(blocks[0], [kb * 3 for kb in
                                                    blocks[1]], blocks[2],
                                        impl="plain")]
    for p in range(n):
        assert torch.equal(got[p][0], want[p])
        assert torch.equal(got[p][2], again[0][p])
    assert threading.active_count() < 16


def test_mesh_raises_a_shard_error_without_hanging():
    """A shard that fails before the collective: the others leave it (the
    barrier is broken) and run raises the shard's own error; the mesh then
    runs again."""
    mesh = SPMesh(["cpu"] * 3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 48, 8, seed=8))
    blocks = [t.chunk(3, dim=2) for t in (q, k, v)]

    def shard(p, qb, kb, vb):
        if p == 1:
            raise KeyError("shard 1")
        return mesh.ring_attention(p, qb, kb, vb)

    with pytest.raises(KeyError, match="shard 1"):
        mesh.run(shard, *blocks)
    got = mesh.run(lambda p, qb, kb, vb: mesh.ring_attention(p, qb, kb, vb),
                   *blocks)
    want = tring.ring_attention_local(*blocks)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
