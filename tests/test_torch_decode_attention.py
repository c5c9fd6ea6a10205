"""The port's int8-KV decode attention (plain version on the CPU) against
the JAX package's Pallas kernel in interpret mode, and the per-element rule
the card holds the CUDA kernel to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.kernels.decode_attention import (
    decode_attention_int8 as j_decode)
from omniquant_tpu_torch.kernels import tolerance
from omniquant_tpu_torch.kernels.decode_attention import (
    decode_attention_int8 as t_decode)


def _inputs(B, n_kv, n_rep, max_len, hd, seed, R=0):
    """q, codes and scales (and a ring of R rows) as numpy, drawn like the
    JAX package's own test draws them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n_kv * n_rep, hd)).astype(np.float32)
    codes = [rng.integers(-127, 128, (B, n_kv, n, hd)).astype(np.int8)
             for n in (max_len, max_len, R, R)]
    scales = [rng.uniform(0.001, 0.02, (B, n_kv, n)).astype(np.float32)
              for n in (max_len, max_len, R, R)]
    cache = (codes[0], scales[0], codes[1], scales[1])
    ring = (codes[2], scales[2], codes[3], scales[3])
    return q, cache, ring


def _run_both(q, cache, lengths, kv_len, ring=None, ring_n=-1):
    ss = 1.0 / np.sqrt(q.shape[-1])
    jq = jnp.asarray(q, jnp.bfloat16)
    want = j_decode(jq, *(jnp.asarray(a) for a in cache),
                    jnp.asarray(lengths, jnp.int32), kv_len, ss,
                    out_dtype=jnp.float32,
                    ring_kv=None if ring is None else tuple(
                        jnp.asarray(a) for a in ring), ring_n=ring_n)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        torch.bfloat16)
    got = t_decode(tq, *(torch.from_numpy(a) for a in cache),
                   torch.tensor(lengths, dtype=torch.int32), kv_len, ss,
                   out_dtype=torch.float32,
                   ring_kv=None if ring is None else tuple(
                       torch.from_numpy(a) for a in ring), ring_n=ring_n)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("B,n_kv,n_rep,kv_len,hd,max_len,lengths", [
    (4, 4, 1, 64, 128, 64, None),     # MHA, window == cache
    (2, 2, 4, 128, 128, 512, None),   # GQA, window < cache
    (3, 8, 2, 256, 128, 256, None),
    # lengths straddling 1024 in a 2048 window (the JAX kernel's chunks)
    (4, 4, 2, 2048, 128, 2048, [1023, 1024, 2000, 37]),
    (2, 4, 1, 1536, 128, 1536, [1400, 600]),
])
def test_matches_jax_kernel(B, n_kv, n_rep, kv_len, hd, max_len, lengths):
    """rtol 1e-3 of the largest output, as the JAX package's own test holds
    its kernel to its reference."""
    q, cache, _ = _inputs(B, n_kv, n_rep, max_len, hd, seed=kv_len + B)
    if lengths is None:
        lengths = np.random.default_rng(B).integers(0, kv_len - 1, B)
    got, want = _run_both(q, cache, list(lengths), kv_len)
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("ring_n", [0, 3])
def test_ring_matches_jax_kernel(ring_n):
    """A ring of R = 4 staged rows after the window; slot 0 has an empty
    window (lengths -1, an idle slot in a staged step_n) and attends only
    the ring."""
    q, cache, ring = _inputs(3, 2, 2, 256, 128, seed=40 + ring_n, R=4)
    got, want = _run_both(q, cache, [-1, 50, 127], 128, ring, ring_n)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()


def _emulate_cuda_kernel(q, kc, ks, vc, vs, lengths, kv_len, score_scale,
                         ring, ring_n, fault=None, chunk=128):
    """The CUDA kernel's arithmetic in PyTorch: per (slot, kv head), chunks
    of 128 live positions, f32 scores (q . code) * (ks * score_scale), an
    f32 online softmax, p * vs in f32 against the v codes, the output
    rounded to bf16. ``fault`` plants a bug: "lost_chunk" skips positions
    512..639, "no_ring" ignores the ring, "no_ks" leaves the key scales out
    of the scores."""
    B, n_heads, hd = q.shape
    n_kv = kc.shape[1]
    n_rep = n_heads // n_kv
    out = torch.zeros(B, n_heads, hd)
    for b in range(B):
        live = max(0, min(int(lengths[b]) + 1, kv_len))
        parts = [(kc[b], ks[b], vc[b], vs[b], c0, min(chunk, live - c0))
                 for c0 in range(0, live, chunk)
                 if not (fault == "lost_chunk" and c0 == 512)]
        if ring_n >= 0 and fault != "no_ring":
            parts.append((ring[0][b], ring[1][b], ring[2][b], ring[3][b], 0,
                          ring_n + 1))
        for hk in range(n_kv):
            qh = q[b, hk * n_rep:(hk + 1) * n_rep].float()  # (n_rep, hd)
            m = torch.full((n_rep, 1), -1e30)
            l = torch.zeros(n_rep, 1)
            acc = torch.zeros(n_rep, hd)
            for kcs, kss, vcs, vss, c0, n in parts:
                k = kcs[hk, c0:c0 + n].float()
                s = qh @ k.T
                if fault != "no_ks":
                    s = s * (kss[hk, c0:c0 + n] * score_scale)
                else:
                    s = s * score_scale
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + (p * vss[hk, c0:c0 + n]) @ vcs[
                    hk, c0:c0 + n].float()
                m = m_new
            out[b, hk * n_rep:(hk + 1) * n_rep] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


@pytest.mark.parametrize("fault", [None, "lost_chunk", "no_ring", "no_ks"])
def test_card_tolerance_admits_rounding_and_rejects_faults(fault):
    """The per-element rule the card holds the CUDA kernel to (2 bf16 ulps
    of each element plus 2^-10) admits the kernel's arithmetic and rejects
    a kernel that loses a chunk past position 512, ignores the ring, or
    leaves the key scales out, at a 2048-token window with lengths
    straddling 1024 and a full ring of 8."""
    q, cache, ring = _inputs(4, 4, 1, 2048, 128, seed=5, R=8)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tcache = [torch.from_numpy(a) for a in cache]
    tring = tuple(torch.from_numpy(a) for a in ring)
    lengths = torch.tensor([1023, 1024, 2000, 700], dtype=torch.int32)
    ss = 128 ** -0.5
    want = t_decode(tq, *tcache, lengths, 2048, ss, ring_kv=tring, ring_n=7)
    got = _emulate_cuda_kernel(tq, *tcache, lengths, 2048, ss, tring, 7,
                               fault)
    ok, _, worst = tolerance.bf16_close(got, want,
                                        tolerance.DECODE_ATTENTION_SLACK)
    assert ok == (fault is None), worst
