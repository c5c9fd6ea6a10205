"""The port's int8-KV decode attention (plain version on the CPU) against
the JAX package's Pallas kernel in interpret mode, the CUDA kernel's split
plan, an emulation of its arithmetic (head groups of up to 8 query heads,
splits, per-warp online softmax, the merge in split order) against the JAX
kernel, and the per-element rule the card holds the CUDA kernel to."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.kernels.decode_attention import (
    decode_attention_int8 as j_decode)
from omniquant_tpu_torch.kernels import tolerance
from omniquant_tpu_torch.kernels import decode_attention as k6
from omniquant_tpu_torch.kernels.decode_attention import (
    DecodeAttnPlan, decode_attention_int8 as t_decode, decode_attention_plan,
    decode_chunk, head_groups, rep_class)


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
    # Falcon's query heads per kv head (hd 64): 40B's 16, 180B's 29 and
    # 7B's 71 on one kv head
    (2, 2, 16, 256, 64, 512, None),
    (2, 2, 29, 384, 64, 384, [383, 100]),
    (3, 1, 71, 256, 64, 256, [255, 0, 130]),
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


def _plan(kv_len, B, n_kv, R, hd, n_rep):
    """The plan the kernel would run on an H100 (132 SMs) holding 6 CTAs
    an SM (the card's answer at hd 128, one query head a kv head)."""
    return decode_attention_plan(kv_len, B, n_kv, R, hd, 132, 6, n_rep)


def _emulate_cuda_kernel(q, kc, ks, vc, vs, lengths, kv_len, score_scale,
                         ring, ring_n, fault=None, plan=None,
                         out_dtype=torch.bfloat16):
    """The CUDA kernel's arithmetic in PyTorch. Per (slot, kv head, head
    group of up to 8 query heads: ``head_groups``), the window splits into
    spans of ``plan.per`` positions (one CTA each) and the ring is one
    split more; a split past the live positions does nothing. A split walks its rows in chunks of ``plan.chunk``; warp w of
    4 owns rows [w, w + 1) * chunk / 4 of each chunk and keeps its own f32
    online softmax: scores (q . code) * (ks * score_scale), p * vs in f32
    against the v codes. The warps' (m, l, sums) combine into the split's
    partial; with one live split it is the output, with more the partials
    merge in split order (the ring last) with exp(m_i - m) rescaling; an
    idle slot with no ring gives 0. The output is rounded to ``out_dtype``
    (bf16, as the kernel's).
    ``fault`` plants a bug: "lost_chunk" skips positions 512..639,
    "no_ring" ignores the ring, "no_ks" leaves the key scales out of the
    scores, "lost_split" leaves the second live split out of the merge,
    "no_rescale" merges without the exp(m_i - m) factors, "ring_twice"
    merges the ring's partial twice."""
    B, n_heads, hd = q.shape
    n_kv = kc.shape[1]
    n_rep = n_heads // n_kv
    R = ring[0].shape[2] if ring_n >= 0 else 0
    if plan is None:
        plan = _plan(kv_len, B, n_kv, R, hd, n_rep)
    rpw = plan.chunk // 4
    groups, cap = head_groups(n_rep)
    out = torch.zeros(B, n_heads, hd)

    def split_partial(qh, kcs, kss, vcs, vss, pos):
        """(m, l, acc) of one split over its rows ``pos`` (group heads,
        ...)."""
        nq = qh.shape[0]
        parts = []
        for w in range(4):
            m = torch.full((nq, 1), -1e30)
            l = torch.zeros(nq, 1)
            acc = torch.zeros(nq, hd)
            for c0 in range(0, len(pos), plan.chunk):
                rows = pos[c0 + w * rpw:c0 + (w + 1) * rpw]
                if fault == "lost_chunk":
                    rows = [r for r in rows if not 512 <= r < 640]
                if not rows:
                    continue
                s = qh @ kcs[rows].float().T
                s = s * (score_scale if fault == "no_ks"
                         else kss[rows] * score_scale)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + (p * vss[rows]) @ vcs[rows].float()
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        a = [torch.exp(m - M) for m, _, _ in parts]
        return (M, sum(l * f for (_, l, _), f in zip(parts, a)),
                sum(acc * f for (_, _, acc), f in zip(parts, a)))

    for b, hk, g in np.ndindex(B, n_kv, groups):
        live = max(0, min(int(lengths[b]) + 1, kv_len))
        h0 = hk * n_rep + g * cap
        h1 = min(h0 + cap, (hk + 1) * n_rep)
        qh = q[b, h0:h1].float()
        parts = [split_partial(qh, kc[b, hk], ks[b, hk], vc[b, hk],
                               vs[b, hk], list(range(lo, min(hi, live))))
                 for lo, hi in plan.spans(kv_len) if lo < live]
        if ring_n >= 0 and fault != "no_ring":
            rp = split_partial(qh, ring[0][b, hk], ring[1][b, hk],
                               ring[2][b, hk], ring[3][b, hk],
                               list(range(min(ring_n + 1, R))))
            parts += [rp, rp] if fault == "ring_twice" else [rp]
        if fault == "lost_split" and len(parts) > 2:
            del parts[1]
        if not parts:
            continue
        if len(parts) == 1:
            _, l, acc = parts[0]
        else:
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            a = [torch.ones_like(M) if fault == "no_rescale"
                 else torch.exp(m - M) for m, _, _ in parts]
            l = sum(pl * f for (_, pl, _), f in zip(parts, a))
            acc = sum(pa * f for (_, _, pa), f in zip(parts, a))
        out[b, h0:h1] = acc / l.clamp_min(1e-30)
    return out.to(out_dtype)


@pytest.mark.parametrize("fault", [None, "lost_chunk", "no_ring", "no_ks",
                                   "lost_split", "no_rescale",
                                   "ring_twice"])
def test_card_tolerance_admits_rounding_and_rejects_faults(fault):
    """The per-element rule the card holds the CUDA kernel to (2 bf16 ulps
    of each element plus 2^-10) admits the kernel's arithmetic and rejects
    a kernel that loses a chunk past position 512, ignores the ring, leaves
    the key scales out, drops a split past the first from the merge, merges
    without rescaling, or merges the ring twice, at a 2048-token window
    with lengths straddling 1024 and a full ring of 8."""
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


# (B, n_kv, n_rep, hd, kv_len, R): chip_smoke.py's five cases (engine C's
# batch 32 at windows 256 and 512, engine D's batch 8 at 2048, with and
# without its ring of 8), GQA, hd 64, and windows that are not a multiple
# of a split
_PLAN_SHAPES = [(32, 32, 1, 128, 256, 0), (32, 32, 1, 128, 512, 0),
                (8, 32, 1, 128, 2048, 0), (8, 32, 1, 128, 2048, 8),
                (2, 8, 4, 128, 2048, 8), (4, 2, 8, 128, 1536, 0),
                (4, 4, 2, 64, 512, 4), (3, 8, 1, 64, 2048, 0),
                (4, 32, 1, 128, 200, 0), (8, 32, 1, 128, 1536, 0),
                (1, 1, 1, 128, 1536, 8), (64, 32, 1, 64, 200, 0),
                # Falcon: 7B (71 query heads on 1 kv head) at batch 8 and a
                # 2048 window with and without its ring, and at batch 32 and
                # 256; 40B (16 on each of 8), 180B (29 on each of 8)
                (8, 1, 71, 64, 2048, 0), (8, 1, 71, 64, 2048, 8),
                (32, 1, 71, 64, 256, 0), (8, 8, 16, 64, 2048, 8),
                (4, 8, 29, 64, 1000, 0)]


@pytest.mark.parametrize("ctas", [1, 4, 6, 16])
@pytest.mark.parametrize("B,n_kv,n_rep,hd,kv_len,R", _PLAN_SHAPES)
def test_plan_covers_the_window_once(B, n_kv, n_rep, hd, kv_len, R, ctas):
    """The splits tile [0, kv_len) with no gap and no overlap (only the
    last may be shorter), each a multiple of the kernel's chunk of rows;
    the ring is a split of its own exactly when there is one; more CTAs an
    SM never give longer spans, and the head groups of a kv head with more
    than 8 query heads count among the CTAs (never shorter spans than one
    group's). The plan is a function of the shapes and the card: it takes
    no lengths."""
    plan = decode_attention_plan(kv_len, B, n_kv, R, hd, 132, ctas, n_rep)
    spans = plan.spans(kv_len)
    assert plan.chunk == decode_chunk(hd) and plan.per % plan.chunk == 0
    assert len(spans) == plan.win_splits >= 1
    assert spans[0][0] == 0 and spans[-1][1] == kv_len
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi - lo == plan.per for lo, hi in spans[:-1])
    assert 0 < spans[-1][1] - spans[-1][0] <= plan.per
    assert plan.ring == (R > 0) and plan.splits == len(spans) + (R > 0)
    assert plan.per <= decode_attention_plan(kv_len, B, n_kv, R, hd, 132,
                                             1, n_rep).per
    one = decode_attention_plan(kv_len, B, n_kv, R, hd, 132, ctas, 1)
    assert plan.per >= one.per
    groups = head_groups(n_rep)[0]
    if plan.per > plan.chunk:  # split no further once every slot has one
        assert B * n_kv * groups * plan.win_splits >= 132 * ctas
    if plan.per < kv_len:  # halved: the CTA slots outnumbered the CTAs
        assert B * n_kv * groups * -(-kv_len // (2 * plan.per)) < 132 * ctas
    assert "lengths" not in inspect.signature(decode_attention_plan).parameters


def test_plan_counts_head_groups_at_falcon_7b():
    """Falcon-7B at batch 8 and a 2048 window (chunk 128 at hd 64): 9 head
    groups of its 71 query heads give 72 CTAs a split. At 3 CTAs an SM,
    what the card holds of the 8-head instance, the plan stops at 8 splits
    of 256 (576 CTAs >= 396 slots); counting 8 CTAs a split, as for one
    query head a kv head, it would go on to 16 of 128. At 6 CTAs an SM
    both reach the chunk, 16 splits of 128 (1152 CTAs >= 792)."""
    assert head_groups(71) == (9, 8)
    plan = decode_attention_plan(2048, 8, 1, 0, 64, 132, 3, 71)
    assert (plan.per, plan.win_splits) == (256, 8)
    assert decode_attention_plan(2048, 8, 1, 0, 64, 132, 3, 1).per == 128
    plan = decode_attention_plan(2048, 8, 1, 0, 64, 132, 6, 71)
    assert (plan.per, plan.win_splits) == (128, 16)
    assert decode_attention_plan(2048, 8, 1, 0, 64, 132, 6, 1).per == 128
    assert decode_attention_plan(2048, 8, 8, 0, 64, 132, 6, 16) == (
        DecodeAttnPlan(128, 256, 8, False))


def test_rep_class_and_head_groups_cover_every_n_rep(monkeypatch):
    """Every n_rep from 1 to 300 has a kernel instance (1, 2, 4 or 8 query
    heads a CTA, at least min(n_rep, 8)) and head groups that hold its
    heads with one group at most part full; _decode_ctas asks the card for
    that instance (stubbed here) without raising, and n_rep 0 is
    refused."""
    asked = []
    monkeypatch.setattr(k6, "_decode_info",
                        lambda hd, rep, ctas: asked.append(rep) or 5)
    monkeypatch.setattr(k6, "_K6_CTAS", {})
    for n in range(1, 301):
        r = rep_class(n)
        groups, cap = head_groups(n)
        assert r in (1, 2, 4, 8) and r >= min(n, 8) and cap <= r
        assert (groups - 1) * cap < n <= groups * cap
        assert k6._decode_ctas(torch.device("cpu"), 64, n) == 5
    assert sorted(set(asked)) == [1, 2, 4, 8]
    with pytest.raises(ValueError, match="at least 1"):
        rep_class(0)


@pytest.mark.parametrize("hd,n_rep,ring_n", [(128, 1, -1), (128, 2, 3),
                                             (64, 4, -1), (64, 1, 0),
                                             (64, 16, -1), (64, 29, 3),
                                             (64, 71, 0)])
def test_emulation_matches_jax_kernel_on_split_boundaries(hd, n_rep, ring_n):
    """The kernel's arithmetic (the emulation, at a plan of two-chunk
    spans) against the JAX kernel in interpret mode, with lengths one
    short of a split, on it, one short of the second, and an idle slot:
    rtol 1e-3 of the largest output, as test_matches_jax_kernel."""
    chunk = decode_chunk(hd)
    per = 2 * chunk
    kv_len = 3 * per
    lengths = [per - 2, per - 1, 2 * per - 1, -1]
    q, cache, ring = _inputs(4, 2, n_rep, kv_len, hd, seed=hd + ring_n,
                             R=4 if ring_n >= 0 else 0)
    ring = ring if ring_n >= 0 else None
    got_ref, want = _run_both(q, cache, lengths, kv_len, ring, ring_n)
    plan = DecodeAttnPlan(chunk, per, 3, ring_n >= 0)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = _emulate_cuda_kernel(
        tq, *(torch.from_numpy(a) for a in cache),
        torch.tensor(lengths, dtype=torch.int32), kv_len, hd ** -0.5,
        None if ring is None else tuple(torch.from_numpy(a) for a in ring),
        ring_n, plan=plan, out_dtype=torch.float32).numpy()
    assert np.isfinite(got).all()
    if ring_n < 0:
        assert (got[3] == 0).all()  # the idle slot
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
