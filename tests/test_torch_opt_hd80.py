"""Head dim 80 (OPT-2.7B: hidden 2560, 32 heads) in the port against the JAX
package, in f32 on the CPU.

K2's and K6's plain versions against the JAX Pallas kernels in interpret
mode at hd 80 (atol 1e-5: f32 sums in different orders); the CUDA
kernels' hd-80 arithmetic emulated (K2: the 128-column instance on
zero-filled columns; K6: chunks of 128 rows, splits, per-warp softmax,
merge) and held to the card's per-element rule; K6's chunk, plan and
shared-memory geometry at hd 80 (every window from 1 to 2048, with and
without the ring; bank conflicts and lane maps of the K and V reads); and
the port's OPTEngine against JAX's on a tiny OPT with two heads of 80
(hidden 160, ffn 320, 2 layers), packed W4 per-channel by the JAX package
and carried across, with flash_min_len lowered to 16 in both engines so
that the prefill takes the flash route: prefill logits within 1e-4
relative, equal greedy streams through generate, step_n and verify_step,
native and int8 KV.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.kernels.decode_attention import (
    decode_attention_int8 as j_decode)
from omniquant_tpu.models import OPT as J_OPT
from omniquant_tpu.models import opt as jopt
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.engine import OPTEngine as JEngine
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.kernels import tolerance
from omniquant_tpu_torch.kernels import flash_attention as tfa
from omniquant_tpu_torch.kernels.decode_attention import (
    DecodeAttnPlan, decode_attention_int8 as t_decode, decode_attention_plan,
    decode_chunk, decode_geometry)
from omniquant_tpu_torch.models import opt as topt
from omniquant_tpu_torch.serving import OPTEngine as TEngine
from omniquant_tpu_torch.utils import from_jax_params

from test_torch_decode_attention import _emulate_cuda_kernel as emulate_k6
from test_torch_decode_attention import _inputs as k6_inputs
from test_torch_engine import add_requests_step_n
from test_torch_flash_attention import _emulate_cuda_kernel as emulate_k2
from test_torch_opt import numpy_opt

jfa = importlib.import_module("omniquant_tpu.kernels.flash_attention")

HD = 80
CFG = dict(vocab_size=128, hidden_size=160, ffn_dim=320, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=128)
JCFG = jopt.OPTConfig(**CFG)
TCFG = topt.OPTConfig(**CFG)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_opt_engine.py: the port's
    ops here are tiny and many, and several threads per op under the
    suite's parallel workers slow them down many times. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K2


def _qkv(B, H, Hkv, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, HD)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, HD)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, HD)).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,S,causal", [
    (1, 4, 4, 200, True),   # ragged: 200 rows of a 128-row block
    (2, 4, 1, 130, True),   # MQA
    (1, 8, 2, 96, False),   # GQA, not causal
])
def test_flash_plain_matches_jax_kernel_at_hd80(B, H, Hkv, S, causal):
    """The plain version against JAX's flash_attention in interpret mode
    (which pads head_dim 80 to its 128 lanes), in f32: atol 1e-5."""
    q, k, v = _qkv(B, H, Hkv, S, seed=S + H)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=64,
                               block_k=128, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.shape == (B, H, S, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("B,H,Hkv,S", [(1, 4, 4, 300), (1, 4, 2, 129)])
def test_flash_padded_instance_matches_plain_at_hd80(B, H, Hkv, S):
    """The CUDA kernel runs hd 80 on its 128-column instance: TMA fills
    columns 80..127 of every q, k and v box with zeros, the products run
    at 128, and the store keeps columns 0..79. That arithmetic (the
    kernel's emulation on the zero-filled tensors, cut back to 80 columns)
    meets the card's per-element rule against the plain version at hd 80,
    with the softmax scale of hd 80."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in (
        (B, H, S, HD), (B, Hkv, S, HD), (B, Hkv, S, HD)))
    scale = HD ** -0.5
    want = tfa.flash_attention(q, k, v, sm_scale=scale)
    pad = [torch.nn.functional.pad(t, (0, 128 - HD)) for t in (q, k, v)]
    full = emulate_k2(*pad, scale)
    assert (full[..., HD:] == 0).all()
    ok, _, worst = tolerance.bf16_close(
        full[..., :HD], want,
        tolerance.flash_attention_slack(q, k, v, sm_scale=scale))
    assert ok, worst


# ---------------------------------------------------------------------------
# K6


def _decode_both(q, cache, lengths, kv_len, ring=None, ring_n=-1):
    ss = HD ** -0.5
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
    return tq, got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n_rep,ring_n", [(1, -1), (1, 3), (2, -1),
                                          (4, 0)])
def test_decode_plain_matches_jax_kernel_at_hd80(n_rep, ring_n):
    """The plain version against JAX's decode_attention_int8 in interpret
    mode at hd 80, a 384-position window of a 512 cache with lengths 0, a
    full window and between, with and without a ring of 4: atol 1e-5."""
    q, cache, ring = k6_inputs(3, 2, n_rep, 512, HD, seed=80 + n_rep,
                               R=4 if ring_n >= 0 else 0)
    _, got, want = _decode_both(q, cache, [0, 383, 200], 384,
                                ring if ring_n >= 0 else None, ring_n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_rep,ring_n", [(1, -1), (1, 0), (8, 3)])
def test_decode_emulation_matches_jax_kernel_at_hd80(n_rep, ring_n):
    """The CUDA kernel's arithmetic at hd 80 (chunks of 128 rows, each
    warp a quarter of them, spans of two chunks, the merge in split order,
    the ring last) against the JAX kernel, with lengths one short of a
    split, on it, one short of the second and idle: rtol 1e-3 of the
    largest output, as tests/test_torch_decode_attention.py holds it; the
    card's per-element rule against the plain version."""
    chunk = decode_chunk(HD)
    per = 2 * chunk
    kv_len = 3 * per
    lengths = [per - 2, per - 1, 2 * per - 1, -1]
    q, cache, ring = k6_inputs(4, 2, n_rep, kv_len, HD, seed=n_rep + ring_n,
                               R=4 if ring_n >= 0 else 0)
    ring = ring if ring_n >= 0 else None
    tq, plain, want = _decode_both(q, cache, lengths, kv_len, ring, ring_n)
    got = emulate_k6(
        tq, *(torch.from_numpy(a) for a in cache),
        torch.tensor(lengths, dtype=torch.int32), kv_len, HD ** -0.5,
        None if ring is None else tuple(torch.from_numpy(a) for a in ring),
        ring_n, plan=DecodeAttnPlan(chunk, per, 3, ring is not None),
        out_dtype=torch.float32)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() < 1e-3 * np.abs(want).max()
    live = slice(None) if ring_n >= 0 else slice(0, 3)  # idle slot: 0
    ok, _, worst = tolerance.bf16_close(
        got.to(torch.bfloat16)[live], torch.from_numpy(plain)[live],
        tolerance.DECODE_ATTENTION_SLACK)
    assert ok, worst


@pytest.mark.parametrize("B,n_kv,n_rep,ctas", [(8, 32, 1, 5), (32, 32, 1, 5),
                                               (1, 2, 4, 1), (4, 8, 16, 3)])
def test_decode_plan_covers_every_window_at_hd80(B, n_kv, n_rep, ctas):
    """decode_chunk(80) is 128 rows (one lane scores a K row, as at hd 64),
    and at every window length from 1 to 2048, with and without a ring,
    the plan's spans are a power of two times the chunk and tile
    [0, kv_len) once, the ring one split more."""
    assert decode_chunk(HD) == 128
    for R in (0, 8):
        for kv_len in range(1, 2049):
            plan = decode_attention_plan(kv_len, B, n_kv, R, HD, 132, ctas,
                                         n_rep)
            mult = plan.per // plan.chunk
            assert plan.chunk == 128 and mult & (mult - 1) == 0
            spans = plan.spans(kv_len)
            assert spans[0][0] == 0 and spans[-1][1] == kv_len
            assert all(a[1] == b[0] and a[1] - a[0] == plan.per
                       for a, b in zip(spans, spans[1:]))
            assert plan.ring == (R > 0)
            assert plan.splits == len(spans) + (R > 0)


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_decode_geometry_reads_are_whole_and_conflict_free(hd):
    """The kernel's Geo<HD, REP> (decode_geometry): hd 64 and 128 keep
    their layout (K rows padded by 16 bytes, chunks of 128 and 64
    rows); at every hd the 16-byte K reads of each quarter warp (8 lanes,
    one piece step) hit 8 distinct bank quads, the lanes' pieces cover
    each K row once, and the P.V lanes cover every (row, dimension) of a
    warp's rows exactly once (hd 80: lanes 20..31 repeat a row of the
    step and are never stored); every instance fits the SM's shared
    memory with the warps' sums inside its ring."""
    g = decode_geometry(hd, 1)
    if hd != 80:
        assert (g.k_stride, g.chunk) == (hd + 16, {64: 128, 128: 64}[hd])
    assert g.k_stride % 16 == 0 and (g.k_stride // 16) % 2 == 1
    piece_lanes = hd // g.k_lanes  # bytes a lane scores
    assert piece_lanes % 16 == 0
    for step in range(piece_lanes // 16):
        for quarter in range(4):
            quads = set()
            for lane in range(8 * quarter, 8 * quarter + 8):
                row, side = divmod(lane, g.k_lanes)
                addr = row * g.k_stride + side * piece_lanes + 16 * step
                quads.add((addr // 16) % 8)
            assert len(quads) == 8
    rpw = g.chunk // 4
    cover = np.zeros((rpw, hd), int)
    for jj in range(0, rpw, g.v_rows):
        for lane in range(32):
            j = jj + (lane // g.v_lanes) % g.v_rows
            assert 0 <= j < rpw
            if lane < g.v_rows * g.v_lanes:  # stored lanes
                d = 4 * (lane % g.v_lanes)
                cover[j, d:d + 4] += 1
    assert (cover == 1).all()
    for rep in (1, 2, 4, 8):
        geo = decode_geometry(hd, rep)
        ring = 2 * geo.chunk * (geo.k_stride + hd + 8)
        assert 4 * rep * (hd + 2) * 4 <= ring < geo.smem <= 232448


# ---------------------------------------------------------------------------
# OPTEngine at hd 80


def _jax(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def packed():
    """(JAX packed params, the same carried into the port)."""
    jp = j_pack_model(J_OPT, _jax(numpy_opt(seed=80, cfg=CFG)),
                      JQuantConfig(n_bits=4, group_size=None))
    np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a), jp,
                           is_leaf=lambda a: a is None)
    return jp, from_jax_params(np_tree, device="cpu")


def engines(packed, **kw):
    jp, tp = packed
    kw = dict(flash_min_len=16, **kw)
    return (JEngine(jp, JCFG, dtype=jnp.float32, **kw),
            TEngine(tp, TCFG, dtype=torch.float32, device="cpu", **kw))


@pytest.fixture
def flash_calls(monkeypatch):
    """The shapes the port's engine hands to flash_attention."""
    mod = importlib.import_module("omniquant_tpu_torch.serving.engine")
    calls = []
    real = mod.flash_attention

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(mod, "flash_attention", spy)
    return calls


def test_prefill_logits_match_jax_at_hd80(packed, flash_calls):
    """Batched prefill of two 24-token prompts (bucket 32, through the
    flash route at flash_min_len 16) against JAX's forward on the engine's
    params: rtol 1e-4."""
    je, te = engines(packed, max_batch=2, max_len=64)
    assert te.cfg.head_dim == HD
    prompts = [[(7 * i + 3) % 128 for i in range(24)],
               [(5 * i + 1) % 128 for i in range(24)]]
    _, got = te.add_requests(prompts, return_logits=True)
    want = np.asarray(jopt.forward(je.params, jnp.asarray(prompts, jnp.int32),
                                   JCFG)[:, -1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert flash_calls and all(s[1:] == (2, 32, HD) for s in flash_calls)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_engine_streams_match_jax_at_hd80(packed, flash_calls, kv_dtype):
    """Equal greedy streams: a 24-token prompt through generate (the
    flash prefill, decode across the 32-row window bucket), three prompts
    prefilled together and step_n(., 4) twice (int8: K6 with the ring and
    the span flush), and verify_step on the engine's own continuation,
    then three steps."""
    je, te = engines(packed, max_batch=4, max_len=128, kv_dtype=kv_dtype)
    prompt = [(31 * i + 5) % 128 for i in range(24)]
    assert te.generate(prompt, max_new_tokens=12) == je.generate(
        prompt, max_new_tokens=12)
    assert flash_calls
    assert add_requests_step_n(te) == add_requests_step_n(je)
    for eng in (je, te):
        for slot in np.nonzero(eng.active)[0]:
            eng.release(int(slot))
    results = []
    for eng in (je, te):
        ref = eng.generate([5, 17, 99, 3], max_new_tokens=9)
        a = eng.add_request([5, 17, 99, 3])
        res = [ref, eng.verify_step({a: ref[:8]})]
        eng.lengths[a] += 8
        last = {a: ref[8]}
        for _ in range(3):
            last = eng.step(last)
            res.append(dict(last))
        results.append(res)
    assert results[1] == results[0]
    assert results[1][1][0] == results[1][0][1:9]
    assert te.attn_kernel == (kv_dtype == "int8")
