"""The PyTorch port's serving engine against the JAX LlamaEngine.

A tiny LLaMA (hidden 256, inter 512, 2 layers, 4 query / 2 kv heads) is
made with numpy from a seed, packed W4 g128 (pairs layout) by the JAX
package and carried across by ``from_jax_params``. Both engines run in f32
on the CPU (the JAX Pallas kernels in interpret mode, the port's wrappers
through their plain versions); their greedy token streams must be equal,
with a native or an int8 KV cache, and so must their verify passes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import LLAMA as J_LLAMA
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.engine import LlamaEngine as JEngine
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.models import LLAMA as T_LLAMA
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.quant import QuantConfig as TQuantConfig
from omniquant_tpu_torch.serving import engine as t_engine_mod
from omniquant_tpu_torch.serving.engine import LlamaEngine as TEngine
from omniquant_tpu_torch.serving.export import pack_model as t_pack_model
from omniquant_tpu_torch.utils.convert import from_jax_params

CPU = torch.device("cpu")
CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)


def numpy_llama(seed=0):
    """A dense LLaMA parameter tree with numpy leaves (N(0, 0.02) weights,
    norms around 1)."""
    rng = np.random.default_rng(seed)
    h, i = CFG["hidden_size"], CFG["intermediate_size"]
    kv = CFG["num_key_value_heads"] * h // CFG["num_attention_heads"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    def lin(o, n):
        return {"weight": w(o, n), "bias": None}

    layers = [{
        "input_layernorm": {"weight": norm()},
        "post_attention_layernorm": {"weight": norm()},
        "q_proj": lin(h, h), "k_proj": lin(kv, h), "v_proj": lin(kv, h),
        "o_proj": lin(h, h), "gate_proj": lin(i, h), "up_proj": lin(i, h),
        "down_proj": lin(h, i),
    } for _ in range(CFG["num_hidden_layers"])]
    return {"embed_tokens": w(CFG["vocab_size"], h), "layers": layers,
            "norm": {"weight": norm()}, "lm_head": w(CFG["vocab_size"], h)}


def _to_jax(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def packed():
    """(JAX packed params, the same carried into the port)."""
    wcfg = JQuantConfig(n_bits=4, group_size=128)
    jp = j_pack_model(J_LLAMA, _to_jax(numpy_llama()), wcfg)
    np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a), jp,
                           is_leaf=lambda a: a is None)
    return jp, from_jax_params(np_tree, device="cpu")


def engines(packed, **kw):
    jp, tp = packed
    jcfg = jllama.LlamaConfig(**CFG)
    tcfg = tllama.LlamaConfig(**CFG)
    je = JEngine(jp, jcfg, dtype=jnp.float32, **kw)
    te = TEngine(tp, tcfg, dtype=torch.float32, device="cpu", **kw)
    return je, te


def test_packed_layout_is_pairs_and_port_packs_the_same_words(packed):
    """pack_model of the port, fed the same dense weights, gives the JAX
    package's words, scales and zeros."""
    jp, _ = packed
    dense = numpy_llama()
    tree = jax.tree.map(lambda a: None if a is None else torch.from_numpy(a),
                        dense, is_leaf=lambda a: a is None)
    tp = t_pack_model(T_LLAMA, tree, TQuantConfig(n_bits=4, group_size=128),
                      device="cpu")
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for name in tllama.LINEAR_NAMES:
            assert jl[name].layout == tl[name].layout == "pairs"
            assert jl[name].tile_k == tl[name].tile_k
            np.testing.assert_array_equal(np.asarray(jl[name].qweight),
                                          tl[name].qweight.numpy())
            np.testing.assert_array_equal(np.asarray(jl[name].zeros),
                                          tl[name].zeros.numpy())
            np.testing.assert_allclose(np.asarray(jl[name].scales),
                                       tl[name].scales.numpy(), rtol=1e-7)


@pytest.mark.parametrize("prompt_len", [6, 58])
def test_generate_matches_jax(packed, prompt_len):
    """The 58-token prompt decodes across the 64-row attention-window
    bucket into the 128-row one."""
    je, te = engines(packed, max_batch=2, max_len=128)
    prompt = [(31 * i + 5) % 256 for i in range(prompt_len)]
    assert te.generate(prompt, max_new_tokens=10) == je.generate(
        prompt, max_new_tokens=10)


def continuous_batching(eng):
    """Slots join and leave between single steps; the token streams."""
    out = {}
    a = eng.add_request([1, 2, 3, 4, 5])
    last = {a: eng._pending_next[a]}
    out[a] = [last[a]]
    for _ in range(3):
        last = eng.step(last)
        out[a].append(last[a])
    b = eng.add_request([9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11, 12, 13, 14,
                         15, 16, 17])
    last[b] = eng._pending_next[b]
    out[b] = [last[b]]
    for _ in range(4):
        last = eng.step(last)
        for s, t in last.items():
            out[s].append(t)
    eng.release(a)
    del last[a]
    for _ in range(2):
        last = eng.step(last)
        out[b].append(last[b])
    return out


def add_requests_step_n(eng):
    """Three prompts of uneven lengths prefilled together, then two
    step_n(., 4) dispatches; the token streams."""
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [1, 6, 1, 8, 0, 3, 3]]
    slots = eng.add_requests(prompts)
    last = {s: eng._pending_next[s] for s in slots}
    out = {s: [t] for s, t in last.items()}
    for _ in range(2):
        res = eng.step_n(last, 4)
        for s, toks in res.items():
            out[s].extend(toks)
            last[s] = toks[-1]
    return out


def flash_gated_prompt(packed, monkeypatch, **kw):
    """A 40-token prompt whose bucket crosses a lowered flash_min_len:
    (port stream, JAX stream, shapes the port's flash kernel saw)."""
    calls = []
    real = t_engine_mod.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(t_engine_mod, "flash_attention", spy)
    je, te = engines(packed, max_batch=2, max_len=128, flash_min_len=32,
                     **kw)
    prompt = [(7 * i + 3) % 256 for i in range(40)]
    return (te.generate(prompt, max_new_tokens=6),
            je.generate(prompt, max_new_tokens=6), calls)


def test_continuous_batching_matches_jax(packed):
    """Slots join and leave between single steps."""
    je, te = engines(packed, max_batch=3, max_len=64)
    assert continuous_batching(te) == continuous_batching(je)


def test_add_requests_step_n_matches_jax(packed):
    je, te = engines(packed, max_batch=4, max_len=64)
    assert add_requests_step_n(te) == add_requests_step_n(je)


def test_flash_gated_prompt_matches_jax(packed, monkeypatch):
    """A prompt whose bucket crosses a lowered flash_min_len takes the
    blockwise-attention path in both engines."""
    got, want, calls = flash_gated_prompt(packed, monkeypatch)
    assert got == want
    assert calls and calls[0][2] == 64  # (1, heads, bucket 64, head_dim)


def test_prefill_logits_match_jax(packed):
    """Batched-prefill logits agree numerically, not only in argmax."""
    je, te = engines(packed, max_batch=2, max_len=64)
    prompts = [[5, 6, 7, 8, 9], [10, 20, 30]]
    _, t_logits = te.add_requests(prompts, return_logits=True)
    jcfg = jllama.LlamaConfig(**CFG)
    jp = je.params
    ref = []
    for p in prompts:
        logits = jllama.forward(jp, jnp.asarray([p], jnp.int32), jcfg)
        ref.append(np.asarray(logits[0, -1]))
    np.testing.assert_allclose(t_logits.numpy(), np.stack(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("prompt_len", [63, 64])
def test_decode_logits_match_jax_forward(packed, prompt_len):
    """One decode step's logits, with the attention window at the edge of
    its 64-row bucket, against the JAX forward over the whole sequence."""
    jp, _ = packed
    _, te = engines(packed, max_batch=2, max_len=128)
    prompt = [(13 * i + 7) % 256 for i in range(prompt_len)]
    slot = te.add_request(prompt)
    nxt = te._pending_next[slot]
    toks, lens = te._device_tokens({slot: nxt})
    got = te._decode_impl(toks, lens, te._kv_len(1))[slot]
    want = jllama.forward(jp, jnp.asarray([prompt + [nxt]], jnp.int32),
                          jllama.LlamaConfig(**CFG))[0, -1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_unported_options_raise(packed):
    """auto_grow is ported: its grow_limit is cfg.max_position_embeddings
    (256 here) unless given, else 16 x max_len, as in the JAX engine."""
    jp, tp = packed
    cfg = tllama.LlamaConfig(**CFG)
    for kw in ({}, dict(grow_limit=1024), dict(auto_grow=True)):
        je = JEngine(jp, jllama.LlamaConfig(**CFG), max_len=64, **kw)
        te = TEngine(tp, cfg, max_len=64, device="cpu", **kw)
        assert (te.auto_grow, te.grow_limit) == (je.auto_grow, je.grow_limit)
    assert te.grow_limit == 256 and te.auto_grow
    no_positions = dataclasses.replace(cfg, max_position_embeddings=0)
    assert TEngine(tp, no_positions, max_len=64,
                   device="cpu").grow_limit == 64 * 16


def test_deleted_engine_is_freed_at_once(packed):
    """An engine (and its KV cache) is freed when its last reference goes,
    without waiting for the cyclic garbage collector: no reference cycle
    holds it (a recursive closure over the engine in _prep_params did)."""
    import gc
    import weakref

    _, tp = packed
    gc.disable()
    try:
        te = TEngine(tp, tllama.LlamaConfig(**CFG), max_batch=2, max_len=64,
                     dtype=torch.float32, device="cpu")
        te.generate([1, 2, 3], max_new_tokens=2)
        ref, cache = weakref.ref(te), weakref.ref(te.cache.k[0])
        del te
        assert ref() is None and cache() is None
    finally:
        gc.enable()


def test_capacity_guard(packed):
    """A decode that would write at max_len is refused, never clamped."""
    _, te = engines(packed, max_batch=1, max_len=32)
    slot = te.add_request(list(range(1, 31)))
    with pytest.raises(RuntimeError, match="max_len"):
        te.step_n({slot: te._pending_next[slot]}, 4)
    assert dataclasses.is_dataclass(te.cache)


def test_engine_from_a_prepped_tree_matches_jax_draft(packed):
    """A one-layer engine built from a built two-layer engine's params (its
    first layer, already fused: the port's counterpart of JAX's
    ``layer_skip_params`` draft) builds, shares the target's buffers and
    gives the JAX draft engine's greedy stream."""
    from omniquant_tpu.serving.spec_decode import layer_skip_params

    je, te = engines(packed, max_batch=2, max_len=64)
    cfg1 = dict(CFG, num_hidden_layers=1)
    jd = JEngine(layer_skip_params(je.params, 1), jllama.LlamaConfig(**cfg1),
                 max_batch=2, max_len=64, dtype=jnp.float32)
    draft = dict(te.params, layers=list(te.params["layers"][:1]))
    td = TEngine(draft, tllama.LlamaConfig(**cfg1), max_batch=2, max_len=64,
                 dtype=torch.float32, device="cpu")
    for name in ("qkv_fused", "gate_up_fused"):
        assert (td.params["layers"][0][name].qweight.data_ptr()
                == te.params["layers"][0][name].qweight.data_ptr())
    prompt = [(13 * i + 2) % 256 for i in range(9)]
    assert td.generate(prompt, max_new_tokens=8) == jd.generate(
        prompt, max_new_tokens=8)


# ---------------------------------------------------------------------------
# int8 KV cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    """Per-token int8 codes and scales, computed in the input's dtype:
    exact on identical inputs (one row all zero, for the 1e-8 floor)."""
    from omniquant_tpu.serving.engine import _quantize_kv as j_quantize

    x = np.random.default_rng(3).standard_normal((2, 3, 5, 64)) * 4
    x[0, 1, 2] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jc, js = j_quantize(jx)
    tc, ts = t_engine_mod._quantize_kv(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("attn_kernel", [True, False])
def test_int8_generate_matches_jax(packed, attn_kernel):
    """generate (prefill, then single steps through K4 and the fused
    attention, or the dequantized dense path), across the 64-row window
    bucket into the 128-row one."""
    je, te = engines(packed, max_batch=2, max_len=128, kv_dtype="int8",
                     attn_kernel=attn_kernel)
    assert te.attn_kernel == je.attn_kernel == attn_kernel
    prompt = [(31 * i + 5) % 256 for i in range(58)]
    assert te.generate(prompt, max_new_tokens=10) == je.generate(
        prompt, max_new_tokens=10)


@pytest.mark.parametrize("attn_kernel", [True, False])
def test_int8_continuous_batching_matches_jax(packed, attn_kernel):
    je, te = engines(packed, max_batch=3, max_len=64, kv_dtype="int8",
                     attn_kernel=attn_kernel)
    assert continuous_batching(te) == continuous_batching(je)


@pytest.mark.parametrize("attn_kernel", [True, False])
def test_int8_add_requests_step_n_matches_jax(packed, attn_kernel):
    """step_n(., 4): with attn_kernel the ring-staged path (the fused
    attention over the window plus the ring, one span flush per layer),
    without it the per-step path. The caches after it equal JAX's: the
    k/v entering the quantizer come from f32 sums taken in another order
    (relative differences ~1e-6), so a code may round the other way where
    x / scale sits on a half-integer, and the flipped code moves the next
    layer's k/v by ~1e-5; codes differ by at most one step, at under 1 in
    1000 entries of the cache (5 or 6 of 32768 here). Scales hold to 1e-4
    of the largest (2.3e-5 here)."""
    je, te = engines(packed, max_batch=4, max_len=64, kv_dtype="int8",
                     attn_kernel=attn_kernel)
    assert te._use_ring() == attn_kernel
    assert add_requests_step_n(te) == add_requests_step_n(je)
    B, H = 4, CFG["num_key_value_heads"]
    for li in range(CFG["num_hidden_layers"]):
        for jc, tc in ((je.cache.k[li], te.cache.k[li]),
                       (je.cache.v[li], te.cache.v[li])):
            d = np.abs(np.asarray(jc, np.int32) - tc.numpy().astype(np.int32))
            assert d.max() <= 1 and np.count_nonzero(d) <= d.size * 1e-3
        for js, ts in ((je.cache.k_scale[li], te.cache.k_scale[li]),
                       (je.cache.v_scale[li], te.cache.v_scale[li])):
            jflat = np.asarray(js).reshape(B, H, -1)[:, :, :64]
            np.testing.assert_allclose(ts.numpy(), jflat, rtol=0,
                                       atol=1e-4 * np.abs(jflat).max())


def test_int8_flash_gated_prompt_matches_jax(packed, monkeypatch):
    """The int8 prefill attends the fresh k/v through flash attention and
    commits their codes; decode then reads the codes."""
    got, want, calls = flash_gated_prompt(packed, monkeypatch,
                                          kv_dtype="int8")
    assert got == want
    assert calls and calls[0][2] == 64


# ---------------------------------------------------------------------------
# the speculative-decoding verify pass


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_verify_step_matches_jax(packed, kv_dtype):
    """verify_step on the engine's own greedy continuation returns it
    shifted by one, and decoding continues the chain once the tokens are
    accepted; garbage verified on another slot and never accepted leaves
    its later decoding unchanged. Both engines through the same calls."""
    je, te = engines(packed, max_batch=2, max_len=64, kv_dtype=kv_dtype)
    prompt, other = [5, 17, 99, 3], [9, 4, 88]
    results = []
    for eng in (je, te):
        ref = eng.generate(prompt, max_new_tokens=9)
        a = eng.add_request(prompt)
        b = eng.add_request(other)
        res = [ref, eng.verify_step({a: ref[:8], b: [1, 2, 3, 4, 5, 6, 7,
                                                     8]})]
        eng.lengths[a] += 8
        last = {a: ref[8], b: eng._pending_next[b]}
        for _ in range(3):
            last = eng.step(last)
            res.append(dict(last))
        results.append(res)
    assert results[1] == results[0]
    ref, verified = results[1][:2]
    assert verified[0] == ref[1:9]


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_verify_step_logits_match_jax(packed, kv_dtype):
    """verify_step_logits gives f32 (s, V) rows equal to JAX's: rtol 1e-4
    with a native cache; with an int8 cache 1e-3, since a code that rounds
    the other way (see the step_n test) moves a logit by ~2e-5."""
    je, te = engines(packed, max_batch=2, max_len=64, kv_dtype=kv_dtype)
    rows = []
    for eng in (je, te):
        slots = eng.add_requests([[5, 6, 7, 8, 9], [10, 20, 30]])
        rows.append(eng.verify_step_logits(
            {s: [11 + s, 12, 13] for s in slots}))
    for s, want in rows[0].items():
        got = rows[1][s]
        assert got.dtype == np.float32 and got.shape == (3, CFG["vocab_size"])
        rtol = 1e-3 if kv_dtype == "int8" else 1e-4
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol / 10)


# ---------------------------------------------------------------------------
# integer activations: W4A4 (pairs weights) and W6A6 (planar weights)


@pytest.fixture(scope="module")
def packed_w6():
    """The same dense model packed W6 g128 (planar layout) in both
    packages."""
    jp = j_pack_model(J_LLAMA, _to_jax(numpy_llama()),
                      JQuantConfig(n_bits=6, group_size=128))
    np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a), jp,
                           is_leaf=lambda a: a is None)
    return jp, from_jax_params(np_tree, device="cpu")


def int_engines(request, monkeypatch, scheme, **kw):
    """A W4A4 or W6A6 engine in each package, with the dense integer route
    from 16 rows on in both, so a tiny prefill takes K8 + K9 while decode
    takes fake-quant + K1 (W4A4, pairs) or K7 (W6A6, planar). Returns the
    engines and the port's route log."""
    from omniquant_tpu.models.common import ActQuantSpec as JSpec
    from omniquant_tpu_torch.kernels import quant_matmul as tqm
    from omniquant_tpu_torch.models.common import ActQuantSpec as TSpec

    jqm = __import__("importlib").import_module(
        "omniquant_tpu.kernels.quant_matmul")
    monkeypatch.setattr(jqm, "_INT_DENSE_MIN_M", 16)
    monkeypatch.setattr(tqm, "_INT_DENSE_MIN_M", 16)
    routes = []
    real_route = tqm.int_route

    def spy(m, pw, cfg):
        routes.append(real_route(m, pw, cfg))
        return routes[-1]

    monkeypatch.setattr(tqm, "int_route", spy)
    abits = 4 if scheme == "w4a4" else 6
    jp, tp = request.getfixturevalue("packed" if abits == 4 else "packed_w6")
    je = JEngine(jp, jllama.LlamaConfig(**CFG), dtype=jnp.float32,
                 spec=JSpec.from_bits(abits), **kw)
    te = TEngine(tp, tllama.LlamaConfig(**CFG), dtype=torch.float32,
                 device="cpu", spec=TSpec.from_bits(abits), **kw)
    assert not te._p_quant_active and not je._p_quant_active
    return je, te, routes


@pytest.mark.parametrize("scheme", ["w4a4", "w6a6"])
def test_int_generate_matches_jax(request, monkeypatch, scheme):
    """generate: a 20-token prompt (bucket 32: the dense route), then single
    steps (two slots: fake-quant + K1 for W4A4, K7 for W6A6); equal greedy
    streams, as JAX's own W4A4 engine test holds its engine to its eval
    forward."""
    je, te, routes = int_engines(request, monkeypatch, scheme, max_batch=2,
                                 max_len=64)
    prompt = [(29 * i + 3) % 256 for i in range(20)]
    assert te.generate(prompt, max_new_tokens=8) == je.generate(
        prompt, max_new_tokens=8)
    small = "fake_quant" if scheme == "w4a4" else "fused"
    assert set(routes) == {"dense", small}


@pytest.mark.parametrize("scheme", ["w4a4", "w6a6"])
def test_int_batching_and_step_n_match_jax(request, monkeypatch, scheme):
    """Continuous batching (slots joining and leaving between steps) and a
    batched prefill of three prompts followed by step_n(., 4) twice: equal
    greedy streams."""
    je, te, _ = int_engines(request, monkeypatch, scheme, max_batch=3,
                            max_len=64)
    assert continuous_batching(te) == continuous_batching(je)
    je, te, _ = int_engines(request, monkeypatch, scheme, max_batch=4,
                            max_len=64)
    assert add_requests_step_n(te) == add_requests_step_n(je)


@pytest.mark.parametrize("scheme", ["w4a4", "w6a6"])
def test_int_verify_logits_match_jax(request, monkeypatch, scheme):
    """verify_step_logits after a batched prefill: f32 rows within rtol
    1e-3 (atol 1e-4) of JAX's. Each activation is rounded to a 4- or 6-bit
    grid, and the f32 sums of the two packages, taken in different orders,
    differ by ~1e-7: an activation on a rounding tie may land on the other
    grid point (tests/test_torch_models.py), which moves a logit by up to
    ~1e-4 here."""
    je, te, _ = int_engines(request, monkeypatch, scheme, max_batch=2,
                            max_len=64)
    rows = []
    for eng in (je, te):
        slots = eng.add_requests([[5, 6, 7, 8, 9] * 4, [10, 20, 30]])
        rows.append(eng.verify_step_logits(
            {s: [11 + s, 12, 13] for s in slots}))
    for s, want in rows[0].items():
        got = rows[1][s]
        assert got.dtype == np.float32 and got.shape == (3, CFG["vocab_size"])
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# a planar weight-only model: W2A16 g64 (pack_model's auto layout is planar
# for groups below 128 rows)


def test_w2a16g64_planar_engine_matches_jax():
    """The same dense model packed W2 g64 by each package's pack_model
    (planar in both, the same words): greedy streams of generate equal
    JAX's, and a batched prefill's logits its forward's (rtol 1e-4)."""
    dense = numpy_llama(seed=5)
    jp = j_pack_model(J_LLAMA, _to_jax(dense), JQuantConfig(n_bits=2,
                                                            group_size=64))
    tree = jax.tree.map(lambda a: None if a is None else torch.from_numpy(a),
                        dense, is_leaf=lambda a: a is None)
    tp = t_pack_model(T_LLAMA, tree, TQuantConfig(n_bits=2, group_size=64),
                      device="cpu")
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for name in tllama.LINEAR_NAMES:
            assert jl[name].layout == tl[name].layout == "planar"
            np.testing.assert_array_equal(np.asarray(jl[name].qweight),
                                          tl[name].qweight.numpy())
    packed_w2 = (jp, tp)
    je, te = engines(packed_w2, max_batch=2, max_len=64)
    prompt = [(31 * i + 5) % 256 for i in range(12)]
    assert te.generate(prompt, max_new_tokens=8) == je.generate(
        prompt, max_new_tokens=8)
    je, te = engines(packed_w2, max_batch=2, max_len=64)
    prompts = [[5, 6, 7, 8, 9], [10, 20, 30]]
    _, t_logits = te.add_requests(prompts, return_logits=True)
    ref = [np.asarray(jllama.forward(je.params, jnp.asarray([p], jnp.int32),
                                     jllama.LlamaConfig(**CFG))[0, -1])
           for p in prompts]
    np.testing.assert_allclose(t_logits.numpy(), np.stack(ref), rtol=1e-4,
                               atol=1e-5)
