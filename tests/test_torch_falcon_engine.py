"""The port's FalconEngine against the JAX package's, in f32 on the CPU.

The tiny Falcons of tests/test_torch_falcon.py (hidden 64, 2 layers, 4
heads of 16): multi-query with parallel attention (Falcon-7B's form),
classic multi-head with a post-attention LayerNorm (Falcon-RW's), the new
decoder architecture on 2 kv heads (Falcon-40B's), and the classic form
with ALiBi and biases (Falcon-RW-1B's), packed W4 per-channel (pairs
words) by the JAX package and carried across. Both engines run in f32
(the JAX Pallas kernels in interpret mode, the port's wrappers through
their plain versions) with a native (f32) or an int8 KV cache:
prefill logits to f32 noise, equal greedy streams through generate,
add_requests / step / step_n and verify_step. The cache holds the true kv
heads (one under multi-query); an ALiBi engine keeps the fused int8 decode
attention and the ring off, and its flash prefill takes the slopes;
ring-staged step_n equals sequential steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import FALCON as J_FALCON
from omniquant_tpu.models import falcon as jfalcon
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.engine import FalconEngine as JEngine
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.models import falcon as tfalcon
from omniquant_tpu_torch.serving import FalconEngine as TEngine
from omniquant_tpu_torch.serving import engine as t_engine_mod
from omniquant_tpu_torch.utils import from_jax_params

from test_torch_engine import add_requests_step_n, continuous_batching
from test_torch_falcon import VARIANTS, configs, numpy_falcon

THREE = ("7b", "rw", "40b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are tiny and many; under the test suite's
    parallel workers, several intra-op threads per op made such runs up
    to 100 times slower on a shared CPU (tests/test_torch_cli.py's CLI
    run: 60 s against 0.6 s on one thread). One thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


_PACKED = {}


def packed(variant):
    """(JAX packed params, the same carried into the port), per variant."""
    if variant not in _PACKED:
        jp = j_pack_model(J_FALCON, _jax(numpy_falcon(variant, seed=21)),
                          JQuantConfig(n_bits=4, group_size=None))
        np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                               jp, is_leaf=lambda a: a is None)
        _PACKED[variant] = (jp, from_jax_params(np_tree, device="cpu"))
    return _PACKED[variant]


def engines(variant, **kw):
    jp, tp = packed(variant)
    jcfg, tcfg = configs(variant)
    return (JEngine(jp, jcfg, dtype=jnp.float32, **kw),
            TEngine(tp, tcfg, dtype=torch.float32, device="cpu", **kw))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_match_jax(variant):
    """Batched-prefill logits against JAX's forward on the engine's params
    (the fused query_key_value, rotary or ALiBi positions)."""
    je, te = engines(variant, max_batch=2, max_len=64)
    prompts = [[5, 6, 7, 8, 9], [10, 20, 30]]
    _, got = te.add_requests(prompts, return_logits=True)
    jcfg, _ = configs(variant)
    want = np.stack([np.asarray(jfalcon.forward(
        je.params, jnp.asarray([p], jnp.int32), jcfg)[0, -1])
        for p in prompts])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_matches_jax(variant, kv_dtype):
    """A 58-token prompt decoded across the 64-row window bucket into the
    128-row one (int8: K4 codes and planes, and the fused attention
    unless ALiBi)."""
    je, te = engines(variant, max_batch=2, max_len=128, kv_dtype=kv_dtype)
    assert te.attn_kernel == je.attn_kernel
    prompt = [(31 * i + 5) % 128 for i in range(58)]
    assert te.generate(prompt, max_new_tokens=10) == je.generate(
        prompt, max_new_tokens=10)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("variant", THREE)
def test_batching_and_step_n_match_jax(variant, kv_dtype):
    """Slots joining and leaving between single steps, then a batched
    prefill of three prompts and step_n(., 4) twice (int8: the ring-staged
    path and its span flush)."""
    je, te = engines(variant, max_batch=3, max_len=64, kv_dtype=kv_dtype)
    assert continuous_batching(te) == continuous_batching(je)
    je, te = engines(variant, max_batch=4, max_len=64, kv_dtype=kv_dtype)
    assert add_requests_step_n(te) == add_requests_step_n(je)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("variant", ["7b", "alibi"])
def test_verify_step_matches_jax(variant, kv_dtype):
    """verify_step on the engine's own greedy continuation returns it
    shifted by one; decoding continues once the tokens are accepted; the
    f32 logit rows of verify_step_logits agree with JAX's (rtol 1e-4 on a
    native cache, 1e-3 on an int8 one, as tests/test_torch_engine.py)."""
    je, te = engines(variant, max_batch=2, max_len=64, kv_dtype=kv_dtype)
    prompt = [5, 17, 99, 3]
    results, rows = [], []
    for eng in (je, te):
        ref = eng.generate(prompt, max_new_tokens=9)
        a = eng.add_request(prompt)
        res = [ref, eng.verify_step({a: ref[:8]})]
        rows.append(eng.verify_step_logits({a: ref[:8]})[a])
        eng.lengths[a] += 8
        last = {a: ref[8]}
        for _ in range(3):
            last = eng.step(last)
            res.append(dict(last))
        results.append(res)
    assert results[1] == results[0]
    assert results[1][1][0] == results[1][0][1:9]
    rtol = 1e-3 if kv_dtype == "int8" else 1e-4
    np.testing.assert_allclose(rows[1], rows[0], rtol=rtol, atol=rtol / 10)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_mqa_cache_stores_one_kv_head(kv_dtype):
    """Multi-query caches one kv head, not one per query head, and its
    greedy stream is the full forward's argmax chain (JAX's
    test_falcon_mqa_cache_stores_single_kv_head; the port's forward, held
    to JAX's by tests/test_torch_falcon.py, on the engine's own params)."""
    _, tcfg = configs("7b")
    _, te = engines("7b", max_batch=2, max_len=64, kv_dtype=kv_dtype)
    assert te.cfg.num_key_value_heads == 1 and te.cfg.n_rep == 4
    assert all(t.shape[1] == 1 for t in te.cache.k + te.cache.v)
    if kv_dtype == "int8":
        assert te.cache.k_scale[0].shape == (2, 1, 64)
    prompt = [5, 17, 99, 3]
    got = te.generate(prompt, max_new_tokens=6)
    toks = torch.tensor([prompt])
    ref = []
    for _ in range(6):
        nxt = int(tfalcon.forward(te.params, toks, tcfg)[0, -1].argmax())
        ref.append(nxt)
        toks = torch.cat([toks, torch.tensor([[nxt]])], dim=1)
    assert got == ref


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_alibi_prefill_uses_flash_and_matches(monkeypatch, kv_dtype):
    """A 300-token ALiBi prompt (bucket 512, at the default flash_min_len
    of 256) prefills through flash attention with the slopes, and its
    first token and logits are JAX's engine's and forward's; an int8 ALiBi
    engine keeps the fused decode attention off and decodes as JAX's."""
    calls = []
    real = t_engine_mod.flash_attention

    def spy(*a, **k):
        calls.append((a[0].shape, k.get("alibi_slopes")))
        return real(*a, **k)

    monkeypatch.setattr(t_engine_mod, "flash_attention", spy)
    je, te = engines("alibi", max_batch=1, max_len=512, kv_dtype=kv_dtype)
    assert not te.attn_kernel and not te._use_ring()
    assert je._alibi_slopes() is not None and te._flash_ok()
    prompt = [int(t) for t in np.random.default_rng(8).integers(1, 127, 300)]
    _, got = te.add_requests([prompt], return_logits=True)
    assert len(calls) == 2 and calls[0][0] == (1, 4, 512, 16)
    np.testing.assert_array_equal(calls[0][1].numpy(),
                                  np.asarray(jfalcon.alibi_slopes(4)))
    jcfg, _ = configs("alibi")
    want = jfalcon.forward(je.params, jnp.asarray([prompt], jnp.int32),
                           jcfg)[0, -1]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    slot = je.add_request(prompt)
    assert te._pending_next[0] == je._pending_next[slot] == int(
        jnp.argmax(want))
    first = te._pending_next[0]
    assert te.step_n({0: first}, 4) == je.step_n({slot: first}, 4)


def _streams(eng_fn, prompts, n_steps):
    """(sequential single steps, one staged step_n) token streams."""
    out = []
    for staged in (False, True):
        eng = eng_fn()
        slots = eng.add_requests(prompts)
        toks = {s: eng._pending_next[s] for s in slots}
        res = {s: [t] for s, t in toks.items()}
        if staged:
            for s, ts in eng.step_n(dict(toks), n_steps).items():
                res[s].extend(ts)
        else:
            for _ in range(n_steps):
                toks = eng.step(dict(toks))
                for s, t in toks.items():
                    res[s].append(t)
        out.append(res)
    return out


@pytest.mark.parametrize("alibi", [False, True])
def test_ring_matches_sequential(alibi):
    """An int8 engine's step_n(., 8) equals 8 single steps, and JAX's
    streams (JAX's test_ring_matches_sequential_falcon): without ALiBi
    through the ring the fused attention reads, with ALiBi (no fused
    attention, no ring) through the dense path."""
    variant = "alibi" if alibi else "7b"
    prompts = [list(np.random.default_rng(3).integers(0, 128, n))
               for n in (6, 11)]
    streams = []
    for i in range(2):
        def make(_i=i):
            eng = engines(variant, max_batch=2, max_len=128,
                          kv_dtype="int8")[_i]
            assert eng._use_ring() == eng.attn_kernel == (not alibi)
            return eng
        streams.append(_streams(make, prompts, 8))
    (j_single, j_multi), (t_single, t_multi) = streams
    assert t_multi == t_single == j_single == j_multi
