"""The PyTorch port's serving engine against the JAX LlamaEngine.

A tiny LLaMA (hidden 256, inter 512, 2 layers, 4 query / 2 kv heads) is
made with numpy from a seed, packed W4 g128 (pairs layout) by the JAX
package and carried across by ``from_jax_params``. Both engines run in f32
on the CPU (the JAX Pallas kernels in interpret mode, the port's wrappers
through their plain versions); their greedy token streams must be equal.
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


def test_continuous_batching_matches_jax(packed):
    """Slots join and leave between single steps."""
    je, te = engines(packed, max_batch=3, max_len=64)
    streams = []
    for eng in (je, te):
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
        streams.append(out)
    assert streams[0] == streams[1]


def test_add_requests_step_n_matches_jax(packed):
    je, te = engines(packed, max_batch=4, max_len=64)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [1, 6, 1, 8, 0, 3, 3]]
    streams = []
    for eng in (je, te):
        slots = eng.add_requests(prompts)
        last = {s: eng._pending_next[s] for s in slots}
        out = {s: [t] for s, t in last.items()}
        for _ in range(2):
            res = eng.step_n(last, 4)
            for s, toks in res.items():
                out[s].extend(toks)
                last[s] = toks[-1]
        streams.append(out)
    assert streams[0] == streams[1]


def test_flash_gated_prompt_matches_jax(packed, monkeypatch):
    """A prompt whose bucket crosses a lowered flash_min_len takes the
    blockwise-attention path in both engines."""
    calls = []
    real = t_engine_mod.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(t_engine_mod, "flash_attention", spy)
    je, te = engines(packed, max_batch=2, max_len=128, flash_min_len=32)
    prompt = [(7 * i + 3) % 256 for i in range(40)]
    assert te.generate(prompt, max_new_tokens=6) == je.generate(
        prompt, max_new_tokens=6)
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
    _, tp = packed
    cfg = tllama.LlamaConfig(**CFG)
    with pytest.raises(NotImplementedError):
        TEngine(tp, cfg, kv_dtype="int8", device="cpu")
    with pytest.raises(NotImplementedError):
        TEngine(tp, cfg, auto_grow=True, device="cpu")
    eng = TEngine(tp, cfg, max_batch=1, max_len=32, device="cpu",
                  dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        eng.verify_step({0: [1, 2]})


def test_capacity_guard(packed):
    """A decode that would write at max_len is refused, never clamped."""
    _, te = engines(packed, max_batch=1, max_len=32)
    slot = te.add_request(list(range(1, 31)))
    with pytest.raises(RuntimeError, match="max_len"):
        te.step_n({slot: te._pending_next[slot]}, 4)
    assert dataclasses.is_dataclass(te.cache)
