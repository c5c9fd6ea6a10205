"""The port's speculative decoding (``serving/spec_decode.py``) against the
JAX package, in f32 on the CPU.

Tiny models (3 layers, hidden 32, vocab 128, as tests/test_spec_decode.py)
are made with numpy from a seed and handed to both packages. The greedy
oracle is JAX's ``LlamaEngine.generate`` (its OPT and Falcon engines for
those families): every speculative stream of the port must equal it token
for token, for any draft. JAX's own ``SpecDecoder`` runs only where its
acceptance counts are held (one ``spec_step`` case, one fused
``spec_steps`` case): ``proposed`` and ``accepted`` must be equal, and the
draft's int8 cache (codes and scale planes at [0, lengths)) must match
JAX's draft's within the tolerance stated there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import LLAMA as J_LLAMA
from omniquant_tpu.models import falcon as jfalcon
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.models import opt as jopt
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving import engine as jengine
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu.serving.spec_decode import SpecDecoder as JSpecDecoder
from omniquant_tpu_torch.models import falcon as tfalcon
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.models import opt as topt
from omniquant_tpu_torch.quant import PackedWeight
from omniquant_tpu_torch.serving import (
    FalconEngine, LlamaEngine, OPTEngine, SpecDecoder, layer_skip_params)
from omniquant_tpu_torch.utils import from_jax_params

LLAMA_CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=3, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=256)
OPT_CFG = dict(vocab_size=128, hidden_size=32, ffn_dim=64,
               num_hidden_layers=3, num_attention_heads=4,
               max_position_embeddings=128)
FALCON_CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=3,
                  num_attention_heads=4, bias=False)
FALCON_FORMS = {"mqa": dict(multi_query=True, parallel_attn=True),
                "alibi": dict(multi_query=False, parallel_attn=False,
                              alibi=True)}
PROMPT = [5, 17, 99, 3, 42]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny ops, many of them: one intra-op thread (several made such runs
    far slower under the suite's parallel workers). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(init_params, cfg, seed):
    """A numpy tree in the layout of the JAX family's ``init_params``:
    N(0, 0.02) weights and biases, norms around 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))

    def leaf(path, s):
        if s is None:
            return None
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] == "bias":
            return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)
        if any("norm" in str(k) or str(k).startswith("ln") for k in keys):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes,
                                            is_leaf=lambda x: x is None)


def both(np_tree):
    """(JAX tree, port tree on the CPU) of one numpy tree."""
    jt = jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                      np_tree, is_leaf=lambda a: a is None)
    return jt, from_jax_params(np_tree, device="cpu")


def model(family, form=None):
    """(JAX engine class, port engine class, JAX cfg, port cfg, JAX params,
    port params) of a tiny model of ``family``."""
    if family == "llama":
        jc, tc = jllama.LlamaConfig(**LLAMA_CFG), tllama.LlamaConfig(
            **LLAMA_CFG)
        jp, tp = both(numpy_params(jllama.init_params, jc, 0))
        return jengine.LlamaEngine, LlamaEngine, jc, tc, jp, tp
    if family == "opt":
        jc, tc = jopt.OPTConfig(**OPT_CFG), topt.OPTConfig(**OPT_CFG)
        jp, tp = both(numpy_params(jopt.init_params, jc, 1))
        return jengine.OPTEngine, OPTEngine, jc, tc, jp, tp
    kw = dict(FALCON_CFG, **FALCON_FORMS[form])
    jc, tc = jfalcon.FalconConfig(**kw), tfalcon.FalconConfig(**kw)
    jp, tp = both(numpy_params(jfalcon.init_params, jc, 4))
    return jengine.FalconEngine, FalconEngine, jc, tc, jp, tp


_MODELS = {}


def tiny(family="llama", form=None):
    key = (family, form)
    if key not in _MODELS:
        _MODELS[key] = model(family, form)
    return _MODELS[key]


_GREEDY, _JAX_ENGINES = {}, {}


def jax_greedy(family, prompt, n, form=None, kv="native", packed=None,
               max_len=128):
    """JAX's greedy stream (the oracle), computed once per case on one JAX
    engine per configuration (each engine compiles its own programs)."""
    key = (family, form, kv, packed, max_len)
    if key + (tuple(prompt), n) not in _GREEDY:
        if key not in _JAX_ENGINES:
            jcls, _, jc, _, jp, _ = tiny(family, form)
            if packed is not None:
                jp = packed_pair(packed)[0]
            _JAX_ENGINES[key] = jcls(jp, jc, max_batch=2, max_len=max_len,
                                     dtype=jnp.float32, kv_dtype=kv)
        _GREEDY[key + (tuple(prompt), n)] = _JAX_ENGINES[key].generate(
            list(prompt), max_new_tokens=n)
    return _GREEDY[key + (tuple(prompt), n)]


def port_engine(family="llama", form=None, params=None, **kw):
    _, tcls, _, tc, _, tp = tiny(family, form)
    kw = dict(dict(max_batch=2, max_len=128), **kw)
    return tcls(tp if params is None else params, tc, dtype=torch.float32,
                device="cpu", **kw)


_PACKED = {}


def packed_pair(bits):
    """The tiny LLaMA fake-quantized and packed at ``bits`` (g16, 16-row
    tiles) by the JAX package: (JAX tree, port tree)."""
    if bits not in _PACKED:
        _, _, jc, _, jp, _ = tiny()
        wcfg = JQuantConfig(n_bits=bits, group_size=16)
        fq = dict(jp, layers=[J_LLAMA.effective_block_weights(
            b, wcfg, None, None, jc) for b in jp["layers"]])
        jpk = j_pack_model(J_LLAMA, fq, wcfg, tile_k=16)
        np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                               jpk, is_leaf=lambda a: a is None)
        _PACKED[bits] = (jpk, from_jax_params(np_tree, device="cpu"))
    return _PACKED[bits]


# ---------------------------------------------------------------------------
# greedy: the stream equals JAX's greedy stream


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_layer_skip_stream_equals_jax_greedy(kv, gamma):
    sd = SpecDecoder(port_engine(kv_dtype=kv), draft_layers=1, gamma=gamma)
    assert sd.generate(PROMPT, max_new_tokens=16) == jax_greedy(
        "llama", PROMPT, 16, kv=kv)
    assert sd.proposed > 0


def _int8_layers(eng, n_layers):
    """The first n_layers of an int8 engine's cache as numpy (k codes, v
    codes, k planes, v planes), each (B, n_kv, max_len[, hd])."""
    c = eng.cache
    if isinstance(eng, jengine.LlamaEngine):
        return [(np.asarray(c.k[i]), np.asarray(c.v[i]),
                 np.asarray(jengine.scale_plane_view(c.k_scale[i])),
                 np.asarray(jengine.scale_plane_view(c.v_scale[i])))
                for i in range(n_layers)]
    return [(c.k[i].numpy(), c.v[i].numpy(), c.k_scale[i].numpy(),
             c.v_scale[i].numpy()) for i in range(n_layers)]


def _int8_cache_close(got, want, lengths, n_layers=1):
    """Two int8 caches on [0, length) of each active slot: the scales to
    1e-5 relative, the codes equal but for at most one step on one code in
    a thousand (f32 sums in another order can move a quotient across a
    rounding tie)."""
    for g, w in zip(_int8_layers(got, n_layers), _int8_layers(want, n_layers)):
        for s, n in lengths.items():
            for a, b in zip(g[:2], w[:2]):
                a = a[s, :, :n].astype(np.int32)
                b = b[s, :, :n].astype(np.int32)
                assert np.abs(a - b).max() <= 1
                assert (a != b).mean() <= 1e-3
            for a, b in zip(g[2:], w[2:]):
                np.testing.assert_allclose(a[s, :, :n], b[s, :, :n],
                                           rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_counts_and_draft_cache_match_jax_spec_decoder(fused):
    """JAX's SpecDecoder and the port's on the same int8 engines, two slots:
    spec_step (one fused round) three times, or spec_steps of 2 rounds
    twice, against JAX's host-paced spec_step and fused rounds. Emitted
    tokens, proposed and accepted are equal; the draft caches match
    (_int8_cache_close), rejected rows past lengths aside, and so do the
    port's draft's and target's first layer (written by decode steps and
    by verify passes, from the same tokens)."""
    jcls, _, jc, _, jp, _ = tiny()
    prompts = [PROMPT, [88, 2, 61]]
    jsd = JSpecDecoder(jcls(jp, jc, max_batch=2, max_len=128,
                            dtype=jnp.float32, kv_dtype="int8"),
                       draft_layers=1, gamma=3)
    tsd = SpecDecoder(port_engine(kv_dtype="int8"), draft_layers=1, gamma=3)
    outs = []
    for sd in (jsd, tsd):
        slots = [sd.add_request(p) for p in prompts]
        last = {s: sd._pending(s) for s in slots}
        stream = {s: [t] for s, t in last.items()}
        for _ in range(2 if fused else 3):
            res = sd.spec_steps(last, rounds=2) if fused else sd.spec_step(
                last)
            for s, toks in res.items():
                stream[s] += toks
                last[s] = toks[-1]
        outs.append((stream, sd.proposed, sd.accepted))
    assert outs[0] == outs[1]
    assert 0 < tsd.accepted < tsd.proposed
    lengths = {s: int(tsd.target.lengths[s]) for s in (0, 1)}
    assert lengths == {s: int(jsd.target.lengths[s]) for s in (0, 1)}
    _int8_cache_close(tsd.draft, jsd.draft, lengths)
    _int8_cache_close(tsd.draft, tsd.target, lengths)


def test_full_depth_self_draft_accepts_everything():
    """A draft with every layer of the target accepts each proposal and
    emits gamma + 1 tokens a round (the bonus token, and the draft's
    gamma + 1-th step covering L + gamma)."""
    prompt = [7, 30, 2]
    sd = SpecDecoder(port_engine(), draft_layers=3, gamma=3)
    assert sd.generate(prompt, max_new_tokens=13) == jax_greedy(
        "llama", prompt, 13)
    assert sd.acceptance_rate == 1.0


def test_w2_draft_for_w4_target():
    """A W2 pack of the same weights drafts for the W4 pack: the stream is
    the W4 engine's, whatever the W2 model proposes."""
    prompt = [11, 63, 2, 9]
    target = port_engine(params=packed_pair(4)[1])
    draft = port_engine(params=packed_pair(2)[1])
    sd = SpecDecoder(target, draft=draft, gamma=3)
    assert sd.generate(prompt, max_new_tokens=12) == jax_greedy(
        "llama", prompt, 12, packed=4)
    assert sd.proposed > 0


def test_multi_slot_divergent_acceptance():
    """Three slots in each spec_step accept different counts; each stream
    equals its own single-slot JAX greedy stream."""
    prompts = [[5, 17, 99], [3, 42, 7, 1], [88, 2]]
    sd = SpecDecoder(port_engine(max_batch=4), draft_layers=1, gamma=3)
    slots = [sd.add_request(p) for p in prompts]
    outs = {s: [sd._pending(s)] for s in slots}
    counts = set()
    while any(len(outs[s]) < 12 for s in slots):
        res = sd.spec_step({s: outs[s][-1] for s in slots
                            if len(outs[s]) < 12})
        counts.add(tuple(len(v) for v in res.values()))
        for s, toks in res.items():
            outs[s].extend(toks)
    assert any(len(set(c)) > 1 for c in counts)
    for s, p in zip(slots, prompts):
        assert outs[s][:12] == jax_greedy("llama", p, 12)


@pytest.mark.parametrize("family,form", [("opt", None), ("falcon", "mqa"),
                                         ("falcon", "alibi")])
def test_opt_and_falcon_streams_equal_jax_greedy(family, form):
    """OPT (learned positions, the draft's config from _ocfg) and Falcon
    in its multi-query and ALiBi layouts (the verify mask with the bias)."""
    prompt = [5, 17, 99, 3]
    sd = SpecDecoder(port_engine(family, form, max_len=64), draft_layers=1,
                     gamma=2)
    assert type(sd.draft) is type(sd.target)
    assert sd.draft.cfg.num_hidden_layers == 1
    assert sd.generate(prompt, max_new_tokens=10) == jax_greedy(
        family, prompt, 10, form=form, max_len=64)
    assert sd.proposed > 0


def test_near_max_len_falls_back_to_steps():
    """max_len 16: prompt 4 + 12 new tokens fill the cache; the dispatch
    shrinks to the rounds that fit and ends with plain steps, giving the
    greedy stream instead of raising."""
    prompt = [5, 17, 99, 3]
    sd = SpecDecoder(port_engine(max_len=16), draft_layers=1, gamma=2)
    assert sd.generate(prompt, max_new_tokens=12) == jax_greedy(
        "llama", prompt, 12, max_len=16)


def test_bystander_slot_capacity_guard():
    """A decode writes a row for every slot: stepping slot a while active
    slot b sits one row below max_len raises instead of cutting b short."""
    eng = port_engine(max_len=16)
    a = eng.add_request([5, 17, 99, 3])
    b = eng.add_request([1, 2, 3])
    eng.lengths[b] = 15
    with pytest.raises(RuntimeError, match="max_len"):
        eng.step_n({a: 7}, 4)
    sd = SpecDecoder(port_engine(max_len=16), draft_layers=1, gamma=2)
    a = sd.add_request([5, 17, 99, 3])
    b = sd.add_request([1, 2, 3])
    sd.target.lengths[b] = 15
    with pytest.raises(RuntimeError, match="max_len"):
        sd.spec_steps({a: 7}, rounds=1)


def test_packed_draft_head_stream_is_exact():
    """draft_head_bits=4 packs only the draft's head (per channel at hidden
    32); the stream is still the target's greedy stream."""
    prompt = [5, 17, 9]
    sd = SpecDecoder(port_engine(max_batch=1, max_len=64), draft_layers=1,
                     gamma=3, draft_head_bits=4)
    head = sd.draft.params["lm_head"]
    assert isinstance(head, PackedWeight) and head.bits == 4
    assert sd.target.params["lm_head"] is not head
    assert not isinstance(sd.target.params["lm_head"], PackedWeight)
    assert sd.generate(prompt, max_new_tokens=16) == jax_greedy(
        "llama", prompt, 16, max_len=64)


def test_layer_skip_params_share_the_targets_tensors():
    """The default draft holds the target's own tensors: its layers,
    embedding, norm and head are the same storage (data_ptr)."""
    sd = SpecDecoder(port_engine(params=packed_pair(4)[1]), draft_layers=2,
                     gamma=2)
    t, d = sd.target.params, sd.draft.params
    assert len(d["layers"]) == 2
    for tl, dl in zip(t["layers"], d["layers"]):
        for name in ("qkv_fused", "gate_up_fused", "o_proj", "down_proj"):
            assert dl[name].qweight.data_ptr() == tl[name].qweight.data_ptr()
            assert dl[name].scales.data_ptr() == tl[name].scales.data_ptr()
        assert (dl["input_layernorm"]["weight"].data_ptr()
                == tl["input_layernorm"]["weight"].data_ptr())
    for name in ("embed_tokens", "lm_head"):
        assert d[name].data_ptr() == t[name].data_ptr()
    direct = layer_skip_params(t, 1)
    assert direct["layers"][0] is t["layers"][0]
    assert direct["embed_tokens"] is t["embed_tokens"]


# ---------------------------------------------------------------------------
# sampling mode


def test_sampling_refuses_greedy_and_truncated_slots():
    sd = SpecDecoder(port_engine(max_len=64), draft_layers=1, gamma=2)
    s0 = sd.add_request([5, 17])
    with pytest.raises(ValueError, match="temperature"):
        sd.sample_spec_step({s0: 3})
    sd.release(s0)
    s1 = sd.add_request([5, 17], temperature=0.5, top_k=4)
    with pytest.raises(ValueError, match="top_k"):
        sd.sample_spec_step({s1: 3})
    sd.release(s1)
    s2 = sd.add_request([5, 17], temperature=0.5)
    with pytest.raises(ValueError, match="GREEDY"):
        sd.spec_steps({s2: 3})


def test_sampling_full_depth_draft_accepts_everything():
    """draft == target: q == p bit for bit, every proposal is accepted and
    each round emits gamma + 1 tokens; generate(temperature) gives
    max_new_tokens tokens of the vocabulary, ending in plain steps near
    max_len."""
    sd = SpecDecoder(port_engine(), draft_layers=3, gamma=3)
    slot = sd.add_request([5, 17, 9], temperature=0.7)
    out = [sd._pending(slot)]
    for _ in range(4):
        emitted = sd.sample_spec_step({slot: out[-1]})[slot]
        assert len(emitted) == sd.gamma + 1
        out.extend(emitted)
    assert sd.acceptance_rate == 1.0
    sd.release(slot)
    sd = SpecDecoder(port_engine(max_len=32), draft_layers=1, gamma=2)
    out = sd.generate([5, 17, 9, 2], max_new_tokens=24, temperature=0.8)
    assert len(out) == 24 and all(0 <= t < 128 for t in out)


def test_sampling_first_token_distribution():
    """The speculative-sampling identity: over repeated rounds from one
    context, the first emitted token is distributed as softmax(target
    logits / T), the logits taken from JAX's forward of the same weights.
    vocab 16: E[TV] ~ sqrt(V / (2 pi n)) ~ 0.046 at n = 1200; the bound
    0.12 is JAX's."""
    cfg = dict(LLAMA_CFG, vocab_size=16)
    jc, tc = jllama.LlamaConfig(**cfg), tllama.LlamaConfig(**cfg)
    jp, tp = both(numpy_params(jllama.init_params, jc, 5))
    T = 0.9
    eng = LlamaEngine(tp, tc, max_batch=1, max_len=256, dtype=torch.float32,
                      device="cpu")
    sd = SpecDecoder(eng, draft_layers=1, gamma=2)
    prompt = [5, 3, 11, 7]
    slot = sd.add_request(prompt, temperature=T)
    last = sd._pending(slot)
    L = int(eng.lengths[slot])
    toks = jnp.asarray(np.asarray(prompt + [last], np.int32)[None])
    z = np.asarray(jllama.forward(jp, toks, jc))[0, -1].astype(np.float64) / T
    p = np.exp(z - z.max())
    p /= p.sum()
    n = 1200
    counts = np.zeros(16)
    for _ in range(n):
        counts[sd.sample_spec_step({slot: last})[slot][0]] += 1
        eng.lengths[slot] = L  # rewind: the same context every round
        sd.draft.lengths[slot] = L
    tv = 0.5 * np.abs(counts / n - p).sum()
    assert tv < 0.12, (tv, counts / n, p)
