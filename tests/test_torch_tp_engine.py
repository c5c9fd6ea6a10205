"""The port's tensor-parallel engines (``serving/tp_engine.py``) against the
port's single engines, which the other engine tests hold against JAX's,
and against JAX's ``TPLlamaEngine`` where that is cheap; on the CPU in f32.

Every case of JAX tests/test_tp_engine.py: the tiny LLaMA packed at tp 2
and 4; dense weights with W4A4 activations (the column-parallel inputs'
per-token ranges through the min/max all-reduce); int8 KV (``step_n``'s
ring too); continuous batching; ``auto_grow``; the W4A4 integer path on
packed weights; overlap chunks; OPT (and OPT W4A4, its q/k/v quantized
over the whole hidden); Falcon multi-query, the new decoder architecture,
ALiBi classic and multi-query, and the ALiBi flash prefill. Each TP engine
gives the single engine's greedy tokens exactly (and its sampled ones:
every shard draws from its own generator, seeded alike). Then
``verify_step_logits`` against JAX's ``TPLlamaEngine`` within 1e-5,
``SpecDecoder`` with a TP target (its draft a TP engine placed from the
raw params), and ``TorchLM(tp_mesh=...)``'s ``greedy_until``, each equal
to the single engine's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.parallel import make_mesh as j_make_mesh
from omniquant_tpu.serving.tp_engine import TPLlamaEngine as JTPLlamaEngine
from omniquant_tpu_torch.models.common import ActQuantSpec
from omniquant_tpu_torch.quant import QuantConfig
from omniquant_tpu_torch.serving import (
    FalconEngine, LlamaEngine, OPTEngine, SpecDecoder, TPFalconEngine,
    TPLlamaEngine, TPOPTEngine)

from test_torch_sharding import (  # noqa: F401
    CFGS, cpu_mesh, one_torch_thread, packed, tiny)

PROMPT = [5, 17, 99, 3, 42]
CFGS["falcon_alibimq"] = dict(CFGS["falcon_alibi"], multi_query=True)
CFGS["falcon_flash"] = dict(CFGS["falcon_alibi"], bias=False)
SINGLE = {"llama": LlamaEngine, "opt": OPTEngine, "falcon": FalconEngine}
TP = {"llama": TPLlamaEngine, "opt": TPOPTEngine, "falcon": TPFalconEngine}


def engines(name, params, tp=2, **kw):
    """(single engine, TP engine over ``tp`` CPU shards) of the tiny model
    ``name`` on ``params``, in f32."""
    fam = name.split("_")[0]
    cfg = tiny(name)[1]
    kw = dict(dict(max_batch=2, max_len=64, dtype=torch.float32), **kw)
    return (SINGLE[fam](params, cfg, device="cpu", **kw),
            TP[fam](params, cfg, cpu_mesh(tp), **kw))


def same_generate(name, params, tp=2, prompt=PROMPT, n=8, gen_kw=None,
                  **kw):
    base, eng = engines(name, params, tp, **kw)
    gen_kw = gen_kw or {}
    want = base.generate(list(prompt), max_new_tokens=n, **gen_kw)
    got = eng.generate(list(prompt), max_new_tokens=n, **gen_kw)
    assert got == want, (got, want)
    return base, eng


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_llama_engine_matches_single_packed(tp):
    _, eng = same_generate("llama", packed("llama")[1], tp)
    shard = eng.shards[0]
    assert len(eng.shards) == tp
    assert shard.cfg.num_attention_heads == 4 // tp
    assert shard.cache.k[0].shape == (2, 4 // tp, 64, 64)
    assert "qkv_fused" in shard.params["layers"][0]


def test_tp_llama_engine_dense_and_w4a4():
    """Dense weights and a W4A4 spec: the column-parallel inputs' ranges
    come from the min/max all-reduce, the single engine's exactly."""
    same_generate("llama", tiny("llama")[3], spec=ActQuantSpec.from_bits(4))


@pytest.mark.parametrize("steps", ["generate", "step_n"])
def test_tp_llama_engine_int8_kv(steps):
    """The head-sharded int8 cache: each shard's writes and fused decode
    attention on its heads; step_n stages each shard's ring."""
    pk = packed("llama")[1]
    if steps == "generate":
        same_generate("llama", pk, kv_dtype="int8")
        return
    base, eng = engines("llama", pk, kv_dtype="int8")
    outs = []
    for e in (base, eng):
        slots = e.add_requests([PROMPT, [7, 8, 9]])
        last = {s: e._pending_next[s] for s in slots}
        outs.append(e.step_n(last, 6))
    assert outs[1] == outs[0]
    for li in range(2):  # the shards' codes are the single cache's heads
        got = torch.cat([s.cache.k[li] for s in eng.shards], dim=1)
        assert torch.equal(got, base.cache.k[li])


def test_tp_llama_continuous_batching():
    """Batched prefill, step_n with slots joining and leaving."""
    reqs = [[5, 17, 99], [3, 42, 7, 11, 19], [1, 2]]

    def run(eng):
        slots = eng.add_requests(reqs)
        toks = {s: eng._pending_next[s] for s in slots}
        outs = {s: [toks[s]] for s in slots}
        for s, r in eng.step_n(toks, 4).items():
            outs[s].extend(r)
        eng.release(slots[1])
        live = {s: outs[s][-1] for s in slots if s != slots[1]}
        for s, r in eng.step_n(live, 2).items():
            outs[s].extend(r)
        new = eng.add_request([9, 9, 4])
        for s, r in eng.step_n({**{s: outs[s][-1] for s in live},
                                new: eng._pending_next[new]}, 3).items():
            outs.setdefault(s, []).extend(r)
        return outs

    base, eng = engines("llama", packed("llama")[1], max_batch=4)
    assert run(eng) == run(base)


def test_tp_auto_grow_matches_single():
    """The head-sharded buffers of every shard double; tokens match the
    single auto-grow engine."""
    base, eng = same_generate("llama", packed("llama")[1], prompt=[5, 17, 99, 3],
                              n=20, max_batch=1, max_len=16, auto_grow=True)
    assert eng.max_len == base.max_len == 32
    assert all(s.max_len == 32 and s.cache.k[0].shape[2] == 32
               for s in eng.shards)


def test_tp_packed_w4a4_int_path_matches_single():
    """Packed weights and a W4A4 spec: the row-parallel linears take the
    integer path on their whole inputs, the column-parallel ones the exact
    fake-quant and the all-reduce."""
    same_generate("llama", packed("llama", gs=128, tile_k=None)[1],
                  spec=ActQuantSpec.from_bits(4), max_batch=1)


def test_tp_engine_overlap_chunks_matches():
    """overlap_chunks=2: the TP engine's stream without chunks, and its
    logits too, exactly."""
    pk = packed("llama")[1]
    cfg = tiny("llama")[1]
    ref = TPLlamaEngine(pk, cfg, cpu_mesh(2), max_batch=2, max_len=64,
                        dtype=torch.float32)
    got = TPLlamaEngine(pk, cfg, cpu_mesh(2), max_batch=2, max_len=64,
                        dtype=torch.float32, overlap_chunks=2)
    assert got.generate(PROMPT, 10) == ref.generate(PROMPT, 10)
    a = ref.add_requests([PROMPT], return_logits=True)[1]
    b = got.add_requests([PROMPT], return_logits=True)[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("spec", [None, 4])
def test_tp_opt_engine_matches_single(spec):
    """OPT packed (biases, the padded ffn), and dense with W4A4: q, k and v
    quantized per token over the whole hidden through the min/max
    all-reduce."""
    if spec is None:
        same_generate("opt", packed("opt")[1])
    else:
        same_generate("opt", tiny("opt")[3],
                      spec=ActQuantSpec.from_bits(spec))


@pytest.mark.parametrize("name", ["falcon_mqa", "falcon_new",
                                  "falcon_alibi", "falcon_alibimq"])
def test_tp_falcon_engine_matches_single(name):
    """Multi-query (each shard a replica of the kv head), the new decoder
    architecture's kv groups, and ALiBi (classic and multi-query: each
    shard's slice of the global slopes)."""
    _, eng = same_generate(name, packed(name)[1], kv_dtype="int8")
    kv_local = {"falcon_mqa": 1, "falcon_new": 1, "falcon_alibi": 2,
                "falcon_alibimq": 1}[name]
    assert eng.shards[1].cache.k[0].shape[1] == kv_local
    if "alibi" in name:
        assert torch.equal(eng.shards[1]._slopes, eng._slopes[2:])


def test_tp_falcon_alibi_flash_prefill_matches_single():
    """A 40-token ALiBi prompt past flash_min_len: each shard's prefill
    takes its local slopes."""
    prompt = list(np.random.default_rng(3).integers(1, 128, 40))
    same_generate("falcon_flash", packed("falcon_flash")[1], prompt=prompt,
                  n=6, max_batch=1, max_len=128, flash_min_len=32)


def test_tp_sampling_matches_single():
    """temperature 0.8, top_k 20: every shard's generator draws as the
    single engine's, in step_n's steps too."""
    same_generate("llama", packed("llama")[1], n=12, seed=3,
                  gen_kw=dict(temperature=0.8, top_k=20))


@pytest.mark.parametrize("name", ["llama", "opt", "falcon_alibi"])
def test_tp_engine_on_dp_rows_matches_one_row(name):
    """A (2, 2) mesh, as JAX's engine takes one: each row's shards split
    over tp 2 (column p % 2, ALiBi slopes too) and the rows are replicas,
    so the logits are the (1, 2) mesh's bit for bit, and so are the
    tokens."""
    from omniquant_tpu_torch.parallel import make_mesh

    fam = name.split("_")[0]
    pk, cfg = packed(name)[1], tiny(name)[1]
    kw = dict(max_batch=2, max_len=64, dtype=torch.float32)
    rows = TP[fam](pk, cfg, make_mesh(dp=2, tp=2, devices=["cpu"] * 4),
                   **kw)
    one = TP[fam](pk, cfg, cpu_mesh(2), **kw)
    assert rows.tp == 2 and len(rows.shards) == 4
    toks = [7, 11, 13, 17]
    logits = []
    for e in (one, rows):
        slot = e.add_request(PROMPT)
        logits.append(e.verify_step_logits({slot: toks})[slot])
    assert np.array_equal(logits[1], logits[0])
    assert (rows.generate(PROMPT, max_new_tokens=6)
            == one.generate(PROMPT, max_new_tokens=6))
    if name == "falcon_alibi":
        assert torch.equal(rows.shards[3]._slopes, one.shards[1]._slopes)


def test_tp_engine_refuses():
    pk = packed("llama")[1]
    cfg = tiny("llama")[1]
    grouped = ActQuantSpec(act=QuantConfig(n_bits=4, symmetric=False,
                                           group_size=32))
    with pytest.raises(NotImplementedError, match="straddle"):
        TPLlamaEngine(pk, cfg, cpu_mesh(2), dtype=torch.float32,
                      spec=grouped).generate(PROMPT, 2)
    with pytest.raises(ValueError, match="divide into tp=8"):
        TPLlamaEngine(pk, cfg, cpu_mesh(8), dtype=torch.float32)
    with pytest.raises(TypeError, match="takes no device"):
        TPLlamaEngine(pk, cfg, cpu_mesh(2), device="cpu")


def test_verify_step_logits_matches_jax_tp():
    """After the same prompt, verify_step_logits of 4 tokens on the port's
    TP engine against JAX's TPLlamaEngine (tp 2) and the port's single
    engine (which adds the shards' partial sums in another order), each
    within 1e-5."""
    jpk, tpk = packed("llama")
    jc, tc = tiny("llama")[:2]
    jeng = JTPLlamaEngine(jpk, jc, j_make_mesh(dp=1, tp=2), max_batch=2,
                          max_len=64, dtype=jnp.float32)
    base, eng = engines("llama", tpk)
    toks = [7, 11, 13, 17]
    outs = []
    for e in (jeng, base, eng):
        slot = e.add_request(PROMPT)
        outs.append(e.verify_step_logits({slot: toks})[slot])
    assert outs[2].shape == (4, 128)
    np.testing.assert_allclose(outs[2], np.asarray(outs[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(outs[2], outs[1], rtol=1e-5, atol=1e-5)


def test_spec_decoder_with_tp_target():
    """A TP target's default draft is a TP engine of its first layer,
    placed from the raw params; the greedy stream is the single engine's,
    and spec_steps runs its rounds one at a time."""
    pk = packed("llama")[1]
    base, eng = engines("llama", pk, max_len=128)
    want = base.generate(PROMPT, max_new_tokens=16)
    sd = SpecDecoder(eng, draft_layers=1, gamma=3)
    assert isinstance(sd.draft, TPLlamaEngine)
    assert len(sd.draft.shards[0].params["layers"]) == 1
    assert sd.generate(PROMPT, max_new_tokens=16) == want
    assert sd.proposed > 0


def test_torchlm_greedy_until_tp_matches_single():
    """TorchLM(tp_mesh=...) generates through the family's TP engine, with
    the single engine's text."""
    from omniquant_tpu_torch.cli import CharTokenizer
    from omniquant_tpu_torch.eval.harness.base import TorchLM
    from omniquant_tpu_torch.models.registry import LLAMA

    cfg, params = tiny("llama")[1], tiny("llama")[3]
    reqs = [("abcabc", ["\n"]), ("hello wor", ["q"])]
    lms = [TorchLM(LLAMA, params, cfg, CharTokenizer(128), seqlen=128,
                   batch_size=2, device="cpu", tp_mesh=mesh)
           for mesh in (None, cpu_mesh(2))]
    for lm in lms:
        lm.max_gen_toks = 8
    assert isinstance(lms[1]._get_engine(), TPLlamaEngine)
    assert lms[1].greedy_until(reqs) == lms[0].greedy_until(reqs)
