"""The port's OPTEngine against the JAX package's, in f32 on the CPU.

The tiny OPT of tests/test_torch_opt.py (hidden 64, ffn 128, 2 layers, 4
heads, biases and LayerNorms away from their init) packed W4 per-channel
(pairs words) by the JAX package and carried across. Both engines run in
f32 (the JAX Pallas kernels in interpret mode, the port's wrappers through
their plain versions): prefill logits to f32 noise, and equal greedy
streams with a native and an int8 KV cache through generate, step_n and
verify_step; a W4A4 engine with the dense integer route lowered to 16
rows in both packages, as tests/test_torch_engine.py's int_ tests do.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import OPT as J_OPT
from omniquant_tpu.models import opt as jopt
from omniquant_tpu.models.common import ActQuantSpec as JSpec
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.engine import OPTEngine as JEngine
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.kernels import quant_matmul as tqm
from omniquant_tpu_torch.models import opt as topt
from omniquant_tpu_torch.models.common import ActQuantSpec as TSpec
from omniquant_tpu_torch.serving import OPTEngine as TEngine
from omniquant_tpu_torch.utils import from_jax_params

from test_torch_engine import add_requests_step_n, continuous_batching
from test_torch_opt import CFG, numpy_opt

JCFG = jopt.OPTConfig(**CFG)
TCFG = topt.OPTConfig(**CFG)


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


@pytest.fixture(scope="module")
def packed():
    """(JAX packed params, the same carried into the port)."""
    jp = j_pack_model(J_OPT, _jax(numpy_opt(seed=21)),
                      JQuantConfig(n_bits=4, group_size=None))
    np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a), jp,
                           is_leaf=lambda a: a is None)
    return jp, from_jax_params(np_tree, device="cpu")


def engines(packed, **kw):
    jp, tp = packed
    return (JEngine(jp, JCFG, dtype=jnp.float32, **kw),
            TEngine(tp, TCFG, dtype=torch.float32, device="cpu", **kw))


def test_prefill_logits_match_jax(packed):
    """Batched-prefill logits against JAX's forward on the engine's params
    (the fused qkv with its LET-free biases, the learned positions)."""
    je, te = engines(packed, max_batch=2, max_len=64)
    assert "qkv_fused" in te.params["layers"][0]
    assert "gate_up_fused" not in te.params["layers"][0]
    prompts = [[5, 6, 7, 8, 9], [10, 20, 30]]
    _, got = te.add_requests(prompts, return_logits=True)
    want = np.stack([np.asarray(jopt.forward(
        je.params, jnp.asarray([p], jnp.int32), JCFG)[0, -1])
        for p in prompts])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_generate_matches_jax(packed, kv_dtype):
    """A 58-token prompt decoded across the 64-row window bucket into the
    128-row one (int8: K4 codes and planes, the fused attention)."""
    je, te = engines(packed, max_batch=2, max_len=128, kv_dtype=kv_dtype)
    prompt = [(31 * i + 5) % 128 for i in range(58)]
    assert te.generate(prompt, max_new_tokens=10) == je.generate(
        prompt, max_new_tokens=10)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_batching_and_step_n_match_jax(packed, kv_dtype):
    """Slots joining and leaving between single steps, then a batched
    prefill of three prompts and step_n(., 4) twice (int8: the ring-staged
    path and its span flush)."""
    je, te = engines(packed, max_batch=3, max_len=64, kv_dtype=kv_dtype)
    assert continuous_batching(te) == continuous_batching(je)
    je, te = engines(packed, max_batch=4, max_len=64, kv_dtype=kv_dtype)
    assert add_requests_step_n(te) == add_requests_step_n(je)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_verify_step_matches_jax(packed, kv_dtype):
    """verify_step on the engine's own greedy continuation returns it
    shifted by one; decoding continues once the tokens are accepted."""
    je, te = engines(packed, max_batch=2, max_len=64, kv_dtype=kv_dtype)
    prompt = [5, 17, 99, 3]
    results = []
    for eng in (je, te):
        ref = eng.generate(prompt, max_new_tokens=9)
        a = eng.add_request(prompt)
        res = [ref, eng.verify_step({a: ref[:8]})]
        eng.lengths[a] += 8
        last = {a: ref[8]}
        for _ in range(3):
            last = eng.step(last)
            res.append(dict(last))
        results.append(res)
    assert results[1] == results[0]
    assert results[1][1][0] == results[1][0][1:9]


def test_w4a4_engine_matches_jax(packed, monkeypatch):
    """W4A4 on pairs words, the dense integer route from 16 rows on in both
    packages: a 20-token prompt (bucket 32) through K8 + K9's plain
    versions, decode through fake-quant + K1; equal greedy streams."""
    jqm = importlib.import_module("omniquant_tpu.kernels.quant_matmul")
    monkeypatch.setattr(jqm, "_INT_DENSE_MIN_M", 16)
    monkeypatch.setattr(tqm, "_INT_DENSE_MIN_M", 16)
    routes = []
    real_route = tqm.int_route

    def spy(m, pw, cfg):
        routes.append(real_route(m, pw, cfg))
        return routes[-1]

    monkeypatch.setattr(tqm, "int_route", spy)
    jp, tp = packed
    je = JEngine(jp, JCFG, dtype=jnp.float32, spec=JSpec.from_bits(4),
                 max_batch=2, max_len=64)
    te = TEngine(tp, TCFG, dtype=torch.float32, device="cpu",
                 spec=TSpec.from_bits(4), max_batch=2, max_len=64)
    prompt = [(29 * i + 3) % 128 for i in range(20)]
    assert te.generate(prompt, max_new_tokens=8) == je.generate(
        prompt, max_new_tokens=8)
    assert set(routes) == {"dense", "fake_quant"}


def test_post_ln_model_is_refused(packed):
    _, tp = packed
    cfg = topt.OPTConfig(**dict(CFG, do_layer_norm_before=False))
    with pytest.raises(ValueError, match="pre-LN"):
        TEngine(tp, cfg, dtype=torch.float32, device="cpu")
