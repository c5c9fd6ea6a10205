"""``TorchLM`` against ``JaxLM`` on a tiny LLaMA (grouped-query, 4 heads on
2 kv heads) and a tiny Falcon (Falcon-7B's multi-query form with parallel
attention), f32 on the CPU.

The CLI's tiny configs (hidden 64, 2 layers) at vocab 128, initialised by
JAX with the 2-D weights scaled by 8 and carried across with
``from_jax_params``; seqlen 128, batch 4. Every loglikelihood within 1e-4
absolute with equal greedy flags, loglikelihood_rolling within 1e-4
relative, and greedy_until texts equal over two waves of requests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.eval.harness import JaxLM
from omniquant_tpu.models import FALCON as J_FALCON
from omniquant_tpu.models import LLAMA as J_LLAMA
from omniquant_tpu_torch.eval.harness import TorchLM
from omniquant_tpu_torch.models import FALCON, LLAMA
from omniquant_tpu_torch.utils import from_jax_params

from test_harness import CharTokenizer
from test_torch_harness import (
    BATCH, GEN_REQS, GEN_TOKS, LL_ATOL, ROLLING_REQS, ROLLING_RTOL,
    SCORE_REQS, SEQLEN, WEIGHT_SCALE)

FAMILIES = {
    "llama": (J_LLAMA, LLAMA, dict(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)),
    "falcon": (J_FALCON, FALCON, dict(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True, parallel_attn=True)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the port's ops here are tiny and many, and the
    suite's parallel workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request):
    jfam, tfam, kw = FAMILIES[request.param]
    jp = jfam.init_params(jax.random.PRNGKey(1), jfam.config_cls(**kw))
    nt = jax.tree.map(
        lambda a: np.asarray(a) * (WEIGHT_SCALE if a.ndim == 2 else 1.0), jp)
    jl = JaxLM(jfam, jax.tree.map(jnp.asarray, nt), jfam.config_cls(**kw),
               CharTokenizer(), seqlen=SEQLEN, batch_size=BATCH)
    tl = TorchLM(tfam, from_jax_params(nt, device="cpu"),
                 tfam.config_cls(**kw), CharTokenizer(), seqlen=SEQLEN,
                 batch_size=BATCH, device="cpu")
    return jl, tl


def test_loglikelihood_matches_jax(pair):
    jl, tl = pair
    want = jl.loglikelihood(SCORE_REQS)
    got = tl.loglikelihood(SCORE_REQS)
    assert [g for _, g in got] == [g for _, g in want]
    np.testing.assert_allclose([x for x, _ in got], [x for x, _ in want],
                               rtol=0, atol=LL_ATOL)


def test_loglikelihood_rolling_matches_jax(pair):
    jl, tl = pair
    np.testing.assert_allclose(tl.loglikelihood_rolling(ROLLING_REQS),
                               jl.loglikelihood_rolling(ROLLING_REQS),
                               rtol=ROLLING_RTOL)


def test_greedy_until_matches_jax_over_two_waves(pair):
    jl, tl = pair
    jl.max_gen_toks = tl.max_gen_toks = GEN_TOKS
    got = tl.greedy_until(GEN_REQS)
    assert got == jl.greedy_until(GEN_REQS)
    assert len(set(got)) > 1
