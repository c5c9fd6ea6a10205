"""The port's evaluation harness (``omniquant_tpu_torch.eval.harness``)
against the JAX package's, on a tiny OPT in f32 on the CPU.

The OPT of tests/test_harness.py (vocab 128, hidden 32, 2 layers, 4 heads),
initialised by JAX with its 2-D weights scaled by 8 (a random tiny OPT
otherwise greedy-decodes one repeated character) and carried across with
``from_jax_params``; the test_harness ``CharTokenizer``. ``TorchLM``
(device="cpu": the kernels' plain versions) against ``JaxLM``: every
loglikelihood within 1e-4 absolute with equal greedy flags,
loglikelihood_rolling within 1e-4 relative, greedy_until texts equal over
two waves of requests (more than batch_size), dense and packed (W4 g32),
and under ``ActQuantSpec.from_bits(4)`` equal to JAX's and to the port's
own ``_greedy_until_uncached``. ``simple_evaluate`` on injected piqa,
lambada_openai, wikitext and gsm8k docs (made from a numpy seed) gives the
same results dict through both packages at 0 and 2 few-shot examples.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.eval.harness import JaxLM
from omniquant_tpu.eval.harness import simple_evaluate as j_simple_evaluate
from omniquant_tpu.models import OPT as J_OPT
from omniquant_tpu.models import opt as jopt
from omniquant_tpu.models.common import ActQuantSpec as JActQuantSpec
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.eval.harness import TorchLM, simple_evaluate
from omniquant_tpu_torch.models import OPT, opt
from omniquant_tpu_torch.models.common import ActQuantSpec
from omniquant_tpu_torch.utils import from_jax_params

from test_harness import CharTokenizer

CFG = dict(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=256)
SEQLEN, BATCH = 128, 4
LL_ATOL = 1e-4
ROLLING_RTOL = 1e-4
WEIGHT_SCALE = 8.0

SCORE_REQS = [("hello ", "world"), ("", "abc"),
              ("the quick brown fox", " jumps"), ("a" * 200, "bb"),
              ("xy", "z" * 5), ("q", "r"), ("Question: 2+2?\nAnswer:", " 4")]
ROLLING_REQS = [("hello world " * 30,), ("short doc",), ("x" * 129,)]
GEN_REQS = [("abcabc", ["\n"]), ("hello wor", ["q", "zz"]), ("x", ["\n"]),
            ("the quick brown", ["!"]), ("aaaa bbbb cccc", ["\n"])]
GEN_TOKS = 9  # the first token and one step_n(., 8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the port's ops here are tiny and many, and the
    suite's parallel workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_opt_numpy(seed=0):
    """JAX's init_params of the tiny OPT as numpy, 2-D weights x 8."""
    jp = jopt.init_params(jax.random.PRNGKey(seed), jopt.OPTConfig(**CFG))
    return jax.tree.map(
        lambda a: np.asarray(a) * (WEIGHT_SCALE if a.ndim == 2 else 1.0), jp)


def _to_jax(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _to_numpy(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def lm_pair(packed=False, abits=16):
    """(JaxLM, TorchLM) over the same weights (dense, or packed W4 g32 by
    the JAX package), f32."""
    nt = jax_opt_numpy()
    jp = _to_jax(nt)
    if packed:
        jp = j_pack_model(J_OPT, jp, JQuantConfig(n_bits=4, group_size=32))
        nt = _to_numpy(jp)
    jl = JaxLM(J_OPT, jp, jopt.OPTConfig(**CFG), CharTokenizer(),
               seqlen=SEQLEN, batch_size=BATCH,
               spec=JActQuantSpec.from_bits(abits))
    tl = TorchLM(OPT, from_jax_params(nt, device="cpu"),
                 opt.OPTConfig(**CFG), CharTokenizer(), seqlen=SEQLEN,
                 batch_size=BATCH, spec=ActQuantSpec.from_bits(abits),
                 device="cpu")
    return jl, tl


@pytest.fixture(scope="module")
def dense():
    return lm_pair()


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "w4g32"])
def test_loglikelihood_matches_jax(packed, dense):
    jl, tl = dense if not packed else lm_pair(packed=True)
    want = jl.loglikelihood(SCORE_REQS)
    got = tl.loglikelihood(SCORE_REQS)
    assert [g for _, g in got] == [g for _, g in want]
    np.testing.assert_allclose([x for x, _ in got], [x for x, _ in want],
                               rtol=0, atol=LL_ATOL)
    assert all(np.isfinite(x) and x < 0 for x, _ in got)


def test_loglikelihood_rolling_matches_jax(dense):
    jl, tl = dense
    want = jl.loglikelihood_rolling(ROLLING_REQS)
    got = tl.loglikelihood_rolling(ROLLING_REQS)
    np.testing.assert_allclose(got, want, rtol=ROLLING_RTOL)


def test_greedy_until_matches_jax_over_two_waves(dense):
    """Five requests at batch_size 4: two waves of the engine; the texts of
    JAX's greedy_until and of the port's O(n^2) oracle."""
    jl, tl = dense
    jl.max_gen_toks = tl.max_gen_toks = GEN_TOKS
    want = jl.greedy_until(GEN_REQS)
    got = tl.greedy_until(GEN_REQS)
    assert got == want
    assert got == tl._greedy_until_uncached(GEN_REQS)
    assert len(set(got)) == len(got) and all(len(t) for t in got)


def test_greedy_until_w4a4_matches_jax_and_uncached():
    """Under ActQuantSpec.from_bits(4) the engine applies the q/k/v
    quantizers the scoring forward applies: the texts equal JAX's and the
    port's own full-forward oracle."""
    jl, tl = lm_pair(abits=4)
    jl.max_gen_toks = tl.max_gen_toks = GEN_TOKS
    reqs = GEN_REQS[:3]
    got = tl.greedy_until(reqs)
    assert got == jl.greedy_until(reqs)
    assert got == tl._greedy_until_uncached(reqs)


def test_engine_dtype_and_tp_mesh():
    """The engine takes ``dtype``, else the first floating leaf (f32 here);
    a tp_mesh raises naming the parallel layer's item."""
    nt = jax_opt_numpy()
    params = from_jax_params(nt, device="cpu")
    tl = TorchLM(OPT, params, opt.OPTConfig(**CFG), CharTokenizer(),
                 seqlen=64, batch_size=2, device="cpu")
    assert tl.dtype == torch.float32
    assert tl._get_engine().dtype == torch.float32
    tl16 = TorchLM(OPT, params, opt.OPTConfig(**CFG), CharTokenizer(),
                   seqlen=64, batch_size=2, device="cpu",
                   dtype=torch.bfloat16)
    assert tl16._get_engine().dtype == torch.bfloat16
    assert tl16._get_engine().max_batch == 2
    assert tl16._get_engine().max_len == 64
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TorchLM(OPT, params, opt.OPTConfig(**CFG), CharTokenizer(),
                device="cpu", tp_mesh=object())


WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliett "
         "kilo lima mike november oscar papa quebec romeo sierra tango").split()


def task_docs(seed=0):
    """Injected docs of piqa, lambada_openai, wikitext and gsm8k, in the
    schemas of tests/test_harness.py, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def words(n):
        return " ".join(rng.choice(WORDS, n))

    def piqa(n):
        return [{"goal": words(4), "sol1": words(2), "sol2": words(3),
                 "label": int(rng.integers(2))} for _ in range(n)]

    def gsm(n):
        out = []
        for _ in range(n):
            a = int(rng.integers(100))
            out.append({"question": words(5) + "?",
                        "answer": f"{words(3)}\n#### {a}"})
        return out

    wiki = []
    for t in range(3):
        wiki += [f" = {words(2)} = \n"] + [words(12) + " \n" for _ in range(3)]
    return {
        "piqa": {"train": piqa(6), "validation": piqa(6)},
        "lambada_openai": {"test": [{"text": words(8)} for _ in range(5)]},
        "wikitext": {"test": wiki, "validation": wiki[:4]},
        "gsm8k": {"train": gsm(4), "test": gsm(3)},
    }


def assert_results_match(got, want):
    """Equal tasks, metrics and versions; each value within the scores'
    bounds (accuracies equal)."""
    assert got["versions"] == want["versions"]
    assert got["config"] == want["config"]
    assert sorted(got["results"]) == sorted(want["results"])
    for task, metrics in want["results"].items():
        assert sorted(got["results"][task]) == sorted(metrics), task
        for m, v in metrics.items():
            np.testing.assert_allclose(got["results"][task][m], v,
                                       rtol=ROLLING_RTOL, atol=LL_ATOL,
                                       err_msg=f"{task} {m}")


@pytest.mark.parametrize("num_fewshot", [0, 2])
def test_simple_evaluate_matches_jax(num_fewshot, dense):
    """piqa (multiple choice), lambada_openai (loglikelihood and its greedy
    flag), gsm8k (greedy_until) and, at 0-shot, wikitext (rolling; a
    perplexity task takes no few-shot examples)."""
    jl, tl = dense
    jl.max_gen_toks = tl.max_gen_toks = GEN_TOKS
    tasks = ["piqa", "lambada_openai", "gsm8k"]
    tasks += ["wikitext"] if num_fewshot == 0 else []
    want = j_simple_evaluate(jl, tasks, num_fewshot=num_fewshot,
                             task_data=task_docs())
    got = simple_evaluate(tl, tasks, num_fewshot=num_fewshot,
                          task_data=task_docs())
    assert_results_match(got, want)
