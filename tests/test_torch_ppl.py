"""The port's strided perplexity (eval/ppl.py::evaluate_ppl) against the
JAX package's, in f32 on the CPU.

Tiny LLaMA and OPT models (hidden 64, 2 layers) made with numpy from a
seed; a test stream of 6 windows of 32 tokens and a ragged tail. Each case
runs both packages on the same weights: dense, dense with W4A4 quantizers,
packed W4 g32 (the port's wrappers take their plain versions on the CPU,
JAX its Pallas kernels in interpret mode where N % 128 == 0), packed with
W4A4, and with ``limit`` (the loop stops after that window, the divisor
stays the full window count). Perplexities agree to PPL_RTOL (largest gap
measured when it was set: 9.1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.eval import evaluate_ppl as j_evaluate_ppl
from omniquant_tpu.models import LLAMA as J_LLAMA
from omniquant_tpu.models import OPT as J_OPT
from omniquant_tpu.models import common as jcommon
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.models import opt as jopt
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.eval import evaluate_ppl
from omniquant_tpu_torch.models import LLAMA as T_LLAMA
from omniquant_tpu_torch.models import OPT as T_OPT
from omniquant_tpu_torch.models import common as tcommon
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.models import opt as topt
from omniquant_tpu_torch.utils import from_jax_params

import test_torch_calib_engine as llama_case
import test_torch_opt as opt_case

SEQLEN = 32
PPL_RTOL = 1e-5
FAMILIES = {
    "llama": (J_LLAMA, T_LLAMA, jllama.LlamaConfig(**llama_case.CFG),
              tllama.LlamaConfig(**llama_case.CFG), llama_case.numpy_llama),
    "opt": (J_OPT, T_OPT, jopt.OPTConfig(**opt_case.CFG),
            topt.OPTConfig(**opt_case.CFG), opt_case.numpy_opt),
}


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


def _numpy(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jfam, tfam, jcfg, tcfg, make = FAMILIES[request.param]
    dense = make(seed=11)
    packed = j_pack_model(jfam, _jax(dense), JQuantConfig(n_bits=4,
                                                         group_size=32))
    tokens = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (1, 6 * SEQLEN + 5)).astype(np.int32)
    return dict(j=(jfam, jcfg), t=(tfam, tcfg), tokens=tokens,
                params={"dense": dense, "packed": _numpy(packed)})


@pytest.mark.parametrize("weights,abits,limit", [
    ("dense", 16, None), ("dense", 4, None), ("packed", 16, None),
    ("packed", 4, None), ("dense", 16, 2)])
def test_ppl_matches_jax(family, weights, abits, limit):
    jfam, jcfg = family["j"]
    tfam, tcfg = family["t"]
    params = family["params"][weights]
    want = j_evaluate_ppl(jfam, _jax(params), jcfg, family["tokens"],
                          seqlen=SEQLEN,
                          spec=jcommon.ActQuantSpec.from_bits(abits),
                          limit=limit)
    got = evaluate_ppl(tfam, from_jax_params(params, device="cpu"), tcfg,
                       family["tokens"], seqlen=SEQLEN,
                       spec=tcommon.ActQuantSpec.from_bits(abits),
                       limit=limit)
    assert isinstance(got, float) and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_limit_keeps_the_full_divisor(family):
    """With limit=k the first k+1 windows are summed and divided by all 6
    windows' tokens: exp(sum_{i<=k} nll_i / (6 * seqlen))."""
    tfam, tcfg = family["t"]
    params = from_jax_params(family["params"]["dense"], device="cpu")
    toks = family["tokens"][0]
    per_window = [np.log(evaluate_ppl(tfam, params, tcfg,
                                      toks[i * SEQLEN: (i + 1) * SEQLEN],
                                      seqlen=SEQLEN)) for i in range(3)]
    got = evaluate_ppl(tfam, params, tcfg, family["tokens"], seqlen=SEQLEN,
                       limit=2)
    np.testing.assert_allclose(np.log(got), sum(per_window) / 6, rtol=1e-5)
