"""The port's model code (models/common.py, models/llama.py) against the
JAX package's, in f32 on numpy-seeded inputs (rtol 1e-4: the matmuls sum in
different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import common as jcommon
from omniquant_tpu.models import llama as jllama
from omniquant_tpu_torch.models import common as tcommon
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.models.registry import get_family

from test_torch_engine import CFG, numpy_llama


def _tree(dense, fn):
    return jax.tree.map(lambda a: None if a is None else fn(a), dense,
                        is_leaf=lambda a: a is None)


def test_forward_matches_jax():
    """Eval-path forward on dense weights: GQA, RoPE, RMSNorm, causal mask,
    untied lm_head."""
    dense = numpy_llama(seed=1)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 11)).astype(
        np.int32)
    want = jllama.forward(_tree(dense, jnp.asarray), jnp.asarray(tokens),
                          jllama.LlamaConfig(**CFG))
    got = tllama.forward(_tree(dense, torch.from_numpy),
                         torch.from_numpy(tokens).long(),
                         tllama.LlamaConfig(**CFG))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert get_family("Llama-2-7b").init_params is tllama.init_params


@pytest.mark.parametrize("abits", [16, 4, 8])
def test_quantizer_sites_match_jax(abits):
    """linear with an act quantizer and attention_core with the q/k/v/p
    quantizers, on identical inputs (a whole forward at 4 bits would let
    1e-7 matmul differences flip activation rounding steps upstream)."""
    rng = np.random.default_rng(abits)
    spec_j = jcommon.ActQuantSpec.from_bits(abits)
    spec_t = tcommon.ActQuantSpec.from_bits(abits)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32) * 0.1
    b = rng.standard_normal(48).astype(np.float32)
    want = jcommon.linear(jnp.asarray(x), {"weight": jnp.asarray(w),
                                           "bias": jnp.asarray(b)}, spec_j.act)
    got = tcommon.linear(torch.from_numpy(x), {"weight": torch.from_numpy(w),
                                               "bias": torch.from_numpy(b)},
                         spec_t.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    q, k, v = (rng.standard_normal((2, 4, 7, 32)).astype(np.float32)
               for _ in range(3))
    for scale_first in (False, True):
        want = jcommon.attention_core(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jcommon.causal_mask(7, 7), 32 ** -0.5, spec_j, scale_first)
        got = tcommon.attention_core(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tcommon.causal_mask(7, 7), 32 ** -0.5, spec_t, scale_first)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_rope_norm_and_masks_match_jax():
    rng = np.random.default_rng(0)
    pos = np.asarray([[0, 3, 17, 200]], np.int32)
    for dtype in ("float32", "bfloat16"):
        jc, js = jllama.rope_cos_sin(jnp.asarray(pos), 64, 10000.0,
                                     getattr(jnp, dtype))
        tc, ts = tllama.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0,
                                     getattr(torch, dtype))
        np.testing.assert_allclose(tc.float().numpy(),
                                   np.asarray(jc.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.float().numpy(),
                                   np.asarray(js.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6)
    x = rng.standard_normal((3, 40)).astype(np.float32) * 5
    wn = rng.standard_normal(40).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), {"weight": torch.from_numpy(wn)},
                         1e-6).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), {"weight": jnp.asarray(wn)},
                                    1e-6)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcommon.causal_mask(3, 5).numpy(),
                                  np.asarray(jcommon.causal_mask(3, 5)))
    kv = rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tcommon.repeat_kv(torch.from_numpy(kv), 3).numpy(),
        np.asarray(jcommon.repeat_kv(jnp.asarray(kv), 3)))
