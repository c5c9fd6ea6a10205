"""The port's packed matmul (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, in f32.

Tolerance: rtol 1e-4 plus an absolute 1e-5 of the output's largest
magnitude. The two sum in different orders, and the JAX pairs path folds
the zero point into a rank-1 term whose f32 cancellation leaves an error
proportional to the output scale rather than to each element."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import pack_weight as j_pack_weight
from omniquant_tpu_torch.kernels import quant_matmul as tqm
from omniquant_tpu_torch.utils.convert import from_jax_params

# the JAX package's kernels/__init__ re-exports the function under the
# module's name
jqm = importlib.import_module("omniquant_tpu.kernels.quant_matmul")


def packed_pair(bits, group_size, out_f, in_f, layout, bias=False, seed=0):
    """A JAX PackedWeight and the same carried into the port."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32)
    b = rng.standard_normal(out_f).astype(np.float32) if bias else None
    jw = j_pack_weight(jnp.asarray(w), JQuantConfig(n_bits=bits,
                                                    group_size=group_size),
                       bias=None if b is None else jnp.asarray(b),
                       layout=layout)
    return jw, from_jax_params(jw, device="cpu")


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("bits,group_size,layout", [
    (4, 128, "pairs"), (3, 128, "pairs"), (2, None, "pairs"),
    (4, 64, "planar"), (6, 128, "planar"), (8, None, "planar"),
])
def test_matches_jax_kernel(bits, group_size, layout, m):
    jw, tw = packed_pair(bits, group_size, 256, 640, layout, seed=bits)
    x = np.random.default_rng(m).standard_normal((m, 640)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert_close(got.numpy(), want)


def test_k_padding_bias_and_3d_input():
    """in_features 640 packs to k_pad 1024 (x is zero-padded, the groups
    past in_features reuse the last scale); bias added in x.dtype."""
    jw, tw = packed_pair(4, 128, 384, 640, "pairs", bias=True, seed=5)
    assert tw.k_pad == 1024 and tw.scales.shape == (384, 5)
    x = np.random.default_rng(6).standard_normal((2, 3, 640)).astype(
        np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 384)
    assert_close(got.numpy(), want)


def test_odd_n_routes_to_reference():
    """N % 128 != 0 goes to the dense reference in both packages."""
    jw, tw = packed_pair(4, 128, 200, 256, "pairs", seed=9)
    x = np.random.default_rng(10).standard_normal((5, 256)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul_reference(jnp.asarray(x), jw))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert_close(got.numpy(), want)
    np.testing.assert_allclose(
        tqm.quant_matmul_reference(torch.from_numpy(x), tw).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_large_m_dequant_once_route():
    """m >= 4096 with a column block below 1024 dequantizes once and calls
    a dense matmul, as the JAX package hands that case to XLA."""
    jw, tw = packed_pair(4, 128, 384, 512, "pairs", seed=41)
    x = np.random.default_rng(42).standard_normal((4096, 512)).astype(
        np.float32)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=False))
    got = tqm.quant_matmul(torch.from_numpy(x), tw)
    assert_close(got.numpy(), want)
    assert tqm.quant_matmul.launches == 0  # no kernel on a CPU tensor


def test_bf16_input_close_to_f32_reference():
    """bf16 activations (the serving dtype) stay within bf16 rounding of
    the f32 product."""
    jw, tw = packed_pair(4, 128, 256, 512, "pairs", seed=3)
    x = np.random.default_rng(4).standard_normal((8, 512)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tqm.quant_matmul(xb, tw).float().numpy()
    want = np.asarray(jqm.quant_matmul(jnp.asarray(xb.float().numpy()), jw,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(
        want).max())
