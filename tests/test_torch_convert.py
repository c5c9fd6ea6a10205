"""One exported artifact feeds both packages: the JAX package's packed npz
checkpoint (format v2) read by the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import LLAMA
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.quant import QuantConfig
from omniquant_tpu.serving.export import pack_model
from omniquant_tpu.utils.checkpoint import save_pytree
from omniquant_tpu_torch.quant import PackedWeight
from omniquant_tpu_torch.utils.convert import from_jax_params, load_packed_npz


@pytest.fixture(scope="module")
def jax_packed():
    cfg = jllama.LlamaConfig(vocab_size=64, hidden_size=128,
                             intermediate_size=256, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    params["layers"][0]["q_proj"]["bias"] = jnp.linspace(-1, 1, 128)
    return pack_model(LLAMA, params, QuantConfig(n_bits=3, group_size=128))


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_npz_reader_matches_in_memory_carrier(jax_packed, tmp_path, dtype):
    path = str(tmp_path / "packed.npz")
    save_pytree(path, jax_packed)
    loaded = load_packed_npz(path, device="cpu", dtype=dtype)
    np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                           jax_packed, is_leaf=lambda a: a is None)
    direct = from_jax_params(np_tree, device="cpu", dtype=dtype)
    for lay_l, lay_d, lay_j in zip(loaded["layers"], direct["layers"],
                                   jax_packed["layers"]):
        for name, pj in lay_j.items():
            pl_, pd = lay_l[name], lay_d[name]
            if not hasattr(pj, "qweight"):
                assert torch.equal(pl_["weight"], pd["weight"])
                continue
            assert isinstance(pl_, PackedWeight)
            assert (pl_.bits, pl_.group_size, pl_.tile_k, pl_.layout,
                    pl_.in_features, pl_.out_features) == (
                pj.bits, pj.group_size, pj.tile_k, pj.layout,
                pj.in_features, pj.out_features)
            assert pl_.qweight.dtype == torch.int32
            np.testing.assert_array_equal(pl_.qweight.numpy(),
                                          np.asarray(pj.qweight))
            assert pl_.scales.dtype == dtype
            assert torch.equal(pl_.scales, pd.scales)
            assert (pl_.bias is None) == (pj.bias is None)
    assert loaded["lm_head"].dtype == dtype
    assert torch.equal(loaded["embed_tokens"], direct["embed_tokens"])


def test_bf16_leaves_carry_across():
    """JAX bf16 arrays (numpy's ml_dtypes bfloat16) keep their values."""
    a = jnp.asarray(np.linspace(-3, 3, 48).reshape(6, 8), jnp.bfloat16)
    tree = {"w": np.asarray(a), "n": None, "i": np.arange(3, dtype=np.int32)}
    got = from_jax_params(tree, device="cpu", dtype=torch.bfloat16)
    assert got["n"] is None and got["i"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
