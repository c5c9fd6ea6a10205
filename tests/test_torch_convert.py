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


def test_opt_tree_carries_across():
    """An OPT tree (learned positions, LayerNorm biases, tied lm_head and
    project_in/project_out set to None) keeps its structure and values."""
    from omniquant_tpu.models import opt as jopt
    from omniquant_tpu_torch.models import opt as topt

    cfg = dict(vocab_size=64, hidden_size=32, ffn_dim=64,
               num_hidden_layers=2, num_attention_heads=2,
               max_position_embeddings=16)
    jp = jopt.init_params(jax.random.PRNGKey(3), jopt.OPTConfig(**cfg))
    assert jp["project_in"] is None and jp["lm_head"] is None
    tree = jax.tree.map(lambda a: None if a is None else np.asarray(a), jp,
                        is_leaf=lambda a: a is None)
    got = from_jax_params(tree, device="cpu")
    assert got["project_in"] is None and got["project_out"] is None
    assert got["lm_head"] is None
    assert sorted(got["layers"][1]) == sorted(jp["layers"][1])
    for a, b in zip(_leaves(jp), _leaves(got)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tokens = np.arange(9, dtype=np.int32)[None]
    np.testing.assert_allclose(
        topt.forward(got, torch.from_numpy(tokens).long(),
                     topt.OPTConfig(**cfg)).numpy(),
        np.asarray(jopt.forward(jp, jax.numpy.asarray(tokens),
                                jopt.OPTConfig(**cfg))), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_falcon_tree_carries_across(packed):
    """A Falcon tree (word_embeddings, ln_f, the fused query_key_value; a
    multi-query model without biases and an ALiBi one with them), dense
    or packed W4 g32 by the JAX package, keeps its structure and values,
    words bit for bit; the carried model's forward is JAX's."""
    from omniquant_tpu.models import FALCON
    from omniquant_tpu.models import falcon as jfalcon
    from omniquant_tpu_torch.models import falcon as tfalcon

    for kw in (dict(), dict(multi_query=False, parallel_attn=False,
                            alibi=True, bias=True)):
        cfg = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, **kw)
        jp = jfalcon.init_params(jax.random.PRNGKey(5), jfalcon.FalconConfig(
            **cfg))
        if cfg.get("bias"):
            jp["layers"][1]["dense"]["bias"] = jnp.linspace(-0.1, 0.1, 64)
        if packed:
            jp = pack_model(FALCON, jp, QuantConfig(n_bits=4, group_size=32))
        tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                            jp, is_leaf=lambda a: a is None)
        got = from_jax_params(tree, device="cpu")
        assert got["lm_head"] is None
        assert sorted(got["layers"][0]) == sorted(jp["layers"][0])
        for name in tfalcon.LINEAR_NAMES:
            a, b = jp["layers"][1][name], got["layers"][1][name]
            if packed:
                assert isinstance(b, PackedWeight)
                np.testing.assert_array_equal(b.qweight.numpy(),
                                              np.asarray(a.qweight))
                a, b = {"bias": a.bias}, {"bias": b.bias}
            assert (a["bias"] is None) == (b["bias"] is None) == (
                not cfg.get("bias"))
        dense = {k: v for k, v in jp.items() if k != "layers"}
        dense["norms"] = [{k: v for k, v in layer.items()
                           if k not in tfalcon.LINEAR_NAMES}
                          for layer in jp["layers"]]
        carried = {k: v for k, v in got.items() if k != "layers"}
        carried["norms"] = [{k: v for k, v in layer.items()
                             if k not in tfalcon.LINEAR_NAMES}
                            for layer in got["layers"]]
        if not packed:
            dense["layers"], carried["layers"] = jp["layers"], got["layers"]
        for a, b in zip(_leaves(dense), _leaves(carried)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        tokens = np.arange(9, dtype=np.int32)[None]
        np.testing.assert_allclose(
            tfalcon.forward(got, torch.from_numpy(tokens).long(),
                            tfalcon.FalconConfig(**cfg)).numpy(),
            np.asarray(jfalcon.forward(jp, jnp.asarray(tokens),
                                       jfalcon.FalconConfig(**cfg))),
            rtol=1e-4, atol=1e-5)
