"""The port's AutoGPTQ exporter (``omniquant_tpu_torch/serving/
export_autogptq.py``) against the JAX package's, case for case with JAX's
tests/test_export_autogptq.py: the bit packing, a linear's tensors for both
wire layouts, a zero point of 0, a whole model's state dict saved and
loaded by torch, and the upstream zeros - 1 convention. The port packs its
own weights (the same numpy weights JAX packs), and its tensors equal
JAX's bit for bit; AutoGPTQ's dequantization of them equals the port's
``dequantize_packed`` at the f16 scales' precision (2e-3, as JAX's test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import LLAMA as JLLAMA
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import pack_weight as j_pack_weight
from omniquant_tpu.serving import export_autogptq as jexp
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.models import LLAMA
from omniquant_tpu_torch.quant import (QuantConfig, dequantize_packed,
                                       pack_weight)
from omniquant_tpu_torch.serving import export_autogptq as texp
from omniquant_tpu_torch.serving import pack_model
from omniquant_tpu_torch.utils import from_jax_params

DEQ_TOL = 2e-3  # f16 scales on the wire, as JAX's test


def _both(w, bits, gs, layout="planar", b=None):
    jpw = j_pack_weight(jnp.asarray(w), JQuantConfig(n_bits=bits,
                                                     group_size=gs),
                        bias=None if b is None else jnp.asarray(b),
                        layout=layout)
    tpw = pack_weight(torch.from_numpy(w), QuantConfig(n_bits=bits,
                                                       group_size=gs),
                      bias=None if b is None else torch.from_numpy(b),
                      layout=layout)
    return jpw, tpw


def _equal_tensors(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g = np.ascontiguousarray(got[k])
        w = np.ascontiguousarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=k)


def _linear_roundtrip(bits, gs, layout):
    rng = np.random.default_rng(17 + bits)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jpw, tpw = _both(w, bits, gs, layout, b)
    got = texp.pack_autogptq_linear(tpw)
    _equal_tensors(got, jexp.pack_autogptq_linear(jpw))
    deq = texp.unpack_autogptq(got, bits)  # (in, out) f32
    ours = dequantize_packed(tpw, dtype=torch.float32)[:96].numpy()
    np.testing.assert_allclose(deq, ours, rtol=DEQ_TOL, atol=DEQ_TOL)
    np.testing.assert_allclose(got["bias"].astype(np.float32), b,
                               rtol=DEQ_TOL, atol=DEQ_TOL)


def _zero_point_zero(_):
    rng = np.random.default_rng(3)
    w = np.abs(rng.standard_normal((32, 64)).astype(np.float32))
    w[:, ::8] = 0.0  # a group minimum of 0 forces zero point 0
    jpw, tpw = _both(w, 4, 32)
    assert float(tpw.zeros.min()) == 0.0
    got = texp.pack_autogptq_linear(tpw)
    _equal_tensors(got, jexp.pack_autogptq_linear(jpw))
    deq = texp.unpack_autogptq(got, 4)
    ours = dequantize_packed(tpw, dtype=torch.float32)[:64].numpy()
    np.testing.assert_allclose(deq, ours, rtol=DEQ_TOL, atol=DEQ_TOL)


def _model_export(tmp_path):
    """Whole-model export under HF llama module names, loadable by torch;
    JAX's and the port's files hold the same tensors bit for bit, and
    every linear's AutoGPTQ dequant matches the packed model."""
    cfg = jllama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64)
    jparams = jllama.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        jparams, is_leaf=lambda a: a is None)
    wcfg = QuantConfig(n_bits=4, group_size=32)
    jpacked = j_pack_model(JLLAMA, jparams, JQuantConfig(n_bits=4,
                                                         group_size=32),
                           tile_k=32)
    packed = pack_model(LLAMA, from_jax_params(tree, device="cpu"), wcfg,
                        tile_k=32, device="cpu")
    jexp.save_autogptq_checkpoint("llama", jpacked,
                                  str(tmp_path / "jax.pt"))
    texp.save_autogptq_checkpoint("llama", packed, str(tmp_path / "port.pt"))
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=True)
    sd = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k]), k
    assert "model.layers.0.self_attn.q_proj.qweight" in sd
    assert "model.layers.1.mlp.down_proj.scales" in sd
    assert "model.embed_tokens.weight" in sd and "model.norm.weight" in sd
    prefix = "model.layers.0.self_attn.q_proj."
    qt = {k[len(prefix):]: v.numpy() for k, v in sd.items()
          if k.startswith(prefix)}
    deq = texp.unpack_autogptq(qt, 4)
    ours = dequantize_packed(packed["layers"][0]["q_proj"],
                             dtype=torch.float32)[:64].numpy()
    np.testing.assert_allclose(deq, ours, rtol=DEQ_TOL, atol=DEQ_TOL)


def _upstream_offset(_):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((32, 64)).astype(np.float32)
    jpw, tpw = _both(w, 4, 32)
    assert float(tpw.zeros.min()) > 0.0
    got = texp.pack_autogptq_linear(tpw, zeros_offset=-1)
    _equal_tensors(got, jexp.pack_autogptq_linear(jpw, zeros_offset=-1))
    deq = texp.unpack_autogptq(got, 4, zeros_offset=-1)
    ours = dequantize_packed(tpw, dtype=torch.float32)[:64].numpy()
    np.testing.assert_allclose(deq, ours, rtol=DEQ_TOL, atol=DEQ_TOL)


def _bitpack(bits):
    """3-bit values straddle int32 words in the AutoGPTQ layout; pack ->
    unpack is exact for every width, and the words are JAX's."""
    rng = np.random.default_rng(bits)
    n = 96
    vals = rng.integers(0, 2**bits, size=(n, 8)).astype(np.uint32)
    words = texp._pack_bits(vals, bits)
    assert words.dtype == np.int32 and words.shape == (n * bits // 32, 8)
    np.testing.assert_array_equal(words, jexp._pack_bits(vals, bits))
    np.testing.assert_array_equal(texp._unpack_bits(words, bits, n), vals)


_LINEARS = [(bits, gs, layout) for layout in ("planar", "pairs")
            for bits, gs in ((2, 32), (3, 32), (4, 32), (4, None), (3, None))]


@pytest.mark.parametrize("case,arg", [
    *[("bitpack_roundtrip_including_straddle", b) for b in (2, 3, 4, 8)],
    *[("linear_roundtrip", a) for a in _LINEARS],
    ("zero_point_zero_survives_default_convention", None),
    ("model_export_and_torch_load", None),
    ("upstream_offset_convention", None)])
def test_autogptq_matches_jax(case, arg, tmp_path):
    if case == "bitpack_roundtrip_including_straddle":
        _bitpack(arg)
    elif case == "linear_roundtrip":
        _linear_roundtrip(*arg)
    elif case == "zero_point_zero_survives_default_convention":
        _zero_point_zero(arg)
    elif case == "model_export_and_torch_load":
        _model_export(tmp_path)
    else:
        _upstream_offset(arg)


def test_export_reads_packs_on_any_device_and_dtype():
    """The adapter reads bf16 scales and zeros (a bf16 engine's pack) as
    f32: the tensors equal those of the f32 pack rounded the same way."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    _, tpw = _both(w, 4, 64)
    bf = tpw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    got = texp.pack_autogptq_linear(bf)
    want = texp.pack_autogptq_linear(tpw.map_tensors(
        lambda t: t.to(torch.bfloat16).float()
        if t.is_floating_point() else t))
    _equal_tensors(got, want)
