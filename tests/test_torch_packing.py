"""The port's packing and quantizer against the JAX package's: the packed
int32 words must be bit-identical, for every layout and width."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.quant import packing as jpk
from omniquant_tpu.quant import quantizer as jq
from omniquant_tpu_torch.quant import packing as tpk
from omniquant_tpu_torch.quant import quantizer as tq

LAYOUT_BITS = [("pairs", 2), ("pairs", 3), ("pairs", 4), ("planar", 2),
               ("planar", 3), ("planar", 4), ("planar", 6), ("planar", 8)]


@pytest.mark.parametrize("in_f", [200, 1280])
@pytest.mark.parametrize("group_size", [None, 64, 128])
@pytest.mark.parametrize("layout,bits", LAYOUT_BITS)
def test_pack_codes_bit_identical(layout, bits, group_size, in_f):
    """Words equal the JAX package's (in_f 200 is no tile multiple), and
    the port unpacks them back to the codes."""
    rng = np.random.default_rng(bits * 1000 + (group_size or 0) + in_f)
    codes = rng.integers(0, 2**bits, size=(48, in_f)).astype(np.int32)
    tile = tpk.pack_tile(bits, group_size, in_f, layout)
    assert tile == jpk.pack_tile(bits, group_size, in_f, layout)
    want = np.asarray(jpk.pack_codes(jnp.asarray(codes), bits, group_size,
                                     tile, layout))
    got = tpk.pack_codes(torch.from_numpy(codes), bits, group_size, tile,
                         layout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpk.unpack_codes(torch.from_numpy(want.copy()), bits, in_f,
                            group_size, tile, layout)
    np.testing.assert_array_equal(back.numpy(), codes.T)


@pytest.mark.parametrize("bits,group_size,layout,symmetric,in_f", [
    (4, 128, "auto", False, 512), (3, 128, "auto", False, 640),
    (2, None, "auto", False, 384), (4, 64, "auto", False, 256),
    (6, 128, "planar", False, 256), (8, None, "planar", False, 256),
    (4, 128, "pairs", True, 200),  # symmetric deficiency padding
])
def test_pack_weight_matches_jax(bits, group_size, layout, symmetric, in_f):
    rng = np.random.default_rng(bits + in_f)
    w = (rng.standard_normal((96, in_f)) * 0.02).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    jcfg = jq.QuantConfig(n_bits=bits, group_size=group_size,
                          symmetric=symmetric)
    tcfg = tq.QuantConfig(n_bits=bits, group_size=group_size,
                          symmetric=symmetric)
    jw = jpk.pack_weight(jnp.asarray(w), jcfg, bias=jnp.asarray(b),
                         layout=layout)
    tw = tpk.pack_weight(torch.from_numpy(w), tcfg, bias=torch.from_numpy(b),
                         layout=layout)
    assert (tw.layout, tw.tile_k, tw.in_features, tw.k_pad) == (
        jw.layout, jw.tile_k, jw.in_features, jw.k_pad)
    np.testing.assert_array_equal(tw.qweight.numpy(), np.asarray(jw.qweight))
    np.testing.assert_array_equal(tw.zeros.numpy(), np.asarray(jw.zeros))
    np.testing.assert_allclose(tw.scales.numpy(), np.asarray(jw.scales),
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(tpk.dequantize_packed(tw).numpy(),
                               np.asarray(jpk.dequantize_packed(jw)),
                               rtol=1e-6, atol=1e-7)


def test_pack_weight_against_recorded_grid():
    """Codes derived against a calibration-recorded (scale, zero) grid."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((64, 256)) * 0.02).astype(np.float32)
    jcfg = jq.QuantConfig(n_bits=4, group_size=128)
    tcfg = tq.QuantConfig(n_bits=4, group_size=128)
    scale, rzp = jq.weight_scale_zp(jnp.asarray(w), jcfg)
    scale, rzp = np.array(scale) * 1.1, np.array(rzp)
    jw = jpk.pack_weight(jnp.asarray(w), jcfg, scale=jnp.asarray(scale),
                         rzp=jnp.asarray(rzp), layout="pairs")
    tw = tpk.pack_weight(torch.from_numpy(w), tcfg,
                         scale=torch.from_numpy(scale),
                         rzp=torch.from_numpy(rzp), layout="pairs")
    np.testing.assert_array_equal(tw.qweight.numpy(), np.asarray(jw.qweight))


@pytest.mark.parametrize("bits,group_size", [(4, 128), (2, None), (6, 64)])
def test_default_layout_and_tile(bits, group_size):
    assert tpk.default_layout(bits, group_size) == jpk.default_layout(
        bits, group_size)
    for in_f in (128, 256, 4096, 11008):
        for layout in ("planar", "pairs"):
            if layout == "pairs" and bits not in (2, 3, 4):
                continue
            assert tpk.pack_tile(bits, group_size, in_f, layout) == \
                jpk.pack_tile(bits, group_size, in_f, layout)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("group_size", [None, 32])
def test_quantizer_matches_jax(symmetric, group_size):
    """weight_scale_zp, quantize/dequantize_weight_int and fake_quant_act
    (including the asymmetric path's missing scale clamp)."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((16, 96)) * 0.05).astype(np.float32)
    w[0, :32] = 0.0  # an all-zero group: the exact-zero scale guard
    jcfg = jq.QuantConfig(n_bits=4, group_size=group_size,
                          symmetric=symmetric)
    tcfg = tq.QuantConfig(n_bits=4, group_size=group_size,
                          symmetric=symmetric)
    js, jz = jq.weight_scale_zp(jnp.asarray(w), jcfg)
    ts, tz = tq.weight_scale_zp(torch.from_numpy(w), tcfg)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jc, _, _ = jq.quantize_weight_int(jnp.asarray(w), jcfg)
    tc, ts, tz = tq.quantize_weight_int(torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    deq = tq.dequantize_weight_int(tc, ts, tz, tcfg, 96)
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jq.fake_quant_weight(jnp.asarray(w), jcfg)),
        rtol=1e-6, atol=1e-7)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    np.testing.assert_allclose(
        tq.fake_quant_act(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jq.fake_quant_act(jnp.asarray(x), jcfg)),
        rtol=1e-6, atol=1e-7)


def test_quant_config_geometry():
    for gs, shape in [(None, (8, 100)), (32, (8, 100)), (128, (4, 4096))]:
        j = jq.QuantConfig(n_bits=4, group_size=gs, symmetric=True)
        t = tq.QuantConfig(n_bits=4, group_size=gs, symmetric=True)
        assert (t.qmin, t.qmax, t.num_groups(shape), t.deficiency(shape[1])) \
            == (j.qmin, j.qmax, j.num_groups(shape), j.deficiency(shape[1]))
