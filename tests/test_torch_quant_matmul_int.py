"""The port's integer-activation path (W4A4 / W6A6) against the JAX
package's on numpy-seeded inputs, on the CPU: ``quantize_act_int`` bit for
bit, K8's plain version exactly, K7's and K9's plain versions (through the
public functions) against the Pallas kernels in interpret mode, the route
each call takes, and the per-element rule the card holds K7 and K9 to.

Tolerance of the products: both sides evaluate the same algebra in f32
(exact int dots, then f32 sums of dot * sc and xsum * off2 over the groups,
times the per-token scale) in orders that differ only inside XLA's and
PyTorch's dots, so rtol 1e-5 plus 1e-6 of the largest output."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import common as jcommon
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import pack_weight as j_pack_weight
from omniquant_tpu_torch.kernels import quant_matmul as tqm
from omniquant_tpu_torch.kernels import tolerance
from omniquant_tpu_torch.models import common as tcommon
from omniquant_tpu_torch.quant import QuantConfig as TQuantConfig
from omniquant_tpu_torch.utils.convert import from_jax_params

jqm = importlib.import_module("omniquant_tpu.kernels.quant_matmul")


def packed_pair(bits, group_size, out_f, in_f, layout, bias=False, seed=0,
                tile_k=None):
    """A JAX PackedWeight and the same carried into the port."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32) * 0.5
    b = rng.standard_normal(out_f).astype(np.float32) if bias else None
    jw = j_pack_weight(jnp.asarray(w), JQuantConfig(n_bits=bits,
                                                    group_size=group_size),
                       bias=None if b is None else jnp.asarray(b),
                       layout=layout, tile_k=tile_k)
    return jw, from_jax_params(jw, device="cpu")


def acts(abits):
    return (JQuantConfig(n_bits=abits, symmetric=False),
            TQuantConfig(n_bits=abits, symmetric=False))


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("abits", [4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_int_bit_exact(abits, dtype):
    """Codes and scales equal JAX's bit for bit, computed in x's dtype:
    random rows, a row of equal values (zero range: the CLIPMIN scale, a
    zero point clamped at -1e4, so the code saturates at 127 as XLA's int8
    conversion does) and rows whose x / scale lands exactly on halves
    (round half to even)."""
    q = 2 ** abits - 1
    x = np.random.default_rng(abits).standard_normal((5, 96)) * 3
    x[1] = 0.75
    x[2] = np.arange(96) % (q + 1)           # range [0, q]: scale 1
    x[2, 10:20] = np.arange(10) + 0.5        # exact ties
    x[3] = -x[2]
    jcfg, tcfg = acts(abits)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jc, js = jqm.quantize_act_int(jx, jcfg)
    tc, ts = tqm.quantize_act_int(tx, tcfg)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.abs(np.delete(tc.numpy(), 1, axis=0)).max() <= q
    assert (tc.numpy()[1] == 127).all()


@pytest.mark.parametrize("bits,layout", [
    (2, "planar"), (3, "planar"), (4, "planar"), (6, "planar"),
    (8, "planar"), (2, "pairs"), (3, "pairs"), (4, "pairs")])
def test_unpack_to_int8_exact(bits, layout):
    """K8's plain version equals the JAX kernel for every layout and width,
    with in_features padded up to the pack tile."""
    gs = 128 if bits != 8 else None
    jw, tw = packed_pair(bits, gs, 256, 640, layout, seed=bits)
    want = jqm._unpack_to_int8(jw.qweight, jnp.zeros((1, 1), jnp.int32),
                               bits, jw.tile_k, layout, True)
    got = tqm._unpack_to_int8(tw)
    assert got.dtype == torch.int8 and got.shape == (tw.k_pad, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tqm._unpack_to_int8.launches == 0  # no kernel on a CPU tensor


@pytest.mark.parametrize("bits,group_size,abits", [
    (2, 128, 4), (3, 64, 4), (4, 32, 4), (6, 128, 6), (6, None, 6),
    (8, None, 4), (4, 64, 6), (3, 128, 6)])
def test_fused_int_matches_jax(bits, group_size, abits):
    """Small m, planar: K7's plain version through ``quant_matmul_int``
    against the JAX kernel; 3-D input, K 640 packed to a padded k_pad."""
    jw, tw = packed_pair(bits, group_size, 256, 640, "planar",
                         seed=10 * bits + abits)
    assert tw.k_pad > 640
    x = np.random.default_rng(abits).standard_normal((2, 5, 640)).astype(
        np.float32)
    jcfg, tcfg = acts(abits)
    assert tqm.int_route(10, tw, tcfg) == "fused"
    want = np.asarray(jqm.quant_matmul_int(jnp.asarray(x), jw, jcfg,
                                           interpret=True))
    got = tqm.quant_matmul_int(torch.from_numpy(x), tw, tcfg)
    assert got.shape == (2, 5, 256)
    assert_close(got.numpy(), want)
    assert tqm.quant_matmul_int.launches == 0


def test_fused_int_bias_through_linear():
    """models.common.linear takes the integer path for a PackedWeight with
    an enabled act quantizer (it raised before the path was ported), and
    adds the bias after the product in x's dtype, as JAX does."""
    jw, tw = packed_pair(6, 64, 128, 256, "planar", bias=True, seed=3)
    x = np.random.default_rng(4).standard_normal((3, 256)).astype(np.float32)
    spec_j = jcommon.ActQuantSpec.from_bits(6)
    spec_t = tcommon.ActQuantSpec.from_bits(6)
    want = np.asarray(jcommon.linear(jnp.asarray(x), jw, spec_j.act))
    got = tcommon.linear(torch.from_numpy(x), tw, spec_t.act)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("bits,group_size,layout,tile_k", [
    (4, 32, "planar", 32), (4, 32, "pairs", None), (3, 32, "pairs", None),
    (6, 32, "planar", 32), (4, None, "planar", 32), (4, 128, "pairs", None),
    (6, 128, "planar", None)])
def test_dense_int_matches_jax(bits, group_size, layout, tile_k):
    """K8 + K9's plain versions through ``_quant_matmul_int_dense`` against
    the JAX route called directly, as its own test calls it: both layouts,
    grouped and per channel, K padded up to the pack tile."""
    in_f = 160 if group_size != 128 else 640
    jw, tw = packed_pair(bits, group_size, 128, in_f, layout, seed=50 + bits,
                         tile_k=tile_k)
    x = np.random.default_rng(7).standard_normal((40, in_f)).astype(
        np.float32)
    jcfg, tcfg = acts(4)
    want = np.asarray(jqm._quant_matmul_int_dense(jnp.asarray(x), jw, jcfg,
                                                  True))
    got = tqm._quant_matmul_int_dense(torch.from_numpy(x), tw, tcfg)
    assert_close(got.numpy(), want)
    assert tqm._quant_matmul_int_dense.launches == 0


def _jax_route(monkeypatch, x, jw, jcfg):
    seen = []

    def spy(name):
        def f(*a, **k):
            seen.append(name)
            return jnp.zeros(x.shape[:-1] + (jw.qweight.shape[1],))
        return f

    monkeypatch.setattr(jqm, "_quant_matmul_int_dense", spy("dense"))
    monkeypatch.setattr(jqm, "_qmm_int_call", spy("fused"))
    monkeypatch.setattr(jqm, "quant_matmul", spy("fake_quant"))
    jqm.quant_matmul_int(x, jw, jcfg, interpret=True)
    monkeypatch.undo()
    return seen


def _port_route(monkeypatch, x, tw, tcfg):
    seen = []

    def spy(name):
        def f(*a, **k):
            seen.append(name)
            return torch.zeros(x.shape[:-1] + (tw.qweight.shape[1],))
        return f

    monkeypatch.setattr(tqm, "_quant_matmul_int_dense", spy("dense"))
    monkeypatch.setattr(tqm, "quant_matmul_int_plain", spy("fused"))
    monkeypatch.setattr(tqm, "quant_matmul", spy("fake_quant"))
    tqm.quant_matmul_int(x, tw, tcfg)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("act", ["a4", "a6", "a8", "a4_grouped", "a16",
                                 "fix0to1"])
@pytest.mark.parametrize("layout,out_f", [("planar", 128), ("pairs", 128),
                                          ("planar", 192)])
def test_routes_match_jax(monkeypatch, act, layout, out_f):
    """For m on both sides of the dense threshold (1, 2047, 2048), the
    route of every call equals JAX's, fallbacks included: 8-bit and grouped
    activation quantizers, N % 128 != 0 and pairs weights at small m take
    fake-quant + K1."""
    kw = {"a4": dict(n_bits=4), "a6": dict(n_bits=6), "a8": dict(n_bits=8),
          "a4_grouped": dict(n_bits=4, group_size=32),
          "a16": dict(n_bits=16), "fix0to1": dict(n_bits=4,
                                                  metric="fix0to1")}[act]
    jcfg = JQuantConfig(symmetric=False, **kw)
    tcfg = TQuantConfig(symmetric=False, **kw)
    jw, tw = packed_pair(4, 32, out_f, 64, layout, seed=1)
    for m in (1, 2047, 2048):
        x = np.zeros((m, 64), np.float32)
        want = _jax_route(monkeypatch, jnp.asarray(x), jw, jcfg)
        got = _port_route(monkeypatch, torch.from_numpy(x), tw, tcfg)
        assert got == want == [tqm.int_route(m, tw, tcfg)], (m, got, want)


def _emulate_int_kernel(xc, xs, w8, pw, splits, fault=None):
    """K7's arithmetic in PyTorch: per split-K slice of the pack tiles, per
    group: exact int dot (f32 here: integers below 2^24), accf += dot * sc
    + xsum * off2 with off2 rounded through bf16 as the kernel forms it;
    the slices added in order, times xs, rounded to bf16. ``fault`` plants a
    bug: "lost_group" skips the third group, "no_off2" leaves the offset
    term out, "xs_twice" applies the per-token scale twice."""
    k_pad = w8.shape[0]
    xc = torch.nn.functional.pad(xc, (0, k_pad - xc.shape[1])).float()
    gs = pw.group_size or pw.tile_k
    n_tiles = k_pad // pw.tile_k
    sc = pw.scales.float().t()
    z = pw.zeros.float().t()
    half = 2.0 ** (pw.bits - 1)
    off2 = ((half - z).bfloat16().float() * sc).bfloat16().float()
    total = torch.zeros(xc.shape[0], w8.shape[1])
    for s in range(splits):
        accf = torch.zeros_like(total)
        for t in range(s * n_tiles // splits, (s + 1) * n_tiles // splits):
            for g in range(t * pw.tile_k // gs, (t + 1) * pw.tile_k // gs):
                if fault == "lost_group" and g == 2:
                    continue
                rows = slice(g * gs, (g + 1) * gs)
                gi = min(g, sc.shape[0] - 1)
                dot = xc[:, rows] @ w8[rows].float()
                term = dot * sc[gi]
                if fault != "no_off2":
                    term = term + xc[:, rows].sum(-1, keepdim=True) * off2[gi]
                accf = accf + term
        total = total + accf
    scale = xs * xs if fault == "xs_twice" else xs
    return (total * scale).bfloat16()


@pytest.mark.parametrize("fault", [None, "lost_group", "no_off2",
                                   "xs_twice"])
def test_card_tolerance_admits_rounding_and_rejects_faults(fault):
    """The rule the card holds K7 and K9 to (2 bf16 ulps of each element
    plus 2^-14 of xs * sum_g (|dot_g| sc_g + |xsum_g off2_g|)) admits the
    kernels' arithmetic (3 split-K slices, bf16 scales and zeros) and
    rejects a lost group, a missing offset term and xs applied twice, on a
    W6A6 projection with K = 1536 (12 groups)."""
    _, tw = packed_pair(6, 128, 256, 1536, "planar", seed=9)
    tw = tw.map_tensors(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (8, 1536)).astype(np.float32)).to(torch.bfloat16)
    xc, xs = tqm.quantize_act_int(x, TQuantConfig(n_bits=6))
    want, mag = tqm.quant_matmul_int_plain(xc, xs, tw, magnitude=True)
    w8 = tqm.unpack_to_int8_plain(tw)
    got = _emulate_int_kernel(xc, xs, w8, tw, splits=3, fault=fault)
    ok, _, worst = tolerance.bf16_close(
        got, want, tolerance.INT_MATMUL_SLACK * mag)
    assert ok == (fault is None), worst
