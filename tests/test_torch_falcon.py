"""The port's Falcon family (models/falcon.py, the FALCON registry entry,
LWC-only calibration, pack_model and the JAX-tree carrier on a Falcon tree)
against the JAX package's, in f32 on the CPU on numpy-seeded inputs.

Tiny Falcons (vocab 128, hidden 64, 2 layers, 4 heads of 16) in the four
forms the family takes: multi-query with parallel attention and rotary
positions (Falcon-7B's), classic multi-head with a post-attention LayerNorm
(Falcon-RW's), the new decoder architecture with 2 kv heads and dual
LayerNorms (Falcon-40B's), and the classic form with ALiBi and biases
(Falcon-RW-1B's). Forwards and blocks agree within 1e-5 (f32 sums in other
orders), head splits and ALiBi slopes exactly, packed words bit for bit.
LET is refused. Calibration is LWC only: JAX's omni_parameters.npz resumed
with epochs=0 folds to JAX's weights and packs to its words; a fresh run of
both packages (W4A16 g16 LWC, 1 epoch of 4 windows of 32) is held at the
tolerances in FRESH_TOL (measured, then a margin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.calib import CalibConfig as JCalibConfig
from omniquant_tpu.calib import calibrate as j_calibrate
from omniquant_tpu.calib import collect_act_stats as j_collect_act_stats
from omniquant_tpu.calib.data import get_synthetic as j_get_synthetic
from omniquant_tpu.models import FALCON as J_FALCON
from omniquant_tpu.models import falcon as jfalcon
from omniquant_tpu.models.common import ActQuantSpec as JSpec
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.calib import CalibConfig, calibrate, collect_act_stats
from omniquant_tpu_torch.models import FALCON as T_FALCON
from omniquant_tpu_torch.models import falcon as tfalcon
from omniquant_tpu_torch.models import get_family
from omniquant_tpu_torch.models.common import ActQuantSpec as TSpec
from omniquant_tpu_torch.quant import QuantConfig
from omniquant_tpu_torch.serving.export import pack_model as t_pack_model
from omniquant_tpu_torch.utils import from_jax_params

from test_torch_calib_engine import _logger

BASE = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4)
# the four forms, as tests/test_falcon.py builds the first three
VARIANTS = {
    "7b": dict(),
    "rw": dict(multi_query=False, parallel_attn=False),
    "40b": dict(new_decoder_architecture=True, num_kv_heads=2),
    "alibi": dict(multi_query=False, parallel_attn=False, alibi=True,
                  bias=True),
}
NSAMPLES, SEQLEN = 4, 32
# the fresh W4A16 g16 LWC run, port against JAX, per layer (0, 1), each
# with the largest gap measured over both variants when it was set (layer
# 1's inputs come from layer 0's differing factors, and Adam moves a factor
# with a near-zero gradient by about lr whatever its size):
#   loss    per-epoch loss, relative (7.0e-7; 1.5e-5)
#   train   final LWC factors, absolute (1.4e-6; 2.8e-4)
#   weight  folded weights over the tensor's largest (1.7e-7; 2.2e-6)
#   scale   recorded scales, relative (2.3e-7; 4.9e-6)
#   zero    recorded zero points, absolute (0; 0)
FRESH_TOL = dict(loss=(1e-5, 2e-4), train=(2e-5, 3e-3),
                 weight=(2e-6, 3e-5), scale=(3e-6, 5e-5), zero=(0, 0))


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


def configs(variant):
    kw = dict(BASE, **VARIANTS[variant])
    return jfalcon.FalconConfig(**kw), tfalcon.FalconConfig(**kw)


def numpy_falcon(variant, seed=0):
    """A dense Falcon tree with numpy leaves in the variant's layout:
    N(0, 0.05) weights, N(0, 0.02) biases where the variant has them,
    LayerNorms around 1 with small biases, a tied lm_head."""
    jcfg, _ = configs(variant)
    rng = np.random.default_rng(seed)
    h = jcfg.hidden_size

    def w(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def lin(o, n):
        return {"weight": w(o, n), "bias": w(o, s=0.02) if jcfg.bias else None}

    def norm():
        return {"weight": (1.0 + 0.1 * rng.standard_normal(h)).astype(
            np.float32), "bias": w(h, s=0.02)}

    layers = []
    for _ in range(jcfg.num_hidden_layers):
        blk = {"query_key_value": lin(tfalcon.qkv_out_features(jcfg), h),
               "dense": lin(h, h), "dense_h_to_4h": lin(4 * h, h),
               "dense_4h_to_h": lin(h, 4 * h)}
        if jcfg.new_decoder_architecture:
            blk["ln_attn"], blk["ln_mlp"] = norm(), norm()
        else:
            blk["input_layernorm"] = norm()
            if not jcfg.parallel_attn:
                blk["post_attention_layernorm"] = norm()
        layers.append(blk)
    return {"word_embeddings": w(jcfg.vocab_size, h), "layers": layers,
            "ln_f": norm(), "lm_head": None}


def _jax(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _numpy(tree):
    return jax.tree.map(
        lambda a: None if a is None else (
            a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)),
        tree, is_leaf=lambda a: a is None)


def _torch(tree):
    return from_jax_params(tree, device="cpu")


def _close(got, want, rtol=1e-5, atol=1e-5, what=""):
    got_l = jax.tree.leaves(_numpy(got))
    want_l = jax.tree_util.tree_leaves_with_path(_numpy(want))
    assert len(got_l) == len(want_l)
    for (path, a), b in zip(want_l, got_l):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=what + jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_head_splits_match_jax(variant):
    """split_heads (kv broadcast to every query head) and split_heads_kv
    (the true kv head count, what the engine caches): exact."""
    jcfg, tcfg = configs(variant)
    fused = np.random.default_rng(1).standard_normal(
        (2, 5, tfalcon.qkv_out_features(jcfg))).astype(np.float32)
    for jfn, tfn in ((jfalcon.split_heads, tfalcon.split_heads),
                     (jfalcon.split_heads_kv, tfalcon.split_heads_kv)):
        want = [np.asarray(a) for a in jfn(jnp.asarray(fused), jcfg)]
        got = [a.numpy() for a in tfn(torch.from_numpy(fused), tcfg)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[1].shape[2] == jcfg.effective_kv_heads == \
        tcfg.effective_kv_heads


@pytest.mark.parametrize("n_heads", [1, 4, 6, 32, 71, 128, 232])
def test_alibi_slopes_match_jax(n_heads):
    np.testing.assert_array_equal(tfalcon.alibi_slopes(n_heads).numpy(),
                                  np.asarray(jfalcon.alibi_slopes(n_heads)))


@pytest.mark.parametrize("abits", [16, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_block_forward_and_taps_match_jax(variant, abits):
    """One block on a 12-token input (positions from 3, the default causal
    mask, ALiBi folded in): output, the per-head k/v it returns, and each
    linear's tapped input; at abits 4 the linears' inputs fake-quantized
    (the attention matmuls never are)."""
    jcfg, tcfg = configs(variant)
    blk = numpy_falcon(variant, seed=2)["layers"][0]
    x = np.random.default_rng(3).standard_normal((2, 12, 64)).astype(
        np.float32)
    pos = np.arange(3, 15)
    jtap, ttap = {}, {}
    want, wkv = jfalcon.block_forward(
        _jax(blk), jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
        spec=JSpec.from_bits(abits), tap=jtap)
    got, gkv = tfalcon.block_forward(
        _torch(blk), torch.from_numpy(x), tcfg,
        positions=torch.from_numpy(pos), spec=TSpec.from_bits(abits),
        tap=ttap)
    _close(got, want, what="y")
    _close(gkv, wkv, what="kv")
    assert sorted(ttap) == sorted(jtap) == sorted(tfalcon.LINEAR_NAMES)
    _close(ttap, jtap, what="tap")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, tcfg = configs(variant)
    dense = numpy_falcon(variant, seed=4)
    tokens = np.random.default_rng(5).integers(0, 128, (2, 24))
    want = jfalcon.forward(_jax(dense), jnp.asarray(tokens), jcfg)
    got = tfalcon.forward(_torch(dense), torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_family_and_let_refusal():
    """The registry entry (LWC only) and LET refused as JAX refuses it."""
    assert get_family("tiiuae/falcon-7b") is T_FALCON
    assert T_FALCON.linear_names == J_FALCON.linear_names
    assert T_FALCON.let_scale_keys == J_FALCON.let_scale_keys == ()
    assert not T_FALCON.supports_let and not J_FALCON.supports_let
    _, tcfg = configs("7b")
    blk = _torch(numpy_falcon("7b")["layers"][0])
    with pytest.raises(NotImplementedError, match="LET"):
        T_FALCON.effective_block_weights(
            blk, None, None, {"qkv_smooth_scale": torch.ones(64)}, tcfg)
    with pytest.raises(NotImplementedError, match="LWC-only"):
        T_FALCON.init_let_params(blk, tcfg, None, None)


@pytest.mark.parametrize("variant", ["7b", "40b"])
def test_effective_block_weights_match_jax(variant):
    """LWC fake quantization of every linear (W3 g16, factors moved off
    their start)."""
    jcfg, tcfg = configs(variant)
    blk = numpy_falcon(variant, seed=6)["layers"][1]
    rng = np.random.default_rng(7)
    lwc = {n: {k: (4.0 + rng.standard_normal((blk[n]["weight"].size // 16,
                                               1))).astype(np.float32)
               for k in ("upbound_factor", "lowbound_factor")}
           for n in tfalcon.LINEAR_NAMES}
    want = jfalcon.effective_block_weights(
        _jax(blk), JQuantConfig(n_bits=3, group_size=16, lwc=True),
        _jax(lwc), None, jcfg)
    got = tfalcon.effective_block_weights(
        _torch(blk), QuantConfig(n_bits=3, group_size=16, lwc=True),
        _torch(lwc), None, tcfg)
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_from_hf_state_dict_matches_jax():
    """An HF FalconForCausalLM state dict (numpy, built here) of the
    Falcon-40B form with an lm_head: the same tree in both packages."""
    jcfg, tcfg = configs("40b")
    dense = numpy_falcon("40b", seed=8)
    t = "transformer."
    sd = {t + "word_embeddings.weight": dense["word_embeddings"],
          t + "ln_f.weight": dense["ln_f"]["weight"],
          t + "ln_f.bias": dense["ln_f"]["bias"],
          "lm_head.weight": dense["word_embeddings"].copy()}
    where = {"query_key_value": "self_attention.", "dense": "self_attention.",
             "dense_h_to_4h": "mlp.", "dense_4h_to_h": "mlp.",
             "ln_attn": "", "ln_mlp": ""}
    for i, layer in enumerate(dense["layers"]):
        for name, sub in layer.items():
            for leaf, a in sub.items():
                if a is not None:
                    sd[f"{t}h.{i}.{where[name]}{name}.{leaf}"] = a
    want = jfalcon.from_hf_state_dict(sd, jcfg)
    got = tfalcon.from_hf_state_dict(sd, tcfg, device="cpu")
    _close(got, want, rtol=0, atol=0)
    assert got["layers"][0]["dense"]["bias"] is None


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("layout", ["pairs", "planar"])
def test_packed_words_match_jax(bias, layout):
    """pack_model on a Falcon tree (query_key_value, dense, dense_h_to_4h,
    dense_4h_to_h; with and without biases), W4 g32: words, scales, zeros
    and biases bit for bit, the rest of the tree carried as it is; the
    packed forward agrees with JAX's."""
    variant = "alibi" if bias else "7b"
    jcfg, tcfg = configs(variant)
    dense = numpy_falcon(variant, seed=9)
    want = j_pack_model(J_FALCON, _jax(dense),
                        JQuantConfig(n_bits=4, group_size=32), layout=layout)
    got = t_pack_model(T_FALCON, _torch(dense),
                       QuantConfig(n_bits=4, group_size=32), layout=layout,
                       device="cpu")
    for i in range(jcfg.num_hidden_layers):
        for name in tfalcon.LINEAR_NAMES:
            a, b = want["layers"][i][name], got["layers"][i][name]
            assert (a.layout, a.tile_k, a.bits, a.out_features) == (
                b.layout, b.tile_k, b.bits, b.out_features)
            for f in ("qweight", "scales", "zeros"):
                np.testing.assert_array_equal(getattr(b, f).numpy(),
                                              np.asarray(getattr(a, f)))
            assert (a.bias is None) == (b.bias is None) == (not bias)
            if bias:
                np.testing.assert_array_equal(b.bias.numpy(),
                                              np.asarray(a.bias))
    # the carrier takes JAX's packed tree to the port's, bit for bit
    np_tree = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                           want, is_leaf=lambda a: a is None)
    carried = from_jax_params(np_tree, device="cpu")
    for i in range(jcfg.num_hidden_layers):
        for name in tfalcon.LINEAR_NAMES:
            assert torch.equal(carried["layers"][i][name].qweight,
                               got["layers"][i][name].qweight)
    tokens = np.random.default_rng(10).integers(0, 128, (1, 16))
    np.testing.assert_allclose(
        tfalcon.forward(got, torch.from_numpy(tokens), tcfg).numpy(),
        np.asarray(jfalcon.forward(want, jnp.asarray(tokens), jcfg)),
        rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def windows():
    train, _ = j_get_synthetic(NSAMPLES, 0, SEQLEN, vocab_size=128)
    return np.asarray(train)


@pytest.mark.parametrize("variant", ["7b", "alibi"])
def test_collect_act_stats_matches_jax(variant, windows):
    jcfg, tcfg = configs(variant)
    dense = numpy_falcon(variant, seed=11)
    js = j_collect_act_stats(J_FALCON, _jax(dense), jcfg,
                             jnp.asarray(windows), batch=2)
    ts = collect_act_stats(T_FALCON, _torch(dense), tcfg, windows, batch=2,
                           device="cpu")
    _close(ts, js, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=["7b", "alibi"])
def calibrated(request, windows, tmp_path_factory):
    """JAX's calibration and the port's (W4A16 g16, LWC, 1 epoch, asked for
    LET: both go on without it), and the port's fold of JAX's
    omni_parameters.npz (epochs=0)."""
    variant = request.param
    jcfg, tcfg = configs(variant)
    dense = numpy_falcon(variant, seed=12)
    out_dir = str(tmp_path_factory.mktemp(f"falcon_calib_{variant}"))
    cc = dict(wbits=4, abits=16, group_size=16, lwc=True, let=True, epochs=1,
              nsamples=NSAMPLES, batch_size=1)
    jl, jh = _logger(f"falcon_calib_jax_{variant}")
    tl, th = _logger(f"falcon_calib_port_{variant}")
    j_losses, t_losses = [], []
    jp, jo = j_calibrate(J_FALCON, _jax(dense), jcfg, jnp.asarray(windows),
                         JCalibConfig(output_dir=out_dir, **cc), logger=jl,
                         progress_cb=lambda i, e, l: j_losses.append(l))
    tp, to = calibrate(T_FALCON, _torch(dense), tcfg, windows,
                       CalibConfig(**cc), logger=tl,
                       progress_cb=lambda i, e, l: t_losses.append(l),
                       device="cpu")
    rp, ro = calibrate(T_FALCON, _torch(dense), tcfg, windows,
                       CalibConfig(**dict(cc, epochs=0),
                                   resume=f"{out_dir}/omni_parameters.npz"),
                       device="cpu")
    return dict(variant=variant, dense=dense,
                jax=(_numpy(jp), _numpy(jo), j_losses, jh.lines),
                port=(_numpy(tp), _numpy(to), t_losses, th.lines),
                resumed=(rp, ro))


def test_calibration_is_lwc_only_as_in_jax(calibrated):
    """Asked for LET, both packages log the same warning once and train
    the LWC factors alone; the per-epoch log lines have the same form."""
    *_, jo, _, j_lines = calibrated["jax"]
    *_, to, _, t_lines = calibrated["port"]
    warned = [ln for ln in t_lines if ln.startswith("WARNING")]
    assert len(warned) == 1 and "falcon" in warned[0]
    assert warned == [ln for ln in j_lines if ln.startswith("WARNING")]
    for i in range(BASE["num_hidden_layers"]):
        assert sorted(to[i]) == sorted(jo[i]) == ["lwc", "qparams"]


def test_resumed_falcon_fold_and_pack_match_jax(calibrated):
    """JAX's LWC factors resumed with epochs=0: the folded blocks to f32
    ulps (the sigmoids' last bits), zero points and packed words bit for
    bit."""
    variant = calibrated["variant"]
    jp, jo, *_ = calibrated["jax"]
    rp, ro = calibrated["resumed"]
    _close(rp["layers"], jp["layers"], rtol=1e-6, atol=1e-6,
           what="resumed fold")
    wcfg = dict(n_bits=4, group_size=16)
    jpk = j_pack_model(J_FALCON, _jax(jp), JQuantConfig(**wcfg), _jax(jo))
    tpk = t_pack_model(T_FALCON, rp, QuantConfig(**wcfg), ro, device="cpu")
    for i in range(BASE["num_hidden_layers"]):
        for name in tfalcon.LINEAR_NAMES:
            np.testing.assert_array_equal(
                _numpy(ro[i]["qparams"][name]["zero"]),
                jo[i]["qparams"][name]["zero"])
            a, b = jpk["layers"][i][name], tpk["layers"][i][name]
            np.testing.assert_array_equal(b.qweight.numpy(),
                                          np.asarray(a.qweight))
            np.testing.assert_array_equal(b.zeros.numpy(),
                                          np.asarray(a.zeros))
            assert (a.bias is None) == (b.bias is None) == (
                variant != "alibi")


def test_fresh_falcon_calibration_matches_jax(calibrated):
    """Both packages calibrate from the same weights and windows: losses,
    LWC factors, folded weights and grids at FRESH_TOL."""
    jp, jo, j_losses, _ = calibrated["jax"]
    tp, to, t_losses, _ = calibrated["port"]
    tol = FRESH_TOL
    assert len(t_losses) == len(j_losses) == BASE["num_hidden_layers"]
    for i in range(BASE["num_hidden_layers"]):
        np.testing.assert_allclose(t_losses[i], j_losses[i],
                                   rtol=tol["loss"][i])
        _close(to[i]["lwc"], jo[i]["lwc"], rtol=0, atol=tol["train"][i],
               what=f"layer {i} lwc")
        for name in tfalcon.LINEAR_NAMES:
            want = jp["layers"][i][name]["weight"]
            got = tp["layers"][i][name]["weight"]
            assert np.abs(got - want).max() <= tol["weight"][i] * np.abs(
                want).max(), (i, name)
            np.testing.assert_allclose(to[i]["qparams"][name]["scale"],
                                       jo[i]["qparams"][name]["scale"],
                                       rtol=tol["scale"][i])
            np.testing.assert_allclose(to[i]["qparams"][name]["zero"],
                                       jo[i]["qparams"][name]["zero"],
                                       rtol=0, atol=tol["zero"][i])
