"""The port's block-wise calibration (calib/engine.py::calibrate) against
the JAX package's, on the CPU in f32.

A tiny LLaMA (hidden 64, inter 128, 2 layers, 4 query / 2 kv heads, so
n_rep = 2: the GQA v -> o transform and the ones-initialised
out_smooth_scale are covered) is made with numpy from a seed and
calibrated by both packages on the same 4 synthetic windows of 32 tokens:
W4A16 g16 with LWC, and W4A4 per-channel with LWC + LET after
collect_act_stats. Held against JAX:

- the per-epoch losses and the final trainables, at the tolerances stated
  below (measured, then a margin). The two packages sum in different
  orders, and Adam moves a trainable whose gradient is near zero by about
  lr * sign(g) whatever its size, so f32 noise grows along the run; with
  4-bit activations a code that flips on a rounding tie moves a whole grid
  step. The first step itself agrees to f32 noise
  (tests/test_torch_calib_transform.py::test_first_step_matches_jax_grad);
- each trainable's displacement from its start against JAX's: its cosine
  and the signs where JAX moved more than a step, bounds that a layer left
  at its start fails;
- the propagation pass and the loss and gradient of every layer on its
  inputs, with JAX's trainables carried across and frozen (learning rates
  0): each block output the port propagates against JAX's block on JAX's
  fold, and the per-layer loss and gradient norm, at f32 tolerance;
- the fold, the recorded (scale, zero) grid, the packed words and the
  served greedy tokens, with the JAX run's trainables carried across (a
  JAX-written omni_parameters.npz resumed with epochs=0). Zero points and
  packed words are bit-exact; scales and folded weights differ only where
  XLA's and PyTorch's sigmoid differ in the last bits (up to 3 ulps on
  about 0.4 % of inputs), so they are held to a few f32 ulps;
- an npz the port writes resumes in JAX to the same fold;
- the NaN stop: the same log lines in both packages; a family without LET:
  the same warning, and LWC alone.
"""
import dataclasses
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.calib import CalibConfig as JCalibConfig
from omniquant_tpu.calib import calibrate as j_calibrate
from omniquant_tpu.calib import collect_act_stats as j_collect_act_stats
from omniquant_tpu.calib.data import get_synthetic as j_get_synthetic
from omniquant_tpu.models import LLAMA as J_LLAMA
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.models.common import ActQuantSpec as JSpec
from omniquant_tpu.models.common import causal_mask as j_causal_mask
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.serving.engine import LlamaEngine as JEngine
from omniquant_tpu.serving.export import pack_model as j_pack_model
from omniquant_tpu_torch.calib import CalibConfig, calibrate, collect_act_stats
from omniquant_tpu_torch.calib.data import get_synthetic
from omniquant_tpu_torch.models import LLAMA as T_LLAMA
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.models.common import ActQuantSpec as TSpec
from omniquant_tpu_torch.quant import QuantConfig
from omniquant_tpu_torch.serving.engine import LlamaEngine as TEngine
from omniquant_tpu_torch.serving.export import pack_model as t_pack_model
from omniquant_tpu_torch.utils import from_jax_params

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
NSAMPLES, SEQLEN = 4, 32

# name -> (CalibConfig keywords, tolerances), each tolerance with the
# largest gap measured when it was set:
#   loss0  per-epoch loss, layer 0 epoch 0, relative (W4A16 2e-7, W4A4 5e-7)
#   loss   every other epoch, relative (W4A16 5e-7; W4A4 + LET 1e-2)
#   train  final trainables, absolute, per layer (W4A16 1.4e-6 both;
#          W4A4 + LET 2.5e-3 and 5.6e-2: with different inputs to layer 1,
#          its 8 Adam steps, each up to about lr, differ almost freely, so
#          this bound is no tighter than the steps; layer 1 is held by cos
#          and sign below and by the frozen run of test_propagation_*)
#   cos    per layer, the least cosine between a trainable's displacement
#          from its start in the port and in JAX (W4A16 1 - 1e-9 both;
#          W4A4 + LET 0.9993 and 0.69); a trainable left at its start has 0
#   sign   per layer, the least share of a trainable's entries that move
#          the same way as JAX's, over those JAX moved by more than one
#          step (lr) (W4A16 1 both; W4A4 + LET 1 and 0.75)
#   weight folded weights over the tensor's largest (W4A16 1.9e-7; W4A4 +
#          LET 0.14), scale the recorded scales, relative (W4A16 2e-7;
#          W4A4 + LET 3.2e-2), zero the recorded zero points, absolute
#          (W4A16 0; W4A4 + LET 1: one code)
RUNS = {
    "w4a16g16_lwc": (dict(wbits=4, abits=16, group_size=16, lwc=True),
                     dict(loss0=1e-5, loss=1e-5, train=(2e-5, 2e-5),
                          cos=(0.9999, 0.9999), sign=(1.0, 1.0),
                          weight=1e-6, scale=1e-6, zero=0)),
    "w4a4_lwc_let": (dict(wbits=4, abits=4, lwc=True, let=True),
                     dict(loss0=1e-5, loss=5e-2, train=(1e-2, 0.1),
                          cos=(0.995, 0.5), sign=(0.95, 0.6),
                          weight=0.25, scale=0.1, zero=1)),
}
# the frozen run (test_propagation_matches_jax): each propagated block
# output over the largest of JAX's (measured 4.4e-7), and the per-layer
# loss and gradient norm, relative (measured 1.2e-6)
PROP_TOL, FROZEN_RTOL = 2e-6, 1e-5
LOG_RE = re.compile(r"layer (\d+) iter (\d+) loss:(\S+) norm:(\S+)")


def numpy_llama(seed=0):
    rng = np.random.default_rng(seed)
    h, i = CFG["hidden_size"], CFG["intermediate_size"]
    kv = CFG["num_key_value_heads"] * h // CFG["num_attention_heads"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    def lin(o, n):
        return {"weight": w(o, n), "bias": None}

    layers = [{
        "input_layernorm": {"weight": norm()},
        "post_attention_layernorm": {"weight": norm()},
        "q_proj": lin(h, h), "k_proj": lin(kv, h), "v_proj": lin(kv, h),
        "o_proj": lin(h, h), "gate_proj": lin(i, h), "up_proj": lin(i, h),
        "down_proj": lin(h, i),
    } for _ in range(CFG["num_hidden_layers"])]
    return {"embed_tokens": w(CFG["vocab_size"], h), "layers": layers,
            "norm": {"weight": norm()}, "lm_head": w(CFG["vocab_size"], h)}


def _jax(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _numpy(tree):
    return jax.tree.map(
        lambda a: None if a is None else (
            a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)),
        tree, is_leaf=lambda a: a is None)


JCFG = jllama.LlamaConfig(**CFG)
TCFG = tllama.LlamaConfig(**CFG)


@pytest.fixture(scope="module")
def windows():
    train, _ = j_get_synthetic(NSAMPLES, 0, SEQLEN, vocab_size=128)
    return train


def _starts(family, layers, model_cfg, wcfg, let_stats):
    """Each layer's trainables as calibrate starts them: the LWC factors at
    4.0 and, given act stats, the LET scales and shifts."""
    starts = []
    for i, layer in enumerate(layers):
        start = {"lwc": family.init_lwc_params_block(layer, wcfg)}
        if let_stats is not None:
            start["let"] = family.init_let_params(layer, model_cfg,
                                                  let_stats[i], alpha=0.5)
        starts.append(_numpy(start))
    return starts


def _frozen(family, dense, windows, cc, stats, resume, logger_name):
    """calibrate with both learning rates 0, resumed from ``resume``: the
    trainables stay as carried; the log lines give each layer's loss and
    gradient norm on the inputs its propagation pass made."""
    lg, lines = _logger(logger_name)
    cc = dict(cc, epochs=1, let_lr=0.0, lwc_lr=0.0)
    if family is J_LLAMA:
        _, o = j_calibrate(family, _jax(dense), JCFG, jnp.asarray(windows),
                           JCalibConfig(resume=resume, **cc), *stats,
                           logger=lg)
    else:
        _, o = calibrate(family, from_jax_params(dense, device="cpu"), TCFG,
                         windows, CalibConfig(resume=resume, **cc), *stats,
                         logger=lg, device="cpu")
    return _numpy(o), [LOG_RE.search(ln).groups() for ln in lines.lines
                       if LOG_RE.search(ln)]


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request, windows, tmp_path_factory):
    """Both packages' calibrations of one RUNS entry, the trainables'
    starts, the port's fold of the JAX run's trainables (its npz resumed
    with epochs=0), and both packages' frozen runs on those trainables
    (the port's with its propagated block outputs recorded)."""
    name = request.param
    kw, tol = RUNS[name]
    out_dir = str(tmp_path_factory.mktemp(name))
    cc = dict(epochs=2, nsamples=NSAMPLES, batch_size=1, **kw)
    dense = numpy_llama()
    j_stats = t_stats = (None, None)
    if kw.get("let"):
        j_stats = j_collect_act_stats(J_LLAMA, _jax(dense), JCFG,
                                      jnp.asarray(windows))
        t_stats = collect_act_stats(T_LLAMA, from_jax_params(
            dense, device="cpu"), TCFG, windows, device="cpu")
    j_losses, t_losses = [], []
    jp, jo = j_calibrate(
        J_LLAMA, _jax(dense), JCFG, jnp.asarray(windows),
        JCalibConfig(output_dir=out_dir, **cc), *j_stats,
        progress_cb=lambda i, e, l: j_losses.append(l))
    tp, to = calibrate(
        T_LLAMA, from_jax_params(dense, device="cpu"), TCFG, windows,
        CalibConfig(**cc), *t_stats,
        progress_cb=lambda i, e, l: t_losses.append(l), device="cpu")
    npz = f"{out_dir}/omni_parameters.npz"
    rp, ro = calibrate(
        T_LLAMA, from_jax_params(dense, device="cpu"), TCFG, windows,
        CalibConfig(**dict(cc, epochs=0), resume=npz), device="cpu")

    propagated = []

    def recording_block_forward(layer, x, model_cfg, mask, positions,
                                spec=None, **kw_):
        if spec is not None:
            kw_["spec"] = spec
        out = tllama.block_forward(layer, x, model_cfg, mask, positions,
                                   **kw_)
        if spec is not None and not torch.is_grad_enabled():
            propagated.append(out[0].numpy().copy())
        return out

    recording = dataclasses.replace(T_LLAMA,
                                    block_forward=recording_block_forward)
    frozen = dict(
        jax=_frozen(J_LLAMA, dense, windows, cc, j_stats, npz,
                    f"frozen_jax_{name}"),
        port=_frozen(recording, dense, windows, cc, t_stats, npz,
                     f"frozen_port_{name}"),
        propagated=np.stack(propagated).reshape(
            CFG["num_hidden_layers"], NSAMPLES, SEQLEN, -1))
    return dict(name=name, kw=kw, tol=tol, cc=cc, out_dir=out_dir,
                jax=(_numpy(jp), _numpy(jo), j_losses),
                port=(tp, to, t_losses), resumed=(rp, ro),
                starts=dict(
                    jax=_starts(J_LLAMA, _jax(dense)["layers"], JCFG,
                                _wcfg(kw, JQuantConfig, lwc=True),
                                j_stats[0]),
                    port=_starts(T_LLAMA, from_jax_params(
                        dense, device="cpu")["layers"], TCFG,
                        _wcfg(kw, QuantConfig, lwc=True), t_stats[0])),
                frozen=frozen, windows=windows)


def _wcfg(kw, pkg, **more):
    return pkg(n_bits=kw["wbits"], group_size=kw.get("group_size"), **more)


def test_losses_match_jax(run):
    j_losses, t_losses = run["jax"][2], run["port"][2]
    assert len(j_losses) == len(t_losses) == 2 * CFG["num_hidden_layers"]
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses[0], j_losses[0],
                               rtol=run["tol"]["loss0"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=run["tol"]["loss"])


def test_trainables_match_jax(run):
    jo, to = run["jax"][1], _numpy(run["port"][1])
    groups = ("lwc", "let") if run["kw"].get("let") else ("lwc",)
    for i in range(CFG["num_hidden_layers"]):
        assert sorted(k for k in to[i] if k != "qparams") == sorted(groups)
        for g in groups:
            flat_j = jax.tree_util.tree_leaves_with_path(jo[i][g])
            flat_t = jax.tree.leaves(to[i][g])
            assert len(flat_j) == len(flat_t)
            for (path, a), b in zip(flat_j, flat_t):
                np.testing.assert_allclose(
                    b, a, atol=run["tol"]["train"][i], rtol=0,
                    err_msg=f"layer {i} {g}{jax.tree_util.keystr(path)}")


def test_trainables_move_as_jax(run):
    """Each trainable's displacement from its start, port against JAX: its
    cosine and the signs where JAX moved by more than one step (``lr``),
    bounds (RUNS ``cos``, ``sign``) that a trainable left at its start
    fails."""
    jo, to = run["jax"][1], _numpy(run["port"][1])
    starts = run["starts"]
    lrs = {"lwc": 1e-2, "let": 5e-3}
    for i in range(CFG["num_hidden_layers"]):
        assert sorted(starts["port"][i]) == sorted(
            k for k in to[i] if k != "qparams")
        for g, lr in lrs.items():
            if g not in to[i]:
                continue
            leaves = zip(jax.tree_util.tree_leaves_with_path(jo[i][g]),
                         jax.tree.leaves(starts["jax"][i][g]),
                         jax.tree.leaves(to[i][g]),
                         jax.tree.leaves(starts["port"][i][g]))
            for (path, j_end), j_start, t_end, t_start in leaves:
                where = f"layer {i} {g}{jax.tree_util.keystr(path)}"
                dj = (j_end - j_start).ravel().astype(np.float64)
                dt = (t_end - t_start).ravel().astype(np.float64)
                cos = dj @ dt / max(np.linalg.norm(dj) * np.linalg.norm(dt),
                                    1e-300)
                assert cos >= run["tol"]["cos"][i], (where, cos)
                big = np.abs(dj) > lr
                if big.any():
                    same = (np.sign(dt[big]) == np.sign(dj[big])).mean()
                    assert same >= run["tol"]["sign"][i], (where, same)


def test_propagation_matches_jax(run):
    """JAX's trainables carried across and frozen (learning rates 0): the
    trainables stay as carried; every block output the port's propagation
    pass makes equals JAX's block, with the activation quantizers on, on
    JAX's fold of the previous output (PROP_TOL); and each layer's loss
    and gradient norm on those inputs equal JAX's (FROZEN_RTOL)."""
    jp, jo, _ = run["jax"]
    (t_omni, t_log), (_, j_log) = run["frozen"]["port"], run["frozen"]["jax"]
    for i in range(CFG["num_hidden_layers"]):
        for g in jo[i]:
            if g == "qparams":
                continue
            for a, b in zip(jax.tree.leaves(jo[i][g]),
                            jax.tree.leaves(t_omni[i][g])):
                np.testing.assert_array_equal(b, a)
    spec = JSpec.from_bits(run["kw"]["abits"])
    mask = j_causal_mask(SEQLEN, SEQLEN, dtype=jnp.float32)
    positions = jnp.arange(SEQLEN)
    xs = J_LLAMA.embed(_jax(numpy_llama()), jnp.asarray(run["windows"]),
                       JCFG)
    for i, layer in enumerate(_jax(jp)["layers"]):
        xs = jnp.concatenate([
            J_LLAMA.block_forward(layer, x[None], JCFG, mask, positions,
                                  spec)[0] for x in xs])
        want = np.asarray(xs)
        got = run["frozen"]["propagated"][i]
        assert np.abs(got - want).max() <= PROP_TOL * np.abs(want).max(), (
            f"layer {i} output", np.abs(got - want).max())
    assert [g[:2] for g in t_log] == [g[:2] for g in j_log] == [
        (str(i), "0") for i in range(CFG["num_hidden_layers"])]
    np.testing.assert_allclose(
        np.array([g[2:] for g in t_log], np.float64),
        np.array([g[2:] for g in j_log], np.float64), rtol=FROZEN_RTOL)


def _assert_fold_close(tp, to, jp, jo, what):
    """Folded blocks and grids agree: zero points exactly, the rest to a
    few f32 ulps of the tensor's scale (the sigmoids' last bits)."""
    for i in range(CFG["num_hidden_layers"]):
        for key, sub in jp["layers"][i].items():
            for leaf, want in sub.items():
                got = tp["layers"][i][key].get(leaf)
                if want is None:
                    assert got is None
                    continue
                got = got.numpy() if isinstance(got, torch.Tensor) else got
                np.testing.assert_allclose(
                    got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                    err_msg=f"{what}: layer {i} {key}.{leaf}")
        for name in tllama.LINEAR_NAMES:
            got, want = to[i]["qparams"][name], jo[i]["qparams"][name]
            got = _numpy(got)
            np.testing.assert_array_equal(got["zero"], want["zero"])
            np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-6,
                                       err_msg=f"{what}: {i} {name} scale")


def test_resumed_fold_matches_jax(run):
    """A JAX-written omni_parameters.npz resumed with epochs=0: the fold
    of the same trainables."""
    jp, jo, _ = run["jax"]
    rp, ro = run["resumed"]
    for i in range(CFG["num_hidden_layers"]):
        assert sorted(ro[i]) == sorted(jo[i])
    _assert_fold_close(rp, ro, jp, jo, "resumed")
    if run["kw"].get("let"):
        assert rp["layers"][0]["input_layernorm"]["bias"] is not None


def test_port_fold_is_close_to_jax(run):
    """The port's own run folds to JAX's weights and grid up to the
    trainables' gap (tolerances in RUNS)."""
    jp, jo, _ = run["jax"]
    tp, to = run["port"][0], _numpy(run["port"][1])
    tol = run["tol"]
    for i in range(CFG["num_hidden_layers"]):
        for name in tllama.LINEAR_NAMES:
            want = jp["layers"][i][name]["weight"]
            got = tp["layers"][i][name]["weight"].numpy()
            assert np.abs(got - want).max() <= tol["weight"] * np.abs(
                want).max(), (i, name)
            got, want = to[i]["qparams"][name], jo[i]["qparams"][name]
            np.testing.assert_allclose(got["scale"], want["scale"],
                                       rtol=tol["scale"])
            np.testing.assert_allclose(got["zero"], want["zero"], rtol=0,
                                       atol=tol["zero"])


def test_pack_words_match_jax(run):
    """pack_model of the resumed fold gives JAX's words and zeros bit for
    bit, scales to f32 ulps, biases (LET) to f32 noise."""
    jp, jo, _ = run["jax"]
    rp, ro = run["resumed"]
    jpk = j_pack_model(J_LLAMA, _jax(jp), _wcfg(run["kw"], JQuantConfig),
                       _jax(jo))
    tpk = t_pack_model(T_LLAMA, rp, _wcfg(run["kw"], QuantConfig), ro,
                       device="cpu")
    for i in range(CFG["num_hidden_layers"]):
        for name in tllama.LINEAR_NAMES:
            a, b = jpk["layers"][i][name], tpk["layers"][i][name]
            assert (a.layout, a.tile_k) == (b.layout, b.tile_k)
            np.testing.assert_array_equal(np.asarray(a.qweight),
                                          b.qweight.numpy())
            np.testing.assert_array_equal(np.asarray(a.zeros),
                                          b.zeros.numpy())
            np.testing.assert_allclose(b.scales.numpy(), np.asarray(a.scales),
                                       rtol=1e-6)
            if a.bias is None:
                assert b.bias is None
            else:
                np.testing.assert_allclose(
                    b.bias.numpy(), np.asarray(a.bias), rtol=1e-5,
                    atol=1e-6 * np.abs(np.asarray(a.bias)).max())


def test_served_greedy_tokens_match_jax(run):
    """calibrate -> pack -> serve: both packages' engines (f32, CPU) on
    their own pack of the same trainables' fold give the same greedy
    tokens."""
    jp, jo, _ = run["jax"]
    rp, ro = run["resumed"]
    abits = run["kw"]["abits"]
    jpk = j_pack_model(J_LLAMA, _jax(jp), _wcfg(run["kw"], JQuantConfig),
                       _jax(jo))
    tpk = t_pack_model(T_LLAMA, rp, _wcfg(run["kw"], QuantConfig), ro,
                       device="cpu")
    je = JEngine(jpk, JCFG, max_batch=2, max_len=64, dtype=jnp.float32,
                 spec=JSpec.from_bits(abits))
    te = TEngine(tpk, TCFG, max_batch=2, max_len=64, dtype=torch.float32,
                 spec=TSpec.from_bits(abits), device="cpu")
    prompt = [int(t) for t in np.asarray(j_get_synthetic(
        1, 5, 12, vocab_size=128)[0][0])]
    want = je.generate(prompt, max_new_tokens=8)
    assert te.generate(prompt, max_new_tokens=8) == want


def test_port_npz_resumes_in_jax(run):
    """The omni_parameters.npz the port writes feeds JAX's calibrate
    (epochs=0) to the port's fold."""
    out_dir = run["out_dir"] + "_port"
    dense = numpy_llama()
    tp, to = calibrate(
        T_LLAMA, from_jax_params(dense, device="cpu"), TCFG,
        np.zeros((NSAMPLES, SEQLEN), np.int32),
        CalibConfig(**dict(run["cc"], epochs=0), output_dir=out_dir,
                    resume=f"{run['out_dir']}/omni_parameters.npz"),
        device="cpu")
    jp, jo = j_calibrate(
        J_LLAMA, _jax(dense), JCFG, jnp.zeros((NSAMPLES, SEQLEN), jnp.int32),
        JCalibConfig(**dict(run["cc"], epochs=0),
                     resume=f"{out_dir}/omni_parameters.npz"))
    _assert_fold_close(tp, to, _numpy(jp), _numpy(jo), "port npz in JAX")


def test_offload_layers_matches_resident(windows):
    """Blocks parked on the host, one on the device at a time: the same
    result as all resident, bit for bit (the same ops on one device)."""
    cc = dict(wbits=3, abits=16, group_size=16, lwc=True, epochs=1,
              nsamples=NSAMPLES, batch_size=2)
    dense = numpy_llama(seed=3)
    q1, o1 = calibrate(T_LLAMA, from_jax_params(dense, device="cpu"), TCFG,
                       windows, CalibConfig(**cc), device="cpu")
    q2, o2 = calibrate(T_LLAMA, from_jax_params(dense, device="cpu"), TCFG,
                       windows, CalibConfig(offload_layers=True, **cc),
                       device="cpu")
    for a, b in zip(jax.tree.leaves(_numpy(q1)), jax.tree.leaves(_numpy(q2))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(_numpy(o1)), jax.tree.leaves(_numpy(o2))):
        np.testing.assert_array_equal(a, b)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        # the per-layer wall time differs between runs
        self.lines.append(re.sub(r"done in [0-9.]+s", "done",
                                 record.getMessage()))


def _logger(name):
    lg = logging.getLogger(name)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    h = _Lines()
    lg.handlers = [h]
    return lg, h


def test_nan_stop_matches_jax(windows):
    """A NaN in a weight makes every loss NaN: both packages log the same
    lines, stop each layer after its first epoch and call progress_cb for
    no epoch."""
    dense = numpy_llama(seed=4)
    dense["layers"][0]["up_proj"]["weight"][0, 0] = np.nan
    cc = dict(wbits=4, abits=16, group_size=16, lwc=True, epochs=3,
              nsamples=NSAMPLES, batch_size=2)
    jl, jh = _logger("calib_nan_jax")
    tl, th = _logger("calib_nan_port")
    j_cb, t_cb = [], []
    j_calibrate(J_LLAMA, _jax(dense), JCFG, jnp.asarray(windows),
                JCalibConfig(**cc), logger=jl,
                progress_cb=lambda *a: j_cb.append(a))
    calibrate(T_LLAMA, from_jax_params(dense, device="cpu"), TCFG, windows,
              CalibConfig(**cc), logger=tl,
              progress_cb=lambda *a: t_cb.append(a), device="cpu")
    assert j_cb == t_cb == []
    assert th.lines == jh.lines
    assert sum("Loss is NAN" in ln for ln in th.lines) == 2
    assert "layer 0 iter 0 loss:nan norm:nan" in th.lines


def test_family_without_let_matches_jax(windows):
    """A family whose supports_let is False, asked for LET: both packages
    log the same warning and calibrate with LWC alone."""
    cc = dict(wbits=4, abits=16, group_size=16, lwc=True, let=True,
              epochs=1, nsamples=NSAMPLES, batch_size=2)
    dense = numpy_llama(seed=5)
    jl, jh = _logger("calib_nolet_jax")
    tl, th = _logger("calib_nolet_port")
    _, jo = j_calibrate(dataclasses.replace(J_LLAMA, supports_let=False),
                        _jax(dense), JCFG, jnp.asarray(windows),
                        JCalibConfig(**cc), logger=jl)
    _, to = calibrate(dataclasses.replace(T_LLAMA, supports_let=False),
                      from_jax_params(dense, device="cpu"), TCFG, windows,
                      CalibConfig(**cc), logger=tl, device="cpu")
    warned = [ln for ln in th.lines if ln.startswith("WARNING")]
    assert len(warned) == 1
    assert warned == [ln for ln in jh.lines if ln.startswith("WARNING")]
    for i in range(CFG["num_hidden_layers"]):
        assert sorted(to[i]) == sorted(jo[i]) == ["lwc", "qparams"]


def test_synthetic_windows_match_jax():
    for seed, n, seqlen, vocab in ((0, 4, 32, 128), (3, 16, 2048, 32000)):
        want_train, want_test = j_get_synthetic(n, seed, seqlen,
                                                vocab_size=vocab)
        got_train, got_test = get_synthetic(n, seed, seqlen,
                                            vocab_size=vocab)
        np.testing.assert_array_equal(got_train, want_train)
        np.testing.assert_array_equal(got_test, want_test)
        assert got_train.dtype == want_train.dtype == np.int32
