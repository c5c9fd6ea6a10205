"""The LET algebra (quant/transform.py), the calibration half of
models/llama.py (init_let_params, init_lwc_params_block,
effective_block_weights, block_forward's tap, from_hf_state_dict), the
activation statistics (calib/act_stats.py), the windows
(calib/data.py) and the npz checkpoints (utils/checkpoint.py) against the
JAX package on the CPU, on numpy-seeded inputs, JAX op by op.

Tolerances: elementwise transforms (divisions, products, truncation) are
bit-exact; a bias that takes a matrix-vector product, the block forward,
its loss and the gradients sum in another order and are held to rtol 1e-5
(gradients: 1e-5 of the leaf's largest entry, 2e-5 through a whole block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.calib import collect_act_stats as j_collect_act_stats
from omniquant_tpu.calib.data import sample_windows as j_sample_windows
from omniquant_tpu.models import LLAMA as J_LLAMA
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.models.common import ActQuantSpec as JSpec
from omniquant_tpu.models.common import causal_mask as j_mask
from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import transform as jt
from omniquant_tpu.utils import checkpoint as j_ckpt
from omniquant_tpu_torch.calib import collect_act_stats, get_loaders
from omniquant_tpu_torch.calib.data import sample_windows
from omniquant_tpu_torch.models import LLAMA as T_LLAMA
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.models.common import ActQuantSpec as TSpec
from omniquant_tpu_torch.models.common import causal_mask as t_mask
from omniquant_tpu_torch.quant import QuantConfig
from omniquant_tpu_torch.quant import transform as tt
from omniquant_tpu_torch.utils import checkpoint as t_ckpt
from omniquant_tpu_torch.utils import from_jax_params

from test_torch_calib_engine import CFG, JCFG, TCFG, _jax, _numpy, numpy_llama

GRAD_RTOL = 1e-5


def _close(got, want, rtol=1e-5, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30),
        err_msg=what)


def _torch(tree, grad=False):
    def conv(a):
        if a is None:
            return None
        t = torch.tensor(np.asarray(a))
        return t.requires_grad_(True) if grad else t
    return jax.tree.map(conv, tree, is_leaf=lambda a: a is None)


def test_truncate_number_matches_jax():
    x = np.asarray([-0.5, -1e-2, -5e-3, -0.0, 0.0, 1e-3, 9.99e-3, 1e-2, 0.3],
                   np.float32)
    np.testing.assert_array_equal(
        tt.truncate_number(torch.from_numpy(x)).numpy(),
        np.asarray(jt.truncate_number(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tt._truncate_fwd_value(torch.from_numpy(x), 0.1).numpy(),
        np.asarray(jt._truncate_fwd_value(jnp.asarray(x), 0.1)))
    tx = torch.tensor(x, requires_grad=True)
    r = torch.arange(len(x), dtype=torch.float32)
    (tt.truncate_number(tx) * r).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jt.truncate_number(a) * r.numpy()))(
        jnp.asarray(x))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


def _lin(rng, out_f, in_f, bias):
    return {"weight": rng.standard_normal((out_f, in_f)).astype(np.float32),
            "bias": (rng.standard_normal(out_f).astype(np.float32)
                     if bias else None)}


def _pos(rng, n):
    return (0.5 + rng.random(n)).astype(np.float32)


TRANSFORMS = ["ln_fcs", "ln_fcs_bias", "fc_fc", "fc_fc_gqa", "q_k",
              "q_k_gqa_bias"]


def _transform_case(name, rng):
    """(JAX function, port function, args as numpy trees): each function
    maps (weights, scales, shifts) to the transformed weights."""
    h, hd = 16, 4
    bias = name.endswith("bias")
    if name.startswith("ln_fcs"):
        ln = {"weight": _pos(rng, h)}
        if bias:
            ln["bias"] = rng.standard_normal(h).astype(np.float32)
        fcs = [_lin(rng, 12, h, bias), _lin(rng, 8, h, False)]
        return (lambda p, s, d: jt.smooth_ln_fcs(p[0], p[1], s, d),
                lambda p, s, d: tt.smooth_ln_fcs(p[0], p[1], s, d),
                (ln, fcs), _pos(rng, h), rng.standard_normal(h).astype(
                    np.float32))
    if name.startswith("fc_fc"):
        n_rep = 2 if name.endswith("gqa") else 1
        kv = 8
        p = (_lin(rng, kv, h, False), _lin(rng, kv * n_rep, kv * n_rep, True))
        return (lambda p, s, d: jt.smooth_fc_fc_gqa(p[0], p[1], s, d, hd,
                                                    n_rep),
                lambda p, s, d: tt.smooth_fc_fc_gqa(p[0], p[1], s, d, hd,
                                                    n_rep),
                p, _pos(rng, kv), rng.standard_normal(kv).astype(np.float32))
    n_rep = 2 if "gqa" in name else 1
    kv = 8
    p = (_lin(rng, kv * n_rep, h, bias), _lin(rng, kv, h, bias))
    return (lambda p, s, d: jt.smooth_q_k(p[0], p[1], s, hd, n_rep),
            lambda p, s, d: tt.smooth_q_k(p[0], p[1], s, hd, n_rep),
            p, _pos(rng, kv), np.zeros(kv, np.float32))


@pytest.mark.parametrize("name", TRANSFORMS)
def test_let_transform_matches_jax(name):
    """Forward (bit-exact but for the w @ shift biases) and the gradient
    of a scalar of every output w.r.t. the weights, scales and shifts."""
    rng = np.random.default_rng(TRANSFORMS.index(name))
    jfun, tfun, p, s, d = _transform_case(name, rng)
    want = _numpy(jfun(_jax(p), jnp.asarray(s), jnp.asarray(d)))
    got = _numpy(tfun(_torch(p), torch.from_numpy(s), torch.from_numpy(d)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        if "bias" in jax.tree_util.keystr(path) and name != "q_k_gqa_bias":
            _close(g, w, 1e-6, jax.tree_util.keystr(path))
        else:
            np.testing.assert_array_equal(g, w, jax.tree_util.keystr(path))

    weights = [rng.standard_normal(np.shape(w)).astype(np.float32)
               for w in jax.tree.leaves(want)]

    def jscalar(p_, s_, d_):
        return sum(jnp.sum(a * r) for a, r in zip(
            jax.tree.leaves(jfun(p_, s_, d_)), weights))

    jg = jax.grad(jscalar, argnums=(0, 1, 2))(_jax(p), jnp.asarray(s),
                                             jnp.asarray(d))
    tp = _torch(p, grad=True)
    ts = torch.tensor(s, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    sum((a * torch.from_numpy(r)).sum() for a, r in zip(
        jax.tree.leaves(tfun(tp, ts, td)), weights)).backward()
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg[0]),
                            jax.tree.leaves(tp)):
        _close(b.grad, a, GRAD_RTOL, jax.tree_util.keystr(path))
    _close(ts.grad, jg[1], GRAD_RTOL, "d/dscales")
    if td.grad is not None:
        _close(td.grad, jg[2], GRAD_RTOL, "d/dshifts")
    else:
        assert not np.asarray(jg[2]).any()


@pytest.fixture(scope="module")
def dense():
    return numpy_llama(seed=7)


@pytest.fixture(scope="module")
def stats(dense):
    train = j_sample_windows(np.arange(5000) % CFG["vocab_size"], 4, 1, 32)
    j = j_collect_act_stats(J_LLAMA, _jax(dense), JCFG, jnp.asarray(train))
    t = collect_act_stats(T_LLAMA, from_jax_params(dense, device="cpu"),
                          TCFG, train, device="cpu")
    return j, t


def test_collect_act_stats_matches_jax(stats):
    """Running abs-max and the EMA of the midrange, per linear and layer
    (the block forwards sum in another order: rtol 1e-5)."""
    (js, jsh), (ts, tsh) = stats
    assert len(ts) == len(js) == CFG["num_hidden_layers"]
    for i in range(len(js)):
        assert sorted(ts[i]) == sorted(js[i]) == sorted(tllama.LINEAR_NAMES)
        for name in js[i]:
            _close(ts[i][name], js[i][name], 1e-5, f"{i} {name} scale")
            _close(tsh[i][name], jsh[i][name], 1e-5, f"{i} {name} shift")


@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("n_kv", [2, 4])
def test_init_let_params_matches_jax(dense, stats, with_stats, n_kv):
    """The plain column max clamped at 1e-5; ones without act stats; the
    v -> o scale at ones under GQA (n_kv 2 of 4 heads)."""
    cfg = dict(CFG, num_key_value_heads=n_kv)
    kv = n_kv * CFG["hidden_size"] // CFG["num_attention_heads"]
    layer = numpy_llama(seed=7)["layers"][0]
    if n_kv == 4:
        rng = np.random.default_rng(0)
        for name in ("k_proj", "v_proj"):
            layer[name]["weight"] = rng.standard_normal(
                (kv, CFG["hidden_size"])).astype(np.float32) * 0.05
    js = stats[0][0][0] if with_stats else None
    want = jllama.init_let_params(_jax(layer), jllama.LlamaConfig(**cfg), js)
    got = tllama.init_let_params(
        from_jax_params(layer, device="cpu"), tllama.LlamaConfig(**cfg),
        {k: np.array(v) for k, v in js.items()} if with_stats else None)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], 2e-7, k)  # pow: one ulp
    if n_kv == 2:
        assert got["out_smooth_scale"].eq(1).all()


def _trainables(dense, stats, wcfg):
    layer = dense["layers"][1]
    let = jllama.init_let_params(_jax(layer), JCFG, stats[0][0][1])
    lwc = jllama.init_lwc_params_block(_jax(layer), wcfg)
    rng = np.random.default_rng(11)
    # away from the init values, with some LET scales below the 1e-2
    # truncation and sigmoids of the LWC factors where XLA's and PyTorch's
    # agree (a few ulps apart elsewhere)
    let = {k: np.asarray(v) * (1 + 0.2 * rng.standard_normal(v.shape))
           .astype(np.float32) for k, v in let.items()}
    let = {k: (v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
               if "shift" in k else v) for k, v in let.items()}
    let["qkv_smooth_scale"][:2] = [5e-3, -4e-3]
    from test_torch_calib_quant import _agreeing_factors
    lwc = {n: {k: _agreeing_factors(rng, np.shape(v)) for k, v in d.items()}
           for n, d in lwc.items()}
    return layer, {"let": let, "lwc": lwc}


@pytest.mark.parametrize("group_size", [None, 16])
def test_effective_block_weights_matches_jax(dense, stats, group_size):
    """LET then LWC on a block: the weights (fake-quantized: bit-exact but
    where a w @ shift bias enters), the fold-only path, and the gradient of
    a scalar of every weight w.r.t. every trainable."""
    jw = JQuantConfig(n_bits=4, group_size=group_size, lwc=True)
    tw = QuantConfig(n_bits=4, group_size=group_size, lwc=True)
    layer, tr = _trainables(dense, stats, jw)
    tlayer = from_jax_params(layer, device="cpu")
    for quantize in (True, False):
        want = _numpy(jllama.effective_block_weights(
            _jax(layer), jw, _jax(tr["lwc"]), _jax(tr["let"]), JCFG,
            quantize=quantize))
        got = _numpy(tllama.effective_block_weights(
            tlayer, tw, _torch(tr["lwc"]), _torch(tr["let"]), TCFG,
            quantize=quantize))
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            key = jax.tree_util.keystr(path)
            if "bias" in key:
                _close(g, w, 1e-6, key)
            else:
                np.testing.assert_array_equal(g, w, key)
    # a scalar of every weight and bias (the shifts reach only the biases)
    rng = np.random.default_rng(5)
    shapes = [np.shape(a) for a in jax.tree.leaves(want)]
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jscalar(t):
        eff = jllama.effective_block_weights(_jax(layer), jw, t["lwc"],
                                             t["let"], JCFG)
        return sum(jnp.sum(a * r)
                   for a, r in zip(jax.tree.leaves(eff), weights))

    jg = jax.jit(jax.grad(jscalar))(_jax(tr))
    ttr = _torch(tr, grad=True)
    eff = tllama.effective_block_weights(tlayer, tw, ttr["lwc"], ttr["let"],
                                         TCFG)
    sum((a * torch.from_numpy(r)).sum()
        for a, r in zip(jax.tree.leaves(eff), weights)).backward()
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(ttr)):
        _close(b.grad, a, GRAD_RTOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("abits,group_size", [(16, 16), (4, None)])
def test_first_step_matches_jax_grad(dense, stats, abits, group_size):
    """A calibration step's loss (the f32 MSE of the block on LET + LWC
    weights, activations quantized at abits, against the fp block's
    output) and its gradient w.r.t. every trainable, against jax.grad:
    loss rtol 1e-5, gradients 2e-5 of each leaf's largest. The q/k scale's
    gradient is zero in exact arithmetic (q . k is invariant under it and
    the STE passes it through the q and k quantizers), so a leaf is held to
    no less than 1e-9 of the largest gradient of any leaf."""
    jw = JQuantConfig(n_bits=4, group_size=group_size, lwc=True)
    tw = QuantConfig(n_bits=4, group_size=group_size, lwc=True)
    layer, tr = _trainables(dense, stats, jw)
    x = np.asarray(dense["embed_tokens"])[np.arange(32) % CFG["vocab_size"]]
    x = x[None].astype(np.float32)
    jmask, pos = j_mask(32, 32), jnp.arange(32)
    y = np.array(jllama.block_forward(_jax(layer), jnp.asarray(x), JCFG,
                                        jmask, pos)[0])
    jspec = JSpec.from_bits(abits)

    def jloss(t):
        eff = jllama.effective_block_weights(_jax(layer), jw, t["lwc"],
                                             t["let"], JCFG)
        out, _ = jllama.block_forward(eff, jnp.asarray(x), JCFG, jmask, pos,
                                      jspec)
        return jnp.mean((out - y) ** 2)

    jv, jg = jax.jit(jax.value_and_grad(jloss))(_jax(tr))
    ttr = _torch(tr, grad=True)
    eff = tllama.effective_block_weights(
        from_jax_params(layer, device="cpu"), tw, ttr["lwc"], ttr["let"],
        TCFG)
    out, _ = tllama.block_forward(eff, torch.from_numpy(x), TCFG,
                                  t_mask(32, 32), torch.arange(32),
                                  TSpec.from_bits(abits))
    loss = (out - torch.from_numpy(y)).pow(2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    largest = max(np.abs(np.asarray(a)).max() for a in jax.tree.leaves(jg))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(ttr)):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.grad.numpy(), a, rtol=0,
            atol=max(2e-5 * np.abs(a).max(), 1e-9 * largest),
            err_msg=jax.tree_util.keystr(path))


def test_block_tap_matches_jax(dense):
    x = np.asarray(dense["embed_tokens"])[None, :24]
    jtap, ttap = {}, {}
    jllama.block_forward(_jax(dense["layers"][0]), jnp.asarray(x), JCFG,
                         tap=jtap)
    tllama.block_forward(from_jax_params(dense["layers"][0], device="cpu"),
                         torch.from_numpy(x), TCFG, tap=ttap)
    assert sorted(ttap) == sorted(jtap) == sorted(tllama.LINEAR_NAMES)
    for k in jtap:
        _close(ttap[k], jtap[k], 1e-5, k)


def test_sample_windows_match_jax():
    corpus = (np.arange(10_000) * 7919 % 32000).astype(np.int32)
    for seed, n, seqlen in ((0, 8, 128), (2, 16, 128), (5, 3, 2048)):
        np.testing.assert_array_equal(
            sample_windows(corpus, n, seed, seqlen),
            j_sample_windows(corpus, n, seed, seqlen))


def test_get_loaders_synthetic_only():
    train, test = get_loaders("synthetic", nsamples=2, seed=1, seqlen=16)
    assert train.shape == (2, 16) and test.shape[0] == 1
    for name in ("wikitext2", "ptb", "c4", "pile", "mix"):
        with pytest.raises(NotImplementedError, match="local copy"):
            get_loaders(name)
    with pytest.raises(ValueError, match="unknown dataset"):
        get_loaders("nope")


def test_checkpoints_cross_both_packages(tmp_path, dense):
    """An omni_parameters-shaped tree (integer layer keys, nested dicts, a
    None) saved by either package loads in the other with equal leaves."""
    tree = {"0": {"let": {"s": np.arange(3, dtype=np.float32)},
                  "lwc": {"q_proj": {"upbound_factor": np.full(
                      (4, 1), 4.0, np.float32)}},
                  "qparams": {"q_proj": {"scale": np.ones((4, 1), np.float32),
                                         "zero": np.zeros((4, 1),
                                                          np.float32)}}},
            "1": {"empty": {}, "none": None, "list": [np.int32(3)]}}
    t_ckpt.save_pytree(str(tmp_path / "port.npz"), _torch(tree))
    j_ckpt.save_pytree(str(tmp_path / "jax.npz"), _jax(tree))
    for got in (j_ckpt.load_pytree(str(tmp_path / "port.npz")),
                t_ckpt.load_pytree(str(tmp_path / "jax.npz")),
                t_ckpt.load_pytree(str(tmp_path / "port.npz"))):
        assert jax.tree.structure(got, is_leaf=lambda a: a is None) == \
            jax.tree.structure(tree, is_leaf=lambda a: a is None)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


def test_from_hf_state_dict_matches_jax():
    rng = np.random.default_rng(2)
    cfg = dict(CFG, num_hidden_layers=1)
    h, i, kv = CFG["hidden_size"], CFG["intermediate_size"], 32
    shapes = {"model.embed_tokens.weight": (CFG["vocab_size"], h),
              "model.norm.weight": (h,), "lm_head.weight": (CFG["vocab_size"],
                                                            h),
              "model.layers.0.input_layernorm.weight": (h,),
              "model.layers.0.post_attention_layernorm.weight": (h,),
              "model.layers.0.self_attn.q_proj.weight": (h, h),
              "model.layers.0.self_attn.q_proj.bias": (h,),
              "model.layers.0.self_attn.k_proj.weight": (kv, h),
              "model.layers.0.self_attn.v_proj.weight": (kv, h),
              "model.layers.0.self_attn.o_proj.weight": (h, h),
              "model.layers.0.mlp.gate_proj.weight": (i, h),
              "model.layers.0.mlp.up_proj.weight": (i, h),
              "model.layers.0.mlp.down_proj.weight": (h, i)}
    sd = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    want = _numpy(jllama.from_hf_state_dict(sd, jllama.LlamaConfig(**cfg)))
    for src in (sd, {k: torch.from_numpy(v).to(torch.bfloat16).float()
                     for k, v in sd.items()}):
        got = _numpy(tllama.from_hf_state_dict(
            src, tllama.LlamaConfig(**cfg), device="cpu"))
        if src is not sd:  # the bf16 round trip, through JAX too
            want = _numpy(jllama.from_hf_state_dict(
                {k: v.numpy() for k, v in src.items()},
                jllama.LlamaConfig(**cfg)))
        assert jax.tree.structure(got, is_leaf=lambda a: a is None) == \
            jax.tree.structure(want, is_leaf=lambda a: a is None)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
