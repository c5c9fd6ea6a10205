"""Sequence-parallel (SP) calibration of the port (``calibrate(...,
sp_mesh=...)``, the ``attn_impl`` hook of the LLaMA and OPT blocks, and
``parallel.SPMesh``) against the JAX package's, on the CPU in f32.

- One LLaMA block (GQA: 4 query heads on 2 kv heads) and one OPT block (q
  pre-scaled, so the ring runs at sm_scale 1.0), run as 4 shard programs
  whose attention is the port's ring (both implementations), against JAX's
  ``shard_map`` forward over 4 devices of the conftest's CPU mesh with its
  "jnp" ring, within 2e-5, and against the dense block.
- ``calibrate(..., sp_mesh=...)`` against JAX's ``calibrate(...,
  sp_mesh=Mesh)`` on the same weights and windows (LLaMA GQA at sp 4, W4A16
  g16 LWC, 2 layers; OPT at sp 2, W4A16 g16 LWC + LET, 1 layer; 1 epoch of
  2 windows of 256 tokens): per-epoch losses, LWC and LET trainables and
  folded weights at the tolerances in SP_RUNS (measured, then a margin).
- the port's SP run against its own single-device run (both rings, and
  aug_loss), at f32 noise.
- the refusals JAX asserts: Falcon, and a seqlen that does not split.

JAX's runs are computed once per configuration (``functools.cache``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from omniquant_tpu.calib import CalibConfig as JCalibConfig
from omniquant_tpu.calib import calibrate as j_calibrate
from omniquant_tpu.models import get_family as j_get_family
from omniquant_tpu.parallel.ring_attention import ring_attention_local
from omniquant_tpu_torch.calib import CalibConfig, calibrate
from omniquant_tpu_torch.models import get_family
from omniquant_tpu_torch.models.common import attention_core, causal_mask
from omniquant_tpu_torch.parallel import SPMesh
from omniquant_tpu_torch.utils import from_jax_params

CONFIGS = {
    "llama": dict(vocab_size=64, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=512),
    "opt": dict(vocab_size=64, hidden_size=64, ffn_dim=128,
                num_hidden_layers=1, num_attention_heads=4,
                max_position_embeddings=512),
}
NSAMPLES, SEQLEN = 2, 256
TOL = 2e-5
# name -> (family, sp, CalibConfig keywords, tolerances against JAX's SP
# run), each with the largest gap measured when it was set: loss relative
# (llama 2.6e-7, opt 7.2e-8), trainables absolute (llama 2.4e-7, opt
# 6.1e-7), folded weights absolute (llama 1.5e-8, opt 8.9e-8)
SP_RUNS = {
    "llama_gqa_sp4_lwc": ("llama", 4, dict(wbits=4, abits=16, group_size=16,
                                           lwc=True),
                          dict(loss=5e-6, train=1e-5, weight=1e-6)),
    "opt_sp2_lwc_let": ("opt", 2, dict(wbits=4, abits=16, group_size=16,
                                       lwc=True, let=True),
                        dict(loss=5e-6, train=1e-5, weight=1e-6)),
}
# the port's SP run against its own single-device run: loss relative,
# trainables and folded weights absolute (largest measured: loss 1.8e-7,
# trainables 2.4e-7, folded weights 0)
ONE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_cli.py (tiny ops under the
    suite's parallel workers); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@functools.cache
def _model(name, seed=0):
    """JAX's init_params of the config, as numpy."""
    fam = j_get_family(name)
    cfg = fam.config_cls(**CONFIGS[name])
    return _np(fam.init_params(jax.random.PRNGKey(seed), cfg))


def _tokens(name):
    return np.random.default_rng(7).integers(
        0, CONFIGS[name]["vocab_size"], (NSAMPLES, SEQLEN)).astype(np.int32)


# ---------------------------------------------------------------------------
# block forwards through the hook
@functools.cache
def _jax_sp_block(name, sp):
    """JAX's block 0 under shard_map over sp devices, its attention the
    "jnp" ring (as tests/test_sp_calibration.py runs it)."""
    fam = j_get_family(name)
    cfg = fam.config_cls(**CONFIGS[name])
    layer = jax.tree.map(jnp.asarray, _model(name)["layers"][0])
    x = (np.random.default_rng(3).standard_normal(
        (1, SEQLEN, cfg.hidden_size)) * 0.5).astype(np.float32)
    s_local = SEQLEN // sp
    sm_scale = 1.0 if name == "opt" else None

    def inner(layer, x_l):
        pos = jax.lax.axis_index("sp") * s_local + jnp.arange(s_local)

        def attn(q, k, v, spec_):
            return ring_attention_local(q, k, v, axis="sp", n=sp,
                                        sm_scale=sm_scale, impl="jnp")

        y, _ = fam.block_forward(layer, x_l, cfg, None, pos, attn_impl=attn)
        return y

    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    # under jit: shard_map outside it dispatches op by op (~1 min here)
    got = jax.jit(shard_map(inner, mesh=mesh,
                            in_specs=(jax.tree.map(lambda a: P(), layer),
                                      P(None, "sp", None)),
                            out_specs=P(None, "sp", None), check_vma=False))(
                                layer, jnp.asarray(x))
    return x, np.asarray(got)


def _port_sp_block(name, layer, x, sp, impl):
    """The port's block as sp shard programs on an SPMesh of CPUs."""
    fam = get_family(name)
    cfg = fam.config_cls(**CONFIGS[name])
    mesh = SPMesh(["cpu"] * sp)
    s_local = x.shape[1] // sp
    sm_scale = 1.0 if name == "opt" else None

    def shard(p, x_p):
        def attn(q, k, v, spec_):
            return mesh.ring_attention(p, q, k, v, sm_scale=sm_scale,
                                       impl=impl)

        pos = torch.arange(p * s_local, (p + 1) * s_local)
        y, _ = fam.block_forward(layer, x_p, cfg, None, pos, attn_impl=attn)
        return y

    return torch.cat(mesh.run(shard, x.chunk(sp, dim=1)), dim=1)


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("name", ["llama", "opt"])
def test_block_forward_through_the_hook_matches_jax_shard_map(name, impl):
    x, want = _jax_sp_block(name, 4)
    fam = get_family(name)
    cfg = fam.config_cls(**CONFIGS[name])
    layer = from_jax_params(_model(name), device="cpu")["layers"][0]
    got = _port_sp_block(name, layer, torch.from_numpy(x), 4, impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    dense, _ = fam.block_forward(layer, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=TOL,
                               atol=TOL)


def test_hook_default_leaves_the_block_as_it_was():
    """attn_impl=None is the dense block, bit for bit, and a hook sees
    LLaMA's k/v repeated to the query heads and OPT's q pre-scaled."""
    for name in ("llama", "opt"):
        fam = get_family(name)
        cfg = fam.config_cls(**CONFIGS[name])
        layer = from_jax_params(_model(name), device="cpu")["layers"][0]
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (1, 32, cfg.hidden_size)).astype(np.float32))
        seen = []

        def hook(q, k, v, spec_):
            seen.append((q.shape, k.shape))
            return attention_core(
                q, k, v, causal_mask(32, 32),
                1.0 if name == "opt" else 1.0 / cfg.head_dim ** 0.5, spec_)

        y0, _ = fam.block_forward(layer, x, cfg)
        y1, _ = fam.block_forward(layer, x, cfg, attn_impl=hook)
        assert torch.equal(y0, y1)
        heads = cfg.num_attention_heads
        assert seen == [((1, heads, 32, cfg.head_dim),) * 2]


# ---------------------------------------------------------------------------
# calibration
@functools.cache
def _jax_sp_run(run):
    name, sp, kw, _ = SP_RUNS[run]
    fam = j_get_family(name)
    cfg = fam.config_cls(**CONFIGS[name])
    cc = JCalibConfig(epochs=1, nsamples=NSAMPLES, batch_size=1, **kw)
    params = jax.tree.map(lambda a: None if a is None else jnp.array(a),
                          _model(name), is_leaf=lambda a: a is None)
    losses = []
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    params, omni = j_calibrate(
        fam, params, cfg, jnp.asarray(_tokens(name)), cc, sp_mesh=mesh,
        progress_cb=lambda i, e, l: losses.append(l))
    return _np(params), _np(omni), losses


def _port_run(name, kw, sp_mesh=None, impl=None, epochs=1, **extra):
    fam = get_family(name)
    cfg = fam.config_cls(**CONFIGS[name])
    cc = CalibConfig(epochs=epochs, nsamples=NSAMPLES, batch_size=1, **kw,
                     **extra)
    losses = []
    params, omni = calibrate(
        fam, from_jax_params(_model(name), device="cpu"), cfg,
        _tokens(name), cc, progress_cb=lambda i, e, l: losses.append(l),
        device="cpu", sp_mesh=sp_mesh, sp_attn_impl=impl)
    return params, omni, losses


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if tree is None:
        return {}
    return {prefix: np.asarray(tree.detach().cpu() if torch.is_tensor(tree)
                               else tree, dtype=np.float64)}


def _held(got, want, atol, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    worst = max(np.abs(g[k] - w[k]).max() for k in g)
    assert worst <= atol, (what, worst)


@pytest.mark.parametrize("run", list(SP_RUNS))
def test_sp_calibration_matches_jax_sp_calibration(run):
    name, sp, kw, tol = SP_RUNS[run]
    j_params, j_omni, j_losses = _jax_sp_run(run)
    params, omni, losses = _port_run(name, kw, ["cpu"] * sp)
    np.testing.assert_allclose(losses, j_losses, rtol=tol["loss"], atol=0)
    for i in range(CONFIGS[name]["num_hidden_layers"]):
        for group in ("lwc", "let"):
            if group in j_omni[i]:
                _held(omni[i][group], j_omni[i][group], tol["train"],
                      f"layer {i} {group}")
        _held({n: params["layers"][i][n]["weight"]
               for n in get_family(name).linear_names},
              {n: j_params["layers"][i][n]["weight"]
               for n in get_family(name).linear_names}, tol["weight"],
              f"layer {i} folded weights")


@pytest.mark.parametrize("impl,aug_loss", [("plain", False),
                                           ("flash", False),
                                           ("plain", True)])
def test_sp_calibration_matches_the_single_device_run(impl, aug_loss):
    """The port at sp 4 (the capture passes on ``impl``'s ring) against its
    own run without sp_mesh, LLaMA GQA, 2 epochs: losses, trainables and
    folded weights within ONE_TOL (f32 noise: only the order of the
    attention sums differs)."""
    kw = dict(wbits=4, abits=16, group_size=16, lwc=True)
    one = _port_run("llama", kw, epochs=2, aug_loss=aug_loss)
    sp = _port_run("llama", kw, ["cpu"] * 4, impl, epochs=2,
                   aug_loss=aug_loss)
    np.testing.assert_allclose(sp[2], one[2], rtol=ONE_TOL, atol=0)
    for i in range(2):
        _held(sp[1][i]["lwc"], one[1][i]["lwc"], ONE_TOL, f"layer {i} lwc")
        _held({n: sp[0]["layers"][i][n]["weight"] for n in ("q_proj",
                                                             "down_proj")},
              {n: one[0]["layers"][i][n]["weight"] for n in ("q_proj",
                                                             "down_proj")},
              ONE_TOL, f"layer {i} folded")


def test_sp_refusals_match_jax():
    """Falcon and a seqlen that does not split into the shards: JAX's
    calibrate asserts, the port raises ValueError with the same reason."""
    kw = dict(wbits=4, abits=16, group_size=16, lwc=True)
    jfam = j_get_family("tiny-falcon")
    fam = get_family("tiny-falcon")
    from omniquant_tpu_torch.cli import TINY_CONFIGS
    jcfg = jfam.config_cls(**TINY_CONFIGS["tiny-falcon"])
    cfg = fam.config_cls(**TINY_CONFIGS["tiny-falcon"])
    jparams = _np(jfam.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.zeros((NSAMPLES, 64), np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    with pytest.raises(AssertionError, match="supports llama and opt"):
        j_calibrate(jfam, jax.tree.map(jnp.asarray, jparams), jcfg,
                    jnp.asarray(tokens), JCalibConfig(
                        epochs=1, nsamples=NSAMPLES, **kw), sp_mesh=mesh)
    with pytest.raises(ValueError, match="supports llama and opt"):
        calibrate(fam, from_jax_params(jparams, device="cpu"), cfg, tokens,
                  CalibConfig(epochs=1, nsamples=NSAMPLES, **kw),
                  device="cpu", sp_mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not split"):
        _port_run("llama", kw, ["cpu"] * 3)
    mesh3 = Mesh(np.asarray(jax.devices()[:3]), ("sp",))
    jfam = j_get_family("llama")
    with pytest.raises(AssertionError):
        j_calibrate(jfam, jax.tree.map(jnp.asarray, _model("llama")),
                    jfam.config_cls(**CONFIGS["llama"]),
                    jnp.asarray(_tokens("llama")), JCalibConfig(
                        epochs=1, nsamples=NSAMPLES, **kw), sp_mesh=mesh3)


def test_sp_calibration_resumes_and_offloads_as_the_single_device_run(
        tmp_path):
    """The rest of calibrate is unchanged under sp_mesh: offload_layers
    gives the same fold, and the npz it writes resumes (epochs=0) to the
    same fold."""
    kw = dict(wbits=4, abits=16, group_size=16, lwc=True)
    sp = _port_run("llama", kw, ["cpu"] * 2, output_dir=str(tmp_path))
    off = _port_run("llama", kw, ["cpu"] * 2, offload_layers=True)
    res = _port_run("llama", kw, ["cpu"] * 2, epochs=0,
                    resume=str(tmp_path / "omni_parameters.npz"))
    for other in (off, res):
        _held({f"{i}/{n}": other[0]["layers"][i][n]["weight"]
               for i in range(2) for n in ("q_proj", "down_proj")},
              {f"{i}/{n}": sp[0]["layers"][i][n]["weight"]
               for i in range(2) for n in ("q_proj", "down_proj")}, 0.0,
              "fold")
