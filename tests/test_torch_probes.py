"""The Hopper probes' plain versions (``omniquant_tpu_torch/kernels/
probes.py``, S1-S4) and their drivers against the Pallas kernels of the JAX
package's experiment scripts, run in interpret mode on the CPU.

Each script module is loaded from ``scripts/`` by path; its size constants
are set small with ``monkeypatch`` and its ``pl.pallas_call`` made an
interpreting one, so nothing under ``scripts/`` changes. S1's and S2's
``run`` also time, so their ``pallas_call`` is built here from the script's
kernel body, wired as ``run`` wires it. Inputs come from numpy's generator;
the packs are JAX's, handed to the port as they are.

Tolerances: S2 int8 exact (s32 sums of integers, cast to f32 in both); S2
bf16 1e-6 of the largest |value| (64 f32 sums of one product, in another
order: 1.5e-7 measured, so tighter than the card's 1e-5); S1 (every mode), S3 and S4 1e-2 of the largest |value| (both round
an f32 sum to bf16 once, a rounding step of 2^-8 relative at most, 2^-9
measured for S3 and S4 in these shapes).
"""
import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omniquant_tpu.quant import QuantConfig as JQuantConfig
from omniquant_tpu.quant import pack_weight as j_pack_weight
from omniquant_tpu_torch.kernels import probes
from omniquant_tpu_torch.quant.packing import PackedWeight
from omniquant_tpu_torch.scripts import (exp_ablate_int, exp_ablate_kernel,
                                         exp_mxu_rates, exp_unpack_variants)

REPO = pathlib.Path(__file__).resolve().parent.parent
BF16_OUT_TOL = 1e-2
S2_BF16_TOL = 1e-6


SCRIPTS = ("exp_ablate_int", "exp_mxu_rates", "exp_unpack_variants",
           "exp_ablate_kernel")


def _script(name):
    """The JAX script ``scripts/<name>.py`` as a module, loaded by path.
    Each script puts a path of its own first on ``sys.path`` when it is
    imported; the load puts ``sys.path`` back as it was, so that nothing
    imported later in the process resolves outside this checkout."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_load_leaves_sys_path(name):
    before = list(sys.path)
    _script(name)
    assert sys.path == before


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _port_pack(jpw) -> PackedWeight:
    return PackedWeight(qweight=_t(jpw.qweight), scales=_t(jpw.scales),
                        zeros=_t(jpw.zeros), bias=None, bits=jpw.bits,
                        group_size=jpw.group_size,
                        in_features=jpw.in_features,
                        out_features=jpw.out_features, tile_k=jpw.tile_k,
                        layout=jpw.layout)


# ---------------------------------------------------------------------------
# S4

@pytest.mark.parametrize("n_dots", [4, 1])
def test_consume_matches_the_script(monkeypatch, interpret, n_dots):
    mod = _script("exp_ablate_int")
    M, K, N, BK = 16, 256, 128, 256
    for k, v in dict(M=M, K=K, N=N, BM=16, BN=128, BK=BK).items():
        monkeypatch.setattr(mod, k, v)
    rng = np.random.default_rng(7)
    xc = rng.integers(-8, 8, (M, K)).astype(np.int8)
    w8 = rng.integers(-8, 8, (K, N)).astype(np.int8)
    slabs = np.zeros((K // BK, 8, N), np.float32)
    slabs[:, :4] = rng.uniform(0.01, 0.1, (K // BK, 4, N))
    want = mod.consume(jnp.asarray(xc), jnp.asarray(w8), jnp.asarray(slabs),
                       n_dots)
    got = probes.consume(_t(xc), _t(w8), _t(slabs), n_dots)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(_bf16(got), want.astype(jnp.float32)) <= BF16_OUT_TOL
    # and the f32 algebra: one 256-row dot at n_dots 1, four of 64 at 4
    gs = BK // n_dots
    f32 = sum((xc[:, g * gs:(g + 1) * gs].astype(np.float32)
               @ w8[g * gs:(g + 1) * gs].astype(np.float32)) * slabs[0, g]
              for g in range(n_dots))
    assert _rel(_bf16(got), f32) <= BF16_OUT_TOL


def test_consume_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="does not split"):
        probes.consume(torch.zeros(4, 256, dtype=torch.int8),
                       torch.zeros(256, 128, dtype=torch.int8),
                       torch.zeros(1, 8, 128), 3)


# ---------------------------------------------------------------------------
# S2

def _mxu_call(mod, kern, x, w, grid):
    n = mod.N
    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((mod.M, n), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), grid=grid)(x, w)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_mxu_rate_matches_the_script(monkeypatch, interpret, dtype):
    mod = _script("exp_mxu_rates")
    M = N = KK = 64
    inner = 3
    for k, v in dict(M=M, N=N, KK=KK, INNER=inner).items():
        monkeypatch.setattr(mod, k, v)
    rng = np.random.default_rng(3)
    if dtype == "bf16":
        x = rng.standard_normal((M, KK)).astype(np.float32)
        w = rng.standard_normal((KK, N)).astype(np.float32)
        jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        tw = torch.from_numpy(w).to(torch.bfloat16)
        kern, fn = mod.kern_bf16, probes.mxu_rate_bf16
    else:
        x = rng.integers(-16, 16, (M, KK)).astype(np.int8)
        w = rng.integers(-8, 8, (KK, N)).astype(np.int8)
        jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), _t(x), _t(w)
        kern, fn = mod.kern_i8, probes.mxu_rate_int8
    want = np.asarray(_mxu_call(mod, kern, jx, jw, (2,)))
    got = fn(tx, tw, inner, 4)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _rel(got.numpy(), want) <= S2_BF16_TOL
    with pytest.raises(ValueError, match="takes"):
        fn(tx.float(), tw.float(), inner, 4)


# ---------------------------------------------------------------------------
# S3

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_f32inj_matches_the_script(monkeypatch, interpret, bits):
    mod = _script("exp_unpack_variants")
    M, K, N = 8, 512, 256
    monkeypatch.setattr(mod, "M", M)
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.02
    x = rng.standard_normal((M, K)).astype(np.float32)
    jpw = j_pack_weight(jnp.asarray(w), JQuantConfig(n_bits=bits,
                                                     group_size=128))
    jx = jnp.asarray(x, jnp.bfloat16)
    want = mod.make_call(jpw, bn=128)(jx)
    pw = _port_pack(jpw)
    sc2, off2 = probes.f32inj_slabs(pw)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = probes.f32inj_matmul(tx, pw.qweight, sc2, off2, bits, pw.tile_k,
                               pw.group_size)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(_bf16(got), want.astype(jnp.float32)) <= BF16_OUT_TOL
    # x @ dequant(W): the script's own check
    ref = mod.quant_matmul_reference(jx.astype(jnp.float32), jpw)
    assert _rel(_bf16(got), ref) <= BF16_OUT_TOL


def test_f32inj_refuses_three_bits():
    rng = np.random.default_rng(0)
    jpw = j_pack_weight(jnp.asarray(rng.standard_normal((128, 512)),
                                    jnp.float32),
                        JQuantConfig(n_bits=3, group_size=128))
    pw = _port_pack(jpw)
    with pytest.raises(ValueError, match="power-of-two"):
        probes.f32inj_slabs(pw)
    with pytest.raises(ValueError, match="power-of-two"):
        probes.f32inj_matmul(torch.zeros(8, 512, dtype=torch.bfloat16),
                             pw.qweight, None, None, 3, pw.tile_k, 128)


# ---------------------------------------------------------------------------
# S1

def _ablate_call(mod, mode, jpw, x, bn):
    """The script's run(mode, pw, x, bn), without the chain and the
    timing."""
    bits, bk = jpw.bits, jpw.tile_k
    k_pad = jpw.qweight.shape[0] * 32 // bits
    n = jpw.qweight.shape[1]
    nk, n_g = k_pad // bk, bk // jpw.group_size
    ngp = -(-n_g // 8) * 8
    sc = jpw.scales.T.astype(jnp.float32)
    if sc.shape[0] < nk * n_g:
        sc = jnp.concatenate(
            [sc, jnp.repeat(sc[-1:], nk * n_g - sc.shape[0], 0)])
    sc = jnp.pad(sc.reshape(nk, n_g, n), ((0, 0), (0, ngp - n_g), (0, 0)))
    kfn = functools.partial(mod._kernel, mode, bits=bits, bk=bk, bn=bn,
                            gs_rows=jpw.group_size)
    m = x.shape[0]
    return pl.pallas_call(
        kfn, grid=(1, n // bn, nk),
        in_specs=[
            pl.BlockSpec((m, bk), lambda im, i, j: (im, j),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((mod.words_per_rows(bits, bk), bn),
                         lambda im, i, j: (j, i), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, ngp, bn), lambda im, i, j: (j, 0, i),
                         memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((m, bn), lambda im, i, j: (im, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((m, bn), jnp.float32)],
    )(x, jpw.qweight, sc)


@pytest.fixture(scope="module")
def ablate_inputs():
    rng = np.random.default_rng(11)
    M, K, N = 8, 1024, 256
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.02
    packs = {b: j_pack_weight(jnp.asarray(w),
                              JQuantConfig(n_bits=b, group_size=128))
             for b in (4, 2)}
    return x, packs


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("mode", ["full", "noup", "nodot"])
def test_ablate_decode_matches_the_script(interpret, ablate_inputs, bits,
                                          mode):
    mod = _script("exp_ablate_kernel")
    x, packs = ablate_inputs
    jpw = packs[bits]
    bn = 128
    jx = jnp.asarray(x, jnp.bfloat16)
    want = _ablate_call(mod, mode, jpw, jx, bn)
    pw = _port_pack(jpw)
    got = probes.ablate_decode(mode, torch.from_numpy(x).to(torch.bfloat16),
                               pw.qweight, probes.ablate_slabs(pw), bits,
                               pw.tile_k, pw.group_size, bn)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(_bf16(got), want.astype(jnp.float32)) <= BF16_OUT_TOL


def test_ablate_noup_refuses_bn_past_bk(interpret, ablate_inputs):
    """noup broadcasts x[0:1, :bn] to (bk, bn): past bk = 512 the script's
    kernel fails, and the port refuses."""
    mod = _script("exp_ablate_kernel")
    x, packs = ablate_inputs
    rng = np.random.default_rng(1)
    jpw = j_pack_weight(jnp.asarray(rng.standard_normal((1024, 512)),
                                    jnp.float32),
                        JQuantConfig(n_bits=4, group_size=128))
    jx = jnp.asarray(x[:, :512], jnp.bfloat16)
    with pytest.raises(Exception):
        _ablate_call(mod, "noup", jpw, jx, 1024)
    pw = _port_pack(jpw)
    with pytest.raises(ValueError, match="needs bn <= bk"):
        probes.ablate_decode("noup", torch.zeros(8, 512, dtype=torch.bfloat16),
                             pw.qweight, probes.ablate_slabs(pw), 4,
                             pw.tile_k, 128, 1024)


# ---------------------------------------------------------------------------
# the drivers, on the CPU at small shapes: every row runs its probe (no
# device time), and the probe rows equal the plain versions above

def test_drivers_run_every_probe_on_the_cpu():
    from omniquant_tpu_torch.kernels import launch_counts

    s4 = exp_ablate_int.run("cpu", m=16, k=512, n=256, n_chain=1)
    assert [r[0] for r in s4] == ["bf16-pairs", "int-fused", "i8dense-g",
                                  "i8dense-1dot"]
    assert all(r[1] is None for r in s4)
    # i8dense-g: xc . (w8 times each row's group scale), one f32 product
    ops = exp_ablate_int.operands("cpu", m=16, k=512, n=256)
    scale_rows = ops["slabs"][:, :4].repeat_interleave(128, 1).reshape(512,
                                                                      256)
    f32 = ops["xc"].float() @ (ops["w8"].float() * scale_rows)
    assert _rel(_bf16(s4[2][2]), f32.numpy()) <= BF16_OUT_TOL
    s2 = exp_mxu_rates.run("cpu", m=64, n=128, inner=2, repeats=4, reps=1)
    assert [r[0] for r in s2] == ["bf16", "int8"]
    s3 = exp_unpack_variants.run("cpu", m=8, k=512, n=512, n_chain=1)
    assert [r[0] for r in s3] == ["w4 cur", "w4 f32inj", "w2 cur",
                                  "w2 f32inj", "w3 cur", "w8 cur",
                                  "w8 f32inj"]
    assert all(r[3] <= BF16_OUT_TOL for r in s3 if r[3] is not None)
    s1 = exp_ablate_kernel.run("cpu", m=8, k=1024, n=1024, n_chain=1,
                               bn=1024)
    labels = [r[0] for r in s1]
    assert labels == ["w4 full", "w4 noup", "w4 nodot", "w4 noup bn 512",
                      "w2 full", "w2 noup", "w2 nodot", "w2 noup bn 512",
                      "dense bf16"]
    assert isinstance(s1[1][2], ValueError)
    # on the CPU no kernel launches
    assert all(v == 0 for v in launch_counts().values())
