"""The port's tensor-parallel trunk (``parallel/tp_forward.py``,
``make_tp_forward``) against the JAX package's, on the CPU in f32.

The cases are JAX tests/test_tp_packed.py's: the tiny LLaMA packed at tp 2
and 4 and dense at tp 4, an intermediate that must be padded (288 at tp 2),
OPT with biases everywhere and a padded ffn (320) at tp 2 and 4, and
Falcon's three head layouts (the new decoder architecture's grouped kv
heads, multi-query, classic multi-head with ALiBi) at tp 2. The same
numpy-made weights (test_torch_sharding.py's helpers) and inputs go
through both trunks; the outputs agree within 1e-5. The overlap chunks
(2 and 4) give exactly the unchunked result, as in JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.parallel import make_mesh as j_make_mesh
from omniquant_tpu.parallel import tp_forward as jtpf
from omniquant_tpu_torch.parallel import make_mesh
from omniquant_tpu_torch.parallel import tp_forward as tpf

from test_torch_sharding import (  # noqa: F401
    cpu_mesh, family_of, one_torch_thread, packed, tiny)

TOL = 1e-5
# (model, packed?, tp)
CASES = [("llama", True, 2), ("llama", True, 4), ("llama", False, 4),
         ("llama_pad", True, 2), ("opt", True, 2), ("opt", True, 4),
         ("falcon_new", True, 2), ("falcon_mqa", True, 2),
         ("falcon_alibi", True, 2)]
_PORT = {}


def port_trunk(name, is_packed, tp, chunks=1):
    """The port's trunk on the tiny model and its placed layers, cached."""
    key = (name, is_packed, tp, chunks)
    if key not in _PORT:
        tc, tparams = tiny(name)[1], tiny(name)[3]
        if is_packed:
            tparams = packed(name, tile_k=None if name == "llama_pad"
                             else 64)[1]
        make_fwd, shard_block = tpf.make_tp_forward(
            family_of(name), cpu_mesh(tp), tc, overlap_chunks=chunks)
        layers = [shard_block(b) for b in tparams["layers"]]
        _PORT[key] = (make_fwd(layers), layers)
    return _PORT[key]


def inputs(name, seed):
    hidden = tiny(name)[1].hidden_size
    return np.random.default_rng(seed).standard_normal(
        (2, 8, hidden)).astype(np.float32)


@pytest.mark.parametrize("name,is_packed,tp", CASES)
def test_tp_trunk_matches_jax(name, is_packed, tp):
    jc, _, jparams, _ = tiny(name)
    if is_packed:
        jparams = packed(name, tile_k=None if name == "llama_pad" else 64)[0]
    make_fwd, shard_block = jtpf.make_tp_forward(
        family_of(name), j_make_mesh(dp=1, tp=tp), jc)
    jlayers = [shard_block(b) for b in jparams["layers"]]
    x = inputs(name, tp)
    want = np.asarray(make_fwd(jlayers)(jlayers, jnp.asarray(x)))
    fwd, layers = port_trunk(name, is_packed, tp)
    got = fwd(layers, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if name == "llama_pad":  # 288 padded to 512: 256 a shard, tiles of 256
        down = layers[0][0]["down_proj"]
        assert layers[0][0]["gate_proj"].out_features == 256
        assert (down.in_features, down.tile_k) == (256, 256)


def test_tp_trunk_on_dp_rows_matches_jax():
    """A (2, 2) mesh: each row splits over tp 2 and the rows are replicas
    (JAX's trunk shards over the "tp" axis alone): the (1, 2) trunk's
    output bit for bit, and JAX's at (2, 2) within TOL."""
    jc, tc = tiny("llama")[:2]
    jpk, tpk = packed("llama", tile_k=64)
    make_fwd, shard_block = jtpf.make_tp_forward(
        "llama", j_make_mesh(dp=2, tp=2), jc)
    jlayers = [shard_block(b) for b in jpk["layers"]]
    x = inputs("llama", 5)
    want = np.asarray(make_fwd(jlayers)(jlayers, jnp.asarray(x)))
    make_fwd, shard_block = tpf.make_tp_forward(
        "llama", make_mesh(dp=2, tp=2, devices=["cpu"] * 4), tc)
    layers = [shard_block(b) for b in tpk["layers"]]
    assert layers[0][3]["o_proj"].in_features == 128
    got = make_fwd(layers)(layers, torch.from_numpy(x)).numpy()
    fwd, one = port_trunk("llama", True, 2)
    assert np.array_equal(got, fwd(one, torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("name,is_packed", [("llama", True),
                                            ("opt", True), ("llama", False)])
def test_overlap_chunks_equal_unchunked(name, is_packed, chunks):
    """Each column-parallel site split into (matmul -> all-reduce) chunks:
    the result is the unchunked trunk's, exactly."""
    x = torch.from_numpy(inputs(name, 7))
    fwd1, layers = port_trunk(name, is_packed, 2)
    fwdc, _ = port_trunk(name, is_packed, 2, chunks)
    assert torch.equal(fwdc(layers, x), fwd1(layers, x))


def test_effective_overlap_chunks_matches_jax():
    for n in (128, 256, 384, 1024, 4096, 5120):
        for c in (1, 2, 3, 4, 8):
            assert tpf.effective_overlap_chunks(n, c) == \
                jtpf.effective_overlap_chunks(n, c)
