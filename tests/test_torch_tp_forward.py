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

With activation quantizers (W4A4 / W6A6, ``ActQuantSpec.from_bits``):
``tp_act_quant`` on a feature-split tensor is the unsplit quantizer bit for
bit (a shard-local range is not); in the trunk, every split site's
quantized input, gathered, is the unsplit quantizer of its gathered input
bit for bit; the trunk on dense fake-quant weights is JAX's family forward
with the spec (its blocks chained) within ACT_TOL; and on packed weights
(the integer route at the row-parallel sites: K7's plain version, or K8 +
K9's with the dense route lowered to 16 rows) the perplexity of the TP
model forward is the single-device packed model's within PACKED_PPL_RTOL.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import get_family as j_get_family
from omniquant_tpu.models.common import ActQuantSpec as JActQuantSpec
from omniquant_tpu.parallel import make_mesh as j_make_mesh
from omniquant_tpu.parallel import tp_forward as jtpf
from omniquant_tpu_torch.eval import evaluate_ppl
from omniquant_tpu_torch.models import get_family
from omniquant_tpu_torch.models.common import ActQuantSpec
from omniquant_tpu_torch.parallel import make_mesh
from omniquant_tpu_torch.parallel import tp_forward as tpf
from omniquant_tpu_torch.quant import QuantConfig
from omniquant_tpu_torch.quant.quantizer import fake_quant_act

from test_torch_sharding import (  # noqa: F401
    cpu_mesh, family_of, one_torch_thread, packed, tiny)

TOL = 1e-5
# the trunk with W4A4 activation quantizers against JAX's family forward
# with the same spec, on dense weights, f32 (measured: llama 2.4e-7, opt
# 4.8e-7, falcon_mqa 6.0e-7; a code that f32 noise moves a step would show
# as ~1e-3, as the port's own single-device forward shows against JAX's at
# W6A6 on falcon_mqa)
ACT_TOL = 5e-5
# the packed TP model's perplexity against the single-device packed
# model's at W4A4 (measured: equal, both routes)
PACKED_PPL_RTOL = 1e-5
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


# ---------------------------------------------------------------------------
# activation quantizers


def _split_run(tp, x, fn):
    """``fn(mesh, p, part)`` on each of tp shards of x split over its last
    axis; the parts' results joined again."""
    mesh = cpu_mesh(tp)
    parts = list(x.chunk(tp, dim=-1))
    return torch.cat(mesh.run(lambda p, part: fn(mesh, p, part), parts),
                     dim=-1)


@pytest.mark.parametrize("bits", [4, 6])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_act_quant_is_the_unsplit_quantizer(tp, bits):
    """Per-token ranges all-reduced over the shards: bit for bit the
    quantizer of the whole row; with shard-local ranges (the planted
    fault) the rows differ."""
    rng = np.random.default_rng(tp * 10 + bits)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    x[:, :, 7] *= 20  # an outlier channel on shard 0 only
    x = torch.from_numpy(x)
    cfg = QuantConfig(n_bits=bits, symmetric=False)
    want = fake_quant_act(x, cfg)
    got = _split_run(tp, x, lambda m, p, part: tpf.tp_act_quant(m, p, part,
                                                                cfg))
    assert torch.equal(got, want)
    local = _split_run(tp, x, lambda m, p, part: fake_quant_act(part, cfg))
    assert not torch.equal(local, want)
    with pytest.raises(NotImplementedError, match="straddle"):
        _split_run(tp, x, lambda m, p, part: tpf.tp_act_quant(
            m, p, part, QuantConfig(n_bits=4, group_size=64)))


def _jax_chain(name, x, spec_bits):
    """JAX's family block_forward with ActQuantSpec.from_bits chained over
    the tiny model's (dense) layers, as its evaluate_ppl runs them."""
    jc, _, jparams, _ = tiny(name)
    fam = j_get_family(family_of(name))
    h = jnp.asarray(x)
    spec = JActQuantSpec.from_bits(spec_bits)
    for layer in jparams["layers"]:
        h, _ = fam.block_forward(layer, h, jc, None, None, spec)
    return np.asarray(h)


@pytest.mark.parametrize("name", ["llama", "opt", "falcon_mqa"])
def test_tp_trunk_quantized_inputs_are_the_unsplit_quantizer(
        name, monkeypatch):
    """W4A4 through the trunk at tp 2 on dense weights: every split site's
    quantized input (o/down, out_proj/fc2 and OPT's q/k/v, dense/
    dense_4h_to_h), gathered over the shards, is the unsplit quantizer of
    its gathered input bit for bit; the output is JAX's family forward with
    the spec within ACT_TOL."""
    spec = ActQuantSpec.from_bits(4)
    _, tc, _, tparams = tiny(name)
    seen = {0: [], 1: []}
    real = tpf.tp_act_quant

    def record(mesh, p, x, qcfg):
        y = real(mesh, p, x, qcfg)
        if qcfg is not None and qcfg.enabled and qcfg.metric == "minmax":
            seen[p].append((x, y, qcfg))
        return y

    monkeypatch.setattr(tpf, "tp_act_quant", record)
    make_fwd, shard_block = tpf.make_tp_forward(
        family_of(name), cpu_mesh(2), tc, spec=spec)
    layers = [shard_block(b) for b in tparams["layers"]]
    x = inputs(name, 11)
    got = make_fwd(layers)(layers, torch.from_numpy(x))
    sites = {"llama": 2, "opt": 5, "falcon": 2}[family_of(name)]
    assert len(seen[0]) == len(seen[1]) == sites * len(layers)
    for (x0, y0, cfg), (x1, y1, _) in zip(seen[0], seen[1]):
        whole = fake_quant_act(torch.cat([x0, x1], dim=-1), cfg)
        assert torch.equal(torch.cat([y0, y1], dim=-1), whole)
    want = _jax_chain(name, x, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=ACT_TOL, atol=ACT_TOL)


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_packed_tp_perplexity_matches_the_single_device(route, monkeypatch):
    """--real_quant's W4A4 perplexity under TP: the tiny LLaMA packed
    planar (K7's route at the row-parallel sites; "dense": K8 + K9's, its
    threshold lowered to 16 rows) scored by make_tp_model_forward at tp 2
    against evaluate_ppl of the single-device packed model, within
    PACKED_PPL_RTOL."""
    from omniquant_tpu_torch.kernels import quant_matmul as qmm
    from omniquant_tpu_torch.models import LLAMA
    from omniquant_tpu_torch.serving import pack_model

    if route == "dense":
        monkeypatch.setattr(qmm, "_INT_DENSE_MIN_M", 16)
    _, tc, _, tparams = tiny("llama")
    wcfg = QuantConfig(n_bits=4)
    fq = dict(tparams, layers=[LLAMA.effective_block_weights(b, wcfg, None,
                                                             None, tc)
                               for b in tparams["layers"]])
    pk = pack_model(LLAMA, fq, wcfg, layout="planar", device="cpu")
    spec = ActQuantSpec.from_bits(4)
    tokens = np.random.default_rng(3).integers(0, tc.vocab_size, (1, 96))
    routes = []
    real = qmm.int_route

    def spy(m, pw, act):
        routes.append(real(m, pw, act))
        return routes[-1]

    monkeypatch.setattr(qmm, "int_route", spy)
    want = evaluate_ppl(LLAMA, pk, tc, tokens, seqlen=32, spec=spec)
    fwd = tpf.make_tp_model_forward(LLAMA, pk, tc, cpu_mesh(2), spec=spec)
    routes.clear()
    got = evaluate_ppl(LLAMA, pk, tc, tokens, seqlen=32, spec=spec,
                       forward=fwd)
    assert set(routes) == {route}
    assert got == pytest.approx(want, rel=PACKED_PPL_RTOL)
