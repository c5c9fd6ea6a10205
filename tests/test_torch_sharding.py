"""The port's mesh, its collectives and tensor-parallel placement
(``parallel/mesh.py``, ``parallel/sharding.py``, ``parallel/tp_forward.py``'s
padding and retiling, ``serving/tp_engine.py``'s ``fuse_packed_tp`` and
``place_params``) against the JAX package, on the CPU.

Tiny models are made with numpy from a seed and handed to both packages
(the helpers here are shared with test_torch_tp_forward.py and
test_torch_tp_engine.py); a packed model is fake-quantized and packed by
the port (whose words equal JAX's, tests/test_torch_packing.py) and handed
to JAX as its PackedWeights, which spares a JAX compile per pack. A JAX spec tree (``PartitionSpec`` leaves) is
read as the axis its shards split, the port's plain description; a placed
JAX array is read shard by shard (``addressable_shards``, in the mesh's
device order) and must equal the port's shard bit for bit: packed words,
scales, zeros and biases, dense weights and norms.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from omniquant_tpu.models import falcon as jfalcon
from omniquant_tpu.models import llama as jllama
from omniquant_tpu.models import opt as jopt
from omniquant_tpu.parallel import make_mesh as j_make_mesh
from omniquant_tpu.parallel import sharding as jsharding
from omniquant_tpu.parallel import tp_forward as jtpf
from omniquant_tpu.quant.packing import PackedWeight as JPackedWeight
from omniquant_tpu.serving import tp_engine as jtpe
from omniquant_tpu_torch.models import FALCON, LLAMA, OPT
from omniquant_tpu_torch.models import falcon as tfalcon
from omniquant_tpu_torch.models import llama as tllama
from omniquant_tpu_torch.models import opt as topt
from omniquant_tpu_torch.parallel import Mesh, make_mesh, sharding
from omniquant_tpu_torch.parallel import tp_forward as tpf
from omniquant_tpu_torch.quant import PackedWeight, QuantConfig, pack_weight
from omniquant_tpu_torch.serving import pack_model
from omniquant_tpu_torch.serving import tp_engine as tpe
from omniquant_tpu_torch.utils import from_jax_params

CPU = torch.device("cpu")
FAMILIES = {"llama": (jllama, tllama, LLAMA),
            "opt": (jopt, topt, OPT),
            "falcon": (jfalcon, tfalcon, FALCON)}
# tiny configurations (JAX tests/test_tp_packed.py's and
# tests/test_tp_engine.py's shapes)
CFGS = {
    "llama": dict(vocab_size=128, hidden_size=256, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, max_position_embeddings=128),
    "llama_pad": dict(vocab_size=64, hidden_size=256, intermediate_size=288,
                      num_hidden_layers=1, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=64),
    "llama_gqa": dict(vocab_size=128, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=8,
                      num_key_value_heads=4, max_position_embeddings=128),
    "opt": dict(vocab_size=128, hidden_size=256, ffn_dim=320,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128),
    "falcon_mqa": dict(vocab_size=128, hidden_size=256, num_hidden_layers=2,
                       num_attention_heads=4, multi_query=True,
                       parallel_attn=True, alibi=False, bias=False),
    "falcon_new": dict(vocab_size=128, hidden_size=256, num_hidden_layers=1,
                       num_attention_heads=4, num_kv_heads=2,
                       multi_query=False, new_decoder_architecture=True,
                       parallel_attn=True),
    "falcon_alibi": dict(vocab_size=128, hidden_size=256, num_hidden_layers=2,
                         num_attention_heads=4, multi_query=False,
                         parallel_attn=False, alibi=True, bias=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny ops, many of them, in shard threads: one intra-op thread (more
    made such runs far slower under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_of(name: str) -> str:
    return name.split("_")[0]


def numpy_params(init_params, cfg, seed):
    """A numpy tree in the layout of the JAX family's ``init_params``:
    N(0, 0.02) weights, N(0, 0.1) biases (the column-parallel bias must
    show if added twice), norms around 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))

    def leaf(path, s):
        if s is None:
            return None
        keys = [str(getattr(k, "key", "")) for k in path]
        if any("norm" in k or k.startswith("ln") for k in keys):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        scale = 0.1 if keys[-1] == "bias" else 0.02
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes,
                                            is_leaf=lambda x: x is None)


_MODELS = {}


def tiny(name: str, seed: int = 0):
    """(JAX cfg, port cfg, JAX params, port params) of the tiny model
    ``name`` (a CFGS key), made once."""
    key = (name, seed)
    if key not in _MODELS:
        jmod, tmod, _ = FAMILIES[family_of(name)]
        jc = jmod.__dict__[_CFG_CLS[family_of(name)]](**CFGS[name])
        tc = tmod.__dict__[_CFG_CLS[family_of(name)]](**CFGS[name])
        np_tree = numpy_params(jmod.init_params, jc, seed)
        jp = jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                          np_tree, is_leaf=lambda a: a is None)
        _MODELS[key] = (jc, tc, jp, from_jax_params(np_tree, device=CPU))
    return _MODELS[key]


_CFG_CLS = {"llama": "LlamaConfig", "opt": "OPTConfig",
            "falcon": "FalconConfig"}
_PACKS = {}


def to_jax(tree):
    """The port's tree as the JAX package's (PackedWeights included)."""
    if tree is None:
        return None
    if isinstance(tree, PackedWeight):
        return JPackedWeight(
            **{f: to_jax(getattr(tree, f))
               for f in ("qweight", "scales", "zeros", "bias")},
            bits=tree.bits, group_size=tree.group_size,
            in_features=tree.in_features, out_features=tree.out_features,
            tile_k=tree.tile_k, layout=tree.layout)
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def packed(name: str, bits=4, gs=32, tile_k=64, seed=0):
    """The tiny model ``name`` fake-quantized and packed (the JAX tests'
    ``_pack``, by the port): (JAX tree, port tree)."""
    key = (name, bits, gs, tile_k, seed)
    if key not in _PACKS:
        _, tc, _, tp_ = tiny(name, seed)
        fam = FAMILIES[family_of(name)][2]
        wcfg = QuantConfig(n_bits=bits, group_size=gs)
        fq = dict(tp_, layers=[fam.effective_block_weights(b, wcfg, None,
                                                           None, tc)
                               for b in tp_["layers"]])
        tpk = pack_model(fam, fq, wcfg, tile_k=tile_k, device=CPU)
        _PACKS[key] = (to_jax(tpk), tpk)
    return _PACKS[key]


def cpu_mesh(tp: int) -> Mesh:
    return make_mesh(tp=tp, devices=[CPU] * tp)


# ---------------------------------------------------------------------------
# the mesh and its collectives

@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_is_bit_identical_on_every_shard(n, op):
    """Each shard's (3, 40) tensor in (f32 and bf16); every shard gets the
    same tensor, equal to the reduction in shard order (bf16 summed in f32
    and rounded once), 20 calls in a row."""
    rng = np.random.default_rng(n)
    parts = [torch.from_numpy(rng.standard_normal((3, 40)).astype(
        np.float32)) for _ in range(n)]
    mesh = cpu_mesh(n)
    fn = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}[op]
    for dtype in (torch.float32, torch.bfloat16):
        xs = [x.to(dtype) for x in parts]
        want = xs[0].float()
        for x in xs[1:]:
            want = fn(want, x.float())
        want = want.to(dtype)
        got = mesh.run(lambda p, x: [mesh.all_reduce(p, x * (r + 1), op)
                                     for r in range(20)], xs)
        for r in range(20):
            for p in range(n):
                assert got[p][r] is got[0][r]  # one tensor for every shard
            scaled = (xs[0] * (r + 1)).float()
            for x in xs[1:]:
                scaled = fn(scaled, (x * (r + 1)).float())
            assert torch.equal(got[0][r], scaled.to(dtype))
        assert torch.equal(got[0][0], want)
    with pytest.raises(ValueError, match="op must be"):
        mesh.run(lambda p: mesh.all_reduce(p, parts[p], "mean"))
    assert threading.active_count() < 8


def test_make_mesh_refuses():
    """dp > 1 lays dp rows of tp shards, dp-major, each row reduced on its
    own (JAX's psum over "tp"); fewer devices than dp * tp raise (a card is
    never repeated unasked); tp shards on one device when asked."""
    mesh = make_mesh(dp=2, tp=2, devices=[CPU] * 4)
    assert (mesh.dp, mesh.tp, mesh.n) == (2, 2, 4)
    parts = [torch.full((3,), float(10 ** p)) for p in range(4)]
    got = mesh.run(lambda p, x: mesh.all_reduce(p, x), parts)
    assert [g[0].item() for g in got] == [11.0, 11.0, 1100.0, 1100.0]
    with pytest.raises(RuntimeError, match="needs 6 devices"):
        make_mesh(dp=2, tp=3, devices=[CPU] * 4)
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        make_mesh(tp=4, devices=[CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(tp=2)
    assert make_mesh(tp=3, devices=["cpu"] * 5).devices == [CPU] * 3


# ---------------------------------------------------------------------------
# layouts

def axis_of(spec):
    """A JAX PartitionSpec read as the axis its tp shards split (None:
    replicated or absent)."""
    if spec is None:
        return None
    return next((i for i, a in enumerate(spec) if a == "tp"), None)


def jax_spec_tree(tree):
    """A JAX spec tree as the port's: PackedWeight specs as dicts of their
    tensor fields' axes, every PartitionSpec as its axis."""
    if hasattr(tree, "qweight"):
        return {f: axis_of(getattr(tree, f))
                for f in ("qweight", "scales", "zeros", "bias")}
    if isinstance(tree, dict):
        return {k: jax_spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [jax_spec_tree(v) for v in tree]
    return axis_of(tree)


@pytest.mark.parametrize("name", ["llama", "opt", "falcon_mqa",
                                  "falcon_alibi"])
@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_specs_match_jax(name, kind):
    fam = family_of(name)
    assert sharding.ROW_PARALLEL == jsharding.ROW_PARALLEL
    assert sharding.COL_PARALLEL == jsharding.COL_PARALLEL
    if kind == "dense":
        jp, tp_ = tiny(name)[2:]
    else:
        jp, tp_ = packed(name)
    assert sharding.model_specs(fam, tp_) == jax_spec_tree(
        jsharding.model_specs(fam, jp))
    for jb, tb in zip(jp["layers"], tp_["layers"]):
        assert sharding.block_specs(fam, tb) == jax_spec_tree(
            jsharding.block_specs(fam, jb))


def jax_shards(x, jmesh) -> list:
    """A placed JAX array's per-device data, in the mesh's device order."""
    by_dev = {s.device: np.asarray(s.data) for s in x.addressable_shards}
    return [by_dev[d] for d in jmesh.devices.flat]


def assert_placed_equal(jtree, ttrees, jmesh, where=""):
    """Every leaf of the placed JAX tree equals the port's shard trees
    (``ttrees``, one per shard) bit for bit."""
    if jtree is None:
        assert all(t is None for t in ttrees), where
        return
    if hasattr(jtree, "qweight"):
        for t in ttrees:
            assert isinstance(t, PackedWeight), where
            assert (t.bits, t.group_size, t.tile_k, t.layout) == (
                jtree.bits, jtree.group_size, jtree.tile_k, jtree.layout)
        for f in ("qweight", "scales", "zeros", "bias"):
            assert_placed_equal(getattr(jtree, f),
                                [getattr(t, f) for t in ttrees], jmesh,
                                f"{where}.{f}")
        return
    if isinstance(jtree, dict):
        for k in jtree:
            assert_placed_equal(jtree[k], [t[k] for t in ttrees], jmesh,
                                f"{where}.{k}")
        return
    if isinstance(jtree, (list, tuple)):
        for i, v in enumerate(jtree):
            assert_placed_equal(v, [t[i] for t in ttrees], jmesh,
                                f"{where}[{i}]")
        return
    for p, (want, got) in enumerate(zip(jax_shards(jtree, jmesh), ttrees)):
        assert got.device == CPU, where
        g = got.numpy()
        assert g.shape == want.shape and np.array_equal(
            g.view(np.uint8), np.ascontiguousarray(want).view(np.uint8)), (
            where, p)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_matches_jax(tp):
    """sharding.shard_params on the dense tiny LLaMA (model_specs) against
    JAX's device_put shards."""
    jc, tc, jp, tp_ = tiny("llama")
    jmesh = j_make_mesh(dp=1, tp=tp)
    jplaced = jsharding.shard_params(jp, jmesh,
                                     jsharding.model_specs("llama", jp))
    tplaced = sharding.shard_params(tp_, cpu_mesh(tp),
                                    sharding.model_specs("llama", tp_))
    assert_placed_equal(jplaced, tplaced, jmesh)


# name, bits, group, tile, tp: packed rows retiled (llama W4 g32 tile 256
# at tp 4: 64-row shards of 256-row tiles; pairs W4 g128 tile 256 at tp 2),
# padded intermediates (llama_pad
# 288 -> 512, OPT 320 -> 512/1024), pairs W3 tiles of 80 rows, fused qkv
# and gate+up, Falcon's MQA relayout and its grouped kv heads
PLACE_CASES = [
    ("llama", 4, 32, 64, 2), ("llama", 4, 32, 64, 4),
    ("llama", 4, 32, None, 4), ("llama_pad", 4, 32, None, 2),
    ("llama_gqa", 4, 128, None, 2), ("opt", 4, 32, 64, 2),
    ("opt", 4, 32, 64, 4), ("falcon_mqa", 4, 32, 64, 2),
    ("falcon_new", 4, 32, 64, 2), ("falcon_alibi", 4, 32, 64, 2),
]


@pytest.mark.parametrize("name,bits,gs,tile,tp", PLACE_CASES)
def test_place_params_matches_jax(name, bits, gs, tile, tp):
    """tp_engine.place_params on a packed model (padding, relayout, fusion,
    retiling, splitting) against JAX's, leaf by leaf on every shard; JAX
    keeps the fused parts beside the fused weight, the port drops them."""
    fam = family_of(name)
    jc, tc = tiny(name)[:2]
    jpk, tpk = packed(name, bits, gs, tile)
    jmesh = j_make_mesh(dp=1, tp=tp)
    jplaced, _, j_inter = jtpe.place_params(jpk, jc, jmesh, fam, jnp.float32)
    tplaced, t_inter = tpe.place_params(tpk, tc, cpu_mesh(tp), fam,
                                        torch.float32)
    assert t_inter == j_inter
    fused_parts = {n for site in tpe._FUSE_SITES[fam] for n in site[:-1]}
    for li, jb in enumerate(jplaced["layers"]):
        tbs = [t["layers"][li] for t in tplaced]
        for name_, jw in jb.items():
            if name_ in fused_parts and name_ not in tbs[0]:
                assert any(s[-1] in tbs[0] for s in tpe._FUSE_SITES[fam])
                continue
            assert_placed_equal(jw, [tb[name_] for tb in tbs], jmesh,
                                f"layers[{li}].{name_}")
    rest = {k: v for k, v in jplaced.items() if k != "layers"}
    assert_placed_equal(rest, [{k: t[k] for k in rest} for t in tplaced],
                        jmesh)


@pytest.mark.parametrize("layout,bits,gs,new_tile", [
    ("planar", 4, 32, 64), ("pairs", 4, 128, 128), ("pairs", 3, 128, 640),
    ("planar", 3, 128, 256)])
def test_retile_and_pad_match_jax(layout, bits, gs, new_tile):
    """_retile_packed, _pad_packed_out/_in and _ensure_col_splittable on
    one random packed weight against JAX's, bit for bit."""
    rng = np.random.default_rng(bits * 100 + gs)
    k = 1280 if bits == 3 and layout == "pairs" else 512
    w = rng.standard_normal((256, k)).astype(np.float32) * 0.02
    tpw = pack_weight(torch.from_numpy(w), QuantConfig(n_bits=bits,
                                                       group_size=gs),
                      layout=layout)
    jpw = to_jax({"w": tpw})["w"]

    def same(jx, tx):
        for f in ("qweight", "scales", "zeros"):
            assert np.array_equal(np.asarray(getattr(jx, f)),
                                  getattr(tx, f).numpy()), f
        assert (jx.tile_k, jx.in_features, jx.out_features) == (
            tx.tile_k, tx.in_features, tx.out_features)

    same(jtpf._retile_packed(jpw, new_tile), tpf._retile_packed(tpw, new_tile))
    same(jtpf._pad_packed_out(jpw, 384), tpf._pad_packed_out(tpw, 384))
    k_big = k + 2 * jpw.tile_k
    same(jtpf._pad_packed_in(jpw, k_big), tpf._pad_packed_in(tpw, k_big))
    assert tpf._min_tile(bits, gs, layout) == jtpf._min_tile(bits, gs, layout)
    for tp in (2, 4, 8):
        try:
            jr = jtpf._ensure_col_splittable(jpw, tp)
        except ValueError:
            with pytest.raises(ValueError, match="cannot split"):
                tpf._ensure_col_splittable(tpw, tp)
            continue
        same(jr, tpf._ensure_col_splittable(tpw, tp))


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_restructure_mqa_and_fuse_match_jax(kind):
    """restructure_falcon_mqa on a dense and a packed block, and
    fuse_packed_tp over the tiny LLaMA's q/k/v at tp 2 and 4, against
    JAX's, bit for bit."""
    jc, tc, jp, tp_ = tiny("falcon_mqa")
    if kind == "packed":
        jp, tp_ = packed("falcon_mqa")
    for tp in (2, 4):
        jb = jtpf.restructure_falcon_mqa(jp["layers"][0], jc, tp)
        tb = tpf.restructure_falcon_mqa(tp_["layers"][0], tc, tp)
        assert_placed_equal_whole(jb["query_key_value"],
                                  tb["query_key_value"])
    jpk, tpk = packed("llama")
    for tp in (2, 4):
        names = ("q_proj", "k_proj", "v_proj")
        jf = jtpe.fuse_packed_tp([jpk["layers"][0][n] for n in names], tp)
        tf = tpe.fuse_packed_tp([tpk["layers"][0][n] for n in names], tp)
        assert_placed_equal_whole(jf, tf)
    dense = tiny("falcon_mqa")[3]["layers"][0]["dense"]
    assert tpe.fuse_packed_tp([tpk["layers"][0]["q_proj"], dense], 2) is None


def assert_placed_equal_whole(jx, tx):
    """An unplaced JAX leaf (PackedWeight or dense dict) equal to the
    port's bit for bit."""
    if hasattr(jx, "qweight"):
        assert tx.out_features == jx.out_features
        jx = {f: getattr(jx, f) for f in ("qweight", "scales", "zeros",
                                          "bias")}
        tx = {f: getattr(tx, f) for f in jx}
    for k, v in jx.items():
        if v is None:
            assert tx[k] is None
        else:
            assert np.array_equal(np.asarray(v), tx[k].numpy()), k
