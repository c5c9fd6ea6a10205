"""The port's multi-process layer (``parallel/multihost.py``, the mesh
across ranks in ``parallel/mesh.py``, ``serving/dp_serving.py``, TP engines
over ranks) against JAX's, on the CPU: one 2-process gloo group, spawned
once for the module (tests/_torch_multihost_worker.py, which imports no
JAX), on the numpy-seeded fixtures of tests/_multihost_worker.py, which
this process builds with JAX and hands over as npz.

What tests/test_multihost.py asserts of JAX's two processes, of the port's:
the dp x tp calibration step's loss (equal on both ranks bit for bit,
within 1e-5 of JAX's single-process oracle at global_mesh(tp=2, dp=2));
six steps and the fold (equal across ranks bit for bit, within
FOLD_RTOL of JAX's oracle); DP serving's global streams (equal on both
ranks, and token for token JAX's ``LlamaEngine.generate`` and the port's
single engine's). Besides: TP at tp 2 with one shard a rank gives the
in-process 2-shard mesh's prefill logits bit for bit and JAX's TP engine's
greedy tokens; ``Mesh.all_reduce`` over 4 shards, 2 a rank, is the
in-process ``Mesh._reduce`` bit for bit in f32 and bf16; an over-capacity
``submit`` raises the same error on both ranks.

Sequence parallelism with the ring across the ranks, on the SP runs of
tests/test_torch_sp_calibration.py (OPT at sp 2: one shard a rank; LLaMA
GQA at sp 4: two shards a rank, so the ring shifts within a rank and
across): layer 0's capture pass through the flash ring gives the
in-process ``SPMesh``'s blocks bit for bit; the plain ring's gradients
(its k/v shifted back across the ranks) equal the in-process ring's within
RING_GRAD_TOL; ``calibrate(sp_mesh=...)``'s losses, trainables and folded
weights are held against JAX's ``calibrate(sp_mesh=Mesh)`` at that file's
SP_RUNS tolerances, and the two ranks' trainables agree bit for bit.

Cluster auto-detection (no group needed): SLURM's node lists, ranks and
port as JAX's ``SlurmCluster`` reads them, Open MPI's as JAX's
``OmpiCluster``, torchrun's variables, and the refusals.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniquant_tpu.models import llama as jllama
from omniquant_tpu.utils.checkpoint import save_pytree as j_save_pytree
from omniquant_tpu_torch.parallel import make_mesh
from omniquant_tpu_torch.utils import from_jax_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
from _multihost_worker import (  # noqa: E402
    calibration_run_global, calibration_step_global, serving_fixture)
from test_torch_sp_calibration import (  # noqa: E402
    CONFIGS as SP_CONFIGS, SP_RUNS, _flat, _jax_sp_run, _model, _port_sp_block,
    _tokens)

WORLD = 2
RANK_TIMEOUT_S = 180
# the fold after six steps against JAX's oracle: two AdamW runs whose f32
# sums are ordered differently (the port: each rank's rows, then the dp
# mean; JAX: one XLA reduction over the global batch). Measured on the CPU:
# FOLDSUM and FOLDHEAD equal JAX's exactly (the codes land on the same
# grid points), the step's loss 2.4e-7 relative from JAX's; the bound is
# JAX's own for its two processes against its oracle
FOLD_RTOL = 1e-6
CPU = torch.device("cpu")
# the plain ring's gradients across the ranks against the in-process
# ring's: the same terms, summed in another order (measured: 0 at sp 2,
# within 2.4e-7 at sp 4)
RING_GRAD_TOL = 1e-6


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _write_inputs(work: Path) -> dict:
    """The ranks' inputs, made as tests/_multihost_worker.py makes them."""
    step_cfg = jllama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64)
    j_save_pytree(str(work / "step_block.npz"), _np(jllama.init_params(
        jax.random.PRNGKey(0), step_cfg)["layers"][0]))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    fp = rng.standard_normal((4, 16, 64)).astype(np.float32)
    run_cfg = jllama.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32)
    j_save_pytree(str(work / "run_params.npz"), _np(jllama.init_params(
        jax.random.PRNGKey(0), run_cfg)))
    cfg, packed, prompts = serving_fixture()
    j_save_pytree(str(work / "serve_packed.npz"), _np(packed))
    dense = _np(jllama.init_params(jax.random.PRNGKey(2), cfg))
    j_save_pytree(str(work / "tp_params.npz"), dense)
    sp = {}
    for run, (name, n, kw, _) in SP_RUNS.items():
        j_save_pytree(str(work / f"sp_{name}.npz"), _model(name))
        sp[f"sp_x_{name}"] = (rng.standard_normal(
            (1, 64, SP_CONFIGS[name]["hidden_size"])) * 0.5).astype(
                np.float32)
        sp[f"sp_tokens_{name}"] = _tokens(name)
    for t in "qkvw":  # the ring's gradient case: 4 heads on 2 kv heads
        heads = 2 if t in "kv" else 4
        sp[f"sp_{t}"] = rng.standard_normal((1, heads, 64, 16)).astype(
            np.float32)
    np.savez(work / "inputs.npz", step_x=x, step_fp=fp,
             step_cfg=json.dumps(dataclasses.asdict(step_cfg)),
             run_cfg=json.dumps(dataclasses.asdict(run_cfg)),
             serve_cfg=json.dumps(dataclasses.asdict(cfg)),
             serve_prompts=json.dumps(prompts),
             sp_runs=json.dumps({run: [name, n, kw, SP_CONFIGS[name]]
                                 for run, (name, n, kw, _) in
                                 SP_RUNS.items()}), **sp)
    return dict(cfg=cfg, packed=packed, prompts=prompts, dense=dense, sp=sp)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Both ranks' results (json and arrays) and the inputs; JAX's oracles
    are computed while the ranks run."""
    work = tmp_path_factory.mktemp("multihost")
    made = _write_inputs(work)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_multihost_worker.py"),
         str(r), str(WORLD), str(port), str(work)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        made["oracle"] = _jax_oracles(made)
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-4000:]}"
    made["json"] = [json.loads((work / f"rank{r}.json").read_text())
                    for r in range(WORLD)]
    made["arrays"] = [dict(np.load(work / f"rank{r}.npz"))
                      for r in range(WORLD)]
    return made


def _jax_oracles(made) -> dict:
    from jax.sharding import NamedSharding, PartitionSpec as P

    from omniquant_tpu.parallel import make_mesh as j_make_mesh
    from omniquant_tpu.parallel.multihost import global_mesh as j_global_mesh
    from omniquant_tpu.serving.engine import LlamaEngine as JLlamaEngine
    from omniquant_tpu.serving.tp_engine import TPLlamaEngine as JTPEngine

    def shard_fn(mesh, arr):
        return jax.device_put(
            arr, NamedSharding(mesh, P("dp", *([None] * (arr.ndim - 1)))))

    out = {"loss": float(calibration_step_global(
        j_global_mesh(tp=2, dp=2), shard_fn, lambda n: slice(0, n)))}
    out["foldsum"], out["foldhead"] = calibration_run_global(
        j_global_mesh(tp=2, dp=2), shard_fn, lambda n: slice(0, n))
    cfg, prompts = made["cfg"], made["prompts"]
    eng = JLlamaEngine(made["packed"], cfg, max_batch=8, max_len=32,
                       dtype=jnp.float32)
    out["streams"] = [eng.generate(p, max_new_tokens=9) for p in prompts]
    teng = JTPEngine(jax.tree.map(jnp.asarray, made["dense"]), cfg,
                     j_make_mesh(dp=1, tp=2), max_batch=2, max_len=32,
                     dtype=jnp.float32)
    out["tp_tokens"] = teng.generate(prompts[0], max_new_tokens=8)
    out["sp"] = {run: _jax_sp_run(run) for run in SP_RUNS}
    return out


def test_ranks_join_one_gloo_group(group):
    for r, res in enumerate(group["json"]):
        assert (res["rank"], res["world"], res["backend"]) == (r, WORLD,
                                                              "gloo")
        assert res["device"] == "cpu"
        assert res["jax_loaded"] == []
        assert res["mesh"]["ranks"] == [0, 0, 1, 1]
        assert res["mesh"]["local"] == [2 * r, 2 * r + 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_all_reduce_across_ranks_is_the_in_process_fold(group, op, dtype):
    """4 shards, 2 a rank: every rank's result is the in-process mesh's
    shard-order fold (bf16 widened to f32, rounded once) bit for bit."""
    dt = getattr(torch, dtype)
    parts = [torch.from_numpy(np.random.default_rng(100 + p).standard_normal(
        (3, 40)).astype(np.float32)).to(dt) for p in range(4)]
    mesh = make_mesh(tp=4, devices=[CPU] * 4)
    want = mesh._reduce(parts, op)[0]
    want = (want.view(torch.int16) if dt == torch.bfloat16 else want).numpy()
    for arrays in group["arrays"]:
        got = arrays[f"ar_{op}_{dtype}"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_calibration_step_loss_matches_jax(group):
    """One dp x tp LWC/LET step: both ranks hold the same loss bit for bit,
    within 1e-5 of JAX's single-process oracle at global_mesh(tp=2, dp=2);
    the dp-mean gradients agree across ranks too."""
    a, b = group["json"]
    assert a["loss_hex"] == b["loss_hex"]
    assert a["grad_norm"] == b["grad_norm"] and a["grad_norm"] > 0
    assert np.isclose(a["loss"], group["oracle"]["loss"], rtol=1e-5), (
        a["loss"], group["oracle"]["loss"])


def test_six_steps_and_fold_match_jax(group):
    """Six dp LWC steps on each rank's slice of the seeded corpus, then the
    fold: FOLDSUM and FOLDHEAD equal across ranks bit for bit and within
    FOLD_RTOL of JAX's oracle."""
    a, b = group["json"]
    assert a["foldsum"] == b["foldsum"]
    assert a["foldhead"] == b["foldhead"]
    np.testing.assert_allclose(a["foldsum"], group["oracle"]["foldsum"],
                               rtol=FOLD_RTOL)
    np.testing.assert_allclose(a["foldhead"], group["oracle"]["foldhead"],
                               rtol=FOLD_RTOL)


def test_dp_serving_streams_match_jax_and_the_single_engine(group):
    """The global streams gathered by both ranks are equal, JAX's
    LlamaEngine.generate's token for token, and the port's single
    engine's; every slot is released after generate_all."""
    from omniquant_tpu_torch.serving import DPServingCoordinator, LlamaEngine

    a, b = group["json"]
    assert a["servtoks"] == b["servtoks"]
    assert a["servtoks"] == group["oracle"]["streams"]
    assert [r["dp"] for r in (a, b)] == [dict(pid=0, nproc=2),
                                        dict(pid=1, nproc=2)]
    assert a["local_slots_after"] == b["local_slots_after"] == 0
    packed = from_jax_params(_np(group["packed"]), device=CPU)
    eng = LlamaEngine(packed, group["cfg"], max_batch=8, max_len=32,
                      dtype=torch.float32, device=CPU)
    one = DPServingCoordinator(eng)  # no group: rank 0 of 1
    assert (one.pid, one.nproc) == (0, 1)
    assert one.generate_all(group["prompts"], max_new_tokens=9,
                            step=4) == a["servtoks"]


def test_over_capacity_submit_raises_alike_on_every_rank(group):
    a, b = group["json"]
    assert a["refusal"] is not None and a["refusal"] == b["refusal"]
    assert "5 requests on host 1 (engine capacity 4)" in a["refusal"]
    assert a["after_refusal"] == b["after_refusal"] == dict(next_id=5,
                                                            live=0)


def test_tp_across_ranks_matches_in_process_mesh_and_jax(group):
    """TP at tp 2, one shard a rank: each rank holds only its shard; its
    prefill logits equal the in-process 2-shard mesh's bit for bit, and its
    greedy tokens JAX's TPLlamaEngine's."""
    from omniquant_tpu_torch.serving import TPLlamaEngine

    for r, res in enumerate(group["json"]):
        assert res["tp"] == dict(local=[r], held=[r], heads=2)
    params = from_jax_params(group["dense"], device=CPU)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        eng = TPLlamaEngine(params, group["cfg"], make_mesh(
            tp=2, devices=[CPU] * 2), max_batch=2, max_len=32,
            dtype=torch.float32)
        _, logits = eng.add_requests(group["prompts"][:2], return_logits=True)
    finally:
        torch.set_num_threads(n)
    for arrays in group["arrays"]:
        np.testing.assert_array_equal(arrays["tp_prefill_logits"],
                                      logits.numpy())
    for res in group["json"]:
        assert res["tp_tokens"] == group["oracle"]["tp_tokens"]


def test_local_layout_reads_the_launcher(monkeypatch):
    """A host's ranks are the launcher's LOCAL_RANK/LOCAL_WORLD_SIZE (2
    hosts of 8 cards: rank 11 is card 3 of 8 on its host, so NCCL); without
    them every rank is on one host."""
    from omniquant_tpu_torch.parallel.multihost import (
        MultihostConfig, local_layout)

    cfg = MultihostConfig("localhost:1", num_processes=16, process_id=11)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert local_layout(cfg) == (11, 16)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert local_layout(cfg) == (11, 16)  # both or neither
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert local_layout(cfg) == (3, 8)


def _one_thread(fn):
    """``fn()`` on one intra-op thread, as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("run", list(SP_RUNS))
def test_sp_capture_across_ranks_is_the_in_process_mesh(group, run):
    """Layer 0 through the flash ring on an SPMesh over the ranks: each
    rank's output blocks are the in-process SPMesh's bit for bit."""
    from omniquant_tpu_torch.models import get_family

    name, sp, _, _ = SP_RUNS[run]
    layer = from_jax_params(_model(name), device="cpu")["layers"][0]
    x = torch.from_numpy(group["sp"][f"sp_x_{name}"])
    want = _one_thread(lambda: _port_sp_block(name, layer, x, sp, "flash"))
    dense, _ = get_family(name).block_forward(
        layer, x, get_family(name).config_cls(**SP_CONFIGS[name]))
    np.testing.assert_allclose(want.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)
    for r, (res, arrays) in enumerate(zip(group["json"], group["arrays"])):
        local = res["sp"][run]["local"]
        assert res["sp"][run]["ranks"] == [p * 2 // sp for p in range(sp)]
        s = x.shape[1] // sp
        mine = torch.cat([want[:, p * s:(p + 1) * s] for p in local], dim=1)
        np.testing.assert_array_equal(arrays[f"{run}/capture"],
                                      mine.numpy())


@pytest.mark.parametrize("run", list(SP_RUNS))
def test_sp_ring_gradients_cross_the_ranks(group, run):
    """d(sum(ring * w))/d(q, k, v) through the plain ring over the ranks:
    the remote blocks' dk/dv come back through the shift's backward, so
    every rank's gradients equal the in-process ring's (RING_GRAD_TOL)."""
    from omniquant_tpu_torch.parallel import ring_attention

    sp = SP_RUNS[run][1]
    q, k, v, w = (torch.from_numpy(group["sp"][f"sp_{t}"]) for t in "qkvw")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = _one_thread(lambda: ring_attention(*leaves, ["cpu"] * sp,
                                             impl="plain"))
    (out * w).sum().backward()
    s = q.shape[2] // sp
    for res, arrays in zip(group["json"], group["arrays"]):
        local = res["sp"][run]["local"]
        for t, leaf in zip("qkv", leaves):
            want = torch.cat([leaf.grad[:, :, p * s:(p + 1) * s]
                              for p in local], dim=2)
            got = arrays[f"{run}/d{t}"]
            assert np.abs(got).max() > 0, t
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=RING_GRAD_TOL, err_msg=t)


@pytest.mark.parametrize("run", list(SP_RUNS))
def test_sp_calibration_across_ranks_matches_jax(group, run):
    """calibrate(sp_mesh=...) with the ring across the ranks: its losses,
    LWC/LET trainables and folded weights within SP_RUNS' tolerances of
    JAX's calibrate(sp_mesh=Mesh); both ranks' bit for bit alike."""
    name, _, _, tol = SP_RUNS[run]
    j_params, j_omni, j_losses = group["oracle"]["sp"][run]
    a, b = group["arrays"]
    keys = sorted(k for k in a if k.startswith(f"{run}/omni/")
                  or k.startswith(f"{run}/weight/"))
    assert keys and keys == sorted(
        k for k in b if k.startswith(f"{run}/omni/")
        or k.startswith(f"{run}/weight/"))
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ra, rb = (r["sp"][run]["losses"] for r in group["json"])
    assert ra == rb
    np.testing.assert_allclose(ra, j_losses, rtol=tol["loss"], atol=0)
    for i, layer in j_omni.items():
        for grp in ("lwc", "let"):
            for path, want in _flat(layer.get(grp, {})).items():
                got = a[f"{run}/omni/{i}/{grp}{path}"]
                assert np.abs(got - want).max() <= tol["train"], (i, grp,
                                                                  path)
        for lin, want in _flat({n: j_params["layers"][int(i)][n]["weight"]
                                for n in _linear_names(name)}).items():
            got = a[f"{run}/weight/{i}{lin}"]
            assert np.abs(got - want).max() <= tol["weight"], (i, lin)


def _linear_names(name):
    from omniquant_tpu_torch.models import get_family

    return get_family(name).linear_names


def _jax_cluster(monkeypatch, cls, env):
    """JAX's reading of ``env`` through ``cls`` (a jax._src.clusters
    ClusterEnv): (coordinator, count, id, local id)."""
    for k in list(os.environ):
        if k.startswith(("SLURM_", "OMPI_")) or k in (
                "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cls.is_env_present()
    return (cls.get_coordinator_address(None, None), cls.get_process_count(),
            cls.get_process_id(), cls.get_local_process_id())


@pytest.mark.parametrize("nodes", ["node001", "node001,host2",
                                   "node[001-015],host2",
                                   "node[001,007-015]", "gpu-a[12-13]"])
def test_slurm_environment_reads_as_jax(monkeypatch, nodes):
    """The port's SLURM reading equals JAX's SlurmCluster's under the same
    environment: the first host of the node list at port SLURM_JOB_ID %
    4096 + 61440, the task count, the rank and the local rank; the local
    layout is SLURM_LOCALID of SLURM_NTASKS / SLURM_STEP_NUM_NODES."""
    from jax._src.clusters.slurm_cluster import SlurmCluster

    from omniquant_tpu_torch.parallel.multihost import (
        MultihostConfig, detect_cluster, local_layout)

    env = dict(SLURM_JOB_ID="123456", SLURM_STEP_NODELIST=nodes,
               SLURM_NTASKS="16", SLURM_PROCID="11", SLURM_LOCALID="3",
               SLURM_STEP_NUM_NODES="2")
    want = _jax_cluster(monkeypatch, SlurmCluster, env)
    got = detect_cluster()
    assert got.launcher == "slurm"
    assert (got.coordinator_address, got.num_processes, got.process_id,
            got.local_rank) == want
    assert local_layout(MultihostConfig()) == (3, 8)


def test_openmpi_environment_reads_as_jax(monkeypatch):
    from jax._src.clusters.ompi_cluster import OmpiCluster

    from omniquant_tpu_torch.parallel.multihost import detect_cluster

    for uri in ("1531576320.0;tcp://10.96.0.1,10.148.0.1:34911",
                "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:"
                "c083:150e::3000:2]:43370"):
        env = dict(OMPI_MCA_orte_hnp_uri=uri, OMPI_COMM_WORLD_SIZE="4",
                   OMPI_COMM_WORLD_RANK="2", OMPI_COMM_WORLD_LOCAL_RANK="0")
        want = _jax_cluster(monkeypatch, OmpiCluster, env)
        got = detect_cluster()
        assert (got.coordinator_address, got.num_processes, got.process_id,
                got.local_rank) == want


def test_torchrun_environment_and_refusals(monkeypatch):
    """torchrun's variables (LOCAL_RANK/LOCAL_WORLD_SIZE taken over
    SLURM's when both are set); with no launcher the error
    names every variable looked for; a --num_processes other than the
    launcher's count, or a coordinator without a process id, is refused
    before any rendezvous."""
    from omniquant_tpu_torch.parallel.multihost import (
        MultihostConfig, NoLauncher, detect_cluster, init_multihost,
        local_layout)

    _jax_cluster(monkeypatch, type("Any", (), {
        "is_env_present": classmethod(lambda c: True),
        "get_coordinator_address": classmethod(lambda c, *a: None),
        "get_process_count": classmethod(lambda c: None),
        "get_process_id": classmethod(lambda c: None),
        "get_local_process_id": classmethod(lambda c: None)}), {})
    with pytest.raises(NoLauncher) as e:
        detect_cluster()
    for var in ("MASTER_ADDR", "WORLD_SIZE", "SLURM_STEP_NODELIST",
                "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE"):
        assert var in str(e.value)
    with pytest.raises(NoLauncher):
        init_multihost(MultihostConfig(num_processes=2), "cpu")
    env = dict(MASTER_ADDR="host7", MASTER_PORT="29500", RANK="5",
               WORLD_SIZE="8", LOCAL_RANK="1", LOCAL_WORLD_SIZE="4",
               SLURM_JOB_ID="1", SLURM_STEP_NODELIST="n1", SLURM_NTASKS="8",
               SLURM_PROCID="5", SLURM_LOCALID="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = detect_cluster()
    assert (got.launcher, got.coordinator_address, got.num_processes,
            got.process_id, got.local_rank, got.local_world) == (
                "torchrun", "host7:29500", 8, 5, 1, 4)
    assert local_layout(MultihostConfig()) == (1, 4)
    with pytest.raises(ValueError, match="num_processes=2, but the torchrun "
                                         "environment holds 8 ranks"):
        init_multihost(MultihostConfig(num_processes=2), "cpu")
    with pytest.raises(ValueError, match="together"):
        init_multihost(MultihostConfig("localhost:1", 2), "cpu")
