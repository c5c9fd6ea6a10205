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
    np.savez(work / "inputs.npz", step_x=x, step_fp=fp,
             step_cfg=json.dumps(dataclasses.asdict(step_cfg)),
             run_cfg=json.dumps(dataclasses.asdict(run_cfg)),
             serve_cfg=json.dumps(dataclasses.asdict(cfg)),
             serve_prompts=json.dumps(prompts))
    return dict(cfg=cfg, packed=packed, prompts=prompts, dense=dense)


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
