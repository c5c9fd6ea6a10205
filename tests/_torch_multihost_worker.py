"""One rank of the port's 2-process gloo group (tests/test_torch_multihost.py).

Run as ``python tests/_torch_multihost_worker.py RANK WORLD PORT WORKDIR``.
It reads the inputs the pytest process wrote to WORKDIR/inputs.npz and the
tiny models beside it (JAX's trees, read with ``utils/convert.py``), and
writes WORKDIR/rank<RANK>.json and WORKDIR/rank<RANK>.npz:

  * ``Mesh.all_reduce`` over 4 shards, 2 a rank, f32 and bf16, sum/min/max;
  * the counterpart of tests/_multihost_worker.py::calibration_step_global
    (one dp LWC/LET step at global_mesh(tp=2, dp=2): the loss of the
    rank's rows, the dp mean of loss and gradients) and of
    calibration_run_global (six LWC steps, then the fold);
  * DP serving (``DPServingCoordinator.generate_all``) and its refusal;
  * TP across the ranks, one shard each;
  * sequence-parallel calibration with the ring across the ranks (each
    entry of ``sp_runs``: layer 0's capture pass through the flash ring,
    the plain ring's gradients, then ``calibrate(sp_mesh=...)``).

Imports neither JAX nor the JAX package.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CPU = torch.device("cpu")
OPS = ("sum", "min", "max")


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as int16)."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def all_reduce_case(res, arrays):
    from omniquant_tpu_torch.parallel import global_mesh

    mesh = global_mesh(tp=4, local_shards=2, device=CPU)
    res["mesh"] = dict(local=mesh.local, ranks=mesh.ranks,
                       devices=[str(d) for d in mesh.devices])
    for dtype in (torch.float32, torch.bfloat16):
        parts = mesh.each(lambda p, d: torch.from_numpy(
            np.random.default_rng(100 + p).standard_normal((3, 40)).astype(
                np.float32)).to(dtype))
        for op in OPS:
            got = mesh.run(lambda p, x: mesh.all_reduce(p, x, op), parts)
            a, b = (got[p] for p in mesh.local)
            assert a is b  # one tensor for the rank's shards
            arrays[f"ar_{op}_{str(dtype)[6:]}"] = _bits(a)


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in _leaves(tree[k])]


def _loss_and_grads(block, wcfg, trainable, cfg, x, fp):
    """The MSE of the block's output on the trainables' effective weights
    against ``fp``, and its gradients w.r.t. every trainable."""
    from omniquant_tpu_torch.models import LLAMA

    leaves = _leaves(trainable)
    for t in leaves:
        t.requires_grad_(True)
    eff = LLAMA.effective_block_weights(block, wcfg, trainable["lwc"],
                                        trainable.get("let"), cfg)
    out, _ = LLAMA.block_forward(eff, x, cfg)
    loss = torch.mean((out - fp) ** 2)
    return loss.detach(), leaves, torch.autograd.grad(loss, leaves)


def calibration_step(res, inputs, workdir):
    """One dp x tp calibration step: this rank's rows of the global batch,
    the loss and the gradients of its rows' mean, and their dp mean
    (every rank: the same bits)."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.parallel import global_mesh
    from omniquant_tpu_torch.parallel.multihost import (
        all_processes_agree, dp_mean, process_slice, shard_calibration_batch)
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.utils import load_packed_npz

    cfg = llama.LlamaConfig(**json.loads(str(inputs["step_cfg"])))
    block = load_packed_npz(str(workdir / "step_block.npz"), device=CPU)
    mesh = global_mesh(tp=2, dp=2, local_shards=2, device=CPU)
    sl = process_slice(4)
    x = shard_calibration_batch(mesh, inputs["step_x"][sl])
    fp = shard_calibration_batch(mesh, inputs["step_fp"][sl])
    wcfg = QuantConfig(n_bits=4, group_size=16, lwc=True)
    trainable = {"lwc": llama.init_lwc_params_block(block, wcfg),
                 "let": llama.init_let_params(block, cfg, None)}
    loss, _, grads = _loss_and_grads(block, wcfg, trainable, cfg, x, fp)
    loss, *grads = dp_mean(mesh, [loss] + list(grads))
    assert all_processes_agree(loss)
    res["loss"] = float(loss)
    res["loss_hex"] = float(loss).hex()
    res["grad_norm"] = float(torch.sqrt(sum((g * g).sum() for g in grads)))


def calibration_run(res, inputs, workdir, steps=6):
    """Six dp LWC steps (optax.adamw(1e-2)'s update) on the rank's rows of
    the seeded synthetic corpus, then the fold of q_proj."""
    from omniquant_tpu_torch.calib.data import get_synthetic
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.parallel import global_mesh
    from omniquant_tpu_torch.parallel.multihost import (
        all_processes_agree, dp_mean, process_slice, shard_calibration_batch)
    from omniquant_tpu_torch.quant import QuantConfig, fake_quant_weight
    from omniquant_tpu_torch.utils import load_packed_npz

    cfg = llama.LlamaConfig(**json.loads(str(inputs["run_cfg"])))
    params = load_packed_npz(str(workdir / "run_params.npz"), device=CPU)
    block = params["layers"][0]
    mesh = global_mesh(tp=2, dp=2, local_shards=2, device=CPU)
    train, _ = get_synthetic(8, seed=3, seqlen=16, vocab_size=64)
    rows = torch.as_tensor(train[process_slice(8)], dtype=torch.long)
    emb = params["embed_tokens"][rows].numpy()  # only this rank's rows
    x = shard_calibration_batch(mesh, emb)
    fp = shard_calibration_batch(mesh, emb * np.float32(1.01))
    wcfg = QuantConfig(n_bits=4, group_size=16, lwc=True)
    trainable = {"lwc": llama.init_lwc_params_block(block, wcfg)}
    leaves = _leaves(trainable)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    for _ in range(steps):
        _, leaves_, grads = _loss_and_grads(block, wcfg, trainable, cfg, x,
                                            fp)
        for t, g in zip(leaves_, dp_mean(mesh, grads)):
            t.grad = g
        opt.step()
    with torch.no_grad():
        w = fake_quant_weight(block["q_proj"]["weight"], wcfg,
                              trainable["lwc"]["q_proj"]).numpy()
    w_sum = float(np.abs(w).sum())
    assert all_processes_agree(w_sum)
    res["foldsum"] = w_sum
    res["foldhead"] = [float(v) for v in w[0, :4]]


def dp_serving(res, inputs, workdir):
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.serving import DPServingCoordinator, LlamaEngine
    from omniquant_tpu_torch.utils import load_packed_npz

    cfg = llama.LlamaConfig(**json.loads(str(inputs["serve_cfg"])))
    packed = load_packed_npz(str(workdir / "serve_packed.npz"), device=CPU)
    prompts = json.loads(str(inputs["serve_prompts"]))
    eng = LlamaEngine(packed, cfg, max_batch=4, max_len=32,
                      dtype=torch.float32, device=CPU)
    coord = DPServingCoordinator(eng)
    res["dp"] = dict(pid=coord.pid, nproc=coord.nproc)
    res["servtoks"] = coord.generate_all(prompts, max_new_tokens=9, step=4)
    res["local_slots_after"] = int(eng.active.sum())
    # a submit that would put 5 requests on rank 1 (capacity 4)
    try:
        coord.submit(prompts + prompts[:4])
        res["refusal"] = None
    except RuntimeError as e:
        res["refusal"] = str(e)
    res["after_refusal"] = dict(next_id=coord._next_id,
                                live=len(coord._host_of))


def tp_across_ranks(res, arrays, inputs, workdir):
    """TP at tp 2, one shard a rank: prefill logits of two prompts, and a
    greedy stream."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.parallel import make_mesh
    from omniquant_tpu_torch.serving import TPLlamaEngine
    from omniquant_tpu_torch.utils import load_packed_npz

    cfg = llama.LlamaConfig(**json.loads(str(inputs["serve_cfg"])))
    params = load_packed_npz(str(workdir / "tp_params.npz"), device=CPU)
    prompts = json.loads(str(inputs["serve_prompts"]))
    mesh = make_mesh(tp=2)
    eng = TPLlamaEngine(params, cfg, mesh, max_batch=2, max_len=32,
                        dtype=torch.float32)
    held = [p for p, s in enumerate(eng.shards) if s is not None]
    res["tp"] = dict(local=mesh.local, held=held,
                     heads=eng.local_shards[0].cfg.num_attention_heads)
    slots, logits = eng.add_requests(prompts[:2], return_logits=True)
    arrays["tp_prefill_logits"] = _bits(logits)
    for s in slots:
        eng.release(s)
    res["tp_tokens"] = eng.generate(prompts[0], max_new_tokens=8)


def _flat_into(arrays, prefix, tree):
    """The tensors of a nested dict into ``arrays`` under "prefix/key/..."."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_into(arrays, f"{prefix}/{k}", v)
    elif tree is not None:
        arrays[prefix] = tree.detach().cpu().numpy()


def sp_across_ranks(res, arrays, inputs, workdir):
    """For each SP run: an SPMesh over the ranks (sp / world shards a
    rank); layer 0 through the flash ring on this rank's blocks of
    ``sp_x_<family>``; d(sum(ring * w))/d(q, k, v) of this rank's blocks
    through the plain ring; then calibrate with sp_mesh (its losses, its
    trainables and folded weights)."""
    from omniquant_tpu_torch.calib import CalibConfig, calibrate
    from omniquant_tpu_torch.models import get_family
    from omniquant_tpu_torch.parallel import SPMesh, global_mesh
    from omniquant_tpu_torch.utils import load_packed_npz

    world = torch.distributed.get_world_size()
    res["sp"] = {}
    for run, (name, sp, kw, cfg_kw) in json.loads(
            str(inputs["sp_runs"])).items():
        fam = get_family(name)
        cfg = fam.config_cls(**cfg_kw)
        m = global_mesh(tp=sp, local_shards=sp // world, device=CPU)
        mesh = SPMesh(m.devices, m.ranks)
        params = load_packed_npz(str(workdir / f"sp_{name}.npz"), device=CPU)
        x = torch.from_numpy(inputs[f"sp_x_{name}"])
        s_local = x.shape[1] // sp
        sm_scale = 1.0 if name == "opt" else None

        def capture(p, x_p):
            def attn(q, k, v, spec_):
                return mesh.ring_attention(p, q, k, v, sm_scale=sm_scale,
                                           impl="flash")

            pos = torch.arange(p * s_local, (p + 1) * s_local)
            return fam.block_forward(params["layers"][0], x_p, cfg, None,
                                     pos, attn_impl=attn)[0]

        ys = mesh.run(capture, mesh.each(
            lambda p, d: x[:, p * s_local: (p + 1) * s_local]))
        arrays[f"{run}/capture"] = torch.cat(
            [ys[p] for p in mesh.local], dim=1).numpy()

        qkv = [torch.from_numpy(inputs[f"sp_{t}"]) for t in "qkv"]
        w = torch.from_numpy(inputs["sp_w"])
        s_ring = qkv[0].shape[2] // sp

        def ring_grads(p, *blocks):
            blocks = [b.clone().requires_grad_(True) for b in blocks]
            out = mesh.ring_attention(p, *blocks, impl="plain")
            return out, blocks

        parts = mesh.each(lambda p, d: [t[:, :, p * s_ring:(p + 1) * s_ring]
                                        for t in qkv])
        got = mesh.run(lambda p, b: ring_grads(p, *b), parts)
        loss = sum((got[p][0] * w[:, :, p * s_ring:(p + 1) * s_ring]).sum()
                   for p in mesh.local)
        loss.backward()
        for i, t in enumerate("qkv"):
            arrays[f"{run}/d{t}"] = torch.cat(
                [got[p][1][i].grad for p in mesh.local], dim=2).numpy()

        tokens = inputs[f"sp_tokens_{name}"]
        cc = CalibConfig(epochs=1, nsamples=tokens.shape[0], batch_size=1,
                         **kw)
        losses = []
        params, omni = calibrate(fam, params, cfg, tokens, cc,
                                 progress_cb=lambda i, e, x: losses.append(x),
                                 device="cpu", sp_mesh=mesh)
        res["sp"][run] = dict(losses=losses, local=mesh.local,
                              ranks=mesh.ranks)
        for i, layer in omni.items():
            for group in ("lwc", "let"):
                _flat_into(arrays, f"{run}/omni/{i}/{group}",
                           layer.get(group))
        for i, layer in enumerate(params["layers"]):
            for lin in fam.linear_names:
                arrays[f"{run}/weight/{i}/{lin}"] = (
                    layer[lin]["weight"].numpy())


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    workdir = Path(sys.argv[4])
    torch.set_num_threads(1)
    from omniquant_tpu_torch.parallel import MultihostConfig, init_multihost
    from omniquant_tpu_torch.parallel import multihost

    dev = init_multihost(MultihostConfig(f"localhost:{port}", world, rank,
                                         timeout_s=120), device="cpu")
    res = dict(rank=multihost.process_index(),
               world=multihost.process_count(), device=str(dev),
               backend=torch.distributed.get_backend())
    arrays = {}
    inputs = np.load(workdir / "inputs.npz")
    all_reduce_case(res, arrays)
    calibration_step(res, inputs, workdir)
    calibration_run(res, inputs, workdir)
    dp_serving(res, inputs, workdir)
    tp_across_ranks(res, arrays, inputs, workdir)
    sp_across_ranks(res, arrays, inputs, workdir)
    res["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "omniquant_tpu"))
    np.savez(workdir / f"rank{rank}.npz", **arrays)
    (workdir / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
