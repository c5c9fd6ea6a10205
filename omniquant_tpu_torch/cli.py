"""Command line of the port: quantize, evaluate and serve, with ``main.py``'s
flags (the same names and defaults; ``--platform`` takes ``cuda``, the
default, or ``cpu``).

    python -m omniquant_tpu_torch --synthetic --net tiny-opt --wbits 4 \\
        --abits 16 --group_size 64 --lwc --epochs 2 --nsamples 8 \\
        --seqlen 256 --eval_ppl --real_quant --save_dir out \\
        --serve_prompt "hello" --max_new_tokens 16

Steps, in ``main.py``'s order: load the model (``--synthetic``: a tiny
random model and a character tokenizer; ``--model``: a local HF checkpoint
through ``transformers``); calibrate it (tokens cached under
``--cache_dir``, activation statistics collected or read from
``--act-scales``/``--act-shifts``, ``--resume`` an omni_parameters.npz);
``--save_dir``: write ``model_fakequant.npz`` and ``config.json``, and with
``--real_quant`` also ``model_packed.npz``, in the npz format both packages
read (and with ``--export_autogptq`` ``model_autogptq.pt``, AutoGPTQ's
tensors: ``serving/export_autogptq.py``); ``--eval_ppl``: perplexity on
each test split there is a local copy of (offline, only ``synthetic``);
``--tasks``: the evaluation harness (``eval/harness``: ``run_tasks`` over a
``TorchLM``, its scores cached in the sqlite db ``--eval_cache`` when
given); ``--serve_prompt``: generate with the serving engine. The last
line of standard output is the results JSON.

Unlike ``main.py``, which evaluates and serves the fake-quant weights
whatever the flag says, ``--real_quant`` runs ``--tasks`` and serves
``--serve_prompt`` on the packed model, in bf16 as the engine holds it: the
weights the kernels take; its ``--eval_cache`` fingerprint, main.py's
otherwise, then ends in ``|real_quant``. ``--spec_decode GAMMA`` serves through
``SpecDecoder`` (a layer-skip self-draft of ``--draft_layers`` blocks) and
logs its acceptance, as ``main.py`` does. ``--sp N`` calibrates sequence-
parallel over N shards taken cyclically over the visible devices (N shards
on one card; on the CPU N shards in this process). ``--tp N`` serves
``--serve_prompt`` through the family's tensor-parallel engine
(``serving/tp_engine.py``, ``--tp_overlap`` chunks of each all-reduce) and
scores ``--eval_ppl`` through the tensor-parallel trunk (``parallel/
tp_forward.py``, which takes no activation quantizers, so it needs
``--abits 16``), over the first N visible cards (it exits when there are
fewer; ``chip_smoke.py`` puts N shards on one card through the library),
or N shards in this process on the CPU. ``--num_processes N
--coordinator host:port --process_id R`` joins this process to a group of
N ranks (``parallel/multihost.py``: NCCL where every rank of the host has
a card of its own, else gloo); every rank runs the whole program, the
``--tp`` mesh then spans the ranks (``--tp N --num_processes N``: one
shard a process), and only rank 0 writes files (``--save_dir``, the
calibration's and the caches' npz files, the ``--eval_cache`` db); each
rank logs to a file of its own, ``log_<time>_rank<R>.txt``. Flags whose
machinery is not ported yet (a cluster found without ``--coordinator``,
``--sp`` across ranks) exit with the ROADMAP item that ports it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import time
import types
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="OmniQuant on PyTorch/CUDA")
    p.add_argument("--model", type=str, default=None,
                   help="local HF model path (read through transformers)")
    p.add_argument("--synthetic", action="store_true",
                   help="use a small randomly-initialized model + synthetic data")
    p.add_argument("--net", type=str, default=None,
                   help="model family tag, e.g. opt-125m / llama-7b / tiny-opt")
    p.add_argument("--cache_dir", default="./cache", type=str)
    p.add_argument("--output_dir", default="./log/", type=str)
    p.add_argument("--save_dir", default=None, type=str,
                   help="save fake-quant model (npz pytree)")
    p.add_argument("--export_autogptq", default=False, action="store_true",
                   help="not ported yet")
    p.add_argument("--real_quant", default=False, action="store_true",
                   help="pack the weights into int32 words: saved with "
                        "--save_dir, served with --serve_prompt")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--calib_dataset", type=str, default="wikitext2",
                   choices=["wikitext2", "ptb", "c4", "mix", "pile",
                            "synthetic"])
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--tasks", default="",
                   help="comma-separated harness task names (fnmatch "
                        "patterns)")
    p.add_argument("--eval_cache", default="",
                   help="sqlite path caching the --tasks scores (keyed by "
                        "the flags that change the model)")
    p.add_argument("--eval_ppl", action="store_true")
    p.add_argument("--num_fewshot", type=int, default=0)
    p.add_argument("--wbits", type=int, default=4)
    p.add_argument("--abits", type=int, default=4)
    p.add_argument("--group_size", type=int, default=None)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--let_lr", type=float, default=5e-3)
    p.add_argument("--lwc_lr", type=float, default=1e-2)
    p.add_argument("--wd", type=float, default=0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--let", default=False, action="store_true")
    p.add_argument("--lwc", default=False, action="store_true")
    p.add_argument("--aug_loss", default=False, action="store_true")
    p.add_argument("--symmetric", default=False, action="store_true")
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree of --serve_prompt's engine "
                        "and --eval_ppl's trunk (the first N visible cards; "
                        "N shards in this process on the CPU)")
    p.add_argument("--tp_overlap", type=int, default=1,
                   help="with --tp > 1: split each column-parallel "
                        "all-reduce into this many chunks")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree for calibration: the "
                        "activation buffers split on the sequence axis "
                        "over this many shards (taken cyclically over the "
                        "visible devices: all on one card when there is "
                        "one) and block forwards run ring attention "
                        "(llama and opt)")
    p.add_argument("--offload_layers", action="store_true",
                   help="keep the blocks on the host during calibration, "
                        "one on the device at a time")
    p.add_argument("--bf16_buffers", action="store_true",
                   help="store calibration activations in bfloat16")
    p.add_argument("--act-scales", dest="act_scales", type=str, default=None)
    p.add_argument("--act-shifts", dest="act_shifts", type=str, default=None)
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process: host:port of rank 0 (required "
                        "with --num_processes > 1)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="multi-process: the number of ranks (one "
                        "torch.distributed group)")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-process: this process's rank (required "
                        "with --num_processes > 1)")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="device to run on (cpu: the kernels' plain versions)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly during the run")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--serve_prompt", type=str, default=None,
                   help="after quantization, generate from this prompt with "
                        "the continuous-batching serving engine")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--serve_kv_dtype", type=str, default="native",
                   choices=["native", "int8"],
                   help="serving KV-cache dtype (int8 = quantized cache)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="serving sampling temperature (0 = greedy)")
    p.add_argument("--spec_decode", type=int, default=0, metavar="GAMMA",
                   help="speculative decoding with GAMMA proposals per "
                        "round (layer-skip self-draft of --draft_layers "
                        "blocks). Greedy (--temperature 0): output is the "
                        "plain greedy stream; with --temperature > 0: "
                        "rejection-sampling acceptance")
    p.add_argument("--draft_layers", type=int, default=4,
                   help="blocks in the layer-skip self-draft")
    return p


# the unported flags: (is the flag set, what it needs)
def _unported(args) -> list:
    return [what for used, what in (
        (args.num_processes > 1 and (args.coordinator is None
                                     or args.process_id is None),
         "--num_processes > 1 without --coordinator and --process_id needs "
         "cluster auto-detection (ROADMAP Queue 1 item 3)"),
        (args.num_processes > 1 and args.sp > 1,
         "--sp with --num_processes > 1 needs ring attention across ranks "
         "(ROADMAP Queue 1 item 3)"),
    ) if used]


TINY_CONFIGS = {
    "tiny-opt": dict(vocab_size=256, hidden_size=64, ffn_dim=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     max_position_embeddings=2048),
    "tiny-llama": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=2048),
    "tiny-falcon": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, multi_query=True,
                        parallel_attn=True),
}


class CharTokenizer:
    """ASCII char-level tokenizer for --synthetic runs."""

    eos_token_id = 0

    def __init__(self, vocab_size=256):
        self.vocab_size = vocab_size

    def encode(self, s, add_special_tokens=False):
        return [min(ord(c), self.vocab_size - 1) for c in s]

    def decode(self, tokens):
        return "".join(chr(max(1, int(t))) for t in tokens)

    def __call__(self, s, **kw):
        return types.SimpleNamespace(input_ids=self.encode(s))


def load_model(args, logger, device):
    """Returns (family, model_cfg, params, tokenizer), params on ``device``."""
    import torch

    from .models import get_family

    def family(name):
        try:
            return get_family(name)
        except ValueError as e:  # a family the port does not have
            raise SystemExit(str(e)) from None

    if args.synthetic:
        name = args.net or "tiny-opt"
        fam = family(name)
        kwargs = TINY_CONFIGS.get(name)
        if kwargs is None:
            raise SystemExit(
                f"--synthetic supports nets {sorted(TINY_CONFIGS)}; got {name}")
        cfg = fam.config_cls(**kwargs)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return (fam, cfg, fam.init_params(gen, cfg, device=device),
                CharTokenizer(cfg.vocab_size))

    if not args.model:
        raise SystemExit("need --model <local-hf-path> or --synthetic")
    try:
        from transformers import (
            AutoConfig, AutoModelForCausalLM, AutoTokenizer)
    except ImportError:
        raise SystemExit("--model reads an HF checkpoint through the "
                         "transformers package, which is not installed; "
                         "use --synthetic") from None

    hf_cfg = AutoConfig.from_pretrained(args.model)
    fam = family(args.net or hf_cfg.model_type)
    cfg = fam.config_cls.from_hf(hf_cfg)
    logger.info(f"loading HF weights from {args.model} ...")
    hf_model = AutoModelForCausalLM.from_pretrained(
        args.model, torch_dtype="float32", low_cpu_mem_usage=True)
    params = fam.from_hf_state_dict(hf_model.state_dict(), cfg, device=device)
    del hf_model
    tokenizer = AutoTokenizer.from_pretrained(args.model, use_fast=False)
    return fam, cfg, params, tokenizer


def main(argv=None):
    args = build_parser().parse_args(argv)
    missing = _unported(args)
    if missing:
        raise SystemExit("not ported yet: " + "; ".join(missing))

    import torch

    from . import resolve_device
    from .utils import create_logger

    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    rank = 0
    if args.num_processes > 1:  # main.py:210-217; a failed join raises
        from .parallel.multihost import (
            MultihostConfig, init_multihost, process_index)

        device = init_multihost(MultihostConfig(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id), device)
        rank = process_index()
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    if (args.epochs > 0 and (args.wbits < 16 or args.abits < 16)
            and not (args.lwc or args.let)):
        raise SystemExit("--epochs > 0 requires --lwc or --let")
    if args.tp > 1 and args.eval_ppl and args.abits < 16:
        raise SystemExit(
            "--eval_ppl with --tp > 1 scores through the tensor-parallel "
            "trunk, which takes no activation quantizers (JAX's "
            "make_tp_forward neither): use --abits 16 or --tp 1")
    mesh = None
    if args.tp > 1:
        try:  # fail before calibrating when there are too few cards
            mesh = tp_mesh(device, args.tp)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(str(e)) from None
    for d in (args.output_dir, args.cache_dir, args.save_dir,
              args.profile_dir):
        if d:
            Path(d).mkdir(parents=True, exist_ok=True)
    logger = create_logger(args.output_dir,
                           rank=rank if args.num_processes > 1 else None)
    logger.info(args)
    if args.net is None and args.model:
        args.net = args.model.split("/")[-1]

    prof = None
    with contextlib.ExitStack() as scope:
        if args.debug_nans:
            scope.enter_context(torch.autograd.detect_anomaly())
        if args.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = scope.enter_context(torch.profiler.profile(activities=acts))
        results = _run(args, device, logger, mesh, rank)
    if prof is not None:
        trace = os.path.join(args.profile_dir, "trace.json" if rank == 0
                             else f"trace_rank{rank}.json")
        prof.export_chrome_trace(trace)
        logger.info(f"profiler trace written to {trace}")
    logger.info(json.dumps(results))
    print(json.dumps(results))
    return results


def sp_devices(device, n: int) -> list:
    """An SP mesh of n shards over the visible devices of ``device``'s
    type, taken cyclically: n shards on one card when there is one (as
    main.py gives the CPU n virtual devices)."""
    import torch

    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def tp_mesh(device, n: int):
    """The tensor-parallel mesh of ``--tp n``: across the ranks when a
    process group is up (n / ranks shards a rank, on its device), else
    the first n visible cards (``make_mesh``, which raises when there are
    fewer), or n shards in this process on the CPU."""
    from .parallel import make_mesh, multihost

    if device.type == "cuda" or multihost.initialized():
        return make_mesh(tp=n)
    return make_mesh(tp=n, devices=[device] * n)


def _run(args, device, logger, mesh, rank: int = 0) -> dict:
    """main.py's steps after its set-up: load, calibrate, save, evaluate,
    serve (``mesh``: the tensor-parallel mesh of ``--tp``); returns the
    results. Only rank 0 writes files."""
    import torch

    from . import kernels
    from .calib import CalibConfig, calibrate, collect_act_stats, get_loaders
    from .eval import evaluate_ppl
    from .utils import load_pytree, save_pytree

    family, model_cfg, params, tokenizer = load_model(args, logger, device)
    seqlen = args.seqlen
    results = {}

    cc = CalibConfig(
        wbits=args.wbits, abits=args.abits, group_size=args.group_size,
        symmetric=args.symmetric, lwc=args.lwc, let=args.let,
        alpha=args.alpha, epochs=args.epochs, nsamples=args.nsamples,
        batch_size=args.batch_size, let_lr=args.let_lr, lwc_lr=args.lwc_lr,
        wd=args.wd, aug_loss=args.aug_loss, offload_layers=args.offload_layers,
        buffer_dtype=torch.bfloat16 if args.bf16_buffers else torch.float32,
        output_dir=args.output_dir if rank == 0 else None,
        resume=args.resume)

    omni_parameters = None
    if args.wbits < 16 or args.abits < 16:
        logger.info("=== start quantization ===")
        tick = time.time()
        calib_name = "synthetic" if args.synthetic else args.calib_dataset
        cache = Path(args.cache_dir) / (
            f"calib_{args.net}_{calib_name}_{args.nsamples}_{seqlen}.npz")
        if cache.exists():
            train_tokens = np.load(cache)["tokens"]
            logger.info(f"loaded calibration tokens from {cache}")
        else:
            try:
                train_tokens, _ = get_loaders(
                    calib_name, nsamples=args.nsamples, seed=args.seed,
                    seqlen=seqlen, tokenizer=tokenizer,
                    vocab_size=model_cfg.vocab_size)
            except NotImplementedError as e:
                raise SystemExit(str(e)) from None
            if rank == 0:
                np.savez(cache, tokens=train_tokens)

        act_scales = act_shifts = None
        if args.let:
            if args.act_scales and os.path.exists(args.act_scales):
                act_scales = load_pytree(args.act_scales)
                act_shifts = load_pytree(args.act_shifts)
                logger.info("loaded act scales/shifts from disk")
            else:
                logger.info("collecting act scales/shifts ...")
                act_scales, act_shifts = collect_act_stats(
                    family, params, model_cfg, train_tokens, logger=logger,
                    device=device)
                if rank == 0:
                    save_pytree(f"{args.output_dir}/act_scales.npz",
                                act_scales)
                    save_pytree(f"{args.output_dir}/act_shifts.npz",
                                act_shifts)
        sp_mesh = None
        if args.sp > 1:
            sp_mesh = sp_devices(device, args.sp)
            logger.info(
                f"sequence-parallel calibration over {args.sp} devices "
                f"(ring attention, seqlen {args.seqlen}): "
                f"{[str(d) for d in sp_mesh]}")
        params, omni_parameters = calibrate(
            family, params, model_cfg, train_tokens, cc, act_scales,
            act_shifts, logger=logger, device=device, sp_mesh=sp_mesh)
        logger.info(f"quantization took {time.time() - tick:.1f}s")

    packed = None
    if args.real_quant:
        from .serving import pack_model

        packed = pack_model(family, params, cc.weight_quant_config,
                            omni_parameters, device=device)
    if args.save_dir and rank == 0:
        logger.info(f"saving fake-quant model to {args.save_dir}")
        save_pytree(f"{args.save_dir}/model_fakequant.npz", params)
        with open(f"{args.save_dir}/config.json", "w") as f:
            json.dump({"family": family.name,
                       "config": model_cfg.__dict__,
                       "wbits": args.wbits, "abits": args.abits,
                       "group_size": args.group_size,
                       "symmetric": args.symmetric}, f, indent=2)
        if packed is not None:
            save_pytree(f"{args.save_dir}/model_packed.npz", packed)
            logger.info("saved packed real-quant weights")
            if args.export_autogptq:
                from .serving.export_autogptq import save_autogptq_checkpoint

                save_autogptq_checkpoint(
                    family.name, packed,
                    f"{args.save_dir}/model_autogptq.pt")
                logger.info(
                    "saved AutoGPTQ-format checkpoint (reference "
                    "real-quant interop, quantize/omniquant.py:255-277)")

    tp_forward = None
    if mesh is not None:
        logger.info(f"tensor-parallel over tp={args.tp}: "
                    f"{[str(d) for d in mesh.devices]}"
                    + (f" on ranks {mesh.ranks}" if mesh.spans_processes
                       else ""))
    if args.eval_ppl:
        eval_sets = (["synthetic"] if args.synthetic
                     else ["wikitext2", "ptb", "c4", "ptb-new", "c4-new"])
        if mesh is not None:
            from .parallel import make_tp_model_forward

            tp_forward = make_tp_model_forward(
                family, params, model_cfg, mesh, args.tp_overlap)
        for ds in eval_sets:
            cache = Path(args.cache_dir) / f"testloader_{args.net}_{ds}.npz"
            if cache.exists():
                test_tokens = np.load(cache)["tokens"]
            else:
                try:
                    _, test_tokens = get_loaders(
                        ds, nsamples=0, seed=args.seed, seqlen=seqlen,
                        tokenizer=tokenizer, vocab_size=model_cfg.vocab_size)
                except NotImplementedError as e:  # no local copy
                    logger.info(f"skipping {ds}: {e}")
                    continue
                if rank == 0:
                    np.savez(cache, tokens=test_tokens)
            ppl = evaluate_ppl(
                family, params, model_cfg, test_tokens, seqlen=seqlen,
                spec=cc.act_quant_spec,
                limit=None if args.limit < 0 else args.limit, logger=logger,
                forward=tp_forward)
            logger.info(f"{ds} : {ppl}")
            results[ds] = ppl

    if args.tasks:
        from .eval.harness import run_tasks

        t_results = run_tasks(
            family, packed if packed is not None else params, model_cfg,
            tokenizer, args.tasks.split(","), num_fewshot=args.num_fewshot,
            limit=None if args.limit < 0 else args.limit,
            spec=cc.act_quant_spec, logger=logger,
            cache_db=(args.eval_cache or None) if rank == 0 else None,
            # main.py's fingerprint: every flag that changes the evaluated
            # model, in its order; --real_quant, under which the port (not
            # main.py) evaluates the packed model in bf16, adds a marker, so
            # a db of fake-quant scores never serves it
            cache_fingerprint="|".join(map(str, (
                args.net, args.model, args.wbits, args.abits,
                args.group_size, args.lwc, args.let, args.symmetric,
                args.epochs, args.resume, args.seed,
                args.calib_dataset, args.nsamples, args.batch_size,
                args.seqlen, args.alpha, args.aug_loss,
                args.act_scales, args.act_shifts,
                args.let_lr, args.lwc_lr, args.wd,
                args.sp, args.offload_layers, args.bf16_buffers,
                args.synthetic))) + ("|real_quant" if args.real_quant
                                     else ""),
            device=device,
            dtype=torch.bfloat16 if packed is not None else None)
        results.update(t_results)

    if args.serve_prompt is not None:
        from .serving import FalconEngine, LlamaEngine, OPTEngine

        engine_cls = {"llama": LlamaEngine, "opt": OPTEngine,
                      "falcon": FalconEngine}[family.name]
        max_len = min(getattr(model_cfg, "max_position_embeddings", 2048),
                      2048)
        kw = dict(max_batch=1, max_len=max_len,
                  kv_dtype=args.serve_kv_dtype, auto_grow=False)
        if mesh is not None:
            from .serving import TP_ENGINES

            engine_cls = TP_ENGINES[family.name]
            eng = engine_cls(packed if packed is not None else params,
                             model_cfg, mesh, overlap_chunks=args.tp_overlap,
                             **kw)
        else:
            eng = engine_cls(packed if packed is not None else params,
                             model_cfg, device=device, **kw)
        logger.info(f"serving the {'fake-quant' if packed is None else 'packed'}"
                    f" model with {engine_cls.__name__}")
        toks = tokenizer.encode(args.serve_prompt, add_special_tokens=False)
        if args.spec_decode > 0:
            from .serving import SpecDecoder

            sd = SpecDecoder(eng, draft_layers=args.draft_layers,
                             gamma=args.spec_decode)
            # temperature > 0 takes speculative sampling: the stream is
            # distributed as plain sampling from the target
            out = sd.generate(list(toks), max_new_tokens=args.max_new_tokens,
                              temperature=args.temperature)
            logger.info(f"spec-decode acceptance {sd.acceptance_rate:.2f} "
                        f"({sd.accepted}/{sd.proposed})")
            del sd
        else:
            out = eng.generate(list(toks), max_new_tokens=args.max_new_tokens,
                               temperature=args.temperature)
        del eng
        text = tokenizer.decode(out)
        logger.info(f"generated {len(out)} tokens")
        results["generation"] = text
        print(text)

    logger.info(f"kernel launches: {json.dumps(kernels.launch_counts())}")
    return results
