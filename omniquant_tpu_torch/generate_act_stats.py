"""Standalone activation-statistics tool: counterpart of the repository's
``generate_act_stats.py`` (reference generate_act_scale_shift.py).

Collects per-linear input abs-max scales and EMA midrange shifts over a
calibration set and saves them as npz pytrees for --act-scales/--act-shifts:
``<output_dir>/<net>_scales.npz`` and ``<net>_shifts.npz``.

  python -m omniquant_tpu_torch.generate_act_stats --model /path/to/model \\
      --calib_dataset wikitext2
  python -m omniquant_tpu_torch.generate_act_stats --synthetic --net tiny-opt
"""
import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--net", type=str, default=None)
    p.add_argument("--calib_dataset", type=str, default="wikitext2")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--output_dir", type=str, default="./act_stats")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from . import cli, resolve_device
    from .calib import collect_act_stats, get_loaders
    from .utils import create_logger, save_pytree

    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    logger = create_logger(args.output_dir)
    family, cfg, params, tokenizer = cli.load_model(args, logger, device)
    name = args.net or (args.model or "model").split("/")[-1]
    calib = "synthetic" if args.synthetic else args.calib_dataset
    try:
        tokens, _ = get_loaders(
            calib, nsamples=args.nsamples, seed=args.seed, seqlen=args.seqlen,
            tokenizer=tokenizer, vocab_size=cfg.vocab_size)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    scales, shifts = collect_act_stats(family, params, cfg, tokens,
                                       logger=logger, device=device)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    save_pytree(f"{args.output_dir}/{name}_scales.npz", scales)
    save_pytree(f"{args.output_dir}/{name}_shifts.npz", shifts)
    logger.info(f"saved act scales/shifts for {name} to {args.output_dir}")


if __name__ == "__main__":
    main()
