"""Ablate the W4A4 integer product's cost on the card: the port of the JAX
package's scripts/exp_ablate_int.py.

    python -m omniquant_tpu_torch.scripts.exp_ablate_int [--device cuda]

Variants at m = 4096, K = N = 4096, W4 g128 (all but bf16-pairs take (m, K)
int8 activation codes):
  bf16-pairs    K1 (quant_matmul) on pairs words, bf16 x: the reference point
  int-fused     the port's integer route (quant_matmul_int: K8 + K9 here)
  i8dense-g     S4 (kernels/probes.consume) on pre-unpacked centered int8
                (K, N) codes: 4 group dots of 128 rows a 512-row tile, each
                times its group's scale (exact algebra)
  i8dense-1dot  S4 with one 512-row dot times the first group's scale (wrong
                algebra by design: a rate probe)
int-fused minus i8dense-g is the unpack's cost, i8dense-g minus
i8dense-1dot the group closes'. Each row is the device time a product over
16 products queued back to back (CUDA events), and the rate 2 m K N over
it. The first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..kernels import probes
from ..kernels.quant_matmul import (quant_matmul, quant_matmul_int,
                                    quantize_act_int)
from ..models.common import ActQuantSpec
from ..quant import QuantConfig, pack_weight
from ..quant.packing import unpack_codes
from ._common import card_line, fmt_us, per_call_ms, randn

K = N = 4096
GS = 128
M = 4096
BK = 512
N_CHAIN = 16


def operands(device, m=M, k=K, n=N, seed=0) -> dict:
    """The script's operands from numpy's generator at ``seed``: x bf16,
    its W4A4 codes xc, the centered codes w8 (k, n) of a W4 g128 planar
    pack, its scale slabs (k / BK, 8, n) f32, and the pairs pack of the
    same weight with bf16 scales (K1's)."""
    rng = np.random.default_rng(seed)
    w = randn(rng, (n, k), device, scale=0.02)
    wcfg = QuantConfig(n_bits=4, group_size=GS)
    pw = pack_weight(w, wcfg, layout="planar")
    pairs = pack_weight(w, wcfg, layout="pairs").map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    acfg = ActQuantSpec.from_bits(4).act
    x = randn(rng, (m, k), device, torch.bfloat16)
    xc, _ = quantize_act_int(x, acfg)
    codes = unpack_codes(pw.qweight, 4, k, GS, pw.tile_k, "planar")
    w8 = (codes - 8).to(torch.int8).contiguous()
    n_g = BK // GS
    slabs = torch.nn.functional.pad(
        pw.scales.t().float().reshape(k // BK, n_g, n), (0, 0, 0, 8 - n_g))
    return dict(x=x, xc=xc.contiguous(), w8=w8, slabs=slabs.contiguous(),
                n_g=n_g, pairs=pairs, planar=pw.map_tensors(
                    lambda t: t.to(torch.bfloat16)
                    if t.is_floating_point() else t), acfg=acfg)


def variants(ops: dict) -> dict:
    """label -> the product the row times."""
    return {
        "bf16-pairs": lambda: quant_matmul(ops["x"], ops["pairs"]),
        "int-fused": lambda: quant_matmul_int(ops["x"], ops["planar"],
                                              ops["acfg"]),
        "i8dense-g": lambda: probes.consume(ops["xc"], ops["w8"],
                                            ops["slabs"], ops["n_g"]),
        "i8dense-1dot": lambda: probes.consume(ops["xc"], ops["w8"],
                                               ops["slabs"], 1),
    }


def run(device="cuda", m=M, k=K, n=N, n_chain=N_CHAIN) -> list:
    """Each variant once, then timed: [(label, ms a product or None on the
    CPU, its output)]."""
    dev = resolve_device(device)
    ops = operands(dev, m, k, n)
    rows = []
    for label, fn in variants(ops).items():
        out = fn()
        rows.append((label, per_call_ms(fn, n_chain, dev), out))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    for label, ms, _ in run(dev):
        rate = ("" if ms is None else
                f"{2 * M * K * N / (ms * 1e-3) / 1e12:6.1f} TF/s eff")
        print(f"{label:14s} {fmt_us(ms)}/gemm  {rate}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
