"""Where a W4/W2 decode product's time goes on the card: the port of the JAX
package's scripts/exp_ablate_kernel.py.

    python -m omniquant_tpu_torch.scripts.exp_ablate_kernel [--device cuda]

S1 (kernels/probes.ablate_decode) at M = 32, K = N = 4096, planar words at
g128, on K1's planar decode tile (its staging, unpack, MMAs, closes and
split-K plan; no zero points), in three modes:
  full    K1's planar unpack into mma.sync bf16, per-group scales
  noup    the same products on a tile broadcast from x row 0; the words
          are staged but not unpacked
  nodot   the same unpack summed by a bf16x2 add, no products
  dense   bf16 torch.matmul at the same shape (the weight as bf16: 4 times
          the bytes of W4's words)
full minus noup is the unpack's cost, full minus nodot the products'. The
script's noup broadcasts x[0:1, :bn] to (bk, bn) and fails at its bn 2048
> bk 512; that row prints the failure, as the script's does, and noup then
runs at bn = bk. Each row: device time of one product in a chain of 64 (y
fed back as x, so N == K; CUDA events, the host's work queued behind a
device sleep; the words warm in L2, as the chain leaves them). The first
line is the card's name and power limit.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..kernels import probes
from ..quant import QuantConfig, pack_weight
from ._common import card_line, chain_ms, fmt_us, randn

M, K, N, GS = 32, 4096, 4096, 128
N_CHAIN = 64
BN = 2048
WIDTHS = (4, 2)


def ablate_call(pw, mode: str, bn: int):
    """The script's run(mode, pw, x, bn) without its timing: x -> S1."""
    sc = probes.ablate_slabs(pw)
    return lambda x: probes.ablate_decode(mode, x, pw.qweight, sc, pw.bits,
                                          pw.tile_k, pw.group_size, bn)


def run(device="cuda", m=M, k=K, n=N, n_chain=N_CHAIN, bn=BN) -> list:
    """[(label, ms a product, or None on the CPU or where the mode refused,
    output or the refusal)] in the script's order, then noup at bn = bk and
    the dense row."""
    if n != k:
        raise ValueError("the chain feeds y back as x: N == K")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = randn(rng, (m, k), dev, torch.bfloat16)
    w = randn(rng, (n, k), dev, scale=0.02)
    rows = []
    for bits in WIDTHS:
        pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=GS))
        for mode in probes.ABLATE_MODES:
            try:
                call = ablate_call(pw, mode, bn)
                out = call(x)
            except ValueError as e:
                rows.append((f"w{bits} {mode}", None, e))
                continue
            rows.append((f"w{bits} {mode}", chain_ms(call, x, n_chain, dev),
                         out))
        if bn > pw.tile_k:
            call = ablate_call(pw, "noup", pw.tile_k)
            rows.append((f"w{bits} noup bn {pw.tile_k}",
                         chain_ms(call, x, n_chain, dev), call(x)))
    wb = w.t().contiguous().to(torch.bfloat16)
    dense = lambda xx: xx @ wb
    rows.append(("dense bf16", chain_ms(dense, x, n_chain, dev), dense(x)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    for label, ms, out in run(dev):
        if isinstance(out, Exception):
            print(f"{label} failed: {type(out).__name__}: {out}", flush=True)
        elif label == "dense bf16":
            rate = ("" if ms is None else
                    f"{K * N * 2 / (ms * 1e-3) / 1e9:5.0f} GB/s")
            print(f"{label:15s}: {fmt_us(ms)}  {rate}", flush=True)
        else:
            print(f"{label:15s}: {fmt_us(ms)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
