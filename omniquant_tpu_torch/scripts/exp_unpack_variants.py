"""Which unpack lets a low-bit decode product run at its byte advantage: the
port of the JAX package's scripts/exp_unpack_variants.py.

    python -m omniquant_tpu_torch.scripts.exp_unpack_variants [--device cuda]

Variants at the decode shape M = 32, K = N = 4096, planar words at g128:
  cur     K1 (quant_matmul): codes through a shift, a mask and a bf16
          subtract into mma.sync bf16, per-group scales after the products
  f32inj  S3 (kernels/probes.f32inj_matmul): mantissa injection, each code
          the f32 1 + c/2^b by shift, mask, shift and or (no int-to-float
          conversion) into the TF32 tensor cores, the 2^b and the -1 folded
          into the scale slabs (power-of-two widths only: W3 has none)
for W4, W2, W3 and W8. Each row: device time of one product in a chain of
64 (y fed back as x; CUDA events, the host's work queued behind a device
sleep; the words warm in L2), the words' bytes over it, and for f32inj
its error against quant_matmul_reference relative to the largest |output|.
The first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..kernels import probes
from ..kernels.quant_matmul import quant_matmul, quant_matmul_reference
from ..quant import QuantConfig, pack_weight
from ._common import card_line, chain_ms, fmt_us, randn

M = 32
K = N = 4096
GS = 128
N_CHAIN = 64
WIDTHS = (4, 2, 3, 8)


def f32inj_call(pw):
    """The script's make_call: the slabs once, then x -> S3's product."""
    sc2, off2 = probes.f32inj_slabs(pw)
    return lambda x: probes.f32inj_matmul(x, pw.qweight, sc2, off2, pw.bits,
                                          pw.tile_k, pw.group_size)


def run(device="cuda", m=M, k=K, n=N, n_chain=N_CHAIN) -> list:
    """[(label, ms a product or None on the CPU, words' bytes, rel err or
    None, output)] in the script's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = randn(rng, (m, k), dev, torch.bfloat16)
    rows = []
    for bits in WIDTHS:
        w = randn(rng, (n, k), dev, scale=0.02)
        pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=GS))
        nbytes = pw.qweight.numel() * 4
        k1 = pw.map_tensors(
            lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
        call = lambda xx, k1=k1: quant_matmul(xx, k1)
        rows.append((f"w{bits} cur", chain_ms(call, x, n_chain, dev), nbytes,
                     None, call(x)))
        if bits in (2, 4, 8):  # the injection takes power-of-two widths
            call = f32inj_call(pw)
            got = call(x)
            want = quant_matmul_reference(x.float(), pw)
            err = ((got.float() - want).abs().max()
                   / (want.abs().max() + 1e-9)).item()
            rows.append((f"w{bits} f32inj", chain_ms(call, x, n_chain, dev),
                         nbytes, err, got))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    for label, ms, nbytes, err, _ in run(dev):
        rate = "" if ms is None else f"{nbytes / (ms * 1e-3) / 1e9:5.0f} GB/s"
        tail = "" if err is None else f"  (rel err {err:.2e})"
        print(f"{label:11s}: {fmt_us(ms)}  {rate}{tail}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
