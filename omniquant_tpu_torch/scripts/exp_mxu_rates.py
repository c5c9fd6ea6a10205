"""The tensor cores' bf16 and int8 rates inside a hand-written kernel: the
port of the JAX package's scripts/exp_mxu_rates.py.

    python -m omniquant_tpu_torch.scripts.exp_mxu_rates [--device cuda]

S2 (kernels/probes.mxu_rate_bf16 / mxu_rate_int8): INNER = 64 products of
512 x 512 x 512 operands staged once in shared memory (no device-memory
traffic in the loop), mma.sync m16n8k16 bf16 -> f32 and m16n8k32 s8 -> s32,
the whole repeated 64 times as the script's grid repeats it. Whether the
int8 rate is twice the bf16 rate is the premise of the integer prefill path
(K7, K9). Each row: device time of one call (CUDA events over 16 calls), the
rate 2 M N K INNER 64 over it and its share of the card's dense peak (989
TFLOP/s bf16, 1979 TOP/s int8, H100 SXM at 700 W). The first line is the
card's name and power limit.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..kernels import probes
from ._common import card_line, per_call_ms

M = N = KK = probes.MXU_DEPTH
INNER = probes.MXU_INNER
REPEATS = probes.MXU_REPEATS
REPS = 16
PEAK = {"bf16": 989e12, "int8": 1979e12}


def operands(device, dtype, m=M, n=N, seed=0) -> tuple:
    """The script's operands: standard normal bf16, or int8 x in [-16, 16)
    and w in [-8, 8)."""
    rng = np.random.default_rng(seed)
    if dtype == "bf16":
        x = rng.standard_normal((m, KK)).astype(np.float32)
        w = rng.standard_normal((KK, n)).astype(np.float32)
        conv = torch.bfloat16
    else:
        x = rng.integers(-16, 16, (m, KK)).astype(np.int8)
        w = rng.integers(-8, 8, (KK, n)).astype(np.int8)
        conv = torch.int8
    return (torch.from_numpy(x).to(device, conv),
            torch.from_numpy(w).to(device, conv))


KERNELS = {"bf16": probes.mxu_rate_bf16, "int8": probes.mxu_rate_int8}


def run(device="cuda", m=M, n=N, inner=INNER, repeats=REPEATS,
        reps=REPS) -> list:
    """[(label, ms a call or None on the CPU, operations a call, output)]."""
    dev = resolve_device(device)
    rows = []
    for label, fn in KERNELS.items():
        x, w = operands(dev, label, m, n)
        out = fn(x, w, inner, repeats)
        ms = per_call_ms(lambda: fn(x, w, inner, repeats), reps, dev)
        rows.append((label, ms, probes.mxu_flops(m, n, inner, repeats), out))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    for label, ms, flops, _ in run(dev):
        if ms is None:
            print(f"{label:8s} not measured", flush=True)
            continue
        rate = flops / (ms * 1e-3)
        print(f"{label:8s} {rate / 1e12:7.1f} TOP/s  ({ms:.4f} ms a call, "
              f"{100 * rate / PEAK[label]:.1f} % of the dense peak)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
