#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``omniquant_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository checkout around this file; without either it exits non-zero and
prints no result. Any failure raises, so the exit code is non-zero.

1. build   -- compile every ``omniquant_tpu_torch/csrc/*.cu`` with nvcc
              into ``build/`` (one nvcc per source, all started at once).
2. kernels -- each hand-written kernel against its plain PyTorch version at
              the shapes of the LLaMA-7B serving path, in bf16 (int8 codes
              and f32 scales for the int8 cache), with the per-element
              tolerance stated in KERNELS
              (omniquant_tpu_torch/kernels/tolerance.py); device times of
              the kernel, the plain version and one PyTorch library call as
              a yardstick (CUDA events, launches queued behind a device
              sleep so no host time falls inside), beside the least time
              the card could take for this run's inputs.
3. serve   -- LLaMA-7B widths and depth (vocab 32000, hidden 4096, inter
              11008, 32 layers, 32/32 heads), random weights from a seeded
              torch.Generator, packed W4 g128 (pairs layout) by pack_model,
              one packed model shared by four engines, built and freed one
              after another:
              A  bf16 KV, max_batch 32, max_len 512: add_requests of 32
                 prompts of 128 tokens, 32 tokens by step_n(., 8);
              B  bf16 KV, max_batch 8, max_len 2048: 8 prompts of 1024
                 tokens (flash attention), 8 tokens by step_n(., 8);
              C  int8 KV, max_batch 32, max_len 512: 32 x 128 prompts, one
                 step (K4 on codes and planes, K6), step_n(., 8) x 4 (K6
                 with the ring, K5 flush), verify_step of 4 tokens on every
                 slot (K5);
              D  int8 KV, max_batch 8, max_len 2048: 8 x 1024 prompts (K2,
                 K3 on codes), step_n(., 8) x 2 at a 2048 window.
              Each engine's run starts with the launch counts set to 0 and
              ends by reading them; every kernel of its path must have
              launched.
4. e2e     -- at full width and 2 layers, the prefill logits and first
              decode logits of a bf16-KV and an int8-KV engine against a
              forward of the same packed model composed of plain PyTorch ops
              in f32, and the int8 engine's fused decode attention against
              its dequantized dense path.

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON line ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--out`` also writes every measurement
to a JSON file.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor cores

# kernel -> (replaced TPU kernel, source, tolerance rule)
KERNELS = {
    "quant_matmul": (
        "omniquant_tpu/kernels/quant_matmul.py:276",
        "omniquant_tpu_torch/csrc/quant_matmul.cu",
        "per element 2 bf16 ulps of |plain| + 2^-10 (both round an f32 sum "
        "to bf16 once)"),
    "flash_attention": (
        "omniquant_tpu/kernels/flash_attention.py:146",
        "omniquant_tpu_torch/csrc/flash_attention.cu",
        "per element 2 bf16 ulps of |plain| + 2^-8 * (plain attention over "
        "|v|) (the kernel rounds p to bf16 for p.v)"),
    "kv_cache_prefill_write": (
        "omniquant_tpu/kernels/kv_update.py:230",
        "omniquant_tpu_torch/csrc/kv_update.cu", "exact"),
    "kv_cache_write": (
        "omniquant_tpu/kernels/kv_update.py:123",
        "omniquant_tpu_torch/csrc/kv_update.cu", "exact"),
    "kv_cache_write_span": (
        "omniquant_tpu/kernels/kv_update.py:348",
        "omniquant_tpu_torch/csrc/kv_update.cu", "exact"),
    "decode_attention_int8": (
        "omniquant_tpu/kernels/decode_attention.py:284",
        "omniquant_tpu_torch/csrc/decode_attention.cu",
        "per element 2 bf16 ulps of |plain| + 2^-10 (both keep scores, "
        "softmax and p*vs in f32 and round the output to bf16 once)"),
}

# kernels each engine of the serve phase must launch
SERVE_PATHS = {
    "A": ("quant_matmul", "kv_cache_prefill_write", "kv_cache_write"),
    "B": ("quant_matmul", "flash_attention", "kv_cache_prefill_write",
          "kv_cache_write"),
    "C": ("quant_matmul", "kv_cache_prefill_write", "kv_cache_write",
          "kv_cache_write_span", "decode_attention_int8"),
    "D": ("quant_matmul", "flash_attention", "kv_cache_prefill_write",
          "kv_cache_write_span", "decode_attention_int8"),
}

# e2e tolerance on logits, relative to the reference's rms / max magnitude:
# the engine rounds activations to bf16 at every op (2^-9 relative each)
# through 2 layers of 4096/11008-wide sums, the reference stays in f32. The
# same engine running every plain version instead of a kernel (on the CPU)
# shows the same error, so it is the bf16 rounding and not a kernel's. The
# int8 cache moves each k/v element by at most 1/254 of its row's largest
# value, below that bf16 rounding, and is held to the same bounds. Its
# fused decode attention and its dense path (which rounds the scales and
# the dequantized window to bf16) are two bf16 engines that differ only in
# where they round, and are held to the same bounds against each other.
E2E_RMS_REL, E2E_MAX_REL = 5e-2, 1e-1


def log(*a):
    print(*a, flush=True)


def rms_rel_err(got, want) -> float:
    d = got.float() - want.float()
    return (d.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()).item()


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


class Timer:
    """Median device time of single launches, with the 50 MB L2 cache
    overwritten before each one (the serving path meets its weights cold).

    Every launch and its two events are queued behind a sleep on the device,
    so the host's work per call (a wrapper's checks, the ctypes conversion
    of its arguments) happens while the device sleeps and lies outside the
    timed windows. If the device reaches the first window before the last
    call is queued, the sleep is lengthened and the run repeated; a function
    that synchronises (an index by a mask) defeats that, and its label goes
    to ``host_in_window``: its time includes host time."""

    SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's ~2 GHz clock

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.host_in_window = []

    def __call__(self, fn, label: str, iters=10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        cycles = self.SLEEP_CYCLES
        for _ in range(3):
            torch.cuda._sleep(cycles)
            marks = []
            for _ in range(iters):
                self.flush.zero_()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                marks.append((s, e))
            hidden = not marks[0][0].query()
            torch.cuda.synchronize()
            if hidden:
                break
            cycles *= 4
        if not hidden:
            self.host_in_window.append(label)
        ms = sorted(s.elapsed_time(e) for s, e in marks)
        return ms[len(ms) // 2]


# ---------------------------------------------------------------------------
def build(out: dict):
    from omniquant_tpu_torch.kernels import _build

    t0 = time.time()
    logs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    out["build_s"] = time.time() - t0
    out["ptxas"] = {n: [ln for ln in s.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, s in logs.items()}
    log(f"build: {sorted(logs)} compiled in {out['build_s']:.1f} s")
    for n, lines in out["ptxas"].items():
        for ln in lines:
            log(f"  ptxas {n}: {ln.strip()}")


def check_quant_matmul(torch, device, timer, dims, out: dict) -> dict:
    """K1 at the decode (m = 32) and prefill shapes of the serving path;
    the JSON entry sums one decoder layer's four decode products."""
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_reference)
    from omniquant_tpu_torch.quant import QuantConfig, dequantize_packed
    from omniquant_tpu_torch.quant import pack_weight

    H, I = dims["hidden"], dims["inter"]
    shapes = {"qkv": (H, 3 * H), "o": (H, H), "gate_up": (H, 2 * I),
              "down": (I, H)}
    ms_list = [(32, ("qkv", "o", "gate_up", "down")),
               (dims["prefill_m"], ("qkv", "o", "down")),
               (dims["flash_m"], ("qkv", "o", "down"))]
    gen = torch.Generator(device=device).manual_seed(1234)
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                       "max_abs_err": 0.0}
    wcfg = QuantConfig(n_bits=4, group_size=128)
    for name, (K, N) in shapes.items():
        w = torch.randn(N, K, generator=gen, device=device) * 0.02
        pw = pack_weight(w, wcfg, layout="auto")
        del w
        # the engine serves bf16-rounded scales and zeros
        pw = pw.map_tensors(
            lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
        w_lib = dequantize_packed(pw, dtype=torch.bfloat16)  # (K, N)
        for m, names in ms_list:
            if name not in names:
                continue
            x = torch.randn(m, K, generator=gen, device=device).to(
                torch.bfloat16)
            got = quant_matmul(x, pw)
            want = quant_matmul_reference(x, pw)
            torch.cuda.synchronize()
            ok, err, worst = tolerance.bf16_close(
                got, want, tolerance.QUANT_MATMUL_SLACK)
            rel = rms_rel_err(got, want)
            if not ok:
                raise AssertionError(
                    f"quant_matmul {name} m={m}: max abs err {err}, "
                    f"{worst:.3g} x its per-element bound")
            lbl = f"quant_matmul {name} m={m}"
            t = timer(lambda: quant_matmul(x, pw), lbl)
            t_plain = timer(lambda: quant_matmul_reference(x, pw),
                            lbl + " plain", iters=3)
            t_lib = timer(lambda: torch.matmul(x, w_lib), lbl + " library")
            nbytes = (pw.qweight.numel() * 4 + pw.scales.numel() * 2
                      + pw.zeros.numel() * 2 + x.numel() * 2 + m * N * 2)
            flops = 2.0 * m * K * N
            b, by = bound_ms(nbytes, flops)
            row = dict(shape=name, m=m, K=K, N=N, ms=t, plain_ms=t_plain,
                       library_ms=t_lib, bound_ms=b, bound_by=by,
                       max_abs_err=err, err_over_bound=worst, rms_rel=rel)
            rows.append(row)
            log(f"  quant_matmul {name:7s} m={m:5d} K={K:5d} N={N:5d}: "
                f"max abs err {err:.3g} ({worst:.3g} x bound, rms rel "
                f"{rel:.2g})  kernel {t:.4f} ms  plain {t_plain:.4f}  "
                f"library {t_lib:.4f}  bound {b:.4f} ({by})")
            if m == 32:
                for k_, v_ in (("ms", t), ("plain_ms", t_plain),
                               ("library_ms", t_lib), ("bound_ms", b)):
                    total[k_] += v_
                total["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
                total["ops_ms"] += flops / BF16_FLOPS_PER_S * 1e3
            total["max_abs_err"] = max(total["max_abs_err"], err)
        del pw, w_lib
    out["quant_matmul_shapes"] = rows
    return dict(
        ms=total["ms"], plain_ms=total["plain_ms"],
        library_ms=total["library_ms"], bound_ms=total["bound_ms"],
        bound_by="bytes" if total["bytes_ms"] >= total["ops_ms"]
        else "operations", max_abs_err=total["max_abs_err"],
        shape="one decoder layer at decode, m=32: qkv 4096x12288, o "
              "4096x4096, gate_up 4096x22016, down 11008x4096")


def check_flash(torch, device, timer, dims) -> dict:
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    B, S, Hh, D = dims["flash_batch"], dims["flash_len"], dims["heads"], 128
    gen = torch.Generator(device=device).manual_seed(99)
    q, k, v = (torch.randn(B, Hh, S, D, generator=gen, device=device).to(
        torch.bfloat16) for _ in range(3))
    scale = D ** -0.5
    got = flash_attention(q, k, v, sm_scale=scale)
    want = flash_attention_plain(q, k, v, sm_scale=scale)
    ok, err, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(q, k, v, sm_scale=scale))
    rel = rms_rel_err(got, want)
    if not ok:
        raise AssertionError(f"flash_attention: max abs err {err}, "
                             f"{worst:.3g} x its per-element bound")
    t = timer(lambda: flash_attention(q, k, v, sm_scale=scale),
              "flash_attention")
    t_plain = timer(lambda: flash_attention_plain(q, k, v, sm_scale=scale),
                    "flash_attention plain", iters=3)
    t_lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), "flash_attention library")
    nbytes = 4 * q.numel() * 2
    flops = 4.0 * B * Hh * S * S * D / 2  # causal: half the score matrix
    b, by = bound_ms(nbytes, flops)
    log(f"  flash_attention ({B},{Hh},{S},{D}) causal: max abs err "
        f"{err:.3g} ({worst:.3g} x bound, rms rel {rel:.2g})  kernel "
        f"{t:.4f} ms  plain {t_plain:.4f}  "
        f"sdpa {t_lib:.4f}  bound {b:.4f} ({by})")
    return dict(ms=t, plain_ms=t_plain, library_ms=t_lib, bound_ms=b,
                bound_by=by, max_abs_err=err, err_over_bound=worst,
                shape=f"q/k/v ({B}, {Hh}, {S}, {D}) bf16, causal")


def check_kv(torch, device, timer, dims, out: dict) -> tuple:
    """K3 on a 32 x 128 prefill, K4 on the bf16 k+v rows of a decode step
    and on the int8 codes and scale planes of one (one launch each), K5 on
    an 8-row ring flush of codes and planes (one launch): all exact."""
    from omniquant_tpu_torch.kernels.kv_update import (
        kv_cache_prefill_write, kv_cache_prefill_write_plain, kv_cache_write,
        kv_cache_write_plain, kv_cache_write_span, kv_cache_write_span_plain)

    B, Hh, S, D = dims["batch"], dims["heads"], dims["max_len"], 128
    Sp, span = dims["prompt_len"], dims["ring"]
    gen = torch.Generator(device=device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(
            torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def exact(name, got, want):
        torch.cuda.synchronize()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        if err != 0:
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{err}")
        return err

    cache = rnd(B, Hh, S, D)
    new = rnd(B, Hh, Sp, D)
    slots = torch.randperm(B, generator=gen, device=device).to(torch.int32)
    a, b_ = cache.clone(), cache.clone()
    kv_cache_prefill_write(a, new, slots)
    kv_cache_prefill_write_plain(b_, new, slots)
    err3 = exact("kv_cache_prefill_write", [a], [b_])
    sl = slots.long()
    t3 = timer(lambda: kv_cache_prefill_write(a, new, slots),
               "kv_cache_prefill_write")
    t3p = timer(lambda: kv_cache_prefill_write_plain(b_, new, slots),
                "kv_cache_prefill_write plain")
    t3l = timer(lambda: a.__setitem__((sl, slice(None), slice(0, Sp)), new),
                "kv_cache_prefill_write library")
    b3, by3 = bound_ms(2 * nbytes([new]), 0)
    log(f"  kv_cache_prefill_write new {tuple(new.shape)} -> "
        f"{tuple(cache.shape)}: exact  kernel {t3:.4f} ms  plain "
        f"{t3p:.4f}  slice-assign {t3l:.4f}  bound {b3:.4f}")
    del a, b_, cache, new

    ar = torch.arange(B, device=device)

    def write_case(name, bufs, news, lengths, writer, plain, label):
        """Kernel vs plain (exact), then device times of the kernel, the
        plain version and one indexed assignment per buffer."""
        mine = [t.clone() for t in bufs]
        ref = [t.clone() for t in bufs]
        writer(mine, news, lengths)
        for r, n in zip(ref, news):
            plain(r, n, lengths)
        err = exact(name, mine, ref)
        span_ = news[0].shape[2] if name == "kv_cache_write_span" else 1
        pos = lengths.long()[:, None] + torch.arange(span_, device=device)

        def lib():
            for c, n in zip(mine, news):
                n = n if span_ > 1 else n.unsqueeze(2)
                c[ar[:, None], :, pos] = n.transpose(1, 2)

        t = timer(lambda: writer(mine, news, lengths), name + " " + label)
        tp = timer(lambda: [plain(r, n, lengths) for r, n in zip(ref, news)],
                   name + " " + label + " plain")
        tl = timer(lib, name + " " + label + " library")
        b, by = bound_ms(2 * nbytes(news), 0)
        log(f"  {name} {label}: exact  kernel {t:.4f} ms  plain {tp:.4f}  "
            f"index-assign {tl:.4f}  bound {b:.6f}")
        return dict(ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
                    bound_by=by, max_abs_err=err,
                    shape=f"{label} -> caches of {tuple(bufs[0].shape)}")

    lengths = torch.randint(0, S, (B,), generator=gen, device=device,
                            dtype=torch.int32)
    k4_bf16 = write_case(
        "kv_cache_write", [rnd(B, Hh, S, D), rnd(B, Hh, S, D)],
        [rnd(B, Hh, D), rnd(B, Hh, D)], lengths, kv_cache_write,
        kv_cache_write_plain, f"bf16 k+v rows {(B, Hh, D)}")
    out["kv_cache_write_bf16"] = k4_bf16
    int8_bufs = [codes(B, Hh, S, D), codes(B, Hh, S, D),
                 torch.rand(B, Hh, S, generator=gen, device=device),
                 torch.rand(B, Hh, S, generator=gen, device=device)]
    k4 = write_case(
        "kv_cache_write", int8_bufs,
        [codes(B, Hh, D), codes(B, Hh, D),
         torch.rand(B, Hh, generator=gen, device=device),
         torch.rand(B, Hh, generator=gen, device=device)],
        lengths, kv_cache_write, kv_cache_write_plain,
        f"int8 k+v codes {(B, Hh, D)} + k+v scales {(B, Hh)}")
    base = torch.randint(0, S - span + 1, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    k5 = write_case(
        "kv_cache_write_span", int8_bufs,
        [codes(B, Hh, span, D), codes(B, Hh, span, D),
         torch.rand(B, Hh, span, generator=gen, device=device),
         torch.rand(B, Hh, span, generator=gen, device=device)],
        base, kv_cache_write_span, kv_cache_write_span_plain,
        f"int8 k+v codes {(B, Hh, span, D)} + k+v scales {(B, Hh, span)}")
    k3 = dict(ms=t3, plain_ms=t3p, library_ms=t3l, bound_ms=b3,
              bound_by=by3, max_abs_err=err3,
              shape=f"new {(B, Hh, Sp, D)} -> cache {(B, Hh, S, D)}")
    return k3, k4, k5


def check_decode_attention(torch, device, timer, dims, out: dict) -> dict:
    """K6 at the int8 serving shapes: batch 32 with windows 256 and 512 of
    a 512 cache, batch 8 with a 2048 window, lengths straddling 1024 and a
    ring of 8 at ring_n 0 and 7. The JSON entry is engine C's decode shape
    (batch 32, window 256). The bound counts the positions this run's
    lengths make live; the yardstick is scaled_dot_product_attention over
    the window already dequantized to bf16 (it reads twice the bytes)."""
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)

    Hh, D, R = dims["heads"], 128, dims["ring"]
    gen = torch.Generator(device=device).manual_seed(11)
    ss = D ** -0.5

    def int8_kv(B, S):
        c = [torch.randint(-127, 128, (B, Hh, S, D), generator=gen,
                           device=device, dtype=torch.int8)
             for _ in range(2)]
        sc = [0.001 + 0.019 * torch.rand(B, Hh, S, generator=gen,
                                         device=device) for _ in range(2)]
        return c[0], sc[0], c[1], sc[1]

    def edge_lengths(B, kv_len):
        lens = torch.randint(0, kv_len, (B,), generator=gen, device=device,
                             dtype=torch.int32)
        lens[0], lens[1] = 0, kv_len - 1
        return lens

    b32 = int8_kv(dims["batch"], dims["max_len"])
    b8 = int8_kv(dims["flash_batch"], 2 * dims["flash_len"])
    ring = int8_kv(dims["flash_batch"], R)
    straddle = torch.tensor([1023, 1024, 2047, 0, 1500, 512, 1022, 1025],
                            dtype=torch.int32, device=device)
    cases = [("b32 kv256", b32, edge_lengths(dims["batch"], 256), 256, -1),
             ("b32 kv512", b32, edge_lengths(dims["batch"], 512), 512, -1),
             ("b8 kv2048", b8, straddle, 2048, -1),
             # a staged step_n passes lengths base - 1: slot 3 is idle
             ("b8 kv2048 ring 0", b8, straddle - 1, 2048, 0),
             ("b8 kv2048 ring 7", b8, straddle - 1, 2048, R - 1)]
    rows = []
    for label, kv, lens, kv_len, ring_n in cases:
        B = kv[0].shape[0]
        q = torch.randn(B, Hh, D, generator=gen, device=device).to(
            torch.bfloat16)
        rk = ring if ring_n >= 0 else None
        args = (q, *kv, lens, kv_len, ss)
        kw = dict(ring_kv=rk, ring_n=ring_n)
        got = decode_attention_int8(*args, **kw)
        want = decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        ok, err, worst = tolerance.bf16_close(
            got, want, tolerance.DECODE_ATTENTION_SLACK)
        if not (ok and torch.isfinite(got.float()).all()):
            raise AssertionError(f"decode_attention_int8 {label}: max abs "
                                 f"err {err}, {worst:.3g} x its bound")
        t = timer(lambda: decode_attention_int8(*args, **kw),
                  "decode_attention_int8 " + label)
        tp = timer(lambda: decode_attention_int8_plain(*args, **kw),
                   "decode_attention_int8 plain " + label, iters=3)
        # yardstick: SDPA over the dequantized bf16 window (and ring)
        kd = (kv[0][:, :, :kv_len].float() * kv[1][:, :, :kv_len, None])
        vd = (kv[2][:, :, :kv_len].float() * kv[3][:, :, :kv_len, None])
        pos = torch.arange(kv_len, device=device)
        mask = pos[None, :] <= lens[:, None]
        if rk is not None:
            kd = torch.cat([kd, rk[0].float() * rk[1][..., None]], dim=2)
            vd = torch.cat([vd, rk[2].float() * rk[3][..., None]], dim=2)
            rmask = (torch.arange(R, device=device) <= ring_n)[None]
            mask = torch.cat([mask, rmask.expand(B, R)], dim=1)
        kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
        mask = mask[:, None, None, :]
        t_lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask, scale=ss),
            "decode_attention_int8 library " + label)
        del kd, vd
        live = lens.long().add(1).clamp(0, kv_len).sum().item()
        live += B * (ring_n + 1 if ring_n >= 0 else 0)
        nbytes = live * Hh * (2 * D + 2 * 4) + 2 * q.numel() * 2
        flops = 4.0 * live * Hh * D
        b, by = bound_ms(nbytes, flops, F32_FLOPS_PER_S)
        rows.append(dict(case=label, ms=t, plain_ms=tp, library_ms=t_lib,
                         bound_ms=b, bound_by=by, max_abs_err=err,
                         err_over_bound=worst, live_positions=live))
        log(f"  decode_attention_int8 {label} ({B},{Hh},·,{D}): max abs err "
            f"{err:.3g} ({worst:.3g} x bound)  kernel {t:.4f} ms  plain "
            f"{tp:.4f}  sdpa-bf16 {t_lib:.4f} (reads 2x the bytes)  bound "
            f"{b:.4f} ({by}, {live} live positions)")
    out["decode_attention_shapes"] = rows
    head = dict(rows[0])
    head["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    head["shape"] = ("q (32, 32, 128) bf16 over int8 codes (32, 32, 512, "
                     "128) + f32 scales, window 256, random lengths with 0 "
                     "and 255; library: SDPA over the bf16-dequantized "
                     "window, 2x the bytes")
    return head


def unported_bounds(dims, out: dict) -> None:
    """Bounds, from the shapes alone, of the W4A4 kernels still to port,
    over the four LLaMA-7B projections (qkv, o, gate_up, down), W4 g128:
    K7 quant_matmul_int (int8 activation codes x packed codes, f32 group
    scales and offsets, bf16 out) at decode m = 32; K8 _unpack_to_int8
    (packed words -> dense int8 codes, independent of m) and K9
    _quant_matmul_int_dense (dense int8 x int8, plus xsum x offsets) at
    m = 4096."""
    H, I, gs = dims["hidden"], dims["inter"], 128
    shapes = ((H, 3 * H), (H, H), (H, 2 * I), (I, H))
    res = {}
    for name, m in (("quant_matmul_int", 32), ("_unpack_to_int8", 4096),
                    ("_quant_matmul_int_dense", 4096)):
        nbytes = flops = 0.0
        for K, N in shapes:
            groups = 2 * N * (K // gs) * 4            # f32 scales + offsets
            if name == "quant_matmul_int":
                nbytes += K * N / 2 + groups + m * K + m * 4 + m * N * 2
                flops += 2.0 * m * K * N
            elif name == "_unpack_to_int8":
                nbytes += K * N / 2 + K * N
            else:
                nbytes += (K * N + groups + m * K + m * (K // gs) * 4
                           + m * 4 + m * N * 2)
                flops += 2.0 * m * K * N
        b, by = bound_ms(nbytes, flops, INT8_OPS_PER_S)
        res[name] = dict(m=m, bound_ms=b, bound_by=by, bytes=nbytes,
                         ops=flops)
        log(f"  {name} (four 7B projections, m={m}): bound {b:.4f} ms "
            f"({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GOP int8)")
    out["unported_bounds"] = res


# ---------------------------------------------------------------------------
def make_packed(torch, cfg, device, seed):
    """Random dense weights from a seeded generator, packed W4 g128."""
    from omniquant_tpu_torch.models import LLAMA, llama
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model

    gen = torch.Generator(device=device).manual_seed(seed)
    dense = llama.init_params(gen, cfg, dtype=torch.float32, device=device)
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        device=device)
    return packed


def prompts(torch, n, length, vocab, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (n, length), generator=gen).tolist()


def serve(torch, device, cfg, dims, seed, out: dict) -> dict:
    """The main path: four engines (SERVE_PATHS) through their user entry
    points, one after another on one packed model. Returns the launch
    counts summed over the four runs."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.serving import LlamaEngine

    t0 = time.time()
    packed = make_packed(torch, cfg, device, seed)
    torch.cuda.synchronize()
    out["pack_s"] = time.time() - t0
    log(f"serve: {cfg.num_hidden_layers}-layer model packed W4 g128 in "
        f"{out['pack_s']:.1f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, time.time() - t

    def check_streams(toks, n_new):
        if any(len(v) != n_new or not all(0 <= t < cfg.vocab_size for t in v)
               for v in toks.values()):
            raise AssertionError("engine returned malformed token streams")

    def run(name, eng, n, length, steps, step_n, single_step=False,
            verify=0):
        reqs = prompts(torch, n, length, cfg.vocab_size, seed + length)
        res = {}
        slots, res["prefill_s"] = timed(lambda: eng.add_requests(reqs))
        last = {s: eng._pending_next[s] for s in slots}
        toks = {s: [t] for s, t in last.items()}
        if single_step:
            last, res["step_s"] = timed(lambda: eng.step(last))
            for s_, t in last.items():
                toks[s_].append(t)
        t_dec = 0.0
        for _ in range(steps // step_n):
            out_, t = timed(lambda: eng.step_n(last, step_n))
            t_dec += t
            for s_, r in out_.items():
                toks[s_].extend(r)
                last[s_] = r[-1]
        check_streams(toks, 1 + int(single_step) + steps)
        if verify:
            ver, res["verify_s"] = timed(lambda: eng.verify_step(
                {s_: toks[s_][-verify:] for s_ in slots}))
            check_streams(ver, verify)
            res["verify_tok_s"] = n * verify / res["verify_s"]
        for s_ in slots:
            eng.release(s_)
        res.update(decode_s=t_dec, prefill_tok_s=n * length / res["prefill_s"],
                   decode_tok_s=n * steps / t_dec,
                   distinct_tokens=len({t for v in toks.values() for t in v}))
        line = (f"  engine {name} {n}x{length}: prefill "
                f"{res['prefill_tok_s']:.1f} tok/s ({res['prefill_s']:.3f} s),"
                f" decode {res['decode_tok_s']:.1f} tok/s over {steps} "
                f"step_n tokens ({t_dec:.3f} s)")
        if single_step:
            line += f", one step {res['step_s'] * 1e3:.2f} ms"
        if verify:
            line += (f", verify of {verify} tokens {res['verify_s']:.3f} s "
                     f"({res['verify_tok_s']:.1f} tok/s)")
        log(line)
        return res

    plans = {
        "A": (dict(max_batch=dims["batch"], max_len=dims["max_len"]),
              dict(n=dims["batch"], length=dims["prompt_len"],
                   steps=dims["decode_steps"], step_n=8)),
        "B": (dict(max_batch=dims["flash_batch"],
                   max_len=2 * dims["flash_len"]),
              dict(n=dims["flash_batch"], length=dims["flash_len"], steps=8,
                   step_n=8)),
        "C": (dict(max_batch=dims["batch"], max_len=dims["max_len"],
                   kv_dtype="int8"),
              dict(n=dims["batch"], length=dims["prompt_len"],
                   steps=dims["decode_steps"], step_n=8, single_step=True,
                   verify=4)),
        "D": (dict(max_batch=dims["flash_batch"],
                   max_len=2 * dims["flash_len"], kv_dtype="int8"),
              dict(n=dims["flash_batch"], length=dims["flash_len"], steps=16,
                   step_n=8)),
    }
    total = {}
    for name, (eng_kw, run_kw) in plans.items():
        eng = LlamaEngine(packed, cfg, dtype=torch.bfloat16, seed=seed,
                          device=device, **eng_kw)
        c = eng.cache
        cache_gb = sum(t.numel() * t.element_size()
                       for bufs in (c.k, c.v, c.k_scale, c.v_scale)
                       if bufs is not None for t in bufs) / 2**30
        # warm-up (allocator, library handles): two short requests
        s = eng.add_requests(prompts(torch, 2, 16, cfg.vocab_size, seed))
        eng.step_n({x: eng._pending_next[x] for x in s}, 2)
        for x in s:
            eng.release(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = run(name, eng, **run_kw)
        counts = kernels.launch_counts()
        res.update(launches=counts, cache_gib=cache_gb,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        out[f"serve_{name}"] = res
        log(f"    cache {cache_gb:.3f} GiB, peak memory "
            f"{res['peak_mem_gib']:.2f} GiB; launches {counts}")
        missing = [k for k in SERVE_PATHS[name] if counts[k] <= 0]
        if missing:
            raise AssertionError(f"engine {name}: kernels never launched on "
                                 f"its path: {missing}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del eng
        torch.cuda.empty_cache()
    out["launches"] = total
    return total


def plain_reference_params(torch, packed):
    """The packed model as dense f32 weights: each PackedWeight dequantized
    from its bf16-rounded scales and zeros (what a bf16 engine serves),
    every other tensor rounded to bf16 like the engine's, then widened."""
    from omniquant_tpu_torch.quant import PackedWeight, dequantize_packed

    def conv(x):
        if isinstance(x, PackedWeight):
            pw = x.map_tensors(lambda t: t.to(torch.bfloat16).float()
                               if t.is_floating_point() else t)
            return {"weight": dequantize_packed(pw).t().contiguous(),
                    "bias": pw.bias}
        if isinstance(x, torch.Tensor):
            return x.to(torch.bfloat16).float()
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x

    return conv(packed)


def e2e(torch, device, cfg, seed, out: dict):
    """Prefill and first-decode logits of a bf16-KV and an int8-KV engine
    against a plain f32 forward (models.llama.forward on dense dequantized
    weights), and the int8 engine's first decode through the fused
    attention (K4 + K6) against its dense path (attn_kernel=False) on the
    same tokens."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.serving import LlamaEngine

    packed = make_packed(torch, cfg, device, seed + 1)
    ref_params = plain_reference_params(torch, packed)
    res = {}

    def held(key, got, want):
        d = got.float() - want.float()
        rms_rel = (d.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()
                   ).item()
        max_rel = (d.abs().max() / want.float().abs().max()).item()
        agree = (got.float().argmax(-1) == want.float().argmax(-1)).float(
        ).mean().item()
        res[key] = dict(rms_rel=rms_rel, max_rel=max_rel, argmax_agree=agree)
        log(f"  e2e {key}: rms rel err {rms_rel:.3g} (tol {E2E_RMS_REL}), "
            f"max rel err {max_rel:.3g} (tol {E2E_MAX_REL}), argmax "
            f"agreement {agree:.3f}")
        if not (math.isfinite(rms_rel) and rms_rel <= E2E_RMS_REL
                and max_rel <= E2E_MAX_REL):
            raise AssertionError(f"e2e {key} outside tolerance")

    for n, length in ((32, 128), (4, 512)):
        reqs = prompts(torch, n, length, cfg.vocab_size, seed + 7 * length)
        tokens = torch.tensor(reqs, device=device)
        for kv, modes in (("native", (None,)), ("int8", (True, False))):
            dec = {}
            for attn_kernel in modes:
                eng = LlamaEngine(packed, cfg, max_batch=n, max_len=2 * length,
                                  dtype=torch.bfloat16, kv_dtype=kv,
                                  attn_kernel=attn_kernel, seed=seed,
                                  device=device)
                slots, logits = eng.add_requests(reqs, return_logits=True)
                if attn_kernel is not False:  # the dense engine reuses them
                    first = [eng._pending_next[s] for s in slots]
                    prefill = logits
                toks, lens = eng._device_tokens(dict(zip(slots, first)))
                dec[attn_kernel] = eng._decode_impl(toks, lens,
                                                    eng._kv_len(1))
                del eng
            full = torch.cat(
                [tokens, torch.tensor(first, device=device)[:, None]], dim=1)
            with torch.no_grad():
                ref = llama.forward(ref_params, full, cfg)
            tag = "" if kv == "native" else "int8_"
            held(f"{tag}prefill_{n}x{length}", prefill, ref[:, length - 1])
            held(f"{tag}decode_{n}x{length}", dec[modes[0]], ref[:, length])
            if kv == "int8":
                held(f"int8_decode_kernel_vs_dense_{n}x{length}", dec[True],
                     dec[False])
            del ref
    out["e2e"] = res


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "omniquant_tpu_torch", "csrc")):
        print("chip_smoke.py: the omniquant_tpu_torch package is not beside "
              "this script; run it from the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from omniquant_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    out = {"card": smi, "torch": torch.__version__}
    t_start = time.time()

    build(out)
    cfg = llama.LlamaConfig(vocab_size=32000, hidden_size=4096,
                            intermediate_size=11008, num_hidden_layers=32,
                            num_attention_heads=32, num_key_value_heads=32)
    dims = dict(hidden=4096, inter=11008, heads=32, batch=32, prompt_len=128,
                max_len=512, decode_steps=32, flash_batch=8, flash_len=1024,
                prefill_m=32 * 128, flash_m=8 * 1024, ring=8)

    log("kernels: each against its plain version at the 7B serving shapes")
    timer = Timer(torch, device)
    results = {"quant_matmul": check_quant_matmul(torch, device, timer, dims,
                                                  out),
               "flash_attention": check_flash(torch, device, timer, dims)}
    (results["kv_cache_prefill_write"], results["kv_cache_write"],
     results["kv_cache_write_span"]) = check_kv(torch, device, timer, dims,
                                                 out)
    results["decode_attention_int8"] = check_decode_attention(
        torch, device, timer, dims, out)
    log("bounds of the kernels still to port (no times)")
    unported_bounds(dims, out)
    out["host_in_window"] = timer.host_in_window
    log(f"  timings that include host time (the function synchronises): "
        f"{timer.host_in_window or 'none'}")
    del timer
    torch.cuda.empty_cache()

    counts = serve(torch, device, cfg, dims, args.seed, out)
    torch.cuda.empty_cache()

    log("e2e: 2-layer full-width engines against a plain f32 forward")
    e2e(torch, device, llama.LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=32),
        args.seed, out)

    entries = []
    for name, (replaces, source, tol) in KERNELS.items():
        r = results[name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            tolerance=tol, shape=r["shape"]))
    out["kernels"] = entries
    out["total_s"] = time.time() - t_start
    log(f"total {out['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    log("serving (prefill / decode tok/s, peak GiB): " + "; ".join(
        f"{n} {out['serve_' + n]['prefill_tok_s']:.1f} / "
        f"{out['serve_' + n]['decode_tok_s']:.1f}, "
        f"{out['serve_' + n]['peak_mem_gib']:.2f}" for n in SERVE_PATHS)
        + "; on:")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
