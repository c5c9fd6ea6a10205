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
              and f32 scales for the int8 cache and the integer products),
              with the per-element tolerance stated in KERNELS
              (omniquant_tpu_torch/kernels/tolerance.py); device times of
              the kernel, the plain version and one PyTorch library call as
              a yardstick (CUDA events, launches queued behind a device
              sleep so no host time falls inside), beside the least time
              the card could take for this run's inputs. K1 runs on pairs
              words (W4 g128: the four decode products at m = 32 and 8,
              qkv, o and down at the m = 128 verify and the m = 4096 and
              8192 prefills) and on planar words (W2/W3/W4 g64, W6 g128,
              W8 per-channel: the four decode products at m = 32 and 8;
              W2 and W4 g64 also at m = 128 and 4096). K2 runs causal at
              (8, 32, 1024, 128), the B/D/F prefill's shape, at
              (2, 32, 4096, 128), the same tokens as a 4x longer prompt,
              at Falcon's prefill heads (8 x 512, head_dim 64: 71
              query heads on 1 kv head, 128 on 8, 32 with ALiBi) and at
              OPT-2.7B's 32 heads of 80 ((8, 32, 512, 80), the opt27b
              prefill, and (1, 32, 2048, 80)). K6 runs at LLaMA-7B's
              decode shapes, at OPT-2.7B's 32 kv heads of 80 and at 16, 29
              and 71 query heads per kv head (head groups; hd 64), each at
              window 256 at batch 32 and window 2048 at batch 8 with and
              without the ring.
              K4 runs on bf16 k+v rows (A) and int8 codes + planes (C),
              K5 on an 8-row flush at C's and D's batch and window, each
              beside its empty launch with the same grid (the floor) and
              its wrapper's host microseconds per call.
3. serve   -- LLaMA-7B widths and depth (vocab 32000, hidden 4096, inter
              11008, 32 layers, 32/32 heads), random weights from a seeded
              torch.Generator, packed by pack_model's auto layout: W4 g128
              (pairs layout) for engines A-F, then, once that model is
              freed, W6 g128 (planar) for G, then W2 g64 (planar) for H;
              engines built and freed one after another:
              A  bf16 KV, max_batch 32, max_len 512: add_requests of 32
                 prompts of 128 tokens, 32 tokens by step_n(., 8);
              B  bf16 KV, max_batch 8, max_len 2048: 8 prompts of 1024
                 tokens (flash attention), 8 tokens by step_n(., 8);
              C  int8 KV, max_batch 32, max_len 512: 32 x 128 prompts, one
                 step (K4 on codes and planes, K6), step_n(., 8) x 4 (K6
                 with the ring, K5 flush), verify_step of 4 tokens on every
                 slot (K5);
              D  int8 KV, max_batch 8, max_len 2048: 8 x 1024 prompts (K2,
                 K3 on codes), step_n(., 8) x 2 at a 2048 window;
              E  W4A4 (4-bit activations), bf16 KV, as A: the prefill
                 (m = 4096) through K8 + K9, decode through fake-quant + K1;
              F  W4A4, bf16 KV, as B: the prefill (m = 8192) through K8 + K9
                 and K2, 8 tokens by step_n(., 8);
              G  W6A6 on the W6 model, bf16 KV, as A plus verify_step of 4
                 tokens: prefill K8 + K9, decode (m = 32) and verify
                 (m = 128) through K7;
              H  W2A16 g64 on the W2 model, bf16 KV, as G: planar K1's
                 prefill tile at the m = 4096 prefill (qkv, o, down; gate_up
                 dequantizes once) and the m = 128 verify, its decode tile
                 at m = 32.
              Each engine's run starts with the launch counts set to 0 and
              ends by reading them; every kernel of its path must have
              launched.
4. e2e     -- at full width and 2 layers, the prefill logits and first
              decode logits of a bf16-KV and an int8-KV engine against a
              forward of the same packed model composed of plain PyTorch ops
              in f32, and the int8 engine's fused decode attention against
              its dequantized dense path; W2A16 and W4A16 g64 engines
              (planar words) likewise; then W4A4 and W6A6 engines
              against the f32 forward with the same activation quantizers
              (rms and largest error, cosine, norm ratio), and at 4 x 512
              the same engines on the CPU (every plain version) showing the
              same error.
5. calibrate -- block-wise LWC/LET calibration (calib/engine.py, plain
              PyTorch with autograd, f32, TF32 off) of LLaMA-7B widths at
              2 layers on 16 synthetic 2048-token windows, 2 epochs: (a)
              W4A16 g128 with LWC, (b) W4A4 per-channel with LWC + LET after
              collect_act_stats, each freed before the next. Seconds a train
              step, fp and propagation passes per layer, the phase's seconds
              and peak memory; then five checks: finite, falling losses;
              nearer the fp model than round-to-nearest on 4 held-out
              windows; the folded blocks equal the trained weights' forward;
              pack_model's words dequantize to the folded weights bit for
              bit; LlamaEngine on the packed model (16 x 128 prompts,
              step_n(., 8): K1, K3, K4, and K8 + K9 for W4A4) against a
              plain f32 forward at the e2e tolerances.
6. opt     -- OPT-6.7B widths (facebook/opt-6.7b: vocab 50272, hidden
              4096, ffn 16384, 32 heads of 128, pre-LN), depth cut to 2
              layers, random weights from a seeded generator with random
              biases and 6 outlier LayerNorm channels: a W4 g128 (pairs)
              pack served by a bf16-KV and an int8-KV OPTEngine (8 x 512
              prompts: K1's prefill tile at m = 4096, K2, K3; the first
              decode and step_n(., 8): K1's decode tile, K4, and for int8
              K5 and K6), prefill and first decode logits against a plain
              f32 opt.forward at the e2e tolerance; then W6A6 LWC + LET
              (shifts from collect_act_stats) calibrated as in calibrate
              (its five checks; served 16 x 128 through K8 + K9, decoded
              through K7). Every calibration (LLaMA's too) ends with the
              perplexity at 2048 tokens of the synthetic test split, of the
              f32 fake-quant model and of its pack in bf16 (K1, or K8 + K9
              for quantized activations), seconds a window, held to the
              bound of ppl_check.
7. opt27b  -- OPT-2.7B at its published widths and full depth
              (facebook/opt-2.7b: vocab 50272, hidden 2560, ffn 10240, 32
              layers, 32 heads of 80, pre-LN), random weights as in opt:
              a W4 g128 (pairs) pack served by a bf16-KV and an int8-KV
              OPTEngine (8 x 512 prompts: K1's prefill tile, K2 and K3 at
              hd 80; the first decode and step_n(., 8): K1's decode tile,
              K4, and for int8 K6 at hd 80 with the ring and K5; int8 also
              verify_step of 4 tokens), prefill and first decode logits
              against a plain f32 opt.forward at E2E_TOL; ppl_check of the
              pack against its dequantized weights in f32; then LWC W4A16
              g128 at 2 layers with calibrate's five checks.
8. falcon  -- the published widths of Falcon-7B (hidden 4544, 71 query
              heads on 1 kv head, parallel attention, rotary, ffn 18176,
              vocab 65024; 2 layers, W4A16 g64 planar), Falcon-40B (hidden
              8192, 128 heads on 8 kv heads, the new decoder architecture,
              ffn 32768; 1 layer, W4A16 g128) and Falcon-RW-1B (hidden
              2048, 32 heads, ALiBi, post-attention LayerNorm, biases,
              vocab 50304; 2 layers, W4A16 g128), random weights from a
              seeded generator: each served by a bf16-KV and an int8-KV
              FalconEngine (8 x 512 prompts, the first decode and
              step_n(., 8)): K2 at 71 on 1 and 128 on 8 heads and on its
              ALiBi path, K3, K4; 7B's int8 decode through K6 at 71 query
              heads a kv head with the ring and K5, 40B's at 16; K1 on
              every linear of 40B and RW-1B, on 7B's dense_h_to_4h only
              (its other three have N % 128 != 0 and take the dense
              reference, as in the JAX package), counted per linear; the
              ALiBi int8 engine without K6. Prefill and first decode
              logits against the plain f32 forward at E2E_TOL. Then LWC
              calibration (W4A16 g64) at Falcon-7B widths with calibrate's
              five checks and the perplexity check.
9. cli     -- ``python -m omniquant_tpu_torch`` as a subprocess on the card
              (its default platform), tiny-opt, tiny-llama and
              tiny-falcon: W4A16 g64
              LWC, 2 epochs of 8 x 256, --eval_ppl, --real_quant,
              --save_dir and a 16-token --serve_prompt of the packed model;
              exit 0, a results JSON last, and K1, K3 and K4 launched (the
              CLI logs its launch counts).
10. spec    -- speculative decoding (serving/spec_decode.py: SpecDecoder's
              fused spec_steps rounds, each checked to run without a host
              synchronisation) and the growing KV cache (auto_grow), random
              weights from a seeded generator at LLaMA-7B widths (vocab
              32000, hidden 4096, inter 11008, 32 heads): A a layer-skip
              self-draft (4 of 32 layers, W4 g128) at gamma 4, 4 rounds a
              dispatch, batch 8 x 128, max_len 1024, bf16 and int8 KV (K1's
              decode tile at m = 8 and its prefill tile at the m = 40
              verify, K4, K5, int8 K6; the int8 run's draft head packed at
              4 bits, K1 at N = 32000): the round in ms and in sequential
              step_n(., 8) steps, acceptance, spec and step_n tok/s, the
              draft's extra memory (its KV cache only, within 1 %), and
              generate against target.generate for 64 tokens; B a W2 g128
              pack of the same weights drafting for the W4 g128 target (full
              depth, max_len 512); C a W6A6 target at 2 layers with a
              one-layer draft, 8 x 512 prompts (K8 + K9 and K2 at the
              prefill, K7 at m = 8 and 40); D auto_grow from 256 to 1024
              rows while 8 x 128 prompts decode 600 tokens each, LLaMA-7B
              and Falcon-RW-1B (ALiBi) widths at 2 layers, bf16 and int8,
              full-depth self-drafts, against engines built at 1024 (copy
              ms, peak GiB); one sample_spec_step round at temperature 0.8
              with a full-depth self-draft, then one greedy dispatch on it
              (A_full: rounds that accept their proposals emit several
              tokens). The kernels phase holds K1 and K7 at this phase's
              shapes (SPEC_K1_M, SPEC_K7_M). Every card stream is held
              whole to the near-tie rule (stream_gaps, near_tie): each
              token lies at most SPEC_TIE x E2E_TOL's max bound (W6A6:
              E2E_INT_TOL[6]'s) x its row's largest |logit| below the
              row's argmax in one causal pass of the plain f32 forward over
              the stream; a planted fault (the draft's own stream) must
              fail it.
11. profile -- last, so that no timed run follows a profiler session: A and
              E rebuilt on a fresh W4 model, prefilled as in serve, two
              step_n(., 8) on the host clock, then one under torch.profiler:
              the device's busy share of a decode step, the kernel launches
              per step and the kernels that took the most device time.

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
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor cores

# kernel -> (replaced TPU kernel, source, tolerance rule)
KERNELS = {
    "quant_matmul": (
        "omniquant_tpu/kernels/quant_matmul.py:276",
        "omniquant_tpu_torch/csrc/quant_matmul.cu",
        "per element 2 bf16 ulps of |plain| + 2^-10 (both round an f32 sum "
        "to bf16 once)"),
    # K1 on planar words: the same kernel source and pallas_call, its own
    # decode tile and prefill staging, counted apart
    "quant_matmul_planar": (
        "omniquant_tpu/kernels/quant_matmul.py:276",
        "omniquant_tpu_torch/csrc/quant_matmul.cu",
        "per element 2 bf16 ulps of |plain| + 2^-10, as quant_matmul (exact "
        "codes, exact products, f32 sums)"),
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
    "quant_matmul_int": (
        "omniquant_tpu/kernels/quant_matmul.py:502",
        "omniquant_tpu_torch/csrc/quant_matmul_int.cu",
        "per element 2 bf16 ulps of |plain| + 2^-14 * xs * sum_g (|dot_g| "
        "sc_g + |xsum_g off2_g|) (exact int dots; only the f32 order of the "
        "group terms differs)"),
    "_unpack_to_int8": (
        "omniquant_tpu/kernels/quant_matmul.py:569",
        "omniquant_tpu_torch/csrc/quant_matmul_int.cu", "exact"),
    "_quant_matmul_int_dense": (
        "omniquant_tpu/kernels/quant_matmul.py:644",
        "omniquant_tpu_torch/csrc/quant_matmul_int.cu",
        "per element 2 bf16 ulps of |plain| + 2^-14 * xs * sum_g (|dot_g| "
        "sc_g + |xsum_g off2_g|), as quant_matmul_int"),
}

# kernels each engine of the serve phase must launch; quant_matmul_prefill
# is pairs K1's prefill tile (m > 32: A-D's prefill, C's verify), and
# planar K1 counts by tile: decode (m <= 32) and prefill / verify (m > 32)
SERVE_PATHS = {
    "A": ("quant_matmul", "quant_matmul_prefill", "kv_cache_prefill_write",
          "kv_cache_write"),
    "B": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
          "kv_cache_prefill_write", "kv_cache_write"),
    "C": ("quant_matmul", "quant_matmul_prefill", "kv_cache_prefill_write",
          "kv_cache_write", "kv_cache_write_span", "decode_attention_int8"),
    "D": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
          "kv_cache_prefill_write", "kv_cache_write_span",
          "decode_attention_int8"),
    "E": ("_unpack_to_int8", "_quant_matmul_int_dense", "quant_matmul",
          "kv_cache_prefill_write", "kv_cache_write"),
    "F": ("_unpack_to_int8", "_quant_matmul_int_dense", "flash_attention",
          "quant_matmul", "kv_cache_prefill_write", "kv_cache_write"),
    "G": ("_unpack_to_int8", "_quant_matmul_int_dense", "quant_matmul_int",
          "kv_cache_prefill_write", "kv_cache_write", "kv_cache_write_span"),
    "H": ("quant_matmul_planar_decode", "quant_matmul_planar_prefill",
          "kv_cache_prefill_write", "kv_cache_write"),
}

# measurements a kernel's JSON entry carries beside the contract's keys
EXTRAS = ("prefill", "long_prompt", "falcon", "opt27b", "int_mm_ms",
          "kernel_ms", "generic_kernel_ms", "verify", "widths", "floor_ms",
          "host_us", "cases")

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
E2E_TOL = dict(rms=5e-2, max=1e-1)
# W4A4 / W6A6 engines against the f32 forward with the same activation
# quantizers: a bf16 rounding upstream may move an activation across a 4-
# or 6-bit grid step (a whole step, not a bf16 ulp), and on random weights
# at full width that compounds: the same plain forward in bf16 (plain
# PyTorch ops, no kernel) already strays 0.80 (W4A4) and 0.27 (W6A6) rms
# from the f32 one, with no argmax in common at W4A4. So the engines are
# held to that yardstick, measured in the same run on the same tokens
# (their rms error at most E2E_INT_VS_PLAIN times the bf16 forward's), and
# at 4 x 512 to the same engine on the CPU running every plain version
# instead of a kernel (the same factor). An rms error near 1 is what zero
# logits give, so each comparison also holds the cosine of the logits to a
# floor and the ratio of their norms to a band: zero, random, negated and
# halved or doubled logits fail, and the run checks that they do.
E2E_INT_TOL = {4: dict(rms=1.0, max=1.2, cos=0.4, norm=(0.8, 1.25)),
               6: dict(rms=0.4, max=0.5, cos=0.8, norm=(0.8, 1.25))}
E2E_INT_VS_PLAIN = 1.25


def log(*a):
    print(*a, flush=True)


def logit_gap(got, want) -> dict:
    """How far logits ``got`` lie from ``want``: rms and largest error over
    want's rms and largest magnitude, argmax agreement, cosine, and the
    ratio of their norms."""
    g = got.float()
    w = want.float().to(g.device)
    gn, wn = g.norm(), w.norm()
    return dict(
        rms_rel=((g - w).norm() / wn).item(),
        max_rel=((g - w).abs().max() / w.abs().max()).item(),
        argmax_agree=(g.argmax(-1) == w.argmax(-1)).float().mean().item(),
        cos=((g * w).sum() / (gn * wn).clamp_min(1e-30)).item(),
        norm_ratio=(gn / wn).item())


def gap_within(gap: dict, tol: dict) -> bool:
    """``gap`` inside ``tol``: rms and max bounds, and where given a cosine
    floor and a band for the norm ratio (NaN fails every bound)."""
    lo, hi = tol.get("norm", (0.0, math.inf))
    return (gap["rms_rel"] <= tol["rms"] and gap["max_rel"] <= tol["max"]
            and gap["cos"] >= tol.get("cos", -1.0)
            and lo <= gap["norm_ratio"] <= hi)


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
    # each kernel's (mangled) name, then its registers and spills
    out["ptxas"] = {n: [ln for ln in s.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling entry function" in ln]
                    for n, s in logs.items()}
    log(f"build: {sorted(logs)} compiled in {out['build_s']:.1f} s")
    for n, lines in out["ptxas"].items():
        for ln in lines:
            log(f"  ptxas {n}: {ln.strip()}")


def _seven_b_shapes(dims):
    H, I = dims["hidden"], dims["inter"]
    return {"qkv": (H, 3 * H), "o": (H, H), "gate_up": (H, 2 * I),
            "down": (I, H)}


def _k1_row(torch, timer, label, pw, w_lib, x) -> dict:
    """One K1 product (x @ dequant(pw)) held per element to its plain
    version, called twice for equal bits; device times of the
    kernel, the plain version and bf16 torch.matmul on the dequantized
    weight, beside the bound for this run's inputs."""
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_reference)

    m, K = x.shape
    N = pw.qweight.shape[1]
    got = quant_matmul(x, pw)
    want = quant_matmul_reference(x, pw)
    torch.cuda.synchronize()
    ok, err, worst = tolerance.bf16_close(got, want,
                                          tolerance.QUANT_MATMUL_SLACK)
    rel = rms_rel_err(got, want)
    if not (ok and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: max abs err {err}, {worst:.3g} x its "
                             "per-element bound")
    again = quant_matmul(x, pw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls differ")
    del again
    del got, want
    t = timer(lambda: quant_matmul(x, pw), label)
    t_plain = timer(lambda: quant_matmul_reference(x, pw), label + " plain",
                    iters=3)
    t_lib = timer(lambda: torch.matmul(x, w_lib), label + " library")
    nbytes = (pw.qweight.numel() * 4 + pw.scales.numel() * 2
              + pw.zeros.numel() * 2 + x.numel() * 2 + m * N * 2)
    flops = 2.0 * m * K * N
    b, by = bound_ms(nbytes, flops)
    log(f"  {label:34s} K={K:5d} N={N:5d}: max abs err {err:.3g} "
        f"({worst:.3g} x bound, rms rel {rel:.2g})  kernel {t:.4f} ms  plain "
        f"{t_plain:.4f}  library {t_lib:.4f}  bound {b:.4f} ({by})")
    return dict(m=m, K=K, N=N, ms=t, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b, bound_by=by, max_abs_err=err, err_over_bound=worst,
                rms_rel=rel, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=flops / BF16_FLOPS_PER_S * 1e3)


def _k1_weight(torch, device, gen, bits, group_size, K, N):
    """A random (N, K) projection packed by pack_weight's auto layout, with
    the bf16-rounded scales and zeros a bf16 engine serves, and its bf16
    dequantized weight (the library call's operand)."""
    from omniquant_tpu_torch.quant import (QuantConfig, dequantize_packed,
                                           pack_weight)

    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout="auto")
    del w
    pw = pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    return pw, dequantize_packed(pw, dtype=torch.bfloat16)  # (K, N)


def _k1_total(rows, all_rows, shape) -> dict:
    """The JSON entry: times and bound summed over ``rows``, the largest
    error over every row checked."""
    tot = _totals(rows, ("ms", "plain_ms", "library_ms", "bound_ms"))
    tot["max_abs_err"] = max(r["max_abs_err"] for r in all_rows)
    tot["shape"] = shape
    return tot


def _k1_prefill_sum(rows, m) -> dict:
    """qkv + o + down at m rows (gate_up is dequantized once there): the
    prefill tile's share of one decoder layer's prefill."""
    sel = [r for r in rows if r["m"] == m]
    tot = _totals(sel, ("ms", "plain_ms", "library_ms", "bound_ms"))
    tot["m"] = m
    return tot


# K1's shapes on the spec phase's path beyond the serving rows: generate's
# single-slot draft and target steps (m = 1) and verify pass (m = 5, the
# decode tile), the batched verify (m = 8 x 5 = 40, the prefill tile) and
# the batched prefill of 8 x 128 prompts (m = 1024); a W2 g128 draft
# (pairs) at its steps and prefill; a 4-bit packed draft head (4096 x 32000)
# at its steps. Their inputs come from a generator of their own, so the
# serving rows keep theirs.
SPEC_K1_M = {"W4 g128": (1, 5, 40, 1024), "W2 g128": (1, 8, 1024),
             "head": (1, 8)}


def check_quant_matmul(torch, device, timer, dims, out: dict) -> dict:
    """K1 on pairs words (W4 g128) at the decode (m = 32 and 8), verify (m =
    128) and prefill (m = 4096 and 8192) shapes of the serving path, and at
    the spec phase's (SPEC_K1_M; rows marked ``spec``); two calls must give
    the same bits (the decode tile's split-K slices are added in a fixed
    order, the prefill tile runs unsplit). The JSON entry sums one decoder
    layer's four decode products at m = 32, and under ``prefill`` qkv + o +
    down at m = 4096; the log also sums the four at m = 8. Its error is the
    largest of every row."""
    shapes = _seven_b_shapes(dims)
    ms_list = [(32, ("qkv", "o", "gate_up", "down")),
               (8, ("qkv", "o", "gate_up", "down")),
               (dims["verify_m"], ("qkv", "o", "down")),
               (dims["prefill_m"], ("qkv", "o", "down")),
               (dims["flash_m"], ("qkv", "o", "down"))]
    gen = torch.Generator(device=device).manual_seed(1234)
    spec_gen = torch.Generator(device=device).manual_seed(1235)
    rows = []

    def spec_rows(tag, name, pw, w_lib, K):
        for m in SPEC_K1_M[tag]:
            x = torch.randn(m, K, generator=spec_gen, device=device).to(
                torch.bfloat16)
            rows.append(dict(shape=name, weights=tag, spec=True, **_k1_row(
                torch, timer, f"quant_matmul {tag} {name} m={m}", pw, w_lib,
                x)))

    for name, (K, N) in shapes.items():
        pw, w_lib = _k1_weight(torch, device, gen, 4, 128, K, N)
        assert pw.layout == "pairs"
        for m, names in ms_list:
            if name not in names:
                continue
            x = torch.randn(m, K, generator=gen, device=device).to(
                torch.bfloat16)
            rows.append(dict(shape=name, **_k1_row(
                torch, timer, f"quant_matmul {name} m={m}", pw, w_lib, x)))
        spec_rows("W4 g128", name, pw, w_lib, K)
        del pw, w_lib
    for tag, bits, todo in (
            ("W2 g128", 2, shapes),
            ("head", 4, {"lm_head": (dims["hidden"],
                                     SPEC_MODEL["vocab_size"])})):
        for name, (K, N) in todo.items():
            pw, w_lib = _k1_weight(torch, device, spec_gen, bits, 128, K, N)
            assert pw.layout == "pairs"
            spec_rows(tag, name, pw, w_lib, K)
            del pw, w_lib
    out["quant_matmul_shapes"] = rows
    serving = [r for r in rows if not r.get("spec")]
    m32 = [r for r in serving if r["m"] == 32]
    m8 = [r for r in serving if r["m"] == 8]
    tot = _k1_total(m32, rows,
                    "one decoder layer at decode, m=32: qkv 4096x12288, o "
                    "4096x4096, gate_up 4096x22016, down 11008x4096")
    log(f"  quant_matmul four decode products: m=32 kernel {tot['ms']:.4f} "
        f"ms, library {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}; "
        f"m=8 kernel {sum(r['ms'] for r in m8):.4f} ms, library "
        f"{sum(r['library_ms'] for r in m8):.4f}")
    tot["prefill"] = _k1_prefill_sum(serving, dims["prefill_m"])
    _log_prefill_sum("quant_matmul", tot["prefill"])
    return tot


def _log_prefill_sum(label, p) -> None:
    log(f"  {label} prefill qkv + o + down m={p['m']}: kernel {p['ms']:.4f} "
        f"ms, plain {p['plain_ms']:.4f}, library {p['library_ms']:.4f}, "
        f"bound {p['bound_ms']:.4f}")


# planar weights of the kernels phase, (bits, group_size) -> whether they
# also run the verify and prefill rows (qkv, o, down at m = 128 and 4096)
# beside the four decode products at m = 32 and 8
PLANAR_K1 = {(2, 64): True, (3, 64): False, (4, 64): True, (6, 128): False,
             (8, None): False}


def _planar_decode_plan(device, pw, m) -> str:
    """The planar decode tile's plan for pw at m rows on this card: its
    slices, steps per slice (CTA), the CTAs an SM holds and their shared
    memory, which must be the same in kernels/quant_matmul.py's geometry
    and in the kernel."""
    from omniquant_tpu_torch.kernels import quant_matmul as qmm

    if not qmm._planar_decode(pw):
        return "prefill tile (a tile too small for a decode step)"
    geo, ctas, plan = qmm.planar_decode_launch(pw, m, device)
    smem = qmm._planar_decode_info(pw.bits, m, pw.tile_k,
                                   pw.group_size or pw.k_pad,
                                   pw.scales.shape[1], False)
    if smem != geo.smem:
        raise AssertionError(f"planar decode smem: kernel {smem}, "
                             f"geometry {geo.smem}")
    return (f"{plan.splits} slices of {plan.per} steps of {geo.nsub} "
            f"sub-steps, {ctas} CTAs/SM of {smem} B")


def check_quant_matmul_planar(torch, device, timer, dims, out: dict) -> dict:
    """K1 on planar words (pack_model's auto layout for groups below 128
    rows and for 6 and 8 bits): the four 7B decode products at m = 32 and 8
    for W2 g64, W3 g64, W4 g64, W6 g128 and W8 per-channel, and qkv, o and
    down at the verify m = 128 and the prefill m = 4096 for W2 g64 and W4
    g64, each held per element to the plain version (two calls equal). The
    JSON entry sums the four W2 g64 decode products at m = 32 (engine H's
    layer), under ``widths`` each width's four at m = 32 and 8 (kernel,
    library, bound), and under ``prefill`` W2 g64's qkv + o + down at m =
    4096. The log gives each decode product's plan on this card."""
    gen = torch.Generator(device=device).manual_seed(2345)
    rows = []
    for (bits, gs), prefill in PLANAR_K1.items():
        tag = f"W{bits} {'g' + str(gs) if gs else 'per-channel'}"
        for name, (K, N) in _seven_b_shapes(dims).items():
            ms = [32, 8]
            if prefill and name != "gate_up":
                ms += [dims["verify_m"], dims["prefill_m"]]
            pw, w_lib = _k1_weight(torch, device, gen, bits, gs, K, N)
            assert pw.layout == "planar", (bits, gs, pw.layout)
            for m in ms:
                x = torch.randn(m, K, generator=gen, device=device).to(
                    torch.bfloat16)
                rows.append(dict(weights=tag, shape=name, **_k1_row(
                    torch, timer, f"quant_matmul {tag} {name} m={m}", pw,
                    w_lib, x)))
                if m <= 32:
                    rows[-1]["plan"] = _planar_decode_plan(device, pw, m)
                del x
            del pw, w_lib
    out["quant_matmul_planar_shapes"] = rows
    widths = {}
    for tag in dict.fromkeys(r["weights"] for r in rows):
        for m in (32, 8):
            sel = [r for r in rows if r["weights"] == tag and r["m"] == m]
            widths.setdefault(tag, {})[f"m={m}"] = _totals(
                sel, ("ms", "library_ms", "bound_ms"))
            log(f"  quant_matmul {tag} four decode products m={m}: kernel "
                f"{sum(r['ms'] for r in sel):.4f} ms, library "
                f"{sum(r['library_ms'] for r in sel):.4f}, bound "
                f"{sum(r['bound_ms'] for r in sel):.4f}; plans "
                + ", ".join(f"{r['shape']} {r['plan']}" for r in sel))
    tot = _k1_total(
        [r for r in rows if r["weights"] == "W2 g64" and r["m"] == 32], rows,
        "one decoder layer at decode, m=32, W2 g64 planar: qkv 4096x12288, "
        "o 4096x4096, gate_up 4096x22016, down 11008x4096")
    tot["widths"] = widths
    tot["prefill"] = _k1_prefill_sum(
        [r for r in rows if r["weights"] == "W2 g64"], dims["prefill_m"])
    _log_prefill_sum("quant_matmul W2 g64", tot["prefill"])
    for tag in ("W4 g64",):
        _log_prefill_sum(f"quant_matmul {tag}", _k1_prefill_sum(
            [r for r in rows if r["weights"] == tag], dims["prefill_m"]))
    return tot


def _flash_row(torch, device, timer, B, Hh, S, D, Hkv=None,
               alibi=False) -> dict:
    """K2 at (B, Hh, S, D) causal, on Hkv kv heads (default Hh) and with
    ALiBi slopes if asked, against its plain version (per element), timed
    beside the plain version, SDPA (kv heads repeated; ALiBi as an additive
    mask) and the bound."""
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from omniquant_tpu_torch.models.falcon import alibi_slopes

    Hkv = Hkv or Hh
    gen = torch.Generator(device=device).manual_seed(99)
    q = torch.randn(B, Hh, S, D, generator=gen, device=device).to(
        torch.bfloat16)
    k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=device).to(
        torch.bfloat16) for _ in range(2))
    slopes = alibi_slopes(Hh, device) if alibi else None
    scale = D ** -0.5
    kw = dict(sm_scale=scale, alibi_slopes=slopes)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    ok, err, worst = tolerance.bf16_close(
        got, want, tolerance.flash_attention_slack(q, k, v, **kw))
    rel = rms_rel_err(got, want)
    del got, want
    shape = (f"({B},{Hh},{S},{D})" + (f" on {Hkv} kv heads" if Hkv != Hh
                                      else "") + (" ALiBi" if alibi else ""))
    if not ok:
        raise AssertionError(f"flash_attention {shape}: max abs err {err}, "
                             f"{worst:.3g} x its per-element bound")
    t = timer(lambda: flash_attention(q, k, v, **kw), "flash_attention")
    t_plain = timer(lambda: flash_attention_plain(q, k, v, **kw),
                    "flash_attention plain", iters=3)
    kr = k.repeat_interleave(Hh // Hkv, dim=1)
    vr = v.repeat_interleave(Hh // Hkv, dim=1)
    if alibi:
        pos = torch.arange(S, device=device)
        bias = (slopes * scale)[:, None, None] * pos.float()
        bias = torch.where(pos[None, :] <= pos[:, None], bias,
                           torch.tensor(float("-inf"), device=device))
        bias = bias[None].to(torch.bfloat16)
        t_lib = timer(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kr, vr, attn_mask=bias, scale=scale),
            "flash_attention library")
    else:
        t_lib = timer(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kr, vr, is_causal=True, scale=scale),
            "flash_attention library")
    del kr, vr
    nbytes = 2 * (q.numel() + k.numel()) * 2
    flops = 4.0 * B * Hh * S * S * D / 2  # causal: half the score matrix
    b, by = bound_ms(nbytes, flops)
    log(f"  flash_attention {shape} causal: max abs err {err:.3g} "
        f"({worst:.3g} x bound, rms rel {rel:.2g})  kernel {t:.4f} ms "
        f"({flops / t / 1e9:.1f} TFLOP/s)  plain {t_plain:.4f}  sdpa "
        f"{t_lib:.4f} ({flops / t_lib / 1e9:.1f} TFLOP/s)  bound {b:.4f} "
        f"({by})")
    return dict(ms=t, plain_ms=t_plain, library_ms=t_lib, bound_ms=b,
                bound_by=by, max_abs_err=err, err_over_bound=worst,
                tflops=flops / t / 1e9, library_tflops=flops / t_lib / 1e9,
                shape=f"q {shape} bf16, causal")


# K2 at Falcon's prefill heads (head_dim 64, 8 x 512 tokens): 7B's 71 query
# heads on one kv head, 40B's 128 on 8, RW-1B's 32 with ALiBi
FLASH_FALCON = (("falcon-7b", 71, 1, False), ("falcon-40b", 128, 8, False),
                ("falcon-rw-1b", 32, 32, True))


# K2 at OPT-2.7B's 32 heads of 80 (the 128-column instance, columns 80..127
# zero-filled by the loads): the opt27b phase's 8 x 512 prefill and one
# 2048-token window
FLASH_OPT27B = (("prefill", 8, 512), ("window_2048", 1, 2048))


def check_flash(torch, device, timer, dims) -> dict:
    """K2 at the serving prefill shape (flash_batch x flash_len), under
    "long_prompt" at a 4x longer prompt with the same tokens per batch,
    under "falcon" at FLASH_FALCON's shapes and under "opt27b" at
    FLASH_OPT27B's."""
    Hh, D = dims["heads"], 128
    row = _flash_row(torch, device, timer, dims["flash_batch"], Hh,
                     dims["flash_len"], D)
    row["long_prompt"] = _flash_row(torch, device, timer,
                                    max(1, dims["flash_batch"] // 4), Hh,
                                    4 * dims["flash_len"], D)
    row["falcon"] = {name: _flash_row(torch, device, timer,
                                      dims["flash_batch"], h, 512, 64, hkv,
                                      alibi)
                     for name, h, hkv, alibi in FLASH_FALCON}
    row["opt27b"] = {name: _flash_row(torch, device, timer, b, 32, s, 80)
                     for name, b, s in FLASH_OPT27B}
    return row


def host_us(torch, fn, calls=300, repeats=5) -> float:
    """Host microseconds per call of ``fn``: the median of ``repeats`` runs
    of ``calls`` calls queued behind a device sleep (so no call waits on the
    device), timed with time.perf_counter."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        torch.cuda._sleep(Timer.SLEEP_CYCLES * 8)  # ~80 ms
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[len(runs) // 2]


def kv_row_cases(torch, device, dims) -> dict:
    """The K4/K5 calls of the serving path at 7B widths, made from a fixed
    seed: label -> (span or None for K4, caches, new rows, lengths). K4 on
    engine A's bf16 k+v rows and on engine C's int8 codes and scale planes;
    K5 on the 8-row ring flush of C (batch 32 into a 512 cache) and of D
    (batch 8 into a 2048 cache)."""
    B, Hh, S, D = dims["batch"], dims["heads"], dims["max_len"], 128
    span = dims["ring"]
    Bd, Sd = dims["flash_batch"], 2 * dims["flash_len"]
    gen = torch.Generator(device=device).manual_seed(8)

    def bf16(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(
            torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def int8(*lead, S_=None):
        """codes and planes: caches (lead, S_, D) if S_ else new rows."""
        if S_ is not None:
            lead = lead + (S_,)
        p = [torch.rand(*lead, generator=gen, device=device)
             for _ in range(2)]
        return [codes(*lead, D), codes(*lead, D)] + p

    def starts(B_, S_, n):
        return torch.randint(0, S_ - n + 1, (B_,), generator=gen,
                             device=device, dtype=torch.int32)

    lengths = starts(B, S, 1)
    c_caches = int8(B, Hh, S_=S)
    return {
        f"bf16 k+v rows {(B, Hh, D)}": (
            None, [bf16(B, Hh, S, D), bf16(B, Hh, S, D)],
            [bf16(B, Hh, D), bf16(B, Hh, D)], lengths),
        f"int8 k+v codes {(B, Hh, D)} + k+v scales {(B, Hh)}": (
            None, c_caches, int8(B, Hh), lengths),
        f"int8 k+v codes {(B, Hh, span, D)} + k+v scales {(B, Hh, span)}": (
            span, c_caches, int8(B, Hh, span), starts(B, S, span)),
        f"int8 k+v codes {(Bd, Hh, span, D)} + k+v scales "
        f"{(Bd, Hh, span)}": (
            span, int8(Bd, Hh, S_=Sd), int8(Bd, Hh, span),
            starts(Bd, Sd, span)),
    }


def kv_times(torch, device, dims, timer) -> dict:
    """Device ms (``timer``) and host microseconds per call (``host_us``) of
    ``kv_cache_write`` and ``kv_cache_write_span`` on each of
    ``kv_row_cases``. It calls only those public entry points, so it times
    whichever tree's package is first on sys.path (a parent checkout's,
    beside this script's)."""
    from omniquant_tpu_torch.kernels.kv_update import (kv_cache_write,
                                                       kv_cache_write_span)

    res = {}
    for label, (span, caches, news, lengths) in kv_row_cases(
            torch, device, dims).items():
        writer = kv_cache_write if span is None else kv_cache_write_span

        def call():
            writer(caches, news, lengths)

        res[label] = dict(ms=timer(call, f"{writer.__name__} {label}"),
                          host_us=host_us(torch, call))
    return res


def check_kv(torch, device, timer, dims, out: dict) -> tuple:
    """K3 on a 32 x 128 prefill; K4 and K5 on ``kv_row_cases``: one launch
    each, all exact. Kernel and host times per call are ``kv_times``';
    each case also times the empty launch with the kernel's grid
    (``kv_write_rows_empty``: the floor no launch of that size beats)."""
    from omniquant_tpu_torch.kernels import _build
    from omniquant_tpu_torch.kernels.kv_update import (
        _row_args, kv_cache_prefill_write, kv_cache_prefill_write_plain,
        kv_cache_write, kv_cache_write_plain, kv_cache_write_span,
        kv_cache_write_span_plain)

    B, Hh, S, D = dims["batch"], dims["heads"], dims["max_len"], 128
    Sp = dims["prompt_len"]
    gen = torch.Generator(device=device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(
            torch.bfloat16)

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
    k3 = dict(ms=t3, plain_ms=t3p, library_ms=t3l, bound_ms=b3,
              bound_by=by3, max_abs_err=err3,
              shape=f"new {(B, Hh, Sp, D)} -> cache {(B, Hh, S, D)}")

    times = kv_times(torch, device, dims, timer)
    rows = {}
    for label, (span, bufs, news, lengths) in kv_row_cases(
            torch, device, dims).items():
        # kernel vs plain (exact), then device times of the empty launch,
        # the plain version and one indexed assignment per buffer
        name, writer, plain = (
            ("kv_cache_write", kv_cache_write, kv_cache_write_plain)
            if span is None else ("kv_cache_write_span", kv_cache_write_span,
                                  kv_cache_write_span_plain))
        mine = [t.clone() for t in bufs]
        ref = [t.clone() for t in bufs]
        writer(mine, news, lengths)
        for r, n in zip(ref, news):
            plain(r, n, lengths)
        err = exact(name, mine, ref)
        ar = torch.arange(lengths.shape[0], device=device)
        pos = lengths.long()[:, None] + torch.arange(span or 1, device=device)

        def lib():
            for c, n in zip(mine, news):
                n = n if span else n.unsqueeze(2)
                c[ar[:, None], :, pos] = n.transpose(1, 2)

        args, held = _row_args(mine, news, lengths, span)
        t, hu = times[label]["ms"], times[label]["host_us"]
        tf = timer(lambda: _build.launch("kv_update", "kv_write_rows_empty",
                                         "b", args),
                   f"{name} {label} empty launch")
        tp = timer(lambda: [plain(r, n, lengths) for r, n in zip(ref, news)],
                   f"{name} {label} plain")
        tl = timer(lib, f"{name} {label} library")
        b, by = bound_ms(2 * nbytes(news), 0)
        log(f"  {name} {label}: exact  kernel {t:.4f} ms  empty launch "
            f"{tf:.4f}  plain {tp:.4f}  index-assign {tl:.4f}  bound "
            f"{b:.6f}  host {hu:.2f} us/call")
        rows[label] = dict(
            ms=t, floor_ms=tf, plain_ms=tp, library_ms=tl, bound_ms=b,
            bound_by=by, max_abs_err=err, host_us=hu,
            shape=f"{label} -> caches of {tuple(bufs[0].shape)}")
        del mine, ref, args, held
    k4_bf16, k4, k5, k5_d = rows.values()
    out["kv_cache_write_bf16"] = k4_bf16
    k4["cases"] = {"bf16": k4_bf16}
    k5["cases"] = {f"b{dims['flash_batch']}_s{2 * dims['flash_len']}": k5_d}
    return k3, k4, k5


def _int8_kv(torch, device, gen, B, n_kv, S, D):
    """Random int8 k and v codes (B, n_kv, S, D) and f32 scales (B, n_kv,
    S) from ``gen``: (k codes, k scales, v codes, v scales)."""
    c = [torch.randint(-127, 128, (B, n_kv, S, D), generator=gen,
                       device=device, dtype=torch.int8) for _ in range(2)]
    sc = [0.001 + 0.019 * torch.rand(B, n_kv, S, generator=gen,
                                     device=device) for _ in range(2)]
    return c[0], sc[0], c[1], sc[1]


def _decode_rows(torch, device, timer, n_kv, n_rep, D, cases, ring_rows,
                 gen, caches) -> list:
    """K6 on each of ``cases`` ((label, B, S, lengths, kv_len, ring_n): a
    cache of B slots, n_kv kv heads of n_rep query heads each, S positions
    of head_dim D; ring_n >= 0 adds a ring of ``ring_rows``) against its
    plain version, with its plan logged; each call must add exactly one
    launch and give the same bits twice. ``caches`` holds the caches
    already made, under (B, S) and (B, "ring"); the others and every query
    are drawn from ``gen`` as the cases need them. Times of the kernel,
    the plain version and scaled_dot_product_attention over the window
    already dequantized to bf16 (it reads twice the bytes), and the bound
    for the positions this run's lengths make live: their bytes, or their
    products at the bf16 tensor cores' peak (int8 codes are exact in bf16
    and the scales factor out of each row, so that is the rate the card
    offers for this work)."""
    from omniquant_tpu_torch.kernels import decode_attention as k6
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)

    ss = D ** -0.5
    H = n_kv * n_rep
    rows = []
    for label, B, S, lens, kv_len, ring_n in cases:
        if (B, S) not in caches:
            caches[(B, S)] = _int8_kv(torch, device, gen, B, n_kv, S, D)
        kv = caches[(B, S)]
        if ring_n >= 0 and (B, "ring") not in caches:
            caches[(B, "ring")] = _int8_kv(torch, device, gen, B, n_kv,
                                           ring_rows, D)
        R = ring_rows if ring_n >= 0 else 0
        rk = caches[(B, "ring")] if ring_n >= 0 else None
        q = torch.randn(B, H, D, generator=gen, device=device).to(
            torch.bfloat16)
        args = (q, *kv, lens, kv_len, ss)
        kw = dict(ring_kv=rk, ring_n=ring_n)
        before = decode_attention_int8.launches
        got = decode_attention_int8(*args, **kw)
        again = decode_attention_int8(*args, **kw)
        want = decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        if decode_attention_int8.launches != before + 2:
            raise AssertionError(f"decode_attention_int8 {label}: "
                                 f"{decode_attention_int8.launches - before}"
                                 " launches in two calls")
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention_int8 {label}: two calls "
                                 "gave different bits")
        ok, err, worst = tolerance.bf16_close(
            got, want, tolerance.DECODE_ATTENTION_SLACK)
        if not (ok and torch.isfinite(got.float()).all()):
            raise AssertionError(f"decode_attention_int8 {label}: max abs "
                                 f"err {err}, {worst:.3g} x its bound")
        plan = k6.decode_attention_launch(device, kv_len, B, n_kv, n_rep, D,
                                          R)
        ctas = k6._decode_ctas(device, D, n_rep)
        smem = k6._decode_info(D, n_rep, False)
        groups = k6.head_groups(n_rep)[0]
        plan_s = (f"{plan.win_splits} window splits of {plan.per}"
                  f"{' + the ring' if plan.ring else ''}"
                  f"{f' x {groups} head groups' if groups > 1 else ''}, "
                  f"{ctas} CTAs/SM of {smem} B")
        log(f"  decode_attention_int8 {label} plan: {plan_s}")
        t = timer(lambda: decode_attention_int8(*args, **kw),
                  "decode_attention_int8 " + label)
        tp = timer(lambda: decode_attention_int8_plain(*args, **kw),
                   "decode_attention_int8 plain " + label, iters=3)
        # yardstick: SDPA over the dequantized bf16 window (and ring), its
        # kv heads repeated for their query heads
        kd = (kv[0][:, :, :kv_len].float() * kv[1][:, :, :kv_len, None])
        vd = (kv[2][:, :, :kv_len].float() * kv[3][:, :, :kv_len, None])
        pos = torch.arange(kv_len, device=device)
        mask = pos[None, :] <= lens[:, None]
        if rk is not None:
            kd = torch.cat([kd, rk[0].float() * rk[1][..., None]], dim=2)
            vd = torch.cat([vd, rk[2].float() * rk[3][..., None]], dim=2)
            rmask = (torch.arange(R, device=device) <= ring_n)[None]
            mask = torch.cat([mask, rmask.expand(B, R)], dim=1)
        kd = kd.to(torch.bfloat16).repeat_interleave(n_rep, dim=1)
        vd = vd.to(torch.bfloat16).repeat_interleave(n_rep, dim=1)
        mask = mask[:, None, None, :]
        t_lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask, scale=ss),
            "decode_attention_int8 library " + label)
        del kd, vd
        live = lens.long().add(1).clamp(0, kv_len).sum().item()
        live += B * (ring_n + 1 if ring_n >= 0 else 0)
        nbytes = live * n_kv * (2 * D + 2 * 4) + 2 * q.numel() * 2
        flops = 4.0 * live * H * D
        b, by = bound_ms(nbytes, flops)
        rows.append(dict(case=label, ms=t, plain_ms=tp, library_ms=t_lib,
                         bound_ms=b, bound_by=by,
                         bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         max_abs_err=err,
                         err_over_bound=worst, live_positions=live,
                         n_kv=n_kv, n_rep=n_rep, head_dim=D, plan=plan_s))
        log(f"  decode_attention_int8 {label} ({B},{H},·,{D}) over {n_kv} kv "
            f"heads: max abs err {err:.3g} ({worst:.3g} x bound)  kernel "
            f"{t:.4f} ms  plain {tp:.4f}  sdpa-bf16 {t_lib:.4f} (reads 2x "
            f"the bytes)  bound {b:.4f} ({by}; bytes alone "
            f"{rows[-1]['bytes_ms']:.4f}; {live} live positions)")
    return rows


# K6 beyond 8 query heads per kv head (head groups), at head_dim 64:
# (label, kv heads, query heads per kv head), Falcon's three geometries
K6_FALCON = (("falcon-40b", 8, 16), ("falcon-180b", 8, 29),
             ("falcon-7b", 1, 71))


def check_decode_attention(torch, device, timer, dims, out: dict) -> dict:
    """K6 at the int8 serving shapes: batch 32 with windows 256 and 512 of
    a 512 cache, batch 8 with a 2048 window, lengths straddling 1024 and a
    ring of 8 at ring_n 0 and 7 (LLaMA-7B: 32 kv heads of 128, one query
    head each); then OPT-2.7B's (32 kv heads of 80, one query head each)
    and Falcon's query heads per kv head (K6_FALCON, head_dim 64), each at
    window 256 at batch 32 and window 2048 at batch 8 without and with the
    ring. The JSON entry is engine C's decode shape (batch 32, window
    256), with every case under ``cases``; see _decode_rows."""
    R, Hh = dims["ring"], dims["heads"]
    gen = torch.Generator(device=device).manual_seed(11)

    def edge_lengths(B, kv_len):
        lens = torch.randint(0, kv_len, (B,), generator=gen, device=device,
                             dtype=torch.int32)
        lens[0], lens[1] = 0, kv_len - 1
        return lens

    b32, b8 = dims["batch"], dims["flash_batch"]
    s8 = 2 * dims["flash_len"]
    # the LLaMA caches, then the lengths, then each case's query: one
    # stream in that order, so the rows keep the lengths of earlier runs
    caches = {(b32, dims["max_len"]): _int8_kv(torch, device, gen, b32, Hh,
                                               dims["max_len"], 128),
              (b8, s8): _int8_kv(torch, device, gen, b8, Hh, s8, 128),
              (b8, "ring"): _int8_kv(torch, device, gen, b8, Hh, R, 128)}
    straddle = torch.tensor([1023, 1024, 2047, 0, 1500, 512, 1022, 1025],
                            dtype=torch.int32, device=device)
    e256, e512 = edge_lengths(b32, 256), edge_lengths(b32, 512)
    cases = [("b32 kv256", b32, dims["max_len"], e256, 256, -1),
             ("b32 kv512", b32, dims["max_len"], e512, 512, -1),
             ("b8 kv2048", b8, s8, straddle, 2048, -1),
             # a staged step_n passes lengths base - 1: slot 3 is idle
             ("b8 kv2048 ring 0", b8, s8, straddle - 1, 2048, 0),
             ("b8 kv2048 ring 7", b8, s8, straddle - 1, 2048, R - 1)]
    rows = _decode_rows(torch, device, timer, Hh, 1, 128, cases, R, gen,
                        caches)
    del caches
    # OPT-2.7B: 32 kv heads of 80, one query head each
    cases = [("opt-2.7b b32 kv256", b32, dims["max_len"], e256, 256, -1),
             ("opt-2.7b b8 kv2048", b8, s8, straddle, 2048, -1),
             ("opt-2.7b b8 kv2048 ring 7", b8, s8, straddle - 1, 2048,
              R - 1)]
    rows += _decode_rows(torch, device, timer, Hh, 1, 80, cases, R,
                         torch.Generator(device=device).manual_seed(80), {})
    torch.cuda.empty_cache()
    for name, n_kv, n_rep in K6_FALCON:
        cases = [(f"{name} b32 kv256", b32, 256, e256, 256, -1),
                 (f"{name} b8 kv2048", b8, s8, straddle, 2048, -1),
                 (f"{name} b8 kv2048 ring 7", b8, s8, straddle - 1, 2048,
                  R - 1)]
        rows += _decode_rows(
            torch, device, timer, n_kv, n_rep, 64, cases, R,
            torch.Generator(device=device).manual_seed(13 + n_rep), {})
        torch.cuda.empty_cache()
    out["decode_attention_shapes"] = rows
    head = dict(rows[0])
    head["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    head["shape"] = ("q (32, 32, 128) bf16 over int8 codes (32, 32, 512, "
                     "128) + f32 scales, window 256, random lengths with 0 "
                     "and 255; library: SDPA over the bf16-dequantized "
                     "window, 2x the bytes; OPT-2.7B's head_dim 80 and "
                     "Falcon's 16, 29 and 71 query heads per kv head "
                     "(head_dim 64) under cases")
    head["cases"] = rows
    return head


def _seven_b_packed(torch, device, gen, bits, K, N):
    """A random (N, K) projection packed at ``bits`` g128 (pairs for 4-bit,
    planar for 6-bit: the "auto" layouts pack_model gives), with the
    bf16-rounded scales and zeros a bf16 engine serves."""
    from omniquant_tpu_torch.quant import QuantConfig, pack_weight

    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=128),
                     layout="auto")
    return pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)


def _int_held(torch, name, got, want, slack):
    from omniquant_tpu_torch.kernels import tolerance

    torch.cuda.synchronize()
    ok, err, worst = tolerance.bf16_close(got, want, slack)
    if not (ok and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: max abs err {err}, {worst:.3g} x its "
                             "per-element bound")
    return err, worst


def _int_bytes(pw, m, K, N, w_bytes):
    """Bytes an integer product's wrapper must move: bf16 activations in,
    the weight (packed words), bf16 scales and zeros, bf16 output."""
    return w_bytes + 2 * pw.scales.numel() * 2 + m * K * 2 + m * N * 2


def _totals(rows, keys):
    tot = {k: sum(r[k] for r in rows) for k in keys}
    tot["bound_by"] = ("bytes" if sum(r["bytes_ms"] for r in rows)
                       >= sum(r["ops_ms"] for r in rows) else "operations")
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def _int_launches(qmm):
    return (qmm.quant_matmul_int.launches, qmm._unpack_to_int8.launches,
            qmm._quant_matmul_int_dense.launches)


def _int_call_held(torch, qmm, label, call, want, mag, launched):
    """One call of an integer wrapper, held to its plain version on the
    same activations (kernels/tolerance.py) and to the launches of its
    route: ``launched`` counts (K7, K8, K9)."""
    from omniquant_tpu_torch.kernels import tolerance

    before = _int_launches(qmm)
    got = call()
    delta = tuple(a - b for a, b in zip(_int_launches(qmm), before))
    if delta != launched:
        raise AssertionError(f"{label}: launched (K7, K8, K9) {delta}, its "
                             f"route launches {launched}")
    return _int_held(torch, label, got, want, tolerance.INT_MATMUL_SLACK * mag)


# K7's rows on the spec phase's W6A6 path: generate's single-slot steps (m =
# 1) and verify (m = 5), the batched draft steps (m = 8) and verify (m = 8 x
# 5 = 40)
SPEC_K7_M = (1, 5, 8, 40)


def check_quant_matmul_int(torch, device, timer, dims, out: dict) -> dict:
    """quant_matmul_int on W6 planar g128 weights of the four 7B projections
    at decode (m = 32) and verify (m = 128) rows with 6-bit activations, as
    the engine calls it: the activation quantizer, then K7; and at the spec
    phase's W6A6 rows (SPEC_K7_M; marked ``spec``, their activations from a
    generator of their own). Held to the
    plain path on the same x (quantize_act_int, quant_matmul_int_plain) and
    timed whole; K7 alone on the same codes (kernel_ms) gives the
    quantizer's share, and K7 with its generic path forced
    (generic_kernel_ms, held to the same plain values) what the fast path
    saves. The JSON entry sums the four at m = 32, and under "verify" at
    m = 128. Yardstick: bf16 torch.matmul on the dequantized weight."""
    from omniquant_tpu_torch.kernels import quant_matmul as qmm
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.quant import QuantConfig, dequantize_packed

    gen = torch.Generator(device=device).manual_seed(4321)
    spec_gen = torch.Generator(device=device).manual_seed(4322)
    acfg = QuantConfig(n_bits=6)
    rows = []
    for name, (K, N) in _seven_b_shapes(dims).items():
        pw = _seven_b_packed(torch, device, gen, 6, K, N)
        assert pw.layout == "planar"
        w_lib = dequantize_packed(pw, dtype=torch.bfloat16)
        for m in (32, 128) + SPEC_K7_M:
            x = torch.randn(m, K, generator=gen if m in (32, 128)
                            else spec_gen, device=device).to(torch.bfloat16)
            xc, xs = qmm.quantize_act_int(x, acfg)
            want, mag = qmm.quant_matmul_int_plain(xc, xs, pw, magnitude=True)
            lbl = f"quant_matmul_int {name} m={m}"
            err, worst = _int_call_held(
                torch, qmm, lbl, lambda: qmm.quant_matmul_int(x, pw, acfg),
                want, mag, (1, 0, 0))

            def generic(xc=xc, xs=xs, pw=pw):
                return qmm._qmm_int_cuda(xc, xs, pw, torch.bfloat16,
                                         generic=True)

            g_err, _ = _int_held(torch, lbl + " generic path", generic(),
                                 want, tolerance.INT_MATMUL_SLACK * mag)
            del want, mag
            t = timer(lambda: qmm.quant_matmul_int(x, pw, acfg), lbl)
            tk = timer(lambda: qmm._qmm_int_cuda(xc, xs, pw, torch.bfloat16),
                       lbl + " kernel")
            tg = timer(generic, lbl + " kernel, generic path")
            tp = timer(lambda: qmm.quant_matmul_int_plain(
                *qmm.quantize_act_int(x, acfg), pw), lbl + " plain", iters=3)
            tl = timer(lambda: torch.matmul(x, w_lib), lbl + " library")
            nbytes = _int_bytes(pw, m, K, N, pw.qweight.numel() * 4)
            ops = 2.0 * m * K * N
            b, by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
            rows.append(dict(
                shape=name, m=m, K=K, N=N, spec=m in SPEC_K7_M, ms=t,
                kernel_ms=tk,
                generic_kernel_ms=tg, plain_ms=tp, library_ms=tl, bound_ms=b,
                bound_by=by, max_abs_err=max(err, g_err),
                err_over_bound=worst,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=ops / INT8_OPS_PER_S * 1e3))
            log(f"  quant_matmul_int {name:7s} m={m:4d} K={K:5d} N={N:5d}: "
                f"max abs err {err:.3g} ({worst:.3g} x bound)  wrapper "
                f"{t:.4f} ms (K7 alone {tk:.4f}, generic path {tg:.4f})  "
                f"plain {tp:.4f}  bf16 "
                f"matmul {tl:.4f}  bound {b:.4f} ({by})")
        del pw, w_lib
    out["quant_matmul_int_shapes"] = rows
    keys = ("ms", "kernel_ms", "generic_kernel_ms", "plain_ms", "library_ms",
            "bound_ms")
    tot = _totals([r for r in rows if r["m"] == 32], keys)
    tot["verify"] = _totals([r for r in rows if r["m"] == 128], keys)
    tot["shape"] = ("four 7B projections (qkv, o, gate_up, down), W6 planar "
                    "g128, bf16 x quantized to 6-bit codes in the wrapper, "
                    "m=32 (verify: m=128); library: bf16 torch.matmul on the "
                    "dequantized weight")
    v = tot["verify"]
    log(f"  quant_matmul_int sums: m=32 K7 alone {tot['kernel_ms']:.4f} ms "
        f"(generic path {tot['generic_kernel_ms']:.4f}, wrapper "
        f"{tot['ms']:.4f}), m=128 K7 alone {v['kernel_ms']:.4f} (generic "
        f"path {v['generic_kernel_ms']:.4f}, wrapper {v['ms']:.4f}), bf16 "
        f"matmul {tot['library_ms']:.4f} / {v['library_ms']:.4f}")
    return tot


def check_unpack_int8(torch, device, timer, dims, out: dict) -> dict:
    """K8 on the four 7B projections packed W4 g128 (pairs, the W4A4
    engines' prefill) and W6 g128 (planar, W6A6's): K-major codes (N,
    k_pad), exact; the JSON entry sums the four W4 projections. No single
    PyTorch call computes it."""
    from omniquant_tpu_torch.kernels import quant_matmul as qmm

    gen = torch.Generator(device=device).manual_seed(5432)
    rows = []
    for bits in (4, 6):
        for name, (K, N) in _seven_b_shapes(dims).items():
            pw = _seven_b_packed(torch, device, gen, bits, K, N)
            got = qmm._unpack_to_int8(pw)
            want = qmm.unpack_to_int8_plain(pw)
            torch.cuda.synchronize()
            if got.shape != (N, pw.k_pad) or not torch.equal(got, want):
                raise AssertionError(f"_unpack_to_int8 W{bits} {name} "
                                     "differs from its plain version")
            lbl = f"_unpack_to_int8 W{bits} {pw.layout} {name}"
            t = timer(lambda: qmm._unpack_to_int8(pw), lbl)
            tp = timer(lambda: qmm.unpack_to_int8_plain(pw), lbl + " plain",
                       iters=3)
            nbytes = pw.qweight.numel() * 4 + got.numel()
            b, by = bound_ms(nbytes, 0)
            rows.append(dict(shape=name, bits=bits, layout=pw.layout, K=K,
                             N=N, ms=t, plain_ms=tp, library_ms=None,
                             bound_ms=b, bound_by=by, max_abs_err=0.0,
                             bytes_ms=b, ops_ms=0.0))
            log(f"  _unpack_to_int8 W{bits} {pw.layout:6s} {name:7s} "
                f"K={K:5d} N={N:5d}: exact (N, k_pad)  kernel {t:.4f} ms  "
                f"plain {tp:.4f}  bound {b:.4f} ({by})")
            del pw, got, want
    out["unpack_to_int8_shapes"] = rows
    tot = _totals([r for r in rows if r["bits"] == 4],
                  ("ms", "plain_ms", "bound_ms"))
    tot["library_ms"] = None
    tot["shape"] = ("four 7B projections packed W4 g128 pairs -> int8 "
                    "(N, k_pad), K-major; no library call")
    return tot


def check_int_dense(torch, device, timer, dims, out: dict) -> dict:
    """_quant_matmul_int_dense on the four 7B projections packed W4 g128
    pairs with 4-bit activations at the prefill rows of engines E (m =
    4096) and F (m = 8192), as the engine calls it: the activation
    quantizer, K8, then K9. Held to the plain path on the same x
    (quantize_act_int, unpack_to_int8_plain, quant_matmul_int_dense_plain),
    two calls bitwise equal, and timed whole; K8 alone (unpack_ms), K9 on
    the same codes with its operands (xsum, sc, off2: kernel_ms) and K9's
    launch alone on prepared operands (launch_ms, with its rate and share
    of the int8 bound) give their shares. The JSON entry sums the four at
    m = 4096. Yardsticks: bf16 torch.matmul on the dequantized weight
    (library_ms) and torch._int_mm on the same int8 codes (int_mm_ms,
    timed only: a plain s8 GEMM without the group scaling). Last, K9's
    launch on a W4 g64 qkv weight, whose groups close twice as often."""
    from omniquant_tpu_torch.kernels import quant_matmul as qmm
    from omniquant_tpu_torch.quant import (QuantConfig, dequantize_packed,
                                           pack_weight)

    gen = torch.Generator(device=device).manual_seed(6543)
    acfg = QuantConfig(n_bits=4)
    rows = []
    for name, (K, N) in _seven_b_shapes(dims).items():
        pw = _seven_b_packed(torch, device, gen, 4, K, N)
        w8 = qmm.unpack_to_int8_plain(pw)
        w_lib = dequantize_packed(pw, dtype=torch.bfloat16)
        tu = timer(lambda: qmm._unpack_to_int8(pw), f"_unpack_to_int8 {name}")
        for m in (dims["prefill_m"], dims["flash_m"]):
            x = torch.randn(m, K, generator=gen, device=device).to(
                torch.bfloat16)
            xc, xs = qmm.quantize_act_int(x, acfg)
            want, mag = qmm.quant_matmul_int_dense_plain(xc, xs, w8, pw,
                                                         magnitude=True)
            lbl = f"_quant_matmul_int_dense {name} m={m}"
            err, worst = _int_call_held(
                torch, qmm, lbl,
                lambda: qmm._quant_matmul_int_dense(x, pw, acfg), want, mag,
                (0, 1, 1))
            del want, mag
            again = [qmm._qmm_int_dense_cuda(xc, xs, w8, pw, torch.bfloat16)
                     for _ in range(2)]
            torch.cuda.synchronize()
            if not torch.equal(*again):
                raise AssertionError(f"{lbl}: two calls differ")
            del again
            ops_k9 = qmm.int_dense_operands(xc, pw)
            t = timer(lambda: qmm._quant_matmul_int_dense(x, pw, acfg), lbl)
            tk = timer(lambda: qmm._qmm_int_dense_cuda(xc, xs, w8, pw,
                                                       torch.bfloat16),
                       lbl + " kernel")
            tn = timer(lambda: qmm._k9_launch(ops_k9, xs, w8, pw),
                       lbl + " launch")
            tp = timer(lambda: qmm.quant_matmul_int_dense_plain(
                *qmm.quantize_act_int(x, acfg), qmm.unpack_to_int8_plain(pw),
                pw), lbl + " plain", iters=3)
            tl = timer(lambda: torch.matmul(x, w_lib), lbl + " library")
            w8t = w8.t()
            ti = timer(lambda: torch._int_mm(ops_k9.xc, w8t), lbl + " _int_mm")
            del ops_k9, w8t
            nbytes = _int_bytes(pw, m, K, N, pw.qweight.numel() * 4)
            ops = 2.0 * m * K * N
            b, by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
            share = ops / INT8_OPS_PER_S * 1e3 / tn
            rows.append(dict(
                shape=name, m=m, K=K, N=N, spec=m in SPEC_K7_M, ms=t,
                kernel_ms=tk, launch_ms=tn,
                unpack_ms=tu, plain_ms=tp, library_ms=tl, int_mm_ms=ti,
                bound_ms=b, bound_by=by, int8_peak_share=share,
                max_abs_err=err, err_over_bound=worst,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=ops / INT8_OPS_PER_S * 1e3))
            log(f"  _quant_matmul_int_dense {name:7s} m={m:5d} K={K:5d} "
                f"N={N:5d}: max abs err {err:.3g} ({worst:.3g} x bound), "
                f"bitwise repeatable  wrapper {t:.4f} ms (K9 with operands "
                f"{tk:.4f}; launch alone {tn:.4f}, {ops / tn / 1e9:.0f} "
                f"TOP/s, {share:.1%} of the int8 peak; K8 alone {tu:.4f})  "
                f"plain {tp:.4f}  bf16 matmul {tl:.4f}  _int_mm {ti:.4f} "
                f"({ops / ti / 1e9:.0f} TOP/s)  bound {b:.4f} ({by})")
        del pw, w8, w_lib
    out["quant_matmul_int_dense_shapes"] = rows
    # groups of 64 rows close twice as often: K9's launch on a W4 g64
    # (planar) qkv weight beside the g128 one
    K, N = _seven_b_shapes(dims)["qkv"]
    m = dims["prefill_m"]
    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=4, group_size=64), layout="auto")
    pw = pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    del w
    x = torch.randn(m, K, generator=gen, device=device).to(torch.bfloat16)
    xc, xs = qmm.quantize_act_int(x, acfg)
    w8 = qmm._unpack_to_int8(pw)
    ops_k9 = qmm.int_dense_operands(xc, pw)
    t64 = timer(lambda: qmm._k9_launch(ops_k9, xs, w8, pw),
                f"_quant_matmul_int_dense qkv m={m} g64 launch")
    t128 = next(r["launch_ms"] for r in rows
                if r["shape"] == "qkv" and r["m"] == m)
    out["quant_matmul_int_dense_g64"] = dict(
        shape="qkv", m=m, layout=pw.layout, launch_ms=t64, g128_ms=t128)
    log(f"  _quant_matmul_int_dense qkv m={m} W4 g64 {pw.layout}: K9 launch "
        f"{t64:.4f} ms ({t64 / t128:.2f} x the g128 pairs weight's "
        f"{t128:.4f})")
    del pw, w8, ops_k9, x, xc, xs
    for m in (dims["prefill_m"], dims["flash_m"]):
        at = [r for r in rows if r["m"] == m]
        tot = _totals(at, ("ms", "kernel_ms", "launch_ms", "unpack_ms",
                           "plain_ms", "library_ms", "int_mm_ms",
                           "bound_ms"))
        log(f"  _quant_matmul_int_dense four projections m={m}: K9 launch "
            f"{tot['launch_ms']:.4f} ms (with operands {tot['kernel_ms']:.4f}"
            f", bound {tot['bound_ms']:.4f}: "
            f"{tot['bound_ms'] / tot['launch_ms']:.1%})  bf16 matmul "
            f"{tot['library_ms']:.4f}  _int_mm {tot['int_mm_ms']:.4f}  "
            f"wrapper {tot['ms']:.4f}")
        out[f"quant_matmul_int_dense_total_m{m}"] = tot
    tot = out[f"quant_matmul_int_dense_total_m{dims['prefill_m']}"]
    tot["shape"] = ("four 7B projections, W4 g128 pairs, bf16 x quantized to "
                    "4-bit codes in the wrapper, K8 then K9, m=4096; "
                    "library: bf16 torch.matmul on the dequantized weight")
    return tot


# ---------------------------------------------------------------------------
def make_packed(torch, cfg, device, seed, bits=4, group_size=128):
    """Random dense weights from a seeded generator, packed at ``bits`` and
    ``group_size`` (the "auto" layout: pairs for 2/3/4-bit at g128, planar
    for 6-bit and for groups below 128 rows)."""
    from omniquant_tpu_torch.models import LLAMA, llama
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model

    gen = torch.Generator(device=device).manual_seed(seed)
    dense = llama.init_params(gen, cfg, dtype=torch.float32, device=device)
    packed = pack_model(LLAMA, dense,
                        QuantConfig(n_bits=bits, group_size=group_size),
                        device=device)
    return packed


def prompts(torch, n, length, vocab, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (n, length), generator=gen).tolist()


def profile_step(torch, eng, last: dict, n: int, step_s: float) -> dict:
    """One ``step_n(last, n)`` under torch.profiler: the device time of the
    kernels it ran, over the unprofiled step time ``step_s`` of the same
    engine (the device's busy share; the rest of the step the device waits
    on the host loop), the kernel launches per step and the kernels that
    took the most device time. The busy share is "not measured" where the
    profiler sees no device time. Nothing timed should follow it in the
    process: a profiler session may leave launches slower after it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        eng.step_n(last, n)
        torch.cuda.synchronize()
        wall = time.time() - t
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(
        device_ms_per_step=dev_ms, step_ms=step_s * 1e3,
        profiled_step_ms=wall * 1e3 / n, launches_per_step=launches,
        busy_share=dev_ms / (step_s * 1e3) if dev_ms > 0 else "not measured",
        top_kernels=[(e.key[:60], e.self_device_time_total / 1e3 / n)
                     for e in top])


def serve_plans(dims) -> dict:
    """Engine name -> (LlamaEngine keywords, serve's run keywords)."""
    from omniquant_tpu_torch.models.common import ActQuantSpec

    return {
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
        "E": (dict(max_batch=dims["batch"], max_len=dims["max_len"],
                   spec=ActQuantSpec.from_bits(4)),
              dict(n=dims["batch"], length=dims["prompt_len"],
                   steps=dims["decode_steps"], step_n=8)),
        "F": (dict(max_batch=dims["flash_batch"],
                   max_len=2 * dims["flash_len"],
                   spec=ActQuantSpec.from_bits(4)),
              dict(n=dims["flash_batch"], length=dims["flash_len"], steps=8,
                   step_n=8)),
        "G": (dict(max_batch=dims["batch"], max_len=dims["max_len"],
                   spec=ActQuantSpec.from_bits(6)),
              dict(n=dims["batch"], length=dims["prompt_len"],
                   steps=dims["decode_steps"], step_n=8, verify=4)),
        "H": (dict(max_batch=dims["batch"], max_len=dims["max_len"]),
              dict(n=dims["batch"], length=dims["prompt_len"],
                   steps=dims["decode_steps"], step_n=8, verify=4)),
    }


# the packed model each engine of the serve phase runs, (bits, group_size);
# engines not named run W4 g128 (pairs)
SERVE_MODELS = {"G": (6, 128), "H": (2, 64)}


def serve(torch, device, cfg, dims, seed, out: dict) -> dict:
    """The main path: eight engines (SERVE_PATHS) through their user entry
    points, one after another: A-F on one W4 g128 model (E and F with
    4-bit activations), G on a W6 g128 model packed once A-F's is freed, H
    on a W2 g64 model (planar) packed once G's is freed. Returns the launch
    counts summed over the eight runs."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.serving import LlamaEngine

    def pack(bits, gs):
        t0 = time.time()
        packed = make_packed(torch, cfg, device, seed, bits, gs)
        torch.cuda.synchronize()
        key = f"pack_w{bits}g{gs}_s"
        out[key] = time.time() - t0
        layout = packed["layers"][0]["q_proj"].layout
        log(f"serve: {cfg.num_hidden_layers}-layer model packed W{bits} g{gs} "
            f"({layout}) in {out[key]:.1f} s")
        return packed

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

    plans = serve_plans(dims)
    total, packed, packed_as = {}, None, None
    for name, (eng_kw, run_kw) in plans.items():
        model = SERVE_MODELS.get(name, (4, 128))
        if model != packed_as:
            del packed
            torch.cuda.empty_cache()
            packed, packed_as = pack(*model), model
        base = torch.cuda.memory_allocated()
        eng = LlamaEngine(packed, cfg, dtype=torch.bfloat16, seed=seed,
                          device=device, **eng_kw)
        cache_gb = sum(t.numel() * t.element_size()
                       for bufs in (eng.cache.k, eng.cache.v,
                                    eng.cache.k_scale, eng.cache.v_scale)
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
        # a freed engine must give its cache and buffers back at once
        res["left_gib"] = (torch.cuda.memory_allocated() - base) / 2**30
        if res["left_gib"] > 0.5:
            raise AssertionError(f"engine {name} left {res['left_gib']:.2f} "
                                 "GiB allocated after it was freed")
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
    same tokens; then W2A16 and W4A16 g64 engines (planar words,
    e2e_planar), and W4A4 and W6A6 ones (e2e_int)."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.serving import LlamaEngine

    packed = make_packed(torch, cfg, device, seed + 1)
    ref_params = plain_reference_params(torch, packed)
    res = {}

    def held(key, got, want, tol=E2E_TOL):
        gap = res[key] = logit_gap(got, want)
        log(f"  e2e {key}: rms rel err {gap['rms_rel']:.3g} (tol "
            f"{tol['rms']}), max rel err {gap['max_rel']:.3g} (tol "
            f"{tol['max']}), cosine {gap['cos']:.3g} (floor "
            f"{tol.get('cos', '-')}), norm ratio {gap['norm_ratio']:.3g} "
            f"(band {tol.get('norm', '-')}), argmax agreement "
            f"{gap['argmax_agree']:.3f}")
        if not gap_within(gap, tol):
            failed.append(key)
        return gap["rms_rel"]

    failed = []

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
    del packed, ref_params
    torch.cuda.empty_cache()
    for bits in (2, 4):
        e2e_planar(torch, device, cfg, seed, bits, held)
    for abits in (4, 6):
        failed += e2e_int(torch, device, cfg, seed, abits, held)
    out["e2e"] = res
    if failed:
        raise AssertionError(f"e2e outside tolerance: {failed}")


def e2e_planar(torch, device, cfg, seed, bits, held):
    """A W2A16 or W4A16 g64 bf16-KV engine (planar words: planar K1 at the
    32 x 128 prefill and the first decode) against the plain f32 forward,
    under E2E_TOL (``held`` records a miss)."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.serving import LlamaEngine

    packed = make_packed(torch, cfg, device, seed + 1, bits, 64)
    assert packed["layers"][0]["q_proj"].layout == "planar"
    ref_params = plain_reference_params(torch, packed)
    n, length = 32, 128
    reqs = prompts(torch, n, length, cfg.vocab_size, seed + 7 * length)
    eng = LlamaEngine(packed, cfg, max_batch=n, max_len=2 * length,
                      dtype=torch.bfloat16, seed=seed, device=device)
    slots, prefill = eng.add_requests(reqs, return_logits=True)
    first = [eng._pending_next[s] for s in slots]
    toks, lens = eng._device_tokens(dict(zip(slots, first)))
    dec = eng._decode_impl(toks, lens, eng._kv_len(1))
    del eng
    full = torch.cat([torch.tensor(reqs, device=device),
                      torch.tensor(first, device=device)[:, None]], dim=1)
    with torch.no_grad():
        ref = llama.forward(ref_params, full, cfg)
    held(f"w{bits}g64_prefill_{n}x{length}", prefill, ref[:, length - 1])
    held(f"w{bits}g64_decode_{n}x{length}", dec, ref[:, length])
    del packed, ref_params, ref
    torch.cuda.empty_cache()


def e2e_int(torch, device, cfg, seed, abits, held):
    """W4A4 (W4 pairs) or W6A6 (W6 planar) engines against the plain f32
    forward with the same activation quantizers: prefill logits (K8 + K9)
    and the first decode (fake-quant + K1, or K7). At 4 x 512 the same
    engine also runs on the CPU, every kernel replaced by its plain
    version, and must show the same error as the card's; so must the plain
    forward in bf16. Each comparison also holds the logits' cosine and norm
    ratio (E2E_INT_TOL), and the run checks that those bounds reject zero,
    random, negated, halved and doubled logits. Returns the keys that missed
    their bounds."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.models.common import ActQuantSpec
    from omniquant_tpu_torch.serving import LlamaEngine
    from omniquant_tpu_torch.serving.engine import _to_engine

    wbits = 4 if abits == 4 else 6
    spec = ActQuantSpec.from_bits(abits)
    failed = []
    packed = make_packed(torch, cfg, device, seed + 1, wbits)
    ref_params = plain_reference_params(torch, packed)
    tag = f"w{wbits}a{abits}"
    tol = E2E_INT_TOL[abits]
    for n, length in ((32, 128), (4, 512)):
        reqs = prompts(torch, n, length, cfg.vocab_size, seed + 7 * length)
        errs = {}
        for dev in (("cuda", "cpu") if n == 4 else ("cuda",)):
            eng = LlamaEngine(packed, cfg, max_batch=n, max_len=2 * length,
                              dtype=torch.bfloat16, spec=spec, seed=seed,
                              device=device if dev == "cuda" else "cpu")
            slots, logits = eng.add_requests(reqs, return_logits=True)
            if dev == "cuda":
                first = [eng._pending_next[s] for s in slots]
            toks, lens = eng._device_tokens(dict(zip(slots, first)))
            dec = eng._decode_impl(toks, lens, eng._kv_len(1))
            del eng
            if dev == "cuda":
                tokens = torch.tensor(reqs, device=device)
                full = torch.cat([tokens, torch.tensor(
                    first, device=device)[:, None]], dim=1)
                with torch.no_grad():
                    ref = llama.forward(ref_params, full, cfg, spec=spec)
                    # the same plain forward in bf16: what bf16 alone moves
                    ref16 = llama.forward(
                        _to_engine(ref_params, device, torch.bfloat16), full,
                        cfg, spec=spec)
                errs["bf16 forward"] = tuple(
                    held(f"{tag}_bf16_forward_{what}_{n}x{length}",
                         ref16[:, i], ref[:, i], tol)
                    for i, what in ((length - 1, "prefill"),
                                    (length, "decode")))
                del ref16
            where = "" if dev == "cuda" else "plain_"
            errs[dev] = (
                held(f"{tag}_{where}prefill_{n}x{length}", logits,
                     ref[:, length - 1], tol),
                held(f"{tag}_{where}decode_{n}x{length}", dec, ref[:, length],
                     tol))
            if dev == "cuda":
                out16 = (logits, dec)
                # the bounds must reject gross failures of these logits
                fakes = {"zero": torch.zeros_like(logits),
                         "random": torch.randn_like(logits.float())
                         * logits.float().pow(2).mean().sqrt(),
                         "negated": -logits, "halved": 0.5 * logits,
                         "doubled": 2.0 * logits}
                for fault, fake in fakes.items():
                    if gap_within(logit_gap(fake, ref[:, length - 1]), tol):
                        failed.append(f"{tag}_bounds_admit_{fault}_logits")
                del fakes
            else:
                # the card's engine against the CPU's: cosine and norm only,
                # as two bf16 runs may each flip activation codes
                vs = dict(tol, rms=math.inf, max=math.inf)
                for i, what in enumerate(("prefill", "decode")):
                    held(f"{tag}_kernels_vs_plain_{what}_{n}x{length}",
                         out16[i], (logits, dec)[i], vs)
        del ref, out16
        for i, what in enumerate(("prefill", "decode")):
            k = errs["cuda"][i]
            for name, key in (("the bf16 forward", "bf16 forward"),
                              ("plain versions on the CPU", "cpu")):
                if key not in errs:
                    continue
                p = errs[key][i]
                log(f"  e2e {tag} {what} {n}x{length}: kernels {k:.4g}, "
                    f"{name} {p:.4g} (kernels at most {E2E_INT_VS_PLAIN} "
                    f"x that)")
                if not k <= E2E_INT_VS_PLAIN * p:
                    failed.append(f"{tag}_{what}_{n}x{length}_vs_{key}")
    del packed, ref_params
    torch.cuda.empty_cache()
    return failed


# ---------------------------------------------------------------------------
# calibrate phase: name -> CalibConfig keywords. (a) the headline W4A16 g128
# with LWC; (b) W4A4 per-channel with LWC + LET, its act stats first. The
# paper's recipe is 128 windows x 20 epochs; here 16 x 2.
CALIB_RUNS = {
    "a_w4a16g128_lwc": dict(wbits=4, abits=16, group_size=128, lwc=True,
                            epochs=2, batch_size=1, lwc_lr=1e-2),
    "b_w4a4_lwc_let": dict(wbits=4, abits=4, lwc=True, let=True, epochs=2),
}
CALIB_NSAMPLES, CALIB_SEQLEN, CALIB_HELD_OUT = 16, 2048, 4
# kernels the calibrated model's engine must launch (16 x 128 prompts: the
# prefill is m = 2048, the integer dense route for W4A4)
CALIB_PATHS = {
    "a_w4a16g128_lwc": ("quant_matmul", "quant_matmul_prefill",
                        "kv_cache_prefill_write", "kv_cache_write"),
    "b_w4a4_lwc_let": ("_unpack_to_int8", "_quant_matmul_int_dense",
                       "quant_matmul", "kv_cache_prefill_write",
                       "kv_cache_write"),
    "c_opt_w6a6_lwc_let": ("_unpack_to_int8", "_quant_matmul_int_dense",
                           "quant_matmul_int", "kv_cache_prefill_write",
                           "kv_cache_write"),
    "d_opt27b_w4a16g128_lwc": ("quant_matmul", "quant_matmul_prefill",
                               "kv_cache_prefill_write", "kv_cache_write"),
    "f_falcon7b_w4a16g64_lwc": ("quant_matmul", "quant_matmul_planar_decode",
                                "quant_matmul_planar_prefill",
                                "kv_cache_prefill_write", "kv_cache_write"),
}


def calibrate_phase(torch, device, cfg, seed, out: dict) -> None:
    """Block-wise calibration of a full-width LLaMA (random weights from a
    seeded generator, cfg's depth) on synthetic 2048-token windows, once
    per CALIB_RUNS entry, each freed before the next (calibrate_run)."""
    from omniquant_tpu_torch.models import LLAMA, llama

    gen = torch.Generator(device=device).manual_seed(seed + 15)
    dense = llama.init_params(gen, cfg, dtype=torch.float32, device=device)
    res = out["calibrate"] = {}
    for name, kw in CALIB_RUNS.items():
        res[name] = calibrate_run(torch, device, LLAMA, cfg, dense,
                                  *calib_windows(cfg, seed), name, kw, seed)
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()


def calib_windows(cfg, seed) -> tuple:
    """(CALIB_NSAMPLES training windows, CALIB_HELD_OUT held-out windows) of
    the synthetic corpus at CALIB_SEQLEN tokens."""
    from omniquant_tpu_torch.calib import get_synthetic, sample_windows

    train, test = get_synthetic(CALIB_NSAMPLES, seed, CALIB_SEQLEN,
                                vocab_size=cfg.vocab_size)
    return train, sample_windows(test, CALIB_HELD_OUT, seed + 1,
                                 CALIB_SEQLEN)


def _chain(torch, family, cfg, layers, x, spec):
    """x through ``layers`` (one window), the blocks' activation
    quantizers at ``spec``."""
    from omniquant_tpu_torch.models.common import causal_mask

    s = x.shape[1]
    mask = causal_mask(s, s, device=x.device)
    pos = torch.arange(s, device=x.device)
    for layer in layers:
        x, _ = family.block_forward(layer, x, cfg, mask, pos, spec)
    return x


def _without_biases(tree):
    """``tree`` with every "bias" entry None."""
    if isinstance(tree, dict):
        return {k: None if k == "bias" else _without_biases(v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_without_biases(v) for v in tree]
    return tree


def _held_with_biases(torch, family, cfg, name, ref_params, full, served,
                      length, gaps) -> list:
    """A pack with LET biases served with 16-bit activations (``served``:
    prefill and first decode logits) against the plain f32 forward at
    E2E_TOL; the same forward without the biases must fall outside that
    bound, so a dropped bias would fail. Returns the failed checks."""
    with torch.no_grad():
        ref = family.forward(ref_params, full, cfg)
        bare = family.forward(_without_biases(ref_params), full, cfg)
    failed = []
    for what, got, i in (("prefill", served[0], length - 1),
                         ("decode", served[1], length)):
        gap = gaps[f"a16_{what}"] = logit_gap(got, ref[:, i])
        gap["without_biases"] = logit_gap(bare[:, i], ref[:, i])
        log(f"  calibrate {name} served with 16-bit activations, {what} "
            f"logits: rms rel err {gap['rms_rel']:.3g}, max rel err "
            f"{gap['max_rel']:.3g} (tol {E2E_TOL['rms']}, "
            f"{E2E_TOL['max']}); the forward without the LET biases: rms "
            f"rel {gap['without_biases']['rms_rel']:.3g}, max rel "
            f"{gap['without_biases']['max_rel']:.3g}")
        if not gap_within(gap, E2E_TOL):
            failed.append(f"a16 {what}")
        if gap_within(gap["without_biases"], E2E_TOL):
            failed.append(f"a16 {what}: the bound admits dropped biases")
    return failed


def calibrate_run(torch, device, family, cfg, dense, train, held, name, kw,
                  seed) -> dict:
    """calibrate on a copy of ``dense``'s blocks, then five checks, any
    failure raising: (1) every loss finite, each layer's last epoch below
    its first; (2) on the held-out windows the last block's output is
    nearer the fp model's (MSE) than round-to-nearest's; (3) each folded
    block gives, on one window, the output of effective_block_weights with
    the final trainables; (4) pack_model's words dequantize to the folded
    weights bit for bit; (5) the family's engine on the packed model, 16 x
    128 prompts and step_n(., 8): prefill and first decode logits against a
    plain f32 forward of the packed model (E2E_TOL; W4A4 / W6A6 as
    e2e_int) and every kernel of CALIB_PATHS launched; a pack with
    quantized activations is also served with 16-bit activations and held
    at E2E_TOL (_held_with_biases). Then the perplexity of the calibrated
    fake-quant model and of its pack (ppl_check)."""
    import dataclasses
    import statistics

    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.calib import (
        CalibConfig, calibrate, collect_act_stats)
    from omniquant_tpu_torch.models.common import NO_ACT_QUANT
    from omniquant_tpu_torch.quant import dequantize_packed
    from omniquant_tpu_torch.serving import pack_model
    from omniquant_tpu_torch.serving.engine import _to_engine

    cc = CalibConfig(nsamples=CALIB_NSAMPLES, **kw)
    wcfg, spec = cc.weight_quant_config, cc.act_quant_spec
    params = dict(dense, layers=[
        {k: {n: (None if t is None else t.clone()) for n, t in v.items()}
         for k, v in b.items()} for b in dense["layers"]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    stats = (collect_act_stats(family, params, cfg, train, device=device)
             if cc.let else (None, None))
    torch.cuda.synchronize()
    stats_s = time.time() - t0
    losses, timings = [], {}
    params, omni = calibrate(
        family, params, cfg, train, cc, *stats,
        progress_cb=lambda i, e, l: losses.append((i, e, l)), device=device,
        timings=timings)
    torch.cuda.synchronize()
    res = dict(
        config=kw, nsamples=CALIB_NSAMPLES, seqlen=CALIB_SEQLEN,
        layers=cfg.num_hidden_layers, phase_s=time.time() - t0,
        act_stats_s=stats_s,
        step_s=statistics.median(timings["step_s"][1:]),
        first_step_s=timings["step_s"][0], steps=len(timings["step_s"]),
        fp_pass_s=timings["fp_pass_s"], propagate_s=timings["propagate_s"],
        layer_s=timings["layer_s"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        losses=losses)
    del stats
    log(f"  calibrate {name}: {res['steps']} steps, {res['step_s']:.4f} s a "
        f"step (median after the first; first {res['first_step_s']:.3f} s); "
        f"fp pass " + ", ".join(f"{t:.3f}" for t in res["fp_pass_s"])
        + " s, propagation " + ", ".join(f"{t:.3f}" for t in
                                         res["propagate_s"])
        + f" s a layer; act stats {stats_s:.2f} s; phase "
        f"{res['phase_s']:.1f} s; peak {res['peak_gib']:.2f} GiB")
    log(f"  calibrate {name} losses (layer, epoch, mean): " + ", ".join(
        f"({i}, {e}, {l:.6e})" for i, e, l in losses))

    # (1) finite and falling
    for i in range(cfg.num_hidden_layers):
        ls = [l for li, _, l in losses if li == i]
        if len(ls) != cc.epochs or not all(map(math.isfinite, ls)):
            raise AssertionError(f"{name}: layer {i} losses {ls}")
        if not ls[-1] < ls[0]:
            raise AssertionError(f"{name}: layer {i} loss did not fall: {ls}")

    with torch.no_grad():
        # (2) beats round-to-nearest on held-out windows
        rtn_cfg = dataclasses.replace(wcfg, lwc=False)
        rtn = [family.effective_block_weights(b, rtn_cfg, None, None, cfg)
               for b in dense["layers"]]
        err = {"calibrated": 0.0, "rtn": 0.0}
        for w in held:
            x = family.embed(dense, torch.as_tensor(w, device=device)[None],
                             cfg)
            fp = _chain(torch, family, cfg, dense["layers"], x, NO_ACT_QUANT)
            for key, layers in (("calibrated", params["layers"]),
                                ("rtn", rtn)):
                err[key] += (_chain(torch, family, cfg, layers, x, spec)
                             - fp).pow(2).mean().item() / len(held)
        del rtn, fp
        res["held_out_mse"] = err
        log(f"  calibrate {name}: held-out last-block MSE against fp "
            f"{err['calibrated']:.6e}, round-to-nearest {err['rtn']:.6e}")
        if not err["calibrated"] < err["rtn"]:
            raise AssertionError(f"{name}: calibrated model does not beat "
                                 f"round-to-nearest on held-out windows")

        # (3) the fold is the trained function
        x = family.embed(dense, torch.as_tensor(held[0], device=device)[None],
                         cfg)
        fold_gap = 0.0
        for i, b in enumerate(dense["layers"]):
            t = omni[i]
            eff = family.effective_block_weights(
                b, wcfg, t.get("lwc"), t.get("let"), cfg)
            want = _chain(torch, family, cfg, [eff], x, spec)
            got = _chain(torch, family, cfg, [params["layers"][i]], x, spec)
            fold_gap = max(fold_gap, rms_rel_err(got, want))
            del eff
        res["fold_rms_rel"] = fold_gap
        log(f"  calibrate {name}: folded blocks against the trained "
            f"weights, largest rms rel err {fold_gap:.3g} (tol 1e-6)")
        if not fold_gap <= 1e-6:
            raise AssertionError(f"{name}: fold differs from the trained "
                                 f"weights ({fold_gap})")

        # (4) the pack is exact
        packed = pack_model(family, params, wcfg, omni, device=device)
        inexact = [
            (i, n) for i, b in enumerate(packed["layers"])
            for n in family.linear_names
            if not torch.equal(dequantize_packed(b[n]).t(),
                               params["layers"][i][n]["weight"])]
        if inexact:
            raise AssertionError(f"{name}: packed words do not dequantize to "
                                 f"the folded weights: {inexact}")
        layout = packed["layers"][0][family.linear_names[0]].layout
        log(f"  calibrate {name}: pack exact ({layout} words, "
            f"{len(family.linear_names) * cfg.num_hidden_layers} linears)")
    del omni
    res["ppl"] = ppl_check(torch, device, family, cfg, params, packed, spec,
                           name, seed)
    del params
    torch.cuda.empty_cache()

    # (5) serve the calibrated model
    n, length = 16, 128
    reqs = prompts(torch, n, length, cfg.vocab_size, seed + 15)
    engine = engine_for(family)
    eng = engine(packed, cfg, max_batch=n, max_len=2 * length,
                 dtype=torch.bfloat16, spec=spec, seed=seed, device=device)
    kernels.reset_launch_counts()
    slots, prefill = eng.add_requests(reqs, return_logits=True)
    first = [eng._pending_next[s] for s in slots]
    toks, lens = eng._device_tokens(dict(zip(slots, first)))
    dec = eng._decode_impl(toks, lens, eng._kv_len(1))
    streams = eng.step_n(dict(zip(slots, first)), 8)
    counts = kernels.launch_counts()
    del eng
    if any(len(v) != 8 or not all(0 <= t < cfg.vocab_size for t in v)
           for v in streams.values()):
        raise AssertionError(f"{name}: malformed token streams")
    res["launches"] = counts
    missing = [k for k in CALIB_PATHS[name] if counts[k] <= 0]
    log(f"  calibrate {name}: engine launches {counts}")
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
    served_a16 = None
    if spec.act is not None:
        # the same pack with 16-bit activations, held at E2E_TOL: the LET
        # biases (the norms', and the linears' added after K1) at a bound
        # that the 4-bit activations' band is too wide to give
        eng = engine(packed, cfg, max_batch=n, max_len=2 * length,
                     dtype=torch.bfloat16, spec=NO_ACT_QUANT, seed=seed,
                     device=device)
        slots, prefill_a16 = eng.add_requests(reqs, return_logits=True)
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        served_a16 = (prefill_a16, eng._decode_impl(toks, lens,
                                                    eng._kv_len(1)))
        del eng
    ref_params = plain_reference_params(torch, packed)
    del packed
    full = torch.cat([torch.tensor(reqs, device=device),
                      torch.tensor(first, device=device)[:, None]], dim=1)
    with torch.no_grad():
        ref = family.forward(ref_params, full, cfg, spec=spec)
        ref16 = (family.forward(_to_engine(ref_params, device,
                                           torch.bfloat16), full, cfg,
                                spec=spec)
                 if spec.act is not None else None)
    failed = []
    gaps = res["logits"] = {}
    if served_a16 is not None:
        failed += _held_with_biases(torch, family, cfg, name, ref_params,
                                    full, served_a16, length, gaps)
    for what, got, i in (("prefill", prefill, length - 1),
                         ("decode", dec, length)):
        gap = gaps[what] = logit_gap(got, ref[:, i])
        tol = E2E_TOL
        if ref16 is not None:
            tol = E2E_INT_TOL[cc.abits]
            gap["bf16_forward"] = logit_gap(ref16[:, i], ref[:, i])
            if not gap["rms_rel"] <= (E2E_INT_VS_PLAIN
                                      * gap["bf16_forward"]["rms_rel"]):
                failed.append(f"{what} vs the bf16 forward")
        log(f"  calibrate {name} {what} logits: rms rel err "
            f"{gap['rms_rel']:.3g} (tol {tol['rms']}), max rel err "
            f"{gap['max_rel']:.3g} (tol {tol['max']}), cosine "
            f"{gap['cos']:.3g}, norm ratio {gap['norm_ratio']:.3g}"
            + (f"; bf16 plain forward rms rel err "
               f"{gap['bf16_forward']['rms_rel']:.3g} (kernels at most "
               f"{E2E_INT_VS_PLAIN} x that)" if ref16 is not None else ""))
        if not gap_within(gap, tol):
            failed.append(what)
    del ref, ref16, ref_params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{name}: served logits outside tolerance: "
                             f"{failed}")
    return res


def engine_for(family):
    """The serving engine class of a model family."""
    from omniquant_tpu_torch import serving

    return {"llama": serving.LlamaEngine, "opt": serving.OPTEngine,
            "falcon": serving.FalconEngine}[family.name]


# the perplexity check (ppl_check): the packed model, served in bf16
# through K1 or the integer route, against the calibrated fake-quant model
# in f32, on every PPL_SEQLEN window of the synthetic test split. Per token,
# the packed model's NLL may stray from the f32 one's by at most
# PPL_VS_PLAIN times what a plain bf16 forward of the same pack (plain
# PyTorch ops, no kernel) strays, rms over the tokens: the kernels may add
# no more than that forward's own bf16 rounding (the e2e rule, E2E_INT_VS_
# PLAIN). And since |ln ppl_packed - ln ppl_fake_quant| is the mean of those
# per-token gaps, at most their rms, the two perplexities are held to
# ln-distance PPL_VS_PLAIN times the bf16 forward's rms gap as well.
PPL_SEQLEN = 2048
PPL_VS_PLAIN = E2E_INT_VS_PLAIN


def _token_nll(torch, family, params, cfg, window, spec):
    """The shifted cross-entropy of each token of one window, f32."""
    logits = family.forward(params, window[None], cfg, spec)
    logp = torch.log_softmax(logits[0, :-1].float(), dim=-1)
    return -logp.gather(-1, window[1:, None])[:, 0]


def ppl_check(torch, device, family, cfg, params, packed, spec, name,
              seed) -> dict:
    """evaluate_ppl of the calibrated fake-quant model (``params``, f32) and
    of its pack (in bf16, as an engine holds it), with seconds a window and
    the pack's kernel launches; then the per-token gaps against a plain
    bf16 forward of the pack (the rule above). Raises outside it."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.calib import get_synthetic
    from omniquant_tpu_torch.eval import evaluate_ppl
    from omniquant_tpu_torch.serving.engine import _to_engine

    _, test = get_synthetic(0, seed, PPL_SEQLEN, vocab_size=cfg.vocab_size)
    n_win = test.shape[1] // PPL_SEQLEN
    served = _to_engine(packed, device, torch.bfloat16)
    res = dict(seqlen=PPL_SEQLEN, windows=n_win)
    for key, p in (("fake_quant", params), ("packed", served)):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.time()
        res[key] = evaluate_ppl(family, p, cfg, test, seqlen=PPL_SEQLEN,
                                spec=spec)
        torch.cuda.synchronize()
        res[f"{key}_s_per_window"] = (time.time() - t) / n_win
    res["launches"] = kernels.launch_counts()
    route = (("_unpack_to_int8", "_quant_matmul_int_dense")
             if spec.act is not None else ("quant_matmul",))
    plain16 = _to_engine(plain_reference_params(torch, packed), device,
                         torch.bfloat16)
    sq = {"packed": 0.0, "bf16_forward": 0.0}
    with torch.inference_mode():
        for i in range(n_win):
            w = torch.as_tensor(test[0, i * PPL_SEQLEN: (i + 1) * PPL_SEQLEN],
                                device=device).long()
            ref = _token_nll(torch, family, params, cfg, w, spec)
            for key, p in (("packed", served), ("bf16_forward", plain16)):
                sq[key] += (_token_nll(torch, family, p, cfg, w, spec)
                            - ref).pow(2).sum().item()
    n_tok = n_win * (PPL_SEQLEN - 1)
    res.update({f"nll_rms_gap_{k}": math.sqrt(v / n_tok)
                for k, v in sq.items()})
    res["ln_ppl_gap"] = abs(math.log(res["packed"] / res["fake_quant"]))
    bound = PPL_VS_PLAIN * res["nll_rms_gap_bf16_forward"]
    log(f"  calibrate {name} perplexity at {PPL_SEQLEN} tokens over {n_win} "
        f"windows: fake-quant (f32) {res['fake_quant']:.4f} "
        f"({res['fake_quant_s_per_window']:.4f} s a window), packed (bf16) "
        f"{res['packed']:.4f} ({res['packed_s_per_window']:.4f} s a "
        f"window); |ln ratio| {res['ln_ppl_gap']:.3g}, per-token NLL rms gap "
        f"{res['nll_rms_gap_packed']:.3g}, bf16 plain forward's "
        f"{res['nll_rms_gap_bf16_forward']:.3g} (both at most "
        f"{PPL_VS_PLAIN} x that: {bound:.3g}); packed launches "
        f"{res['launches']}")
    missing = [k for k in route if res["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"{name}: perplexity of the pack never "
                             f"launched {missing}")
    if not (math.isfinite(res["packed"]) and math.isfinite(res["fake_quant"])
            and res["nll_rms_gap_packed"] <= bound
            and res["ln_ppl_gap"] <= bound):
        raise AssertionError(f"{name}: perplexities outside the bound: {res}")
    del served, plain16
    return res


# ---------------------------------------------------------------------------
# opt phase: OPT-6.7B widths (facebook/opt-6.7b's config.json: vocab 50272,
# hidden 4096, ffn 16384, 32 heads of 128, 2048 positions, pre-LN), depth
# cut to 2 layers; random weights from a seeded generator.
OPT_67B = dict(vocab_size=50272, hidden_size=4096, ffn_dim=16384,
               num_hidden_layers=2, num_attention_heads=32,
               max_position_embeddings=2048)
OPT_SERVE_BATCH, OPT_SERVE_LEN = 8, 512
# kernels each OPT engine must launch: a W4 g128 (pairs) model, 8 x 512
# prompts (K1's prefill tile at m = 4096, K2, K3), the first decode and
# step_n(., 8) (K1's decode tile, K4; int8: K4 on codes and planes, K6 with
# the ring, K5's flush)
OPT_SERVE_PATHS = {
    "native": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
               "kv_cache_prefill_write", "kv_cache_write"),
    "int8": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
             "kv_cache_prefill_write", "kv_cache_write",
             "kv_cache_write_span", "decode_attention_int8"),
}
# the OPT calibration: W6A6 per-channel, LWC + LET with the shifts of
# collect_act_stats, on calibrate_phase's windows; its pack (planar W6) is
# served 16 x 128 (m = 2048: K8 + K9) and decoded by K7 (CALIB_PATHS)
OPT_CALIB_RUNS = {
    "c_opt_w6a6_lwc_let": dict(wbits=6, abits=6, lwc=True, let=True,
                               epochs=2),
}


# outlier channels: trained OPT models from 6.7B on carry a few hidden
# dims whose activations are tens of times the rest (Dettmers et al.,
# LLM.int8(), 2022), which is what LET's smoothing is for; random weights
# have none. (count, factor on those LayerNorm weights) plants them. Without
# them W6A6 LWC + LET loses to round-to-nearest on held-out windows (CPU
# rehearsals at hidden 512 and 1024: LET's SmoothQuant start hurts weights
# without outliers, and 2 epochs do not recover).
OPT_OUTLIERS = (6, 20.0)


def opt_dense(torch, device, cfg, seed):
    """A random OPT (opt.init_params) whose biases and LayerNorms are moved
    off their init (N(0, 0.02) biases, LayerNorm weights 1 + N(0, 0.1)), so
    the served bias adds are held too, with OPT_OUTLIERS in every block's
    two LayerNorms."""
    from omniquant_tpu_torch.models import opt

    gen = torch.Generator(device=device).manual_seed(seed)
    dense = opt.init_params(gen, cfg, dtype=torch.float32, device=device)
    outliers = torch.randperm(cfg.hidden_size, generator=gen,
                              device=device)[:OPT_OUTLIERS[0]]
    for sub in [dense["final_layer_norm"]] + [
            v for b in dense["layers"] for v in b.values()]:
        sub["bias"].normal_(0.0, 0.02, generator=gen)
        if sub["weight"].dim() == 1:
            sub["weight"].normal_(1.0, 0.1, generator=gen)
    for b in dense["layers"]:
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            b[ln]["weight"][outliers] *= OPT_OUTLIERS[1]
    return dense


def opt_phase(torch, device, seed, out: dict) -> None:
    """The OPT family at OPT-6.7B widths, 2 layers: a W4 g128 pack served
    by a bf16-KV and an int8-KV OPTEngine (opt_serve), then the W6A6 LWC +
    LET calibration with calibrate_run's five checks and ppl_check."""
    from omniquant_tpu_torch.models import OPT, opt

    cfg = opt.OPTConfig(**OPT_67B)
    res = out["opt"] = {}
    dense = opt_dense(torch, device, cfg, seed + 16)
    opt_serve(torch, device, cfg, dense, seed, res)
    torch.cuda.empty_cache()
    for name, kw in OPT_CALIB_RUNS.items():
        res[name] = calibrate_run(torch, device, OPT, cfg, dense,
                                  *calib_windows(cfg, seed), name, kw, seed)
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()


def opt_serve(torch, device, cfg, dense, seed, res: dict) -> None:
    """``dense`` packed W4 g128 (pairs), served by a bf16-KV and an int8-KV
    OPTEngine (serve_and_hold, OPT_SERVE_PATHS)."""
    from omniquant_tpu_torch.models import OPT
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model

    packed = pack_model(OPT, dense, QuantConfig(n_bits=4, group_size=128),
                        device=device)
    serve_and_hold(torch, device, OPT, cfg, packed, OPT_SERVE_PATHS,
                   OPT_SERVE_BATCH, OPT_SERVE_LEN, seed, res, "OPT")


def serve_and_hold(torch, device, family, cfg, packed, paths, n, length,
                   seed, res: dict, label: str, counts_check=None,
                   verify=None) -> None:
    """``packed`` served by the family's engine once per entry of ``paths``
    (KV dtype -> kernels it must launch): n x length prompts, the first
    decode and step_n(., 8), and where ``verify`` (KV dtype -> tokens)
    names the KV dtype a verify_step of that many tokens on every slot,
    timed on the host clock behind a synchronisation; prefill and first
    decode logits against a plain f32 forward of the dequantized pack at
    E2E_TOL. ``counts_check(kv, eng, counts)``, when given, may raise on the
    run's launch counts."""
    from omniquant_tpu_torch import kernels

    engine = engine_for(family)
    reqs = prompts(torch, n, length, cfg.vocab_size, seed + 16)
    failed, logits = [], {}
    for kv, path in paths.items():
        eng = engine(packed, cfg, max_batch=n, max_len=2 * length,
                     dtype=torch.bfloat16, kv_dtype=kv, seed=seed,
                     device=device)
        warm = eng.add_requests(prompts(torch, 2, 16, cfg.vocab_size, seed))
        eng.step_n({x: eng._pending_next[x] for x in warm}, 2)
        for x in warm:
            eng.release(x)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        slots, prefill = eng.add_requests(reqs, return_logits=True)
        torch.cuda.synchronize()
        prefill_s = time.time() - t
        first = [eng._pending_next[x] for x in slots]
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))
        torch.cuda.synchronize()
        t = time.time()
        streams = eng.step_n(dict(zip(slots, first)), 8)
        torch.cuda.synchronize()
        decode_s = time.time() - t
        n_ver = (verify or {}).get(kv, 0)
        if n_ver:
            t = time.time()
            ver = eng.verify_step({x: streams[x][-n_ver:] for x in slots})
            torch.cuda.synchronize()
            verify_s = time.time() - t
            if any(len(ver[x]) != n_ver
                   or not all(0 <= y < cfg.vocab_size for y in ver[x])
                   for x in slots):
                raise AssertionError(f"{label} {kv}: malformed verify_step")
        counts = kernels.launch_counts()
        attn_kernel = eng.attn_kernel
        if counts_check is not None:
            counts_check(kv, eng, counts)
        del eng
        torch.cuda.empty_cache()
        if any(len(v) != 8 or not all(0 <= x < cfg.vocab_size for x in v)
               for v in streams.values()):
            raise AssertionError(f"{label} {kv}: malformed token streams")
        r = res[f"serve_{kv}"] = dict(
            prefill_s=prefill_s, prefill_tok_s=n * length / prefill_s,
            decode_s=decode_s, decode_tok_s=n * 8 / decode_s,
            launches=counts, attn_kernel=attn_kernel)
        if n_ver:
            r.update(verify_s=verify_s, verify_tok_s=n * n_ver / verify_s)
        log(f"  {label} engine, {kv} KV, {n}x{length}: prefill "
            f"{r['prefill_tok_s']:.1f} tok/s ({prefill_s:.3f} s), step_n(., "
            f"8) {r['decode_tok_s']:.1f} tok/s ({decode_s:.3f} s)"
            + (f", verify_step of {n_ver} {r['verify_tok_s']:.1f} tok/s "
               f"({verify_s:.3f} s)" if n_ver else "")
            + f"; launches {counts}")
        missing = [k for k in path if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{label} {kv} engine: kernels never "
                                 f"launched on its path: {missing}")
        logits[kv] = (prefill, dec, first)
    ref_params = plain_reference_params(torch, packed)
    for kv, (prefill, dec, first) in logits.items():
        full = torch.cat([torch.tensor(reqs, device=device),
                          torch.tensor(first, device=device)[:, None]], dim=1)
        with torch.no_grad():
            ref = family.forward(ref_params, full, cfg)
        for what, got, i in (("prefill", prefill, length - 1),
                             ("decode", dec, length)):
            gap = res[f"serve_{kv}"][f"{what}_logits"] = logit_gap(
                got, ref[:, i])
            log(f"  {label} engine, {kv} KV, {what} logits: rms rel err "
                f"{gap['rms_rel']:.3g}, max rel err {gap['max_rel']:.3g} "
                f"(tol {E2E_TOL['rms']}, {E2E_TOL['max']}), argmax "
                f"agreement {gap['argmax_agree']:.3f}")
            if not gap_within(gap, E2E_TOL):
                failed.append(f"{kv} {what}")
        del ref
    del ref_params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{label} engines outside E2E_TOL: {failed}")


# ---------------------------------------------------------------------------
# opt27b phase: OPT-2.7B at its published widths and full depth (the
# config.json of facebook/opt-2.7b: vocab 50272, hidden 2560, ffn 10240, 32
# layers, 32 heads of 80, 2048 positions, pre-LN, word_embed_proj_dim 2560,
# so no project_in/out); random weights from a seeded generator, with
# opt_dense's biases, LayerNorms and outlier channels. Every linear has
# N % 128 == 0 (qkv 7680, out 2560, fc1 10240, fc2 2560) and reaches K1;
# K2 and K6 run at head_dim 80.
OPT_27B = dict(vocab_size=50272, hidden_size=2560, ffn_dim=10240,
               num_hidden_layers=32, num_attention_heads=32,
               max_position_embeddings=2048)
# verify_step of 4 tokens on every slot of the int8 engine (K1's prefill
# tile at m = 32, K5)
OPT27B_VERIFY = {"int8": 4}
# LWC W4A16 g128 at 2.7B widths, depth cut to OPT27B_CALIB_LAYERS, on
# calibrate_phase's windows (CALIB_PATHS: its pack served 16 x 128)
OPT27B_CALIB_LAYERS = 2
OPT27B_CALIB_RUNS = {
    "d_opt27b_w4a16g128_lwc": dict(wbits=4, abits=16, group_size=128,
                                   lwc=True, epochs=2, batch_size=1,
                                   lwc_lr=1e-2),
}


def opt27b_phase(torch, device, seed, out: dict) -> None:
    """OPT-2.7B at full width and depth: a W4 g128 (pairs) pack served by a
    bf16-KV and an int8-KV OPTEngine (serve_and_hold at OPT_SERVE_PATHS,
    8 x 512 prompts, the first decode, step_n(., 8), verify_step of 4
    tokens on the int8 engine), then ppl_check of the pack against its
    dequantized weights in f32 (9 windows of 2048 tokens; the forward's
    attention is dense, as the JAX package's), then LWC W4A16 g128 at
    OPT27B_CALIB_LAYERS layers with calibrate_run's five checks."""
    import dataclasses

    from omniquant_tpu_torch.models import OPT, opt
    from omniquant_tpu_torch.models.common import NO_ACT_QUANT
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model

    cfg = opt.OPTConfig(**OPT_27B)
    assert cfg.head_dim == 80 and cfg.word_embed_proj_dim is None
    res = out["opt27b"] = {}
    dense = opt_dense(torch, device, cfg, seed + 27)
    t = time.time()
    packed = pack_model(OPT, dense, QuantConfig(n_bits=4, group_size=128),
                        device=device)
    torch.cuda.synchronize()
    res["pack_s"] = time.time() - t
    res["packed_gib"] = sum(
        x.numel() * x.element_size() for b in packed["layers"]
        for pw in b.values() if hasattr(pw, "qweight")
        for x in (pw.qweight, pw.scales, pw.zeros)) / 2 ** 30
    log(f"  OPT-2.7B: {cfg.num_hidden_layers} layers packed W4 g128 in "
        f"{res['pack_s']:.1f} s, {res['packed_gib']:.3f} GiB of words, "
        "scales and zeros")
    serve_and_hold(torch, device, OPT, cfg, packed, OPT_SERVE_PATHS,
                   OPT_SERVE_BATCH, OPT_SERVE_LEN, seed, res, "OPT-2.7B",
                   verify=OPT27B_VERIFY)
    torch.cuda.empty_cache()
    res["ppl"] = ppl_check(torch, device, OPT, cfg,
                           plain_reference_params(torch, packed), packed,
                           NO_ACT_QUANT, "opt-2.7b W4 g128 (32 layers)", seed)
    del packed
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=OPT27B_CALIB_LAYERS)
    dense = dict(dense, layers=dense["layers"][:OPT27B_CALIB_LAYERS])
    torch.cuda.empty_cache()
    for name, kw in OPT27B_CALIB_RUNS.items():
        res[name] = calibrate_run(torch, device, OPT, cfg2, dense,
                                  *calib_windows(cfg2, seed), name, kw, seed)
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# falcon phase: the published widths of three Falcons (the config.json of
# the HF repos tiiuae/falcon-7b, tiiuae/falcon-40b and tiiuae/falcon-rw-1b;
# nothing is downloaded), depth cut, random weights from a seeded
# generator. Every Falcon has head_dim 64.
FALCON_MODELS = {
    # multi-query (71 query heads on 1 kv head), parallel attention, rotary
    "falcon-7b": dict(vocab_size=65024, hidden_size=4544,
                      num_hidden_layers=2, num_attention_heads=71,
                      multi_query=True, parallel_attn=True),
    # the new decoder architecture: 128 query heads on 8 kv heads, two
    # LayerNorms, rotary
    "falcon-40b": dict(vocab_size=65024, hidden_size=8192,
                       num_hidden_layers=1, num_attention_heads=128,
                       num_kv_heads=8, new_decoder_architecture=True,
                       parallel_attn=True),
    # ALiBi, 32 heads, no multi-query, post-attention LayerNorm, biases
    "falcon-rw-1b": dict(vocab_size=50304, hidden_size=2048,
                         num_hidden_layers=2, num_attention_heads=32,
                         multi_query=False, parallel_attn=False, alibi=True,
                         bias=True),
}
# (bits, group size) of each pack: W4A16 g64 for 7B (4544 = 71 x 64 rows:
# g128 does not divide them), g128 for the others
FALCON_PACKS = {"falcon-7b": (4, 64), "falcon-40b": (4, 128),
                "falcon-rw-1b": (4, 128)}
FALCON_SERVE_BATCH, FALCON_SERVE_LEN = 8, 512
# kernels each Falcon engine must launch (8 x 512 prompts, the first decode
# and step_n(., 8)). 7B: of its four linears only dense_h_to_4h (N 18176)
# has N % 128 == 0: qkv (N 4672), dense and dense_4h_to_h (N 4544) take the
# dense reference in both packages, and at the m = 4096 prefill
# dense_h_to_4h (column block 256) is dequantized once, so K1 runs only its
# planar decode tile, for dense_h_to_4h. 40B: every linear through K1 (the
# prefill tile at m = 4096, the decode tile); int8 K6 at 16 query heads a
# kv head. RW-1B: ALiBi through K2 at the prefill; an int8 engine keeps the
# fused decode attention off (the ALiBi bias lives in the additive mask),
# so K6 never runs and step_n takes single steps (K4, no K5).
FALCON_SERVE_PATHS = {
    "falcon-7b": {
        "native": ("quant_matmul", "quant_matmul_planar_decode",
                   "flash_attention", "kv_cache_prefill_write",
                   "kv_cache_write"),
        "int8": ("quant_matmul", "quant_matmul_planar_decode",
                 "flash_attention", "kv_cache_prefill_write",
                 "kv_cache_write", "kv_cache_write_span",
                 "decode_attention_int8")},
    "falcon-40b": {
        "native": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
                   "kv_cache_prefill_write", "kv_cache_write"),
        "int8": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
                 "kv_cache_prefill_write", "kv_cache_write",
                 "kv_cache_write_span", "decode_attention_int8")},
    "falcon-rw-1b": {
        "native": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
                   "kv_cache_prefill_write", "kv_cache_write"),
        "int8": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
                 "kv_cache_prefill_write", "kv_cache_write")},
}
# (linears a layer that launch K1, forward passes that do): of a run's 10
# passes (the prefill, the first decode, step_n(., 8)), 7B's one linear
# launches K1 in the 9 decode passes; every linear of the others in all 10
FALCON_K1 = {"falcon-7b": (1, 9), "falcon-40b": (4, 10),
             "falcon-rw-1b": (4, 10)}
# the LWC calibration at Falcon-7B widths (2 layers, calibrate_phase's
# windows); its pack (planar W4 g64) served 16 x 128: K1 on dense_h_to_4h
# (the planar prefill tile at m = 2048, the decode tile)
FALCON_CALIB_RUNS = {
    "f_falcon7b_w4a16g64_lwc": dict(wbits=4, abits=16, group_size=64,
                                    lwc=True, epochs=2),
}


def falcon_dense(torch, device, cfg, seed):
    """A random Falcon (falcon.init_params) whose LayerNorms are moved off
    their init (weights 1 + N(0, 0.1), biases N(0, 0.02)) and whose
    linear biases, where the model has them, are N(0, 0.02)."""
    from omniquant_tpu_torch.models import falcon

    gen = torch.Generator(device=device).manual_seed(seed)
    dense = falcon.init_params(gen, cfg, dtype=torch.float32, device=device)
    for sub in [dense["ln_f"]] + [v for b in dense["layers"]
                                  for v in b.values()]:
        if sub.get("bias") is not None:
            sub["bias"].normal_(0.0, 0.02, generator=gen)
        if sub["weight"].dim() == 1:
            sub["weight"].normal_(1.0, 0.1, generator=gen)
    return dense


def falcon_phase(torch, device, seed, out: dict) -> None:
    """Each of FALCON_MODELS packed (FALCON_PACKS) and served by a bf16-KV
    and an int8-KV FalconEngine (serve_and_hold, FALCON_SERVE_PATHS), the
    K1 launches counted per linear and K6's head groups checked; then the
    LWC calibration at Falcon-7B widths with calibrate_run's five checks
    and ppl_check."""
    from omniquant_tpu_torch.kernels.decode_attention import head_groups
    from omniquant_tpu_torch.models import FALCON, falcon
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model

    res = out["falcon"] = {}
    n, length = FALCON_SERVE_BATCH, FALCON_SERVE_LEN
    for name, kw in FALCON_MODELS.items():
        t0 = time.time()
        cfg = falcon.FalconConfig(**kw)
        dense = falcon_dense(torch, device, cfg, seed + 17)
        bits, group = FALCON_PACKS[name]
        packed = pack_model(FALCON, dense,
                            QuantConfig(n_bits=bits, group_size=group),
                            device=device)
        del dense
        layouts = {k: packed["layers"][0][k].layout
                   for k in falcon.LINEAR_NAMES}
        r = res[name] = dict(config=kw, pack=f"W{bits}A16 g{group}",
                             layouts=layouts)
        n_rep = cfg.num_attention_heads // cfg.effective_kv_heads
        linears, passes = FALCON_K1[name]
        k1_want = linears * passes * cfg.num_hidden_layers

        def counts_check(kv, eng, counts, _want=k1_want, _name=name,
                         _alibi=cfg.alibi):
            if counts["quant_matmul"] != _want:
                raise AssertionError(
                    f"{_name} {kv}: {counts['quant_matmul']} K1 launches, "
                    f"not {_want}")
            if _alibi and (eng.attn_kernel
                           or counts["decode_attention_int8"]):
                raise AssertionError(f"{_name} {kv}: an ALiBi engine ran "
                                     "the fused int8 decode attention")

        log(f"  {name}: {cfg.num_hidden_layers} layer(s), hidden "
            f"{cfg.hidden_size}, {cfg.num_attention_heads} query heads on "
            f"{cfg.effective_kv_heads} kv heads (n_rep {n_rep}: "
            f"{head_groups(n_rep)[0]} K6 head groups), W{bits}A16 g{group} "
            f"({layouts}); K1 on {linears} linear(s) a layer in {passes} "
            f"forward passes" + (": qkv (N 4672), dense and dense_4h_to_h (N 4544) "
                        "take the dense reference, as in the JAX package "
                        "(N % 128 != 0)" if name == "falcon-7b" else ""))
        serve_and_hold(torch, device, FALCON, cfg, packed,
                       FALCON_SERVE_PATHS[name], n, length, seed, r, name,
                       counts_check)
        del packed
        torch.cuda.empty_cache()
        r["phase_s"] = time.time() - t0
    cfg = falcon.FalconConfig(**FALCON_MODELS["falcon-7b"])
    dense = falcon_dense(torch, device, cfg, seed + 18)
    for name, kw in FALCON_CALIB_RUNS.items():
        res[name] = calibrate_run(torch, device, FALCON, cfg, dense,
                                  *calib_windows(cfg, seed), name, kw, seed)
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# cli phase: ``python -m omniquant_tpu_torch`` (the CLI's default platform,
# the card) as a user runs it, once per synthetic net. At these widths the
# projections with N % 128 != 0 take the dense reference instead of K1, as
# the JAX package routes them: CLI_DENSE names them.
CLI_NETS = ("tiny-opt", "tiny-llama", "tiny-falcon")
CLI_ARGS = ("--synthetic", "--wbits", "4", "--abits", "16", "--group_size",
            "64", "--lwc", "--epochs", "2", "--nsamples", "8", "--seqlen",
            "256", "--eval_ppl", "--real_quant", "--max_new_tokens", "16")
CLI_PROMPT = "The quick brown fox jumps over the lazy dog"
CLI_PATHS = ("quant_matmul", "kv_cache_prefill_write", "kv_cache_write")
CLI_DENSE = {"tiny-opt": "qkv (N 192), out_proj and fc2 (N 64)",
             "tiny-llama": "o_proj and down_proj (N 64)",
             "tiny-falcon": "query_key_value (N 96), dense and dense_4h_to_h "
                            "(N 64)"}


def cli_phase(out: dict) -> None:
    """The CLI_NETS runs as subprocesses started together, each in a fresh
    directory under the git-ignored build/ with its output in files there:
    each must exit 0, end with a results JSON holding a finite synthetic
    perplexity and a generation, and log the launch of every kernel of
    CLI_PATHS. A run still going after 600 s is killed and fails."""
    import re
    import shutil

    res = out["cli"] = {}
    env = dict(os.environ, PYTHONPATH=HERE)
    runs = {}
    try:
        for net in CLI_NETS:
            d = os.path.join(HERE, "build", "cli_smoke", net)
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            cmd = [sys.executable, "-m", "omniquant_tpu_torch", "--net", net,
                   *CLI_ARGS, "--serve_prompt", CLI_PROMPT,
                   "--save_dir", os.path.join(d, "save"),
                   "--output_dir", os.path.join(d, "out"),
                   "--cache_dir", os.path.join(d, "cache")]
            logs = [open(os.path.join(d, f), "w+")
                    for f in ("stdout.log", "stderr.log")]
            runs[net] = dict(logs=logs, t=time.time(), wall=None,
                             p=subprocess.Popen(cmd, cwd=HERE, env=env,
                                                stdout=logs[0],
                                                stderr=logs[1]))
        deadline = time.time() + 600
        while any(r["wall"] is None for r in runs.values()):
            if time.time() > deadline:
                raise AssertionError("cli: a run took more than 600 s")
            time.sleep(0.2)
            for r in runs.values():
                if r["wall"] is None and r["p"].poll() is not None:
                    r["wall"] = time.time() - r["t"]
    finally:
        for r in runs.values():
            if r["p"].poll() is None:
                r["p"].kill()
                r["p"].wait()
    for net, r in runs.items():
        for f in r["logs"]:
            f.seek(0)
        stdout, stderr = (f.read() for f in r["logs"])
        for f in r["logs"]:
            f.close()
        wall = r["wall"]
        if r["p"].returncode != 0:
            log(stdout[-4000:])
            log(stderr[-4000:])
            raise AssertionError(f"cli {net}: exit code {r['p'].returncode}")
        last = json.loads(stdout.strip().splitlines()[-1])
        counts = json.loads(re.search(r"kernel launches: (\{.*\})",
                                      stdout).group(1))
        res[net] = dict(results=last, launches=counts, wall_s=wall)
        log(f"  cli {net}: exit 0 in {wall:.1f} s (the {len(runs)} runs "
            f"together); synthetic ppl {last.get('synthetic')}, generation "
            f"{last.get('generation')!r}; launches {counts}; at these widths "
            f"{CLI_DENSE[net]} take the dense reference, as in the JAX "
            "package (N % 128 != 0)")
        if not (math.isfinite(last.get("synthetic", math.nan))
                and len(last.get("generation", "")) == 16):
            raise AssertionError(f"cli {net}: results {last}")
        missing = [k for k in CLI_PATHS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"cli {net}: kernels never launched: "
                                 f"{missing}")


# ---------------------------------------------------------------------------
# spec phase: speculative decoding (serving/spec_decode.py) and the growing
# KV cache (auto_grow), after the JAX package's bench.py stage 4 and
# scripts/bench_spec_w2draft.py. A: a layer-skip self-draft of a LLaMA-7B
# (full width and depth, W4 g128); B: a W2 g128 pack of the same weights
# drafting for it; C: a W6A6 target at 2 layers; D: engines that grow from
# 256 to 1024 rows while they decode; between A and B, one sampling round
# and one greedy dispatch with a full-depth self-draft.
SPEC_MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=32)
SPEC_BATCH, SPEC_PROMPT_LEN, SPEC_GAMMA, SPEC_ROUNDS = 8, 128, 4, 4
SPEC_DRAFT_LAYERS = 4
SPEC_DISPATCHES = 3     # timed spec_steps dispatches a run
SPEC_GEN_TOKENS = 64    # SpecDecoder.generate against target.generate (A;
#                         half as many in B and C)
SPEC_INT_PROMPT_LEN = 512            # C: 8 x 512 prompts (K8 + K9, K2)
SPEC_GROW = (256, 1024, 600)         # D: max_len, grown max_len, tokens
SPEC_TEMPERATURE = 0.8
# the near-tie rule (stream_gaps, near_tie): every token of a card's greedy
# stream lies at most SPEC_TIE x the engine's largest-error bound (E2E_TOL's
# "max", or E2E_INT_TOL[6]'s for W6A6) x its row's largest |logit| below
# that row's argmax in the plain f32 forward over the stream's own
# context. Logits within that error bound of the f32 row move each of the
# two tokens by at most the bound, so an engine that meets it never emits a
# token further down. A rule in units of the row's rms (4 x 5e-2) failed a
# correct int8 stream over 64 tokens at 0.236 rms on an H100 at 32 layers:
# the int8 cache's rounding, which the f32 forward does not model, is
# within E2E_TOL and not within that. A planted fault, the
# draft's own greedy stream, must fail the rule (A_native).
SPEC_TIE = 2
# kernels each run must launch. A, B, D: the batched prefill on K1's
# prefill tile and K3; the draft's decode steps on K1's decode tile (m = 8)
# and K4 (with K6 on an int8 cache); the verify pass on K1's prefill tile
# at m = 40 and K5. C (W6A6): the 8 x 512 prefill through K8 + K9 and K2,
# the draft's steps (m = 8) and the verify (m = 40) through K7. D's ALiBi
# Falcon keeps K6 off on its int8 cache.
_SPEC_A16 = ("quant_matmul", "quant_matmul_prefill", "kv_cache_prefill_write",
             "kv_cache_write", "kv_cache_write_span")
SPEC_PATHS = {
    "A_native": _SPEC_A16,
    "A_int8": _SPEC_A16 + ("decode_attention_int8",),
    "A_full": _SPEC_A16,
    "B": _SPEC_A16,
    "C": ("_unpack_to_int8", "_quant_matmul_int_dense", "quant_matmul_int",
          "flash_attention", "kv_cache_prefill_write", "kv_cache_write",
          "kv_cache_write_span"),
    "D_llama_native": _SPEC_A16,
    "D_llama_int8": _SPEC_A16 + ("decode_attention_int8",),
    "D_falcon_native": _SPEC_A16,
    "D_falcon_int8": _SPEC_A16,
}


def plain_logits(torch, family, cfg, packed, tokens, spec, n):
    """The plain f32 forward's logits at the last ``n`` positions of
    ``tokens`` (B, S), (B, n, V): the packed model dequantized as
    plain_reference_params does, one layer at a time (a 32-layer 7B model
    never sits in memory in f32)."""
    top = plain_reference_params(
        torch, {k: v for k, v in packed.items() if k != "layers"})
    with torch.no_grad():
        x = family.embed(top, tokens, cfg)
        for layer in packed["layers"]:
            x = _chain(torch, family, cfg,
                       [plain_reference_params(torch, layer)], x, spec)
        return family.head(top, x[:, -n:], cfg).float()


def stream_gaps(torch, family, cfg, packed, prompts, streams, spec) -> list:
    """Each token of each greedy stream (prompts of one length) against one
    causal pass of the plain f32 forward of the packed model over its
    prompt and the stream before it: the gap between the row's f32 argmax
    logit and the token's, over the row's largest |logit|. The rows are
    padded on the right, which no earlier position sees. Returns a list of
    gaps a stream."""
    from omniquant_tpu_torch.models.common import embedding_device

    n = max(len(s) for s in streams)
    device = embedding_device(packed)
    ctx = torch.tensor([list(p) + list(s[:-1]) + [0] * (n - len(s))
                        for p, s in zip(prompts, streams)], device=device)
    got = torch.tensor([list(s) + [0] * (n - len(s)) for s in streams],
                       device=device)
    logits = plain_logits(torch, family, cfg, packed, ctx, spec, n)
    gap = ((logits.max(-1).values - logits.gather(-1, got[..., None])[..., 0])
           / logits.abs().amax(-1)).tolist()
    return [g[:len(s)] for g, s in zip(gap, streams)]


def near_tie(gaps: list, bound: float) -> dict:
    """The near-tie rule over streams' gaps (stream_gaps): every token at
    most ``bound`` x its row's largest |logit| below the row's f32
    argmax."""
    flat = sorted(x for g in gaps for x in g)
    return dict(tokens=len(flat), at_argmax=sum(x == 0 for x in flat),
                over=sum(x > bound for x in flat), worst=flat[-1],
                median=flat[len(flat) // 2], limit=bound,
                ok=flat[-1] <= bound)


def _log_tie(t: dict) -> str:
    return (f"{t['tokens']} tokens, {t['at_argmax']} at the f32 argmax, "
            f"{t['over']} beyond the near-tie limit; gap to the argmax "
            f"median {t['median']:.4f}, worst {t['worst']:.4f} of the row's "
            f"largest |logit| (limit {t['limit']:.4f})")


def _no_sync_rounds(torch, sd) -> None:
    """sd's fused rounds (everything spec_steps runs between building its
    inputs and copying its results to the host) under
    set_sync_debug_mode("error"): a host synchronisation there raises. The
    wrapper holds sd weakly, so a deleted decoder is freed at once."""
    ref, inner = weakref.ref(sd), type(sd)._rounds

    def rounds(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(ref(), *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    sd._rounds = rounds


def _cache_bytes(eng) -> int:
    return sum(t.numel() * t.element_size()
               for bufs in (eng.cache.k, eng.cache.v, eng.cache.k_scale,
                            eng.cache.v_scale) if bufs for t in bufs)


def _own_head_bytes(sd) -> int:
    """The bytes of a draft head that is not the target's (a packed one)."""
    head = sd.draft.params.get("lm_head")
    if head is None or head is sd.target.params.get("lm_head"):
        return 0
    return sum(t.numel() * t.element_size() for t in (
        head.qweight, head.scales, head.zeros))


def spec_decoder(torch, target, res: dict, **kw):
    """A SpecDecoder over ``target``; with the default layer-skip draft,
    the memory it adds must be its KV cache (and packed head) within 1 %."""
    from omniquant_tpu_torch.serving import SpecDecoder

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sd = SpecDecoder(target, gamma=SPEC_GAMMA, **kw)
    torch.cuda.synchronize()
    if kw.get("draft") is None:
        extra = torch.cuda.memory_allocated() - before
        cache, head = _cache_bytes(sd.draft), _own_head_bytes(sd)
        want = cache + head
        res.update(draft_extra_gib=extra / 2**30,
                   draft_cache_gib=cache / 2**30,
                   draft_head_gib=head / 2**30)
        log(f"    layer-skip draft of {len(sd.draft.params['layers'])} "
            f"layers: {extra / 2**30:.4f} GiB more allocated, its KV cache "
            f"{cache / 2**30:.4f} GiB"
            + (f" and packed head {head / 2**30:.4f} GiB" if head else ""))
        if abs(extra - want) > 0.01 * want:
            raise AssertionError("the layer-skip draft holds more than its "
                                 "KV cache: it copied the target's weights")
    _no_sync_rounds(torch, sd)
    return sd


def _warm(torch, sd, vocab, seed) -> None:
    """Two short requests through both engines, one fused round and one
    step_n of the target (allocator, library handles, workspaces)."""
    t, d = sd.target, sd.draft
    reqs = prompts(torch, 2, 16, vocab, seed)
    slots = t.add_requests(reqs)
    d.add_requests(reqs)
    last = {s: t._pending_next[s] for s in slots}
    last = {s: v[-1] for s, v in sd.spec_steps(last, rounds=1).items()}
    t.step_n(last, 2)
    for s in slots:
        sd.release(s)
    torch.cuda.synchronize()


def spec_run(torch, name, sd, reqs, vocab, res: dict, total: dict,
             dispatches=SPEC_DISPATCHES, tokens=0, tag="") -> dict:
    """The main path of one spec run, its launch counts set to 0 before and
    read after: both engines prefilled with ``reqs`` (add_requests), then
    ``dispatches`` fused spec_steps(., SPEC_ROUNDS) dispatches (or, with
    ``tokens``, as many as every slot needs for that many tokens), then,
    without ``tokens``, two step_n(., 8) of the target alone. Every kernel
    of SPEC_PATHS[name] must launch. Returns the slots' streams."""
    from omniquant_tpu_torch import kernels

    t, d = sd.target, sd.draft
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    slots = t.add_requests(reqs)
    if d.add_requests(reqs) != slots:
        raise AssertionError(f"spec {name}: target and draft slots differ")
    torch.cuda.synchronize()
    res["prefill_s"] = time.time() - t0
    last = {s: t._pending_next[s] for s in slots}
    streams = {s: [v] for s, v in last.items()}
    p0, a0 = sd.proposed, sd.accepted
    times, slot_rounds = [], 0
    while len(times) < dispatches or tokens:
        # with ``tokens``, a slot that has them leaves the requests (its
        # rows still take the bystander writes, past its length)
        live = {s: v for s, v in last.items()
                if not tokens or len(streams[s]) < tokens}
        if not live:
            break
        torch.cuda.synchronize()
        t0 = time.time()
        got = sd.spec_steps(live, rounds=SPEC_ROUNDS)  # ends on the host
        times.append(time.time() - t0)
        slot_rounds += len(live) * SPEC_ROUNDS
        for s, v in got.items():
            streams[s] += v
            last[s] = v[-1]
    spec_s = sum(times)
    emitted = sum(len(v) - 1 for v in streams.values())
    res.update(dispatches=len(times), spec_s=spec_s,
               round_ms=spec_s / (len(times) * SPEC_ROUNDS) * 1e3,
               spec_tok_s=emitted / spec_s,
               tokens_per_round=emitted / slot_rounds,
               acceptance=(sd.accepted - a0) / (sd.proposed - p0))
    line = (f"  spec {name}{tag}: {len(slots)} x {len(reqs[0])}, gamma "
            f"{sd.gamma}, {len(times)} dispatches of {SPEC_ROUNDS} rounds: "
            f"a round {res['round_ms']:.2f} ms, "
            f"{res['tokens_per_round']:.3f} tokens a slot a round, "
            f"acceptance {res['acceptance']:.4f}, spec {res['spec_tok_s']:.1f}"
            " tok/s")
    if not tokens:
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(2):
            last = {s: v[-1] for s, v in t.step_n(last, 8).items()}
        torch.cuda.synchronize()
        step_s = (time.time() - t0) / 16
        res.update(step_n_tok_s=len(slots) / step_s, step_ms=step_s * 1e3,
                   round_in_steps=res["round_ms"] / (step_s * 1e3))
        line += (f"; step_n(., 8) {res['step_n_tok_s']:.1f} tok/s, a round "
                 f"costs {res['round_in_steps']:.2f} sequential steps")
    counts = kernels.launch_counts()
    for s in slots:
        sd.release(s)
    res["launches"] = counts
    log(line + f"; launches {counts}")
    if any(not all(0 <= x < vocab for x in v) for v in streams.values()):
        raise AssertionError(f"spec {name}: malformed token streams")
    missing = [k for k in SPEC_PATHS[name] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"spec {name}: kernels never launched on its "
                             f"path: {missing}")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return streams


def spec_generate(torch, name, family, cfg, packed, sd, prompt, n, spec,
                  bound, res: dict, want=None, fault=False) -> list:
    """SpecDecoder.generate for ``n`` tokens, every token held to the
    near-tie rule; the tokens equal to target.generate (``want``, when
    given) before the first divergence are reported. With ``fault``, a
    planted fault goes through the same rule and must fail it: the draft's
    own greedy stream, which a decoder that accepted every proposal
    unchecked would emit."""
    if want is None:
        want = sd.target.generate(prompt, max_new_tokens=n)
    got = sd.generate(prompt, max_new_tokens=n)
    streams = [got] + ([sd.draft.generate(prompt, max_new_tokens=n)]
                       if fault else [])
    gaps = stream_gaps(torch, family, cfg, packed, [prompt] * len(streams),
                       streams, spec)
    agreed = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                  min(len(got), len(want)))
    tie = res["generate"] = dict(near_tie(gaps[:1], bound), agreed=agreed)
    log(f"  spec {name} generate: {agreed} of {n} tokens equal to "
        f"target.generate before the first divergence; near-tie rule over "
        f"the whole stream: {_log_tie(tie)}")
    if fault:
        f = res["planted_fault"] = near_tie(gaps[1:], bound)
        log(f"  spec {name} planted fault (the draft's own greedy stream): "
            f"{_log_tie(f)}")
        if f["ok"]:
            raise AssertionError(f"spec {name}: the near-tie rule passes a "
                                 "planted fault")
    if not tie["ok"] or len(got) != n:
        raise AssertionError(f"spec {name}: generate emits a token at no "
                             "near tie with the f32 argmax")
    return want


def spec_phase(torch, device, seed, out: dict) -> dict:
    """A-D, the sampling round and A_full (see the module docstring);
    returns the launch counts summed over their main-path runs."""
    import dataclasses

    from omniquant_tpu_torch.models import FALCON, LLAMA, falcon, llama
    from omniquant_tpu_torch.models.common import NO_ACT_QUANT, ActQuantSpec
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import (
        FalconEngine, LlamaEngine, pack_model)

    res = out["spec"] = {}
    total = {}
    cfg = llama.LlamaConfig(**SPEC_MODEL)
    V = cfg.vocab_size
    reqs = prompts(torch, SPEC_BATCH, SPEC_PROMPT_LEN, V, seed + 19)
    w4 = make_packed(torch, cfg, device, seed + 19, 4, 128)
    bound = SPEC_TIE * E2E_TOL["max"]
    want = {}
    for kv in ("native", "int8"):
        name = f"A_{kv}"
        r = res[name] = {}
        eng = LlamaEngine(w4, cfg, max_batch=SPEC_BATCH, max_len=1024,
                          dtype=torch.bfloat16, kv_dtype=kv, seed=seed,
                          device=device)
        # the int8 run's draft packs its head at 4 bits (K1 at N = 32000)
        sd = spec_decoder(torch, eng, r, draft_layers=SPEC_DRAFT_LAYERS,
                          draft_head_bits=4 if kv == "int8" else None)
        _warm(torch, sd, V, seed)
        spec_run(torch, name, sd, reqs, V, r, total)
        want[kv] = spec_generate(torch, name, LLAMA, cfg, w4, sd, reqs[0],
                                 SPEC_GEN_TOKENS, NO_ACT_QUANT, bound, r,
                                 fault=kv == "native")
        del sd, eng
        torch.cuda.empty_cache()

    # the full-depth self-draft (q == p): one sampling round on every slot,
    # then greedy rounds, where nearly every proposal is accepted
    r = res["sampling"] = {}
    eng = LlamaEngine(w4, cfg, max_batch=SPEC_BATCH, max_len=1024,
                      dtype=torch.bfloat16, seed=seed, device=device)
    sd = spec_decoder(torch, eng, r, draft_layers=cfg.num_hidden_layers)
    slots = eng.add_requests(reqs, temperature=SPEC_TEMPERATURE)
    sd.draft.add_requests(reqs, temperature=SPEC_TEMPERATURE)
    torch.cuda.synchronize()
    t0 = time.time()
    got = sd.sample_spec_step({s: eng._pending_next[s] for s in slots})
    r.update(round_s=time.time() - t0, acceptance=sd.acceptance_rate,
             emitted=sum(len(v) for v in got.values()))
    log(f"  spec sampling (temperature {SPEC_TEMPERATURE}, full-depth "
        f"self-draft, {len(slots)} slots): one sample_spec_step round "
        f"{r['round_s'] * 1e3:.1f} ms, acceptance {r['acceptance']:.4f}, "
        f"{r['emitted']} tokens")
    if r["acceptance"] < 0.9 or not all(
            0 <= x < V for v in got.values() for x in v):
        raise AssertionError("spec sampling: a full-depth self-draft must "
                             "accept nearly every proposal")
    for s in slots:
        sd.release(s)
    r = res["A_full"] = {}
    _warm(torch, sd, V, seed)
    streams = list(spec_run(torch, "A_full", sd, reqs, V, r, total,
                            dispatches=1).values())
    tie = r["held"] = near_tie(stream_gaps(torch, LLAMA, cfg, w4, reqs,
                                           streams, NO_ACT_QUANT), bound)
    r["most_in_dispatch"] = max(len(v) - 1 for v in streams)
    log(f"  spec A_full: at most {r['most_in_dispatch']} tokens from "
        f"{SPEC_ROUNDS} rounds; near-tie rule over the {len(streams)} "
        f"streams: {_log_tie(tie)}")
    if r["most_in_dispatch"] <= SPEC_ROUNDS or not tie["ok"]:
        raise AssertionError("spec A_full: no round accepted a proposal, or "
                             "a token at no near tie with the f32 argmax")
    del sd, eng
    torch.cuda.empty_cache()

    # B: a W2 g128 pack of the same weights drafts for the W4 g128 target
    w2 = make_packed(torch, cfg, device, seed + 19, 2, 128)
    r = res["B"] = {}
    target = LlamaEngine(w4, cfg, max_batch=SPEC_BATCH, max_len=512,
                         dtype=torch.bfloat16, seed=seed, device=device)
    draft = LlamaEngine(w2, cfg, max_batch=SPEC_BATCH, max_len=512,
                        dtype=torch.bfloat16, seed=seed, device=device)
    sd = spec_decoder(torch, target, r, draft=draft)
    _warm(torch, sd, V, seed)
    spec_run(torch, "B", sd, reqs, V, r, total, dispatches=2)
    n_gen = SPEC_GEN_TOKENS // 2
    spec_generate(torch, "B", LLAMA, cfg, w4, sd, reqs[0], n_gen,
                  NO_ACT_QUANT, bound, r, want=want["native"][:n_gen])
    del sd, target, draft, w2, w4
    torch.cuda.empty_cache()

    # C: W6A6 at 2 layers, a one-layer self-draft
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    w6 = make_packed(torch, cfg2, device, seed + 20, 6, 128)
    spec6 = ActQuantSpec.from_bits(6)
    r = res["C"] = {}
    eng = LlamaEngine(w6, cfg2, max_batch=SPEC_BATCH, max_len=1024,
                      dtype=torch.bfloat16, spec=spec6, seed=seed,
                      device=device)
    sd = spec_decoder(torch, eng, r, draft_layers=1)
    _warm(torch, sd, V, seed)
    reqs_c = prompts(torch, SPEC_BATCH, SPEC_INT_PROMPT_LEN, V, seed + 20)
    spec_run(torch, "C", sd, reqs_c, V, r, total, dispatches=2)
    spec_generate(torch, "C", LLAMA, cfg2, w6, sd, reqs_c[0], n_gen, spec6,
                  SPEC_TIE * E2E_INT_TOL[6]["max"], r)
    del sd, eng, w6
    torch.cuda.empty_cache()

    # D: auto_grow, LLaMA-7B widths and Falcon-RW-1B's (ALiBi) at 2 layers
    w4_2 = make_packed(torch, cfg2, device, seed + 21, 4, 128)
    fcfg = falcon.FalconConfig(**dict(FALCON_MODELS["falcon-rw-1b"],
                                      num_hidden_layers=2))
    fdense = falcon_dense(torch, device, fcfg, seed + 21)
    fw4 = pack_model(FALCON, fdense, QuantConfig(n_bits=4, group_size=128),
                     device=device)
    del fdense
    for fam, engine, mcfg, packed in (("llama", LlamaEngine, cfg2, w4_2),
                                      ("falcon", FalconEngine, fcfg, fw4)):
        family = LLAMA if fam == "llama" else FALCON
        d_reqs = prompts(torch, SPEC_BATCH, SPEC_PROMPT_LEN,
                         mcfg.vocab_size, seed + 22)
        for kv in ("native", "int8"):
            name = f"D_{fam}_{kv}"
            r = res[name] = {}
            streams = {}
            for grow in (True, False):
                eng = engine(packed, mcfg, max_batch=SPEC_BATCH,
                             max_len=SPEC_GROW[0 if grow else 1],
                             dtype=torch.bfloat16, kv_dtype=kv, seed=seed,
                             device=device, auto_grow=grow)
                # a full-depth self-draft: rounds emit several tokens, so
                # the growths meet multi-row writes, in fewer rounds
                sd = spec_decoder(torch, eng, {},
                                  draft_layers=mcfg.num_hidden_layers)
                _warm(torch, sd, mcfg.vocab_size, seed)
                growths = r.setdefault("growths", [])
                if grow:
                    for e in (sd.target, sd.draft):
                        _time_growth(torch, e, growths)
                got = spec_run(
                    torch, name, sd, d_reqs, mcfg.vocab_size,
                    r if grow else {}, total if grow else {},
                    tokens=SPEC_GROW[2],
                    tag="" if grow else f" (built at {SPEC_GROW[1]})")
                streams[grow] = [v[:SPEC_GROW[2]] for v in got.values()]
                if grow and sd.target.max_len != SPEC_GROW[1]:
                    raise AssertionError(f"spec {name}: grew to "
                                         f"{sd.target.max_len}, not "
                                         f"{SPEC_GROW[1]}")
                del sd, eng
                torch.cuda.empty_cache()
            tie = r["held"] = near_tie(stream_gaps(
                torch, family, mcfg, packed, d_reqs * 2,
                streams[True] + streams[False], NO_ACT_QUANT), bound)
            r["equal"] = sum(a == b for a, b in zip(streams[True],
                                                    streams[False]))
            log(f"  spec {name}: max_len {SPEC_GROW[0]} grew to "
                f"{SPEC_GROW[1]} ({len(r['growths'])} growths of target and "
                "draft: copy ms / peak GiB " + ", ".join(
                    f"{g['ms']:.2f} / {g['peak_gib']:.3f}"
                    for g in r["growths"])
                + f"); {r['equal']} of {SPEC_BATCH} streams equal to the "
                f"engine built at {SPEC_GROW[1]} over {SPEC_GROW[2]} "
                f"tokens; near-tie rule over both engines' streams: "
                + _log_tie(tie))
            if not tie["ok"]:
                raise AssertionError(f"spec {name}: a token at no near tie "
                                     "with the f32 argmax")
    del w4_2, fw4
    torch.cuda.empty_cache()
    out["spec_launches"] = total
    return total


def _time_growth(torch, eng, growths: list) -> None:
    """Times each _grow of ``eng`` (host clock behind synchronisations) and
    records the peak memory while its old and new caches are both held.
    The wrapper holds ``eng`` weakly."""
    ref, inner = weakref.ref(eng), type(eng)._grow

    def grow(need):
        e = ref()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        old = e.max_len
        t0 = time.time()
        inner(e, need)
        torch.cuda.synchronize()
        growths.append(dict(rows=(old, e.max_len),
                            ms=(time.time() - t0) * 1e3,
                            peak_gib=torch.cuda.max_memory_allocated()
                            / 2**30))

    eng._grow = grow


# ---------------------------------------------------------------------------
def profile_decode(torch, device, cfg, dims, seed, out: dict) -> None:
    """Engines A and E of serve_plans, rebuilt on a fresh W4 model and
    prefilled as serve prefills them: after one step_n to warm up, two
    step_n(., 8) on the host clock give the step time, then one more runs
    under torch.profiler (profile_step). This phase runs last, so that no
    timed run follows a profiler session."""
    from omniquant_tpu_torch.serving import LlamaEngine

    packed = make_packed(torch, cfg, device, seed, 4)
    plans = serve_plans(dims)
    for name in ("A", "E"):
        eng_kw, run_kw = plans[name]
        n, length, step_n = run_kw["n"], run_kw["length"], run_kw["step_n"]
        eng = LlamaEngine(packed, cfg, dtype=torch.bfloat16, seed=seed,
                          device=device, **eng_kw)
        slots = eng.add_requests(prompts(torch, n, length, cfg.vocab_size,
                                         seed + length))
        last = {s: eng._pending_next[s] for s in slots}
        reps, t = 2, 0.0
        for i in range(1 + reps):
            if i == 1:
                torch.cuda.synchronize()
                t = time.time()
            last = {s: r[-1] for s, r in eng.step_n(last, step_n).items()}
        torch.cuda.synchronize()
        step_s = (time.time() - t) / (reps * step_n)
        p = out[f"profile_{name}"] = profile_step(torch, eng, last, step_n,
                                                  step_s)
        busy = p["busy_share"]
        log(f"  engine {name} profiled step_n({step_n}): device "
            f"{p['device_ms_per_step']:.2f} ms of a {p['step_ms']:.2f} ms "
            f"step ({busy if isinstance(busy, str) else f'{busy:.1%}'} "
            f"busy), {p['launches_per_step']:.0f} launches per step; "
            "most device time: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in p["top_kernels"]))
        del eng
        torch.cuda.empty_cache()


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
                prefill_m=32 * 128, flash_m=8 * 1024, ring=8, verify_m=128)

    log("kernels: each against its plain version at the 7B serving shapes")
    timer = Timer(torch, device)
    results = {"quant_matmul": check_quant_matmul(torch, device, timer, dims,
                                                  out),
               "quant_matmul_planar": check_quant_matmul_planar(
                   torch, device, timer, dims, out),
               "flash_attention": check_flash(torch, device, timer, dims)}
    (results["kv_cache_prefill_write"], results["kv_cache_write"],
     results["kv_cache_write_span"]) = check_kv(torch, device, timer, dims,
                                                 out)
    results["decode_attention_int8"] = check_decode_attention(
        torch, device, timer, dims, out)
    results["quant_matmul_int"] = check_quant_matmul_int(torch, device, timer,
                                                         dims, out)
    results["_unpack_to_int8"] = check_unpack_int8(torch, device, timer, dims,
                                                   out)
    results["_quant_matmul_int_dense"] = check_int_dense(torch, device, timer,
                                                         dims, out)
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

    log("calibrate: LLaMA-7B widths at 2 layers, 16 x 2048 windows, W4A16 "
        "g128 LWC then W4A4 LWC + LET; calibrate -> pack -> serve -> "
        "perplexity")
    t_cal = time.time()
    calibrate_phase(torch, device, llama.LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=32),
        args.seed, out)
    out["calibrate_phase_s"] = time.time() - t_cal
    log(f"  calibrate phase {out['calibrate_phase_s']:.1f} s")

    log("opt: OPT-6.7B widths at 2 layers: W4 g128 bf16- and int8-KV "
        "OPTEngines, then W6A6 LWC + LET calibration -> pack -> serve -> "
        "perplexity")
    t_opt = time.time()
    opt_phase(torch, device, args.seed, out)
    out["opt_phase_s"] = time.time() - t_opt
    log(f"  opt phase {out['opt_phase_s']:.1f} s")

    log("opt27b: OPT-2.7B widths at full depth (heads of 80): W4 g128 "
        "bf16- and int8-KV OPTEngines, perplexity of the pack, then LWC "
        "W4A16 g128 at 2 layers -> pack -> serve -> perplexity")
    t_opt27 = time.time()
    opt27b_phase(torch, device, args.seed, out)
    out["opt27b_phase_s"] = time.time() - t_opt27
    log(f"  opt27b phase {out['opt27b_phase_s']:.1f} s")

    log("falcon: Falcon-7B (2 layers, W4A16 g64), 40B (1 layer, W4A16 g128) "
        "and RW-1B (2 layers, W4A16 g128) widths: bf16- and int8-KV "
        "FalconEngines, then LWC calibration at 7B widths -> pack -> serve "
        "-> perplexity")
    t_falcon = time.time()
    falcon_phase(torch, device, args.seed, out)
    out["falcon_phase_s"] = time.time() - t_falcon
    log(f"  falcon phase {out['falcon_phase_s']:.1f} s")

    log("cli: python -m omniquant_tpu_torch on tiny-opt, tiny-llama and "
        "tiny-falcon")
    t_cli = time.time()
    cli_phase(out)
    out["cli_phase_s"] = time.time() - t_cli
    log(f"  cli phase {out['cli_phase_s']:.1f} s")

    log("spec: speculative decoding at LLaMA-7B widths (A: layer-skip "
        "self-draft, 32 layers, bf16 and int8 KV; B: W2 g128 draft for W4 "
        "g128; C: W6A6 at 2 layers; a full-depth self-draft sampling and "
        "greedy) and auto_grow (D: 256 -> 1024 rows, LLaMA-7B and "
        "Falcon-RW-1B widths at 2 layers)")
    t_spec = time.time()
    spec_counts = spec_phase(torch, device, args.seed, out)
    out["spec_phase_s"] = time.time() - t_spec
    log(f"  spec phase {out['spec_phase_s']:.1f} s")

    log("profile: one decode step of engines A and E under torch.profiler")
    profile_decode(torch, device, cfg, dims, args.seed, out)

    # the serve and spec phases' launches per entry: K1's count holds both
    # layouts
    counts = {k: v + spec_counts.get(k, 0) for k, v in counts.items()}
    planar = (counts["quant_matmul_planar_decode"]
              + counts["quant_matmul_planar_prefill"])
    launches = dict(counts, quant_matmul=counts["quant_matmul"] - planar,
                    quant_matmul_planar=planar)
    entries = []
    for name, (replaces, source, tol) in KERNELS.items():
        r = results[name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            tolerance=tol, shape=r["shape"],
            **{k: r[k] for k in EXTRAS if k in r}))
    out["kernels"] = entries
    out["total_s"] = time.time() - t_start
    log(f"total {out['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    log("calibration (s a step, peak GiB): " + "; ".join(
        f"{k} {v['step_s']:.4f}, {v['peak_gib']:.2f}"
        for k, v in out["calibrate"].items()) + "; on:")
    log(smi)
    opt_res = out["opt"]
    log("opt (prefill / step_n tok/s, native and int8 KV; W6A6 calibration "
        "s a step, peak GiB; perplexity fake-quant / packed, s a window): "
        + "; ".join(f"{kv} {opt_res['serve_' + kv]['prefill_tok_s']:.1f} / "
                    f"{opt_res['serve_' + kv]['decode_tok_s']:.1f}"
                    for kv in OPT_SERVE_PATHS)
        + "; " + "; ".join(
            f"{k} {v['step_s']:.4f}, {v['peak_gib']:.2f}; "
            f"{v['ppl']['fake_quant']:.2f} "
            f"({v['ppl']['fake_quant_s_per_window']:.4f}) / "
            f"{v['ppl']['packed']:.2f} "
            f"({v['ppl']['packed_s_per_window']:.4f})"
            for k, v in opt_res.items() if k in OPT_CALIB_RUNS)
        + "; on:")
    log(smi)
    o27 = out["opt27b"]
    log("opt27b (prefill / step_n tok/s, native and int8 KV; int8 verify "
        "tok/s; perplexity f32 / packed; LWC s a step, peak GiB, held-out "
        "MSE vs RTN): " + "; ".join(
            f"{kv} {o27['serve_' + kv]['prefill_tok_s']:.1f} / "
            f"{o27['serve_' + kv]['decode_tok_s']:.1f}"
            for kv in OPT_SERVE_PATHS)
        + f"; {o27['serve_int8']['verify_tok_s']:.1f}; "
        f"{o27['ppl']['fake_quant']:.2f} / {o27['ppl']['packed']:.2f}; "
        + "; ".join(
            f"{k} {v['step_s']:.4f}, {v['peak_gib']:.2f}, "
            f"{v['held_out_mse']['calibrated']:.4g} vs "
            f"{v['held_out_mse']['rtn']:.4g}"
            for k, v in o27.items() if k in OPT27B_CALIB_RUNS)
        + "; on:")
    log(smi)
    fal = out["falcon"]
    log("falcon (prefill / step_n tok/s, native and int8 KV; LWC "
        "calibration s a step, peak GiB, held-out MSE vs RTN): " + "; ".join(
            f"{m} " + ", ".join(
                f"{kv} {fal[m]['serve_' + kv]['prefill_tok_s']:.1f} / "
                f"{fal[m]['serve_' + kv]['decode_tok_s']:.1f}"
                for kv in FALCON_SERVE_PATHS[m]) for m in FALCON_MODELS)
        + "; " + "; ".join(
            f"{k} {v['step_s']:.4f}, {v['peak_gib']:.2f}, "
            f"{v['held_out_mse']['calibrated']:.4g} vs "
            f"{v['held_out_mse']['rtn']:.4g}"
            for k, v in fal.items() if k in FALCON_CALIB_RUNS)
        + "; on:")
    log(smi)
    sp = out["spec"]
    log("spec (a round ms, in sequential steps, acceptance, spec / step_n "
        "tok/s, draft extra GiB): " + "; ".join(
            f"{k} {sp[k]['round_ms']:.2f}, {sp[k]['round_in_steps']:.2f}, "
            f"{sp[k]['acceptance']:.4f}, {sp[k]['spec_tok_s']:.1f} / "
            f"{sp[k]['step_n_tok_s']:.1f}"
            + (f", {sp[k]['draft_extra_gib']:.4f}"
               if "draft_extra_gib" in sp[k] else "")
            for k in ("A_native", "A_int8", "A_full", "B", "C"))
        + f"; sampling acceptance {sp['sampling']['acceptance']:.4f}; "
        "auto_grow copy ms / peak GiB: " + "; ".join(
            f"{k[2:]} " + ", ".join(f"{g['ms']:.2f} / {g['peak_gib']:.3f}"
                                   for g in sp[k]["growths"])
            for k in sp if k.startswith("D_")) + "; on:")
    log(smi)
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
