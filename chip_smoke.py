#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``omniquant_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository checkout around this file; without either it exits non-zero and
prints no result. Any failure raises, so the exit code is non-zero.

1. build   -- compile every ``omniquant_tpu_torch/csrc/*.cu`` with nvcc
              into ``build/`` (one nvcc per source, all started at once).
2. kernels -- each hand-written kernel against its plain PyTorch version at
              the shapes of the LLaMA-7B serving path, in bf16, with the
              per-element tolerance stated in KERNELS
              (omniquant_tpu_torch/kernels/tolerance.py); device times of
              the kernel, the plain version and one PyTorch library call as
              a yardstick (CUDA events, launches queued behind a device
              sleep so no host time falls inside), beside the least time
              the card could take.
3. serve   -- LLaMA-7B widths and depth (vocab 32000, hidden 4096, inter
              11008, 32 layers, 32/32 heads), random weights from a seeded
              torch.Generator, packed W4 g128 (pairs layout) by pack_model.
              Engine A (max_batch 32, max_len 512, bf16 KV) prefills 32
              prompts of 128 tokens with add_requests and decodes 32 tokens
              with step_n(., 8); engine B (max_batch 8, max_len 2048)
              prefills 8 prompts of 1024 tokens (flash attention) and
              decodes 8. The launch counts are set to 0 just before and read
              just after; every kernel must have launched.
4. e2e     -- at full width and 2 layers, the engine's prefill logits and
              first decode logits against a forward of the same packed model
              composed of plain PyTorch ops in f32.

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
}

# e2e tolerance on logits, relative to the reference's rms / max magnitude:
# the engine rounds activations to bf16 at every op (2^-9 relative each)
# through 2 layers of 4096/11008-wide sums, the reference stays in f32. The
# same engine running every plain version instead of a kernel (on the CPU)
# shows the same error, so it is the bf16 rounding and not a kernel's.
E2E_RMS_REL, E2E_MAX_REL = 5e-2, 1e-1


def log(*a):
    print(*a, flush=True)


def rms_rel_err(got, want) -> float:
    d = got.float() - want.float()
    return (d.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()).item()


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
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


def check_kv(torch, device, timer, dims) -> tuple:
    from omniquant_tpu_torch.kernels.kv_update import (
        kv_cache_prefill_write, kv_cache_prefill_write_plain, kv_cache_write,
        kv_cache_write_plain)

    B, Hh, S, D = dims["batch"], dims["heads"], dims["max_len"], 128
    Sp = dims["prompt_len"]
    gen = torch.Generator(device=device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(
            torch.bfloat16)

    cache = rnd(B, Hh, S, D)
    new = rnd(B, Hh, Sp, D)
    slots = torch.randperm(B, generator=gen, device=device).to(torch.int32)
    a, b_ = cache.clone(), cache.clone()
    kv_cache_prefill_write(a, new, slots)
    kv_cache_prefill_write_plain(b_, new, slots)
    torch.cuda.synchronize()
    err3 = (a.float() - b_.float()).abs().max().item()
    if err3 != 0:
        raise AssertionError(f"kv_cache_prefill_write differs: {err3}")
    sl = slots.long()
    t3 = timer(lambda: kv_cache_prefill_write(a, new, slots),
               "kv_cache_prefill_write")
    t3p = timer(lambda: kv_cache_prefill_write_plain(b_, new, slots),
                "kv_cache_prefill_write plain")
    t3l = timer(lambda: a.__setitem__((sl, slice(None), slice(0, Sp)), new),
                "kv_cache_prefill_write library")
    b3, by3 = bound_ms(2 * new.numel() * 2, 0)
    log(f"  kv_cache_prefill_write new {tuple(new.shape)} -> "
        f"{tuple(cache.shape)}: exact  kernel {t3:.4f} ms  plain "
        f"{t3p:.4f}  slice-assign {t3l:.4f}  bound {b3:.4f}")

    ck, cv = cache.clone(), rnd(B, Hh, S, D)
    pk, pv = ck.clone(), cv.clone()
    nk, nv = rnd(B, Hh, D), rnd(B, Hh, D)
    lengths = torch.randint(0, S, (B,), generator=gen, device=device,
                            dtype=torch.int32)
    kv_cache_write((ck, cv), (nk, nv), lengths)
    kv_cache_write_plain(pk, nk, lengths)
    kv_cache_write_plain(pv, nv, lengths)
    torch.cuda.synchronize()
    err4 = max((ck.float() - pk.float()).abs().max().item(),
               (cv.float() - pv.float()).abs().max().item())
    if err4 != 0:
        raise AssertionError(f"kv_cache_write differs: {err4}")
    ar, ln = torch.arange(B, device=device), lengths.long()

    def lib4():
        ck[ar, :, ln] = nk
        cv[ar, :, ln] = nv

    t4 = timer(lambda: kv_cache_write((ck, cv), (nk, nv), lengths),
               "kv_cache_write")
    t4p = timer(lambda: (kv_cache_write_plain(pk, nk, lengths),
                         kv_cache_write_plain(pv, nv, lengths)),
                "kv_cache_write plain")
    t4l = timer(lib4, "kv_cache_write library")
    b4, by4 = bound_ms(2 * 2 * nk.numel() * 2, 0)
    log(f"  kv_cache_write k+v rows {tuple(nk.shape)} -> {tuple(ck.shape)}: "
        f"exact  kernel {t4:.4f} ms  plain {t4p:.4f}  index-assign "
        f"{t4l:.4f}  bound {b4:.4f}")
    k3 = dict(ms=t3, plain_ms=t3p, library_ms=t3l, bound_ms=b3,
              bound_by=by3, max_abs_err=err3,
              shape=f"new {tuple(new.shape)} -> cache {tuple(cache.shape)}")
    k4 = dict(ms=t4, plain_ms=t4p, library_ms=t4l, bound_ms=b4,
              bound_by=by4, max_abs_err=err4,
              shape=f"k and v rows {tuple(nk.shape)} -> {tuple(ck.shape)}")
    return k3, k4


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
    """The main path: both engines through their user entry points."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.serving import LlamaEngine

    t0 = time.time()
    packed = make_packed(torch, cfg, device, seed)
    torch.cuda.synchronize()
    out["pack_s"] = time.time() - t0
    log(f"serve: {cfg.num_hidden_layers}-layer model packed W4 g128 in "
        f"{out['pack_s']:.1f} s")
    eng_a = LlamaEngine(packed, cfg, max_batch=dims["batch"],
                        max_len=dims["max_len"], dtype=torch.bfloat16,
                        seed=seed, device=device)
    eng_b = LlamaEngine(packed, cfg, max_batch=dims["flash_batch"],
                        max_len=2 * dims["flash_len"], dtype=torch.bfloat16,
                        seed=seed, device=device)
    del packed
    # warm-up (cuBLAS handles, allocator): one short request, released
    s = eng_a.add_requests(prompts(torch, 2, 16, cfg.vocab_size, seed))
    eng_a.step_n({x: eng_a._pending_next[x] for x in s}, 2)
    for x in s:
        eng_a.release(x)
    torch.cuda.synchronize()

    def run(eng, n, length, steps, step_n):
        reqs = prompts(torch, n, length, cfg.vocab_size, seed + length)
        torch.cuda.synchronize()
        t0 = time.time()
        slots = eng.add_requests(reqs)
        torch.cuda.synchronize()
        t1 = time.time()
        last = {s: eng._pending_next[s] for s in slots}
        toks = {s: [t] for s, t in last.items()}
        for _ in range(steps // step_n):
            res = eng.step_n(last, step_n)
            for s_, r in res.items():
                toks[s_].extend(r)
                last[s_] = r[-1]
        torch.cuda.synchronize()
        t2 = time.time()
        for s_ in slots:
            eng.release(s_)
        vocab_ok = all(0 <= t < cfg.vocab_size for v in toks.values()
                       for t in v)
        if not vocab_ok or any(len(v) != steps + 1 for v in toks.values()):
            raise AssertionError("engine returned malformed token streams")
        return dict(prefill_s=t1 - t0, decode_s=t2 - t1,
                    prefill_tok_s=n * length / (t1 - t0),
                    decode_tok_s=n * steps / (t2 - t1),
                    distinct_tokens=len({t for v in toks.values() for t in v}))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    a = run(eng_a, dims["batch"], dims["prompt_len"], dims["decode_steps"], 8)
    b = run(eng_b, dims["flash_batch"], dims["flash_len"], 8, 8)
    counts = kernels.launch_counts()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["serve_a"], out["serve_b"], out["launches"] = a, b, counts
    log(f"  engine A {dims['batch']}x{dims['prompt_len']}: prefill "
        f"{a['prefill_tok_s']:.1f} tok/s ({a['prefill_s']:.3f} s), decode "
        f"{a['decode_tok_s']:.1f} tok/s over {dims['decode_steps']} steps "
        f"({a['decode_s']:.3f} s)")
    log(f"  engine B {dims['flash_batch']}x{dims['flash_len']}: prefill "
        f"{b['prefill_tok_s']:.1f} tok/s ({b['prefill_s']:.3f} s), decode "
        f"{b['decode_tok_s']:.1f} tok/s over 8 steps ({b['decode_s']:.3f} s)")
    log(f"  peak memory {out['peak_mem_gb']:.2f} GiB; launches {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return counts


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
    """Prefill and first-decode logits of the engine against a plain f32
    forward (models.llama.forward on dense dequantized weights)."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.serving import LlamaEngine

    packed = make_packed(torch, cfg, device, seed + 1)
    ref_params = plain_reference_params(torch, packed)
    res = {}
    for n, length in ((32, 128), (4, 512)):
        eng = LlamaEngine(packed, cfg, max_batch=n, max_len=2 * length,
                          dtype=torch.bfloat16, seed=seed, device=device)
        reqs = prompts(torch, n, length, cfg.vocab_size, seed + 7 * length)
        slots, logits = eng.add_requests(reqs, return_logits=True)
        first = [eng._pending_next[s] for s in slots]
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))
        tokens = torch.tensor(reqs, device=device)
        full = torch.cat([tokens, torch.tensor(first, device=device)[:, None]],
                         dim=1)
        with torch.no_grad():
            ref = llama.forward(ref_params, full, cfg)
        for what, got, want in (("prefill", logits, ref[:, length - 1]),
                                ("decode", dec, ref[:, length])):
            d = got.float() - want
            rms_rel = (d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()
                       ).item()
            max_rel = (d.abs().max() / want.abs().max()).item()
            agree = (got.float().argmax(-1) == want.argmax(-1)).float(
            ).mean().item()
            key = f"{what}_{n}x{length}"
            res[key] = dict(rms_rel=rms_rel, max_rel=max_rel,
                            argmax_agree=agree)
            log(f"  e2e {key}: rms rel err {rms_rel:.3g} (tol {E2E_RMS_REL})"
                f", max rel err {max_rel:.3g} (tol {E2E_MAX_REL}), argmax "
                f"agreement {agree:.3f}")
            if not (math.isfinite(rms_rel) and rms_rel <= E2E_RMS_REL
                    and max_rel <= E2E_MAX_REL):
                raise AssertionError(f"e2e {key} outside tolerance")
        del eng
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
                prefill_m=32 * 128, flash_m=8 * 1024)

    log("kernels: each against its plain version at the 7B serving shapes")
    timer = Timer(torch, device)
    results = {"quant_matmul": check_quant_matmul(torch, device, timer, dims,
                                                  out),
               "flash_attention": check_flash(torch, device, timer, dims)}
    results["kv_cache_prefill_write"], results["kv_cache_write"] = check_kv(
        torch, device, timer, dims)
    out["host_in_window"] = timer.host_in_window
    log(f"  timings that include host time (the function synchronises): "
        f"{timer.host_in_window or 'none'}")
    del timer
    torch.cuda.empty_cache()

    counts = serve(torch, device, cfg, dims, args.seed, out)
    torch.cuda.empty_cache()

    log("e2e: 2-layer full-width engine against a plain f32 forward")
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
    a, b = out["serve_a"], out["serve_b"]
    log(f"serving: prefill {a['prefill_tok_s']:.1f} tok/s (32x128), "
        f"{b['prefill_tok_s']:.1f} tok/s (8x1024); decode "
        f"{a['decode_tok_s']:.1f} tok/s (batch 32), {b['decode_tok_s']:.1f} "
        f"tok/s (batch 8); peak memory {out['peak_mem_gb']:.2f} GiB; on:")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
