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
2b. probes -- the Hopper probes of the JAX package's experiment scripts
              (kernels/probes.py, csrc/probes.cu; on no serving path): S4
              consume at M = K = N = 4096 (n_dots 4 and 1), S2 mxu_rate
              bf16 and int8 (512^3, 64 x 64 products), S3 f32inj_matmul
              (W4, W2, W8 g128 planar at M = 32, K = N = 4096) and S1
              ablate_decode (W4 and W2, full, noup at bn = bk, nodot),
              each held against its plain version at
              tolerance.PROBE_REL_TOL and timed beside its bound and a
              library call; then their path: the four drivers
              (omniquant_tpu_torch/scripts, as ``python -m`` runs them)
              with the launch counts set to 0 before and read after, every
              probe and every S1 mode launched. The serving path must
              launch none of them.
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
              pack against its dequantized weights in f32; then the harness
              on the same pack (below); then LWC W4A16 g128 at 2 layers
              with calibrate's five checks.
   harness -- the evaluation harness as the CLI's --tasks runs it
              (eval/harness: run_tasks over a TorchLM, seqlen 2048, batch
              4, bf16), on task docs made from the seed and the CLI's
              CharTokenizer: piqa (64 docs), lambada_openai (32), wikitext
              (3 docs of 3 rolling windows) and gsm8k (16 greedy_until
              contexts, some of 300 characters and more, 16 tokens each):
              scoring through K1's prefill tile (and, at 8192 rows, the
              dense route on the linears whose N K1 takes only below 4096
              rows), generation through the engine (K2, K3, K4, K1's decode
              tile). Each loglikelihood, greedy flag, rolling sum,
              generated stream and task metric is held token by token
              against the plain f32 forward (harness_hold). Planted faults
              go through the same run and hold, which must reject them:
              the scales x 1.01 in the second of the pack's first two
              layers (beside a clean run of those two layers, which must
              pass), x 1.1 in the middle layer of all 32. Then W4A4 on a
              planar W4 g128 pack of the
              same weights at 2 layers (K7 below 2048 rows and at decode,
              K8 + K9 from 2048), held the same way at E2E_INT_TOL[4].
              Requests/s, windows/s and tokens/s of the three request
              types.
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
              --save_dir and a 16-token --serve_prompt of the packed model
              (tiny-llama with --export_autogptq: its model_autogptq.pt
              decoded by unpack_autogptq equals model_packed.npz's
              weights at the f16 scales, bit for bit);
              exit 0, a results JSON last, and K1, K3 and K4 launched (the
              CLI logs its launch counts); tiny-llama again with --sp 2
              (its mesh logged, K2 with stats launched as the ring's
              schedule says, its perplexity near the run without --sp).
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
11. sp      -- sequence-parallel calibration with all shards on the card:
              (a) K2 with its softmax stats (return_stats) at the ring's
              blocks, (1, 32, 2048, 128) and (1, 32, 1024, 128), and
              OPT-2.7B's (1, 32, 1024, 80), causal and not, against its
              plain version (out at K2's rule and equal to the call without
              stats; m and l at tolerance.flash_stats_close), timed with
              and without stats beside aten's flash attention with its
              logsumexp; (b) ring attention over 4096 tokens at sp 2 and 4,
              the flash ring against the plain ring and K2 over the whole
              sequence; (c) calibrate(..., sp_mesh=[cuda:0] * 2) at
              LLaMA-2-7B's published widths (meta-llama/Llama-2-7b-hf:
              vocab 32000, hidden 4096, inter 11008, 32 heads, 4096
              positions, rms eps 1e-5; 2 layers, random seeded weights) on
              4 windows of 4096 tokens, W4A16 g128 LWC, 2 epochs, and (d)
              at OPT-2.7B's widths (2 layers, heads of 80, sm_scale 1.0) on
              4 windows of 2048, each against the run without sp_mesh on
              the same card and windows (losses, LWC factors, folded
              weights, packed codes; held-out MSE below round-to-nearest),
              seconds a step and peak GiB of both, and the K2 stats
              launches and ring calls the schedule implies.
12. profile -- A and E rebuilt on a fresh W4 model, prefilled as in serve,
              two step_n(., 8) on the host clock, then one under
              torch.profiler: the device's busy share of a decode step, the
              kernel launches per step and the kernels that took the most
              device time.
13. tp      -- last: tensor-parallel serving (serving/tp_engine.py) with
              every shard on the card (make_mesh(tp=n, devices=[cuda:0] *
              n), one thread a shard): LLaMA-2-7B's published widths
              (meta-llama/Llama-2-7b-hf) at 2 layers and tp 2, W4A16 g128
              (pairs) and W4A4 on a planar W4 g128 pack (K7 at decode, K8 +
              K9 at the prefill, the min/max all-reduce), intermediate
              11008 padded to 11264; then LLaMA-2-70B's (meta-llama/
              Llama-2-70b-hf: vocab 32000, hidden 8192, intermediate 28672,
              64 heads on 8 kv heads) at TP_70B_LAYERS of its 80 layers and
              tp 8, W3 g128 packed layer by layer as scripts/rehearse_70b.py
              lays it out, bf16 and int8 KV; random weights from seeded
              generators. Each run: batch 8 x 256-token prompts, max_len
              2048, the first decode and two step_n(., 8), on the single
              LlamaEngine of the same pack and on the TP engine (decoding
              from the single engine's first tokens), timed;
              every plain version and dense route counted (none may run);
              the TP engine's launches exactly tp times a shard's
              (_tp_expected); its prefill and first-decode logits against
              the single engine's at E2E_TOL (W4A4: E2E_INT_TOL[4]) and its
              streams under the near-tie rule; the planted fault (the last
              shard's partial left out of every sum) must fail that hold.
              The 70B int8 run ends with one step_n(., 8) of each engine
              under torch.profiler (the card's busy share). Then
              --eval_ppl --tp's path (make_tp_model_forward with the
              activation quantizers) at LLaMA-2-70B widths, TP_70B_LAYERS
              layers, tp 8, per-channel W4A4 and W6A6 packed planar, in
              bf16, on one 2048-token window of the synthetic test split
              (TP_PPL_RUNS): K8 + K9 at the row-parallel sites, the
              fake-quantized input (ranges all-reduced) into K1's planar
              prefill tile at the column-parallel ones, launches exactly tp
              times a shard's; against the single-device forward of the
              pack: every column-parallel site's gathered quantized input
              the unsplit quantizer's bit for bit, each shard's
              row-parallel products the single device's columns within
              TP_PPL_SHARD_RMS, the logits within TP_PPL_LOGIT_RMS (W6A6
              only) and the NLL rule of ppl_check; shard-local ranges and
              shard 0's scales x 1.01 must each fail. Seconds a window, peak GiB. The kernels
              phase holds and times K1 at the per-shard shapes (TP_K1:
              70B's at tp 8, 7B's at tp 2, OPT-2.7B's out_proj retiled to
              256 and 128 rows) and K6 at a 70B shard's one kv head of 8
              query heads.
14. mp      -- multi-process serving, every rank a process of its own on
              the one card (this script with --mp-rank, spawned after the
              build, each rank with the phase's timeout; a gloo group, as
              the ranks share a card; each pack written once to
              build/mp/ in utils/convert.py's npz format and read by the
              ranks, none of which packs). DP: LLaMA-7B widths at 32
              layers (engine A's: W4A16 g128 pairs, bf16 KV, max_len 512)
              behind DPServingCoordinator over 2 ranks of max_batch 4: 8 x
              128 prompts routed round-robin, the first decode, step_n(.,
              8) x 4, gather_tokens; held: both ranks gather the same
              global streams, each under the near-tie rule; each rank's
              first-decode logits equal a batch-4 LlamaEngine's on its
              prompts bit for bit and its streams that engine's; its K1,
              K3 and K4 launches that engine's; a rank whose scales are x
              1.01 must fail that hold. Read beside one engine at batch 8:
              prefill and step_n tok/s a rank and together, peak GiB a
              rank. TP: the tp phase's LLaMA-2-7B tp 2 (W4A16) and
              LLaMA-2-70B tp 8 (8 layers, int8 KV) packs made again from
              their seeds, one shard a rank (each rank places only its
              shard): every rank's launches exactly one shard's of the tp
              phase's run, its prefill and first-decode logits against the
              tp phase's in-process TP engine (bit identity reported, held
              at E2E_TOL), all ranks alike, streams under the near-tie
              rule; the last shard's partial left out of every sum must
              fail. A step ms, step_n and prefill tok/s and a shard's GiB
              beside the in-process mesh's and the single engine's. DP
              again, its ranks launched with torchrun's variables and no
              coordinator (init_multihost finds the group): each rank's
              streams, first-decode logits and launches those of the
              explicit launch's rank bit for bit. SP: the sp phase's
              LLaMA-2-7B run (4 x 4096 tokens, W4A16 g128 LWC) with the
              ring across 2 ranks of one shard (k/v blocks and, in the
              backward, their gradients exchanged point to point through
              the host): layer 0's fp capture the in-process SPMesh's bit
              for bit, losses and LWC factors within the sp phase's
              tolerances and MP_SP_LOSS_RTOL / MP_SP_LWC_RMS of it, both
              ranks alike, each rank's K2 stats launches its shard's share
              of the ring; rank 1 handing zeros back for the dk/dv must
              fail. Seconds a step (the slowest rank) beside the
              in-process and single-device runs, peak GiB a rank.

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON line ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--out`` also writes every measurement
to a JSON file.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    # K2 with its softmax stats (return_stats): the same kernel source and
    # pallas_call, its stats written in the epilogue, counted apart
    "flash_attention_stats": (
        "omniquant_tpu/kernels/flash_attention.py:146",
        "omniquant_tpu_torch/csrc/flash_attention.cu",
        "out as flash_attention; m within 2^-12 (1 + |m|) and l within "
        "2^-12 l of the plain version's (f32 scores summed in another "
        "order, ex2.approx)"),
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
    # the Hopper probes of the JAX package's experiment scripts (S1-S4), on
    # no serving path: the probes phase drives them through their drivers
    "ablate_decode": (
        "scripts/exp_ablate_kernel.py:98",
        "omniquant_tpu_torch/csrc/probes.cu",
        "1e-2 of the largest |plain| (an f32 sum rounded to bf16 once)"),
    "mxu_rate_bf16": (
        "scripts/exp_mxu_rates.py:48", "omniquant_tpu_torch/csrc/probes.cu",
        "1e-5 of the largest |plain| (64 f32 sums of one product, in "
        "another order)"),
    "mxu_rate_int8": (
        "scripts/exp_mxu_rates.py:48", "omniquant_tpu_torch/csrc/probes.cu",
        "exact (s32 sums of integers)"),
    "f32inj_matmul": (
        "scripts/exp_unpack_variants.py:114",
        "omniquant_tpu_torch/csrc/probes.cu",
        "1e-2 of the largest |plain| (an f32 sum rounded to bf16 once)"),
    "consume": (
        "scripts/exp_ablate_int.py:66", "omniquant_tpu_torch/csrc/probes.cu",
        "1e-2 of the largest |plain| (an f32 sum rounded to bf16 once)"),
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
          "host_us", "cases", "ms_without_stats", "stats_m_max_abs_err",
          "stats_l_max_rel_err", "tp", "rate", "peak_share")

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
# ---------------------------------------------------------------------------
# probes phase: the Hopper probes of the JAX package's experiment scripts
# (kernels/probes.py, S1-S4), at the scripts' shapes

# count name -> the probe's launches that the drivers' run must show
PROBE_PATHS = ("consume", "mxu_rate_bf16", "mxu_rate_int8", "f32inj_matmul",
               "ablate_decode_full", "ablate_decode_noup",
               "ablate_decode_nodot")
PROBE_DRIVERS = ("exp_ablate_int", "exp_mxu_rates", "exp_unpack_variants",
                 "exp_ablate_kernel")


def _probe_row(torch, timer, label, name, call, plain, lib, nbytes, ops,
               peak) -> dict:
    """One probe call held to its plain version at PROBE_REL_TOL, then the
    device times of the kernel, the plain version and the library call
    (None where there is none), beside the bound for these inputs."""
    from omniquant_tpu_torch.kernels import tolerance

    got = call()
    want = plain()
    torch.cuda.synchronize()
    ok, err, rel = tolerance.probe_close(got, want, name)
    if not ok:
        raise AssertionError(f"{label}: max abs err {err}, {rel:.3g} of the "
                             "largest |value|")
    del got, want
    t = timer(call, label)
    t_plain = timer(plain, label + " plain", iters=3)
    t_lib = None if lib is None else timer(lib, label + " library")
    b, by = bound_ms(nbytes, ops, peak)
    log(f"  {label:34s}: max abs err {err:.3g} ({rel:.3g} of max)  kernel "
        f"{t:.4f} ms  plain {t_plain:.4f}  library "
        f"{'-' if t_lib is None else f'{t_lib:.4f}'}  bound {b:.4f} ({by})")
    return dict(ms=t, plain_ms=t_plain, library_ms=t_lib, bound_ms=b,
                bound_by=by, max_abs_err=err, rel_err=rel)


def _probe_entry(rows: dict, head: str) -> dict:
    """The JSON entry: the head row's numbers, the largest error of all,
    every row under ``cases``."""
    return dict(rows[head], shape=head, cases=rows,
                max_abs_err=max(r["max_abs_err"] for r in rows.values()))


def probe_checks(torch, device, timer) -> dict:
    """S1-S4 against their plain versions at the scripts' shapes, timed
    (the Timer's cold-L2 single launches). Bounds: bytes (words, x, the
    slabs' used rows, out) for S1 and S3, operations at the bf16 and int8
    peaks for S2 and S4. Library calls, timed only: S4 torch._int_mm and
    the scale (n_dots 1's function); S2 one torch.matmul / torch._int_mm
    doing the kernel's 64 x 64 products (x tiled, w stacked); S3 and S1
    full bf16 torch.matmul
    on the weight they multiply (S1's without zero points). S3's rows also
    time K1 on the same words (``k1_ms``: the script's "cur")."""
    from omniquant_tpu_torch.kernels import probes
    from omniquant_tpu_torch.kernels.quant_matmul import quant_matmul
    from omniquant_tpu_torch.quant import (QuantConfig, dequantize_packed,
                                           pack_weight)
    from omniquant_tpu_torch.quant.packing import unpack_codes
    from omniquant_tpu_torch.scripts import (exp_ablate_int,
                                             exp_ablate_kernel,
                                             exp_mxu_rates,
                                             exp_unpack_variants)

    res = {}
    # S4 at M = K = N = 4096, BK 512, W4 g128 codes
    ops = exp_ablate_int.operands(device)
    xc, w8, slabs, n_g = ops["xc"], ops["w8"], ops["slabs"], ops["n_g"]
    M, K = xc.shape
    N = w8.shape[1]
    rows = {}
    for n_dots in (n_g, 1):
        lib = None
        if n_dots == 1:
            row0 = slabs[0, 0]
            lib = lambda: torch._int_mm(xc, w8) * row0
        rows[f"n_dots {n_dots}"] = _probe_row(
            torch, timer, f"consume n_dots {n_dots}", "consume",
            lambda n=n_dots: probes.consume(xc, w8, slabs, n),
            lambda n=n_dots: probes.consume_plain(xc, w8, slabs, n), lib,
            M * K + K * N + (K // 512) * n_g * N * 4 + M * N * 2,
            2.0 * M * K * N, INT8_OPS_PER_S)
    del ops, xc, w8
    res["consume"] = _probe_entry(rows, f"n_dots {n_g}")
    # S2: 512^3 operands, 64 products a repeat, 64 repeats
    for dt, name, peak in (("bf16", "mxu_rate_bf16", BF16_FLOPS_PER_S),
                           ("int8", "mxu_rate_int8", INT8_OPS_PER_S)):
        x, w = exp_mxu_rates.operands(device, dt)
        fn = getattr(probes, name)
        # the library's call for the same products: x tiled 64 x 64 times w
        # stacked 64 times, (32768, 32768) . (32768, 512), whose 64 row
        # blocks are the 64 repeats' sums of 64 products each
        xt, ws = x.repeat(probes.MXU_REPEATS, probes.MXU_INNER), w.repeat(
            probes.MXU_INNER, 1)
        if dt == "bf16":
            lib = lambda xt=xt, ws=ws: torch.matmul(xt, ws)
        else:
            lib = lambda xt=xt, ws=ws: torch._int_mm(xt, ws)
        flops = probes.mxu_flops(x.shape[0], w.shape[1])
        row = _probe_row(
            torch, timer, f"{name} 512^3 x 64 x 64", name,
            lambda fn=fn, x=x, w=w: fn(x, w),
            lambda x=x, w=w: probes.mxu_rate_plain(x, w), lib,
            x.numel() * x.element_size() * 2 + x.shape[0] * w.shape[1] * 4,
            flops, peak)
        del xt, ws
        row["rate"] = flops / (row["ms"] * 1e-3)
        row["peak_share"] = row["rate"] / peak
        row["library_rate"] = flops / (row["library_ms"] * 1e-3)
        log(f"    {name}: {row['rate'] / 1e12:.1f} TOP/s, "
            f"{100 * row['peak_share']:.1f} % of the dense peak (library "
            f"{row['library_rate'] / 1e12:.1f} TOP/s)")
        res[name] = dict(row, shape="512 x 512 x 512, 64 x 64 products",
                         cases={})
    # S3 and S1 at M = 32, K = N = 4096, planar g128 (tile 512)
    gen = torch.Generator(device=device).manual_seed(2424)
    x = torch.randn(exp_unpack_variants.M, exp_unpack_variants.K,
                    generator=gen, device=device).to(torch.bfloat16)
    M, K = x.shape
    N = exp_unpack_variants.N
    inj, abl = {}, {}
    for bits in (4, 2, 8):
        w = torch.randn(N, K, generator=gen, device=device) * 0.02
        pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=128))
        del w
        words = pw.qweight.numel() * 4
        used = (K // 512) * 4 * N * 4  # a slab's used rows, f32
        sc2, off2 = probes.f32inj_slabs(pw)
        w_lib = dequantize_packed(pw, dtype=torch.bfloat16)
        args = (x, pw.qweight, sc2, off2, bits, pw.tile_k, pw.group_size)
        k1 = pw.map_tensors(
            lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
        inj[f"W{bits}"] = row = _probe_row(
            torch, timer, f"f32inj_matmul W{bits} m={M}", "f32inj_matmul",
            lambda a=args: probes.f32inj_matmul(*a),
            lambda a=args: probes.f32inj_matmul_plain(*a),
            lambda w_lib=w_lib: torch.matmul(x, w_lib),
            words + x.numel() * 2 + 2 * used + M * N * 2, 2.0 * M * K * N,
            BF16_FLOPS_PER_S)
        # the script's "cur" row: K1 on the same words (bf16 scales)
        row["k1_ms"] = timer(lambda k1=k1: quant_matmul(x, k1),
                             f"quant_matmul W{bits} m={M}")
        log(f"    K1 on the same words: {row['k1_ms']:.4f} ms")
        del k1
        if bits in exp_ablate_kernel.WIDTHS:
            sc = probes.ablate_slabs(pw)
            codes = unpack_codes(pw.qweight, bits, K, 128, pw.tile_k)
            w_nz = (codes.float() * pw.scales.t().float().repeat_interleave(
                128, 0)).to(torch.bfloat16)  # no zero points, as S1
            del codes
            for mode in probes.ABLATE_MODES:
                bn = pw.tile_k if mode == "noup" else exp_ablate_kernel.BN
                a = (mode, x, pw.qweight, sc, bits, pw.tile_k, 128, bn)
                abl[f"W{bits} {mode}"] = _probe_row(
                    torch, timer, f"ablate_decode W{bits} {mode} bn={bn}",
                    "ablate_decode", lambda a=a: probes.ablate_decode(*a),
                    lambda a=a: probes.ablate_decode_plain(*a),
                    (lambda w_nz=w_nz: torch.matmul(x, w_nz))
                    if mode == "full" else None,
                    words + x.numel() * 2 + used + M * N * 2,
                    2.0 * M * K * N, BF16_FLOPS_PER_S)
            del w_nz
        del pw, w_lib, sc2, off2
    res["f32inj_matmul"] = _probe_entry(inj, "W4")
    res["ablate_decode"] = _probe_entry(abl, "W4 full")
    return res


def probes_phase(torch, device, timer, out: dict) -> tuple:
    """The probes held and timed (probe_checks), then their path: the four
    drivers (omniquant_tpu_torch/scripts, each main() as ``python -m``
    runs it, at the scripts' shapes, printing the scripts' rows) with the
    launch counts set to 0 before and read after; each probe, and each of
    S1's modes, must have launched. Returns (entries, counts)."""
    import importlib

    from omniquant_tpu_torch import kernels

    t0 = time.time()
    res = probe_checks(torch, device, timer)
    kernels.reset_launch_counts()
    for d in PROBE_DRIVERS:
        log(f"  python -m omniquant_tpu_torch.scripts.{d}:")
        importlib.import_module(f"omniquant_tpu_torch.scripts.{d}").main([])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    missing = [k for k in PROBE_PATHS if counts[k] <= 0]
    log(f"  probe launches in the drivers' run: "
        f"{ {k: counts[k] for k in PROBE_PATHS} }")
    if missing:
        raise AssertionError(f"probes: never launched by the drivers: "
                             f"{missing}")
    out["probes"] = dict(rows=res, launches=counts,
                         phase_s=time.time() - t0)
    log(f"  probes phase {out['probes']['phase_s']:.1f} s")
    return res, counts


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


def opt27b_phase(torch, device, seed, out: dict) -> dict:
    """OPT-2.7B at full width and depth: a W4 g128 (pairs) pack served by a
    bf16-KV and an int8-KV OPTEngine (serve_and_hold at OPT_SERVE_PATHS,
    8 x 512 prompts, the first decode, step_n(., 8), verify_step of 4
    tokens on the int8 engine), then ppl_check of the pack against its
    dequantized weights in f32 (9 windows of 2048 tokens; the forward's
    attention is dense, as the JAX package's), then the harness phase on
    the same pack (harness_phase), then LWC W4A16 g128 at
    OPT27B_CALIB_LAYERS layers with calibrate_run's five checks. Returns
    the harness phase's launches."""
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
    torch.cuda.empty_cache()
    log("harness: run_tasks (the CLI's --tasks path) on OPT-2.7B W4 g128 "
        "(32 layers) and W4A4 (2 layers), held token by token against the "
        "plain f32 forward")
    harness_counts = harness_phase(torch, device, cfg, dense, packed, seed,
                                   out)
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
    return harness_counts


# ---------------------------------------------------------------------------
# harness phase: the evaluation harness (eval/harness: run_tasks over a
# TorchLM, as the CLI's --tasks runs it, at its defaults: seqlen 2048, batch
# 4) on opt27b's W4 g128 pack of OPT-2.7B (32 layers, bf16), on task docs
# made from the seed (nothing downloaded) and the CLI's CharTokenizer:
# piqa (multiple choice), lambada_openai (loglikelihood and its greedy
# flag), wikitext (rolling windows of 2048 tokens) and gsm8k (greedy_until,
# some contexts of 256 tokens and more, so the engine's prefill takes K2).
# Then W4A4 (ActQuantSpec.from_bits(4)) on a planar W4 g128 pack of the
# same weights at HARNESS_INT_LAYERS layers: scoring chunks below 2048 rows
# and the decode through K7, chunks from 2048 rows through K8 + K9.
HARNESS_DOCS = {"piqa": 64, "lambada_openai": 32, "wikitext": 3, "gsm8k": 16}
HARNESS_GEN_TOKS = 16     # TorchLM.max_gen_toks for gsm8k's greedy_until
HARNESS_WIKI_CHARS = 5000  # each wikitext doc: 3 rolling windows of 2048
HARNESS_INT_LAYERS = 2
# kernels each run must launch; K1's decode tile (m <= 4 here) is checked
# apart: quant_matmul's launches less its prefill tile's
HARNESS_PATHS = {
    "w4a16": ("quant_matmul", "quant_matmul_prefill", "flash_attention",
              "kv_cache_prefill_write", "kv_cache_write"),
    "w4a4": ("quant_matmul_int", "_unpack_to_int8",
             "_quant_matmul_int_dense", "flash_attention",
             "kv_cache_prefill_write", "kv_cache_write"),
}
# the planted faults, each run through run_tasks and harness_hold as the
# clean run is, which must reject it: name -> (layers of the model, the
# faulted layer, the factor on every scale of its linears). At 32 layers
# the bf16 forward's own per-token gap (0.0177 nats on an H100) hides a 1 %
# fault (the rms rule sees a systematic error from about 0.75 of that
# noise: 1.25^2 - 1 = 0.75^2), so 1 % is planted in the second of the
# pack's first two layers, beside a clean run of those two layers, and
# 10 % in the middle layer of all 32.
HARNESS_FAULTS = {"layer_1_of_2_x1.01": (2, 1, 1.01),
                  "layer_16_of_32_x1.1": (32, 16, 1.1)}
_WORDS = ("time person year way day thing man world life hand part child "
          "eye woman place work week case point number group problem fact "
          "be have do say get make go know take see come think look want "
          "give use find tell ask seem feel try leave call good new first "
          "last long great little own other old right big high different "
          "small large next early young important few public bad same able "
          "red cup table stone river apple water glass paper bread").split()


def harness_docs(seed) -> dict:
    """Task docs in the schemas of tests/test_harness.py, from ``seed``."""
    import random

    rnd = random.Random(seed)

    def words(n):
        return " ".join(rnd.choice(_WORDS) for _ in range(n))

    def para(chars):
        text = ""
        while len(text) < chars:
            text += words(12) + " . "
        return text[:chars]

    piqa = [{"goal": words(rnd.randint(6, 16)),
             "sol1": words(rnd.randint(3, 12)),
             "sol2": words(rnd.randint(3, 12)), "label": rnd.randint(0, 1)}
            for _ in range(HARNESS_DOCS["piqa"])]
    lambada = [{"text": words(rnd.randint(15, 40))}
               for _ in range(HARNESS_DOCS["lambada_openai"])]
    wiki = []
    for _ in range(HARNESS_DOCS["wikitext"]):
        wiki += [f" = {words(2)} = \n", para(HARNESS_WIKI_CHARS) + " \n"]
    gsm = [{"question": para(rnd.choice((60, 120, 300, 420))) + "?",
            "answer": f"{words(6)}\n#### {rnd.randint(0, 999)}"}
           for _ in range(HARNESS_DOCS["gsm8k"])]
    return {"piqa": {"train": [], "validation": piqa},
            "lambada_openai": {"test": lambada},
            "wikitext": {"test": wiki, "validation": wiki[:2]},
            "gsm8k": {"train": [], "test": gsm}}


def _recording_lm(torch, base):
    """A TorchLM subclass that keeps each call's requests, responses and
    seconds (behind a synchronisation), and counts the tokens the engine
    generates; ``holder["lm"]`` is the last one built (pop it)."""
    holder = {}

    class RecordingLM(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.max_gen_toks = HARNESS_GEN_TOKS
            self.record = {}
            holder["lm"] = self

        def _timed(self, kind, requests, fn):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(requests)
            torch.cuda.synchronize()
            self.record[kind] = dict(requests=list(requests), responses=out,
                                     s=time.time() - t)
            return out

        def loglikelihood(self, requests):
            return self._timed("loglikelihood", requests,
                               super().loglikelihood)

        def loglikelihood_rolling(self, requests):
            return self._timed("loglikelihood_rolling", requests,
                               super().loglikelihood_rolling)

        def greedy_until(self, requests):
            eng = self._get_engine()
            step_n, add = eng.step_n, eng.add_requests
            made = [0]

            def counted_step_n(last, n):
                made[0] += n * len(last)
                return step_n(last, n)

            def counted_add(reqs, **kw):
                made[0] += len(reqs)
                return add(reqs, **kw)

            eng.step_n, eng.add_requests = counted_step_n, counted_add
            try:
                out = self._timed("greedy_until", requests,
                                  super().greedy_until)
            finally:
                del eng.step_n, eng.add_requests
            self.record["greedy_until"]["tokens"] = made[0]
            return out

    return RecordingLM, holder


def _token_stats(torch, family, cfg, params, spec, pairs, seqlen, batch,
                 device, rows=False):
    """Per-token log-probabilities and argmax flags of each (context,
    continuation) token pair, in TorchLM's chunks (batch pairs, longest
    first, padded on the right to the chunk's longest); with ``rows`` also
    each row's gap between its top two logits and its largest |logit|."""
    out = [None] * len(pairs)
    order = sorted(range(len(pairs)),
                   key=lambda i: -(len(pairs[i][0]) + len(pairs[i][1])))
    with torch.inference_mode():
        for start in range(0, len(order), batch):
            chunk = order[start:start + batch]
            seqs = [(list(pairs[i][0]) + list(pairs[i][1]))[-(seqlen + 1):]
                    for i in chunk]
            toks = torch.zeros((len(chunk), max(map(len, seqs))),
                               dtype=torch.int64)
            for r, s in enumerate(seqs):
                toks[r, :len(s)] = torch.tensor(s)
            toks = toks.to(device)
            logits = family.forward(params, toks[:, :-1], cfg, spec).float()
            logp = torch.log_softmax(logits, dim=-1)
            tgt = toks[:, 1:]
            lp = logp.gather(-1, tgt[..., None])[..., 0].cpu()
            greedy = (logp.argmax(-1) == tgt).cpu()
            if rows:
                top2 = logits.topk(2, dim=-1).values
                top_gap = (top2[..., 0] - top2[..., 1]).cpu()
                mag = logits.abs().amax(-1).cpu()
            for r, i in enumerate(chunk):
                n, cl = len(seqs[r]), len(pairs[i][1])
                sl = slice(n - 1 - cl, n - 1)
                st = dict(lp=lp[r, sl].double(), greedy=greedy[r, sl])
                if rows:
                    st.update(top_gap=top_gap[r, sl].double(),
                              mag=mag[r, sl].double())
                out[i] = st
            del logits, logp
    return out


def _scored_pairs(lm, record) -> tuple:
    """The token pairs a run scored, as TorchLM encodes them: its
    loglikelihood requests, then each rolling request's disjoint windows;
    and each rolling request's window indices."""
    from omniquant_tpu_torch.eval.harness import (
        get_rolling_token_windows, make_disjoint_window)

    pairs = [([lm.eot_token_id] if c == "" else lm.tok_encode(c),
              lm.tok_encode(x))
             for c, x in record["loglikelihood"]["requests"]]
    owners = []
    for (string,) in record["loglikelihood_rolling"]["requests"]:
        w = [make_disjoint_window(x) for x in get_rolling_token_windows(
            lm.tok_encode(string), lm.eot_token_id, lm.seqlen, 1)]
        owners.append(list(range(len(pairs), len(pairs) + len(w))))
        pairs += w
    return pairs, owners


class _ReplayLM:
    """Responses looked up by request: loglikelihoods and rolling sums from
    ``ll``/``rolling`` (request -> response), generations from ``gen``."""

    def __init__(self, ll, rolling, gen):
        self.ll, self.rolling, self.gen = ll, rolling, gen

    def loglikelihood(self, requests):
        return [self.ll[tuple(r)] for r in requests]

    def loglikelihood_rolling(self, requests):
        return [self.rolling[tuple(r)] for r in requests]

    def greedy_until(self, requests):
        return [self.gen[(r[0], tuple(r[1]))] for r in requests]


def text_stream_gaps(torch, family, cfg, ref, spec, lm, requests, texts,
                     device) -> list:
    """stream_gaps for greedy_until's texts: each text re-encoded (the
    CharTokenizer's tokens map back one to one, apart from chr(1), which
    both the end-of-text token 0 and token 1 decode to), each token's gap
    to its row's argmax in the plain f32 forward ``ref`` over the prompt
    TorchLM gave the engine and the stream before it, over the row's
    largest |logit|. Returns a list of gaps a non-empty text."""
    keep = max(1, lm.seqlen - lm.max_gen_toks)
    gaps = []
    with torch.inference_mode():
        for (ctx, _), text in zip(requests, texts):
            stream = lm.tok_encode(text)
            if not stream:
                continue
            prompt = lm.tok_encode(ctx)[-keep:] or [lm.eot_token_id]
            toks = torch.tensor([prompt + stream[:-1]], device=device)
            logits = family.forward(ref, toks, cfg, spec)[0, -len(stream):]
            logits = logits.float()
            cand = torch.tensor(stream, device=device)
            alt = torch.where(cand == 1, 0, cand)
            top = logits.max(-1).values
            tok = torch.maximum(logits.gather(-1, cand[:, None])[:, 0],
                                logits.gather(-1, alt[:, None])[:, 0])
            gaps.append(((top - tok) / logits.abs().amax(-1)).tolist())
    return gaps


class HoldFailed(AssertionError):
    """harness_hold's rejection: the checks that failed and the
    measurements."""

    def __init__(self, label, reasons, res):
        super().__init__(f"harness {label}: outside the hold: {reasons}")
        self.reasons, self.res = reasons, res


def harness_hold(torch, device, family, cfg, lm, results, ref, plain16,
                 spec, tol_max, docs, label) -> dict:
    """Holds one run_tasks run against the plain f32 forward ``ref`` of the
    same pack (plain_reference_params; ``plain16`` is it in bf16, plain
    PyTorch ops, no kernel), token by token:

    - ppl_check's rule over every scored token (loglikelihoods and rolling
      windows): the rms of the run's per-token log-probability gap to ref
      at most PPL_VS_PLAIN x the bf16 plain forward's;
    - each loglikelihood and each rolling sum within the e2e bound applied
      per token: a row whose logits lie within ``tol_max`` x its largest
      |logit| moves a token's log-probability by at most twice that;
    - each greedy flag equal to ref's, except where a token's argmax
      flipped on a near tie (ref's top-2 gap at most SPEC_TIE x
      ``tol_max`` x the row's largest |logit|); each multiple-choice doc's
      chosen answer likewise, except where ref's margin lies within the two
      answers' e2e bounds; both counted;
    - each generated stream by the near-tie rule (each token at most
      SPEC_TIE x ``tol_max`` x its row's largest |logit| below the row's
      f32 argmax, over the stream's own context);
    - the task metrics: the evaluator's over ref's scores (the run's
      generations replayed), accuracies apart from the counted near ties,
      perplexities between those over ref's scores -/+ their e2e bounds.

    Raises HoldFailed outside it; returns the measurements."""
    from omniquant_tpu_torch.eval.harness import evaluate, get_task_dict

    rec = lm.record
    pairs, owners = _scored_pairs(lm, rec)
    n_ll = len(rec["loglikelihood"]["requests"])

    def stats(params, rows=False):
        # in the run's chunks: the loglikelihood requests in one call, each
        # rolling request's windows in one call of their own
        out = []
        for idx in [range(n_ll)] + owners:
            out += _token_stats(torch, family, cfg, params, spec,
                                [pairs[k] for k in idx], lm.seqlen,
                                lm.batch_size, device, rows=rows)
        return out

    got, want, p16 = stats(lm.params), stats(ref, True), stats(plain16)
    res = {}
    # the re-scored chunks are the run's: the same sums, bit for bit up to
    # the summation order
    replay = [float(g["lp"].sum()) for g in got[:n_ll]]
    res["rescore_max_abs"] = max(
        abs(a - b[0]) for a, b in zip(replay, rec["loglikelihood"]["responses"]))
    d_got = torch.cat([g["lp"] - w["lp"] for g, w in zip(got, want)])
    d_p16 = torch.cat([p["lp"] - w["lp"] for p, w in zip(p16, want)])
    res["tokens"] = d_got.numel()
    res["nll_rms_gap"] = d_got.pow(2).mean().sqrt().item()
    res["nll_rms_gap_bf16_forward"] = d_p16.pow(2).mean().sqrt().item()
    bound = [2 * tol_max * w["mag"].sum().item() for w in want]
    failed = []
    if not res["nll_rms_gap"] <= PPL_VS_PLAIN * res["nll_rms_gap_bf16_forward"]:
        failed.append("per-token rms gap")
    if res["rescore_max_abs"] > 1e-3:
        failed.append("re-scored chunks differ from the run's")
    ll_ref, ll_lo, ll_hi, ties, over = {}, {}, {}, 0, []
    limit = SPEC_TIE * tol_max
    for i, (req, (ll, flag)) in enumerate(zip(
            rec["loglikelihood"]["requests"],
            rec["loglikelihood"]["responses"])):
        w = want[i]
        ref_ll = w["lp"].sum().item()
        if abs(ll - ref_ll) > bound[i]:
            over.append(f"loglikelihood {i}")
        ll_ref[tuple(req)] = (ref_ll, bool(w["greedy"].all()))
        ll_lo[tuple(req)] = (ref_ll - bound[i], ll_ref[tuple(req)][1])
        ll_hi[tuple(req)] = (ref_ll + bound[i], ll_ref[tuple(req)][1])
        if flag != ll_ref[tuple(req)][1]:
            flips = got[i]["greedy"] != w["greedy"]
            if (w["top_gap"][flips] / w["mag"][flips]).max() > limit:
                over.append(f"greedy flag {i}")
            ties += 1
    res["flag_near_ties"] = ties
    # multiple-choice docs: the requests of one context, in order
    by_ctx = {}
    for i, (c, _) in enumerate(rec["loglikelihood"]["requests"]):
        by_ctx.setdefault(c, []).append(i)
    mc_ties = 0
    for idx in (v for v in by_ctx.values() if len(v) > 1):
        conts = [rec["loglikelihood"]["requests"][i][1] for i in idx]
        g = [rec["loglikelihood"]["responses"][i][0] for i in idx]
        r = [want[i]["lp"].sum().item() for i in idx]
        for norm in (1.0, None):
            div = [1.0 if norm else float(len(c) - 1) for c in conts]
            a = max(range(len(idx)), key=lambda k: g[k] / div[k])
            b = max(range(len(idx)), key=lambda k: r[k] / div[k])
            if a != b:
                margin = r[b] / div[b] - r[a] / div[a]
                if margin > (bound[idx[a]] / div[a] + bound[idx[b]] / div[b]):
                    over.append(f"choice of context {idx[0]}")
                mc_ties += 1
    res["choice_near_ties"] = mc_ties
    roll_ref, roll_lo, roll_hi = {}, {}, {}
    for req, s, ws in zip(rec["loglikelihood_rolling"]["requests"],
                          rec["loglikelihood_rolling"]["responses"], owners):
        r = sum(want[k]["lp"].sum().item() for k in ws)
        b = sum(bound[k] for k in ws)
        if abs(s - r) > b:
            over.append(f"rolling sum of {len(ws)} windows")
        roll_ref[tuple(req)], roll_lo[tuple(req)], roll_hi[tuple(req)] = (
            r, r - b, r + b)
    # streams: each generated token against the f32 forward over its context
    gen = rec["greedy_until"]
    gaps = text_stream_gaps(torch, family, cfg, ref, spec, lm,
                            gen["requests"], gen["responses"], device)
    res["streams"] = near_tie(gaps, limit) if gaps else dict(tokens=0,
                                                             ok=False)
    if not res["streams"]["ok"]:
        over.append("generated streams")
    # the metrics over ref's scores, and over ref's -/+ the bounds
    gen_map = {(c, tuple(u)): t for (c, u), t in zip(gen["requests"],
                                                     gen["responses"])}
    metrics = {}
    for key, ll, roll in (("ref", ll_ref, roll_ref), ("lo", ll_lo, roll_lo),
                          ("hi", ll_hi, roll_hi)):
        metrics[key] = evaluate(_ReplayLM(ll, roll, gen_map),
                                get_task_dict(list(docs), docs))["results"]
    res["metrics"] = results["results"]
    res["metrics_ref"] = metrics["ref"]
    n_docs = {t: HARNESS_DOCS[t] for t in docs}
    for task, ms in results["results"].items():
        for m, v in ms.items():
            if m.endswith("_stderr"):
                continue
            r = metrics["ref"][task][m]
            if m.startswith("acc"):
                allowed = (mc_ties if task == "piqa" else
                           ties if task == "lambada_openai" else 0)
                ok = abs(v - r) * n_docs[task] <= allowed + 1e-9
            else:
                lo, hi = sorted((metrics["lo"][task][m],
                                 metrics["hi"][task][m]))
                ok = lo - 1e-9 * abs(lo) <= v <= hi + 1e-9 * abs(hi)
            if not ok:
                over.append(f"{task} {m}: {v} against {r}")
    log(f"  harness {label} hold: {res['tokens']} scored tokens, per-token "
        f"rms gap {res['nll_rms_gap']:.4g} (bf16 plain forward "
        f"{res['nll_rms_gap_bf16_forward']:.4g}, at most {PPL_VS_PLAIN} x "
        f"that); greedy flags flipped on near ties: {ties}, choices: "
        f"{mc_ties}; re-scored chunks within {res['rescore_max_abs']:.3g}; "
        f"streams: " + (_log_tie(res["streams"]) if gaps else "none"))
    for task, ms in results["results"].items():
        log(f"    {task}: " + ", ".join(
            f"{m} {v:.4f} (f32 {metrics['ref'][task][m]:.4f})"
            for m, v in ms.items() if not m.endswith("_stderr")))
    if failed or over:
        raise HoldFailed(label, failed + over, res)
    return res


def _faulted(params, layers, factor):
    """``params`` with every PackedWeight scale of ``layers`` x factor."""
    out = dict(params, layers=list(params["layers"]))
    for i in layers:
        out["layers"][i] = {
            k: (dataclasses.replace(v, scales=v.scales * factor)
                if hasattr(v, "scales") else v)
            for k, v in params["layers"][i].items()}
    return out


def harness_run(torch, device, family, cfg, packed, spec, docs, label,
                paths, tol_max) -> tuple:
    """run_tasks (the CLI's --tasks path) on ``packed`` in bf16 through a
    recording TorchLM, with the launch counts set to 0 before it and read
    after it; checks that every kernel of ``paths`` and K1's decode tile
    launched. Returns (results, the LM, the counts, seconds)."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.cli import CharTokenizer
    from omniquant_tpu_torch.eval import harness

    base = harness.TorchLM
    RecordingLM, holder = _recording_lm(torch, base)
    harness.TorchLM = RecordingLM
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.time()
        results = harness.run_tasks(
            family, packed, cfg, CharTokenizer(cfg.vocab_size),
            list(HARNESS_DOCS), spec=spec, task_data=docs, device=device,
            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        run_s = time.time() - t
        counts = kernels.launch_counts()
    finally:
        harness.TorchLM = base
    # popped: the holder, reached from the class's __init__, would keep the
    # LM (its bf16 params and engine) in a cycle until the collector ran
    lm = holder.pop("lm")
    rec = lm.record
    n_win = sum(len(w) for w in _scored_pairs(lm, rec)[1])
    rates = dict(
        loglikelihood_req_s=len(rec["loglikelihood"]["requests"])
        / rec["loglikelihood"]["s"],
        rolling_windows_s=n_win / rec["loglikelihood_rolling"]["s"],
        greedy_until_tok_s=rec["greedy_until"]["tokens"]
        / rec["greedy_until"]["s"],
        loglikelihood_requests=len(rec["loglikelihood"]["requests"]),
        rolling_windows=n_win, generated_tokens=rec["greedy_until"]["tokens"],
        run_s=run_s)
    decode_tile = (counts["quant_matmul"] - counts["quant_matmul_prefill"]
                   - counts["quant_matmul_planar_decode"]
                   - counts["quant_matmul_planar_prefill"])
    log(f"  harness {label}: run_tasks {run_s:.2f} s: loglikelihood "
        f"{rates['loglikelihood_req_s']:.1f} requests/s "
        f"({rates['loglikelihood_requests']}), loglikelihood_rolling "
        f"{rates['rolling_windows_s']:.2f} windows/s ({n_win} of "
        f"{lm.seqlen}), greedy_until {rates['greedy_until_tok_s']:.1f} "
        f"tokens/s ({rates['generated_tokens']}); launches {counts}")
    missing = [k for k in paths if counts[k] <= 0]
    if spec.act is None and decode_tile <= 0:
        missing.append("quant_matmul (decode tile)")
    if missing:
        raise AssertionError(f"harness {label}: kernels never launched on "
                             f"its path: {missing}")
    return results, lm, counts, rates


def harness_checked(torch, device, cfg, packed, docs, label, ref=None):
    """harness_run of W4A16 ``packed`` (OPT, ``cfg``), then harness_hold
    against ``ref`` (by default the pack's own plain f32 forward) and its
    bf16 copy. Returns (the hold's measurements, rates, launches); raises
    HoldFailed outside the hold."""
    from omniquant_tpu_torch.models import OPT
    from omniquant_tpu_torch.models.common import NO_ACT_QUANT
    from omniquant_tpu_torch.serving.engine import _to_engine

    results, lm, counts, rates = harness_run(
        torch, device, OPT, cfg, packed, NO_ACT_QUANT, docs, label,
        HARNESS_PATHS["w4a16"], E2E_TOL["max"])
    ref = plain_reference_params(torch, packed) if ref is None else ref
    try:
        return harness_hold(torch, device, OPT, cfg, lm, results, ref,
                            _to_engine(ref, device, torch.bfloat16),
                            NO_ACT_QUANT, E2E_TOL["max"], docs,
                            label), rates, counts
    finally:
        del lm, ref
        torch.cuda.empty_cache()


def harness_phase(torch, device, cfg, dense, packed, seed, out: dict) -> dict:
    """The harness on OPT-2.7B: W4A16 (``packed``, 32 layers) held token by
    token against the plain f32 forward (harness_hold); the planted faults
    (HARNESS_FAULTS), each held against the plain f32 forward of the pack
    it faults and rejected, the 2-layer one beside the clean 2-layer run;
    then W4A4 at HARNESS_INT_LAYERS layers held the same way at
    E2E_INT_TOL[4]. Returns the launches of the clean 32-layer and W4A4
    runs."""
    from omniquant_tpu_torch.models import OPT
    from omniquant_tpu_torch.models.common import ActQuantSpec
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model
    from omniquant_tpu_torch.serving.engine import _to_engine

    t0 = time.time()
    mem0 = torch.cuda.memory_allocated()
    res = out["harness"] = {}
    docs = harness_docs(seed)
    hold, rates, counts = harness_checked(torch, device, cfg, packed, docs,
                                          "W4A16 g128")
    total = dict(counts)
    res["w4a16"] = dict(rates=rates, launches=counts, **hold)
    faults = res["faults"] = {}
    for name, (n, layer, factor) in HARNESS_FAULTS.items():
        cfg_n = dataclasses.replace(cfg, num_hidden_layers=n)
        clean = dict(packed, layers=packed["layers"][:n])
        ref = plain_reference_params(torch, clean)
        if n < cfg.num_hidden_layers:
            faults[f"clean_{n}_layers"] = harness_checked(
                torch, device, cfg_n, clean, docs, f"W4A16 g128, {n} layers",
                ref)[0]
        try:
            harness_checked(torch, device, cfg_n,
                            _faulted(clean, [layer], factor), docs,
                            f"planted fault {name}", ref)
        except HoldFailed as e:
            faults[name] = dict(e.res, reasons=e.reasons)
            log(f"  harness planted fault {name}: rejected for {e.reasons}")
        else:
            raise AssertionError(f"harness: the hold admitted the planted "
                                 f"fault {name}")
        del ref, clean
        torch.cuda.empty_cache()

    # W4A4 at HARNESS_INT_LAYERS layers on planar words (K7 below 2048 rows)
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=HARNESS_INT_LAYERS)
    dense2 = dict(dense, layers=dense["layers"][:HARNESS_INT_LAYERS])
    packed2 = pack_model(OPT, dense2, QuantConfig(n_bits=4, group_size=128),
                         layout="planar", device=device)
    spec = ActQuantSpec.from_bits(4)
    tol4 = E2E_INT_TOL[4]["max"]
    results, lm, counts, rates = harness_run(
        torch, device, OPT, cfg2, packed2, spec, docs, "W4A4",
        HARNESS_PATHS["w4a4"], tol4)
    total = {k: v + counts[k] for k, v in total.items()}
    ref = plain_reference_params(torch, packed2)
    hold = harness_hold(torch, device, OPT, cfg2, lm, results, ref,
                        _to_engine(ref, device, torch.bfloat16), spec, tol4,
                        docs, "W4A4")
    res["w4a4"] = dict(rates=rates, launches=counts, **hold)
    del lm, ref, packed2
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - mem0) / 2**30
    if left > 0.5:
        raise AssertionError(f"harness: {left:.2f} GiB still allocated after "
                             "the phase: a TorchLM or engine was kept")
    res["launches"] = total
    res["phase_s"] = time.time() - t0
    log(f"  harness phase {res['phase_s']:.1f} s")
    return total


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
# run name -> (net, extra flags): the three nets (tiny-llama also writes
# the AutoGPTQ checkpoint), and tiny-llama again with sequence-parallel
# calibration over 2 shards on the card (--sp 2)
CLI_RUNS = {"tiny-opt": ("tiny-opt", ()),
            "tiny-llama": ("tiny-llama", ("--export_autogptq",)),
            "tiny-falcon": ("tiny-falcon", ()),
            "tiny-llama-sp2": ("tiny-llama", ("--sp", "2"))}
# the --sp 2 run's K2 stats launches: 2 layers x 8 windows x 2 capture
# passes x 3 ring blocks; its perplexity within CLI_SP_PPL_RTOL of the run
# without --sp (its capture passes attend in bf16, so the two calibrations
# may drift apart; equal in PERF.md's runs, PR 21)
CLI_SP_STATS, CLI_SP_PPL_RTOL = 2 * 8 * 2 * 3, 1e-3
CLI_ARGS = ("--synthetic", "--wbits", "4", "--abits", "16", "--group_size",
            "64", "--lwc", "--epochs", "2", "--nsamples", "8", "--seqlen",
            "256", "--eval_ppl", "--real_quant", "--max_new_tokens", "16")
CLI_PROMPT = "The quick brown fox jumps over the lazy dog"
CLI_PATHS = ("quant_matmul", "kv_cache_prefill_write", "kv_cache_write")
CLI_DENSE = {"tiny-opt": "qkv (N 192), out_proj and fc2 (N 64)",
             "tiny-llama": "o_proj and down_proj (N 64)",
             "tiny-falcon": "query_key_value (N 96), dense and dense_4h_to_h "
                            "(N 64)"}


def autogptq_hold(save_dir: str, family: str) -> dict:
    """The CLI's model_autogptq.pt decoded by unpack_autogptq, linear by
    linear, against its model_packed.npz dequantized with the scales
    rounded to f16 as the wire holds them: equal bit for bit."""
    import numpy as np
    import torch

    from omniquant_tpu_torch.quant import dequantize_packed
    from omniquant_tpu_torch.serving import export_autogptq as ag
    from omniquant_tpu_torch.utils import load_packed_npz

    sd = torch.load(os.path.join(save_dir, "model_autogptq.pt"),
                    weights_only=True)
    packed = load_packed_npz(os.path.join(save_dir, "model_packed.npz"),
                             device="cpu")
    held, worst = 0, 0.0
    for i, block in enumerate(packed["layers"]):
        prefix = ag._LAYER_PREFIX[family].format(i=i)
        for key, path in ag._LINEAR_NAMES[family].items():
            pw = block[key]
            tensors = {t: sd[f"{prefix}{path}.{t}"].numpy()
                       for t in ("qweight", "qzeros", "scales", "g_idx")}
            got = ag.unpack_autogptq(tensors, pw.bits)
            f16 = dataclasses.replace(
                pw, scales=pw.scales.half().float(), bias=None)
            want = dequantize_packed(f16, dtype=torch.float32)[
                :pw.in_features].numpy()
            worst = max(worst, float(np.abs(got - want).max()))
            held += 1
    if worst != 0.0:
        raise AssertionError(f"model_autogptq.pt: {held} linears, largest "
                             f"difference {worst} from the packed weights")
    return dict(linears=held, tensors=len(sd), max_abs_err=worst)


def cli_phase(out: dict) -> None:
    """The CLI_RUNS as subprocesses started together, each in a fresh
    directory under the git-ignored build/ with its output in files there:
    each must exit 0, end with a results JSON holding a finite synthetic
    perplexity and a generation, and log the launch of every kernel of
    CLI_PATHS; the --sp 2 run must log its mesh, launch K2 with stats
    CLI_SP_STATS times and give tiny-llama's perplexity within
    CLI_SP_PPL_RTOL; tiny-llama's model_autogptq.pt must decode to its
    model_packed.npz (autogptq_hold). A run still going after 600 s is
    killed and fails."""
    import re
    import shutil

    res = out["cli"] = {}
    env = dict(os.environ, PYTHONPATH=HERE)
    runs = {}
    try:
        for run, (net, extra) in CLI_RUNS.items():
            d = os.path.join(HERE, "build", "cli_smoke", run)
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            cmd = [sys.executable, "-m", "omniquant_tpu_torch", "--net", net,
                   *CLI_ARGS, *extra, "--serve_prompt", CLI_PROMPT,
                   "--save_dir", os.path.join(d, "save"),
                   "--output_dir", os.path.join(d, "out"),
                   "--cache_dir", os.path.join(d, "cache")]
            logs = [open(os.path.join(d, f), "w+")
                    for f in ("stdout.log", "stderr.log")]
            runs[run] = dict(logs=logs, t=time.time(), wall=None,
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
    for run, r in runs.items():
        net = CLI_RUNS[run][0]
        for f in r["logs"]:
            f.seek(0)
        stdout, stderr = (f.read() for f in r["logs"])
        for f in r["logs"]:
            f.close()
        wall = r["wall"]
        if r["p"].returncode != 0:
            log(stdout[-4000:])
            log(stderr[-4000:])
            raise AssertionError(f"cli {run}: exit code {r['p'].returncode}")
        last = json.loads(stdout.strip().splitlines()[-1])
        counts = json.loads(re.search(r"kernel launches: (\{.*\})",
                                      stdout).group(1))
        res[run] = dict(results=last, launches=counts, wall_s=wall,
                        mesh_logged="sequence-parallel calibration over "
                                    "2 devices" in stdout)
        log(f"  cli {run}: exit 0 in {wall:.1f} s (the {len(runs)} runs "
            f"together); synthetic ppl {last.get('synthetic')}, generation "
            f"{last.get('generation')!r}; launches {counts}; at these widths "
            f"{CLI_DENSE[net]} take the dense reference, as in the JAX "
            "package (N % 128 != 0)")
        if not (math.isfinite(last.get("synthetic", math.nan))
                and len(last.get("generation", "")) == 16):
            raise AssertionError(f"cli {run}: results {last}")
        missing = [k for k in CLI_PATHS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"cli {run}: kernels never launched: "
                                 f"{missing}")
    sp, one = res["tiny-llama-sp2"], res["tiny-llama"]
    gap = abs(sp["results"]["synthetic"] / one["results"]["synthetic"] - 1)
    sp["ppl_rel_gap"] = gap
    log(f"  cli tiny-llama-sp2: mesh logged {sp['mesh_logged']}, K2 stats "
        f"launches {sp['launches']['flash_attention_stats']} (the schedule's "
        f"{CLI_SP_STATS}), perplexity {gap:.3g} relative from the run "
        f"without --sp (tol {CLI_SP_PPL_RTOL})")
    if not (sp["mesh_logged"] and gap <= CLI_SP_PPL_RTOL and
            sp["launches"]["flash_attention_stats"] == CLI_SP_STATS):
        raise AssertionError(f"cli tiny-llama-sp2: {sp}")
    ag = res["tiny-llama"]["autogptq"] = autogptq_hold(
        os.path.join(HERE, "build", "cli_smoke", "tiny-llama", "save"),
        "llama")
    log(f"  cli tiny-llama --export_autogptq: model_autogptq.pt "
        f"({ag['tensors']} tensors) decodes to model_packed.npz on all "
        f"{ag['linears']} linears, largest difference {ag['max_abs_err']}")


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
# ---------------------------------------------------------------------------
# sp phase: sequence-parallel calibration (calib/engine.py, calibrate(...,
# sp_mesh=...)), ring attention (parallel/ring_attention.py) and K2 with
# its softmax stats (return_stats), all shards on the one card.
# LLaMA-2-7B's published widths (meta-llama/Llama-2-7b-hf: vocab 32000,
# hidden 4096, intermediate 11008, 32 heads on 32 kv heads, 4096
# positions, rms eps 1e-5), depth cut to 2 layers, random seeded weights
SP_LLAMA = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                num_hidden_layers=2, num_attention_heads=32,
                num_key_value_heads=32, max_position_embeddings=4096,
                rms_norm_eps=1e-5)
# K2 with stats at the ring's block shapes: seqlen 4096 at sp 2 (2048-row
# blocks) and sp 4 (1024), and OPT-2.7B's heads of 80 at sp 2 of 2048;
# each causal (the ring's diagonal) and not (an off-diagonal block)
SP_K2 = ((1, 32, 2048, 128), (1, 32, 1024, 128), (1, 32, 1024, 80))
SP_RING_LEN, SP_RING_SHARDS = 4096, (2, 4)
# name -> (family, seqlen, shards); each calibrates W4A16 g128 LWC on
# SP_NSAMPLES windows, with and without sp_mesh, then SP_HELD windows
SP_CALIB_RUNS = {"llama2_7b_4096_sp2": ("llama", 4096, 2),
                 "opt27b_2048_sp2": ("opt", 2048, 2)}
SP_CALIB = dict(wbits=4, abits=16, group_size=128, lwc=True, epochs=2,
                batch_size=1, lwc_lr=1e-2)
SP_NSAMPLES, SP_HELD = 4, 2
# the SP run against the run without sp_mesh on the same card and windows.
# The capture passes attend in bf16 (K2) where the single-device run's
# dense attention is f32, so the targets move by bf16 noise and the two
# runs drift apart by that much: layer 0's fp capture of window 0 within
# SP_CAPTURE_RMS rms relative; losses within SP_LOSS_RTOL relative; LWC
# factors within SP_LWC_RMS rms; folded weights apart by more than a 1e-4
# share of the tensor's largest on at most SP_WEIGHT_SHARE of them, and
# the packed codes equal but on at most SP_CODE_SHARE of them. Each limit
# sits 3.4-10 times above the sound runs' largest reading and below what
# each planted fault (SP_FAULTS) reads on the checks it moves (PERF.md,
# PR 21)
SP_CAPTURE_RMS, SP_LOSS_RTOL, SP_LWC_RMS = 2e-2, 5e-3, 2e-3
SP_WEIGHT_SHARE, SP_CODE_SHARE = 2e-4, 1e-4
# planted faults, each an SP run that the checks above must reject: the
# last shard's MSE left out of the train loss, and (LLaMA, whose blocks
# apply RoPE; OPT's positions are in its embedding) every shard's block
# run at local positions 0 .. S/n - 1
SP_FAULTS = {"llama": ("drop_last_mse", "local_positions"),
             "opt": ("drop_last_mse",)}


def _stats_row(torch, device, timer, B, H, S, D, causal) -> dict:
    """K2 with stats at (B, H, S, D) against its plain version (out at K2's
    rule, bit for bit the output without stats; m and l at
    tolerance.flash_stats_close), timed with and without stats beside the
    plain version, aten's flash attention with its logsumexp (the library
    call; timed only) and the bound."""
    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    gen = torch.Generator(device=device).manual_seed(S + D + causal)
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device=device).to(
        torch.bfloat16) for _ in range(3))
    kw = dict(sm_scale=D ** -0.5, causal=causal)
    out, m, l = flash_attention(q, k, v, return_stats=True, **kw)
    alone = flash_attention(q, k, v, **kw)
    want, m_p, l_p = flash_attention_plain(q, k, v, return_stats=True, **kw)
    ok, err, worst = tolerance.bf16_close(
        out, want, tolerance.flash_attention_slack(q, k, v, **kw))
    s_ok, dm, rel_l, s_worst = tolerance.flash_stats_close(m, l, m_p, l_p)
    same = torch.equal(alone, out)
    del out, m, l, alone, want, m_p, l_p
    shape = f"({B},{H},{S},{D}) {'causal' if causal else 'not causal'}"
    if not (ok and s_ok and same):
        raise AssertionError(
            f"flash_attention stats {shape}: out within K2's rule {ok} "
            f"({worst:.3g}), stats {s_ok} ({s_worst:.3g}), out equal to the "
            f"call without stats {same}")
    t = timer(lambda: flash_attention(q, k, v, return_stats=True, **kw),
              "flash_attention stats")
    t_alone = timer(lambda: flash_attention(q, k, v, **kw),
                    "flash_attention")
    t_plain = timer(lambda: flash_attention_plain(q, k, v, return_stats=True,
                                                  **kw),
                    "flash_attention stats plain", iters=3)
    t_lib = timer(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=D ** -0.5),
        "flash_attention stats library")
    nbytes = 4 * q.numel() * 2 + 2 * B * H * S * 4
    flops = 4.0 * B * H * S * S * D / (2 if causal else 1)
    b, by = bound_ms(nbytes, flops)
    log(f"  flash_attention stats {shape}: out max abs err {err:.3g} "
        f"({worst:.3g} x bound), m max abs err {dm:.3g}, l max rel err "
        f"{rel_l:.3g} ({s_worst:.3g} x bound); kernel {t:.4f} ms (without "
        f"stats {t_alone:.4f}), plain {t_plain:.4f}, aten flash with "
        f"logsumexp {t_lib:.4f}, bound {b:.4f} ({by})")
    return dict(ms=t, ms_without_stats=t_alone, plain_ms=t_plain,
                library_ms=t_lib, bound_ms=b, bound_by=by, max_abs_err=err,
                err_over_bound=worst, stats_m_max_abs_err=dm,
                stats_l_max_rel_err=rel_l, stats_over_bound=s_worst,
                shape=f"q {shape} bf16")


def _ring_row(torch, device, timer, S, sp) -> dict:
    """Ring attention over sp shards of an S-token sequence on ``device``
    (LLaMA-7B's 32 heads of 128, bf16): the flash ring (K2 with stats,
    sp (sp + 1) / 2 launches) and the plain ring against the plain attention
    over the whole sequence at K2's rule, and the flash ring against K2
    causal over the whole sequence at twice that rule (each lies within it
    of the plain attention); on f32 q/k/v, what the flash ring's bf16 cast
    costs against the plain f32 ring; device times of the three."""
    import importlib

    from omniquant_tpu_torch.kernels import tolerance
    from omniquant_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    ra = importlib.import_module("omniquant_tpu_torch.parallel.ring_attention")

    gen = torch.Generator(device=device).manual_seed(S + sp)
    q, k, v = (torch.randn(1, 32, S, 128, generator=gen, device=device).to(
        torch.bfloat16) for _ in range(3))
    mesh = [device] * sp
    before = flash_attention.launches_stats
    flash = ra.ring_attention(q, k, v, mesh, impl="flash")
    launched = flash_attention.launches_stats - before
    plain = ra.ring_attention(q, k, v, mesh, impl="plain")
    full = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    slack = tolerance.flash_attention_slack(q, k, v)
    # against K2: twice K2's rule (bf16_close adds 2 ulps of |K2| itself)
    held = {"flash vs plain": tolerance.bf16_close(flash, want, slack),
            "plain ring vs plain": tolerance.bf16_close(plain, want, slack),
            "flash vs K2 whole": tolerance.bf16_close(
                flash, full, 2 * slack + 2 * tolerance.bf16_ulp(want))}
    del flash, plain, full, want, slack
    log(f"  ring sp {sp} over {S} tokens: " + "; ".join(
        f"{k_} max abs err {e:.3g} ({w:.3g} x bound)"
        for k_, (_, e, w) in held.items())
        + f"; K2 stats launches {launched}")
    bad = [k_ for k_, (ok, _, _) in held.items() if not ok]
    if bad or launched != sp * (sp + 1) // 2:
        raise AssertionError(f"ring sp {sp}: {bad or 'launches'} "
                             f"({launched} K2 launches)")
    # what the bf16 cast at K2 costs on f32 q/k/v (calibration's buffers):
    # the flash ring against the plain f32 ring
    q32, k32, v32 = (torch.randn(1, 32, S, 128, generator=gen,
                                 device=device) for _ in range(3))
    cast = ra.ring_attention(q32, k32, v32, mesh, impl="flash")
    f32 = ra.ring_attention(q32, k32, v32, mesh, impl="plain")
    cast_err = dict(rms_rel=rms_rel_err(cast, f32),
                    max_abs=(cast - f32).abs().max().item())
    del q32, k32, v32, cast, f32
    log(f"  ring sp {sp} on f32 q/k/v: the flash ring (K2 in bf16) against "
        f"the plain f32 ring: rms rel {cast_err['rms_rel']:.3g}, max abs "
        f"{cast_err['max_abs']:.3g}")
    t_flash = timer(lambda: ra.ring_attention(q, k, v, mesh, impl="flash"),
                    f"ring flash sp {sp}", iters=5)
    t_plain = timer(lambda: ra.ring_attention(q, k, v, mesh, impl="plain"),
                    f"ring plain sp {sp}", iters=3)
    t_k2 = timer(lambda: flash_attention(q, k, v), "flash_attention")
    log(f"  ring sp {sp}: flash {t_flash:.4f} ms, plain {t_plain:.4f} ms, "
        f"K2 causal over the whole sequence {t_k2:.4f} ms")
    return dict(flash_ms=t_flash, plain_ms=t_plain, k2_whole_ms=t_k2,
                k2_launches=launched, bf16_cast_error=cast_err,
                held={k_: dict(max_abs_err=e, over_bound=w)
                      for k_, (_, e, w) in held.items()})


def _code_share(torch, family, a, b) -> float:
    """The share of the packed codes of pack ``a`` that differ from
    ``b``'s, over every linear of every layer."""
    from omniquant_tpu_torch.quant.packing import unpack_codes

    diff = total = 0
    for la, lb in zip(a["layers"], b["layers"]):
        for n in family.linear_names:
            ca, cb = (unpack_codes(p.qweight, p.bits, p.in_features,
                                   p.group_size, p.tile_k, p.layout)
                      for p in (la[n], lb[n]))
            diff += (ca != cb).sum().item()
            total += ca.numel()
    return diff / total


def _sp_family(torch, family, capture, fault):
    """``family`` with a block_forward that keeps, per positions tensor,
    the output of its first call under no_grad (layer 0's fp capture of
    window 0: the whole sequence without sp_mesh, a shard's block with it)
    in ``capture``, and, for the planted fault "local_positions", runs
    every shard's block at positions 0 .. S/n - 1."""
    import dataclasses

    inner = family.block_forward

    def block_forward(layer, x, cfg, mask, positions, *a, **kw):
        pos = positions
        if fault == "local_positions" and kw.get("attn_impl") is not None:
            pos = positions - positions[:1]
        y = inner(layer, x, cfg, mask, pos, *a, **kw)
        if not torch.is_grad_enabled() and id(positions) not in capture:
            capture[id(positions)] = (positions, y[0][0].clone())
        return y

    return dataclasses.replace(family, block_forward=block_forward)


def _sp_calibrate(torch, device, family, cfg, dense, train, cc, mesh,
                  fault=None) -> dict:
    """calibrate on a copy of ``dense`` with ``sp_mesh=mesh`` (None: the
    single-device run) and ``fault`` planted (SP_FAULTS; "drop_last_mse"
    takes the last shard's terms out of the train loss; "no_shift_back",
    on a mesh over ranks, zeroes the gradients rank 1's ring shifts back):
    its params, omni
    parameters, losses, timings, peak GiB, launches, ring calls and layer
    0's fp capture of window 0, (S, hidden)."""
    import importlib
    import statistics

    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.calib import calibrate
    ra = importlib.import_module("omniquant_tpu_torch.parallel.ring_attention")

    params = dict(dense, layers=[
        {k: {n: (None if t is None else t.clone()) for n, t in v.items()}
         for k, v in b.items()} for b in dense["layers"]])
    losses, timings, capture = [], {}, {}
    run = ra.SPMesh.run

    def drop_last(self, fn, *shard_args):
        res = run(self, fn, *shard_args)
        return res[:-1] if isinstance(res[-1], list) else res

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    calls = dict(ra.ring_attention_local.calls)
    mesh_mod = importlib.import_module("omniquant_tpu_torch.parallel.mesh")
    exchange = mesh_mod.Mesh._exchange

    def no_shift_back(self, xs, step):
        # rank 1 hands zeros back in place of the dk/dv of the blocks it
        # received (a backward with no shift): the exchange still happens
        if step < 0 and torch.distributed.get_rank() == 1:
            xs = [torch.zeros_like(x) for x in xs]
        return exchange(self, xs, step)

    if fault == "drop_last_mse":
        ra.SPMesh.run = drop_last
    if fault == "no_shift_back":
        mesh_mod.Mesh._exchange = no_shift_back
    t0 = time.time()
    try:
        params, omni = calibrate(
            _sp_family(torch, family, capture, fault), params, cfg, train,
            cc, device=device, timings=timings, sp_mesh=mesh,
            progress_cb=lambda i, e, x: losses.append(x))
        torch.cuda.synchronize()
    finally:
        ra.SPMesh.run = run
        mesh_mod.Mesh._exchange = exchange
    return dict(
        params=params, omni=omni, losses=losses, phase_s=time.time() - t0,
        steps=len(timings["step_s"]),
        step_s=statistics.median(timings["step_s"][1:]),
        fp_pass_s=timings["fp_pass_s"], propagate_s=timings["propagate_s"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=kernels.launch_counts(),
        ring_calls={k: v - calls[k]
                    for k, v in ra.ring_attention_local.calls.items()},
        capture=torch.cat([y for _, y in sorted(
            capture.values(), key=lambda c: int(c[0][0]))]))


def _sp_readings(torch, device, family, cfg, wcfg, run, one, held,
                 dense) -> dict:
    """``run`` (an SP run) against ``one`` (the single-device run): layer
    0's fp capture gap (rms relative), the losses' largest relative gap,
    the LWC factors' rms gap, the shares of folded weights and of packed
    codes apart, the held-out last-block MSE of both and of
    round-to-nearest, and the checks that fail."""
    import dataclasses

    from omniquant_tpu_torch.models.common import NO_ACT_QUANT
    from omniquant_tpu_torch.serving import pack_model

    layers = cfg.num_hidden_layers
    capture = ((run["capture"] - one["capture"]).pow(2).mean().sqrt()
               / one["capture"].pow(2).mean().sqrt()).item()
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(run["losses"], one["losses"]))
    d = torch.cat([(run["omni"][i]["lwc"][n][f] - one["omni"][i]["lwc"][n][f])
                   .flatten() for i in range(layers)
                   for n in family.linear_names
                   for f in one["omni"][i]["lwc"][n]])
    lwc_rms = d.pow(2).mean().sqrt().item()
    apart = max((
        ((run["params"]["layers"][i][n]["weight"]
          - one["params"]["layers"][i][n]["weight"]).abs()
         > 1e-4 * one["params"]["layers"][i][n]["weight"].abs().max())
        .float().mean().item())
        for i in range(layers) for n in family.linear_names)
    with torch.no_grad():
        packs = [pack_model(family, r["params"], wcfg, r["omni"],
                            device=device) for r in (run, one)]
        codes = _code_share(torch, family, *packs)
        del packs
        rtn_cfg = dataclasses.replace(wcfg, lwc=False)
        rtn = [family.effective_block_weights(b, rtn_cfg, None, None, cfg)
               for b in dense["layers"]]
        mse = {"sp": 0.0, "single": 0.0, "rtn": 0.0}
        for w in held:
            x = family.embed(dense, torch.as_tensor(w, device=device)[None],
                             cfg)
            fp = _chain(torch, family, cfg, dense["layers"], x, NO_ACT_QUANT)
            for key, ls in (("sp", run["params"]["layers"]),
                            ("single", one["params"]["layers"]),
                            ("rtn", rtn)):
                mse[key] += (_chain(torch, family, cfg, ls, x, NO_ACT_QUANT)
                             - fp).pow(2).mean().item() / len(held)
        del rtn, fp, x
    failed = [what for what, bad in (
        ("capture", not capture <= SP_CAPTURE_RMS),
        ("losses", not all(map(math.isfinite, run["losses"]))
         or not loss_gap <= SP_LOSS_RTOL),
        ("lwc", not lwc_rms <= SP_LWC_RMS),
        ("weights", not apart <= SP_WEIGHT_SHARE),
        ("codes", not codes <= SP_CODE_SHARE),
        ("held-out", not mse["sp"] < mse["rtn"])) if bad]
    return dict(capture_rms_gap=capture, loss_max_rel_gap=loss_gap,
                lwc_rms_gap=lwc_rms, weights_apart_share=apart,
                codes_apart_share=codes, held_out_mse=mse, failed=failed)


def sp_calib_run(torch, device, name, family, cfg, dense, seed,
                 keep: dict = None) -> dict:
    """One SP_CALIB_RUNS entry: calibrate ``dense`` without and with
    sp_mesh = [device] * shards on the same windows, each with its seconds
    a step, peak GiB and launches; the SP run's K2 launches, all with
    stats, must number layers x windows x 2 passes x shards (shards + 1) /
    2, its flash ring calls layers x windows x 2 and its plain ring calls
    its train steps (none on the capture passes). Then the SP run is held
    against the single-device one (SP_CAPTURE_RMS, SP_LOSS_RTOL,
    SP_LWC_RMS, SP_WEIGHT_SHARE, SP_CODE_SHARE, and its held-out MSE below
    round-to-nearest's), and each planted fault of SP_FAULTS, run and read
    the same way, must fail a check."""
    from omniquant_tpu_torch.calib import (
        CalibConfig, get_synthetic, sample_windows)

    _, seqlen, shards = SP_CALIB_RUNS[name]
    train, test = get_synthetic(SP_NSAMPLES, seed, seqlen,
                                vocab_size=cfg.vocab_size)
    held = sample_windows(test, SP_HELD, seed + 1, seqlen)
    cc = CalibConfig(nsamples=SP_NSAMPLES, **SP_CALIB)
    layers = cfg.num_hidden_layers
    runs = {}
    for key, mesh, fault in (
            ("single", None, None), ("sp", [device] * shards, None),
            *((f, [device] * shards, f) for f in SP_FAULTS[family.name])):
        r = runs[key] = _sp_calibrate(torch, device, family, cfg, dense,
                                      train, cc, mesh, fault)
        log(f"  sp {name} {key}: {r['steps']} steps, {r['step_s']:.4f} s a "
            f"step; fp pass " + ", ".join(f"{t:.3f}" for t in r["fp_pass_s"])
            + " s, propagation " + ", ".join(f"{t:.3f}" for t in
                                             r["propagate_s"])
            + f" s a layer; phase {r['phase_s']:.1f} s; peak "
            f"{r['peak_gib']:.2f} GiB; K2 launches "
            f"{r['launches']['flash_attention']} (with stats "
            f"{r['launches']['flash_attention_stats']}), ring calls "
            f"{r['ring_calls']}; losses " + ", ".join(
                f"{x:.6e}" for x in r["losses"]))
    one, sp = runs["single"], runs["sp"]
    if keep is not None and name == MP_SP_RUN:
        keep[name] = dict(
            capture=sp["capture"].cpu(), losses=sp["losses"],
            lwc=_lwc_flat(torch, family, sp["omni"], cfg).cpu(),
            step_s=sp["step_s"], peak_gib=sp["peak_gib"],
            single_step_s=one["step_s"], single_peak_gib=one["peak_gib"])
    steps = sp["steps"]
    stats = layers * SP_NSAMPLES * 2 * shards * (shards + 1) // 2
    want = dict(stats=stats, k2=stats, flash=layers * SP_NSAMPLES * 2,
                plain=steps)
    got = dict(stats=sp["launches"]["flash_attention_stats"],
               k2=sp["launches"]["flash_attention"],
               flash=sp["ring_calls"]["flash"],
               plain=sp["ring_calls"]["plain"])
    if got != want or one["launches"]["flash_attention"] or any(
            one["ring_calls"].values()):
        raise AssertionError(f"sp {name}: launches {got}, the schedule's "
                             f"{want}; single-device run "
                             f"{one['launches']['flash_attention']}, "
                             f"{one['ring_calls']}")
    readings = {key: _sp_readings(torch, device, family, cfg,
                                  cc.weight_quant_config, r, one, held, dense)
                for key, r in runs.items() if key != "single"}
    for key, rd in readings.items():
        mse = rd["held_out_mse"]
        log(f"  sp {name} {key} against single-device: layer 0's fp capture "
            f"rms gap {rd['capture_rms_gap']:.3g} (tol {SP_CAPTURE_RMS}); "
            f"losses max rel gap {rd['loss_max_rel_gap']:.3g} (tol "
            f"{SP_LOSS_RTOL}); LWC factors rms gap {rd['lwc_rms_gap']:.3g} "
            f"(tol {SP_LWC_RMS}); folded weights apart on "
            f"{rd['weights_apart_share']:.3g} (tol {SP_WEIGHT_SHARE}), "
            f"packed codes on {rd['codes_apart_share']:.3g} (tol "
            f"{SP_CODE_SHARE}); "
            "held-out "
            f"last-block MSE sp {mse['sp']:.6e}, single {mse['single']:.6e}, "
            f"round-to-nearest {mse['rtn']:.6e}; failed {rd['failed']}")
    log(f"  sp {name}: a step {sp['step_s']:.4f} s against "
        f"{one['step_s']:.4f}, peak {sp['peak_gib']:.2f} GiB against "
        f"{one['peak_gib']:.2f}")
    res = dict(
        seqlen=seqlen, shards=shards, layers=layers, nsamples=SP_NSAMPLES,
        config=SP_CALIB, steps=steps,
        **{f"{k}_{m}": runs[k][m] for k in ("single", "sp")
           for m in ("step_s", "peak_gib", "phase_s", "losses", "fp_pass_s",
                     "propagate_s")},
        launches=got, **readings.pop("sp"), faults=readings)
    del runs, sp, one
    torch.cuda.empty_cache()
    admitted = [f for f, rd in readings.items() if not rd["failed"]]
    if res["failed"] or admitted:
        raise AssertionError(f"sp {name}: failed {res['failed']}; planted "
                             f"faults admitted {admitted}")
    return res


def _lwc_flat(torch, family, omni, cfg):
    """Every LWC factor of a calibration's omni parameters, in one f32
    vector (layers, linears, factors in order)."""
    return torch.cat([omni[i]["lwc"][n][f].float().flatten()
                      for i in range(cfg.num_hidden_layers)
                      for n in family.linear_names
                      for f in sorted(omni[i]["lwc"][n])])


def sp_phase(torch, device, seed, out: dict, keep: dict = None) -> dict:
    """(a) K2 with stats at SP_K2's shapes, causal and not, against its plain
    version and timed; (b) the ring over SP_RING_LEN tokens at
    SP_RING_SHARDS; (c) SP calibration of LLaMA-2-7B widths at 4096 tokens
    and (d) of OPT-2.7B widths at 2048 (SP_CALIB_RUNS), each against the
    single-device run. Returns the launch counts of the SP runs (the main
    path's): K2's, and those of them with stats. ``keep`` receives
    MP_SP_RUN's SP run (capture, losses, LWC factors, seconds a step, peak
    GiB) for the mp phase."""
    from omniquant_tpu_torch.models import LLAMA, OPT, llama, opt

    res = out["sp"] = {}
    timer = Timer(torch, device)
    res["k2_stats"] = {f"{s}{'' if c else ' not causal'}": _stats_row(
        torch, device, timer, *s, c) for s in SP_K2 for c in (True, False)}
    res["ring"] = {sp: _ring_row(torch, device, timer, SP_RING_LEN, sp)
                   for sp in SP_RING_SHARDS}
    res["host_in_window"] = timer.host_in_window
    del timer
    torch.cuda.empty_cache()
    counts = {}
    for name, (fam, _, _) in SP_CALIB_RUNS.items():
        if fam == "llama":
            family, cfg = LLAMA, llama.LlamaConfig(**SP_LLAMA)
            gen = torch.Generator(device=device).manual_seed(seed + 21)
            dense = llama.init_params(gen, cfg, dtype=torch.float32,
                                      device=device)
        else:
            family = OPT
            cfg = opt.OPTConfig(**dict(OPT_27B, num_hidden_layers=2))
            dense = opt_dense(torch, device, cfg, seed + 21)
        r = res[name] = sp_calib_run(torch, device, name, family, cfg, dense,
                                     seed, keep)
        for k, v in (("flash_attention", "k2"),
                     ("flash_attention_stats", "stats")):
            counts[k] = counts.get(k, 0) + r["launches"][v]
        del dense
        torch.cuda.empty_cache()
    return counts


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


# ---------------------------------------------------------------------------
# tp phase: tensor-parallel serving (serving/tp_engine.py), every shard on
# the one card. LLaMA-2-70B's published widths (meta-llama/Llama-2-70b-hf
# config.json: vocab 32000, hidden 8192, intermediate 28672, 64 heads on 8
# kv heads of 128, 4096 positions, rms eps 1e-5), depth cut to
# TP_70B_LAYERS of its 80 layers, at tp 8: the north star's geometry (W3
# g128, int8 KV, batch 8, max_len 2048; scripts/rehearse_70b.py), packed
# layer by layer as that script lays it out (o_proj and down_proj planar,
# whose packed rows split 8 ways on whole tiles; the others pairs). Then
# LLaMA-2-7B's widths at 2 layers and tp 2 (intermediate 11008, padded to
# 11264 by pad_intermediate_packed): W4A16 (pairs, auto layout) and W4A4
# on a planar W4 g128 pack (K7 at decode, K8 + K9 at the 2048-row
# prefill, the column-parallel inputs' ranges through the min/max
# all-reduce). Random weights from seeded generators.
LLAMA2_70B = dict(vocab_size=32000, hidden_size=8192, intermediate_size=28672,
                  num_hidden_layers=80, num_attention_heads=64,
                  num_key_value_heads=8, max_position_embeddings=4096,
                  rms_norm_eps=1e-5)
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=2, num_attention_heads=32,
                 num_key_value_heads=32, max_position_embeddings=4096,
                 rms_norm_eps=1e-5)
TP_70B_LAYERS = 8
TP_BATCH, TP_PROMPT_LEN, TP_MAX_LEN = 8, 256, 2048  # prefill m = 2048 < 4096
TP_DISPATCHES = 2   # timed step_n(., 8) dispatches a run
# run -> (model, tp, KV dtype, activation bits)
TP_RUNS = {"7b_w4a16": ("7b", 2, "native", 16),
           "7b_w4a4": ("7b", 2, "native", 4),
           "70b_bf16": ("70b", 8, "native", 16),
           "70b_int8": ("70b", 8, "int8", 16)}
_TP_ATTN_KV = ("kv_cache_prefill_write", "flash_attention", "kv_cache_write",
               "kv_cache_write_span", "decode_attention_int8")
# kernels every shard launches: K1's decode tile at m = 8 and its prefill
# tile at m = 2048 (pairs: quant_matmul_prefill), K2 at the 256-token
# prefill, K3, K4 at the first decode; int8: K5 flushes step_n's rings and
# K6 attends; W4A4: K8 + K9 on the row-parallel prefill, K7 on the
# row-parallel decode, planar K1 on the column-parallel sites
_TP_A16 = ("quant_matmul", "flash_attention", "kv_cache_prefill_write",
           "kv_cache_write")
TP_PATHS = {"70b_bf16": _TP_A16 + ("quant_matmul_prefill",
                                   "quant_matmul_planar_decode",
                                   "quant_matmul_planar_prefill"),
            "7b_w4a16": _TP_A16 + ("quant_matmul_prefill",),
            "7b_w4a4": ("quant_matmul_int", "_unpack_to_int8",
                        "_quant_matmul_int_dense", "flash_attention",
                        "kv_cache_prefill_write", "kv_cache_write",
                        "quant_matmul_planar_decode",
                        "quant_matmul_planar_prefill"),
            "70b_int8": _TP_A16 + ("quant_matmul_prefill",
                                   "quant_matmul_planar_decode",
                                   "quant_matmul_planar_prefill",
                                   "kv_cache_write_span",
                                   "decode_attention_int8")}


def _llama2_70b_pack(torch, device, layers, seed, bits=3, group_size=128,
                     layout=None):
    """LLaMA-2-70B widths at ``layers`` layers, N(0, 0.02) weights and
    norms near 1 from a seeded generator, each linear packed (W3 g128 by
    default) as soon as it is drawn (a layer's f32 weights are 3.4 GB; the
    model's never exist at once): with ``layout`` None, o_proj and
    down_proj planar and the others by the auto layout (pairs), else every
    linear in ``layout``. Embeddings and head f32."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.quant import QuantConfig, pack_weight

    cfg = llama.LlamaConfig(**dict(LLAMA2_70B, num_hidden_layers=layers))
    gen = torch.Generator(device=device).manual_seed(seed)
    wcfg = QuantConfig(n_bits=bits, group_size=group_size)
    H, I = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    shapes = {"q_proj": (H, H), "k_proj": (kv, H), "v_proj": (kv, H),
              "o_proj": (H, H), "gate_proj": (I, H), "up_proj": (I, H),
              "down_proj": (H, I)}

    def norm():
        return {"weight": 1.0 + 0.1 * torch.randn(H, generator=gen,
                                                  device=device)}

    blocks = []
    for _ in range(layers):
        block = {"input_layernorm": norm(), "post_attention_layernorm": norm()}
        for name, (n, k) in shapes.items():
            w = torch.randn(n, k, generator=gen, device=device) * 0.02
            block[name] = pack_weight(w, wcfg, layout=layout or (
                "planar" if name in ("o_proj", "down_proj") else "auto"))
            del w
        blocks.append(block)
    top = {k: torch.randn(cfg.vocab_size, H, generator=gen,
                          device=device) * 0.02
           for k in ("embed_tokens", "lm_head")}
    return cfg, dict(top, layers=blocks, norm=norm())


def _llama2_7b_pack(torch, device, layout, seed):
    from omniquant_tpu_torch.models import LLAMA, llama
    from omniquant_tpu_torch.quant import QuantConfig
    from omniquant_tpu_torch.serving import pack_model

    cfg = llama.LlamaConfig(**LLAMA2_7B)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = llama.init_params(gen, cfg, device=device)
    packed = pack_model(LLAMA, dense, QuantConfig(n_bits=4, group_size=128),
                        layout=layout, device=device)
    return cfg, packed


class _Fallbacks:
    """Counts calls of every plain version and dense route a kernel wrapper
    could take (quant_matmul's reference and its dequantize-once route, the
    integer path's and the attention and cache kernels' plain versions)
    while it is entered; the card path must make none."""

    NAMES = {"quant_matmul": ("quant_matmul_reference", "dequantize_packed",
                              "quant_matmul_int_plain",
                              "quant_matmul_int_dense_plain",
                              "unpack_to_int8_plain"),
             "flash_attention": ("flash_attention_plain",),
             "decode_attention": ("decode_attention_int8_plain",),
             "kv_update": ("kv_cache_prefill_write_plain",
                           "kv_cache_write_plain",
                           "kv_cache_write_span_plain")}

    def __init__(self):
        import importlib

        self.calls = {}
        self._saved = []
        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(
                f"omniquant_tpu_torch.kernels.{mod_name}")
            self._saved += [(mod, n, getattr(mod, n)) for n in names]

    def __enter__(self):
        for mod, n, f in self._saved:
            def counted(*a, _f=f, _n=n, **kw):
                self.calls[_n] = self.calls.get(_n, 0) + 1
                return _f(*a, **kw)
            setattr(mod, n, counted)
        return self

    def __exit__(self, *exc):
        for mod, n, f in self._saved:
            setattr(mod, n, f)


def _tree_bytes(torch, *trees) -> int:
    """Bytes of the distinct tensors in ``trees`` (a tensor shared by two
    shards counts once)."""
    from omniquant_tpu_torch.quant import PackedWeight

    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, PackedWeight):
            for t in (x.qweight, x.scales, x.zeros, x.bias):
                walk(t)
        elif isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel())
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    for t in trees:
        walk(t)
    return total


def _tp_expected(run, tp, layers, steps, dispatches) -> dict:
    """The launches every shard's step programs make, times tp: per layer a
    K3 pair at the prefill, one K2, K4 at the first decode; K6 at every
    decode step and K5 at every step_n dispatch on an int8 cache; K1's
    prefill tile 4 times a layer on an A16 model (W4A4: its planar tile
    twice, the column-parallel sites), K8 + K9 twice (the row-parallel
    ones)."""
    model, _, kv, abits = TP_RUNS[run]
    n = tp * layers
    # K4 writes the first decode's rows; a bf16 cache's step_n steps write
    # theirs one by one, an int8 cache's go to the rings (K5 flushes them)
    want = {"kv_cache_prefill_write": 2 * n, "flash_attention": n,
            "kv_cache_write": n * (1 if kv == "int8" else steps)}
    if kv == "int8":
        want.update(kv_cache_write_span=n * dispatches,
                    decode_attention_int8=n * steps)
    if abits == 4:
        want.update(_unpack_to_int8=2 * n, _quant_matmul_int_dense=2 * n,
                    quant_matmul_int=2 * n * steps,
                    quant_matmul_planar_decode=2 * n * steps,
                    quant_matmul_planar_prefill=2 * n)
    elif model == "70b":  # qkv and gate_up pairs, o and down planar
        want.update(quant_matmul=4 * n * (steps + 1),
                    quant_matmul_prefill=2 * n,
                    quant_matmul_planar_prefill=2 * n,
                    quant_matmul_planar_decode=2 * n * steps)
    else:
        want.update(quant_matmul=4 * n * (steps + 1),
                    quant_matmul_prefill=4 * n)
    return want


def _serve_timed(torch, eng, reqs, res: dict, first=None):
    """Warm up, then prefill ``reqs`` (logits kept), the first decode's
    logits (engine._decode_impl) and TP_DISPATCHES step_n(., 8) on the host
    clock behind synchronisations, the launch counts and the peak memory
    reset at its start; every plain version and dense route counted.
    ``first``, when given, replaces the prefill's first tokens (so that two
    engines decode from the same tokens where their prefills' argmaxes
    part)."""
    from omniquant_tpu_torch import kernels

    warm = eng.add_requests([r[:16] for r in reqs[:2]])
    eng.step_n({x: eng._pending_next[x] for x in warm}, 2)
    for x in warm:
        eng.release(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _Fallbacks() as fb:
        t = time.time()
        slots, prefill = eng.add_requests(reqs, return_logits=True)
        torch.cuda.synchronize()
        prefill_s = time.time() - t
        if first is None:
            first = [eng._pending_next[x] for x in slots]
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))
        last = dict(zip(slots, first))
        streams = {x: [] for x in slots}
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(TP_DISPATCHES):
            out = eng.step_n(last, 8)
            for x in slots:
                streams[x].extend(out[x])
            last = {x: out[x][-1] for x in slots}
        torch.cuda.synchronize()
        decode_s = time.time() - t
    n_tok = sum(len(r) for r in reqs)
    res.update(prefill_s=prefill_s, prefill_tok_s=n_tok / prefill_s,
               decode_s=decode_s, step_s=decode_s / (8 * TP_DISPATCHES),
               decode_tok_s=len(reqs) * 8 * TP_DISPATCHES / decode_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               run_peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               launches=kernels.launch_counts(), fallbacks=fb.calls)
    if fb.calls:
        raise AssertionError(f"plain versions or dense routes ran on the "
                             f"card path: {fb.calls}")
    return prefill, dec, [[f] + streams[x] for f, x in zip(first, slots)], \
        last


def _tp_hold(torch, cfg, packed, reqs, single, tp, spec, tol, bound):
    """The TP engine's prefill and first-decode logits against the single
    engine's (``tol``), and its streams (first token included) under the
    near-tie rule at ``bound`` against one causal pass of the plain f32
    forward over prompt and stream; the single engine's streams read the
    same way. Returns the readings and whether all held."""
    from omniquant_tpu_torch.models import LLAMA

    r = {}
    for what, i in (("prefill", 0), ("decode", 1)):
        r[f"{what}_logits"] = logit_gap(tp[i], single[i])
    for who, got in (("tp", tp), ("single", single)):
        gaps = stream_gaps(torch, LLAMA, cfg, packed, reqs, got[2], spec)
        r[f"{who}_streams"] = near_tie(gaps, bound)
    r["streams_equal"] = sum(a == b for a, b in zip(tp[2], single[2]))
    r["ok"] = (gap_within(r["prefill_logits"], tol)
               and gap_within(r["decode_logits"], tol)
               and r["tp_streams"]["ok"])
    return r


class _DropLastPartial:
    """The planted fault: every sum all-reduce of ``mesh`` leaves out the
    last shard's partial (its heads' attention output and its slice of the
    MLP never reach the residual stream)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        reduce = self.mesh._reduce

        def faulty(xs, op):
            if op == "sum":
                xs = list(xs[:-1]) + [xs[-1] * 0]
            return reduce(xs, op)

        self.mesh._reduce = faulty
        return self

    def __exit__(self, *exc):
        del self.mesh._reduce


def tp_run(torch, device, name, cfg, packed, seed, out: dict):
    """One TP_RUNS entry: the single LlamaEngine and the TP engine (tp
    shards on ``device``) on ``packed``, each timed by _serve_timed; the
    hold (_tp_hold) must pass, the TP engine's launches must be tp times a
    shard's (_tp_expected, exactly) and cover TP_PATHS, and the planted
    fault (_DropLastPartial) must fail the hold. Returns (the two engines,
    the last tokens of each) for the profile."""
    from omniquant_tpu_torch.models.common import ActQuantSpec
    from omniquant_tpu_torch.parallel import make_mesh
    from omniquant_tpu_torch.serving import LlamaEngine, TPLlamaEngine

    model, tp, kv, abits = TP_RUNS[name]
    spec = ActQuantSpec.from_bits(abits)
    kw = dict(max_batch=TP_BATCH, max_len=TP_MAX_LEN, dtype=torch.bfloat16,
              kv_dtype=kv, spec=spec, seed=seed)
    reqs = prompts(torch, TP_BATCH, TP_PROMPT_LEN, cfg.vocab_size, seed + 22)
    res = out[name] = dict(tp=tp, kv=kv, abits=abits,
                           layers=cfg.num_hidden_layers)
    single = LlamaEngine(packed, cfg, device=device, **kw)
    s_got = _serve_timed(torch, single, reqs, res.setdefault("single", {}))
    torch.cuda.synchronize()
    t = time.time()
    eng = TPLlamaEngine(packed, cfg, make_mesh(tp=tp, devices=[device] * tp),
                        **kw)
    torch.cuda.synchronize()
    res["place_s"] = time.time() - t
    t_got = _serve_timed(torch, eng, reqs, res.setdefault("tp_engine", {}),
                         first=[s[0] for s in s_got[2]])
    r = res["tp_engine"]
    r["shard_gib"] = [_tree_bytes(torch, s.params, s.cache) / 2**30
                      for s in eng.shards]
    r["total_gib"] = _tree_bytes(torch, [s.params for s in eng.shards],
                                 [s.cache for s in eng.shards]) / 2**30
    res["single"]["engine_gib"] = _tree_bytes(
        torch, single.params, single.cache) / 2**30
    steps = 1 + 8 * TP_DISPATCHES
    want = _tp_expected(name, tp, cfg.num_hidden_layers, steps,
                        TP_DISPATCHES)
    counts = r["launches"]
    wrong = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    # the single engine's attention and cache kernels: a shard's share
    one = {k: v // tp for k, v in want.items() if k in _TP_ATTN_KV}
    s_wrong = {k: (res["single"]["launches"][k], v) for k, v in one.items()
               if res["single"]["launches"][k] != v}
    missing = [k for k in TP_PATHS[name] if counts[k] <= 0]
    if wrong or missing or s_wrong:
        raise AssertionError(f"tp {name}: launches (got, want) {wrong}, "
                             f"single {s_wrong}, never launched {missing}")
    tol = E2E_TOL if abits == 16 else E2E_INT_TOL[abits]
    bound = SPEC_TIE * tol["max"]
    hold = res["hold"] = _tp_hold(torch, cfg, packed, reqs, s_got, t_got,
                                  spec, tol, bound)
    log(f"  tp {name} ({model}, {cfg.num_hidden_layers} layers, tp {tp}, "
        f"{kv} KV, A{abits}): placed in {res['place_s']:.2f} s; prefill "
        f"{r['prefill_tok_s']:.1f} tok/s (single "
        f"{res['single']['prefill_tok_s']:.1f}), step_n(., 8) "
        f"{r['decode_tok_s']:.1f} tok/s (single "
        f"{res['single']['decode_tok_s']:.1f}), a step {r['step_s'] * 1e3:.2f}"
        f" ms (single {res['single']['step_s'] * 1e3:.2f}); a shard "
        f"{max(r['shard_gib']):.3f} GiB, the shards {r['total_gib']:.3f} GiB "
        f"(single engine {res['single']['engine_gib']:.3f}), peak "
        f"{r['peak_gib']:.2f} GiB on the card (the run "
        f"{r['run_peak_gib']:.2f}); launches {counts}")
    for what in ("prefill", "decode"):
        g = hold[f"{what}_logits"]
        log(f"  tp {name} {what} logits against the single engine: rms rel "
            f"{g['rms_rel']:.3g}, max rel {g['max_rel']:.3g} (tol "
            f"{tol['rms']}, {tol['max']}), argmax agreement "
            f"{g['argmax_agree']:.3f}")
    log(f"  tp {name} streams: TP {_log_tie(hold['tp_streams'])}; single "
        f"{_log_tie(hold['single_streams'])}; {hold['streams_equal']} of "
        f"{len(reqs)} streams equal")
    if not hold["ok"]:
        raise AssertionError(f"tp {name}: the TP engine fails its hold")
    return single, eng, s_got, t_got, reqs, spec, tol, bound


def tp_fault(torch, cfg, packed, single_got, eng, reqs, spec, tol, bound,
             res: dict) -> None:
    """The planted fault through the same run and hold: it must fail."""
    for x in [i for i, a in enumerate(eng.active) if a]:
        eng.release(x)
    with _DropLastPartial(eng.mesh):
        slots, prefill = eng.add_requests(reqs, return_logits=True)
        first = [s[0] for s in single_got[2]]
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))
        out = eng.step_n(dict(zip(slots, first)), 8)
    got = (prefill, dec, [[f] + out[x] for f, x in zip(first, slots)])
    fault = res["fault"] = _tp_hold(torch, cfg, packed, reqs,
                                    (single_got[0], single_got[1],
                                     [s[:9] for s in single_got[2]]),
                                    got, spec, tol, bound)
    log(f"  tp fault (the last shard's partial left out of every sum): "
        f"prefill logits rms rel {fault['prefill_logits']['rms_rel']:.3g}, "
        f"decode {fault['decode_logits']['rms_rel']:.3g}; streams "
        f"{_log_tie(fault['tp_streams'])}: "
        f"{'REJECTED' if not fault['ok'] else 'PASSED'}")
    if fault["ok"]:
        raise AssertionError("tp: the planted fault passed the hold")
    for x in slots:
        eng.release(x)


# --eval_ppl --tp's path (make_tp_model_forward with the run's activation
# quantizers) at LLaMA-2-70B widths, TP_70B_LAYERS layers, tp 8 on the
# card: per-channel W4A4 and W6A6 packed planar (the scripts' recipes),
# in bf16 as an engine holds it; one window of TP_PPL_SEQLEN tokens of the
# synthetic test split. The row-parallel sites (q, k, v, gate, up) take
# K8 + K9 at m = 2048, the column-parallel ones (o, down) the
# fake-quantized input (its per-token ranges all-reduced) into K1's planar
# prefill tile. run -> (weight bits, activation bits)
TP_PPL_RUNS = {"70b_w4a4_ppl": (4, 4), "70b_w6a6_ppl": (6, 6)}
TP_PPL_TP, TP_PPL_SEQLEN = 8, 2048
# Holds. At W4A4 and W6A6 in bf16 two sound forwards of one pack part by
# the bf16 noise that the 4- and 6-bit activation codes turn into whole
# code steps, and the more so the more layers they pass. So: (a) at every
# column-parallel site of every layer, the shards' quantized inputs,
# gathered, must be the unsplit quantizer of the gathered inputs bit for
# bit; (b) at layer 0's input, each shard's row-parallel products (q, k,
# v, gate, up through K8 + K9) must be the single device's columns of the
# whole linear within TP_PPL_SHARD_RMS rms relative; (c) the logits, TP
# against single device, within the run's TP_PPL_LOGIT_RMS (rms relative),
# where a limit separates the faults (None: at W4A4 the sound run lies as
# far from the single device as the faults); (d) ppl_check's per-token NLL
# rule against the plain f32 forward. Planted faults through the same run:
# every column-parallel site quantized with its shard's own per-token
# ranges (must fail a and c), shard 0's scales x TP_PPL_FAULT_SCALE in
# every linear (must fail b and c)
TP_PPL_SHARD_RMS = 2e-3  # the sound run reads 0, the scale fault 0.0121
# logits' rms rel on an NVIDIA H100 80GB HBM3, 700 W, sound / local ranges
# / scales: W4A4 0.904 / 1.103 / 1.048, W6A6 0.381 / 0.538 / 0.498
TP_PPL_LOGIT_RMS = {"70b_w4a4_ppl": None, "70b_w6a6_ppl": 0.44}
TP_PPL_FAULT_SCALE = 1.01


def _window_nll(torch, logits, window):
    """The shifted cross-entropy of each token of one window, f32."""
    logp = torch.log_softmax(logits[:-1].float(), dim=-1)
    return -logp.gather(-1, window[1:, None])[:, 0]


def _plain_window_logits(torch, cfg, packed, window, spec, dtype):
    """The plain forward's logits over one window, layer by layer from the
    packed model dequantized as plain_reference_params does, in ``dtype``
    (f32: the reference; bf16: what the card's plain arithmetic reaches)."""
    from omniquant_tpu_torch.models import LLAMA
    from omniquant_tpu_torch.serving.engine import _to_engine

    top = _to_engine(plain_reference_params(
        torch, {k: v for k, v in packed.items() if k != "layers"}),
        window.device, dtype)
    with torch.inference_mode():
        x = LLAMA.embed(top, window[None], cfg)
        for layer in packed["layers"]:
            x = _chain(torch, LLAMA, cfg, [_to_engine(plain_reference_params(
                torch, layer), window.device, dtype)], x, spec)
        return LLAMA.head(top, x, cfg)[0].float()


def _fault_on(torch, fwd, fault):
    """Plant ``fault`` ("local_ranges" or "scale_shard0") in the TP forward
    ``fwd``; returns the undo."""
    import dataclasses as dc

    from omniquant_tpu_torch.models.common import maybe_quant
    from omniquant_tpu_torch.parallel import tp_forward as tpf
    from omniquant_tpu_torch.quant import PackedWeight

    saved_quant = tpf.tp_act_quant
    saved_blocks = [dict(shards[0]) for shards in fwd.layers]
    if fault == "local_ranges":
        tpf.tp_act_quant = lambda mesh, p, x, qcfg: maybe_quant(x, qcfg)
    elif fault == "scale_shard0":
        for shards in fwd.layers:
            for name, w in shards[0].items():
                if isinstance(w, PackedWeight):
                    shards[0][name] = dc.replace(
                        w, scales=w.scales * TP_PPL_FAULT_SCALE)

    def undo():
        tpf.tp_act_quant = saved_quant
        for shards, block in zip(fwd.layers, saved_blocks):
            shards[0].clear()
            shards[0].update(block)

    return undo


def _tp_ppl_forward(torch, fwd, window, sites=None):
    """One window through the TP model forward: (logits f32, seconds,
    launches, plain versions entered). ``sites``, a list, receives every
    column-parallel site's (shard, input, quantized input, quantizer)."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.parallel import tp_forward as tpf

    inner = tpf.tp_act_quant

    def record(mesh, p, x, qcfg):
        y = inner(mesh, p, x, qcfg)
        if qcfg is not None and qcfg.enabled:
            sites.append((p, x, y, qcfg))
        return y

    if sites is not None:
        tpf.tp_act_quant = record
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with _Fallbacks() as fb, torch.inference_mode():
            t = time.time()
            logits = fwd(window[None])[0].float()
            torch.cuda.synchronize()
            seconds = time.time() - t
    finally:
        tpf.tp_act_quant = inner
    return logits, seconds, kernels.launch_counts(), fb.calls


def _sites_hold(torch, sites, tp) -> dict:
    """(a): each column-parallel site's shards' quantized inputs, gathered,
    against the unsplit quantizer of the gathered inputs; the count of
    sites and of those apart."""
    from omniquant_tpu_torch.quant.quantizer import fake_quant_act

    by_shard = [[s for s in sites if s[0] == p] for p in range(tp)]
    apart = 0
    for calls in zip(*by_shard):
        whole = fake_quant_act(torch.cat([c[1] for c in calls], dim=-1),
                               calls[0][3])
        apart += not torch.equal(torch.cat([c[2] for c in calls], dim=-1),
                                 whole)
    return dict(sites=len(by_shard[0]), apart=apart,
                ok=apart == 0 and len(by_shard[0]) > 0
                and len({len(b) for b in by_shard}) == 1)


def _row_shards_hold(torch, fwd, served, cfg, window, spec, tp) -> dict:
    """(b): layer 0's input (the normed embeddings of the window) through
    each shard's placed row-parallel linears and through the whole linears
    of the single-device model: the largest rms relative gap over (shard,
    linear) of a shard's products to its columns of the whole."""
    from omniquant_tpu_torch.models import LLAMA
    from omniquant_tpu_torch.models.common import linear, rms_norm
    from omniquant_tpu_torch.parallel import tp_forward as tpf

    block = served["layers"][0]
    with torch.inference_mode():
        h = rms_norm(LLAMA.embed(served, window[None], cfg),
                     block["input_layernorm"], cfg.rms_norm_eps)
        worst = 0.0
        for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
            whole = linear(h, block[name], spec.act).float()
            n = whole.shape[-1] // tp
            for p in range(tp):
                got = tpf._row_linear(h, fwd.layers[0][p][name],
                                      spec.act).float()
                worst = max(worst, rms_rel_err(got, whole[..., p * n:
                                                          (p + 1) * n]))
    return dict(worst_rms_rel=worst, ok=worst <= TP_PPL_SHARD_RMS)


def tp_ppl_run(torch, device, name, seed, out: dict) -> dict:
    """One TP_PPL_RUNS entry: the pack, the single-device forward's and the
    TP forward's logits on one window, timed; the TP forward's launches
    exactly tp times a shard's (K8 and K9 at the five row-parallel sites of
    every layer, K1's planar prefill tile at the two column-parallel ones),
    none through a plain version; the holds above (a-d); each planted
    fault must fail its holds. Returns the TP forward's launches."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.calib import get_synthetic
    from omniquant_tpu_torch.models import LLAMA
    from omniquant_tpu_torch.models.common import ActQuantSpec
    from omniquant_tpu_torch.parallel import make_mesh, make_tp_model_forward
    from omniquant_tpu_torch.serving.engine import _to_engine

    bits, abits = TP_PPL_RUNS[name]
    tp, layers = TP_PPL_TP, TP_70B_LAYERS
    t0 = time.time()
    cfg, packed = _llama2_70b_pack(torch, device, layers, seed + 70 + bits,
                                   bits=bits, group_size=None,
                                   layout="planar")
    served = _to_engine(packed, device, torch.bfloat16)
    spec = ActQuantSpec.from_bits(abits)
    _, test = get_synthetic(0, seed, TP_PPL_SEQLEN, vocab_size=cfg.vocab_size)
    window = torch.as_tensor(test[0, :TP_PPL_SEQLEN], device=device).long()
    res = out[name] = dict(tp=tp, layers=layers, wbits=bits, abits=abits,
                           seqlen=TP_PPL_SEQLEN, pack_s=time.time() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        LLAMA.forward(served, window[None, :64], cfg, spec)  # warm-up
        torch.cuda.synchronize()
        t = time.time()
        single = LLAMA.forward(served, window[None], cfg, spec)[0].float()
        torch.cuda.synchronize()
    res["single_s_per_window"] = time.time() - t
    t = time.time()
    fwd = make_tp_model_forward(LLAMA, served, cfg, make_mesh(
        tp=tp, devices=[device] * tp), spec=spec)
    torch.cuda.synchronize()
    res["place_s"] = time.time() - t
    _tp_ppl_forward(torch, fwd, window[:64])  # warm-up
    got, res["tp_s_per_window"], counts, fallbacks = _tp_ppl_forward(
        torch, fwd, window)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["launches"] = counts
    per = {"_unpack_to_int8": 5 * layers, "_quant_matmul_int_dense":
           5 * layers, "quant_matmul": 2 * layers,
           "quant_matmul_planar_prefill": 2 * layers}
    wrong = {k: (counts[k], tp * v) for k, v in per.items()
             if counts[k] != tp * v}
    if wrong or fallbacks:
        raise AssertionError(f"tp {name}: launches (got, want) {wrong}; "
                             f"plain versions entered {fallbacks}")

    lim = TP_PPL_LOGIT_RMS[name]

    def holds(logits, sites):
        h = dict(logits=logit_gap(logits, single),
                 sites=_sites_hold(torch, sites, tp),
                 row_shards=_row_shards_hold(torch, fwd, served, cfg,
                                             window, spec, tp))
        h["logits"]["ok"] = lim is None or h["logits"]["rms_rel"] <= lim
        return h

    sites = []
    _tp_ppl_forward(torch, fwd, window, sites)
    hold = res["hold"] = holds(got, sites)
    del sites
    ref = _plain_window_logits(torch, cfg, packed, window, spec,
                               torch.float32)
    nll_ref = _window_nll(torch, ref, window)
    del ref
    plain16 = _plain_window_logits(torch, cfg, packed, window, spec,
                                   torch.bfloat16)
    gaps = {k: (_window_nll(torch, lg, window) - nll_ref).pow(2).mean()
            .sqrt().item() for k, lg in (("tp", got), ("single", single),
                                         ("bf16_forward", plain16))}
    del plain16
    bound = PPL_VS_PLAIN * gaps["bf16_forward"]
    hold.update(nll_rms_gap=gaps, nll_bound=bound, ppl={
        k: math.exp(nll.mean().item()) for k, nll in (
            ("tp", _window_nll(torch, got, window)),
            ("single", _window_nll(torch, single, window)),
            ("f32_forward", nll_ref))})
    hold["ok"] = (hold["sites"]["ok"] and hold["row_shards"]["ok"]
                  and hold["logits"]["ok"]
                  and gaps["tp"] <= bound and gaps["single"] <= bound)
    res["faults"] = {}
    for fault, check in (("local_ranges", "sites"),
                         ("scale_shard0", "row_shards")):
        undo = _fault_on(torch, fwd, fault)
        try:
            sites = []
            f_got = _tp_ppl_forward(torch, fwd, window, sites)[0]
            f = res["faults"][fault] = holds(f_got, sites)
        finally:
            undo()
        # its bit-level hold and, where it is set, the logit limit
        f["rejected"] = not f[check]["ok"] and (lim is None
                                                or not f["logits"]["ok"])
        del sites, f_got
    del fwd, served, packed, got, single
    torch.cuda.empty_cache()
    res["run_s"] = time.time() - t0

    def said(h):
        return (f"column-parallel sites apart {h['sites']['apart']} of "
                f"{h['sites']['sites']}, row shards' worst rms rel "
                f"{h['row_shards']['worst_rms_rel']:.4g}, logits rms rel "
                f"{h['logits']['rms_rel']:.4g}")

    log(f"  tp {name} (--eval_ppl --tp {tp}: LLaMA-2-70B widths, {layers} "
        f"layers, W{bits}A{abits} per-channel planar, one {TP_PPL_SEQLEN}-"
        f"token window): TP {res['tp_s_per_window']:.3f} s a window, single "
        f"device {res['single_s_per_window']:.3f}; placed in "
        f"{res['place_s']:.2f} s; peak {res['peak_gib']:.2f} GiB; "
        f"perplexity TP {hold['ppl']['tp']:.4f}, single "
        f"{hold['ppl']['single']:.4f}, plain f32 "
        f"{hold['ppl']['f32_forward']:.4f}; launches {counts}")
    log(f"  tp {name} hold: {said(hold)} (limits: 0, {TP_PPL_SHARD_RMS}, "
        f"{lim}), max rel {hold['logits']['max_rel']:.4g}, cos "
        f"{hold['logits']['cos']:.4f}, argmax agreement "
        f"{hold['logits']['argmax_agree']:.4f}; per-token NLL rms gap to "
        f"the plain f32 forward: TP {gaps['tp']:.4g}, single "
        f"{gaps['single']:.4g}, plain bf16 {gaps['bf16_forward']:.4g} "
        f"(bound {bound:.4g})")
    for fault, f in res["faults"].items():
        log(f"  tp {name} fault {fault}: {said(f)}: "
            f"{'REJECTED' if f['rejected'] else 'PASSED'}")
    if not hold["ok"]:
        raise AssertionError(f"tp {name}: the TP forward fails its hold: "
                             f"{hold}")
    admitted = [k for k, v in res["faults"].items() if not v["rejected"]]
    if admitted:
        raise AssertionError(f"tp {name}: planted faults passed {admitted}")
    return counts


def tp_phase(torch, device, seed, out: dict, keep: dict = None) -> dict:
    """TP_RUNS in order; the last (LLaMA-2-70B widths, int8 KV) ends with
    one step_n(., 8) of the single and the TP engine under torch.profiler
    (profile_step: the card's busy share of a step). ``keep`` receives the
    pack (cfg, params) and the TP engine's logits, streams and readings of
    MP_TP_RUNS (the mp phase hands the pack to its ranks and holds them
    against the rest). Then TP_PPL_RUNS (tp_ppl_run). Returns the TP
    engines' and TP forwards' launches summed over the runs."""
    res = out["tp"] = {}
    counts = {}
    packs = {}
    for name, (model, tp, kv, abits) in TP_RUNS.items():
        t0 = time.time()
        key = (model, abits)
        if key not in packs:
            packs.clear()
            torch.cuda.empty_cache()
            if model == "70b":
                packs[key] = _llama2_70b_pack(torch, device, TP_70B_LAYERS,
                                              seed + 70)
            else:
                packs[key] = _llama2_7b_pack(
                    torch, device, "planar" if abits == 4 else "auto",
                    seed + 7)
        cfg, packed = packs[key]
        single, eng, s_got, t_got, reqs, spec, tol, bound = tp_run(
            torch, device, name, cfg, packed, seed, res)
        for k, v in res[name]["tp_engine"]["launches"].items():
            counts[k] = counts.get(k, 0) + v
        if keep is not None and name in MP_TP_RUNS:
            keep[name] = dict(prefill=t_got[0].float().cpu(),
                              dec=t_got[1].float().cpu(), streams=t_got[2],
                              first=[x[0] for x in s_got[2]],
                              readings=res[name], pack=packs[key])
        tp_fault(torch, cfg, packed, s_got, eng, reqs, spec, tol, bound,
                 res[name])
        if name == "70b_int8":
            for who, e in (("single", single), ("tp_engine", eng)):
                for x in [i for i, a in enumerate(e.active) if a]:
                    e.release(x)
                slots = e.add_requests(reqs)
                last = {x: e._pending_next[x] for x in slots}
                last = {x: r[-1] for x, r in e.step_n(last, 8).items()}
                p = res[name][who]["profile"] = profile_step(
                    torch, e, last, 8, res[name][who]["step_s"])
                busy = p["busy_share"]
                log(f"  tp {name} {who} profiled step_n(8): device "
                    f"{p['device_ms_per_step']:.2f} ms of a "
                    f"{p['step_ms']:.2f} ms step ("
                    f"{busy if isinstance(busy, str) else f'{busy:.1%}'} "
                    f"busy), {p['launches_per_step']:.0f} launches a step; "
                    "most device time: " + ", ".join(
                        f"{k} {v:.3f} ms" for k, v in p["top_kernels"]))
        del single, eng
        torch.cuda.empty_cache()
        res[name]["run_s"] = time.time() - t0
    del packs
    torch.cuda.empty_cache()
    for name in TP_PPL_RUNS:
        for k, v in tp_ppl_run(torch, device, name, seed, res).items():
            counts[k] = counts.get(k, 0) + v
    return counts


# K1 and K6 at the tp phase's per-shard shapes: (label, bits, group,
# layout, N, K, tp, padded K); a column-parallel weight is packed whole,
# padded, made splittable (OPT-2.7B's out_proj retiles from 512 rows to 256
# at tp 2 and 128 at tp 4) and split as the TP engine places it; a
# row-parallel shard is a pack of its own lanes (70B's fused qkv: 1280
# lanes a shard, gate_up 7168)
TP_K1 = (("70b qkv tp8", 3, 128, "pairs", 1280, 8192, 1, 8192),
         ("70b o tp8", 3, 128, "planar", 8192, 8192, 8, 8192),
         ("70b gate_up tp8", 3, 128, "pairs", 7168, 8192, 1, 8192),
         ("70b down tp8", 3, 128, "planar", 8192, 28672, 8, 28672),
         ("7b o tp2", 4, 128, "pairs", 4096, 4096, 2, 4096),
         ("7b down tp2", 4, 128, "pairs", 4096, 11008, 2, 11264),
         ("opt27b out tp2", 4, 128, "pairs", 2560, 2560, 2, 2560),
         ("opt27b out tp4", 4, 128, "pairs", 2560, 2560, 4, 2560))
TP_K1_M = (8, TP_BATCH * TP_PROMPT_LEN)


def tp_shard_weight(torch, device, gen, bits, group_size, layout, N, K, tp,
                    k_pad):
    """Shard 0 of a random (N, K) weight placed column-parallel over tp
    shards (tp 1: the whole weight), bf16 scales and zeros; and its bf16
    dequantized weight (the library call's operand)."""
    from omniquant_tpu_torch.parallel import tp_forward as tpf
    from omniquant_tpu_torch.parallel.sharding import local_packed
    from omniquant_tpu_torch.quant import (QuantConfig, dequantize_packed,
                                           pack_weight)

    w = torch.randn(N, K, generator=gen, device=device) * 0.02
    pw = pack_weight(w, QuantConfig(n_bits=bits, group_size=group_size),
                     layout=layout)
    del w
    pw = pw.map_tensors(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t)
    if k_pad != K:
        pw = tpf._pad_packed_in(pw, k_pad)
    pw = tpf._ensure_col_splittable(pw, tp)
    pw = local_packed(pw, tpf.local_spec(pw, False), tp, 0, device)
    return pw, dequantize_packed(pw, dtype=torch.bfloat16)


def check_tp_kernels(torch, device, timer, out: dict) -> tuple:
    """K1 at every TP_K1 shape and m in TP_K1_M (the tp phase's decode and
    prefill rows), each one launch of the kernel (never the dense route),
    held and timed by _k1_row; K6 at a 70B shard's decode (8 slots, one kv
    head of 8 query heads, window 2048, with and without the ring) by
    _decode_rows. Returns (K1 rows, K6 rows)."""
    from omniquant_tpu_torch.kernels.quant_matmul import quant_matmul

    gen = torch.Generator(device=device).manual_seed(2208)
    rows = []
    for label, bits, gs, layout, N, K, tp, k_pad in TP_K1:
        pw, w_lib = tp_shard_weight(torch, device, gen, bits, gs, layout, N,
                                    K, tp, k_pad)
        for m in TP_K1_M:
            x = torch.randn(m, k_pad // tp, generator=gen,
                            device=device).to(torch.bfloat16)
            before = quant_matmul.launches
            quant_matmul(x, pw)
            if quant_matmul.launches != before + 1:
                raise AssertionError(f"quant_matmul {label} m={m}: not one "
                                     "kernel launch")
            rows.append(dict(shape=label, tile_k=pw.tile_k, layout=layout,
                             **_k1_row(torch, timer,
                                       f"quant_matmul {label} m={m} "
                                       f"(tile {pw.tile_k})", pw, w_lib, x)))
        del pw, w_lib
        torch.cuda.empty_cache()
    gen6 = torch.Generator(device=device).manual_seed(2209)
    straddle = torch.tensor([1023, 1024, 2047, 0, 1500, 512, 1022, 1025],
                            dtype=torch.int32, device=device)
    cases = [("70b tp8 shard b8 kv2048", 8, 2048, straddle, 2048, -1),
             ("70b tp8 shard b8 kv2048 ring 7", 8, 2048, straddle - 1, 2048,
              7)]
    k6 = _decode_rows(torch, device, timer, 1, 8, 128, cases, 8, gen6, {})
    out["tp_kernel_shapes"] = dict(quant_matmul=rows,
                                   decode_attention_int8=k6)
    return rows, k6


# ---------------------------------------------------------------------------
# mp: multi-process serving with every rank on the one card. Ranks are this
# script run with --mp-rank, spawned with subprocess after the kernels are
# built; each joins a gloo group (its ranks share one card, so not NCCL:
# parallel/multihost.py) and reads its pack from an npz file (the v2
# format of utils/convert.py::load_packed_npz) that this process writes.
# DP: engine A's LLaMA-7B widths at full depth (32 layers, W4A16 g128
# pairs, bf16 KV, max_len 512) behind DPServingCoordinator over
# MP_DP_RANKS ranks of max_batch 4: 8 prompts of 128 tokens routed
# round-robin, the first decode, step_n(., 8) x MP_DP_DISPATCHES; against
# one LlamaEngine at batch 8 and one at batch 4 (each rank's prompts) on
# the same pack. TP: MP_TP_RUNS of TP_RUNS with one shard a rank, against
# the tp phase's in-process TP engine on the same (regenerated) pack.
MP_DIR = os.path.join(HERE, "build", "mp")
MP_DP_MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=32)  # engine A's (main's cfg)
MP_DP_RANKS, MP_DP_MAX_BATCH, MP_DP_PROMPTS, MP_DP_LEN = 2, 4, 8, 128
MP_DP_MAX_LEN, MP_DP_DISPATCHES = 512, 4
MP_DP_PATHS = ("quant_matmul", "quant_matmul_prefill",
               "kv_cache_prefill_write", "kv_cache_write")
MP_TP_RUNS = ("7b_w4a16", "70b_int8")
# SP: the sp phase's LLaMA-2-7B run (4 x 4096 tokens, W4A16 g128 LWC, 2
# epochs) with the ring across MP_SP_RANKS gloo ranks of one shard each,
# the clean run, then the planted fault (rank 1's ring hands zeros back in
# place of the dk/dv of the blocks it received). Held against the sp
# phase's in-process SPMesh run: layer 0's fp capture bit for bit, the
# losses and LWC factors within the sp phase's tolerances and within
# MP_SP_LOSS_RTOL / MP_SP_LWC_RMS (the two differ only in the order of the
# loss's and the gradients' sums; the fault must fail them), both ranks'
# factors bit for bit, each rank's K2 stats launches its shard's share of
# the ring's schedule. The sound run read 1.51e-6 and 1.17e-5, the fault
# 2.04e-4 and 5.73e-3 (PERF.md, PR 25): the fault stays inside the sp
# phase's tolerances, which hold SP against a single-device run
MP_SP_RUN, MP_SP_RANKS = "llama2_7b_4096_sp2", 2
MP_SP_LOSS_RTOL, MP_SP_LWC_RMS = 2e-5, 1e-4
MP_TIMEOUT_S = {"dp": 300, "dp_auto": 300, "7b_w4a16": 180,
                "70b_int8": 360, "sp": 480}
MP_COLLECTIVE_TIMEOUT_S = 300
MP_FAULT_SCALE = 1.01  # DP's planted fault: rank 1's scales x 1.01
# TP's planted fault runs the first MP_TP_FAULT_REQS prompts: a 70B
# prefill's partials (8 x 256 rows) cross gloo through the host at ~20 s
MP_TP_FAULT_REQS = 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mp_spawn(leg: str, world: int, seed: int, timeout: float,
             torchrun: bool = False) -> list:
    """``world`` ranks of this script with ``--mp-rank leg``, each logging
    to MP_DIR/<leg>_rank<r>.log, given ``timeout`` seconds in all; the
    first rank to fail, or the clock, kills them all and raises. The ranks
    get --rank/--world/--port, or with ``torchrun`` the variables torchrun
    sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE) and no coordinator (init_multihost finds the group
    in them). Returns each rank's (json readings, tensors)."""
    import torch

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // world)))
    procs, logs = [], []
    t0 = time.time()
    try:
        for r in range(world):
            logs.append(open(os.path.join(MP_DIR, f"{leg}_rank{r}.log"), "w"))
            cmd = [sys.executable, os.path.abspath(__file__), "--mp-rank",
                   leg, "--seed", str(seed)]
            rank_env = env
            if torchrun:
                rank_env = dict(env, MASTER_ADDR="localhost",
                                MASTER_PORT=str(port), RANK=str(r),
                                WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                                LOCAL_WORLD_SIZE=str(world))
            else:
                cmd += ["--rank", str(r), "--world", str(world), "--port",
                        str(port)]
            procs.append(subprocess.Popen(
                cmd, cwd=HERE, env=rank_env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.time() - t0 > timeout
            if bad or late:
                r = bad[0] if bad else 0
                with open(os.path.join(MP_DIR, f"{leg}_rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(
                    f"mp {leg}: rank {r} "
                    f"{'exited ' + str(codes[r]) if bad else 'timed out'} "
                    f"after {time.time() - t0:.1f} s:\n{tail}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = []
    for r in range(world):
        base = os.path.join(MP_DIR, f"{leg}_rank{r}")
        with open(base + ".json") as f:
            out.append((json.load(f), torch.load(base + ".pt")))
    return out


def _dp_run(torch, eng, reqs, coord=None) -> tuple:
    """Serve ``reqs`` as a DP rank (``coord``: submit, step_n and
    gather_tokens of a DPServingCoordinator over ``eng``) or as one engine:
    a warm-up, then the prefill, the first decode's logits
    (eng._decode_impl on the local slots from their first tokens; step_n
    writes that row again with the same values) and MP_DP_DISPATCHES
    step_n(., 8), timed on the host clock behind synchronisations, the
    launch counts and the peak memory reset at the prefill. A rank starts
    the prefill and the decode loop at a barrier of every rank and keeps
    the host-clock stamps (one clock: the ranks share the host) of each
    window, so the ranks' windows together are read from the first start
    to the last end. Returns (readings, first-decode logits of the local
    slots in request order, streams: the global ones for a rank, else the
    engine's)."""
    from omniquant_tpu_torch import kernels
    from omniquant_tpu_torch.parallel import multihost

    def barrier():
        if coord is not None:
            torch.distributed.barrier(group=multihost.cpu_group())

    warm = [r[:16] for r in reqs[:2 * (coord.nproc if coord else 1)]]
    if coord is not None:
        ids = coord.submit(warm)
        coord.step_n(2)
        for i in ids:
            coord.release(i)
    else:
        slots = eng.add_requests(warm)
        eng.step_n({x: eng._pending_next[x] for x in slots}, 2)
        for x in slots:
            eng.release(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _Fallbacks() as fb:
        barrier()
        t = time.time()
        if coord is not None:
            ids = coord.submit(reqs)
            slots = [coord._slot_of[i] for i in ids if i in coord._slot_of]
        else:
            slots = eng.add_requests(reqs)
        torch.cuda.synchronize()
        prefill = (t, time.time())
        first = [eng._pending_next[x] for x in slots]
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        dec = eng._decode_impl(toks, lens, eng._kv_len(1))
        torch.cuda.synchronize()
        barrier()
        t = time.time()
        if coord is not None:
            for _ in range(MP_DP_DISPATCHES):
                coord.step_n(8)
        else:
            last = dict(zip(slots, first))
            streams = {x: [f] for x, f in last.items()}
            for _ in range(MP_DP_DISPATCHES):
                out = eng.step_n(last, 8)
                for x in slots:
                    streams[x].extend(out[x])
                last = {x: out[x][-1] for x in slots}
        torch.cuda.synchronize()
        decode = (t, time.time())
    barrier()
    if coord is not None:
        got = coord.gather_tokens()
        streams = [got[i] for i in ids]
        for i in ids:
            coord.release(i)
    else:
        streams = [streams[x] for x in slots]
        for x in slots:
            eng.release(x)
    if fb.calls:
        raise AssertionError(f"mp dp: plain versions or dense routes ran "
                             f"on the card path: {fb.calls}")
    n = len(slots)
    prefill_s, decode_s = prefill[1] - prefill[0], decode[1] - decode[0]
    r = dict(requests=n, prefill_s=prefill_s, decode_s=decode_s,
             prefill_window=prefill, decode_window=decode,
             prefill_tok_s=n * len(reqs[0]) / prefill_s,
             decode_tok_s=n * 8 * MP_DP_DISPATCHES / decode_s,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             launches=kernels.launch_counts())
    return r, dec.float().cpu(), streams


def _mp_dp_rank(torch, dev, args) -> tuple:
    """A DP rank: its own replica of the pack on the card behind
    DPServingCoordinator, the clean run, then the fault run (rank 1's
    scales x MP_FAULT_SCALE)."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.quant import PackedWeight
    from omniquant_tpu_torch.serving import DPServingCoordinator, LlamaEngine
    from omniquant_tpu_torch.utils import load_packed_npz

    cfg = llama.LlamaConfig(**MP_DP_MODEL)
    t = time.time()
    packed = load_packed_npz(os.path.join(MP_DIR, "dp_pack.npz"), device=dev)
    eng = LlamaEngine(packed, cfg, max_batch=MP_DP_MAX_BATCH,
                      max_len=MP_DP_MAX_LEN, dtype=torch.bfloat16,
                      seed=args.seed, device=dev)
    del packed
    res = dict(load_s=time.time() - t)
    coord = DPServingCoordinator(eng)
    reqs = prompts(torch, MP_DP_PROMPTS, MP_DP_LEN, cfg.vocab_size,
                   args.seed + 24)
    res["clean"], dec, streams = _dp_run(torch, eng, reqs, coord)
    tensors = {"clean_dec": dec}
    res["clean"]["streams"] = streams
    if args.mp_rank == "dp_auto":
        return res, tensors
    if coord.pid == 1:
        for layer in eng.params["layers"]:
            for w in layer.values():
                if isinstance(w, PackedWeight):
                    w.scales.mul_(MP_FAULT_SCALE)
    res["fault"], tensors["fault_dec"], res["fault"]["streams"] = _dp_run(
        torch, eng, reqs, coord)
    return res, tensors


def _tp_model_cfg(name):
    from omniquant_tpu_torch.models import llama

    if TP_RUNS[name][0] == "70b":
        return llama.LlamaConfig(**dict(LLAMA2_70B,
                                        num_hidden_layers=TP_70B_LAYERS))
    return llama.LlamaConfig(**LLAMA2_7B)


def _mp_tp_rank(torch, dev, args) -> tuple:
    """A TP rank of TP_RUNS[args.mp_rank], one shard: the pack read on the
    host and only this rank's shard placed on the card; _serve_timed from
    the in-process run's first tokens, then the planted fault (the last
    shard's partial left out of every sum, on every rank) through the same
    calls on the first MP_TP_FAULT_REQS prompts."""
    from omniquant_tpu_torch.models.common import ActQuantSpec
    from omniquant_tpu_torch.parallel import make_mesh
    from omniquant_tpu_torch.serving import TPLlamaEngine
    from omniquant_tpu_torch.utils import load_packed_npz

    name = args.mp_rank
    model, tp, kv, abits = TP_RUNS[name]
    cfg = _tp_model_cfg(name)
    t = time.time()
    packed = load_packed_npz(os.path.join(MP_DIR, f"{name}_pack.npz"),
                             device="cpu", dtype=torch.bfloat16)
    res = dict(load_s=time.time() - t)
    t = time.time()
    mesh = make_mesh(tp=tp)
    eng = TPLlamaEngine(packed, cfg, mesh, max_batch=TP_BATCH,
                        max_len=TP_MAX_LEN, dtype=torch.bfloat16,
                        kv_dtype=kv, spec=ActQuantSpec.from_bits(abits),
                        seed=args.seed)
    torch.cuda.synchronize()
    res.update(place_s=time.time() - t, local=mesh.local,
               held=[p for p, s in enumerate(eng.shards) if s is not None])
    with open(os.path.join(MP_DIR, f"{name}_first.json")) as f:
        first = json.load(f)
    reqs = prompts(torch, TP_BATCH, TP_PROMPT_LEN, cfg.vocab_size,
                   args.seed + 22)
    prefill, dec, streams, _ = _serve_timed(torch, eng, reqs, res,
                                            first=first)
    res["streams"] = streams
    res["shard_gib"] = _tree_bytes(
        torch, [s.params for s in eng.local_shards],
        [s.cache for s in eng.local_shards]) / 2**30
    tensors = dict(prefill=prefill.float().cpu(), dec=dec.float().cpu())
    for x in [i for i, a in enumerate(eng.active) if a]:
        eng.release(x)
    n_f = MP_TP_FAULT_REQS
    with _DropLastPartial(eng.mesh):
        slots, f_prefill = eng.add_requests(reqs[:n_f], return_logits=True)
        toks, lens = eng._device_tokens(dict(zip(slots, first)))
        f_dec = eng._decode_impl(toks, lens, eng._kv_len(1))
        out = eng.step_n(dict(zip(slots, first)), 8)
    res["fault_streams"] = [[f] + out[x] for f, x in zip(first, slots)]
    tensors.update(fault_prefill=f_prefill.float().cpu(),
                   fault_dec=f_dec.float().cpu())
    return res, tensors


def _mp_sp_rank(torch, dev, args) -> tuple:
    """An SP rank: MP_SP_RUN's dense model and windows made from the seed
    as the sp phase makes them, an SPMesh over the ranks (one shard a
    rank), calibrate clean and with the planted fault (_sp_calibrate)."""
    from omniquant_tpu_torch.calib import CalibConfig, get_synthetic
    from omniquant_tpu_torch.models import LLAMA, llama
    from omniquant_tpu_torch.parallel import SPMesh, global_mesh

    cfg = llama.LlamaConfig(**SP_LLAMA)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)
    dense = llama.init_params(gen, cfg, dtype=torch.float32, device=dev)
    _, seqlen, shards = SP_CALIB_RUNS[MP_SP_RUN]
    train, _ = get_synthetic(SP_NSAMPLES, args.seed, seqlen,
                             vocab_size=cfg.vocab_size)
    cc = CalibConfig(nsamples=SP_NSAMPLES, **SP_CALIB)
    world = torch.distributed.get_world_size()
    m = global_mesh(tp=shards, local_shards=shards // world, device=dev)
    mesh = SPMesh(m.devices, m.ranks)
    res, tensors = dict(local=mesh.local, ranks=mesh.ranks), {}
    for run, fault in (("clean", None), ("fault", "no_shift_back")):
        r = _sp_calibrate(torch, dev, LLAMA, cfg, dense, train, cc, mesh,
                          fault)
        res[run] = {k: r[k] for k in ("losses", "steps", "step_s",
                                      "fp_pass_s", "propagate_s", "phase_s",
                                      "peak_gib", "launches", "ring_calls")}
        tensors[f"{run}_capture"] = r["capture"].cpu()
        tensors[f"{run}_lwc"] = _lwc_flat(torch, LLAMA, r["omni"], cfg).cpu()
        del r
        torch.cuda.empty_cache()
    return res, tensors


def mp_rank_main(torch, args) -> int:
    """One rank of the mp phase (``--mp-rank``): join the gloo group (with
    --rank/--world/--port, or, without --port, from the launcher's
    environment), run the leg, write MP_DIR/<leg>_rank<r>.json and .pt."""
    from omniquant_tpu_torch.parallel import MultihostConfig, init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.port:
        cfg = MultihostConfig(f"localhost:{args.port}", args.world,
                              args.rank, timeout_s=MP_COLLECTIVE_TIMEOUT_S)
    else:
        cfg = MultihostConfig(timeout_s=MP_COLLECTIVE_TIMEOUT_S)
    dev = init_multihost(cfg, "cuda")
    leg = {"dp": _mp_dp_rank, "dp_auto": _mp_dp_rank,
           "sp": _mp_sp_rank}.get(args.mp_rank, _mp_tp_rank)
    res, tensors = leg(torch, dev, args)
    rank = torch.distributed.get_rank()
    res.update(rank=rank, device=str(dev),
               backend=torch.distributed.get_backend())
    base = os.path.join(MP_DIR, f"{args.mp_rank}_rank{rank}")
    torch.save(tensors, base + ".pt")
    with open(base + ".json", "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _dp_hold(torch, cfg, packed, reqs, ranks, single, run, bound) -> dict:
    """The DP hold on ``run`` ("clean" or "fault") of every rank: the
    gathered global streams equal on every rank and under the near-tie
    rule (stream_gaps) at ``bound``; each rank's first-decode logits equal
    to the batch-4 single engine's on its prompts bit for bit (the same
    kernels at the same shapes on the same card) and its streams equal to
    that engine's; its launches of MP_DP_PATHS that engine's. The batch-8
    engine's streams are read the same way."""
    from omniquant_tpu_torch.models import LLAMA
    from omniquant_tpu_torch.models.common import NO_ACT_QUANT

    got = [r[run]["streams"] for r, _ in ranks]
    h = dict(ranks_agree=all(g == got[0] for g in got))
    h["streams"] = near_tie(stream_gaps(torch, LLAMA, cfg, packed, reqs,
                                        got[0], NO_ACT_QUANT), bound)
    h["equal_to_batch8"] = sum(a == b for a, b in zip(
        got[0], single["batch8"][2]))
    h["ranks"] = []
    for r, (res, tensors) in enumerate(ranks):
        one = single[f"rank{r}"]
        mine = got[0][r::len(ranks)]
        h["ranks"].append(dict(
            dec_bit_equal=bool(torch.equal(tensors[f"{run}_dec"], one[1])),
            dec_gap=logit_gap(tensors[f"{run}_dec"], one[1]),
            streams_equal=sum(a == b for a, b in zip(mine, one[2])),
            launches_equal={k: (res[run]["launches"][k],
                                one[0]["launches"][k])
                            for k in MP_DP_PATHS}))
    h["ok"] = (h["ranks_agree"] and h["streams"]["ok"] and all(
        x["dec_bit_equal"] and x["streams_equal"] == MP_DP_PROMPTS // len(
            ranks) for x in h["ranks"]))
    return h


def mp_dp(torch, device, seed, res: dict) -> dict:
    """The DP leg: the pack written, the batch-8 and batch-4 single engines,
    the ranks spawned, the hold on the clean run (must pass) and on the
    fault run (must fail), the launch checks. Returns the ranks' launches
    summed (clean runs)."""
    from omniquant_tpu_torch.models import llama
    from omniquant_tpu_torch.serving import LlamaEngine
    from omniquant_tpu_torch.utils import save_pytree

    cfg = llama.LlamaConfig(**MP_DP_MODEL)
    packed = make_packed(torch, cfg, device, seed + 23)
    t = time.time()
    save_pytree(os.path.join(MP_DIR, "dp_pack.npz"), packed)
    res["pack_write_s"] = time.time() - t
    reqs = prompts(torch, MP_DP_PROMPTS, MP_DP_LEN, cfg.vocab_size, seed + 24)
    single = {}
    kw = dict(max_len=MP_DP_MAX_LEN, dtype=torch.bfloat16, seed=seed,
              device=device)
    eng = LlamaEngine(packed, cfg, max_batch=MP_DP_PROMPTS, **kw)
    single["batch8"] = _dp_run(torch, eng, reqs)
    del eng
    eng = LlamaEngine(packed, cfg, max_batch=MP_DP_MAX_BATCH, **kw)
    for r in range(MP_DP_RANKS):
        single[f"rank{r}"] = _dp_run(torch, eng, reqs[r::MP_DP_RANKS])
    del eng
    torch.cuda.empty_cache()
    t = time.time()
    ranks = mp_spawn("dp", MP_DP_RANKS, seed, MP_TIMEOUT_S["dp"])
    res["spawn_s"] = time.time() - t
    t = time.time()
    auto = mp_spawn("dp_auto", MP_DP_RANKS, seed, MP_TIMEOUT_S["dp_auto"],
                    torchrun=True)
    res["auto_spawn_s"] = time.time() - t
    os.remove(os.path.join(MP_DIR, "dp_pack.npz"))
    # the torchrun-style launch (no --rank/--world/--port): each rank's
    # results those of the explicit launch's rank, bit for bit
    res["auto"] = [dict(
        streams_equal=a["clean"]["streams"] == e["clean"]["streams"],
        dec_bit_equal=bool(torch.equal(at["clean_dec"], et["clean_dec"])),
        launches_equal=a["clean"]["launches"] == e["clean"]["launches"],
        rank=a["rank"], backend=a["backend"])
        for (a, at), (e, et) in zip(auto, ranks)]
    log(f"  mp dp launched with torchrun's variables and no coordinator: "
        f"per rank streams, first-decode logits and launches equal to the "
        f"explicit launch's {res['auto']} ({res['auto_spawn_s']:.1f} s)")
    if not all(a["streams_equal"] and a["dec_bit_equal"]
               and a["launches_equal"] and a["rank"] == r
               for r, a in enumerate(res["auto"])):
        raise AssertionError("mp dp: the auto-detected launch differs from "
                             f"the explicit one: {res['auto']}")
    bound = SPEC_TIE * E2E_TOL["max"]
    hold = res["hold"] = _dp_hold(torch, cfg, packed, reqs, ranks, single,
                                  "clean", bound)
    fault = res["fault"] = _dp_hold(torch, cfg, packed, reqs, ranks, single,
                                    "fault", bound)
    res["single_batch8"] = single["batch8"][0]
    res["single_batch4"] = [single[f"rank{r}"][0]
                            for r in range(MP_DP_RANKS)]
    res["ranks"] = [dict({k: v for k, v in r["clean"].items()
                          if k != "streams"}, load_s=r["load_s"],
                         backend=r["backend"], device=r["device"])
                    for r, _ in ranks]
    rk = res["ranks"]

    def span(key):  # the first rank's start to the last rank's end
        return max(r[key][1] for r in rk) - min(r[key][0] for r in rk)

    tog = res["together"] = dict(
        prefill_s=span("prefill_window"), decode_s=span("decode_window"),
        start_skew_s=max(abs(r[k][0] - rk[0][k][0]) for r in rk
                         for k in ("prefill_window", "decode_window")))
    tog.update(prefill_tok_s=MP_DP_PROMPTS * MP_DP_LEN / tog["prefill_s"],
               decode_tok_s=(MP_DP_PROMPTS * 8 * MP_DP_DISPATCHES
                             / tog["decode_s"]))
    wrong = {r: {k: v for k, v in x["launches_equal"].items()
                 if v[0] != v[1] or v[0] <= 0}
             for r, x in enumerate(hold["ranks"])}
    s8 = single["batch8"][0]
    log(f"  mp dp ({MP_DP_RANKS} ranks x max_batch {MP_DP_MAX_BATCH}, "
        f"{cfg.num_hidden_layers} layers, {rk[0]['backend']}): prefill tok/s "
        + " / ".join(f"{r['prefill_tok_s']:.1f}" for r in rk)
        + f" a rank, {res['together']['prefill_tok_s']:.1f} together "
        f"(single batch 8: {s8['prefill_tok_s']:.1f}); step_n tok/s "
        + " / ".join(f"{r['decode_tok_s']:.1f}" for r in rk)
        + f" a rank, {res['together']['decode_tok_s']:.1f} together (single "
        f"batch 8: {s8['decode_tok_s']:.1f}); peak GiB a rank "
        + " / ".join(f"{r['peak_gib']:.2f}" for r in rk)
        + f" (single batch 8: {s8['peak_gib']:.2f}); together: the first "
        f"rank's start to the last rank's end, the ranks' windows starting "
        f"at barriers at most {tog['start_skew_s'] * 1e3:.2f} ms apart; pack "
        f"written in {res['pack_write_s']:.1f} s, ranks "
        f"{res['spawn_s']:.1f} s")
    log(f"  mp dp hold: ranks agree {hold['ranks_agree']}; streams "
        f"{_log_tie(hold['streams'])}; {hold['equal_to_batch8']} of "
        f"{MP_DP_PROMPTS} equal to the batch-8 engine's; per rank first-"
        "decode logits bit-equal to the batch-4 engine's "
        f"{[x['dec_bit_equal'] for x in hold['ranks']]}, streams equal "
        f"{[x['streams_equal'] for x in hold['ranks']]}; launches "
        f"(rank, batch-4 engine) "
        f"{[x['launches_equal'] for x in hold['ranks']]}")
    log(f"  mp dp fault (rank 1's scales x {MP_FAULT_SCALE}): first-decode "
        "logits bit-equal "
        f"{[x['dec_bit_equal'] for x in fault['ranks']]}, rms rel "
        f"{[round(x['dec_gap']['rms_rel'], 5) for x in fault['ranks']]}; "
        f"streams equal {[x['streams_equal'] for x in fault['ranks']]}: "
        f"{'REJECTED' if not fault['ok'] else 'PASSED'}")
    if not hold["ok"] or any(wrong.values()):
        raise AssertionError(f"mp dp: the hold fails (ok {hold['ok']}) or "
                             f"launches differ {wrong}")
    if fault["ok"]:
        raise AssertionError("mp dp: the planted fault passed the hold")
    counts = {}
    for r, _ in ranks:
        for k, v in r["clean"]["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return counts


def mp_tp(torch, device, seed, name, inproc: dict, out: dict) -> dict:
    """A TP leg: the tp phase's pack (taken from ``inproc``) written, tp
    ranks of one shard, each rank's launches one shard's of the in-process
    run (_tp_expected / tp, exactly); the prefill and first-decode logits
    against the in-process TP engine's (bit identity reported, held to
    E2E_TOL), all ranks alike, the streams under the near-tie rule; the
    planted fault must fail. Returns the ranks' launches summed."""
    from omniquant_tpu_torch.models import LLAMA
    from omniquant_tpu_torch.models.common import ActQuantSpec
    from omniquant_tpu_torch.utils import save_pytree

    model, tp, kv, abits = TP_RUNS[name]
    res = out[name] = dict(tp=tp, kv=kv, abits=abits)
    cfg, packed = inproc.pop("pack")
    t = time.time()
    save_pytree(os.path.join(MP_DIR, f"{name}_pack.npz"), packed)
    with open(os.path.join(MP_DIR, f"{name}_first.json"), "w") as f:
        json.dump(inproc["first"], f)
    res["pack_write_s"] = time.time() - t
    t = time.time()
    ranks = mp_spawn(name, tp, seed, MP_TIMEOUT_S[name])
    res["spawn_s"] = time.time() - t
    os.remove(os.path.join(MP_DIR, f"{name}_pack.npz"))
    reqs = prompts(torch, TP_BATCH, TP_PROMPT_LEN, cfg.vocab_size, seed + 22)
    spec = ActQuantSpec.from_bits(abits)
    tol = E2E_TOL if abits == 16 else E2E_INT_TOL[abits]
    bound = SPEC_TIE * tol["max"]
    r0, t0 = ranks[0]
    want = {k: v // tp for k, v in _tp_expected(
        name, tp, cfg.num_hidden_layers, 1 + 8 * TP_DISPATCHES,
        TP_DISPATCHES).items()}
    wrong = {r: {k: (res_r["launches"][k], v) for k, v in want.items()
                 if res_r["launches"][k] != v}
             for r, (res_r, _) in enumerate(ranks)}
    missing = [k for k in TP_PATHS[name] if r0["launches"][k] <= 0]

    def hold(prefill, dec, streams, fault=False):
        n = len(streams)  # the fault runs the first MP_TP_FAULT_REQS
        want = inproc["prefill"][:n]
        h = dict(prefill_logits=logit_gap(prefill, want),
                 prefill_bit_equal=bool(torch.equal(prefill, want)),
                 streams=near_tie(stream_gaps(torch, LLAMA, cfg, packed,
                                              reqs[:n], streams, spec),
                                  bound))
        if not fault:
            h.update(decode_logits=logit_gap(dec, inproc["dec"]),
                     decode_bit_equal=bool(torch.equal(dec, inproc["dec"])),
                     streams_equal_in_process=sum(
                         a == b for a, b in zip(streams, inproc["streams"])))
        h["ok"] = (gap_within(h["prefill_logits"], tol)
                   and (fault or gap_within(h["decode_logits"], tol))
                   and h["streams"]["ok"])
        return h

    h = res["hold"] = hold(t0["prefill"], t0["dec"], r0["streams"])
    h["ranks_agree"] = all(
        torch.equal(t["prefill"], t0["prefill"])
        and torch.equal(t["dec"], t0["dec"]) and r["streams"] == r0["streams"]
        for r, t in ranks)
    f = res["fault"] = hold(t0["fault_prefill"], None, r0["fault_streams"],
                            fault=True)
    res["ranks"] = [{k: r[k] for k in (
        "load_s", "place_s", "prefill_s", "prefill_tok_s", "decode_s",
        "step_s", "decode_tok_s", "peak_gib", "run_peak_gib", "shard_gib",
        "local", "held", "backend", "device")} for r, _ in ranks]
    ip = inproc["readings"]
    rk = res["ranks"]
    log(f"  mp tp {name} ({model}, {cfg.num_hidden_layers} layers, {tp} "
        f"ranks of one shard, {kv} KV, {rk[0]['backend']}): a step "
        f"{max(r['step_s'] for r in rk) * 1e3:.2f} ms (in-process mesh "
        f"{ip['tp_engine']['step_s'] * 1e3:.2f}, single engine "
        f"{ip['single']['step_s'] * 1e3:.2f}); step_n tok/s "
        f"{min(r['decode_tok_s'] for r in rk):.1f} (in-process "
        f"{ip['tp_engine']['decode_tok_s']:.1f}, single "
        f"{ip['single']['decode_tok_s']:.1f}); prefill tok/s "
        f"{min(r['prefill_tok_s'] for r in rk):.1f} (in-process "
        f"{ip['tp_engine']['prefill_tok_s']:.1f}, single "
        f"{ip['single']['prefill_tok_s']:.1f}); a shard "
        f"{max(r['shard_gib'] for r in rk):.3f} GiB (in-process "
        f"{max(ip['tp_engine']['shard_gib']):.3f}), peak a rank "
        f"{max(r['peak_gib'] for r in rk):.2f} GiB; read "
        f"{max(r['load_s'] for r in rk):.1f} s, placed "
        f"{max(r['place_s'] for r in rk):.1f} s, pack written "
        f"{res['pack_write_s']:.1f} s, ranks {res['spawn_s']:.1f} s; "
        f"launches a rank {r0['launches']}")
    log(f"  mp tp {name} against the in-process TP engine: prefill logits "
        f"bit-equal {h['prefill_bit_equal']} (rms rel "
        f"{h['prefill_logits']['rms_rel']:.3g}, max rel "
        f"{h['prefill_logits']['max_rel']:.3g}; tol {tol['rms']}, "
        f"{tol['max']}), first decode bit-equal {h['decode_bit_equal']}; "
        f"ranks agree {h['ranks_agree']}; streams {_log_tie(h['streams'])}, "
        f"{h['streams_equal_in_process']} of {len(reqs)} equal to the "
        f"in-process engine's")
    log(f"  mp tp {name} fault (the last shard's partial left out of every "
        f"sum): prefill logits rms rel {f['prefill_logits']['rms_rel']:.3g};"
        f" streams {_log_tie(f['streams'])}: "
        f"{'REJECTED' if not f['ok'] else 'PASSED'}")
    if any(wrong.values()) or missing:
        raise AssertionError(f"mp tp {name}: launches (got, want) {wrong}, "
                             f"never launched {missing}")
    if not (h["ok"] and h["ranks_agree"]):
        raise AssertionError(f"mp tp {name}: the ranks fail the hold")
    if f["ok"]:
        raise AssertionError(f"mp tp {name}: the planted fault passed")
    counts = {}
    for r, _ in ranks:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    del packed
    torch.cuda.empty_cache()
    return counts


def _mp_sp_hold(torch, ranks, inproc, run: str, layers: int) -> dict:
    """The SP hold on ``run`` ("clean" or "fault") of every rank (module
    constants above)."""
    s_local = inproc["capture"].shape[0] // MP_SP_RANKS
    lwc0 = ranks[0][1][f"{run}_lwc"]
    losses = ranks[0][0][run]["losses"]
    h = dict(
        capture_bit_equal=[bool(torch.equal(
            t[f"{run}_capture"], inproc["capture"][r * s_local:
                                                   (r + 1) * s_local]))
            for r, (_, t) in enumerate(ranks)],
        ranks_agree=all(torch.equal(t[f"{run}_lwc"], lwc0)
                        and res[run]["losses"] == losses
                        for res, t in ranks),
        loss_max_rel_gap=max(abs(a - b) / abs(b) for a, b in zip(
            losses, inproc["losses"])),
        lwc_rms_gap=(lwc0 - inproc["lwc"]).pow(2).mean().sqrt().item())
    # shard r of the causal ring attends r + 1 blocks a ring; a ring a
    # window, layer and pass (fp and propagation)
    h["k2_stats"] = [(res[run]["launches"]["flash_attention_stats"],
                      layers * SP_NSAMPLES * 2 * (r + 1))
                     for r, (res, _) in enumerate(ranks)]
    h["within_sp_phase"] = (h["loss_max_rel_gap"] <= SP_LOSS_RTOL
                            and h["lwc_rms_gap"] <= SP_LWC_RMS)
    h["ok"] = (all(h["capture_bit_equal"]) and h["ranks_agree"]
               and h["within_sp_phase"]
               and h["loss_max_rel_gap"] <= MP_SP_LOSS_RTOL
               and h["lwc_rms_gap"] <= MP_SP_LWC_RMS
               and all(a == b for a, b in h["k2_stats"]))
    return h


def mp_sp(torch, device, seed, inproc: dict, res: dict) -> dict:
    """The SP leg: MP_SP_RANKS ranks, the clean run held (must pass), the
    fault run (must fail). Returns the ranks' launches summed (clean
    runs)."""
    from omniquant_tpu_torch.models import llama

    layers = llama.LlamaConfig(**SP_LLAMA).num_hidden_layers
    t = time.time()
    ranks = mp_spawn("sp", MP_SP_RANKS, seed, MP_TIMEOUT_S["sp"])
    res["spawn_s"] = time.time() - t
    hold = res["hold"] = _mp_sp_hold(torch, ranks, inproc, "clean", layers)
    fault = res["fault"] = _mp_sp_hold(torch, ranks, inproc, "fault", layers)
    res["ranks"] = [dict({k: r["clean"][k] for k in (
        "steps", "step_s", "fp_pass_s", "propagate_s", "phase_s", "peak_gib",
        "ring_calls")}, backend=r["backend"], device=r["device"],
        local=r["local"]) for r, _ in ranks]
    rk = res["ranks"]
    log(f"  mp sp ({MP_SP_RUN}: LLaMA-2-7B widths, {layers} layers, "
        f"{SP_NSAMPLES} x {SP_CALIB_RUNS[MP_SP_RUN][1]} tokens, the ring "
        f"across {MP_SP_RANKS} ranks of one shard, {rk[0]['backend']}): a "
        f"step {max(r['step_s'] for r in rk):.4f} s (the slowest rank; "
        f"in-process SPMesh {inproc['step_s']:.4f}, single device "
        f"{inproc['single_step_s']:.4f}); peak GiB a rank "
        + " / ".join(f"{r['peak_gib']:.2f}" for r in rk)
        + f" (in-process {inproc['peak_gib']:.2f}, single device "
        f"{inproc['single_peak_gib']:.2f}); fp pass s a layer "
        + " / ".join(", ".join(f"{x:.3f}" for x in r["fp_pass_s"])
                     for r in rk) + f"; ranks {res['spawn_s']:.1f} s")
    for name, h in (("hold", hold), ("fault (rank 1 hands zeros back for "
                                     "dk/dv)", fault)):
        log(f"  mp sp {name}: capture bit-equal to the in-process mesh's "
            f"{h['capture_bit_equal']}; ranks agree {h['ranks_agree']}; "
            f"losses max rel gap {h['loss_max_rel_gap']:.3g} (tol "
            f"{MP_SP_LOSS_RTOL}, sp phase {SP_LOSS_RTOL}); LWC rms gap "
            f"{h['lwc_rms_gap']:.3g} (tol {MP_SP_LWC_RMS}, sp phase "
            f"{SP_LWC_RMS}); K2 stats launches (got, want) a rank "
            f"{h['k2_stats']}: {'PASSED' if h['ok'] else 'REJECTED'}")
    if not hold["ok"]:
        raise AssertionError(f"mp sp: the ranks fail the hold: {hold}")
    if fault["ok"]:
        raise AssertionError("mp sp: the planted fault passed the hold")
    counts = {}
    for r, _ in ranks:
        for k, v in r["clean"]["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return counts


def mp_phase(torch, device, seed, out: dict, inproc: dict) -> dict:
    """DP (and its torchrun-style launch), the TP legs (``inproc``: the tp
    phase's in-process results of MP_TP_RUNS), then SP (``inproc``
    [MP_SP_RUN]: the sp phase's in-process run). Returns the ranks'
    launches summed over the legs."""
    os.makedirs(MP_DIR, exist_ok=True)
    res = out["mp"] = {}
    counts = {}
    legs = [("dp", lambda: mp_dp(torch, device, seed, res.setdefault(
        "dp", {})))] + [(name, lambda name=name: mp_tp(
            torch, device, seed, name, inproc[name], res))
        for name in MP_TP_RUNS] + [("sp", lambda: mp_sp(
            torch, device, seed, inproc[MP_SP_RUN], res.setdefault(
                "sp", {})))]
    for leg, run in legs:
        t = time.time()
        for k, v in run().items():
            counts[k] = counts.get(k, 0) + v
        res[leg]["leg_s"] = time.time() - t
        torch.cuda.empty_cache()
    return counts

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    # one rank of the mp phase (spawned by mp_spawn)
    ap.add_argument("--mp-rank", default=None, help=argparse.SUPPRESS)
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
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
    if args.mp_rank:
        return mp_rank_main(torch, args)
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
    log("kernels at the tp phase's per-shard shapes (LLaMA-2-70B at tp 8, "
        "LLaMA-2-7B at tp 2, OPT-2.7B's retiled out_proj)")
    tp_k1, tp_k6 = check_tp_kernels(torch, device, timer, out)
    results["quant_matmul"]["tp"] = tp_k1
    results["quant_matmul"]["max_abs_err"] = max(
        [results["quant_matmul"]["max_abs_err"]]
        + [r["max_abs_err"] for r in tp_k1])
    results["decode_attention_int8"]["tp"] = tp_k6
    results["decode_attention_int8"]["max_abs_err"] = max(
        [results["decode_attention_int8"]["max_abs_err"]]
        + [r["max_abs_err"] for r in tp_k6])
    log("probes: the Hopper probes of the JAX package's experiment scripts "
        "(S1-S4) against their plain versions at the scripts' shapes, then "
        "their drivers")
    probe_rows, probe_counts = probes_phase(torch, device, timer, out)
    results.update(probe_rows)
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
    harness_counts = opt27b_phase(torch, device, args.seed, out)
    out["opt27b_phase_s"] = time.time() - t_opt27
    log(f"  opt27b phase {out['opt27b_phase_s']:.1f} s (the harness phase "
        f"{out['harness']['phase_s']:.1f} s of it)")

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

    log("sp: sequence-parallel calibration on the card: K2 with its softmax "
        "stats, the ring over 4096 tokens at sp 2 and 4, then LLaMA-2-7B "
        "widths (2 layers) at 4096 tokens and OPT-2.7B widths (2 layers) at "
        "2048, each over 2 shards, against the single-device run")
    t_sp = time.time()
    mp_keep = {}
    sp_counts = sp_phase(torch, device, args.seed, out, mp_keep)
    out["sp_phase_s"] = time.time() - t_sp
    log(f"  sp phase {out['sp_phase_s']:.1f} s")
    stats = out["sp"]["k2_stats"]
    head = str(SP_K2[0])
    results["flash_attention_stats"] = dict(
        stats[head], cases={k: v for k, v in stats.items() if k != head})

    log("profile: one decode step of engines A and E under torch.profiler")
    profile_decode(torch, device, cfg, dims, args.seed, out)

    log(f"tp: tensor-parallel serving with every shard on the card: "
        f"LLaMA-2-7B widths at tp 2 (2 layers, W4A16 and W4A4), then "
        f"LLaMA-2-70B widths at tp 8 ({TP_70B_LAYERS} of 80 layers, W3 g128, "
        f"bf16 and int8 KV), each against the single engine of its pack")
    t_tp = time.time()
    tp_counts = tp_phase(torch, device, args.seed, out, mp_keep)
    out["tp_phase_s"] = time.time() - t_tp
    log(f"  tp phase {out['tp_phase_s']:.1f} s")

    log(f"mp: multi-process serving, every rank on the card (gloo): DP over "
        f"{MP_DP_RANKS} ranks at LLaMA-7B widths (32 layers, W4A16 g128) "
        f"against one engine at batch {MP_DP_PROMPTS}; then TP with one "
        f"shard a rank: LLaMA-2-7B widths at tp 2 and LLaMA-2-70B widths at "
        f"tp 8 ({TP_70B_LAYERS} layers, int8 KV) against the tp phase's "
        f"in-process mesh")
    t_mp = time.time()
    mp_counts = mp_phase(torch, device, args.seed, out, mp_keep)
    del mp_keep
    out["mp_phase_s"] = time.time() - t_mp
    log(f"  mp phase {out['mp_phase_s']:.1f} s")

    # the serve, spec, harness, sp, tp and mp phases' launches per entry
    # (mp: its ranks' main runs): K1's count holds both layouts
    counts = {k: v + spec_counts.get(k, 0) + harness_counts.get(k, 0)
              + sp_counts.get(k, 0) + tp_counts.get(k, 0)
              + mp_counts.get(k, 0) for k, v in counts.items()}
    planar = (counts["quant_matmul_planar_decode"]
              + counts["quant_matmul_planar_prefill"])
    launches = dict(counts, quant_matmul=counts["quant_matmul"] - planar,
                    quant_matmul_planar=planar)
    # the probes lie on no serving path: the drivers' run is theirs
    stray = {k: launches[k] for k in probe_rows if launches[k]}
    if stray:
        raise AssertionError(f"probes launched on the serving path: {stray}")
    launches.update({k: probe_counts[k] for k in probe_rows})
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
    hr = out["harness"]
    log("harness (run_tasks on OPT-2.7B: loglikelihood requests/s, "
        "loglikelihood_rolling windows/s, greedy_until tokens/s, run s; the "
        "phase's s): " + "; ".join(
            f"{k} {hr[k]['rates']['loglikelihood_req_s']:.1f}, "
            f"{hr[k]['rates']['rolling_windows_s']:.2f}, "
            f"{hr[k]['rates']['greedy_until_tok_s']:.1f}, "
            f"{hr[k]['rates']['run_s']:.2f}" for k in ("w4a16", "w4a4"))
        + f"; {hr['phase_s']:.1f}; on:")
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
    log("sp (K2 ms with / without stats at (1, 32, 2048, 128) causal; ring "
        "flash / plain ms over 4096 tokens; SP and single-device calibration "
        "s a step, peak GiB; held-out MSE SP vs RTN): "
        f"{stats[head]['ms']:.4f} / {stats[head]['ms_without_stats']:.4f}; "
        + "; ".join(f"sp {n} {r['flash_ms']:.4f} / {r['plain_ms']:.4f}"
                    for n, r in out["sp"]["ring"].items()) + "; " + "; ".join(
            f"{k} {v['sp_step_s']:.4f}, {v['sp_peak_gib']:.2f} vs "
            f"{v['single_step_s']:.4f}, {v['single_peak_gib']:.2f}; "
            f"{v['held_out_mse']['sp']:.4g} vs {v['held_out_mse']['rtn']:.4g}"
            for k, v in out["sp"].items() if k in SP_CALIB_RUNS) + "; on:")
    log(smi)
    tpr = out["tp"]
    log("tp (TP engine / single engine: prefill tok/s, step_n tok/s, a step "
        "ms; a shard's / the shards' GiB; peak GiB; prefill logits rms rel; "
        "fault prefill rms rel): " + "; ".join(
            f"{k} tp {v['tp']} {v['tp_engine']['prefill_tok_s']:.1f} / "
            f"{v['single']['prefill_tok_s']:.1f}, "
            f"{v['tp_engine']['decode_tok_s']:.1f} / "
            f"{v['single']['decode_tok_s']:.1f}, "
            f"{v['tp_engine']['step_s'] * 1e3:.2f} / "
            f"{v['single']['step_s'] * 1e3:.2f}; "
            f"{max(v['tp_engine']['shard_gib']):.3f} / "
            f"{v['tp_engine']['total_gib']:.3f}; "
            f"{v['tp_engine']['peak_gib']:.2f}; "
            f"{v['hold']['prefill_logits']['rms_rel']:.3g}; "
            f"{v['fault']['prefill_logits']['rms_rel']:.3g}"
            for k, v in tpr.items() if k in TP_RUNS)
        + "; busy share TP / single: "
        + " / ".join(str(tpr["70b_int8"][w]["profile"]["busy_share"])
                     for w in ("tp_engine", "single")) + "; on:")
    log(smi)
    log("tp perplexity (--eval_ppl --tp 8, LLaMA-2-70B widths, "
        f"{TP_70B_LAYERS} layers, one {TP_PPL_SEQLEN}-token window: TP / "
        "single-device s a window; peak GiB; logits rms rel to the single "
        "device; column-parallel sites apart; row shards' worst rms rel; "
        "the faults' readings, local ranges / shard 0's scales x "
        f"{TP_PPL_FAULT_SCALE}): " + "; ".join(
            f"{k} {v['tp_s_per_window']:.3f} / "
            f"{v['single_s_per_window']:.3f}, {v['peak_gib']:.2f}, "
            f"{v['hold']['logits']['rms_rel']:.4g}, "
            f"{v['hold']['sites']['apart']} of {v['hold']['sites']['sites']},"
            f" {v['hold']['row_shards']['worst_rms_rel']:.3g}; faults "
            f"{v['faults']['local_ranges']['sites']['apart']} of "
            f"{v['faults']['local_ranges']['sites']['sites']}, "
            f"{v['faults']['local_ranges']['logits']['rms_rel']:.4g} / "
            f"{v['faults']['scale_shard0']['row_shards']['worst_rms_rel']:.3g}"
            f", {v['faults']['scale_shard0']['logits']['rms_rel']:.4g}"
            for k, v in tpr.items() if k in TP_PPL_RUNS) + "; on:")
    log(smi)
    mpr = out["mp"]
    dp = mpr["dp"]
    log("mp (DP: prefill / step_n tok/s of the ranks together and of the "
        "single engine at batch 8, peak GiB a rank; TP a rank of one shard "
        "/ in-process mesh / single engine: a step ms, step_n tok/s; a "
        "shard's GiB; prefill logits bit-equal to the in-process mesh's): "
        f"dp {dp['together']['prefill_tok_s']:.1f} / "
        f"{dp['single_batch8']['prefill_tok_s']:.1f}, "
        f"{dp['together']['decode_tok_s']:.1f} / "
        f"{dp['single_batch8']['decode_tok_s']:.1f}, "
        + " / ".join(f"{r['peak_gib']:.2f}" for r in dp["ranks"]) + "; "
        + "; ".join(
            f"{k} {max(r['step_s'] for r in v['ranks']) * 1e3:.2f} / "
            f"{tpr[k]['tp_engine']['step_s'] * 1e3:.2f} / "
            f"{tpr[k]['single']['step_s'] * 1e3:.2f}, "
            f"{min(r['decode_tok_s'] for r in v['ranks']):.1f} / "
            f"{tpr[k]['tp_engine']['decode_tok_s']:.1f} / "
            f"{tpr[k]['single']['decode_tok_s']:.1f}; "
            f"{max(r['shard_gib'] for r in v['ranks']):.3f}; "
            f"{v['hold']['prefill_bit_equal']}"
            for k, v in mpr.items() if k in MP_TP_RUNS) + "; on:")
    log(smi)
    msp = mpr["sp"]
    log(f"mp sp (the ring across {MP_SP_RANKS} ranks, {MP_SP_RUN}: s a step "
        "the slowest rank / in-process SPMesh / single device; peak GiB a "
        "rank; losses max rel gap, LWC rms gap to the in-process run; the "
        "fault's): "
        f"{max(r['step_s'] for r in msp['ranks']):.4f} / "
        f"{out['sp'][MP_SP_RUN]['sp_step_s']:.4f} / "
        f"{out['sp'][MP_SP_RUN]['single_step_s']:.4f}; "
        + " / ".join(f"{r['peak_gib']:.2f}" for r in msp["ranks"])
        + f"; {msp['hold']['loss_max_rel_gap']:.3g}, "
        f"{msp['hold']['lwc_rms_gap']:.3g}; "
        f"{msp['fault']['loss_max_rel_gap']:.3g}, "
        f"{msp['fault']['lwc_rms_gap']:.3g}; dp launched with torchrun's "
        f"variables equal to the explicit launch "
        f"{all(a['streams_equal'] and a['dec_bit_equal'] for a in dp['auto'])}"
        "; on:")
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
