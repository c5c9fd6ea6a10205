"""How far a CUDA kernel may stray from its plain PyTorch version.

quant_matmul, flash_attention, decode_attention_int8 and the integer
products (quant_matmul_int, _quant_matmul_int_dense) sum in f32 in both
versions and round each output to bf16 once, so an element may differ by a
rounding step of its own size. The bound is per element, never a share of
the tensor's largest value, so small outputs (late rows of causal
attention) are held as tightly as large ones. Each kernel adds a slack for
what it rounds that its plain version does not. ``chip_smoke.py`` and the
card tests use these rules; the KV-cache writes are copies and are held
exact, and so is _unpack_to_int8.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_plain

# quant_matmul, on pairs and on planar words alike: both versions sum exact
# bf16 x code products in f32 (every code up to 255 is exact in bf16) and
# only the order differs (per-group scales applied after each run's sum, or
# dequantized weights), ~1e-6 at outputs of order 1; this floor covers the
# elements whose own rounding step is smaller than that.
QUANT_MATMUL_SLACK = 2.0 ** -10

# decode_attention_int8: the kernel keeps q.k, the scales, exp and p * vs in
# f32 (its plain version dequantizes in f32 and attends densely); only the
# summation order and the fast exp differ, ~1e-6 of the largest |v|, so it
# is held like quant_matmul.
DECODE_ATTENTION_SLACK = 2.0 ** -10

# the integer products: the group dots are exact int32 in both versions,
# and only the order of the f32 sum of the terms dot_g * sc_g and
# xsum_g * off2_g differs (per split-K slice and per group in the kernels,
# per K tile in the plain versions). Up to ~2 adds per group (176 at K =
# 11264) each round by 2^-24 of a partial sum no larger than the sum of the
# terms' magnitudes: 2^-14 of that sum leaves a margin of 4. The slack of an
# element is this times xs * sum_g (|dot_g| |sc_g| + |xsum_g off2_g|), which
# the plain versions return with ``magnitude=True``.
INT_MATMUL_SLACK = 2.0 ** -14


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |a|, element-wise (0 where a is 0)."""
    a = a.float().abs()
    step = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return torch.where(a > 0, step, torch.zeros_like(a))


def bf16_close(got: torch.Tensor, want: torch.Tensor, slack) -> tuple:
    """Hold ``got`` to |got - want| <= 2 ulp_bf16(|want|) + slack element-wise
    (``slack`` a number or a tensor of want's shape). Returns (within the
    bound, max abs error, largest error / bound)."""
    err = (got.float() - want.float()).abs()
    bound = 2 * bf16_ulp(want) + slack
    # an exact element meets any bound, a zero one too (0 / 0 is no excess)
    worst = torch.where(err == 0, 0.0, err / bound).max().item()
    return worst <= 1.0, err.max().item(), worst


def flash_attention_slack(q, k, v, sm_scale: Optional[float] = None,
                          causal: bool = True,
                          alibi_slopes: Optional[torch.Tensor] = None):
    """Slack of the flash kernel, per output element. It rounds each
    unnormalised probability p <= 1 to bf16 (by at most 2^-9 p) before the
    p.v product, which moves an output by at most 2^-9 sum_j p_j |v_j| / l:
    the plain attention over |v|, times 2^-9. The slack is twice that."""
    return 2.0 ** -8 * flash_attention_plain(
        q.float(), k.float(), v.float().abs(), sm_scale, causal, alibi_slopes)



# flash_attention's softmax stats (return_stats, which ring attention
# merges): both versions take each score as an f32 sum of the same exact
# bf16 products, in another order, which moves a scaled score by at most
# D 2^-24 sum_i |q_i k_i| sm_scale (8.6e-5 for unit-variance q and k at
# head_dim 128); the kernel's max runs on raw or exp2-domain scores and is
# converted to scaled units in its epilogue (an ulp), and its l sums
# ex2.approx terms (2 ulps each) in f32. So m is held to 2^-12 (1 + |m|)
# absolute and l to 2^-12 of itself: a max in raw-score units, a lost key
# tile or an unrescaled sum fails (tests/test_torch_ring_attention.py).
FLASH_STATS_SLACK = 2.0 ** -12


def flash_stats_close(m_got, l_got, m_want, l_want) -> tuple:
    """Hold K2's stats to the plain version's, element-wise: |dm| <=
    2^-12 (1 + |m|), |dl| <= 2^-12 l. Returns (within the bounds, max abs
    error of m, max relative error of l, largest error / bound)."""
    m_want, l_want = m_want.float(), l_want.float()
    dm = (m_got.float() - m_want).abs()
    dl = (l_got.float() - l_want).abs()
    worst = max(
        (dm / (FLASH_STATS_SLACK * (1 + m_want.abs()))).max().item(),
        torch.where(dl == 0, 0.0,
                    dl / (FLASH_STATS_SLACK * l_want)).max().item())
    rel_l = (dl / l_want.clamp_min(1e-30)).max().item()
    return worst <= 1.0, dm.max().item(), rel_l, worst


# The Hopper probes (kernels/probes.py) against their plain versions, as a
# share of the output's largest |value|: consume (S4), f32inj_matmul (S3)
# and ablate_decode (S1) round an f32 sum to bf16 once (2^-8 of an element
# at most; the sums differ only in order); mxu_rate_bf16 (S2) adds 64 f32
# products summed in another order; mxu_rate_int8 sums integers exactly.
PROBE_REL_TOL = {"consume": 1e-2, "mxu_rate_bf16": 1e-5, "mxu_rate_int8": 0.0,
                 "f32inj_matmul": 1e-2, "ablate_decode": 1e-2}


def probe_close(got: torch.Tensor, want: torch.Tensor, name: str) -> tuple:
    """Hold a probe's output to PROBE_REL_TOL[name] of want's largest
    |value|. Returns (within the bound, max abs error, that error over the
    largest |value|)."""
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(got.float()).all())
    return finite and rel <= PROBE_REL_TOL[name], err, rel
