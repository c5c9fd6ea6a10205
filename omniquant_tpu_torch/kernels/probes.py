"""Hopper probes: the four Pallas kernels of the JAX package's experiment
scripts (``scripts/exp_*.py``), each with its plain PyTorch version.

They sit on no serving or calibration path. Each computes what its script's
kernel computes, on the operands the script builds, and its driver in
``omniquant_tpu_torch/scripts/`` times it on the card:

* S4 ``consume`` (exp_ablate_int.py ``_consume_kernel``): int8 (M, K) x
  centered int8 (K, N) codes, group dots of ``BK / n_dots`` rows into s32,
  each times its group's f32 scale from slabs (K / BK, 8, N), summed in f32,
  bf16 out. ``n_dots`` 1 is one dot per BK rows times the first group's
  scale (the script's rate probe, not the exact algebra).
* S2 ``mxu_rate_bf16`` / ``mxu_rate_int8`` (exp_mxu_rates.py ``kern_bf16`` /
  ``kern_i8``): the sum of ``inner`` products x . w of 512-deep operands,
  f32 (int8: s32 sums, cast), repeated ``repeats`` times as the script's
  grid repeats it.
* S3 ``f32inj_matmul`` (exp_unpack_variants.py ``_kernel_f32inj``): the
  mantissa-injection decode product on planar words, codes turned into
  1 + c/2^b, with the scale slabs sc2 = sc * 2^b and off2 = -z*sc - sc2
  (``f32inj_slabs``) and the xsum . off2 term; equal to x @ dequant(W).
* S1 ``ablate_decode`` (exp_ablate_kernel.py ``_kernel``): sum_g (x_g . c_g)
  * sc_g on planar words (no zero points; ``ablate_slabs``), run on the
  card by K1's planar decode tile with K1's split-K plan, in the modes
  ``full``, ``noup`` (the products on a tile broadcast from x[0, tile +
  n mod bn], no unpack; needs bn <= bk, as the script's broadcast does) and
  ``nodot`` (the first M rows of each code tile, summed over tiles).

Slabs follow the scripts: per pack tile of ``tile_k`` rows, its groups'
rows (the last group repeated where the tile runs past the last group),
padded to 8 rows. On a CUDA tensor each wrapper launches its kernel in
``csrc/probes.cu`` or raises (the CUDA kernels take the scripts' geometry:
see each wrapper); on a CPU tensor it runs the plain version. Each launch
adds one to the wrapper's ``launches``; ``ablate_decode`` also counts by
mode (``launches_full``, ``launches_noup``, ``launches_nodot``).
"""
from __future__ import annotations

import torch

from ..quant.packing import PackedWeight, _unpack_planar
from . import _build
from . import quant_matmul as _qmm

MXU_INNER = 64    # products a repeat sums (the script's INNER)
MXU_REPEATS = 64  # repeats (the script's grid)
MXU_DEPTH = 512   # the operands' inner dimension (the script's KK)
ABLATE_MODES = ("full", "noup", "nodot")
_TILE = 512        # the pack tile and quant group the decode probes take
_GROUP = 128
_AB_CTAS: dict = {}  # (device, bits) -> S1's CTAs per SM


def _slabs(rows: torch.Tensor, nk: int, n_g: int) -> torch.Tensor:
    """(G, n) per-group rows -> (nk, ceil8(n_g), n) slabs: the last group
    repeated up to nk * n_g rows, each tile's rows padded to 8."""
    need = nk * n_g
    if rows.shape[0] < need:
        rows = torch.cat([rows, rows[-1:].expand(need - rows.shape[0], -1)])
    rows = rows[:need].reshape(nk, n_g, rows.shape[1])
    ngp = -(-n_g // 8) * 8
    return torch.nn.functional.pad(rows, (0, 0, 0, ngp - n_g))


def _tiles(pw: PackedWeight) -> tuple:
    """(tiles, groups a tile) of a planar grouped pack, as the scripts cut
    it."""
    if pw.layout != "planar" or not pw.group_size:
        raise ValueError("the decode probes read planar words with groups")
    k_pad = pw.qweight.shape[0] * 32 // pw.bits
    return k_pad // pw.tile_k, pw.tile_k // pw.group_size


def _check_cuda(name: str, *ts) -> None:
    for t in ts:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: every operand contiguous on the card")


# ---------------------------------------------------------------------------
# S4

def consume_plain(xc, w8, sc_slabs, n_dots: int) -> torch.Tensor:
    """Plain version: per k tile of BK = K / len(sc_slabs) rows and group
    of BK / n_dots rows, the exact integer dot (an f32 product of integers
    whose sums stay below 2^24) times the group's scale, summed in f32
    (n_dots 1: the first group's scale); bf16 out."""
    M, K = xc.shape
    nk = sc_slabs.shape[0]
    bk = K // nk
    gs = bk // n_dots
    acc = torch.zeros(M, w8.shape[1], dtype=torch.float32, device=xc.device)
    for j in range(nk):
        for g in range(n_dots):
            lo = j * bk + g * gs
            d = xc[:, lo:lo + gs].float() @ w8[lo:lo + gs].float()
            acc += d * sc_slabs[j, g].float()
    return acc.to(torch.bfloat16)


def consume(xc, w8, sc_slabs, n_dots: int) -> torch.Tensor:
    """S4 on the card (mma.sync m16n8k32 s8, one close per group; N and K
    multiples of 128, the group BK / n_dots a multiple of 32 up to 512) or
    its plain version on the CPU."""
    M, K = xc.shape
    nk = sc_slabs.shape[0]
    if K % nk or (K // nk) % n_dots or w8.shape[0] != K:
        raise ValueError(f"consume: K {K} does not split into {nk} tiles of "
                         f"{n_dots} groups")
    if not xc.is_cuda:
        return consume_plain(xc, w8, sc_slabs, n_dots)
    N, bk = w8.shape[1], K // nk
    gs = bk // n_dots
    _check_cuda("consume", xc, w8, sc_slabs)
    if not (xc.dtype == w8.dtype == torch.int8
            and sc_slabs.dtype == torch.float32):
        raise ValueError("consume: int8 codes and f32 scale slabs")
    if (N % 128 or K % 128 or gs not in (32, 64, 128, 256, 512)
            or tuple(sc_slabs.shape) != (nk, 8, N) or n_dots > 8):
        raise ValueError(f"consume takes N and K multiples of 128 and groups "
                         f"of 32-512 rows in (K / BK, 8, N) slabs, not N {N},"
                         f" K {K}, BK {bk}, n_dots {n_dots}")
    out = torch.empty(M, N, dtype=torch.bfloat16, device=xc.device)
    _build.launch("probes", "probe_consume", "ppppiiiii", xc.data_ptr(),
                  w8.data_ptr(), sc_slabs.data_ptr(), out.data_ptr(), M, N, K,
                  bk, gs)
    _build.count(consume, "launches")
    return out


# ---------------------------------------------------------------------------
# S2

def mxu_rate_plain(x, w, inner: int = MXU_INNER) -> torch.Tensor:
    """Plain version: the f32 product x . w added ``inner`` times in f32
    (bf16), or the exact integer product times ``inner`` cast to f32
    (int8, as s32 sums cast are)."""
    if x.dtype == torch.int8:
        return (torch.matmul(x.double(), w.double()) * inner).float()
    d = x.float() @ w.float()
    acc = torch.zeros_like(d)
    for _ in range(inner):
        acc += d
    return acc


def _mxu_rate(fn, x, w, inner, repeats, dtype):
    if x.dtype != dtype or w.dtype != dtype:
        raise ValueError(f"{fn.__name__} takes {dtype} operands")
    if not x.is_cuda:
        return mxu_rate_plain(x, w, inner)
    M, K = x.shape
    N = w.shape[1]
    _check_cuda(fn.__name__, x, w)
    if K != MXU_DEPTH or w.shape[0] != K or M % 64 or N % 128 or repeats % 4:
        raise ValueError(f"{fn.__name__} takes (M, {MXU_DEPTH}) . ("
                         f"{MXU_DEPTH}, N), M % 64 == 0, N % 128 == 0 and "
                         "repeats in fours")
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    _build.launch("probes", "probe_mxu_rate", "pppiiiii", x.data_ptr(),
                  w.data_ptr(), out.data_ptr(), M, N, inner, repeats,
                  int(dtype == torch.int8))
    _build.count(fn, "launches")
    return out


def mxu_rate_bf16(x, w, inner: int = MXU_INNER,
                  repeats: int = MXU_REPEATS) -> torch.Tensor:
    """S2's bf16 kernel (mma.sync m16n8k16, operands resident in shared
    memory) on the card, or its plain version on the CPU."""
    return _mxu_rate(mxu_rate_bf16, x, w, inner, repeats, torch.bfloat16)


def mxu_rate_int8(x, w, inner: int = MXU_INNER,
                  repeats: int = MXU_REPEATS) -> torch.Tensor:
    """S2's int8 kernel (mma.sync m16n8k32 s8) on the card, or its plain
    version on the CPU."""
    return _mxu_rate(mxu_rate_int8, x, w, inner, repeats, torch.int8)


def mxu_flops(M: int, N: int, inner: int = MXU_INNER,
              repeats: int = MXU_REPEATS) -> float:
    """The operations a call does: 2 M N K per product."""
    return 2.0 * M * N * MXU_DEPTH * inner * repeats


# ---------------------------------------------------------------------------
# S3

def _check_injection(bits: int) -> None:
    if bits not in (2, 4, 8):
        raise ValueError(f"mantissa injection takes the power-of-two widths "
                         f"2, 4 and 8 (one plane), not {bits}")


def f32inj_slabs(pw: PackedWeight) -> tuple:
    """(sc2, off2) slabs of the script's make_call: sc2 = sc * 2^b, off2 =
    -z*sc - sc2, f32 (tiles, 8, N)."""
    _check_injection(pw.bits)
    nk, n_g = _tiles(pw)
    sc = pw.scales.t().float()
    zp = pw.zeros.t().float()
    sc2 = sc * 2.0 ** pw.bits
    off2 = -zp * sc - sc2
    return _slabs(sc2, nk, n_g), _slabs(off2, nk, n_g)


def f32inj_matmul_plain(x, qweight, sc2, off2, bits: int,
                        tile_k: int, group_size: int) -> torch.Tensor:
    """Plain version: w' = 1 + c/2^b in f32, per tile (xsum . off2 over its
    groups) + sum_g (x_g . w'_g) * sc2_g in f32, summed over tiles; bf16."""
    _check_injection(bits)
    m = x.shape[0]
    codes = _unpack_planar(qweight.to(torch.int64) & 0xFFFFFFFF, bits, tile_k)
    w1 = 1.0 + codes.float() / 2.0 ** bits
    nk, n_g = codes.shape[0] // tile_k, tile_k // group_size
    acc = torch.zeros(m, qweight.shape[1], dtype=torch.float32,
                      device=x.device)
    for j in range(nk):
        xv = x[:, j * tile_k:(j + 1) * tile_k].float()
        xsum = xv.reshape(m, n_g, group_size).sum(-1)
        a = xsum @ off2[j, :n_g]
        for g in range(n_g):
            rows = slice(g * group_size, (g + 1) * group_size)
            d = xv[:, rows] @ w1[j * tile_k:(j + 1) * tile_k][rows]
            a += d * sc2[j, g]
        acc += a
    return acc.to(torch.bfloat16)


def _check_decode(name, x, qweight, bits, tile_k, group_size, slabs):
    M, K = x.shape
    N = qweight.shape[1]
    if x.dtype != torch.bfloat16 or qweight.dtype != torch.int32 or any(
            s.dtype != torch.float32 for s in slabs):
        raise ValueError(f"{name}: bf16 x, int32 words and f32 slabs")
    if (M > 32 or N % 128 or K % _TILE or tile_k != _TILE
            or group_size != _GROUP or qweight.shape[0] * 32 != K * bits
            or any(tuple(s.shape) != (K // _TILE, 8, N) for s in slabs)):
        raise ValueError(
            f"{name} takes M <= 32, N % 128 == 0 and planar words of "
            f"{_TILE}-row tiles and {_GROUP}-row groups over all K rows of "
            f"x, not M {M}, N {N}, K {K}, tile {tile_k}, group {group_size}")



def f32inj_matmul(x, qweight, sc2, off2, bits: int, tile_k: int,
                  group_size: int) -> torch.Tensor:
    """S3 on the card (codes injected into f32 and multiplied on the TF32
    tensor cores; M <= 32, N % 128 == 0, K % 512 == 0, tiles of 512 rows,
    groups of 128) or its plain version on the CPU."""
    _check_injection(bits)
    if not x.is_cuda:
        return f32inj_matmul_plain(x, qweight, sc2, off2, bits, tile_k,
                                   group_size)
    M, K = x.shape
    N = qweight.shape[1]
    _check_cuda("f32inj_matmul", x, qweight, sc2, off2)
    _check_decode("f32inj_matmul", x, qweight, bits, tile_k, group_size,
                  (sc2, off2))
    part = torch.empty(K // _TILE, M, N, dtype=torch.float32,
                       device=x.device)
    y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    _build.launch("probes", "probe_f32inj", "ppppppiiii", x.data_ptr(),
                  qweight.data_ptr(), sc2.data_ptr(), off2.data_ptr(),
                  part.data_ptr(), y.data_ptr(), M, N, K, bits)
    _build.count(f32inj_matmul, "launches")
    return y



# ---------------------------------------------------------------------------
# S1

def ablate_slabs(pw: PackedWeight) -> torch.Tensor:
    """The script's scale slabs: f32 (tiles, 8, N)."""
    nk, n_g = _tiles(pw)
    return _slabs(pw.scales.t().float(), nk, n_g)


def _check_mode(mode: str, bn: int, tile_k: int) -> None:
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode {mode!r} is not one of {ABLATE_MODES}")
    if mode == "noup" and bn > tile_k:
        raise ValueError(f"noup broadcasts x[0:1, :bn] to ({tile_k}, {bn}) "
                         f"and needs bn <= bk = {tile_k}, not bn {bn}")


def ablate_decode_plain(mode: str, x, qweight, sc, bits: int, tile_k: int,
                        group_size: int, bn: int) -> torch.Tensor:
    """Plain version, tile by tile as the script's grid goes: full sums
    (x_g . c_g) * sc_g, noup the same on w[k][n] = x[0, tile + n mod bn],
    nodot the tile's first M rows of codes; f32 sums, bf16 out."""
    _check_mode(mode, bn, tile_k)
    m, n = x.shape[0], qweight.shape[1]
    codes = _unpack_planar(qweight.to(torch.int64) & 0xFFFFFFFF, bits, tile_k)
    nk, n_g = codes.shape[0] // tile_k, tile_k // group_size
    acc = torch.zeros(m, n, dtype=torch.float32, device=x.device)
    cols = torch.arange(n, device=x.device) % bn
    for j in range(nk):
        tile = codes[j * tile_k:(j + 1) * tile_k]
        if mode == "nodot":
            acc += tile[:m].float()
            continue
        xv = x[:, j * tile_k:(j + 1) * tile_k]
        if mode == "noup":
            w = x[0, j * tile_k + cols].float().expand(tile_k, n)
        else:
            w = tile.to(x.dtype).float()
        for g in range(n_g):
            rows = slice(g * group_size, (g + 1) * group_size)
            acc += (xv[:, rows].float() @ w[rows]) * sc[j, g]
    return acc.to(torch.bfloat16)


def _ablate_plan(device, bits: int, m: int, n: int, k: int):
    """K1's planar split-K plan (``planar_decode_plan``) for S1's K walk of
    ``k`` rows (a step: 32 words a column, ``bits / 2`` steps a tile of
    512 rows) at S1's own CTAs per SM, asked of the card once per width."""
    key = (device.index or 0, bits)
    if key not in _AB_CTAS:
        n_ctas = _build.fn("probes", "probe_ablate_ctas", "i")(bits, None)
        if n_ctas < 1:
            raise RuntimeError(f"probes: S1 occupancy query failed ({n_ctas})")
        _AB_CTAS[key] = n_ctas
    return _qmm.planar_decode_plan(m, n, k // _TILE * (bits // 2),
                                   _qmm._sm_count(device), _AB_CTAS[key])


def ablate_decode(mode: str, x, qweight, sc, bits: int, tile_k: int,
                  group_size: int, bn: int = 2048) -> torch.Tensor:
    """S1 on the card (K1's planar decode tile, MODE a template argument,
    with K1's split-K plan and in-launch sum; W2 and W4, M <= 32, N % 128
    == 0, tiles of 512 rows, groups of 128) or its plain version on the
    CPU."""
    _check_mode(mode, bn, tile_k)
    if not x.is_cuda:
        return ablate_decode_plain(mode, x, qweight, sc, bits, tile_k,
                                   group_size, bn)
    if bits not in (2, 4):
        raise ValueError(f"ablate_decode's kernel takes the script's W2 and "
                         f"W4, not W{bits}")
    M, K = x.shape
    N = qweight.shape[1]
    _check_cuda("ablate_decode", x, qweight, sc)
    _check_decode("ablate_decode", x, qweight, bits, tile_k, group_size,
                  (sc,))
    if any(t.data_ptr() % 16 for t in (x, qweight, sc)):
        raise ValueError("ablate_decode stages x, the words and the slabs by "
                         "16-byte copies: 16-byte aligned operands")
    plan = _ablate_plan(x.device, bits, M, N, K)
    part = tickets = None
    if plan.splits > 1:
        part = torch.empty(plan.workspace, dtype=torch.float32,
                           device=x.device)
        tickets = _qmm._planar_tickets(x.device, N // _qmm._K1_BN)
    y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    _build.launch("probes", "probe_ablate", "ppppppiiiiiiii", x.data_ptr(),
                  qweight.data_ptr(), sc.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if tickets is None else tickets.data_ptr(),
                  y.data_ptr(), M, N, K, bits, ABLATE_MODES.index(mode), bn,
                  plan.splits, plan.per)
    _build.count(ablate_decode, "launches", f"launches_{mode}")
    return y


consume.launches = 0
mxu_rate_bf16.launches = 0
mxu_rate_int8.launches = 0
f32inj_matmul.launches = 0
ablate_decode.launches = 0
for _mode in ABLATE_MODES:
    setattr(ablate_decode, f"launches_{_mode}", 0)
