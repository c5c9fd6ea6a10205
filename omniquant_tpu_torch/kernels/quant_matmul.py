"""Packed-weight matmul: y = x @ dequant(W) (+ bias), W4A16 and kin.

Counterpart of ``omniquant_tpu/kernels/quant_matmul.py::quant_matmul`` with
the same host routing:

* N % 128 != 0 goes to the dense reference;
* m >= 4096 with a column block below 1024 (e.g. fused gate+up at
  N = 22016) dequantizes the weight once and calls ``torch.matmul``, as the
  JAX package hands that case to XLA;
* everything else runs the fused kernel: on a CUDA tensor the hand-written
  ``csrc/quant_matmul.cu`` (pairs layout at bits 2/3/4 with groups of a
  multiple of 64 rows, planar layout at bits 2/3/4/6/8 with groups of a
  multiple of 32 rows, per-channel scales in both; bf16 activations, scales
  and zeros), on a CPU tensor its plain version ``quant_matmul_reference``.

The kernel has two tiles. At m <= 32 (decode) the bytes of the packed
words set the bound: the decode tile reads each word once through a 2-stage
cp.async ring and splits K across CTAs (on the card both decode tiles are
bound by their instructions, well above that bound). On pairs words the split is on
pack-tile boundaries (``decode_plan``: about three CTAs of 128 columns on
each SM), and the slices' f32 partial sums, in a (splits, m, N) workspace
allocated here, are added in slice order by a second pass
(``csrc/splitk_sum.cuh``, shared with K7). On planar words the split is in
steps of the K walk, set by the card (``planar_decode_plan``: the CTAs an SM
holds, asked of the card), and the slice of each column block that finishes
last adds the slices in slice order inside the kernel, counting on a
per-device ticket buffer that the kernel leaves zeroed. Either way two calls
give bitwise equal results. At m > 32 the 128 x 128 prefill tile runs
unsplit, bound by the tensor cores: it keeps a pack tile's words in shared
memory and walks the tile field by field (``prefill_plan``). Pairs tiles
must hold a multiple of 8 words per column; a planar tile must hold a
multiple of 8 low-plane words per column (``pack_tile`` makes only such
tiles), and one whose low blocks are too small for a decode step
(``_planar_decode``: in_features below 256 rows at 2, 4 and 6 bits, 512 at
3, 128 at 8) runs on the prefill tile at every m. Each launch counts in
``quant_matmul.launches``; pairs ones at m > 32 also in
``launches_prefill``, planar ones in ``launches_planar_decode`` (m <= 32)
or ``launches_planar_prefill``.

Geometry comes from the tensor shapes (qweight's column count is N), as in
the JAX package. x's last dim is the logical in_features; rows past it up to
the packed length count as zeros.

The integer-activation path (W4A4 / W6A6), counterpart of
``quant_matmul_int`` there: per-token asymmetric activation codes, centered
to int8 (``quantize_act_int``), meet the weight codes centered by 2^{b-1}
in exact int32 dots, one per quant group, and

    y[m, n] = xs_m * sum_g [dot_g[m, n] * sc_g[n] + xsum_g[m] * off2_g[n]]

with off2 = (2^{b-1} - zero) * scale formed in the dtype of the scales (bf16
in a bf16 engine) and widened to f32, and xsum_g the group's sum of
activation codes. ``quant_matmul_int`` routes as the JAX function does:

* eligible (act quant enabled, per token, n_bits <= 7, minmax; N % 128 == 0;
  bits <= 8) and m >= ``_INT_DENSE_MIN_M`` -> ``_quant_matmul_int_dense``:
  the weight unpacked once to centered int8 (K8 ``_unpack_to_int8``), then
  the dense product (K9), for either layout;
* eligible, smaller m, planar layout -> the fused kernel (K7), which reads
  each packed word once per CTA for up to 128 rows and unpacks it into
  tensor-core registers (``int_plan`` cuts K into slices);
* anything else -> ``fake_quant_act`` then ``quant_matmul`` (K1), on either
  layout.

K7, K8 and K9 live in ``csrc/quant_matmul_int.cu`` (int8 -> s32: K7 on
``mma.sync`` with the raw u8 weight codes, K9 on ``wgmma`` fed by TMA);
their plain versions evaluate the same algebra in f32. K8 writes the
centered codes K-major, (N, k_pad), as ``wgmma`` takes 8-bit operands
(JAX's kernel writes them (k_pad, N)).
"""
from __future__ import annotations

import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from ..quant.packing import PackedWeight, dequantize_packed, unpack_codes
from ..quant.quantizer import _scale_zp, fake_quant_act
from . import _build

# groups a multiple of 64 rows for K1 on pairs words, K7 and K9: a run of
# K1's pairs decode tile (up to 64 rows) and the chunks of K9 (64 or 128
# rows) must lie inside one group; K7 (k32 blocks of 32 rows) takes the
# same groups as K9, the other half of the integer route
_CUDA_GROUP_MULTIPLE = 64
# K1 on planar words: a decode run (16 or 32 rows) and a prefill K step (32
# rows) must lie inside one group
_K1_PLANAR_GROUP_MULTIPLE = 32
# K1's decode tile: 128 columns per CTA. On pairs words split-K to about
# this many CTAs on each SM, and at most this many quant groups per slice
# (their scales and zeros sit in shared memory beside a 2-stage ring of ~34
# KB stages, and three such CTAs fit on an SM). On planar words a pack
# tile's scales ride in the ring, so the slice length is free, and
# planar_decode_plan's model of the card (fit to the card's times of each
# split count at the 7B shapes, every width, m = 32 and 8) charges each CTA
# this many steps besides its slice's (its first load, its ticket) and a
# round of CTAs on an SM at least the time of this many CTAs, at m <= 8 and
# at m > 8 (fewer do not hide the latency of the loads and the MMAs; at m <=
# 8 a CTA has less to do between loads)
_K1_BN, _K1_CTAS_PER_SM, _K1_SLICE_GROUPS = 128, 3, 8
_K1_PL_CTA_STEPS, _K1_PL_MIN_LOAD = 0.5, (3, 2)
# K1's prefill tile (m > 32): at most this many word rows per pack tile and
# column (two tiles' words sit in shared memory beside the x ring) and quant
# groups per pack tile (their scales, zeros and xsum sit there too); its
# shared memory, at most what a block can have
_K1_PF_WORDS, _K1_PF_GROUPS, _K1_PF_SMEM = 128, 16, 232448
# column blocks of the JAX kernel, widest first: N's widest divisor among
# them decides the dequantize-once route at m >= 4096, as it does there
_BLOCK_N = (2048, 1024, 512, 256, 128)
# the integer path's dense route from this many rows on (a TPU-tuned
# threshold, kept so the port routes like the reference)
_INT_DENSE_MIN_M = 2048
# K7: 64 columns per CTA and up to 128 token rows (more rows take row
# blocks of 128); a split-K slice spans at most _K7_SLICE_GROUPS quant
# groups (their scales sit in shared memory); a generic-path x stage holds
# at most _K7_X_BYTES; a block has at most _K7_SMEM bytes of shared memory
_K7_BN, _K7_MR, _K7_SLICE_GROUPS = 64, 128, 32
_K7_X_BYTES, _K7_SMEM = 17408, 232448
# int_plan's model of the card (an H100 SXM): shared memory of an SM, and
# the bytes it moves while a CTA works through one pack tile (~6 us at ~1.5
# TB/s in chip_smoke's timing); the CTAs an SM's registers hold come from
# the card (_k7_reg_ctas)
_K7_SM_SMEM, _K7_TILE_BYTES = 233472, 9e6
_SM_COUNT: dict = {}
_K7_REG_CTAS: dict = {}
_K1_PL_CTAS: dict = {}
_K1_TICKETS: dict = {}
_BUFFER_LOCK = threading.Lock()


def quant_matmul_reference(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Plain version: dequantize in f32, f32 product, cast to x.dtype, then
    add the bias in x.dtype."""
    w = dequantize_packed(pw, dtype=torch.float32)  # (in, out)
    pad = w.shape[0] - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    y = torch.matmul(x.float(), w).to(x.dtype)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y


class DecodePlan(NamedTuple):
    """How K1's decode tile (m <= 32) cuts K: ``splits`` slices of
    ``per`` pack tiles (the last may be shorter), and the (splits, m, N) f32
    workspace of their partial sums when there is more than one slice."""
    splits: int
    per: int
    n_tiles: int
    workspace: Optional[tuple]

    def slices(self) -> list:
        """(first tile, end tile) of each slice, as the kernel takes them."""
        return [(s * self.per, min((s + 1) * self.per, self.n_tiles))
                for s in range(self.splits)]


def decode_plan(m: int, n: int, k_pad: int, tile_k: int,
                group_rows: int, sm_count: int) -> DecodePlan:
    """The split-K plan of K1's pairs decode tile for m rows: enough slices
    to put about ``_K1_CTAS_PER_SM`` CTAs of 128 columns on each SM, on
    pack-tile boundaries, with at most ``_K1_SLICE_GROUPS`` quant groups
    per slice, or one pack tile where a tile holds more; the slice's scales
    sit in shared memory. ``group_rows`` is the group size, or k_pad for
    per-channel scales. One slice for the prefill tile (m > 32)."""
    n_tiles = k_pad // tile_k
    if m > 32:
        return DecodePlan(1, n_tiles, n_tiles, None)
    ctas = n // _K1_BN
    want = max(1, min(n_tiles, -(-_K1_CTAS_PER_SM * sm_count // ctas)))
    per = min(-(-n_tiles // want),
              max(1, _K1_SLICE_GROUPS * group_rows // tile_k))
    splits = -(-n_tiles // per)
    return DecodePlan(splits, per, n_tiles,
                      (splits, m, n) if splits > 1 else None)


class PrefillPlan(NamedTuple):
    """How K1's prefill tile walks a pack tile (``csrc/quant_matmul.cu``,
    ``pf_step``): steps of ``kc`` x columns (128 where the tile is a
    multiple of 128 rows, its groups a multiple or a divisor of 128 rows,
    and its shared memory fits; else the widest of 64, 32 and 16 that
    divides the tile and its groups), a group closing every ``kg`` k16
    blocks where a 128-column step holds whole groups (0: a group spans
    whole steps and closes with the last), ``steps`` per tile through a
    ring of ``stages``, runs of ``run_rows`` rows that share a bit offset
    (a pairs field, 2W rows of W words; a planar slot, P rows of P low
    words), ``words`` word rows per column held in shared memory,
    ``groups`` quant groups closing inside the tile (1 for per-channel
    scales, which close at each tile's end), and the ``smem`` bytes the
    kernel asks for."""
    kc: int
    kg: int
    steps: int
    stages: int
    run_rows: int
    words: int
    groups: int
    smem: int


def _prefill_smem(kc: int, words: int, planar: bool, groups: int) -> int:
    """Shared memory of the prefill tile (csrc ``pf_smem``): the x ring of
    128 rows, two tiles' words, two tiles' (scale, zero) pairs and the
    tile's xsum per group and row."""
    stages = {128: 2, 64: 3}.get(kc, 4)
    return (stages * 128 * (kc + 8) * 2 + 2 * words * (132 if planar else 136)
            * 4 + 2 * groups * 128 * 4 + groups * 128 * 4)


def prefill_plan(layout: str, bits: int, tile_k: int, group_rows: int,
                 k_pad: int) -> PrefillPlan:
    """The prefill tile's schedule for a weight, or NotImplementedError
    for a tile it does not take: more than ``_K1_PF_WORDS`` word rows per
    column, more than ``_K1_PF_GROUPS`` groups per tile, a tile of other
    than a multiple of 16 rows or one that splits a group. ``group_rows``
    is the group size, or k_pad for per-channel scales."""
    if layout == "pairs":
        words = tile_k // (2 * (5 if bits == 3 else 16 // bits))
        run_rows = 2 * words
    else:
        words = tile_k * bits // 32
        run_rows = _planar_geometry(bits, tile_k)[0]
    per_channel = group_rows >= k_pad
    groups = 1 if per_channel else tile_k // group_rows
    if tile_k % 16 or k_pad % tile_k or words > _K1_PF_WORDS or (
            not per_channel and (tile_k % group_rows or group_rows % 16
                                 or groups > _K1_PF_GROUPS)):
        raise NotImplementedError(
            f"the prefill tile takes pack tiles of a multiple of 16 rows, at "
            f"most {_K1_PF_WORDS} words per column and {_K1_PF_GROUPS} whole "
            f"groups; got {tile_k} rows, {words} words, groups of "
            f"{group_rows} rows")
    rows = min(group_rows, tile_k)
    planar = layout == "planar"
    fits = [c for c in (128, 64, 32, 16) if tile_k % c == 0 and (
        rows % c == 0 or (c == 128 and 128 % rows == 0 and rows >= 32))
        and _prefill_smem(c, words, planar, groups) <= _K1_PF_SMEM]
    if not fits:
        raise NotImplementedError(
            f"the prefill tile's shared memory does not hold a pack tile of "
            f"{tile_k} rows with {words} words per column")
    kc = fits[0]
    return PrefillPlan(kc, rows // 16 if kc == 128 and rows <= 128 else 0,
                       tile_k // kc, {128: 2, 64: 3}.get(kc, 4), run_rows,
                       words, groups, _prefill_smem(kc, words, planar, groups))


def _planar_geometry(bits: int, tile_k: int) -> tuple:
    """(low-plane words per tile and column, words per decode-tile step
    block, low blocks per step) of K1's planar tiles: two blocks P/2 apart
    for the two-plane widths (3 and 6 bits), whose high words both share."""
    lo = {3: 2, 6: 4}.get(bits, bits)
    return (tile_k * lo // 32, 32 if bits in (4, 8) else 16,
            2 if bits in (3, 6) else 1)


def _planar_decode(pw: PackedWeight) -> bool:
    """Whether K1's decode tile takes this planar weight at m <= 32: its
    low blocks hold whole steps (else the prefill tile serves every m)."""
    P, ws, nsel = _planar_geometry(pw.bits, pw.tile_k)
    return (P // nsel) % ws == 0


class PlanarDecodeGeometry(NamedTuple):
    """K1's planar decode tile for a weight and m rows, as
    ``csrc/quant_matmul.cu`` lays it out (``PlanarStep``, ``pl_dec_kb``,
    ``pl_dec_smem``; ``chip_smoke.py`` and the card tests hold the shared
    memory of the two equal). A
    step is ``ws`` = 16 ``kb`` consecutive words of each of ``nsel`` low
    blocks (and of the high plane at 3 and 6 bits), ``spt`` steps per pack
    tile; slot p of a block is a run of ``ws`` rows, and a step's runs, in
    the order u = p * nsel + b, go in ``nsub`` sub-steps of ``runs`` runs
    (two, of half the slots each, where a step's x columns take more than
    16 KB, or 8 KB with a high plane).
    Shared memory: two stages of a step's words (``words_bytes`` each) and
    of a sub-step's x columns (``x_bytes``), two slots of a pack tile's
    (scale, zero) bf16 planes (``sz_bytes``, ``ngp`` elements per column
    and plane), ``smem`` in all."""
    kb: int
    ws: int
    nsel: int
    nsub: int
    runs: int
    spt: int
    words_bytes: int
    x_bytes: int
    ngp: int
    sz_bytes: int
    smem: int


def planar_decode_geometry(bits: int, m: int, tile_k: int, group_rows: int,
                           n_groups: int) -> PlanarDecodeGeometry:
    """The decode tile's geometry (see ``PlanarDecodeGeometry``) for a
    planar weight it takes (``_planar_decode``); ``group_rows`` is the
    group size, or k_pad for per-channel scales, ``n_groups`` the scales'
    column count."""
    P, ws_min, nsel = _planar_geometry(bits, tile_k)
    B = P // nsel
    if B % ws_min:
        raise NotImplementedError(
            f"a {tile_k}-row pack tile at {bits} bits runs the prefill tile")
    kb = 2 if nsel == 1 and B % 32 == 0 else 1
    ws = 16 * kb
    v = 32 // {3: 2, 6: 4}.get(bits, bits)  # slots per low word
    mr = 8 * next(n for n in (1, 2, 4) if m <= 8 * n)
    x_step = mr * v * nsel * ws * 2  # a step's x columns, bytes
    nsub = 2 if x_step > 16384 or (nsel == 2 and x_step >= 8192) else 1
    runs = v * nsel // nsub
    spans = (-(-tile_k // group_rows) + 1 if tile_k % group_rows
             else tile_k // group_rows)
    ngp = (min(spans, n_groups) + 2) & ~1
    words_bytes = (nsel + (nsel == 2)) * ws * (_K1_BN + 4) * 4
    x_bytes = mr * runs * ws * 2
    sz_bytes = 2 * _K1_BN * ngp * 2
    return PlanarDecodeGeometry(
        kb, ws, nsel, nsub, runs, B // ws, words_bytes, x_bytes, ngp,
        sz_bytes, 2 * (words_bytes + x_bytes + sz_bytes))


class PlanarDecodePlan(NamedTuple):
    """How K1's planar decode tile cuts the K walk of ``n_steps`` steps:
    ``splits`` slices of ``per`` steps (the last may be shorter), and the
    (splits, m, N) f32 workspace of their partial sums when there is more
    than one slice."""
    splits: int
    per: int
    n_steps: int
    workspace: Optional[tuple]

    def slices(self) -> list:
        """(first step, end step) of each slice, as the kernel takes them."""
        return [(s * self.per, min((s + 1) * self.per, self.n_steps))
                for s in range(self.splits)]


def planar_decode_plan(m: int, n: int, n_steps: int, sm_count: int,
                       ctas_per_sm: int) -> PlanarDecodePlan:
    """The split-K plan of the planar decode tile for m rows, N = n and a K
    walk of ``n_steps`` steps: the slice count that gives the least time on
    the busiest SM. That SM takes c = ceil(CTAs / ``sm_count``) CTAs (of 128
    columns) in rounds of at most ``ctas_per_sm``; a round costs the steps
    of a slice plus ``_K1_PL_CTA_STEPS``, times the CTAs it runs, but at
    least ``_K1_PL_MIN_LOAD`` of them (its first entry at m <= 8, its
    second above). Fewer slices win a tie."""
    col_blocks = n // _K1_BN
    min_load = _K1_PL_MIN_LOAD[0 if m <= 8 else 1]
    best = (math.inf, 1, n_steps)
    for want in range(1, n_steps + 1):
        per = -(-n_steps // want)
        splits = -(-n_steps // per)
        if splits != want:
            continue
        c = -(-col_blocks * splits // sm_count)
        cost = (-(-c // ctas_per_sm) * max(min(c, ctas_per_sm), min_load)
                * (per + _K1_PL_CTA_STEPS))
        if cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    return PlanarDecodePlan(splits, per, n_steps,
                            (splits, m, n) if splits > 1 else None)


def _planar_decode_info(bits: int, m: int, tile_k: int, group_rows: int,
                        n_groups: int, ctas: bool) -> int:
    """The planar decode tile's shared memory, or (``ctas``) the CTAs of it
    an SM holds, from ``csrc/quant_matmul.cu`` (the card's occupancy)."""
    n = _build.fn("quant_matmul", "qmm_planar_decode_info", "iiiiii")(
        bits, m, tile_k, group_rows, n_groups, int(ctas), None)
    if n < 1:
        raise RuntimeError(f"quant_matmul: planar decode query failed ({n})")
    return n


def _planar_ctas(device, bits: int, m: int, tile_k: int, group_rows: int,
                 n_groups: int) -> int:
    """``_planar_decode_info``'s CTAs per SM, asked of the card once per
    instance and shared-memory size."""
    mn = next(n for n in (1, 2, 4) if m <= 8 * n)
    key = (device.index or 0, bits, mn, tile_k, group_rows, n_groups)
    if key not in _K1_PL_CTAS:
        _K1_PL_CTAS[key] = _planar_decode_info(bits, 8 * mn, tile_k,
                                               group_rows, n_groups, True)
    return _K1_PL_CTAS[key]


def planar_decode_launch(pw: PackedWeight, m: int, device) -> tuple:
    """What the planar decode tile runs for pw at m rows on ``device``'s
    card: (geometry, CTAs an SM holds, plan)."""
    group_rows, G = pw.group_size or pw.k_pad, pw.scales.shape[1]
    geo = planar_decode_geometry(pw.bits, m, pw.tile_k, group_rows, G)
    ctas = _planar_ctas(device, pw.bits, m, pw.tile_k, group_rows, G)
    return geo, ctas, planar_decode_plan(
        m, pw.qweight.shape[1], pw.k_pad // pw.tile_k * geo.spt,
        _sm_count(device), ctas)


def _device_buffer(store: dict, device, numel: int,
                   dtype=torch.int32) -> torch.Tensor:
    """``store``'s buffer on ``device``, of at least ``numel`` elements:
    zeroed when made, grown by doubling. Launches on one stream at a time
    share it (the shards of a tensor-parallel mesh on one card do: they
    all launch on its default stream)."""
    key = device.index or 0
    with _BUFFER_LOCK:
        t = store.get(key)
        if t is None or t.numel() < numel:
            t = torch.zeros(max(numel, 2 * (0 if t is None else t.numel())),
                            dtype=dtype, device=device)
            store[key] = t
    return t


def _planar_tickets(device, n_blocks: int) -> torch.Tensor:
    """The planar decode tile's int32 ticket per column block on
    ``device``: zeroed once and grown with N; every launch leaves them
    zeroed (the last slice of a column block resets its ticket), so no call
    launches a memset."""
    return _device_buffer(_K1_TICKETS, device, n_blocks)


def _check_k1_weight(pw: PackedWeight) -> None:
    """What K1 takes, per layout; raises on anything else, before it looks
    at the card."""
    gs = pw.group_size
    if pw.layout == "pairs":
        if pw.bits not in (2, 3, 4):
            raise NotImplementedError(
                f"the CUDA quant_matmul takes the pairs layout at 2/3/4 bits, "
                f"not {pw.bits}")
        if gs and gs % _CUDA_GROUP_MULTIPLE:
            raise NotImplementedError(
                f"pairs group_size {gs} is not a multiple of "
                f"{_CUDA_GROUP_MULTIPLE}")
        fields = 5 if pw.bits == 3 else 16 // pw.bits  # codes per half word
        if (pw.tile_k // (2 * fields)) % 8:
            raise NotImplementedError(
                f"pack tile of {pw.tile_k} rows is not a multiple of 8 words "
                "per column (pack_tile makes only such tiles)")
    else:
        if pw.bits not in (2, 3, 4, 6, 8):
            raise NotImplementedError(
                f"the CUDA quant_matmul takes the planar layout at 2/3/4/6/8 "
                f"bits, not {pw.bits}")
        if gs and gs % _K1_PLANAR_GROUP_MULTIPLE:
            raise NotImplementedError(
                f"planar group_size {gs} is not a multiple of "
                f"{_K1_PLANAR_GROUP_MULTIPLE}")
        if pw.tile_k % 32 or _planar_geometry(pw.bits, pw.tile_k)[0] % 8:
            raise NotImplementedError(
                f"pack tile of {pw.tile_k} rows is not a multiple of 32 rows "
                "and 8 low-plane words per column (pack_tile makes only such "
                "tiles)")
    if not pw.scales.dtype == pw.zeros.dtype == torch.bfloat16:
        raise NotImplementedError(
            "the CUDA quant_matmul takes bf16 scales and zeros (a bf16 engine "
            f"rounds them so); got {pw.scales.dtype} and {pw.zeros.dtype}")


def _qmm_cuda(x2: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Launch the CUDA kernel on x2 (m, K) bf16; no bias. At m <= 32 the
    decode tile splits K per ``decode_plan`` (pairs) or
    ``planar_decode_plan`` (planar) and adds the slices' f32 partial sums in
    slice order; the prefill tile runs unsplit and takes what
    ``prefill_plan`` takes."""
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA quant_matmul takes bf16 x, not {x2.dtype}")
    _check_k1_weight(pw)
    m, K = x2.shape
    k_pad = pw.k_pad
    group_rows = pw.group_size or k_pad
    planar = pw.layout == "planar"
    decode = m <= 32 and (not planar or _planar_decode(pw))
    if not decode:  # raises on a pack tile the prefill tile does not take
        prefill_plan(pw.layout, pw.bits, pw.tile_k, group_rows, k_pad)
    qweight = pw.qweight
    if not (qweight.is_cuda and qweight.dtype == torch.int32
            and qweight.is_contiguous() and qweight.data_ptr() % 16 == 0):
        raise ValueError("qweight must be a contiguous, 16-byte aligned int32 "
                         "CUDA tensor")
    x2 = x2.contiguous()
    N = qweight.shape[1]
    G = pw.scales.shape[1]
    if K > k_pad or pw.scales.shape[0] != N or pw.zeros.shape != pw.scales.shape:
        raise ValueError("x, qweight and scales disagree on the geometry")
    # the planar decode tile stages scales and zeros by 4-byte copies
    scales, zeros = (t.contiguous() if t.data_ptr() % 4 == 0 else t.clone()
                     for t in (pw.scales, pw.zeros))
    tickets = None
    if decode and planar:
        plan = planar_decode_launch(pw, m, x2.device)[2]
        if plan.splits > 1:
            tickets = _planar_tickets(x2.device, N // _K1_BN)
    elif decode:
        plan = decode_plan(m, N, k_pad, pw.tile_k, group_rows,
                           _sm_count(x2.device))
    else:  # the prefill tile, unsplit
        plan = DecodePlan(1, k_pad // pw.tile_k, k_pad // pw.tile_k, None)
    y = torch.empty((m, N), dtype=x2.dtype, device=x2.device)
    part = (None if plan.workspace is None else
            torch.empty(plan.workspace, dtype=torch.float32, device=x2.device))
    x_vec = int(K % 8 == 0 and x2.data_ptr() % 16 == 0)
    ptrs = [x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), None if part is None else part.data_ptr()]
    if planar:
        ptrs.append(None if tickets is None else tickets.data_ptr())
    _build.launch(
        "quant_matmul", "qmm_planar_bf16" if planar else "qmm_pairs_bf16",
        "p" * (len(ptrs) + 1) + "iiiiiiiiiii", *ptrs, y.data_ptr(), m, K, N,
        k_pad, G, group_rows, pw.tile_k, pw.bits, x_vec, plan.splits, plan.per)
    if planar and m <= 32:
        _build.count(quant_matmul, "launches", "launches_planar_decode")
    elif planar:
        _build.count(quant_matmul, "launches", "launches_planar_prefill")
    elif m > 32:
        _build.count(quant_matmul, "launches", "launches_prefill")
    else:
        _build.count(quant_matmul, "launches")
    return y


def quant_matmul(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """y = x @ dequant(pw) (+ bias). x: (..., in_features_logical)."""
    lead = x.shape[:-1]
    m = math.prod(lead)
    n = pw.qweight.shape[1]
    if n % 128 != 0:
        return quant_matmul_reference(x, pw).reshape(*lead, n)
    bn = next(b for b in _BLOCK_N if n % b == 0)
    x2 = x.reshape(m, x.shape[-1])
    if m >= 4096 and bn < 1024:
        w = dequantize_packed(pw, dtype=x.dtype)
        pad = w.shape[0] - x2.shape[-1]
        if pad:
            x2 = torch.nn.functional.pad(x2, (0, pad))
        y = x2 @ w
    elif not x2.is_cuda:
        return quant_matmul_reference(x, pw).reshape(*lead, n)
    else:
        y = _qmm_cuda(x2, pw)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y.reshape(*lead, n)


quant_matmul.launches = 0
quant_matmul.launches_prefill = 0
quant_matmul.launches_planar_decode = 0
quant_matmul.launches_planar_prefill = 0


# ---------------------------------------------------------------------------
# integer-activation path (W4A4 / W6A6)


def quantize_act_int(x: torch.Tensor, cfg) -> tuple:
    """Per-token activation codes on exactly the ``fake_quant_act`` grid,
    computed in x's dtype: returns (centered int8 codes xq - zero_point of
    x's shape, f32 scale (..., 1)). Needs n_bits <= 7 and no groups."""
    if cfg.n_bits > 7 or cfg.group_size:
        raise ValueError("integer activation codes need per-token "
                         "quantization at n_bits <= 7")
    xmin = x.amin(dim=-1, keepdim=True)
    xmax = x.amax(dim=-1, keepdim=True)
    scale, rzp = _scale_zp(xmin, xmax, cfg)
    xq = torch.clamp(torch.round(x / scale) + rzp, 0, cfg.qmax)
    # a zero-range row (scale CLIPMIN, |zero point| up to 1e4) leaves int8;
    # saturate as XLA's float -> int8 conversion does
    return torch.clamp(xq - rzp, -128, 127).to(torch.int8), scale.float()


def int_route(m: int, pw: PackedWeight, act_cfg) -> str:
    """Which route ``quant_matmul_int`` takes for m rows: "dense" (K8 + K9),
    "fused" (K7) or "fake_quant" (fake-quantized activations into K1)."""
    eligible = (
        act_cfg is not None and act_cfg.enabled and not act_cfg.group_size
        and act_cfg.n_bits <= 7 and act_cfg.metric == "minmax"
        and pw.qweight.shape[1] % 128 == 0 and pw.bits <= 8)
    if eligible and m >= _INT_DENSE_MIN_M:
        return "dense"
    return "fused" if eligible and pw.layout == "planar" else "fake_quant"


def unpack_to_int8_plain(pw: PackedWeight) -> torch.Tensor:
    """Plain version of K8: every packed row's code minus 2^{b-1}, int8
    (N, k_pad), K-major (each column's codes contiguous along k): JAX's
    ``_unpack_to_int8`` codes, transposed."""
    codes = unpack_codes(pw.qweight, pw.bits, pw.k_pad, pw.group_size,
                         pw.tile_k, pw.layout)
    return (codes - 2 ** (pw.bits - 1)).t().contiguous().to(torch.int8)


class IntDenseOperands(NamedTuple):
    """What the dense integer product reads besides the weight codes, as the
    JAX route forms it outside its kernel: the activation codes zero-padded
    to k_pad (m, k_pad) int8, their per-group sums xsum (m, n_groups)
    int32, and the f32 slabs sc and off2 (n_groups, N) of the scales and of
    off2 = (2^{b-1} - zero) * scale, formed in the scales' dtype (bf16 in a
    bf16 engine, each step rounded) and widened. Groups of the layout
    padding past the last scale column repeat the last group's scales;
    per-channel scales count one group per pack tile."""
    xc: torch.Tensor
    xsum: torch.Tensor
    sc: torch.Tensor
    off2: torch.Tensor


def int_dense_operands(xc: torch.Tensor, pw: PackedWeight) -> IntDenseOperands:
    """The operands of K9 and its plain version for codes xc (m, K)."""
    m, K = xc.shape
    k_pad = pw.k_pad
    if K != k_pad:
        xc = torch.nn.functional.pad(xc, (0, k_pad - K))
    gs = pw.group_size or pw.tile_k
    n_groups = k_pad // gs
    idx = torch.arange(n_groups, device=pw.scales.device).clamp_max(
        pw.scales.shape[1] - 1)
    sc = pw.scales.t().float()[idx]
    off2 = ((2 ** (pw.bits - 1) - pw.zeros) * pw.scales).t().float()[idx]
    xsum = xc.reshape(m, n_groups, gs).sum(-1, dtype=torch.int32)
    return IntDenseOperands(xc, xsum, sc.contiguous(), off2.contiguous())


def quant_matmul_int_dense_plain(xc, xs, w8, pw: PackedWeight,
                                 out_dtype=torch.bfloat16,
                                 magnitude: bool = False):
    """Plain version of K9: codes xc (m, K) int8 and scales xs (m, 1) f32
    against the centered weight codes w8 (N, k_pad) with pw's scales and
    zeros; (m, N) in out_dtype, no bias. The algebra in f32, in the JAX
    kernels' order: per K tile xsum . off2, plus each group's dot * sc,
    summed over the tiles, times xs, cast to out_dtype. The operands are
    ``int_dense_operands``'. The dots are sums of integer products below
    2^24, so exact in f32.

    With ``magnitude`` it returns (y, xs * sum_g (|dot_g| |sc_g| +
    |xsum_g off2_g|)) in f32: the size of the terms whose f32 order a
    kernel may change, which ``kernels/tolerance.py`` scales to a slack."""
    m = xc.shape[0]
    n, k_pad = w8.shape
    ops = int_dense_operands(xc, pw)
    gs = pw.group_size or pw.tile_k
    n_g = pw.tile_k // gs
    sc, off2, xsum = ops.sc, ops.off2, ops.xsum.float()
    xf, wf = ops.xc.float(), w8.float()
    acc = torch.zeros(m, n, dtype=torch.float32, device=xc.device)
    mag = torch.zeros_like(acc) if magnitude else None
    for t in range(k_pad // pw.tile_k):
        tg = slice(t * n_g, (t + 1) * n_g)
        part = xsum[:, tg] @ off2[tg]
        if magnitude:
            mag += xsum[:, tg].abs() @ off2[tg].abs()
        for g in range(t * n_g, (t + 1) * n_g):
            rows = slice(g * gs, (g + 1) * gs)
            dot = xf[:, rows] @ wf[:, rows].t()
            part = part + dot * sc[g]
            if magnitude:
                mag += dot.abs() * sc[g].abs()
        acc = acc + part
    y = (acc * xs).to(out_dtype)
    return (y, mag * xs) if magnitude else y


def quant_matmul_int_plain(xc, xs, pw: PackedWeight,
                           out_dtype=torch.bfloat16, magnitude: bool = False):
    """Plain version of K7: K9's algebra on the unpacked codes."""
    return quant_matmul_int_dense_plain(xc, xs, unpack_to_int8_plain(pw), pw,
                                        out_dtype, magnitude)


def _check_int_weight(pw: PackedWeight, name: str) -> None:
    if not (pw.qweight.is_cuda and pw.qweight.dtype == torch.int32
            and pw.qweight.is_contiguous() and pw.qweight.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: qweight must be a contiguous, 16-byte "
                         "aligned int32 CUDA tensor")
    if not pw.scales.dtype == pw.zeros.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{name} takes bf16 scales and zeros (a bf16 engine rounds them "
            f"so); got {pw.scales.dtype} and {pw.zeros.dtype}")


def _check_int_acts(xc, xs, pw, out_dtype, name: str) -> None:
    gs = pw.group_size or pw.tile_k
    if gs % _CUDA_GROUP_MULTIPLE:
        raise NotImplementedError(
            f"{name}: group of {gs} rows is not a multiple of "
            f"{_CUDA_GROUP_MULTIPLE}")
    m, K = xc.shape
    if out_dtype != torch.bfloat16:
        raise ValueError(f"{name} gives bf16 out, not {out_dtype}")
    if not (xc.dtype == torch.int8 and xc.is_contiguous()
            and xs.dtype == torch.float32 and xs.is_contiguous()
            and xs.numel() == m):
        raise ValueError(f"{name}: codes must be contiguous int8 (m, K) and "
                         "scales contiguous f32 (m, 1)")
    if K > pw.k_pad or pw.scales.shape != pw.zeros.shape or (
            pw.scales.shape[0] != pw.qweight.shape[1]):
        raise ValueError(f"{name}: codes, qweight and scales disagree on the "
                         "geometry")


def _unpack_words(pw: PackedWeight) -> int:
    """Low-plane (planar) or pairs words per pack tile and column: K8 reads
    them four at a time."""
    if pw.layout == "pairs":
        return pw.tile_k // (2 * (5 if pw.bits == 3 else 16 // pw.bits))
    return pw.tile_k * {3: 2, 6: 4}.get(pw.bits, pw.bits) // 32


def _unpack_to_int8(pw: PackedWeight) -> torch.Tensor:
    """K8: packed words -> centered int8 codes (N, k_pad), K-major, every
    layout and width the packing makes. On a CUDA tensor the kernel (32
    columns of one pack tile per CTA, staged in shared memory and written
    as 16-byte runs of k), on a CPU tensor its plain version."""
    if not pw.qweight.is_cuda:
        return unpack_to_int8_plain(pw)
    _check_int_weight(pw, "_unpack_to_int8")
    N = pw.qweight.shape[1]
    if N % 32:
        raise ValueError(f"_unpack_to_int8 takes N % 32 == 0, not {N}")
    if _unpack_words(pw) % 4:
        raise NotImplementedError(
            f"_unpack_to_int8 reads words in fours: a pack tile of "
            f"{pw.tile_k} rows holds {_unpack_words(pw)} per column (every "
            "tile of a multiple of 64 rows holds a multiple of 4)")
    out = torch.empty((N, pw.k_pad), dtype=torch.int8,
                      device=pw.qweight.device)
    _build.launch("quant_matmul_int", "unpack_to_int8", "ppiiiii",
                  pw.qweight.data_ptr(), out.data_ptr(), N, pw.k_pad,
                  pw.tile_k, pw.bits, int(pw.layout == "pairs"))
    _build.count(_unpack_to_int8, "launches")
    return out


def _k9_offset_operands(ops: IntDenseOperands) -> tuple:
    """The offset term sum_g xsum_g[m] * off2_g[n] as a bf16 product for K9's
    tensor cores: each code sum split exactly as 65536 a + 256 b + c (b, c in
    [0, 255], every part exact in bf16), xo (m, ko) = [65536 a | 256 b | c]
    and wo (N, ko) = [off2 | off2 | off2] transposed, zero-padded to ko, a
    multiple of 64 columns. off2 is bf16-valued (a bf16 engine rounds it
    so), so every product is exact and xo @ wo.T is the offset term up to
    the order of its f32 sum."""
    m, n_groups = ops.xsum.shape
    ko = -(-3 * n_groups // 64) * 64
    xsum = ops.xsum
    parts = (65536 * (xsum >> 16), 256 * ((xsum >> 8) & 255), xsum & 255)
    xo = torch.zeros((m, ko), dtype=torch.bfloat16, device=xsum.device)
    wo = torch.zeros((ops.off2.shape[1], ko), dtype=torch.bfloat16,
                     device=xsum.device)
    off2_t = ops.off2.t()
    for i, part in enumerate(parts):
        xo[:, i * n_groups:(i + 1) * n_groups] = part
        wo[:, i * n_groups:(i + 1) * n_groups] = off2_t
    return xo, wo


def _k9_launch(ops: IntDenseOperands, xs, w8, pw: PackedWeight) -> torch.Tensor:
    """Launch K9 on prepared operands: xc (m, k_pad), the offset term's bf16
    operands (``_k9_offset_operands``), the sc slab (n_groups, N) and K8's
    codes w8 (N, k_pad)."""
    m, k_pad = ops.xc.shape
    n = w8.shape[0]
    xo, wo = _k9_offset_operands(ops)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=ops.xc.device)
    _build.launch(
        "quant_matmul_int", "qmm_int_dense", "pppppppiiiii",
        ops.xc.data_ptr(), w8.data_ptr(), xo.data_ptr(), wo.data_ptr(),
        ops.sc.data_ptr(), xs.data_ptr(), y.data_ptr(), m, n, k_pad,
        pw.group_size or pw.tile_k, xo.shape[1])
    return y


def _qmm_int_dense_cuda(xc, xs, w8, pw: PackedWeight,
                        out_dtype) -> torch.Tensor:
    """K9 on codes xc (m, K) and K8's codes w8 (N, k_pad): the operands
    (``int_dense_operands``, as JAX forms them outside its kernel), then
    the launch; no bias."""
    _check_int_weight(pw, "_quant_matmul_int_dense")
    _check_int_acts(xc, xs, pw, out_dtype, "_quant_matmul_int_dense")
    n = w8.shape[0]
    if not (w8.is_cuda and w8.dtype == torch.int8 and w8.is_contiguous()
            and w8.shape[1] == pw.k_pad and n % 128 == 0):
        raise ValueError("w8 must be contiguous int8 (N, k_pad) on the card "
                         "with N % 128 == 0")
    return _k9_launch(int_dense_operands(xc, pw), xs, w8, pw)


def _quant_matmul_int_dense(x: torch.Tensor, pw: PackedWeight,
                            act_cfg) -> torch.Tensor:
    """The large-m integer route: activation codes, the weight unpacked once
    (K8), then the dense s8 x s8 product with the group algebra (K9; xsum,
    sc and off2 formed here, as in JAX). Bias added after, in x's
    dtype."""
    lead = x.shape[:-1]
    n = pw.qweight.shape[1]
    m = math.prod(lead)
    xc, xs = quantize_act_int(x.reshape(m, x.shape[-1]), act_cfg)
    w8 = _unpack_to_int8(pw)
    if not xc.is_cuda:
        y = quant_matmul_int_dense_plain(xc, xs, w8, pw, x.dtype)
    else:
        y = _qmm_int_dense_cuda(xc, xs, w8, pw, x.dtype)
        _build.count(_quant_matmul_int_dense, "launches")
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y.reshape(*lead, n)


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


class K7Geometry(NamedTuple):
    """K7's tile for m rows (this is its one copy: the launch passes it on
    and ``csrc/quant_matmul_int.cu::k7_fits`` checks it): ``mn``
    n8 tiles of token rows per CTA (1, 2, 4, 8 or 16) and ``row_blocks``
    of 128 rows; the ``fast`` path (windows of 32 low-plane words of every
    block, where a block holds a multiple of 32) or the generic one (a whole
    pack tile a window, its k32 blocks in row order); ``kx`` k32 blocks per
    step; the bytes of a word slot (one on the fast
    path, two on the generic one), an x slot (two) and all the shared
    memory the kernel asks for."""
    mn: int
    row_blocks: int
    fast: bool
    kx: int
    word_slot: int
    x_slot: int
    smem: int


def _k7_geometry(bits: int, m: int, tile_k: int, k_pad: int,
                 group_rows: int, per: int,
                 generic: bool = False) -> K7Geometry:
    """K7's geometry for a slice of ``per`` pack tiles, or
    NotImplementedError for a tile it does not take. ``group_rows`` is the
    group size, or k_pad for per-channel scales. The fast path is taken
    wherever the tile allows it, unless ``generic`` (which takes every tile;
    chip_smoke.py times one path against the other)."""
    lo = {3: 2, 6: 4}.get(bits, bits)
    nsel = 2 if bits in (3, 6) else 1
    P = tile_k * lo // 32
    B = P // nsel
    if tile_k % 32 or tile_k > 1024 or k_pad % tile_k or P % 4 or B % 4:
        raise NotImplementedError(
            f"quant_matmul_int: pack tile {tile_k} is not supported (a "
            "multiple of 32 rows, whole word quads per plane, at most 1024 "
            "rows)")
    if group_rows != k_pad and (group_rows % 64 or tile_k % group_rows):
        raise NotImplementedError(
            f"quant_matmul_int: groups of {group_rows} rows (a multiple of 64 "
            f"dividing the pack tile of {tile_k}, or per-channel)")
    mn = next(n for n in (1, 2, 4, 8, 16) if m <= 8 * n or n == 16)
    mr = 8 * mn
    fast = B % 32 == 0 and not generic
    if fast:
        h = 1 if mn <= 4 else mn // 4
        kx = (32 // lo) * nsel // h
        blocks = 3 if nsel == 2 else 1  # low blocks and the high plane
        word_slot = blocks * 32 * _K7_BN * 4
    else:
        kb = tile_k // 32
        kx = next((d for d in range(kb, 0, -1)
                   if kb % d == 0 and mr * (32 * d + 16) <= _K7_X_BYTES), 1)
        word_slot = tile_k * bits // 32 * _K7_BN * 4
    x_slot = mr * (32 * kx + 16)
    ng = 1 if group_rows == k_pad else per * tile_k // group_rows
    smem = ((1 if fast else 2) * word_slot + 2 * x_slot + 2 * kx * mr * 4
            + ng * _K7_BN * 4)
    if smem > _K7_SMEM:
        raise NotImplementedError(
            f"quant_matmul_int: a pack tile of {tile_k} rows at {bits} bits "
            f"needs {smem} bytes of shared memory, more than a block has")
    return K7Geometry(mn, -(-m // _K7_MR), fast, kx, word_slot, x_slot, smem)


class IntPlan(NamedTuple):
    """How K7 cuts K for m rows: ``splits`` slices of ``per`` pack tiles
    (the last may be shorter) and the (splits, m, N) f32 workspace of their
    partial sums when there is more than one slice."""
    geometry: K7Geometry
    splits: int
    per: int
    n_tiles: int
    workspace: Optional[tuple]

    def slices(self) -> list:
        """(first tile, end tile) of each slice, as the kernel takes them."""
        return [(s * self.per, min((s + 1) * self.per, self.n_tiles))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=1024)
def int_plan(m: int, n: int, k_pad: int, tile_k: int, bits: int,
             group_rows: int, sm_count: int, reg_ctas: int,
             generic: bool = False) -> IntPlan:
    """K7's split-K plan: the slice length ``per`` (whole pack tiles, at
    most ``_K7_SLICE_GROUPS`` groups) that minimises the time in pack tiles
    of a CTA: rounds of resident CTAs (ceil(CTAs / (resident per SM x
    SMs)), resident by shared memory and by ``reg_ctas``, the CTAs an SM's
    registers hold) times per, plus what more slices cost in the same
    units: the workspace's f32 partials written and read again (8 m N bytes
    a slice) and the second pass (half a tile). Fewer slices win a tie.
    ``generic`` as in ``_k7_geometry``. Raises NotImplementedError for a
    tile K7 does not take."""
    n_tiles = k_pad // tile_k
    col_blocks = (n // _K7_BN) * -(-m // _K7_MR)
    best = None
    for want in range(1, n_tiles + 1):
        per = -(-n_tiles // want)
        splits = -(-n_tiles // per)
        if splits != want or (per > 1 and group_rows != k_pad
                              and per * tile_k // group_rows
                              > _K7_SLICE_GROUPS):
            continue
        geo = _k7_geometry(bits, m, tile_k, k_pad, group_rows, per, generic)
        resident = max(1, min(reg_ctas, _K7_SM_SMEM // (geo.smem + 1024)))
        cost = -(-col_blocks * splits // (resident * sm_count)) * per
        if splits > 1:
            cost += 0.5 + splits * 8 * m * n / _K7_TILE_BYTES
        if best is None or cost < best[0]:
            best = (cost, geo, splits, per)
    _, geo, splits, per = best
    return IntPlan(geo, splits, per, n_tiles,
                   (splits, m, n) if splits > 1 else None)


def _k7_reg_ctas(bits: int, mn: int, fast: bool) -> int:
    """The CTAs of K7's (bits, mn, fast) instance an SM holds by registers
    and threads, asked of the card once."""
    key = (bits, mn, fast)
    if key not in _K7_REG_CTAS:
        n = _build.fn("quant_matmul_int", "qmm_int_planar_ctas", "iii")(
            bits, mn, int(fast), None)
        if n < 1:
            raise RuntimeError(f"quant_matmul_int: occupancy query failed "
                               f"({n})")
        _K7_REG_CTAS[key] = n
    return _K7_REG_CTAS[key]


def _qmm_int_cuda(xc, xs, pw: PackedWeight, out_dtype,
                  generic: bool = False) -> torch.Tensor:
    """Launch K7 on codes xc (m, K); no bias. The pack tiles are split per
    ``int_plan``; with more than one slice each writes f32 partial sums that
    a second pass adds in slice order. Refuses, before it looks for the
    card, what the plan does not take. ``generic`` as in
    ``_k7_geometry``."""
    if pw.layout != "planar" or pw.bits not in (2, 3, 4, 6, 8):
        raise NotImplementedError(
            f"the fused integer kernel takes planar 2/3/4/6/8-bit weights; "
            f"got {pw.layout} at {pw.bits} bits")
    m, K = xc.shape
    n = pw.qweight.shape[1]
    group_rows = pw.group_size or pw.k_pad
    geo = _k7_geometry(pw.bits, m, pw.tile_k, pw.k_pad, group_rows, 1,
                       generic)
    _check_int_weight(pw, "quant_matmul_int")
    _check_int_acts(xc, xs, pw, out_dtype, "quant_matmul_int")
    plan = int_plan(m, n, pw.k_pad, pw.tile_k, pw.bits, group_rows,
                    _sm_count(xc.device),
                    _k7_reg_ctas(pw.bits, geo.mn, geo.fast), generic)
    geo = plan.geometry
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xc.device)
    part = (None if plan.workspace is None else
            torch.empty(plan.workspace, dtype=torch.float32, device=xc.device))
    _build.launch(
        "quant_matmul_int", "qmm_int_planar", "pppppppiiiiiiiiiiiiiiii",
        xc.data_ptr(), xs.data_ptr(), pw.qweight.data_ptr(),
        pw.scales.contiguous().data_ptr(), pw.zeros.contiguous().data_ptr(),
        None if part is None else part.data_ptr(), y.data_ptr(), m, K, n,
        pw.k_pad, pw.scales.shape[1], group_rows, pw.tile_k, pw.bits,
        plan.splits, plan.per, geo.mn, int(geo.fast), geo.kx, geo.word_slot,
        geo.x_slot, geo.smem)
    return y


def quant_matmul_int(x: torch.Tensor, pw: PackedWeight,
                     act_cfg) -> torch.Tensor:
    """y = fake_quant_act(x) @ dequant(pw) (+ bias), evaluated on the
    integer codes where the route allows (see the module docstring)."""
    lead = x.shape[:-1]
    m = math.prod(lead)
    route = int_route(m, pw, act_cfg)
    if route == "dense":
        return _quant_matmul_int_dense(x, pw, act_cfg)
    if route == "fake_quant":
        return quant_matmul(fake_quant_act(x, act_cfg), pw)
    n = pw.qweight.shape[1]
    xc, xs = quantize_act_int(x.reshape(m, x.shape[-1]), act_cfg)
    if xc.is_cuda:
        y = _qmm_int_cuda(xc, xs, pw, x.dtype)
        _build.count(quant_matmul_int, "launches")
    else:
        y = quant_matmul_int_plain(xc, xs, pw, x.dtype)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y.reshape(*lead, n)


quant_matmul_int.launches = 0
_unpack_to_int8.launches = 0
_quant_matmul_int_dense.launches = 0
