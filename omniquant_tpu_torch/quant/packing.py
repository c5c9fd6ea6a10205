"""Packed integer weight storage (W2/W3/W4/W6/W8), bit-identical to the JAX
package's wire layouts (``omniquant_tpu/quant/packing.py``).

Weights are stored transposed, W^T of shape (in, out), as int32 words, in
tiles of ``tile_k`` rows:

* ``planar``: within a tile, bit slot p of word w holds row
  p*(tile/vpw) + w. 3-bit is a 2-bit plane followed by a 1-bit plane
  (code = low2 | hi1 << 2); 6-bit a 4-bit plane and a 2-bit plane.
* ``pairs`` (bits 2/3/4): within a tile of T rows (W = T/vpw words,
  vpw = 2*(16//bits)), natural row j*2W + 2w + h sits at bit
  bits*j + 16*h of word w, so the two halves of a word hold a pair of
  consecutive rows. 3-bit stores 10 codes per word (bits 15 and 31 unused).

Scales and rounded zero points are (out, n_groups); dequant is
(code - zero) * scale. Bit work runs in int64 so that shifts up to 31 bits
never overflow; packed words are then wrapped into int32 exactly as the JAX
package's uint32 -> int32 cast does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .quantizer import QuantConfig, quantize_weight_int

_LAYOUTS = ("planar", "pairs")


def vals_per_word(bits: int) -> int:
    """Values per int32 word for the power-of-two planar widths."""
    return {1: 32, 2: 16, 4: 8, 8: 4}[bits]


def _pairs_vpw(bits: int) -> int:
    """Values per word in the pairs layout: 2*(16//bits) (10 for 3-bit)."""
    return 2 * (16 // bits)


def rows_per_words(bits: int, words: int, layout: str = "planar") -> int:
    if bits == 3 and layout == "pairs":
        return words * 10
    if (words * 32) % bits:
        raise ValueError(f"{words} words do not hold whole {bits}-bit codes")
    return words * 32 // bits


def pack_tile(bits: int, group_size: Optional[int],
              in_features: Optional[int] = None,
              layout: str = "planar") -> int:
    """Default pack tile (rows of W^T): a multiple of every plane's 8-word
    unit and of the group size, scaled toward 512 rows (640 for pairs
    3-bit) but not past in_features."""
    if bits == 3 and layout == "pairs":
        base, target = 80, 640
    elif bits == 3:
        base, target = 256, 512
    elif bits == 6:
        base, target = 128, 512
    else:
        base, target = vals_per_word(bits) * 8, 512
    if group_size:
        base = base * group_size // math.gcd(base, group_size)
    scale = max(1, target // base)
    if in_features is not None:
        while scale > 1 and base * scale > in_features:
            scale //= 2
    return base * scale


@dataclasses.dataclass
class PackedWeight:
    """A packed quantized linear weight.

    qweight: int32 (k_pad*bits/32, out) packed W^T codes (k_pad/10 rows of
             words for pairs 3-bit), k_pad = in_features rounded up to tile_k
    scales:  (out, n_groups) float
    zeros:   (out, n_groups) float, rounded zero points
    bias:    optional (out,)
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    bias: Optional[torch.Tensor]
    bits: int
    group_size: Optional[int]
    in_features: int
    out_features: int
    tile_k: int = 0  # 0 => the default for (bits, group_size, in_features)
    layout: str = "planar"

    def __post_init__(self):
        if self.layout not in _LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}")
        if not self.tile_k:
            self.tile_k = pack_tile(
                self.bits, self.group_size, self.in_features, self.layout)

    @property
    def k_pad(self) -> int:
        return rows_per_words(self.bits, self.qweight.shape[0], self.layout)

    def map_tensors(self, fn) -> "PackedWeight":
        """A copy with fn applied to every tensor (bias only when present)."""
        return dataclasses.replace(
            self, qweight=fn(self.qweight), scales=fn(self.scales),
            zeros=fn(self.zeros),
            bias=None if self.bias is None else fn(self.bias))


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 with two's-complement wrap."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_planar(codes_t: torch.Tensor, bits: int, tile: int) -> torch.Tensor:
    """(k_pad, out) int64 codes -> (k_pad*bits/32, out) int64 words."""
    k_pad, out_f = codes_t.shape
    vpw = vals_per_word(bits)
    grouped = codes_t.reshape(k_pad // tile, vpw, tile // vpw, out_f)
    shifts = (bits * torch.arange(vpw, device=codes_t.device)).view(1, vpw, 1, 1)
    return (grouped << shifts).sum(dim=1).reshape(k_pad * bits // 32, out_f)


def _unpack_planar(words: torch.Tensor, bits: int, tile: int) -> torch.Tensor:
    vpw = vals_per_word(bits)
    out_f = words.shape[1]
    p = words.reshape(-1, 1, tile // vpw, out_f)
    shifts = (bits * torch.arange(vpw, device=words.device)).view(1, vpw, 1, 1)
    return ((p >> shifts) & (2**bits - 1)).reshape(-1, out_f)


def _pair_shifts(bits: int, device) -> torch.Tensor:
    """(1, vpw/2, 1, 2, 1) bit offsets bits*j + 16*h of the pairs layout."""
    j = bits * torch.arange(16 // bits, device=device).view(1, -1, 1, 1, 1)
    h = 16 * torch.arange(2, device=device).view(1, 1, 1, 2, 1)
    return j + h


def _pack_pairs(codes_t: torch.Tensor, bits: int, tile: int) -> torch.Tensor:
    if bits not in (2, 3, 4):
        raise ValueError(f"pairs layout takes bits 2/3/4, got {bits}")
    k_pad, out_f = codes_t.shape
    vpw = _pairs_vpw(bits)
    if tile % vpw:
        raise ValueError(f"tile {tile} is not a multiple of {vpw}")
    W = tile // vpw
    tiles = codes_t.reshape(k_pad // tile, vpw // 2, W, 2, out_f)
    packed = (tiles << _pair_shifts(bits, codes_t.device)).sum(dim=(1, 3))
    return packed.reshape(k_pad // vpw, out_f)


def _unpack_pairs(words: torch.Tensor, bits: int, tile: int) -> torch.Tensor:
    W = tile // _pairs_vpw(bits)
    out_f = words.shape[1]
    p = words.reshape(-1, 1, W, 1, out_f)
    vals = (p >> _pair_shifts(bits, words.device)) & (2**bits - 1)
    return vals.reshape(-1, out_f)


def pack_codes(codes: torch.Tensor, bits: int,
               group_size: Optional[int] = None,
               tile_k: Optional[int] = None,
               layout: str = "planar") -> torch.Tensor:
    """Pack integer codes (out, in) into int32 words (see module docstring).
    Codes are zero-padded up to k_pad = roundup(in, tile)."""
    out_f, in_f = codes.shape
    tile = tile_k or pack_tile(bits, group_size, in_f, layout)
    codes_t = codes.t().to(torch.int64)
    pad = (-in_f) % tile
    if pad:
        codes_t = torch.nn.functional.pad(codes_t, (0, 0, 0, pad))
    k_pad = codes_t.shape[0]
    if layout == "pairs":
        return _to_int32(_pack_pairs(codes_t, bits, tile))
    if bits in (3, 6):
        # two planes per tile: (2-bit, 1-bit) for 3-bit, (4-bit, 2-bit) for 6
        lo_bits, hi_bits = (2, 1) if bits == 3 else (4, 2)
        n_tiles = k_pad // tile
        lo = _pack_planar(codes_t & (2**lo_bits - 1), lo_bits, tile)
        hi = _pack_planar(codes_t >> lo_bits, hi_bits, tile)
        packed = torch.cat([
            lo.reshape(n_tiles, tile * lo_bits // 32, out_f),
            hi.reshape(n_tiles, tile * hi_bits // 32, out_f)], dim=1)
        return _to_int32(packed.reshape(k_pad * bits // 32, out_f))
    return _to_int32(_pack_planar(codes_t, bits, tile))


def unpack_codes(packed: torch.Tensor, bits: int, in_features: int,
                 group_size: Optional[int] = None,
                 tile_k: Optional[int] = None,
                 layout: str = "planar") -> torch.Tensor:
    """Unpack int32 words into codes (in_features, out) int32 [W^T layout]."""
    out_f = packed.shape[1]
    tile = tile_k or pack_tile(bits, group_size, in_features, layout)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    if layout == "pairs":
        vals = _unpack_pairs(words, bits, tile)
    elif bits in (3, 6):
        lo_bits, hi_bits = (2, 1) if bits == 3 else (4, 2)
        tiles = words.reshape(-1, tile * bits // 32, out_f)
        n_lo = tile * lo_bits // 32
        lo = _unpack_planar(tiles[:, :n_lo].reshape(-1, out_f), lo_bits, tile)
        hi = _unpack_planar(tiles[:, n_lo:].reshape(-1, out_f), hi_bits, tile)
        vals = lo | (hi << lo_bits)
    else:
        vals = _unpack_planar(words, bits, tile)
    return vals[:in_features].to(torch.int32)


def default_layout(bits: int, group_size: Optional[int]) -> str:
    """'pairs' for bits 2/3/4 with per-channel or >= 128-row groups."""
    if bits in (2, 3, 4) and (group_size is None or group_size >= 128):
        return "pairs"
    return "planar"


def pack_weight(
    w: torch.Tensor,
    cfg: QuantConfig,
    lwc_params: Optional[dict] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    rzp: Optional[torch.Tensor] = None,
    tile_k: Optional[int] = None,
    layout: str = "planar",
) -> PackedWeight:
    """Quantize and pack a weight (out, in) into a PackedWeight.

    With ``scale``/``rzp`` (calibration-recorded grid, (num_groups, 1)) the
    codes are derived against that exact grid. ``layout="auto"`` picks
    default_layout and falls back to planar where a pairs 3-bit tile does
    not fit."""
    out_f, in_f = w.shape
    if scale is not None:
        deficiency = cfg.deficiency(in_f)
        xq = torch.nn.functional.pad(w, (0, deficiency)) if deficiency else w
        grouped = xq.reshape(-1, cfg.group_size) if cfg.group_size else xq
        codes = torch.clamp(torch.round(grouped / scale) + rzp,
                            cfg.qmin, cfg.qmax)
        codes = codes.reshape(out_f, in_f + deficiency).to(torch.int32)
    else:
        codes, scale, rzp = quantize_weight_int(w, cfg, lwc_params)
    in_padded = codes.shape[1]
    scales = scale.reshape(out_f, -1).to(torch.float32)
    zeros = rzp.reshape(out_f, -1).to(torch.float32)
    auto = layout == "auto"
    if auto:
        layout = default_layout(cfg.n_bits, cfg.group_size)
    tile = tile_k or pack_tile(cfg.n_bits, cfg.group_size, in_padded, layout)
    if cfg.n_bits == 3 and layout == "pairs" and tile % 80:
        if not auto:
            raise ValueError(
                f"tile_k {tile} incompatible with the pairs 3-bit layout "
                "(needs a multiple of 80 rows)")
        layout = "planar"
        tile = tile_k or pack_tile(cfg.n_bits, cfg.group_size, in_padded)
    if cfg.group_size and tile % cfg.group_size:
        raise ValueError(
            f"tile_k {tile} must be a multiple of group_size "
            f"{cfg.group_size} (quant groups must not straddle pack tiles)")
    return PackedWeight(
        qweight=pack_codes(codes, cfg.n_bits, cfg.group_size, tile, layout),
        scales=scales, zeros=zeros, bias=bias, bits=cfg.n_bits,
        group_size=cfg.group_size, in_features=in_padded, out_features=out_f,
        tile_k=tile, layout=layout)


def dequantize_packed(pw: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    """PackedWeight -> dense W^T (in_features, out), computed in float32 and
    cast to ``dtype``."""
    in_f = min(pw.in_features,
               rows_per_words(pw.bits, pw.qweight.shape[0], pw.layout))
    codes = unpack_codes(pw.qweight, pw.bits, in_f, pw.group_size,
                         pw.tile_k, pw.layout)
    out_f = codes.shape[1]
    scales_t = pw.scales.t().to(torch.float32)
    zeros_t = pw.zeros.t().to(torch.float32)
    if pw.group_size:
        n_g = in_f // pw.group_size
        cg = codes.reshape(n_g, pw.group_size, out_f).to(torch.float32)
        deq = ((cg - zeros_t[:n_g, None]) * scales_t[:n_g, None])
        deq = deq.reshape(in_f, out_f)
    else:
        deq = (codes.to(torch.float32) - zeros_t) * scales_t
    return deq.to(dtype)
