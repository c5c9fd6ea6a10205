// The planar packed-word layout of quant/packing.py, shared by K1
// (quant_matmul.cu) and K7/K8 (quant_matmul_int.cu).
//
// Within a pack tile of T rows, bit slot p of low-plane word w holds tile
// row p*P + w (P = T*LO/32 low words per column). 3-bit codes are a 2-bit
// low plane plus a 1-bit high plane, 6-bit a 4-bit plus a 2-bit plane; the
// P/2 high-plane words follow the low plane inside each tile, and the high
// bits of row v*P + w sit in high word w mod (P/2), at slot 2v + w / (P/2).
#pragma once

#include <stdint.h>

// planar widths: the low plane (the only one for 2/4/8 bits) and the high
// plane of 3-bit (2 + 1) and 6-bit (4 + 2) codes
template <int BITS>
struct Planar {
  static constexpr int LO = BITS == 3 ? 2 : (BITS == 6 ? 4 : BITS);
  static constexpr int HI = BITS - LO;
  static constexpr int V = 32 / LO;  // codes per low-plane word
};

// Code v of a low-plane word (tile row v*P + w, P low words per tile). For
// two planes, hi is the high-plane word of that row (word w mod P/2 of the
// high plane) and sel = w / (P/2) picks its slot 2v + sel.
template <int BITS>
__device__ __forceinline__ int planar_code(uint32_t lo, uint32_t hi, int v,
                                           int sel) {
  using PL = Planar<BITS>;
  int c = (lo >> (PL::LO * v)) & ((1u << PL::LO) - 1u);
  if (PL::HI)
    c |= ((hi >> (PL::HI * (2 * v + sel))) & ((1u << PL::HI) - 1u)) << PL::LO;
  return c;
}
