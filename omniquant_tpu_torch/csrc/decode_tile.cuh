// The device pieces of K1's decode tiles (quant_matmul.cu) that the S1
// probe (probes.cu) is built from as well: the tensor-core and copy
// instructions, the bf16 code conversions, the planar step geometry, the
// planar fragment reads and the tiles' output store. See quant_matmul.cu's
// note for the tiles they make up.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planar.cuh"

namespace {

constexpr int DEC_BN = 128;           // output columns per CTA (4 warps x 32)
constexpr int DEC_THREADS = 128;
constexpr int DEC_LDW_PL = DEC_BN + 4;  // words per staged row: the fragment
                                        // reads of rows 2*t4 (+1) hit 32
                                        // distinct banks

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b, the accumulator not read: the first k16 block of a sum
__device__ __forceinline__ void mma_16816_first(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// (lo16, hi16) code fields of a shifted word -> bf16x2 (c_lo, c_hi), exact:
// 0x4300 is bf16 128.0, and 128 + c (c < 128) carries c in its mantissa.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t t, uint32_t mask2) {
  uint32_t v = (t & mask2) | 0x43004300u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 tiles of x (rows from the lanes' addresses) as
// fragments, or two with X2: the decode tiles' B operand, the prefill
// tile's A operand
template <bool X2>
__device__ __forceinline__ void ldmatrix_x(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if (X2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// The warp's 32 columns (from col) of the decode tile's sums: bf16 into y,
// or with split-K f32 into the slice's plane of the workspace.
template <int MN>
__device__ __forceinline__ void store_out(const float (&acc)[2][MN][4],
                                          float* __restrict__ part,
                                          __nv_bfloat16* __restrict__ y,
                                          int m, int N, int col, int g,
                                          int t4) {
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int nt = 0; nt < MN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + 2 * t4 + (e & 1);
        const int n = col + mc * 16 + g + 8 * (e >> 1);
        if (r >= m) continue;
        if (split)
          part[((size_t)blockIdx.y * m + r) * N + n] = acc[mc][nt][e];
        else
          y[(size_t)r * N + n] = __float2bfloat16(acc[mc][nt][e]);
      }
}

// A step's geometry for one planar width, KB k16 blocks a run and MN n8
// tiles of x rows: WS = 16*KB consecutive words of each of the NSEL low
// blocks (two for 3/6-bit: words b*B + w0 .. of the P low words, B =
// P/NSEL) and, for 3/6-bit, the WS high-plane words P + w0 .. both blocks
// share. Slot p of block b is a run of WS rows (tile rows p*P + b*B +
// w0 ..); the step's runs, in the order u = p*NSEL + b, go in NSUB
// sub-steps of RUNS runs, whose x columns are staged per sub-step while the
// words stay for the whole step. Two sub-steps (half the slots each) where
// a step's x columns take more than 16 KB, or 8 KB with a high plane (its
// block makes the step's words half as large again); else one. (Chosen on
// the card: at m = 8, two sub-steps were faster for 3-bit codes and slower
// for 6-bit ones.)
template <int BITS, int KB, int MN>
struct PlanarStep {
  static constexpr int NSEL = Planar<BITS>::HI ? 2 : 1;
  static constexpr int WS = 16 * KB;
  static constexpr int NBLK = NSEL + (Planar<BITS>::HI ? 1 : 0);
  static constexpr int X_BYTES = 8 * MN * Planar<BITS>::V * NSEL * WS * 2;
  static constexpr int NSUB =
      X_BYTES > 16384 || (NSEL == 2 && X_BYTES >= 8192) ? 2 : 1;
  static constexpr int RUNS = Planar<BITS>::V * NSEL / NSUB;
  static constexpr int LDX = RUNS * WS;  // bf16 per staged x row
  static constexpr int STEP_WORDS = NBLK * WS * DEC_LDW_PL;
};

// The k16 blocks of a planar decode run: 2 where a low block holds a
// multiple of 32 words at 2, 4 and 8 bits, else 1 (the tile takes a block
// of a multiple of 32 words at 4 and 8 bits, 16 at 2, 3 and 6).
__host__ __device__ inline int pl_dec_kb(int bits, int T) {
  const int lo = bits == 3 ? 2 : (bits == 6 ? 4 : bits);
  const int B = T * lo / 32 / (bits == 3 || bits == 6 ? 2 : 1);
  return bits != 3 && bits != 6 && B % 32 == 0 ? 2 : 1;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// A k-pair of planar codes (row k's in the low 16 bits) as a bf16x2
// fragment register, exact.
template <int BITS>
__device__ __forceinline__ uint32_t planar_bf16x2(uint32_t c) {
  if constexpr (BITS == 8) {
    // 2^23 + c is exact in f32; bf16 holds every integer up to 256
    const float f0 = __uint_as_float(0x4b000000u | (c & 0xffffu)) - 8388608.f;
    const float f1 = __uint_as_float(0x4b000000u | (c >> 16)) - 8388608.f;
    __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    return codes_bf16x2(c, 0x007f007fu);  // c < 64
  }
}

// Half hh of the k-pairs of a staged block's A registers: register e of
// column tile mc and k16 block kb holds column g + 8*(e & 1) (+ mc*16) of
// block words 16kb + 2*t4 + 8*(e >> 1) and the next, their low (hh = 0)
// or high (hh = 1) 16-bit halves side by side.
template <int KB>
__device__ __forceinline__ void planar_words(uint32_t (&d)[KB][2][4],
                                             const uint32_t* wsm, int hh) {
  const uint32_t sel = hh ? 0x7632u : 0x5410u;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int mc = 0; mc < 2; ++mc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t* q = wsm + (16 * kb + 8 * (e >> 1)) * DEC_LDW_PL +
                            mc * 16 + 8 * (e & 1);
        d[kb][mc][e] = __byte_perm(q[0], q[DEC_LDW_PL], sel);
      }
}

template <int MN>
__device__ __forceinline__ void zero_sums(float (&pt)[2][MN][4],
                                          float (&xs)[MN][4]) {
#pragma unroll
  for (int nt = 0; nt < MN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[0][nt][e] = pt[1][nt][e] = xs[nt][e] = 0.f;
}

// mma_16816 into d, or mma_16816_first where the sum starts
__device__ __forceinline__ void mma_16816_or_first(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1,
                                                   bool first) {
  if (first)
    mma_16816_first(d, a, b0, b1);
  else
    mma_16816(d, a, b0, b1);
}

}  // namespace
