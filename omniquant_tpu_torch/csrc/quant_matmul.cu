// Packed W2/W3/W4 (pairs layout) x bf16 activations -> bf16, for sm_90a.
//
// Replaces the TPU kernel omniquant_tpu/kernels/quant_matmul.py::quant_matmul
// (_qmm_call / _qmm_kernel, pallas_call at :276): y = x @ dequant(W), with W
// stored as packed int32 W^T words, per-group scales s and rounded zero
// points z, dequant(c) = (c - z) * s.
//
// Both tiles evaluate, with codes turned into bf16 in registers and
// multiplied on the tensor cores (mma.sync m16n8k16, f32 accumulation), the
// scales applied per quant group in f32 after the products:
//     y = sum_g s_g * (x_g . c_g) + xsum_g * off_g,   off_g = -z_g * s_g.
// Codes < 16 are exact in bf16 and bf16 x bf16 products are exact in f32, so
// nothing is rounded before the f32 sums (no bf16 rounding of scales or of
// dequantised weights). A pairs-layout word holds two consecutive rows
// (bits 16*h apart), which is exactly the k-pair an mma fragment register
// holds, so one shift, one and-or and one bf16x2 subtract give a ready
// fragment register.
//
// Decode tile (m <= 32). At decode the packed words are read once and each
// is used by at most 32 rows, so the kernel is bound by the bytes of the
// words (a W4 7B layer moves ~100 MB; the byte bound of its four products
// is ~0.034 ms on an H100). What the design does about it:
//   * Each word is loaded from device memory once. A K step is WS = 8*KB
//     consecutive words of one pack tile (KB = 4 where the tile has a
//     multiple of 32 words per column) for 128 columns, and covers every
//     bit field of them: field j of word w is the k-pair at tile rows
//     j*2W + 2w + {0,1} (W words per tile). A thread reads its words from
//     shared memory once per step into registers and unpacks all fields
//     from there.
//   * Loads in flight: the words (16-byte cp.async, neighbouring threads on
//     neighbouring columns) and the x columns of all fields of the step
//     (rows >= m and columns >= K zero-filled) go through a ring of 2
//     shared-memory stages (~34 KB each at m = 32): the next step is in
//     flight while one is multiplied, and three CTAs fit on an SM, so an SM
//     has three steps in flight and twelve warps to hide the latency of the
//     unpacking and the MMAs (on the card this beat 3 stages with 2 CTAs
//     per SM: at m = 32 the tile is bound by its instructions, not by the
//     bytes in flight).
//   * Operands swapped: 16 output columns are the A operand (the words give
//     A fragment registers directly) and x is B with n = 8 rows, so m = 8
//     costs one n8 tile and m = 32 four (MN templated: 1, 2 or 4).
//   * Split-K: the grid is (N / 128 column blocks, splits); slice s takes
//     pack tiles [s*per, min((s+1)*per, n_tiles)), so every projection puts
//     about three CTAs on each SM. Each slice applies its own groups' s and
//     off (exact algebra: the expression is linear per group) and writes f32
//     partial sums to a (splits, m, N) workspace; a second pass
//     (splitk_sum.cuh, shared with K7) adds them in slice order, so two
//     calls give bitwise equal results.
//   * A step's run of 2*WS rows of one field lies inside one quant group
//     (groups are a multiple of 64 rows, or one group over k_pad; runs of
//     2*WS <= 64 rows are aligned to their length), so each run is closed
//     into the f32 sums with one scale per column. The slice's (128
//     columns, groups) block of scales and zeros is loaded into shared
//     memory once, at the slice's start.
//   * xsum comes from one more MMA with an all-ones A operand, in the D
//     layout the close needs (no shuffles, no f32 adds per x pair); x's B
//     fragments come by ldmatrix. No index is divided inside the k16 loop.
//     (Feeding codes as 128 + c and taking 128 * xsum off at the close
//     would save the subtract but costs accuracy: the tensor cores sum the
//     larger products with fewer spare bits, and on the card many more
//     outputs then differed from the f32 reference by a bf16 step.)
// The wrapper refuses, for both tiles, a pack tile whose word count per
// column is not a multiple of 8 (pack_tile never makes one).
//
// Prefill tile (m > 32): ~2*m*K*N operations on the bf16 tensor cores bound
// it. 128 x 128 tiles, K steps of 32 rows, the x tile and the unpacked codes
// staged in shared memory (padded rows, no bank conflicts on the fragment
// loads). No cp.async/TMA/wgmma pipeline yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splitk_sum.cuh"

namespace {

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo16, hi16) code fields of a shifted word -> bf16x2 (c_lo, c_hi), exact:
// 0x4300 is bf16 128.0, and 128 + c (c < 128) carries c in its mantissa.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t t, uint32_t mask2) {
  uint32_t v = (t & mask2) | 0x43004300u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16x2_sum(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat162float(h.x) + __bfloat162float(h.y);
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
qmm_pairs_kernel(const __nv_bfloat16* __restrict__ x,
                 const int32_t* __restrict__ qw,
                 const __nv_bfloat16* __restrict__ scales,
                 const __nv_bfloat16* __restrict__ zeros,
                 __nv_bfloat16* __restrict__ y,
                 int m, int K, int N, int k_pad, int G, int gs_rows,
                 int tile_k, int bits, int x_vec) {
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int XS_LD = BK + 8;  // bf16 per x row in smem
  constexpr int WS_LD = BN + 8;  // code pairs per row pair in smem
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0, "tile shape");
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ uint32_t ws[(BK / 2) * WS_LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  const int vpw = 2 * (16 / bits);
  const int words_per_tile = tile_k / vpw;
  const int part_rows = 2 * words_per_tile;  // rows sharing one bit offset
  const uint32_t mask2 = ((1u << bits) - 1u) * 0x00010001u;

  float acc[MT][NT][4], part[MT][NT][4], xsum[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    xsum[i][0] = xsum[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;
  }

  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    // x tile (BM x BK), zero beyond m rows and K columns (the packed rows
    // past in_features carry code 0 but a non-zero dequant value)
    for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      const int gr = row0 + r, gc = k0 + c8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < m) {
        const __nv_bfloat16* src = x + (size_t)gr * K + gc;
        if (x_vec && gc + 8 <= K) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            tmp[e] = (gc + e < K) ? src[e] : __float2bfloat16(0.f);
          v = *reinterpret_cast<const uint4*>(tmp);
        }
      }
      *reinterpret_cast<uint4*>(&xs[r * XS_LD + c8]) = v;
    }
    // codes of rows k0..k0+BK-1 as bf16 pairs (row k even, row k+1)
    for (int i = tid; i < (BK / 2) * BN; i += NTHREADS) {
      const int rp = i / BN, c = i % BN;
      const int k = k0 + 2 * rp;
      uint32_t v = 0u;
      if (k < k_pad) {
        const int t = k / tile_k, n = k - t * tile_k;
        const int j = n / part_rows, w = (n - j * part_rows) >> 1;
        const uint32_t word = (uint32_t)__ldg(
            qw + (size_t)(t * words_per_tile + w) * N + col0 + c);
        v = codes_bf16x2(word >> (bits * j), mask2);
      }
      ws[rp * WS_LD + c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * WM + mt * 16 + g, c = kk * 16 + t4 * 2;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&xs[r * XS_LD + c]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&xs[(r + 8) * XS_LD + c]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&xs[r * XS_LD + c + 8]);
        a[mt][3] =
            *reinterpret_cast<const uint32_t*>(&xs[(r + 8) * XS_LD + c + 8]);
        xsum[mt][0] += bf16x2_sum(a[mt][0]) + bf16x2_sum(a[mt][2]);
        xsum[mt][1] += bf16x2_sum(a[mt][1]) + bf16x2_sum(a[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cc = wn * WN + nt * 8 + g;
        const uint32_t b0 = ws[(kk * 8 + t4) * WS_LD + cc];
        const uint32_t b1 = ws[(kk * 8 + 4 + t4) * WS_LD + cc];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_16816(part[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();

    const int k_next = k0 + BK;
    if (k_next % gs_rows == 0 || k_next >= k_pad) {
      // end of a quant group: scale its partial products, add the zero term
      const int grp = min(k0 / gs_rows, G - 1);  // padded rows reuse the last
      float rs[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = xsum[mt][h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          rs[mt][h] = v;
          xsum[mt][h] = 0.f;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + wn * WN + nt * 8 + t4 * 2 + e;
          const float s = __bfloat162float(scales[(size_t)col * G + grp]);
          const float off = -__bfloat162float(zeros[(size_t)col * G + grp]) * s;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][e] += part[mt][nt][e] * s + rs[mt][0] * off;
            acc[mt][nt][e + 2] += part[mt][nt][e + 2] * s + rs[mt][1] * off;
            part[mt][nt][e] = part[mt][nt][e + 2] = 0.f;
          }
        }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = row0 + wm * WM + mt * 16 + g;
      const int c = col0 + wn * WN + nt * 8 + t4 * 2;
      if (r < m)
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)r * N + c]) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < m)
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)(r + 8) * N + c]) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
void launch(const void* x, const void* qw, const void* scales,
            const void* zeros, void* y, int m, int K, int N, int k_pad, int G,
            int gs_rows, int tile_k, int bits, int x_vec, cudaStream_t st) {
  dim3 grid(N / BN, (m + BM - 1) / BM);
  qmm_pairs_kernel<BM, BN, BK, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int32_t*>(qw),
          static_cast<const __nv_bfloat16*>(scales),
          static_cast<const __nv_bfloat16*>(zeros),
          static_cast<__nv_bfloat16*>(y), m, K, N, k_pad, G, gs_rows, tile_k,
          bits, x_vec);
}

// ---------------------------------------------------------------------------
// Decode tile (m <= 32): see the note at the top of the file.
constexpr int DEC_BN = 128;           // output columns per CTA (4 warps x 32)
constexpr int DEC_THREADS = 128;
constexpr int DEC_STAGES = 2;         // shared-memory ring
constexpr int DEC_LDW = DEC_BN + 8;   // words per staged row: conflict-free

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

__host__ __device__ __forceinline__ int pairs_fields(int bits) {
  return bits == 3 ? 5 : 16 / bits;  // code fields per 16-bit half word
}

// bf16 elements per staged x row: the 2*WS columns of every field, padded
// so that the B fragment loads of 8 rows x 4 words hit 32 distinct banks
__host__ __device__ __forceinline__ int dec_ldx(int fields, int ws) {
  return fields * 2 * ws + 8;
}

// four 8 x 8 bf16 tiles of x (rows from the lanes' addresses) as B
// fragments, or two with X2
template <bool X2>
__device__ __forceinline__ void ldmatrix_b(uint32_t (&r)[4], const void* p) {
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

// MN: n8 tiles of x rows (m <= 8 * MN); KB: k16 blocks (8 words) per step
template <int MN, int KB>
__global__ void __launch_bounds__(DEC_THREADS)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ qw,
                  const __nv_bfloat16* __restrict__ scales,
                  const __nv_bfloat16* __restrict__ zeros,
                  float* __restrict__ part, __nv_bfloat16* __restrict__ y,
                  int m, int K, int N, int G, int gs_rows, int T, int bits,
                  int n_tiles, int per, int x_vec) {
  constexpr int WS = 8 * KB, MR = 8 * MN;
  constexpr int SCALE_BATCH = 8;  // scale loads in flight per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = pairs_fields(bits);
  const int W = T / (2 * F);  // words per tile and column
  const int PR = 2 * W;       // tile rows per field
  const int LDX = dec_ldx(F, WS);
  const int steps_per_tile = W / WS;
  const int words_bytes = WS * DEC_LDW * 4;
  const int stage_bytes = words_bytes + MR * LDX * 2;
  // (scale, zero) bf16 pairs of the slice's groups, [group][column]
  uint32_t* sz = reinterpret_cast<uint32_t*>(smem + DEC_STAGES * stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * DEC_BN, cw = warp * 32;
  const int t_begin = blockIdx.y * per;
  const int t_end = min(t_begin + per, n_tiles);
  const int n_steps = (t_end - t_begin) * steps_per_tile;
  const int g0 = t_begin * T / gs_rows;
  const int ng = (t_end * T - 1) / gs_rows - g0 + 1;
  const uint32_t mask2 = ((1u << bits) - 1u) * 0x00010001u;

  auto load_step = [&](int step) {
    const int tt = step / steps_per_tile;
    const int t = t_begin + tt, ws0 = (step - tt * steps_per_tile) * WS;
    unsigned char* base = smem + (step % DEC_STAGES) * stage_bytes;
    uint32_t* wsm = reinterpret_cast<uint32_t*>(base);
    __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(base + words_bytes);
    const int32_t* src = qw + ((size_t)t * W + ws0) * N + col0;
    for (int i = tid; i < WS * (DEC_BN / 4); i += DEC_THREADS) {
      const int w = i / (DEC_BN / 4), c4 = (i % (DEC_BN / 4)) * 4;
      cp_async16(wsm + w * DEC_LDW + c4, src + (size_t)w * N + c4, 16);
    }
    // x columns of each field's run, zero at rows >= m and columns >= K
    // (the packed rows past in_features carry code 0 but enter xsum)
    const int kt = t * T + 2 * ws0;
    for (int j = 0; j < F; ++j) {
      for (int i = tid; i < MR * (WS / 4); i += DEC_THREADS) {
        const int r = i / (WS / 4), c8 = (i % (WS / 4)) * 8;
        const int gc = kt + j * PR + c8;
        __nv_bfloat16* dst = xsm + r * LDX + j * 2 * WS + c8;
        if (x_vec) {
          const bool in = r < m && gc < K;
          cp_async16(dst, in ? x + (size_t)r * K + gc : x, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (r < m && gc + e < K) ? x[(size_t)r * K + gc + e]
                                           : __float2bfloat16(0.f);
        }
      }
    }
  };

  // the ring's first stages go out before anything waits on memory
#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }
  // the slice's scales and zeros, once, SCALE_BATCH loads in flight per
  // thread; each column's groups are contiguous, and the groups of the
  // layout padding (past G) reuse the last group's
  for (int i0 = 0; i0 < ng * DEC_BN; i0 += SCALE_BATCH * DEC_THREADS) {
    __nv_bfloat16 sv[SCALE_BATCH], zv[SCALE_BATCH];
#pragma unroll
    for (int u = 0; u < SCALE_BATCH; ++u) {
      const int i = i0 + u * DEC_THREADS + tid;
      if (i < ng * DEC_BN) {
        const int c = i / ng, gi = i - c * ng;
        const size_t src = (size_t)(col0 + c) * G + min(g0 + gi, G - 1);
        sv[u] = scales[src];
        zv[u] = zeros[src];
      }
    }
#pragma unroll
    for (int u = 0; u < SCALE_BATCH; ++u) {
      const int i = i0 + u * DEC_THREADS + tid;
      if (i < ng * DEC_BN) {
        const int c = i / ng, gi = i - c * ng;
        __nv_bfloat162 v;
        v.x = sv[u];
        v.y = zv[u];
        sz[gi * DEC_BN + c] = *reinterpret_cast<uint32_t*>(&v);
      }
    }
  }

  float acc[2][MN][4];
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int nt = 0; nt < MN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mc][nt][e] = 0.f;
  const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                            0x3f803f80u};  // bf16 1.0 pairs
  // ldmatrix rows: lane L addresses row L % 8 of tile L / 8, tiles ordered
  // (n8 tile, k half): (nt, 0), (nt, 1), (nt + 1, 0), (nt + 1, 1)
  const int lm_row = ((lane >> 4) * 8 + (lane & 7)), lm_half = (lane >> 3) & 1;

  int t = t_begin, ws0 = 0;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // step's stage landed; step - 1's stage is free
    if (step + DEC_STAGES - 1 < n_steps) load_step(step + DEC_STAGES - 1);
    cp_async_commit();

    const unsigned char* base = smem + (step % DEC_STAGES) * stage_bytes;
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(base);
    const __nv_bfloat16* xsm =
        reinterpret_cast<const __nv_bfloat16*>(base + words_bytes);
    // A fragments of every field: words 8kb + t4 (+4) of columns g (+8)
    uint32_t wr[KB][2][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int mc = 0; mc < 2; ++mc) {
        const uint32_t* p = wsm + (8 * kb + t4) * DEC_LDW + cw + mc * 16 + g;
        wr[kb][mc][0] = p[0];
        wr[kb][mc][1] = p[8];
        wr[kb][mc][2] = p[4 * DEC_LDW];
        wr[kb][mc][3] = p[4 * DEC_LDW + 8];
      }
    const int krow = t * T + 2 * ws0;
    for (int j = 0; j < F; ++j) {
      // pt: sum_k x c; xs: sum_k x (the ones row), per run
      float pt[2][MN][4], xs[MN][4];
#pragma unroll
      for (int nt = 0; nt < MN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[0][nt][e] = pt[1][nt][e] = xs[nt][e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        uint32_t b[MN][2];
#pragma unroll
        for (int nt = 0; nt < MN; nt += 2) {
          uint32_t r[4];
          ldmatrix_b<MN == 1>(
              r, xsm + (nt * 8 + lm_row) * LDX + j * 2 * WS + 16 * kb +
                     8 * lm_half);
          b[nt][0] = r[0];
          b[nt][1] = r[1];
          if (MN > 1) {
            b[nt + 1][0] = r[2];
            b[nt + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int nt = 0; nt < MN; ++nt)
          mma_16816(xs[nt], ones, b[nt][0], b[nt][1]);
#pragma unroll
        for (int mc = 0; mc < 2; ++mc) {
          uint32_t a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = codes_bf16x2(wr[kb][mc][e], mask2);
            wr[kb][mc][e] >>= bits;  // the next field
          }
#pragma unroll
          for (int nt = 0; nt < MN; ++nt)
            mma_16816(pt[mc][nt], a, b[nt][0], b[nt][1]);
        }
      }
      // close the run (one quant group): D rows are columns g and g + 8,
      // D columns the x rows 2*t4 and 2*t4 + 1 of each n8 tile
      const int gi = (krow + j * PR) / gs_rows - g0;
#pragma unroll
      for (int mc = 0; mc < 2; ++mc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v = sz[gi * DEC_BN + cw + mc * 16 + g + 8 * h];
          const __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&v);
          const float s = __bfloat162float(p.x);
          const float off = -__bfloat162float(p.y) * s;
#pragma unroll
          for (int nt = 0; nt < MN; ++nt) {
            acc[mc][nt][2 * h] += pt[mc][nt][2 * h] * s + xs[nt][0] * off;
            acc[mc][nt][2 * h + 1] +=
                pt[mc][nt][2 * h + 1] * s + xs[nt][1] * off;
          }
        }
    }
    ws0 += WS;
    if (ws0 == W) {
      ws0 = 0;
      ++t;
    }
  }

  const bool split = gridDim.y > 1;
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int nt = 0; nt < MN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + 2 * t4 + (e & 1);
        const int n = col0 + cw + mc * 16 + g + 8 * (e >> 1);
        if (r >= m) continue;
        if (split)
          part[((size_t)blockIdx.y * m + r) * N + n] = acc[mc][nt][e];
        else
          y[(size_t)r * N + n] = __float2bfloat16(acc[mc][nt][e]);
      }
}

template <int MN, int KB>
int launch_decode(const void* x, const void* qw, const void* scales,
                  const void* zeros, void* part, void* y, int m, int K, int N,
                  int k_pad, int G, int gs_rows, int T, int bits, int x_vec,
                  int splits, int per, cudaStream_t st) {
  const int n_tiles = k_pad / T;
  const int fields = pairs_fields(bits);
  // the largest scale block a slice of per tiles can span
  const int ng = T % gs_rows ? (per * T - 1) / gs_rows + 2 : per * T / gs_rows;
  const int smem = DEC_STAGES * (8 * KB * DEC_LDW * 4 +
                                 8 * MN * dec_ldx(fields, 8 * KB) * 2) +
                   ng * DEC_BN * 4;
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_decode_kernel<MN, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(qmm_decode_kernel<MN, KB>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(N / DEC_BN, splits);
  qmm_decode_kernel<MN, KB><<<grid, DEC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(y), m, K, N, G, gs_rows, T, bits, n_tiles,
      per, x_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(part), nullptr,
                    static_cast<__nv_bfloat16*>(y), m, N, splits, st);
}

template <int MN>
int launch_decode_kb(const void* x, const void* qw, const void* scales,
                     const void* zeros, void* part, void* y, int m, int K,
                     int N, int k_pad, int G, int gs_rows, int T, int bits,
                     int x_vec, int splits, int per, cudaStream_t st) {
  const int W = T / (2 * pairs_fields(bits));
  if (W % 32 == 0)
    return launch_decode<MN, 4>(x, qw, scales, zeros, part, y, m, K, N, k_pad,
                                G, gs_rows, T, bits, x_vec, splits, per, st);
  if (W % 16 == 0)
    return launch_decode<MN, 2>(x, qw, scales, zeros, part, y, m, K, N, k_pad,
                                G, gs_rows, T, bits, x_vec, splits, per, st);
  return launch_decode<MN, 1>(x, qw, scales, zeros, part, y, m, K, N, k_pad,
                              G, gs_rows, T, bits, x_vec, splits, per, st);
}

}  // namespace

// N must be a multiple of 128; scales/zeros are (N, G) bf16 (a bf16 engine
// serves bf16-rounded scales); gs_rows is the group size (a multiple of 64),
// or k_pad for per-channel scales (G == 1). A pack tile holds a multiple of
// 8 words per column. For m <= 32 the K tiles are split into ``splits``
// slices of ``per`` tiles (the last may be shorter); with splits > 1, part
// is a (splits, m, N) f32 workspace. qweight must be 16-byte aligned.
extern "C" int qmm_pairs_bf16(const void* x, const void* qw,
                              const void* scales, const void* zeros,
                              void* part, void* y, int m, int K, int N,
                              int k_pad, int G, int gs_rows, int tile_k,
                              int bits, int x_vec, int splits, int per,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = k_pad / tile_k;
  if (m <= 32) {
    // a run of up to 64 rows must lie inside one group: groups a multiple
    // of 64 rows, or one group over k_pad
    if (N % DEC_BN || (tile_k / (2 * pairs_fields(bits))) % 8 ||
        (gs_rows < k_pad && gs_rows % 64) || splits < 1 || per < 1 ||
        (splits - 1) * per >= n_tiles || splits * per < n_tiles ||
        (splits > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    const int mn = m <= 8 ? 1 : (m <= 16 ? 2 : 4);
#define DEC_CASE(MN)                                                        \
  case MN:                                                                  \
    return launch_decode_kb<MN>(x, qw, scales, zeros, part, y, m, K, N,     \
                                k_pad, G, gs_rows, tile_k, bits, x_vec,     \
                                splits, per, st);
    switch (mn) {
      DEC_CASE(1)
      DEC_CASE(2)
      DEC_CASE(4)
    }
#undef DEC_CASE
    return (int)cudaErrorInvalidValue;
  }
  launch<128, 128, 32, 2, 4>(x, qw, scales, zeros, y, m, K, N, k_pad, G,
                             gs_rows, tile_k, bits, x_vec, st);
  return (int)cudaGetLastError();
}
