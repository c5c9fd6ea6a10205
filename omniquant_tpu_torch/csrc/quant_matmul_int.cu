// Integer-activation (W4A4 / W6A6) kernels for sm_90a: packed weight codes
// against per-token int8 activation codes on the s8 x s8 -> s32 tensor cores.
//
// Replaces three TPU kernels of omniquant_tpu/kernels/quant_matmul.py:
//   K8 _unpack_to_int8 (pallas_call at :569): packed words -> centered int8
//      codes (k_pad, N), every layout and width of quant/packing.py;
//   K9 _quant_matmul_int_dense (_qmm_int_dense_call, :644): the dense
//      product of int8 activation codes (m, K) and K8's codes (the m >= 2048
//      route);
//   K7 quant_matmul_int (_qmm_int_call, :502): the same product with the
//      planar words unpacked inside the kernel (the small-m route).
// Both products evaluate, with xc the centered activation codes, xs their
// per-token f32 scale, wc = code - 2^{b-1}, sc the group scale and
// off2 = (2^{b-1} - zero) * scale,
//     y[m, n] = xs_m * sum_g [ dot(xc_g, wc_g)[m, n] * sc_g[n]
//                              + xsum_g[m] * off2_g[n] ],
// with each group's dot exact in int32 (mma.sync m16n8k32 s8.s8.s32) and
// turned into f32 at the group's end. xsum_g (the group's sum of activation
// codes) is formed by the kernels from their own activation fragments
// (dp4a), and off2 from the bf16 scales and zeros, rounded to bf16 at each
// step as a bf16 engine forms it. Group indices past the last group (the
// rows of the layout padding, whose codes meet zero activations) reuse the
// last group's scales, so no scale column past G is read.
//
// What bounds them on an H100:
//   K8 is a copy that reads the words once and writes one byte per code: it
//      is bound by those bytes. One thread per (packed word, 4 columns):
//      16-byte loads, 4-byte stores, contiguous along N.
//   K9 at prefill (m >= 2048) does 2*m*K*N integer operations and is bound
//      by the int8 tensor cores. 128 x 128 tiles, 8 warps of 64 x 32, K steps
//      of 64 rows staged in shared memory (double buffered, the next
//      step's loads held in registers while the current one multiplies).
//      The weight tile is transposed to K-contiguous columns on the way in
//      (byte permutes), as the B fragment wants.
//   K7 at decode (m = 32) reads each packed word once and is bound by those
//      bytes. A CTA of 4 warps takes 32 rows x 64 columns and a slice of the
//      pack tiles (split-K, so that several CTAs sit on every SM); each tile's
//      words are unpacked straight into the B fragment layout in shared
//      memory (never written to device memory). Slices write f32 partial
//      sums that a second pass (splitk_sum.cuh) adds in a fixed order.
// No cp.async/TMA/wgmma pipeline yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "planar.cuh"
#include "splitk_sum.cuh"

namespace {

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// off2 = (2^{b-1} - z) * s, each step rounded to bf16 like bf16 tensor ops
__device__ __forceinline__ float off2_bf16(float s, float z, float half) {
  const float d = __bfloat162float(__float2bfloat16_rn(half - z));
  return __bfloat162float(__float2bfloat16_rn(d * s));
}

__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return (uint32_t)(c0 & 0xff) | ((uint32_t)(c1 & 0xff) << 8) |
         ((uint32_t)(c2 & 0xff) << 16) | ((uint32_t)(c3 & 0xff) << 24);
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}

// ---------------------------------------------------------------------------
// K8: one thread per (tile, low-plane or pairs word, 4 columns)
template <int BITS, bool PAIRS>
__global__ void __launch_bounds__(256)
unpack_int8_kernel(const int32_t* __restrict__ qw, int8_t* __restrict__ out,
                   int N, int n_tiles, int T) {
  constexpr int HALF = 1 << (BITS - 1);
  constexpr int PAIR_J = 16 / BITS;                       // pairs: slots j
  const int P = PAIRS ? T / (2 * PAIR_J) : T * Planar<BITS>::LO / 32;
  const int WPT = PAIRS ? P : T * BITS / 32;              // words per tile
  const int nq = N / 4;
  const long long items = (long long)n_tiles * P * nq;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const int c4 = (int)(i % nq);
    const long long tw = i / nq;
    const int w = (int)(tw % P), t = (int)(tw / P);
    const size_t col = (size_t)c4 * 4;
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(
        qw + ((size_t)t * WPT + w) * N + col));
    int8_t* dst = out + (size_t)t * T * N + col;
    if (PAIRS) {
#pragma unroll
      for (int j = 0; j < PAIR_J; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sh = BITS * j + 16 * h;
          int c[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            c[e] = (int)((word_of(lo, e) >> sh) & ((1u << BITS) - 1u)) - HALF;
          *reinterpret_cast<uint32_t*>(dst + (size_t)(j * 2 * P + 2 * w + h) *
                                                 N) =
              pack4(c[0], c[1], c[2], c[3]);
        }
    } else {
      uint4 hi = make_uint4(0u, 0u, 0u, 0u);
      int sel = 0;
      if (Planar<BITS>::HI) {
        const int half_p = P / 2;
        sel = w / half_p;
        hi = __ldg(reinterpret_cast<const uint4*>(
            qw + ((size_t)t * WPT + P + (w % half_p)) * N + col));
      }
#pragma unroll
      for (int v = 0; v < Planar<BITS>::V; ++v) {
        int c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e] = planar_code<BITS>(word_of(lo, e), word_of(hi, e), v, sel) -
                 HALF;
        *reinterpret_cast<uint32_t*>(dst + (size_t)(v * P + w) * N) =
            pack4(c[0], c[1], c[2], c[3]);
      }
    }
  }
}

template <int BITS, bool PAIRS>
int launch_unpack(const void* qw, void* out, int N, int k_pad, int T,
                  cudaStream_t st) {
  const int P = PAIRS ? T / (2 * (16 / BITS)) : T * Planar<BITS>::LO / 32;
  const long long items = (long long)(k_pad / T) * P * (N / 4);
  const int blocks = (int)std::min<long long>((items + 255) / 256, 132LL * 16);
  unpack_int8_kernel<BITS, PAIRS><<<blocks, 256, 0, st>>>(
      static_cast<const int32_t*>(qw), static_cast<int8_t*>(out), N,
      k_pad / T, T);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the group epilogue shared by K7 and K9: the group's int32 dots and the
// quad-reduced code sums of rows g and g+8 into the f32 sums
template <int MT, int NT>
__device__ __forceinline__ void close_group(
    int (&acc)[MT][NT][4], float (&accf)[MT][NT][4], int (&xsum)[MT][2],
    const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ zeros, int G, int grp, int col_base,
    int t4, float half) {
  float rs[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = xsum[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      rs[mt][h] = (float)v;
      xsum[mt][h] = 0;
    }
  grp = min(grp, G - 1);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col_base + nt * 8 + t4 * 2 + e;
      const float s = __bfloat162float(scales[(size_t)col * G + grp]);
      const float o =
          off2_bf16(s, __bfloat162float(zeros[(size_t)col * G + grp]), half);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        accf[mt][nt][e] += (float)acc[mt][nt][e] * s + rs[mt][0] * o;
        accf[mt][nt][e + 2] += (float)acc[mt][nt][e + 2] * s + rs[mt][1] * o;
        acc[mt][nt][e] = acc[mt][nt][e + 2] = 0;
      }
    }
}

// A fragments of one m16 x k32 slice from a K-contiguous shared tile, and
// their contribution to the row code sums (rows g and g+8)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], int (&xs)[2],
                                       const int8_t* tile, int ld, int row,
                                       int col) {
  a[0] = *reinterpret_cast<const uint32_t*>(tile + row * ld + col);
  a[1] = *reinterpret_cast<const uint32_t*>(tile + (row + 8) * ld + col);
  a[2] = *reinterpret_cast<const uint32_t*>(tile + row * ld + col + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(tile + (row + 8) * ld + col + 16);
  xs[0] = __dp4a((int)a[0], 0x01010101, __dp4a((int)a[2], 0x01010101, xs[0]));
  xs[1] = __dp4a((int)a[1], 0x01010101, __dp4a((int)a[3], 0x01010101, xs[1]));
}

// 16 activation code bytes of row r at column c (zero past m rows or K)
__device__ __forceinline__ uint4 load_x16(const int8_t* __restrict__ xc,
                                          int m, int K, int r, int c,
                                          bool x_vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < m && c < K) {
    const int8_t* src = xc + (size_t)r * K + c;
    if (x_vec && c + 16 <= K) {
      v = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      __align__(16) int8_t tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) tmp[e] = (c + e < K) ? src[e] : (int8_t)0;
      v = *reinterpret_cast<const uint4*>(tmp);
    }
  }
  return v;
}

// ---------------------------------------------------------------------------
// K9: dense int8 (m, K) x int8 (k_pad, N)
constexpr int K9_BM = 128, K9_BN = 128, K9_THREADS = 256, BK = 64;

struct K9Loads {
  static constexpr int A_CHUNKS = K9_BM * BK / 16 / K9_THREADS;   // uint4
  static constexpr int B_BLOCKS = (BK / 32) * (K9_BN / 16) / 8;   // per warp
  uint4 a[A_CHUNKS];
  uint32_t b[B_BLOCKS][4];
};

__device__ __forceinline__ void k9_fetch(K9Loads& L,
                                         const int8_t* __restrict__ xc,
                                         const int8_t* __restrict__ w8, int m,
                                         int K, int N, int row0, int col0,
                                         int k0, bool x_vec, int tid) {
#pragma unroll
  for (int i = 0; i < K9Loads::A_CHUNKS; ++i) {
    const int chunk = tid + i * K9_THREADS;
    const int r = chunk / (BK / 16), c = (chunk % (BK / 16)) * 16;
    L.a[i] = load_x16(xc, m, K, row0 + r, k0 + c, x_vec);
  }
  // each warp block is 32 k-rows x 16 columns; a lane takes 4 rows x 4
  // columns (lane & 3: column quad, lane >> 2: row quad)
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < K9Loads::B_BLOCKS; ++i) {
    const int blk = warp + i * 8;
    const int kb = blk / (K9_BN / 16), nb = blk % (K9_BN / 16);
    const int k = k0 + kb * 32 + (lane >> 2) * 4;
    const int n = col0 + nb * 16 + (lane & 3) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      L.b[i][r] = __ldg(reinterpret_cast<const uint32_t*>(
          w8 + (size_t)(k + r) * N + n));
  }
}

__device__ __forceinline__ void k9_store(const K9Loads& L, int8_t* As,
                                         int8_t* Bs, int tid) {
  constexpr int LD = BK + 16;
#pragma unroll
  for (int i = 0; i < K9Loads::A_CHUNKS; ++i) {
    const int chunk = tid + i * K9_THREADS;
    const int r = chunk / (BK / 16), c = (chunk % (BK / 16)) * 16;
    *reinterpret_cast<uint4*>(As + r * LD + c) = L.a[i];
  }
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < K9Loads::B_BLOCKS; ++i) {
    const int blk = warp + i * 8;
    const int kb = blk / (K9_BN / 16), nb = blk % (K9_BN / 16);
    const int k = kb * 32 + (lane >> 2) * 4;
    const int n = nb * 16 + (lane & 3) * 4;
    // 4 x 4 byte transpose: row words -> K-contiguous column words
    const uint32_t t0 = __byte_perm(L.b[i][0], L.b[i][1], 0x5140);
    const uint32_t t1 = __byte_perm(L.b[i][2], L.b[i][3], 0x5140);
    const uint32_t t2 = __byte_perm(L.b[i][0], L.b[i][1], 0x7362);
    const uint32_t t3 = __byte_perm(L.b[i][2], L.b[i][3], 0x7362);
    *reinterpret_cast<uint32_t*>(Bs + (n + 0) * LD + k) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(Bs + (n + 1) * LD + k) =
        __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(Bs + (n + 2) * LD + k) =
        __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(Bs + (n + 3) * LD + k) =
        __byte_perm(t2, t3, 0x7632);
  }
}

__global__ void __launch_bounds__(K9_THREADS)
qmm_int_dense_kernel(const int8_t* __restrict__ xc,
                     const float* __restrict__ xs,
                     const int8_t* __restrict__ w8,
                     const __nv_bfloat16* __restrict__ scales,
                     const __nv_bfloat16* __restrict__ zeros,
                     __nv_bfloat16* __restrict__ y, int m, int K, int N,
                     int k_pad, int G, int gs_rows, float half, int x_vec) {
  constexpr int WARPS_N = 4, WM = 64, WN = 32, MT = WM / 16, NT = WN / 8;
  constexpr int LD = BK + 16;  // row stride: conflict-free fragment loads
  __shared__ __align__(16) int8_t As[2][K9_BM * LD];
  __shared__ __align__(16) int8_t Bs[2][K9_BN * LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.y * K9_BM, col0 = blockIdx.x * K9_BN;

  int acc[MT][NT][4], xsum[MT][2];
  float accf[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    xsum[i][0] = xsum[i][1] = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0, accf[i][j][e] = 0.f;
  }

  K9Loads L;
  k9_fetch(L, xc, w8, m, K, N, row0, col0, 0, x_vec, tid);
  k9_store(L, As[0], Bs[0], tid);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    const bool more = k0 + BK < k_pad;
    if (more) k9_fetch(L, xc, w8, m, K, N, row0, col0, k0 + BK, x_vec, tid);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(a[mt], xsum[mt], As[buf], LD, wm * WM + mt * 16 + g,
               kk * 32 + t4 * 4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* bp = Bs[buf] + (wn * WN + nt * 8 + g) * LD + kk * 32 +
                           t4 * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
    if ((k0 + BK) % gs_rows == 0)
      close_group<MT, NT>(acc, accf, xsum, scales, zeros, G,
                          (k0 + BK) / gs_rows - 1, col0 + wn * WN, t4, half);
    if (more) {
      k9_store(L, As[buf ^ 1], Bs[buf ^ 1], tid);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + wm * WM + mt * 16 + g;
    const float s0 = r < m ? xs[r] : 0.f, s1 = r + 8 < m ? xs[r + 8] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + wn * WN + nt * 8 + t4 * 2;
      if (r < m)
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)r * N + c]) =
            __floats2bfloat162_rn(accf[mt][nt][0] * s0, accf[mt][nt][1] * s0);
      if (r + 8 < m)
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)(r + 8) * N + c]) =
            __floats2bfloat162_rn(accf[mt][nt][2] * s1, accf[mt][nt][3] * s1);
    }
  }
}

void launch_dense(const void* xc, const void* xs, const void* w8,
                  const void* scales, const void* zeros, void* y, int m,
                  int K, int N, int k_pad, int G, int gs_rows, float half,
                  int x_vec, cudaStream_t st) {
  dim3 grid(N / K9_BN, (m + K9_BM - 1) / K9_BM);
  qmm_int_dense_kernel<<<grid, K9_THREADS, 0, st>>>(
      static_cast<const int8_t*>(xc), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w8),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros),
      static_cast<__nv_bfloat16*>(y), m, K, N, k_pad, G, gs_rows, half,
      x_vec);
}

// ---------------------------------------------------------------------------
// K7: small m, planar words unpacked per pack tile in shared memory
constexpr int K7_BM = 32, K7_BN = 64, K7_THREADS = 128;

template <int BITS>
__global__ void __launch_bounds__(K7_THREADS)
qmm_int_planar_kernel(const int8_t* __restrict__ xc,
                      const float* __restrict__ xs,
                      const int32_t* __restrict__ qw,
                      const __nv_bfloat16* __restrict__ scales,
                      const __nv_bfloat16* __restrict__ zeros,
                      float* __restrict__ part, __nv_bfloat16* __restrict__ y,
                      int m, int K, int N, int G, int gs_rows, int T,
                      int n_tiles, int splits, int x_vec) {
  constexpr int MT = 2, NT = 2, WN = 16, HALF = 1 << (BITS - 1);
  using PL = Planar<BITS>;
  extern __shared__ __align__(16) int8_t smem[];
  const int LD = T + 16;  // T % 32 == 0: conflict-free fragment loads
  int8_t* As = smem;
  int8_t* Bs = smem + K7_BM * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * K7_BN, row0 = blockIdx.y * K7_BM;
  const int split = blockIdx.z;
  const int tile_begin = (int)((long long)split * n_tiles / splits);
  const int tile_end = (int)((long long)(split + 1) * n_tiles / splits);
  const int P = T * PL::LO / 32;  // low-plane words per tile and column
  const int WPT = T * BITS / 32;  // words per tile and column
  const int PQ = P / 4;           // word quads
  const int half_p = P / 2;

  int acc[MT][NT][4], xsum[MT][2];
  float accf[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    xsum[i][0] = xsum[i][1] = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0, accf[i][j][e] = 0.f;
  }

  for (int t = tile_begin; t < tile_end; ++t) {
    const int k0 = t * T;
    for (int i = tid; i < K7_BM * (T / 16); i += K7_THREADS) {
      const int r = i / (T / 16), c = (i % (T / 16)) * 16;
      *reinterpret_cast<uint4*>(As + r * LD + c) =
          load_x16(xc, m, K, row0 + r, k0 + c, x_vec);
    }
    // items of 4 consecutive low-plane words of one column; a warp takes
    // 8 columns x 4 quads, so its loads are 4 rows of 32 contiguous bytes
    // and its shared stores hit 32 distinct banks
    const int n_items = ((PQ + 3) / 4) * 4 * K7_BN;
    for (int i = tid; i < n_items; i += K7_THREADS) {
      const int n = (i & 7) + ((i >> 5) % (K7_BN / 8)) * 8;
      const int q = ((i >> 3) & 3) + ((i >> 5) / (K7_BN / 8)) * 4;
      if (q >= PQ) continue;
      const int32_t* src = qw + (size_t)t * WPT * N + col0 + n;
      uint32_t lo[4], hi[4];
      int sel[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = 4 * q + e;
        lo[e] = (uint32_t)__ldg(src + (size_t)w * N);
        hi[e] = 0u;
        sel[e] = 0;
        if (PL::HI) {
          sel[e] = w / half_p;
          hi[e] = (uint32_t)__ldg(src + (size_t)(P + w % half_p) * N);
        }
      }
      int8_t* dst = Bs + n * LD + 4 * q;
#pragma unroll
      for (int v = 0; v < PL::V; ++v) {
        int c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e] = planar_code<BITS>(lo[e], hi[e], v, sel[e]) - HALF;
        *reinterpret_cast<uint32_t*>(dst + v * P) =
            pack4(c[0], c[1], c[2], c[3]);
      }
    }
    __syncthreads();

    for (int gk = 0; gk < T; gk += gs_rows) {
      for (int kk = gk; kk < gk + gs_rows; kk += 32) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a(a[mt], xsum[mt], As, LD, mt * 16 + g, kk + t4 * 4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int8_t* bp = Bs + (warp * WN + nt * 8 + g) * LD + kk + t4 * 4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
        }
      }
      close_group<MT, NT>(acc, accf, xsum, scales, zeros, G,
                          (k0 + gk) / gs_rows, col0 + warp * WN, t4,
                          (float)HALF);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + warp * WN + nt * 8 + t4 * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= m) continue;
        const float v0 = accf[mt][nt][2 * h], v1 = accf[mt][nt][2 * h + 1];
        if (splits == 1) {
          const float s = xs[rr];
          *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)rr * N + c]) =
              __floats2bfloat162_rn(v0 * s, v1 * s);
        } else {
          *reinterpret_cast<float2*>(
              &part[((size_t)split * m + rr) * N + c]) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int BITS>
int launch_planar(const void* xc, const void* xs, const void* qw,
                  const void* scales, const void* zeros, void* part, void* y,
                  int m, int K, int N, int k_pad, int G, int gs_rows, int T,
                  int splits, int x_vec, cudaStream_t st) {
  const int smem = (K7_BM + K7_BN) * (T + 16);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_int_planar_kernel<BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(N / K7_BN, (m + K7_BM - 1) / K7_BM, splits);
  qmm_int_planar_kernel<BITS><<<grid, K7_THREADS, smem, st>>>(
      static_cast<const int8_t*>(xc), static_cast<const float*>(xs),
      static_cast<const int32_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(y), m, K, N, G, gs_rows, T, k_pad / T,
      splits, x_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(part),
                    static_cast<const float*>(xs),
                    static_cast<__nv_bfloat16*>(y), m, N, splits, st);
}

}  // namespace

// K8. qweight (k_pad*bits/32 rows, or k_pad/10 for pairs 3-bit, N) int32,
// 16-byte aligned with N % 4 == 0; out (k_pad, N) int8.
extern "C" int unpack_to_int8(const void* qw, void* out, int N, int k_pad,
                              int tile_k, int bits, int pairs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pairs) {
    switch (bits) {
      case 2: return launch_unpack<2, true>(qw, out, N, k_pad, tile_k, st);
      case 3: return launch_unpack<3, true>(qw, out, N, k_pad, tile_k, st);
      case 4: return launch_unpack<4, true>(qw, out, N, k_pad, tile_k, st);
    }
  } else {
    switch (bits) {
      case 2: return launch_unpack<2, false>(qw, out, N, k_pad, tile_k, st);
      case 3: return launch_unpack<3, false>(qw, out, N, k_pad, tile_k, st);
      case 4: return launch_unpack<4, false>(qw, out, N, k_pad, tile_k, st);
      case 6: return launch_unpack<6, false>(qw, out, N, k_pad, tile_k, st);
      case 8: return launch_unpack<8, false>(qw, out, N, k_pad, tile_k, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// K9. xc (m, K) int8, xs (m) f32, w8 (k_pad, N) int8, scales/zeros (N, G)
// bf16, y (m, N) bf16; N % 128 == 0, gs_rows (the group, or the pack tile
// for per-channel scales) a multiple of 64 dividing k_pad.
extern "C" int qmm_int_dense(const void* xc, const void* xs, const void* w8,
                             const void* scales, const void* zeros, void* y,
                             int m, int K, int N, int k_pad, int G,
                             int gs_rows, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % K9_BN || gs_rows % BK || k_pad % gs_rows)
    return (int)cudaErrorInvalidValue;
  const int x_vec = (K % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(xc) % 16 == 0);
  const float half = (float)(1 << (bits - 1));
  launch_dense(xc, xs, w8, scales, zeros, y, m, K, N, k_pad, G, gs_rows,
               half, x_vec, st);
  return (int)cudaGetLastError();
}

// K7. qweight planar (k_pad*bits/32, N) int32; part (splits, m, N) f32 when
// splits > 1 (else unused); N % 64 == 0; tile_k a multiple of 32 with whole
// word quads per plane, at most 1024; gs_rows a multiple of 64 (as K9 and
// K1 take) dividing tile_k.
extern "C" int qmm_int_planar(const void* xc, const void* xs, const void* qw,
                              const void* scales, const void* zeros,
                              void* part, void* y, int m, int K, int N,
                              int k_pad, int G, int gs_rows, int tile_k,
                              int bits, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % K7_BN || gs_rows % 64 || tile_k % gs_rows ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int x_vec = (K % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(xc) % 16 == 0);
#define K7_CASE(B)                                                         \
  case B:                                                                  \
    return launch_planar<B>(xc, xs, qw, scales, zeros, part, y, m, K, N,   \
                            k_pad, G, gs_rows, tile_k, splits, x_vec, st);
  switch (bits) {
    K7_CASE(2)
    K7_CASE(3)
    K7_CASE(4)
    K7_CASE(6)
    K7_CASE(8)
  }
#undef K7_CASE
  return (int)cudaErrorInvalidValue;
}
