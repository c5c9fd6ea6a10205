// Packed W2/W3/W4 (pairs layout) x bf16 activations -> bf16, for sm_90a.
//
// Replaces the TPU kernel omniquant_tpu/kernels/quant_matmul.py::quant_matmul
// (_qmm_call / _qmm_kernel, pallas_call at :276): y = x @ dequant(W), with W
// stored as packed int32 W^T words, per-group scales s and rounded zero
// points z, dequant(c) = (c - z) * s.
//
// What bounds it on an H100: at decode (m = 32) the packed weights are read
// once and reused 32 times, so the kernel is bound by the bytes of the words
// (a W4 7B layer moves ~100 MB); at prefill (m = 4096) it does ~2*m*K*N
// operations on the bf16 tensor cores and is bound by them.
//
// Design: codes are turned into bf16 in registers and multiplied on the
// tensor cores (mma.sync m16n8k16, f32 accumulation); the scales are applied
// per quant group in f32, after the products:
//     y = sum_g s_g * (x_g . c_g) + xsum_g * off_g,   off_g = -z_g * s_g.
// Codes < 16 are exact in bf16 and bf16 x bf16 products are exact in f32, so
// nothing is rounded before the f32 sums (no bf16 rounding of scales or of
// dequantised weights). A pairs-layout word holds two consecutive rows
// (bits 16*h apart), which is exactly the k-pair an mma B fragment register
// holds, so one shift, one and, one or and one bf16x2 subtract give a ready
// fragment. The x tile and the unpacked codes are staged in shared memory
// (padded rows, no bank conflicts on the fragment loads). Two tile shapes:
// a 32-row one for decode (more CTAs over N, deeper K steps) and a
// 128 x 128 one for prefill. No cp.async/TMA/wgmma pipeline yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// N must be a multiple of 128; scales/zeros are (N, G) bf16 (a bf16 engine
// serves bf16-rounded scales); gs_rows is the group size (a multiple of 64,
// the deepest K step), or k_pad for per-channel scales (G == 1).
extern "C" int qmm_pairs_bf16(const void* x, const void* qw,
                              const void* scales, const void* zeros, void* y,
                              int m, int K, int N, int k_pad, int G,
                              int gs_rows, int tile_k, int bits, int x_vec,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 32)
    launch<32, 32, 64, 1, 4>(x, qw, scales, zeros, y, m, K, N, k_pad, G,
                             gs_rows, tile_k, bits, x_vec, st);
  else
    launch<128, 128, 32, 2, 4>(x, qw, scales, zeros, y, m, K, N, k_pad, G,
                               gs_rows, tile_k, bits, x_vec, st);
  return (int)cudaGetLastError();
}
