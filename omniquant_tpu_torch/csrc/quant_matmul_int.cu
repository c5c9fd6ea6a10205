// Integer-activation (W4A4 / W6A6) kernels for sm_90a: packed weight codes
// against per-token int8 activation codes on the s8 x s8 -> s32 tensor cores.
//
// Replaces three TPU kernels of omniquant_tpu/kernels/quant_matmul.py:
//   K8 _unpack_to_int8 (pallas_call at :569): packed words -> centered int8
//      codes, every layout and width of quant/packing.py, written K-major
//      (N, k_pad) as wgmma takes 8-bit operands (the TPU kernel writes
//      (k_pad, N));
//   K9 _quant_matmul_int_dense (_qmm_int_dense_call, :644): the dense
//      product of int8 activation codes (m, k_pad) and K8's codes (the
//      m >= 2048 route);
//   K7 quant_matmul_int (_qmm_int_call, :502): the same product with the
//      planar words unpacked inside the kernel (the small-m route).
// Both products evaluate, with xc the centered activation codes, xs their
// per-token f32 scale, wc = code - 2^{b-1}, sc the group scale and
// off2 = (2^{b-1} - zero) * scale,
//     y[m, n] = xs_m * sum_g [ dot(xc_g, wc_g)[m, n] * sc_g[n]
//                              + xsum_g[m] * off2_g[n] ],
// with each group's dot exact in int32 and turned into f32 at the group's
// end. off2 is rounded to bf16 at each step as a bf16 engine forms it.
// Group indices past the last group (the rows of the layout padding, whose
// codes meet zero activations) reuse the last group's scales. K7 forms
// xsum_g (the group's sum of activation codes) from its own fragments
// (dp4a) and off2 from the bf16 scales and zeros; K9 takes xsum, sc and
// off2 as the wrapper forms them, as the JAX route does outside its kernel
// (xsum and off2 as the bf16 operands of the offset term's product).
//
// What bounds them on an H100:
//   K8 is a copy that reads the words once and writes one byte per code: it
//      is bound by those bytes. A CTA stages 32 columns of a pack tile in
//      shared memory and writes each column's codes as 16-byte runs of k.
//   K9 at prefill (m >= 2048) does 2*m*K*N integer operations and is bound
//      by the int8 tensor cores: wgmma m64n128k32 fed by TMA through a ring
//      of mbarrier-guarded stages, a producer warpgroup and two consumer
//      warpgroups whose group closes overlap each other's products, the
//      offset term on the bf16 tensor cores (see the K9 section).
//   K7 at decode (m = 32) reads each packed word once and is bound by those
//      bytes. A CTA of 4 warps takes 32 rows x 64 columns and a slice of the
//      pack tiles (split-K, so that several CTAs sit on every SM); each tile's
//      words are unpacked straight into the B fragment layout in shared
//      memory (never written to device memory). Slices write f32 partial
//      sums that a second pass (splitk_sum.cuh) adds in a fixed order; its
//      products are mma.sync m16n8k32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "planar.cuh"
#include "sm90.cuh"
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

// ---------------------------------------------------------------------------
// K8: a CTA takes K8_NB columns of one pack tile. Phase 1: a thread reads
// four consecutive words of one column (a warp: 32 consecutive columns, so
// each word row is one 128-byte load) and stores each slot's codes, four
// consecutive rows of k, as 4-byte words into a (K8_NB, T + 4) byte tile
// (the row pitch is 1 or 17 words mod 32: the 32 columns hit 32 banks).
// Phase 2: 16-byte runs of k, a warp taking 4 columns x 8 runs (conflict-
// free shared loads, 128 contiguous bytes per column in device memory).
constexpr int K8_NB = 32, K8_THREADS = 256;

template <int BITS, bool PAIRS>
__global__ void __launch_bounds__(K8_THREADS)
unpack_int8_kernel(const int32_t* __restrict__ qw, int8_t* __restrict__ out,
                   int N, int k_pad, int T) {
  constexpr int HALF = 1 << (BITS - 1);
  constexpr int PAIR_J = 16 / BITS;                       // pairs: slots j
  extern __shared__ __align__(16) uint8_t k8_tile[];
  const int P = PAIRS ? T / (2 * PAIR_J) : T * Planar<BITS>::LO / 32;
  const int WPT = PAIRS ? P : T * BITS / 32;              // words per tile
  const int LD = T + 4;
  const int t = blockIdx.y, col0 = blockIdx.x * K8_NB;
  const int32_t* src = qw + (size_t)t * WPT * N + col0;
  for (int i = threadIdx.x; i < (P / 4) * K8_NB; i += K8_THREADS) {
    const int c = i % K8_NB, q = i / K8_NB;
    uint32_t lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      lo[e] = (uint32_t)__ldg(src + (size_t)(4 * q + e) * N + c);
    uint8_t* dst = k8_tile + c * LD;
    if (PAIRS) {
      // word w holds rows j*2P + 2w + h at bits BITS*j + 16*h
#pragma unroll
      for (int j = 0; j < PAIR_J; ++j) {
        int cd[8];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            cd[2 * e + h] =
                (int)((lo[e] >> (BITS * j + 16 * h)) & ((1u << BITS) - 1u)) -
                HALF;
        uint32_t* d = reinterpret_cast<uint32_t*>(dst + j * 2 * P + 8 * q);
        d[0] = pack4(cd[0], cd[1], cd[2], cd[3]);
        d[1] = pack4(cd[4], cd[5], cd[6], cd[7]);
      }
    } else {
      uint32_t hi[4] = {0u, 0u, 0u, 0u};
      int sel[4] = {0, 0, 0, 0};
      if (Planar<BITS>::HI) {
        const int half_p = P / 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sel[e] = (4 * q + e) / half_p;
          hi[e] = (uint32_t)__ldg(src + (size_t)(P + (4 * q + e) % half_p) *
                                            N + c);
        }
      }
#pragma unroll
      for (int v = 0; v < Planar<BITS>::V; ++v) {
        int cd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cd[e] = planar_code<BITS>(lo[e], hi[e], v, sel[e]) - HALF;
        *reinterpret_cast<uint32_t*>(dst + v * P + 4 * q) =
            pack4(cd[0], cd[1], cd[2], cd[3]);
      }
    }
  }
  __syncthreads();
  const int CH = T / 16;  // 16-byte runs per column
  const int n_items = (K8_NB / 4) * ((CH + 7) / 8) * 32;
  for (int e = threadIdx.x; e < n_items; e += K8_THREADS) {
    const int sub = e % 32, b = e / 32;
    const int c = (b % (K8_NB / 4)) * 4 + sub / 8;
    const int ch = (b / (K8_NB / 4)) * 8 + sub % 8;
    if (ch >= CH) continue;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(k8_tile + c * LD +
                                                          ch * 16);
    *reinterpret_cast<uint4*>(out + (size_t)(col0 + c) * k_pad +
                              (size_t)t * T + ch * 16) =
        make_uint4(s[0], s[1], s[2], s[3]);
  }
}

template <int BITS, bool PAIRS>
int launch_unpack(const void* qw, void* out, int N, int k_pad, int T,
                  cudaStream_t st) {
  const int P = PAIRS ? T / (2 * (16 / BITS)) : T * Planar<BITS>::LO / 32;
  if (N % K8_NB || T % 16 || P % 4 || k_pad % T)
    return (int)cudaErrorInvalidValue;
  const int smem = K8_NB * (T + 4);
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        unpack_int8_kernel<BITS, PAIRS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(N / K8_NB, k_pad / T);
  unpack_int8_kernel<BITS, PAIRS><<<grid, K8_THREADS, smem, st>>>(
      static_cast<const int32_t*>(qw), static_cast<int8_t*>(out), N, k_pad,
      T);
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
// K9: dense int8 xc (m, k_pad) x K8's codes w8 (N, k_pad), both K-major, on
// wgmma m64n128k32 s8.s8.s32 fed by TMA.
//
// A CTA of 384 threads takes a 128 x 128 output tile. Warpgroup 0 is the
// producer: one thread walks the ring of K9_STAGES slots, waiting on a
// slot's empty barrier, arming its full barrier with the position's bytes
// and issuing two TMA boxes (128 rows x 128 bytes, 128-byte swizzle, zero
// fill past the matrix). The first n_off positions of the walk carry the
// offset term's bf16 operands, the rest the K stages of xc and w8 (128
// bytes of k each), each with a bulk copy of the scales of the tile's
// columns for every group that starts in the stage (512 bytes a group,
// into slot 0 or 1 by the half of the stage where it starts).
// Warpgroups 1 and 2 are the consumers, 64 rows x 128 columns each, with
// setmaxnreg giving them the producer's registers:
//  * the offset term sum_g xsum_g[row] * off2_g[col] goes to the tensor
//    cores: the wrapper splits each xsum exactly as 65536 a + 256 b + c
//    into bf16 columns (xo, rows x ko) against off2 repeated three times
//    (wo, N x ko; off2 is bf16 on the card), and bf16 wgmma m64n128k16
//    writes the products, exact, summed in f32, straight into the f32 sums;
//  * then chunks of CHUNK bytes of k (a whole stage where the groups and
//    k_pad are multiples of 128 rows, else half a stage; a chunk never
//    spans two groups), each its own wgmma commit group into one s32
//    accumulator set, with no branch around a wgmma (ptxas serializes
//    those). At a group's first chunk the thread reads the group's 32
//    scales of its columns from the stage into registers (scales read from
//    L2 here would wait behind the TMA streams). After a chunk's wgmmas
//    complete, its stage is freed at once if the chunk ends it, and at a
//    group's end the group closes: accf += float(acc) * sc[col] (cvt and
//    one FMA an element). The next group's first wgmma overwrites the
//    accumulator.
// The two consumers run unsynchronized, so one's close overlaps the
// other's products; each consumer's own stage is still a serial chain
// (issue, wait for its wgmmas, close), which is what bounds the kernel on
// an H100 (PERF.md). The epilogue multiplies by xs and stores bf16 pairs.
// The grid walks bands of K9_GM row tiles, rows fastest, so a band's
// activations and a few weight tiles stay in L2.
constexpr int K9_BM = 128, K9_BN = 128, K9_BK = 128, K9_STAGES = 6;
constexpr int K9_THREADS = 384, K9_GM = 16;
constexpr int K9_BOX = K9_BM * K9_BK;                       // 16 KB
constexpr int K9_SC = K9_BN * 4;  // a group's scales of the tile's columns
constexpr int K9_STAGE = 2 * K9_BOX + 2 * K9_SC;  // groups start <= 2 a stage
constexpr int K9_OFF_K = 64;  // bf16 columns of the offset term a stage
constexpr int K9_SMEM = K9_STAGES * K9_STAGE + 2 * K9_STAGES * 8 + 1024;
static_assert(K9_STAGE % 1024 == 0, "swizzled boxes need 1024-byte bases");

// one chunk of CHUNK bytes of k: straight-line k32 steps from shared
// addresses a, b; the group's first step overwrites the accumulator
template <int CHUNK>
__device__ __forceinline__ void k9_issue(int (&acc)[64], uint32_t a,
                                         uint32_t b, bool first) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < CHUNK / 32; ++q)
    wgmma_s8(acc, desc_k_sw128(a + 32 * q), desc_k_sw128(b + 32 * q),
             (q == 0 && first) ? 0 : 1);
  wgmma_commit();
}


template <int CHUNK>
__global__ void __launch_bounds__(K9_THREADS, 1)
qmm_int_dense_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_xo,
                     const __grid_constant__ CUtensorMap map_wo,
                     const float* __restrict__ sc,
                     const float* __restrict__ xs,
                     __nv_bfloat16* __restrict__ y, int m, int N, int k_pad,
                     int gs, int n_off) {
  // no runtime division in the loops (a division by gs is a dependent
  // MUFU sequence on the GPU): chunks of a group are counted instead
  const int chunks_per_group = gs / CHUNK;
  extern __shared__ uint8_t k9_raw[];
  const uint32_t raw = smem_u32(k9_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = k9_raw + (base - raw);
  const uint32_t bars = base + K9_STAGES * K9_STAGE;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (K9_STAGES + i); };

  // the tile: bands of K9_GM row tiles, rows fastest inside a band
  const int n_tiles = N / K9_BN, m_tiles = (m + K9_BM - 1) / K9_BM;
  const int band = K9_GM * n_tiles;
  const int first = (int)blockIdx.x / band * K9_GM;
  const int gm = min(m_tiles - first, K9_GM);
  const int in_band = (int)blockIdx.x % band;
  const int row0 = (first + in_band % gm) * K9_BM;
  const int col0 = in_band / gm * K9_BN;
  const int n_stages = (k_pad + K9_BK - 1) / K9_BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < K9_STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // ring positions: n_off offset-term stages, then the K stages
      for (int p = 0; p < n_off + n_stages; ++p) {
        const int slot = p % K9_STAGES;
        mbar_wait(empty(slot), ((p / K9_STAGES) & 1) ^ 1);
        const uint32_t st = base + slot * K9_STAGE;
        if (p < n_off) {
          mbar_arm(full(slot), 2 * K9_BOX);
          tma_box(st, &map_xo, full(slot), p * K9_OFF_K, row0);
          tma_box(st + K9_BOX, &map_wo, full(slot), p * K9_OFF_K, col0);
        } else {
          // the groups that start in this stage (at half h), their scales
          const int k0 = (p - n_off) * K9_BK;
          bool starts[2];
          for (int h = 0; h < 2; ++h)
            starts[h] = k0 + 64 * h < k_pad && (k0 + 64 * h) % gs == 0;
          mbar_arm(full(slot),
                   2 * K9_BOX + (starts[0] + starts[1]) * K9_SC);
          tma_box(st, &map_x, full(slot), k0, row0);
          tma_box(st + K9_BOX, &map_w, full(slot), k0, col0);
          for (int h = 0; h < 2; ++h)
            if (starts[h])
              bulk_copy(st + 2 * K9_BOX + h * K9_SC,
                        sc + (size_t)((k0 + 64 * h) / gs) * N + col0, K9_SC,
                        full(slot));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;  // rows 64*cw of the tile
    const int t = threadIdx.x % 128, lane = t & 31;
    const int r0 = cw * 64 + (t >> 5) * 16 + (lane >> 2);  // and r0 + 8
    const int col = 2 * (lane & 3);  // and + 1, + 8 j
    int acc[64];
    float accf[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0, accf[i] = 0.f;

    // the offset term, straight into the f32 sums
    for (int p = 0; p < n_off; ++p) {
      const int slot = p % K9_STAGES;
      const uint32_t a = base + slot * K9_STAGE + cw * 64 * K9_BK;
      const uint32_t b = base + slot * K9_STAGE + K9_BOX;
      mbar_wait(full(slot), (p / K9_STAGES) & 1);
      fence_acc(accf);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wgmma_bf16(accf, desc_k_sw128(a + 32 * q),
                   desc_k_sw128(b + 32 * q), (p == 0 && q == 0) ? 0 : 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(accf);
      mbar_arrive(empty(slot));
    }

    float2 sc2[16];
    const int n_chunks = k_pad / CHUNK;
    // ring position of the K walk, its slot and phase; chunks of the group
    int slot = n_off % K9_STAGES, phase = (n_off / K9_STAGES) & 1, in_g = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = c * CHUNK, k1 = k0 + CHUNK;
      const int half = (k0 & (K9_BK - 1)) / 64;
      if (half == 0) mbar_wait(full(slot), phase);
      const uint32_t st = base + slot * K9_STAGE + 64 * half;
      k9_issue<CHUNK>(acc, st + cw * 64 * K9_BK, st + K9_BOX, in_g == 0);
      if (in_g == 0) {  // the group's scales, read while its wgmmas run
        const float* g_sc = reinterpret_cast<const float*>(
            smem + slot * K9_STAGE + 2 * K9_BOX + half * K9_SC);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          sc2[j] = *reinterpret_cast<const float2*>(g_sc + col + 8 * j);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if ((k1 & (K9_BK - 1)) == 0 || k1 == k_pad) {
        mbar_arrive(empty(slot));
        if (++slot == K9_STAGES) slot = 0, phase ^= 1;
      }
      if (++in_g == chunks_per_group) {  // the group's close
        in_g = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          accf[4 * j] = fmaf((float)acc[4 * j], sc2[j].x, accf[4 * j]);
          accf[4 * j + 1] =
              fmaf((float)acc[4 * j + 1], sc2[j].y, accf[4 * j + 1]);
          accf[4 * j + 2] =
              fmaf((float)acc[4 * j + 2], sc2[j].x, accf[4 * j + 2]);
          accf[4 * j + 3] =
              fmaf((float)acc[4 * j + 3], sc2[j].y, accf[4 * j + 3]);
        }
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + r0 + 8 * h;
      if (r >= m) continue;
      const float s = xs[r];
      __nv_bfloat16* dst = y + (size_t)r * N + col0 + col;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(accf[4 * j + 2 * h] * s,
                                  accf[4 * j + 2 * h + 1] * s);
    }
  }
}

// a (rows, cols) matrix of 1- or 2-byte elements, K-major, read as boxes of
// 128 rows x 128 bytes with the 128-byte swizzle; past the matrix, zeros
bool k9_map(CUtensorMap* map, const void* ptr, int rows, int cols,
            bool bf16) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const int elem = bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(K9_BK / elem), K9_BM};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CHUNK>
int launch_dense(const CUtensorMap (&maps)[4], const void* sc, const void* xs,
                 void* y, int m, int N, int k_pad, int gs, int n_off,
                 cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_int_dense_kernel<CHUNK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K9_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int grid = (N / K9_BN) * ((m + K9_BM - 1) / K9_BM);
  qmm_int_dense_kernel<CHUNK><<<grid, K9_THREADS, K9_SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(sc),
      static_cast<const float*>(xs), static_cast<__nv_bfloat16*>(y), m, N,
      k_pad, gs, n_off);
  return (int)cudaGetLastError();
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

// K8. qweight (k_pad*bits/32 rows, or k_pad/10 for pairs 3-bit, N) int32
// with N % 32 == 0 and a multiple of 4 low-plane (or pairs) words per pack
// tile and column; out (N, k_pad) int8, K-major.
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

// K9. xc (m, k_pad) int8 and w8 (N, k_pad) int8, K-major; xo (m, ko) and
// wo (N, ko) bf16, the offset term's operands (ko a multiple of 64); sc
// (k_pad / gs, N) f32; xs (m) f32; y (m, N) bf16; every pointer 16-byte
// aligned. N % 128 == 0, gs (the group, or the pack tile for per-channel
// scales) a multiple of 64 dividing k_pad.
extern "C" int qmm_int_dense(const void* xc, const void* w8, const void* xo,
                             const void* wo, const void* sc, const void* xs,
                             void* y, int m, int N, int k_pad, int gs,
                             int ko, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % K9_BN || gs % 64 || k_pad % gs || ko % K9_OFF_K || ko <= 0)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {xc, w8, xo, wo, sc})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!k9_map(&maps[0], xc, m, k_pad, false) ||
      !k9_map(&maps[1], w8, N, k_pad, false) ||
      !k9_map(&maps[2], xo, m, ko, true) || !k9_map(&maps[3], wo, N, ko, true))
    return (int)cudaErrorInvalidValue;
  // whole stages a chunk where groups and k_pad allow, else half stages
  if (gs % K9_BK == 0 && k_pad % K9_BK == 0)
    return launch_dense<128>(maps, sc, xs, y, m, N, k_pad, gs, ko / K9_OFF_K,
                             st);
  return launch_dense<64>(maps, sc, xs, y, m, N, k_pad, gs, ko / K9_OFF_K,
                          st);
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
