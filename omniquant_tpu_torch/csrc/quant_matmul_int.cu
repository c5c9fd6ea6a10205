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
// xsum_g (the group's sum of activation codes) from its staged x codes and
// off2 from the bf16 scales and zeros; K9 takes xsum, sc and off2 as the
// wrapper forms them, as the JAX route does outside its kernel (xsum and
// off2 as the bf16 operands of the offset term's product).
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
//   K7 at decode (m = 32) and verify (m = 128) reads each packed word
//      once per CTA for all of its rows and is bound by those bytes (the
//      four W6 g128 7B products: ~0.049 ms on an H100). A CTA takes 64
//      columns, every row up to 128 (tokens are the n8 operand of
//      mma.sync m16n8k32, unpacked weight codes the A operand, straight
//      from the words into registers) and a split-K slice of pack tiles;
//      words and x codes go through a two-stage cp.async ring (see the K7
//      section). Slices write f32 partial sums that a second pass
//      (splitk_sum.cuh) adds in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "planar.cuh"
#include "sm90.cuh"
#include "splitk_sum.cuh"

namespace {

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
// K7: the small-m route (decode m <= 32, verify m = 128, every m < 2048).
//
// A CTA of 4 warps takes K7_BN = 64 output columns, up to 128 token rows
// (the n8 operand: MN tiles of 8 rows, MN = 1, 2, 4, 8 or 16; more rows
// take more row blocks, each reading the words once) and a split-K slice
// of pack tiles. A warp takes 16 columns: A-tile row g is column 2g, row
// g + 8 column 2g + 1, so a thread's two columns sit side by side.
//
// Steps. The fast path (B, the low-plane words per block, a multiple of
// 32) walks windows of 32 consecutive low words of every block (w0 ..
// w0 + 31 and, for 3/6-bit codes, B + w0 .. and the 32 high-plane words
// both share). Run f = p * NSEL + b of a window (slot p of block b) is 32
// consecutive tile rows f*B + w0 .., which is one k32 block of the MMA, in
// one quant group. A window's KW = V * NSEL k32 blocks go in H steps of KX
// (H = 1 up to 32 rows, 2 at 64, 4 at 128, so an x stage stays <= ~18 KB).
// The generic path (any other tile with whole word quads per plane) takes
// a whole pack tile as its window and its k32 blocks in row order, each
// thread finding its quads' words and slots at run time.
//
// Operands: the unpacked weight codes are A (u8, raw codes: the centering
// 2^{b-1} * xsum comes off the int32 dot at the close, exactly), the x
// codes B (s8). A thread's A register holds 4 consecutive k of one column:
// in the planar layout one bit slot of 4 consecutive low words. The fast
// path reads its 16 words of a block per step from shared memory (rows
// 4*t4 + e and 16 + 4*t4 + e of its two columns, LDS.64), byte-transposes
// each quad (PRMT: register q holds byte q of the four words; a step of a
// window cut in H forms only the registers its slots use) and then gets
// every slot's A register with one shift and one mask (two more and an or
// for a high plane). B fragments come by ldmatrix from the staged x codes.
//
// Loads in flight: two x slots (a step each) and a word slot (a window)
// filled by 16-byte cp.async, zero past m rows and past K. Step s + 1's x
// codes, and where s ends a window the next window's words, are in flight
// while step s is multiplied: the fast path reads a window's words into
// registers at the top of each of its steps, so the next window's can
// refill the one slot once every thread has (the generic path, which
// reads its words from shared memory throughout, has two word slots).
// Three CTAs fit on an SM at W6 g128 and m <= 32.
//
// xsum: once per step, from the staged x codes: each (k32 block, token)
// sums its 32 codes and adds them (a shared atomic) into the sum of its
// group's rank among the step's groups (at most kx of them), in one of two
// buffers (the other is zeroed for the next step meanwhile); a close reads
// its group's sums. Group closes: the
// slice's scales and off2 (rounded in bf16 at each step, so bf16-valued)
// are staged once per CTA as bf16 pairs, [group][column]; a close is, per
// element, an int32 dot minus 2^{b-1} * xsum, converted to f32, and two
// FMAs. A group is closed where its k32 blocks of a step end (each step
// closes its groups).
//
// Split-K: slices of whole pack tiles (kernels/quant_matmul.py::int_plan,
// which counts the CTAs an SM holds); the f32 partials are summed in slice
// order by splitk_sum.cuh, so two calls give the same bits. On an H100 SXM
// (700 W) the four W6 g128 7B products at m = 32 take ~0.15 ms in
// chip_smoke.py's timing, three times the byte bound (PERF.md).
constexpr int K7_BN = 64, K7_THREADS = 128, K7_MR_MAX = 128;
constexpr int K7_SMEM_MAX = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// d (+)= a . b: a 16 x 32 u8 (weight codes), b 32 x 8 s8 (x codes)
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of two n8 tiles (x4) or one (x2) of a k32 block
template <bool X2>
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  const uint32_t a = smem_u32(p);
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

// t[q] = byte q of w0, w1, w2, w3 (w0's in the low byte)
__device__ __forceinline__ void transpose4(uint32_t (&t)[4], uint32_t w0,
                                           uint32_t w1, uint32_t w2,
                                           uint32_t w3) {
  const uint32_t l01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t h01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t l23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t h23 = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(l01, l23, 0x5410);
  t[1] = __byte_perm(l01, l23, 0x7632);
  t[2] = __byte_perm(h01, h23, 0x5410);
  t[3] = __byte_perm(h01, h23, 0x7632);
}

// the low bytes of four words, w0's lowest
__device__ __forceinline__ uint32_t gather4(uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3) {
  return __byte_perm(__byte_perm(w0, w1, 0x0040), __byte_perm(w2, w3, 0x0040),
                     0x5410);
}

// A staged word row holds K7_BN columns as 16 chunks of 4; chunk c of row
// r sits at c ^ k7_swz(r), so the LDS.64 of rows 4*t4 + e (t4 = 0..3) and
// the thread's columns hit 32 distinct banks
__device__ __forceinline__ int k7_swz(int r) { return 2 * ((r >> 2) & 3); }
__device__ __forceinline__ int k7_word(int r, int col) {
  return r * K7_BN + (((col >> 2) ^ k7_swz(r)) << 2) + (col & 3);
}

template <int BITS>
struct K7Planes {
  using PL = Planar<BITS>;
  static constexpr int NSEL = PL::HI ? 2 : 1;  // low blocks
  static constexpr int NBLK = NSEL + (PL::HI ? 1 : 0);
  static constexpr int KW = PL::V * NSEL;      // k32 blocks of a window
  static constexpr uint32_t MLO = ((1u << PL::LO) - 1u) * 0x01010101u;
  static constexpr uint32_t MHI =
      PL::HI ? ((1u << PL::HI) - 1u) * 0x01010101u : 0u;
};

// MN: n8 tiles of token rows; FAST: windows of 32 low words (see above)
template <int BITS, int MN, bool FAST>
__global__ void __launch_bounds__(K7_THREADS)
qmm_int_planar_kernel(const int8_t* __restrict__ xc,
                      const float* __restrict__ xs,
                      const int32_t* __restrict__ qw,
                      const __nv_bfloat16* __restrict__ scales,
                      const __nv_bfloat16* __restrict__ zeros,
                      float* __restrict__ part, __nv_bfloat16* __restrict__ y,
                      int m, int K, int N, int G, int gs_rows, int T,
                      int n_tiles, int per, int kx_arg, int x_vec,
                      int word_slot, int x_slot) {
  using PL = Planar<BITS>;
  using S = K7Planes<BITS>;
  constexpr int LO = PL::LO, HI = PL::HI, NSEL = S::NSEL;
  constexpr int MR = 8 * MN, HALF = 1 << (BITS - 1);
  constexpr int H = MN <= 4 ? 1 : MN / 4;  // steps of a fast window
  constexpr int KXF = S::KW / H;           // k32 blocks of a fast step
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = T * LO / 32, B = P / NSEL, WPT = T * BITS / 32;
  const int kx = FAST ? KXF : kx_arg;  // equal on the fast path
  const int steps_per_win = FAST ? H : (T / 32) / kx;
  const int wins_per_tile = FAST ? B / 32 : 1;
  const int LDX = kx * 32 + 16;  // x stage row: 16 mod 128, ldmatrix-clean
  unsigned char* wbase = smem;
  unsigned char* xbase = smem + (FAST ? 1 : 2) * word_slot;
  // x-code sums, two buffers of [group of the step][token]
  int* segsum = reinterpret_cast<int*>(xbase + 2 * x_slot);
  // (scale, off2) bf16 pairs (off2 is bf16-valued), [group][column]
  uint32_t* scl = reinterpret_cast<uint32_t*>(segsum + 2 * kx * MR);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * K7_BN, cw = warp * 16;
  const int split = blockIdx.y, r0 = blockIdx.z * K7_MR_MAX;
  const int t_begin = split * per;
  const int t_end = min(t_begin + per, n_tiles);
  const int n_win = (t_end - t_begin) * wins_per_tile;
  const int n_steps = n_win * steps_per_win;
  const int g0 = t_begin * T / gs_rows;
  const int ng = (t_end * T - 1) / gs_rows - g0 + 1;

  const int rstride = FAST ? B : 32;  // rows from a k32 block to the next
  // a step's k32 block kb has the rank (lo + kb * rstride) / rdiv among the
  // step's groups, lo its first row's offset in its group (see xsum_pass)
  const int rdiv = max(gs_rows, rstride);
  const float inv_rdiv = 1.f / (float)rdiv;
  // first tile row (absolute) of step s's k32 blocks
  auto step_row = [&](int s) -> int {
    const int w = s / steps_per_win, sw = s - w * steps_per_win;
    const int wt = w / wins_per_tile;
    return (t_begin + wt) * T + 32 * (w - wt * wins_per_tile) * FAST +
           sw * kx * rstride;
  };
  // a window's words for the CTA's columns into word slot w & 1: the fast
  // path's NSEL blocks of 32 low words and the 32 high words (rows 32 b +
  // k of the slot), the generic path's whole tile
  auto load_words = [&](int w) {
    const int wt = w / wins_per_tile;
    const int w0 = 32 * (w - wt * wins_per_tile);
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(wbase + (FAST ? 0 : w & 1) * word_slot);
    const int32_t* src = qw + (size_t)(t_begin + wt) * WPT * N + col0;
    const int rows = FAST ? S::NBLK * 32 : WPT;
    for (int i = tid; i < rows * (K7_BN / 4); i += K7_THREADS) {
      const int r = i >> 4, c = (i & 15) << 2;
      int row = r;
      if (FAST) {
        const int b = r >> 5;
        row = (b < NSEL ? b * B : P) + w0 + (r & 31);
      }
      cp_async16(dst + k7_word(r, c), src + (size_t)row * N + c, 16);
    }
  };
  // step s's x codes: per token row, kx k32 blocks of 32 bytes
  auto load_x = [&](int s) {
    const int row0 = step_row(s);
    int8_t* dst = reinterpret_cast<int8_t*>(xbase + (s & 1) * x_slot);
    for (int i = tid; i < MR * kx * 2; i += K7_THREADS) {
      const int r = i / (kx * 2), rem = i - r * (kx * 2);
      const int k = row0 + (rem >> 1) * rstride + 16 * (rem & 1);
      const int tok = r0 + r;
      int8_t* d = dst + r * LDX + 16 * rem;
      if (x_vec) {
        const bool in = tok < m && k < K;
        cp_async16(d, in ? xc + (size_t)tok * K + k : xc, in ? 16 : 0);
      } else {
        __align__(16) int8_t tmp[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          tmp[e] = (tok < m && k + e < K) ? xc[(size_t)tok * K + k + e]
                                          : (int8_t)0;
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
      }
    }
  };
  // per token, the x-code sums of step s's groups: each (k32 block, token)
  // adds its 32 codes into the sum of its group's rank among the step's
  // groups (< kx), in sums buffer s & 1, which was zeroed during step s - 1.
  // Where blocks are closer than a group, the step's groups are consecutive
  // and the rank is the group relative to the step's first, (lo + kb *
  // rstride) / gs_rows; blocks a group or more apart (the fast path's B >=
  // gs_rows: W8 g64 at 512-row tiles, W4 g64 and W8 g128 at 1024) are each
  // a group of their own, rank kb = (lo + kb * B) / B as lo + 32 <= gs_rows.
  // Both are (lo + kb * rstride) / rdiv, without a branch (a branch here
  // slowed the W6 g128 products on the card)
  auto xsum_pass = [&](int s) {
    const int row0 = step_row(s);
    const int lo = row0 - row0 / gs_rows * gs_rows;  // offset in its group
    const int8_t* xsm =
        reinterpret_cast<const int8_t*>(xbase + (s & 1) * x_slot);
    int* sums = segsum + (s & 1) * kx * MR;
    for (int i = tid; i < kx * MR; i += K7_THREADS) {
      const int kb = i / MR, r = i - kb * MR;
      const int v = lo + kb * rstride;
      int gi = __float2int_rz(__int2float_rn(v) * inv_rdiv);
      gi += (gi + 1) * rdiv <= v;
      gi -= gi * rdiv > v;
      const uint4* q = reinterpret_cast<const uint4*>(xsm + r * LDX + 32 * kb);
      const uint4 u = q[0], t = q[1];
      int a = __dp4a((int)u.x, 0x01010101, 0);
      int c = __dp4a((int)t.x, 0x01010101, 0);
      a = __dp4a((int)u.y, 0x01010101, a);
      c = __dp4a((int)t.y, 0x01010101, c);
      a = __dp4a((int)u.z, 0x01010101, a);
      c = __dp4a((int)t.z, 0x01010101, c);
      a = __dp4a((int)u.w, 0x01010101, a);
      c = __dp4a((int)t.w, 0x01010101, c);
      atomicAdd(sums + gi * MR + r, a + c);
    }
  };
  // the top of step s: its copies have landed everywhere and every thread
  // is done with step s - 1; step s + 1's x codes (on the generic path also
  // the next window's words, where s + 1 starts one) go in flight
  auto ring_top = [&](int s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n_steps) {
      if (!FAST && (s + 1) % steps_per_win == 0)
        load_words((s + 1) / steps_per_win);
      load_x(s + 1);
    }
    cp_async_commit();
  };
  // step s's code sums (the other buffer zeroed for step s + 1), then a
  // barrier; by then every thread of the fast path has read its window's
  // words into registers, so where s ends a window the next window's words
  // go into the one word slot
  auto ring_sums = [&](int s) {
    xsum_pass(s);
    int* next_sums = segsum + ((s + 1) & 1) * kx * MR;
    for (int i = tid; i < kx * MR; i += K7_THREADS) next_sums[i] = 0;
    __syncthreads();
    if (FAST && s + 1 < n_steps && (s + 1) % steps_per_win == 0) {
      load_words((s + 1) / steps_per_win);
      cp_async_commit();
    }
  };

  load_words(0);
  load_x(0);
  cp_async_commit();
  for (int i = tid; i < kx * MR; i += K7_THREADS) segsum[i] = 0;
  // the slice's scales and off2 = (2^{b-1} - z) * s, each step rounded to
  // bf16, [group][column]; groups past G (layout padding) reuse the last
  {
    constexpr int BATCH = 8;
    for (int i0 = 0; i0 < ng * K7_BN; i0 += BATCH * K7_THREADS) {
      __nv_bfloat16 sv[BATCH], zv[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * K7_THREADS + tid;
        if (i < ng * K7_BN) {
          const int c = i / ng, gi = i - c * ng;
          const size_t at = (size_t)(col0 + c) * G + min(g0 + gi, G - 1);
          sv[u] = scales[at];
          zv[u] = zeros[at];
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * K7_THREADS + tid;
        if (i < ng * K7_BN) {
          const int c = i / ng, gi = i - c * ng;
          const float o = off2_bf16(__bfloat162float(sv[u]),
                                    __bfloat162float(zv[u]), (float)HALF);
          __nv_bfloat162 v;
          v.x = sv[u];
          v.y = __float2bfloat16_rn(o);  // exact: o is bf16-valued
          scl[gi * K7_BN + c] = *reinterpret_cast<uint32_t*>(&v);
        }
      }
    }
  }

  int acc[MN][4];
  float accf[MN][4];
#pragma unroll
  for (int nt = 0; nt < MN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0, accf[nt][e] = 0.f;

  // group grp's k32 blocks of step s end (its sums at rank gi of buffer
  // s & 1; the step's closes come in rank order): D
  // rows are the thread's columns cw + 2g (e = 0, 1) and + 1 (e = 2, 3), D
  // columns its tokens 2 t4 (e even) and 2 t4 + 1
  auto close = [&](int s, int gi, int grp) {
    const uint2 sv =
        *reinterpret_cast<const uint2*>(scl + (grp - g0) * K7_BN + cw + 2 * g);
    const float4 sc = make_float4(
        __uint_as_float(sv.x << 16), __uint_as_float(sv.x & 0xffff0000u),
        __uint_as_float(sv.y << 16), __uint_as_float(sv.y & 0xffff0000u));
    const int* sums = segsum + ((s & 1) * kx + gi) * MR;
#pragma unroll
    for (int nt = 0; nt < MN; ++nt) {
      const int2 xv = *reinterpret_cast<const int2*>(sums + nt * 8 + 2 * t4);
      const float xa = (float)xv.x, xb = (float)xv.y;
      float(&f)[4] = accf[nt];
      int(&d)[4] = acc[nt];
      f[0] = fmaf((float)(d[0] - HALF * xv.x), sc.x, fmaf(xa, sc.y, f[0]));
      f[1] = fmaf((float)(d[1] - HALF * xv.y), sc.x, fmaf(xb, sc.y, f[1]));
      f[2] = fmaf((float)(d[2] - HALF * xv.x), sc.z, fmaf(xa, sc.w, f[2]));
      f[3] = fmaf((float)(d[3] - HALF * xv.y), sc.z, fmaf(xb, sc.w, f[3]));
      d[0] = d[1] = d[2] = d[3] = 0;
    }
  };
  // the MMAs of k32 block kb of the step (x stage xsm) on A registers a
  const int lm_tok = ((lane >> 4) << 3) + (lane & 7);
  const int lm_off = ((lane >> 3) & 1) << 4;
  auto mma_block = [&](const uint32_t (&a)[4], const int8_t* xsm, int kb) {
#pragma unroll
    for (int nt = 0; nt < MN; nt += 2) {
      uint32_t b[4];
      ldsm<MN == 1>(b, xsm + (nt * 8 + lm_tok) * LDX + 32 * kb + lm_off);
      mma_u8s8(acc[nt], a, b[0], b[1]);
      if constexpr (MN > 1) mma_u8s8(acc[nt + 1], a, b[2], b[3]);
    }
  };

  if constexpr (FAST) {
    for (int w = 0; w < n_win; ++w) {
#pragma unroll
      for (int sw = 0; sw < H; ++sw) {
        const int s = w * H + sw;
        // tl[b][c][h][q]: byte q of the four low words of block b, column
        // c (cw + 2g + c), rows 16 h + 4 t4 .. + 3 of the window; th
        // likewise for the high plane
        uint32_t tl[NSEL][2][2][4], th[2][2][4];
        ring_top(s);
        {
          // every step reads its window's words again: a step of a window
          // cut in H steps uses 1/H of each register's bytes, so the
          // others are never formed and their registers stay free
          const uint32_t* wsm = reinterpret_cast<const uint32_t*>(wbase);
#pragma unroll
          for (int b = 0; b < S::NBLK; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t vx[4], vy[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = 32 * b + 16 * h + 4 * t4 + e;
                const uint2 v = *reinterpret_cast<const uint2*>(
                    wsm + k7_word(r, cw + 2 * g));
                vx[e] = v.x;
                vy[e] = v.y;
              }
              if (b < NSEL) {
                transpose4(tl[b < NSEL ? b : 0][0][h], vx[0], vx[1], vx[2],
                           vx[3]);
                transpose4(tl[b < NSEL ? b : 0][1][h], vy[0], vy[1], vy[2],
                           vy[3]);
              } else {
                transpose4(th[0][h], vx[0], vx[1], vx[2], vx[3]);
                transpose4(th[1][h], vy[0], vy[1], vy[2], vy[3]);
              }
            }
        }
        ring_sums(s);
        const int8_t* xsm =
            reinterpret_cast<const int8_t*>(xbase + (s & 1) * x_slot);
        int row = step_row(s);
        int grp = row / gs_rows, g_hi = (grp + 1) * gs_rows, rank = 0;
#pragma unroll
        for (int i = 0; i < KXF; ++i) {
          const int f = sw * KXF + i, p = f / NSEL, b = f % NSEL;
          const int q = LO * p / 8, sh = LO * p % 8;
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // a0 a1 a2 a3: (column, half)
            uint32_t c = tl[b][r & 1][r >> 1][q];
            if constexpr (LO < 8) c = (c >> sh) & S::MLO;
            if constexpr (HI > 0) {
              const int fh = 2 * p + b, qh = HI * fh / 8, shh = HI * fh % 8;
              c |= ((th[r & 1][r >> 1][qh] >> shh) & S::MHI) << LO;
            }
            a[r] = c;
          }
          mma_block(a, xsm, i);
          const int next = row + B;
          if (i == KXF - 1 || next >= g_hi) {
            close(s, rank++, grp);
            for (; next >= g_hi; g_hi += gs_rows) ++grp;
          }
          row = next;
        }
      }
    }
  } else {
    for (int w = 0; w < n_win; ++w) {
      const uint32_t* wsm =
          reinterpret_cast<const uint32_t*>(wbase + (w & 1) * word_slot);
      for (int sw = 0; sw < steps_per_win; ++sw) {
        const int s = w * steps_per_win + sw;
        ring_top(s);
        ring_sums(s);
        const int8_t* xsm =
            reinterpret_cast<const int8_t*>(xbase + (s & 1) * x_slot);
        int row = step_row(s);
        int grp = row / gs_rows, g_hi = (grp + 1) * gs_rows, rank = 0;
        for (int i = 0; i < kx; ++i) {
          const int kb = sw * kx + i;
          uint32_t a[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // the quad at tile rows 32 kb + 16 h + 4 t4 ..: run f (slot p
            // of block b), words j4 .. j4 + 3 of the block
            const int rr = 32 * kb + 16 * h + 4 * t4;
            const int f = rr / B, j4 = rr - f * B;
            const int p = f / NSEL, b = f - p * NSEL;
            uint32_t lx[4], ly[4], hx[4] = {0, 0, 0, 0}, hy[4] = {0, 0, 0, 0};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = b * B + j4 + e;
              const uint2 v = *reinterpret_cast<const uint2*>(
                  wsm + k7_word(r, cw + 2 * g));
              lx[e] = v.x >> (LO * p);
              ly[e] = v.y >> (LO * p);
              if constexpr (HI > 0) {
                const int rh = P + j4 + e;
                const uint2 u = *reinterpret_cast<const uint2*>(
                    wsm + k7_word(rh, cw + 2 * g));
                hx[e] = u.x >> (HI * (2 * p + b));
                hy[e] = u.y >> (HI * (2 * p + b));
              }
            }
            uint32_t cx = gather4(lx[0], lx[1], lx[2], lx[3]) & S::MLO;
            uint32_t cy = gather4(ly[0], ly[1], ly[2], ly[3]) & S::MLO;
            if constexpr (HI > 0) {
              cx |= (gather4(hx[0], hx[1], hx[2], hx[3]) & S::MHI) << LO;
              cy |= (gather4(hy[0], hy[1], hy[2], hy[3]) & S::MHI) << LO;
            }
            a[2 * h] = cx;
            a[2 * h + 1] = cy;
          }
          mma_block(a, xsm, i);
          const int next = row + 32;
          if (i == kx - 1 || next >= g_hi) {
            close(s, rank++, grp);
            for (; next >= g_hi; g_hi += gs_rows) ++grp;
          }
          row = next;
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < MN; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tok = r0 + nt * 8 + 2 * t4 + e;
      if (tok >= m) continue;
      const int col = col0 + cw + 2 * g;
      const float v0 = accf[nt][e], v1 = accf[nt][e + 2];
      if (gridDim.y == 1) {
        const float s = xs[tok];
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)tok * N + col]) =
            __floats2bfloat162_rn(v0 * s, v1 * s);
      } else {
        *reinterpret_cast<float2*>(
            &part[((size_t)split * m + tok) * N + col]) = make_float2(v0, v1);
      }
    }
}

// K7's tile geometry is chosen by kernels/quant_matmul.py::_k7_geometry
// (its one copy). This refuses a tile the kernel does not take, or a
// geometry whose slots and shared memory do not hold what the kernel
// touches.
bool k7_fits(int bits, int m, int T, int k_pad, int gs_rows, int per, int mn,
             int fast, int kx, int word_slot, int x_slot, int smem) {
  const int lo = bits == 3 ? 2 : (bits == 6 ? 4 : bits), hi = bits - lo;
  const int nsel = hi ? 2 : 1;
  const int P = T * lo / 32, B = P / nsel, mr = 8 * mn;
  if (m < 1 || T % 32 || T > 1024 || k_pad % T || P % 4 || (hi && B % 4) ||
      per < 1 || mr < (m < K7_MR_MAX ? m : K7_MR_MAX) || kx < 1)
    return false;
  if (gs_rows != k_pad && (gs_rows % 64 || T % gs_rows)) return false;
  const int h = mn <= 4 ? 1 : mn / 4;
  if (fast ? B % 32 || kx != (32 / lo) * nsel / h : (T / 32) % kx)
    return false;
  const int words = (fast ? (nsel + (hi ? 1 : 0)) * 32 : T * bits / 32);
  const int ng = gs_rows == k_pad ? 1 : per * T / gs_rows;
  return (word_slot | x_slot) % 16 == 0 && word_slot >= words * K7_BN * 4 &&
         x_slot >= mr * (32 * kx + 16) &&
         smem >= (fast ? 1 : 2) * word_slot + 2 * x_slot + 2 * kx * mr * 4 +
                     ng * K7_BN * 4 &&
         smem <= K7_SMEM_MAX;
}

using K7Kernel = void (*)(const int8_t*, const float*, const int32_t*,
                          const __nv_bfloat16*, const __nv_bfloat16*, float*,
                          __nv_bfloat16*, int, int, int, int, int, int, int,
                          int, int, int, int, int);

template <int BITS, bool FAST>
K7Kernel k7_kernel_mn(int mn) {
  switch (mn) {
    case 1: return qmm_int_planar_kernel<BITS, 1, FAST>;
    case 2: return qmm_int_planar_kernel<BITS, 2, FAST>;
    case 4: return qmm_int_planar_kernel<BITS, 4, FAST>;
    case 8: return qmm_int_planar_kernel<BITS, 8, FAST>;
    case 16: return qmm_int_planar_kernel<BITS, 16, FAST>;
  }
  return nullptr;
}

template <int BITS>
K7Kernel k7_kernel_bits(int mn, bool fast) {
  return fast ? k7_kernel_mn<BITS, true>(mn) : k7_kernel_mn<BITS, false>(mn);
}

// the instance for (bits, mn, fast), or nullptr
K7Kernel k7_kernel(int bits, int mn, bool fast) {
  switch (bits) {
    case 2: return k7_kernel_bits<2>(mn, fast);
    case 3: return k7_kernel_bits<3>(mn, fast);
    case 4: return k7_kernel_bits<4>(mn, fast);
    case 6: return k7_kernel_bits<6>(mn, fast);
    case 8: return k7_kernel_bits<8>(mn, fast);
  }
  return nullptr;
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
// splits > 1 (else unused); N % 64 == 0; tile_k a multiple of 32, at most
// 1024, with whole word quads in each plane; gs_rows a multiple of 64
// dividing tile_k, or k_pad for per-channel scales (G == 1); slice s takes
// pack tiles [s*per, min((s+1)*per, n_tiles)); mn .. smem the tile's
// geometry (kernels/quant_matmul.py::int_plan). Any m: row blocks of 128
// rows past 128.
extern "C" int qmm_int_planar(const void* xc, const void* xs, const void* qw,
                              const void* scales, const void* zeros,
                              void* part, void* y, int m, int K, int N,
                              int k_pad, int G, int gs_rows, int tile_k,
                              int bits, int splits, int per, int mn, int fast,
                              int kx, int word_slot, int x_slot, int smem,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = k_pad / tile_k;
  const K7Kernel kern = k7_kernel(bits, mn, fast != 0);
  if (kern == nullptr || N % K7_BN ||
      !k7_fits(bits, m, tile_k, k_pad, gs_rows, per, mn, fast, kx, word_slot,
               x_slot, smem) ||
      splits < 1 || (splits - 1) * per >= n_tiles ||
      splits * per < n_tiles || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // the largest dynamic shared memory each instance was allowed so far
  static int smem_set[9][17][2];
  int& allowed = smem_set[bits][mn][fast != 0];
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const int x_vec = (K % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(xc) % 16 == 0);
  dim3 grid(N / K7_BN, splits, (m + K7_MR_MAX - 1) / K7_MR_MAX);
  kern<<<grid, K7_THREADS, smem, st>>>(
      static_cast<const int8_t*>(xc), static_cast<const float*>(xs),
      static_cast<const int32_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(y), m, K, N, G, gs_rows, tile_k, n_tiles,
      per, kx, x_vec, word_slot, x_slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(part),
                    static_cast<const float*>(xs),
                    static_cast<__nv_bfloat16*>(y), m, N, splits, st);
}

// The CTAs of K7's (bits, mn, fast) instance that an SM holds by its
// registers and threads alone (int_plan bounds them by shared memory
// itself), or a negative CUDA error.
extern "C" int qmm_int_planar_ctas(int bits, int mn, int fast, void*) {
  const K7Kernel kern = k7_kernel(bits, mn, fast != 0);
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kern, K7_THREADS, 0);
  return err == cudaSuccess ? n : -(int)err;
}
