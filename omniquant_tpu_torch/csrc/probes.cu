// Hopper probes: the four Pallas kernels of the JAX package's experiment
// scripts, ported as kernels of their own for sm_90a. None of them is on a
// serving or calibration path; each answers, on the H100, the question its
// script answered on the TPU. Wrappers, plain versions and the shapes they
// take: kernels/probes.py; drivers: omniquant_tpu_torch/scripts/.
//
// S4 consume (scripts/exp_ablate_int.py::_consume_kernel, pallas_call :66):
//   out = sum over k tiles j of BK rows and groups g of gs = BK / n_dots
//   rows: (xc_jg . w8_jg) * sc[j, g], int8 x int8 -> s32 dots, f32 sum, bf16
//   out. Bound by the int8 tensor cores at its shape (2 M K N operations at
//   M = K = N = 4096). mma.sync m16n8k32 s8 into s32 per group; a group's
//   close converts the s32 sums and scales them into f32 (n_dots 4: four
//   closes per 512 rows; n_dots 1: one), so the pair of times is the cost
//   of the closes. A CTA takes 128 x 128 outputs (8 warps of 64 x 32), K in
//   chunks of 128 rows through two shared-memory stages: x codes by
//   16-byte cp.async, w8 (K-major in device memory: (K, N)) read as 4 rows x
//   16 columns a thread into registers one chunk ahead and transposed 4 x 4
//   bytes at a time (prmt) into [n][k] rows, so both operands' fragments are
//   4-byte shared loads (rows of 144 bytes; B's k words XOR-swizzled by the
//   column's 16-column block, so the transposing stores and the fragment
//   loads hit 32 banks).
//
// S2 mxu_rate (scripts/exp_mxu_rates.py::kern_bf16 / kern_i8, pallas_call
//   :48): out = sum of INNER products x . w of 512 x 512 x 512 operands,
//   bf16 -> f32 or s8 -> s32 -> f32, the whole repeated by a grid of 64. A
//   probe of the tensor cores' rate under mma.sync: the operands of a CTA's
//   64 x 128 outputs are staged once into shared memory (bf16 w as [k][n],
//   read by ldmatrix.trans; int8 w transposed to [n][k] at staging); each
//   warp (8 of 32 x 32) reads a chunk of four k steps' fragments into
//   registers once and issues the INNER products' MMAs on that chunk from
//   them (mma.sync m16n8k16 bf16 or m16n8k32 s8). The script's products all
//   take the same operands, so reading them once a chunk instead of once a
//   product leaves the MMAs as they were and takes the fragment reads out
//   of the loop: read once a product (2 KB of ldmatrix per 8 MMAs, as a
//   32 x 32 warp tile needs), they held both types at the shared memory's
//   128 bytes a cycle, half the dense peak, whatever the tensor cores could
//   do. Each bf16 product's chunk sums in a fresh f32 accumulator that is
//   then added to the output's, as the script's acc += dot adds f32 dots
//   (chunk by chunk, not dot by dot); the int8 products sum exactly in s32,
//   the even and the odd products into two sets of sums, so that a warp has
//   as many MMA chains in flight (16) as the bf16 kernel, whose products
//   each start a fresh accumulator. Both kernels take the same shared
//   memory and one CTA of 8 warps per SM.
//   A CTA runs 4 of the 64 repeats (staging once), each writing the same
//   output, as the grid's steps do.
//
// S3 f32inj (scripts/exp_unpack_variants.py::_kernel_f32inj, pallas_call
//   :114): the mantissa-injection decode product. A planar code c of b bits
//   becomes the f32 1 + c/2^b by ((u >> s) & mask) << (23 - b) | 1.0f's
//   bits, with no int-to-float conversion; the 2^b and the -1 fold into the
//   scale slabs sc2 = sc * 2^b and off2 = -z*sc - sc2, applied per group
//   with xsum_g . off2_g. The injected floats carry at most 8 mantissa
//   bits and bf16 x is exact in TF32, so they go as they are into the TF32
//   tensor cores (mma.sync m16n8k8 tf32, exact products, f32 sums): the
//   script's f32 dots, with neither a CUDA-core FMA per code (6x the byte
//   bound at M = 32) nor an f16 x (whose range a chain of 64 products would
//   leave). Bound by the bytes of the words at M = 32 (W4 4096 x 4096: 8 MB).
//   A CTA takes 128 output columns (8 warps of 16) and one pack tile of 512
//   rows (the grid's y), every row of x up to 32 (the n8 operand: outputs
//   are computed transposed, the 16 columns the A operand); the tile's x
//   columns go to shared memory by cp.async, the thread's words of the tile
//   straight into registers (P/2 of them, P words per column per tile), and
//   the loop runs bit slot by bit slot, so each quant group's run of rows
//   closes once into the f32 sums (groups of 128 rows: T / 128 per tile).
//   Each tile writes f32 partial sums to a (tiles, M, N) workspace that
//   splitk_sum.cuh adds in tile order.
//
// S1 ablate (scripts/exp_ablate_kernel.py::_kernel, pallas_call :98): K1's
//   planar decode product without zero points, y = sum_g (x_g . c_g) *
//   sc_g, on K1's planar decode tile (quant_matmul.cu's
//   qmm_planar_decode_kernel, from the pieces in decode_tile.cuh) for
//   one-plane words (W2, W4) at m <= 32: steps of 32 words a column staged
//   by 16-byte cp.async into a two-stage ring, each sub-step's x columns
//   staged beside them (XOR-swizzled for ldmatrix), a thread's fragment
//   registers read from the staged words by one prmt each (planar_words),
//   codes turned into bf16 pairs by a shift, a mask and a bf16x2 subtract
//   (planar_bf16x2), mma.sync m16n8k16 with x as the n8 operand, a close
//   per quant group, K1's split-K plan (kernels/quant_matmul.py::
//   planar_decode_plan, with this kernel's occupancy) and the slices summed
//   in the launch by the last one to take a column block's ticket. What K1
//   does and S1 does not: the zero points (the ones-row MMA for xsum, the
//   second FMA of each close, staging zeros); S1's scales are the script's
//   f32 slabs, staged per pack tile as K1 stages its bf16 planes. MODE is a
//   template argument. FULL: as above. NOUP: the same MMAs and x reads on
//   A fragments broadcast from x row 0 (w[k][n] = x[0][tile + n mod bn],
//   read per step); the words are staged but neither read nor unpacked.
//   NODOT: the same word reads and conversions, summed by a bf16x2 add in
//   place of the x fragment reads, the MMAs and the closes; the tile's first
//   32 rows of codes are added into the output (the script's sum, times 0,
//   keeps the other codes' work). FULL minus NOUP is what the unpack costs
//   on K1's tile, FULL minus NODOT what the products cost there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "planar.cuh"
#include "splitk_sum.cuh"

namespace {

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8 x 8 b16 tiles, each transposed (rows from the lanes' addresses):
// S2's bf16 B operand from w staged as [k][n]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// d += a . b: a 16 x 32 s8, b 32 x 8 s8, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b: a 16 x 8 tf32, b 8 x 8 tf32 (f32 bit patterns), f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 x 4 bytes transposed: r[i] holds row i's bytes (columns 0..3); c[j]
// gets column j's bytes (rows 0..3)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// a dynamic shared-memory size above 48 KB, set once per kernel instance
template <typename K>
int allow_smem(K kernel, int bytes, int& done) {
  if (bytes > 48 * 1024 && bytes > done) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done = bytes;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// S4
constexpr int CS_BM = 128, CS_BN = 128, CS_KC = 128, CS_THREADS = 256;
constexpr int CS_LD = CS_KC + 16;  // bytes a staged row: 36 words
constexpr int CS_STAGE = (CS_BM + CS_BN) * CS_LD;
constexpr int CS_SMEM = 2 * CS_STAGE;

// GS32: the group's rows in k32 steps (gs = BK / n_dots)
template <int GS32>
__global__ void __launch_bounds__(CS_THREADS, 1)
consume_kernel(const int8_t* __restrict__ xc, const int8_t* __restrict__ w8,
               const float* __restrict__ sc, __nv_bfloat16* __restrict__ out,
               int M, int N, int K, int BK) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * CS_BM, n0 = blockIdx.x * CS_BN;
  const int nc = K / CS_KC, gs = GS32 * 32;

  // this thread's share of a w8 chunk: rows 4*kw .. +3, 16 columns at
  // 16*nb (a warp: 4 rows x 128 contiguous bytes a load)
  const int b_nb = tid & 7, b_kw = 4 * (tid >> 5) + ((tid >> 3) & 3);
  uint4 breg[4];
  auto load_b = [&](int c) {
    const int8_t* src =
        w8 + (size_t)(c * CS_KC + 4 * b_kw) * N + n0 + 16 * b_nb;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      breg[r] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * N));
  };
  // the registers as [n][k] words: column n's word kw at kw ^ (4 * (n/16))
  auto store_b = [&](int stage) {
    unsigned char* bs = smem + stage * CS_STAGE + CS_BM * CS_LD;
    const int kwp = b_kw ^ (4 * b_nb);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r[4] = {(&breg[0].x)[q], (&breg[1].x)[q],
                             (&breg[2].x)[q], (&breg[3].x)[q]};
      uint32_t c[4];
      transpose4x4(r, c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(bs + (16 * b_nb + 4 * q + j) * CS_LD +
                                     4 * kwp) = c[j];
    }
  };
  auto load_a = [&](int c, int stage) {
    unsigned char* as = smem + stage * CS_STAGE;
#pragma unroll
    for (int r = 0; r < CS_BM * (CS_KC / 16) / CS_THREADS; ++r) {
      const int i = tid + r * CS_THREADS, row = i >> 3, c16 = i & 7;
      const bool in = m0 + row < M;
      const int8_t* src =
          in ? xc + (size_t)(m0 + row) * K + c * CS_KC + c16 * 16 : xc;
      cp_async16(as + row * CS_LD + c16 * 16, src, in ? 16 : 0);
    }
  };

  int acc_i[4][4][4];
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_i[mt][nt][e] = 0;
        acc[mt][nt][e] = 0.f;
      }

  // a group ends at row kend: its s32 sums into f32, times sc[tile, group]
  auto close = [&](int kend) {
    const int kl = kend - 1;
    const float* srow = sc + ((size_t)(kl / BK) * 8 + (kl % BK) / gs) * N +
                        n0 + wn * 32 + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float s0 = __ldg(srow + nt * 8), s1 = __ldg(srow + nt * 8 + 1);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][nt][0] = fmaf((float)acc_i[mt][nt][0], s0, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf((float)acc_i[mt][nt][1], s1, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf((float)acc_i[mt][nt][2], s0, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf((float)acc_i[mt][nt][3], s1, acc[mt][nt][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_i[mt][nt][e] = 0;
      }
    }
  };

  load_a(0, 0);
  cp_async_commit();
  load_b(0);
  store_b(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      load_a(c + 1, (c + 1) & 1);
      load_b(c + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c's x codes landed, its w8 stored
    const unsigned char* as =
        smem + (c & 1) * CS_STAGE + (wm * 64 + g) * CS_LD + 4 * t4;
    const unsigned char* bs = smem + (c & 1) * CS_STAGE + CS_BM * CS_LD;
#pragma unroll
    for (int s = 0; s < CS_KC / 32; ++s) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* p = as + mt * 16 * CS_LD + 32 * s;
        a[mt][0] = lds32(p);
        a[mt][1] = lds32(p + 8 * CS_LD);
        a[mt][2] = lds32(p + 16);
        a[mt][3] = lds32(p + 8 * CS_LD + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g, swz = 4 * ((n >> 4) & 7);
        const unsigned char* q = bs + n * CS_LD;
        b[nt][0] = lds32(q + 4 * ((8 * s + t4) ^ swz));
        b[nt][1] = lds32(q + 4 * ((8 * s + 4 + t4) ^ swz));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc_i[mt][nt], a[mt], b[nt][0], b[nt][1]);
      if ((c * (CS_KC / 32) + s + 1) % GS32 == 0)
        close(c * CS_KC + (s + 1) * 32);
    }
    if (c + 1 < nc) store_b((c + 1) & 1);  // the other stage: free
    __syncthreads();  // chunk c's stage is free for chunk c + 2
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)row * N + n0 + wn * 32 + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

template <int GS32>
int consume_launch(const int8_t* xc, const int8_t* w8, const float* sc,
                   __nv_bfloat16* out, int M, int N, int K, int BK,
                   cudaStream_t st) {
  static int smem_done = 0;
  const int err = allow_smem(consume_kernel<GS32>, CS_SMEM, smem_done);
  if (err) return err;
  const dim3 grid(N / CS_BN, (M + CS_BM - 1) / CS_BM);
  consume_kernel<GS32><<<grid, CS_THREADS, CS_SMEM, st>>>(xc, w8, sc, out, M,
                                                          N, K, BK);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S2
constexpr int MX_BM = 64, MX_BN = 128, MX_K = 512, MX_THREADS = 256;
constexpr int MX_REPS = 4;  // repeats a CTA runs on one staging
constexpr int MX_KC = 4;    // k steps a chunk of fragments in registers
constexpr int MX_LDA_BF16 = MX_K * 2 + 16;   // bytes: x rows [m][k]
constexpr int MX_LDB_BF16 = MX_BN * 2 + 16;  // w rows [k][n]
constexpr int MX_LD_I8 = MX_K + 16;          // x [m][k], w [n][k]
constexpr int MX_SMEM_BF16 = MX_BM * MX_LDA_BF16 + MX_K * MX_LDB_BF16;
constexpr int MX_SMEM_I8 = (MX_BM + MX_BN) * MX_LD_I8;
// both instances take the bf16 one's shared memory: one CTA per SM each
constexpr int MX_SMEM = MX_SMEM_BF16;
static_assert(MX_SMEM >= MX_SMEM_I8, "int8 staging fits the bf16 size");

template <bool INT8>
__global__ void __launch_bounds__(MX_THREADS, 1)
mxu_rate_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                float* __restrict__ out, int M, int N, int inner, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int m0 = blockIdx.y * MX_BM, n0 = blockIdx.x * MX_BN;
  constexpr int ESZ = INT8 ? 1 : 2;
  constexpr int LDA = INT8 ? MX_LD_I8 : MX_LDA_BF16;
  unsigned char* as = smem;
  unsigned char* bs = smem + MX_BM * LDA;
  const unsigned char* x = static_cast<const unsigned char*>(xv);
  const unsigned char* w = static_cast<const unsigned char*>(wv);

  // staging, once: x rows as they are; w as [k][n] (bf16) or transposed 4 x
  // 4 bytes at a time into [n][k] (int8)
  for (int i = tid; i < MX_BM * MX_K * ESZ / 16; i += MX_THREADS) {
    const int row = i / (MX_K * ESZ / 16), c16 = i % (MX_K * ESZ / 16);
    *reinterpret_cast<uint4*>(as + row * LDA + c16 * 16) =
        __ldg(reinterpret_cast<const uint4*>(
            x + ((size_t)(m0 + row) * MX_K) * ESZ + c16 * 16));
  }
  if constexpr (!INT8) {
    for (int i = tid; i < MX_K * MX_BN * 2 / 16; i += MX_THREADS) {
      const int k = i / (MX_BN * 2 / 16), c16 = i % (MX_BN * 2 / 16);
      *reinterpret_cast<uint4*>(bs + k * MX_LDB_BF16 + c16 * 16) =
          __ldg(reinterpret_cast<const uint4*>(
              w + ((size_t)k * N + n0) * 2 + c16 * 16));
    }
  } else {
    // a thread: rows 4*kw .. +3 and 16 columns at 16*nb
    for (int i = tid; i < (MX_K / 4) * (MX_BN / 16); i += MX_THREADS) {
      const int nb = i % (MX_BN / 16), kw = i / (MX_BN / 16);
      uint4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(4 * kw + r) * N + n0 + 16 * nb));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t r4[4] = {(&v[0].x)[q], (&v[1].x)[q], (&v[2].x)[q],
                                (&v[3].x)[q]};
        uint32_t c[4];
        transpose4x4(r4, c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(bs + (16 * nb + 4 * q + j) * MX_LD_I8 +
                                       4 * kw) = c[j];
      }
    }
  }
  __syncthreads();

  // ldmatrix lane addresses. A: row (lane & 15) of the m16 tile, k half
  // lane >> 4 (8 bf16 or 16 int8). B bf16 (.trans on [k][n]): k row (lane &
  // 7) + 8 * ((lane >> 3) & 1), n tile lane >> 4. B int8 ([n][k]): n row
  // (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1.
  const unsigned char* a_base =
      as + (wm * 32 + (lane & 15)) * LDA + (lane >> 4) * 16;
  const unsigned char* b_base =
      INT8 ? bs + (wn * 32 + (lane & 7) + 8 * (lane >> 4)) * MX_LD_I8 +
                 ((lane >> 3) & 1) * 16
           : bs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * MX_LDB_BF16 +
                 (wn * 32 + 8 * (lane >> 4)) * 2;
  // one k step: 16 (bf16) or 32 (int8) k; a chunk: MX_KC k steps whose
  // fragments every product of the repeat takes from registers
  constexpr int KSTEPS = INT8 ? MX_K / 32 : MX_K / 16;
  static_assert(KSTEPS % MX_KC == 0, "whole chunks");

  for (int rep = 0; rep < reps; ++rep) {
    // int8: two sets of s32 sums, the even products' and the odd ones',
    // so that a warp has 16 MMA chains in flight, as the bf16 kernel has
    // with its fresh accumulator a product
    float acc[2][4][4];
    int acc_i[2][2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] = 0.f;
          acc_i[0][mt][nt][e] = acc_i[1][mt][nt][e] = 0;
        }
#pragma unroll 1
    for (int c = 0; c < KSTEPS / MX_KC; ++c) {
      uint32_t a[MX_KC][2][4], b[MX_KC][4][2];
#pragma unroll
      for (int kk = 0; kk < MX_KC; ++kk) {
        const int ks = c * MX_KC + kk;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x<false>(a[kk][mt], a_base + mt * 16 * LDA + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          if constexpr (INT8)
            ldmatrix_x<false>(r, b_base + np * 16 * MX_LD_I8 + ks * 32);
          else
            ldmatrix_x4_trans(r, b_base + ks * 16 * MX_LDB_BF16 + np * 32);
          b[kk][2 * np][0] = r[0];
          b[kk][2 * np][1] = r[1];
          b[kk][2 * np + 1][0] = r[2];
          b[kk][2 * np + 1][1] = r[3];
        }
      }
      // product it's MMAs on the chunk into the s32 sums of set par
      auto products_i8 = [&](int par) {
#pragma unroll
        for (int kk = 0; kk < MX_KC; ++kk)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_s8(acc_i[par][mt][nt], a[kk][mt], b[kk][nt][0],
                     b[kk][nt][1]);
      };
      if constexpr (INT8) {
#pragma unroll 1
        for (int it = 0; it + 1 < inner; it += 2) {
          products_i8(0);
          products_i8(1);
        }
        if (inner & 1) products_i8(0);
      } else {
#pragma unroll 2
        for (int it = 0; it < inner; ++it) {
          // product it's chunk in a fresh accumulator, then into the sum
          float d[2][4][4];
#pragma unroll
          for (int kk = 0; kk < MX_KC; ++kk)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_16816_or_first(d[mt][nt], a[kk][mt], b[kk][nt][0],
                                   b[kk][nt][1], kk == 0);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[mt][nt][e];
        }
      }
    }
    // every repeat writes the same sums, as each step of the script's grid
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
          float2 v;
          if constexpr (INT8)
            v = make_float2(
                (float)(acc_i[0][mt][nt][2 * h] + acc_i[1][mt][nt][2 * h]),
                (float)(acc_i[0][mt][nt][2 * h + 1] +
                        acc_i[1][mt][nt][2 * h + 1]));
          else
            v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) = v;
        }
      }
  }
}

template <bool INT8>
int mxu_rate_launch(const void* x, const void* w, float* out, int M, int N,
                    int inner, int repeats, cudaStream_t st) {
  static int smem_done = 0;
  const int err = allow_smem(mxu_rate_kernel<INT8>, MX_SMEM, smem_done);
  if (err) return err;
  const dim3 grid(N / MX_BN, M / MX_BM, repeats / MX_REPS);
  mxu_rate_kernel<INT8><<<grid, MX_THREADS, MX_SMEM, st>>>(x, w, out, M, N,
                                                           inner, MX_REPS);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S3's decode skeleton (see the note at the top of the file)
constexpr int DK_T = 512;   // rows a pack tile
constexpr int DK_GS = 128;  // rows a quant group
constexpr int DK_BN = 128, DK_THREADS = 256;
constexpr int DK_LDX = DK_T + 8;  // bf16 a staged x row: 260 words
constexpr int DK_SMEM = 32 * DK_LDX * 2 + 4 * 32 * 4;  // x, xsum

// The tile's x columns [t*T, (t+1)*T) for rows < M into xs (rows 32), zero
// past M
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs,
                                        const __nv_bfloat16* __restrict__ x,
                                        int M, int K, int t, int tid) {
  for (int i = tid; i < 32 * (DK_T / 8); i += DK_THREADS) {
    const int r = i / (DK_T / 8), c8 = (i % (DK_T / 8)) * 8;
    const bool in = r < M;
    cp_async16(xs + r * DK_LDX + c8,
               in ? x + (size_t)r * K + (size_t)t * DK_T + c8 : x,
               in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// S3
template <int BITS>
__global__ void __launch_bounds__(DK_THREADS)
f32inj_kernel(const __nv_bfloat16* __restrict__ x,
              const int32_t* __restrict__ qw, const float* __restrict__ sc2,
              const float* __restrict__ off2, float* __restrict__ part, int M,
              int N, int K) {
  constexpr int V = 32 / BITS, P = DK_T * BITS / 32, NB = P / 8;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* xsum = reinterpret_cast<float*>(smem + 32 * DK_LDX * 2);  // [4][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t = blockIdx.y, col = blockIdx.x * DK_BN + warp * 16 + g;

  // the thread's words: block b's rows 8b + t4 (+4), columns col (+8)
  uint32_t w[NB][4];
  const int32_t* src = qw + (size_t)t * P * N + col;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[b][e] = (uint32_t)__ldg(
          src + (size_t)(8 * b + t4 + 4 * (e >> 1)) * N + 8 * (e & 1));
  stage_x(xs, x, M, K, t, tid);
  __syncthreads();
  {  // xsum per (group, row) in f32: two threads per pair, 64 columns each
    const int r = tid >> 3, gq = (tid >> 1) & 3, h = tid & 1;
    const __nv_bfloat16* p = xs + r * DK_LDX + gq * DK_GS + h * 64;
    float s = 0.f;
    for (int i = 0; i < 64; ++i) s += __bfloat162float(p[i]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (h == 0) xsum[gq * 32 + r] = s;
  }
  __syncthreads();

  float acc[4][4], pt[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = pt[mt][e] = 0.f;
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(xs) + g * DK_LDX + t4;
#pragma unroll
  for (int p = 0; p < V; ++p) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = (((w[b][e] >> (BITS * p)) & MASK) << (23 - BITS)) |
               0x3F800000u;
      const int kk = p * P + 8 * b;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint16_t* q = xr + mt * 8 * DK_LDX + kk;
        mma_tf32(pt[mt], a, (uint32_t)q[0] << 16, (uint32_t)q[4] << 16);
      }
    }
    if (((p + 1) * P) % DK_GS == 0) {  // group gi's rows end with slot p
      const int gi = p * P / DK_GS;
      const size_t so = ((size_t)t * 8 + gi) * N + col;
      const float s0 = __ldg(sc2 + so), s1 = __ldg(sc2 + so + 8);
      const float o0 = __ldg(off2 + so), o1 = __ldg(off2 + so + 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float x0 = xsum[gi * 32 + mt * 8 + 2 * t4];
        const float x1 = xsum[gi * 32 + mt * 8 + 2 * t4 + 1];
        // D^T: e 0/1 column col, rows 2t4 (+1); e 2/3 column col + 8
        acc[mt][0] += fmaf(pt[mt][0], s0, x0 * o0);
        acc[mt][1] += fmaf(pt[mt][1], s0, x1 * o0);
        acc[mt][2] += fmaf(pt[mt][2], s1, x0 * o1);
        acc[mt][3] += fmaf(pt[mt][3], s1, x1 * o1);
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[mt][e] = 0.f;
      }
    }
  }
  float* dst = part + (size_t)t * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mt * 8 + 2 * t4 + (e & 1);
      if (row < M) dst[(size_t)row * N + col + 8 * (e >> 1)] = acc[mt][e];
    }
}

template <int BITS>
int f32inj_launch(const __nv_bfloat16* x, const int32_t* qw, const float* sc2,
                  const float* off2, float* part, __nv_bfloat16* y, int M,
                  int N, int K, cudaStream_t st) {
  const dim3 grid(N / DK_BN, K / DK_T);
  f32inj_kernel<BITS><<<grid, DK_THREADS, DK_SMEM, st>>>(x, qw, sc2, off2,
                                                         part, M, N, K);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return splitk_sum(part, nullptr, y, M, N, K / DK_T, st);
}

// ---------------------------------------------------------------------------
// S1: K1's planar decode tile for one-plane words (see the note at the top
// of the file; quant_matmul.cu's qmm_planar_decode_kernel is the original)
enum { AB_FULL = 0, AB_NOUP = 1, AB_NODOT = 2 };
constexpr int AB_T = 512;            // rows a pack tile
constexpr int AB_GS = 128;           // rows a quant group
constexpr int AB_NG = AB_T / AB_GS;  // groups a tile
constexpr int AB_MN = 4;             // n8 tiles of x rows: m <= 32
constexpr int AB_KB = 2;             // k16 blocks a run: pl_dec_kb(2 or 4, 512)

// The step of BITS-bit words and the shared memory: two stages of a step's
// words, two of a sub-step's x columns (at X), two slots of a pack tile's
// scale slab rows for the block's columns (at SC)
template <int BITS>
struct AbGeo {
  using S = PlanarStep<BITS, AB_KB, AB_MN>;
  static_assert(S::NSEL == 1, "one plane of codes: W2 and W4");
  static constexpr int P = AB_T * Planar<BITS>::LO / 32;  // words a tile
  static constexpr int SPT = P / S::WS;                   // steps a tile
  static constexpr int X = 2 * S::STEP_WORDS * 4;
  static constexpr int SC = X + 2 * 8 * AB_MN * S::LDX * 2;
  static constexpr int SMEM = SC + 2 * AB_NG * DEC_BN * 4;
};

// The K walk is n_steps steps (SPT a pack tile) of NSUB sub-steps each;
// the grid is (N / 128 column blocks, splits), and slice s takes steps
// [s*per, min((s+1)*per, n_steps)).
template <int BITS, int MODE>
__global__ void __launch_bounds__(DEC_THREADS)
ablate_kernel(const __nv_bfloat16* __restrict__ x,
              const int32_t* __restrict__ qw, const float* __restrict__ sc,
              float* __restrict__ part, int* __restrict__ tickets,
              __nv_bfloat16* __restrict__ y, int m, int K, int N,
              int n_steps, int per, int bn) {
  using Geo = AbGeo<BITS>;
  using S = typename Geo::S;
  using PL = Planar<BITS>;
  constexpr int WS = S::WS, NSUB = S::NSUB, RUNS = S::RUNS, P = Geo::P;
  constexpr int MR = 8 * AB_MN, LDX = S::LDX, SW = S::STEP_WORDS;
  constexpr int HS = PL::V / 2;  // slots per 16-bit half
  constexpr uint32_t MLO = ((1u << PL::LO) - 1u) * 0x00010001u;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* w_ring = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* x_ring = reinterpret_cast<__nv_bfloat16*>(smem + Geo::X);
  float* sc_ring = reinterpret_cast<float*>(smem + Geo::SC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * DEC_BN, cw = warp * 32;
  const int s0 = blockIdx.y * per, s1 = min(s0 + per, n_steps);
  const int n_sub = (s1 - s0) * NSUB;
  const int t_first = s0 / Geo::SPT;

  // Sub-step j into the ring, as K1's: with a step's first sub-step, the
  // step's words (tile words w0 ..) into the stage of the step and, at a
  // tile's first step or the slice's, the tile's scale slab rows of the
  // block's columns into the slot of the tile; then the x columns of the
  // sub-step's runs (run u: tile rows u*P + w0 ..) into the stage j & 1,
  // each 16-byte chunk at its chunk index XOR (row & 7), zero at rows >= m.
  auto load_sub = [&](int j) {
    const int step = s0 + j / NSUB, h = j % NSUB;
    const int t = step / Geo::SPT, w0 = (step - t * Geo::SPT) * WS;
    if (h == 0) {
      const int32_t* src = qw + ((size_t)t * P + w0) * N + col0;
      uint32_t* wsm = w_ring + ((step - s0) & 1) * SW;
      for (int i = tid; i < WS * (DEC_BN / 4); i += DEC_THREADS) {
        const int r = i / (DEC_BN / 4), c4 = (i % (DEC_BN / 4)) * 4;
        cp_async16(wsm + r * DEC_LDW_PL + c4, src + (size_t)r * N + c4, 16);
      }
      if (step == s0 || w0 == 0) {
        float* ss = sc_ring + ((t - t_first) & 1) * AB_NG * DEC_BN;
        for (int i = tid; i < AB_NG * (DEC_BN / 4); i += DEC_THREADS) {
          const int gq = i / (DEC_BN / 4), c4 = (i % (DEC_BN / 4)) * 4;
          cp_async16(ss + gq * DEC_BN + c4,
                     sc + ((size_t)t * 8 + gq) * N + col0 + c4, 16);
        }
      }
    }
    __nv_bfloat16* xsm = x_ring + (j & 1) * MR * LDX;
    const int kt = t * AB_T + w0;
    constexpr int PER_RUN = MR * (WS / 8);
    for (int i = tid; i < RUNS * PER_RUN; i += DEC_THREADS) {
      const int q = i / PER_RUN, rem = i - q * PER_RUN;
      const int r = rem / (WS / 8), c8 = (rem % (WS / 8)) * 8;
      const int gc = kt + (h * RUNS + q) * P + c8;
      __nv_bfloat16* dst =
          xsm + r * LDX + ((((q * WS + c8) >> 3) ^ (r & 7)) << 3);
      const bool in = r < m;
      cp_async16(dst, in ? x + (size_t)r * K + gc : x, in ? 16 : 0);
    }
  };

  load_sub(0);
  cp_async_commit();

  float acc[2][AB_MN][4];
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int nt = 0; nt < AB_MN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mc][nt][e] = 0.f;
  // ldmatrix rows: lane L addresses row L % 8 of tile L / 8, tiles ordered
  // (n8 tile, k half): (nt, 0), (nt, 1), (nt + 1, 0), (nt + 1, 1)
  const int lm_row = ((lane >> 4) * 8 + (lane & 7)), lm_half = (lane >> 3) & 1;
  __nv_bfloat162 csum = __floats2bfloat162_rn(0.f, 0.f);  // NODOT's codes

  for (int step = s0; step < s1; ++step) {
    const int t = step / Geo::SPT, w0 = (step - t * Geo::SPT) * WS;
    // the staged scales of the thread's first column, cw + g: group gq of
    // the tile at gq * DEC_BN
    const float* ss = sc_ring + ((t - t_first) & 1) * AB_NG * DEC_BN + cw + g;
    // NOUP's A registers: column c's broadcast x[0][tile + c mod bn] in both
    // halves (register e holds column g + 8*(e & 1))
    uint32_t bc[2][4];
    if constexpr (MODE == AB_NOUP) {
      const unsigned short* x0 =
          reinterpret_cast<const unsigned short*>(x) + (size_t)t * AB_T;
#pragma unroll
      for (int mc = 0; mc < 2; ++mc)
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const uint32_t v =
              __ldg(x0 + (col0 + cw + mc * 16 + g + 8 * hc) % bn);
          bc[mc][hc] = bc[mc][hc + 2] = v | (v << 16);
        }
    }
    // runs go in slot order; consecutive runs of one group sum into pt and
    // the group closes once, where the next run starts another; its first
    // k16 block starts the sums
    const int krow = t * AB_T + w0;
    int gi = krow / AB_GS, g_hi = (gi + 1) * AB_GS;
    float pt[2][AB_MN][4];
    bool fresh = true;
#pragma unroll
    for (int h = 0; h < NSUB; ++h) {
      const int j = (step - s0) * NSUB + h;
      cp_async_wait<0>();
      __syncthreads();  // sub-step j's stage landed; j - 1's is free
      if (j + 1 < n_sub) load_sub(j + 1);
      cp_async_commit();
      // the thread's words of the step: rows 2*t4 (+1) .., columns cw + g ..
      const uint32_t* wsm =
          w_ring + ((step - s0) & 1) * SW + 2 * t4 * DEC_LDW_PL + cw + g;
      const __nv_bfloat16* xsm = x_ring + (j & 1) * MR * LDX;
      // half hh of the step's slots takes half hh of each word pair, slot p
      // at bit LO*(p - hh*HS) of each lane, shifted into place as it goes
#pragma unroll
      for (int hh = NSUB == 2 ? h : 0; hh < (NSUB == 2 ? h + 1 : 2); ++hh) {
        uint32_t cl[AB_KB][2][4];
        if constexpr (MODE != AB_NOUP) planar_words<AB_KB>(cl, wsm, hh);
        auto slot = [&](int p) {
          const int q = p - h * RUNS;  // the run's place in the x stage
#pragma unroll
          for (int kb = 0; kb < AB_KB; ++kb) {
            const bool first = fresh && kb == 0;
            uint32_t bf[AB_MN][2];
            if constexpr (MODE != AB_NODOT) {
#pragma unroll
              for (int nt = 0; nt < AB_MN; nt += 2) {
                uint32_t r[4];
                ldmatrix_x<false>(
                    r, xsm + (nt * 8 + lm_row) * LDX +
                           ((q * (WS / 8) + 2 * kb + lm_half) ^ (lane & 7)) *
                               8);
                bf[nt][0] = r[0];
                bf[nt][1] = r[1];
                bf[nt + 1][0] = r[2];
                bf[nt + 1][1] = r[3];
              }
            }
#pragma unroll
            for (int mc = 0; mc < 2; ++mc) {
              uint32_t a[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if constexpr (MODE == AB_NOUP)
                  a[e] = bc[mc][e];
                else
                  a[e] = planar_bf16x2<BITS>(cl[kb][mc][e] & MLO);
              }
              if constexpr (MODE == AB_NODOT) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const __nv_bfloat162 v =
                      *reinterpret_cast<const __nv_bfloat162*>(&a[e]);
                  csum = __hadd2(csum, v);
                  if (w0 == 0 && p == 0) {
                    // tile rows 16kb + 2t4 + 8(e >> 1) (+1) of column g +
                    // 8(e & 1): output rows of n8 tile 2kb + (e >> 1)
                    const int nt = 2 * kb + (e >> 1);
                    acc[mc][nt][2 * (e & 1)] += __low2float(v);
                    acc[mc][nt][2 * (e & 1) + 1] += __high2float(v);
                  }
                }
              } else {
#pragma unroll
                for (int nt = 0; nt < AB_MN; ++nt)
                  mma_16816_or_first(pt[mc][nt], a, bf[nt][0], bf[nt][1],
                                     first);
              }
            }
          }
          fresh = false;
          if constexpr (MODE != AB_NODOT) {
            const int next = krow + (p + 1) * P;
            if (p + 1 == PL::V || next >= g_hi) {
              // the group's close: acc += s * pt, in f32
              const float* sg = ss + (gi - t * AB_NG) * DEC_BN;
#pragma unroll
              for (int mc = 0; mc < 2; ++mc)
#pragma unroll
                for (int hc = 0; hc < 2; ++hc) {
                  const float s = sg[mc * 16 + 8 * hc];
#pragma unroll
                  for (int nt = 0; nt < AB_MN; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      float& o = acc[mc][nt][2 * hc + e];
                      o = fmaf(pt[mc][nt][2 * hc + e], s, o);
                    }
                }
              fresh = true;
              while (next >= g_hi) {  // the next run's group: rows rise
                ++gi;
                g_hi += AB_GS;
              }
            }
          }
          if constexpr (MODE != AB_NOUP) {
#pragma unroll
            for (int kb = 0; kb < AB_KB; ++kb)
#pragma unroll
              for (int mc = 0; mc < 2; ++mc)
#pragma unroll
                for (int e = 0; e < 4; ++e) cl[kb][mc][e] >>= PL::LO;
          }
        };
        if constexpr (HS <= 4) {
#pragma unroll
          for (int p = hh * HS; p < (hh + 1) * HS; ++p) slot(p);
        } else {
#pragma unroll 1
          for (int p = hh * HS; p < (hh + 1) * HS; ++p) slot(p);
        }
      }
    }
  }

  if constexpr (MODE == AB_NODOT)  // 0 times the sum of every code: 0 for
                                   // finite codes, and it keeps their work
    acc[0][0][0] += 0.f * (__low2float(csum) + __high2float(csum));
  store_out<AB_MN>(acc, part, y, m, N, col0 + cw, g, t4);
  if (gridDim.y == 1) return;
  // With split-K, as K1's: store_out wrote this slice's f32 partial sums;
  // the slice that takes the column block's last ticket adds every slice's
  // in slice order from 0 (two calls give the same bits), writes y and
  // resets the ticket for the next launch.
  __threadfence();
  __syncthreads();
  int* ticket = reinterpret_cast<int*>(smem);  // the ring is not read again
  if (tid == 0) *ticket = atomicAdd(tickets + blockIdx.x, 1);
  __syncthreads();
  const int splits = gridDim.y;
  if (*ticket != splits - 1) return;
  __threadfence();
  if (tid == 0) tickets[blockIdx.x] = 0;
  constexpr int CH = MR * (DEC_BN / 4) / DEC_THREADS;  // float4 per thread
  float4 sum[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) sum[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < splits; ++k)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = c * DEC_THREADS + tid, r = i / (DEC_BN / 4);
      if (r < m) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            part + ((size_t)k * m + r) * N + col0 + (i % (DEC_BN / 4)) * 4));
        sum[c].x += v.x;
        sum[c].y += v.y;
        sum[c].z += v.z;
        sum[c].w += v.w;
      }
    }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = c * DEC_THREADS + tid, r = i / (DEC_BN / 4);
    if (r < m) {
      __nv_bfloat162 v[2] = {__floats2bfloat162_rn(sum[c].x, sum[c].y),
                             __floats2bfloat162_rn(sum[c].z, sum[c].w)};
      *reinterpret_cast<uint2*>(y + (size_t)r * N + col0 +
                                (i % (DEC_BN / 4)) * 4) =
          *reinterpret_cast<uint2*>(v);
    }
  }
}

// Let the instance take its dynamic shared memory (more than 48 KB), with
// the carveout at its largest, once.
template <int BITS, int MODE>
cudaError_t ablate_allow() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ablate_kernel<BITS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AbGeo<BITS>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ablate_kernel<BITS, MODE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

template <int BITS, int MODE>
int ablate_launch(const __nv_bfloat16* x, const int32_t* qw, const float* sc,
                  float* part, int* tickets, __nv_bfloat16* y, int M, int N,
                  int K, int bn, int splits, int per, cudaStream_t st) {
  const cudaError_t err = ablate_allow<BITS, MODE>();
  if (err != cudaSuccess) return (int)err;
  const int n_steps = K / AB_T * AbGeo<BITS>::SPT;
  if (splits < 1 || per < 1 || (splits - 1) * per >= n_steps ||
      splits * per < n_steps ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / DEC_BN, splits);
  ablate_kernel<BITS, MODE><<<grid, DEC_THREADS, AbGeo<BITS>::SMEM, st>>>(
      x, qw, sc, part, tickets, y, M, K, N, n_steps, per, bn);
  return (int)cudaGetLastError();
}

template <int BITS>
int ablate_mode(int mode, const __nv_bfloat16* x, const int32_t* qw,
                const float* sc, float* part, int* tickets, __nv_bfloat16* y,
                int M, int N, int K, int bn, int splits, int per,
                cudaStream_t st) {
  switch (mode) {
    case AB_FULL:
      return ablate_launch<BITS, AB_FULL>(x, qw, sc, part, tickets, y, M, N,
                                          K, bn, splits, per, st);
    case AB_NOUP:
      return ablate_launch<BITS, AB_NOUP>(x, qw, sc, part, tickets, y, M, N,
                                          K, bn, splits, per, st);
    case AB_NODOT:
      return ablate_launch<BITS, AB_NODOT>(x, qw, sc, part, tickets, y, M, N,
                                           K, bn, splits, per, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The CTAs of the FULL instance an SM holds (every mode takes its plan)
template <int BITS>
int ablate_ctas() {
  const cudaError_t err = ablate_allow<BITS, AB_FULL>();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  const cudaError_t e2 = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ablate_kernel<BITS, AB_FULL>, DEC_THREADS, AbGeo<BITS>::SMEM);
  return e2 == cudaSuccess ? n : -(int)e2;
}

}  // namespace

// The wrappers (kernels/probes.py) check shapes, types and contiguity;
// these return cudaGetLastError() after the launch.

// S4: xc (M, K) int8, w8 (K, N) int8, sc (K / BK, 8, N) f32 -> out (M, N)
// bf16; N % 128 == 0, K % 128 == 0, K % BK == 0, gs = BK / n_dots a
// multiple of 32 up to 512
extern "C" int probe_consume(const void* xc, const void* w8, const void* sc,
                             void* out, int M, int N, int K, int BK, int gs,
                             void* stream) {
  const int8_t* a = static_cast<const int8_t*>(xc);
  const int8_t* b = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(sc);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gs) {
    case 32: return consume_launch<1>(a, b, s, o, M, N, K, BK, st);
    case 64: return consume_launch<2>(a, b, s, o, M, N, K, BK, st);
    case 128: return consume_launch<4>(a, b, s, o, M, N, K, BK, st);
    case 256: return consume_launch<8>(a, b, s, o, M, N, K, BK, st);
    case 512: return consume_launch<16>(a, b, s, o, M, N, K, BK, st);
  }
  return (int)cudaErrorInvalidValue;
}

// S2: x (M, 512), w (512, N), bf16 (int8 0) or int8 (int8 1) -> out (M, N)
// f32; M % 64 == 0, N % 128 == 0, repeats % 4 == 0
extern "C" int probe_mxu_rate(const void* x, const void* w, void* out, int M,
                              int N, int inner, int repeats, int int8,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (int8) return mxu_rate_launch<true>(x, w, o, M, N, inner, repeats, st);
  return mxu_rate_launch<false>(x, w, o, M, N, inner, repeats, st);
}

// S3: x (M, K) bf16, planar words (K * bits / 32, N) at tile 512, sc2 and
// off2 (K / 512, 8, N) f32; part (K / 512, M, N) f32 scratch -> y (M, N)
// bf16; M <= 32, N % 128 == 0, K % 512 == 0, groups of 128 rows
extern "C" int probe_f32inj(const void* x, const void* qw, const void* sc2,
                            const void* off2, void* part, void* y, int M,
                            int N, int K, int bits, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int32_t* w = static_cast<const int32_t*>(qw);
  const float* s = static_cast<const float*>(sc2);
  const float* o = static_cast<const float*>(off2);
  float* pt = static_cast<float*>(part);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return f32inj_launch<2>(xb, w, s, o, pt, yb, M, N, K, st);
    case 4: return f32inj_launch<4>(xb, w, s, o, pt, yb, M, N, K, st);
    case 8: return f32inj_launch<8>(xb, w, s, o, pt, yb, M, N, K, st);
  }
  return (int)cudaErrorInvalidValue;
}

// S1: x (M, K) bf16 (16-byte aligned), planar words (K * bits / 32, N) at
// tile 512, sc (K / 512, 8, N) f32, mode 0 full / 1 noup / 2 nodot, bn the
// script's column block (noup's broadcast); K1's planar split-K plan
// (splits slices of per steps; a step is 32 words a column, bits / 2 steps
// a tile): with splits > 1, part is a (splits, M, N) f32 workspace and
// tickets a zeroed int32 counter per 128 columns (left zeroed) -> y (M, N)
// bf16; M <= 32, N % 128 == 0, K % 512 == 0, groups of 128 rows
extern "C" int probe_ablate(const void* x, const void* qw, const void* sc,
                            void* part, void* tickets, void* y, int M, int N,
                            int K, int bits, int mode, int bn, int splits,
                            int per, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int32_t* w = static_cast<const int32_t*>(qw);
  const float* s = static_cast<const float*>(sc);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      return ablate_mode<2>(mode, xb, w, s, pt, tk, yb, M, N, K, bn, splits,
                            per, st);
    case 4:
      return ablate_mode<4>(mode, xb, w, s, pt, tk, yb, M, N, K, bn, splits,
                            per, st);
  }
  return (int)cudaErrorInvalidValue;
}

// S1's CTAs per SM at W``bits`` (its split-K plan's occupancy), or minus a
// CUDA error
extern "C" int probe_ablate_ctas(int bits, void* stream) {
  (void)stream;
  switch (bits) {
    case 2: return ablate_ctas<2>();
    case 4: return ablate_ctas<4>();
  }
  return -(int)cudaErrorInvalidValue;
}
