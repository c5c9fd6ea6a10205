// Packed W2/W3/W4 (pairs layout) and W2/W3/W4/W6/W8 (planar layout) x bf16
// activations -> bf16, for sm_90a.
//
// Replaces the TPU kernel omniquant_tpu/kernels/quant_matmul.py::quant_matmul
// (_qmm_call / _qmm_kernel, pallas_call at :276): y = x @ dequant(W), with W
// stored as packed int32 W^T words, per-group scales s and rounded zero
// points z, dequant(c) = (c - z) * s.
//
// Every tile evaluates, with codes turned into bf16 in registers and
// multiplied on the tensor cores (mma.sync m16n8k16, f32 accumulation), the
// scales applied per quant group in f32 after the products:
//     y = sum_g s_g * (x_g . c_g) + xsum_g * off_g,   off_g = -z_g * s_g.
// Codes <= 255 are exact in bf16 and bf16 x bf16 products are exact in f32,
// so nothing is rounded before the f32 sums (no bf16 rounding of scales or
// of dequantised weights; the JAX fine-group branch rounds w = c*s + off to
// bf16, this kernel does not). A pairs-layout word holds two consecutive
// rows (bits 16*h apart), which is exactly the k-pair an mma fragment
// register holds, so one shift, one and-or and one bf16x2 subtract give a
// ready fragment register. In the planar layout (planar.cuh) rows k and k+1
// sit in the same bit slot of two adjacent words; one byte permute of the
// two words puts their low (high) halves side by side, and from there a
// slot's pair of codes is the same shift, and-or and subtract (3-bit and
// 6-bit codes OR in their high-plane bits first; 8-bit codes, up to 255,
// go through f32, as 128 + c no longer fits bf16's mantissa).
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
// The wrapper refuses, for both tiles, a pairs pack tile whose word count per
// column is not a multiple of 8 (pack_tile never makes one).
//
// Planar decode tile (m <= 32), the same design on planar words. A step is
// WS = 16*KB consecutive low-plane words w0.. of a pack tile (KB = 2 at 4
// and 8 bits, else 1) for 128 columns; for 3-bit and 6-bit codes it also
// takes the WS low words P/2 further on and the WS high-plane words both
// blocks share, so each high word is read once too. Slot p of a block is a
// run of WS consecutive rows (p*P + block start + w0 ...), aligned to WS <=
// 32, so inside one quant group of a multiple of 32 rows; consecutive runs
// of one group are closed together, with one scale per column. An A
// fragment register's k-pair is slot p of words 2*t4 and 2*t4 + 1 (+8) of
// the run. Steps are up to ~59 KB at m = 32 (3-bit: 48 words and 512 x
// columns a step, so one CTA per SM). The tile takes a tile whose low block
// (P, or P/2 with two planes) is a multiple of WS words; smaller tiles (in_features below 256 rows at 2 and 6 bits, 512 at 3,
// 128 at 4, 64 at 8) run on the prefill tile at every m.
//
// Prefill tile (m > 32): ~2*m*K*N operations on the bf16 tensor cores bound
// it (qkv at m = 4096: 0.42 ms at the H100's dense bf16 peak). The words are
// few next to the products (a CTA of 128 x 128 outputs uses each word for
// 128 x rows), so the tile has to keep the tensor cores fed. What the design
// does about it:
//   * Field-major K loop. Field j of a pairs pack tile's W words is the
//     contiguous row run [j*2W, (j+1)*2W); slot p of a planar tile's P low
//     words is the run [p*P, (p+1)*P). So walking a tile's fields (slots) in
//     order walks its rows in order: each step's x columns are contiguous,
//     and the tile's words serve every field from shared memory.
//   * Each word read from device memory once per CTA: a pack tile's words
//     for the CTA's 128 columns (up to PF_WMAX per column) go into shared
//     memory by 16-byte cp.async and stay for all its fields; two word
//     stages, the next tile's riding in the cp.async group of the current
//     tile's first step. Planar word pairs are byte-permuted once, in place,
//     when their tile starts, so that a k-pair's codes sit in one word.
//   * x through its own ring of 128 rows x KC columns (16-byte cp.async,
//     zero past m and past K, as the down projection's padded rows need),
//     one barrier per step; KC = 128 (2 stages) where the tile allows it,
//     else 64 (3) or 32 / 16 (4). On the card wider steps were faster and
//     more stages were not. A fragments by ldmatrix.x4.
//   * B fragments unpacked in registers from the resident words by a
//     shift, an and-or and a bf16 subtract (codes_bf16x2; 8-bit codes
//     through f32). No code tile goes through shared memory: the two warps
//     of a column band unpack the same codes, which costs issue slots but
//     saves a store, a barrier and a load.
//   * 8 warps as 2 x 4, 64 x 32 outputs each, one CTA per SM (128 f32 sums
//     per thread; 64-row tiles with two CTAs per SM were slower).
//   * Exact algebra as above: each group's sum closes once, scaled by the
//     column's s in f32, where its rows end (groups of a multiple of 16
//     rows; per-channel scales close at each tile's end, which is the same
//     sum). Where a 128-column step holds whole groups the closes sit at
//     fixed blocks of the step and the next group's first MMAs start from
//     zero. xsum comes from the ones-row MMA, one m16 tile per warp (the
//     four warps of a row band share the band's sums), into shared memory
//     per group; at the tile's end sum_g xsum_g * off_g is added from there
//     with the tile's staged scales and zeros ([group][column], loaded once
//     per tile into registers and stored after the step's MMAs).
//   * No split-K: two calls give the same bits.
// On the card the group closes cost the most after the MMAs: the same
// weight runs slower at g128 than per-channel and slower still at g64.
// Still on mma.sync m16n8k16; wgmma fed by TMA, with the words and x moved
// by the copy engine and a warp-specialised producer, is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planar.cuh"
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

// The slice's scales and zeros as (scale, zero) bf16 pairs, [group][column],
// loaded once, SCALE_BATCH loads in flight per thread; each column's groups
// are contiguous, and the groups of the layout padding (past G) reuse the
// last group's.
__device__ __forceinline__ void stage_scales(
    uint32_t* sz, const __nv_bfloat16* __restrict__ scales,
    const __nv_bfloat16* __restrict__ zeros, int col0, int G, int g0, int ng,
    int tid) {
  constexpr int SCALE_BATCH = 8;
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
}

// Close a run (rows inside one quant group, whose staged (scale, zero)
// row is sz_g) into the f32 sums: D rows are columns g and g + 8 of each
// 16-column A tile, D columns the x rows 2*t4 and 2*t4 + 1 of each n8 tile.
template <int MN>
__device__ __forceinline__ void close_run(float (&acc)[2][MN][4],
                                          const float (&pt)[2][MN][4],
                                          const float (&xs)[MN][4],
                                          const uint32_t* sz_g, int cw,
                                          int g) {
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = sz_g[cw + mc * 16 + g + 8 * h];
      const __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&v);
      const float s = __bfloat162float(p.x);
      const float off = -__bfloat162float(p.y) * s;
#pragma unroll
      for (int nt = 0; nt < MN; ++nt) {
        acc[mc][nt][2 * h] += pt[mc][nt][2 * h] * s + xs[nt][0] * off;
        acc[mc][nt][2 * h + 1] += pt[mc][nt][2 * h + 1] * s + xs[nt][1] * off;
      }
    }
}

template <int MN>
__device__ __forceinline__ void zero_run(float (&pt)[2][MN][4],
                                         float (&xs)[MN][4]) {
#pragma unroll
  for (int nt = 0; nt < MN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[0][nt][e] = pt[1][nt][e] = xs[nt][e] = 0.f;
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
  stage_scales(sz, scales, zeros, col0, G, g0, ng, tid);

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
          ldmatrix_x<MN == 1>(
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
      close_run<MN>(acc, pt, xs, sz + ((krow + j * PR) / gs_rows - g0) * DEC_BN,
                    cw, g);
    }
    ws0 += WS;
    if (ws0 == W) {
      ws0 = 0;
      ++t;
    }
  }
  store_out<MN>(acc, part, y, m, N, col0 + cw, g, t4);
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


// ---------------------------------------------------------------------------
// Planar decode tile (m <= 32): see the note at the top of the file.
constexpr int DEC_LDW_PL = DEC_BN + 4;  // words per staged row: the fragment
                                        // reads of rows 2*t4 (+1) hit 32
                                        // distinct banks

// A step's geometry for one planar width: NSEL low blocks of WS words (two
// for 3/6-bit: words w0.. and P/2 + w0..) plus, for two planes, the WS
// high-plane words they share; RUNS runs of WS rows (slot p of block b).
template <int BITS>
struct PlanarStep {
  static constexpr int NSEL = Planar<BITS>::HI ? 2 : 1;
  static constexpr int KB = (BITS == 4 || BITS == 8) ? 2 : 1;
  static constexpr int WS = 16 * KB;
  static constexpr int NBLK = NSEL + (Planar<BITS>::HI ? 1 : 0);
  static constexpr int RUNS = Planar<BITS>::V * NSEL;
  static constexpr int LDX = RUNS * WS + 8;  // bf16 per staged x row
  static constexpr int WORDS_BYTES = NBLK * WS * DEC_LDW_PL * 4;
  __host__ __device__ static constexpr int stage_bytes(int mr) {
    return WORDS_BYTES + mr * LDX * 2;
  }
};

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

// Slot p of a k-pair as a bf16x2 fragment register, exact. lo[0] holds the
// low 16-bit halves of the pair's two low-plane words side by side (row k
// in the low lane, row k + 1 in the high lane), lo[1] their high halves;
// hi likewise for their high-plane words, whose slot is 2p + sel.
template <int BITS>
__device__ __forceinline__ uint32_t planar_pair(const uint32_t (&lo)[2],
                                                const uint32_t (&hi)[2],
                                                int p, int sel) {
  using PL = Planar<BITS>;
  constexpr int HS = PL::V / 2;  // low-plane slots per 16-bit half
  constexpr uint32_t MLO = ((1u << PL::LO) - 1u) * 0x00010001u;
  uint32_t c =
      (p < HS ? lo[0] >> (PL::LO * p) : lo[1] >> (PL::LO * (p - HS))) & MLO;
  if constexpr (PL::HI > 0) {
    constexpr int HF = 16 / PL::HI;  // high-plane slots per 16-bit half
    constexpr uint32_t MHI = ((1u << PL::HI) - 1u) * 0x00010001u;
    const int f = 2 * p + sel;
    c |= ((f < HF ? hi[0] >> (PL::HI * f) : hi[1] >> (PL::HI * (f - HF))) &
          MHI)
         << PL::LO;
  }
  return planar_bf16x2<BITS>(c);
}

template <int BITS, int MN>
__global__ void __launch_bounds__(DEC_THREADS)
qmm_planar_decode_kernel(const __nv_bfloat16* __restrict__ x,
                         const int32_t* __restrict__ qw,
                         const __nv_bfloat16* __restrict__ scales,
                         const __nv_bfloat16* __restrict__ zeros,
                         float* __restrict__ part,
                         __nv_bfloat16* __restrict__ y, int m, int K, int N,
                         int G, int gs_rows, int T, int n_tiles, int per,
                         int x_vec) {
  using S = PlanarStep<BITS>;
  constexpr int WS = S::WS, KB = S::KB, NSEL = S::NSEL, MR = 8 * MN;
  constexpr int LDX = S::LDX, STAGE = S::stage_bytes(MR);
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = T * Planar<BITS>::LO / 32;  // low-plane words per tile
  const int B = P / NSEL;                   // low words per block
  const int WPT = T * BITS / 32;            // words per tile and column
  const int steps_per_tile = B / WS;
  // (scale, zero) bf16 pairs of the slice's groups, [group][column]
  uint32_t* sz = reinterpret_cast<uint32_t*>(smem + DEC_STAGES * STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * DEC_BN, cw = warp * 32;
  const int t_begin = blockIdx.y * per;
  const int t_end = min(t_begin + per, n_tiles);
  const int n_steps = (t_end - t_begin) * steps_per_tile;
  const int g0 = t_begin * T / gs_rows;
  const int ng = (t_end * T - 1) / gs_rows - g0 + 1;

  auto load_step = [&](int step) {
    const int tt = step / steps_per_tile;
    const int t = t_begin + tt, w0 = (step - tt * steps_per_tile) * WS;
    unsigned char* base = smem + (step % DEC_STAGES) * STAGE;
    uint32_t* wsm = reinterpret_cast<uint32_t*>(base);
    __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(base + S::WORDS_BYTES);
    // block b < NSEL: low words b*B + w0 ..; block NSEL: high words P + w0 ..
    const int32_t* src = qw + (size_t)t * WPT * N + col0;
    for (int i = tid; i < S::NBLK * WS * (DEC_BN / 4); i += DEC_THREADS) {
      const int r = i / (DEC_BN / 4), c4 = (i % (DEC_BN / 4)) * 4;
      const int b = r / WS;
      const int row = (b < NSEL ? b * B : P) + w0 + (r - b * WS);
      cp_async16(wsm + r * DEC_LDW_PL + c4, src + (size_t)row * N + c4, 16);
    }
    // x columns of each run (slot p of block b: tile rows p*P + b*B + w0 ..),
    // zero at rows >= m and columns >= K (the packed rows past in_features
    // carry code 0 but enter xsum)
    const int kt = t * T + w0;
    constexpr int PER_RUN = MR * (WS / 8);
    for (int i = tid; i < S::RUNS * PER_RUN; i += DEC_THREADS) {
      const int run = i / PER_RUN, rem = i - run * PER_RUN;
      const int r = rem / (WS / 8), c8 = (rem % (WS / 8)) * 8;
      const int p = run / NSEL, b = run - p * NSEL;
      const int gc = kt + p * P + b * B + c8;
      __nv_bfloat16* dst = xsm + r * LDX + run * WS + c8;
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
  };

#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }
  stage_scales(sz, scales, zeros, col0, G, g0, ng, tid);

  float acc[2][MN][4];
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int nt = 0; nt < MN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mc][nt][e] = 0.f;
  const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                            0x3f803f80u};  // bf16 1.0 pairs
  const int lm_row = ((lane >> 4) * 8 + (lane & 7)), lm_half = (lane >> 3) & 1;

  int t = t_begin, w0 = 0;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // step's stage landed; step - 1's stage is free
    if (step + DEC_STAGES - 1 < n_steps) load_step(step + DEC_STAGES - 1);
    cp_async_commit();

    const unsigned char* base = smem + (step % DEC_STAGES) * STAGE;
    const uint32_t* wsm = reinterpret_cast<const uint32_t*>(base);
    const __nv_bfloat16* xsm =
        reinterpret_cast<const __nv_bfloat16*>(base + S::WORDS_BYTES);
    // the k-pairs of A register e (column g + 8*(e & 1), block words
    // 16kb + 2*t4 + 8*(e >> 1) and the next), low and high halves
    // permuted side by side: lw for the low blocks, hw for the high block
    uint32_t lw[NSEL][KB][2][4][2], hw[KB][2][4][2];
#pragma unroll
    for (int b = 0; b < S::NBLK; ++b)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int mc = 0; mc < 2; ++mc)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t* q =
                wsm + (b * WS + 16 * kb + 2 * t4 + 8 * (e >> 1)) * DEC_LDW_PL +
                cw + mc * 16 + g + 8 * (e & 1);
            const uint32_t wa = q[0], wb = q[DEC_LDW_PL];
            uint32_t(&d)[2] = b < NSEL ? lw[b < NSEL ? b : 0][kb][mc][e]
                                       : hw[kb][mc][e];
            d[0] = __byte_perm(wa, wb, 0x5410);
            d[1] = __byte_perm(wa, wb, 0x7632);
          }
    // runs go in slot order; consecutive runs of one group (slots 2q and
    // 2q + 1 of a 512-row tile at g64 and 2 bits, every run of a step with
    // per-channel scales) sum into pt and xs, and the group closes once,
    // where the next run starts another group
    const int krow = t * T + w0;
    float pt[2][MN][4], xs[MN][4];
    zero_run<MN>(pt, xs);
    // the group of the runs summing in pt and xs, and its rows [g_lo, g_hi)
    int gi = krow / gs_rows;
    int g_lo = gi * gs_rows, g_hi = g_lo + gs_rows;
#pragma unroll
    for (int run = 0; run < S::RUNS; ++run) {
      const int p = run / NSEL, b = run % NSEL;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        uint32_t bf[MN][2];
#pragma unroll
        for (int nt = 0; nt < MN; nt += 2) {
          uint32_t r[4];
          ldmatrix_x<MN == 1>(r, xsm + (nt * 8 + lm_row) * LDX + run * WS +
                                     16 * kb + 8 * lm_half);
          bf[nt][0] = r[0];
          bf[nt][1] = r[1];
          if (MN > 1) {
            bf[nt + 1][0] = r[2];
            bf[nt + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int nt = 0; nt < MN; ++nt)
          mma_16816(xs[nt], ones, bf[nt][0], bf[nt][1]);
#pragma unroll
        for (int mc = 0; mc < 2; ++mc) {
          uint32_t a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[e] = planar_pair<BITS>(lw[b][kb][mc][e], hw[kb][mc][e], p, b);
#pragma unroll
          for (int nt = 0; nt < MN; ++nt)
            mma_16816(pt[mc][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
      const int next = krow + ((run + 1) / NSEL) * P + ((run + 1) % NSEL) * B;
      if (run + 1 == S::RUNS || next < g_lo || next >= g_hi) {
        // the group ends here: close it, open the next run's
        close_run<MN>(acc, pt, xs, sz + (gi - g0) * DEC_BN, cw, g);
        zero_run<MN>(pt, xs);
        if (run + 1 < S::RUNS) {
          gi = next / gs_rows;
          g_lo = gi * gs_rows;
          g_hi = g_lo + gs_rows;
        }
      }
    }
    w0 += WS;
    if (w0 == B) {
      w0 = 0;
      ++t;
    }
  }
  store_out<MN>(acc, part, y, m, N, col0 + cw, g, t4);
}

template <int BITS, int MN>
int launch_planar_decode(const void* x, const void* qw, const void* scales,
                         const void* zeros, void* part, void* y, int m, int K,
                         int N, int k_pad, int G, int gs_rows, int T,
                         int x_vec, int splits, int per, cudaStream_t st) {
  // the largest scale block a slice of per tiles can span
  const int ng = T % gs_rows ? (per * T - 1) / gs_rows + 2 : per * T / gs_rows;
  const int smem = DEC_STAGES * PlanarStep<BITS>::stage_bytes(8 * MN) +
                   ng * DEC_BN * 4;
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_planar_decode_kernel<BITS, MN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(qmm_planar_decode_kernel<BITS, MN>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(N / DEC_BN, splits);
  qmm_planar_decode_kernel<BITS, MN><<<grid, DEC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(y), m, K, N, G, gs_rows, T, k_pad / T, per,
      x_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(part), nullptr,
                    static_cast<__nv_bfloat16*>(y), m, N, splits, st);
}

// ---------------------------------------------------------------------------
// Prefill tile (m > 32, and planar tiles too small for a decode step at
// every m): see the note at the top of the file.
constexpr int PF_BN = 128;       // output columns per CTA
constexpr int PF_MT = 4;         // m16 tiles per warp
constexpr int PF_BM = 32 * PF_MT;  // x rows per CTA
constexpr int PF_THREADS = 256;  // 8 warps as 2 x 4, 64 x 32 outputs each
constexpr int PF_WMAX = 128;     // words per pack tile and column
constexpr int PF_GMAX = 16;      // quant groups per pack tile
constexpr int PF_SZ_PER_THREAD = PF_GMAX * PF_BN / PF_THREADS;
constexpr int PF_SMEM_MAX = 232448;  // shared memory a block can have

// A step of KC x columns (pf_step picks KC): the x ring's stages (2 of 128
// columns, 3 of 64, else 4: on the card more stages did not help once a
// step holds 64 columns) and their row pitch
__host__ __device__ constexpr int pf_stages(int kc) {
  return kc == 128 ? 2 : (kc == 64 ? 3 : 4);
}
__host__ __device__ constexpr int pf_xld(int kc) {
  return kc + 8;  // bf16 per staged x row: the ldmatrix rows hit distinct
                  // banks
}

// words per staged row: the B reads of 4 (pairs: rows t4) or 8 (planar:
// rows 2*t4, 2*t4 + 1) word rows x 8 columns hit 32 distinct banks
__host__ __device__ constexpr int pf_ldw(int planar) {
  return planar ? PF_BN + 4 : PF_BN + 8;
}

// word rows per pack tile and column
__host__ __device__ __forceinline__ int pf_words(int T, int bits,
                                                 int planar) {
  return planar ? T * bits / 32 : T / (2 * pairs_fields(bits));
}

// the dynamic shared memory of a step width: the x ring, two tiles' words,
// two tiles' (scale, zero) pairs and the tile's xsum per group and row
__host__ __device__ __forceinline__ int pf_smem(int kc, int wpt, int planar,
                                                int ngt) {
  return pf_stages(kc) * PF_BM * pf_xld(kc) * 2 + 2 * wpt * pf_ldw(planar) * 4 +
         2 * ngt * PF_BN * 4 + ngt * PF_BM * 4;
}

// KG: k16 blocks per group where a group fits in a 128-column step (it
// closes at a fixed block of the step, and the next group's first block
// starts its sums afresh), 0 where a group spans whole steps (it closes
// with the step where its rows end)
template <int PL_BITS, int KC, int KG>
__global__ void __launch_bounds__(PF_THREADS, 1)
qmm_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                   const int32_t* __restrict__ qw,
                   const __nv_bfloat16* __restrict__ scales,
                   const __nv_bfloat16* __restrict__ zeros,
                   __nv_bfloat16* __restrict__ y, int m, int K, int N, int G,
                   int gs_rows, int T, int bits, int n_tiles, int x_vec) {
  constexpr int LDW = pf_ldw(PL_BITS), MT = PF_MT, BM = PF_BM;
  constexpr int STAGES = pf_stages(KC), XLD = pf_xld(KC);
  extern __shared__ __align__(16) unsigned char smem[];
  const int WPT = pf_words(T, bits, PL_BITS);
  // rows of one run: a pairs field (2 * WPT rows) or a planar slot (P)
  const int PR = PL_BITS ? T * Planar<PL_BITS>::LO / 32 : 2 * WPT;
  const int spt = T / KC;  // steps per pack tile
  const int n_steps = n_tiles * spt;
  const int gse = min(gs_rows, T);  // rows of a group inside a tile
  const int ngt = T / gse;          // groups per tile
  __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* wb =
      reinterpret_cast<uint32_t*>(smem + STAGES * BM * XLD * 2);
  uint32_t* sz = wb + 2 * WPT * LDW;  // [tile & 1][group][column]
  float* xsg = reinterpret_cast<float*>(sz + 2 * ngt * PF_BN);  // [group][row]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * PF_BN;
  const int cw = wn * 32;
  const uint32_t mask2 = ((1u << bits) - 1u) * 0x00010001u;

  // a tile's words: 16-byte cp.async, neighbouring threads on neighbouring
  // columns
  auto load_words = [&](int t) {
    uint32_t* dst = wb + (t & 1) * WPT * LDW;
    const int32_t* src = qw + (size_t)t * WPT * N + col0;
    for (int i = tid; i < WPT * (PF_BN / 4); i += PF_THREADS) {
      const int w = i >> 5, c4 = (i & 31) * 4;
      cp_async16(dst + w * LDW + c4, src + (size_t)w * N + c4, 16);
    }
  };
  // a step's x columns (KC consecutive rows of the weight; the steps of a
  // tile are consecutive, so step s starts at row s * KC), zero at rows >=
  // m and columns >= K (the packed rows past in_features carry code 0 but
  // enter xsum)
  auto load_x = [&](int step) {
    const int k0 = step * KC;
    __nv_bfloat16* dst = xr + (step % STAGES) * BM * XLD;
    constexpr int PIECES = KC / 8;  // 16-byte pieces per row
#pragma unroll
    for (int i0 = 0; i0 < BM * PIECES; i0 += PF_THREADS) {
      const int i = i0 + tid;
      if (BM * PIECES < PF_THREADS && i >= BM * PIECES) break;
      const int r = i / PIECES, c8 = (i % PIECES) * 8;
      const int gr = row0 + r, gc = k0 + c8;
      __nv_bfloat16* d = dst + r * XLD + c8;
      if (x_vec) {
        const bool in = gr < m && gc < K;
        cp_async16(d, in ? x + (size_t)gr * K + gc : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = (gr < m && gc + e < K) ? x[(size_t)gr * K + gc + e]
                                        : __float2bfloat16(0.f);
      }
    }
  };
  // a tile's (scale, zero) bf16 pairs, [group][column], into registers (the
  // groups of the layout padding, past G, reuse the last group's), and from
  // there into shared memory once the step's products are issued; element
  // i is group i % ngt of column i / ngt, so that neighbouring threads read
  // a column's groups, which lie side by side
  auto ldg_scales = [&](int t, uint32_t (&v)[PF_SZ_PER_THREAD]) {
    const int gt = t * T / gs_rows;  // the tile's first group (0 per-channel)
#pragma unroll
    for (int u = 0; u < PF_SZ_PER_THREAD; ++u) {
      const int i = u * PF_THREADS + tid;
      if (i < ngt * PF_BN) {
        const int c = i / ngt;
        const size_t src =
            (size_t)(col0 + c) * G + min(gt + i - c * ngt, G - 1);
        __nv_bfloat162 p;
        p.x = scales[src];
        p.y = zeros[src];
        v[u] = *reinterpret_cast<uint32_t*>(&p);
      }
    }
  };
  auto st_scales = [&](int t, const uint32_t (&v)[PF_SZ_PER_THREAD]) {
#pragma unroll
    for (int u = 0; u < PF_SZ_PER_THREAD; ++u) {
      const int i = u * PF_THREADS + tid;
      if (i < ngt * PF_BN) {
        const int c = i / ngt;
        sz[(t & 1) * ngt * PF_BN + (i - c * ngt) * PF_BN + c] = v[u];
      }
    }
  };

  load_words(0);
  {
    uint32_t v[PF_SZ_PER_THREAD];
    ldg_scales(0, v);
    st_scales(0, v);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_x(s);
    cp_async_commit();
  }

  // acc: the output; part: the open group's sum_k x c; xsr: its sum_k x
  // over the 16 rows of m16 tile wn of the warp's row band (the band's four
  // warps share its xsum)
  float acc[MT][4][4], part[MT][4][4], xsr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;
  constexpr uint32_t ONES = 0x3f803f80u;  // bf16 1.0 pairs
  const int band = wm * 16 * MT;  // the warp's first x row
  const int a_row = band + (lane & 15), a_col = (lane >> 4) * 8;

  int gl = 0, rg = 0;  // the open group inside the tile, its rows done
  // the open group ends: its sums scaled into acc, its xsum kept for the
  // tile's offsets
  auto close_group = [&](const uint32_t* szt) {
    // with KG, the next group's first MMAs overwrite part and xsr
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t v = szt[gl * PF_BN + cw + nt * 8 + 2 * t4 + e];
        const float s =
            __bfloat162float(reinterpret_cast<__nv_bfloat162*>(&v)->x);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][e] += part[mt][nt][e] * s;
          acc[mt][nt][e + 2] += part[mt][nt][e + 2] * s;
          if (KG == 0) part[mt][nt][e] = part[mt][nt][e + 2] = 0.f;
        }
      }
    if (t4 == 0) {
      xsg[gl * BM + band + wn * 16 + g] = xsr[0];
      xsg[gl * BM + band + wn * 16 + g + 8] = xsr[2];
    }
    if (KG == 0) xsr[0] = xsr[1] = xsr[2] = xsr[3] = 0.f;
    rg = 0;
    ++gl;
  };

  int t = 0, st = 0;    // tile, step inside it
  int run = 0, rr = 0;  // the next k16 block: its run, its row in the run
  for (int step = 0; step < n_steps; ++step) {
    const bool first = st == 0;
    // the next tile's words ride in the group of a tile's first step; a
    // tile of fewer steps than the ring holds waits for them in full
    if (first && spt < STAGES - 1)
      cp_async_wait<0>();
    else
      cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's stage landed; step - 1's stage is free
    if (step + STAGES - 1 < n_steps) load_x(step + STAGES - 1);
    const bool pre = first && t + 1 < n_tiles;
    uint32_t sv[PF_SZ_PER_THREAD];
    if (pre) {
      load_words(t + 1);  // tile t - 1's stage: free since this barrier
      ldg_scales(t + 1, sv);
    }
    cp_async_commit();

    if constexpr (PL_BITS != 0) {
      if (first) {
        // planar: the tile's word pairs (rows 2r, 2r + 1) permuted once in
        // place, so that row 2r holds their low 16-bit halves side by side
        // and row 2r + 1 their high halves: a k-pair's codes then sit in one
        // word, as in the pairs layout
        uint32_t* wsm = wb + (t & 1) * WPT * LDW;
        for (int i = tid; i < (WPT / 2) * PF_BN; i += PF_THREADS) {
          uint32_t* q = wsm + 2 * (i >> 7) * LDW + (i & (PF_BN - 1));
          const uint32_t wa = q[0], wb2 = q[LDW];
          q[0] = __byte_perm(wa, wb2, 0x5410);
          q[LDW] = __byte_perm(wa, wb2, 0x7632);
        }
        __syncthreads();
      }
    }
    const __nv_bfloat16* xs = xr + (step % STAGES) * BM * XLD;
    const uint32_t* ws = wb + (t & 1) * WPT * LDW;
    const uint32_t* szt = sz + (t & 1) * ngt * PF_BN;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x<false>(a[mt],
                          xs + (a_row + mt * 16) * XLD + kk * 16 + a_col);
      {
        // the band's xsum: this warp's m16 tile of it against a ones row
        uint32_t ax[4];
        ldmatrix_x<false>(ax, xs + (a_row + wn * 16) * XLD + kk * 16 + a_col);
        if (KG > 0 && kk % KG == 0)
          mma_16816_first(xsr, ax, ONES, ONES);
        else
          mma_16816(xsr, ax, ONES, ONES);
      }
      // B fragments: register h holds rows 2*t4 (+1) + 8h of the block,
      // column g of each n8 tile
      uint32_t b[4][2];
      if constexpr (PL_BITS == 0) {
        // field `run`, rows rr..: words rr/2 + t4 (+4), shifted to the field
        const uint32_t* q = ws + (rr / 2 + t4) * LDW + cw + g;
        const int sh = bits * run;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] = codes_bf16x2(q[nt * 8] >> sh, mask2);
          b[nt][1] = codes_bf16x2(q[4 * LDW + nt * 8] >> sh, mask2);
        }
      } else {
        using PL = Planar<PL_BITS>;
        constexpr int HS = PL::V / 2;  // low-plane slots per 16-bit half
        constexpr uint32_t MLO = ((1u << PL::LO) - 1u) * 0x00010001u;
        // rows rr + 8h .. + 7 lie in one slot (P is a multiple of 8): slot
        // run, or run + 1 for h = 1 where a slot of 8 or 24 rows ends
        // inside the block
        const int wrap = rr + 8 >= PR;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // slot p of the permuted pair w, w + 1 (w even): row w holds slots
          // below HS, row w + 1 the rest; with two planes, the permuted high
          // pair of the same rows at slot 2p + sel
          const int p = run + (h ? wrap : 0);
          const int w = rr + 8 * h - (h && wrap ? PR : 0) + 2 * t4;
          const int psh = PL::LO * (p < HS ? p : p - HS);
          const uint32_t* q = ws + (w + (p >= HS)) * LDW + cw + g;
          int hsh = 0;
          const uint32_t* qh = q;
          if constexpr (PL::HI > 0) {
            constexpr int HF = 16 / PL::HI;  // high-plane slots per half
            const int half = PR / 2;
            const int sel = w >= half;
            const int f = 2 * p + sel;
            hsh = PL::HI * (f < HF ? f : f - HF);
            qh = ws + (PR + w - sel * half + (f >= HF)) * LDW + cw + g;
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint32_t c = (q[nt * 8] >> psh) & MLO;
            if constexpr (PL::HI > 0) {
              constexpr uint32_t MHI = ((1u << PL::HI) - 1u) * 0x00010001u;
              c |= ((qh[nt * 8] >> hsh) & MHI) << PL::LO;
            }
            b[nt][h] = planar_bf16x2<PL_BITS>(c);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (KG > 0 && kk % KG == 0)
            mma_16816_first(part[mt][nt], a[mt], b[nt][0], b[nt][1]);
          else
            mma_16816(part[mt][nt], a[mt], b[nt][0], b[nt][1]);
      rr += 16;
      while (rr >= PR) {  // twice only where a planar slot has 8 rows
        rr -= PR;
        ++run;
      }
      if constexpr (KG > 0)
        if ((kk + 1) % KG == 0) close_group(szt);
    }
    if constexpr (KG == 0) {
      rg += KC;
      if (rg == gse) close_group(szt);
    }
    if (pre) st_scales(t + 1, sv);  // tile t - 1's stage, last read before
                                    // the barrier above
    if (++st == spt) {
      // the tile ends: sum_g xsum_g off_g over its groups, once every warp
      // has written its rows' xsum
      __syncthreads();
      for (int q = 0; q < ngt; ++q) {
        float off[4][2], xv[MT][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t v = szt[q * PF_BN + cw + nt * 8 + 2 * t4 + e];
            const __nv_bfloat162 pz = *reinterpret_cast<__nv_bfloat162*>(&v);
            off[nt][e] = -__bfloat162float(pz.y) * __bfloat162float(pz.x);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[mt][h] = xsg[q * BM + band + mt * 16 + g + 8 * h];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] += xv[mt][e >> 1] * off[nt][e & 1];
      }
      st = 0;
      ++t;
      run = rr = gl = 0;
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = row0 + band + mt * 16 + g;
      const int c = col0 + cw + nt * 8 + t4 * 2;
      if (r < m)
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)r * N + c]) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < m)
        *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)(r + 8) * N + c]) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// The prefill tile's step width for a weight, 0 where it does not take
// it: N a multiple of 128, one slice, a pack tile of a multiple of 16 rows
// and at most PF_WMAX words per column that holds whole groups (at most
// PF_GMAX, each a multiple of 16 rows) or runs under per-channel scales
// (gs_rows == k_pad). 128 columns where the tile is a multiple of 128 rows
// and its groups a multiple or a divisor of 128 rows (32 or 64: they close
// inside a step), else the widest of 64/32/16 that divides the tile and its
// groups (they close with a step); the shared memory must fit.
int pf_step(int N, int k_pad, int gs_rows, int T, int bits, int planar,
            int splits) {
  const int wpt = pf_words(T, bits, planar);
  if (N % PF_BN || T % 16 || k_pad % T || splits != 1 || wpt > PF_WMAX)
    return 0;
  const int gse = min(gs_rows, T), ngt = T / gse;
  if (gs_rows < k_pad && (T % gs_rows || gs_rows % 16 || ngt > PF_GMAX))
    return 0;
  for (int kc = 128; kc >= 16; kc /= 2)
    if (T % kc == 0 &&
        (gse % kc == 0 || (kc == 128 && 128 % gse == 0 && gse >= 32)) &&
        pf_smem(kc, wpt, planar, ngt) <= PF_SMEM_MAX)
      return kc;
  return 0;
}

template <int PL_BITS, int KC, int KG>
int launch_prefill_kc(const void* x, const void* qw, const void* scales,
                      const void* zeros, void* y, int m, int K, int N,
                      int k_pad, int G, int gs_rows, int T, int bits,
                      int x_vec, cudaStream_t st) {
  const int smem =
      pf_smem(KC, pf_words(T, bits, PL_BITS), PL_BITS, T / min(gs_rows, T));
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_prefill_kernel<PL_BITS, KC, KG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(qmm_prefill_kernel<PL_BITS, KC, KG>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(N / PF_BN, (m + PF_BM - 1) / PF_BM);
  qmm_prefill_kernel<PL_BITS, KC, KG><<<grid, PF_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros),
      static_cast<__nv_bfloat16*>(y), m, K, N, G, gs_rows, T, bits, k_pad / T,
      x_vec);
  return (int)cudaGetLastError();
}

template <int PL_BITS>
int launch_prefill(const void* x, const void* qw, const void* scales,
                   const void* zeros, void* y, int m, int K, int N, int k_pad,
                   int G, int gs_rows, int T, int bits, int x_vec,
                   cudaStream_t st) {
  const int kc = pf_step(N, k_pad, gs_rows, T, bits, PL_BITS != 0, 1);
  const int gse = min(gs_rows, T);
  const int kg = kc == 128 && gse <= 128 ? gse / 16 : 0;
#define PF_CASE(KC, KG)                                                     \
  if (kc == KC && kg == KG)                                                 \
    return launch_prefill_kc<PL_BITS, KC, KG>(x, qw, scales, zeros, y, m, K, \
                                              N, k_pad, G, gs_rows, T, bits, \
                                              x_vec, st);
  PF_CASE(128, 0)
  PF_CASE(128, 8)
  PF_CASE(128, 2)
  PF_CASE(128, 4)
  PF_CASE(64, 0)
  PF_CASE(32, 0)
  if constexpr (PL_BITS == 0) {
    PF_CASE(16, 0)
  }
#undef PF_CASE
  return (int)cudaErrorInvalidValue;
}

// The decode tile at m <= 32 where the tile's low blocks hold whole steps,
// else the prefill tile (one slice).
template <int BITS>
int planar_entry(const void* x, const void* qw, const void* scales,
                 const void* zeros, void* part, void* y, int m, int K, int N,
                 int k_pad, int G, int gs_rows, int T, int x_vec, int splits,
                 int per, cudaStream_t st) {
  using S = PlanarStep<BITS>;
  const int P = T * Planar<BITS>::LO / 32;
  if (m <= 32 && (P / S::NSEL) % S::WS == 0) {
#define PL_CASE(MN)                                                          \
  return launch_planar_decode<BITS, MN>(x, qw, scales, zeros, part, y, m, K, \
                                        N, k_pad, G, gs_rows, T, x_vec,      \
                                        splits, per, st)
    if (m <= 8) PL_CASE(1);
    if (m <= 16) PL_CASE(2);
    PL_CASE(4);
#undef PL_CASE
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  return launch_prefill<BITS>(x, qw, scales, zeros, y, m, K, N, k_pad, G,
                              gs_rows, T, BITS, x_vec, st);
}

}  // namespace

// Both entries: N a multiple of 128; scales/zeros (N, G) bf16 (a bf16
// engine serves bf16-rounded scales); gs_rows the group size, or k_pad for
// per-channel scales (G == 1). For m <= 32 the decode tile splits the K
// tiles into ``splits`` slices of ``per`` tiles (the last may be shorter);
// with splits > 1, part is a (splits, m, N) f32 workspace. The prefill tile
// takes one slice and what pf_step takes (else cudaErrorInvalidValue).
// qweight must be 16-byte aligned.
//
// Pairs layout, bits 2/3/4: groups a multiple of 64 rows (a decode run of up
// to 64 rows lies inside one group), a pack tile of a multiple of 8 words
// per column.
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
  if (splits != 1) return (int)cudaErrorInvalidValue;
  return launch_prefill<0>(x, qw, scales, zeros, y, m, K, N, k_pad, G, gs_rows,
                           tile_k, bits, x_vec, st);
}

// Planar layout, bits 2/3/4/6/8: groups a multiple of 32 rows (a decode run
// of up to 32 rows lies inside one group), a pack tile of a multiple of 32
// rows whose low plane holds a multiple of 8 words per column (pack_tile
// makes only such tiles).
extern "C" int qmm_planar_bf16(const void* x, const void* qw,
                               const void* scales, const void* zeros,
                               void* part, void* y, int m, int K, int N,
                               int k_pad, int G, int gs_rows, int tile_k,
                               int bits, int x_vec, int splits, int per,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lo = bits == 3 ? 2 : (bits == 6 ? 4 : bits);
  if (N % DEC_BN || tile_k % 32 || k_pad % tile_k || (tile_k * lo / 32) % 8 ||
      (gs_rows < k_pad && gs_rows % 32) || splits < 1 || per < 1 ||
      (splits - 1) * per >= k_pad / tile_k || splits * per < k_pad / tile_k ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
#define PL_BITS_CASE(B)                                                      \
  case B:                                                                    \
    return planar_entry<B>(x, qw, scales, zeros, part, y, m, K, N, k_pad, G, \
                           gs_rows, tile_k, x_vec, splits, per, st);
  switch (bits) {
    PL_BITS_CASE(2)
    PL_BITS_CASE(3)
    PL_BITS_CASE(4)
    PL_BITS_CASE(6)
    PL_BITS_CASE(8)
  }
#undef PL_BITS_CASE
  return (int)cudaErrorInvalidValue;
}
