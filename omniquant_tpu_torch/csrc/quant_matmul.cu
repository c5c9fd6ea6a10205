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
// Planar decode tile (m <= 32): the same algebra on planar words, with the
// split set by the card rather than by the quant group. On the card it was
// bound by its instructions and their latency (a clock trace found its
// cp.async waits near zero, a burst of first loads, then the K loop), not by
// the bytes of the words.
//   * A step is WS = 16*KB consecutive low-plane words w0.. of a pack tile
//     for 128 columns (KB = 2 where a low block holds a multiple of 32
//     words at 2, 4 and 8 bits); for 3-bit and 6-bit codes also the WS low
//     words P/2 further on and the WS high-plane words both blocks share,
//     so each word is read from device memory once. Slot p of a block is a
//     run of WS rows (p*P + block start + w0 ...), aligned to WS <= 32, so
//     inside one quant group of a multiple of 32 rows.
//   * The ring (2 stages, cp.async) holds a step's words and a sub-step's x
//     columns: where a step's x would take more than 16 KB (8 KB with a
//     high plane) its runs go in two sub-steps of half the slots each, so
//     that every width puts two or more CTAs on an SM (94 KB at 3 bits and
//     m = 32: two; 73-77 KB at 2, 4 and 6 bits: three). x chunks are
//     XOR-swizzled by row, not padded.
//   * Half h of the slots takes half h of each word pair: a thread reads
//     its words from shared memory at each half and byte-permutes them
//     (prmt) so that a register holds rows k and k + 1 of one bit slot in
//     its two lanes; the registers then shift in place, one slot a run, so
//     the slot loop need not be unrolled (unrolled code was slower) and few
//     registers hold words (166-168 at m = 32, no spills).
//   * Consecutive runs of one group sum together and close once, with one
//     scale per column: acc += s*pt + off*xs, off = -z*s, two FMAs per sum
//     (at W2 g64 a close every 4 k16 blocks). xsum comes from the ones-row
//     MMA as in the pairs tile.
//   * A pack tile's (scale, zero) pairs for the 128 columns ride in the ring
//     with the tile's first step, by 4-byte cp.async into one of two slots
//     of bf16 planes (each column's groups are contiguous in (N, G); a
//     column whose first group sits at an odd element starts one element
//     early), so no step waits on its own round trip, and a slice may be
//     any number of steps, whatever the group size.
//   * Split-K by the card (kernels/quant_matmul.py::planar_decode_plan):
//     slices of whole steps, as many as give the least time on the busiest
//     SM for the CTAs an SM holds (asked of the card). Each slice writes
//     f32 partial sums to the workspace, fences and takes a ticket of its
//     column block; the last to finish adds the slices in slice order from
//     0 (two calls give the same bits), writes y and resets the ticket. No
//     second launch; the partials are read back while they are still in
//     L2.
// The tile takes a tile whose low block (P, or P/2 with two planes) is a
// multiple of 16 words (32 at 4 and 8 bits); smaller tiles (in_features
// below 256 rows at 2, 4 and 6 bits, 512 at 3, 128 at 8) run on the
// prefill tile at every m.
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

// The planar decode tile's shared memory: two stages of a step's words and
// two of a sub-step's x columns (x), then two slots of a pack tile's scales
// and zeros (sz), each a bf16 plane of ngp per column (the tile's groups
// from the column's first one, one element earlier where that one sits at
// an odd element, in whole words).
struct PlDecSmem {
  int x, sz, ngp, bytes;
};

template <int BITS, int KB, int MN>
__host__ __device__ inline PlDecSmem pl_dec_smem(int T, int gs_rows, int G) {
  using S = PlanarStep<BITS, KB, MN>;
  const int spans = T % gs_rows ? (T - 1) / gs_rows + 2 : T / gs_rows;
  const int ngt = spans < G ? spans : G;  // groups a tile's columns touch
  PlDecSmem L;
  L.ngp = (ngt + 2) & ~1;
  L.x = 2 * S::STEP_WORDS * 4;
  L.sz = L.x + 2 * 8 * MN * S::LDX * 2;
  L.bytes = L.sz + 2 * 2 * DEC_BN * L.ngp * 2;
  return L;
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

// Close a group's runs into the f32 sums: acc += s*pt + off*xs, off =
// -z*s, in f32. ss and zs point at the group's (scale, zero) of the
// thread's first column (g) in the staged planes, whose columns lie ngp
// apart (zo = ngp); gl is the group's element.
template <int MN>
__device__ __forceinline__ void close_planar(float (&acc)[2][MN][4],
                                             const float (&pt)[2][MN][4],
                                             const float (&xs)[MN][4],
                                             const uint16_t* ss,
                                             const uint16_t* zs, int zo,
                                             int gl) {
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = (mc * 16 + 8 * h) * zo + gl;
      const float s = __uint_as_float((uint32_t)ss[i] << 16);
      const float off = -__uint_as_float((uint32_t)zs[i] << 16) * s;
#pragma unroll
      for (int nt = 0; nt < MN; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& a = acc[mc][nt][2 * h + e];
          a = fmaf(pt[mc][nt][2 * h + e], s, a);
          a = fmaf(xs[nt][e], off, a);
        }
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

// The K walk is n_steps steps (spt per pack tile) of NSUB sub-steps each;
// the grid is (N / 128 column blocks, splits), and slice s takes steps
// [s*per, min((s+1)*per, n_steps)).
template <int BITS, int MN, int KB>
__global__ void __launch_bounds__(DEC_THREADS)
qmm_planar_decode_kernel(const __nv_bfloat16* __restrict__ x,
                         const int32_t* __restrict__ qw,
                         const __nv_bfloat16* __restrict__ scales,
                         const __nv_bfloat16* __restrict__ zeros,
                         float* __restrict__ part, int* __restrict__ tickets,
                         __nv_bfloat16* __restrict__ y, int m, int K, int N,
                         int G, int gs_rows, int T, int n_steps, int per,
                         int x_vec) {
  using S = PlanarStep<BITS, KB, MN>;
  using PL = Planar<BITS>;
  constexpr int WS = S::WS, NSEL = S::NSEL, NSUB = S::NSUB, RUNS = S::RUNS;
  constexpr int MR = 8 * MN, LDX = S::LDX, SW = S::STEP_WORDS;
  constexpr int HS = PL::V / 2;  // low-plane slots per 16-bit half
  constexpr uint32_t MLO = ((1u << PL::LO) - 1u) * 0x00010001u;
  constexpr uint32_t MHI = ((1u << PL::HI) - 1u) * 0x00010001u;
  extern __shared__ __align__(16) unsigned char smem[];
  const PlDecSmem L = pl_dec_smem<BITS, KB, MN>(T, gs_rows, G);
  const int P = T * Planar<BITS>::LO / 32;  // low-plane words per tile
  const int B = P / NSEL;                   // low words per block
  const int WPT = T * BITS / 32;            // words per tile and column
  const int spt = B / WS;                   // steps per tile
  uint32_t* w_ring = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* x_ring = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  uint16_t* sz_ring = reinterpret_cast<uint16_t*>(smem + L.sz);
  const int sz_slot = 2 * DEC_BN * L.ngp;  // bf16 of a (scales, zeros) slot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * DEC_BN, cw = warp * 32;
  const int s0 = blockIdx.y * per, s1 = min(s0 + per, n_steps);
  const int n_sub = (s1 - s0) * NSUB;
  const int t_first = s0 / spt;

  // the groups of pack tile t: [gt0, gt0 + nv), the layout padding past G
  // reusing group G - 1
  auto tile_groups = [&](int t, int& gt0, int& nv) {
    gt0 = t * T / gs_rows;
    nv = min(((t + 1) * T - 1) / gs_rows, G - 1) - gt0 + 1;
  };

  // Sub-step j into the ring: with a step's first sub-step, the step's
  // words (block b < NSEL: low words b*B + w0 ..; block NSEL: high words
  // P + w0 ..) into the stage of the step and, at a tile's first step or
  // the slice's, the tile's scales and zeros into the slot of the tile;
  // then the x columns of the sub-step's runs into the stage j & 1.
  auto load_sub = [&](int j) {
    const int step = s0 + j / NSUB, h = j % NSUB;
    const int t = step / spt, w0 = (step - t * spt) * WS;
    if (h == 0) {
      const int32_t* src = qw + (size_t)t * WPT * N + col0;
      uint32_t* wsm = w_ring + ((step - s0) & 1) * SW;
      for (int i = tid; i < S::NBLK * WS * (DEC_BN / 4); i += DEC_THREADS) {
        const int r = i / (DEC_BN / 4), c4 = (i % (DEC_BN / 4)) * 4;
        const int b = r / WS;
        const int row = (b < NSEL ? b * B : P) + w0 + (r - b * WS);
        cp_async16(wsm + r * DEC_LDW_PL + c4, src + (size_t)row * N + c4, 16);
      }
      if (step == s0 || w0 == 0) {
        // the words holding elements [e0, e0 + nv) of each column's plane
        // (at most nw0 words: one more where e0 is odd), column by column
        // across the threads so that a warp's copies share sectors
        int gt0, nv;
        tile_groups(t, gt0, nv);
        uint16_t* ss = sz_ring + ((t - t_first) & 1) * sz_slot;
        const int nw0 = (nv + 2) >> 1;
        const long long n_el = (long long)N * G;
        for (int i = tid; i < DEC_BN * nw0; i += DEC_THREADS) {
          const int c = i / nw0, w = i - c * nw0;
          const long long e0 = (long long)(col0 + c) * G + gt0;
          const long long e = (e0 & ~1LL) + 2 * w;
          if (e < e0 + nv) {
            const int bytes = e + 1 < n_el ? 4 : 2;
            cp_async4(ss + c * L.ngp + 2 * w, scales + e, bytes);
            cp_async4(ss + (DEC_BN + c) * L.ngp + 2 * w, zeros + e, bytes);
          }
        }
      }
    }
    // x columns of run q (step run u = h*RUNS + q: slot u / NSEL of block
    // u % NSEL, tile rows p*P + b*B + w0 ..) at row columns q*WS ..., each
    // 16-byte chunk at its chunk index XOR (row & 7), so that ldmatrix's
    // eight rows hit distinct banks; zero at rows >= m and columns >= K
    // (the packed rows past in_features carry code 0 but enter xsum)
    __nv_bfloat16* xsm = x_ring + (j & 1) * MR * LDX;
    const int kt = t * T + w0;
    constexpr int PER_RUN = MR * (WS / 8);
    for (int i = tid; i < RUNS * PER_RUN; i += DEC_THREADS) {
      const int q = i / PER_RUN, rem = i - q * PER_RUN;
      const int r = rem / (WS / 8), c8 = (rem % (WS / 8)) * 8;
      const int u = h * RUNS + q;
      const int gc = kt + (u / NSEL) * P + (u % NSEL) * B + c8;
      __nv_bfloat16* dst =
          xsm + r * LDX + ((((q * WS + c8) >> 3) ^ (r & 7)) << 3);
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

  load_sub(0);
  cp_async_commit();

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

  for (int step = s0; step < s1; ++step) {
    const int t = step / spt, w0 = (step - t * spt) * WS;
    int gt0, nv;
    tile_groups(t, gt0, nv);
    // the staged planes of the thread's first column, cw + g; its columns
    // (col0 + cw + mc*16 + g + 8h: g's parity) start one element late
    // where (col0 + c)*G + gt0 is odd
    const uint16_t* ss = sz_ring + ((t - t_first) & 1) * sz_slot +
                         (cw + g) * L.ngp + (((g & G) ^ gt0) & 1);
    // runs go in the order u; consecutive runs of one group (slots 2q and
    // 2q + 1 at g64 and 2 bits, every run of a step with per-channel
    // scales) sum into pt and xs, and the group closes once, where the next
    // run starts another. The group's first k16 block starts the sums with
    // one low block; with two they are zeroed (faster on the card there)
    const int krow = t * T + w0;
    int gi = krow / gs_rows, g_hi = (gi + 1) * gs_rows;
    float pt[2][MN][4], xs[MN][4];
    if constexpr (NSEL == 2) zero_sums<MN>(pt, xs);
    bool fresh = true;
#pragma unroll
    for (int h = 0; h < NSUB; ++h) {
      const int j = (step - s0) * NSUB + h;
      cp_async_wait<0>();
      __syncthreads();  // sub-step j's stage landed; j - 1's is free
      if (j + 1 < n_sub) load_sub(j + 1);
      cp_async_commit();
      // the thread's words of the step: rows 2*t4 (+1) .. of each block,
      // columns cw + g ..
      const uint32_t* wsm =
          w_ring + ((step - s0) & 1) * SW + 2 * t4 * DEC_LDW_PL + cw + g;
      const __nv_bfloat16* xsm = x_ring + (j & 1) * MR * LDX;
      // half hh of the step's runs (slots [hh*HS, (hh+1)*HS) of every
      // block) takes half hh of each word pair: the low plane's slot p sits
      // at bit LO*(p - hh*HS) of each lane, the high plane's field 2p + b
      // at HI*(2p + b - hh*HF); both registers shift in place as the runs
      // go, so the loop over slots need not be unrolled (it is where a half
      // has at most 4 slots)
#pragma unroll
      for (int hh = NSUB == 2 ? h : 0; hh < (NSUB == 2 ? h + 1 : 2); ++hh) {
        uint32_t cl[NSEL][KB][2][4], ch[KB][2][4];
#pragma unroll
        for (int b = 0; b < NSEL; ++b)
          planar_words<KB>(cl[b], wsm + b * WS * DEC_LDW_PL, hh);
        if constexpr (NSEL == 2)
          planar_words<KB>(ch, wsm + 2 * WS * DEC_LDW_PL, hh);
        // slot p: its NSEL runs, then the low plane's next slot into place
        auto slot = [&](int p) {
#pragma unroll
          for (int b = 0; b < NSEL; ++b) {
            const int u = p * NSEL + b, q = u - h * RUNS;
#pragma unroll
            for (int kb = 0; kb < KB; ++kb) {
              const bool first = NSEL == 1 && fresh && kb == 0;
              uint32_t bf[MN][2];
#pragma unroll
              for (int nt = 0; nt < MN; nt += 2) {
                uint32_t r[4];
                ldmatrix_x<MN == 1>(
                    r, xsm + (nt * 8 + lm_row) * LDX +
                           ((q * (WS / 8) + 2 * kb + lm_half) ^ (lane & 7)) *
                               8);
                bf[nt][0] = r[0];
                bf[nt][1] = r[1];
                if (MN > 1) {
                  bf[nt + 1][0] = r[2];
                  bf[nt + 1][1] = r[3];
                }
              }
#pragma unroll
              for (int nt = 0; nt < MN; ++nt)
                mma_16816_or_first(xs[nt], ones, bf[nt][0], bf[nt][1], first);
#pragma unroll
              for (int mc = 0; mc < 2; ++mc) {
                uint32_t a[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  uint32_t c = cl[b][kb][mc][e] & MLO;
                  if constexpr (PL::HI > 0) {
                    c |= (ch[kb][mc][e] & MHI) << PL::LO;
                    ch[kb][mc][e] >>= PL::HI;
                  }
                  a[e] = planar_bf16x2<BITS>(c);
                }
#pragma unroll
                for (int nt = 0; nt < MN; ++nt)
                  mma_16816_or_first(pt[mc][nt], a, bf[nt][0], bf[nt][1],
                                     first);
              }
            }
            fresh = false;
            const int next =
                krow + ((u + 1) / NSEL) * P + ((u + 1) % NSEL) * B;
            if (u + 1 == NSEL * PL::V || next >= g_hi) {
              close_planar<MN>(acc, pt, xs, ss, ss + DEC_BN * L.ngp, L.ngp,
                               min(gi - gt0, nv - 1));
              if constexpr (NSEL == 2) zero_sums<MN>(pt, xs);
              fresh = true;
              while (next >= g_hi) {  // the next run's group: rows rise
                ++gi;
                g_hi += gs_rows;
              }
            }
          }
#pragma unroll
          for (int b = 0; b < NSEL; ++b)
#pragma unroll
            for (int kb = 0; kb < KB; ++kb)
#pragma unroll
              for (int mc = 0; mc < 2; ++mc)
#pragma unroll
                for (int e = 0; e < 4; ++e) cl[b][kb][mc][e] >>= PL::LO;
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

  store_out<MN>(acc, part, y, m, N, col0 + cw, g, t4);
  if (gridDim.y == 1) return;
  // With split-K, store_out wrote this slice's f32 partial sums; then the
  // column block's ticket. The slice that takes the last one adds every
  // slice's sums in slice order from 0 (as splitk_sum does: two calls give
  // the same bits) while they are still in L2, writes y and resets the
  // ticket for the next launch.
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

// Let the decode instance take smem bytes of dynamic shared memory: the
// attribute only grows, for the launch and the occupancy query alike.
template <int BITS, int MN, int KB>
cudaError_t pl_dec_allow(int smem) {
  static int allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      qmm_planar_decode_kernel<BITS, MN, KB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qmm_planar_decode_kernel<BITS, MN, KB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <int BITS, int MN, int KB>
int launch_planar_decode(const void* x, const void* qw, const void* scales,
                         const void* zeros, void* part, void* tickets, void* y,
                         int m, int K, int N, int k_pad, int G, int gs_rows,
                         int T, int x_vec, int splits, int per,
                         cudaStream_t st) {
  using S = PlanarStep<BITS, KB, MN>;
  const int smem = pl_dec_smem<BITS, KB, MN>(T, gs_rows, G).bytes;
  const cudaError_t err = pl_dec_allow<BITS, MN, KB>(smem);
  if (err != cudaSuccess) return (int)err;
  const int n_steps =
      k_pad / T * (T * Planar<BITS>::LO / 32 / S::NSEL / S::WS);
  dim3 grid(N / DEC_BN, splits);
  qmm_planar_decode_kernel<BITS, MN, KB><<<grid, DEC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const __nv_bfloat16*>(zeros), static_cast<float*>(part),
      static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(y), m, K, N, G,
      gs_rows, T, n_steps, per, x_vec);
  return (int)cudaGetLastError();
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

// The decode tile at m <= 32 where the tile's low blocks hold whole steps
// (a multiple of 32 words at 4 and 8 bits, 16 at 2, 3 and 6), split into
// ``splits`` slices of ``per`` steps; else the prefill tile (one slice).
template <int BITS>
bool planar_decodes(int m, int T) {
  const int B = T * Planar<BITS>::LO / 32 / (Planar<BITS>::HI ? 2 : 1);
  return m <= 32 && B % (BITS == 4 || BITS == 8 ? 32 : 16) == 0;
}

template <int BITS>
int planar_entry(const void* x, const void* qw, const void* scales,
                 const void* zeros, void* part, void* tickets, void* y, int m,
                 int K, int N, int k_pad, int G, int gs_rows, int T,
                 int x_vec, int splits, int per, cudaStream_t st) {
  if (planar_decodes<BITS>(m, T)) {
    const int kb = pl_dec_kb(BITS, T);
    const int n_steps = k_pad / T *
                        (T * Planar<BITS>::LO / 32 /
                         (Planar<BITS>::HI ? 2 : 1) / (16 * kb));
    // scales and zeros are staged by 4-byte copies
    if (splits < 1 || per < 1 || (splits - 1) * per >= n_steps ||
        splits * per < n_steps ||
        (splits > 1 && (part == nullptr || tickets == nullptr)) ||
        (reinterpret_cast<uintptr_t>(scales) |
         reinterpret_cast<uintptr_t>(zeros)) % 4)
      return (int)cudaErrorInvalidValue;
    const int mn = m <= 8 ? 1 : (m <= 16 ? 2 : 4);
#define PL_CASE(MN, KB)                                                      \
  if (mn == MN && kb == KB)                                                 \
    return launch_planar_decode<BITS, MN, KB>(x, qw, scales, zeros, part,   \
                                              tickets, y, m, K, N, k_pad,   \
                                              G, gs_rows, T, x_vec, splits, \
                                              per, st);
    if constexpr (BITS != 3 && BITS != 6) {
      PL_CASE(1, 2)
      PL_CASE(2, 2)
      PL_CASE(4, 2)
    }
    if constexpr (BITS == 2 || BITS == 3 || BITS == 6) {
      PL_CASE(1, 1)
      PL_CASE(2, 1)
      PL_CASE(4, 1)
    }
#undef PL_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  return launch_prefill<BITS>(x, qw, scales, zeros, y, m, K, N, k_pad, G,
                              gs_rows, T, BITS, x_vec, st);
}

// The planar decode tile's shared memory for (m, T, gs_rows, G) and, with
// ctas, how many of its CTAs an SM holds (cudaOccupancy...); negative: a
// CUDA error.
template <int BITS>
int planar_decode_info(int m, int T, int gs_rows, int G, bool ctas) {
  if (!planar_decodes<BITS>(m, T)) return -(int)cudaErrorInvalidValue;
  const int kb = pl_dec_kb(BITS, T), mn = m <= 8 ? 1 : (m <= 16 ? 2 : 4);
#define PL_INFO(MN, KB)                                                     \
  if (mn == MN && kb == KB) {                                              \
    const int smem = pl_dec_smem<BITS, KB, MN>(T, gs_rows, G).bytes;   \
    if (!ctas) return smem;                                                \
    cudaError_t err = pl_dec_allow<BITS, MN, KB>(smem);                    \
    int n = 0;                                                             \
    if (err == cudaSuccess)                                                \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
          &n, qmm_planar_decode_kernel<BITS, MN, KB>, DEC_THREADS, smem);  \
    return err == cudaSuccess ? n : -(int)err;                             \
  }
  if constexpr (BITS != 3 && BITS != 6) {
    PL_INFO(1, 2)
    PL_INFO(2, 2)
    PL_INFO(4, 2)
  }
  if constexpr (BITS == 2 || BITS == 3 || BITS == 6) {
    PL_INFO(1, 1)
    PL_INFO(2, 1)
    PL_INFO(4, 1)
  }
#undef PL_INFO
  return -(int)cudaErrorInvalidValue;
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
// makes only such tiles). For the decode tile ``per`` counts steps of the
// K walk (planar_decode_plan), scales and zeros must be 4-byte aligned and,
// with splits > 1, tickets is a zeroed int32 counter per column block,
// which the kernel leaves zeroed.
extern "C" int qmm_planar_bf16(const void* x, const void* qw,
                               const void* scales, const void* zeros,
                               void* part, void* tickets, void* y, int m,
                               int K, int N, int k_pad, int G, int gs_rows,
                               int tile_k, int bits, int x_vec, int splits,
                               int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lo = bits == 3 ? 2 : (bits == 6 ? 4 : bits);
  if (N % DEC_BN || tile_k % 32 || k_pad % tile_k || (tile_k * lo / 32) % 8 ||
      (gs_rows < k_pad && gs_rows % 32))
    return (int)cudaErrorInvalidValue;
#define PL_BITS_CASE(B)                                                      \
  case B:                                                                    \
    return planar_entry<B>(x, qw, scales, zeros, part, tickets, y, m, K, N,  \
                           k_pad, G, gs_rows, tile_k, x_vec, splits, per,    \
                           st);
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

// planar_decode_info for the entry's widths: shared memory (ctas == 0) or
// CTAs per SM (ctas != 0) of the decode tile at m rows.
extern "C" int qmm_planar_decode_info(int bits, int m, int tile_k,
                                      int gs_rows, int G, int ctas, void*) {
  switch (bits) {
    case 2: return planar_decode_info<2>(m, tile_k, gs_rows, G, ctas != 0);
    case 3: return planar_decode_info<3>(m, tile_k, gs_rows, G, ctas != 0);
    case 4: return planar_decode_info<4>(m, tile_k, gs_rows, G, ctas != 0);
    case 6: return planar_decode_info<6>(m, tile_k, gs_rows, G, ctas != 0);
    case 8: return planar_decode_info<8>(m, tile_k, gs_rows, G, ctas != 0);
  }
  return -(int)cudaErrorInvalidValue;
}
