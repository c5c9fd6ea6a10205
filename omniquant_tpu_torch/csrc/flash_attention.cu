// Blockwise (flash) attention forward for sm_90a: causal or not, GQA,
// optional ALiBi, bf16 in and out, f32 online softmax.
//
// Replaces the TPU kernel omniquant_tpu/kernels/flash_attention.py::
// flash_attention (_flash_call / _flash_kernel, pallas_call at :146), with
// the same semantics: scores = q.k * sm_scale (+ slope[h] * sm_scale * key
// position), keys at or beyond Skv masked, the causal mask aligned at
// position 0 (key <= query), exp in f32, the unnormalised probabilities
// rounded to bf16 for the p.v product, rows divided by max(l, 1e-30).
//
// What bounds it on an H100: at the serving prefill shapes (S = 1024,
// head_dim 128, causal) it does 2 * 2 * S^2 * D / 2 operations per (batch,
// head) on the bf16 tensor cores against 4 * S * D * 2 bytes of q, k, v and
// out: bound by the tensor cores, and next by the exponentials (one per
// score, 1/16 of the tensor cores' rate per SM) between the two products.
//
// Design: a CTA of two warpgroups takes two 128-row query tiles of one
// (batch, head): iq = n_q_tiles - 1 - blockIdx.x, the longest causal rows,
// first, then iq = blockIdx.x (causal pairs are equal work); CTAs of one
// head are neighbours in the grid, so they meet its K and V in L2. Each
// warpgroup takes 64 rows of a tile. One thread loads both Q tiles at the
// start and the first key tiles; then 128-key K and V tiles of both query
// tiles stream by TMA through a ring of FA_STAGES slots (3-D maps over
// (D, S, B*H), so rows past S arrive as zeros, never as the next head's
// rows; 128-byte swizzled boxes of 64 bf16 columns), K and V with separate
// full barriers. The second warpgroup done with a slot's K (or V) refills
// it: a count in shared memory says which. There is no producer warp: at
// 256 threads ptxas may give each thread up to 255 registers, where a
// third warpgroup (or a ninth warp) caps them at 168 whatever setmaxnreg
// asks, and the loop below needs ~210. Per key tile jt:
//  * S_jt = Q.K^T on wgmma m64n128k16 from shared memory, both K-major,
//    issued together with O += P_{jt-1}.V_{jt-1} (wgmma with P in
//    registers: the S accumulator converted pairwise to bf16 is the A
//    fragment; V MN-major straight from the ring, the transpose bit),
//    after O *= alpha_{jt-1};
//  * once S_jt has landed, its online softmax runs under that P.V, on the
//    accumulator fragment in the exp2 domain (p = exp2(s*c - m*c),
//    c = sm_scale * log2(e), one FFMA an element; ALiBi folds in as
//    slope*c*key), masks only on the causal diagonal tile and the tile
//    holding key Skv-1; row maxima over the quad by two shuffles, row sums
//    kept per thread and summed over the quad once at the end; P_jt is
//    packed only after P_{jt-1}.V_{jt-1} has read its registers;
//  * the two warpgroups take turns issuing their products (named
//    barriers), so one's softmax runs under the other's wgmmas.
// Head dims other than 64 and 128 (multiples of 8 up to 128: OPT-2.7B's 80)
// run the next instance up on maps of the true width (fa_instance): the
// columns past D arrive as zeros and are never stored, as JAX pads head_dim
// to 128 lanes, with no padded copy in memory. At hd 80 that is 128/80 =
// 1.6x the tensor-core work of the true product.
// The epilogue scales by 1/max(l, 1e-30), writes bf16 into the warpgroup's
// rows of the tile's Q buffer in the swizzled layout, and stores them by
// TMA (rows past Sq are not written). No atomics on the output and no
// split over keys: two calls on the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int FA_BQ = 128, FA_BK = 128;  // query rows and keys of a tile
constexpr int FA_STAGES = 2, FA_THREADS = 256;
constexpr int FA_BOX = 128 * 128;  // 128 rows x 64 bf16: one swizzled box
constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory: two Q tiles, then per slot a K and a V tile, then
// the barriers and the slots' counts; every tile (D / 64 boxes) at a
// 1024-byte aligned address
template <int D>
struct FaLayout {
  static constexpr int TILE = D / 64 * FA_BOX;
  static constexpr int BARS = (2 + 2 * FA_STAGES) * TILE;
  static constexpr int BYTES =
      BARS + (1 + 2 * FA_STAGES) * 8 + 2 * FA_STAGES * 4 + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// S (64 x 128) = Q (this warpgroup's 64 rows at q) . K^T (128 keys at k):
// k16 step kk reads 32 bytes at column 32 * (kk % 4) of box kk / 4
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[64], uint32_t q,
                                         uint32_t k) {
  fence_acc(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * FA_BOX + 32 * (kk % 4);
    wgmma_bf16(s, desc_k_sw128(q + off), desc_k_sw128(k + off), kk > 0);
  }
  wgmma_commit();
}

// O (64 x D) += P (64 x 128 keys, registers) . V (128 keys x D at v): k16
// step kk reads keys 16 kk.. (2048 bytes a step), the next 64 columns one
// box (FA_BOX bytes) on
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         const uint32_t (&p)[8][4],
                                         uint32_t v) {
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < FA_BK / 16; ++kk)
    wgmma_bf16_rs(o, p[kk], desc_mn_sw128(v + 2048 * kk, FA_BOX), 1);
  wgmma_commit();
}

// One key tile's online softmax on the S fragment: element i of the
// thread's 64 is row g + 8 ((i / 2) % 2) of its warp's 16, key offset
// 8 (i / 4) + i % 2 from key0 (the tile's first key + 2 (lane % 4)). MASK:
// offsets at or past lim[h] get no weight. ALIBI: s becomes the exp2-domain
// score s*c + slope*c*key first, and the max and exponent run on it. On
// return s holds the unnormalised p and alpha the rescale of the rows'
// running sums.
template <bool MASK, bool ALIBI>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, float slope_c,
                                             int key0, const int (&lim)[2]) {
  if (ALIBI) {
    const float kb = slope_c * (float)key0;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      s[i] = fmaf(s[i], c, fmaf(slope_c, (float)(8 * (i / 4) + i % 2), kb));
  }
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i / 4) + i % 2 >= lim[(i / 2) % 2]) s[i] = -INFINITY;
  }
  const float cs = ALIBI ? 1.f : c;
  float mx[2] = {-INFINITY, -INFINITY}, mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    mc[h] = m_new == -INFINITY ? 0.f : m_new * cs;  // a row with no key yet
    alpha[h] = ex2(fmaf(m[h], cs, -mc[h]));
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i / 2) % 2;
    s[i] = ex2(fmaf(s[i], cs, -mc[h]));
    rs[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], rs[h]);
}

// the two consumers take turns issuing their products (named barriers 3
// and 4, 256 threads): one's softmax runs under the other's wgmmas
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
}

template <int D, bool ALIBI>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o,
                 const float* __restrict__ slopes, int H, int Hkv, int Sq,
                 int Skv, float c, int causal) {
  using L = FaLayout<D>;
  extern __shared__ uint8_t fa_raw[];
  const uint32_t raw = smem_u32(fa_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = fa_raw + (base - raw);
  // two Q tiles, then per slot a K and a V tile
  auto q_s = [&](int it) { return base + it * L::TILE; };
  auto k_s = [&](int i) { return base + (2 + 2 * i) * L::TILE; };
  auto v_s = [&](int i) { return base + (3 + 2 * i) * L::TILE; };
  // barriers: q_full, then per slot k_full and v_full; then per slot the
  // count of warpgroups done with its K and with its V
  const uint32_t q_full = base + L::BARS;
  auto k_full = [&](int i) { return q_full + 8 * (1 + i); };
  auto v_full = [&](int i) { return q_full + 8 * (1 + FA_STAGES + i); };
  int* done = reinterpret_cast<int*>(smem + L::BARS + 8 * (1 + 2 * FA_STAGES));

  // the CTA's query tiles: n_q - 1 - x (the longest causal rows) first,
  // then x; causal pairs are equal work. Key tiles are counted f over both.
  const int n_q = (Sq + FA_BQ - 1) / FA_BQ, x = blockIdx.x;
  const int n_items = 2 * x + 1 == n_q ? 1 : 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_kv = (Skv + FA_BK - 1) / FA_BK;
  auto q_tile = [&](int it) { return it ? x : n_q - 1 - x; };
  auto n_kt = [&](int iq) { return causal ? min(n_kv, iq + 1) : n_kv; };
  const int n_first = n_kt(q_tile(0));
  const int n_all = n_first + (n_items == 2 ? n_kt(q_tile(1)) : 0);
  const int kv_plane = b * Hkv + h / (H / Hkv);
  // key tile f's K (kind 0) or V (kind 1) into its slot
  auto load = [&](int kind, int f) {
    const int i = f % FA_STAGES;
    const int jt = f < n_first ? f : f - n_first;
    const uint32_t full = kind ? v_full(i) : k_full(i);
    const uint32_t dst = kind ? v_s(i) : k_s(i);
    mbar_arm(full, L::TILE);
    for (int cb = 0; cb < D / 64; ++cb)
      tma_box3(dst + cb * FA_BOX, kind ? &map_v : &map_k, full, 64 * cb,
               jt * FA_BK, kv_plane);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < FA_STAGES; ++i) {
      mbar_init(k_full(i), 1);
      mbar_init(v_full(i), 1);
      done[i] = done[FA_STAGES + i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(q_full, n_items * L::TILE);
    for (int it = 0; it < n_items; ++it)
      for (int cb = 0; cb < D / 64; ++cb)
        tma_box3(q_s(it) + cb * FA_BOX, &map_q, q_full, 64 * cb,
                 q_tile(it) * FA_BQ, b * H + h);
    for (int f = 0; f < min(n_all, FA_STAGES); ++f) {
      load(0, f);
      load(1, f);
    }
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;  // query rows 64 cw.. of a tile
  const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float slope_c = ALIBI ? slopes[h] * c : 0.f;

  // this warpgroup is done with key tile f's K (kind 0) or V (kind 1):
  // the second warpgroup to say so loads tile f + FA_STAGES into the slot
  auto release = [&](int kind, int f) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (t == 0) {
      int* cnt = done + kind * FA_STAGES + f % FA_STAGES;
      if (atomicAdd(cnt, 1) == 1) {
        *cnt = 0;
        if (f + FA_STAGES < n_all) load(kind, f + FA_STAGES);
      }
    }
  };

  float o[D / 2], s[64], m[2], l[2], alpha[2];
  uint32_t p[8][4];
  int row0 = 0, iq = 0;  // this thread's rows row0, row0 + 8 of tile iq

  // key tile jt's softmax on s (masked on the edge tiles)
  auto softmax = [&](int jt) {
    const int key0 = jt * FA_BK + 2 * t4;
    if ((causal && jt == iq) || (jt == n_kv - 1 && Skv % FA_BK)) {
      const int lim[2] = {(causal ? min(Skv, row0 + 1) : Skv) - key0,
                          (causal ? min(Skv, row0 + 9) : Skv) - key0};
      softmax_tile<true, ALIBI>(s, m, l, alpha, c, slope_c, key0, lim);
    } else {
      const int lim[2] = {0, 0};
      softmax_tile<false, ALIBI>(s, m, l, alpha, c, slope_c, key0, lim);
    }
  };
  // the unnormalised p into P's registers (no P.V may still read them)
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  // S = Q.K^T of key tile f issued, in this consumer's turn
  auto qk = [&](int f, uint32_t q_w) {
    mbar_wait(k_full(f % FA_STAGES), (f / FA_STAGES) & 1);
    turn_wait(cw);
    qk_issue<D>(s, q_w, k_s(f % FA_STAGES));
  };
  auto pass = [&](int f) {  // the other consumer's turn; see turn_wait
    if (cw == 0 || f < n_all - 1) turn_pass(cw);
  };
  // O *= alpha, then O += P.V of key tile f issued (not waited for)
  auto pv = [&](int f) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    mbar_wait(v_full(f % FA_STAGES), (f / FA_STAGES) & 1);
    pv_issue<D>(o, p, v_s(f % FA_STAGES));
  };
  auto pv_done = [&](int f) {
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[kk][r])::"memory");
    release(1, f);
  };

  if (cw == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
  mbar_wait(q_full, 0);
  for (int it = 0, f0 = 0; it < n_items; ++it) {
    iq = q_tile(it);
    row0 = iq * FA_BQ + cw * 64 + warp * 16 + g;
    const int nk = n_kt(iq);
    const uint32_t q_w = q_s(it) + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    // key tile 0: S alone
    qk(f0, q_w);
    pass(f0);
    wgmma_wait<0>();
    fence_acc(s);
    release(0, f0);
    softmax(0);
    to_p();
    // key tile jt: S_jt and O += P_{jt-1}.V_{jt-1} in flight together, the
    // softmax of S_jt under the second
    for (int jt = 1; jt < nk; ++jt) {
      qk(f0 + jt, q_w);
      pv(f0 + jt - 1);
      pass(f0 + jt);
      wgmma_wait<1>();
      fence_acc(s);
      release(0, f0 + jt);
      softmax(jt);
      wgmma_wait<0>();
      pv_done(f0 + jt - 1);
      to_p();
    }
    pv(f0 + nk - 1);
    wgmma_wait<0>();
    pv_done(f0 + nk - 1);
    f0 += nk;

    // epilogue: this warpgroup's rows of the tile's Q buffer (its own
    // wgmmas have read them) take the bf16 output in the swizzled layout
    // TMA stores
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;  // r % 8 == g
        const int off = (j / 8) * FA_BOX + r * 128 + ((j % 8) ^ g) * 16 +
                        4 * t4;
        *reinterpret_cast<uint32_t*>(smem + it * L::TILE + cw * 64 * 128 +
                                     off) =
            pack_bf16x2(o[4 * j + 2 * hh] * inv[hh],
                        o[4 * j + 2 * hh + 1] * inv[hh]);
      }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (t == 0 && iq * FA_BQ + cw * 64 < Sq) {
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store3(&map_o, q_w + cb * FA_BOX, 64 * cb, iq * FA_BQ + cw * 64,
                   b * H + h);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait_read();  // the stores' reads of shared memory
}

// a (planes, rows, D) bf16 tensor as a 3-D map read or written in boxes of
// box_rows x 64 columns with the 128-byte swizzle; past its rows, zeros
bool fa_map(CUtensorMap* map, const void* ptr, int planes, int rows, int D,
            int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The instance that runs head_dim D: 64 up to 64 columns, 128 up to 128
// (0: none). The maps keep the true D, so a box's columns past it arrive
// as zeros (TMA's fill past a map's extent) and are never stored: at D 80
// the second box of a tile holds columns 64..79 and 48 zero columns. Q.K^T
// over zero columns adds nothing, and P.V writes zeros there, which the
// output map's extent keeps out of memory. D must be a multiple of 8 (the
// maps' row stride, 2 D bytes, a multiple of 16).
int fa_instance(int D) {
  if (D < 8 || D > 128 || D % 8) return 0;
  return D <= 64 ? 64 : 128;
}

template <int D, bool ALIBI>
int launch(const CUtensorMap (&maps)[4], const float* slopes, int B, int H,
           int Hkv, int Sq, int Skv, float sm_scale, int causal,
           cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, ALIBI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, FaLayout<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((Sq + 2 * FA_BQ - 1) / (2 * FA_BQ), H, B);
  flash_wgmma_kernel<D, ALIBI><<<grid, FA_THREADS, FaLayout<D>::BYTES, st>>>(
      maps[0], maps[1], maps[2], maps[3], slopes, H, Hkv, Sq, Skv,
      sm_scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k/v (B, Hkv, Skv, D), out (B, H, Sq, D), all contiguous
// bf16 at 16-byte aligned addresses; slopes (H,) f32 or null. D is a
// multiple of 8 up to 128 (fa_instance), H a multiple of Hkv, Sq and Skv at
// least 1.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* slopes,
                                    void* out, int B, int H, int Hkv, int Sq,
                                    int Skv, int D, float sm_scale, int causal,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fa_instance(D) == 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!fa_map(&maps[0], q, B * H, Sq, D, FA_BQ) ||
      !fa_map(&maps[1], k, B * Hkv, Skv, D, FA_BK) ||
      !fa_map(&maps[2], v, B * Hkv, Skv, D, FA_BK) ||
      !fa_map(&maps[3], out, B * H, Sq, D, 64))
    return (int)cudaErrorInvalidValue;
  const float* sl = static_cast<const float*>(slopes);
#define FA_CASE(DD)                                                         \
  if (fa_instance(D) == DD)                                                 \
    return sl ? launch<DD, true>(maps, sl, B, H, Hkv, Sq, Skv, sm_scale,    \
                                 causal, st)                                \
              : launch<DD, false>(maps, sl, B, H, Hkv, Sq, Skv, sm_scale,   \
                                  causal, st);
  FA_CASE(128)
  FA_CASE(64)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
