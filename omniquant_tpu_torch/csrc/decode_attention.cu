// One-query decode attention over an int8 KV cache for sm_90a (K6).
//
// Replaces the TPU kernel omniquant_tpu/kernels/decode_attention.py::
// decode_attention_int8 (_kernel, pallas_call at :284), with its semantics:
// per query head h (kv head h / n_rep), scores (q . k_code) * (ks *
// score_scale) over the cache positions 0..lengths[b] of the window
// [0, kv_len), then, with a ring, over ring positions 0..ring_n; an f32
// online softmax; the output sum_j (p_j * vs_j) * v_code_j / max(l, 1e-30),
// rounded to bf16. The codes are never dequantized: the per-token scales
// fold into the scores and the probabilities.
//
// What bounds it on an H100: bytes. Each position read costs 2 * hd code
// bytes and 8 scale bytes for ~4 * hd operations per query head, far below
// the card's ~295 operations per byte. At engine D's shape (batch 8, 32 kv
// heads, hd 128, a 2048 window, lengths around 1024) the live codes and
// scales are ~77 MB, 0.021 ms at 3.35 TB/s; at engine C's (batch 32, window
// 256) ~35 MB. Reaching that rate takes ~20 KB or more of loads in flight
// on every SM at all times, and work for every SM however unequal the
// slots' lengths are.
//
// Design (flash-decoding):
//   * A CTA of 128 threads takes one (window split, kv head and group of
//     query heads, slot): a span of `per` positions (a multiple of the
//     chunk, from kernels/decode_attention.py::decode_attention_plan, which
//     never reads lengths) for up to MAX_REP = 8 query heads of the kv head.
//     A kv head with more (Falcon: 71 on one kv head for 7B, 16 for 40B,
//     29 for 180B) spreads them over ceil(n_rep / 8) head groups, one CTA
//     each along the grid's y with the kv heads; the last group is masked.
//     Each group keeps its own online softmax and its own partials and
//     ticket, so its merge is the same as a kv head's with <= 8 query
//     heads. The groups of a kv head each read its window: at n_rep 71, 9
//     reads of every code byte, all but the first mostly from L2 (the
//     groups of a split run side by side). The ring is a split of its own,
//     the grid's last. A CTA whose split starts past the slot's live
//     positions (read from lengths[b] on the device) leaves at once, so the
//     grid is sized for the window and costs only the live part.
//   * The split's K and V code rows and their scales go through a ring of
//     two chunks in shared memory by cp.async (16 bytes a code piece, 4 a
//     scale); the next chunk is issued before this one is computed, and
//     six CTAs share an SM at hd 128 and one query head (the plan asks the
//     card how many), so every SM keeps loads in flight. A chunk is 64 rows
//     at hd 128 (128 at hd 64 and 80): 8-10 KB of K and of V codes.
//   * No block-wide reduction per chunk: warp w owns a quarter of each
//     chunk's rows, and keeps its own online softmax (m, l) and output sums.
//     Scores: two lanes a row at hd 128 (one at hd 64 and 80), each 64 (80)
//     code bytes from K rows of an odd number of 16-byte pieces (hd 64 and
//     128 padded by 16 bytes: free of bank conflicts), against q in f32 in
//     shared memory. P.V: each lane takes 4 output dimensions of a V row
//     (one 32-bit read a row; two rows a step at hd 64; at hd 80 20 lanes a
//     row, the other 12 idle) and walks the warp's rows, p * vs taken from
//     the row's lane by a shuffle.
//     The codes become floats by a byte permute into the mantissa of 2^23
//     and one subtraction (exact), not by the slower int-to-float
//     conversion. The four warps' (m, l, sums) are combined once a split.
//   * Merge inside the launch, in a fixed order: with more than one live
//     split, each writes its f32 partial (m, l, acc) per query head to a
//     workspace, fences and takes its (slot, kv head)'s ticket; the one
//     that takes the last ticket (the count of live splits comes from
//     lengths[b] and the ring on the device) resets it to 0 and merges the
//     partials in split order, window splits first, then the ring. Two
//     calls give the same bits; no float atomics, no memset. A slot with
//     one live split writes its output directly; an idle one (no live
//     position, no ring) gets 0 from its first split.
//   * p * vs stays in f32, as the plain version's dequantized f32 values.
//
// What is left (NVIDIA H100 80GB HBM3): a variant that loads every chunk
// but computes nothing runs about as fast as the kernel, and one that does
// neither still takes a quarter of its time (CTA starts, partials, merges),
// so the kernel runs at the rate of its own loads. Under chip_smoke.py's
// timer those loads share the memory with the write-back of the zeroed L2
// flush buffer. Not done: loads by TMA bulk copies onto an mbarrier (fewer
// copy instructions, no padding), scores and P.V on the tensor cores (at
// one query a head they buy little), q in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int STAGES = 2;  // chunks in the ring (3 or 4: fewer CTAs, slower)
constexpr int MAX_REP = 8;  // query heads a CTA holds (a head group)
constexpr float NEG = -1e30f;

// Lanes that score one K row: two at hd 128 (64 code bytes each), one at
// hd 64 and 80 (one lane reads a whole 80-byte row: 40 bytes a lane would
// not be whole 16-byte pieces). kernels/decode_attention.py::decode_chunk
// follows the same rule.
__host__ __device__ constexpr int lanes_per_k_row(int hd) {
  return hd == 128 ? 2 : 1;
}
__host__ __device__ constexpr int chunk_rows(int hd) {
  return THREADS / lanes_per_k_row(hd);
}

// The geometry for head dim HD (64, 80 or 128) and up to REP query heads;
// kernels/decode_attention.py::decode_geometry models it.
template <int HD, int REP>
struct Geo {
  static constexpr int TPR = lanes_per_k_row(HD);  // lanes a K row (scores)
  static constexpr int CH = chunk_rows(HD);   // rows a chunk: 64 or 128
  static constexpr int RPW = CH / NWARPS;     // rows a warp owns per chunk
  // K row stride in bytes: an odd number of 16-byte pieces, so the 8 lanes
  // of a quarter warp reading 16 bytes of 8 rows hit 8 distinct bank
  // quads (80 at hd 64 and 80, 144 at hd 128)
  static constexpr int KRS = (HD / 16) % 2 ? HD : HD + 16;
  static constexpr int LPR = HD / 4;          // lanes a V row (P.V)
  // V rows a warp step: 2 at hd 64, 1 at 80 (lanes 20..31 repeat lanes
  // 0..11 on the same row; their sums are never stored) and 128
  static constexpr int RPI = 32 / LPR;
  static constexpr int QS = HD + 8;           // q row stride in floats
  static constexpr int QHALF = HD / TPR + 4;  // q offset of a lane's half
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = CH * KRS;
  static constexpr int KS_OFF = V_OFF + CH * HD;
  static constexpr int VS_OFF = KS_OFF + CH * 4;
  static constexpr int STAGE = VS_OFF + CH * 4;  // bytes of one chunk
  static constexpr int Q_OFF = STAGES * STAGE;
  static constexpr int FLAG_OFF = Q_OFF + REP * QS * 4;
  static constexpr int SMEM = FLAG_OFF + 16;
  // the four warps' (m, l, sums), over the ring once the split is done
  static constexpr int RED_BYTES = NWARPS * REP * (HD + 2) * 4;
  static_assert(RED_BYTES <= Q_OFF, "the warps' sums must fit the ring");
  static_assert(HD == 64 || HD == 80 || HD == 128, "head dim 64, 80, 128");
  static_assert(RPW % RPI == 0 && HD % 16 == 0, "whole steps and pieces");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Code e (0..3) of the word u = w ^ 0x80808080 (the codes biased to
// unsigned) as a float: the byte in the mantissa of 2^23, less 2^23 + 128.
__device__ __forceinline__ float code_f(uint32_t u, int e) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | e)) -
         8388736.f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The sum over the warp's rows of a value every lane of a row holds alike.
template <int TPR>
__device__ __forceinline__ float rows_sum(float x) {
#pragma unroll
  for (int o = 16; o >= TPR; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int REP>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kc, const float* __restrict__ ks,
                   const int8_t* __restrict__ vc, const float* __restrict__ vs,
                   const int32_t* __restrict__ lengths,
                   const int8_t* __restrict__ rkc,
                   const float* __restrict__ rks,
                   const int8_t* __restrict__ rvc,
                   const float* __restrict__ rvs, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ tickets,
                   int n_kv, int n_rep, int max_len, int kv_len, int R,
                   int ring_n, int per, int n_win, float score_scale) {
  using G = Geo<HD, REP>;
  extern __shared__ __align__(16) uint8_t smem[];
  // grid: (split, kv head x head group, slot); a group holds REP heads
  const int n_groups = (n_rep + REP - 1) / REP;
  const int s = blockIdx.x, hk = blockIdx.y / n_groups, b = blockIdx.z;
  const int grp = blockIdx.y - hk * n_groups;
  const int nq = min(REP, n_rep - grp * REP);  // this group's query heads
  const int cap = min(REP, n_rep);             // heads a group's partial holds
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * n_kv + hk;                       // the kv rows
  const int bg = b * gridDim.y + blockIdx.y;          // partials, ticket
  const int n_splits = gridDim.x;

  // live positions of the window and of the ring, and this split's rows
  const int live = max(0, min(lengths[b] + 1, kv_len));
  const int ring_live = ring_n >= 0 ? min(ring_n + 1, R) : 0;
  const int live_win = (live + per - 1) / per;
  const int n_live = live_win + (ring_live > 0);
  const bool is_ring = s == n_win;
  const int n_rows = is_ring ? ring_live : min(per, live - s * per);
  const size_t head0 = (size_t)bh * n_rep + grp * REP;  // first query head
  if (n_rows <= 0) {
    if (s == 0 && n_live == 0)  // an idle slot with no ring: 0
      for (int i = tid; i < nq * HD; i += THREADS)
        out[head0 * HD + i] = __float2bfloat16(0.f);
    return;
  }
  const size_t row0 = is_ring ? (size_t)bh * R
                              : (size_t)bh * max_len + (size_t)s * per;
  const int8_t* kp = (is_ring ? rkc : kc) + row0 * HD;
  const int8_t* vp = (is_ring ? rvc : vc) + row0 * HD;
  const float* ksp = (is_ring ? rks : ks) + row0;
  const float* vsp = (is_ring ? rvs : vs) + row0;
  const int n_ch = (n_rows + G::CH - 1) / G::CH;

  auto issue = [&](int c) {
    uint8_t* st = smem + (c % STAGES) * G::STAGE;
    const int r0 = c * G::CH, n = min(G::CH, n_rows - r0);
    constexpr int VPR = HD / 16;  // 16-byte pieces a row
    for (int i = tid; i < n * VPR; i += THREADS) {
      const int r = i / VPR, c16 = (i % VPR) * 16;
      const size_t src = (size_t)(r0 + r) * HD + c16;
      cp_async16(st + G::K_OFF + r * G::KRS + c16, kp + src);
      cp_async16(st + G::V_OFF + r * HD + c16, vp + src);
    }
    for (int i = tid; i < n; i += THREADS) {
      cp_async4(st + G::KS_OFF + 4 * i, ksp + r0 + i);
      cp_async4(st + G::VS_OFF + 4 * i, vsp + r0 + i);
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_ch) issue(c);
    cp_async_commit();
  }
  // q in f32; a lane's half of the row sits 4 floats past the other's, so
  // the two lanes of a K row read different banks
  float* sq = reinterpret_cast<float*>(smem + G::Q_OFF);
  for (int i = tid; i < REP * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    sq[r * G::QS + (d / (HD / G::TPR)) * G::QHALF + d % (HD / G::TPR)] =
        r < nq ? __bfloat162float(q[head0 * HD + i]) : 0.f;
  }

  float m_run[REP], l_run[REP], acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = NEG;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
  const int my_row = warp * G::RPW + lane / G::TPR;  // scores: row, half
  const int side = lane % G::TPR;

  for (int c = 0; c < n_ch; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + STAGES - 1 < n_ch) issue(c + STAGES - 1);
    cp_async_commit();
    const uint8_t* st = smem + (c % STAGES) * G::STAGE;
    const int n = min(G::CH, n_rows - c * G::CH);
    const bool valid = my_row < n;

    // scores of my_row, this lane's half of the dimensions
    float sc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) sc[r] = 0.f;
    const uint8_t* krow = st + G::K_OFF + my_row * G::KRS + side * (HD / G::TPR);
    const float* qh = sq + side * G::QHALF;
#pragma unroll
    for (int c16 = 0; c16 < HD / G::TPR; c16 += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(krow + c16);
      const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                 w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = code_f(words[wi], e);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qh + r * G::QS + c16 + 4 * wi);
          sc[r] = fmaf(qq.x, f[0], sc[r]);
          sc[r] = fmaf(qq.y, f[1], sc[r]);
          sc[r] = fmaf(qq.z, f[2], sc[r]);
          sc[r] = fmaf(qq.w, f[3], sc[r]);
        }
      }
    }
    const float* sks = reinterpret_cast<const float*>(st + G::KS_OFF);
    const float* svs = reinterpret_cast<const float*>(st + G::VS_OFF);
    const float fk = valid ? sks[my_row] * score_scale : 0.f;
    const float vsc = valid ? svs[my_row] : 0.f;
    float pv[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (G::TPR == 2) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], 1);
      sc[r] = valid ? sc[r] * fk : NEG;
      const float m_new = fmaxf(m_run[r], warp_max(sc[r]));
      const float p = valid ? __expf(sc[r] - m_new) : 0.f;
      const float alpha = __expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + rows_sum<G::TPR>(p);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha;
      m_run[r] = m_new;
      pv[r] = p * vsc;
    }

    // P.V over the warp's rows: lane takes dimensions 4 * (lane % LPR)..+3
    const uint8_t* vrow0 = st + G::V_OFF + (warp * G::RPW) * HD +
                           4 * (lane % G::LPR);
#pragma unroll 4
    for (int jj = 0; jj < G::RPW; jj += G::RPI) {
      const int j = jj + (lane / G::LPR) % G::RPI;  // the warp's row
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(vrow0 + j * HD) ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = code_f(u, e);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pv[r], j * G::TPR);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(pj, f[e], acc[r][e]);
      }
    }
  }

  // combine the four warps' (m, l, sums) into the split's
  __syncthreads();  // every warp is done with the ring
  float* wacc = reinterpret_cast<float*>(smem);          // [warp][REP][HD]
  float* wml = wacc + NWARPS * REP * HD;                 // [warp][REP][2]
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (G::RPI == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    }
    if (lane < G::LPR)
      *reinterpret_cast<float4*>(wacc + (warp * REP + r) * HD + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (lane == 0) {
      wml[(warp * REP + r) * 2] = m_run[r];
      wml[(warp * REP + r) * 2 + 1] = l_run[r];
    }
  }
  __syncthreads();
  const size_t n_acc = (size_t)gridDim.z * gridDim.y * n_splits * cap * HD;
  for (int i = tid; i < nq * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, wml[(w * REP + r) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float a = __expf(wml[(w * REP + r) * 2] - M);
      L = fmaf(wml[(w * REP + r) * 2 + 1], a, L);
      A = fmaf(wacc[(w * REP + r) * HD + d], a, A);
    }
    if (n_live == 1) {
      out[head0 * HD + i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      const size_t part = ((size_t)bg * n_splits + s) * cap + r;
      ws[part * HD + d] = A;
      if (d == 0) {
        ws[n_acc + 2 * part] = M;
        ws[n_acc + 2 * part + 1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last live split to take the ticket merges them all, in split order
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + G::FLAG_OFF);
  if (tid == 0) *flag = atomicAdd(tickets + bg, 1);
  __syncthreads();
  if (*flag != n_live - 1) return;
  __threadfence();
  if (tid == 0) tickets[bg] = 0;
  for (int i = tid; i < nq * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float M = NEG;
    for (int k = 0; k < n_live; ++k) {
      const int sk = k < live_win ? k : n_win;  // the ring is merged last
      const size_t part = ((size_t)bg * n_splits + sk) * cap + r;
      M = fmaxf(M, __ldcg(ws + n_acc + 2 * part));
    }
    float L = 0.f, A = 0.f;
#pragma unroll 4
    for (int k = 0; k < n_live; ++k) {
      const int sk = k < live_win ? k : n_win;
      const size_t part = ((size_t)bg * n_splits + sk) * cap + r;
      const float a = __expf(__ldcg(ws + n_acc + 2 * part) - M);
      L = fmaf(__ldcg(ws + n_acc + 2 * part + 1), a, L);
      A = fmaf(__ldcg(ws + part * HD + d), a, A);
    }
    out[head0 * HD + i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

// Let the instance take its dynamic shared memory (above 48 KB only after
// this attribute); then its shared memory or the CTAs of it an SM holds.
template <int HD, int REP>
int info(bool ctas) {
  constexpr int smem = Geo<HD, REP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<HD, REP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  if (!ctas) return smem;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attn_kernel<HD, REP>, THREADS, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <int HD, int REP>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* lengths, const void* rkc,
           const void* rks, const void* rvc, const void* rvs, void* out,
           void* ws, void* tickets, int B, int n_kv, int n_rep, int max_len,
           int kv_len, int R, int ring_n, int per, int n_win,
           float score_scale, cudaStream_t st) {
  static const int ok = info<HD, REP>(false);
  if (ok < 0) return -ok;
  const dim3 grid(n_win + (ring_n >= 0 ? 1 : 0),
                  n_kv * ((n_rep + REP - 1) / REP), B);
  decode_attn_kernel<HD, REP><<<grid, THREADS, Geo<HD, REP>::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int32_t*>(lengths),
      static_cast<const int8_t*>(rkc), static_cast<const float*>(rks),
      static_cast<const int8_t*>(rvc), static_cast<const float*>(rvs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), n_kv, n_rep, max_len, kv_len, R, ring_n,
      per, n_win, score_scale);
  return (int)cudaGetLastError();
}

// The instance for n_rep >= 1 query heads a kv head: the least power of
// two that holds them, at most MAX_REP (more take head groups of MAX_REP).
int rep_class(int n_rep) {
  return n_rep <= 1 ? 1 : n_rep <= 2 ? 2 : n_rep <= 4 ? 4 : MAX_REP;
}

}  // namespace

// q (B, n_kv * n_rep, hd) bf16; k/v codes (B, n_kv, max_len, hd) int8; k/v
// scales (B, n_kv, max_len) f32; lengths (B,) int32; ring codes (B, n_kv,
// R, hd) int8 and scales (B, n_kv, R) f32, read only when ring_n >= 0; out
// (B, n_kv * n_rep, hd) bf16. All contiguous; hd is 64, 80 or 128, n_rep >= 1
// (n_rep > 8: G = ceil(n_rep / 8) head groups of up to 8; else G = 1).
// The window splits into n_win spans of `per` positions (a multiple of the
// chunk: 64 rows at hd 128, 128 at hd 64 and 80), and the ring is one
// more. With more than one split, ws holds (B, n_kv, G, splits, C, hd) f32
// sums and then (B, n_kv, G, splits, C, 2) f32 (m, l), C = min(n_rep, 8),
// and tickets is a zeroed int32 per (slot, kv head, group), left zeroed.
extern "C" int decode_attention_int8(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* lengths, const void* rkc, const void* rks,
    const void* rvc, const void* rvs, void* out, void* ws, void* tickets,
    int B, int n_kv, int n_rep, int hd, int max_len, int kv_len, int R,
    int ring_n, int per, int n_win, float score_scale, void* stream) {
  if (n_rep < 1 || n_kv < 1 ||
      (long long)n_kv * ((n_rep + MAX_REP - 1) / MAX_REP) > 65535 ||
      (hd != 64 && hd != 80 && hd != 128) || n_win < 1 || per < 1 ||
      per % chunk_rows(hd) ||
      (n_win + (ring_n >= 0) > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K6_LAUNCH(HD, REP)                                                 \
  launch<HD, REP>(q, kc, ks, vc, vs, lengths, rkc, rks, rvc, rvs, out, ws,  \
                  tickets, B, n_kv, n_rep, max_len, kv_len, R, ring_n, per, \
                  n_win, score_scale, st)
  switch (hd * 16 + rep_class(n_rep)) {
    case 128 * 16 + 1: return K6_LAUNCH(128, 1);
    case 128 * 16 + 2: return K6_LAUNCH(128, 2);
    case 128 * 16 + 4: return K6_LAUNCH(128, 4);
    case 128 * 16 + 8: return K6_LAUNCH(128, 8);
    case 64 * 16 + 1: return K6_LAUNCH(64, 1);
    case 64 * 16 + 2: return K6_LAUNCH(64, 2);
    case 64 * 16 + 4: return K6_LAUNCH(64, 4);
    case 64 * 16 + 8: return K6_LAUNCH(64, 8);
    case 80 * 16 + 1: return K6_LAUNCH(80, 1);
    case 80 * 16 + 2: return K6_LAUNCH(80, 2);
    case 80 * 16 + 4: return K6_LAUNCH(80, 4);
    case 80 * 16 + 8: return K6_LAUNCH(80, 8);
  }
#undef K6_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The kernel for head dim hd and n_rep >= 1 query heads a kv head (the
// instance of rep_class(n_rep)): its shared memory (ctas == 0) or the CTAs
// of it an SM holds (ctas != 0), or minus a CUDA error.
extern "C" int decode_attention_info(int hd, int n_rep, int ctas, void*) {
  if (n_rep < 1) return -(int)cudaErrorInvalidValue;
  switch (hd * 16 + rep_class(n_rep)) {
    case 128 * 16 + 1: return info<128, 1>(ctas != 0);
    case 128 * 16 + 2: return info<128, 2>(ctas != 0);
    case 128 * 16 + 4: return info<128, 4>(ctas != 0);
    case 128 * 16 + 8: return info<128, 8>(ctas != 0);
    case 64 * 16 + 1: return info<64, 1>(ctas != 0);
    case 64 * 16 + 2: return info<64, 2>(ctas != 0);
    case 64 * 16 + 4: return info<64, 4>(ctas != 0);
    case 64 * 16 + 8: return info<64, 8>(ctas != 0);
    case 80 * 16 + 1: return info<80, 1>(ctas != 0);
    case 80 * 16 + 2: return info<80, 2>(ctas != 0);
    case 80 * 16 + 4: return info<80, 4>(ctas != 0);
    case 80 * 16 + 8: return info<80, 8>(ctas != 0);
  }
  return -(int)cudaErrorInvalidValue;
}
