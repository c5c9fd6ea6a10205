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
// the card's ~295 operations per byte; at the serving shapes (batch 32, 32
// heads, hd 128, window 256) the codes and scales are ~70 MB at most, 0.021
// ms at 3.35 TB/s, and the kernel reads only the live part of each window.
//
// Design (first version, simple): one CTA of 128 threads per (kv head,
// slot). It loops over the live positions in chunks of 128: the chunk's K
// and V codes are loaded as 16-byte vectors into shared memory (rows padded
// to 144 bytes so the row-per-thread reads are free of bank conflicts),
// each thread computes the f32 scores of one position for the n_rep query
// heads, the block reduces the chunk's max and sum, and each thread then
// accumulates one output dimension over the chunk with p * vs kept in f32.
// It stops at lengths[b] instead of reading the whole bucket; the ring is a
// last chunk read from the ring buffers. Decode has one query per head, so
// tensor cores buy nothing. Not yet done: splitting a long window across
// CTAs (flash-decoding) and overlapping the next chunk's loads with this
// chunk's arithmetic (cp.async).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;        // positions per chunk = threads per CTA
constexpr int NWARPS = T / 32;
constexpr int MAX_REP = 8;    // query heads per kv head
constexpr float NEG = -1e30f;

template <int HD>
struct Smem {
  int8_t k[T][HD + 16];
  int8_t v[T][HD + 16];
  float ks[T];
  float vs[T];
  float q[MAX_REP][HD];
  float pv[MAX_REP][T];  // p * vs of the chunk
  float red[MAX_REP][NWARPS];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Attend rows [0, n) of one chunk (n >= 1): codes (n, HD) int8 and scales
// (n,) f32 at the given addresses. Every thread keeps the running (m, l)
// of each query head; thread d < HD keeps output dimension d in acc.
template <int HD>
__device__ void attend_chunk(Smem<HD>& sm, const int8_t* kc, const float* ks,
                             const int8_t* vc, const float* vs, int n,
                             int n_rep, float score_scale,
                             float (&m_run)[MAX_REP], float (&l_run)[MAX_REP],
                             float (&acc)[MAX_REP]) {
  constexpr int VPR = HD / 16;  // 16-byte vectors per row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the previous chunk's readers are done
  for (int i = tid; i < T * VPR; i += T) {
    const int r = i / VPR, c = (i % VPR) * 16;
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    if (r < n) {
      kk = *reinterpret_cast<const uint4*>(kc + (size_t)r * HD + c);
      vv = *reinterpret_cast<const uint4*>(vc + (size_t)r * HD + c);
    }
    *reinterpret_cast<uint4*>(&sm.k[r][c]) = kk;
    *reinterpret_cast<uint4*>(&sm.v[r][c]) = vv;
  }
  if (tid < n) {
    sm.ks[tid] = ks[tid];
    sm.vs[tid] = vs[tid];
  }
  __syncthreads();

  // scores of position tid
  float s[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) s[r] = 0.f;
  if (tid < n) {
#pragma unroll 4
    for (int c = 0; c < HD; c += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(&sm.k[tid][c]);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float kv =
            (float)((int32_t)(words[e >> 2] << (24 - 8 * (e & 3))) >> 24);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < n_rep) s[r] = fmaf(sm.q[r][c + e], kv, s[r]);
      }
    }
    const float f = sm.ks[tid] * score_scale;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) s[r] *= f;
  } else {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) s[r] = NEG;
  }

  float m_new[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    const float mx = warp_max(s[r]);
    if (lane == 0) sm.red[r][warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    float mx = sm.red[r][0];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, sm.red[r][w]);
    m_new[r] = fmaxf(m_run[r], mx);
  }
  float psum[MAX_REP];
  const float vsc = tid < n ? sm.vs[tid] : 0.f;
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    const float p = tid < n ? __expf(s[r] - m_new[r]) : 0.f;
    sm.pv[r][tid] = p * vsc;
    psum[r] = warp_sum(p);
  }
  __syncthreads();  // every thread has read the chunk max
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    if (lane == 0) sm.red[r][warp] = psum[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) l += sm.red[r][w];
    const float alpha = __expf(m_run[r] - m_new[r]);
    l_run[r] = l_run[r] * alpha + l;
    acc[r] *= alpha;
    m_run[r] = m_new[r];
  }
  if (tid < HD) {
    for (int j = 0; j < n; ++j) {
      const float vj = (float)sm.v[j][tid];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < n_rep) acc[r] = fmaf(sm.pv[r][j], vj, acc[r]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(T)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kc, const float* __restrict__ ks,
                   const int8_t* __restrict__ vc, const float* __restrict__ vs,
                   const int32_t* __restrict__ lengths,
                   const int8_t* __restrict__ rkc,
                   const float* __restrict__ rks,
                   const int8_t* __restrict__ rvc,
                   const float* __restrict__ rvs, __nv_bfloat16* __restrict__ out,
                   int n_kv, int n_rep, int max_len, int kv_len, int R,
                   int ring_n, float score_scale) {
  __shared__ __align__(16) Smem<HD> sm;
  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t head0 = (size_t)b * n_kv * n_rep + (size_t)hk * n_rep;
  for (int i = tid; i < n_rep * HD; i += T)
    sm.q[i / HD][i % HD] = __bfloat162float(q[head0 * HD + i]);

  float m_run[MAX_REP], l_run[MAX_REP], acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m_run[r] = NEG;
    l_run[r] = 0.f;
    acc[r] = 0.f;
  }
  // positions 0..lengths[b] of the window [0, kv_len)
  const int live = max(0, min(lengths[b] + 1, kv_len));
  const size_t base = ((size_t)b * n_kv + hk) * max_len;
  for (int c0 = 0; c0 < live; c0 += T)
    attend_chunk<HD>(sm, kc + (base + c0) * HD, ks + base + c0,
                     vc + (base + c0) * HD, vs + base + c0, min(T, live - c0),
                     n_rep, score_scale, m_run, l_run, acc);
  if (ring_n >= 0) {
    const int staged = min(ring_n + 1, R);
    const size_t rb = ((size_t)b * n_kv + hk) * R;
    for (int c0 = 0; c0 < staged; c0 += T)
      attend_chunk<HD>(sm, rkc + (rb + c0) * HD, rks + rb + c0,
                       rvc + (rb + c0) * HD, rvs + rb + c0,
                       min(T, staged - c0), n_rep, score_scale, m_run, l_run,
                       acc);
  }
  if (tid < HD) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < n_rep)
        out[(head0 + r) * HD + tid] =
            __float2bfloat16(acc[r] / fmaxf(l_run[r], 1e-30f));
  }
}

template <int HD>
void launch(const void* q, const void* kc, const void* ks, const void* vc,
            const void* vs, const void* lengths, const void* rkc,
            const void* rks, const void* rvc, const void* rvs, void* out,
            int B, int n_kv, int n_rep, int max_len, int kv_len, int R,
            int ring_n, float score_scale, cudaStream_t st) {
  decode_attn_kernel<HD><<<dim3(n_kv, B), T, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int32_t*>(lengths),
      static_cast<const int8_t*>(rkc), static_cast<const float*>(rks),
      static_cast<const int8_t*>(rvc), static_cast<const float*>(rvs),
      static_cast<__nv_bfloat16*>(out), n_kv, n_rep, max_len, kv_len, R,
      ring_n, score_scale);
}

}  // namespace

// q (B, n_kv * n_rep, hd) bf16; k/v codes (B, n_kv, max_len, hd) int8; k/v
// scales (B, n_kv, max_len) f32; lengths (B,) int32; ring codes (B, n_kv,
// R, hd) int8 and scales (B, n_kv, R) f32, read only when ring_n >= 0; out
// (B, n_kv * n_rep, hd) bf16. All contiguous; hd is 64 or 128, n_rep <= 8.
extern "C" int decode_attention_int8(
    const void* q, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* lengths, const void* rkc, const void* rks,
    const void* rvc, const void* rvs, void* out, int B, int n_kv, int n_rep,
    int hd, int max_len, int kv_len, int R, int ring_n, float score_scale,
    void* stream) {
  if (n_rep < 1 || n_rep > MAX_REP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    launch<128>(q, kc, ks, vc, vs, lengths, rkc, rks, rvc, rvs, out, B, n_kv,
                n_rep, max_len, kv_len, R, ring_n, score_scale, st);
  else if (hd == 64)
    launch<64>(q, kc, ks, vc, vs, lengths, rkc, rks, rvc, rvs, out, B, n_kv,
               n_rep, max_len, kv_len, R, ring_n, score_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
