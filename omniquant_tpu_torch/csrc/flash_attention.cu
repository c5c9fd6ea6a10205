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
// head_dim 128) it does ~2 * 2 * S^2 * D / 2 operations per (batch, head)
// on the tensor cores against 4 * S * D * 2 bytes of q, k, v and out, so it
// is bound by the tensor cores (and, in this first version, by the
// exponentials and the synchronous tile loads between them).
//
// Design: one CTA of 4 warps per (q tile of 64 rows, head, batch); each warp
// owns 16 query rows, holds its q fragments and its f32 output accumulator in
// registers, and loops over 64-key tiles of K and V staged in shared memory
// (rows padded so the fragment loads are free of bank conflicts). Both
// products are mma.sync m16n8k16 bf16 with f32 accumulation; the score
// accumulator layout is reused directly as the A fragment of p.v. Tiles
// strictly above the causal diagonal are skipped. The kv head of query head
// h is h / (H / Hkv); nothing is materialised per query head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, NWARPS = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ slopes,
                 __nv_bfloat16* __restrict__ out, int H, int Hkv, int Sq,
                 int Skv, float sm_scale, int causal) {
  constexpr int LD = D + 8;  // bf16 per smem row
  constexpr int KT = D / 16, DT = D / 8, ST = BKV / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * LD];

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)(b * H + h) * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * Skv * D;
  const int r0 = iq * BQ + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const float alibi = slopes != nullptr ? slopes[h] * sm_scale : 0.f;

  uint32_t qf[KT][4];
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt * 16 + t4 * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + ((e & 1) ? 8 : 0), cc = c + ((e & 2) ? 8 : 0);
      qf[kt][e] = r < Sq ? pack_raw(qb[(size_t)r * D + cc],
                                    qb[(size_t)r * D + cc + 1])
                         : pack_raw(zero, zero);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  int n_kt = (Skv + BKV - 1) / BKV;
  if (causal) n_kt = min(n_kt, (iq * BQ + BQ - 1) / BKV + 1);

  for (int jt = 0; jt < n_kt; ++jt) {
    __syncthreads();
    for (int i = tid; i < BKV * (D / 8); i += NWARPS * 32) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const int kr = jt * BKV + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (kr < Skv) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)kr * D + c8);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)kr * D + c8);
      }
      *reinterpret_cast<uint4*>(&ks[r * LD + c8]) = kv4;
      *reinterpret_cast<uint4*>(&vs[r * LD + c8]) = vv4;
    }
    __syncthreads();

    float s[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + g) * LD + kt * 16 + t4 * 2];
        mma_16816(s[nt], qf[kt], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = jt * BKV + nt * 8 + t4 * 2 + (e & 1);
        const int row = r0 + ((e & 2) ? 8 : 0);
        float val = s[nt][e] * sm_scale + alibi * (float)key;
        const bool ok = key < Skv && (!causal || key <= row);
        val = ok ? val : NEG_INF;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // o += p . v, with p's score-accumulator layout reused as A fragments
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int kr = kk * 16 + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int c = dt * 8 + g;
        const uint32_t b0 = pack_raw(vs[kr * LD + c], vs[(kr + 1) * LD + c]);
        const uint32_t b1 =
            pack_raw(vs[(kr + 8) * LD + c], vs[(kr + 9) * LD + c]);
        mma_16816(o[dt], a, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
  __nv_bfloat16* ob = out + (size_t)(b * H + h) * Sq * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)r0 * D + c]) =
          __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)(r0 + 8) * D + c]) =
          __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* slopes,
            void* out, int B, int H, int Hkv, int Sq, int Skv, float sm_scale,
            int causal, cudaStream_t st) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NWARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(slopes),
      static_cast<__nv_bfloat16*>(out), H, Hkv, Sq, Skv, sm_scale, causal);
}

}  // namespace

// q (B, H, Sq, D), k/v (B, Hkv, Skv, D), out (B, H, Sq, D), all contiguous
// bf16; slopes (H,) f32 or null. D is 64 or 128.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* slopes,
                                    void* out, int B, int H, int Hkv, int Sq,
                                    int Skv, int D, float sm_scale, int causal,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    launch<128>(q, k, v, slopes, out, B, H, Hkv, Sq, Skv, sm_scale, causal, st);
  else if (D == 64)
    launch<64>(q, k, v, slopes, out, B, H, Hkv, Sq, Skv, sm_scale, causal, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
