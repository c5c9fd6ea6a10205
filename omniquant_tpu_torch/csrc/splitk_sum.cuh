// The split-K second pass shared by K1's pairs decode tile (quant_matmul.cu)
// and K7 (quant_matmul_int.cu): the slices' f32 partial sums in a (splits,
// m, N) workspace, added in slice order (so two calls give the same bits),
// times the row scale xs[row] where xs is given, rounded to bf16 once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

__global__ void __launch_bounds__(256)
splitk_sum_kernel(const float* __restrict__ part,
                  const float* __restrict__ xs,
                  __nv_bfloat16* __restrict__ y, int m, int N, int splits) {
  const long long pairs = (long long)m * N / 2;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    const size_t e = (size_t)i * 2;
    float2 s = make_float2(0.f, 0.f);
    for (int k = 0; k < splits; ++k) {
      const float2 p =
          *reinterpret_cast<const float2*>(&part[(size_t)k * m * N + e]);
      s.x += p.x;
      s.y += p.y;
    }
    const float sc = xs ? xs[e / N] : 1.f;  // x * 1.f keeps x's bits
    *reinterpret_cast<__nv_bfloat162*>(&y[e]) =
        __floats2bfloat162_rn(s.x * sc, s.y * sc);
  }
}

// N even; xs may be nullptr. Returns cudaGetLastError().
int splitk_sum(const float* part, const float* xs, __nv_bfloat16* y, int m,
               int N, int splits, cudaStream_t st) {
  const long long pairs = (long long)m * N / 2;
  const int blocks = (int)std::min<long long>((pairs + 255) / 256, 132LL * 8);
  splitk_sum_kernel<<<blocks, 256, 0, st>>>(part, xs, y, m, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace
