// In-place KV-cache writes for sm_90a: whole prefilled sequences (K3) and
// one decode row per slot (K4, "rows" kind).
//
// Replace the TPU kernels omniquant_tpu/kernels/kv_update.py::
// kv_cache_prefill_write (_kv_prefill / _prefill_kernel, pallas_call at :230)
// and kv_cache_write (_kv_write / _write_kernel, pallas_call at :123).
//
// What bounds them on an H100: they only move bytes, each new row read once
// and written once (a decode write of 32 slots x 32 heads x 128 bf16 is
// 256 KB; a prefill write of 32 x 32 x 128 x 128 bf16 is 32 MB), so memory
// bandwidth, and for the small decode write, launch latency.
//
// Design: a grid-stride copy of 16-byte vectors straight into the target
// rows; a decode write covers the K and the V cache in one launch. The TPU kernel read-modified-wrote whole 8-row tiles because its DMA
// engine needs (8, 128)-aligned slices; here each new row is stored alone,
// and the rest of the cache is never touched. A row whose slot or position
// lies outside the cache is dropped, never clamped (a clamped write would
// overwrite a live row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void prefill_kernel(const uint4* __restrict__ src,
                               uint4* __restrict__ dst,
                               const int32_t* __restrict__ slots, int N, int H,
                               int S, int Sp, int B, int row_vecs) {
  const long long total = (long long)N * H * Sp * row_vecs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % row_vecs);
    const long long r = i / row_vecs;  // (n * H + h) * Sp + s
    const int s = (int)(r % Sp);
    const long long nh = r / Sp;
    const int h = (int)(nh % H), n = (int)(nh / H);
    const int slot = slots[n];
    if (slot < 0 || slot >= B) continue;
    dst[(((long long)slot * H + h) * S + s) * row_vecs + c] = src[i];
  }
}

// Two caches at once: vectors [0, per) go to cache 0, [per, 2 per) to
// cache 1 (ncache is 1 or 2).
__global__ void write_rows_kernel(const uint4* __restrict__ src0,
                                  uint4* __restrict__ dst0,
                                  const uint4* __restrict__ src1,
                                  uint4* __restrict__ dst1,
                                  const int32_t* __restrict__ lengths,
                                  int ncache, int B, int H, int S,
                                  int row_vecs) {
  const long long per = (long long)B * H * row_vecs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < ncache * per; i += (long long)gridDim.x * blockDim.x) {
    const bool second = i >= per;
    const long long j = second ? i - per : i;
    const int c = (int)(j % row_vecs);
    const long long bh = j / row_vecs;  // b * H + h
    const int b = (int)(bh / H);
    const int pos = lengths[b];
    if (pos < 0 || pos >= S) continue;
    (second ? dst1 : dst0)[(bh * S + pos) * row_vecs + c] =
        (second ? src1 : src0)[j];
  }
}

int blocks_for(long long total) {
  const long long b = (total + 255) / 256;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

}  // namespace

// cache (B, H, S, row) <- new (N, H, Sp, row) at cache[slots[n], :, :Sp];
// rows are row_vecs 16-byte vectors.
extern "C" int kv_prefill_write(const void* src, void* dst, const void* slots,
                                int N, int H, int S, int Sp, int B,
                                int row_vecs, void* stream) {
  const long long total = (long long)N * H * Sp * row_vecs;
  prefill_kernel<<<blocks_for(total), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      static_cast<const int32_t*>(slots), N, H, S, Sp, B, row_vecs);
  return (int)cudaGetLastError();
}

// cache_i (B, H, S, row) <- new_i (B, H, row) at cache_i[b, :, lengths[b]]
// for i < ncache (1 or 2; src1/dst1 unused at 1).
extern "C" int kv_write_rows(const void* src0, void* dst0, const void* src1,
                             void* dst1, const void* lengths, int ncache,
                             int B, int H, int S, int row_vecs, void* stream) {
  if (ncache < 1 || ncache > 2) return (int)cudaErrorInvalidValue;
  const long long total = (long long)ncache * B * H * row_vecs;
  write_rows_kernel<<<blocks_for(total), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src0), static_cast<uint4*>(dst0),
      static_cast<const uint4*>(src1), static_cast<uint4*>(dst1),
      static_cast<const int32_t*>(lengths), ncache, B, H, S, row_vecs);
  return (int)cudaGetLastError();
}
