// In-place KV-cache writes for sm_90a: whole prefilled sequences (K3), one
// decode row per slot (K4, "rows" and "flat" kinds) and a span of
// contiguous rows per slot (K5).
//
// Replace the TPU kernels omniquant_tpu/kernels/kv_update.py::
// kv_cache_prefill_write (_kv_prefill / _prefill_kernel, pallas_call at :230),
// kv_cache_write (_kv_write / _write_kernel, pallas_call at :123) and
// kv_cache_write_span (_kv_write_span / _span_kernel, pallas_call at :348).
//
// What bounds them on an H100: they only move bytes, each new row read once
// and written once (a bf16 decode write of 32 slots x 32 heads x 128 is
// 256 KB; an int8 ring flush of 8 rows, codes and scales of K and V, is
// 2.1 MB; a prefill write of 32 x 32 x 128 x 128 bf16 is 32 MB), so memory
// bandwidth, and for the small decode writes, launch latency.
//
// Design: a grid-stride copy straight into the target rows. The TPU kernels
// read-modify-wrote whole 8-row tiles because its DMA engine needs
// (8, 128)-aligned slices (and K5 clamped its tile near the buffer end);
// here each new row is stored alone, and the rest of the cache is never
// touched. A decode write or a span flush covers up to four buffers in one
// launch (K and V codes, K and V scale planes), each with its own row size:
// a row moves in the widest unit (16, 8, 4, 2 or 1 bytes) that divides it
// and both base addresses, so a 128-byte code row moves as 16-byte vectors
// and a plane row (one f32) as one 4-byte word. A row whose slot or
// position lies outside the cache is dropped, never clamped (a clamped
// write would overwrite a live row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BUFFERS = 4;

struct Buffers {
  const unsigned char* src[MAX_BUFFERS];
  unsigned char* dst[MAX_BUFFERS];
  int row_units[MAX_BUFFERS];  // units per row
  int unit[MAX_BUFFERS];       // bytes per unit
  long long end[MAX_BUFFERS];  // running total of units, buffer by buffer
  int n;
};

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

template <typename U>
__device__ __forceinline__ void copy_unit(const unsigned char* src,
                                          unsigned char* dst, long long from,
                                          long long to) {
  reinterpret_cast<U*>(dst)[to] = reinterpret_cast<const U*>(src)[from];
}

// Buffer k's source is (B, H, span, row) and its cache (B, H, S, row); the
// flat index runs over the buffers one after another.
__global__ void write_rows_kernel(Buffers bufs,
                                  const int32_t* __restrict__ lengths, int H,
                                  int S, int span) {
  const long long total = bufs.end[bufs.n - 1];
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    int k = 0;
    while (i >= bufs.end[k]) ++k;
    const long long j = k ? i - bufs.end[k - 1] : i;
    const int ru = bufs.row_units[k];
    const int c = (int)(j % ru);
    const long long r = j / ru;  // (b * H + h) * span + t
    const int t = (int)(r % span);
    const long long bh = r / span;
    const int pos = lengths[bh / H] + t;
    if (pos < 0 || pos >= S) continue;
    const long long to = (bh * S + pos) * ru + c;
    switch (bufs.unit[k]) {
      case 16: copy_unit<uint4>(bufs.src[k], bufs.dst[k], j, to); break;
      case 8: copy_unit<uint2>(bufs.src[k], bufs.dst[k], j, to); break;
      case 4: copy_unit<uint32_t>(bufs.src[k], bufs.dst[k], j, to); break;
      case 2: copy_unit<uint16_t>(bufs.src[k], bufs.dst[k], j, to); break;
      default: copy_unit<uint8_t>(bufs.src[k], bufs.dst[k], j, to);
    }
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

// For k < n (1 to 4): cache_k (B, H, S, row_k) <- new_k (B, H, span, row_k),
// row t of slot b at position lengths[b] + t. srcs, dsts and row_bytes are
// host arrays of n entries; a plane is a cache whose row is one f32.
extern "C" int kv_write_rows(const void* const* srcs, void* const* dsts,
                             const int* row_bytes, int n, const void* lengths,
                             int B, int H, int S, int span, void* stream) {
  if (n < 1 || n > MAX_BUFFERS || span < 1) return (int)cudaErrorInvalidValue;
  Buffers bufs = {};
  bufs.n = n;
  long long total = 0;
  for (int k = 0; k < n; ++k) {
    int unit = 16;
    while (unit > 1 && (row_bytes[k] % unit ||
                        reinterpret_cast<uintptr_t>(srcs[k]) % unit ||
                        reinterpret_cast<uintptr_t>(dsts[k]) % unit))
      unit /= 2;
    bufs.src[k] = static_cast<const unsigned char*>(srcs[k]);
    bufs.dst[k] = static_cast<unsigned char*>(dsts[k]);
    bufs.unit[k] = unit;
    bufs.row_units[k] = row_bytes[k] / unit;
    total += (long long)B * H * span * bufs.row_units[k];
    bufs.end[k] = total;
  }
  write_rows_kernel<<<blocks_for(total), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      bufs, static_cast<const int32_t*>(lengths), H, S, span);
  return (int)cudaGetLastError();
}
