// In-place KV-cache writes for sm_90a: whole prefilled sequences (K3), one
// decode row per slot (K4, "rows" and "flat" kinds) and a span of
// contiguous rows per slot (K5).
//
// Replace the TPU kernels omniquant_tpu/kernels/kv_update.py::
// kv_cache_prefill_write (_kv_prefill / _prefill_kernel, pallas_call at :230),
// kv_cache_write (_kv_write / _write_kernel, pallas_call at :123) and
// kv_cache_write_span (_kv_write_span / _span_kernel, pallas_call at :348).
//
// What bounds them on an H100. Each new row is read once and written once
// (a bf16 decode write of 32 slots x 32 heads x 128 is 512 KB with K and V;
// an int8 ring flush of 8 rows, codes and scales of K and V, 2.1 MB; a
// prefill write of 32 x 32 x 128 x 128 bf16, 32 MB). The prefill write is
// bound by those bytes. The row writes (K4, K5) move so few that their byte
// bound is below a microsecond: what bounds them is the launch itself (the
// empty kernel below, launched with their grid, is the floor no launch of
// that size beats) plus the latency of one trip to memory and the drain of
// the stores.
//
// Design of the row writes (write_rows_kernel). A decode write or a span
// flush covers up to four buffers in one launch (K and V codes, K and V
// scale planes), each with its own row size. For each (slot b, head h) a
// buffer's span rows are one contiguous run in the source (B, H, span, row)
// and in the cache (B, H, S, row), so each run is a vector copy of
// span x row bytes, cut only where it leaves [0, S): a row outside the
// cache is dropped, never clamped (a clamped write would overwrite a live
// row). A row moves in the widest unit (16, 8, 4, 2 or 1 bytes) that
// divides it and both base addresses: a 128-byte int8 or 256-byte bf16 row
// as 16-byte vectors, a plane entry (one f32) as one 4-byte word.
// - The grid is (slot) x (head, lane): 2^lg_lanes threads per (slot, head),
//   the fewest that cover the longest buffer's run, 64 threads a CTA.
//   Thread lane moves unit lane of every buffer's run. Slot and head come from blockIdx.y and a shift, so the
//   index math is 32-bit multiplies, shifts and masks: no division, and
//   64-bit arithmetic only in the cache offset.
// - One trip to memory: a thread loads lengths[b] and then its source units
//   of every buffer before anything waits on lengths (a source index never
//   depends on it); the range check predicates only the stores.
// - The per-buffer table (pointers, units per row, unit size) is indexed
//   only by unrolled constants, so it stays in the parameter space (no
//   local stack frame). The engines' two layouts (K and V of 16-byte units;
//   int8 K and V codes of 16-byte units and their planes of 4-byte ones)
//   have the unit sizes as template arguments, so their loads and stores
//   are straight-line; other layouts read each unit size at run time.
// - Every (slot, head) has its own threads: batch 32 x 32 heads is 128 CTAs
//   for an int8 decode write and 1024 for an 8-row flush, one wave over the
//   132 SMs.
// What is left: the launch floor, which only fewer launches (a captured
// decode step, or the write fused into the kernel that makes the rows) can
// remove.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BUFFERS = 4;
constexpr int ROWS_BLOCK = 64;  // threads of a row-write CTA

// One buffer of a row write: new rows (B, H, span, row), cache (B, H, S,
// row), a row of ru units of 2^lg bytes; ru == 0 marks no buffer.
struct RowBuffer {
  const unsigned char* src;
  unsigned char* dst;
  int ru;
  int lg;
};

struct RowBuffers {
  RowBuffer buf[MAX_BUFFERS];
};

// What a row-write launch needs besides lengths: the buffers and the grid.
struct RowPlan {
  RowBuffers bufs;
  int lg_lanes;
  dim3 grid;
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

// Unit i of 2^lg bytes at p, in the low words of a uint4.
__device__ __forceinline__ uint4 load_unit(const unsigned char* p, int i,
                                           int lg) {
  switch (lg) {
    case 4: return __ldg(reinterpret_cast<const uint4*>(p) + i);
    case 3: {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      return make_uint4(v.x, v.y, 0u, 0u);
    }
    case 2:
      return make_uint4(__ldg(reinterpret_cast<const unsigned int*>(p) + i),
                        0u, 0u, 0u);
    case 1:
      return make_uint4(__ldg(reinterpret_cast<const unsigned short*>(p) + i),
                        0u, 0u, 0u);
    default: return make_uint4(__ldg(p + i), 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_unit(unsigned char* p, long long i,
                                           int lg, uint4 v) {
  switch (lg) {
    case 4: reinterpret_cast<uint4*>(p)[i] = v; break;
    case 3: reinterpret_cast<uint2*>(p)[i] = make_uint2(v.x, v.y); break;
    case 2: reinterpret_cast<unsigned int*>(p)[i] = v.x; break;
    case 1: reinterpret_cast<unsigned short*>(p)[i] = (unsigned short)v.x;
      break;
    default: p[i] = (unsigned char)v.x;
  }
}

constexpr int ANY = -1;   // a unit size read from RowBuffer::lg at run time
constexpr int NONE = -2;  // no buffer

// Grid (ceil(H * 2^lg_lanes / ROWS_BLOCK), B). Thread u of (slot b, head h)
// moves unit u of each buffer's run of span * ru units; 2^lg_lanes covers
// the longest run. LGk is buffer k's unit (log2 bytes) where the launch
// knows it, so the engines' layouts load and store with no branch on the
// unit. The host keeps B * H * span * ru below 2^31 for every buffer, so
// the source index is 32-bit.
template <int LG0, int LG1, int LG2, int LG3>
__global__ void __launch_bounds__(ROWS_BLOCK)
    write_rows_kernel(RowBuffers bufs, const int32_t* __restrict__ lengths,
                      int H, int S, int span, int lg_lanes) {
  constexpr int LG[MAX_BUFFERS] = {LG0, LG1, LG2, LG3};
  const int x = blockIdx.x * ROWS_BLOCK + threadIdx.x;
  const int h = x >> lg_lanes;
  if (h >= H) return;
  const int u = x & ((1 << lg_lanes) - 1);
  const int bh = blockIdx.y * H + h;
  const int len = __ldg(lengths + blockIdx.y);  // in flight with the loads
  uint4 v[MAX_BUFFERS];
#pragma unroll
  for (int k = 0; k < MAX_BUFFERS; ++k) {
    if (LG[k] == NONE) continue;
    const RowBuffer r = bufs.buf[k];
    v[k] = u < span * r.ru ? load_unit(r.src, bh * span * r.ru + u,
                                       LG[k] == ANY ? r.lg : LG[k])
                           : make_uint4(0u, 0u, 0u, 0u);
  }
  // rows t_lo <= t < t_hi of the span land inside [0, S)
  const int t_lo = len >= 0 ? 0 : (len <= -span ? span : -len);
  const int t_hi = len >= S ? 0 : (len <= S - span ? span : S - len);
#pragma unroll
  for (int k = 0; k < MAX_BUFFERS; ++k) {
    if (LG[k] == NONE) continue;
    const RowBuffer r = bufs.buf[k];
    if (u >= t_lo * r.ru && u < t_hi * r.ru)
      store_unit(r.dst, ((long long)bh * S + len) * r.ru + u,
                 LG[k] == ANY ? r.lg : LG[k], v[k]);
  }
}

// The floor of a row write: nothing, launched with its grid.
__global__ void __launch_bounds__(ROWS_BLOCK) empty_rows_kernel() {}

int blocks_for(long long total) {
  const long long b = (total + 255) / 256;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// Fills plan for kv_write_rows' arguments; false where the kernel does not
// take them (no first buffer, span < 1, B outside [1, 65535], a grid row
// of 2^31 threads or more).
bool plan_rows(RowPlan& plan, const void* const* srcs, void* const* dsts,
               const int* row_bytes, int B, int H, int span) {
  if (row_bytes[0] < 1 || span < 1 || B < 1 || B > 65535 || H < 1)
    return false;
  long long units = 0;  // the longest run
  for (int k = 0; k < MAX_BUFFERS; ++k) {
    RowBuffer& r = plan.bufs.buf[k];
    r.src = static_cast<const unsigned char*>(srcs[k]);
    r.dst = static_cast<unsigned char*>(dsts[k]);
    r.ru = 0;
    r.lg = 0;
    if (row_bytes[k] < 1) continue;
    const uintptr_t bits = (uintptr_t)row_bytes[k] |
                           reinterpret_cast<uintptr_t>(srcs[k]) |
                           reinterpret_cast<uintptr_t>(dsts[k]);
    r.lg = 4;
    while (r.lg > 0 && (bits & ((uintptr_t(1) << r.lg) - 1))) --r.lg;
    r.ru = row_bytes[k] >> r.lg;
    if ((long long)span * r.ru > units) units = (long long)span * r.ru;
  }
  plan.lg_lanes = 0;
  while ((1LL << plan.lg_lanes) < units) ++plan.lg_lanes;
  const long long threads = (long long)H << plan.lg_lanes;
  if (threads > 0x7fffffffLL - ROWS_BLOCK) return false;
  plan.grid = dim3((unsigned)((threads + ROWS_BLOCK - 1) / ROWS_BLOCK), B);
  return true;
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

// A row write's arguments as the host packs them: 17 int64 in this order
// (one buffer of bytes is cheaper to pass from Python than 17 scalars).
struct RowArgs {
  long long src[MAX_BUFFERS];  // new rows (B, H, span, row_k bytes)
  long long dst[MAX_BUFFERS];  // caches (B, H, S, row_k bytes)
  long long row[MAX_BUFFERS];  // row_k in bytes; 0: no buffer
  long long lengths;           // (B,) int32 on the card
  long long B, H, S, span;
};

namespace {

// kv_write_rows' launch, of the row writer or (empty) of a kernel that does
// nothing with the same grid.
int launch_rows(const RowArgs* a, bool empty, void* stream) {
  const void* srcs[MAX_BUFFERS];
  void* dsts[MAX_BUFFERS];
  int rows[MAX_BUFFERS];
  for (int k = 0; k < MAX_BUFFERS; ++k) {
    srcs[k] = reinterpret_cast<const void*>(a->src[k]);
    dsts[k] = reinterpret_cast<void*>(a->dst[k]);
    rows[k] = (int)a->row[k];
  }
  const int B = (int)a->B, H = (int)a->H, S = (int)a->S, span = (int)a->span;
  RowPlan plan;
  if (!plan_rows(plan, srcs, dsts, rows, B, H, span))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowBuffer* r = plan.bufs.buf;
  const int32_t* lens = reinterpret_cast<const int32_t*>(a->lengths);
  if (empty)
    empty_rows_kernel<<<plan.grid, ROWS_BLOCK, 0, st>>>();
  else if (r[0].lg == 4 && r[1].ru && r[1].lg == 4 && !r[2].ru && !r[3].ru)
    // bf16 (or any 16-byte-row) K and V
    write_rows_kernel<4, 4, NONE, NONE><<<plan.grid, ROWS_BLOCK, 0, st>>>(
        plan.bufs, lens, H, S, span, plan.lg_lanes);
  else if (r[0].lg == 4 && r[1].ru && r[1].lg == 4 && r[2].ru &&
           r[2].lg == 2 && r[3].ru && r[3].lg == 2)
    // int8 K and V codes and their f32 scale planes
    write_rows_kernel<4, 4, 2, 2><<<plan.grid, ROWS_BLOCK, 0, st>>>(
        plan.bufs, lens, H, S, span, plan.lg_lanes);
  else
    write_rows_kernel<ANY, ANY, ANY, ANY><<<plan.grid, ROWS_BLOCK, 0, st>>>(
        plan.bufs, lens, H, S, span, plan.lg_lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// For each buffer k with row_k > 0 (buffer 0 always), up to four: cache
// dst_k <- new rows src_k, row t of slot b at position lengths[b] + t,
// dropped outside [0, S). A plane is a cache whose row is one f32.
extern "C" int kv_write_rows(const RowArgs* a, void* stream) {
  return launch_rows(a, false, stream);
}

// kv_write_rows' grid and block launching a kernel that does nothing: the
// floor of a row write of these arguments, for timing only.
extern "C" int kv_write_rows_empty(const RowArgs* a, void* stream) {
  return launch_rows(a, true, stream);
}
