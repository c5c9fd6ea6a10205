// Hopper (sm_90a) building blocks shared by K9 (quant_matmul_int.cu) and K2
// (flash_attention.cu): mbarriers, TMA copies, wgmma operand descriptors and
// issue, and cuTensorMapEncodeTiled reached through the CUDA runtime.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no link to libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// a wait that never ends (a ring out of step) traps after 2^22 polls
// (each try_wait suspends for up to microseconds: ~20 s on an H100), so
// it fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  // a phase that has completed passes without try_wait's suspend latency
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  int polls = 0;
  do {
    if (++polls == (1 << 22)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// a box of a 3-D map at (x innermost, y, z)
__device__ __forceinline__ void tma_box3(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// shared -> global by a 3-D map; elements past the map's extent are not
// written. Completion: bulk_commit, then bulk_wait_read before the shared
// source is reused or the CTA exits.
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int x, int y,
                                           int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's shared-memory writes, made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma operand descriptors, 128-byte swizzle (layout 1), as TMA writes a
// box of 128-byte rows at a 1024-byte aligned base. K-major: rows of 128
// bytes of k, start >> 4, LBO 16 bytes (unused for this layout), SBO 1024
// bytes (8 rows of 128 bytes).
__device__ __forceinline__ uint64_t desc_k_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// MN-major (a row of 128 bytes holds 64 consecutive n of one k): SBO 1024
// bytes to the next 8 k, LBO ``lbo`` bytes to the next 64 n
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr,
                                                  uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accesses to the accumulators across the
// asynchronous wgmma instructions
template <int N>
__device__ __forceinline__ void fence_acc(int (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

#define SM90_D32(c)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),  \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),  \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]),          \
      c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]),          \
      c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define SM90_D64(c)                                                        \
  SM90_D32(c), c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]),           \
      c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),          \
      c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]),          \
      c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]),          \
      c(d[55]), c(d[56]), c(d[57]), c(d[58]), c(d[59]), c(d[60]),          \
      c(d[61]), c(d[62]), c(d[63])
#define SM90_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_REGS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SM90_RW_INT(x) "+r"(x)
#define SM90_RW_F32(x) "+f"(x)

// D (64 x 128) s32 (+)= A (64 x 32) . B (128 x 32)^T, both K-major in
// shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_REGS64
      ", %64, %65, p;\n}\n"
      : SM90_D64(SM90_RW_INT)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128) f32 (+)= A (64 x 16) . B (128 x 16)^T, bf16, both K-major in
// shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_D64(SM90_RW_F32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N) f32 += A (64 x 16, bf16 pairs in registers: the m16n8k16
// A fragment of each warp's 16 rows) . B (16 x N), B MN-major in shared
// memory (the transpose bit set), N = 128 or 64; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_D64(SM90_RW_F32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_D32(SM90_RW_F32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
