// Hopper primitives for the port's sm_90a kernels (fused_mlp.cu,
// fused_mlp_half.cu, fused_attn_half.cu and fused_attn_half_bwd.cu through
// gemm_sm90.cuh, flash_attn_fwd.cu, flash_attn_bwd.cu, and the attention
// cores of the fused halves):
// - mbarriers (init, arrive, arrive with an expected TMA byte count, parity
//   wait), TMA tile loads (cp.async.bulk.tensor, 2-D and 4-D) and stores
//   (2-D) with their bulk groups, plain bulk copies (cp.async.bulk), named
//   barriers, and the 128-byte-swizzled layout of a TMA tile (pan);
// - warpgroup matrix multiply (wgmma): shared-memory descriptors for
//   128-byte-swizzled operands, the fence, commit and wait instructions,
//   and wgmma.mma_async m64nNk16 with bf16 (or, with T = __half, fp16)
//   inputs and fp32 accumulators, A from shared memory (wgmma_ss) or from
//   registers (wgmma_rs). B is
//   K-major with TRANS_B = 0 and N-major with TRANS_B = 1, and A from
//   shared memory K-major with TRANS_A = 0 and M-major with TRANS_A = 1
//   (both allowed for 16-bit types). scale_d = 0 overwrites d;
// - cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   no library links -lcuda.
//
// The accumulator of m64nN: a warpgroup's warp w holds rows 16 w .. 16 w
// + 15; lane (g = lane / 4, t = lane % 4) holds d[4 j], d[4 j + 1] at row
// g, columns 8 j + 2 t, + 1, and d[4 j + 2], d[4 j + 3] at row g + 8. An A
// fragment in registers has mma.sync m16n8k16's layout in each warp.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace xtag {
namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's current phase differs from ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D box of the tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c_inner), "r"(c_outer)
      : "memory");
}

// One 4-D box of the tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One 2-D box from shared memory to the tensor map's tensor (a bulk async
// group of this thread; boxes past the tensor's edge are clipped).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c_inner,
                                             int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory (READ) or are still in flight at all.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier of ``threads`` threads on hardware barrier ``id`` (0 is
// __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A tile of ``ROWS`` rows loaded (or stored) as [ROWS x 64] TMA boxes with
// the 128-byte swizzle, panel after panel: the canonical layout wgmma
// reads, K-major along a row and N-major down the rows. Element offset of
// (row, col) in such a tile:
template <int ROWS>
__device__ __forceinline__ int pan(int row, int col) {
  return (col >> 6) * (ROWS * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) +
         (col & 7);
}

// ``bytes`` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A descriptor for a 128-byte-swizzled operand: start address, leading and
// stride byte offsets, all in bytes. K-major: the stride offset steps 8
// rows of 128 bytes; the leading offset is unused. N-major: the leading
// offset steps 64-element column blocks, the stride offset 8 k rows.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
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

// Keep the compiler from moving accumulator reads or writes across a wait,
// and register A fragments alive (unchanged) until the wgmma reading them
// has been waited for.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Shared-memory writes of this thread (generic proxy) made visible to
// wgmma's reads (async proxy); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The four wgmma.mma_async forms below, for one input type TY ("bf16" or
// "f16"; fp32 accumulators either way): A from shared memory (SS) or from
// registers (RS), N = 64 or 128.
#define XTAG_D32 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define XTAG_D64 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define XTAG_WGMMA_SS_64(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %36, %35;\n}\n" \
               : XTAG_D32                                                        \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A))
#define XTAG_WGMMA_SS_128(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"    \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %68, %67;\n}\n" \
               : XTAG_D64                                                        \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A))
#define XTAG_WGMMA_RS_64(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
               : XTAG_D32                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
                 "n"(TRANS_B))
#define XTAG_WGMMA_RS_128(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"    \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
               : XTAG_D64                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
                 "n"(TRANS_B))

// T: the inputs' type, bf16 or __half (the 16-bit float of the f16 forms)
template <int TRANS_B, int TRANS_A = 0, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    XTAG_WGMMA_SS_64("f16");
  else
    XTAG_WGMMA_SS_64("bf16");
}

template <int TRANS_B, int TRANS_A = 0, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    XTAG_WGMMA_SS_128("f16");
  else
    XTAG_WGMMA_SS_128("bf16");
}

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    XTAG_WGMMA_RS_64("f16");
  else
    XTAG_WGMMA_RS_64("bf16");
}

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    XTAG_WGMMA_RS_128("f16");
  else
    XTAG_WGMMA_RS_128("bf16");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint (so the library
// needs no -lcuda); null where it is missing.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : static_cast<EncodeTiledFn>(nullptr);
  }();
  return fn;
}

// The device's count of SMs (a persistent grid's size).
inline int sm_count() {
  static int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

}  // namespace sm90
}  // namespace xtag
