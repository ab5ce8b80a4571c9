// A Hopper bf16 GEMM with a fused epilogue, for the fused MLP (fused_mlp.cu):
//   C[M, N] = epi(A[M, K] @ B[K, N] + bias[N])
// A row-major (K contiguous), B row-major (N contiguous, the flax [in, out]
// weight as it is stored), bias fp32, C bf16 row-major. The epilogue adds the
// bias in fp32 and applies the exact erf gelu or quick_gelu in fp32 (or
// nothing), then rounds once to bf16: the numerics of block_common.cuh's
// WMMA GEMM, which the fused halves keep.
//
// Design (what the card offers that the WMMA GEMM did not use):
// - a persistent grid, one block an SM, walking 128 x 128 output tiles
//   (128 x 256 was no faster);
// - a ring of 4 shared-memory stages (128 KB), each a 128 x 64 tile of A
//   and a 64 x 128 tile of B, filled by TMA (cp.async.bulk.tensor,
//   128-byte swizzle) from one producer thread, with mbarrier completion
//   (full barriers: TMA bytes; empty barriers: one arrival per consumer
//   warp); the producer runs ahead across tiles, so the next tile's loads
//   overlap this tile's epilogue (a 192 KB ring was slower);
// - two consumer warpgroups, 64 rows each, running wgmma m64n128k16 with the
//   sums in registers and one wgmma group kept in flight; setmaxnreg moves
//   registers from the producer to them;
// - B read N-major through wgmma's transpose bit (a 16-bit type allows it),
//   so the weights are used as stored, with no transposed copy;
// - the epilogue in registers: bias, activation, one bf16 rounding, 4-byte
//   stores masked to rows < M and columns < N. TMA zero-fills what lies
//   past M, N or K, so ragged edges need no special path.
// What holds it back: the epilogue does not overlap the same block's
// products, which costs the c_fc product with its erff gelu most (short K
// of 768, a [N, 3072] output).
// Needs K % 64 == 0, N % 64 == 0, 16-byte aligned rows (checked by the
// caller). The tensor maps are encoded on the host through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint: no -lcuda.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace xtag {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // output rows per tile: two warpgroups of 64
constexpr int BN = 128;          // output columns per tile
constexpr int BK = 64;           // K per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int A_BYTES = BM * BK * 2;            // 16 KB
constexpr int B_HALF_BYTES = BK * 64 * 2;       // 8 KB: 64 k rows x 64 columns
constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_HALF_BYTES;
constexpr int STAGES = 4;                       // a 128 KB ring
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int PRODUCER_REGS = 40;               // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 232;

enum Epilogue : int { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_QGELU = 2 };

template <int EPI>
__device__ __forceinline__ float activate(float v) {
  if (EPI == EPI_BIAS_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (EPI == EPI_BIAS_QGELU) return v / (1.0f + expf(-1.702f * v));
  return v;
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ bias, bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stage bases on that grid
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int k_steps = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_2d(st, &map_a, &full[stage], ks * BK, m0);
#pragma unroll
          for (int half = 0; half < BN / 64; ++half)
            tma_load_2d(st + A_BYTES + half * B_HALF_BYTES, &map_b, &full[stage],
                        n0 + 64 * half, ks * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows wg * 64 .. wg * 64 + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    int stage = 0;
    uint32_t phase = 0;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
      int prev = -1;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_addr = smem_u32(smem + stage * STAGE_BYTES) + wg * (64 * 128);
        const uint32_t b_addr = smem_u32(smem + stage * STAGE_BYTES + A_BYTES);
        fence_operands(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart;
          //    a k-step of 16 is 32 bytes along the swizzled row.
          // B: N-major; 64-column blocks 8 KB apart (leading offset), 8-row
          //    k groups 1024 bytes apart (stride offset); a k-step is 16
          //    rows, 2048 bytes.
          wgmma_ss<1>(d, wgmma_desc(a_addr + kk * 32, 16, 1024),
                       wgmma_desc(b_addr + kk * 2048, B_HALF_BYTES, 1024),
                       (ks > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        fence_operands(d);
        if (prev >= 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(d);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: fragment (row g or g + 8, columns 8 j + 2 t, + 1) of this
      // warp's 16 rows
      const int row = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= N) continue;
        const float b0 = __ldg(bias + col);
        const float b1 = __ldg(bias + col + 1);
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
              __floats2bfloat162_rn(activate<EPI>(d[4 * j] + b0),
                                    activate<EPI>(d[4 * j + 1] + b1));
        if (row + 8 < M)
          *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
              __floats2bfloat162_rn(activate<EPI>(d[4 * j + 2] + b0),
                                    activate<EPI>(d[4 * j + 3] + b1));
      }
    }
  }
}

// A 2-D bf16 row-major [outer, inner] tensor read in boxes of
// [box_outer, box_inner] with the 128-byte swizzle; out-of-bounds reads
// fill zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                     uint32_t box_inner, uint32_t box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = epi(A @ B + bias); see the file note for the layouts and limits.
template <int EPI>
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias, bf16* C,
                               int M, int N, int K, cudaStream_t stream) {
  if (M < 1 || N % 64 != 0 || K % BK != 0 || N < 64 || K < BK)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, A, (uint64_t)K, (uint64_t)M, BK, BM) ||
      !make_map(&map_b, B, (uint64_t)N, (uint64_t)K, 64, BK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gemm_sm90_kernel<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_sm90_kernel<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, bias, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace xtag
