// Shared device code for the fused attention half (fused_attn_half.cu)
// and its backward (fused_attn_half_bwd.cu): the row LayerNorm of
// ln_rows.cuh and a bf16 tensor-core GEMM with the operand layouts and
// epilogues they need. Numerics follow the contract of the Pallas
// kernels in xtagclip_tpu/ops/fused_attn_block.py:20-25: LN statistics in
// fp32 (two-pass variance), every product accumulated in fp32, biases,
// activations and residual adds in fp32, one rounding to bf16 per output.
//
// Design. The Pallas kernels keep the whole half's weights resident in VMEM
// (4.7 MB of bf16 at ViT-B width), far above the 227 KB of shared memory a
// Hopper block can hold. Here each half is a short chain of launches whose
// intermediates (xn, qkv, the per-head outputs, the MLP hidden) are bf16
// round trips through device memory at exactly the points where the Pallas
// kernel rounds to bf16, so the arithmetic is the same. The GEMM is a plain
// 64x64x32 WMMA tile (bf16 16x16x16 fragments, fp32 accumulators), four
// warps of 32x32 each, with no asynchronous copies: simple and right first.
// At the slice's shapes the halves are bound by operations (800-1100 FLOP
// per byte moved at B=32, above the H100's ~295), so the GEMM's tensor-core
// rate is what a later tuning pass should raise (wgmma, TMA, pipelining).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "ln_rows.cuh"

namespace xtag {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

enum Epilogue : int {
  EPI_BIAS = 0,        // C = bf16(acc + bias)
  EPI_BIAS_RESID = 1,  // C = bf16(resid + (acc + bias))
  EPI_NONE = 2,        // C = bf16(acc)
  EPI_F32 = 3,         // C = acc, fp32
};

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;
// Padded leading dimensions: multiples of 8 bf16 / 4 fp32 as WMMA needs,
// with every 16-row fragment start on a 32-byte boundary. A tile is held
// [BM x BK] (A row-major) or [BK x BM] (A^T given), a B tile [BK x BN]
// (B row-major) or [BN x BK] (B^T given).
constexpr int GEMM_A_LD = GEMM_BK + 8;   // bf16, A tile [BM x BK]
constexpr int GEMM_AT_LD = GEMM_BM + 8;  // bf16, A tile [BK x BM]
constexpr int GEMM_B_LD = GEMM_BN + 8;   // bf16, B tile [BK x BN]
constexpr int GEMM_BT_LD = GEMM_BK + 8;  // bf16, B tile [BN x BK]
constexpr int GEMM_C_LD = GEMM_BN + 4;   // fp32
constexpr int GEMM_TILE_ELEMS = GEMM_BM * GEMM_A_LD > GEMM_BK * GEMM_AT_LD
                                    ? GEMM_BM * GEMM_A_LD : GEMM_BK * GEMM_AT_LD;
static_assert(GEMM_BK * GEMM_B_LD <= GEMM_TILE_ELEMS &&
              GEMM_BN * GEMM_BT_LD <= GEMM_TILE_ELEMS, "tile buffer size");

// C[M,N] = epi(op(A) @ op(B) + bias[N] (+ resid[M,N])). op(A) is A [M,K]
// row-major, or with A_T the transpose of A given as [K,M] row-major; op(B)
// is B [K,N] row-major, or with B_T the transpose of B given as [N,K]
// row-major. resid and C (bf16, or fp32 for EPI_F32) are row-major [M,N];
// bias fp32. Needs N % 64 == 0, M % 8 == 0 with A_T, K % 8 == 0 unless
// both operands are read along rows of K (A_T and not B_T), 16-byte aligned
// rows. M and K are ragged: rows past M or K load as zero, rows past M are
// not stored.
template <int EPI, bool A_T = false, bool B_T = false>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const float* __restrict__ bias,
                 const bf16* __restrict__ resid, void* __restrict__ C,
                 int M, int N, int K) {
  using ALayout = std::conditional_t<A_T, wmma::col_major, wmma::row_major>;
  using BLayout = std::conditional_t<B_T, wmma::col_major, wmma::row_major>;
  __shared__ __align__(128) bf16 As[GEMM_TILE_ELEMS];
  __shared__ __align__(128) bf16 Bs[GEMM_TILE_ELEMS];
  __shared__ __align__(128) float Cs[GEMM_BM * GEMM_C_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;  // 0..1: 32-row half of the tile
  const int warp_n = warp & 1;   // 0..1: 32-column half of the tile
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    // A tile: 256 vectors of 8 bf16, two a thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = tid + it * GEMM_THREADS;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (A_T) {  // rows k0..k0+31 of A^T, 64 columns of m
        const int r = v >> 3;
        const int c = (v & 7) * 8;
        if (k0 + r < K && m0 + c < M)
          val = *reinterpret_cast<const uint4*>(A + (size_t)(k0 + r) * M + m0 + c);
        *reinterpret_cast<uint4*>(As + r * GEMM_AT_LD + c) = val;
      } else {    // rows m0..m0+63 of A, 32 columns of k
        const int r = v >> 2;
        const int c = (v & 3) * 8;
        if (m0 + r < M && k0 + c < K)
          val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(As + r * GEMM_A_LD + c) = val;
      }
    }
    // B tile: 256 vectors, two a thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = tid + it * GEMM_THREADS;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (B_T) {  // rows n0..n0+63 of B^T, 32 columns of k
        const int r = v >> 2;
        const int c = (v & 3) * 8;
        if (k0 + c < K)
          val = *reinterpret_cast<const uint4*>(B + (size_t)(n0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(Bs + r * GEMM_BT_LD + c) = val;
      } else {    // rows k0..k0+31 of B, 64 columns of n
        const int r = v >> 3;
        const int c = (v & 7) * 8;
        if (k0 + r < K)
          val = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + n0 + c);
        *reinterpret_cast<uint4*>(Bs + r * GEMM_B_LD + c) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = warp_m * 32 + i * 16;
        if (A_T)
          wmma::load_matrix_sync(af[i], As + kk * GEMM_AT_LD + m, GEMM_AT_LD);
        else
          wmma::load_matrix_sync(af[i], As + m * GEMM_A_LD + kk, GEMM_A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = warp_n * 32 + j * 16;
        if (B_T)
          wmma::load_matrix_sync(bfr[j], Bs + n * GEMM_BT_LD + kk, GEMM_BT_LD);
        else
          wmma::load_matrix_sync(bfr[j], Bs + kk * GEMM_B_LD + n, GEMM_B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (warp_m * 32 + i * 16) * GEMM_C_LD + warp_n * 32 + j * 16,
                              acc[i][j], GEMM_C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < GEMM_BM * GEMM_BN; idx += GEMM_THREADS) {
    const int r = idx / GEMM_BN;
    const int c = idx % GEMM_BN;
    const int gm = m0 + r;
    if (gm >= M) continue;
    const size_t off = (size_t)gm * N + n0 + c;
    float v = Cs[r * GEMM_C_LD + c];
    if (EPI == EPI_F32) {
      static_cast<float*>(C)[off] = v;
      continue;
    }
    if (EPI != EPI_NONE) v += bias[n0 + c];
    if (EPI == EPI_BIAS_RESID) v = __bfloat162float(resid[off]) + v;
    static_cast<bf16*>(C)[off] = __float2bfloat16(v);
  }
}

template <int EPI, bool A_T = false, bool B_T = false>
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias,
                               const bf16* resid, void* C, int M, int N, int K,
                               cudaStream_t stream) {
  dim3 grid(N / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<EPI, A_T, B_T><<<grid, GEMM_THREADS, 0, stream>>>(A, B, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace xtag
