// Shared device code for the two fused block halves (fused_attn_half.cu,
// fused_mlp_half.cu): a row LayerNorm and a bf16 tensor-core GEMM with the
// epilogues the halves need. Numerics follow the contract of the Pallas
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

namespace xtag {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// y[r] = bf16(((x[r] - mean) * rsqrt(var + eps)) * g + b), one warp a row.
// Two-pass variance over the fp32 row, as fused_attn_block.py:458-463.
constexpr int LN_THREADS = 128;

__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, bf16* __restrict__ y,
               int n_rows, int d, float eps) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const bf16* xr = x + (size_t)row * d;
  bf16* yr = y + (size_t)row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += __bfloat162float(xr[i]);
  const float mean = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float t = __bfloat162float(xr[i]) - mean;
    v += t * t;
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)d + eps);
  for (int i = lane; i < d; i += 32) {
    const float t = (__bfloat162float(xr[i]) - mean) * rstd;
    yr[i] = __float2bfloat16(t * g[i] + b[i]);
  }
}

enum Epilogue : int {
  EPI_BIAS = 0,        // C = bf16(acc + bias)
  EPI_BIAS_GELU = 1,   // C = bf16(gelu(acc + bias)), exact erf gelu
  EPI_BIAS_QGELU = 2,  // C = bf16(quick_gelu(acc + bias))
  EPI_BIAS_RESID = 3,  // C = bf16(resid + (acc + bias))
};

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;
// Padded leading dimensions: multiples of 8 bf16 / 4 fp32 as WMMA needs,
// with every 16-row fragment start on a 32-byte boundary.
constexpr int GEMM_A_LD = GEMM_BK + 8;  // bf16
constexpr int GEMM_B_LD = GEMM_BN + 8;  // bf16
constexpr int GEMM_C_LD = GEMM_BN + 4;  // fp32

template <int EPI>
__device__ __forceinline__ float epilogue(float v) {
  if (EPI == EPI_BIAS_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (EPI == EPI_BIAS_QGELU) return v / (1.0f + expf(-1.702f * v));
  return v;
}

// C[M,N] = epi(A[M,K] @ B[K,N] + bias[N] (+ resid[M,N])). A, B, C, resid
// row-major bf16; bias fp32. Needs N % 64 == 0, K % 32 == 0, 16-byte
// aligned rows; M is ragged (rows past M load as zero and are not stored).
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const float* __restrict__ bias,
                 const bf16* __restrict__ resid, bf16* __restrict__ C,
                 int M, int N, int K) {
  __shared__ __align__(128) bf16 As[GEMM_BM * GEMM_A_LD];
  __shared__ __align__(128) bf16 Bs[GEMM_BK * GEMM_B_LD];
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
    // A tile [64 x 32]: 256 vectors of 8 bf16, two a thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = tid + it * GEMM_THREADS;
      const int r = v >> 2;
      const int c = (v & 3) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * GEMM_A_LD + c) = val;
    }
    // B tile [32 x 64]: 256 vectors, two a thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = tid + it * GEMM_THREADS;
      const int r = v >> 3;
      const int c = (v & 7) * 8;
      *reinterpret_cast<uint4*>(Bs + r * GEMM_B_LD + c) =
          *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (warp_m * 32 + i * 16) * GEMM_A_LD + kk, GEMM_A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * GEMM_B_LD + warp_n * 32 + j * 16, GEMM_B_LD);
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
    float v = Cs[r * GEMM_C_LD + c] + bias[n0 + c];
    if (EPI == EPI_BIAS_RESID) {
      v = __bfloat162float(resid[off]) + v;
    } else {
      v = epilogue<EPI>(v);
    }
    C[off] = __float2bfloat16(v);
  }
}

template <int EPI>
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias,
                               const bf16* resid, bf16* C, int M, int N, int K,
                               cudaStream_t stream) {
  dim3 grid(N / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<EPI><<<grid, GEMM_THREADS, 0, stream>>>(A, B, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

inline cudaError_t launch_ln(const bf16* x, const float* g, const float* b, bf16* y,
                             int n_rows, int d, float eps, cudaStream_t stream) {
  const int rows_per_block = LN_THREADS / 32;
  dim3 grid((n_rows + rows_per_block - 1) / rows_per_block);
  ln_rows_kernel<<<grid, LN_THREADS, 0, stream>>>(x, g, b, y, n_rows, d, eps);
  return cudaGetLastError();
}

}  // namespace xtag
