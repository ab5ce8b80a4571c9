// The row LayerNorm of the fused block halves (fused_mlp_half.cu,
// fused_attn_half.cu, fused_attn_half_bwd.cu):
//   y[r] = bf16(((x[r] - mean) * rsqrt(var + eps)) * g + b)
// over bf16 rows of D (a multiple of 8, at most 32 * 8 * LN_MAX_VPL = 2048:
// the widest stream the fused halves take is 1280, ViT-bigG-14's text), with
// the fp32 statistics and two-pass variance of the Pallas kernels
// (xtagclip_tpu/ops/fused_attn_block.py:458-463, :814-819) and one bf16
// rounding of the output.
//
// Bound on the H100: bytes (x read once, y written once: 4.9 MB at the
// ViT-B-32 vision rows, N = 1600, D = 768, 1.5 us at 3.35 TB/s). The
// kernel reads each row once: one warp a row, 16-byte loads of 8 bf16
// held in registers (VPL vectors a lane), the mean and the centred sum of
// squares over those registers, then 16-byte stores; g and b arrive as
// 16-byte fp32 loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xtag {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int LN_THREADS = 128;  // four rows a block
constexpr int LN_MAX_VPL = 8;    // 16-byte vectors a lane: D <= 2048

template <int VPL>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int n_rows, int d,
               float eps) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int nv = d >> 3;  // 16-byte vectors in a row
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  uint4 v[VPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < nv ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / (float)d;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i >= nv) continue;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      const float t0 = f.x - mean, t1 = f.y - mean;
      var += t0 * t0 + t1 * t1;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)d + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c >= nv) continue;
    const float4* g4 = reinterpret_cast<const float4*>(g) + 2 * c;
    const float4* b4 = reinterpret_cast<const float4*>(b) + 2 * c;
    const float4 ga = __ldg(g4), gb = __ldg(g4 + 1), ba = __ldg(b4), bb = __ldg(b4 + 1);
    const float gs[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const float bs[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      const float t0 = (f.x - mean) * rstd, t1 = (f.y - mean) * rstd;
      o[e] = __floats2bfloat162_rn(t0 * gs[2 * e] + bs[2 * e], t1 * gs[2 * e + 1] + bs[2 * e + 1]);
    }
    yr[c] = out;
  }
}

// Needs d % 8 == 0, d <= 32 * 8 * LN_MAX_VPL, and 16-byte aligned x, y, g, b.
inline cudaError_t launch_ln(const __nv_bfloat16* x, const float* g, const float* b,
                             __nv_bfloat16* y, int n_rows, int d, float eps,
                             cudaStream_t stream) {
  if (d < 8 || d % 8 != 0 || d > 32 * 8 * LN_MAX_VPL) return cudaErrorInvalidValue;
  const int vpl = (d / 8 + 31) / 32;
  const dim3 grid((n_rows + LN_THREADS / 32 - 1) / (LN_THREADS / 32));
  if (vpl <= 1)
    ln_rows_kernel<1><<<grid, LN_THREADS, 0, stream>>>(x, g, b, y, n_rows, d, eps);
  else if (vpl <= 2)
    ln_rows_kernel<2><<<grid, LN_THREADS, 0, stream>>>(x, g, b, y, n_rows, d, eps);
  else if (vpl <= 4)
    ln_rows_kernel<4><<<grid, LN_THREADS, 0, stream>>>(x, g, b, y, n_rows, d, eps);
  else
    ln_rows_kernel<LN_MAX_VPL><<<grid, LN_THREADS, 0, stream>>>(x, g, b, y, n_rows, d, eps);
  return cudaGetLastError();
}

}  // namespace xtag
