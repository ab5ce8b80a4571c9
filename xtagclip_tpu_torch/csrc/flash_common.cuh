// Device code that flash attention's forward (flash_attn_fwd.cu) and
// backward (flash_attn_bwd.cu), and the attention cores of the fused
// attention half (fused_attn_half.cu) and its backward
// (fused_attn_half_bwd.cu), share: the Strides of a [B, H, L, dh] view,
// the tensor maps that TMA reads such views through, the shared-memory
// layout of the tiles it writes, and the register helpers of the element
// type (bf16, or __half for flash attention's float16 instantiations).
//
// A tensor is read as [B, H, L, dh] through its element strides over b, h
// and l, with dh contiguous, so the model's q/k/v views of one [B, L, 3D]
// projection (BLHD) and BHLD tensors both load without a copy. Rows past L
// load as zero (TMA's out-of-bounds fill).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace xtag {

using sm90::bf16;

struct Strides {  // element strides of a [B, H, L, dh] view
  long long b, h, l;
};

// A tile of rows of one (b, h) slice is DH / 64 TMA boxes of [rows x 64]
// (hopper.cuh's pan layout).
using sm90::pan;

// The tensor map of a [B, H, L, dh] view lists its dims by stride: dh, then
// h before l when h's stride is the smaller (the model's [B, L, 3D]
// projection), b last.
__device__ __forceinline__ void load_box(const CUtensorMap* map, bool h_first, void* dst,
                                         uint64_t* bar, int col, int row, int h, int b) {
  if (h_first)
    sm90::tma_load_4d(dst, map, bar, col, h, row, b);
  else
    sm90::tma_load_4d(dst, map, bar, col, row, h, b);
}

// 2^x (the MUFU instruction; exp(y) is computed as 2^(y log2 e))
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to nearest into a pair of the element type T (bf16
// or __half), as 32 bits; and such a pair back to two floats (exact)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The tensor-map element type of T
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// e / d rounded to nearest, for d >= 1 and a normal or zero quotient (the
// attention cores' p = e / sum, sum >= 1), without the IEEE division's
// range check and its slow path: r = RN(1 / d), q = RN(e r), and one
// correction with the exact remainder e - q d (Markstein), which gives the
// correctly rounded quotient.
__device__ __forceinline__ float div_rn(float e, float r, float d) {
  const float q = e * r;
  return fmaf(fmaf(-q, d, e), r, q);
}

// The [L, L] fp32 mask of the fused attention half's cores laid out by
// thread: element 4 jj + e of consumer thread tid (of T = 2 NK, the
// warpgroups' accumulator layout: row wg 64 + warp 16 + g + 8 (e >> 1),
// key 8 jj + 2 t + (e & 1)) at out[(4 jj + e) T + tid], so a warp's mask
// loads are one 128-byte line each; keys past L hold -inf, rows past L 0.
template <int NK>
__global__ void mask_by_thread_kernel(const float* __restrict__ mask, float* __restrict__ out,
                                      int L) {
  constexpr int T = 2 * NK;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (NK / 2) * T) return;
  const int j = i / T;
  const int tid = i % T;
  const int lane = tid & 31;
  const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * ((j & 3) >> 1);
  const int key = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
  out[i] = key >= L ? -INFINITY : (row >= L ? 0.0f : mask[(size_t)row * L + key]);
}

template <int NK>
inline cudaError_t launch_mask_by_thread(const float* mask, float* out, int L,
                                         cudaStream_t stream) {
  constexpr int n = (NK / 2) * 2 * NK;
  mask_by_thread_kernel<NK><<<(n + 255) / 256, 256, 0, stream>>>(mask, out, L);
  return cudaGetLastError();
}

// The exact row softmax of the fused attention half's cores, on a
// warpgroup's m64nNK accumulator of scores: consumer thread ``tid``'s rows
// ``row0`` and row0 + 8, key pairs (columns 8 jj + 2 t, + 1). The Pallas
// kernel's arithmetic (xtagclip_tpu/ops/fused_attn_block.py:481-486):
// s * scale after the dot, plus the mask (``mask_t``: the [L, L] mask laid
// out by mask_by_thread_kernel, or null), keys past L at -inf, the row max
// and sum over the quad (shuffles), e = expf(s - max), p = e / sum in fp32
// (div_rn), left in ``s``. Rows past L and whole 8-key groups past L get
// p = 0 without the math.
template <int NK>
__device__ __forceinline__ void softmax_rows(float (&s)[NK / 2], int row0, int t, int tid, int L,
                                             const float* __restrict__ mask_t, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
  float sum[2] = {0.0f, 0.0f};
  const bool live[2] = {row0 < L, row0 + 8 < L};
  if (mask_t != nullptr) {
    // straight-line loads, so they are all in flight at once (the laid-out
    // mask holds -inf past L)
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      s[i] = s[i] * scale + __ldg(mask_t + i * (2 * NK) + tid);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < NK / 8; ++jj) {
      if (8 * jj < L) {  // else this group lies past L
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * jj + 2 * t + (e & 1);
          s[4 * jj + e] = key < L ? s[4 * jj + e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj) {
    if (8 * jj < L) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[4 * jj + e];
        const float ex = v == -INFINITY ? 0.0f : expf(v - mx[e >> 1]);
        s[4 * jj + e] = ex;
        sum[e >> 1] += ex;
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = __frcp_rn(sum[r]);
  }
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * jj + e] = 8 * jj < L && live[e >> 1]
                          ? div_rn(s[4 * jj + e], inv[e >> 1], sum[e >> 1])
                          : 0.0f;
}

// The tensor map of a [B, H, L, DH] view of 16-bit elements T (bf16 or
// __half) with element strides ``st``,
// read in boxes of [rows x 64]; sets ``h_first`` when h's stride is below
// l's (see load_box). DH is the true head dim: a box's columns past it
// load as zero. False if cuTensorMapEncodeTiled refuses it.
template <typename T>
inline bool make_view_map(CUtensorMap* map, const T* ptr, const Strides& st, int B, int H,
                          int L, int DH, int rows, bool* h_first) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  *h_first = st.h < st.l;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)(*h_first ? H : L),
                              (cuuint64_t)(*h_first ? L : H), (cuuint64_t)B};
  const long long s1 = *h_first ? st.h : st.l;
  const long long s2 = *h_first ? st.l : st.h;
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(*h_first ? 1 : rows),
                             (cuuint32_t)(*h_first ? rows : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, map_type<T>(), 4, const_cast<T*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace xtag
