// Device code that flash attention's forward (flash_attn_fwd.cu) and
// backward (flash_attn_bwd.cu) share: the Strides of a [B, H, L, dh] view,
// the tensor maps that TMA reads such views through, the shared-memory
// layout of the tiles it writes, and two register helpers.
//
// A tensor is read as [B, H, L, dh] through its element strides over b, h
// and l, with dh contiguous, so the model's q/k/v views of one [B, L, 3D]
// projection (BLHD) and BHLD tensors both load without a copy. Rows past L
// load as zero (TMA's out-of-bounds fill).
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace xtag {

using bf16 = __nv_bfloat16;

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

// The tensor map of a [B, H, L, DH] bf16 view with element strides ``st``,
// read in boxes of [rows x 64]; sets ``h_first`` when h's stride is below
// l's (see load_box). False if cuTensorMapEncodeTiled refuses it.
inline bool make_view_map(CUtensorMap* map, const bf16* ptr, const Strides& st, int B, int H,
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
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace xtag
