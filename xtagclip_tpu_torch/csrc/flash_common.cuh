// Device code of the flash attention backward (flash_attn_bwd.cu): tile
// sizes, the shared-memory layout of a head's 64-row tiles and the strided
// tile load; and the Strides of a view, which the forward
// (flash_attn_fwd.cu) shares.
//
// A tensor is read as [B, H, L, dh] through its element strides over b, h
// and l, with dh contiguous, so the model's q/k/v views of one [B, L, 3D]
// projection (BLHD) and BHLD tensors both load without a copy. Rows past L
// load as zero; the kernels mask the scores of keys past L themselves.
#pragma once

#include "block_common.cuh"

namespace xtag {

constexpr int FA_TILE = 64;     // query rows and key rows per tile
constexpr int FA_THREADS = 128; // four warps, 16 rows each
constexpr int FA_WARPS = FA_THREADS / 32;

struct Strides {  // element strides of a [B, H, L, dh] view
  long long b, h, l;
};

// Padded leading dimensions (elements): multiples of 8 bf16 / 4 fp32 as
// WMMA needs, every 16-row fragment start on a 32-byte boundary.
template <int DH>
struct FaLayout {
  static constexpr int LD = DH + 8;         // bf16 [64 x DH] tiles (q, k, v, dO)
  static constexpr int S_LD = FA_TILE + 4;  // fp32 [64 x 64] scores
  static constexpr int P_LD = FA_TILE + 8;  // bf16 [64 x 64] probabilities
  static constexpr int O_LD = DH + 4;       // fp32 [64 x DH] accumulators
  static constexpr size_t TILE_BYTES = (size_t)FA_TILE * LD * 2;
  static constexpr size_t S_BYTES = (size_t)FA_TILE * S_LD * 4;
  static constexpr size_t P_BYTES = (size_t)FA_TILE * P_LD * 2;
  static constexpr size_t O_BYTES = (size_t)FA_TILE * O_LD * 4;
};

// Rows row0..row0+63 of one (b, h) slice into a [64 x DH] smem tile with
// leading dimension ld: 16-byte vectors, neighbouring threads on
// neighbouring addresses within a row; rows >= L are zero.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long row_stride, int row0, int L) {
  constexpr int VPR = DH / 8;  // vectors per row
  for (int v = threadIdx.x; v < FA_TILE * VPR; v += FA_THREADS) {
    const int r = v / VPR;
    const int c = (v % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// A warp's 16 x 16 product tile of two [64 x DH] smem tiles, A rows times
// B rows transposed (S = Q K^T, dP = dO V^T), stored fp32 at dst.
template <int DH>
__device__ __forceinline__ void tile_abt(const bf16* a, const bf16* b, float* dst, int ld_dst) {
  constexpr int LD = FaLayout<DH>::LD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a + kk, LD);
    wmma::load_matrix_sync(fb, b + kk, LD);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(dst, acc, ld_dst, wmma::mem_row_major);
}

}  // namespace xtag
