// A Hopper bf16 GEMM with a fused epilogue, for the fused MLP (fused_mlp.cu),
// the MLP half of the fused block (fused_mlp_half.cu), the attention half
// (fused_attn_half.cu) and its backward (fused_attn_half_bwd.cu):
//   C[M, N] = epi(op(A)[M, K] @ op(B)[K, N] + bias[N])
// op(A) is A [M, K] row-major (K contiguous), or with A_T its transpose
// given as [K, M] row-major (M contiguous, wgmma's M-major A); op(B) is B
// [K, N] row-major (N contiguous, the flax [in, out] weight as it is
// stored), or with B_T its transpose given as [N, K] row-major (K
// contiguous: a weight used transposed, as stored). bias fp32, C bf16
// row-major, or fp32 with EPI_F32. The epilogue adds the bias in fp32 and
// applies the exact erf gelu or quick_gelu in fp32, or adds a bf16
// residual R[M, N] in fp32 as resid + (acc + bias) (the Pallas kernel's
// (x32 + (dot + b2)), xtagclip_tpu/ops/fused_attn_block.py:826-829), or
// nothing (EPI_NONE), then rounds once to bf16; EPI_F32 stores the fp32
// sums as they are. The transposed operands and the fp32 output serve the
// attention half's backward: datt = g wout^T and dxn = dqkv wqkv^T (B_T),
// dwout = att^T g (A_T, EPI_F32, K = B L rows).
//
// Design:
// - a persistent grid, one block an SM, walking 128 x BN output tiles
//   (BN 128, or 64 where pick_bn finds the narrower tiles faster; 128 x
//   256 was no faster). Each output element sums its K products in the
//   same order whatever BN is (no split of K), so BN changes no number;
// - a ring of 4 shared-memory stages (128 KB at BN 128, and 64 KB of
//   output tiles beside it), each a 128 x 64
//   tile of A and a 64 x BN tile of B, filled by TMA (cp.async.bulk.tensor,
//   128-byte swizzle) from one producer thread, with mbarrier completion
//   (full barriers: TMA bytes; empty barriers: one arrival per warp of the
//   warpgroup that consumes the stage); the producer runs ahead across
//   tiles, so the next tile's loads overlap this tile's epilogue (a 192 KB
//   ring was slower);
// - two consumer warpgroups in ping-pong: each takes every other tile of
//   the block and runs all 128 rows of it (two wgmma m64nBNk16 a k-step,
//   the sums in registers, one wgmma group kept in flight), so one
//   warpgroup's epilogue overlaps the other's products; setmaxnreg moves
//   registers from the producer to them;
// - B read N-major through wgmma's transpose bit (a 16-bit type allows it),
//   so the weights are used as stored, with no transposed copy; with B_T
//   B is read K-major (one [BN x 64] TMA box a stage, the layout of A),
//   and with A_T A is read M-major through the transpose bit for A (two
//   [64 k x 64 m] boxes a stage): a transposed operand costs no copy and
//   changes no number, since every output element sums its K products in
//   the same order whatever the layouts;
// - the epilogue: bias, activation or residual in fp32 on the registers,
//   one bf16 rounding, written into a [128 x BN] output tile in shared
//   memory (one per consumer) that TMA stores, so the warpgroup goes on to
//   its next tile while the store drains (4-byte stores straight from the
//   registers had held the warpgroup up); the residual tile arrives in the
//   same buffer by TMA under the products. TMA zero-fills what lies past
//   M, N or K on loads and clips stores, so ragged edges need no special
//   path: a K that is no multiple of 64 (dwout's K = B L) ends on a
//   k-step whose products past K multiply zeros. EPI_F32 (dwout: M = N =
//   D, a few dozen tiles) stores its fp32 pairs straight from the
//   registers, with 64-wide tiles: a [128 x 128] fp32 output tile per
//   consumer would not fit beside the ring. No split of K, no atomics:
//   runs repeat bit for bit.
// What holds it back (measured on the H100, chip_smoke.py's ms_by_kernel):
// at #2's precompute chunk (M = 39424) c_proj (K = 2048, bias + residual)
// reaches 55% of the bf16 peak at 128 x 128 tiles (152 us). c_fc does the
// same products at K = 512 and takes 263 us (32%): its epilogue, the exact
// erff gelu on the CUDA cores over 4x c_proj's output elements, costs
// about as much as their 1024 tensor-core FLOP each, and the ping-pong
// hides little of it. A block with a single tile (the serve shapes'
// c_proj) has no second tile to overlap its epilogue with.
// Needs N % 64 == 0, dense row-major operands with 16-byte aligned rows
// and bases (checked by the caller): a K-contiguous operand's K is a
// multiple of 8; a ragged K (dwout's B L) is the outer dimension of the
// M-major A and of B. The tensor maps are encoded on the host through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint: no -lcuda.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace xtag {
namespace sm90 {

constexpr int BM = 128;          // output rows per tile: two warpgroups of 64
constexpr int BK = 64;           // K per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int A_BYTES = BM * BK * 2;            // 16 KB
constexpr int STAGES = 4;
constexpr int B_HALF_BYTES = BK * 64 * 2;       // 8 KB: 64 k rows x 64 columns
constexpr int PRODUCER_REGS = 40;               // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 232;

// a stage: the A tile and BN / 64 column blocks of the B tile; an output
// tile staged for its TMA store: [BM x BN] bf16, one per consumer
template <int BN>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + (BN / 64) * B_HALF_BYTES; }
template <int BN>
__host__ __device__ constexpr int out_bytes() { return BM * BN * 2; }
template <int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)STAGES * stage_bytes<BN>() + (size_t)CONSUMERS * out_bytes<BN>() +
         (2 * STAGES + 2 * CONSUMERS) * 8 + 1024;
}

enum Epilogue : int {
  EPI_BIAS = 0,        // C = bf16(acc + bias)
  EPI_BIAS_GELU = 1,   // C = bf16(gelu(acc + bias))
  EPI_BIAS_QGELU = 2,  // C = bf16(quick_gelu(acc + bias))
  EPI_BIAS_RESID = 3,  // C = bf16(resid + (acc + bias))
  EPI_NONE = 4,        // C = bf16(acc)
  EPI_F32 = 5,         // C = acc, fp32
};

template <int EPI>
__device__ __forceinline__ float activate(float v) {
  if (EPI == EPI_BIAS_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (EPI == EPI_BIAS_QGELU) return v / (1.0f + expf(-1.702f * v));
  return v;
}

// The epilogue of a pair (c0, c1) of an output row, in place at ``out``:
// the residual pair there (EPI_BIAS_RESID) + (acc + bias), or act(acc +
// bias), rounded once to bf16.
template <int EPI>
__device__ __forceinline__ void finish(float a0, float a1, float b0, float b1, bf16* out) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out);
  if (EPI == EPI_BIAS_RESID) {
    const float2 r = __bfloat1622float2(*o);
    *o = __floats2bfloat162_rn(r.x + (a0 + b0), r.y + (a1 + b1));
  } else if (EPI == EPI_NONE) {
    *o = __floats2bfloat162_rn(a0, a1);
  } else {
    *o = __floats2bfloat162_rn(activate<EPI>(a0 + b0), activate<EPI>(a1 + b1));
  }
}

template <int EPI, int BN, bool A_T, bool B_T>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_c,
                 const __grid_constant__ CUtensorMap map_r, const float* __restrict__ bias,
                 float* __restrict__ c32, int M, int N, int K) {
  constexpr int STAGE_BYTES = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stage bases on that grid
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* outs = smem + STAGES * STAGE_BYTES;  // [CONSUMERS] output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + CONSUMERS * out_bytes<BN>());
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;       // [CONSUMERS]: whose products run next
  uint64_t* resid_full = turn + CONSUMERS;  // [CONSUMERS]: a residual tile has landed

  const int wg = threadIdx.x >> 7;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int k_steps = (K + BK - 1) / BK;  // past K: zero-filled

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    for (int w = 0; w < CONSUMERS; ++w) {
      mbar_init(&turn[w], 4);
      mbar_init(&resid_full[w], 1);
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
          if (A_T) {  // [64 k x 64 m] boxes, one per 64 rows of the tile
            tma_load_2d(st, &map_a, &full[stage], m0, ks * BK);
            tma_load_2d(st + A_BYTES / 2, &map_a, &full[stage], m0 + 64, ks * BK);
          } else {
            tma_load_2d(st, &map_a, &full[stage], ks * BK, m0);
          }
          if (B_T) {  // one [BN x 64 k] box
            tma_load_2d(st + A_BYTES, &map_b, &full[stage], ks * BK, n0);
          } else {
#pragma unroll
            for (int half = 0; half < BN / 64; ++half)
              tma_load_2d(st + A_BYTES + half * B_HALF_BYTES, &map_b, &full[stage],
                          n0 + 64 * half, ks * BK);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers, in ping-pong: warpgroup wg takes every other tile of the
    // block's sequence and computes all 128 rows of it, so one warpgroup's
    // epilogue runs while the other's products run. The turn barriers
    // order the two main loops: a warpgroup waits on the ring's stages of
    // its tile only once the other has passed those of the tile before
    // (an mbarrier parity wait must not run more than one phase ahead).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    float d[2][BN / 2];  // rows 0-63 and 64-127 of the tile
    bf16* out = reinterpret_cast<bf16*>(outs + wg * out_bytes<BN>());
    const bool leader = (threadIdx.x & 127) == 0;
    for (int n = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;
         n += CONSUMERS, tile += CONSUMERS * gridDim.x) {
      const int m0 = (tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
      const int panels = (N - n0) / 64 < BN / 64 ? (N - n0) / 64 : BN / 64;  // inside N
      if (leader && EPI != EPI_F32) {
        // the previous tile's store has read the output tile; for
        // EPI_BIAS_RESID the residual tile lands there under the products
        bulk_wait<0, true>();
        if (EPI == EPI_BIAS_RESID) {
          mbar_expect_tx(&resid_full[wg], panels * BM * 64 * 2);
          for (int p = 0; p < panels; ++p)
            tma_load_2d(out + p * BM * 64, &map_r, &resid_full[wg], n0 + 64 * p, m0);
        }
      }
      if (n > 0) mbar_wait(&turn[wg], ((n - 1) / CONSUMERS) & 1);
      const int pos0 = n * k_steps;  // the tile's first stage in the ring's sequence
      for (int ks = 0; ks < k_steps; ++ks) {
        const int pos = pos0 + ks;
        const int stage = pos % STAGES;
        mbar_wait(&full[stage], (pos / STAGES) & 1);
        const uint32_t a_addr = smem_u32(smem + stage * STAGE_BYTES);
        const uint32_t b_addr = smem_u32(smem + stage * STAGE_BYTES + A_BYTES);
        fence_operands(d[0]);
        fence_operands(d[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, the
          //    second 64 rows 8 KB on; a k-step of 16 is 32 bytes along the
          //    swizzled row. A_T: M-major, each 64 rows one [64 k x 64 m]
          //    box (8 KB), 8-row k groups 1024 bytes apart; a k-step is 16
          //    k rows, 2048 bytes.
          // B: N-major; 64-column blocks 8 KB apart (leading offset), 8-row
          //    k groups 1024 bytes apart (stride offset); a k-step is 16
          //    rows, 2048 bytes. B_T: K-major as A, BN rows.
          const uint64_t db = B_T ? wgmma_desc(b_addr + kk * 32, 16, 1024)
                                  : wgmma_desc(b_addr + kk * 2048, B_HALF_BYTES, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint64_t da = A_T ? wgmma_desc(a_addr + h * (64 * 128) + kk * 2048, 64 * 128, 1024)
                                    : wgmma_desc(a_addr + h * (64 * 128) + kk * 32, 16, 1024);
            wgmma_ss<B_T ? 0 : 1, A_T ? 1 : 0>(d[h], da, db, (ks > 0 || kk > 0) ? 1 : 0);
          }
        }
        wgmma_commit();
        fence_operands(d[0]);
        fence_operands(d[1]);
        if (ks > 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          if (lane == 0) mbar_arrive(&empty[(pos - 1) % STAGES]);
        }
      }
      if (lane == 0) mbar_arrive(&turn[(wg + 1) % CONSUMERS]);  // the other's turn
      wgmma_wait<0>();
      fence_operands(d[0]);
      fence_operands(d[1]);
      if (lane == 0) mbar_arrive(&empty[(pos0 + k_steps - 1) % STAGES]);

      if (EPI == EPI_F32) {
        // fp32 pairs (row g or g + 8, columns 8 j + 2 t, + 1) straight to C
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m0 + h * 64 + warp * 16 + g + 8 * r;
            if (row >= M) continue;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = n0 + 8 * j + 2 * t;
              if (col < N)
                *reinterpret_cast<float2*>(c32 + (size_t)row * N + col) =
                    make_float2(d[h][4 * j + 2 * r], d[h][4 * j + 2 * r + 1]);
            }
          }
        }
        continue;
      }
      // epilogue: fragment (row g or g + 8, columns 8 j + 2 t, + 1) of this
      // warp's 16 rows in each half, into the output tile (pan layout,
      // conflict-free under the swizzle), then TMA stores it, clipped to M
      if (EPI == EPI_BIAS_RESID)
        mbar_wait(&resid_full[wg], ((n - wg) / CONSUMERS) & 1);
      else
        named_barrier(1 + wg, 128);  // the leader saw the last store read the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h * 64 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const bool in_n = EPI != EPI_NONE && n0 + col < N;
          const float b0 = in_n ? __ldg(bias + n0 + col) : 0.0f;
          const float b1 = in_n ? __ldg(bias + n0 + col + 1) : 0.0f;
          finish<EPI>(d[h][4 * j], d[h][4 * j + 1], b0, b1, out + pan<BM>(row, col));
          finish<EPI>(d[h][4 * j + 2], d[h][4 * j + 3], b0, b1, out + pan<BM>(row + 8, col));
        }
      }
      fence_proxy_async();  // the tile's writes, visible to the TMA store
      named_barrier(1 + wg, 128);
      if (leader) {
        for (int p = 0; p < panels; ++p) tma_store_2d(&map_c, out + p * BM * 64, n0 + 64 * p, m0);
        bulk_commit();
      }
    }
    if (leader && EPI != EPI_F32) bulk_wait<0, false>();  // the stores are done before the block ends
  }
}

// A dense 2-D bf16 row-major [outer, inner] tensor read in boxes of
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

// The tile width: 64 where the narrower tiles finish first, counting waves
// of tiles over the SMs and each 64-wide wave as 0.55 of a 128-wide one
// (its wgmma reads as much A for half the columns; measured on the H100 at
// #2's shapes); else 128. 64 wins where 128-wide tiles leave most SMs idle
// (a few rows) or cut a ragged last wave (the serve shapes' c_fc); it
// loses on grids of fewer 128-wide tiles than SMs that a second wave of
// 64-wide ones would follow (the serve shapes' c_proj). 192-wide tiles
// spilled and ran slower.
inline int pick_bn(int M, int N) {
  const long long sms = sm_count();
  const long long rows = (M + BM - 1) / BM;
  const long long waves128 = (rows * ((N + 127) / 128) + sms - 1) / sms;
  const long long waves64 = (rows * (N / 64) + sms - 1) / sms;
  return waves64 * 11 < waves128 * 20 ? 64 : 128;
}

template <int EPI, int BN, bool A_T, bool B_T>
inline cudaError_t launch_tiles(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                const CUtensorMap& map_c, const CUtensorMap& map_r,
                                const float* bias, float* c32, int M, int N, int K,
                                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(gemm_sm90_kernel<EPI, BN, A_T, B_T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_sm90_kernel<EPI, BN, A_T, B_T><<<grid, THREADS, smem, stream>>>(
      map_a, map_b, map_c, map_r, bias, c32, M, N, K);
  return cudaGetLastError();
}

// C = epi(op(A) @ op(B) + bias), with resid [M, N] for EPI_BIAS_RESID (else
// unread) and bias unread for EPI_NONE and EPI_F32; C is bf16, or fp32 for
// EPI_F32. See the file note for the layouts and limits.
template <int EPI, bool A_T = false, bool B_T = false>
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias,
                               const bf16* resid, void* C, int M, int N, int K,
                               cudaStream_t stream) {
  if (M < 1 || K < 1 || N % 64 != 0 || N < 64 ||
      (EPI == EPI_BIAS_RESID && resid == nullptr))
    return cudaErrorInvalidValue;
  // A in [BM x 64 k] boxes, or [64 k x 64 m] with A_T; B in [64 k x 64 n]
  // boxes, or [BN x 64 k] with B_T (its box height set below with BN); C
  // and the residual in [BM x 64] boxes, as the output tile's panels
  const int bn = EPI == EPI_F32 ? 64 : pick_bn(M, N);
  CUtensorMap map_a, map_b, map_c{}, map_r{};  // EPI_F32 stores from the registers
  const bool ok =
      (A_T ? make_map(&map_a, A, (uint64_t)M, (uint64_t)K, 64, BK)
           : make_map(&map_a, A, (uint64_t)K, (uint64_t)M, BK, BM)) &&
      (B_T ? make_map(&map_b, B, (uint64_t)K, (uint64_t)N, BK, bn)
           : make_map(&map_b, B, (uint64_t)N, (uint64_t)K, 64, BK)) &&
      (EPI == EPI_F32 ||
       (make_map(&map_c, C, (uint64_t)N, (uint64_t)M, 64, BM) &&
        make_map(&map_r, EPI == EPI_BIAS_RESID ? resid : C, (uint64_t)N, (uint64_t)M, 64, BM)));
  if (!ok) return cudaErrorInvalidValue;
  float* c32 = EPI == EPI_F32 ? static_cast<float*>(C) : nullptr;
  if constexpr (EPI == EPI_F32) {
    return launch_tiles<EPI, 64, A_T, B_T>(map_a, map_b, map_c, map_r, bias, c32, M, N, K,
                                           stream);
  } else {
    return bn == 64
               ? launch_tiles<EPI, 64, A_T, B_T>(map_a, map_b, map_c, map_r, bias, c32, M, N, K,
                                                stream)
               : launch_tiles<EPI, 128, A_T, B_T>(map_a, map_b, map_c, map_r, bias, c32, M, N,
                                                 K, stream);
  }
}

}  // namespace sm90
}  // namespace xtag
