// Flash attention forward on Hopper: exact-softmax multi-head attention
//   o = softmax(q k^T * dh^-0.5) v   over [B, H, L, dh] bf16 views, no mask,
// and, for the backward, the fp32 log-sum-exp of each query row [B, H, L].
// Replaces the stock Pallas TPU flash kernel that
// xtagclip_tpu/ops/flash_attn.py::flash_mha (:93) calls
// (jax.experimental.pallas.ops.tpu.flash_attention, its forward).
//
// Numerics (the Pallas kernel's): scores q.k accumulated in fp32 and scaled
// after the dot; an online softmax with an fp32 running max m and sum l
// over key tiles; the probabilities exp(s - m) rounded to bf16 UNnormalized
// for P V (as the Pallas kernel's p.astype(v.dtype)), accumulated in fp32;
// the output divided by l at the end and rounded once to bf16. Keys past L
// score -inf. lse = m + log(l).
//
// Design. One block per (64-query tile, head, batch), four warps, each
// owning 16 query rows from end to end, so after a key tile is in shared
// memory a warp runs its scores, softmax update, rescale and P V without
// waiting on the others (two block barriers per key tile). The block loops
// over 64-key tiles of K and V; it does not assume that a head's keys fit
// in shared memory. WMMA bf16 16x16x16 fragments with fp32 accumulators;
// scores and the output accumulator pass through shared memory, where the
// row-wise softmax can read them. 72.5 KB of shared memory at dh = 64
// (113 KB at dh = 128).
// Bound on the H100 at the slice's shape (B=32, H=12, L=256, dh=64): bytes.
// q, k, v and o are 50.3 MB, 0.015 ms at 3.35 TB/s; the 6.44 GFLOP take
// 0.0065 ms at 989 TFLOP/s. A simple WMMA kernel with no asynchronous
// copies sits well above that bound; wgmma, TMA and register-resident
// scores are later work.
#include "flash_common.cuh"

namespace xtag {

template <int DH>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  using Ly = FaLayout<DH>;
  return 3 * Ly::TILE_BYTES + Ly::S_BYTES + Ly::P_BYTES + Ly::O_BYTES;
}

template <int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int L, float scale) {
  using Ly = FaLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + FA_TILE * Ly::LD;
  bf16* Vs = Ks + FA_TILE * Ly::LD;
  float* Ss = reinterpret_cast<float*>(Vs + FA_TILE * Ly::LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + FA_TILE * Ly::S_LD);
  float* Os = reinterpret_cast<float*>(Ps + FA_TILE * Ly::P_LD);

  const int q0 = blockIdx.x * FA_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;  // this warp's first row in the tile

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  load_tile<DH>(Qs, Ly::LD, qb, sq.l, q0, L);
  for (int e = lane; e < 16 * DH; e += 32)
    Os[(r0 + e / DH) * Ly::O_LD + e % DH] = 0.0f;

  // running max and sum of the warp's 16 rows, the same in every lane
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  const int n_kt = (L + FA_TILE - 1) / FA_TILE;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * FA_TILE;
    __syncthreads();  // every warp is done with the previous K and V
    load_tile<DH>(Ks, Ly::LD, kb, sk.l, k0, L);
    load_tile<DH>(Vs, Ly::LD, vb, sv.l, k0, L);
    __syncthreads();

    // S rows r0..r0+15 = Q K^T over this key tile, fp32
#pragma unroll
    for (int tj = 0; tj < FA_TILE / 16; ++tj)
      tile_abt<DH>(Qs + r0 * Ly::LD, Ks + tj * 16 * Ly::LD,
                   Ss + r0 * Ly::S_LD + tj * 16, Ly::S_LD);
    __syncwarp();

    // online softmax: each lane holds key columns lane and lane + 32
    const bool ok0 = k0 + lane < L;
    const bool ok1 = k0 + lane + 32 < L;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const float s0 = ok0 ? Ss[row * Ly::S_LD + lane] * scale : -INFINITY;
      const float s1 = ok1 ? Ss[row * Ly::S_LD + lane + 32] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = (m[r] == -INFINITY) ? 0.0f : expf(m[r] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.0f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.0f;
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      Ps[row * Ly::P_LD + lane] = __float2bfloat16(p0);
      Ps[row * Ly::P_LD + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < DH; c += 32) Os[row * Ly::O_LD + c] *= alpha;
    }
    __syncwarp();

    // O rows r0..r0+15 += P V, fp32
#pragma unroll
    for (int tj = 0; tj < DH / 16; ++tj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* od = Os + r0 * Ly::O_LD + tj * 16;
      wmma::load_matrix_sync(acc, od, Ly::O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FA_TILE; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + r0 * Ly::P_LD + kk, Ly::P_LD);
        wmma::load_matrix_sync(fv, Vs + kk * Ly::LD + tj * 16, Ly::LD);
        wmma::mma_sync(acc, fp, fv, acc);
      }
      wmma::store_matrix_sync(od, acc, Ly::O_LD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + r0 + r;
    if (qrow >= L) continue;
    for (int c = lane; c < DH; c += 32)
      ob[qrow * so.l + c] = __float2bfloat16(Os[(r0 + r) * Ly::O_LD + c] / l[r]);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * L + qrow] = m[r] + logf(l[r]);
  }
}

template <int DH>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                       const Strides* st, int B, int H, int L, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((L + FA_TILE - 1) / FA_TILE, H, B);
  flash_fwd_kernel<DH><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, o, lse, st[0], st[1], st[2], st[3], H, L, scale);
  return cudaGetLastError();
}

}  // namespace xtag

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: [B, H, L, dh] bf16 views with dh contiguous; strides holds
// (b, h, l) element strides of q, k, v and o in that order (12 values).
// lse: [B, H, L] fp32, or null when no backward follows. dh: 64 or 128.
// Returns a cudaError_t (0 = launched).
int xtag_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const long long* strides, int B, int H,
                        int L, int dh, float scale, void* stream) {
  using namespace xtag;
  if (B < 1 || H < 1 || L < 1 || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dh == 64 ? launch_fwd<64>(qb, kb, vb, ob, lse, st, B, H, L, scale, s)
                                 : launch_fwd<128>(qb, kb, vb, ob, lse, st, B, H, L, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
