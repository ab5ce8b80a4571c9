// Flash attention backward on Hopper: dq, dk, dv of
//   o = softmax(q k^T * dh^-0.5) v   over [B, H, L, dh] bf16 views, no mask,
// from q, k, v, the forward's output o and fp32 log-sum-exp, and dO.
// Replaces the stock Pallas TPU flash backward that
// xtagclip_tpu/ops/flash_attn.py::flash_mha (:93) reaches through its
// custom VJP (jax.experimental.pallas.ops.tpu.flash_attention, the dq and
// dkv kernels).
//
// Numerics (the Pallas kernels'): D_i = rowsum(dO o) in fp32;
// P = exp(s - lse) in fp32 from the recomputed scores s = q.k * scale;
// dV = bf16(P)^T dO; dP = dO V^T in fp32; dS = (dP - D_i) P scale in fp32;
// dK = bf16(dS)^T Q and dQ = bf16(dS) K; every product accumulates in fp32
// and each gradient rounds once to bf16. Keys past L get P = 0.
//
// Design. The Pallas kernels walk their grid in order and carry dq, dk, dv
// in VMEM scratch from one step to the next; CUDA blocks run in no order,
// so each gradient is owned by one block that loops over the other axis,
// and nothing is added by two blocks (no atomics: runs repeat bit for bit):
//   1. delta: D_i = rowsum(dO o), one warp a row -> [B, H, L] fp32;
//   2. dkv: one block per (64-key tile, head, batch) holds K and V of its
//      tile, loops over 64-query tiles, recomputes S and dP, and keeps dK
//      and dV in WMMA accumulators (each warp 16 key rows);
//   3. dq: one block per (64-query tile, head, batch) holds Q, dO, lse and
//      D of its tile, loops over 64-key tiles, recomputes S and dP, and
//      keeps dQ in WMMA accumulators (each warp 16 query rows).
// S and dP are computed twice (in dkv and in dq): 14 B H L^2 dh FLOP
// against the function's 10. Bound on the H100 at the slice's shape
// (B=32, H=12, L=256, dh=64): bytes. q, k, v, o, dO in and dq, dk, dv out
// are 100.7 MB, 0.030 ms at 3.35 TB/s; the function's 16.1 GFLOP take
// 0.016 ms at 989 TFLOP/s. WMMA tiles through shared memory, no
// asynchronous copies: right and simple first.
#include "flash_common.cuh"

namespace xtag {

// D[row] = sum_c o[row, c] dO[row, c] over rows (b, h, l) of [B, H, L].
template <int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, Strides so, Strides sd, int H, int L,
                   long long n_rows) {
  const long long row = (long long)blockIdx.x * FA_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int l = static_cast<int>(row % L);
  const int h = static_cast<int>((row / L) % H);
  const long long b = row / ((long long)L * H);
  const bf16* orow = o + b * so.b + h * so.h + l * so.l;
  const bf16* drow = dout + b * sd.b + h * sd.h + l * sd.l;
  float s = 0.0f;
  for (int c = lane; c < DH; c += 32)
    s += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// P (bf16) and dS (bf16) of a warp's 16 query rows over a 64-key tile,
// from S and dP (fp32, in place) and the rows' lse and D.
template <int DH>
__device__ __forceinline__ void probs_and_dscores(const float* Ss, const float* dPs,
                                                  bf16* Pb, bf16* dSb, const float* lse_s,
                                                  const float* d_s, int r0, int q0, int k0,
                                                  int L, float scale, int lane) {
  using Ly = FaLayout<DH>;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const bool qok = q0 + row < L;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      float p = 0.0f;
      if (qok && k0 + c < L) p = expf(Ss[row * Ly::S_LD + c] * scale - lse_s[row]);
      const float ds = (dPs[row * Ly::S_LD + c] - d_s[row]) * p * scale;
      if (Pb != nullptr) Pb[row * Ly::P_LD + c] = __float2bfloat16(p);
      dSb[row * Ly::P_LD + c] = __float2bfloat16(ds);
    }
  }
}

// A warp's [16 x DH] fp32 accumulators, rounded to bf16, to rows
// row0..row0+15 (those < L) of dst; staged through the warp's 16 rows of
// an fp32 [64 x S_LD] buffer, one 16-column fragment at a time.
template <int DH>
__device__ __forceinline__ void store_rows_bf16(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* stage,
    bf16* dst, long long row_stride, int row0, int L, int lane) {
  using Ly = FaLayout<DH>;
#pragma unroll
  for (int tj = 0; tj < DH / 16; ++tj) {
    __syncwarp();
    wmma::store_matrix_sync(stage, acc[tj], Ly::S_LD, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4;
      const int c = e & 15;
      if (row0 + r < L)
        dst[(row0 + r) * row_stride + tj * 16 + c] =
            __float2bfloat16(stage[r * Ly::S_LD + c]);
    }
  }
}

template <int DH>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  using Ly = FaLayout<DH>;
  return 4 * Ly::TILE_BYTES + 2 * Ly::S_BYTES + 2 * Ly::P_BYTES + 2 * FA_TILE * 4;
}

template <int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
                 Strides sv, Strides sd, Strides sdk, Strides sdv, int H, int L,
                 float scale) {
  using Ly = FaLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + FA_TILE * Ly::LD;
  bf16* Qs = Vs + FA_TILE * Ly::LD;
  bf16* dOs = Qs + FA_TILE * Ly::LD;
  float* Ss = reinterpret_cast<float*>(dOs + FA_TILE * Ly::LD);
  float* dPs = Ss + FA_TILE * Ly::S_LD;
  bf16* Pb = reinterpret_cast<bf16*>(dPs + FA_TILE * Ly::S_LD);
  bf16* dSb = Pb + FA_TILE * Ly::P_LD;
  float* lse_s = reinterpret_cast<float*>(dSb + FA_TILE * Ly::P_LD);
  float* d_s = lse_s + FA_TILE;

  const int k0 = blockIdx.x * FA_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const long long bh = (long long)b * H + h;

  load_tile<DH>(Ks, Ly::LD, k + b * sk.b + h * sk.h, sk.l, k0, L);
  load_tile<DH>(Vs, Ly::LD, v + b * sv.b + h * sv.h, sv.l, k0, L);
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;

  // this warp's key rows r0..r0+15 of dK and dV
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[DH / 16], dv_acc[DH / 16];
#pragma unroll
  for (int tj = 0; tj < DH / 16; ++tj) {
    wmma::fill_fragment(dk_acc[tj], 0.0f);
    wmma::fill_fragment(dv_acc[tj], 0.0f);
  }

  const int n_qt = (L + FA_TILE - 1) / FA_TILE;
  for (int t = 0; t < n_qt; ++t) {
    const int q0 = t * FA_TILE;
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<DH>(Qs, Ly::LD, qb, sq.l, q0, L);
    load_tile<DH>(dOs, Ly::LD, db, sd.l, q0, L);
    for (int r = threadIdx.x; r < FA_TILE; r += FA_THREADS) {
      const bool ok = q0 + r < L;
      lse_s[r] = ok ? lse[bh * L + q0 + r] : 0.0f;
      d_s[r] = ok ? delta[bh * L + q0 + r] : 0.0f;
    }
    __syncthreads();

    // S and dP for this warp's query rows r0..r0+15, all 64 keys
#pragma unroll
    for (int tj = 0; tj < FA_TILE / 16; ++tj) {
      tile_abt<DH>(Qs + r0 * Ly::LD, Ks + tj * 16 * Ly::LD,
                   Ss + r0 * Ly::S_LD + tj * 16, Ly::S_LD);
      tile_abt<DH>(dOs + r0 * Ly::LD, Vs + tj * 16 * Ly::LD,
                   dPs + r0 * Ly::S_LD + tj * 16, Ly::S_LD);
    }
    __syncwarp();
    probs_and_dscores<DH>(Ss, dPs, Pb, dSb, lse_s, d_s, r0, q0, k0, L, scale, lane);
    __syncthreads();  // dV and dK read every query row of P and dS

    // dV += P^T dO and dK += dS^T Q for this warp's key rows
#pragma unroll
    for (int kk = 0; kk < FA_TILE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fp, fds;
      wmma::load_matrix_sync(fp, Pb + kk * Ly::P_LD + r0, Ly::P_LD);
      wmma::load_matrix_sync(fds, dSb + kk * Ly::P_LD + r0, Ly::P_LD);
#pragma unroll
      for (int tj = 0; tj < DH / 16; ++tj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fdo, fq;
        wmma::load_matrix_sync(fdo, dOs + kk * Ly::LD + tj * 16, Ly::LD);
        wmma::load_matrix_sync(fq, Qs + kk * Ly::LD + tj * 16, Ly::LD);
        wmma::mma_sync(dv_acc[tj], fp, fdo, dv_acc[tj]);
        wmma::mma_sync(dk_acc[tj], fds, fq, dk_acc[tj]);
      }
    }
  }

  // each warp stages through its own 16 rows of Ss, which no other warp
  // reads after the last barrier
  float* stage = Ss + r0 * Ly::S_LD;
  store_rows_bf16<DH>(dk_acc, stage, dk + b * sdk.b + h * sdk.h, sdk.l, k0 + r0, L, lane);
  store_rows_bf16<DH>(dv_acc, stage, dv + b * sdv.b + h * sdv.h, sdv.l, k0 + r0, L, lane);
}

template <int DH>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  using Ly = FaLayout<DH>;
  return 4 * Ly::TILE_BYTES + 2 * Ly::S_BYTES + Ly::P_BYTES + 2 * FA_TILE * 4;
}

template <int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sd,
                Strides sdq, int H, int L, float scale) {
  using Ly = FaLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + FA_TILE * Ly::LD;
  bf16* Ks = dOs + FA_TILE * Ly::LD;
  bf16* Vs = Ks + FA_TILE * Ly::LD;
  float* Ss = reinterpret_cast<float*>(Vs + FA_TILE * Ly::LD);
  float* dPs = Ss + FA_TILE * Ly::S_LD;
  bf16* dSb = reinterpret_cast<bf16*>(dPs + FA_TILE * Ly::S_LD);
  float* lse_s = reinterpret_cast<float*>(dSb + FA_TILE * Ly::P_LD);
  float* d_s = lse_s + FA_TILE;

  const int q0 = blockIdx.x * FA_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const long long bh = (long long)b * H + h;

  load_tile<DH>(Qs, Ly::LD, q + b * sq.b + h * sq.h, sq.l, q0, L);
  load_tile<DH>(dOs, Ly::LD, dout + b * sd.b + h * sd.h, sd.l, q0, L);
  for (int r = threadIdx.x; r < FA_TILE; r += FA_THREADS) {
    const bool ok = q0 + r < L;
    lse_s[r] = ok ? lse[bh * L + q0 + r] : 0.0f;
    d_s[r] = ok ? delta[bh * L + q0 + r] : 0.0f;
  }
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // this warp's query rows r0..r0+15 of dQ
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[DH / 16];
#pragma unroll
  for (int tj = 0; tj < DH / 16; ++tj) wmma::fill_fragment(dq_acc[tj], 0.0f);

  const int n_kt = (L + FA_TILE - 1) / FA_TILE;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * FA_TILE;
    __syncthreads();  // every warp is done with the previous K and V
    load_tile<DH>(Ks, Ly::LD, kb, sk.l, k0, L);
    load_tile<DH>(Vs, Ly::LD, vb, sv.l, k0, L);
    __syncthreads();

#pragma unroll
    for (int tj = 0; tj < FA_TILE / 16; ++tj) {
      tile_abt<DH>(Qs + r0 * Ly::LD, Ks + tj * 16 * Ly::LD,
                   Ss + r0 * Ly::S_LD + tj * 16, Ly::S_LD);
      tile_abt<DH>(dOs + r0 * Ly::LD, Vs + tj * 16 * Ly::LD,
                   dPs + r0 * Ly::S_LD + tj * 16, Ly::S_LD);
    }
    __syncwarp();
    probs_and_dscores<DH>(Ss, dPs, nullptr, dSb, lse_s, d_s, r0, q0, k0, L, scale, lane);
    __syncwarp();

    // dQ += dS K for this warp's query rows
#pragma unroll
    for (int kk = 0; kk < FA_TILE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fds;
      wmma::load_matrix_sync(fds, dSb + r0 * Ly::P_LD + kk, Ly::P_LD);
#pragma unroll
      for (int tj = 0; tj < DH / 16; ++tj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
        wmma::load_matrix_sync(fk, Ks + kk * Ly::LD + tj * 16, Ly::LD);
        wmma::mma_sync(dq_acc[tj], fds, fk, dq_acc[tj]);
      }
    }
  }

  store_rows_bf16<DH>(dq_acc, Ss + r0 * Ly::S_LD, dq + b * sdq.b + h * sdq.h, sdq.l,
                      q0 + r0, L, lane);
}

template <int DH>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                       const bf16* dout, const float* lse, float* delta, bf16* dq,
                       bf16* dk, bf16* dv, const Strides* st, int B, int H, int L,
                       float scale, cudaStream_t stream) {
  const long long n_rows = (long long)B * H * L;
  flash_delta_kernel<DH><<<(unsigned)((n_rows + FA_WARPS - 1) / FA_WARPS), FA_THREADS, 0,
                           stream>>>(o, dout, delta, st[3], st[4], H, L, n_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((L + FA_TILE - 1) / FA_TILE, H, B);
  constexpr size_t dkv_smem = dkv_smem_bytes<DH>();
  e = cudaFuncSetAttribute(flash_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dkv_smem));
  if (e != cudaSuccess) return e;
  flash_dkv_kernel<DH><<<grid, FA_THREADS, dkv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, st[0], st[1], st[2], st[4], st[6], st[7], H, L,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr size_t dq_smem = dq_smem_bytes<DH>();
  e = cudaFuncSetAttribute(flash_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dq_smem));
  if (e != cudaSuccess) return e;
  flash_dq_kernel<DH><<<grid, FA_THREADS, dq_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, st[0], st[1], st[2], st[4], st[5], H, L, scale);
  return cudaGetLastError();
}

}  // namespace xtag

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o, dout, dq, dk, dv: [B, H, L, dh] bf16 views with dh
// contiguous; strides holds the (b, h, l) element strides of the eight in
// that order (24 values). lse: the forward's [B, H, L] fp32 log-sum-exp.
// Scratch from the caller: delta [B, H, L] fp32. dh: 64 or 128.
// Returns a cudaError_t (0 = launched).
int xtag_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta_ws, void* dq,
                        void* dk, void* dv, const long long* strides, int B, int H,
                        int L, int dh, float scale, void* stream) {
  using namespace xtag;
  if (B < 1 || H < 1 || L < 1 || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dh == 64 ? launch_bwd<64>(in(q), in(k), in(v), in(o), in(dout), lse, delta_ws,
                                out(dq), out(dk), out(dv), st, B, H, L, scale, s)
               : launch_bwd<128>(in(q), in(k), in(v), in(o), in(dout), lse, delta_ws,
                                 out(dq), out(dk), out(dv), st, B, H, L, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
