// Backward of the attention half of a pre-norm transformer block on Hopper,
// the half being y = x + out_proj(MHA(LN1(x))) (optional additive [L, L]
// fp32 mask). Replaces the Pallas kernel xtagclip_tpu/ops/fused_attn_block.py
// ::_fused_attn_half_bwd (:543, pallas_call :722).
//
// From x and the output cotangent g it recomputes the half (nothing is
// saved by the forward but x) and emits dx [N, D] bf16, dqkv [N, 3D] bf16,
// dwout [D, D] fp32 and dbout/dls/dlb [D] fp32 summed over all N = B*L
// rows. dwqkv = xn^T dqkv and dbqkv are left to the caller, as the JAX
// package leaves them to XLA.
//
// Rounding points are the Pallas kernel's (:560-565): xn, q/k/v, datt =
// g wout^T, p (for P V and dV), dp = dO V^T, dV, dQ, dK and dxn = dqkv
// wqkv^T round to bf16; LN statistics, scores, softmax, ds = p (dp -
// rowsum(dp p)) scale, the LN backward and every sum stay fp32. dQ = dS K
// and dK = dS^T Q take ds in fp32 (it is not bf16-representable): on the
// tensor cores ds runs as three bf16 terms hi + mid + lo (each the bf16
// rounding of what the terms before it leave), which carry its 24-bit
// significand to within a few fp32 ulps, three wgmmas a product against
// the bf16 K or Q, summed in fp32: the fp32-FMA sum up to summation order.
//
// Design. The Pallas kernel walks the batch in order and carries dwout and
// the [D] sums in VMEM from one grid step to the next; CUDA blocks run in
// no order, so here each carried sum is a pass of its own: dwout is one
// GEMM att^T g contracting all N rows, and the [D] sums are per-split
// column partials plus a second pass that adds the splits in a fixed
// order (no atomics: a run repeats bit for bit). Nine launches on the
// caller's stream, every product on wgmma:
//   1. LN1 rows -> xn (ln_rows.cuh);
//   2. xn wqkv + bqkv -> qkv (gemm_sm90.cuh, EPI_BIAS);
//   3. g wout^T -> datt (gemm_sm90.cuh, B read K-major, EPI_NONE);
//   4. the attention core below -> att [N, D], dqkv [N, 3D];
//   5. att^T g -> dwout (gemm_sm90.cuh, A read M-major, fp32 out, K = N
//      ragged);
//   6. dqkv wqkv^T -> dxn (gemm_sm90.cuh, B read K-major, EPI_NONE);
//   7. the LN backward rows, one warp a row held in registers -> dx (+
//      row mean and rstd);
//   8. column partials of g, dxn xhat, dxn over row splits;
//   9. the splits added in order -> dbout, dls, dlb.
// The weights are read as stored in every product (the transposes are
// wgmma's transpose bits), and TMA zero-fills every ragged edge.
//
// The core: one block per (head, batch) with all L <= 128 keys in one tile
// (NK = 64 or 128, L padded), one consumer warpgroup per 64 query rows.
// One thread loads Q, K, V and dO of the head by TMA (4-D tensor maps
// over the strided [B, H, L, 64] views, rows past L zero-filled). Each
// warpgroup, on its query rows:
//   - S = Q K^T and dp = dO V^T, wgmma from shared memory (K, V K-major);
//   - the forward's exact softmax (flash_common.cuh::softmax_rows):
//     p fp32 in registers, 0 on rows and keys past L; bf16(p) into a
//     swizzled shared copy P;
//   - dp rounded to bf16, ds = p (dp - rowsum(dp p)) scale in fp32, split
//     into hi + mid + lo, each into a swizzled shared copy;
// then, once both warpgroups have written theirs:
//   - att = P V and dQ = (hi + mid + lo) K, A K-major from the shared
//     copies, V and K read N-major;
//   - dV = P^T dO and dK = (hi + mid + lo)^T Q for the warpgroup's 64 keys,
//     A read M-major from the same copies (wgmma's transpose bit for A),
//     dO and Q read N-major: nothing is transposed through memory.
// Each output rounds once to bf16, rows past L not stored. Shared memory:
// 64 KB a block at NK = 64, 193 KB at NK = 128.
//
// Bound on the H100: operations (2 B L D (8 D + 6 L) FLOP, the Pallas
// CostEstimate), about 16 us at the ViT-B/32 vision shape at 989 TFLOP/s.
#include "flash_common.cuh"
#include "gemm_sm90.cuh"
#include "ln_rows.cuh"

namespace xtag {

constexpr int COL_SPLITS = 32;  // row splits of the [D] sums

namespace attn_bwd {

using sm90::smem_u32;

constexpr int DH = 64;
constexpr int MAX_L = 128;

template <int NK>
struct Smem {
  static constexpr int T_BYTES = NK * DH * 2;  // one of Q, K, V, dO
  static constexpr int P_BYTES = NK * NK * 2;  // one [NK queries x NK keys] bf16 copy
  // Q, K, V, dO; P and the three terms of ds; the barrier; slack for the
  // 1024-byte grid of the 128-byte swizzle
  static constexpr size_t BYTES = (size_t)4 * T_BYTES + 4 * P_BYTES + 8 + 1024;
};

template <int NK>
__global__ void __launch_bounds__(2 * NK, 1)
attn_bwd_core_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, int h_first,
                     const float* __restrict__ mask_t, bf16* __restrict__ att,
                     bf16* __restrict__ dqkv, int L, int D, float scale) {
  using namespace sm90;
  using Sm = Smem<NK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qb = base;
  unsigned char* Kb = Qb + Sm::T_BYTES;
  unsigned char* Vb = Kb + Sm::T_BYTES;
  unsigned char* dOb = Vb + Sm::T_BYTES;
  bf16* Ps = reinterpret_cast<bf16*>(dOb + Sm::T_BYTES);
  bf16* DSs = Ps + NK * NK;  // [3][NK x NK]: hi, mid, lo
  uint64_t* full = reinterpret_cast<uint64_t*>(DSs + 3 * NK * NK);
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full, 4 * Sm::T_BYTES);
    load_box(&map_q, h_first & 1, Qb, full, 0, 0, h, b);
    load_box(&map_k, h_first & 2, Kb, full, 0, 0, h, b);
    load_box(&map_v, h_first & 4, Vb, full, 0, 0, h, b);
    load_box(&map_do, h_first & 8, dOb, full, 0, 0, h, b);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  const int r0 = wg * 64 + warp * 16;  // this warp's first query (or key) row
  const uint32_t q_addr = smem_u32(Qb);
  const uint32_t k_addr = smem_u32(Kb);
  const uint32_t v_addr = smem_u32(Vb);
  const uint32_t do_addr = smem_u32(dOb);
  const uint32_t p_addr = smem_u32(Ps);
  const uint32_t ds_addr = smem_u32(DSs);
  mbar_wait(full, 0);

  // S = Q K^T and dp = dO V^T on this warpgroup's 64 query rows: A and B
  // K-major (dh along the 128-byte rows), a k-step of 16 is 32 bytes
  float s[NK / 2], dp[NK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<0>(s, wgmma_desc(q_addr + wg * 64 * 128 + kk * 32, 16, 1024),
                wgmma_desc(k_addr + kk * 32, 16, 1024), kk > 0 ? 1 : 0);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<0>(dp, wgmma_desc(do_addr + wg * 64 * 128 + kk * 32, 16, 1024),
                wgmma_desc(v_addr + kk * 32, 16, 1024), kk > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
  fence_operands(dp);

  // the forward's softmax of rows r0 + g and r0 + g + 8 (p = 0 on rows
  // past L), and rowsum(bf16(dp) p) over the quad
  softmax_rows<NK>(s, r0 + g, t, threadIdx.x, L, mask_t, scale);
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[4 * jj + e] = __bfloat162float(__float2bfloat16(dp[4 * jj + e]));
      rs[e >> 1] += dp[4 * jj + e] * s[4 * jj + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
  // bf16(p) into P, and ds = p (dp - rowsum) scale as hi + mid + lo into
  // the three shared copies, all [NK queries x NK keys] in the swizzled
  // panel layout (pan) that wgmma reads
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = pan<NK>(r0 + g + 8 * r, 8 * jj + 2 * t);
      const float p0 = s[4 * jj + 2 * r], p1 = s[4 * jj + 2 * r + 1];
      *reinterpret_cast<uint32_t*>(Ps + off) = pack_bf16(p0, p1);
      float d0 = p0 * (dp[4 * jj + 2 * r] - rs[r]) * scale;
      float d1 = p1 * (dp[4 * jj + 2 * r + 1] - rs[r]) * scale;
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(d0, d1);
        *reinterpret_cast<__nv_bfloat162*>(DSs + term * NK * NK + off) = v;
        const float2 f = __bfloat1622float2(v);
        d0 -= f.x;  // exact: what the bf16 term leaves
        d1 -= f.y;
      }
    }
  fence_proxy_async();  // the copies, visible to wgmma's reads
  __syncthreads();

  // a [64 x 64] fp32 accumulator of this warpgroup rounded to bf16 into
  // rows wg * 64 + (warp * 16 + g, + 8) < L of dst (row stride ld)
  auto store = [&](const float (&a)[DH / 2], bf16* dst, size_t ld) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= L) continue;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + row * ld + 8 * j + 2 * t) =
            pack_bf16(a[4 * j + 2 * r], a[4 * j + 2 * r + 1]);
    }
  };
  // A of this warpgroup's query rows from a shared copy, K-major: 64-key
  // panels NK * 128 bytes apart, a k-step of 16 keys is 32 bytes
  auto a_rows = [&](uint32_t copy, int kk) {
    return wgmma_desc(copy + (kk >> 2) * (NK * 128) + wg * 64 * 128 + (kk & 3) * 32, 16, 1024);
  };
  // A^T of this warpgroup's 64 keys from a shared copy, M-major: the
  // keys' panel, a k-step of 16 queries is 16 rows, 2048 bytes
  auto a_cols = [&](uint32_t copy, int kk) {
    return wgmma_desc(copy + wg * (NK * 128) + kk * 2048, NK * 128, 1024);
  };
  // B read N-major (dh along the rows): a k-step is 16 rows, 2048 bytes
  auto b_rows = [&](uint32_t tile, int kk) {
    return wgmma_desc(tile + kk * 2048, NK * 128, 1024);
  };
  const size_t ld = (size_t)3 * D;
  bf16* dq_b = dqkv + (size_t)b * L * ld + (size_t)h * DH;

  // att = P V and dQ = (hi + mid + lo) K
  float o[DH / 2], dq[DH / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_ss<1>(o, a_rows(p_addr, kk), b_rows(v_addr, kk), kk > 0 ? 1 : 0);
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_ss<1>(dq, a_rows(ds_addr + term * Sm::P_BYTES, kk), b_rows(k_addr, kk),
                  (term > 0 || kk > 0) ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  fence_operands(dq);
  store(o, att + (size_t)b * L * D + (size_t)h * DH, D);
  store(dq, dq_b, ld);

  // dV = P^T dO and dK = (hi + mid + lo)^T Q for keys wg * 64 .. + 63
  float dv[DH / 2], dk[DH / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_ss<1, 1>(dv, a_cols(p_addr, kk), b_rows(do_addr, kk), kk > 0 ? 1 : 0);
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_ss<1, 1>(dk, a_cols(ds_addr + term * Sm::P_BYTES, kk), b_rows(q_addr, kk),
                     (term > 0 || kk > 0) ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dv);
  fence_operands(dk);
  store(dk, dq_b + D, ld);
  store(dv, dq_b + 2 * D, ld);
}

// qkv [B L, 3D] and datt [B L, D] bf16 -> att [B L, D], dqkv [B L, 3D]
// bf16; NK = 64 for L <= 64, else 128. A mask is first laid out by thread
// into mask_ws (NK * NK fp32).
template <int NK>
cudaError_t launch_core(const bf16* qkv, const bf16* datt, const float* mask, float* mask_ws,
                        bf16* att, bf16* dqkv, int B, int L, int D, int H, float scale,
                        cudaStream_t stream) {
  if (mask != nullptr) {
    const cudaError_t e = launch_mask_by_thread<NK>(mask, mask_ws, L, stream);
    if (e != cudaSuccess) return e;
  }
  // [B, H, L, 64] views of the [B L, 3D] and [B L, D] buffers
  const Strides sq{(long long)L * 3 * D, DH, 3LL * D};
  const Strides sd{(long long)L * D, DH, (long long)D};
  CUtensorMap mq, mk, mv, mdo;
  bool hq, hk, hv, hdo;
  if (!make_view_map(&mq, qkv, sq, B, H, L, DH, NK, &hq) ||
      !make_view_map(&mk, qkv + D, sq, B, H, L, DH, NK, &hk) ||
      !make_view_map(&mv, qkv + 2 * D, sq, B, H, L, DH, NK, &hv) ||
      !make_view_map(&mdo, datt, sd, B, H, L, DH, NK, &hdo))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<NK>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_core_kernel<NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  attn_bwd_core_kernel<NK><<<dim3(H, B), 2 * NK, smem, stream>>>(
      mq, mk, mv, mdo, (hq ? 1 : 0) | (hk ? 2 : 0) | (hv ? 4 : 0) | (hdo ? 8 : 0),
      mask == nullptr ? nullptr : mask_ws, att, dqkv, L, D, scale);
  return cudaGetLastError();
}

}  // namespace attn_bwd

// The LN backward, one warp a row (fused_attn_block.py:666-670):
// dx = bf16(g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))),
// dxhat = dxn gamma, with the forward's two-pass statistics. Also stores
// the row's mean and rstd for the column sums. As ln_rows.cuh, the row's
// x and dxn are read once, 16 bytes a lane, into registers (VPL vectors
// of 8 a lane).
template <int VPL>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ dxn, const float* __restrict__ gamma,
                   bf16* __restrict__ dx, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, int n_rows, int d, float eps) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int nv = d >> 3;  // 16-byte vectors in a row
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const uint4* dr = reinterpret_cast<const uint4*>(dxn + (size_t)row * d);
  float xv[VPL][8], dv[VPL][8];  // x, then xhat; dxhat = dxn gamma
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const bool in = c < nv;
    const uint4 a = in ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
    const uint4 b = in ? dr[c] : make_uint4(0u, 0u, 0u, 0u);
    const float4* g4 = reinterpret_cast<const float4*>(gamma) + 2 * c;
    const float4 ga = in ? __ldg(g4) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 gb = in ? __ldg(g4 + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
    const float2 gp[4] = {make_float2(ga.x, ga.y), make_float2(ga.z, ga.w),
                          make_float2(gb.x, gb.y), make_float2(gb.z, gb.w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(ah[e]);
      const float2 fb = __bfloat1622float2(bh[e]);
      xv[i][2 * e] = fa.x;
      xv[i][2 * e + 1] = fa.y;
      dv[i][2 * e] = fb.x * gp[e].x;
      dv[i][2 * e + 1] = fb.y * gp[e].y;
      s += fa.x + fa.y;
    }
  }
  const float mean = warp_sum(s) / (float)d;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i >= nv) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = xv[i][e] - mean;
      var += t * t;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)d + eps);
  float s1 = 0.f;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i >= nv) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xv[i][e] = (xv[i][e] - mean) * rstd;
      s1 += dv[i][e];
      s2 += dv[i][e] * xv[i][e];
    }
  }
  const float m1 = warp_sum(s1) / (float)d;
  const float m2 = warp_sum(s2) / (float)d;
  const uint4* gr = reinterpret_cast<const uint4*>(g + (size_t)row * d);
  uint4* out = reinterpret_cast<uint4*>(dx + (size_t)row * d);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c >= nv) continue;
    const uint4 gv = gr[c];
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gv);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fg = __bfloat1622float2(gh[e]);
      oh[e] = __floats2bfloat162_rn(
          fg.x + rstd * (dv[i][2 * e] - m1 - xv[i][2 * e] * m2),
          fg.y + rstd * (dv[i][2 * e + 1] - m1 - xv[i][2 * e + 1] * m2));
    }
    out[c] = o;
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Needs d % 8 == 0, d <= 32 * 8 * LN_MAX_VPL, 16-byte aligned rows and gamma.
inline cudaError_t launch_ln_bwd_rows(const bf16* x, const bf16* g, const bf16* dxn,
                                      const float* gamma, bf16* dx, float* mean, float* rstd,
                                      int n_rows, int d, float eps, cudaStream_t stream) {
  if (d < 8 || d % 8 != 0 || d > 32 * 8 * LN_MAX_VPL) return cudaErrorInvalidValue;
  const int vpl = (d / 8 + 31) / 32;
  const dim3 grid((n_rows + LN_THREADS / 32 - 1) / (LN_THREADS / 32));
  if (vpl <= 1)
    ln_bwd_rows_kernel<1><<<grid, LN_THREADS, 0, stream>>>(x, g, dxn, gamma, dx, mean, rstd,
                                                           n_rows, d, eps);
  else if (vpl <= 2)
    ln_bwd_rows_kernel<2><<<grid, LN_THREADS, 0, stream>>>(x, g, dxn, gamma, dx, mean, rstd,
                                                           n_rows, d, eps);
  else if (vpl <= 4)
    ln_bwd_rows_kernel<4><<<grid, LN_THREADS, 0, stream>>>(x, g, dxn, gamma, dx, mean, rstd,
                                                           n_rows, d, eps);
  else
    ln_bwd_rows_kernel<LN_MAX_VPL><<<grid, LN_THREADS, 0, stream>>>(x, g, dxn, gamma, dx, mean,
                                                                    rstd, n_rows, d, eps);
  return cudaGetLastError();
}

// Column partials over one split of the rows: partial[split][0] = sum g,
// [1] = sum dxn xhat, [2] = sum dxn. Block (32 columns, 8 row lanes).
__global__ void __launch_bounds__(256)
ln_bwd_cols_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ dxn, const float* __restrict__ mean,
                   const float* __restrict__ rstd, float* __restrict__ partial,
                   int n_rows, int d) {
  __shared__ float red[3][8][33];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  const int split = blockIdx.y;
  const int per = (n_rows + gridDim.y - 1) / gridDim.y;
  const int r0 = split * per;
  const int r1 = min(n_rows, r0 + per);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int r = r0 + ty; r < r1; r += 8) {
    const size_t off = (size_t)r * d + col;
    const float xhat = (__bfloat162float(x[off]) - mean[r]) * rstd[r];
    const float dn = __bfloat162float(dxn[off]);
    a0 += __bfloat162float(g[off]);
    a1 += dn * xhat;
    a2 += dn;
  }
  red[0][ty][tx] = a0;
  red[1][ty][tx] = a1;
  red[2][ty][tx] = a2;
  __syncthreads();
  if (ty < 3) {
    float sum = 0.f;
    for (int y = 0; y < 8; ++y) sum += red[ty][y][tx];
    partial[((size_t)split * 3 + ty) * d + col] = sum;
  }
}

// The splits added in order: out[k][col] = sum over splits of partial.
__global__ void col_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbout,
                               float* __restrict__ dls, float* __restrict__ dlb,
                               int splits, int d) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * d) return;
  const int k = idx / d;
  const int col = idx - k * d;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += partial[((size_t)sp * 3 + k) * d + col];
  float* out = k == 0 ? dbout : (k == 1 ? dls : dlb);
  out[col] = sum;
}

}  // namespace xtag

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, g, dx: [B, L, D] bf16; ln_g/ln_b: [D] fp32; wqkv: [D, 3D] bf16;
// bqkv: [3D] fp32; wout: [D, D] bf16; mask: [L, L] fp32 or null.
// Outputs: dx, dqkv [B, L, 3D] bf16; dwout [D, D] fp32; dbout, dls, dlb
// [D] fp32. Scratch from the caller: xn, datt, att, dxn [B*L, D] and qkv
// [B*L, 3D] bf16; stats [2 * B*L] fp32; partial [32 * 3 * D] fp32; with
// a mask, mask_ws [128 * 128] fp32 (else unread). Returns a cudaError_t
// (0 = launched).
int xtag_fused_attn_half_bwd(const void* x, const void* g, const float* ln_g,
                             const float* ln_b, const void* wqkv, const float* bqkv,
                             const void* wout, const float* mask, void* xn_ws,
                             void* qkv_ws, void* datt_ws, void* att_ws, void* dxn_ws,
                             float* stats_ws, float* partial_ws, float* mask_ws, void* dx,
                             void* dqkv,
                             float* dwout, float* dbout, float* dls, float* dlb, int B,
                             int L, int D, int H, float eps, void* stream) {
  using namespace xtag;
  using attn_bwd::DH;
  using sm90::launch_gemm;
  if (D != H * DH || L < 1 || L > attn_bwd::MAX_L || D % 64 != 0 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * L;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  bf16* xn = static_cast<bf16*>(xn_ws);
  bf16* qkv = static_cast<bf16*>(qkv_ws);
  bf16* datt = static_cast<bf16*>(datt_ws);
  bf16* att = static_cast<bf16*>(att_ws);
  bf16* dxn = static_cast<bf16*>(dxn_ws);
  bf16* dq = static_cast<bf16*>(dqkv);
  cudaError_t e = launch_ln(xb, ln_g, ln_b, xn, n, D, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<sm90::EPI_BIAS>(xn, wq, bqkv, nullptr, qkv, n, 3 * D, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<sm90::EPI_NONE, false, true>(gb, static_cast<const bf16*>(wout), nullptr,
                                               nullptr, datt, n, D, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  e = L <= 64
          ? attn_bwd::launch_core<64>(qkv, datt, mask, mask_ws, att, dq, B, L, D, H, scale, s)
          : attn_bwd::launch_core<128>(qkv, datt, mask, mask_ws, att, dq, B, L, D, H, scale, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<sm90::EPI_F32, true, false>(att, gb, nullptr, nullptr, dwout, D, D, n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<sm90::EPI_NONE, false, true>(dq, wq, nullptr, nullptr, dxn, n, D, 3 * D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* mean = stats_ws;
  float* rstd = stats_ws + n;
  e = launch_ln_bwd_rows(xb, gb, dxn, ln_g, static_cast<bf16*>(dx), mean, rstd, n, D, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_cols_kernel<<<dim3(D / 32, COL_SPLITS), dim3(32, 8), 0, s>>>(xb, gb, dxn, mean, rstd,
                                                                     partial_ws, n, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  col_sum_kernel<<<(3 * D + 255) / 256, 256, 0, s>>>(partial_ws, dbout, dls, dlb, COL_SPLITS, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
