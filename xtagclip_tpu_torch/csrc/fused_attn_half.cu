// Attention half of a pre-norm transformer block on Hopper:
//   y = x + out_proj(MHA(LN1(x)))   (optional additive [L, L] fp32 mask)
// Replaces the Pallas kernel xtagclip_tpu/ops/fused_attn_block.py
// ::_fused_attn_half_fwd (:434, pallas_call :524).
//
// Four launches on the caller's stream, bf16 intermediates at exactly the
// Pallas kernel's rounding points (see block_common.cuh):
//   1. LN1 rows -> xn [N, D] bf16;
//   2. xn @ wqkv + bqkv -> qkv [N, 3D] bf16 (tensor-core GEMM);
//   3. the attention core, one block per (head, batch): q/k/v of the head
//      in shared memory (all L <= 128 keys), scores q.k in fp32 times
//      dh^-0.5 AFTER the dot, plus the mask, fp32 softmax, probabilities
//      rounded to bf16, P @ V in fp32, the head's output rounded to bf16
//      -> att [N, D];
//   4. att @ wout, then x + (acc + bout) in fp32, rounded once -> y.
// Bound on the H100: operations (the two projections), see the header.
#include "block_common.cuh"

namespace xtag {

constexpr int ATTN_DH = 64;
constexpr int ATTN_THREADS = 128;
constexpr int ATTN_MAX_L = 128;
constexpr int QKV_LD = ATTN_DH + 8;  // bf16
constexpr int O_LD = ATTN_DH + 4;    // fp32

__host__ __device__ inline int attn_pad_len(int L) { return (L + 15) & ~15; }

// Shared bytes: Q, K, V [Lp x 72] bf16; S [Lp x (Lp+4)] fp32;
// P [Lp x (Lp+8)] bf16; O [Lp x 68] fp32. 188 KB at L = 128.
__host__ __device__ inline size_t attn_smem_bytes(int L) {
  const size_t lp = (size_t)attn_pad_len(L);
  return 3 * lp * QKV_LD * 2 + lp * (lp + 4) * 4 + lp * (lp + 8) * 2 + lp * O_LD * 4;
}

__global__ void __launch_bounds__(ATTN_THREADS)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                 bf16* __restrict__ att, int L, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lp = attn_pad_len(L);
  const int nt = lp / 16;
  const int s_ld = lp + 4;
  const int p_ld = lp + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lp * QKV_LD;
  bf16* Vs = Ks + lp * QKV_LD;
  float* Ss = reinterpret_cast<float*>(Vs + lp * QKV_LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + lp * s_ld);
  float* Os = reinterpret_cast<float*>(Ps + lp * p_ld);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = (size_t)3 * D;
  const bf16* base = qkv + (size_t)b * L * row_stride + h * ATTN_DH;

  // q/k/v rows of this head: 8 vectors of 8 bf16 per row; rows >= L zero.
  for (int v = tid; v < 3 * lp * 8; v += ATTN_THREADS) {
    const int which = v / (lp * 8);
    const int rem = v - which * lp * 8;
    const int r = rem >> 3;
    const int c = (rem & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < L)
      val = *reinterpret_cast<const uint4*>(base + (size_t)r * row_stride + which * D + c);
    *reinterpret_cast<uint4*>(Qs + which * lp * QKV_LD + r * QKV_LD + c) = val;
  }
  __syncthreads();

  // S = Q @ K^T in fp32 (K row-major is K^T column-major).
  for (int t = warp; t < nt * nt; t += ATTN_THREADS / 32) {
    const int ti = t / nt;
    const int tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < ATTN_DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + ti * 16 * QKV_LD + kk, QKV_LD);
      wmma::load_matrix_sync(bk, Ks + tj * 16 * QKV_LD + kk, QKV_LD);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * s_ld + tj * 16, acc, s_ld, wmma::mem_row_major);
  }
  __syncthreads();

  // Row softmax in fp32: s * scale + mask; key columns >= L are -inf.
  constexpr int PER_LANE = ATTN_MAX_L / 32;
  for (int i = warp; i < lp; i += ATTN_THREADS / 32) {
    bf16* prow = Ps + i * p_ld;
    if (i >= L) {
      for (int j = lane; j < lp; j += 32) prow[j] = __float2bfloat16(0.0f);
      continue;
    }
    float s[PER_LANE];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + u * 32;
      float val = -INFINITY;
      if (j < L) {
        val = Ss[i * s_ld + j] * scale;
        if (mask != nullptr) val += mask[(size_t)i * L + j];
      }
      s[u] = val;
      m = fmaxf(m, val);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const float e = (s[u] == -INFINITY) ? 0.0f : expf(s[u] - m);
      s[u] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + u * 32;
      if (j < lp) prow[j] = __float2bfloat16(s[u] / sum);
    }
  }
  __syncthreads();

  // O = P @ V in fp32.
  for (int t = warp; t < nt * (ATTN_DH / 16); t += ATTN_THREADS / 32) {
    const int ti = t / (ATTN_DH / 16);
    const int tj = t % (ATTN_DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < lp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, Ps + ti * 16 * p_ld + kk, p_ld);
      wmma::load_matrix_sync(bv, Vs + kk * QKV_LD + tj * 16, QKV_LD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Os + ti * 16 * O_LD + tj * 16, acc, O_LD, wmma::mem_row_major);
  }
  __syncthreads();

  bf16* out = att + (size_t)b * L * D + h * ATTN_DH;
  for (int idx = tid; idx < L * ATTN_DH; idx += ATTN_THREADS) {
    const int r = idx / ATTN_DH;
    const int c = idx % ATTN_DH;
    out[(size_t)r * D + c] = __float2bfloat16(Os[r * O_LD + c]);
  }
}

}  // namespace xtag

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [B, L, D] bf16; ln_g/ln_b: [D] fp32; wqkv: [D, 3D] bf16;
// bqkv: [3D] fp32; wout: [D, D] bf16; bout: [D] fp32; mask: [L, L] fp32
// or null. Scratch from the caller: xn [B*L, D], qkv [B*L, 3D],
// att [B*L, D], all bf16. Returns a cudaError_t (0 = launched).
int xtag_fused_attn_half(const void* x, const float* ln_g, const float* ln_b,
                         const void* wqkv, const float* bqkv, const void* wout,
                         const float* bout, const float* mask, void* xn_ws,
                         void* qkv_ws, void* att_ws, void* out, int B, int L,
                         int D, int H, float eps, void* stream) {
  using namespace xtag;
  if (D != H * ATTN_DH || L < 1 || L > ATTN_MAX_L || D % GEMM_BN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * L;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(xn_ws);
  bf16* qkv = static_cast<bf16*>(qkv_ws);
  bf16* att = static_cast<bf16*>(att_ws);
  cudaError_t e = launch_ln(xb, ln_g, ln_b, xn, n, D, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_BIAS>(xn, static_cast<const bf16*>(wqkv), bqkv, nullptr, qkv, n, 3 * D, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = attn_smem_bytes(L);
  e = cudaFuncSetAttribute(attn_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = 1.0f / sqrtf(static_cast<float>(ATTN_DH));
  attn_core_kernel<<<dim3(H, B), ATTN_THREADS, smem, s>>>(qkv, mask, att, L, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_BIAS_RESID>(att, static_cast<const bf16*>(wout), bout, xb,
                                  static_cast<bf16*>(out), n, D, D, s);
  return static_cast<int>(e);
}

}  // extern "C"
