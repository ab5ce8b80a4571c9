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
// and dK = dS^T Q take fp32 operands (ds is not bf16-representable), so
// they run as fp32 FMAs, not on the tensor cores.
//
// Design. The Pallas kernel walks the batch in order and carries dwout and
// the [D] sums in VMEM from one grid step to the next; CUDA blocks run in
// no order, so here each carried sum is a pass of its own: dwout is one
// GEMM att^T g contracting all N rows, and the [D] sums are per-split
// column partials plus a second pass that adds the splits in a fixed
// order (no atomics: a run repeats bit for bit). Nine launches on the
// caller's stream:
//   1. LN1 rows -> xn;                     2. xn wqkv + bqkv -> qkv;
//   3. g wout^T -> datt (B transposed);
//   4. the attention core, one block per (head, batch) with all L <= 128
//      keys in shared memory: S, p, att = P V, dV = P^T dO, dp = dO V^T,
//      ds, dQ, dK -> att [N, D], dqkv [N, 3D];
//   5. att^T g -> dwout (A transposed, fp32 out, K = N ragged);
//   6. dqkv wqkv^T -> dxn (B transposed);
//   7. the LN backward rows, one warp a row -> dx (+ row mean and rstd);
//   8. column partials of g, dxn xhat, dxn over row splits;
//   9. the splits added in order -> dbout, dls, dlb.
// Bound on the H100: operations (2 B L D (8 D + 6 L) FLOP, the Pallas
// CostEstimate), about 16 us at the ViT-B/32 vision shape at 989 TFLOP/s.
// The GEMMs are block_common.cuh's plain WMMA tiles and the fp32 dQ/dK run
// on the CUDA cores, so the kernel sits far from that bound: simple and
// right first, wgmma/TMA is later work.
#include "block_common.cuh"

namespace xtag {

constexpr int BWD_DH = 64;
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_L = 128;
constexpr int BWD_QKV_LD = BWD_DH + 8;  // bf16
constexpr int BWD_STAGE_LD = 16 + 4;    // fp32, one 16x16 tile per warp
constexpr int BWD_ROWS = 8;             // rows of dQ / dK a thread holds
constexpr int COL_SPLITS = 32;          // row splits of the [D] sums

__host__ __device__ inline int bwd_pad_len(int L) { return (L + 15) & ~15; }

// Shared bytes: Q, K, V, dO [Lp x 72] bf16; S [Lp x (Lp+4)] fp32 (p, then
// ds); P [Lp x (Lp+8)] bf16 (p, then dp); a [16 x 20] fp32 staging tile per
// warp. 181 KB at L = 128.
__host__ __device__ inline size_t bwd_smem_bytes(int L) {
  const size_t lp = (size_t)bwd_pad_len(L);
  return 4 * lp * BWD_QKV_LD * 2 + lp * (lp + 4) * 4 + lp * (lp + 8) * 2 +
         (size_t)BWD_WARPS * 16 * BWD_STAGE_LD * 4;
}

// Round a warp's 16x16 fp32 tile (in its staging buffer) to bf16 and store
// the rows below `rows` at dst (row stride `ld` elements).
__device__ __forceinline__ void store_tile_bf16(const float* stage, bf16* dst, int ld,
                                                int rows, int lane) {
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = e >> 4;
    const int c = e & 15;
    if (r < rows) dst[(size_t)r * ld + c] = __float2bfloat16(stage[r * BWD_STAGE_LD + c]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(BWD_THREADS)
attn_bwd_core_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                     const float* __restrict__ mask, bf16* __restrict__ att,
                     bf16* __restrict__ dqkv, int L, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lp = bwd_pad_len(L);
  const int nt = lp / 16;
  const int s_ld = lp + 4;
  const int p_ld = lp + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lp * BWD_QKV_LD;
  bf16* Vs = Ks + lp * BWD_QKV_LD;
  bf16* dOs = Vs + lp * BWD_QKV_LD;
  float* Ss = reinterpret_cast<float*>(dOs + lp * BWD_QKV_LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + lp * s_ld);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* stage = reinterpret_cast<float*>(Ps + lp * p_ld) + warp * 16 * BWD_STAGE_LD;
  const size_t qkv_stride = (size_t)3 * D;
  const bf16* qkv_b = qkv + (size_t)b * L * qkv_stride + h * BWD_DH;
  const bf16* do_b = datt + (size_t)b * L * D + h * BWD_DH;
  bf16* att_b = att + (size_t)b * L * D + h * BWD_DH;
  bf16* dqkv_b = dqkv + (size_t)b * L * qkv_stride + h * BWD_DH;

  // q, k, v and dO rows of this head: 8 vectors of 8 bf16 a row; rows >= L
  // are zero.
  for (int v = tid; v < 4 * lp * 8; v += BWD_THREADS) {
    const int which = v / (lp * 8);
    const int rem = v - which * lp * 8;
    const int r = rem >> 3;
    const int c = (rem & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < L) {
      const bf16* src = which < 3 ? qkv_b + (size_t)r * qkv_stride + which * D + c
                                  : do_b + (size_t)r * D + c;
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(Qs + which * lp * BWD_QKV_LD + r * BWD_QKV_LD + c) = val;
  }
  __syncthreads();

  // S = Q K^T in fp32.
  for (int t = warp; t < nt * nt; t += BWD_WARPS) {
    const int ti = t / nt;
    const int tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < BWD_DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + ti * 16 * BWD_QKV_LD + kk, BWD_QKV_LD);
      wmma::load_matrix_sync(bk, Ks + tj * 16 * BWD_QKV_LD + kk, BWD_QKV_LD);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * s_ld + tj * 16, acc, s_ld, wmma::mem_row_major);
  }
  __syncthreads();

  // Row softmax in fp32, the forward's arithmetic: s * scale + mask, key
  // columns >= L are -inf. p stays in S (fp32) and goes to P (bf16); rows
  // and columns past L hold 0 in both.
  constexpr int PER_LANE = BWD_MAX_L / 32;
  for (int i = warp; i < lp; i += BWD_WARPS) {
    float* srow = Ss + i * s_ld;
    bf16* prow = Ps + i * p_ld;
    if (i >= L) {
      for (int j = lane; j < lp; j += 32) {
        srow[j] = 0.0f;
        prow[j] = __float2bfloat16(0.0f);
      }
      continue;
    }
    float s[PER_LANE];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + u * 32;
      float val = -INFINITY;
      if (j < L) {
        val = srow[j] * scale;
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
      if (j < lp) {
        const float p = s[u] / sum;
        srow[j] = p;
        prow[j] = __float2bfloat16(p);
      }
    }
  }
  __syncthreads();

  // att = P V (the head's output, as in the forward) and dV = P^T dO, in
  // fp32, rounded to bf16.
  for (int t = warp; t < nt * (BWD_DH / 16); t += BWD_WARPS) {
    const int ti = t / (BWD_DH / 16);
    const int tj = t % (BWD_DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < lp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, Ps + ti * 16 * p_ld + kk, p_ld);
      wmma::load_matrix_sync(bv, Vs + kk * BWD_QKV_LD + tj * 16, BWD_QKV_LD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(stage, acc, BWD_STAGE_LD, wmma::mem_row_major);
    store_tile_bf16(stage, att_b + (size_t)ti * 16 * D + tj * 16, D, L - ti * 16, lane);
  }
  for (int t = warp; t < nt * (BWD_DH / 16); t += BWD_WARPS) {
    const int ti = t / (BWD_DH / 16);
    const int tj = t % (BWD_DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < lp; kk += 16) {
      // P^T read column-major from P: element (j, i) = P[i][j]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bo;
      wmma::load_matrix_sync(a, Ps + kk * p_ld + ti * 16, p_ld);
      wmma::load_matrix_sync(bo, dOs + kk * BWD_QKV_LD + tj * 16, BWD_QKV_LD);
      wmma::mma_sync(acc, a, bo, acc);
    }
    wmma::store_matrix_sync(stage, acc, BWD_STAGE_LD, wmma::mem_row_major);
    store_tile_bf16(stage, dqkv_b + (size_t)ti * 16 * qkv_stride + 2 * D + tj * 16,
                    (int)qkv_stride, L - ti * 16, lane);
  }
  __syncthreads();

  // dp = dO V^T in fp32, rounded to bf16, into P (bf16 p is no longer
  // needed). Rows and columns past L come out 0 (zero rows of dO and V).
  for (int t = warp; t < nt * nt; t += BWD_WARPS) {
    const int ti = t / nt;
    const int tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < BWD_DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bv;
      wmma::load_matrix_sync(a, dOs + ti * 16 * BWD_QKV_LD + kk, BWD_QKV_LD);
      wmma::load_matrix_sync(bv, Vs + tj * 16 * BWD_QKV_LD + kk, BWD_QKV_LD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(stage, acc, BWD_STAGE_LD, wmma::mem_row_major);
    store_tile_bf16(stage, Ps + ti * 16 * p_ld + tj * 16, p_ld, 16, lane);
  }
  __syncthreads();

  // ds = p * (dp - rowsum(dp * p)) * scale in fp32, over p in S. Rows past
  // L keep their zeros; columns past L have p = 0, hence ds = 0.
  for (int i = warp; i < L; i += BWD_WARPS) {
    float* srow = Ss + i * s_ld;
    const bf16* dprow = Ps + i * p_ld;
    float pv[PER_LANE];
    float dpv[PER_LANE];
    float t = 0.f;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + u * 32;
      pv[u] = 0.f;
      dpv[u] = 0.f;
      if (j < lp) {
        pv[u] = srow[j];
        dpv[u] = __bfloat162float(dprow[j]);
      }
      t += dpv[u] * pv[u];
    }
    t = warp_sum(t);
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int j = lane + u * 32;
      if (j < lp) srow[j] = pv[u] * (dpv[u] - t) * scale;
    }
  }
  __syncthreads();

  // dQ = dS K and dK = dS^T Q with fp32 operands, as fp32 FMAs. A thread
  // owns head column c and rows of one parity, BWD_ROWS at a time; a warp
  // shares its rows, so each S read is a broadcast.
  const int c = tid & (BWD_DH - 1);
  const int parity = tid / BWD_DH;  // 0..1
  for (int base = 0; base < L; base += 2 * BWD_ROWS) {
    float acc[BWD_ROWS];
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) acc[r] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float kv = __bfloat162float(Ks[j * BWD_QKV_LD + c]);
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r)
        acc[r] = fmaf(Ss[(base + parity + 2 * r) * s_ld + j], kv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) {
      const int i = base + parity + 2 * r;
      if (i < L) dqkv_b[(size_t)i * qkv_stride + c] = __float2bfloat16(acc[r]);
    }
  }
  for (int base = 0; base < L; base += 2 * BWD_ROWS) {
    float acc[BWD_ROWS];
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) acc[r] = 0.f;
    for (int i = 0; i < L; ++i) {
      const float qv = __bfloat162float(Qs[i * BWD_QKV_LD + c]);
      const float* srow = Ss + i * s_ld + base + parity;
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) acc[r] = fmaf(srow[2 * r], qv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) {
      const int j = base + parity + 2 * r;
      if (j < L) dqkv_b[(size_t)j * qkv_stride + D + c] = __float2bfloat16(acc[r]);
    }
  }
}

// The LN backward, one warp a row (fused_attn_block.py:666-670):
// dx = bf16(g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))),
// dxhat = dxn gamma, with the forward's two-pass statistics. Also stores
// the row's mean and rstd for the column sums.
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ dxn, const float* __restrict__ gamma,
                   bf16* __restrict__ dx, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, int n_rows, int d, float eps) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const size_t base = (size_t)row * d;
  const bf16* xr = x + base;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += __bfloat162float(xr[i]);
  const float mean = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float t = __bfloat162float(xr[i]) - mean;
    v += t * t;
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)d + eps);
  float s1 = 0.f;
  float s2 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xhat = (__bfloat162float(xr[i]) - mean) * rstd;
    const float dxhat = __bfloat162float(dxn[base + i]) * gamma[i];
    s1 += dxhat;
    s2 += dxhat * xhat;
  }
  const float m1 = warp_sum(s1) / (float)d;
  const float m2 = warp_sum(s2) / (float)d;
  for (int i = lane; i < d; i += 32) {
    const float xhat = (__bfloat162float(xr[i]) - mean) * rstd;
    const float dxhat = __bfloat162float(dxn[base + i]) * gamma[i];
    const float dx_ln = rstd * (dxhat - m1 - xhat * m2);
    dx[base + i] = __float2bfloat16(__bfloat162float(g[base + i]) + dx_ln);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
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
// [B*L, 3D] bf16; stats [2 * B*L] fp32; partial [32 * 3 * D] fp32.
// Returns a cudaError_t (0 = launched).
int xtag_fused_attn_half_bwd(const void* x, const void* g, const float* ln_g,
                             const float* ln_b, const void* wqkv, const float* bqkv,
                             const void* wout, const float* mask, void* xn_ws,
                             void* qkv_ws, void* datt_ws, void* att_ws, void* dxn_ws,
                             float* stats_ws, float* partial_ws, void* dx, void* dqkv,
                             float* dwout, float* dbout, float* dls, float* dlb, int B,
                             int L, int D, int H, float eps, void* stream) {
  using namespace xtag;
  if (D != H * BWD_DH || L < 1 || L > BWD_MAX_L || D % GEMM_BN != 0 || B < 1)
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
  e = launch_gemm<EPI_BIAS>(xn, wq, bqkv, nullptr, qkv, n, 3 * D, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_NONE, false, true>(gb, static_cast<const bf16*>(wout), nullptr,
                                          nullptr, datt, n, D, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = bwd_smem_bytes(L);
  e = cudaFuncSetAttribute(attn_bwd_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = 1.0f / sqrtf(static_cast<float>(BWD_DH));
  attn_bwd_core_kernel<<<dim3(H, B), BWD_THREADS, smem, s>>>(qkv, datt, mask, att, dq, L, D,
                                                              scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_F32, true, false>(att, gb, nullptr, nullptr, dwout, D, D, n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_NONE, false, true>(dq, wq, nullptr, nullptr, dxn, n, D, 3 * D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* mean = stats_ws;
  float* rstd = stats_ws + n;
  const int rows_per_block = LN_THREADS / 32;
  ln_bwd_rows_kernel<<<(n + rows_per_block - 1) / rows_per_block, LN_THREADS, 0, s>>>(
      xb, gb, dxn, ln_g, static_cast<bf16*>(dx), mean, rstd, n, D, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_cols_kernel<<<dim3(D / 32, COL_SPLITS), dim3(32, 8), 0, s>>>(xb, gb, dxn, mean, rstd,
                                                                     partial_ws, n, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  col_sum_kernel<<<(3 * D + 255) / 256, 256, 0, s>>>(partial_ws, dbout, dls, dlb, COL_SPLITS, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
