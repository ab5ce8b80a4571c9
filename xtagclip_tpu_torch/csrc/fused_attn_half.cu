// Attention half of a pre-norm transformer block on Hopper:
//   y = x + out_proj(MHA(LN1(x)))   (optional additive [L, L] fp32 mask)
// Replaces the Pallas kernel xtagclip_tpu/ops/fused_attn_block.py
// ::_fused_attn_half_fwd (:434, pallas_call :524).
//
// Four launches on the caller's stream, bf16 intermediates at exactly the
// Pallas kernel's rounding points (:20-25):
//   1. ln_rows.cuh: LN1 rows in fp32 (two-pass variance), rounded once ->
//      xn [N, D] bf16;
//   2. gemm_sm90.cuh: xn @ wqkv + bqkv in fp32, rounded once -> qkv [N, 3D];
//   3. the attention core below -> att [N, D];
//   4. gemm_sm90.cuh: att @ wout, then x + (acc + bout) in fp32
//      (EPI_BIAS_RESID), rounded once -> y.
// Both products read the weights N-major as stored; M = N = B L rows is
// ragged, and TMA zero-fills and clips it.
//
// What bounds it on the H100: operations. 2 B L D (4 D + 2 L) FLOP: 88.9
// GFLOP at the precompute chunk (B = 512, L = 77, D = 512), 0.090 ms at
// 989 TFLOP/s; the bytes (x, y, the weights, and the xn, qkv and att round
// trips) take about 0.08 ms there. The core alone is bound by bytes: at
// that chunk it reads 121 MB of qkv and writes 40 MB of att, 0.048 ms at
// 3.35 TB/s, against 10.7 GFLOP (0.011 ms) of products.
//
// The core. All L <= 128 keys of a (batch, head) fit one tile, so the
// softmax is exact, with no running max. A persistent grid (4 blocks an SM
// at NK = 64, 2 at NK = 128) walks the (head, batch) items; a block is one
// warpgroup per 64 query rows (NK / 64 of them, sharing K and V):
// - one thread loads an item's NK Q, K and V rows (NK = 64 or 128, L
//   padded) by TMA through 4-D tensor maps over the strided [B, H, L, 64]
//   views of the qkv buffer (flash_common.cuh, 128-byte swizzle; rows
//   past L zero-fill) into one of two slots, one item ahead, so the next
//   item's loads run under this item's math;
// - S = Q K^T is one wgmma m64nNKk16 chain from shared memory (fp32 in
//   registers);
// - the softmax on the accumulator rows (flash_common.cuh::softmax_rows),
//   the Pallas kernel's arithmetic: s * dh^-0.5 after the dot, plus the
//   mask, keys past L at -inf, the row max and sum exact over the quad
//   (shuffles), e = expf(s - max), p = e / sum in fp32. p is rounded to
//   bf16 AFTER it is normalized (the Pallas kernel's rounding point, not
//   flash attention's unnormalized P) and converted in registers to
//   wgmma's A fragments. A warp whose rows all lie past L skips it;
// - O = P V is wgmma with A from registers and V read N-major (the
//   transpose bit), O rounded once to bf16, staged in the warp's own Q
//   rows and stored as 16-byte vectors, rows past L not stored.
// Measured on the H100, the core without its softmax runs near its bytes'
// time; the softmax is what costs, and three things keep it cheap (PERF.md
// §6): p = e / sum is div_rn, the correctly rounded quotient
// without the IEEE division's range check, whose slow path the zeros of
// keys past L and of the mask take; the mask is laid out by thread once a
// launch (mask_by_thread_kernel), so a warp's mask load is one cache line,
// and its loads are straight-line code, all in flight at once; and no
// producer warp, so two 8-warp blocks share an SM within 128 registers a
// thread.
// No atomics: a run repeats bit for bit.
#include "flash_common.cuh"
#include "gemm_sm90.cuh"
#include "ln_rows.cuh"

namespace xtag {
namespace attn_fwd {

using sm90::smem_u32;

constexpr int DH = 64;
constexpr int MAX_L = 128;

// NK keys (L padded to 64 or 128) and as many query rows, one consumer
// warpgroup per 64 of them; no producer warp, so 2 blocks of 8 warps fit an
// SM at NK = 128 with 128 registers a thread (a ninth warp would leave one
// SM sub-partition 5 warps and cap them at 96, which spilled)
template <int NK>
struct Cfg {
  static constexpr int WGS = NK / 64;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BLOCKS_PER_SM = NK == 64 ? 4 : 2;
  static constexpr int T_BYTES = NK * DH * 2;  // Q, K or V of an item
  static constexpr int SLOT_BYTES = 3 * T_BYTES;
  // two item slots, their barriers, and slack for the 1024-byte grid of
  // the 128-byte swizzle
  static constexpr size_t SMEM = (size_t)2 * SLOT_BYTES + 4 * 8 + 1024;
};

template <int NK>
__global__ void __launch_bounds__(Cfg<NK>::THREADS, Cfg<NK>::BLOCKS_PER_SM)
attn_core_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, int h_first,
                 const float* __restrict__ mask_t, bf16* __restrict__ att, int B, int H, int L,
                 int D, float scale) {
  using namespace sm90;
  using C = Cfg<NK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * C::SLOT_BYTES);
  uint64_t* empty = full + 2;
  const int items = H * B;  // (head, batch), head fastest

  // item n's Q, K and V into slot n & 1 once its previous item has left it
  // (thread 0 only)
  auto load_item = [&](int n, int item) {
    const int h = item % H;
    const int b = item / H;
    unsigned char* slot = base + (n & 1) * C::SLOT_BYTES;
    mbar_wait(&empty[n & 1], ((n >> 1) & 1) ^ 1);
    mbar_expect_tx(&full[n & 1], C::SLOT_BYTES);
    load_box(&map_q, h_first & 1, slot, &full[n & 1], 0, 0, h, b);
    load_box(&map_k, h_first & 2, slot + C::T_BYTES, &full[n & 1], 0, 0, h, b);
    load_box(&map_v, h_first & 4, slot + 2 * C::T_BYTES, &full[n & 1], 0, 0, h, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * C::WGS);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x < items) load_item(0, blockIdx.x);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  const int r0 = wg * 64 + warp * 16;  // this warp's first query row
  float s[NK / 2];
  uint32_t pa[NK / 16][4];  // bf16(p) as wgmma A fragments, 16 keys each
  float acc[DH / 2];
  for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
    const int h = item % H;
    const int b = item / H;
    // the next item's loads run under this item's math
    if (threadIdx.x == 0 && item + gridDim.x < items) load_item(n + 1, item + gridDim.x);
    bf16* Qs = reinterpret_cast<bf16*>(base + (n & 1) * C::SLOT_BYTES);
    const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
    const uint32_t k_addr = smem_u32(Qs) + C::T_BYTES;
    const uint32_t v_addr = k_addr + C::T_BYTES;
    mbar_wait(&full[n & 1], (n >> 1) & 1);

    // S = Q K^T: A = Q and B = K both K-major (dh along the 128-byte rows),
    // a k-step of 16 is 32 bytes
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<0>(s, wgmma_desc(q_addr + kk * 32, 16, 1024),
                  wgmma_desc(k_addr + kk * 32, 16, 1024), kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // the softmax of rows r0 + g and r0 + g + 8 (rows past L are not
    // stored: a warp whose 16 rows all lie past L gives P = 0 at once)
    if (r0 < L) {
      softmax_rows<NK>(s, r0 + g, t, threadIdx.x, L, mask_t, scale);
#pragma unroll
      for (int jj = 0; jj < NK / 8; ++jj) {
        pa[jj >> 1][(jj & 1) * 2] = pack_bf16(s[4 * jj], s[4 * jj + 1]);
        pa[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;
    }

    // O = P V: B = V N-major (dh along the rows, keys down them); a k-step
    // is 16 key rows, 2048 bytes
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
    fence_operands(acc);
    fence_operands(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs<1>(acc, pa[kk], wgmma_desc(v_addr + kk * 2048, NK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(pa);

    // O rounded once to bf16, staged in this warp's own Q rows (the S
    // products that read them are done), then 16-byte stores of rows < L;
    // then the slot is free for the item after next
    if (r0 < L) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(Qs + pan<NK>(r0 + g, col)) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(Qs + pan<NK>(r0 + g + 8, col)) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();
      bf16* ob = att + (size_t)b * L * D + (size_t)h * DH;
#pragma unroll
      for (int i = lane; i < 16 * (DH / 8); i += 32) {
        const int r = r0 + i / (DH / 8);
        const int c = (i % (DH / 8)) * 8;
        if (r < L)
          *reinterpret_cast<uint4*>(ob + (size_t)r * D + c) =
              *reinterpret_cast<const uint4*>(Qs + pan<NK>(r, c));
      }
    }
    fence_proxy_async();  // these shared reads and writes before the next TMA fill
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n & 1]);
  }
}

// qkv [B L, 3D] bf16 -> att [B L, D] bf16 on a persistent grid over the
// (head, batch) items; NK = 64 for L <= 64, else 128. A mask is first laid
// out by thread into mask_ws (NK * NK fp32).
template <int NK>
cudaError_t launch_core(const bf16* qkv, const float* mask, float* mask_ws, bf16* att, int B,
                        int L, int D, int H, float scale, cudaStream_t stream) {
  using C = Cfg<NK>;
  if (mask != nullptr) {
    const cudaError_t e = launch_mask_by_thread<NK>(mask, mask_ws, L, stream);
    if (e != cudaSuccess) return e;
  }
  // q, k, v of head h: [B, H, L, 64] views of the [B L, 3D] buffer
  const Strides st{(long long)L * 3 * D, DH, 3LL * D};
  CUtensorMap mq, mk, mv;
  bool hq, hk, hv;
  if (!make_view_map(&mq, qkv, st, B, H, L, DH, NK, &hq) ||
      !make_view_map(&mk, qkv + D, st, B, H, L, DH, NK, &hk) ||
      !make_view_map(&mv, qkv + 2 * D, st, B, H, L, DH, NK, &hv))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_core_kernel<NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(C::SMEM));
  if (e != cudaSuccess) return e;
  const int items = H * B;
  const int slots = C::BLOCKS_PER_SM * sm90::sm_count();
  attn_core_kernel<NK><<<items < slots ? items : slots, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, (hq ? 1 : 0) | (hk ? 2 : 0) | (hv ? 4 : 0), mask == nullptr ? nullptr : mask_ws,
      att, B, H, L, D, scale);
  return cudaGetLastError();
}

}  // namespace attn_fwd
}  // namespace xtag

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [B, L, D] bf16; ln_g/ln_b: [D] fp32; wqkv: [D, 3D] bf16;
// bqkv: [3D] fp32; wout: [D, D] bf16; bout: [D] fp32; mask: [L, L] fp32
// or null. Scratch from the caller: xn [B*L, D], qkv [B*L, 3D],
// att [B*L, D], all bf16; with a mask, mask_ws [128 * 128] fp32 (else
// unread). Returns a cudaError_t (0 = launched).
int xtag_fused_attn_half(const void* x, const float* ln_g, const float* ln_b,
                         const void* wqkv, const float* bqkv, const void* wout,
                         const float* bout, const float* mask, void* xn_ws,
                         void* qkv_ws, void* att_ws, float* mask_ws, void* out, int B,
                         int L, int D, int H, float eps, void* stream) {
  using namespace xtag;
  using attn_fwd::DH;
  if (B < 1 || D != H * DH || L < 1 || L > attn_fwd::MAX_L || D % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * L;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(xn_ws);
  bf16* qkv = static_cast<bf16*>(qkv_ws);
  bf16* att = static_cast<bf16*>(att_ws);
  cudaError_t e = launch_ln(xb, ln_g, ln_b, xn, n, D, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = sm90::launch_gemm<sm90::EPI_BIAS>(xn, static_cast<const bf16*>(wqkv), bqkv, nullptr, qkv,
                                        n, 3 * D, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  e = L <= 64 ? attn_fwd::launch_core<64>(qkv, mask, mask_ws, att, B, L, D, H, scale, s)
              : attn_fwd::launch_core<128>(qkv, mask, mask_ws, att, B, L, D, H, scale, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = sm90::launch_gemm<sm90::EPI_BIAS_RESID>(att, static_cast<const bf16*>(wout), bout, xb,
                                              static_cast<bf16*>(out), n, D, D, s);
  return static_cast<int>(e);
}

}  // extern "C"
