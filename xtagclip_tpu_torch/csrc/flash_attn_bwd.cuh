// Flash attention backward on Hopper (the kernels; flash_attn_bwd.cu and
// flash_attn_bwd_masked.cu instantiate them in bf16 without and with the
// mask, flash_attn_bwd_f16.cu in float16 without it): dq, dk, dv of
//   o = softmax(q k^T * dh^-0.5 + mask) v   over [B, H, L, dh] bf16 (or
// float16) views,
// with an optional additive [L, L] mask (fp32 or bf16), from q, k, v, the
// forward's output o and fp32 log-sum-exp, and dO.
// Replaces the stock Pallas TPU flash backward that
// xtagclip_tpu/ops/flash_attn.py::flash_mha (:93) reaches through its
// custom VJP (jax.experimental.pallas.ops.tpu.flash_attention, the dq and
// dkv kernels).
//
// Numerics (the Pallas kernels'): D_i = rowsum(dO o) in fp32;
// P = exp(s - lse) in fp32 from the recomputed scores s = q.k * scale
// (as 2^(s * scale * log2 e - lse * log2 e): the scale folds into one FFMA,
// as in the forward); dP = dO V^T in fp32; dS = (dP - D_i) P scale in fp32;
// P and dS round to the element dtype before their products; dV = P^T dO,
// dK = dS^T Q and dQ = dS K accumulate in fp32 and each gradient rounds once
// to the element dtype. The element type T is bf16 or __half, as in the
// forward (flash_attn_fwd.cuh): f16 wgmma and FLOAT16 tensor maps, every
// statistic in fp32.
// Queries past L get P = 0 (their lse reads as +inf); keys past L load as
// zero rows, and the dq kernel sets their P to 0. With a mask, P is
// recomputed as 2^(s * scale * log2 e + mask * log2 e - lse * log2 e): the
// mask is added after the scale, as in the forward (an entry of -inf gives
// P = 0); each score reads its entry from the [L, L] table.
//
// What bounds it on the H100. At the GAP shape (B=32, H=12, L=256, dh=64)
// q, k, v, o, dO in and dq, dk, dv out are 100.7 MB: 0.030 ms at 3.35 TB/s;
// the function's 10 B H L^2 dh FLOP (16.1 GFLOP; with S and dP recomputed in
// both kernels, 22.5) take 0.016-0.023 ms at 989 TFLOP/s. So bytes bound
// it, closely followed by the tensor cores: the design streams each tile
// once into shared memory by TMA and keeps every score tile in registers.
//
// Design. The Pallas kernels walk their grid in order and carry dq, dk, dv
// in VMEM scratch from one step to the next; CUDA blocks run in no order, so
// each gradient is owned by one block that loops over the other axis, and
// nothing is added by two blocks (no atomics: runs repeat bit for bit):
//   1. delta: a pre-pass writes, per 64-row query tile, D_i = rowsum(dO o)
//      (a block a tile; 16-byte loads, 8 or 16 lanes a row, so a warp
//      reads 4 or 2 rows)
//      and lse * log2 e beside it, +inf and 0 for rows past L: 512 aligned
//      bytes a tile, which one bulk copy brings into shared memory;
//   2. dkv: a persistent grid over (128-key block, head, batch). Each
//      block is two consumer warpgroups (64 keys each) and a producer
//      warpgroup whose one thread loads the block's K and V (double-
//      buffered across items) and keeps a ring of Q, dO and statistics
//      tiles in flight by TMA (4-D tensor maps over the strided views,
//      128-byte swizzle). It computes in the transposed orientation, so no
//      tile is transposed through shared memory: S^T = K Q^T and
//      dP^T = V dO^T by wgmma from shared memory (K, V, Q, dO all K-major);
//      P^T and dS^T in registers from the column statistics; both converted
//      in registers to wgmma A fragments; dV += P^T dO and dK += dS^T Q by
//      wgmma with A from registers and dO, Q read N-major (the transpose
//      bit). dK and dV stay in registers across the query tiles and leave
//      through the block's own K and V rows as 16-byte stores;
//   3. dq: the same grid over (128-query block, head, batch): Q and dO of
//      the block (double-buffered across items), a ring of K and V tiles;
//      S = Q K^T and dP = dO V^T by wgmma, dS in registers, dQ += dS K by
//      wgmma with A from registers and K read N-major.
// setmaxnreg gives the producer warpgroup 24 registers and each consumer
// 240, so dh 128 holds dK and dV (2 x 64 registers), S^T and dP^T
// (2 x 32) and the A fragments without spilling. Shared memory a block:
// 130 KB (dh 64) or 194 KB (dh 128). Head dims 72-120 run the dh 128
// instantiation as the forward does: the maps' head-dim extent is the true
// dh (zeros past it), the score products take ceil(dh / 16) k-steps, the
// delta pass sums over dh, and dQ, dK, dV store dh columns.
// Head dim 256 runs in two 128-column halves: each (block, head, batch)
// is two work items, one a half; both compute S^T and dP^T (or S and dP)
// over the whole 256 (16 k-steps) and keep only their half of dK and dV
// (or dQ) in registers, the gradient products reading that half's panels
// of Q and dO (or K). The owned tiles are single-buffered and the ring has
// one stage: 194 KB a block.
// What still holds it back (measured on the H100 at the GAP shape,
// chip_smoke.py's ms_by_kernel): dkv and dq run at 36% and 29% of the bf16
// peak (36 and 34 us); starting the next tile's score products under dq's
// gradient product moved nothing. Within a warpgroup the score products, the elementwise
// pass and the gradient products run in turn; only the two warpgroups of
// a block overlap one another.
#pragma once

#include "flash_common.cuh"

namespace xtag {
namespace fa_bwd {

using sm90::smem_u32;

constexpr int WGS = 2;                   // consumer warpgroups, 64 rows each
constexpr int BR = 64 * WGS;             // rows a block owns
constexpr int BT = 64;                   // rows of a streamed tile
constexpr int THREADS = 128 * (WGS + 1); // + one producer warpgroup
constexpr int PRODUCER_REGS = 24;        // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 240;
constexpr int STAT_FLOATS = 2 * BT;      // lse * log2 e, then D, of a query tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Smem {
  static constexpr int OWN_BYTES = BR * DH * 2;  // one owned tile (K or V; Q or dO)
  static constexpr int RING_BYTES = BT * DH * 2; // one streamed tile
  static constexpr int STAGES = DH == 64 ? 4 : DH == 128 ? 2 : 1;
  static constexpr int OWN_BUFS = DH == 256 ? 1 : 2;
  // the gradients' column halves: CH columns each, NH of them
  static constexpr int CH = DH > 128 ? 128 : DH;
  static constexpr int NH = DH / CH;
  // the owned pairs (double-buffered across items but at dh 256), the
  // ring of streamed pairs, the statistics ring (dkv), barriers, and slack
  // for the 1024-byte grid of the 128-byte swizzle
  static constexpr size_t BYTES = (size_t)OWN_BUFS * 2 * OWN_BYTES +
                                  (size_t)STAGES * 2 * RING_BYTES +
                                  (size_t)STAGES * STAT_FLOATS * 4 + (4 + 2 * STAGES) * 8 + 1024;
};

// The additive mask's entry (row, key) of a [L, L] table, fp32 or bf16,
// times log2 e; 0 outside the table (rows or keys past L)
__device__ __forceinline__ float mask_log2(const void* mask, bool bf, int row, int key, int L) {
  if (row >= L || key >= L) return 0.0f;
  const long long i = (long long)row * L + key;
  const float v = bf ? __bfloat162float(__ldg(static_cast<const bf16*>(mask) + i))
                     : __ldg(static_cast<const float*>(mask) + i);
  return v * LOG2E;
}

// D and lse * log2 e of every row of every 64-row query tile, +inf and 0
// past L: stat[((b H + h) n_t + tile) 128 + r] and [... + 64 + r]. A block
// is one tile (blockIdx.y) of one (b, h) (blockIdx.x): 64 rows of CH / 8
// lanes each, a lane 8 elements of each of the NH column halves.
template <typename T, int DH>
__global__ void __launch_bounds__(BT * Smem<DH>::CH / 8)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ stat, Strides so,
                   Strides sd, int H, int L, int dh) {
  constexpr int CH = Smem<DH>::CH;
  constexpr int G = CH / 8;  // lanes a row, 8 elements a half each
  const int r = threadIdx.x / G;
  const int l = blockIdx.y * BT + r;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int b = bh / H;
  float s = 0.0f;
#pragma unroll
  for (int hf = 0; hf < Smem<DH>::NH; ++hf) {
    const int c = hf * CH + (threadIdx.x % G) * 8;
    if (l < L && c < dh) {  // lanes past the true head dim add nothing
      const uint4 ov = *reinterpret_cast<const uint4*>(o + b * so.b + h * so.h + l * so.l + c);
      const uint4 dv =
          *reinterpret_cast<const uint4*>(dout + b * sd.b + h * sd.h + l * sd.l + c);
      const uint32_t* op = reinterpret_cast<const uint32_t*>(&ov);
      const uint32_t* dp = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack2<T>(op[e]);
        const float2 d = unpack2<T>(dp[e]);
        s = fmaf(a.x, d.x, s);
        s = fmaf(a.y, d.y, s);
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % G == 0) {
    float* out = stat + ((long long)bh * gridDim.y + blockIdx.y) * STAT_FLOATS;
    out[r] = l < L ? lse[(long long)bh * L + l] * LOG2E : INFINITY;
    out[BT + r] = l < L ? s : 0.0f;
  }
}

// A warp's 16 rows of a [64 x DH] fp32 accumulator (rows g, g + 8 of each
// 16), rounded to T, staged in rows ``r0`` .. ``r0`` + 15 of a
// [ROWS x DH] tile in the panel layout (pan), then stored as 16-byte
// vectors to rows row0 .. row0 + 15 (those < L) of dst.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2], T* tile, int r0,
                                           T* dst, long long row_stride, int row0, int L,
                                           int dh, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + pan<ROWS>(r0 + g, col)) =
        pack2<T>(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + pan<ROWS>(r0 + g + 8, col)) =
        pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
  constexpr int CPR = DH / 8;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    if (row0 + r < L && c < dh)  // only the true head dim's columns are stored
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(tile + pan<ROWS>(r0 + r, c));
  }
}

// S (or S^T) and dP (or dP^T) of a warpgroup: A = 64 rows of an owned
// tile (BR rows, panels BR * 128 bytes apart), B = a streamed tile (BT
// rows); both K-major along dh, a k-step of 16 is 32 bytes along the
// swizzled row; KS k-steps, ceil(dh / 16) (the columns past dh are
// zero). Started and committed as one group, not waited for.
template <typename T, int KS>
__device__ __forceinline__ void score_products(float (&s)[BT / 2], float (&dp)[BT / 2],
                                               uint32_t a_s, uint32_t b_s, uint32_t a_dp,
                                               uint32_t b_dp) {
  using namespace sm90;
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t ao = (kk >> 2) * (BR * 128) + (kk & 3) * 32;
    const uint32_t bo = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
    wgmma_ss<0, 0, T>(s, wgmma_desc(a_s + ao, 16, 1024), wgmma_desc(b_s + bo, 16, 1024),
                kk > 0 ? 1 : 0);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t ao = (kk >> 2) * (BR * 128) + (kk & 3) * 32;
    const uint32_t bo = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
    wgmma_ss<0, 0, T>(dp, wgmma_desc(a_dp + ao, 16, 1024), wgmma_desc(b_dp + bo, 16, 1024),
                kk > 0 ? 1 : 0);
  }
  wgmma_commit();
  fence_operands(s);
  fence_operands(dp);
}

// acc += A B over the 64 columns of the score tile: A from registers (four
// k-steps of 16), B a streamed tile read N-major (a k-step is 16 rows,
// 2048 bytes; 64-column panels BT * 128 bytes apart).
template <typename T, int DH>
__device__ __forceinline__ void grad_product(float (&acc)[DH / 2], const uint32_t (&a)[BT / 16][4],
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    sm90::wgmma_rs<1, T>(acc, a[kk], sm90::wgmma_desc(b + kk * 2048, BT * 128, 1024), 1);
}

// MASKED: mask is an [L, L] additive mask (bf16 when mask_bf16, else
// fp32); else it is null and the kernel carries no mask code.
template <typename T, int DH, int KS, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do, int h_first,
                 const float* __restrict__ stat, T* __restrict__ dk, T* __restrict__ dv,
                 Strides sdk, Strides sdv, int B, int H, int L, int dh, float scale,
                 const void* __restrict__ mask, int mask_bf16) {
  using namespace sm90;
  using Sm = Smem<DH>;
  constexpr int STAGES = Sm::STAGES;
  constexpr int OWN_BUFS = Sm::OWN_BUFS;
  constexpr int CH = Sm::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [OWN_BUFS items][K, V] of BR rows; [STAGES][Q, dO] of BT rows; [STAGES] stats
  unsigned char* own = base;
  unsigned char* ring = own + OWN_BUFS * 2 * Sm::OWN_BYTES;
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * Sm::RING_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + STAGES * STAT_FLOATS);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + STAGES;

  const int n_kb = (L + BR - 1) / BR;
  const int n_qt = (L + BT - 1) / BT;
  const int items = n_kb * H * B * Sm::NH;  // the column half slowest

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], WGS * 4);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], WGS * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == WGS) {
    // producer: one thread loads each item's K and V (double-buffered) and
    // keeps the Q / dO / statistics ring full, running ahead across items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == WGS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
        const int kb = item % n_kb;
        const int h = (item / n_kb) % H;
        const int b = (item / (n_kb * H)) % B;
        const int buf = n % OWN_BUFS;
        unsigned char* kt = own + buf * 2 * Sm::OWN_BYTES;
        unsigned char* vt = kt + Sm::OWN_BYTES;
        mbar_wait(&kv_empty[buf], ((n / OWN_BUFS) & 1) ^ 1);
        mbar_expect_tx(&kv_full[buf], 2 * Sm::OWN_BYTES);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p) {
          load_box(&map_k, h_first & 2, kt + p * BR * 128, &kv_full[buf], 64 * p, kb * BR, h, b);
          load_box(&map_v, h_first & 4, vt + p * BR * 128, &kv_full[buf], 64 * p, kb * BR, h, b);
        }
        const float* item_stat = stat + ((long long)b * H + h) * n_qt * STAT_FLOATS;
        for (int it = 0; it < n_qt; ++it) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * Sm::RING_BYTES + STAT_FLOATS * 4);
          unsigned char* qt = ring + stage * 2 * Sm::RING_BYTES;
          unsigned char* dot = qt + Sm::RING_BYTES;
#pragma unroll
          for (int p = 0; p < DH / 64; ++p) {
            load_box(&map_q, h_first & 1, qt + p * BT * 128, &full[stage], 64 * p, it * BT, h, b);
            load_box(&map_do, h_first & 8, dot + p * BT * 128, &full[stage], 64 * p, it * BT, h,
                     b);
          }
          bulk_load(stats + stage * STAT_FLOATS, item_stat + it * STAT_FLOATS, STAT_FLOATS * 4,
                    &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys wg * 64 .. wg * 64 + 63 of a block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int r0 = wg * 64 + warp * 16;  // this warp's first row in the block
    const float scale_log2 = scale * LOG2E;
    int stage = 0;
    uint32_t phase = 0;
    float dk_acc[CH / 2], dv_acc[CH / 2];
    for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
      const int kb = item % n_kb;
      const int h = (item / n_kb) % H;
      const int b = (item / (n_kb * H)) % B;
      const int hf = item / (n_kb * H * B);  // the column half of dK and dV
      const int buf = n % OWN_BUFS;
      T* kt = reinterpret_cast<T*>(own + buf * 2 * Sm::OWN_BYTES);
      T* vt = kt + BR * DH;
      const uint32_t k_addr = smem_u32(kt) + wg * 64 * 128;
      const uint32_t v_addr = smem_u32(vt) + wg * 64 * 128;
#pragma unroll
      for (int i = 0; i < CH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
      mbar_wait(&kv_full[buf], (n / OWN_BUFS) & 1);

      for (int it = 0; it < n_qt; ++it) {
        mbar_wait(&full[stage], phase);
        const uint32_t q_addr = smem_u32(ring + stage * 2 * Sm::RING_BYTES);
        const uint32_t do_addr = q_addr + Sm::RING_BYTES;
        float s[BT / 2], dp[BT / 2];
        score_products<T, KS>(s, dp, k_addr, q_addr, v_addr, do_addr);
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);
        // P^T and dS^T of this lane's keys (rows g, g + 8) and queries
        // (columns 8 jj + 2 t, + 1), from the columns' statistics
        const float* st = stats + stage * STAT_FLOATS;
        uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
        for (int jj = 0; jj < BT / 8; ++jj) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * jj + 2 * t);
          const float2 dd = *reinterpret_cast<const float2*>(st + BT + 8 * jj + 2 * t);
          float c[4] = {-l2.x, -l2.y, -l2.x, -l2.y};  // the exponents' offsets
          if constexpr (MASKED) {
            const int q = it * BT + 8 * jj + 2 * t;     // this lane's queries q, q + 1
            const int key = kb * BR + r0 + (lane >> 2);  // and keys key, key + 8
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c[e] += mask_log2(mask, mask_bf16, q + (e & 1), key + 8 * (e >> 1), L);
          }
          const float p0 = exp2_approx(fmaf(s[4 * jj], scale_log2, c[0]));
          const float p1 = exp2_approx(fmaf(s[4 * jj + 1], scale_log2, c[1]));
          const float p2 = exp2_approx(fmaf(s[4 * jj + 2], scale_log2, c[2]));
          const float p3 = exp2_approx(fmaf(s[4 * jj + 3], scale_log2, c[3]));
          pa[jj >> 1][(jj & 1) * 2] = pack2<T>(p0, p1);
          pa[jj >> 1][(jj & 1) * 2 + 1] = pack2<T>(p2, p3);
          da[jj >> 1][(jj & 1) * 2] =
              pack2<T>((dp[4 * jj] - dd.x) * p0 * scale, (dp[4 * jj + 1] - dd.y) * p1 * scale);
          da[jj >> 1][(jj & 1) * 2 + 1] = pack2<T>((dp[4 * jj + 2] - dd.x) * p2 * scale,
                                                    (dp[4 * jj + 3] - dd.y) * p3 * scale);
        }
        // dV += P^T dO, dK += dS^T Q
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pa);
        fence_operands(da);
        wgmma_fence();
        // the gradients' columns hf CH .. hf CH + CH - 1: that half's panels
        grad_product<T, CH>(dv_acc, pa, do_addr + hf * (CH / 64) * (BT * 128));
        grad_product<T, CH>(dk_acc, da, q_addr + hf * (CH / 64) * (BT * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pa);
        fence_operands(da);
        if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the tile
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // dK and dV leave through this warp's own rows of the K and V tiles,
      // which no wgmma reads any more; then the pair goes back to the
      // producer
      const int key0 = kb * BR + r0;
      const int c0 = hf * CH;
      store_rows<T, CH, BR>(dk_acc, kt, r0, dk + b * sdk.b + h * sdk.h + c0, sdk.l, key0, L,
                         dh - c0, lane);
      store_rows<T, CH, BR>(dv_acc, vt, r0, dv + b * sdv.b + h * sdv.h + c0, sdv.l, key0, L,
                         dh - c0, lane);
      fence_proxy_async();  // these shared reads and writes before the next TMA fill
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[buf]);
    }
  }
}

template <typename T, int DH, int KS, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do, int h_first,
                const float* __restrict__ stat, T* __restrict__ dq, Strides sdq, int B,
                int H, int L, int dh, float scale, const void* __restrict__ mask,
                int mask_bf16) {
  using namespace sm90;
  using Sm = Smem<DH>;
  constexpr int STAGES = Sm::STAGES;
  constexpr int OWN_BUFS = Sm::OWN_BUFS;
  constexpr int CH = Sm::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [OWN_BUFS items][Q, dO] of BR rows; [STAGES][K, V] of BT rows
  unsigned char* own = base;
  unsigned char* ring = own + OWN_BUFS * 2 * Sm::OWN_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * Sm::RING_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + STAGES;

  const int n_qb = (L + BR - 1) / BR;
  const int n_t = (L + BT - 1) / BT;  // query tiles of the statistics; key tiles
  const int items = n_qb * H * B * Sm::NH;  // the column half slowest

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], WGS * 4);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == WGS) {
    // producer: each item's Q and dO (double-buffered), and the K and V
    // ring, running ahead across items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == WGS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
        const int qb = item % n_qb;
        const int h = (item / n_qb) % H;
        const int b = (item / (n_qb * H)) % B;
        const int buf = n % OWN_BUFS;
        unsigned char* qt = own + buf * 2 * Sm::OWN_BYTES;
        unsigned char* dot = qt + Sm::OWN_BYTES;
        mbar_wait(&q_empty[buf], ((n / OWN_BUFS) & 1) ^ 1);
        mbar_expect_tx(&q_full[buf], 2 * Sm::OWN_BYTES);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p) {
          load_box(&map_q, h_first & 1, qt + p * BR * 128, &q_full[buf], 64 * p, qb * BR, h, b);
          load_box(&map_do, h_first & 8, dot + p * BR * 128, &q_full[buf], 64 * p, qb * BR, h,
                   b);
        }
        for (int it = 0; it < n_t; ++it) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * Sm::RING_BYTES);
          unsigned char* kt = ring + stage * 2 * Sm::RING_BYTES;
          unsigned char* vt = kt + Sm::RING_BYTES;
#pragma unroll
          for (int p = 0; p < DH / 64; ++p) {
            load_box(&map_k, h_first & 2, kt + p * BT * 128, &full[stage], 64 * p, it * BT, h, b);
            load_box(&map_v, h_first & 4, vt + p * BT * 128, &full[stage], 64 * p, it * BT, h, b);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns queries wg * 64 .. wg * 64 + 63 of a block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = wg * 64 + warp * 16;
    const float scale_log2 = scale * LOG2E;
    int stage = 0;
    uint32_t phase = 0;
    float dq_acc[CH / 2];
    for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
      const int qb = item % n_qb;
      const int h = (item / n_qb) % H;
      const int b = (item / (n_qb * H)) % B;
      const int hf = item / (n_qb * H * B);  // the column half of dQ
      const int buf = n % OWN_BUFS;
      T* qt = reinterpret_cast<T*>(own + buf * 2 * Sm::OWN_BYTES);
      const uint32_t q_addr = smem_u32(qt) + wg * 64 * 128;
      const uint32_t do_addr = q_addr + Sm::OWN_BYTES;
      // the statistics of this lane's rows g and g + 8
      float l2[2], dd[2];
      const float* item_stat = stat + ((long long)b * H + h) * n_t * STAT_FLOATS;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qb * BR + r0 + g + 8 * r;
        const bool ok = q < L;
        l2[r] = ok ? item_stat[(q / BT) * STAT_FLOATS + q % BT] : INFINITY;
        dd[r] = ok ? item_stat[(q / BT) * STAT_FLOATS + BT + q % BT] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < CH / 2; ++i) dq_acc[i] = 0.0f;
      mbar_wait(&q_full[buf], (n / OWN_BUFS) & 1);

      for (int it = 0; it < n_t; ++it) {
        mbar_wait(&full[stage], phase);
        const uint32_t k_addr = smem_u32(ring + stage * 2 * Sm::RING_BYTES);
        const uint32_t v_addr = k_addr + Sm::RING_BYTES;
        float s[BT / 2], dp[BT / 2];
        score_products<T, KS>(s, dp, q_addr, k_addr, do_addr, v_addr);
        wgmma_wait<0>();
        fence_operands(s);
        fence_operands(dp);
        // dS of this lane's queries (rows g, g + 8) and keys (columns
        // 8 jj + 2 t, + 1); keys past L only in the last tile, and only
        // when L is not a whole number of tiles
        const bool ragged = (it + 1) * BT > L;
        const int key0 = it * BT + 2 * t;
        uint32_t da[BT / 16][4];
#pragma unroll
        for (int jj = 0; jj < BT / 8; ++jj) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * jj + (e & 1);
            float c = -l2[e >> 1];
            if constexpr (MASKED)
              c += mask_log2(mask, mask_bf16, qb * BR + r0 + g + 8 * (e >> 1), key, L);
            p[e] = exp2_approx(fmaf(s[4 * jj + e], scale_log2, c));
            if (ragged && key >= L) p[e] = 0.0f;
          }
          da[jj >> 1][(jj & 1) * 2] = pack2<T>((dp[4 * jj] - dd[0]) * p[0] * scale,
                                                (dp[4 * jj + 1] - dd[0]) * p[1] * scale);
          da[jj >> 1][(jj & 1) * 2 + 1] = pack2<T>((dp[4 * jj + 2] - dd[1]) * p[2] * scale,
                                                    (dp[4 * jj + 3] - dd[1]) * p[3] * scale);
        }
        // dQ += dS K
        fence_operands(dq_acc);
        fence_operands(da);
        wgmma_fence();
        grad_product<T, CH>(dq_acc, da, k_addr + hf * (CH / 64) * (BT * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dq_acc);
        fence_operands(da);
        if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the tile
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      store_rows<T, CH, BR>(dq_acc, qt, r0, dq + b * sdq.b + h * sdq.h + hf * CH, sdq.l,
                         qb * BR + r0, L, dh - hf * CH, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[buf]);
    }
  }
}

template <typename T, int DH, int KS, bool MASKED>
cudaError_t launch(const T* q, const T* k, const T* v, const T* o,
                   const T* dout, const float* lse, float* stat, T* dq, T* dk,
                   T* dv, const Strides* st, int B, int H, int L, int dh, float scale,
                   const void* mask, int mask_bf16, cudaStream_t stream) {
  flash_delta_kernel<T, DH><<<dim3(B * H, (L + BT - 1) / BT), BT * Smem<DH>::CH / 8, 0, stream>>>(
      o, dout, lse, stat, st[3], st[4], H, L, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // dkv streams Q and dO tiles past owned K and V blocks; dq the reverse.
  // The maps' head-dim extent is the true dh: a box's columns past it read
  // as zero (TMA's out-of-bounds fill), never the next head's.
  CUtensorMap mq_t, mk_o, mv_o, mdo_t, mq_o, mk_t, mv_t, mdo_o;
  bool hq, hk, hv, hdo;
  if (!make_view_map(&mq_t, q, st[0], B, H, L, dh, BT, &hq) ||
      !make_view_map(&mk_o, k, st[1], B, H, L, dh, BR, &hk) ||
      !make_view_map(&mv_o, v, st[2], B, H, L, dh, BR, &hv) ||
      !make_view_map(&mdo_t, dout, st[4], B, H, L, dh, BT, &hdo) ||
      !make_view_map(&mq_o, q, st[0], B, H, L, dh, BR, &hq) ||
      !make_view_map(&mk_t, k, st[1], B, H, L, dh, BT, &hk) ||
      !make_view_map(&mv_t, v, st[2], B, H, L, dh, BT, &hv) ||
      !make_view_map(&mdo_o, dout, st[4], B, H, L, dh, BR, &hdo))
    return cudaErrorInvalidValue;
  const int h_first = (hq ? 1 : 0) | (hk ? 2 : 0) | (hv ? 4 : 0) | (hdo ? 8 : 0);
  constexpr size_t smem = Smem<DH>::BYTES;
  const int items = (L + BR - 1) / BR * H * B * Smem<DH>::NH;
  const int grid = items < sm90::sm_count() ? items : sm90::sm_count();

  e = cudaFuncSetAttribute(flash_dkv_kernel<T, DH, KS, MASKED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_dkv_kernel<T, DH, KS, MASKED><<<grid, THREADS, smem, stream>>>(
      mq_t, mk_o, mv_o, mdo_t, h_first, stat, dk, dv, st[6], st[7], B, H, L, dh, scale, mask,
      mask_bf16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_dq_kernel<T, DH, KS, MASKED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_dq_kernel<T, DH, KS, MASKED><<<grid, THREADS, smem, stream>>>(
      mq_o, mk_t, mv_t, mdo_o, h_first, stat, dq, st[5], B, H, L, dh, scale, mask, mask_bf16);
  return cudaGetLastError();
}

// Checks the arguments and launches the instantiation of element type T
// (bf16 or __half) for head dim dh, as fa_fwd::run picks it (the masked
// library, flash_attn_bwd_masked.cu, holds three; the unmasked ones,
// flash_attn_bwd.cu and flash_attn_bwd_f16.cu, six each). q, k, v, o,
// dout, dq, dk, dv: [B, H, L, dh] views of T with dh contiguous; strides
// holds the (b, h, l) element strides of the eight in that order (24
// values). lse: the forward's [B, H, L] fp32 log-sum-exp. Scratch from the
// caller: stat, B H ceil(L / 64) 128 fp32, 16-byte aligned. mask: the
// forward's contiguous [L, L] additive mask (bf16 when mask_bf16 != 0,
// else fp32) with MASKED, null without.
template <typename T, bool MASKED>
cudaError_t run(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* stat_ws, void* dq, void* dk, void* dv,
                const long long* strides, int B, int H, int L, int dh, float scale,
                const void* mask, int mask_bf16, void* stream) {
  if (B < 1 || H < 1 || L < 1 || dh % 8 != 0 || dh < 64 || (dh > 128 && dh != 256) ||
      (mask != nullptr) != MASKED)
    return cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launcher) {
    return launcher(in(q), in(k), in(v), in(o), in(dout), lse, stat_ws, out(dq), out(dk),
                    out(dv), st, B, H, L, dh, scale, mask, mask_bf16, s);
  };
  if (dh == 64) return go(launch<T, 64, 4, MASKED>);
  if (dh == 256) return go(launch<T, 256, 16, MASKED>);
  if constexpr (MASKED) {
    return go(launch<T, 128, 8, true>);
  } else {
    switch ((dh + 15) / 16) {  // the k-steps of the score products
      case 5: return go(launch<T, 128, 5, false>);
      case 6: return go(launch<T, 128, 6, false>);
      case 7: return go(launch<T, 128, 7, false>);
      default: return go(launch<T, 128, 8, false>);
    }
  }
}

}  // namespace fa_bwd
}  // namespace xtag
