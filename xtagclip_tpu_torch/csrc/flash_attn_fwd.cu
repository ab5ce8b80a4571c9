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
// What bounds it on the H100. At the GAP shape (B=32, H=12, L=256, dh=64)
// q, k, v and o are 50.3 MB: 0.015 ms at 3.35 TB/s, against 6.44 GFLOP,
// 0.0065 ms at 989 TFLOP/s. So bytes bound it, and the design streams those
// bytes once, with loads kept in flight under the math, and keeps
// everything else in registers and shared memory.
//
// Design (hopper.cuh's TMA, mbarrier and wgmma):
// - a persistent grid (3 blocks an SM at dh = 64, 2 at dh = 128) walks the
//   (64-query tile, head, batch) items; each block is one consumer
//   warpgroup and one producer warp;
// - the producer thread loads each item's Q (double-buffered) and a ring of
//   64-key K and V tiles with TMA (4-D tensor maps over the strided
//   [B, H, L, dh] views, 128-byte swizzle, rows past L zero-filled),
//   completing on mbarriers; it runs ahead across items, so the next
//   item's loads overlap this item's math and epilogue;
// - S = Q K^T is wgmma m64n64k16 from shared memory (fp32 in registers);
//   the online softmax works on the accumulator rows (quad shuffles for
//   the row max; per-lane partial row sums, summed over the quad at the
//   end); exp(x) is computed as 2^(x log2 e) with the scale folded into
//   one FFMA (the same value to a few fp32 ulps); P converts in registers
//   to wgmma's A fragments, and O += P V is wgmma with A from registers
//   and V read N-major (the transpose bit), so P never touches shared
//   memory;
// - within the warpgroup S_j and P_{j-1} V_{j-1} are started back to back
//   and the softmax of S_j runs while P V is on the tensor cores; O is
//   rescaled once P V has landed. The two P buffers alternate from tile to
//   tile: a register copy between them makes ptxas serialize the wgmmas
//   (its C7513 warning);
// - the output is staged through the warpgroup's own Q rows and written
//   as 16-byte stores; the lse as fp32.
// Shared memory: 65 KB a block at dh = 64, 97 KB at dh = 128.
#include "flash_common.cuh"

namespace xtag {
namespace fa_fwd {

using sm90::smem_u32;

constexpr int WGS = 1;                   // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * WGS;             // queries a block
constexpr int BN = 64;                   // keys a tile
constexpr int THREADS = 128 * WGS + 32;  // + one producer warp

// K and V tiles in flight (a ring of stages), and blocks an SM holds
template <int DH>
__host__ __device__ constexpr int kv_stages() { return DH == 64 ? 3 : 2; }
template <int DH>
__host__ __device__ constexpr int min_blocks() { return DH == 64 ? 3 : 2; }

template <int DH>
struct Smem {
  static constexpr int Q_BYTES = BM * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;  // one K or V tile
  static constexpr int STAGES = kv_stages<DH>();
  // Q twice, the K ring, the V ring, barriers, and slack for the 1024-byte
  // grid of the 128-byte swizzle
  static constexpr size_t BYTES =
      (size_t)2 * Q_BYTES + 2 * STAGES * KV_BYTES + (4 + 2 * STAGES) * 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, min_blocks<DH>())
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, int h_first,
                 bf16* __restrict__ o, float* __restrict__ lse, Strides so, int B, int H,
                 int L, float scale) {
  using namespace sm90;
  using Sm = Smem<DH>;
  constexpr int STAGES = Sm::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);             // [2][BM x DH]
  unsigned char* Kb = base + 2 * Sm::Q_BYTES;           // [STAGES][BN x DH]
  unsigned char* Vb = Kb + STAGES * Sm::KV_BYTES;       // [STAGES][BN x DH]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vb + STAGES * Sm::KV_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + STAGES;

  // work items (query tile, head, batch), query tile fastest, dealt out
  // round-robin to the persistent grid
  const int n_qt = (L + BM - 1) / BM;
  const int items = n_qt * H * B;
  const int n_kt = (L + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], WGS * 4);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], WGS * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WGS) {
    // producer: one thread loads each item's Q (double-buffered) and keeps
    // the K and V ring full, running ahead across items
    if (threadIdx.x == 128 * WGS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
        const int qt = item % n_qt;
        const int h = (item / n_qt) % H;
        const int b = item / (n_qt * H);
        const int qb = n & 1;
        mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], Sm::Q_BYTES);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p)
          load_box(&map_q, h_first & 1, Qs + qb * BM * DH + p * BM * 64, &q_full[qb], 64 * p,
                   qt * BM, h, b);
        for (int it = 0; it < n_kt; ++it) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * Sm::KV_BYTES);
          bf16* kt = reinterpret_cast<bf16*>(Kb + stage * Sm::KV_BYTES);
          bf16* vt = reinterpret_cast<bf16*>(Vb + stage * Sm::KV_BYTES);
#pragma unroll
          for (int p = 0; p < DH / 64; ++p) {
            load_box(&map_k, h_first & 2, kt + p * BN * 64, &full[stage], 64 * p, it * BN, h,
                     b);
            load_box(&map_v, h_first & 4, vt + p * BN * 64, &full[stage], 64 * p, it * BN, h,
                     b);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = WGS == 1 ? 0 : threadIdx.x >> 7;  // uniform when there is one
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  const int r0 = wg * 64 + warp * 16;  // this warp's first row in the block
  // exp(x) as 2^(x log2 e): the scale and log2 e fold into one FFMA
  const float scale_log2 = scale * 1.4426950408889634f;

  float acc[DH / 2];  // O [64 x DH] of this warpgroup, fp32
  float m[2];         // running max of rows g, g + 8 (log2 domain)
  float l[2];         // this lane's partial row sums
  uint32_t q_addr;

  // S_j = Q K_j^T, started (not waited for); A = Q and B = K both K-major
  // (dh along the 128-byte rows): a k-step of 16 is 32 bytes, a panel of
  // 64 apart
  auto start_s = [&](float (&s)[BN / 2], int st) {
    const uint32_t k_addr = smem_u32(Kb + st * Sm::KV_BYTES);
    fence_operands(s);  // nothing that defines s may sink past the fence
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<0>(s,
                  wgmma_desc(q_addr + (kk >> 2) * (BM * 128) + (kk & 3) * 32, 16, 1024),
                  wgmma_desc(k_addr + (kk >> 2) * (BN * 128) + (kk & 3) * 32, 16, 1024),
                  kk > 0 ? 1 : 0);
    wgmma_commit();
    fence_operands(s);
  };
  // O += P V_j, started (not waited for): B = V N-major (dh along the rows,
  // keys down them); a k-step is 16 key rows, 2048 bytes; 64-column panels
  // apart
  auto start_pv = [&](uint32_t (&pa)[BN / 16][4], int st) {
    const uint32_t v_addr = smem_u32(Vb + st * Sm::KV_BYTES);
    fence_operands(acc);  // the rescale and P's registers settle before the fence
    fence_operands(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<1>(acc, pa[kk], wgmma_desc(v_addr + kk * 2048, BN * 128, 1024), 1);
    wgmma_commit();
    fence_operands(acc);
  };
  // the online softmax of tile j's scores: the new running max, P_j as
  // the register A fragments of P V, the row sums; returns the factors
  // alpha that rescale what came before
  auto softmax = [&](float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4], int j, float (&alpha)[2]) {
    // keys past L only in the last tile, and only when L is not a whole
    // number of tiles
    const bool ragged = (j + 1) * BN > L;
    const int key0 = j * BN + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && key0 + 8 * jj + (e & 1) >= L) s[4 * jj + e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // scale > 0
      alpha[r] = exp2_approx(m[r] - m_new);                 // 0 on the first tile
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float p0 = exp2_approx(fmaf(s[4 * jj], scale_log2, -m[0]));
      const float p1 = exp2_approx(fmaf(s[4 * jj + 1], scale_log2, -m[0]));
      const float p2 = exp2_approx(fmaf(s[4 * jj + 2], scale_log2, -m[1]));
      const float p3 = exp2_approx(fmaf(s[4 * jj + 3], scale_log2, -m[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[jj >> 1][(jj & 1) * 2] = pack_bf16(p0, p1);
      pa[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj) {
      acc[4 * jj] *= alpha[0];
      acc[4 * jj + 1] *= alpha[0];
      acc[4 * jj + 2] *= alpha[1];
      acc[4 * jj + 3] *= alpha[1];
    }
  };

  // The pipeline within the warpgroup: S_j and P_{j-1} V_{j-1} are started
  // back to back; the softmax of S_j runs while P V is on the tensor
  // cores; O is rescaled once P V has landed. P_{j-1} stays in registers
  // until its wgmma has been waited for. The K and V ring runs on across
  // items.
  float s[BN / 2];
  uint32_t pa[BN / 16][4];  // P of one tile, then of every other tile
  uint32_t pb[BN / 16][4];  // P of the tiles between
  float alpha[2];
  int stage = 0;  // the stage of the next tile
  uint32_t phase = 0;
  for (int n = 0, item = blockIdx.x; item < items; ++n, item += gridDim.x) {
    const int q0 = (item % n_qt) * BM;
    const int h = (item / n_qt) % H;
    const int b = item / (n_qt * H);
    const int qb = n & 1;
    bf16* Qi = Qs + qb * BM * DH;
    q_addr = smem_u32(Qi) + wg * 64 * 128;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
    mbar_wait(&q_full[qb], (n >> 1) & 1);

    mbar_wait(&full[stage], phase);
    start_s(s, stage);
    wgmma_wait<0>();
    fence_operands(s);
    softmax(s, pa, 0, alpha);
    fence_operands(pa);
    int cur = stage;  // the stage of tile j - 1
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    // one tile: P_{j-1} is in pc, P_j goes to pn; the two buffers swap from
    // tile to tile (a register copy between them would make ptxas
    // serialize the wgmmas)
    auto step = [&](int j, uint32_t (&pc)[BN / 16][4], uint32_t (&pn)[BN / 16][4]) {
      mbar_wait(&full[stage], phase);
      start_s(s, stage);
      start_pv(pc, cur);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_operands(s);
      softmax(s, pn, j, alpha);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pc);
      if (lane == 0) mbar_arrive(&empty[cur]);  // this warp is done with tile j - 1
      rescale(alpha);
      fence_operands(acc);  // the rescaled O and P_j settle before the next S
      fence_operands(pn);
      cur = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    int j = 1;
    for (; j + 1 < n_kt; j += 2) {
      step(j, pa, pb);
      step(j + 1, pb, pa);
    }
    if (j < n_kt) {
      step(j, pa, pb);
      start_pv(pb, cur);
      wgmma_wait<0>();
      fence_operands(pb);
    } else {
      start_pv(pa, cur);
      wgmma_wait<0>();
      fence_operands(pa);
    }
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[cur]);

    // stage o / l as bf16 in this warp's own Q rows, then 16-byte stores;
    // then the Q buffer goes back to the producer
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(Qi + pan<BM>(r0 + g, col)) =
          pack_bf16(acc[4 * j] / l[0], acc[4 * j + 1] / l[0]);
      *reinterpret_cast<uint32_t*>(Qi + pan<BM>(r0 + g + 8, col)) =
          pack_bf16(acc[4 * j + 2] / l[1], acc[4 * j + 3] / l[1]);
    }
    __syncwarp();
    bf16* ob = o + b * so.b + h * so.h;
    constexpr int CPR = DH / 8;
#pragma unroll
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR;
      const int c = (i % CPR) * 8;
      const int qrow = q0 + r0 + r;
      if (qrow < L)
        *reinterpret_cast<uint4*>(ob + (long long)qrow * so.l + c) =
            *reinterpret_cast<const uint4*>(Qi + pan<BM>(r0 + r, c));
    }
    if (lse != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qrow = q0 + r0 + g + 8 * r;
        if (qrow < L)
          lse[((long long)b * H + h) * L + qrow] = m[r] * 0.6931471805599453f + logf(l[r]);
      }
    }
    fence_proxy_async();  // these shared reads and writes before the next TMA fill
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);
  }
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   const Strides* st, int B, int H, int L, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  bool hq, hk, hv;
  if (!make_view_map(&mq, q, st[0], B, H, L, DH, BM, &hq) ||
      !make_view_map(&mk, k, st[1], B, H, L, DH, BN, &hk) ||
      !make_view_map(&mv, v, st[2], B, H, L, DH, BN, &hv))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<DH>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int items = (L + BM - 1) / BM * H * B;
  const int slots = min_blocks<DH>() * sm90::sm_count();
  flash_fwd_kernel<DH><<<items < slots ? items : slots, THREADS, smem, stream>>>(
      mq, mk, mv, (hq ? 1 : 0) | (hk ? 2 : 0) | (hv ? 4 : 0), o, lse, st[3], B, H, L, scale);
  return cudaGetLastError();
}

}  // namespace fa_fwd
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
  const cudaError_t e =
      dh == 64 ? fa_fwd::launch<64>(qb, kb, vb, ob, lse, st, B, H, L, scale, s)
               : fa_fwd::launch<128>(qb, kb, vb, ob, lse, st, B, H, L, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
