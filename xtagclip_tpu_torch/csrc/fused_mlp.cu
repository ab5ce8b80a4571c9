// The fused transformer MLP on Hopper:  y = c_proj(act(c_fc(x))),
// act = exact gelu or quick_gelu, over [N, D] bf16 rows.
// Replaces the Pallas kernel xtagclip_tpu/ops/fused_mlp.py::_fused_mlp_fwd
// (:62, pallas_call :78), which keeps the [256, 4D] hidden tile in VMEM.
//
// Two launches of gemm_sm90.cuh's TMA + wgmma GEMM on the caller's stream:
//   1. x @ w1, + b1 and act in fp32 (erff: the exact gelu of the XLA path,
//      not the Pallas kernel's rational erf), rounded once to bf16 ->
//      hidden [N, Hd];
//   2. hidden @ w2, + b2 in fp32, rounded once to bf16 -> y.
// The hidden rounds to bf16 where the Pallas kernel rounds it (:74), so its
// round trip through device memory changes no number. Partial mode (tensor
// parallelism): w1, b1 and w2 are a rank's slice of the hidden width, and
// step 2 stores its fp32 sums without b2 (EPI_F32); the caller sums the
// ranks' partials in fp32, adds b2 and rounds once, as step 2 does.
//
// What bounds it on the H100 at the GAP shape (N = 32 * 256, 768 / 3072):
// operations, 77.3 GFLOP, 0.078 ms at 989 TFLOP/s; its bytes (the 34.6 MB
// of x, weights and y, plus the hidden's 50.3 MB written and read again)
// take 0.010-0.040 ms. The design therefore feeds the tensor cores at
// their own rate: wgmma from a TMA-filled, multi-stage shared-memory ring,
// a persistent grid whose producer loads the next tile under this tile's
// epilogue, and weights read as stored (N-major, wgmma's transpose bit).
// The c_fc product, whose epilogue carries the activation and writes the
// [N, Hd] hidden, takes 1.7 times the c_proj product's time (106 vs 62 us
// on the H100).
#include "gemm_sm90.cuh"


extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [N, D] bf16; w1: [D, Hd] bf16; b1: [Hd] fp32; w2: [Hd, D] bf16;
// b2: [D] fp32 (unread when partial); act: 0 = gelu, 1 = quick_gelu.
// out: [N, D] bf16, or with ``partial`` the fp32 sums hidden @ w2 (no
// b2). Scratch from the caller: hidden [N, Hd] bf16. D and Hd multiples
// of 8 (16-byte rows for TMA); a hidden width that is no multiple of 64
// (ViT-SO400M-14-SigLIP's 4304) ends c_fc on a ragged column tile and
// c_proj on a ragged K tile, whose loads fill zeros past the width (zero
// products) and whose stores clip at it (gemm_sm90.cuh). Returns a
// cudaError_t (0 = launched).
static int mlp(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, void* hid_ws, void* out, int N, int D, int Hd, int act,
               bool partial, void* stream) {
  using namespace xtag::sm90;
  if (N < 1 || D % 8 != 0 || Hd % 8 != 0 || (act != 0 && act != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hid = static_cast<bf16*>(hid_ws);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  cudaError_t e =
      act == 0 ? launch_gemm<EPI_BIAS_GELU>(xb, w1b, b1, nullptr, hid, N, Hd, D, s)
               : launch_gemm<EPI_BIAS_QGELU>(xb, w1b, b1, nullptr, hid, N, Hd, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = partial ? launch_gemm<EPI_F32>(hid, w2b, nullptr, nullptr, out, N, D, Hd, s)
              : launch_gemm<EPI_BIAS>(hid, w2b, b2, nullptr, out, N, D, Hd, s);
  return static_cast<int>(e);
}

// The MLP, or with ``partial`` != 0 a slice of the hidden width's fp32
// hidden @ w2 into out, b2 unread (mlp above).
int xtag_fused_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* hid_ws, void* out, int N, int D, int Hd,
                   int act, int partial, void* stream) {
  return mlp(x, w1, b1, w2, b2, hid_ws, out, N, D, Hd, act, partial != 0, stream);
}

}  // extern "C"
