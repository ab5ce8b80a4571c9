// MLP half of a pre-norm transformer block on Hopper:
//   y = x + c_proj(act(c_fc(LN2(x)))),   act = exact gelu or quick_gelu
// Replaces the Pallas kernel xtagclip_tpu/ops/fused_attn_block.py
// ::_fused_mlp_half_fwd (:796, pallas_call :840).
//
// Three launches on the caller's stream (see block_common.cuh):
//   1. LN2 rows -> xn [N, D] bf16;
//   2. xn @ w1 in fp32, + b1, act in fp32 (erff: the exact gelu of the XLA
//      path, not the Pallas kernel's rational erf), rounded to bf16 ->
//      hidden [N, 4D] (the Pallas kernel rounds the hidden to bf16 here
//      too, before c_proj);
//   3. hidden @ w2 in fp32, then x + (acc + b2) in fp32, rounded once.
// Bound on the H100: operations (two GEMMs of 2*N*D*4D FLOP each).
#include "block_common.cuh"

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [N, D] bf16; ln_g/ln_b: [D] fp32; w1: [D, Hd] bf16; b1: [Hd]
// fp32; w2: [Hd, D] bf16; b2: [D] fp32; act: 0 = gelu, 1 = quick_gelu.
// Scratch from the caller: xn [N, D] and hidden [N, Hd], bf16.
// Returns a cudaError_t (0 = launched).
int xtag_fused_mlp_half(const void* x, const float* ln_g, const float* ln_b,
                        const void* w1, const float* b1, const void* w2,
                        const float* b2, void* xn_ws, void* hid_ws, void* out,
                        int N, int D, int Hd, int act, float eps, void* stream) {
  using namespace xtag;
  if (D % GEMM_BN != 0 || Hd % GEMM_BN != 0 || (act != 0 && act != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(xn_ws);
  bf16* hid = static_cast<bf16*>(hid_ws);
  cudaError_t e = launch_ln(xb, ln_g, ln_b, xn, N, D, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (act == 0)
    e = launch_gemm<EPI_BIAS_GELU>(xn, static_cast<const bf16*>(w1), b1, nullptr, hid, N, Hd, D, s);
  else
    e = launch_gemm<EPI_BIAS_QGELU>(xn, static_cast<const bf16*>(w1), b1, nullptr, hid, N, Hd, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_BIAS_RESID>(hid, static_cast<const bf16*>(w2), b2, xb,
                                  static_cast<bf16*>(out), N, D, Hd, s);
  return static_cast<int>(e);
}

}  // extern "C"
