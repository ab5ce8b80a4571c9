// MLP half of a pre-norm transformer block on Hopper:
//   y = x + c_proj(act(c_fc(LN2(x)))),   act = exact gelu or quick_gelu
// over [N, D] bf16 rows. Replaces the Pallas kernel
// xtagclip_tpu/ops/fused_attn_block.py::_fused_mlp_half_fwd (:796,
// pallas_call :840), which keeps the half's weights and the [tile, 4D]
// hidden in VMEM.
//
// Three launches on the caller's stream:
//   1. ln_rows.cuh: LN2 rows in fp32 (two-pass variance), rounded once to
//      bf16 -> xn [N, D];
//   2. gemm_sm90.cuh: xn @ w1 in fp32, + b1 and act in fp32 (erff: the
//      exact gelu of the XLA path, not the Pallas kernel's rational erf),
//      rounded to bf16 -> hidden [N, 4D] (the Pallas kernel rounds the
//      hidden to bf16 there too, before c_proj);
//   3. gemm_sm90.cuh: hidden @ w2 in fp32, then x + (acc + b2) in fp32
//      (EPI_BIAS_RESID), rounded once -> y.
// xn and the hidden round to bf16 where the Pallas kernel rounds them, so
// their round trips through device memory change no number.
//
// What bounds it on the H100: operations. The two products are 4 N D 4D
// FLOP: 15.1 GFLOP at the ViT-B-32 vision rows (N = 1600, D = 768), 0.0153
// ms at 989 TFLOP/s; 10.4 GFLOP at the text rows (N = 2464, D = 512); 165
// GFLOP for a 512-prompt precompute chunk (N = 39424, D = 512), 0.167 ms.
// The bytes (x, the weights and y, plus the hidden's round trip) take
// 0.002-0.04 ms. So the design feeds the tensor cores: both products run
// on gemm_sm90.cuh (TMA ring, wgmma in ping-pong, persistent grid, weights
// read N-major as stored, the output stored by TMA), which picks 64-wide
// output tiles where they cut a ragged last wave (the serve shapes'
// c_fc); the LN reads each row once into registers with 16-byte loads.
// What still holds it back (H100): c_fc's exact erff gelu on the CUDA
// cores (gemm_sm90.cuh's note); the precompute chunk spends 26 us in LN,
// 263 in c_fc and 152 in c_proj, the same products.
#include "gemm_sm90.cuh"
#include "ln_rows.cuh"

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [N, D] bf16; ln_g/ln_b: [D] fp32; w1: [D, Hd] bf16; b1: [Hd]
// fp32; w2: [Hd, D] bf16; b2: [D] fp32; act: 0 = gelu, 1 = quick_gelu.
// Scratch from the caller: xn [N, D] and hidden [N, Hd], bf16. D and Hd
// multiples of 64. Returns a cudaError_t (0 = launched).
int xtag_fused_mlp_half(const void* x, const float* ln_g, const float* ln_b,
                        const void* w1, const float* b1, const void* w2,
                        const float* b2, void* xn_ws, void* hid_ws, void* out,
                        int N, int D, int Hd, int act, float eps, void* stream) {
  using namespace xtag::sm90;
  if (N < 1 || D % 64 != 0 || Hd % 64 != 0 || (act != 0 && act != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(xn_ws);
  bf16* hid = static_cast<bf16*>(hid_ws);
  const bf16* w1b = static_cast<const bf16*>(w1);
  cudaError_t e = xtag::launch_ln(xb, ln_g, ln_b, xn, N, D, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = act == 0 ? launch_gemm<EPI_BIAS_GELU>(xn, w1b, b1, nullptr, hid, N, Hd, D, s)
               : launch_gemm<EPI_BIAS_QGELU>(xn, w1b, b1, nullptr, hid, N, Hd, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<EPI_BIAS_RESID>(hid, static_cast<const bf16*>(w2), b2, xb,
                                  static_cast<bf16*>(out), N, D, Hd, s);
  return static_cast<int>(e);
}

}  // extern "C"
