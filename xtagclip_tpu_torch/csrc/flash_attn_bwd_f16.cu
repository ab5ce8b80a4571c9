// Flash attention's backward in float16 without a mask: the C entry point
// of the float16 instantiations of flash_attn_bwd.cuh (its notes: what it
// computes, the TPU kernels it replaces, its bound and design), a library
// of its own so that nvcc builds it beside the bf16 ones (the forward's
// flash_attn_fwd_f16.cu says why there is no masked one).
#include "flash_attn_bwd.cuh"

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// See xtag::fa_bwd::run: the eight views float16, mask null. Returns a
// cudaError_t (0 = launched).
int xtag_flash_attn_bwd_f16(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* stat_ws, void* dq,
                            void* dk, void* dv, const long long* strides, int B, int H,
                            int L, int dh, float scale, const void* mask, int mask_bf16,
                            void* stream) {
  return static_cast<int>(xtag::fa_bwd::run<__half, false>(
      q, k, v, o, dout, lse, stat_ws, dq, dk, dv, strides, B, H, L, dh, scale, mask,
      mask_bf16, stream));
}

}  // extern "C"
