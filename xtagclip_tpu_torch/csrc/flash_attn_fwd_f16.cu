// Flash attention's forward in float16 without a mask: the C entry point
// of the float16 instantiations of flash_attn_fwd.cuh (its notes: what it
// computes, the TPU kernel it replaces, its bound and design), a library
// of its own so that nvcc builds it beside the bf16 ones. JAX's flash
// kernel takes float16 streams (a pure_fp16 GAP tower); its fused halves,
// the one Pallas route under a mask, do not, so there is no masked
// float16 instantiation.
#include "flash_attn_fwd.cuh"

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// See xtag::fa_fwd::run: q, k, v, o float16, mask null. Returns a
// cudaError_t (0 = launched).
int xtag_flash_attn_fwd_f16(const void* q, const void* k, const void* v, void* o, float* lse,
                            const long long* strides, int B, int H, int L, int dh, float scale,
                            const void* mask, int mask_bf16, void* stream) {
  return static_cast<int>(xtag::fa_fwd::run<__half, false>(
      q, k, v, o, lse, strides, B, H, L, dh, scale, mask, mask_bf16, stream));
}

}  // extern "C"
