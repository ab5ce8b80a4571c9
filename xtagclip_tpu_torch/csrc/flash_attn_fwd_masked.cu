// Flash attention's forward under an additive [L, L] mask: the C
// entry point of the masked (bf16) instantiations of flash_attn_fwd.cuh (its
// notes: what it computes, the TPU kernel it replaces, its bound and
// design), a library of its own so that nvcc builds the two beside each
// other.
#include "flash_attn_fwd.cuh"

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// See xtag::fa_fwd::run: mask non-null. Returns a cudaError_t (0 =
// launched).
int xtag_flash_attn_fwd_masked(const void* q, const void* k, const void* v, void* o,
                               float* lse, const long long* strides, int B, int H, int L,
                               int dh, float scale, const void* mask, int mask_bf16,
                               void* stream) {
  return static_cast<int>(xtag::fa_fwd::run<xtag::bf16, true>(
      q, k, v, o, lse, strides, B, H, L, dh, scale, mask, mask_bf16, stream));
}

}  // extern "C"
