// Image normalization on Hopper: [B, H, W, 3] uint8 -> x * scale[c] + bias[c]
// in fp32 (one FMA, scale = 1/(255 std) and bias = -mean/std folded on the
// host), written as bf16 (round to nearest even) or as fp32.
// Replaces the Pallas kernel xtagclip_tpu/ops/preprocess.py
// ::normalize_images_pallas (:47, pallas_call :80).
//
// Bound on the H100: bytes. Each element reads 1 byte and writes 2 (bf16)
// or 4 (fp32) and costs one FMA, far below the card's ~295 FLOP per byte.
// The Pallas kernel walks the batch one image per grid step, because the
// TPU stages a whole image in VMEM; here the batch is one flat array of
// B*H*W*3 elements and every thread walks it with a grid-stride loop in
// chunks of 16 elements: one 16-byte load (uint4) of bytes, 16 FMAs, and
// 32 (bf16, as __nv_bfloat162 pairs) or 64 (fp32) bytes stored as uint4 /
// float4. 16 = 1 (mod 3), so chunk c starts at channel c % 3 and the three
// per-channel constants are rotated once per chunk into registers; the 16
// elements then index them with compile-time constants. Elements past the
// last whole chunk, or every element when a base pointer is not 16-byte
// aligned, take a scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Affine {
  float s0, s1, s2, b0, b1, b2;
};

constexpr int THREADS = 256;
constexpr int CHUNK = 16;

__device__ __forceinline__ float pick(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

template <bool BF16>
__device__ __forceinline__ void store_chunk(void* out, long long c, const float (&y)[CHUNK]) {
  if constexpr (BF16) {
    uint4 w[2];
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(w);
#pragma unroll
    for (int j = 0; j < CHUNK / 2; ++j) p[j] = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
    uint4* dst = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + c * CHUNK);
    dst[0] = w[0];
    dst[1] = w[1];
  } else {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + c * CHUNK);
#pragma unroll
    for (int j = 0; j < CHUNK / 4; ++j)
      dst[j] = make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
  }
}

template <bool BF16>
__device__ __forceinline__ void store_one(void* out, long long i, float y) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[i] = y;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
normalize_u8_kernel(const uint8_t* __restrict__ x, void* __restrict__ out,
                    long long n, long long n_vec_chunks, Affine a) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long c = tid; c < n_vec_chunks; c += stride) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + c);
    const uint8_t* v = reinterpret_cast<const uint8_t*>(&raw);
    const int phase = (int)(c % 3);
    // rotated constants: element j of the chunk has channel (phase + j) % 3
    const float sa = pick(phase, a.s0, a.s1, a.s2);
    const float sb = pick(phase, a.s1, a.s2, a.s0);
    const float sc = pick(phase, a.s2, a.s0, a.s1);
    const float ba = pick(phase, a.b0, a.b1, a.b2);
    const float bb = pick(phase, a.b1, a.b2, a.b0);
    const float bc = pick(phase, a.b2, a.b0, a.b1);
    float y[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float s = (j % 3 == 0) ? sa : ((j % 3 == 1) ? sb : sc);
      const float b = (j % 3 == 0) ? ba : ((j % 3 == 1) ? bb : bc);
      y[j] = __fmaf_rn((float)v[j], s, b);
    }
    store_chunk<BF16>(out, c, y);
  }
  // scalar tail: the elements past the last whole chunk
  for (long long i = n_vec_chunks * CHUNK + tid; i < n; i += stride) {
    const int ch = (int)(i % 3);
    const float y = __fmaf_rn((float)x[i], pick(ch, a.s0, a.s1, a.s2), pick(ch, a.b0, a.b1, a.b2));
    store_one<BF16>(out, i, y);
  }
}

}  // namespace

extern "C" {

const char* xtag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: n uint8 (a contiguous [B, H, W, 3] batch, n = B*H*W*3); out: n bf16
// (out_bf16 = 1) or fp32 (out_bf16 = 0); scale/bias per channel.
// Returns a cudaError_t (0 = launched).
int xtag_normalize_images(const void* x, void* out, long long n, int out_bf16,
                          float s0, float s1, float s2, float b0, float b1,
                          float b2, void* stream) {
  if (n < 0 || n % 3 != 0 || (out_bf16 != 0 && out_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long n_vec_chunks = aligned ? n / CHUNK : 0;
  const long long work = n_vec_chunks > 0 ? n_vec_chunks : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks an SM, grid-stride
  const Affine a{s0, s1, s2, b0, b1, b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    normalize_u8_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), out, n, n_vec_chunks, a);
  else
    normalize_u8_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(x), out, n, n_vec_chunks, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
