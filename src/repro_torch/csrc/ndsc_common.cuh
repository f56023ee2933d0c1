// Shared pieces of the NDSC codec kernels (fwht.cu, quantpack.cu,
// quantencode.cu, quantdecode.cu): the row tiling, the in-shared-memory
// FWHT and the quantize-and-pack of one int32 word. The warp-resident FWHT
// of fwht.cu and quantencode.cu is in warp_rows.cuh.
//
// Bitwise contract with the plain versions (repro_torch/kernels/ref.py):
// every float operation on the payload path is a round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), so nvcc cannot
// contract a multiply and an add into an fma, and division is correctly
// rounded. The FWHT keeps the radix-2 order of ref.fwht (pair i with i+h
// for h = 1, 2, 4, ...) and its single final multiply by f32(1/sqrt(N)).
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace ndsc {

constexpr int kThreads = 256;
// A block holds max(1, kTileFloats / n) rows of n floats in shared memory:
// 8 KB for n <= 2048, one 32 KB row at the largest n = 8192.
constexpr int kTileFloats = 2048;
constexpr int kMaxN = 8192;

__host__ __device__ inline int rows_per_block(int n) {
  return n >= kTileFloats ? 1 : kTileFloats / n;
}

inline int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

inline bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// What one kernel has been granted on each device: the dynamic shared
// memory it opted in to (cudaFuncSetAttribute) and, for a persistent
// kernel, the blocks of it that fit on the card at once.
constexpr int kMaxDevices = 64;
struct LaunchCache {
  int smem[kMaxDevices];
  int blocks[kMaxDevices];
};

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device: Hopper gives a block up to 227 KB, but above 48 KB only after
// this call. It is made once per (kernel, device) and size; a failure is
// returned and not cached.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes, LaunchCache* c) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && c->smem[dev] >= bytes) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc == cudaSuccess && dev < kMaxDevices) c->smem[dev] = bytes;
  return rc;
}

// The blocks of `threads` threads and `bytes` of dynamic shared memory that
// fit on the current device at once (after the opt-in), read once per
// (kernel, device); an error where not one block fits.
template <typename Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, int bytes,
                                     LaunchCache* c, int* blocks) {
  cudaError_t rc = opt_in_smem(kernel, bytes, c);
  if (rc != cudaSuccess) return rc;
  int dev = 0;
  rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && c->blocks[dev] > 0) {
    *blocks = c->blocks[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     threads, bytes);
  if (rc != cudaSuccess) return rc;
  if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) c->blocks[dev] = sms * per_sm;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// In place, normalized FWHT of `nrows` rows of length n = 2^log2n held in
// shared memory. All threads of the block must call it; it synchronizes
// before the first stage and after the final scaling.
__device__ inline void fwht_tile(float* sm, int nrows, int log2n,
                                 float inv_sqrt_n) {
  const int n = 1 << log2n;
  const int pairs_per_row = n >> 1;
  const int pairs = nrows * pairs_per_row;
  for (int h = 1; h < n; h <<= 1) {
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int row = p >> (log2n - 1);
      const int j = p & (pairs_per_row - 1);
      const int i = row * n + ((j & ~(h - 1)) << 1) + (j & (h - 1));
      const float a = sm[i];
      const float b = sm[i + h];
      sm[i] = __fadd_rn(a, b);
      sm[i + h] = __fsub_rn(a, b);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x)
    sm[e] = __fmul_rn(sm[e], inv_sqrt_n);
  __syncthreads();
}

// The R-bit code of v against denom = max(scale, FLT_MIN):
// clip(floor((clip(v / denom, -1, 1) + 1) / (2 / 2^bits)), 0, 2^bits - 1),
// as ref.quantize_pack. Dividing by the power of two 2 / 2^bits is
// multiplying by 2^(bits-1): both are exact on [0, 2], so the product gives
// the division's bits.
__device__ inline unsigned quantize_code(float v, float denom, int bits) {
  const float levels = static_cast<float>(1 << bits);
  const float inv_delta = static_cast<float>(1 << (bits - 1));
  const float q = fminf(fmaxf(__fdiv_rn(v, denom), -1.0f), 1.0f);
  float id = floorf(__fmul_rn(__fadd_rn(q, 1.0f), inv_delta));
  id = fminf(fmaxf(id, 0.0f), levels - 1.0f);
  return static_cast<unsigned>(id);
}

// The k = 32/bits values v[0..k) quantized against `scale` and packed,
// code j at bit j*bits.
__device__ inline unsigned quantize_pack_word(const float* v, float scale,
                                              int bits) {
  const int k = 32 / bits;
  const float denom = fmaxf(scale, FLT_MIN);
  unsigned w = 0;
  for (int j = 0; j < k; ++j)
    w |= quantize_code(v[j], denom, bits) << (j * bits);
  return w;
}

// 2^-bits, the argument `dequant` takes.
__host__ __device__ inline float inv_levels(int bits) {
  return 1.0f / static_cast<float>(1 << bits);
}

// Dequantized value of code `idx`: (-1 + (2*idx + 1) / 2^bits) * scale,
// as ref.unpack_dequant. 2*idx + 1 < 2^9 is an integer, so its quotient by
// 2^bits is exact and equals its product with inv_levels(bits).
__device__ inline float dequant(unsigned idx, float inv_levels, float scale) {
  const float t = __fadd_rn(__fmul_rn(2.0f, static_cast<float>(idx)), 1.0f);
  return __fmul_rn(__fadd_rn(-1.0f, __fmul_rn(t, inv_levels)), scale);
}

}  // namespace ndsc
