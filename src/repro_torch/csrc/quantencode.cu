// The fused NDSC encoder, plain and with the error-feedback residual.
//
// Per row u of length n: x = H(D u) (sign flip, normalized radix-2 FWHT),
// scale = max|x|, optional x += dither * scale, R-bit index
// clip(floor((clip(x / max(scale, FLT_MIN), -1, 1) + 1) / (2 / 2^R)),
// 0, 2^R - 1), code j packed at bit j*R of int32 words, optional 0/1 row
// mask on words and scale. With a residual output it then decodes its own
// payload in the tile (dequantize, mask, / rescale, FWHT, sign flip, round
// through f32 or bf16) and writes u - y.
//
// Replaces: src/repro/kernels/quantencode.py, encode_pallas and
// encode_ef_pallas (one pl.pallas_call in _encode_call, body
// _encode_kernel). Called through repro_torch.kernels.ops.encode /
// encode_ef from repro_torch.dist.gradcomp.
//
// Bound on an H100: bytes. Encode reads 4 B per coordinate (8 B with the
// dither) and writes R/8 B; the EF variant also writes the 4 B residual.
// The FWHT and quantizer cost O(log2 n) operations per coordinate.
// Design: a block holds max(1, 2048/n) whole rows in shared memory. The
// embedding, the dithered values and the decoded rows live only there, so
// device memory sees the input, the payload and the residual once each
// (the residual step re-reads u, which the L2 cache mostly serves). The
// row maximum is an atomicMax on the bit patterns of |x| in shared memory,
// exact for non-negative floats. Each thread packs whole words (with
// ndsc::quantize_pack_word, which quantpack.cu's quantize_pack shares), so
// word stores are coalesced; the dither is added elementwise, so its reads
// are.
#include <cuda_bf16.h>

#include "ndsc_common.cuh"

namespace {

constexpr int kMaxRowsPerBlock = ndsc::kTileFloats / 32;  // n >= 32

__global__ void encode_kernel(const float* __restrict__ x,
                              const float* __restrict__ signs,
                              const float* __restrict__ dither,
                              const float* __restrict__ mask,
                              int32_t* __restrict__ words,
                              float* __restrict__ scale_out,
                              float* __restrict__ residual, int64_t rows,
                              int log2n, int bits, float inv_sqrt_n,
                              int has_rescale, float rescale,
                              int residual_bf16) {
  extern __shared__ float sm[];
  __shared__ int row_max[kMaxRowsPerBlock];
  const int n = 1 << log2n;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int nrows = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);
  const int tile = nrows * n;
  const float* xb = x + r0 * n;

  for (int t = threadIdx.x; t < nrows; t += blockDim.x) row_max[t] = 0;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    sm[e] = __fmul_rn(xb[e], signs[e & (n - 1)]);
  ndsc::fwht_tile(sm, nrows, log2n, inv_sqrt_n);

  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    atomicMax(&row_max[e >> log2n], __float_as_int(fabsf(sm[e])));
  __syncthreads();

  if (dither != nullptr) {
    const float* db = dither + r0 * n;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const float s = __int_as_float(row_max[e >> log2n]);
      sm[e] = __fadd_rn(sm[e], __fmul_rn(db[e], s));
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    const float s = __int_as_float(row_max[t]);
    scale_out[r0 + t] = mask != nullptr ? __fmul_rn(s, mask[r0 + t]) : s;
  }

  const int k = 32 / bits;
  const int wpr = n / k;
  const float inv_levels = ndsc::inv_levels(bits);
  for (int wi = threadIdx.x; wi < nrows * wpr; wi += blockDim.x) {
    const int r = wi / wpr;
    const int c = wi - r * wpr;
    const float s = __int_as_float(row_max[r]);
    float* v = sm + r * n + c * k;
    int32_t wo = static_cast<int32_t>(ndsc::quantize_pack_word(v, s, bits));
    float s_out = s;
    float mk = 1.0f;
    if (mask != nullptr) {
      mk = mask[r0 + r];
      wo *= static_cast<int32_t>(mk);
      s_out = __fmul_rn(s, mk);
    }
    words[(r0 + r) * wpr + c] = wo;
    if (residual != nullptr) {
      // decode this word's own (masked) codes in place: only this thread
      // reads or writes these k values in this loop
      const unsigned wu = static_cast<unsigned>(wo);
      const unsigned code_mask = (1u << bits) - 1u;
      for (int j = 0; j < k; ++j) {
        const unsigned idx = (wu >> (j * bits)) & code_mask;
        float xh = ndsc::dequant(idx, inv_levels, s_out);
        if (mask != nullptr) {
          xh = __fmul_rn(xh, mk);
          if (has_rescale) xh = __fdiv_rn(xh, rescale);
        }
        v[j] = xh;
      }
    }
  }
  if (residual == nullptr) return;  // uniform across the block

  ndsc::fwht_tile(sm, nrows, log2n, inv_sqrt_n);
  float* rb = residual + r0 * n;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    float y = __fmul_rn(sm[e], signs[e & (n - 1)]);
    if (residual_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
    rb[e] = __fsub_rn(xb[e], y);
  }
}

}  // namespace

// x, dither, residual: (rows, n) float32; signs: (n,) float32; mask,
// scale_out: (rows,) float32; words: (rows, n*bits/32) int32. dither, mask
// and residual may be null. Returns cudaGetLastError().
extern "C" int ndsc_encode(const float* x, const float* signs,
                           const float* dither, const float* mask,
                           int32_t* words, float* scale_out, float* residual,
                           int64_t rows, int n, int bits, float inv_sqrt_n,
                           int has_rescale, float rescale, int residual_bf16,
                           cudaStream_t stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8)
    return cudaErrorInvalidValue;
  if (!ndsc::is_pow2(n) || n < 32 || n > ndsc::kMaxN)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * n * sizeof(float);
  encode_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, smem,
                  stream>>>(x, signs, dither, mask, words, scale_out,
                            residual, rows, ndsc::log2_int(n), bits,
                            inv_sqrt_n, has_rescale, rescale, residual_bf16);
  return static_cast<int>(cudaGetLastError());
}
