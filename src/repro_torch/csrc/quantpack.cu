// Quantize + pack against a given scale, and its inverse, unpack +
// dequantize, of NDSC payload words: code j of a word sits at bit j*R.
// Pack: index clip(floor((clip(x / max(scale, FLT_MIN), -1, 1) + 1) /
// (2 / 2^R)), 0, 2^R - 1). Unpack: value = (-1 + (2*idx + 1) / 2^R) *
// scale, trimmed to n per row.
//
// Replaces: src/repro/kernels/quantpack.py, quantize_pack_pallas
// (pl.pallas_call body _quantpack_kernel) and unpack_dequant_pallas (body
// _unpackdequant_kernel). Called through repro_torch.kernels.ops:
// quantize_pack from the KV-cache encode (models/kvquant.encode_entry),
// unpack_dequant in every NDSC decode.
//
// Bound on an H100: bytes. Pack reads 4 B of f32 per coordinate (plus one
// scale per row) and writes R/8 B; unpack the reverse. Each does a handful
// of integer and float operations per coordinate.
// Design, pack: one thread per output word, in a grid-stride loop over all
// rows * words (64-bit indices, no cap on N), so word stores are coalesced
// and the k inputs of a word are k neighbouring floats. The quantizer is
// ndsc::quantize_pack_word, built on ndsc::quantize_code as the fused
// encoder's is. Unpack: a block owns max(1, 2048/n) whole rows; each thread writes
// one output float, so stores are coalesced, and neighbouring threads read
// the same word, which the L1 cache serves.
#include "ndsc_common.cuh"

namespace {

__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     const float* __restrict__ scale,
                                     int32_t* __restrict__ words,
                                     int64_t total_words, int wpr, int bits) {
  const int k = 32 / bits;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t wi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       wi < total_words; wi += stride) {
    words[wi] = static_cast<int32_t>(
        ndsc::quantize_pack_word(x + wi * k, scale[wi / wpr], bits));
  }
}

__global__ void unpack_dequant_kernel(const int32_t* __restrict__ words,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int64_t rows,
                                      int wpr, int n, int bits) {
  const int rpb = ndsc::rows_per_block(n);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int nrows = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);
  const int k = 32 / bits;
  const unsigned code_mask = (1u << bits) - 1u;
  const float inv_levels = ndsc::inv_levels(bits);
  const int32_t* wb = words + r0 * wpr;
  const float* sb = scale + r0;
  float* ob = out + r0 * n;
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x) {
    const int r = e / n;
    const int j = e - r * n;
    const unsigned w = static_cast<unsigned>(wb[r * wpr + j / k]);
    const unsigned idx = (w >> ((j % k) * bits)) & code_mask;
    ob[e] = ndsc::dequant(idx, inv_levels, sb[r]);
  }
}

bool valid_bits(int bits) {
  return bits == 1 || bits == 2 || bits == 4 || bits == 8;
}

}  // namespace

// x: (rows, n) float32; scale: (rows,) float32; words: (rows, n*bits/32)
// int32; n a positive multiple of 32/bits. Returns cudaGetLastError().
extern "C" int ndsc_quantize_pack(const float* x, const float* scale,
                                  int32_t* words, int64_t rows, int n,
                                  int bits, cudaStream_t stream) {
  if (!valid_bits(bits)) return cudaErrorInvalidValue;
  const int k = 32 / bits;
  if (n <= 0 || n % k) return cudaErrorInvalidValue;
  const int wpr = n / k;
  const int64_t total = rows * wpr;
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + ndsc::kThreads - 1) / ndsc::kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  quantize_pack_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, 0,
                         stream>>>(x, scale, words, total, wpr, bits);
  return static_cast<int>(cudaGetLastError());
}

// words: (rows, wpr) int32; scale: (rows,) float32; out: (rows, n) float32;
// n <= wpr * 32 / bits. Returns cudaGetLastError().
extern "C" int ndsc_unpack_dequant(const int32_t* words, const float* scale,
                                   float* out, int64_t rows, int wpr, int n,
                                   int bits, cudaStream_t stream) {
  if (!valid_bits(bits)) return cudaErrorInvalidValue;
  if (n <= 0 || n > wpr * (32 / bits)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  unpack_dequant_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, 0,
                          stream>>>(words, scale, out, rows, wpr, n, bits);
  return static_cast<int>(cudaGetLastError());
}
