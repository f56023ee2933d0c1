// Unpack + dequantize of NDSC payload words: code j of a word sits at bit
// j*R; value = (-1 + (2*idx + 1) / 2^R) * scale, trimmed to n per row.
//
// Replaces: src/repro/kernels/quantpack.py, unpack_dequant_pallas
// (pl.pallas_call body _unpackdequant_kernel). Called through
// repro_torch.kernels.ops.unpack_dequant in every NDSC decode.
// (quantize_pack_pallas, the other kernel of that file, is not ported yet.)
//
// Bound on an H100: bytes. It reads R/8 B of words and writes 4 B of f32
// per coordinate (plus one scale per row), with a handful of integer and
// float operations per output.
// Design: a block owns max(1, 2048/n) whole rows; each thread writes one
// output float, so stores are coalesced, and neighbouring threads read the
// same word, which the L1 cache serves. Indexing within a block is 32-bit.
#include "ndsc_common.cuh"

namespace {

__global__ void unpack_dequant_kernel(const int32_t* __restrict__ words,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int64_t rows,
                                      int wpr, int n, int bits) {
  const int rpb = ndsc::rows_per_block(n);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int nrows = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);
  const int k = 32 / bits;
  const unsigned code_mask = (1u << bits) - 1u;
  const float levels = static_cast<float>(1 << bits);
  const int32_t* wb = words + r0 * wpr;
  const float* sb = scale + r0;
  float* ob = out + r0 * n;
  for (int e = threadIdx.x; e < nrows * n; e += blockDim.x) {
    const int r = e / n;
    const int j = e - r * n;
    const unsigned w = static_cast<unsigned>(wb[r * wpr + j / k]);
    const unsigned idx = (w >> ((j % k) * bits)) & code_mask;
    const float t = __fadd_rn(__fmul_rn(2.0f, static_cast<float>(idx)), 1.0f);
    const float v = __fadd_rn(-1.0f, __fdiv_rn(t, levels));
    ob[e] = __fmul_rn(v, sb[r]);
  }
}

}  // namespace

// words: (rows, wpr) int32; scale: (rows,) float32; out: (rows, n) float32;
// n <= wpr * 32 / bits. Returns cudaGetLastError().
extern "C" int ndsc_unpack_dequant(const int32_t* words, const float* scale,
                                   float* out, int64_t rows, int wpr, int n,
                                   int bits, cudaStream_t stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8)
    return cudaErrorInvalidValue;
  if (n <= 0 || n > wpr * (32 / bits)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  unpack_dequant_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, 0,
                          stream>>>(words, scale, out, rows, wpr, n, bits);
  return static_cast<int>(cudaGetLastError());
}
