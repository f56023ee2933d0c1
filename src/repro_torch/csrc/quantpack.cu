// Quantize + pack against a given scale, and its inverse, unpack +
// dequantize, of NDSC payload words: code j of a word sits at bit j*R.
// Pack: index clip(floor((clip(x / max(scale, FLT_MIN), -1, 1) + 1) /
// (2 / 2^R)), 0, 2^R - 1). Unpack: value = (-1 + (2*idx + 1) / 2^R) *
// scale, trimmed to n per row.
//
// Replaces: src/repro/kernels/quantpack.py, quantize_pack_pallas
// (pl.pallas_call body _quantpack_kernel) and unpack_dequant_pallas (body
// _unpackdequant_kernel). Called through repro_torch.kernels.ops:
// quantize_pack from the KV-cache encode (models/kvquant.encode_entry) and
// RATQ, unpack_dequant in every NDSC decode; both also inside the encoders
// from N = 2^16 (kernels/quantencode.py).
//
// Bound on an H100: bytes. Pack reads 4 B of f32 per coordinate (plus one
// scale per row) and writes R/8 B; unpack the reverse. Each does a handful
// of integer and float operations per coordinate.
// Design, pack: the input is one flat stream of float4s. Where wpr is a
// power of two (every call of the port's paths but the 12288-wide sweep
// row), thread f loads float4 f, neighbouring threads on neighbouring
// addresses, quantizes its 4 values with ndsc::quantize_code (bitwise
// ref.quantize_pack, as the fused encoder's) into its bit field of word
// f / F4 (F4 = 8/R float4s a word), and the F4 lanes of a word OR their
// fields together with __shfl_xor_sync (none at R 8); the first of them
// stores the word, so a warp writes 16R contiguous bytes. R is a template
// argument and the row is the word index shifted by log2(wpr), so there is
// no division. The optional dither (x + d * scale, as __fadd_rn(x,
// __fmul_rn(d, scale))), row mask (masked rows emit zero words) and masked
// scale output (scale * mask) make the same kernel the tail of the encoders
// from N = 2^16 (quantencode.py). Other widths take a row kernel: one
// thread per output word, its row by a division (no dither or mask).
// The first design (one thread per word everywhere, k scalar loads of
// neighbouring floats, so a warp's loads touched up to 32 lines at once,
// a 64-bit division per word, and a grid capped at 2^20 blocks) ran at
// 0.58-0.61 of its bound at the training shapes (PERF.md).
// Design, unpack: a write stream, 4 B out for every R/8 B in. Where rows
// are whole (n == wpr * 32/R, every decode of the codec) and wpr is a
// power of two (every wpr of the port's paths: the chunk is one, and so is
// R), the output is one flat stream in which word w's k = 32/R codes are
// floats [w*k, w*k + k). Each thread owns one float4 of it: it loads the
// word (the k/4 lanes that share a word load it in one instruction) and
// the row's scale, and stores 16 B, so a warp writes 512 contiguous bytes.
// R is a template argument, so the word index, the code shifts and the
// mask are constants; the row is the word index shifted by log2(wpr). A
// thread per word (k/4 float4 stores 4k bytes apart) and a grid capped at
// a few blocks per SM (a grid-stride loop) were both slower on the card.
// Other rows (trimmed, n < wpr * k, or wpr not a power of two) take a
// row-wise kernel: a block owns max(1, 2048/n) whole rows and each thread
// writes one output float.
#include "ndsc_common.cuh"

namespace {

// Row path: one thread per output word, its row by a division.
__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ scale,
                                     int32_t* __restrict__ words,
                                     int64_t total_words, int wpr, int bits) {
  const int k = 32 / bits;
  const int64_t wi =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (wi >= total_words) return;
  words[wi] = static_cast<int32_t>(
      ndsc::quantize_pack_word(x + wi * k, scale[wi / wpr], bits));
}

// Flat path: thread f quantizes float4 f of x, codes 4*(f % F4) .. +3 of
// word f / F4 (F4 = 8/R float4s a word), against the scale of row
// (word >> wpr_shift). dither, mask and scale_out may be null.
template <int BITS>
__global__ void quantize_flat_kernel(const float4* __restrict__ x,
                                     const float* __restrict__ scale,
                                     const float4* __restrict__ dither,
                                     const float* __restrict__ mask,
                                     uint32_t* __restrict__ words,
                                     float* __restrict__ scale_out,
                                     int64_t total_f4, int wpr_shift) {
  constexpr int kLog2F4 = BITS == 1 ? 3 : BITS == 2 ? 2 : BITS == 4 ? 1 : 0;
  constexpr int kF4 = 1 << kLog2F4;
  const int64_t f =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = f < total_f4;
  const int64_t wi = f >> kLog2F4;
  const int64_t row = wi >> wpr_shift;
  float s = 0.0f;
  unsigned w = 0;
  if (valid) {
    s = __ldg(scale + row);
    float4 v = x[f];
    if (dither != nullptr) {
      const float4 d = dither[f];
      v.x = __fadd_rn(v.x, __fmul_rn(d.x, s));
      v.y = __fadd_rn(v.y, __fmul_rn(d.y, s));
      v.z = __fadd_rn(v.z, __fmul_rn(d.z, s));
      v.w = __fadd_rn(v.w, __fmul_rn(d.w, s));
    }
    const float denom = fmaxf(s, FLT_MIN);
    const int sh = static_cast<int>(f & (kF4 - 1)) * 4 * BITS;
    w = ndsc::quantize_code(v.x, denom, BITS) << sh |
        ndsc::quantize_code(v.y, denom, BITS) << (sh + BITS) |
        ndsc::quantize_code(v.z, denom, BITS) << (sh + 2 * BITS) |
        ndsc::quantize_code(v.w, denom, BITS) << (sh + 3 * BITS);
  }
  // the F4 lanes of a word hold disjoint bit fields; every lane of the
  // warp takes part in the shuffles, valid or not
#pragma unroll
  for (int o = 1; o < kF4; o <<= 1)
    w |= __shfl_xor_sync(0xffffffffu, w, o);
  if (!valid || (f & (kF4 - 1)) != 0) return;
  float mk = 1.0f;
  if (mask != nullptr) {
    mk = __ldg(mask + row);
    // the int32 product with the mask, wrapping as ref.encode's does
    w *= static_cast<unsigned>(static_cast<int32_t>(mk));
  }
  words[wi] = w;
  if (scale_out != nullptr && (wi & ((int64_t(1) << wpr_shift) - 1)) == 0)
    scale_out[row] = mask != nullptr ? __fmul_rn(s, mk) : s;
}

// Flat path: thread f stores float4 f of the output, codes
// 4*(f % F4) .. +3 of word f / F4 (F4 = 8/R float4s a word), with the
// scale of row (word >> wpr_shift).
template <int BITS>
__global__ void unpack_flat_kernel(const uint32_t* __restrict__ words,
                                   const float* __restrict__ scale,
                                   float4* __restrict__ out, int64_t total_f4,
                                   int wpr_shift) {
  constexpr int kLog2F4 = BITS == 1 ? 3 : BITS == 2 ? 2 : BITS == 4 ? 1 : 0;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  const int64_t f =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= total_f4) return;
  const float il = ndsc::inv_levels(BITS);
  const int64_t wi = f >> kLog2F4;
  const unsigned w = __ldg(words + wi);
  const float s = __ldg(scale + (wi >> wpr_shift));
  const int sh = static_cast<int>(f & ((1 << kLog2F4) - 1)) * 4 * BITS;
  float4 v;
  v.x = ndsc::dequant((w >> sh) & kMask, il, s);
  v.y = ndsc::dequant((w >> (sh + BITS)) & kMask, il, s);
  v.z = ndsc::dequant((w >> (sh + 2 * BITS)) & kMask, il, s);
  v.w = ndsc::dequant((w >> (sh + 3 * BITS)) & kMask, il, s);
  out[f] = v;
}

// Other rows (trimmed, n < wpr * 32/bits, or wpr not a power of two): a
// block owns rpb whole rows, a thread writes one float.
__global__ void unpack_rows_kernel(const int32_t* __restrict__ words,
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

template <int BITS>
void launch_flat(const int32_t* words, const float* scale, float* out,
                 int64_t total_f4, int wpr_shift, unsigned blocks,
                 cudaStream_t stream) {
  unpack_flat_kernel<BITS><<<blocks, ndsc::kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(words), scale,
      reinterpret_cast<float4*>(out), total_f4, wpr_shift);
}

template <int BITS>
void launch_quantize_flat(const float* x, const float* scale,
                          const float* dither, const float* mask,
                          int32_t* words, float* scale_out, int64_t total_f4,
                          int wpr_shift, unsigned blocks,
                          cudaStream_t stream) {
  quantize_flat_kernel<BITS><<<blocks, ndsc::kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), scale,
      reinterpret_cast<const float4*>(dither), mask,
      reinterpret_cast<uint32_t*>(words), scale_out, total_f4, wpr_shift);
}

bool valid_bits(int bits) {
  return bits == 1 || bits == 2 || bits == 4 || bits == 8;
}

}  // namespace

// x: (rows, n) float32; scale: (rows,) float32; words: (rows, n*bits/32)
// int32; n a positive multiple of 32/bits. Where wpr = n*bits/32 is a
// power of two (the flat path) x and dither are 16-byte aligned, and the
// optional dither (rows, n), mask (rows,) and scale_out (rows,) apply;
// other widths take none of them. Returns cudaGetLastError().
extern "C" int ndsc_quantize_pack(const float* x, const float* scale,
                                  const float* dither, const float* mask,
                                  int32_t* words, float* scale_out,
                                  int64_t rows, int n, int bits,
                                  cudaStream_t stream) {
  if (!valid_bits(bits)) return cudaErrorInvalidValue;
  const int k = 32 / bits;
  if (n <= 0 || n % k) return cudaErrorInvalidValue;
  const int wpr = n / k;
  const int64_t total = rows * wpr;
  if (!ndsc::is_pow2(wpr)) {
    if (dither != nullptr || mask != nullptr || scale_out != nullptr)
      return cudaErrorInvalidValue;
    if (total == 0) return cudaSuccess;
    const int64_t blocks = (total + ndsc::kThreads - 1) / ndsc::kThreads;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    quantize_rows_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, 0,
                           stream>>>(x, scale, words, total, wpr, bits);
    return static_cast<int>(cudaGetLastError());
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dither) % 16)
    return cudaErrorMisalignedAddress;
  const int64_t total_f4 = rows * n / 4;
  if (total_f4 == 0) return cudaSuccess;
  const int64_t blocks = (total_f4 + ndsc::kThreads - 1) / ndsc::kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const unsigned b = static_cast<unsigned>(blocks);
  const int sh = ndsc::log2_int(wpr);
  switch (bits) {
    case 1: launch_quantize_flat<1>(x, scale, dither, mask, words, scale_out,
                                    total_f4, sh, b, stream); break;
    case 2: launch_quantize_flat<2>(x, scale, dither, mask, words, scale_out,
                                    total_f4, sh, b, stream); break;
    case 4: launch_quantize_flat<4>(x, scale, dither, mask, words, scale_out,
                                    total_f4, sh, b, stream); break;
    default: launch_quantize_flat<8>(x, scale, dither, mask, words,
                                     scale_out, total_f4, sh, b, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Flat path. words: (rows, wpr) int32, wpr a power of two; scale: (rows,)
// float32; out: (rows, wpr * 32/bits) float32, 16-byte aligned. One
// float4 per thread. Returns cudaGetLastError().
extern "C" int ndsc_unpack_flat(const int32_t* words, const float* scale,
                                float* out, int64_t rows, int wpr, int bits,
                                cudaStream_t stream) {
  if (!valid_bits(bits) || wpr <= 0 || !ndsc::is_pow2(wpr))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16) return cudaErrorMisalignedAddress;
  const int64_t total_f4 = rows * wpr * (8 / bits);
  if (total_f4 == 0) return cudaSuccess;
  const int64_t blocks = (total_f4 + ndsc::kThreads - 1) / ndsc::kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const unsigned b = static_cast<unsigned>(blocks);
  const int sh = ndsc::log2_int(wpr);
  switch (bits) {
    case 1: launch_flat<1>(words, scale, out, total_f4, sh, b, stream); break;
    case 2: launch_flat<2>(words, scale, out, total_f4, sh, b, stream); break;
    case 4: launch_flat<4>(words, scale, out, total_f4, sh, b, stream); break;
    default: launch_flat<8>(words, scale, out, total_f4, sh, b, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Other rows. words: (rows, wpr) int32; scale: (rows,) float32; out:
// (rows, n) float32; n <= wpr * 32 / bits. Returns cudaGetLastError().
extern "C" int ndsc_unpack_rows(const int32_t* words, const float* scale,
                                float* out, int64_t rows, int wpr, int n,
                                int bits, cudaStream_t stream) {
  if (!valid_bits(bits)) return cudaErrorInvalidValue;
  if (n <= 0 || n > wpr * (32 / bits)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  unpack_rows_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, 0,
                       stream>>>(words, scale, out, rows, wpr, n, bits);
  return static_cast<int>(cudaGetLastError());
}
