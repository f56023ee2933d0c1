// The fused NDSC encoder, plain and with the error-feedback residual.
//
// Per row u of length n: x = H(D u) (sign flip, normalized radix-2 FWHT),
// scale = max|x|, optional x += dither * scale, R-bit index
// clip(floor((clip(x / max(scale, FLT_MIN), -1, 1) + 1) / (2 / 2^R)),
// 0, 2^R - 1), code j packed at bit j*R of int32 words, optional 0/1 row
// mask on words and scale. With a residual output it then decodes its own
// payload (dequantize, mask, / rescale, FWHT, sign flip, round through f32
// or bf16) and writes u - y.
//
// Replaces: src/repro/kernels/quantencode.py, encode_pallas and
// encode_ef_pallas (one pl.pallas_call in _encode_call, body
// _encode_kernel). Called through repro_torch.kernels.ops.encode /
// encode_ef from repro_torch.dist.gradcomp.
//
// Bound on an H100: bytes. Encode reads 4 B per coordinate (8 B with the
// dither) and writes R/8 B; the EF variant also writes the 4 B residual.
// The FWHT and quantizer cost O(log2 n) operations per coordinate.
// Design, for n <= ndsc::kWarpMaxN (warp_rows.cuh): a warp owns a row (or
// 128/n rows below n = 128) with V = max(4, n/32) consecutive values per
// lane in registers, moved as float4s. Each lane loads its V signs once and
// keeps them for every row; the warp strides over rows and loads the next
// row's u before it works on the current one. The FWHT runs in registers
// and shuffles; the scale is the integer maximum of the bit patterns of |x|
// (redux.sync across a 32-lane row, a shuffle tree below), so there are no
// atomics; the codes are packed from registers: V/k whole words per lane
// when V >= k = 32/R, else a word spans k/V lanes whose disjoint bit fields
// an OR-shuffle tree combines, and the first of them stores it. The
// residual decodes the lane's codes from the masked word, runs the inverse
// FWHT in registers and subtracts from u, which is still in registers:
// device memory sees u (and the dither), the words, the scale and the
// residual once each. The kernels are instantiated per (V, R) so that every
// register index is a constant. The cap kWarpMaxN = 1024 is the largest n
// whose kernels compile without spilling (226 registers at V = 32; one
// 4-byte spill at V = 8, R = 2, which ptxas chose at 64 registers). Above
// it a block holds max(1, 2048/n) rows in shared memory, runs
// ndsc::fwht_tile there, takes the row maximum with one shared atomicMax
// per warp after a redux.sync, and packs whole words per thread with
// ndsc::quantize_pack_word (which quantpack.cu's row kernel shares).
// N > 8192 (one row past a block's shared memory) does not come here:
// repro_torch/kernels/quantencode.py runs it as passes, fwht.cu's
// ndsc_fwht_pass with the sign flip and the row maximum folded in, then
// quantpack.cu's flat quantize kernel with the dither and the mask (and
// for the residual its flat unpack kernel and the passes again).
#include <cuda_bf16.h>

#include "ndsc_common.cuh"
#include "warp_rows.cuh"

namespace {

struct EncodeArgs {
  const float* x;
  const float* signs;
  const float* dither;    // null: no dither
  const float* mask;      // null: no mask
  int32_t* words;
  float* scale_out;
  float* residual;        // null: plain encode
  int64_t rows;
  int log2n;
  float inv_sqrt_n;
  int has_rescale;
  float rescale;
  int residual_bf16;
};

template <int V, int BITS>
__global__ void __launch_bounds__(ndsc::kThreads)
    encode_warp_kernel(const EncodeArgs a) {
  constexpr int K = 32 / BITS;                // codes per word
  constexpr int W = V >= K ? V / K : 1;       // words a lane holds
  constexpr int S = V >= K ? 1 : K / V;       // lanes a word spans
  constexpr unsigned kCodeMask = (1u << BITS) - 1u;
  const ndsc::WarpRows g = ndsc::WarpRows::make<V>(a.rows, a.log2n);
  const int n = g.n;
  const int wpr = n / K;
  const int lane_in_row = g.col / V;
  // bit offset of the lane's first code in its word when a word spans lanes
  const int shift0 = (lane_in_row % S) * V * BITS;
  const float inv_levels = ndsc::inv_levels(BITS);

  float s[V];
  ndsc::load_values<V>(a.signs + g.col, s);
  float next[V];
  ndsc::load_row<V>(a.x, g.row(g.first), a.rows, g, next);
  for (int64_t item = g.first; item < g.items; item += g.stride) {
    const int64_t row = g.row(item);
    const bool valid = row < a.rows;
    float u[V], e[V];
#pragma unroll
    for (int i = 0; i < V; ++i) u[i] = next[i];
    ndsc::load_row<V>(a.x, g.row(item + g.stride), a.rows, g, next);
    float d[V];
    if (a.dither != nullptr) ndsc::load_row<V>(a.dither, row, a.rows, g, d);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = __fmul_rn(u[i], s[i]);
    ndsc::warp_fwht<V>(e, n, a.inv_sqrt_n);
    const float scale = ndsc::row_absmax<V>(e, g.lanes_per_row);
    if (a.dither != nullptr) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        e[i] = __fadd_rn(e[i], __fmul_rn(d[i], scale));
    }
    float mk = 1.0f;
    float s_out = scale;
    if (a.mask != nullptr) {
      mk = valid ? a.mask[row] : 0.0f;
      s_out = __fmul_rn(scale, mk);
    }
    if (valid && lane_in_row == 0) a.scale_out[row] = s_out;

    const float denom = fmaxf(scale, FLT_MIN);
    unsigned w[W];
#pragma unroll
    for (int t = 0; t < W; ++t) w[t] = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const unsigned c = ndsc::quantize_code(e[i], denom, BITS);
      if constexpr (V >= K)
        w[i / K] |= c << ((i % K) * BITS);
      else
        w[0] |= c << (shift0 + i * BITS);
    }
    // the k/V lanes of a word hold disjoint bit fields: OR them together,
    // so that every one of them holds the whole word
#pragma unroll
    for (int o = 1; o < S; o <<= 1) w[0] |= __shfl_xor_sync(ndsc::kFullMask,
                                                           w[0], o);
    if (a.mask != nullptr) {
      // the int32 product with the mask, wrapping as ref.encode's does
      const unsigned m = static_cast<unsigned>(static_cast<int32_t>(mk));
#pragma unroll
      for (int t = 0; t < W; ++t) w[t] *= m;
    }
    if (valid) {
      int32_t* wr = a.words + row * wpr;
      if constexpr (V >= K) {
#pragma unroll
        for (int t = 0; t < W; ++t)
          wr[lane_in_row * W + t] = static_cast<int32_t>(w[t]);
      } else if (lane_in_row % S == 0) {
        wr[lane_in_row / S] = static_cast<int32_t>(w[0]);
      }
    }
    if (a.residual == nullptr) continue;      // uniform across the grid

    // decode the lane's own codes from the masked word; u is still here
#pragma unroll
    for (int i = 0; i < V; ++i) {
      unsigned idx;
      if constexpr (V >= K)
        idx = (w[i / K] >> ((i % K) * BITS)) & kCodeMask;
      else
        idx = (w[0] >> (shift0 + i * BITS)) & kCodeMask;
      float xh = ndsc::dequant(idx, inv_levels, s_out);
      if (a.mask != nullptr) {
        xh = __fmul_rn(xh, mk);
        if (a.has_rescale) xh = __fdiv_rn(xh, a.rescale);
      }
      e[i] = xh;
    }
    ndsc::warp_fwht<V>(e, n, a.inv_sqrt_n);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float y = __fmul_rn(e[i], s[i]);
      if (a.residual_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
      e[i] = __fsub_rn(u[i], y);
    }
    if (valid) ndsc::store_values<V>(a.residual + row * n + g.col, e);
  }
}

template <int V, int BITS>
int launch_warp_bits(const EncodeArgs& a, cudaStream_t stream) {
  static int max_blocks = 0;
  const int rows_per_item = 32 * V / (1 << a.log2n);
  const int64_t items = (a.rows + rows_per_item - 1) / rows_per_item;
  const unsigned blocks =
      ndsc::warp_grid(encode_warp_kernel<V, BITS>, items, &max_blocks);
  encode_warp_kernel<V, BITS><<<blocks, ndsc::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_warp(const EncodeArgs& a, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_warp_bits<V, 1>(a, stream);
    case 2: return launch_warp_bits<V, 2>(a, stream);
    case 4: return launch_warp_bits<V, 4>(a, stream);
    default: return launch_warp_bits<V, 8>(a, stream);
  }
}

constexpr int kMaxRowsPerBlock = ndsc::kTileFloats / 32;  // n >= 32

__global__ void encode_smem_kernel(const EncodeArgs a, int bits) {
  extern __shared__ float sm[];
  __shared__ unsigned row_max[kMaxRowsPerBlock];
  const int log2n = a.log2n;
  const int n = 1 << log2n;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int nrows = static_cast<int>(a.rows - r0 < rpb ? a.rows - r0 : rpb);
  const int tile = nrows * n;
  const float* xb = a.x + r0 * n;
  const float* signs = a.signs;
  const float* mask = a.mask;

  for (int t = threadIdx.x; t < nrows; t += blockDim.x) row_max[t] = 0;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    sm[e] = __fmul_rn(xb[e], signs[e & (n - 1)]);
  ndsc::fwht_tile(sm, nrows, log2n, a.inv_sqrt_n);

  // n >= kThreads, so tile is a multiple of blockDim.x: every lane takes
  // every pass, and a warp's 32 values of a pass lie in one row
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const unsigned m =
        __reduce_max_sync(ndsc::kFullMask, __float_as_uint(fabsf(sm[e])));
    if ((threadIdx.x & 31) == 0) atomicMax(&row_max[e >> log2n], m);
  }
  __syncthreads();

  if (a.dither != nullptr) {
    const float* db = a.dither + r0 * n;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const float s = __uint_as_float(row_max[e >> log2n]);
      sm[e] = __fadd_rn(sm[e], __fmul_rn(db[e], s));
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    const float s = __uint_as_float(row_max[t]);
    a.scale_out[r0 + t] = mask != nullptr ? __fmul_rn(s, mask[r0 + t]) : s;
  }

  const int k = 32 / bits;
  const int wpr = n / k;
  const float inv_levels = ndsc::inv_levels(bits);
  for (int wi = threadIdx.x; wi < nrows * wpr; wi += blockDim.x) {
    const int r = wi / wpr;
    const int c = wi - r * wpr;
    const float s = __uint_as_float(row_max[r]);
    float* v = sm + r * n + c * k;
    unsigned wo = ndsc::quantize_pack_word(v, s, bits);
    float s_out = s;
    float mk = 1.0f;
    if (mask != nullptr) {
      mk = mask[r0 + r];
      wo *= static_cast<unsigned>(static_cast<int32_t>(mk));
      s_out = __fmul_rn(s, mk);
    }
    a.words[(r0 + r) * wpr + c] = static_cast<int32_t>(wo);
    if (a.residual != nullptr) {
      // decode this word's own (masked) codes in place: only this thread
      // reads or writes these k values in this loop
      const unsigned code_mask = (1u << bits) - 1u;
      for (int j = 0; j < k; ++j) {
        const unsigned idx = (wo >> (j * bits)) & code_mask;
        float xh = ndsc::dequant(idx, inv_levels, s_out);
        if (mask != nullptr) {
          xh = __fmul_rn(xh, mk);
          if (a.has_rescale) xh = __fdiv_rn(xh, a.rescale);
        }
        v[j] = xh;
      }
    }
  }
  if (a.residual == nullptr) return;  // uniform across the block

  ndsc::fwht_tile(sm, nrows, log2n, a.inv_sqrt_n);
  float* rb = a.residual + r0 * n;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    float y = __fmul_rn(sm[e], signs[e & (n - 1)]);
    if (a.residual_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
    rb[e] = __fsub_rn(xb[e], y);
  }
}

}  // namespace

// x, dither, residual: (rows, n) float32; signs: (n,) float32; mask,
// scale_out: (rows,) float32; words: (rows, n*bits/32) int32. dither, mask
// and residual may be null; x, signs, dither and residual are 16-byte
// aligned. Returns cudaGetLastError().
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
  const EncodeArgs a{x, signs, dither, mask, words, scale_out, residual,
                     rows, ndsc::log2_int(n), inv_sqrt_n, has_rescale,
                     rescale, residual_bf16};
  if (n <= ndsc::kWarpMaxN) {
    switch (ndsc::warp_values(n)) {
      case 4: return launch_warp<4>(a, bits, stream);
      case 8: return launch_warp<8>(a, bits, stream);
      case 16: return launch_warp<16>(a, bits, stream);
      case 32: return launch_warp<32>(a, bits, stream);
    }
  }
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * n * sizeof(float);
  encode_smem_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, smem,
                       stream>>>(a, bits);
  return static_cast<int>(cudaGetLastError());
}
