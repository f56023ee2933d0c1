// Normalized fast Walsh-Hadamard transform along the last axis.
//
// Replaces: src/repro/kernels/fwht.py, fwht_pallas (pl.pallas_call body
// _fwht_kernel). Called through repro_torch.kernels.ops.fwht / unrotate in
// every NDSC decode, in the serve path's K/V and query rotation, and in
// the dsc codec's Hadamard frames (N up to 2^28).
//
// Bound on an H100: bytes. Each value is read once and written once
// (8 B per coordinate) against log2(N) adds per coordinate, far below the
// card's ratio of operations to bytes.
// Design, for 4 <= N <= ndsc::kWarpMaxN (warp_rows.cuh): one warp owns a row
// (or 128/N rows below N = 128) with V = max(4, N/32) consecutive values per
// lane in registers, loaded and stored as float4s; butterfly stages h < V
// run in registers and h >= V across lanes with __shfl_xor_sync, so there
// is no shared memory and no block barrier. Each warp strides over items
// and loads its next item before transforming the current one, so one
// item's loads overlap the previous one's arithmetic. The cap, N 1024
// (V = 32, 100 registers here), is where the encoder's registers run out
// (warp_rows.cuh). Above it (and for N < 4) up to N = 8192 a block loads
// max(1, 2048/N) rows into shared memory and runs the stages there between
// __syncthreads (ndsc_fwht, one launch).
// Above N = 8192 (ndsc_fwht_pass, one launch per pass) the stages are
// split into passes in increasing h, as repro_torch.kernels.fwht.fwht_plan
// lays them out: every stage maps each pair to (a + b, a - b) on its own,
// so any split that keeps the order gives ref.fwht's bits. A pass of
// stages [s, s + k) owns tiles of 2^k values 2^s apart (the bits s..s+k-1
// of the position) by W contiguous columns: W = 1 and 2^13 contiguous
// values in the first pass, W >= 32 floats (whole 128 B lines) later. A
// block loads its tile into shared memory as float4s, runs the k stages
// there and writes the tile back; tiles are disjoint, so the passes after
// the first run in place. Only the last pass multiplies by f32(1/sqrt(N)).
// The decode and the encoders from N = 2^16 (quantencode.py) fold their
// per-value steps into the first pass's loads (signs; row mask, rescale)
// and the last pass's stores (signs, bf16 rounding, the EF subtract, the
// row maximum by atomicMax on the bits of |x|). Element offsets are int64.
#include <cuda_bf16.h>

#include "ndsc_common.cuh"
#include "warp_rows.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(ndsc::kThreads)
    fwht_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int64_t rows, int log2n, float inv_sqrt_n) {
  const ndsc::WarpRows g = ndsc::WarpRows::make<V>(rows, log2n);
  float next[V];
  ndsc::load_row<V>(x, g.row(g.first), rows, g, next);
  for (int64_t item = g.first; item < g.items; item += g.stride) {
    const int64_t row = g.row(item);
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = next[i];
    ndsc::load_row<V>(x, g.row(item + g.stride), rows, g, next);
    ndsc::warp_fwht<V>(v, g.n, inv_sqrt_n);
    if (row < rows) ndsc::store_values<V>(y + row * g.n + g.col, v);
  }
}

template <int V>
int launch_warp(const float* x, float* y, int64_t rows, int n,
                float inv_sqrt_n, cudaStream_t stream) {
  static int max_blocks = 0;
  const int rows_per_item = 32 * V / n;
  const int64_t items = (rows + rows_per_item - 1) / rows_per_item;
  const unsigned blocks =
      ndsc::warp_grid(fwht_warp_kernel<V>, items, &max_blocks);
  fwht_warp_kernel<V><<<blocks, ndsc::kThreads, 0, stream>>>(
      x, y, rows, ndsc::log2_int(n), inv_sqrt_n);
  return static_cast<int>(cudaGetLastError());
}

__global__ void fwht_smem_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int64_t rows,
                                 int log2n, float inv_sqrt_n) {
  extern __shared__ float sm[];
  const int n = 1 << log2n;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int nrows = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);
  const int tile = nrows * n;
  const float* xb = x + r0 * n;
  float* yb = y + r0 * n;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) sm[e] = xb[e];
  ndsc::fwht_tile(sm, nrows, log2n, inv_sqrt_n);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) yb[e] = sm[e];
}

struct PassArgs {
  const float* in;         // may alias out (passes after the first)
  float* out;
  const float* signs_in;   // (n,): multiply at load, or null
  const float* row_mul;    // (rows,): multiply at load, or null
  const float* signs_out;  // (n,): multiply at store, or null
  const float* sub_from;   // (rows, n): store sub_from - y, or null
  unsigned* rowmax;        // (rows,): max |y| as bits, or null
  int64_t rows;
  int log2n, first_stage, n_stages, log2w;
  int has_rescale, last, round_bf16;
  float rescale, inv_sqrt_n;
};

// One pass: stages h = 2^first_stage .. 2^(first_stage + n_stages - 1) on
// a tile of 2^n_stages x W values per block. Tile element e sits at
// position col0 + (e >> log2w) * 2^first_stage + (e & (W - 1)) of its
// row; four consecutive e are four consecutive positions (W >= 4, or
// first_stage 0 and W 1), so the tile moves as float4s.
__global__ void fwht_pass_kernel(const PassArgs a) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int s = a.first_stage, k = a.n_stages, lw = a.log2w;
  const int w = 1 << lw;
  const int tile = 1 << (k + lw);
  const int tiles_log = a.log2n - k - lw;          // tiles per row, log2
  const int64_t t_id = static_cast<int64_t>(blockIdx.x);
  const int64_t row = t_id >> tiles_log;
  const int64_t in_row = t_id & ((int64_t(1) << tiles_log) - 1);
  const int cb_log = s - lw;                       // column blocks, log2
  const int64_t col0 = ((in_row >> cb_log) << (s + k)) +
                       ((in_row & ((int64_t(1) << cb_log) - 1)) << lw);
  const int64_t base = (row << a.log2n);
  float m = 1.0f;
  if (a.row_mul != nullptr) m = a.row_mul[row];

  for (int e = 4 * threadIdx.x; e < tile; e += 4 * blockDim.x) {
    const int64_t col = col0 + (static_cast<int64_t>(e >> lw) << s) +
                        (e & (w - 1));
    float4 v = *reinterpret_cast<const float4*>(a.in + base + col);
    if (a.signs_in != nullptr) {
      const float4 g = *reinterpret_cast<const float4*>(a.signs_in + col);
      v.x = __fmul_rn(v.x, g.x);
      v.y = __fmul_rn(v.y, g.y);
      v.z = __fmul_rn(v.z, g.z);
      v.w = __fmul_rn(v.w, g.w);
    }
    if (a.row_mul != nullptr) {
      v.x = __fmul_rn(v.x, m);
      v.y = __fmul_rn(v.y, m);
      v.z = __fmul_rn(v.z, m);
      v.w = __fmul_rn(v.w, m);
      if (a.has_rescale) {
        v.x = __fdiv_rn(v.x, a.rescale);
        v.y = __fdiv_rn(v.y, a.rescale);
        v.z = __fdiv_rn(v.z, a.rescale);
        v.w = __fdiv_rn(v.w, a.rescale);
      }
    }
    sm4[e >> 2] = v;
  }

  const int pairs = tile >> 1;
  for (int j = 0; j < k; ++j) {
    __syncthreads();
    const int h = w << j;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int q = p >> lw;
      const int t = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
      const int i = (t << lw) | (p & (w - 1));
      const float x0 = sm[i];
      const float x1 = sm[i + h];
      sm[i] = __fadd_rn(x0, x1);
      sm[i + h] = __fsub_rn(x0, x1);
    }
  }
  __syncthreads();

  unsigned mx = 0;
  for (int e = 4 * threadIdx.x; e < tile; e += 4 * blockDim.x) {
    const int64_t col = col0 + (static_cast<int64_t>(e >> lw) << s) +
                        (e & (w - 1));
    const float4 t4 = sm4[e >> 2];
    float y[4] = {t4.x, t4.y, t4.z, t4.w};
    if (a.last) {
      float g[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a.signs_out != nullptr) {
        const float4 t = *reinterpret_cast<const float4*>(a.signs_out + col);
        g[0] = t.x, g[1] = t.y, g[2] = t.z, g[3] = t.w;
      }
      if (a.sub_from != nullptr) {
        const float4 t =
            *reinterpret_cast<const float4*>(a.sub_from + base + col);
        u[0] = t.x, u[1] = t.y, u[2] = t.z, u[3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[i] = __fmul_rn(y[i], a.inv_sqrt_n);
        const unsigned b = __float_as_uint(fabsf(y[i]));
        mx = b > mx ? b : mx;
        if (a.signs_out != nullptr) y[i] = __fmul_rn(y[i], g[i]);
        if (a.round_bf16) y[i] = __bfloat162float(__float2bfloat16_rn(y[i]));
        if (a.sub_from != nullptr) y[i] = __fsub_rn(u[i], y[i]);
      }
    }
    *reinterpret_cast<float4*>(a.out + base + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
  if (a.rowmax != nullptr) {
    // every lane of the block reaches here; the block's tile is in one row
    mx = __reduce_max_sync(0xffffffffu, mx);
    if ((threadIdx.x & 31) == 0 && mx != 0) atomicMax(a.rowmax + row, mx);
  }
}

}  // namespace

// x, y: (rows, n) float32, contiguous, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int ndsc_fwht(const float* x, float* y, int64_t rows, int n,
                         float inv_sqrt_n, cudaStream_t stream) {
  if (!ndsc::is_pow2(n) || n > ndsc::kMaxN) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (n >= 4 && n <= ndsc::kWarpMaxN) {
    switch (ndsc::warp_values(n)) {
      case 4: return launch_warp<4>(x, y, rows, n, inv_sqrt_n, stream);
      case 8: return launch_warp<8>(x, y, rows, n, inv_sqrt_n, stream);
      case 16: return launch_warp<16>(x, y, rows, n, inv_sqrt_n, stream);
      case 32: return launch_warp<32>(x, y, rows, n, inv_sqrt_n, stream);
    }
  }
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * n * sizeof(float);
  fwht_smem_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, smem,
                     stream>>>(x, y, rows, ndsc::log2_int(n), inv_sqrt_n);
  return static_cast<int>(cudaGetLastError());
}

// The largest tile of a pass: 2^15 floats, 128 KB of dynamic shared
// memory (beyond the 48 KB a launch gets without opting in).
constexpr int kMaxPassTile = 1 << 15;

// One pass of the FWHT above N = 8192 (see the header and
// repro_torch.kernels.fwht.fwht_plan): stages [first_stage, first_stage +
// n_stages) on tiles of 2^n_stages x 2^log2w values. in, out, signs_in,
// signs_out and sub_from are 16-byte aligned; in may equal out. The loads
// multiply by signs_in and then by row_mul (and divide by rescale where
// has_rescale); with `last` the stores multiply by inv_sqrt_n, take the
// row maximum of |y| into rowmax (zeroed here first), multiply by
// signs_out, round through bf16 where round_bf16, and store sub_from - y.
// Returns cudaGetLastError().
extern "C" int ndsc_fwht_pass(const float* in, float* out,
                              const float* signs_in, const float* row_mul,
                              int has_rescale, float rescale,
                              const float* signs_out, const float* sub_from,
                              unsigned* rowmax, int round_bf16, int64_t rows,
                              int log2n, int first_stage, int n_stages,
                              int log2w, int last, float inv_sqrt_n,
                              cudaStream_t stream) {
  const int tile_log = n_stages + log2w;
  if (log2n < 2 || n_stages < 0 || first_stage < 0 || log2w < 0 ||
      first_stage + n_stages > log2n || log2w > first_stage ||
      tile_log > log2n || (1 << tile_log) < 4 ||
      (1 << tile_log) > kMaxPassTile || (log2w < 2 && first_stage != 0))
    return cudaErrorInvalidValue;
  if (!last && (signs_out || sub_from || rowmax || round_bf16))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int64_t blocks = rows << (log2n - tile_log);
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (rowmax != nullptr) {
    const cudaError_t rc =
        cudaMemsetAsync(rowmax, 0, rows * sizeof(unsigned), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int tile = 1 << tile_log;
  const int smem = tile * static_cast<int>(sizeof(float));
  static ndsc::LaunchCache cache;
  const cudaError_t rc = ndsc::opt_in_smem(fwht_pass_kernel, smem, &cache);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int threads = tile / 32;
  threads = threads < 32 ? 32 : threads > 1024 ? 1024 : threads;
  const PassArgs a{in, out, signs_in, row_mul, signs_out, sub_from, rowmax,
                   rows, log2n, first_stage, n_stages, log2w, has_rescale,
                   last, round_bf16, rescale, inv_sqrt_n};
  fwht_pass_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
