// Normalized fast Walsh-Hadamard transform along the last axis.
//
// Replaces: src/repro/kernels/fwht.py, fwht_pallas (pl.pallas_call body
// _fwht_kernel). Called through repro_torch.kernels.ops.fwht / unrotate in
// every NDSC decode and in the serve path's K/V and query rotation.
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
// (warp_rows.cuh). Above it (and for N < 4) a block loads max(1, 2048/N)
// rows into shared memory and runs the stages there between
// __syncthreads. N <= 8192 (one 32 KB row); larger N is refused by the
// Python wrapper.
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
