// Normalized fast Walsh-Hadamard transform along the last axis.
//
// Replaces: src/repro/kernels/fwht.py, fwht_pallas (pl.pallas_call body
// _fwht_kernel). Called through repro_torch.kernels.ops.fwht / unrotate in
// every NDSC decode.
//
// Bound on an H100: bytes. Each value is read once and written once
// (8 B per coordinate) against log2(N) adds per coordinate, far below the
// card's ratio of operations to bytes.
// Design: a block loads max(1, 2048/N) whole rows into shared memory
// (coalesced), runs the log2(N) butterfly stages there with
// __syncthreads between stages, and writes the rows back once, so the
// intermediate stages never touch device memory. N <= 8192 (one 32 KB row);
// larger N is refused by the Python wrapper.
#include "ndsc_common.cuh"

namespace {

__global__ void fwht_kernel(const float* __restrict__ x,
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

// x, y: (rows, n) float32, contiguous. Returns cudaGetLastError().
extern "C" int ndsc_fwht(const float* x, float* y, int64_t rows, int n,
                         float inv_sqrt_n, cudaStream_t stream) {
  if (!ndsc::is_pow2(n) || n > ndsc::kMaxN) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int rpb = ndsc::rows_per_block(n);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * n * sizeof(float);
  fwht_kernel<<<static_cast<unsigned>(blocks), ndsc::kThreads, smem,
                stream>>>(x, y, rows, ndsc::log2_int(n), inv_sqrt_n);
  return static_cast<int>(cudaGetLastError());
}
