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
// Three routes (repro_torch.kernels.fwht.fwht_path), one launch per call
// up to N = 2^15.
// "single", N <= 8192 (ndsc_fwht). For 4 <= N <= ndsc::kWarpMaxN
// (warp_rows.cuh): one warp owns a row (or 128/N rows below N = 128) with
// V = max(4, N/32) consecutive values per lane in registers, loaded and
// stored as float4s; butterfly stages h < V run in registers and h >= V
// across lanes with __shfl_xor_sync, so there is no shared memory and no
// block barrier. Each warp strides over items and loads its next item
// before transforming the current one. The cap, N 1024 (V = 32, 100
// registers here), is where the encoder's registers run out
// (warp_rows.cuh). Above it (and for N < 4) up to N = 8192 a block loads
// max(1, 2048/N) rows into shared memory and runs the stages there between
// __syncthreads.
// "row", N = 2^14 and 2^15, and "passes" from 2^16 (ndsc_fwht_pass, one
// launch per pass of repro_torch.kernels.fwht.fwht_plan): the stages are
// split into passes in increasing h; every stage maps each pair to
// (a + b, a - b) on its own, so any split that keeps the order gives
// ref.fwht's bits. Every pass keeps its values in registers and crosses
// shared memory only to change layout:
//   fwht_row_kernel, the first pass (stages 0..L-1, L = 14 or 15, on
//   contiguous segments of 2^L; the whole transform at N = 2^L): the
//   encoder's row schedule (row_fwht.cuh), persistent blocks striding over
//   segments, T = 2^L/32 threads with 32 values each, the next segment's
//   first half in flight by a TMA bulk copy while the current one runs,
//   the store straight from layout B (each warp store 128 contiguous B).
//   Shared memory 96 KB (2^14, two blocks an SM) or 192 KB (2^15, one).
//   fwht_cols_kernel<K>, a later pass (stages s..s+K-1, s >= 14, K <= 8):
//   tiles of 2^13 values, 2^K strided rows 2^s apart by W = 2^(13-K)
//   contiguous columns, 256 threads with 32 values each. Layout L1 holds
//   min(K, 5) of the tile's row bits in registers (a thread's values lie
//   in one column, 2^s apart; below K = 5 also column bits 5..), the
//   lane is column bits 0-4; for K > 5 one exchange through shared memory
//   into layout L2 brings row bits 5..K-1 into registers. Both layouts
//   give each warp 32 consecutive floats per register, so loads, stores
//   and the exchange are 128 B a warp and free of bank conflicts.
//   Persistent blocks, three an SM (80 registers a thread, 32 KB of
//   shared memory for the exchange), load a tile's 32 values a thread at
//   once, so 3 x 32 KB are in flight an SM while the other blocks
//   compute. Staging the next tile by TMA bulk copies instead (one per
//   contiguous run of W floats) was no faster at 2^26 and 2^28, and its
//   pass at 2^23 (K = 8: 128-byte runs) took 1.8 times as long
//   (tools/fwht_variants.py, stage_tma; PERF.md). The tile loop takes s
//   through an opaque copy, so the 32 offsets m * 2^s of a layout are not
//   hoisted into 32 live registers (they spilled at 80 without it).
//   Tiles are disjoint, so the passes after the first run in place.
// Only the last pass multiplies by f32(1/sqrt(N)). The decode and the
// encoders from N = 2^16 (quantencode.py) fold their per-value steps into
// the first pass's loads (signs; row mask, rescale) and the last pass's
// stores (signs, bf16 rounding, the EF subtract, the row maximum by
// atomicMax on the bits of |x|). Element offsets are int64.
#include <cuda_bf16.h>

#include "ndsc_common.cuh"
#include "row_fwht.cuh"
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
  const float* in;         // may alias out
  float* out;
  const float* signs_in;   // (n,): multiply at load, or null (first pass)
  const float* row_mul;    // (rows,): multiply at load, or null (first)
  const float* signs_out;  // (n,): multiply at store, or null (last pass)
  const float* sub_from;   // (rows, n): store sub_from - y, or null (last)
  unsigned* rowmax;        // (rows,): max |y| as bits, or null (last)
  int64_t rows;
  int log2n, first_stage, n_stages;
  int has_rescale, last, round_bf16;
  float rescale, inv_sqrt_n;
};

// The last pass's value y at position pos of the row at row_base: times
// f32(1/sqrt(N)), its |y| into mx, times signs_out[pos], rounded through
// bf16, subtracted from sub_from, as the arguments ask.
__device__ inline float finish(const PassArgs& a, float y, int64_t row_base,
                               int pos, unsigned& mx) {
  y = __fmul_rn(y, a.inv_sqrt_n);
  const unsigned b = __float_as_uint(fabsf(y));
  mx = b > mx ? b : mx;
  if (a.signs_out != nullptr) y = __fmul_rn(y, a.signs_out[pos]);
  if (a.round_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
  if (a.sub_from != nullptr) y = __fsub_rn(a.sub_from[row_base + pos], y);
  return y;
}

// Every lane of the warp reaches here; its values lie in one row.
__device__ inline void row_max_out(const PassArgs& a, int64_t row,
                                   unsigned mx) {
  if (a.rowmax == nullptr) return;
  mx = __reduce_max_sync(ndsc::kFullMask, mx);
  if ((threadIdx.x & 31) == 0 && mx != 0) atomicMax(a.rowmax + row, mx);
}

// The first pass: stages 0..LOG2N-1 on each contiguous segment of 2^LOG2N
// values (the whole row at N = 2^LOG2N).
template <int LOG2N>
__global__ void __launch_bounds__(ndsc::RowShape<LOG2N>::T,
                                  ndsc::RowShape<LOG2N>::BLOCKS)
    fwht_row_kernel(const PassArgs a) {
  using S = ndsc::RowShape<LOG2N>;
  constexpr int T = S::T;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);   // N floats: the exchange
  float* stage = buf + S::N;                      // S::STAGE floats
  __shared__ uint64_t bar;                        // the staged half segment

  const int tid = threadIdx.x, lane = tid & 31;
  const int a0 = 4 * lane + 1024 * (tid >> 5);    // group 0's position in A
  const bool staged = a0 < S::STAGE;              // uniform over the warp
  const int seg_log = a.log2n - LOG2N;            // segments a row, log2
  const int64_t segs = a.rows << seg_log;
  int64_t seg = blockIdx.x;
  if (tid == 0) {
    ndsc::mbar_init(&bar);
    if (seg < segs)
      ndsc::bulk_load(stage, a.in + (seg << LOG2N), S::STAGE * 4, &bar);
  }
  __syncthreads();
  uint32_t parity = 0;
  for (; seg < segs; seg += gridDim.x) {
    const int64_t row = seg >> seg_log;
    const int64_t row_base = row << a.log2n;
    // the segment's first position in its row
    const int col = static_cast<int>(seg - (row << seg_log)) << LOG2N;
    float v[ndsc::kRowV];
    if (staged) {
      ndsc::mbar_wait(&bar, parity);
      ndsc::load_a(v, stage + a0);
    } else {
      ndsc::load_a(v, a.in + row_base + col + a0);
    }
    parity ^= 1u;
    if (a.signs_in != nullptr) ndsc::mul_a(v, a.signs_in + col + a0);
    if (a.row_mul != nullptr) {
      ndsc::scale_values(v, a.row_mul[row]);
      if (a.has_rescale) {
#pragma unroll
        for (int i = 0; i < ndsc::kRowV; ++i)
          v[i] = __fdiv_rn(v[i], a.rescale);
      }
    }
    // every staged value is in registers, and every thread has left the
    // previous segment's reads of buf
    __syncthreads();
    if (tid == 0 && seg + gridDim.x < segs)
      ndsc::bulk_load(stage, a.in + ((seg + gridDim.x) << LOG2N),
                      S::STAGE * 4, &bar);

    ndsc::fwht_low(v, lane);
    ndsc::to_b<T>(v, buf, a0);
    ndsc::fwht_high<LOG2N>(v);
    float* o = a.out + row_base + col + tid;
    if (!a.last) {
#pragma unroll
      for (int r = 0; r < ndsc::kRowV; ++r) o[T * r] = v[r];
      continue;
    }
    unsigned mx = 0;
#pragma unroll
    for (int r = 0; r < ndsc::kRowV; ++r)
      o[T * r] = finish(a, v[r], row_base, col + tid + T * r, mx);
    row_max_out(a, row, mx);
    // the next segment writes buf only after its first __syncthreads
  }
}

// A later pass's tile: 2^13 values, 256 threads with 32 values each.
constexpr int kColsTileLog = 13;
constexpr int kColsTile = 1 << kColsTileLog;
constexpr int kColsThreads = kColsTile / ndsc::kRowV;
constexpr int kColsMaxStages = 8;        // W = 2^(13 - K) >= 32 floats
constexpr int kColsBlocks = 3;           // per SM: 80 registers a thread

// A later pass: stages s..s+K-1 (s = first_stage) on tiles of 2^K rows,
// 2^s apart, by W = 2^(13-K) contiguous columns. Tile element e is row
// e >> (13-K), column e & (W-1); it sits at position
// col0 + (e >> (13-K)) * 2^s + (e & (W-1)) of its row.
template <int K>
__global__ void __launch_bounds__(kColsThreads, kColsBlocks)
    fwht_cols_kernel(const PassArgs a) {
  constexpr int LW = kColsTileLog - K;            // log2 W
  constexpr int W = 1 << LW;
  constexpr int KR = K < 5 ? K : 5;               // row bits in L1 registers
  __shared__ float xbuf[K > 5 ? kColsTile : 1];   // the exchange (K > 5)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_log = a.log2n - kColsTileLog;   // tiles a row, log2
  const int cb_log = a.first_stage - LW;          // column blocks, log2
  const int64_t tiles = a.rows << tiles_log;
  // L1: register i holds element e1 + ((i & (2^KR - 1)) << LW) +
  // ((i >> KR) << 5): the lane is column bits 0-4; for K >= 5 the warp is
  // column bits 5..12-K and row bits 5..K-1, for K < 5 column bits
  // 10-K..12-K (registers carry column bits 5..9-K)
  int e1;
  if constexpr (K >= 5)
    e1 = lane | ((warp & ((1 << (8 - K)) - 1)) << 5) |
         ((warp >> (8 - K)) << (LW + 5));
  else
    e1 = lane | (warp << (10 - K));

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    // s through an opaque copy: the 32 offsets (m << s) of a layout are
    // then formed where they are used, not hoisted out of the loop into
    // 32 live registers
    int s;
    asm volatile("mov.b32 %0, %1;" : "=r"(s) : "r"(a.first_stage));
    const int64_t row = t >> tiles_log;
    const int64_t row_base = row << a.log2n;
    const int ti = static_cast<int>(t - (row << tiles_log));
    const int col0 = ((ti >> cb_log) << (s + K)) +
                     ((ti & ((1 << cb_log) - 1)) << LW);
    // the loads: all 32 in flight at once, each warp's 128 contiguous B
    const float* in = a.in + row_base + col0 + ((e1 >> LW) << s) +
                      (e1 & (W - 1));
    float v[ndsc::kRowV];
#pragma unroll
    for (int i = 0; i < ndsc::kRowV; ++i)
      v[i] = in[((i & ((1 << KR) - 1)) << s) + ((i >> KR) << 5)];
    ndsc::register_stages<1, (1 << KR)>(v);
    int e = e1;
    if constexpr (K > 5) {
      // L2: register i holds element e + ((i >> (K-5)) << LW) +
      // ((i & (2^(K-5) - 1)) << (LW + 5)): registers are row bits 5..K-1
      // (low) and 0..9-K (high), the warp column bits 5..12-K and row bits
      // 10-K..4
      e = lane | ((warp & ((1 << (8 - K)) - 1)) << 5) |
          ((warp >> (8 - K)) << (LW + 10 - K));
      __syncthreads();               // every thread has read the last xbuf
#pragma unroll
      for (int i = 0; i < ndsc::kRowV; ++i) xbuf[e1 + (i << LW)] = v[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ndsc::kRowV; ++i)
        v[i] = xbuf[e + ((i >> (K - 5)) << LW) +
                    ((i & ((1 << (K - 5)) - 1)) << (LW + 5))];
      ndsc::register_stages<1, (1 << (K - 5))>(v);
    }
    // register i holds position p0 + off(i) of the row: element e +
    // (m << LW) + c sits at col0 + ((e >> LW) + m) * 2^s + (e & (W-1)) + c
    const int p0 = col0 + ((e >> LW) << s) + (e & (W - 1));
    float* o = a.out + row_base;
    auto off = [&](int i) {
      if constexpr (K > 5)
        return ((i >> (K - 5)) + ((i & ((1 << (K - 5)) - 1)) << 5)) << s;
      else
        return ((i & ((1 << KR) - 1)) << s) + ((i >> KR) << 5);
    };
    if (!a.last) {
#pragma unroll
      for (int i = 0; i < ndsc::kRowV; ++i) o[p0 + off(i)] = v[i];
      continue;
    }
    unsigned mx = 0;
#pragma unroll
    for (int i = 0; i < ndsc::kRowV; ++i) {
      const int p = p0 + off(i);
      o[p] = finish(a, v[i], row_base, p, mx);
    }
    row_max_out(a, row, mx);
  }
}

template <int LOG2N>
int launch_row(const PassArgs& a, cudaStream_t stream) {
  using S = ndsc::RowShape<LOG2N>;
  static ndsc::LaunchCache cache;
  int fit = 0;
  const cudaError_t rc = ndsc::persistent_blocks(
      fwht_row_kernel<LOG2N>, S::T, S::SMEM, &cache, &fit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t segs = a.rows << (a.log2n - LOG2N);
  const unsigned blocks = static_cast<unsigned>(segs < fit ? segs : fit);
  fwht_row_kernel<LOG2N><<<blocks, S::T, S::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_cols(const PassArgs& a, cudaStream_t stream) {
  static ndsc::LaunchCache cache;
  int fit = 0;
  const cudaError_t rc = ndsc::persistent_blocks(
      fwht_cols_kernel<K>, kColsThreads, 0, &cache, &fit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t tiles = a.rows << (a.log2n - kColsTileLog);
  const unsigned blocks = static_cast<unsigned>(tiles < fit ? tiles : fit);
  fwht_cols_kernel<K><<<blocks, kColsThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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


// One pass of the FWHT above N = 8192 (see the header and
// repro_torch.kernels.fwht.fwht_plan): stages [first_stage, first_stage +
// n_stages). The first pass (first_stage 0, n_stages 14 or 15, log2w 0)
// runs fwht_row_kernel; a later one (1 <= n_stages <= 8, log2w =
// 13 - n_stages <= first_stage) fwht_cols_kernel. in, out, signs_in,
// signs_out and sub_from are 16-byte aligned; in may equal out. The first
// pass's loads multiply by signs_in and then by row_mul (and divide by
// rescale where has_rescale); the last pass (which ends at stage log2n - 1)
// multiplies by inv_sqrt_n, takes the row maximum of |y| into rowmax
// (zeroed here first), multiplies by signs_out, rounds through bf16 where
// round_bf16, and stores sub_from - y. Returns cudaGetLastError().
extern "C" int ndsc_fwht_pass(const float* in, float* out,
                              const float* signs_in, const float* row_mul,
                              int has_rescale, float rescale,
                              const float* signs_out, const float* sub_from,
                              unsigned* rowmax, int round_bf16, int64_t rows,
                              int log2n, int first_stage, int n_stages,
                              int log2w, int last, float inv_sqrt_n,
                              cudaStream_t stream) {
  const bool head = first_stage == 0;
  if (log2n < 14 || log2n > 30 || n_stages < 1 ||
      first_stage + n_stages > log2n || (last && !(first_stage + n_stages ==
                                                   log2n)))
    return cudaErrorInvalidValue;
  if (head ? (n_stages != 14 && n_stages != 15) || log2w != 0
           : n_stages > kColsMaxStages ||
                 log2w != kColsTileLog - n_stages || log2w > first_stage ||
                 signs_in || row_mul || has_rescale)
    return cudaErrorInvalidValue;
  if (!last && (signs_out || sub_from || rowmax || round_bf16))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (rowmax != nullptr) {
    const cudaError_t rc =
        cudaMemsetAsync(rowmax, 0, rows * sizeof(unsigned), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const PassArgs a{in, out, signs_in, row_mul, signs_out, sub_from, rowmax,
                   rows, log2n, first_stage, n_stages, has_rescale, last,
                   round_bf16, rescale, inv_sqrt_n};
  switch (head ? n_stages + 100 : n_stages) {
    case 114: return launch_row<14>(a, stream);
    case 115: return launch_row<15>(a, stream);
    case 1: return launch_cols<1>(a, stream);
    case 2: return launch_cols<2>(a, stream);
    case 3: return launch_cols<3>(a, stream);
    case 4: return launch_cols<4>(a, stream);
    case 5: return launch_cols<5>(a, stream);
    case 6: return launch_cols<6>(a, stream);
    case 7: return launch_cols<7>(a, stream);
    default: return launch_cols<8>(a, stream);
  }
}
