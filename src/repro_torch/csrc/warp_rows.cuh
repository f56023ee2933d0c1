// Warp-resident rows: the layout, the FWHT and the row maximum shared by
// fwht.cu and quantencode.cu for rows of n <= kWarpMaxN.
//
// Layout. A warp owns one item of 32 * V floats at a time: lane l holds the
// V consecutive values [V*l, V*l + V) in registers, with V = n / 32 for
// n >= 128 (one row per item) and V = 4 below (128 / n rows per item, n / 4
// lanes per row), so every lane moves its values as V/4 16-byte float4s.
// Position bits below log2 V are the register index; the bits above are
// the lane's index within its row.
//
// The FWHT keeps ref.fwht's radix-2 order (pair i with i + h for h = 1, 2,
// 4, ..., n/2, each pair becoming (a + b, a - b), then one multiply by
// f32(1/sqrt(n))). The order within a stage changes no bit, so stages with
// h < V run in registers and stages with h >= V run across lanes with one
// __shfl_xor_sync per register: no shared memory and no block barrier.
#pragma once

#include "ndsc_common.cuh"

namespace ndsc {

constexpr unsigned kFullMask = 0xffffffffu;
// The largest n on the warp-resident path. At V = 32 (n 1024) ptxas
// (CUDA 12.8, sm_90a) compiles the heaviest kernel, encode_warp_kernel, in
// 226 registers without spilling; V = 64 would keep ~5 * 64 floats live,
// past the 255-register limit (chip_smoke.py phase 1 prints registers and
// spills per kernel). Above it the shared-memory kernels run. The smem
// encoder's row maximum takes one atomic per warp, which needs its rows to
// fill whole passes of a kThreads block.
constexpr int kWarpMaxN = 1024;
static_assert(kWarpMaxN >= kThreads, "smem kernels need n >= kThreads");
constexpr int kWarpsPerBlock = kThreads / 32;

// Values per lane for rows of n (n >= 4).
__host__ __device__ inline int warp_values(int n) {
  return n < 128 ? 4 : n / 32;
}

// Where this lane's values sit: rows_per_item rows of n per warp item, the
// lane's row within the item (sub) and its first column (col).
struct WarpRows {
  int n, lanes_per_row, rows_per_item, sub, col;
  int64_t items, first, stride;

  template <int V>
  __device__ static WarpRows make(int64_t rows, int log2n) {
    WarpRows g;
    const int lane = threadIdx.x & 31;
    g.n = 1 << log2n;
    g.lanes_per_row = g.n / V;
    g.rows_per_item = 32 / g.lanes_per_row;
    g.sub = lane / g.lanes_per_row;
    g.col = (lane & (g.lanes_per_row - 1)) * V;
    g.items = (rows + g.rows_per_item - 1) / g.rows_per_item;
    g.first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
              threadIdx.x / 32;
    g.stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
    return g;
  }
  // this lane's row in `item`
  __device__ int64_t row(int64_t item) const {
    return item * rows_per_item + sub;
  }
};

template <int V>
__device__ inline void load_values(const float* __restrict__ p,
                                   float (&v)[V]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 t = q[i];
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

template <int V>
__device__ inline void store_values(float* __restrict__ p,
                                    const float (&v)[V]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// The lane's values of `row`, or zeros where the row is past the end.
template <int V>
__device__ inline void load_row(const float* __restrict__ base, int64_t row,
                                int64_t rows, const WarpRows& g,
                                float (&v)[V]) {
  if (row < rows) {
    load_values<V>(base + row * g.n + g.col, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
  }
}

// In place, normalized FWHT of the rows the warp holds (n >= V). All 32
// lanes must call it.
template <int V>
__device__ inline void warp_fwht(float (&v)[V], int n, float inv_sqrt_n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 1; h < V; h <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if ((i & h) == 0) {
        const float a = v[i];
        const float b = v[i + h];
        v[i] = __fadd_rn(a, b);
        v[i + h] = __fsub_rn(a, b);
      }
    }
  }
  for (int h = V; h < n; h <<= 1) {
    // the partner holds position ^ h. The lower lane (a) keeps
    // b + a = a + b, the upper (b) keeps a + (-b), which IEEE 754 defines
    // as a - b: the same bits as ref.fwht's pair
    const int o = h / V;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float p = __shfl_xor_sync(kFullMask, v[i], o);
      v[i] = __fadd_rn(p, upper ? -v[i] : v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = __fmul_rn(v[i], inv_sqrt_n);
}

// max |v| over the lane's row, every lane of the row gets it. The integer
// maximum of the bit patterns of |v| (sign bit clear) is the float maximum.
// All 32 lanes must call it.
template <int V>
__device__ inline float row_absmax(const float (&v)[V], int lanes_per_row) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned b = __float_as_uint(fabsf(v[i]));
    m = b > m ? b : m;
  }
  if (lanes_per_row == 32) {
    m = __reduce_max_sync(kFullMask, m);            // redux.sync
  } else {
    for (int o = 1; o < lanes_per_row; o <<= 1) {
      const unsigned b = __shfl_xor_sync(kFullMask, m, o);
      m = b > m ? b : m;
    }
  }
  return __uint_as_float(m);
}

// Blocks of kThreads for `items` warp items: one item per warp, at most as
// many blocks as fit on the card at once (the kernels stride over the
// rest). The fit is read once per kernel on the first call's device.
template <typename Kernel>
inline unsigned warp_grid(Kernel kernel, int64_t items, int* max_blocks) {
  if (*max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    *max_blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int64_t want = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned>(want < *max_blocks ? want : *max_blocks);
}

}  // namespace ndsc
