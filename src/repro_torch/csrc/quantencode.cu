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
//
// Four routes, chosen by n (repro_torch/kernels/quantencode.py,
// encode_path); the first three are one launch per call.
//
// "fused", 32 <= n <= ndsc::kWarpMaxN (warp_rows.cuh): a warp owns a row
// (or 128/n rows below n = 128) with V = max(4, n/32) consecutive values per
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
// whose kernels compile without spilling (226 registers at V = 32).
// "fused" above it, up to n = ndsc::kMaxN = 8192: a block holds
// max(1, 2048/n) rows in shared memory (8 KB; 32 KB at 8192), runs
// ndsc::fwht_tile there, takes the row maximum with one shared atomicMax
// per warp after a redux.sync, and packs whole words per thread with
// ndsc::quantize_pack_word (which quantpack.cu's row kernel shares).
//
// "row", n = 2^14 and 2^15 (kRowMinN..kRowMaxN): encode_row_kernel,
// persistent blocks (two per SM at 2^14, one at 2^15) striding over rows,
// T = n/32 threads (512 or 1024) with V = 32 values each in registers.
// The layouts, the FWHT's schedule and the TMA helpers are row_fwht.cuh's,
// shared with fwht.cu's row kernel. Shared memory serves only the
// exchanges between two layouts of the row and the loads:
//   A (loads, pack): thread (warp w, lane l) holds the float4 groups
//     j = 0..7 at positions 4l + 128j + 1024w; register 4j + c is position
//     4l + 128j + 1024w + c. Position bits 0-1 and 7-9 are register bits,
//     bits 2-6 the lane, bits 10.. the warp.
//   B (top stages, row maximum, residual): thread t holds positions
//     t + T*r, r = 0..31: bits 0..log2(T)-1 are the thread, the rest
//     register bits.
// The FWHT runs bits 0-1 in registers, 2-6 across the warp (one
// __shfl_xor_sync and one fma by +-1 per value: p + v*(+-1) rounds once,
// as the pair's a + b or a - b), 7-9 in registers; one exchange (float4
// stores in A, scalar loads in B, both free of bank conflicts) brings bits
// 10..log2(n)-1 into registers; then the single multiply by f32(1/sqrt n).
// The row maximum is redux.sync on the bits of |x| and one shared
// atomicMax per warp. A second exchange takes x back to layout A, where the
// dither is added, each thread quantizes its 8 groups and packs them: a
// word of k = 32/R codes spans k/4 lanes (1, 2, 4 or 8), an OR-shuffle
// tree combines their disjoint fields and the first lane stores it. The
// EF inverse decodes each lane's codes from the masked word and runs the
// same schedule (A, exchange, B); the residual u - y is formed in layout B.
// u is not kept: a thread has 64 registers, too few to hold u's 32 values
// beside the 32 being transformed. Once the inverse's exchange has been
// read, one TMA bulk copy loads the row's u again into the exchange buffer
// (from L2 where it still is) while the top stages run.
// Loads overlap work: the first half of a block's next row is in flight
// into a staging buffer by a TMA bulk copy (cp.async.bulk with an
// mbarrier) while the current row runs; the warps of the second half read
// theirs into registers directly.
// Shared memory: the exchange buffer (n floats) plus the staging buffer
// (n/2 floats): 96 KB a block at 2^14 (two blocks an SM), 192 KB at 2^15,
// after the opt-in of ndsc::opt_in_smem (once per device). Registers:
// __launch_bounds__ holds both at 64 a thread (65,536 an SM), without
// spills (chip_smoke.py phase 1 prints the counts and spills). What holds
// the kernel back (PERF.md): at 2^15 the single block of 1024 threads an
// SM, whose block-wide barriers (seven a row with the residual, four
// without) stall the whole SM; the shuffle stages and the quantizer's
// division cost issue slots at both n.
// "cluster", n = 2^16 .. kClusterMaxN = 2^17: encode_cluster_kernel, one
// launch. A row of n = C * 2^14 belongs to one thread-block cluster of C
// CTAs (4 or 8: within the portable cluster size of 8; 2^18 would need 16,
// non-portable, of which 14 fit on an H100 against 30 of 8, chip_smoke.py
// phase 1). CTA r loads segment r (positions r*2^14 .. (r+1)*2^14 - 1)
// and runs the row kernel's schedule at 2^14 on it: 512 threads, 32
// values each, 96 KB of shared memory, two CTAs an SM, 64 registers (a
// few spilled: phase 1 prints them). That leaves the top log2(C) stages,
// whose pairs lie in C different CTAs: in layout B a thread's register q
// holds in-segment position t + T*q in every CTA. One exchange through
// distributed shared memory transposes the row: every CTA stores its 32
// values to its exchange buffer, barrier.cluster, and CTA r reads piece r
// (in-segment positions r*P .. (r+1)*P - 1, P = 2^14 / C) of every
// segment with mapa / ld.shared::cluster, each warp 128 consecutive bytes
// (layout X: register s*I + i holds segment s's position r*P + t + T*i,
// I = 32 / C). The stages over the segments then pair registers I apart,
// in increasing order, a + b and a - b as ref.fwht; then the one multiply
// by f32(1/sqrt(n)), n the row's. Each CTA moves (C-1)/C of its segment
// through DSMEM, once, where one exchange a stage with the partner CTA
// (the "pairwise" design of tools/encode_cluster_variants.py) moves
// log2(C) whole segments and synchronizes the cluster twice a stage
// (encode_ef 8.6 against 6.6 ms at 2^16, 11.2 against 7.3 at 2^17, on an
// H100 80GB HBM3 at 700 W, PERF.md). The row maximum is redux.sync
// plus a shared atomicMax per CTA; after a cluster barrier lane r of each
// warp reads CTA r's value through DSMEM and the warp takes their maximum
// (exact, in any order); CTA rank 0 writes the scale. The exchange of
// the row kernel (to_a) takes layout X to layout A over the CTA's C
// pieces, where the dither is added and each CTA quantizes, packs and
// masks its pieces into whole words of their own (a piece holds whole
// words). The EF inverse starts, after a cluster barrier, from its own
// segment's words read back from L2 (ld.global.cg; the cluster wrote them
// before the barrier), decodes them and runs the same stages (the row
// schedule, the transposing exchange, the stages over the segments, the
// multiply); the residual is formed in layout X, u brought into the
// exchange buffer by C bulk copies (one a piece) once a cluster barrier
// shows that the partners have read it. Cluster barriers a row: two, five
// with the residual. Persistent clusters walk the rows by %clusterid
// (every CTA of a cluster the same rows, so none leaves a partner waiting
// at a barrier, and a last barrier before any CTA exits), the next row's
// first half of the segment staged by TMA as in the row kernel; the grid is
// the clusters that cudaOccupancyMaxActiveClusters fits, launched by
// cudaLaunchKernelEx with the cluster dimension (capturable in a CUDA
// graph). What holds it back (PERF.md): the residual's second pass of
// barriers and exchanges, where the row kernel has none.
// n > kClusterMaxN does not come here: repro_torch/kernels/quantencode.py
// runs it as passes, fwht.cu's ndsc_fwht_pass (its register-resident row
// and column kernels) with the sign flip and the row maximum folded in,
// then quantpack.cu's flat quantize kernel with the dither and the mask
// (and for the residual its flat unpack kernel and the passes again).
#include <cuda_bf16.h>

#include "ndsc_common.cuh"
#include "row_fwht.cuh"
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

// ---- the "row" route: n = 2^14 and 2^15, one block per row ------------------

constexpr int kRowMinN = 1 << 14;
constexpr int kRowMaxN = 1 << 15;
using ndsc::bulk_load;
using ndsc::fwht_high;
using ndsc::fwht_low;
using ndsc::kRowV;
using ndsc::load_a;
using ndsc::bulk_copy;
using ndsc::mbar_expect;
using ndsc::mbar_init;
using ndsc::mbar_wait;
using ndsc::mul_a;
using ndsc::RowShape;
using ndsc::to_a;
using ndsc::to_b;

template <int LOG2N, int BITS>
__global__ void __launch_bounds__(RowShape<LOG2N>::T,
                                  RowShape<LOG2N>::BLOCKS)
    encode_row_kernel(const EncodeArgs a) {
  using S = RowShape<LOG2N>;
  constexpr int N = S::N, T = S::T;
  constexpr int K = 32 / BITS;               // codes per word
  constexpr int G = K / 4;                   // lanes a word spans
  constexpr int WPR = N / K;                 // words per row
  constexpr unsigned kCodeMask = (1u << BITS) - 1u;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);   // N floats: the exchange
  float* stage = buf + N;                         // S::STAGE floats
  __shared__ uint64_t bar;                        // the staged half row
  __shared__ uint64_t bar_u;                      // u again, into buf
  __shared__ unsigned row_max;

  const int tid = threadIdx.x, lane = tid & 31;
  const int a0 = 4 * lane + 1024 * (tid >> 5);    // group 0's position in A
  const bool staged = a0 < S::STAGE;              // uniform over the warp
  // bit offset of the lane's first code in its word
  const int shift0 = (4 * lane) % K * BITS;
  const float inv_levels = ndsc::inv_levels(BITS);

  int64_t row = blockIdx.x;
  if (tid == 0) {
    mbar_init(&bar);
    mbar_init(&bar_u);
    row_max = 0;
    if (row < a.rows) bulk_load(stage, a.x + row * N, S::STAGE * 4, &bar);
  }
  __syncthreads();
  uint32_t parity = 0, parity_u = 0;
  for (; row < a.rows; row += gridDim.x) {
    const float* xr = a.x + row * N;
    float v[kRowV];
    if (staged) {
      mbar_wait(&bar, parity);
      load_a(v, stage + a0);
    } else {
      load_a(v, xr + a0);
    }
    parity ^= 1u;
    mul_a(v, a.signs + a0);
    // every staged value is in registers, and every thread has left the
    // previous row's reads of buf
    __syncthreads();
    if (tid == 0 && row + gridDim.x < a.rows)
      bulk_load(stage, a.x + (row + gridDim.x) * N, S::STAGE * 4, &bar);

    fwht_low(v, lane);
    to_b<T>(v, buf, a0);
    fwht_high<LOG2N>(v);
    ndsc::scale_values(v, a.inv_sqrt_n);
    unsigned m = 0;
#pragma unroll
    for (int r = 0; r < kRowV; ++r) {
      const unsigned b = __float_as_uint(fabsf(v[r]));
      m = b > m ? b : m;
    }
    m = __reduce_max_sync(ndsc::kFullMask, m);
    if (lane == 0) atomicMax(&row_max, m);
    __syncthreads();                 // also: every thread has read buf
    const float scale = __uint_as_float(row_max);
    to_a<T>(v, buf, a0);
    if (tid == 0) row_max = 0;       // every thread has read it (to_a's sync)

    if (a.dither != nullptr) {
      const float* dr = a.dither + row * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 d = *reinterpret_cast<const float4*>(dr + a0 + 128 * j);
        v[4 * j] = __fadd_rn(v[4 * j], __fmul_rn(d.x, scale));
        v[4 * j + 1] = __fadd_rn(v[4 * j + 1], __fmul_rn(d.y, scale));
        v[4 * j + 2] = __fadd_rn(v[4 * j + 2], __fmul_rn(d.z, scale));
        v[4 * j + 3] = __fadd_rn(v[4 * j + 3], __fmul_rn(d.w, scale));
      }
    }
    float mk = 1.0f;
    float s_out = scale;
    if (a.mask != nullptr) {
      mk = a.mask[row];
      s_out = __fmul_rn(scale, mk);
    }
    if (tid == 0) a.scale_out[row] = s_out;

    const float denom = fmaxf(scale, FLT_MIN);
    const unsigned mw = static_cast<unsigned>(static_cast<int32_t>(mk));
    unsigned w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned x = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x |= ndsc::quantize_code(v[4 * j + c], denom, BITS)
             << (shift0 + c * BITS);
      // the G lanes of a word hold disjoint bit fields: OR them together,
      // so that every one of them holds the whole word
#pragma unroll
      for (int o = 1; o < G; o <<= 1)
        x |= __shfl_xor_sync(ndsc::kFullMask, x, o);
      if (a.mask != nullptr) x *= mw;   // the int32 product, wrapping
      w[j] = x;
    }
    if (lane % G == 0) {
      int32_t* wr = a.words + row * WPR;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wr[(a0 + 128 * j) / K] = static_cast<int32_t>(w[j]);
    }
    if (a.residual == nullptr) continue;      // uniform across the grid

    // decode the lane's own codes from the masked words
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned idx = (w[j] >> (shift0 + c * BITS)) & kCodeMask;
        float xh = ndsc::dequant(idx, inv_levels, s_out);
        if (a.mask != nullptr) {
          xh = __fmul_rn(xh, mk);
          if (a.has_rescale) xh = __fdiv_rn(xh, a.rescale);
        }
        v[4 * j + c] = xh;
      }
    }
    __syncthreads();                 // every thread has read to_a's buf
    fwht_low(v, lane);
    to_b<T>(v, buf, a0);
    // u again, for the residual in layout B: one bulk copy into buf, in
    // flight while the top stages run (read per value from global memory
    // instead, encode_ef took 7.2 ms against 3.7 on chip_smoke 3f's tree at
    // 2^14 on an H100 80GB HBM3 at 700 W, PERF.md)
    __syncthreads();                 // every thread has read buf
    if (tid == 0) bulk_load(buf, xr, N * 4, &bar_u);
    fwht_high<LOG2N>(v);
    ndsc::scale_values(v, a.inv_sqrt_n);
    mbar_wait(&bar_u, parity_u);
    parity_u ^= 1u;
    float* rr = a.residual + row * N;
#pragma unroll
    for (int r = 0; r < kRowV; ++r) {
      const int p = tid + T * r;
      float y = __fmul_rn(v[r], a.signs[p]);
      if (a.residual_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
      rr[p] = __fsub_rn(buf[p], y);
    }
    // the next row writes buf only after its first __syncthreads
  }
}

template <int LOG2N, int BITS>
int launch_row_bits(const EncodeArgs& a, cudaStream_t stream) {
  using S = RowShape<LOG2N>;
  static ndsc::LaunchCache cache;
  int fit = 0;
  const cudaError_t rc = ndsc::persistent_blocks(
      encode_row_kernel<LOG2N, BITS>, S::T, S::SMEM, &cache, &fit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks =
      static_cast<unsigned>(a.rows < fit ? a.rows : fit);
  encode_row_kernel<LOG2N, BITS><<<blocks, S::T, S::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int launch_row(const EncodeArgs& a, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_row_bits<LOG2N, 1>(a, stream);
    case 2: return launch_row_bits<LOG2N, 2>(a, stream);
    case 4: return launch_row_bits<LOG2N, 4>(a, stream);
    default: return launch_row_bits<LOG2N, 8>(a, stream);
  }
}

// ---- the "cluster" route: n = 2^16 .. kClusterMaxN, a cluster per row -----

constexpr int kClusterMinN = 1 << 16;
// The largest n of the route: C = n / 2^kClusterSeg CTAs a cluster, at most
// 8 (the portable cluster size; 16 would need the non-portable opt-in, and
// chip_smoke.py phase 1 prints how many clusters of 2..16 CTAs fit on the
// card, ndsc_encode_cluster_fit). Above it the passes run.
constexpr int kClusterMaxLog2 = 17;
constexpr int kClusterMaxN = 1 << kClusterMaxLog2;
// The segment of a row that one CTA holds: 2^14 (512 threads, two CTAs an
// SM) or 2^15 (1024 threads, one); tools/encode_cluster_variants.py times
// both.
constexpr int kClusterSeg = 14;

__device__ inline unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ inline unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ inline unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: its shared-memory writes before
// it are visible to the whole cluster after it.
__device__ inline void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of CTA `rank`'s copy of the shared::cta
// address `addr`.
__device__ inline uint32_t peer_addr(uint32_t addr, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ inline float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ inline unsigned ld_peer_u32(uint32_t addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// Where a CTA's values sit in the row once the top stages have run: the
// CTA holds NS / P pieces of P consecutive positions, piece s being piece
// `rank` of segment s; buffer index l (< NS) is piece l / P at offset
// l % P.
template <int SEG, int C>
struct ClusterLayout {
  static constexpr int NS = 1 << SEG, T = NS / kRowV;
  static constexpr int P = NS / C;
  static constexpr int I = P / T;            // registers of layout X a piece
  // so that a0 + 128*j (layout A, j < 8) stays in a0's piece
  static_assert(P % 1024 == 0, "a piece must hold whole warps of layout A");

  // the row position of buffer index l
  __device__ static int pos(int l, unsigned rank) {
    return (l / P) * NS + static_cast<int>(rank) * P + l % P;
  }
  // pos(t + T*q) - pos(t) for t < T: a constant for each register q, so
  // that the compiler keeps one base address, not one for each register
  // (which spilled)
  __host__ __device__ static constexpr int off_b(int q) {
    return (q / I) * NS + T * (q % I);
  }
};

// The exchange before the stages h = 2^SEG, 2^(SEG+1), ... of a row of C
// segments of 2^SEG, v in layout B: a thread's register q holds in-segment
// position t + T*q in every CTA. buf is free: every thread of this CTA has
// read its own addresses of it (to_b), and the partners last read it
// before a cluster barrier. Each CTA stores v there and synchronizes the
// cluster; thread t of CTA rank then reads, from every CTA r, in-segment
// positions rank*P + t + T*i (i < I = 32/C), which CTA r holds at buffer
// index t + T*(rank*I + i), into register r*I + i: layout X, the value at
// buffer index t + T*q of ClusterLayout. The caller synchronizes the
// cluster before buf is written again.
template <int SEG, int C>
__device__ inline void cluster_stages(float (&v)[kRowV], float* buf,
                                      unsigned rank) {
  constexpr int T = RowShape<SEG>::T, I = ClusterLayout<SEG, C>::I;
  float* mine = buf + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kRowV; ++q) mine[T * q] = v[q];
  cluster_sync();
  float* piece = mine + T * I * static_cast<int>(rank);
  const uint32_t at = ndsc::smem_addr(piece);
#pragma unroll
  for (int r = 0; r < C; ++r) {
    if (r == static_cast<int>(rank)) {
#pragma unroll
      for (int i = 0; i < I; ++i) v[r * I + i] = piece[T * i];
    } else {
      const uint32_t peer = peer_addr(at, r);
#pragma unroll
      for (int i = 0; i < I; ++i) v[r * I + i] = ld_peer(peer + 4 * T * i);
    }
  }
}

// After cluster_stages: the stages over the segments in layout X, register
// r*I + i pairing with (r ^ h)*I + i, in increasing h (ref.fwht's order).
template <int SEG, int C>
__device__ inline void top_stages(float (&v)[kRowV]) {
  ndsc::register_stages<ClusterLayout<SEG, C>::I, kRowV>(v);
}

template <int LOG2N, int SEG, int BITS>
__global__ void __launch_bounds__(RowShape<SEG>::T, RowShape<SEG>::BLOCKS)
    encode_cluster_kernel(const EncodeArgs a) {
  using S = RowShape<SEG>;
  constexpr int N = 1 << LOG2N, NS = S::N, T = S::T;
  constexpr int C = N / NS;                  // CTAs a cluster
  constexpr int K = 32 / BITS;               // codes per word
  constexpr int G = K / 4;                   // lanes a word spans
  constexpr int WPR = N / K;                 // words per row
  constexpr unsigned kCodeMask = (1u << BITS) - 1u;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);   // NS floats: the exchanges
  float* stage = buf + NS;                        // S::STAGE floats
  __shared__ uint64_t bar;                        // the staged half segment
  __shared__ uint64_t bar_u;                      // u again, into buf
  // the CTA's maximum of |x|'s bits, by row parity: a partner reads a row's
  // slot after that row's maximum barrier, and the slot is cleared one row
  // later, after the next row's first cluster barrier
  __shared__ unsigned row_max[2];

  using L = ClusterLayout<SEG, C>;
  const int tid = threadIdx.x, lane = tid & 31;
  const int a0 = 4 * lane + 1024 * (tid >> 5);    // group 0's position in A
  const bool staged = a0 < S::STAGE;              // uniform over the warp
  const int shift0 = (4 * lane) % K * BITS;
  const float inv_levels = ndsc::inv_levels(BITS);
  const unsigned rank = cluster_rank();
  const int seg0 = static_cast<int>(rank) * NS;   // the CTA's segment
  // after the top stages: the row positions of layout A's group 0 and of
  // layout X's (B's) register 0
  const int pa = L::pos(a0, rank);
  const int pb = L::pos(tid, rank);
  const int64_t clusters = cluster_count();

  // every CTA of a cluster walks the same rows, so none waits at a cluster
  // barrier for a partner that has left the loop
  int64_t row = cluster_id();
  if (tid == 0) {
    mbar_init(&bar);
    mbar_init(&bar_u);
    row_max[0] = row_max[1] = 0;
    if (row < a.rows)
      bulk_load(stage, a.x + row * N + seg0, S::STAGE * 4, &bar);
  }
  __syncthreads();
  uint32_t parity = 0, parity_u = 0, slot = 0;
  for (; row < a.rows; row += clusters, slot ^= 1u) {
    const float* xr = a.x + row * N + seg0;
    float v[kRowV];
    if (staged) {
      mbar_wait(&bar, parity);
      load_a(v, stage + a0);
    } else {
      load_a(v, xr + a0);
    }
    parity ^= 1u;
    mul_a(v, a.signs + seg0 + a0);
    // every staged value is in registers, and every thread has left the
    // previous row's reads of buf
    __syncthreads();
    if (tid == 0 && row + clusters < a.rows)
      bulk_load(stage, xr + clusters * N, S::STAGE * 4, &bar);

    fwht_low(v, lane);
    to_b<T>(v, buf, a0);
    fwht_high<SEG>(v);
    cluster_stages<SEG, C>(v, buf, rank);
    top_stages<SEG, C>(v);
    if (tid == 0) row_max[slot ^ 1u] = 0;   // the previous row's, read
    ndsc::scale_values(v, a.inv_sqrt_n);    // after every stage: 1/sqrt(N)
    unsigned m = 0;
#pragma unroll
    for (int r = 0; r < kRowV; ++r) {
      const unsigned b = __float_as_uint(fabsf(v[r]));
      m = b > m ? b : m;
    }
    m = __reduce_max_sync(ndsc::kFullMask, m);
    if (lane == 0) atomicMax(&row_max[slot], m);
    // the partners have read buf, and every CTA's maximum is in
    cluster_sync();
    // lane r < C reads CTA r's maximum, and the warp takes their maximum
    m = lane < C ? ld_peer_u32(peer_addr(ndsc::smem_addr(&row_max[slot]),
                                         lane))
                 : 0u;
    const float scale = __uint_as_float(__reduce_max_sync(ndsc::kFullMask,
                                                          m));
    to_a<T>(v, buf, a0);

    if (a.dither != nullptr) {
      const float* dr = a.dither + row * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 d = *reinterpret_cast<const float4*>(
            dr + pa + 128 * j);
        v[4 * j] = __fadd_rn(v[4 * j], __fmul_rn(d.x, scale));
        v[4 * j + 1] = __fadd_rn(v[4 * j + 1], __fmul_rn(d.y, scale));
        v[4 * j + 2] = __fadd_rn(v[4 * j + 2], __fmul_rn(d.z, scale));
        v[4 * j + 3] = __fadd_rn(v[4 * j + 3], __fmul_rn(d.w, scale));
      }
    }
    float mk = 1.0f;
    float s_out = scale;
    if (a.mask != nullptr) {
      mk = a.mask[row];
      s_out = __fmul_rn(scale, mk);
    }
    if (rank == 0 && tid == 0) a.scale_out[row] = s_out;

    const float denom = fmaxf(scale, FLT_MIN);
    const unsigned mw = static_cast<unsigned>(static_cast<int32_t>(mk));
    unsigned w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned x = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x |= ndsc::quantize_code(v[4 * j + c], denom, BITS)
             << (shift0 + c * BITS);
#pragma unroll
      for (int o = 1; o < G; o <<= 1)
        x |= __shfl_xor_sync(ndsc::kFullMask, x, o);
      if (a.mask != nullptr) x *= mw;   // the int32 product, wrapping
      w[j] = x;
    }
    int32_t* wr = a.words + row * WPR;
    if (lane % G == 0) {
      // whole words of the CTA's own positions: a word never spans two
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wr[(pa + 128 * j) / K] = static_cast<int32_t>(w[j]);
    }
    if (a.residual == nullptr) continue;      // uniform across the grid

    // the CTA's own segment's words, written by the cluster: from L2
    cluster_sync();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = static_cast<unsigned>(__ldcg(wr + (seg0 + a0 + 128 * j) / K));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned idx = (w[j] >> (shift0 + c * BITS)) & kCodeMask;
        float xh = ndsc::dequant(idx, inv_levels, s_out);
        if (a.mask != nullptr) {
          xh = __fmul_rn(xh, mk);
          if (a.has_rescale) xh = __fdiv_rn(xh, a.rescale);
        }
        v[4 * j + c] = xh;
      }
    }
    // to_b stores where this thread's to_a loaded: no barrier between
    fwht_low(v, lane);
    to_b<T>(v, buf, a0);
    fwht_high<SEG>(v);
    cluster_stages<SEG, C>(v, buf, rank);
    cluster_sync();                  // the partners have read buf
    // u again, for the residual in layout B or X: bulk copies into buf (its
    // C pieces, or its segment), in flight during the stages over the
    // segments and the multiply
    if (tid == 0) {
      const float* ur = a.x + row * N;
      mbar_expect(&bar_u, NS * 4);
#pragma unroll
      for (int r = 0; r < NS / L::P; ++r)
        bulk_copy(buf + r * L::P, ur + L::pos(r * L::P, rank), L::P * 4,
                  &bar_u);
    }
    top_stages<SEG, C>(v);
    ndsc::scale_values(v, a.inv_sqrt_n);
    mbar_wait(&bar_u, parity_u);
    parity_u ^= 1u;
    float* rr = a.residual + row * N + pb;
    const float* sr = a.signs + pb;
#pragma unroll
    for (int r = 0; r < kRowV; ++r) {
      float y = __fmul_rn(v[r], sr[L::off_b(r)]);
      if (a.residual_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
      rr[L::off_b(r)] = __fsub_rn(buf[tid + T * r], y);
    }
    // the next row writes buf only after its first __syncthreads
  }
  // no CTA leaves while a partner may still read its shared memory
  cluster_sync();
}

// A launch of clusters of c CTAs (threads, smem bytes each): `clusters`
// of them on `stream`. cfg keeps a pointer to attr.
inline void cluster_config(cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int c,
                           unsigned clusters, int threads, int smem,
                           cudaStream_t stream) {
  *cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(clusters * c);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The clusters of c CTAs of `kernel` that fit on the current device at
// once, read once per (kernel, device); an error where not one fits.
template <typename Kernel>
cudaError_t cluster_fit(Kernel kernel, int c, int threads, int smem,
                        ndsc::LaunchCache* cache, int* clusters) {
  cudaError_t rc = ndsc::opt_in_smem(kernel, smem, cache);
  if (rc != cudaSuccess) return rc;
  int dev = 0;
  rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < ndsc::kMaxDevices && cache->blocks[dev] > 0) {
    *clusters = cache->blocks[dev];
    return cudaSuccess;
  }
  if (c > 8) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
    if (rc != cudaSuccess) return rc;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, c, 1, threads, smem, nullptr);
  int n = 0;
  rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaErrorInvalidConfiguration;
  if (dev < ndsc::kMaxDevices) cache->blocks[dev] = n;
  *clusters = n;
  return cudaSuccess;
}

template <int LOG2N, int BITS>
int launch_cluster_bits(const EncodeArgs& a, cudaStream_t stream) {
  using S = RowShape<kClusterSeg>;
  constexpr int C = 1 << (LOG2N - kClusterSeg);
  auto kernel = encode_cluster_kernel<LOG2N, kClusterSeg, BITS>;
  static ndsc::LaunchCache cache;
  int fit = 0;
  cudaError_t rc = cluster_fit(kernel, C, S::T, S::SMEM, &cache, &fit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, C,
                 static_cast<unsigned>(a.rows < fit ? a.rows : fit), S::T,
                 S::SMEM, stream);
  rc = cudaLaunchKernelEx(&cfg, kernel, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int launch_cluster(const EncodeArgs& a, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch_cluster_bits<LOG2N, 1>(a, stream);
    case 2: return launch_cluster_bits<LOG2N, 2>(a, stream);
    case 4: return launch_cluster_bits<LOG2N, 4>(a, stream);
    default: return launch_cluster_bits<LOG2N, 8>(a, stream);
  }
}

}  // namespace

// The clusters of `cluster` CTAs of the cluster route's kernel (its
// segment, threads and shared memory) that fit on the current device at
// once, into *clusters; a cluster of more than 8 CTAs with the
// non-portable opt-in. Returns the CUDA error of the query.
extern "C" int ndsc_encode_cluster_fit(int cluster, int* clusters) {
  using S = RowShape<kClusterSeg>;
  ndsc::LaunchCache cache = {};
  return static_cast<int>(
      cluster_fit(encode_cluster_kernel<kClusterMaxLog2, kClusterSeg, 4>,
                  cluster, S::T, S::SMEM, &cache, clusters));
}

// x, dither, residual: (rows, n) float32; signs: (n,) float32; mask,
// scale_out: (rows,) float32; words: (rows, n*bits/32) int32; n a power of
// two in [32, 8192] or in [2^14, kClusterMaxN]. dither, mask and residual
// may be null; x, signs, dither and residual are 16-byte aligned. Returns
// cudaGetLastError() (or the error of the shared-memory opt-in, the
// cluster occupancy query or cudaLaunchKernelEx).
extern "C" int ndsc_encode(const float* x, const float* signs,
                           const float* dither, const float* mask,
                           int32_t* words, float* scale_out, float* residual,
                           int64_t rows, int n, int bits, float inv_sqrt_n,
                           int has_rescale, float rescale, int residual_bf16,
                           cudaStream_t stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8)
    return cudaErrorInvalidValue;
  if (!ndsc::is_pow2(n) || n < 32 || n > kClusterMaxN ||
      (n > ndsc::kMaxN && n < kRowMinN))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const EncodeArgs a{x, signs, dither, mask, words, scale_out, residual,
                     rows, ndsc::log2_int(n), inv_sqrt_n, has_rescale,
                     rescale, residual_bf16};
  if (n == kClusterMinN) return launch_cluster<16>(a, bits, stream);
  if (n == 2 * kClusterMinN) return launch_cluster<17>(a, bits, stream);
  if (n == kRowMinN) return launch_row<14>(a, bits, stream);
  if (n == kRowMaxN) return launch_row<15>(a, bits, stream);
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
