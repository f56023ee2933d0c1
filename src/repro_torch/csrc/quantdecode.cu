// Flash-decode GQA attention of one query step over the NDSC-packed,
// Hadamard-rotated KV cache, with the inverse rotation of V at the end.
//
// Per (batch b, kv-head h): q (G, dh) pre-scaled and rotated; for each
// cached position c < C, K_c and V_c are unpacked from R-bit codes and
// scaled by their per-vector scales; scores s_gc = q_g . K_c, masked to
// -1e30 where c >= kv_len[b]; out = FWHT(softmax(s) V), the softmax taken
// online (running max m, sum l, accumulator acc) and closed with
// acc / max(l, 1e-30), as ref.quant_decode_attention computes it.
//
// Replaces: src/repro/kernels/quantdecode.py, quant_decode_attention_pallas
// (pl.pallas_call body _qdecode_kernel). Called through
// repro_torch.kernels.ops.quant_decode_attention from
// models/kvquant.quant_decode_attention, once per layer per decode step.
//
// Bound on an H100: bytes at 8 bits and short caches, operations at 4 bits
// and below on long ones. The kernel reads R/8 B of K and V codes per
// coordinate plus two scales per position, and does 4*G*dh f32 operations
// per position for the two products.
// Design: the cache is split across blocks. The grid is (b, h, split): a
// block walks positions [s*L, min((s+1)*L, C)) of one (b, h), L a whole
// number of tiles, chosen by the wrapper from C and the card's SM count
// (kernels/quantdecode.py, num_splits) so that several blocks run on each
// SM. With one split the block normalizes, inverse-rotates and writes the
// output itself; otherwise it writes its partial (m, l, acc) per row, and a
// combining kernel, one block per (b, h), weighs split s by
// w_s = exp(m_s - max m), closes with sum w_s acc_s / max(sum w_s l_s,
// 1e-30) and inverse-rotates (ndsc::fwht_tile).
// Two kernels walk a split. For G <= 8 and 32 <= dh <= 256 (the serving
// path's G 8, dh 128), quant_decode_warp_kernel holds the query rows and
// their accumulators in registers and has each warp take batches of 8
// positions: every lane loads the words of its dh/32 coordinates straight
// from global memory, dequantizes them in registers and adds its part of
// the 8 scores, which 9 shuffles reduce across the warp; the online
// softmax runs per batch, and only the batch's probabilities pass through
// shared memory (72 floats per warp). There is no block barrier until the
// warps' partial results are combined at the end. Other shapes take
// quant_decode_tile_kernel: q and the (G, dh) accumulator in shared memory,
// tiles of tc positions whose K and V are unpacked once into shared
// memory, one thread per packed word; one thread per (g, position) computes
// a score from float4 reads of q and of the K tile, whose row stride of
// dh + 4 puts the 8 rows a quarter-warp reads in distinct banks; one warp
// per query row runs the online softmax with shuffles; one thread per
// (g, 4 channels) accumulates p . V. Packed words are shifted as unsigned.
// f32 on CUDA cores throughout (no TF32, no tensor cores), expf rather
// than __expf.
// Masking: with kv_len >= 1, a position past it weighs exp(-1e30 - m) = 0
// exactly, so the walk stops at min(kv_len, C); a split (or a warp) that
// starts there or later does no work and writes m = -1e30, l = 0, acc = 0,
// which the combine weighs exp(-1e30 - M) = 0 (split 0 always holds
// position 0, so M is a real score). With kv_len = 0 every score is -1e30
// and the reference's softmax is the uniform mean over all C, so every
// split visits all its positions: each has m = -1e30, every w_s is 1, and
// the combine gives sum acc / sum l, the mean. m is never -inf, whose
// difference with itself would be NaN.
#include "ndsc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
// Largest dynamic shared memory a block may use on an H100 (227 KB), and
// what a block may use without opting in.
constexpr size_t kMaxSmemBytes = 232448;
constexpr size_t kDefaultSmemBytes = 49152;
// The warp-resident kernel: query rows held in registers, positions a warp
// takes at a time, shared floats of one warp (p of each position and row,
// and the rows' corrections), and the tile that a split's length is a
// multiple of (one batch per warp).
constexpr int kRows = 8;
constexpr int kBatch = 8;
constexpr int kWarpFloats = (kBatch + 1) * kRows;
constexpr int kWarpTile = kBatch * (ndsc::kThreads / 32);

__host__ __device__ inline bool warp_path(int g, int dh) {
  return g <= kRows && dh >= 32 && dh <= 256;
}

__host__ __device__ inline size_t warp_smem_floats(int g, int dh) {
  // (warp, row) maxima, sums and weights, per-row sums; then the larger of
  // the warps' p buffers and their (warp, g, dh) accumulators
  const int warps = ndsc::kThreads / 32;
  const size_t acc = static_cast<size_t>(warps) * g * dh;
  const size_t bufs = static_cast<size_t>(warps) * kWarpFloats;
  return 3 * warps * kRows + kRows + (acc > bufs ? acc : bufs);
}

__host__ __device__ inline size_t smem_floats(int g, int dh, int tc) {
  // q, acc: g*dh each; K tile: tc*(dh+4); V tile: tc*dh; p: g*tc;
  // running max, sum, correction: g each
  return 2 * static_cast<size_t>(g) * dh +
         static_cast<size_t>(tc) * (2 * dh + 4) +
         static_cast<size_t>(g) * tc + 3 * static_cast<size_t>(g);
}

__host__ __device__ inline size_t combine_smem_floats(int g, int dh, int s) {
  // output rows: g*dh; weights: s*g; denominators: g
  return static_cast<size_t>(g) * dh + static_cast<size_t>(s) * g + g;
}

// Four consecutive codes of word w, from bit `shift` on, dequantized.
__device__ inline float4 dequant4(unsigned w, int shift, int bits,
                                  unsigned code_mask, float inv_levels,
                                  float scale) {
  return make_float4(
      ndsc::dequant((w >> shift) & code_mask, inv_levels, scale),
      ndsc::dequant((w >> (shift + bits)) & code_mask, inv_levels, scale),
      ndsc::dequant((w >> (shift + 2 * bits)) & code_mask, inv_levels, scale),
      ndsc::dequant((w >> (shift + 3 * bits)) & code_mask, inv_levels,
                    scale));
}

// Normalizes the G rows of sacc by their sums, inverse-rotates them when
// asked and writes them to out. All threads of the block call it.
__device__ inline void finish_rows(float* sacc, const float* den, float* out,
                                   int G, int log2dh, int inv_rotate_v,
                                   float inv_sqrt_dh) {
  const int dh = 1 << log2dh;
  __syncthreads();
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x)
    sacc[e] = sacc[e] / fmaxf(den[e >> log2dh], 1e-30f);
  if (inv_rotate_v)
    ndsc::fwht_tile(sacc, G, log2dh, inv_sqrt_dh);  // synchronizes
  else
    __syncthreads();
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x) out[e] = sacc[e];
}

__global__ void quant_decode_tile_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ kw,
    const float* __restrict__ ks, const int32_t* __restrict__ vw,
    const float* __restrict__ vs, const int32_t* __restrict__ kv_len,
    float* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int C, int K, int G, int log2dh, int bits,
    int tc, int S, int L, int inv_rotate_v, float inv_sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  const int dh = 1 << log2dh;
  const int dh4 = dh >> 2;               // dh >= 4: dh * bits is a multiple
  const int log2dh4 = log2dh - 2;        // of 32 with bits <= 8
  const int bk = blockIdx.x / S;         // b * K + h
  const int split = blockIdx.x - bk * S;
  const int b = bk / K;
  const int kh = bk - b * K;
  const int log2k = 5 - (__ffs(bits) - 1);  // k = 32 / bits codes per word
  const int log2w = log2dh - log2k;         // W = dh / k words per vector
  const int ldk = dh + 4;
  float* sq = smem;
  float* sacc = sq + G * dh;
  float* sk = sacc + G * dh;
  float* sv = sk + tc * ldk;
  float* sp = sv + tc * dh;
  float* sm = sp + G * tc;
  float* sl = sm + G;
  float* scorr = sl + G;

  const int64_t qoff = static_cast<int64_t>(bk) * G * dh;
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x) {
    sq[e] = q[qoff + e];
    sacc[e] = 0.0f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sm[g] = kNegInf;
    sl[g] = 0.0f;
  }
  const int len = kv_len[b];
  const int n_pos = len >= 1 ? (len < C ? len : C) : C;
  const int p0 = split * L;
  const int p1 = p0 + L < n_pos ? p0 + L : n_pos;  // <= p0: nothing to do
  const unsigned code_mask = (1u << bits) - 1u;
  const float inv_levels = ndsc::inv_levels(bits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();

  for (int t0 = p0; t0 < p1; t0 += tc) {
    const int nt = p1 - t0 < tc ? p1 - t0 : tc;
    // 1. unpack + dequantize the tile's K and V, one thread per word
    for (int e = threadIdx.x; e < (nt << log2w); e += blockDim.x) {
      const int c = e >> log2w;
      const int wi = e & ((1 << log2w) - 1);
      const int64_t vec = (static_cast<int64_t>(b) * C + t0 + c) * K + kh;
      const int64_t woff = (vec << log2w) + wi;
      const unsigned kword = static_cast<unsigned>(kw[woff]);
      const unsigned vword = static_cast<unsigned>(vw[woff]);
      const float kscale = ks[vec];
      const float vscale = vs[vec];
      float4* kd = reinterpret_cast<float4*>(sk + c * ldk + (wi << log2k));
      float4* vd = reinterpret_cast<float4*>(sv + c * dh + (wi << log2k));
      for (int j = 0; j < (1 << log2k) >> 2; ++j) {
        kd[j] = dequant4(kword, 4 * j * bits, bits, code_mask, inv_levels,
                         kscale);
        vd[j] = dequant4(vword, 4 * j * bits, bits, code_mask, inv_levels,
                         vscale);
      }
    }
    __syncthreads();
    // 2. scores, one thread per (g, position), four partial sums
    for (int e = threadIdx.x; e < G * nt; e += blockDim.x) {
      const int g = e / nt;
      const int c = e - g * nt;
      const float4* qr = reinterpret_cast<const float4*>(sq + g * dh);
      const float4* kr = reinterpret_cast<const float4*>(sk + c * ldk);
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int d = 0; d < dh4; ++d) {
        const float4 a = qr[d];
        const float4 k4 = kr[d];
        s.x = fmaf(a.x, k4.x, s.x);
        s.y = fmaf(a.y, k4.y, s.y);
        s.z = fmaf(a.z, k4.z, s.z);
        s.w = fmaf(a.w, k4.w, s.w);
      }
      sp[g * tc + c] = t0 + c < len ? (s.x + s.y) + (s.z + s.w) : kNegInf;
    }
    __syncthreads();
    // 3. online softmax, one warp per query row
    for (int g = warp; g < G; g += nwarps) {
      float* pr = sp + g * tc;
      float mx = kNegInf;
      for (int c = lane; c < nt; c += 32) mx = fmaxf(mx, pr[c]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < nt; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      // the shuffles order every lane's read of sm[g] before lane 0's write
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * corr + p . V, one thread per (g, 4 channels)
    for (int e = threadIdx.x; e < G * dh4; e += blockDim.x) {
      const int g = e >> log2dh4;
      const int d4 = e & (dh4 - 1);
      const float* pr = sp + g * tc;
      const float4* vcol = reinterpret_cast<const float4*>(sv) + d4;
      const float corr = scorr[g];
      float4 a = reinterpret_cast<float4*>(sacc)[e];
      a.x *= corr;
      a.y *= corr;
      a.z *= corr;
      a.w *= corr;
      for (int c = 0; c < nt; ++c) {
        const float p = pr[c];
        const float4 v4 = vcol[c * dh4];
        a.x = fmaf(p, v4.x, a.x);
        a.y = fmaf(p, v4.y, a.y);
        a.z = fmaf(p, v4.z, a.z);
        a.w = fmaf(p, v4.w, a.w);
      }
      reinterpret_cast<float4*>(sacc)[e] = a;
    }
    __syncthreads();
  }

  if (S == 1) {
    // 5. normalize, inverse-rotate V (H is its own inverse), write out
    finish_rows(sacc, sl, out + qoff, G, log2dh, inv_rotate_v, inv_sqrt_dh);
    return;
  }
  // 5'. the split's partial result: acc unnormalized, then (m, l) per row
  __syncthreads();
  const int64_t poff = static_cast<int64_t>(blockIdx.x) * G;
  float4* pacc = reinterpret_cast<float4*>(part_acc + poff * dh);
  for (int e = threadIdx.x; e < G * dh4; e += blockDim.x)
    pacc[e] = reinterpret_cast<const float4*>(sacc)[e];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    part_ml[2 * (poff + g)] = sm[g];
    part_ml[2 * (poff + g) + 1] = sl[g];
  }
}

// Sum over the 32 lanes of each of the 8 values x[0..8): on return every
// lane holds the full sum of row (lane >> 2) & 7, in 9 shuffles (each level
// halves the rows a lane keeps and doubles the lanes it has summed over).
__device__ inline float reduce_rows8(const float (&x)[kRows]) {
  const int lane = threadIdx.x & 31;
  float u[4], v[2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool hi = lane & 16;
    const float send = hi ? x[r] : x[r + 4];
    u[r] = (hi ? x[r + 4] : x[r]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool hi = lane & 8;
    const float send = hi ? u[r] : u[r + 2];
    v[r] = (hi ? u[r + 2] : u[r]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = lane & 4;
  float w = (hi ? v[1] : v[0]) +
            __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[1], 4);
  w += __shfl_xor_sync(0xffffffffu, w, 2);
  w += __shfl_xor_sync(0xffffffffu, w, 1);
  return w;
}

// The R-bit codes of lane's V coordinates of one cache vector, as
// u = -1 + (2 idx + 1) / 2^R (exact in f32), from its NW loaded words.
template <int V, int R, int NW>
__device__ inline void unit_codes(const unsigned (&w)[NW], int bit0,
                                  float two_inv, float off, float (&u)[V]) {
  constexpr unsigned kMask = (1u << R) - 1u;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    unsigned code;
    if constexpr (NW == 1)
      code = (w[0] >> (bit0 + j * R)) & kMask;
    else
      code = (w[(j * R) >> 5] >> ((j * R) & 31)) & kMask;
    u[j] = fmaf(static_cast<float>(code), two_inv, off);
  }
}

// The NW words that hold lane's codes of cache vector `vec`.
template <int NW, int WPV>
__device__ inline void load_words(const unsigned* __restrict__ words,
                                  int64_t vec, int first,
                                  unsigned (&w)[NW]) {
  const unsigned* p = words + vec * WPV + first;
  if constexpr (NW == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else {
    w[0] = *p;
  }
}

// Warp-resident decode attention for dh = 32 V (V in {1, 2, 4, 8}) and
// G <= 8: lane l owns coordinates [l V, (l + 1) V) of all 8 query rows and
// of their accumulators, in registers. A warp takes batches of kBatch
// positions (warp w: batches w, w + 8, ... of the split's range); per
// position each lane loads the words that hold its codes straight from
// global memory (consecutive lanes, consecutive words), dequantizes them
// in registers and adds its part of the 8 scores, reduced across the warp
// in 9 shuffles. The online softmax runs per batch on the lane's row
// ((lane >> 2) & 7); the probabilities and corrections go through 72
// floats of shared memory per warp (one writer lane per row, broadcast
// reads). V is dequantized in registers likewise and accumulated with the
// probabilities times the V scale. No block barrier until the warps'
// partial results are combined in shared memory at the end.
template <int V, int R>
__global__ void __launch_bounds__(ndsc::kThreads, V >= 8 ? 1 : 2)
    quant_decode_warp_kernel(const float* __restrict__ q,
                             const unsigned* __restrict__ kw,
                             const float* __restrict__ ks,
                             const unsigned* __restrict__ vw,
                             const float* __restrict__ vs,
                             const int32_t* __restrict__ kv_len,
                             float* __restrict__ out,
                             float* __restrict__ part_acc,
                             float* __restrict__ part_ml, int C, int K,
                             int G, int S, int L, int inv_rotate_v,
                             float inv_sqrt_dh) {
  constexpr int kDh = 32 * V;
  constexpr int kLog2Dh = V == 1 ? 5 : V == 2 ? 6 : V == 4 ? 7 : 8;
  constexpr int kWpv = kDh * R / 32;               // words per vector
  constexpr int kLaneBits = V * R;
  constexpr int kNw = kLaneBits >= 32 ? kLaneBits / 32 : 1;
  constexpr int kWarps = ndsc::kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  float* cm = smem;                                 // (warp, row) maxima
  float* cl = cm + kWarps * kRows;                  // (warp, row) sums
  float* cw = cl + kWarps * kRows;                  // (warp, row) weights
  float* cden = cw + kWarps * kRows;                // per row: sum
  float* big = cden + kRows;                        // per-warp p, or acc
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (lane >> 2) & 7;                  // this lane's softmax row
  float* sp = big + warp * kWarpFloats;             // p[i][row], corr[row]

  const int bk = blockIdx.x / S;
  const int split = blockIdx.x - bk * S;
  const int b = bk / K;
  const int kh = bk - b * K;
  const int64_t qoff = static_cast<int64_t>(bk) * G * kDh;
  float qr[kRows][V], acc[kRows][V];
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      qr[g][j] = g < G ? q[qoff + g * kDh + lane * V + j] : 0.0f;
      acc[g][j] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;                      // of this lane's row
  const int len = kv_len[b];
  const int n_pos = len >= 1 ? (len < C ? len : C) : C;
  const int p0 = split * L;
  const int p1 = p0 + L < n_pos ? p0 + L : n_pos;   // <= p0: nothing to do
  const float inv = ndsc::inv_levels(R);
  const float two_inv = 2.0f * inv;                 // exact
  const float off = inv - 1.0f;                     // exact
  const int first = kNw == 1 ? (lane * kLaneBits) >> 5 : lane * kNw;
  const int bit0 = kNw == 1 ? (lane * kLaneBits) & 31 : 0;
  const int64_t vec0 = static_cast<int64_t>(b) * C * K + kh;

  for (int c0 = p0 + warp * kBatch; c0 < p1; c0 += kWarps * kBatch) {
    const int nb = p1 - c0 < kBatch ? p1 - c0 : kBatch;
    // 1. scores of the batch's positions; lane keeps its row's. The
    // batch's V words are loaded with its K words, so their latency hides
    // behind the scores.
    unsigned wd[kBatch][kNw], wv[kBatch][kNw];
    float sc[kBatch], svs[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < nb) {
        const int64_t vec = vec0 + static_cast<int64_t>(c0 + i) * K;
        load_words<kNw, kWpv>(kw, vec, first, wd[i]);
        load_words<kNw, kWpv>(vw, vec, first, wv[i]);
        sc[i] = ks[vec];
        svs[i] = vs[vec];
      }
    }
    float s[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      s[i] = kNegInf;
      if (i < nb) {
        float u[V], part[kRows];
        unit_codes<V, R, kNw>(wd[i], bit0, two_inv, off, u);
#pragma unroll
        for (int g = 0; g < kRows; ++g) {
          part[g] = 0.0f;
#pragma unroll
          for (int j = 0; j < V; ++j) part[g] = fmaf(qr[g][j], u[j], part[g]);
        }
        const float r = reduce_rows8(part) * sc[i];
        s[i] = c0 + i < len ? r : kNegInf;
      }
    }
    // 2. online softmax of the lane's row over the batch
    float mx = m;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (i < nb) mx = fmaxf(mx, s[i]);
    const float corr = expf(m - mx);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      s[i] = i < nb ? expf(s[i] - mx) : 0.0f;
      sum += s[i];
    }
    l = l * corr + sum;
    m = mx;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) sp[i * kRows + row] = s[i];
      sp[kBatch * kRows + row] = corr;
    }
    __syncwarp();
    // 3. acc = acc * corr + p . V
    {
      const float4* c4 = reinterpret_cast<const float4*>(sp + kBatch * kRows);
      const float4 ca = c4[0], cb = c4[1];
      const float cr[kRows] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
      for (int g = 0; g < kRows; ++g)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[g][j] *= cr[g];
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < nb) {
        float u[V];
        unit_codes<V, R, kNw>(wv[i], bit0, two_inv, off, u);
        const float4* p4 = reinterpret_cast<const float4*>(sp + i * kRows);
        const float4 pa = p4[0], pb = p4[1];
        const float sv = svs[i];
        const float pv[kRows] = {pa.x * sv, pa.y * sv, pa.z * sv, pa.w * sv,
                                 pb.x * sv, pb.y * sv, pb.z * sv, pb.w * sv};
#pragma unroll
        for (int g = 0; g < kRows; ++g)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[g][j] = fmaf(pv[g], u[j], acc[g][j]);
      }
    }
    __syncwarp();
  }

  // 4. the warps' partial results combined in shared memory: weights
  // exp(m_w - M) per row, then one thread per (row, coordinate)
  __syncthreads();                        // every warp is done with sp
  float* cacc = big;                      // (warp, g, dh)
  if ((lane & 3) == 0 && row < G) {
    cm[warp * kRows + row] = m;
    cl[warp * kRows + row] = l;
  }
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
    if (g < G) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        cacc[(warp * G + g) * kDh + lane * V + j] = acc[g][j];
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mmax = kNegInf;
    for (int w = 0; w < kWarps; ++w) mmax = fmaxf(mmax, cm[w * kRows + g]);
    float den = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(cm[w * kRows + g] - mmax);
      cw[w * kRows + g] = wt;
      den = fmaf(wt, cl[w * kRows + g], den);
    }
    cden[g] = den;
    if (S > 1) {
      const int64_t poff = static_cast<int64_t>(blockIdx.x) * G + g;
      part_ml[2 * poff] = mmax;
      part_ml[2 * poff + 1] = den;
    }
  }
  __syncthreads();
  // element e = g * dh + d reads cacc[(w * G) * dh + e] of every warp and,
  // with one split, writes its sum back to cacc[e] (no other thread reads
  // it)
  for (int e = threadIdx.x; e < G * kDh; e += blockDim.x) {
    const int g = e >> kLog2Dh;
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      a = fmaf(cw[w * kRows + g], cacc[w * G * kDh + e], a);
    if (S > 1)
      part_acc[static_cast<int64_t>(blockIdx.x) * G * kDh + e] = a;
    else
      cacc[e] = a;
  }
  if (S == 1)
    finish_rows(cacc, cden, out + qoff, G, kLog2Dh, inv_rotate_v,
                inv_sqrt_dh);
}

// One block per (b, h): the S partial results of its splits combined.
__global__ void quant_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int G, int log2dh, int S, int inv_rotate_v,
    float inv_sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  const int dh = 1 << log2dh;
  const int dh4 = dh >> 2;
  const int log2dh4 = log2dh - 2;
  float* sacc = smem;                    // G*dh
  float* sw = sacc + G * dh;             // S*G weights, split-major
  float* sden = sw + S * G;              // G
  const int bk = blockIdx.x;
  const float* ml = part_ml + 2 * static_cast<int64_t>(bk) * S * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // weights and denominators, one warp per query row
  for (int g = warp; g < G; g += nwarps) {
    float mx = kNegInf;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, ml[2 * (s * G + g)]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float w = expf(ml[2 * (s * G + g)] - mx);
      sw[s * G + g] = w;
      den = fmaf(w, ml[2 * (s * G + g) + 1], den);
    }
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) sden[g] = den;
  }
  __syncthreads();
  // sum_s w_s acc_s, one thread per (g, 4 channels)
  const float4* pacc =
      reinterpret_cast<const float4*>(part_acc) +
      static_cast<int64_t>(bk) * S * G * dh4;
  for (int e = threadIdx.x; e < G * dh4; e += blockDim.x) {
    const int g = e >> log2dh4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < S; ++s) {
      const float w = sw[s * G + g];
      const float4 v = pacc[static_cast<int64_t>(s) * G * dh4 + e];
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
    reinterpret_cast<float4*>(sacc)[e] = a;
  }
  finish_rows(sacc, sden, out + static_cast<int64_t>(bk) * G * dh, G, log2dh,
              inv_rotate_v, inv_sqrt_dh);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmemBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

using WarpKernel = void (*)(const float*, const unsigned*, const float*,
                            const unsigned*, const float*, const int32_t*,
                            float*, float*, float*, int, int, int, int, int,
                            int, float);

template <int V>
WarpKernel warp_kernel_of_bits(int bits) {
  switch (bits) {
    case 1: return quant_decode_warp_kernel<V, 1>;
    case 2: return quant_decode_warp_kernel<V, 2>;
    case 4: return quant_decode_warp_kernel<V, 4>;
    default: return quant_decode_warp_kernel<V, 8>;
  }
}

// The instance for dh in {32, 64, 128, 256} and bits in {1, 2, 4, 8}.
WarpKernel warp_kernel(int dh, int bits) {
  switch (dh) {
    case 32: return warp_kernel_of_bits<1>(bits);
    case 64: return warp_kernel_of_bits<2>(bits);
    case 128: return warp_kernel_of_bits<4>(bits);
    default: return warp_kernel_of_bits<8>(bits);
  }
}

}  // namespace

// q, out: (B, K, G, dh) float32; kw, vw: (B, C, K, dh*bits/32) int32;
// ks, vs: (B, C, K) float32; kv_len: (B,) int32; all contiguous. dh a
// power of 2 <= 8192 with dh*bits/32 whole; C >= 1. G <= 8 and
// 32 <= dh <= 256 run the warp-resident kernel, whose tile tc must be
// kWarpTile (64) positions; other shapes the tile kernel, tc positions per
// tile. S splits of L positions each, L a multiple of tc, cover [0, C)
// with none empty ((S - 1) * L < C <= S * L). With S > 1, `part` holds
// B*K*S*G*(dh + 2) floats of scratch, 16-byte aligned: the splits'
// accumulators, then their (m, l) pairs; with S = 1 it is not read.
// Returns cudaGetLastError() (cudaErrorInvalidValue for shapes the kernels
// do not take, including one that needs more than 227 KB of shared
// memory).
extern "C" int ndsc_quant_decode_attention(
    const float* q, const int32_t* kw, const float* ks, const int32_t* vw,
    const float* vs, const int32_t* kv_len, float* out, float* part, int B,
    int C, int K, int G, int dh, int bits, int tc, int S, int L,
    int inv_rotate_v, float inv_sqrt_dh, cudaStream_t stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8)
    return cudaErrorInvalidValue;
  if (!ndsc::is_pow2(dh) || dh > ndsc::kMaxN || (dh * bits) % 32)
    return cudaErrorInvalidValue;
  if (B < 0 || C < 1 || K < 0 || G < 0 || tc < 1) return cudaErrorInvalidValue;
  const bool warp = warp_path(G, dh);
  if (warp && tc != kWarpTile) return cudaErrorInvalidValue;
  if (S < 1 || L < tc || L % tc ||
      static_cast<int64_t>(S - 1) * L >= C ||
      static_cast<int64_t>(S) * L < C)
    return cudaErrorInvalidValue;
  if (S > 1 && (part == nullptr || reinterpret_cast<uintptr_t>(part) % 16))
    return cudaErrorInvalidValue;
  const size_t smem = (warp ? warp_smem_floats(G, dh)
                            : smem_floats(G, dh, tc)) * sizeof(float);
  const size_t csmem = combine_smem_floats(G, dh, S) * sizeof(float);
  if (smem > kMaxSmemBytes || (S > 1 && csmem > kMaxSmemBytes))
    return cudaErrorInvalidValue;
  const int64_t bk = static_cast<int64_t>(B) * K;
  if (bk == 0 || G == 0) return cudaSuccess;
  if (bk * S > 0x7fffffff) return cudaErrorInvalidValue;
  const int log2dh = ndsc::log2_int(dh);
  float* part_acc = part;
  float* part_ml = S > 1 ? part + bk * S * G * dh : nullptr;
  const unsigned grid = static_cast<unsigned>(bk * S);
  cudaError_t rc;
  if (warp) {
    const WarpKernel kernel = warp_kernel(dh, bits);
    rc = allow_smem(kernel, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel<<<grid, ndsc::kThreads, smem, stream>>>(
        q, reinterpret_cast<const unsigned*>(kw), ks,
        reinterpret_cast<const unsigned*>(vw), vs, kv_len, out, part_acc,
        part_ml, C, K, G, S, L, inv_rotate_v, inv_sqrt_dh);
  } else {
    rc = allow_smem(quant_decode_tile_kernel, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    quant_decode_tile_kernel<<<grid, ndsc::kThreads, smem, stream>>>(
        q, kw, ks, vw, vs, kv_len, out, part_acc, part_ml, C, K, G, log2dh,
        bits, tc, S, L, inv_rotate_v, inv_sqrt_dh);
  }
  rc = cudaGetLastError();
  if (rc != cudaSuccess || S == 1) return static_cast<int>(rc);
  rc = allow_smem(quant_decode_combine_kernel, csmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  quant_decode_combine_kernel<<<static_cast<unsigned>(bk), ndsc::kThreads,
                                csmem, stream>>>(
      part_acc, part_ml, out, G, log2dh, S, inv_rotate_v, inv_sqrt_dh);
  return static_cast<int>(cudaGetLastError());
}
