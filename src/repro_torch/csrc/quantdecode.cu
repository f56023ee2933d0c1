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
// Design: one block per (b, h); q and the (G, dh) accumulator live in
// shared memory. The loop walks the cache in tiles of tc positions: the
// tile's K and V are unpacked once into shared memory, one thread per
// packed word (its k >= 4 codes stored as float4s); one thread per
// (g, position) computes a score from float4 reads of q and of the K tile,
// whose row stride of dh + 4 puts the 8 rows a quarter-warp reads in
// distinct banks; one warp per query row runs the online softmax with
// shuffles; one thread per (g, 4 channels) accumulates p . V. Packed words
// are shifted as unsigned. f32 on CUDA cores throughout (no TF32, no
// tensor cores), expf rather than __expf. The inverse rotation is
// ndsc::fwht_tile on the G accumulator rows, once per block.
// Masking: with kv_len >= 1, a position past it weighs exp(-1e30 - m) = 0
// exactly, so the loop stops at min(kv_len, C). With kv_len = 0 every score
// is -1e30 and the reference's softmax is the uniform mean over all C, so
// all C positions are visited. Positions past C in a ragged last tile are
// never part of the softmax.
// Occupancy: B*K blocks (16 at the serving shape) leave most of the 132 SMs
// idle; splitting C across blocks with a combining pass is later work.
#include "ndsc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
// Largest dynamic shared memory a block may use on an H100 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

__host__ __device__ inline size_t smem_floats(int g, int dh, int tc) {
  // q, acc: g*dh each; K tile: tc*(dh+4); V tile: tc*dh; p: g*tc;
  // running max, sum, correction: g each
  return 2 * static_cast<size_t>(g) * dh +
         static_cast<size_t>(tc) * (2 * dh + 4) +
         static_cast<size_t>(g) * tc + 3 * static_cast<size_t>(g);
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

__global__ void quant_decode_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ kw,
    const float* __restrict__ ks, const int32_t* __restrict__ vw,
    const float* __restrict__ vs, const int32_t* __restrict__ kv_len,
    float* __restrict__ out, int C, int K, int G, int log2dh, int bits,
    int tc, int inv_rotate_v, float inv_sqrt_dh) {
  extern __shared__ __align__(16) float smem[];
  const int dh = 1 << log2dh;
  const int dh4 = dh >> 2;               // dh >= 4: dh * bits is a multiple
  const int log2dh4 = log2dh - 2;        // of 32 with bits <= 8
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x - b * K;
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

  const int64_t qoff = (static_cast<int64_t>(b) * K + kh) * G * dh;
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
  const unsigned code_mask = (1u << bits) - 1u;
  const float inv_levels = ndsc::inv_levels(bits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();

  for (int t0 = 0; t0 < n_pos; t0 += tc) {
    const int nt = n_pos - t0 < tc ? n_pos - t0 : tc;
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

  // 5. normalize, inverse-rotate V (H is its own inverse), write out
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x)
    sacc[e] = sacc[e] / fmaxf(sl[e >> log2dh], 1e-30f);
  if (inv_rotate_v)
    ndsc::fwht_tile(sacc, G, log2dh, inv_sqrt_dh);  // synchronizes
  else
    __syncthreads();
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x)
    out[qoff + e] = sacc[e];
}

}  // namespace

// q, out: (B, K, G, dh) float32; kw, vw: (B, C, K, dh*bits/32) int32;
// ks, vs: (B, C, K) float32; kv_len: (B,) int32; all contiguous. dh a
// power of 2 <= 8192 with dh*bits/32 whole; C >= 1; tc positions per
// tile. Returns cudaGetLastError() (cudaErrorInvalidValue for shapes the
// kernel does not take, including a tile that needs more than 227 KB of
// shared memory).
extern "C" int ndsc_quant_decode_attention(
    const float* q, const int32_t* kw, const float* ks, const int32_t* vw,
    const float* vs, const int32_t* kv_len, float* out, int B, int C, int K,
    int G, int dh, int bits, int tc, int inv_rotate_v, float inv_sqrt_dh,
    cudaStream_t stream) {
  if (bits != 1 && bits != 2 && bits != 4 && bits != 8)
    return cudaErrorInvalidValue;
  if (!ndsc::is_pow2(dh) || dh > ndsc::kMaxN || (dh * bits) % 32)
    return cudaErrorInvalidValue;
  if (B < 0 || C < 1 || K < 0 || G < 0 || tc < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(G, dh, tc) * sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(B) * K == 0 || G == 0) return cudaSuccess;
  const cudaError_t attr = cudaFuncSetAttribute(
      quant_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  quant_decode_kernel<<<static_cast<unsigned>(B * K), ndsc::kThreads, smem,
                        stream>>>(q, kw, ks, vw, vs, kv_len, out, C, K, G,
                                  ndsc::log2_int(dh), bits, tc, inv_rotate_v,
                                  inv_sqrt_dh);
  return static_cast<int>(cudaGetLastError());
}
