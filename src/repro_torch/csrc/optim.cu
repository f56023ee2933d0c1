// The optimizer phase of a train step: the global norm's sum of squares
// over every gradient leaf, then one pass a leaf that folds the clip into
// AdamW's or SGD's update.
//
// Replaces no kernel of src/repro/: the reference leaves clip_by_global_norm
// and adamw()/sgd() (src/repro/optimizer/optim.py) to XLA, which fuses
// their tree maps. Eager PyTorch ran the same maps one operator a kernel:
// the clip's square, sum and multiply, AdamW's 15 maps (18 kernels, 156 B
// a value at f32), SGD's norm and its map (20 B). Called through
// repro_torch.kernels.ops: sum_squares from optimizer.optim.global_norm
// (and the ZeRO-1 step's norm), adamw_update and sgd_update from the
// optimizers' update.
//
// Bound on an H100: bytes. Each value needs a handful of float operations,
// far below the ridge line. The least that the mathematics reads and
// writes: the norm reads g once (4 B a value at f32); AdamW reads g, mu,
// nu and p and writes mu', nu' and u (28 B); SGD reads g (and its
// velocity) and writes u (and the velocity): 8 B plain, 16 B with
// momentum. 32 B a value in all for AdamW with the clip, 12 B for SGD.
// Design:
// - sum_squares: one launch over a table of up to kMaxLeaves leaves passed
//   by value (kernel parameters, so a captured graph holds them), then
//   one finishing launch. The leaves are cut into tiles of kSumTile
//   values, numbered leaf after leaf; persistent blocks (as many as fit
//   on the card) take tiles in turn, and each tile's f32 partial goes to
//   its own slot of a scratch buffer. The finishing block sums the
//   partials in f64 in a fixed order and rounds once to f32. No atomics:
//   the result depends only on the leaves' sizes, so every call and every
//   replay gives the same bits, on any card. A thread holds 8 float4
//   loads in flight per batch, 32 float4 a tile; squares and sums are
//   __fmul_rn / __fadd_rn (torch.square, then a sum).
// - adamw_update / sgd_update: one launch a leaf, persistent blocks over
//   the leaf in a grid-stride loop, each thread two float4 groups of every
//   stream a turn (128-bit loads and stores; 64-bit at 16 bits), all loads
//   and stores with the streaming hint (__ldcs / __stcs: no value is read
//   twice). A leaf that is not aligned for the vector loads takes a
//   scalar loop; the n % 4 values past the last float4 are done by the
//   first threads of block 0. lr, the bias corrections c1, c2 and the
//   clip scale are read from device memory (0-d tensors), never passed
//   from the host, so a captured step replays a schedule.
// Bitwise contract with the plain versions (repro_torch/kernels/ref.py):
// each PyTorch operator of the tree maps is one round-to-nearest
// intrinsic here, in its order: the Python-double constants (b1, 1 - b1,
// b2, 1 - b2, eps, weight_decay, momentum) arrive rounded to f32 as
// PyTorch rounds a scalar operand; division is __fdiv_rn by the device
// scalar (never a reciprocal); sqrt is __fsqrt_rn. The clip (g * scale)
// is rounded to g's dtype first, as `(g * scale).to(g.dtype)`: at bf16
// and f16 the scale is rounded to that dtype before the product, as
// PyTorch's elementwise multiply casts its f32 operand to the common
// dtype. u is rounded to p's dtype (__float2bfloat16_rn at bf16,
// __float2half_rn at f16, PyTorch's own).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "ndsc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;
constexpr int64_t kSumTile = 32768;                        // values a tile
constexpr int kF4PerThread = kSumTile / 4 / kThreads;      // 32
constexpr int kBatch = 8;                     // float4 loads in flight
constexpr int kFinishThreads = 1024;
constexpr int kUnroll = 2;                    // float4 groups a turn

// dtype codes of the C interface
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

// ---------------------------------------------------------------------------
// Values: 4 at a time (float4, or 4 bf16 / f16 in a uint2) and one at a time,
// converted to f32 exactly, stored rounded to nearest even
// ---------------------------------------------------------------------------
__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// f rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float f) {
  return bf16_bits_to_float(float_to_bf16_bits(f));
}

__device__ __forceinline__ float f16_bits_to_float(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}

__device__ __forceinline__ unsigned short float_to_f16_bits(float f) {
  return __half_as_ushort(__float2half_rn(f));
}

// f rounded to f16 and back
__device__ __forceinline__ float round_f16(float f) {
  return f16_bits_to_float(float_to_f16_bits(f));
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  using Raw = float4;
  static constexpr int kAlign = 16;
  __device__ static Raw load4(const float* p, int64_t i) {
    return __ldcs(reinterpret_cast<const float4*>(p) + i);
  }
  __device__ static void unpack(const Raw& r, float f[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  __device__ static void store4(float* p, int64_t i, const float f[4]) {
    __stcs(reinterpret_cast<float4*>(p) + i,
           make_float4(f[0], f[1], f[2], f[3]));
  }
  __device__ static float load1(const float* p, int64_t i) {
    return __ldcs(p + i);
  }
  __device__ static void store1(float* p, int64_t i, float f) {
    __stcs(p + i, f);
  }
  // the clip's product rounded to this dtype (the scale as given)
  __device__ static float scaled(float g, float s) { return __fmul_rn(g, s); }
  __device__ static float scale_operand(float s) { return s; }
};

// A 16-bit float: 4 values in a uint2 (64-bit loads); Bits converts.
template <typename T, typename Bits>
struct Io16 {
  using Raw = uint2;
  static constexpr int kAlign = 8;
  __device__ static Raw load4(const T* p, int64_t i) {
    return __ldcs(reinterpret_cast<const uint2*>(p) + i);
  }
  __device__ static void unpack(const Raw& r, float f[4]) {
    f[0] = Bits::to_float(static_cast<unsigned short>(r.x & 0xffffu));
    f[1] = Bits::to_float(static_cast<unsigned short>(r.x >> 16));
    f[2] = Bits::to_float(static_cast<unsigned short>(r.y & 0xffffu));
    f[3] = Bits::to_float(static_cast<unsigned short>(r.y >> 16));
  }
  __device__ static void store4(T* p, int64_t i, const float f[4]) {
    uint2 r;
    r.x = static_cast<unsigned>(Bits::from_float(f[0])) |
          (static_cast<unsigned>(Bits::from_float(f[1])) << 16);
    r.y = static_cast<unsigned>(Bits::from_float(f[2])) |
          (static_cast<unsigned>(Bits::from_float(f[3])) << 16);
    __stcs(reinterpret_cast<uint2*>(p) + i, r);
  }
  __device__ static float load1(const T* p, int64_t i) {
    return Bits::to_float(
        __ldcs(reinterpret_cast<const unsigned short*>(p) + i));
  }
  __device__ static void store1(T* p, int64_t i, float f) {
    __stcs(reinterpret_cast<unsigned short*>(p) + i, Bits::from_float(f));
  }
  // a product of two 16-bit floats is exact in f32, so one rounding, to T
  __device__ static float scaled(float g, float s) {
    return Bits::round(__fmul_rn(g, s));
  }
  __device__ static float scale_operand(float s) { return Bits::round(s); }
};

struct BF16Bits {
  __device__ static float to_float(unsigned short b) {
    return bf16_bits_to_float(b);
  }
  __device__ static unsigned short from_float(float f) {
    return float_to_bf16_bits(f);
  }
  __device__ static float round(float f) { return round_bf16(f); }
};

struct F16Bits {
  __device__ static float to_float(unsigned short b) {
    return f16_bits_to_float(b);
  }
  __device__ static unsigned short from_float(float f) {
    return float_to_f16_bits(f);
  }
  __device__ static float round(float f) { return round_f16(f); }
};

template <>
struct Io<__nv_bfloat16> : Io16<__nv_bfloat16, BF16Bits> {};

template <>
struct Io<__half> : Io16<__half, F16Bits> {};

template <typename T>
inline bool vec_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % Io<T>::kAlign == 0;
}

// ---------------------------------------------------------------------------
// sum_squares
// ---------------------------------------------------------------------------
struct LeafTable {
  const void* ptr[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t first[kMaxLeaves + 1];   // each leaf's first tile; first[count]
  int dtype[kMaxLeaves];           // a dtype code
  bool vec[kMaxLeaves];            // aligned for the vector loads
  int count;
};

__device__ __forceinline__ void add_squares(float& a, float f) {
  a = __fadd_rn(a, __fmul_rn(f, f));
}

// The sum of squares of tile `tile` of a leaf of n values, this thread's
// share: float4 j of the tile for j = tid, tid + 256, ... into one
// accumulator per lane, the leaf's last n % 4 values (in its last tile)
// into the first threads' lane 0.
template <typename T, bool kVec>
__device__ float tile_squares(const T* __restrict__ x, int64_t n,
                              int64_t tile, int64_t tiles) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  const int tid = threadIdx.x;
  if (kVec) {
    const int64_t n4 = n / 4;
    const int64_t base = tile * (kSumTile / 4);
    if (base + kSumTile / 4 <= n4) {
#pragma unroll
      for (int r = 0; r < kF4PerThread; r += kBatch) {
        typename Io<T>::Raw v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          v[k] = Io<T>::load4(x, base + (r + k) * kThreads + tid);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          float f[4];
          Io<T>::unpack(v[k], f);
#pragma unroll
          for (int l = 0; l < 4; ++l) add_squares(a[l], f[l]);
        }
      }
    } else {
      for (int64_t i = base + tid; i < n4; i += kThreads) {
        float f[4];
        Io<T>::unpack(Io<T>::load4(x, i), f);
#pragma unroll
        for (int l = 0; l < 4; ++l) add_squares(a[l], f[l]);
      }
    }
    if (tile == tiles - 1 && tid < n - 4 * n4)
      add_squares(a[0], Io<T>::load1(x, 4 * n4 + tid));
  } else {
    const int64_t stop = (tile + 1) * kSumTile;
    const int64_t end = stop < n ? stop : n;
    for (int64_t i = tile * kSumTile + tid; i < end; i += kThreads)
      add_squares(a[0], Io<T>::load1(x, i));
  }
  return __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
}

template <typename T>
__device__ __forceinline__ float leaf_tile(const void* x, bool vec, int64_t n,
                                           int64_t tile, int64_t tiles) {
  const T* xt = static_cast<const T*>(x);
  return vec ? tile_squares<T, true>(xt, n, tile, tiles)
             : tile_squares<T, false>(xt, n, tile, tiles);
}

__global__ void __launch_bounds__(kThreads)
    sum_squares_tile_kernel(const __grid_constant__ LeafTable t,
                            float* __restrict__ partials) {
  __shared__ float warp_sums[kThreads / 32];
  const int64_t tiles = t.first[t.count];
  int leaf = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (tile >= t.first[leaf + 1]) ++leaf;
    const int64_t local = tile - t.first[leaf];
    const int64_t leaf_tiles = t.first[leaf + 1] - t.first[leaf];
    float s;
    switch (t.dtype[leaf]) {
      case kF32:
        s = leaf_tile<float>(t.ptr[leaf], t.vec[leaf], t.n[leaf], local,
                             leaf_tiles);
        break;
      case kBF16:
        s = leaf_tile<__nv_bfloat16>(t.ptr[leaf], t.vec[leaf], t.n[leaf],
                                     local, leaf_tiles);
        break;
      default:
        s = leaf_tile<__half>(t.ptr[leaf], t.vec[leaf], t.n[leaf], local,
                              leaf_tiles);
    }
    // a butterfly leaves every lane the same sum (a + b == b + a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = warp_sums[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) b = __fadd_rn(b, warp_sums[w]);
      partials[tile] = b;
    }
    __syncthreads();
  }
}

// out[0] = the f64 sum of partials[0 .. count), rounded once to f32: each
// thread its strided share, then a fixed tree.
__global__ void __launch_bounds__(kFinishThreads)
    sum_squares_finish_kernel(const float* __restrict__ partials,
                              int64_t count, float* __restrict__ out) {
  __shared__ double warp_sums[kFinishThreads / 32];
  double acc = 0.0;
#pragma unroll 8
  for (int64_t i = threadIdx.x; i < count; i += kFinishThreads)
    acc = __dadd_rn(acc, static_cast<double>(partials[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __dadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    double s = warp_sums[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (threadIdx.x == 0) out[0] = __double2float_rn(s);
  }
}

ndsc::LaunchCache g_tile_blocks;

// ---------------------------------------------------------------------------
// adamw_update
// ---------------------------------------------------------------------------
struct AdamWConsts {
  float b1, omb1, b2, omb2, eps, wd;
};

// One value: mu' = b1*mu + (1-b1)*g; nu' = b2*nu + (1-b2)*g*g;
// u = -lr * ((mu'/c1) / (sqrt(nu'/c2) + eps) + wd*p)
__device__ __forceinline__ void adamw_one(float g, float m, float v, float p,
                                          const AdamWConsts& k, float neg_lr,
                                          float c1, float c2, float& m2,
                                          float& v2, float& u) {
  m2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v2 = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2)), k.eps);
  const float x = __fadd_rn(__fdiv_rn(__fdiv_rn(m2, c1), den),
                            __fmul_rn(k.wd, p));
  u = __fmul_rn(neg_lr, x);
}

template <typename TG, typename TP, bool kVec>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(const TG* __restrict__ g, const float* __restrict__ mu,
                        const float* __restrict__ nu,
                        const TP* __restrict__ p, float* __restrict__ mu_out,
                        float* __restrict__ nu_out, TP* __restrict__ u_out,
                        int64_t n, const float* __restrict__ lr,
                        const float* __restrict__ c1p,
                        const float* __restrict__ c2p,
                        const float* __restrict__ scale,
                        const AdamWConsts k) {
  const float neg_lr = -*lr, c1 = *c1p, c2 = *c2p;
  const bool clip = scale != nullptr;
  const float s = clip ? Io<TG>::scale_operand(*scale) : 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (kVec) {
    const int64_t n4 = n / 4;
    for (int64_t i0 = start; i0 < n4; i0 += kUnroll * stride) {
      typename Io<TG>::Raw gr[kUnroll];
      float4 mr[kUnroll], vr[kUnroll];
      typename Io<TP>::Raw pr[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = i0 + j * stride;
        if (i < n4) {
          gr[j] = Io<TG>::load4(g, i);
          mr[j] = __ldcs(reinterpret_cast<const float4*>(mu) + i);
          vr[j] = __ldcs(reinterpret_cast<const float4*>(nu) + i);
          pr[j] = Io<TP>::load4(p, i);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = i0 + j * stride;
        if (i < n4) {
          float gf[4], pf[4], m2[4], v2[4], u[4];
          Io<TG>::unpack(gr[j], gf);
          Io<TP>::unpack(pr[j], pf);
          const float mf[4] = {mr[j].x, mr[j].y, mr[j].z, mr[j].w};
          const float vf[4] = {vr[j].x, vr[j].y, vr[j].z, vr[j].w};
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const float gl = clip ? Io<TG>::scaled(gf[l], s) : gf[l];
            adamw_one(gl, mf[l], vf[l], pf[l], k, neg_lr, c1, c2, m2[l],
                      v2[l], u[l]);
          }
          Io<float>::store4(mu_out, i, m2);
          Io<float>::store4(nu_out, i, v2);
          Io<TP>::store4(u_out, i, u);
        }
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
      const int64_t i = 4 * n4 + threadIdx.x;
      const float gf = Io<TG>::load1(g, i);
      float m2, v2, u;
      adamw_one(clip ? Io<TG>::scaled(gf, s) : gf, Io<float>::load1(mu, i),
                Io<float>::load1(nu, i), Io<TP>::load1(p, i), k, neg_lr, c1,
                c2, m2, v2, u);
      Io<float>::store1(mu_out, i, m2);
      Io<float>::store1(nu_out, i, v2);
      Io<TP>::store1(u_out, i, u);
    }
  } else {
    for (int64_t i = start; i < n; i += stride) {
      const float gf = Io<TG>::load1(g, i);
      float m2, v2, u;
      adamw_one(clip ? Io<TG>::scaled(gf, s) : gf, Io<float>::load1(mu, i),
                Io<float>::load1(nu, i), Io<TP>::load1(p, i), k, neg_lr, c1,
                c2, m2, v2, u);
      Io<float>::store1(mu_out, i, m2);
      Io<float>::store1(nu_out, i, v2);
      Io<TP>::store1(u_out, i, u);
    }
  }
}

// ---------------------------------------------------------------------------
// sgd_update
// ---------------------------------------------------------------------------
// mode 0: u = -lr*g; 1: vel' = momentum*vel + g, u = -lr*vel';
// 2 (Nesterov): vel' as 1, u = -lr*(momentum*vel' + g)
__device__ __forceinline__ void sgd_one(float g, float v, int mode,
                                        float momentum, float neg_lr,
                                        float& v2, float& u) {
  if (mode == 0) {
    u = __fmul_rn(neg_lr, g);
    return;
  }
  v2 = __fadd_rn(__fmul_rn(momentum, v), g);
  u = __fmul_rn(neg_lr,
                mode == 1 ? v2 : __fadd_rn(__fmul_rn(momentum, v2), g));
}

template <typename TG, typename TU, bool kVec>
__global__ void __launch_bounds__(kThreads)
    sgd_update_kernel(const TG* __restrict__ g, const float* __restrict__ vel,
                      float* __restrict__ vel_out, TU* __restrict__ u_out,
                      int64_t n, const float* __restrict__ lr,
                      const float* __restrict__ scale, int mode,
                      float momentum) {
  const float neg_lr = -*lr;
  const bool clip = scale != nullptr;
  const float s = clip ? Io<TG>::scale_operand(*scale) : 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (kVec) {
    const int64_t n4 = n / 4;
    for (int64_t i0 = start; i0 < n4; i0 += kUnroll * stride) {
      typename Io<TG>::Raw gr[kUnroll];
      float4 vr[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = i0 + j * stride;
        if (i < n4) {
          gr[j] = Io<TG>::load4(g, i);
          if (mode) vr[j] = __ldcs(reinterpret_cast<const float4*>(vel) + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = i0 + j * stride;
        if (i < n4) {
          float gf[4], v2[4], u[4];
          Io<TG>::unpack(gr[j], gf);
          const float vf[4] = {mode ? vr[j].x : 0.f, mode ? vr[j].y : 0.f,
                               mode ? vr[j].z : 0.f, mode ? vr[j].w : 0.f};
#pragma unroll
          for (int l = 0; l < 4; ++l)
            sgd_one(clip ? Io<TG>::scaled(gf[l], s) : gf[l], vf[l], mode,
                    momentum, neg_lr, v2[l], u[l]);
          if (mode) Io<float>::store4(vel_out, i, v2);
          Io<TU>::store4(u_out, i, u);
        }
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
      const int64_t i = 4 * n4 + threadIdx.x;
      const float gf = Io<TG>::load1(g, i);
      float v2, u;
      sgd_one(clip ? Io<TG>::scaled(gf, s) : gf,
              mode ? Io<float>::load1(vel, i) : 0.f, mode, momentum, neg_lr,
              v2, u);
      if (mode) Io<float>::store1(vel_out, i, v2);
      Io<TU>::store1(u_out, i, u);
    }
  } else {
    for (int64_t i = start; i < n; i += stride) {
      const float gf = Io<TG>::load1(g, i);
      float v2, u;
      sgd_one(clip ? Io<TG>::scaled(gf, s) : gf,
              mode ? Io<float>::load1(vel, i) : 0.f, mode, momentum, neg_lr,
              v2, u);
      if (mode) Io<float>::store1(vel_out, i, v2);
      Io<TU>::store1(u_out, i, u);
    }
  }
}

// A persistent grid over `work` items of kThreads threads: at most the
// blocks of `kernel` that fit on the card at once.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int64_t work, ndsc::LaunchCache* c,
                     unsigned* grid) {
  int fit = 0;
  cudaError_t rc = ndsc::persistent_blocks(kernel, kThreads, 0, c, &fit);
  if (rc != cudaSuccess) return rc;
  const int64_t want = (work + kThreads - 1) / kThreads;
  *grid = static_cast<unsigned>(want < fit ? (want > 0 ? want : 1) : fit);
  return cudaSuccess;
}

template <typename TG, typename TP>
cudaError_t launch_adamw(const void* g, const float* mu, const float* nu,
                         const void* p, float* mu_out, float* nu_out,
                         void* u_out, int64_t n, const float* lr,
                         const float* c1, const float* c2, const float* scale,
                         const AdamWConsts& k, cudaStream_t stream) {
  static ndsc::LaunchCache cache_vec, cache_scalar;
  const bool vec = vec_aligned<TG>(g) && vec_aligned<float>(mu) &&
                   vec_aligned<float>(nu) && vec_aligned<TP>(p) &&
                   vec_aligned<float>(mu_out) && vec_aligned<float>(nu_out) &&
                   vec_aligned<TP>(u_out);
  unsigned grid = 0;
  cudaError_t rc;
  const TG* gt = static_cast<const TG*>(g);
  const TP* pt = static_cast<const TP*>(p);
  TP* ut = static_cast<TP*>(u_out);
  if (vec) {
    auto kernel = adamw_update_kernel<TG, TP, true>;
    rc = grid_for(kernel, n / 4, &cache_vec, &grid);
    if (rc != cudaSuccess) return rc;
    kernel<<<grid, kThreads, 0, stream>>>(gt, mu, nu, pt, mu_out, nu_out, ut,
                                          n, lr, c1, c2, scale, k);
  } else {
    auto kernel = adamw_update_kernel<TG, TP, false>;
    rc = grid_for(kernel, n, &cache_scalar, &grid);
    if (rc != cudaSuccess) return rc;
    kernel<<<grid, kThreads, 0, stream>>>(gt, mu, nu, pt, mu_out, nu_out, ut,
                                          n, lr, c1, c2, scale, k);
  }
  return cudaGetLastError();
}

template <typename TG, typename TU>
cudaError_t launch_sgd(const void* g, const float* vel, float* vel_out,
                       void* u_out, int64_t n, const float* lr,
                       const float* scale, int mode, float momentum,
                       cudaStream_t stream) {
  static ndsc::LaunchCache cache_vec, cache_scalar;
  const bool vec = vec_aligned<TG>(g) && vec_aligned<TU>(u_out) &&
                   (mode == 0 || (vec_aligned<float>(vel) &&
                                  vec_aligned<float>(vel_out)));
  unsigned grid = 0;
  cudaError_t rc;
  const TG* gt = static_cast<const TG*>(g);
  TU* ut = static_cast<TU*>(u_out);
  if (vec) {
    auto kernel = sgd_update_kernel<TG, TU, true>;
    rc = grid_for(kernel, n / 4, &cache_vec, &grid);
    if (rc != cudaSuccess) return rc;
    kernel<<<grid, kThreads, 0, stream>>>(gt, vel, vel_out, ut, n, lr, scale,
                                          mode, momentum);
  } else {
    auto kernel = sgd_update_kernel<TG, TU, false>;
    rc = grid_for(kernel, n, &cache_scalar, &grid);
    if (rc != cudaSuccess) return rc;
    kernel<<<grid, kThreads, 0, stream>>>(gt, vel, vel_out, ut, n, lr, scale,
                                          mode, momentum);
  }
  return cudaGetLastError();
}

bool valid_dtype(int d) { return d == kF32 || d == kBF16 || d == kF16; }

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}) for the C type T of dtype code `d` (a valid one)
template <typename F>
cudaError_t with_dtype(int d, F&& f) {
  if (d == kF32) return f(Type<float>{});
  if (d == kBF16) return f(Type<__nv_bfloat16>{});
  return f(Type<__half>{});
}

// The partials (tiles) of a leaf of n values.
int64_t tiles_of(int64_t n) { return (n + kSumTile - 1) / kSumTile; }

}  // namespace

// out[0] (f32) = the sum of squares of `count` leaves: ptrs[i] holds
// lens[i] values of dtype dtypes[i] (0 f32, 1 bf16, 2 f16). partials:
// n_partials f32 of scratch, one per tile of kSumTile values of each leaf
// (the sum of tiles_of(lens[i])). One tile launch per kMaxLeaves leaves
// that hold a value, then the finishing launch. Returns
// cudaGetLastError().
extern "C" int repro_sum_squares(const void* const* ptrs, const int64_t* lens,
                                 const int* dtypes, int count,
                                 float* partials, int64_t n_partials,
                                 float* out, cudaStream_t stream) {
  if (count < 0) return cudaErrorInvalidValue;
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (lens[i] < 0 || !valid_dtype(dtypes[i])) return cudaErrorInvalidValue;
    total += tiles_of(lens[i]);
  }
  if (total != n_partials) return cudaErrorInvalidValue;
  int64_t offset = 0;
  for (int lo = 0; lo < count; lo += kMaxLeaves) {
    LeafTable t;
    t.count = count - lo < kMaxLeaves ? count - lo : kMaxLeaves;
    t.first[0] = 0;
    for (int j = 0; j < t.count; ++j) {
      const int i = lo + j;
      t.ptr[j] = ptrs[i];
      t.n[j] = lens[i];
      t.dtype[j] = dtypes[i];
      t.vec[j] = dtypes[i] == kF32 ? vec_aligned<float>(ptrs[i])
                                   : vec_aligned<__half>(ptrs[i]);
      t.first[j + 1] = t.first[j] + tiles_of(lens[i]);
    }
    const int64_t tiles = t.first[t.count];
    if (tiles == 0) continue;
    int fit = 0;
    cudaError_t rc = ndsc::persistent_blocks(sum_squares_tile_kernel,
                                             kThreads, 0, &g_tile_blocks,
                                             &fit);
    if (rc != cudaSuccess) return rc;
    const unsigned grid = static_cast<unsigned>(tiles < fit ? tiles : fit);
    sum_squares_tile_kernel<<<grid, kThreads, 0, stream>>>(t,
                                                           partials + offset);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    offset += tiles;
  }
  sum_squares_finish_kernel<<<1, kFinishThreads, 0, stream>>>(
      partials, n_partials, out);
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step over a leaf of n values: g (g_dtype), p and u (p_dtype),
// mu, nu, mu_out, nu_out f32; lr, c1, c2 and the optional scale (null: no
// clip) 0-d f32 device tensors; the constants already rounded to f32.
extern "C" int repro_adamw_update(const void* g, int g_dtype, const float* mu,
                                  const float* nu, const void* p, int p_dtype,
                                  float* mu_out, float* nu_out, void* u_out,
                                  int64_t n, const float* lr, const float* c1,
                                  const float* c2, const float* scale,
                                  float b1, float omb1, float b2, float omb2,
                                  float eps, float wd, cudaStream_t stream) {
  if (!valid_dtype(g_dtype) || !valid_dtype(p_dtype) || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const AdamWConsts k{b1, omb1, b2, omb2, eps, wd};
  return static_cast<int>(with_dtype(g_dtype, [&](auto tg) {
    return with_dtype(p_dtype, [&](auto tp) {
      return launch_adamw<typename decltype(tg)::type,
                          typename decltype(tp)::type>(
          g, mu, nu, p, mu_out, nu_out, u_out, n, lr, c1, c2, scale, k,
          stream);
    });
  }));
}

// One SGD step over a leaf of n values: g (g_dtype), u (u_dtype); mode 0
// plain (vel, vel_out null), 1 momentum, 2 Nesterov (vel, vel_out f32);
// lr and the optional scale 0-d f32 device tensors.
extern "C" int repro_sgd_update(const void* g, int g_dtype, const float* vel,
                                float* vel_out, void* u_out, int u_dtype,
                                int64_t n, const float* lr,
                                const float* scale, int mode, float momentum,
                                cudaStream_t stream) {
  if (!valid_dtype(g_dtype) || !valid_dtype(u_dtype) || n < 0 || mode < 0 ||
      mode > 2 || (mode && (vel == nullptr || vel_out == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  return static_cast<int>(with_dtype(g_dtype, [&](auto tg) {
    return with_dtype(u_dtype, [&](auto tu) {
      return launch_sgd<typename decltype(tg)::type,
                        typename decltype(tu)::type>(
          g, vel, vel_out, u_out, n, lr, scale, mode, momentum, stream);
    });
  }));
}
