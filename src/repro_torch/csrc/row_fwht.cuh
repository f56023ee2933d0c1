// The FWHT of a contiguous row of 2^14 or 2^15 floats held in the registers
// of one block, and the TMA helpers that stage a row into shared memory.
// Shared by quantencode.cu (encode_row_kernel) and fwht.cu (fwht_row_kernel;
// fwht_cols_kernel takes its register stages).
//
// Layouts of a row of N = 2^LOG2N floats, T = N/32 threads with kRowV = 32
// values each:
//   A (loads): thread (warp w, lane l) holds the float4 groups j = 0..7 at
//     positions 4l + 128j + 1024w; register 4j + c is position
//     4l + 128j + 1024w + c. Position bits 0-1 and 7-9 are register bits,
//     bits 2-6 the lane, bits 10.. the warp.
//   B: thread t holds positions t + T*r, r = 0..31: bits 0..log2(T)-1 are
//     the thread, the rest register bits.
// fwht_low runs bits 0-1 in registers, 2-6 across the warp (one
// __shfl_xor_sync and one fma by +-1 per value: p + v*(+-1) rounds once,
// as the pair's a + b or a - b), 7-9 in registers; to_b is the exchange
// (float4 stores in A, scalar loads in B, both free of bank conflicts);
// fwht_high runs bits 10..LOG2N-1 in registers. Each stage is ref.fwht's
// radix-2 stage on the bits it owns, in increasing order, so the result
// is ref.fwht's before its final multiply by f32(1/sqrt(N)), which the
// caller makes.
#pragma once

#include <cstdint>

#include "warp_rows.cuh"

namespace ndsc {

constexpr int kRowV = 32;                 // values per thread

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the barrier's phase, expecting `bytes` of bulk copies
// (issued by any thread before or after it).
__device__ inline void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global src into shared dst, completing its bytes on `bar`; it does not
// arrive.
__device__ inline void bulk_copy(float* dst, const float* src, int bytes,
                                 uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: the barrier's arrival and one bulk copy into it.
__device__ inline void bulk_load(float* dst, const float* src, int bytes,
                                 uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ inline void butterfly(float& a, float& b) {
  const float x = a;
  a = __fadd_rn(x, b);
  b = __fsub_rn(x, b);
}

// ref.fwht's stages on the register bits of v whose strides are
// FIRST, 2*FIRST, ... below LAST: register i pairs with i + h.
template <int FIRST, int LAST, int R>
__device__ inline void register_stages(float (&v)[R]) {
#pragma unroll
  for (int h = FIRST; h < LAST; h <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if ((i & h) == 0) butterfly(v[i], v[i + h]);
  }
}

// Position bits 0-9 of the row in layout A: register stages for bits 0-1
// (register stride 1, 2), lane stages for bits 2-6, register stages for
// bits 7-9 (register stride 4, 8, 16).
__device__ inline void fwht_low(float (&v)[kRowV], int lane) {
  register_stages<1, 4>(v);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    // the partner holds position ^ 4o; the lower keeps b + a, the upper
    // a + (-b): one rounding each, as ref.fwht's pair
    const float sgn = (lane & o) ? -1.0f : 1.0f;
#pragma unroll
    for (int i = 0; i < kRowV; ++i) {
      const float p = __shfl_xor_sync(kFullMask, v[i], o);
      v[i] = __fmaf_rn(v[i], sgn, p);
    }
  }
  register_stages<4, kRowV>(v);
}

// Position bits 10..LOG2N-1 in layout B (register bit q is position bit
// LOG2N - 5 + q).
template <int LOG2N>
__device__ inline void fwht_high(float (&v)[kRowV]) {
  register_stages<1 << (15 - LOG2N), kRowV>(v);
}

template <int R>
__device__ inline void scale_values(float (&v)[R], float m) {
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = __fmul_rn(v[i], m);
}

// Layout A -> B through buf (the caller synchronizes before buf is written
// again).
template <int T>
__device__ inline void to_b(float (&v)[kRowV], float* buf, int a0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(buf + a0 + 128 * j) =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRowV; ++r) v[r] = buf[threadIdx.x + T * r];
}

// Layout B -> A through buf (the caller synchronizes before buf is written
// again).
template <int T>
__device__ inline void to_a(float (&v)[kRowV], float* buf, int a0) {
#pragma unroll
  for (int r = 0; r < kRowV; ++r) buf[threadIdx.x + T * r] = v[r];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 t = *reinterpret_cast<const float4*>(buf + a0 + 128 * j);
    v[4 * j] = t.x;
    v[4 * j + 1] = t.y;
    v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}

// The thread's 8 float4 groups of layout A, src pointing at its group 0
// (16-byte aligned).
__device__ inline void load_a(float (&v)[kRowV], const float* src) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 t = *reinterpret_cast<const float4*>(src + 128 * j);
    v[4 * j] = t.x, v[4 * j + 1] = t.y, v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}

// v times the thread's layout-A values at src (as load_a's), one rounding
// each.
__device__ inline void mul_a(float (&v)[kRowV], const float* src) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 g = *reinterpret_cast<const float4*>(src + 128 * j);
    v[4 * j] = __fmul_rn(v[4 * j], g.x);
    v[4 * j + 1] = __fmul_rn(v[4 * j + 1], g.y);
    v[4 * j + 2] = __fmul_rn(v[4 * j + 2], g.z);
    v[4 * j + 3] = __fmul_rn(v[4 * j + 3], g.w);
  }
}

template <int LOG2N>
struct RowShape {
  static constexpr int N = 1 << LOG2N;
  static constexpr int T = N / kRowV;                   // 512 or 1024
  static constexpr int STAGE = N / 2;     // the next row's first half
  static constexpr int SMEM = (N + STAGE) * static_cast<int>(sizeof(float));
  // blocks per SM: two of 96 KB at 2^14; at 2^15 the 192 KB leave no room
  static constexpr int BLOCKS = LOG2N == 14 ? 2 : 1;
};

}  // namespace ndsc
