// Shared helpers for the port's CUDA kernels: element-type conversion,
// warp reductions, tile loads into shared memory, `cp.async` copies and
// the bf16 tensor-core fragment helpers. Every kernel accumulates in fp32
// whatever its storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rtt {

constexpr float kNegInf = -1e30f;   // the TPU kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// 2^x by the hardware's approximation (ex2.approx); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over `width` consecutive lanes (a power of two <= 32).
template <int width>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [row0, row0 + R) of a (rows, stride) array of T, D columns
// each, into a float tile in shared memory with row stride DST; rows at
// or past `nrows` read as 0. Every load is a 16-byte vector, and all of
// a thread's loads are issued before the first store. `Threads` threads
// of the CTA take part.
template <typename T, int D, int R, int DST, int Threads>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long stride, int row0, int nrows,
                                          float* dst, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int kTotal = R * kVecPerRow;
  constexpr int kPer = (kTotal + Threads - 1) / Threads;
  uint4 reg[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int vi = tid + Threads * i;
    const int r = vi / kVecPerRow;
    reg[i] = make_uint4(0, 0, 0, 0);
    if (vi < kTotal && row0 + r < nrows)
      reg[i] = *reinterpret_cast<const uint4*>(
          src + (row0 + r) * stride + (vi % kVecPerRow) * kVec);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int vi = tid + Threads * i;
    if (vi >= kTotal) continue;
    const int r = vi / kVecPerRow;
    const int d0 = (vi % kVecPerRow) * kVec;
    const T* x = reinterpret_cast<const T*>(&reg[i]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * DST + d0 + e] = to_f32(x[e]);
  }
}

// ---- cp.async: 16-byte copies from device to shared memory -------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread's copies are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- bf16 tensor-core helpers (mma.sync.m16n8k16) -----------------------
//
// With g = lane / 4 and t = lane % 4, an m16n8k16 fragment gives the
// thread rows g and g+8 and columns 2t, 2t+1 (+8 for the second half of
// A and of B's k range); the fp32 accumulator holds C[g][2t..2t+1] in
// c[0..1] and C[g+8][2t..2t+1] in c[2..3].

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + R) of a (rows, stride) bf16 array, D columns each,
// into shared memory with row stride DS; rows at or past `nrows` are 0.
template <int D, int R, int DS, int Threads>
__device__ __forceinline__ void copy_tile_bf16(
    const __nv_bfloat16* __restrict__ src, long stride, int row0, int nrows,
    __nv_bfloat16* dst, int tid) {
  constexpr int kVecPerRow = D / 8;
  constexpr int kTotal = R * kVecPerRow;
  constexpr int kPer = (kTotal + Threads - 1) / Threads;
  uint4 reg[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int vi = tid + Threads * i;
    const int r = vi / kVecPerRow;
    reg[i] = make_uint4(0, 0, 0, 0);
    if (vi < kTotal && row0 + r < nrows)
      reg[i] = *reinterpret_cast<const uint4*>(
          src + (row0 + r) * stride + (vi % kVecPerRow) * 8);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int vi = tid + Threads * i;
    if (vi >= kTotal) continue;
    const int r = vi / kVecPerRow;
    *reinterpret_cast<uint4*>(dst + r * DS + (vi % kVecPerRow) * 8) = reg[i];
  }
}

}  // namespace rtt
