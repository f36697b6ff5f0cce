// K4: fused RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/rmsnorm.py
// `_rmsnorm_kernel` (launched by `_fwd`). Python wrapper:
// ray_tpu_torch/ops/kernels/rmsnorm.py.
//
// What it computes, as the Pallas kernel does: for each row of x
// (rows, d), y = (x * 1 / sqrt(mean(x^2) + eps)) * w, with the sum of
// squares and every product in fp32 whatever the storage type, and y
// cast to x's type. x and y are float32, bfloat16 or float16; w is any of
// the three, independently of x.
//
// What bounds it on the card: about 4 operations per element against 4
// bytes an element in bf16 (x read once, y written once), far below the
// H100's ~295 operations a byte: the bound is the bytes of x and y. What
// the design does about it: x is read and y written as 16-byte vectors,
// neighbouring lanes on neighbouring addresses, wherever a row is 16-byte
// aligned. Where a row is at most 512 such vectors (4096 bf16 values,
// 2048 fp32), each lane holds its share of the row in registers (up to
// 16 vectors, all loads issued before the sum), so x is read from device
// memory once and written from the registers. A wider row takes a second
// pass that re-reads it from L1/L2. Nothing is padded or staged through
// shared memory.
//
// Differences from the TPU grid: the Pallas kernel pads the rows to a
// multiple of block_rows and streams (block_rows, d) tiles through VMEM,
// one grid step after another. Here one warp owns one row (8 rows per
// 256-thread CTA, all CTAs in parallel): its lanes sum their squares, a
// shuffle reduction gives every lane the row's mean, then the lanes scale
// and write. Warps past the last row exit, so nothing is padded. A row
// whose width is not a multiple of 16 bytes, or an unaligned tensor,
// takes the two-pass loops with scalar loads.
//
// Layouts: x, y (rows, d) contiguous; w (d,). It allocates nothing and
// runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                    // rows per CTA
constexpr int kThreads = 32 * kWarps;

template <typename TX, typename TW, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, long long rows, int d, float eps) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;                   // the whole warp leaves
  const int lane = threadIdx.x % 32;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  constexpr int kVecElems = 16 / sizeof(TX);

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kVecElems; i += 32) {
      const uint4 u = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&u);
#pragma unroll
      for (int j = 0; j < kVecElems; ++j) {
        const float f = rtt::to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = rtt::to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = rtt::group_sum<32>(ss);
  // 1 / sqrtf rounds correctly; rsqrtf is within 2 ulp
  const float inv = 1.f / sqrtf(ss / (float)d + eps);

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / kVecElems; i += 32) {
      const uint4 u = xv[i];
      const TX* e = reinterpret_cast<const TX*>(&u);
      uint4 o;
      TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
      for (int j = 0; j < kVecElems; ++j)
        oe[j] = rtt::from_f32<TX>(rtt::to_f32(e[j]) * inv *
                                  rtt::to_f32(w[i * kVecElems + j]));
      yv[i] = o;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = rtt::from_f32<TX>(rtt::to_f32(xr[i]) * inv * rtt::to_f32(w[i]));
  }
}

// A row of at most 32 * NV 16-byte vectors: lane l holds vectors l,
// l + 32, ... in registers, so the row is read once.
template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_reg_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ y, long long rows, int d, float eps) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;                   // the whole warp leaves
  const int lane = threadIdx.x % 32;
  constexpr int kVecElems = 16 / sizeof(TX);
  const int nvec = d / kVecElems;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yv = reinterpret_cast<uint4*>(y + row * d);

  uint4 u[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    u[k] = i < nvec ? xv[i] : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const TX* e = reinterpret_cast<const TX*>(&u[k]);
#pragma unroll
    for (int j = 0; j < kVecElems; ++j) {
      const float f = rtt::to_f32(e[j]);
      ss += f * f;
    }
  }
  ss = rtt::group_sum<32>(ss);
  const float inv = 1.f / sqrtf(ss / (float)d + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i >= nvec) continue;
    const TX* e = reinterpret_cast<const TX*>(&u[k]);
    uint4 o;
    TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
    for (int j = 0; j < kVecElems; ++j)
      oe[j] = rtt::from_f32<TX>(rtt::to_f32(e[j]) * inv *
                                rtt::to_f32(w[i * kVecElems + j]));
    yv[i] = o;
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec = (d * sizeof(TX)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  const dim3 grid((unsigned)blocks);
  // 16-byte vectors each lane holds; the kernel with the next power of
  // two takes the row
  const int per_lane = (d / (int)(16 / sizeof(TX)) + 31) / 32;
  if (!vec)
    rmsnorm_kernel<TX, TW, false><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else if (per_lane <= 1)
    rmsnorm_reg_kernel<TX, TW, 1><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else if (per_lane <= 2)
    rmsnorm_reg_kernel<TX, TW, 2><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else if (per_lane <= 4)
    rmsnorm_reg_kernel<TX, TW, 4><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else if (per_lane <= 8)
    rmsnorm_reg_kernel<TX, TW, 8><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else if (per_lane <= 16)
    rmsnorm_reg_kernel<TX, TW, 16><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else
    rmsnorm_kernel<TX, TW, true><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_weight(int w_dtype, const void* x, const void* w, void* y,
                      long long rows, int d, float eps, cudaStream_t st) {
  switch (w_dtype) {
    case 0: return launch<TX, float>(x, w, y, rows, d, eps, st);
    case 1: return launch<TX, __nv_bfloat16>(x, w, y, rows, d, eps, st);
    case 2: return launch<TX, __half>(x, w, y, rows, d, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t
// (0 = launched, or nothing to do for rows == 0).
extern "C" int rtt_rmsnorm(const void* x, const void* w, void* y,
                           long long rows, int d, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  if (rows < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return (int)by_weight<float>(w_dtype, x, w, y, rows, d, eps, st);
    case 1:
      return (int)by_weight<__nv_bfloat16>(w_dtype, x, w, y, rows, d, eps, st);
    case 2: return (int)by_weight<__half>(w_dtype, x, w, y, rows, d, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
