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
// H100's ~295 operations a byte: the bound is the bytes of x and y. The
// weight is d values, read again for every row: held in registers or
// read with scalar loads per row, it costs more load instructions and
// cache traffic than x itself (an fp32 weight is twice a bf16 row).
//
// What the design does about it (the ring route, every row that is a
// whole number of 16-byte vectors at 16-byte aligned x and y, and fits):
//  * A persistent grid: at most as many CTAs as the card holds at once,
//    from its SM count and the occupancy one CTA's shared memory allows
//    (`ring_plan`, on the host). Warp w of CTA c takes blocks of R
//    consecutive rows c + G w, c + G w + G W, ... (G CTAs of W warps),
//    so the first G W blocks spread over every SM.
//  * The weight in shared memory: each CTA stages it once, converted to
//    fp32, as V/4 planes of float4 (V = elements of a 16-byte vector of
//    x): plane p holds weights 4p..4p+3 of every vector, so the lanes of
//    a warp read consecutive 16-byte words, free of bank conflicts. The
//    staging reads 16-byte vectors, four a thread issued before the
//    first is stored, so it costs about one trip to device memory while
//    the first rows are in flight (staged by scalar loads, four trips,
//    K4 took 0.0332 ms at x (4096, 4096) bf16 and 0.0134 ms at (8, 4096)
//    against 0.0288 and 0.0077 so: tools/rmsnorm_ab.py, NVIDIA H100 80GB
//    HBM3, 700 W).
//  * Each warp streams its blocks through its own ring of S stages in
//    shared memory: a block of consecutive rows is one contiguous byte
//    range, so one 1-D bulk copy (`cp.async.bulk`, completing on the
//    stage's mbarrier) fills a stage. While the warp reduces and writes
//    one block, the next S - 1 are in flight; the warp refills a stage
//    as soon as it has read it. Warps never wait for each other after
//    the weight is staged.
//  * A row is read from device memory once; its two passes (sum of
//    squares, then scale) read the stage.
//  * y leaves as 16-byte vector stores from registers, neighbouring
//    lanes on neighbouring addresses: faster than writing y back into
//    the stage and sending it by a bulk store (RMSNORM_BULK_STORE=1),
//    whose refill of the stage waits for the store to leave shared
//    memory. In one run of tools/rmsnorm_ab.py (NVIDIA H100 80GB HBM3,
//    700 W) at x (4096, 4096) bf16, fp32 weight: 0.0288 ms as built (8
//    warps, 3 stages of 8 KB), 0.0300 with the bulk store, 0.0300 with 2
//    stages, 0.0312 with 4 (4 warps a CTA then fit), 0.0287 with 4 warps
//    a CTA (two CTAs an SM), 0.0307 with 16 KB stages.
// Few rows (a decode step's 8) take one row a stage and one CTA a
// block, so they spread over as many SMs as there are rows.
//
// The routes that stay, by shape: a row too wide for the ring (the fp32
// weight and two stages of one row past the shared memory a CTA may
// have: fp32 past ~19k values, bf16 past ~29k) takes the two-pass loop,
// one warp a row, reading the row twice (the second time from L1/L2); a
// row that is not a whole number of 16-byte vectors, or an unaligned x
// or y, takes the same loops with scalar loads.
//
// Differences from the TPU grid: the Pallas kernel pads the rows to a
// multiple of block_rows and streams (block_rows, d) tiles through VMEM,
// one grid step after another. Here the CTAs run in parallel, each warp
// owning whole rows: its lanes sum their squares, a shuffle reduction
// gives every lane the row's mean, then the lanes scale and write.
// Nothing is padded: the last block of rows is short, and its copy too.
//
// Layouts: x, y (rows, d) contiguous; w (d,). It allocates nothing and
// runs on the caller's stream.

#include <algorithm>

#include "hopper.cuh"

// Design choices of the ring route; tools/rmsnorm_ab.py builds the
// other values with -D.
#ifndef RMSNORM_WARPS
#define RMSNORM_WARPS 8          // warps of a CTA, at most
#endif
#ifndef RMSNORM_STAGES
#define RMSNORM_STAGES 3         // stages of each warp's ring
#endif
#ifndef RMSNORM_STAGE_BYTES
#define RMSNORM_STAGE_BYTES 8192 // bytes of x a stage aims at (whole rows)
#endif
#ifndef RMSNORM_BULK_STORE
#define RMSNORM_BULK_STORE 0     // 1: y from the stage by a bulk store
#endif

namespace {

constexpr int kWarps = 8;                    // two-pass route: rows a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = RMSNORM_STAGES;

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

// Shared memory of the ring route: the fp32 weight, then each warp's
// kStages stages of `rows_per_stage` rows, then each warp's kStages
// mbarriers.
size_t ring_smem(int d, int x_bytes, int warps, int rows_per_stage) {
  const size_t stage = (size_t)rows_per_stage * d * x_bytes;
  return (size_t)d * 4 + (size_t)warps * kStages * (stage + 8);
}

// The ring route (see the note above). Launched with ring_smem(...)
// bytes of dynamic shared memory and blockDim.x = 32 * warps; w_vec: w
// is 16-byte aligned and a whole number of 16-byte vectors.
template <typename TX, typename TW>
__global__ void __launch_bounds__(32 * RMSNORM_WARPS)
rmsnorm_ring_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ y, long long rows, int d, float eps,
                    int rows_per_stage, int w_vec) {
  constexpr int kV = 16 / sizeof(TX);        // elements of a vector
  constexpr int kPlanes = kV / 4;            // float4 planes of the weight
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = d / kV;
  const int R = rows_per_stage;
  const size_t row_bytes = (size_t)d * sizeof(TX);
  const size_t stage_bytes = R * row_bytes;
  float* wf = reinterpret_cast<float*>(smem);
  float4* wp = reinterpret_cast<float4*>(smem);
  unsigned char* ring = smem + (size_t)d * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(
                       ring + (size_t)warps * kStages * stage_bytes) +
                   warp * kStages;
  ring += (size_t)warp * kStages * stage_bytes;

  const long long nblk = (rows + R - 1) / R;
  const long long first = (long long)warp * gridDim.x + blockIdx.x;
  const long long step = (long long)warps * gridDim.x;
  // one bulk copy of block `blk` (R rows, fewer in the last) into stage s
  auto fill = [&](int s, long long blk) {
    const long long r0 = blk * R;
    const uint32_t bytes =
        (uint32_t)(min((long long)R, rows - r0) * (long long)row_bytes);
    rtt::mbar_arrive_expect_tx(&full[s], bytes);
    rtt::bulk_load(ring + s * stage_bytes, x + r0 * d, bytes, &full[s]);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) rtt::mbar_init(&full[s], 1);
    rtt::mbar_fence_init();
    for (int s = 0; s < kStages; ++s)
      if (first + s * step < nblk) fill(s, first + s * step);
  }
  // stage the weight while the first blocks are in flight
  if (w_vec) {
    // 16-byte loads, kBatch a thread issued before any is stored: the
    // staging costs about one trip to device memory
    constexpr int kW = 16 / sizeof(TW);      // weights a load
    constexpr int kBatch = 4;
    const int nchunk = d / kW;
    for (int c0 = threadIdx.x; c0 < nchunk; c0 += kBatch * blockDim.x) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * blockDim.x;
        if (c < nchunk) raw[u] = reinterpret_cast<const uint4*>(w)[c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * blockDim.x;
        if (c >= nchunk) continue;
        const TW* e = reinterpret_cast<const TW*>(&raw[u]);
#pragma unroll
        for (int g = 0; g < kW / 4; ++g) {
          const int e0 = c * kW + 4 * g;     // its 4 weights share a float4
          wp[(e0 % kV) / 4 * nvec + e0 / kV] =
              make_float4(rtt::to_f32(e[4 * g]), rtt::to_f32(e[4 * g + 1]),
                          rtt::to_f32(e[4 * g + 2]),
                          rtt::to_f32(e[4 * g + 3]));
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      const int i = e / kV, j = e % kV;
      wf[((j / 4) * nvec + i) * 4 + j % 4] = rtt::to_f32(w[e]);
    }
  }
  __syncthreads();

  int k = 0;
  for (long long blk = first; blk < nblk; blk += step, ++k) {
    const int s = k % kStages;
    unsigned char* st = ring + s * stage_bytes;
    rtt::mbar_wait(&full[s], (k / kStages) & 1);
    const long long r0 = blk * R;
    const int nr = (int)min((long long)R, rows - r0);
    for (int r = 0; r < nr; ++r) {
      uint4* xs = reinterpret_cast<uint4*>(st + r * row_bytes);
      float ss = 0.f;
#pragma unroll 4
      for (int i = lane; i < nvec; i += 32) {
        const uint4 u = xs[i];
        const TX* e = reinterpret_cast<const TX*>(&u);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float f = rtt::to_f32(e[j]);
          ss += f * f;
        }
      }
      ss = rtt::group_sum<32>(ss);
      // 1 / sqrtf rounds correctly; rsqrtf is within 2 ulp
      const float inv = 1.f / sqrtf(ss / (float)d + eps);
      uint4* yv = reinterpret_cast<uint4*>(y + (r0 + r) * d);
#pragma unroll 4
      for (int i = lane; i < nvec; i += 32) {
        const uint4 u = xs[i];
        const TX* e = reinterpret_cast<const TX*>(&u);
        float wv[kV];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const float4 q = wp[p * nvec + i];
          wv[4 * p] = q.x;
          wv[4 * p + 1] = q.y;
          wv[4 * p + 2] = q.z;
          wv[4 * p + 3] = q.w;
        }
        uint4 o;
        TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
        for (int j = 0; j < kV; ++j)
          oe[j] = rtt::from_f32<TX>(rtt::to_f32(e[j]) * inv * wv[j]);
        if (RMSNORM_BULK_STORE)
          xs[i] = o;
        else
          yv[i] = o;
      }
    }
    if (RMSNORM_BULK_STORE) {
      rtt::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        rtt::bulk_store(y + r0 * d, st, (uint32_t)(nr * row_bytes));
        rtt::bulk_commit();
        rtt::bulk_wait_read<0>();            // the stage may be refilled
      }
    } else {
      __syncwarp();                          // every lane has read stage s
    }
    if (lane == 0 && blk + kStages * step < nblk)
      fill(s, blk + kStages * step);
  }
  if (RMSNORM_BULK_STORE && lane == 0) rtt::bulk_wait<0>();
}

// The ring route's launch: warps a CTA, rows a stage, CTAs and shared
// memory. grid = 0 when the row is too wide for the ring.
struct RingPlan {
  int warps = 0, rows_per_stage = 0, grid = 0;
  size_t smem = 0;
};

template <typename TX, typename TW>
cudaError_t ring_plan(long long rows, int d, RingPlan* plan) {
  int dev, n_sm, smem_max;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int x_bytes = sizeof(TX);
  const long long row_bytes = (long long)d * x_bytes;
  int rps = (int)std::max(1LL, RMSNORM_STAGE_BYTES / row_bytes);
  int warps = RMSNORM_WARPS;
  while (warps > 1 && ring_smem(d, x_bytes, warps, rps) > (size_t)smem_max)
    warps /= 2;
  size_t smem = ring_smem(d, x_bytes, warps, rps);
  if (smem > (size_t)smem_max) return cudaSuccess;   // too wide: grid 0
  auto kernel = rmsnorm_ring_kernel<TX, TW>;
  if (smem > 48 * 1024) {
    // an upper bound of what the launch takes: rows a stage only shrink
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * warps, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // fewer rows a stage when there are fewer rows than warps on the card
  const long long slots = (long long)n_sm * per_sm * warps;
  rps = (int)std::min((long long)rps, (rows + slots - 1) / slots);
  smem = ring_smem(d, x_bytes, warps, rps);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * warps, smem);
  if (e != cudaSuccess) return e;
  const long long nblk = (rows + rps - 1) / rps;
  plan->warps = warps;
  plan->rows_per_stage = rps;
  plan->smem = smem;
  plan->grid = (int)std::min(nblk, (long long)n_sm * std::max(per_sm, 1));
  return cudaSuccess;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  const bool vec = (d * sizeof(TX)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (vec) {
    RingPlan plan;
    const cudaError_t e = ring_plan<TX, TW>(rows, d, &plan);
    if (e != cudaSuccess) return e;
    if (plan.grid > 0) {
      const int w_vec = (d * sizeof(TW)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
      rmsnorm_ring_kernel<TX, TW><<<plan.grid, 32 * plan.warps, plan.smem,
                                    stream>>>(xp, wp, yp, rows, d, eps,
                                              plan.rows_per_stage, w_vec);
      return cudaGetLastError();
    }
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (vec)
    rmsnorm_kernel<TX, TW, true><<<grid, kThreads, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  else
    rmsnorm_kernel<TX, TW, false><<<grid, kThreads, 0, stream>>>(
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
