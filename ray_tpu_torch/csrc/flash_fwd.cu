// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd`): tiled attention with an
// online softmax, causal or not, returning O and the per-row logsumexp.
// Python wrapper: ray_tpu_torch/ops/kernels/flash_attention.py.
//
// What bounds it on the card: at prefill lengths attention does
// 4*S*S*D/2 operations per head (causal) on 4*S*D elements, far above
// the H100's ~295 operations per byte, so the bound is arithmetic, on
// the tensor cores. Three kernels, by input type and head dim:
//  * bf16 at D 64 and 128 (every path of the port): a warp-specialised
//    kernel on `wgmma.mma_async` (hopper.cuh), the counterpart of K2a's
//    in flash_bwd.cu. One producer warp loads the CTA's 128 query rows
//    once and streams 64-key K/V tiles through a 3-stage ring of
//    full/empty mbarriers by TMA (`cp.async.bulk.tensor`, 128-byte
//    swizzle), so no consumer waits on device memory; two consumer
//    warpgroups of 64 rows each take the producer's registers
//    (`setmaxnreg`). S = Q K^T is wgmma with both operands in shared
//    memory; P, rounded to bf16 as the Pallas kernel's p.astype(v.dtype)
//    does, is already wgmma's register-A fragment for O += P V, which
//    reads V through a transposed (MN-major) descriptor. Each consumer
//    issues tile n's S product before tile n-1's P.V product and runs
//    tile n's softmax while P.V is in flight.
//  * bf16 at D 16 and 32: `mma.sync.m16n8k16` from padded shared memory
//    (a wgmma tile is at least 64 wide in K; no path of the port runs
//    these head dims).
//  * fp32: scalar fp32 FMAs from shared memory, so fp32 results stay
//    exact products (the port's fp32 parity checks need it).
// What every kernel does about the bound: the S x S scores never reach
// device memory, each K/V tile is read once per CTA of query rows, and
// causal tiles past the diagonal are never loaded.
//
// Differences from the TPU grid:
//  * one CTA per (batch*q-head, q tile: 128 rows for wgmma, 64 for the
//    others) with the key loop inside the block, replacing the
//    sequential third grid axis and its VMEM scratch; the running
//    max/sum live in registers; the wgmma grid launches the heaviest
//    (last) q tiles first;
//  * causal: the key loop stops at the q tile's last row instead of
//    testing each key block;
//  * GQA: query head h reads kv head h / (Hq / Hkv); K/V are never
//    repeated in memory;
//  * ragged edges are masked in the kernel (no padded copies; TMA reads
//    rows past the end as zeros, and the mask still decides);
//  * lse is (B*Hq, Sq), not the Mosaic (BH, 1, S) layout.
// Kept: masked scores are -1e30 (-inf in the wgmma kernel, which works in
// base 2), a row whose sum is 0 writes 0 (`safe_l`), and causal masking
// compares absolute indices (k <= q).
//
// Layouts: q/o (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), all contiguous and
// 16-byte aligned; float32 or bfloat16 storage, fp32 arithmetic. It
// allocates nothing and runs on the caller's stream.

#include "common.cuh"
#include "hopper.cuh"

#include <cmath>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BK][D+1], sV [BK][D], sP [BQ][BK+1], all fp32
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// Thread (tr, tc) = (tid / 8, tid % 8) owns query rows tr*4 .. tr*4+3 of
// the tile, score columns tc + 8*j (j < 8) and output columns tc + 8*j
// (j < D/8). The 8 lanes of a row group are consecutive lanes of one
// warp, so row reductions are 3 shuffles and the P tile a row group
// writes is read back only by that same warp.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int RPT = kBQ / 16;  // rows per thread
  constexpr int CPT = kBK / 8;   // score columns per thread
  constexpr int OPT = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);

  const long q_stride = (long)Hq * D;    // between consecutive positions
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  rtt::load_tile<T, D, kBQ, DP, kThreads>(qb, q_stride, q0, Sq, sQ, tid);

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = rtt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // sQ written / previous tile's sK, sV consumed
    rtt::load_tile<T, D, kBK, DP, kThreads>(kb, kv_stride, k0, Sk, sK, tid);
    rtt::load_tile<T, D, kBK, D, kThreads>(vb, kv_stride, k0, Sk, sV, tid);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(tr * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = tr * RPT + i;
      const int qpos = q0 + row;
      bool ok[CPT];
      float mx = rtt::kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tc + 8 * j;
        ok[j] = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : rtt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = rtt::group_max<8>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        sP[row * PP + tc + 8 * j] = p;
        rs += p;
      }
      rs = rtt::group_sum<8>(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // sP rows of this row group are complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(tr * RPT + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const float vx = sV[kk * D + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vx, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + tr * RPT + i;
    if (qr >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / safe_l;
    T* orow = o + ((long)b * Sq + qr) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      orow[tc + 8 * j] = rtt::from_f32<T>(acc[i][j] * inv);
    if (tc == 0) lse[(long)bh * Sq + qr] = m[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, void* lse, int B, int Sq, int Sk, int Hq,
                       int Hkv, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 at D 16 and 32: mma.sync kernel -------------------------------
//
// 4 warps; warp w owns query rows 16w .. 16w+15 of the 64-row tile. With
// g = lane / 4 and t = lane % 4, an m16n8k16 fragment gives the thread
// rows g and g+8 and columns 2t, 2t+1 (+8 for the second half of A), so
// each query row's softmax statistics are reduced over the 4 lanes that
// share g. Tiles sit in shared memory as bf16 with rows padded by 8
// elements, which keeps every fragment load free of bank conflicts.

template <int D>
constexpr size_t mma_smem_bytes() {
  // sQ [BQ][D+8], sK [BK][D+8], sV [BK][D+8], bf16
  return sizeof(__nv_bfloat16) * (kBQ + 2 * kBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int Hq, int Hkv, float scale,
                     int causal) {
  constexpr int DS = D + 8;
  constexpr int NT = kBK / 8;    // key n-tiles of S
  constexpr int NO = D / 8;      // d n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* sK = sQ + kBQ * DS;
  __nv_bfloat16* sV = sK + kBK * DS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = (tid >> 5) * 16;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const __nv_bfloat16* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  rtt::copy_tile_bf16<D, kBQ, DS, kThreads>(qb, q_stride, q0, Sq, sQ, tid);

  const int qpos[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float m[2] = {rtt::kNegInf, rtt::kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // sQ written / previous tile's sK, sV consumed
    rtt::copy_tile_bf16<D, kBK, DS, kThreads>(kb, kv_stride, k0, Sk, sK,
                                              tid);
    rtt::copy_tile_bf16<D, kBK, DS, kThreads>(vb, kv_stride, k0, Sk, sV,
                                              tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (wrow + g) * DS + kk * 16 + 2 * t;
      const uint32_t a0 = rtt::ld32(qa), a1 = rtt::ld32(qa + 8 * DS);
      const uint32_t a2 = rtt::ld32(qa + 8);
      const uint32_t a3 = rtt::ld32(qa + 8 * DS + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * DS + kk * 16 + 2 * t;
        rtt::mma_bf16(s[j], a0, a1, a2, a3, rtt::ld32(kp),
                      rtt::ld32(kp + 8));
      }
    }

    // masks, online softmax; element e of s[j] is row g + 8*(e/2), key
    // k0 + 8j + 2t + e%2
    float mx[2] = {rtt::kNegInf, rtt::kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = kpos < Sk && (!causal || kpos <= qpos[e >> 1]);
        s[j][e] = ok ? s[j][e] * scale : rtt::kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], rtt::group_max<4>(mx[r]));
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == rtt::kNegInf ? 0.f : __expf(x - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rtt::group_sum<4>(rs[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: S's accumulator layout is the A-fragment layout of P
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = rtt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = rtt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = rtt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = rtt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = sV + (kk * 16 + 2 * t) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* c = vp + n * 8;
        rtt::mma_bf16(acc[n], a0, a1, a2, a3, rtt::pack_bf16(c[0], c[DS]),
                      rtt::pack_bf16(c[8 * DS], c[9 * DS]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / safe_l;
    __nv_bfloat16* orow = o + ((long)b * Sq + qpos[r]) * q_stride +
                          (long)h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          rtt::pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0) lse[(long)bh * Sq + qpos[r]] = m[r] + logf(safe_l);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

// ---- bf16 at D 64 and 128: warp-specialised wgmma kernel -----------------
//
// 384 threads: warpgroups 0 and 1 consume, each owning 64 of the CTA's
// 128 query rows (wgmma's M); the first thread of warpgroup 2 loads the
// Q tile once and streams the kv head's 64-key K and V tiles through the
// ring, and warpgroup 2 gives its registers to the consumers.
//
// A consumer's step n: issue S_n = Q K_n^T, then O += P_{n-1} V_{n-1};
// wait for S_n alone; mask S_n and take its online softmax in registers
// (in base 2: scores are scaled by scale * log2(e)) while the P.V product
// runs; wait for that product, release tile n-1's stage and rescale O by
// the new row maxima; round P_n to bf16 pairs for the next step. Tile 0's
// S product and softmax come before the loop and the last P.V after it,
// so every step issues both products unconditionally: with the P.V
// product under a condition inside the loop, ptxas serialised every
// wgmma of the kernel (advisory C7514; chip_smoke.py fails on it) and the
// overlap was lost. With g = lane / 4 and t = lane % 4, accumulator
// element i of warp w holds row 16w + g + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2t + (i & 1), so a row's max and sum are reduced over the
// 4 lanes that share g.

constexpr int kWG = 128;                    // threads of a warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kWsThreads = (kConsumers + 1) * kWG;
constexpr int kTileRows = kConsumers * 64;  // query rows of a CTA
constexpr int kStreamRows = 64;             // keys of a streamed tile
constexpr int kStages = 3;
// 24 * 128 + 240 * 256 = 64512, the CTA's 168 registers a thread at
// launch, as in flash_bwd.cu
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using rtt::bf16;

// Masks and online softmax of one 64-key tile of S (keys k0 ..), in
// place: sc becomes P (fp32, base 2: scores scaled by scale * log2(e));
// m and l are the running max and sum of the thread's two rows, corr
// the factor that rescales their O. Masked: a key at or past Sk, and
// (causal) a key past the row; -inf never makes NaN (a row that has
// seen no key keeps m = -inf, and 0 stands in for it).
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2], int k0,
                                               int Sk, int causal, int first,
                                               const int (&qpos)[2], int t,
                                               float scale2) {
  const bool masked = k0 + kStreamRows > Sk ||
                      (causal && k0 + kStreamRows - 1 > first);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = sc[i] * scale2;
    if (masked) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (kpos >= Sk || (causal && kpos > qpos[r])) x = -INFINITY;
    }
    sc[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float ref[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], rtt::group_max<4>(mx[r]));
    ref[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = rtt::exp2_approx(m[r] - ref[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = rtt::exp2_approx(sc[i] - ref[r]);
    rs[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + rtt::group_sum<4>(rs[r]);
}

template <int D>
struct FwdLayout {
  using QTile = rtt::Tile<kTileRows, D>;
  using KTile = rtt::Tile<kStreamRows, D>;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + QTile::kBytes;            // kStages tiles
  static constexpr int kV = kK + kStages * KTile::kBytes;  // kStages tiles
  static constexpr int kBar = kV + kStages * KTile::kBytes;
  static constexpr size_t kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Sk, int Hq, int Hkv, float scale,
                       int causal) {
  using L = FwdLayout<D>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = rtt::align_1024(smem_raw);
  const QTile sQ{reinterpret_cast<bf16*>(smem + L::kQ)};
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  auto k_tile = [&](int s) {
    return KTile{reinterpret_cast<bf16*>(smem + L::kK + s * KTile::kBytes)};
  };
  auto v_tile = [&](int s) {
    return KTile{reinterpret_cast<bf16*>(smem + L::kV + s * KTile::kBytes)};
  };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  // the heaviest (last) q tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;
  // causal: keys past the tile's last row are never loaded
  const int k_end = causal ? min(Sk, q0 + kTileRows) : Sk;
  const int n_tiles = (k_end + kStreamRows - 1) / kStreamRows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      rtt::mbar_init(&full[s], 1);
      rtt::mbar_init(&empty[s], kConsumers * kWG);
    }
    rtt::mbar_init(q_full, 1);
    rtt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers * kWG) {
    // ---- producer ----
    rtt::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * kWG) {
      rtt::tma_prefetch_map(&map_k);
      rtt::tma_prefetch_map(&map_v);
      rtt::mbar_arrive_expect_tx(q_full, QTile::kBytes);
      rtt::tma_tile(sQ, &map_q, q_full, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        rtt::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        rtt::mbar_arrive_expect_tx(&full[s], 2 * KTile::kBytes);
        rtt::tma_tile(k_tile(s), &map_k, &full[s], kvh, n * kStreamRows, b);
        rtt::tma_tile(v_tile(s), &map_v, &full[s], kvh, n * kStreamRows, b);
      }
    }
  } else {
    // ---- consumers ----
    rtt::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWG;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = wg * 64;      // this warpgroup's rows of the q tile
    const int first = q0 + row0;   // its first query row
    const int qpos[2] = {first + ((tid >> 5) & 3) * 16 + g,
                         first + ((tid >> 5) & 3) * 16 + g + 8};
    const float scale2 = scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, base 2
    float l[2] = {0.f, 0.f};
    uint32_t pa[4][4];                     // P of the previous tile, bf16
    float sc[32];                          // S_n, then P_n in fp32
    float corr[2];                         // rescale factors of O's rows
    rtt::mbar_wait(q_full, 0);

    // tile 0: S_0 and its softmax (O is still 0)
    rtt::mbar_wait(&full[0], 0);
    rtt::fence_regs(sc);
    rtt::wgmma_fence();
    rtt::gemm_ss(sc, sQ, row0, k_tile(0));
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_regs(sc);
    online_softmax(sc, m, l, corr, 0, Sk, causal, first, qpos, t, scale2);
    rtt::pack_a(sc, pa);

    // tile n: S_n = Q K_n^T, then O += P_{n-1} V_{n-1}; the softmax of
    // S_n runs while P.V is in flight
    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int prev = (n - 1) % kStages;
      rtt::mbar_wait(&full[s], (n / kStages) & 1);
      rtt::fence_regs(sc);
      rtt::fence_regs(acc);
      rtt::fence_regs(pa);
      rtt::wgmma_fence();
      rtt::gemm_ss(sc, sQ, row0, k_tile(s));
      rtt::wgmma_commit();
      rtt::gemm_rs(acc, pa, v_tile(prev));
      rtt::wgmma_commit();
      rtt::wgmma_wait<1>();   // S_n is done, P.V may still run
      rtt::fence_regs(sc);
      online_softmax(sc, m, l, corr, n * kStreamRows, Sk, causal, first,
                     qpos, t, scale2);
      rtt::wgmma_wait<0>();
      rtt::fence_regs(acc);
      rtt::fence_regs(pa);   // read by the product until here
      rtt::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      rtt::pack_a(sc, pa);
    }

    // the last tile's P V
    rtt::fence_regs(acc);
    rtt::fence_regs(pa);
    rtt::wgmma_fence();
    rtt::gemm_rs(acc, pa, v_tile((n_tiles - 1) % kStages));
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_regs(acc);
    rtt::fence_regs(pa);
    rtt::mbar_arrive(&empty[(n_tiles - 1) % kStages]);

    float safe_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) safe_l[r] = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] /= safe_l[(i >> 1) & 1];
    const long stride = (long)Hq * D;
    rtt::store_rows<D>(acc, o + (long)b * Sq * stride + (long)h * D, stride,
                       qpos, Sq, t);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qpos[r] < Sq)
          lse[(long)bh * Sq + qpos[r]] =
              (m[r] == -INFINITY ? rtt::kNegInf : m[r] * kLn2) +
              logf(safe_l[r]);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int Sq, int Sk, int Hq,
                         int Hkv, float scale, int causal,
                         cudaStream_t stream) {
  if (Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = rtt::make_bshd_map(&mq, q, B, Sq, Hq, D, kTileRows)) ||
      (err = rtt::make_bshd_map(&mk, k, B, Sk, Hkv, D, kStreamRows)) ||
      (err = rtt::make_bshd_map(&mv, v, B, Sk, Hkv, D, kStreamRows)))
    return err;
  const size_t smem = FwdLayout<D>::kBytes;
  auto kern = flash_fwd_wgmma_kernel<D>;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  dim3 grid(B * Hq, (Sq + kTileRows - 1) / kTileRows);
  kern<<<grid, kWsThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk,
      Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

// bf16 by head dim: mma.sync at 16 and 32, wgmma at 64 and 128
cudaError_t dispatch_bf16(int D, const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int Sq, int Sk, int Hq,
                          int Hkv, float scale, int causal,
                          cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch_mma<32>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// a tensor map that cannot be encoded or a refused launch is returned as
// it is, with no other kernel tried.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Sq, int Sk,
                             int Hq, int Hkv, int D, int causal, float scale,
                             int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv,
                                  scale, causal, st);
  if (dtype == 1)
    return (int)dispatch_bf16(D, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale,
                              causal, st);
  return (int)cudaErrorInvalidValue;
}
