// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd`): tiled attention with an
// online softmax, causal or not, returning O and the per-row logsumexp.
// Python wrapper: ray_tpu_torch/ops/kernels/flash_attention.py.
//
// What bounds it on the card: at prefill lengths attention does
// 4*S*S*D/2 operations per head (causal) on 4*S*D elements, far above
// the H100's ~295 operations per byte, so the bound is arithmetic. Two
// kernels, chosen by the input type: bf16 runs on the tensor cores
// (`mma.sync.m16n8k16`, bf16 operands, fp32 accumulation; P is rounded
// to bf16 for the P.V product, as the Pallas kernel's p.astype(v.dtype)
// does); fp32 runs on scalar fp32 FMAs from shared memory, so fp32
// results stay exact products (the port's fp32 parity checks need it).
// Neither pipelines its tile loads; wgmma/TMA tiles are later work.
// What the design does about the bound: the S x S scores never reach
// device memory, each K/V tile is read once per 64 query rows as 16-byte
// vectors, and causal tiles past the diagonal are never loaded.
//
// Differences from the TPU grid:
//  * one CTA per (batch*q-head, 64-row q tile) with the key loop inside
//    the block, replacing the sequential third grid axis and its VMEM
//    scratch; the running max/sum live in registers;
//  * causal: the key loop stops at the q tile's last row instead of
//    testing each key block;
//  * GQA: query head h reads kv head h / (Hq / Hkv); K/V are never
//    repeated in memory;
//  * ragged edges are masked in the kernel (no padded copies);
//  * lse is (B*Hq, Sq), not the Mosaic (BH, 1, S) layout.
// Kept: masked scores are -1e30, a row whose sum is 0 writes 0
// (`safe_l`), and causal masking compares absolute indices (k <= q).
//
// Layouts: q/o (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), all contiguous and
// 16-byte aligned; float32 or bfloat16 storage, fp32 arithmetic. It
// allocates nothing and runs on the caller's stream.

#include "common.cuh"

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

// ---- bf16: tensor-core kernel ------------------------------------------
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

cudaError_t dispatch_mma(int D, const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int Sq, int Sk, int Hq,
                         int Hkv, float scale, int causal,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch_mma<32>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch_mma<64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch_mma<128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
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
    return (int)dispatch_mma(D, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale,
                             causal, st);
  return (int)cudaErrorInvalidValue;
}
