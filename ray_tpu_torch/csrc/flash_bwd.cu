// K2a/K2b: flash-attention backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels ray_tpu/ops/pallas/flash_attention.py
// `_bwd_dq_kernel` (K2a) and `_bwd_dkv_kernel` (K2b), launched by
// `_flash_bwd`. Both rebuild the normalised probabilities from the
// forward's logsumexp, P = exp(S * scale - lse) under the forward's masks,
// and form dS = P * (dO V^T - delta) * scale with delta = rowsum(dO * O)
// computed beforehand (the wrapper's one torch expression, as the
// reference leaves it to XLA):
//   K2a  dQ = sum over keys of dS K
//   K2b  dK = sum over queries of dS^T Q,  dV = sum over queries of P^T dO
// Python wrapper: ray_tpu_torch/ops/kernels/flash_attention.py.
//
// What bounds them on the card: K2a does three and K2b four products of
// 2*S*S*D/2 operations per head (causal) on O(S*D) elements, so at
// training lengths both are bound by arithmetic. Two kernels each,
// chosen by the input type: bf16 runs on the tensor cores
// (`mma.sync.m16n8k16`, bf16 operands, fp32 accumulation), with P and dS
// rounded to bf16 before the products that take them, as the Pallas
// kernels do (`p.astype(do.dtype)`, `ds.astype(q.dtype)`); fp32 runs on
// scalar fp32 FMAs from shared memory, so fp32 results stay exact
// products (the port's fp32 parity checks need it). Neither pipelines
// its tile loads; wgmma/TMA tiles are later work. What the design does
// about the bound: the S x S scores and probabilities never reach device
// memory, every product reads its operands from shared memory, and
// causal tiles that see no key are never loaded.
//
// Differences from the TPU grids:
//  * K2a: one CTA per (batch*q-head, 64-row q tile), looping over key
//    tiles inside the block and stopping at the diagonal under causal
//    masking; the heaviest (last) q tiles are launched first.
//  * K2b: one CTA per (batch*kv-head, 64-key tile). It loops over the
//    Hq/Hkv query heads of its group and over their q tiles, and keeps
//    dK/dV for the kv head in fp32 registers. GQA thus needs no expanded
//    K/V, no atomics and no second reduction pass, and the result is
//    deterministic; this replaces the reference's repeat-then-sum
//    (`jnp.repeat` of K/V before the kernel, summed back by autodiff).
//    Under causal masking the q loop starts at the key tile's first row.
//  * ragged edges are masked in the kernels (no padded copies);
//  * lse and delta are (B*Hq, Sq) fp32, not the Mosaic (BH, 1, S) layout.
// Kept: causal masking compares absolute indices (key k <= query q);
// masked and out-of-range entries of P are 0.
//
// Layouts: q/dO/dQ (B, Sq, Hq, D), k/v/dK/dV (B, Sk, Hkv, D), all
// contiguous and 16-byte aligned; float32 or bfloat16 storage (dQ in q's
// type, dK/dV in k's type). They allocate nothing and run on the
// caller's stream.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps

// ---- fp32: scalar kernels ------------------------------------------------
//
// Thread (tr, tc) = (tid / 8, tid % 8) owns tile rows tr*4 .. tr*4+3,
// score columns tc + 8*j (j < 8) and output columns tc + 8*j (j < D/8),
// as in K1's fp32 kernel; the 8 lanes of a row group are consecutive
// lanes of one warp, so the dS (or P) rows a row group writes to shared
// memory are read back only by that same warp.

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sO, sK, sV [64][D+1], sP [64][65]
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) +
                          kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
              float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int RPT = kBQ / 16;  // query rows per thread
  constexpr int CPT = kBK / 8;   // key columns per thread
  constexpr int OPT = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kBQ * DP;
  float* sK = sO + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * DP;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const float* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const float* ob = dout + (long)b * Sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const float* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  rtt::load_tile<float, D, kBQ, DP, kThreads>(qb, q_stride, q0, Sq, sQ, tid);
  rtt::load_tile<float, D, kBQ, DP, kThreads>(ob, q_stride, q0, Sq, sO, tid);
  float lr[RPT], dr[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + tr * RPT + i;
    lr[i] = qr < Sq ? lse[(long)bh * Sq + qr] : 0.f;
    dr[i] = qr < Sq ? delta[(long)bh * Sq + qr] : 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // sQ/sO written / previous tile's sK, sV consumed
    rtt::load_tile<float, D, kBK, DP, kThreads>(kb, kv_stride, k0, Sk, sK,
                                                tid);
    rtt::load_tile<float, D, kBK, DP, kThreads>(vb, kv_stride, k0, Sk, sV,
                                                tid);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kx[CPT], vx[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = sQ[(tr * RPT + i) * DP + d];
        ov[i] = sO[(tr * RPT + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kx[j] = sK[(tc + 8 * j) * DP + d];
        vx[j] = sV[(tc + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kx[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vx[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = tr * RPT + i;
      const int qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool ok = kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        sP[row * PP + tc + 8 * j] = p * (dp[i][j] - dr[i]) * scale;
      }
    }
    __syncwarp();  // sP rows of this row group are complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(tr * RPT + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const float kx = sK[kk * DP + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], kx, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + tr * RPT + i;
    if (qr >= Sq) continue;
    float* row = dq + ((long)b * Sq + qr) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) row[tc + 8 * j] = acc[i][j];
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sO [64][D+1], sP, sS [64][65], sL, sD [64]
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) +
                          2 * kBK * (kBQ + 1) + 2 * kBQ);
}

// Here thread (tr, tc) owns key rows tr*4 .. tr*4+3 of the CTA's tile and
// query columns tc + 8*j of each q tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
               float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBQ + 1;
  constexpr int RPT = kBK / 16;  // key rows per thread
  constexpr int CPT = kBQ / 8;   // query columns per thread
  constexpr int OPT = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * DP;
  float* sQ = sV + kBK * DP;
  float* sO = sQ + kBQ * DP;
  float* sP = sO + kBQ * DP;
  float* sS = sP + kBK * PP;
  float* sL = sS + kBK * PP;
  float* sD = sL + kBQ;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const int rep = Hq / Hkv;
  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = (long)b * Sk * kv_stride + (long)kvh * D;

  rtt::load_tile<float, D, kBK, DP, kThreads>(k + kv_off, kv_stride, k0, Sk,
                                              sK, tid);
  rtt::load_tile<float, D, kBK, DP, kThreads>(v + kv_off, kv_stride, k0, Sk,
                                              sV, tid);
  float acc_k[RPT][OPT], acc_v[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // causal: query rows before k0 see none of this tile's keys (kBQ == kBK)
  const int q_begin = causal ? k0 : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const long bh = (long)b * Hq + h;
    const float* qb = q + (long)b * Sq * q_stride + (long)h * D;
    const float* ob = dout + (long)b * Sq * q_stride + (long)h * D;
    for (int q0 = q_begin; q0 < Sq; q0 += kBQ) {
      __syncthreads();  // previous q tile consumed
      rtt::load_tile<float, D, kBQ, DP, kThreads>(qb, q_stride, q0, Sq, sQ,
                                                  tid);
      rtt::load_tile<float, D, kBQ, DP, kThreads>(ob, q_stride, q0, Sq, sO,
                                                  tid);
      if (tid < kBQ) {
        const int qr = q0 + tid;
        sL[tid] = qr < Sq ? lse[bh * Sq + qr] : 0.f;
        sD[tid] = qr < Sq ? delta[bh * Sq + qr] : 0.f;
      }
      __syncthreads();

      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kx[RPT], vx[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kx[i] = sK[(tr * RPT + i) * DP + d];
          vx[i] = sV[(tr * RPT + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = sQ[(tc + 8 * j) * DP + d];
          ov[j] = sO[(tc + 8 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kx[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vx[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = tr * RPT + i;
        const int kpos = k0 + row;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = tc + 8 * j;
          const int qpos = q0 + col;
          const bool ok = qpos < Sq && kpos < Sk &&
                          (!causal || kpos <= qpos);
          const float p = ok ? expf(s[i][j] * scale - sL[col]) : 0.f;
          sP[row * PP + col] = p;
          sS[row * PP + col] = p * (dp[i][j] - sD[col]) * scale;
        }
      }
      __syncwarp();  // sP/sS rows of this row group are complete

#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float pv[RPT], sv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[(tr * RPT + i) * PP + qq];
          sv[i] = sS[(tr * RPT + i) * PP + qq];
        }
#pragma unroll
        for (int j = 0; j < OPT; ++j) {
          const float ox = sO[qq * DP + tc + 8 * j];
          const float qx = sQ[qq * DP + tc + 8 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc_v[i][j] = fmaf(pv[i], ox, acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qx, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kr = k0 + tr * RPT + i;
    if (kr >= Sk) continue;
    const long off = ((long)b * Sk + kr) * kv_stride + (long)kvh * D;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      dk[off + tc + 8 * j] = acc_k[i][j];
      dv[off + tc + 8 * j] = acc_v[i][j];
    }
  }
}

// ---- bf16: tensor-core kernels --------------------------------------------
//
// 4 warps; warp w owns rows 16w .. 16w+15 of the CTA's 64-row tile (query
// rows in K2a, key rows in K2b). Fragment layouts are those of
// common.cuh; an accumulator of S (or dS) is reused in registers as the A
// fragment of the next product, rounded to bf16, with no round trip
// through shared memory. Tiles sit in shared memory as bf16 with rows
// padded by 8 elements, which keeps every fragment load free of bank
// conflicts.

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // sQ, sO [64][D+8], sK, sV [64][D+8]
  return sizeof(bf16) * (2 * kBQ + 2 * kBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  constexpr int DS = D + 8;
  constexpr int NT = kBK / 8;  // key n-tiles of S and dP
  constexpr int NO = D / 8;    // d n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kBQ * DS;
  bf16* sK = sO + kBQ * DS;
  bf16* sV = sK + kBK * DS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = (tid >> 5) * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const bf16* ob = dout + (long)b * Sq * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  rtt::copy_tile_bf16<D, kBQ, DS, kThreads>(qb, q_stride, q0, Sq, sQ, tid);
  rtt::copy_tile_bf16<D, kBQ, DS, kThreads>(ob, q_stride, q0, Sq, sO, tid);

  const int qpos[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] = qpos[r] < Sq ? lse[(long)bh * Sq + qpos[r]] : 0.f;
    dr[r] = qpos[r] < Sq ? delta[(long)bh * Sq + qpos[r]] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // sQ/sO written / previous tile's sK, sV consumed
    rtt::copy_tile_bf16<D, kBK, DS, kThreads>(kb, kv_stride, k0, Sk, sK,
                                              tid);
    rtt::copy_tile_bf16<D, kBK, DS, kThreads>(vb, kv_stride, k0, Sk, sV,
                                              tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = sQ + (wrow + g) * DS + kk * 16 + 2 * t;
      const bf16* oa = sO + (wrow + g) * DS + kk * 16 + 2 * t;
      const uint32_t a0 = rtt::ld32(qa), a1 = rtt::ld32(qa + 8 * DS);
      const uint32_t a2 = rtt::ld32(qa + 8);
      const uint32_t a3 = rtt::ld32(qa + 8 * DS + 8);
      const uint32_t o0 = rtt::ld32(oa), o1 = rtt::ld32(oa + 8 * DS);
      const uint32_t o2 = rtt::ld32(oa + 8);
      const uint32_t o3 = rtt::ld32(oa + 8 * DS + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* kp = sK + (j * 8 + g) * DS + kk * 16 + 2 * t;
        const bf16* vp = sV + (j * 8 + g) * DS + kk * 16 + 2 * t;
        rtt::mma_bf16(s[j], a0, a1, a2, a3, rtt::ld32(kp),
                      rtt::ld32(kp + 8));
        rtt::mma_bf16(dp[j], o0, o1, o2, o3, rtt::ld32(vp),
                      rtt::ld32(vp + 8));
      }
    }

    // dS in place of S; element e of s[j] is row g + 8*(e/2), key
    // k0 + 8j + 2t + e%2
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = kpos < Sk && qpos[r] < Sq &&
                        (!causal || kpos <= qpos[r]);
        const float p = ok ? __expf(s[j][e] * scale - lr[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[r]) * scale;
      }

    // dQ += dS K: B[k = key][n = d] is K's tile as stored
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = rtt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = rtt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = rtt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = rtt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* kp = sK + (kk * 16 + 2 * t) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* c = kp + n * 8;
        rtt::mma_bf16(acc[n], a0, a1, a2, a3, rtt::pack_bf16(c[0], c[DS]),
                      rtt::pack_bf16(c[8 * DS], c[9 * DS]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    bf16* row = dq + ((long)b * Sq + qpos[r]) * q_stride + (long)h * D +
                2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          rtt::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

constexpr int kQT = 32;  // query rows per step of the bf16 K2b kernel

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // sK, sV [64][D+8], sQ, sO [32][D+8] bf16; sL, sD [32] fp32
  return sizeof(bf16) * (2 * kBK + 2 * kQT) * (D + 8) +
         sizeof(float) * 2 * kQT;
}

// Each warp holds dK and dV for its 16 keys (2 x D/8 accumulator tiles);
// the q step is 32 rows so that S^T and dP^T add only 2 x 4 more.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                   float scale, int causal) {
  constexpr int DS = D + 8;
  constexpr int NT = kQT / 8;  // query n-tiles of S^T and dP^T
  constexpr int NO = D / 8;    // d n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBK * DS;
  bf16* sQ = sV + kBK * DS;
  bf16* sO = sQ + kQT * DS;
  float* sL = reinterpret_cast<float*>(sO + kQT * DS);
  float* sD = sL + kQT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = (tid >> 5) * 16;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const int rep = Hq / Hkv;
  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = (long)b * Sk * kv_stride + (long)kvh * D;

  rtt::copy_tile_bf16<D, kBK, DS, kThreads>(k + kv_off, kv_stride, k0, Sk,
                                            sK, tid);
  rtt::copy_tile_bf16<D, kBK, DS, kThreads>(v + kv_off, kv_stride, k0, Sk,
                                            sV, tid);

  const int kpos[2] = {k0 + wrow + g, k0 + wrow + g + 8};
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // causal: query rows before k0 see none of this tile's keys
  const int q_begin = causal ? k0 : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const long bh = (long)b * Hq + h;
    const bf16* qb = q + (long)b * Sq * q_stride + (long)h * D;
    const bf16* ob = dout + (long)b * Sq * q_stride + (long)h * D;
    for (int q0 = q_begin; q0 < Sq; q0 += kQT) {
      __syncthreads();  // previous q step consumed
      rtt::copy_tile_bf16<D, kQT, DS, kThreads>(qb, q_stride, q0, Sq, sQ,
                                                tid);
      rtt::copy_tile_bf16<D, kQT, DS, kThreads>(ob, q_stride, q0, Sq, sO,
                                                tid);
      if (tid < kQT) {
        const int qr = q0 + tid;
        sL[tid] = qr < Sq ? lse[bh * Sq + qr] : 0.f;
        sD[tid] = qr < Sq ? delta[bh * Sq + qr] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* ka = sK + (wrow + g) * DS + kk * 16 + 2 * t;
        const bf16* va = sV + (wrow + g) * DS + kk * 16 + 2 * t;
        const uint32_t a0 = rtt::ld32(ka), a1 = rtt::ld32(ka + 8 * DS);
        const uint32_t a2 = rtt::ld32(ka + 8);
        const uint32_t a3 = rtt::ld32(ka + 8 * DS + 8);
        const uint32_t v0 = rtt::ld32(va), v1 = rtt::ld32(va + 8 * DS);
        const uint32_t v2 = rtt::ld32(va + 8);
        const uint32_t v3 = rtt::ld32(va + 8 * DS + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const bf16* qp = sQ + (j * 8 + g) * DS + kk * 16 + 2 * t;
          const bf16* op = sO + (j * 8 + g) * DS + kk * 16 + 2 * t;
          rtt::mma_bf16(st[j], a0, a1, a2, a3, rtt::ld32(qp),
                        rtt::ld32(qp + 8));
          rtt::mma_bf16(dpt[j], v0, v1, v2, v3, rtt::ld32(op),
                        rtt::ld32(op + 8));
        }
      }

      // P^T in st, dS^T in dpt; element e of st[j] is key row
      // kpos[e/2], query q0 + 8j + 2t + e%2
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = 8 * j + 2 * t + (e & 1);
          const int qpos = q0 + col;
          const bool ok = qpos < Sq && kpos[r] < Sk &&
                          (!causal || kpos[r] <= qpos);
          const float p = ok ? __expf(st[j][e] * scale - sL[col]) : 0.f;
          dpt[j][e] = p * (dpt[j][e] - sD[col]) * scale;
          st[j][e] = p;
        }

      // dV += P^T dO and dK += dS^T Q: B[k = query][n = d] is the dO or
      // Q tile as stored
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        const uint32_t p0 = rtt::pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        const uint32_t p1 = rtt::pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        const uint32_t p2 =
            rtt::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        const uint32_t p3 =
            rtt::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        const uint32_t s0 = rtt::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        const uint32_t s1 = rtt::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        const uint32_t s2 =
            rtt::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        const uint32_t s3 =
            rtt::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
        const bf16* op = sO + (kk * 16 + 2 * t) * DS + g;
        const bf16* qp = sQ + (kk * 16 + 2 * t) * DS + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const bf16* c = op + n * 8;
          rtt::mma_bf16(acc_v[n], p0, p1, p2, p3,
                        rtt::pack_bf16(c[0], c[DS]),
                        rtt::pack_bf16(c[8 * DS], c[9 * DS]));
          c = qp + n * 8;
          rtt::mma_bf16(acc_k[n], s0, s1, s2, s3,
                        rtt::pack_bf16(c[0], c[DS]),
                        rtt::pack_bf16(c[8 * DS], c[9 * DS]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Sk) continue;
    const long off = ((long)b * Sk + kpos[r]) * kv_stride + (long)kvh * D +
                     2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          rtt::pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          rtt::pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv;
  float scale;
  int causal;
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_dq(const Args& a, bool bf, cudaStream_t st) {
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
  if (bf) {
    const size_t smem = dq_mma_smem_bytes<D>();
    cudaError_t err = prepare(bwd_dq_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    bwd_dq_mma_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale,
        a.causal);
  } else {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = prepare(bwd_dq_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, bool bf, cudaStream_t st) {
  dim3 grid((a.Sk + kBK - 1) / kBK, a.B * a.Hkv);
  if (bf) {
    const size_t smem = dkv_mma_smem_bytes<D>();
    cudaError_t err = prepare(bwd_dkv_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    bwd_dkv_mma_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk,
        a.Hq, a.Hkv, a.scale, a.causal);
  } else {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = prepare(bwd_dkv_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk,
        a.Hq, a.Hkv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch(int D, const Args& a, bool bf, cudaStream_t st) {
  switch (D) {
    case 16: return DKV ? launch_dkv<16>(a, bf, st) : launch_dq<16>(a, bf, st);
    case 32: return DKV ? launch_dkv<32>(a, bf, st) : launch_dq<32>(a, bf, st);
    case 64: return DKV ? launch_dkv<64>(a, bf, st) : launch_dq<64>(a, bf, st);
    case 128:
      return DKV ? launch_dkv<128>(a, bf, st) : launch_dq<128>(a, bf, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int entry(const Args& a, int D, int dtype, void* stream) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B * a.Hq > 65535 ||
      a.Sq <= 0 || a.Sk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<DKV>(D, a, dtype == 1,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 =
// launched). lse and delta are (B*Hq, Sq) fp32.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Sk, int Hq, int Hkv, int D, int causal,
                                float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               B, Sq, Sk, Hq, Hkv, scale, causal};
  return entry<false>(a, D, dtype, stream);
}

extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int Sq, int Sk,
                                 int Hq, int Hkv, int D, int causal,
                                 float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               B, Sq, Sk, Hq, Hkv, scale, causal};
  return entry<true>(a, D, dtype, stream);
}
