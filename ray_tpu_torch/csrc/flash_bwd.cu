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
// training lengths both are bound by arithmetic, on the tensor cores.
// What the design does about it, by input type and head dim:
//  * bf16 at D 64 and 128 (every path of the port): warp-specialised
//    kernels on `wgmma.mma_async` (hopper.cuh). One producer warp keeps
//    TMA loads (`cp.async.bulk.tensor`, 128-byte swizzle) of the
//    streamed tiles in flight through a 3-stage ring of full/empty
//    mbarriers, so no consumer waits on device memory; two consumer
//    warpgroups of 64 rows each take the producer's registers
//    (`setmaxnreg`). S and dP (or S^T and dP^T) are wgmma with both
//    operands in shared memory; the second products take P and dS from
//    registers (the 64-row accumulator, rounded to bf16, is wgmma's
//    register-A layout) and B from the same shared tile through a
//    transposed (MN-major) descriptor: no operand is gathered element by
//    element.
//  * bf16 at D 16 and 32 keep the `mma.sync.m16n8k16` kernels (a wgmma
//    tile is at least 64 wide in K and the TMA box at least 16 bytes;
//    no path of the port runs these head dims).
//  * fp32 runs on scalar fp32 FMAs from shared memory, so fp32 results
//    stay exact products (the port's fp32 parity checks need it).
// P and dS are rounded to bf16 before the products that take them, as
// the Pallas kernels do (`p.astype(do.dtype)`, `ds.astype(q.dtype)`).
// The S x S scores and probabilities never reach device memory, and
// causal tiles that see no key of a warpgroup are not computed.
//
// Differences from the TPU grids:
//  * K2a: one CTA per (batch*q-head, q tile: 128 rows for wgmma, 64
//    for mma.sync and fp32), looping over key tiles inside the block and
//    stopping at the diagonal under causal masking; the heaviest (last)
//    q tiles are launched first.
//  * K2b: one CTA per (batch*kv-head, key tile: 128 keys for wgmma, 64
//    otherwise). It loops over the Hq/Hkv query heads of its group and
//    over their q tiles, and keeps dK/dV for the kv head in fp32
//    registers. GQA thus needs no expanded K/V, no atomics and no second
//    reduction pass, and the result is deterministic; this replaces the
//    reference's repeat-then-sum (`jnp.repeat` of K/V before the kernel,
//    summed back by autodiff). Under causal masking the q loop starts at
//    the key tile's first row, and the wgmma grid launches the key tiles
//    with the most query rows first.
//  * ragged edges are masked in the kernels (no padded copies; TMA reads
//    rows past the end as zeros, and the mask still decides);
//  * lse and delta are (B*Hq, Sq) fp32, not the Mosaic (BH, 1, S) layout.
// Kept: causal masking compares absolute indices (key k <= query q);
// masked and out-of-range entries of P are 0.
//
// Layouts: q/dO/dQ (B, Sq, Hq, D), k/v/dK/dV (B, Sk, Hkv, D), all
// contiguous and 16-byte aligned; float32 or bfloat16 storage (dQ in q's
// type, dK/dV in k's type). They allocate nothing and run on the
// caller's stream.

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16 at D 64 and 128: warp-specialised wgmma kernels ----------------
//
// 384 threads: warpgroups 0 and 1 consume, each owning 64 rows of the
// CTA's 128-row tile (query rows in K2a, key rows in K2b: wgmma's M);
// warpgroup 2 produces, one warp of it issuing TMA loads into a ring of
// kStages stages guarded by full/empty mbarriers, and gives its
// registers to the consumers (setmaxnreg). The tile that stays (Q and dO
// in K2a, K and V in K2b) is loaded once by TMA; the streamed tiles (K
// and V in K2a; Q, dO, lse and delta in K2b) pass through the ring.
//
// A consumer's step: S (or S^T) and dP (or dP^T) as wgmma with both
// operands in shared memory (K-major: every tile is stored [row][d]);
// P and dS in fp32 registers under the masks; then the second products
// with A from registers (the 64-row accumulator, rounded to bf16, is
// already wgmma's register-A layout) and B the streamed or resident
// tile read MN-major through a descriptor with the transpose bit.

constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kWsThreads = (kConsumers + 1) * kWG;
constexpr int kTileRows = kConsumers * 64;  // rows of the resident tile
constexpr int kStreamRows = 64;           // rows of a streamed tile
constexpr int kStages = 3;
// The launch gives each thread 168 registers (64K / 384, rounded down to
// 8), 64512 a CTA; 24 * 128 + 240 * 256 = 64512 splits them. K2b's
// consumers at D 128 hold 128 fp32 of dK/dV and 64 of S^T/dP^T: at 232
// registers ptxas spills, at 240 it does not.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

using rtt::align_1024;
using rtt::gemm_rs;
using rtt::gemm_ss;
using rtt::pack_a;
using rtt::store_rows;
using rtt::Tile;
using rtt::tma_tile;

template <int D>
struct DqLayout {
  using QTile = Tile<kTileRows, D>;
  using KTile = Tile<kStreamRows, D>;
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + QTile::kBytes;
  static constexpr int kK = kO + QTile::kBytes;            // kStages tiles
  static constexpr int kV = kK + kStages * KTile::kBytes;  // kStages tiles
  static constexpr int kBar = kV + kStages * KTile::kBytes;
  static constexpr size_t kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Sq, int Sk, int Hq, int Hkv, float scale,
                    int causal) {
  using L = DqLayout<D>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const QTile sQ{reinterpret_cast<bf16*>(smem + L::kQ)};
  const QTile sO{reinterpret_cast<bf16*>(smem + L::kO)};
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* qo_full = empty + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  // the heaviest (last) q tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;
  const int k_end = causal ? min(Sk, q0 + kTileRows) : Sk;
  const int n_tiles = (k_end + kStreamRows - 1) / kStreamRows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      rtt::mbar_init(&full[s], 1);
      rtt::mbar_init(&empty[s], kConsumers * kWG);
    }
    rtt::mbar_init(qo_full, 1);
    rtt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers * kWG) {
    // ---- producer ----
    rtt::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * kWG) {
      rtt::tma_prefetch_map(&map_k);
      rtt::tma_prefetch_map(&map_v);
      rtt::mbar_arrive_expect_tx(qo_full, 2 * QTile::kBytes);
      tma_tile(sQ, &map_q, qo_full, h, q0, b);
      tma_tile(sO, &map_o, qo_full, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        rtt::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        rtt::mbar_arrive_expect_tx(&full[s], 2 * KTile::kBytes);
        const KTile sK{reinterpret_cast<bf16*>(smem + L::kK) +
                       s * KTile::kBytes / 2};
        const KTile sV{reinterpret_cast<bf16*>(smem + L::kV) +
                       s * KTile::kBytes / 2};
        tma_tile(sK, &map_k, &full[s], kvh, n * kStreamRows, b);
        tma_tile(sV, &map_v, &full[s], kvh, n * kStreamRows, b);
      }
    }
  } else {
    // ---- consumers ----
    rtt::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWG;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = wg * 64;  // this warpgroup's rows of the q tile
    const int qpos[2] = {q0 + row0 + ((tid >> 5) & 3) * 16 + g,
                         q0 + row0 + ((tid >> 5) & 3) * 16 + g + 8};
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lr[r] = qpos[r] < Sq ? lse[(long)bh * Sq + qpos[r]] : 0.f;
      dr[r] = qpos[r] < Sq ? delta[(long)bh * Sq + qpos[r]] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    rtt::mbar_wait(qo_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int k0 = n * kStreamRows;
      const KTile sK{reinterpret_cast<bf16*>(smem + L::kK) +
                     s * KTile::kBytes / 2};
      const KTile sV{reinterpret_cast<bf16*>(smem + L::kV) +
                     s * KTile::kBytes / 2};
      rtt::mbar_wait(&full[s], (n / kStages) & 1);
      // under causal masking a key tile past all 64 rows adds nothing
      if (!causal || k0 <= q0 + row0 + 63) {
        // the first products overwrite these (scale_d = 0): nothing
        // carries from one tile to the next
        float sc[32], dp[32];
        rtt::fence_regs(sc);
        rtt::fence_regs(dp);
        rtt::wgmma_fence();
        gemm_ss(sc, sQ, row0, sK);     // S = Q K^T
        gemm_ss(dp, sO, row0, sV);     // dP = dO V^T
        rtt::wgmma_commit();
        rtt::wgmma_wait_all();
        rtt::fence_regs(sc);
        rtt::fence_regs(dp);
        // element i: row qpos[(i >> 1) & 1], key k0 + 8 (i >> 2) + 2t + i%2
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool ok = kpos < Sk && qpos[r] < Sq &&
                          (!causal || kpos <= qpos[r]);
          const float p = ok ? __expf(sc[i] * scale - lr[r]) : 0.f;
          sc[i] = p * (dp[i] - dr[r]) * scale;
        }
        uint32_t a[4][4];
        pack_a(sc, a);
        rtt::fence_regs(acc);
        rtt::wgmma_fence();
        gemm_rs(acc, a, sK);           // dQ += dS K
        rtt::wgmma_commit();
        rtt::wgmma_wait_all();
        rtt::fence_regs(acc);
      }
      rtt::mbar_arrive(&empty[s]);
    }
    const long stride = (long)Hq * D;
    store_rows<D>(acc, dq + (long)b * Sq * stride + (long)h * D, stride,
                  qpos, Sq, t);
  }
}

template <int D>
struct DkvLayout {
  using KTile = Tile<kTileRows, D>;
  using QTile = Tile<kStreamRows, D>;
  static constexpr int kK = 0;
  static constexpr int kV = kK + KTile::kBytes;
  static constexpr int kQ = kV + KTile::kBytes;            // kStages tiles
  static constexpr int kO = kQ + kStages * QTile::kBytes;  // kStages tiles
  static constexpr int kL = kO + kStages * QTile::kBytes;  // [kStages][64]
  static constexpr int kD = kL + kStages * kStreamRows * 4;
  static constexpr int kBar = kD + kStages * kStreamRows * 4;
  static constexpr size_t kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                     int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = DkvLayout<D>;
  using KTile = typename L::KTile;
  using QTile = typename L::QTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const KTile sK{reinterpret_cast<bf16*>(smem + L::kK)};
  const KTile sV{reinterpret_cast<bf16*>(smem + L::kV)};
  float* sL = reinterpret_cast<float*>(smem + L::kL);
  float* sD = reinterpret_cast<float*>(smem + L::kD);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int rep = Hq / Hkv;
  // key tiles in launch order: blockIdx.y = 0 (the most query rows under
  // causal masking) is dispatched first
  const int k0 = blockIdx.y * kTileRows;
  // causal: query rows before k0 see none of this CTA's keys
  const int q_begin = causal ? k0 : 0;
  const int per_head =
      Sq > q_begin ? (Sq - q_begin + kStreamRows - 1) / kStreamRows : 0;
  const int n_tiles = rep * per_head;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      rtt::mbar_init(&full[s], 32);
      rtt::mbar_init(&empty[s], kConsumers * kWG);
    }
    rtt::mbar_init(kv_full, 1);
    rtt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers * kWG) {
    // ---- producer: the first warp of warpgroup 2 ----
    rtt::setmaxnreg_dec<kProducerRegs>();
    const int lane = tid - kConsumers * kWG;
    if (lane < 32) {
      if (lane == 0) {
        rtt::tma_prefetch_map(&map_q);
        rtt::tma_prefetch_map(&map_o);
        rtt::mbar_arrive_expect_tx(kv_full, 2 * KTile::kBytes);
        tma_tile(sK, &map_k, kv_full, kvh, k0, b);
        tma_tile(sV, &map_v, kv_full, kvh, k0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const int h = kvh * rep + n / per_head;
        const int q0 = q_begin + (n % per_head) * kStreamRows;
        rtt::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        if (lane == 0) {
          rtt::mbar_expect_tx(&full[s], 2 * QTile::kBytes);
          const QTile sQ{reinterpret_cast<bf16*>(smem + L::kQ) +
                         s * QTile::kBytes / 2};
          const QTile sO{reinterpret_cast<bf16*>(smem + L::kO) +
                         s * QTile::kBytes / 2};
          tma_tile(sQ, &map_q, &full[s], h, q0, b);
          tma_tile(sO, &map_o, &full[s], h, q0, b);
        }
        // lse and delta rows are Sq floats, no multiple of 16 bytes in
        // general, so no TMA map takes them: the warp copies them
        const long row = ((long)b * Hq + h) * Sq;
#pragma unroll
        for (int i = lane; i < kStreamRows; i += 32) {
          const int qr = q0 + i;
          sL[s * kStreamRows + i] = qr < Sq ? lse[row + qr] : 0.f;
          sD[s * kStreamRows + i] = qr < Sq ? delta[row + qr] : 0.f;
        }
        rtt::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers ----
    rtt::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWG;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = wg * 64;  // this warpgroup's keys of the k tile
    const int kpos[2] = {k0 + row0 + ((tid >> 5) & 3) * 16 + g,
                         k0 + row0 + ((tid >> 5) & 3) * 16 + g + 8};
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    rtt::mbar_wait(kv_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      const int q0 = q_begin + (n % per_head) * kStreamRows;
      const QTile sQ{reinterpret_cast<bf16*>(smem + L::kQ) +
                     s * QTile::kBytes / 2};
      const QTile sO{reinterpret_cast<bf16*>(smem + L::kO) +
                     s * QTile::kBytes / 2};
      const float* lq = sL + s * kStreamRows;
      const float* dlt = sD + s * kStreamRows;
      rtt::mbar_wait(&full[s], (n / kStages) & 1);
      // under causal masking a q tile before all 64 keys adds nothing
      if (!causal || q0 + kStreamRows - 1 >= k0 + row0) {
        float st[32], dpt[32];  // overwritten by the first products
        rtt::fence_regs(st);
        rtt::fence_regs(dpt);
        rtt::wgmma_fence();
        gemm_ss(st, sK, row0, sQ);     // S^T = K Q^T
        gemm_ss(dpt, sV, row0, sO);    // dP^T = V dO^T
        rtt::wgmma_commit();
        rtt::wgmma_wait_all();
        rtt::fence_regs(st);
        rtt::fence_regs(dpt);
        // element i: key kpos[(i >> 1) & 1], query q0 + 8 (i >> 2) + 2t +
        // i%2
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          const int qpos = q0 + col;
          const bool ok = qpos < Sq && kpos[r] < Sk &&
                          (!causal || kpos[r] <= qpos);
          const float p = ok ? __expf(st[i] * scale - lq[col]) : 0.f;
          dpt[i] = p * (dpt[i] - dlt[col]) * scale;
          st[i] = p;
        }
        uint32_t pa[4][4], sa[4][4];
        pack_a(st, pa);
        pack_a(dpt, sa);
        rtt::fence_regs(acc_k);
        rtt::fence_regs(acc_v);
        rtt::wgmma_fence();
        gemm_rs(acc_v, pa, sO);        // dV += P^T dO
        gemm_rs(acc_k, sa, sQ);        // dK += dS^T Q
        rtt::wgmma_commit();
        rtt::wgmma_wait_all();
        rtt::fence_regs(acc_k);
        rtt::fence_regs(acc_v);
      }
      rtt::mbar_arrive(&empty[s]);
    }
    const long stride = (long)Hkv * D;
    const long off = (long)b * Sk * stride + (long)kvh * D;
    store_rows<D>(acc_k, dk + off, stride, kpos, Sk, t);
    store_rows<D>(acc_v, dv + off, stride, kpos, Sk, t);
  }
}

template <int D>
cudaError_t make_maps(const Args& a, int q_rows, int kv_rows,
                      CUtensorMap (&m)[4]) {
  cudaError_t e;
  if ((e = rtt::make_bshd_map(&m[0], a.q, a.B, a.Sq, a.Hq, D, q_rows)) ||
      (e = rtt::make_bshd_map(&m[1], a.k, a.B, a.Sk, a.Hkv, D, kv_rows)) ||
      (e = rtt::make_bshd_map(&m[2], a.v, a.B, a.Sk, a.Hkv, D, kv_rows)) ||
      (e = rtt::make_bshd_map(&m[3], a.dout, a.B, a.Sq, a.Hq, D, q_rows)))
    return e;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t err = make_maps<D>(a, kTileRows, kStreamRows, m);
  if (err != cudaSuccess) return err;
  const size_t smem = DqLayout<D>::kBytes;
  if ((err = prepare(bwd_dq_wgmma_kernel<D>, smem)) != cudaSuccess)
    return err;
  dim3 grid(a.B * a.Hq, (a.Sq + kTileRows - 1) / kTileRows);
  bwd_dq_wgmma_kernel<D><<<grid, kWsThreads, smem, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.Sq,
      a.Sk, a.Hq, a.Hkv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t err = make_maps<D>(a, kStreamRows, kTileRows, m);
  if (err != cudaSuccess) return err;
  const size_t smem = DkvLayout<D>::kBytes;
  if ((err = prepare(bwd_dkv_wgmma_kernel<D>, smem)) != cudaSuccess)
    return err;
  dim3 grid(a.B * a.Hkv, (a.Sk + kTileRows - 1) / kTileRows);
  bwd_dkv_wgmma_kernel<D><<<grid, kWsThreads, smem, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, bool bf, cudaStream_t st) {
  if (bf) {
    // by head dim: wgmma at 64 and 128, mma.sync at 16 and 32
    if constexpr (D >= 64) {
      return launch_dq_wgmma<D>(a, st);
    } else {
      const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
      const size_t smem = dq_mma_smem_bytes<D>();
      cudaError_t err = prepare(bwd_dq_mma_kernel<D>, smem);
      if (err != cudaSuccess) return err;
      bwd_dq_mma_kernel<D><<<grid, kThreads, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
          static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale,
          a.causal);
    }
  } else {
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
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
  if (bf) {
    // by head dim: wgmma at 64 and 128, mma.sync at 16 and 32
    if constexpr (D >= 64) {
      return launch_dkv_wgmma<D>(a, st);
    } else {
      const dim3 grid((a.Sk + kBK - 1) / kBK, a.B * a.Hkv);
      const size_t smem = dkv_mma_smem_bytes<D>();
      cudaError_t err = prepare(bwd_dkv_mma_kernel<D>, smem);
      if (err != cudaSuccess) return err;
      bwd_dkv_mma_kernel<D><<<grid, kThreads, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk,
          a.Hq, a.Hkv, a.scale, a.causal);
    }
  } else {
    const dim3 grid((a.Sk + kBK - 1) / kBK, a.B * a.Hkv);
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
