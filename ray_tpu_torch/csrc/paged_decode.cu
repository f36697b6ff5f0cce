// K3: single-token decode attention over a paged KV pool, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `paged_decode_attention`). Python
// wrapper: ray_tpu_torch/ops/kernels/paged_attention.py.
//
// What bounds it on the card: each key row is read once and used for
// 4*rep*D operations (rep = Hq/Hkv query heads), about 16 operations per
// byte for Llama-3-8B in bf16, far below the H100's ~295: the bound is
// the bytes of the K/V rows the sequences actually hold. What the design
// does about it: K/V rows are read straight from the (N_flat, Hkv, D)
// pools as 16-byte vectors, never gathered into a contiguous copy and
// never expanded by head; all `rep` query heads of a kv head share one
// read of each row; the next 64-key chunk is loaded into registers while
// the current one is computed; pages past a sequence's bound are never
// touched.
//
// Differences from the TPU grid: one CTA per (sequence, kv head) covers
// that head's `rep` query heads and reads its own page_table, lengths and
// qpos entries (replacing the scalar prefetch); the loop over pages runs
// inside the block with an online softmax, in chunks of 64 keys, and
// stops at min(lengths, qpos + 1) (the causal bound a replayed query at
// an earlier position needs) and at the table's width P * page_size.
// A row with no valid key writes 0.
//
// Known limit: decode-batch parallelism is at most max_slots x Hkv CTAs
// (72 for 9 slots of Llama-3-8B on 132 SMs), each walking its whole
// sequence alone. Splitting the page loop across blocks is later work.
//
// Layouts: q/out (S, Hq, D); k_pool/v_pool (N_flat, Hkv, D);
// page_table (S, P) int32; lengths, qpos (S,) int32; all contiguous,
// pools 16-byte aligned. float32 or bfloat16 storage, fp32 arithmetic.
// It allocates nothing and runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                   // keys per online-softmax step
constexpr int kMaxRep = 16;                  // query heads per kv head
constexpr int kHeadGroups = kThreads / kChunk;
constexpr int kHeadsPerThread = kMaxRep / kHeadGroups;

template <int D>
constexpr size_t smem_bytes() {
  // sQ [kMaxRep][D], sK [kChunk][D+1], sV [kChunk][D],
  // sS [kMaxRep][kChunk], sM/sL/sC [kMaxRep]
  return sizeof(float) * (kMaxRep * D + kChunk * (D + 1) + kChunk * D +
                          kMaxRep * kChunk + 3 * kMaxRep);
}

// One chunk of K and V rows, kVec elements per 16-byte vector, spread
// over the CTA: thread t holds vectors t, t + kThreads, ...
template <typename T, int D>
struct ChunkRegs {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVecPerRow = D / kVec;
  static constexpr int kTotal = kChunk * kVecPerRow;
  static constexpr int kPerThread = (kTotal + kThreads - 1) / kThreads;
  uint4 k[kPerThread];
  uint4 v[kPerThread];

  __device__ __forceinline__ void load(const T* k_pool, const T* v_pool,
                                       const int* pt, int c0, int bound,
                                       int page_size, long row_stride,
                                       long head_off, int tid) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int vi = tid + kThreads * i;
      const int j = vi / kVecPerRow;
      const int pos = c0 + j;
      if (vi < kTotal && pos < bound) {
        const long row = (long)pt[pos / page_size] * page_size +
                         pos % page_size;
        const long off = row * row_stride + head_off +
                         (vi % kVecPerRow) * kVec;
        k[i] = *reinterpret_cast<const uint4*>(k_pool + off);
        v[i] = *reinterpret_cast<const uint4*>(v_pool + off);
      } else {
        k[i] = make_uint4(0, 0, 0, 0);
        v[i] = make_uint4(0, 0, 0, 0);
      }
    }
  }

  __device__ __forceinline__ void store(float* sK, float* sV, int tid) const {
    constexpr int DP = D + 1;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int vi = tid + kThreads * i;
      if (vi >= kTotal) continue;
      const int j = vi / kVecPerRow;
      const int d0 = (vi % kVecPerRow) * kVec;
      const T* kx = reinterpret_cast<const T*>(&k[i]);
      const T* vx = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sK[j * DP + d0 + e] = rtt::to_f32(kx[e]);
        sV[j * D + d0 + e] = rtt::to_f32(vx[e]);
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const int* __restrict__ qpos, T* __restrict__ out,
                    int Hq, int Hkv, int page_size, int P, float scale) {
  constexpr int DP = D + 1;
  constexpr int kStep = kThreads / D;          // heads apart per accumulator
  constexpr int APT = kMaxRep * D / kThreads;  // accumulators per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kMaxRep * D;
  float* sV = sK + kChunk * DP;
  float* sS = sV + kChunk * D;
  float* sM = sS + kMaxRep * kChunk;   // running max per query head
  float* sL = sM + kMaxRep;            // running sum per query head
  float* sC = sL + kMaxRep;            // this chunk's rescale factor

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int rep = Hq / Hkv;
  int bound = min(lengths[s], qpos[s] + 1);
  bound = min(bound, P * page_size);

  const T* qb = q + ((long)s * Hq + (long)g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) sQ[i] = rtt::to_f32(qb[i]);
  if (tid < rep) {
    sM[tid] = rtt::kNegInf;
    sL[tid] = 0.f;
  }
  float acc[APT];
#pragma unroll
  for (int a = 0; a < APT; ++a) acc[a] = 0.f;

  const long row_stride = (long)Hkv * D;
  const long head_off = (long)g * D;
  const int* pt = page_table + (long)s * P;
  const int warp = tid >> 5, lane = tid & 31;
  const int sj = tid % kChunk, sg = tid / kChunk;  // score: key, head group
  const int od = tid % D, orow = tid / D;          // output: column, head

  ChunkRegs<T, D> regs;
  if (bound > 0)
    regs.load(k_pool, v_pool, pt, 0, bound, page_size, row_stride, head_off,
              tid);

  for (int c0 = 0; c0 < bound; c0 += kChunk) {
    const int nk = min(kChunk, bound - c0);
    __syncthreads();  // previous chunk consumed; sQ/sM/sL written
    regs.store(sK, sV, tid);
    if (c0 + kChunk < bound)  // next chunk's loads fly during this one
      regs.load(k_pool, v_pool, pt, c0 + kChunk, bound, page_size,
                row_stride, head_off, tid);
    __syncthreads();

    // scores: thread (sj, sg) takes key sj for heads sg, sg + groups, ...
    float sc[kHeadsPerThread];
#pragma unroll
    for (int i = 0; i < kHeadsPerThread; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kx = sK[sj * DP + d];
#pragma unroll
      for (int i = 0; i < kHeadsPerThread; ++i) {
        const int r = sg + kHeadGroups * i;
        if (r < rep) sc[i] = fmaf(sQ[r * D + d], kx, sc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kHeadsPerThread; ++i) {
      const int r = sg + kHeadGroups * i;
      if (r < rep)
        sS[r * kChunk + sj] = sj < nk ? sc[i] * scale : rtt::kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kWarps) {
      float mx = rtt::kNegInf;
      for (int j = lane; j < kChunk; j += 32)
        mx = fmaxf(mx, sS[r * kChunk + j]);
      mx = rtt::group_max<32>(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float p = j < nk ? __expf(sS[r * kChunk + j] - m_new) : 0.f;
        sS[r * kChunk + j] = p;
        sum += p;
      }
      sum = rtt::group_sum<32>(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread (od, orow) owns column od of heads orow, orow + kStep, ...
#pragma unroll
    for (int a = 0; a < APT; ++a) {
      const int r = orow + kStep * a;
      if (r < rep) acc[a] *= sC[r];
    }
    for (int j = 0; j < nk; ++j) {
      const float vx = sV[j * D + od];
#pragma unroll
      for (int a = 0; a < APT; ++a) {
        const int r = orow + kStep * a;
        if (r < rep) acc[a] = fmaf(sS[r * kChunk + j], vx, acc[a]);
      }
    }
  }
  __syncthreads();  // sL final (also when the loop never ran)

  T* ob = out + ((long)s * Hq + (long)g * rep) * D;
#pragma unroll
  for (int a = 0; a < APT; ++a) {
    const int r = orow + kStep * a;
    if (r < rep) {
      const float l = sL[r];
      const float safe_l = l == 0.f ? 1.f : l;
      ob[r * D + od] = rtt::from_f32<T>(acc[a] / safe_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths,
                   const void* qpos, void* out, int S, int Hq, int Hkv,
                   int page_size, int P, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<const int*>(qpos),
      static_cast<T*>(out), Hq, Hkv, page_size, P, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const void* page_table,
                       const void* lengths, const void* qpos, void* out,
                       int S, int Hq, int Hkv, int page_size, int P,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k_pool, v_pool, page_table, lengths, qpos, out, S, Hq, Hkv, page_size, P, scale, stream);
    case 32: return launch<T, 32>(q, k_pool, v_pool, page_table, lengths, qpos, out, S, Hq, Hkv, page_size, P, scale, stream);
    case 64: return launch<T, 64>(q, k_pool, v_pool, page_table, lengths, qpos, out, S, Hq, Hkv, page_size, P, scale, stream);
    case 128: return launch<T, 128>(q, k_pool, v_pool, page_table, lengths, qpos, out, S, Hq, Hkv, page_size, P, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rtt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* page_table,
                                const void* lengths, const void* qpos,
                                void* out, int S, int Hq, int Hkv, int D,
                                int page_size, int P, int n_flat, float scale,
                                int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRep || page_size <= 0 ||
      n_flat % page_size != 0 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k_pool, v_pool, page_table, lengths,
                                  qpos, out, S, Hq, Hkv, page_size, P, scale,
                                  st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, page_table,
                                          lengths, qpos, out, S, Hq, Hkv,
                                          page_size, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
