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
// does about it:
//  * split-KV: each sequence's key range is cut into splits of
//    `split_keys` keys (a whole number of pages, chosen on the host from
//    the page table's width alone), one CTA per (sequence, kv head,
//    split), so a decode batch of a few long sequences still fills the
//    card; a second small kernel merges the splits' partial softmaxes;
//  * each CTA keeps kStages - 1 chunks of K/V rows in flight through a
//    shared-memory ring filled by 16-byte `cp.async` copies straight from
//    the (N_flat, Hkv, D) pools: no gathered copy, no expansion by head;
//  * all `rep` query heads of a kv head share one read of each row: a
//    lane holds a 16-byte slice of a key row, takes its partial dot
//    products with every query head's slice, and the lanes of the row
//    sum them with warp shuffles; in P.V a lane converts its slice of a
//    V row once for four query heads;
//  * pages past a sequence's bound are never touched.
//
// Grid: (S, Hkv, n_split). A CTA reads its own page_table, lengths and
// qpos entries (replacing the scalar prefetch) and its keys
// [split * split_keys, ...) below bound = min(lengths, qpos + 1,
// P * page_size) (qpos + 1 is the causal bound a replayed query at an
// earlier position needs). It runs an online softmax (base 2) over
// chunks of 64 keys in bf16, 32 in fp32 (at D 16, one per row group of
// lanes), 256 threads sharing each, and writes, for each of its query
// heads, the unnormalised output, the max and the sum to fp32 partials
// of shape (S, Hq, n_split, D) and (S, Hq, n_split); a split that starts
// at or past the bound touches no page and writes an empty partial (max
// -inf, sum 0). The merge kernel combines a row's partials by the
// logsumexp rule; a row with no valid key writes 0. With one split the
// CTA normalises and writes O itself and no merge runs.
//
// Layouts: q/out (S, Hq, D); k_pool/v_pool (N_flat, Hkv, D);
// page_table (S, P) int32; lengths, qpos (S,) int32; all contiguous,
// pools 16-byte aligned. float32 or bfloat16 storage, fp32 arithmetic.
// The wrapper allocates the partials; the kernels allocate nothing and
// run on the caller's stream.

#include "common.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 256;  // two CTAs an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;     // query heads per kv head
constexpr int kStages = 3;      // chunks in the ring
constexpr int kMaxPages = 512;  // pages of one split
constexpr float kLog2e = 1.4426950408889634f;

// Work split of a CTA for element type T and head dim D.
template <typename T, int D>
struct Geo {
  static constexpr int kVec = 16 / sizeof(T);        // elements of a slice
  static constexpr int kLanes = D / kVec;            // slices of a row
  static constexpr int kGroups = kThreads / kLanes;  // rows at once
  // keys of a chunk: 64 in bf16, 32 in fp32, or one a row group
  static constexpr int kChunk =
      128 / sizeof(T) > kGroups ? 128 / sizeof(T) : kGroups;
  static constexpr int kPasses = kChunk / kGroups;
  static_assert(kLanes <= 32 && kChunk % kGroups == 0, "geometry");
  // the running max, sum and rescale factor of each head and the
  // split's page ids; then the ring [kStages][K, V][kChunk][D] of T, sQ
  // [kMaxRep][D] and sS [kMaxRep][kChunk] in fp32. The end-of-split sums
  // over key partitions, [KP][rep][D] fp32 with KP * rep <= 4 * kGroups,
  // reuse the ring and what follows it.
  static constexpr int kRingElems = kStages * 2 * kChunk * D;
  static constexpr size_t kStatOff = 0;
  static constexpr size_t kPageOff = kStatOff + sizeof(float) * 3 * kMaxRep;
  static constexpr size_t kRingOff = kPageOff + sizeof(int) * kMaxPages;
  static constexpr size_t kQOff = kRingOff + sizeof(T) * kRingElems;
  static constexpr size_t kSOff = kQOff + sizeof(float) * kMaxRep * D;
  static constexpr size_t kEnd = kSOff + sizeof(float) * kMaxRep * kChunk;
  static constexpr size_t kRedEnd = kRingOff + sizeof(float) * 4 * kGroups * D;
  static constexpr size_t kBytes = kEnd > kRedEnd ? kEnd : kRedEnd;
};

// Sums four partial dot products (query heads r0 .. r0 + 3 against one
// key row) over the kLanes lanes of the row and stores the scores of
// the heads below `rep` to col[head * stride], or -inf where the key is
// not `valid`. With four or more lanes a row, the first two steps trade
// halves (a reduce-scatter) so that a quarter of the lanes keeps each
// head, then plain butterfly steps finish: log2(kLanes) + 1 shuffles in
// place of 4 log2(kLanes).
template <int kLanes>
__device__ __forceinline__ void store_scores(const float (&v)[4], int lane,
                                             int r0, int rep, float* col,
                                             int stride, float scale,
                                             bool valid) {
  if constexpr (kLanes >= 4) {
    constexpr int h1 = kLanes / 2, h2 = kLanes / 4;
    const bool up1 = lane & h1, up2 = lane & h2;
    const float keep0 = (up1 ? v[2] : v[0]) +
                        __shfl_xor_sync(0xffffffffu, up1 ? v[0] : v[2], h1);
    const float keep1 = (up1 ? v[3] : v[1]) +
                        __shfl_xor_sync(0xffffffffu, up1 ? v[1] : v[3], h1);
    float x = (up2 ? keep1 : keep0) +
              __shfl_xor_sync(0xffffffffu, up2 ? keep0 : keep1, h2);
#pragma unroll
    for (int o = h2 / 2; o > 0; o >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, o);
    const int r = r0 + (up1 ? 2 : 0) + (up2 ? 1 : 0);
    if (lane % h2 == 0 && r < rep)
      col[r * stride] = valid ? x * scale : -INFINITY;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x = rtt::group_sum<kLanes>(v[u]);
      if (lane % kLanes == 0 && r0 + u < rep)
        col[(r0 + u) * stride] = valid ? x * scale : -INFINITY;
    }
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void load_slice(const T* p, float (&x)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = rtt::to_f32(e[i]);
}

// One CTA: kv head g of sequence s, keys of split blockIdx.z. With
// `direct` (a single split) it writes O; otherwise the partials.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const int* __restrict__ qpos, T* __restrict__ out,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int Hq, int Hkv,
                    int page_size, int P, int split_keys, float scale) {
  using G = Geo<T, D>;
  constexpr int kVec = G::kVec, kLanes = G::kLanes, kGroups = G::kGroups;
  constexpr int kChunk = G::kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem + G::kRingOff);
  float* sQ = reinterpret_cast<float*>(smem + G::kQOff);
  float* sS = reinterpret_cast<float*>(smem + G::kSOff);
  float* sM = reinterpret_cast<float*>(smem + G::kStatOff);  // running max
  float* sL = sM + kMaxRep;                                  // running sum
  float* sC = sL + kMaxRep;                 // this chunk's rescale factor
  int* sPT = reinterpret_cast<int*>(smem + G::kPageOff);

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const bool direct = n_split == 1;
  const int tid = threadIdx.x;
  const int rep = Hq / Hkv;
  const int bound = min(min(lengths[s], qpos[s] + 1), P * page_size);
  const int c_begin = split * split_keys;
  const int c_end = min(c_begin + split_keys, bound);
  const long head0 = (long)s * Hq + (long)g * rep;  // first query head

  if (c_begin >= c_end) {
    // nothing to read: an empty partial, or (one split) a zero row
    if (direct) {
      for (int i = tid; i < rep * D; i += kThreads)
        out[head0 * D + i] = rtt::from_f32<T>(0.f);
    } else if (tid < rep) {
      m_part[(head0 + tid) * n_split + split] = -INFINITY;
      l_part[(head0 + tid) * n_split + split] = 0.f;
    }
    return;
  }
  const int n_chunks = (c_end - c_begin + kChunk - 1) / kChunk;
  const long row_stride = (long)Hkv * D;
  const long head_off = (long)g * D;
  // the split's page ids, read once (split_keys is whole pages)
  const int page0 = c_begin / page_size;
  const int n_pages = (c_end - 1) / page_size - page0 + 1;
  for (int i = tid; i < n_pages; i += kThreads)
    sPT[i] = page_table[(long)s * P + page0 + i];
  __syncthreads();

  // chunk c into stage c % kStages: rows at or past c_end are not copied
  // and never read
  auto issue = [&](int c) {
    T* dk = ring + (c % kStages) * 2 * kChunk * D;
    T* dv = dk + kChunk * D;
    const int key0 = c_begin + c * kChunk;
#pragma unroll
    for (int i = tid; i < kChunk * kLanes; i += kThreads) {
      const int j = i / kLanes;
      const int col = (i % kLanes) * kVec;
      const int pos = key0 + j;
      if (pos < c_end) {
        const long row =
            (long)sPT[pos / page_size - page0] * page_size + pos % page_size;
        const long off = row * row_stride + head_off + col;
        rtt::cp_async16(dk + j * D + col, k_pool + off);
        rtt::cp_async16(dv + j * D + col, v_pool + off);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    rtt::cp_async_commit();
  }

  const T* qb = q + head0 * D;
  for (int i = tid; i < rep * D; i += kThreads) sQ[i] = rtt::to_f32(qb[i]);
  if (tid < rep) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int grp = tid / kLanes;            // row group
  const int col = (tid % kLanes) * kVec;   // this lane's slice of a row
  const float scale2 = scale * kLog2e;
  // P.V: row group grp takes the four heads 4 hb .. 4 hb + 3 (those below
  // rep) and keys kp, kp + KP, ... of each chunk, so a V slice, once
  // converted, serves four heads
  const int hw = (rep + 3) / 4;   // groups of four heads
  const int KP = kGroups / hw;    // key partitions
  const int hb = grp % hw, kp = grp / hw;
  const bool pv_active = kp < KP;
  float acc[4][kVec];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[a][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int nk = min(kChunk, c_end - c_begin - c * kChunk);
    rtt::cp_async_wait<kStages - 2>();
    // chunk c has landed for every thread; chunk c - 1 is consumed, so
    // its stage takes chunk c + kStages - 1
    __syncthreads();
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    rtt::cp_async_commit();
    const T* sK = ring + (c % kStages) * 2 * kChunk * D;
    const T* sV = sK + kChunk * D;

    // scores, base 2: row group grp takes keys grp, grp + kGroups, ...,
    // and forms them four query heads at a time
    float kx[G::kPasses][kVec];
#pragma unroll
    for (int pass = 0; pass < G::kPasses; ++pass)
      load_slice<T, kVec>(sK + (pass * kGroups + grp) * D + col, kx[pass]);
    for (int r0 = 0; r0 < rep; r0 += 4) {
      float qv[4][kVec];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 x = r0 + u < rep ? *reinterpret_cast<const float4*>(
                                              sQ + (r0 + u) * D + col + e)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
          qv[u][e] = x.x;
          qv[u][e + 1] = x.y;
          qv[u][e + 2] = x.z;
          qv[u][e + 3] = x.w;
        }
#pragma unroll
      for (int pass = 0; pass < G::kPasses; ++pass) {
        const int j = pass * kGroups + grp;
        float dot[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dot[u] = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dot[u] = fmaf(qv[u][e], kx[pass][e], dot[u]);
        }
        store_scores<kLanes>(dot, lane, r0, rep, sS + j, kChunk, scale2,
                             j < nk);
      }
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + kWarps, ...
    for (int r = warp; r < rep; r += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, sS[r * kChunk + j]);
      mx = rtt::group_max<32>(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);   // finite: nk >= 1
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float p = rtt::exp2_approx(sS[r * kChunk + j] - m_new);
        sS[r * kChunk + j] = p;
        sum += p;
      }
      sum = rtt::group_sum<32>(sum);
      if (lane == 0) {
        const float corr = rtt::exp2_approx(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    if (pv_active) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float corr = 4 * hb + a < rep ? sC[4 * hb + a] : 1.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[a][e] *= corr;
      }
#pragma unroll 2
      for (int j = kp; j < nk; j += KP) {
        float vx[kVec];
        load_slice<T, kVec>(sV + j * D + col, vx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          // heads past rep take p = 0 and are never stored
          const float p =
              4 * hb + a < rep ? sS[(4 * hb + a) * kChunk + j] : 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[a][e] = fmaf(p, vx[e], acc[a][e]);
        }
      }
    }
  }

  // sum the key partitions: red [KP][rep][D] over the ring
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + G::kRingOff);
  if (pv_active) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * hb + a;
      if (r < rep)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          red[(kp * rep + r) * D + col + e] = acc[a][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    float v = 0.f;
    for (int p = 0; p < KP; ++p) v += red[p * rep * D + i];
    const int r = i / D;
    if (direct) {
      const float l = sL[r];
      out[head0 * D + i] = rtt::from_f32<T>(v / (l == 0.f ? 1.f : l));
    } else {
      o_part[((head0 + r) * n_split + split) * D + i % D] = v;
    }
  }
  if (!direct && tid < rep) {
    m_part[(head0 + tid) * n_split + split] = sM[tid];
    l_part[(head0 + tid) * n_split + split] = sL[tid];
  }
}

// One CTA per (sequence, query head): O = sum_i 2^(m_i - M) o_i / L with
// M = max m_i and L = sum_i 2^(m_i - M) l_i over the non-empty splits; 0
// where every split is empty. The row's maxima and sums are read once
// into shared memory (2 * n_split floats), then turned into weights.
template <typename T>
__global__ void paged_merge_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   T* __restrict__ out, int D, int n_split) {
  extern __shared__ float sw[];   // [n_split] maxima, then weights
  float* sl = sw + n_split;       // [n_split] sums
  const long row = blockIdx.x;   // s * Hq + h
  for (int i = threadIdx.x; i < n_split; i += blockDim.x) {
    sw[i] = m_part[row * n_split + i];
    sl[i] = l_part[row * n_split + i];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int i = 0; i < n_split; ++i)
    if (sl[i] > 0.f) M = fmaxf(M, sw[i]);
  float L = 0.f;
  for (int i = 0; i < n_split; ++i)
    if (sl[i] > 0.f) L += sl[i] * exp2f(sw[i] - M);
  __syncthreads();   // every thread has read the maxima
  for (int i = threadIdx.x; i < n_split; i += blockDim.x)
    sw[i] = sl[i] > 0.f ? exp2f(sw[i] - M) : 0.f;
  __syncthreads();
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) {
      // an empty split's partial was never written: its weight is 0 and
      // its value is not used
      const float x = o_part[(row * n_split + i) * D + d];
      acc += sw[i] > 0.f ? sw[i] * x : 0.f;
    }
    out[row * D + d] = rtt::from_f32<T>(acc * inv);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *page_table, *lengths, *qpos;
  void *out, *o_part, *ml_part;
  int S, Hq, Hkv, page_size, P, split_keys, n_split;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geo<T, D>;
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  float* m_part = static_cast<float*>(a.ml_part);
  float* l_part = m_part == nullptr
                      ? nullptr
                      : m_part + (long)a.S * a.Hq * a.n_split;
  dim3 grid(a.S, a.Hkv, a.n_split);
  kern<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.qpos),
      static_cast<T*>(a.out), static_cast<float*>(a.o_part), m_part, l_part,
      a.Hq, a.Hkv, a.page_size, a.P, a.split_keys, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 1)
    return err;
  paged_merge_kernel<T><<<a.S * a.Hq, D, 2 * sizeof(float) * a.n_split,
                          stream>>>(
      static_cast<const float*>(a.o_part), m_part, l_part,
      static_cast<T*>(a.out), D, a.n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. o_part (S, Hq, n_split, D) and
// ml_part (2, S, Hq, n_split), fp32, are needed when n_split > 1; the
// splits of split_keys keys (a multiple of page_size) must cover the
// table's P * page_size keys. Returns a cudaError_t (0 = launched).
extern "C" int rtt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* page_table,
                                const void* lengths, const void* qpos,
                                void* out, void* o_part, void* ml_part,
                                int S, int Hq, int Hkv, int D,
                                int page_size, int P, int n_flat,
                                int split_keys, int n_split, float scale,
                                int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRep || page_size <= 0 ||
      n_flat % page_size != 0 || Hkv > 65535 || split_keys <= 0 ||
      split_keys % page_size != 0 || split_keys / page_size > kMaxPages ||
      n_split < 1 || n_split > 4096 ||
      (long)n_split * split_keys < (long)P * page_size ||
      (n_split > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, page_table, lengths, qpos, out,
               o_part, ml_part, S, Hq, Hkv, page_size, P, split_keys,
               n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, a, st);
  return (int)cudaErrorInvalidValue;
}
