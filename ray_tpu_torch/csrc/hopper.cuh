// Hopper (sm_90a) building blocks for the port's kernels, in inline PTX:
// mbarriers, 1-D bulk copies (`cp.async.bulk`) and TMA tile loads
// (`cp.async.bulk.tensor`), warpgroup matrix
// products (`wgmma.mma_async`) with their shared-memory descriptors,
// `setmaxnreg`, the swizzled tiles and the products on them that the
// flash forward and backward share, and the host-side tensor-map encoder
// reached through `cudaGetDriverEntryPoint` (so no library needs
// `-lcuda`).
//
// Shared-memory tiles are in the layout a TMA load with the 128-byte
// swizzle writes: a tile of R rows and D bf16 columns is D/64 column
// blocks, each R rows of 128 bytes (64 values), every 8 rows (1024
// bytes) one swizzle atom. Each block starts on a 1024-byte boundary.
// The descriptors below read such a block either way round:
//  * K-major (`desc_kmajor`): rows are M or N, the 64 columns are K;
//    the k-th 16-deep step starts 32 bytes further in the row, and the
//    next 64 columns are the next block.
//  * MN-major (`desc_mnmajor`, used with the transpose bit): rows are
//    K, columns are N; LBO is the stride from one 64-column block to the
//    next, SBO the 1024 bytes from 8 rows of K to the next 8, and the
//    k-th 16-deep step starts 16 rows (2048 bytes) further.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace rtt {

using bf16 = __nv_bfloat16;

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Announce `bytes` of TMA traffic for the barrier's current phase
// (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---- 1-D bulk copies ---------------------------------------------------------
//
// The TMA unit copying one contiguous byte range, with no tensor map:
// `bytes` a multiple of 16, both addresses 16-byte aligned.

// Global -> shared; completion is counted on `bar` (announce the bytes
// with mbar_arrive_expect_tx first).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared -> global, tracked by bulk groups (bulk_commit, bulk_wait*).
// The threads that wrote `src` run fence_proxy_async() before the
// barrier that precedes this.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)),
                 "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N committed bulk groups are still running.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order this thread's shared-memory writes before later reads of the
// same bytes by the async proxy (a bulk store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ----------------------------------------------------------------------

// A 4-D box {c0, c1, c2, c3} (innermost first) of the tensor map into
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- warpgroup products ------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for a register-A operand that a running product still reads:
// its registers stay live, and unchanged, up to this point.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Descriptor of a 128-byte-swizzled operand in shared memory.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major block: rows of 128 bytes, 8-row groups 1024 bytes apart (LBO
// is not read for swizzled K-major operands).
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return make_desc(p, 16, 1024);
}

// MN-major: `block_bytes` from one 64-column block to the next.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p,
                                                 uint32_t block_bytes) {
  return make_desc(p, block_bytes, 1024);
}

// d (64 x N, fp32) (+)= A (64 x 16) B (16 x N): A and B from shared
// memory, both K-major. scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// The same with A from registers (the m16n8k16 A fragment of the
// thread's warp: rows 16w + g and + 8, k columns 2t, 2t + 1 and + 8) and
// B MN-major (the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// ---- tiles and the products on them (flash forward and backward) -----

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// A tile of R rows x D columns in shared memory, as D/64 column blocks
// of R x 64; `block(c)` is column block c.
template <int R, int D>
struct Tile {
  static constexpr int kBytes = R * D * 2;
  static constexpr uint32_t kBlockBytes = R * 128;
  bf16* p;
  __device__ __forceinline__ bf16* block(int c) const { return p + c * R * 64; }
};

// Load rows [row0, row0 + R) of head `h` of batch `b` from a (B, S, H, D)
// map: D/64 boxes of R x 64.
template <int R, int D>
__device__ __forceinline__ void tma_tile(const Tile<R, D>& t,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int h, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(t.block(c), map, bar, c * 64, h, row0, b);
}

// d = A B^T over all D columns of two K-major tiles (the first k step
// overwrites d): A is the 64 rows of `a` from row `a_row`, B^T all RB
// rows of `bt`.
template <int RA, int RB, int D>
__device__ __forceinline__ void gemm_ss(float (&d)[RB / 2],
                                        const Tile<RA, D>& a, int a_row,
                                        const Tile<RB, D>& bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 16;
    wgmma_ss<RB>(d, desc_kmajor(a.block(c) + a_row * 64 + off),
                 desc_kmajor(bt.block(c) + off), kk > 0);
  }
}

// d += A B: A (64 x 64) from registers (4 k steps of the packed
// fragment), B the 64 rows of `bt` read MN-major (K = rows, N = D).
template <int RB, int D>
__device__ __forceinline__ void gemm_rs(float (&d)[D / 2],
                                        const uint32_t (&a)[4][4],
                                        const Tile<RB, D>& bt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tb<D>(d, a[kk],
                   desc_mnmajor(bt.p + kk * 16 * 64, Tile<RB, D>::kBlockBytes),
                   1);
}

// The 64 x 64 fp32 accumulator of this thread as 4 k steps of wgmma's
// register-A fragment, rounded to bf16.
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Store a 64 x D fp32 accumulator (rows 16w + g and + 8 of the thread's
// warp) as bf16 rows of a (B, S, H, D) array; rows at or past `nrows`
// are left alone.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           bf16* base, long stride,
                                           const int (&pos)[2], int nrows,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] >= nrows) continue;
    bf16* row = base + (long)pos[r] * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---- host: tensor maps ------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found once at run time.
inline decltype(&cuTensorMapEncodeTiled) tensor_map_encoder() {
  static decltype(&cuTensorMapEncodeTiled) fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p);
  }();
  return fn;
}

// Map of a contiguous (B, S, H, D) bf16 array, read as boxes of `rows`
// rows of one (b, h) and 64 columns: {64, 1, rows, 1} over {D, H, S, B},
// 128-byte swizzle, rows past S read as zeros. D must be a multiple of
// 64 and the base 16-byte aligned.
inline cudaError_t make_bshd_map(CUtensorMap* map, const void* base, int B,
                                 int S, int H, int D, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace rtt
