// Hopper building blocks shared by the sm_90a kernels (quant_matmul_sm90.cu,
// quant_matmul_m128_sm90.cu, ffn_sm90.cu, dense_matmul_sm90.cu,
// prefill_attention_sm90.cu): mbarriers,
// TMA loads (cp.async.bulk.tensor and the plain bulk copy), the async-proxy
// fence, the int8 weight tile's conversion into mma fragments, thread-block
// clusters (rank, barriers, mapa and st.async into another
// rank's shared memory), wgmma (shared-memory descriptors, fence, commit,
// wait), and the host side's tensor-map encoding and its per-(pointer,
// shape) cache.  cuTensorMapEncodeTiled comes through
// cudaGetDriverEntryPoint, so the library needs no -lcuda; a failed encode
// returns an error (the wrappers raise), never a fallback.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "attention_common.cuh"  // pack_bf16x2

namespace md {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) from global memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Generic-proxy shared-memory accesses before the async proxy (TMA, wgmma)
// touches the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- int8 weight tiles as mma operands (the int8 weight-streaming dots) ----

__device__ __forceinline__ void ldsm_x4_u32(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans_u32(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// (a & b) | c in one logic op: written out, with b and c constants, the
// compiler emits two (a SASS LOP3 takes one immediate)
__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Bytes b0..b3 of w (signed int8) -> even = bf16x2 {b0, b2}, odd = {b1, b3}
// (low half first), exactly: with low7 = b & 0x7F and sign = b & 0x80,
// bf16 0x4300 | low7 is 128 + low7 and 0x4300 | sign is 128 or 256, so
// their difference is b (an integer |b| <= 128, exact in bf16).  Two
// logic ops and a bf16x2 subtraction a pair, no conversion unit.  An
// ldmatrix.trans register of the int8 tile holds (k, col 2g), (k, col
// 2g+1), (k+1, col 2g), (k+1, col 2g+1): even and odd are the k-pairs of the
// two columns, i.e. mma B fragments.
__device__ __forceinline__ uint32_t i8_pair(uint32_t w) {  // bytes 0 and 2 of w
  const uint32_t lo = lop3_and_or(w, 0x007F007Fu, 0x43004300u);
  const uint32_t hi = lop3_and_or(w, 0x00800080u, 0x43004300u);
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void i8_pairs(uint32_t w, uint32_t& even, uint32_t& odd) {
  even = i8_pair(w);
  odd = i8_pair(w >> 8);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint2 pack_bf16x4(const float v[4]) {
  return make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// ---- the rms-norm prologue of the weight-streaming dots -----------------------

// acc + the sum of the squares of eight bf16 values
__device__ __forceinline__ float sum_sq8(float acc, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    acc += f.x * f.x;
    acc += f.y * f.y;
  }
  return acc;
}

// bf16(bf16(x * r) * w) of a bf16 pair (the norm of x by its factor r and
// the norm weight w)
__device__ __forceinline__ uint32_t norm_pair(uint32_t xv, uint32_t wv, float r) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  const __nv_bfloat162 n = __floats2bfloat162_rn(f.x * r, f.y * r);
  const __nv_bfloat162 o = __hmul2(n, *reinterpret_cast<const __nv_bfloat162*>(&wv));
  return *reinterpret_cast<const uint32_t*>(&o);
}

// ---- clusters ----------------------------------------------------------------

// Every non-exited thread of the cluster (release, then acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory location in cluster rank `rank`.
__device__ __forceinline__ uint32_t rank_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Remote stores that complete on the receiving rank's mbarrier (its
// transaction count falls by the bytes stored).
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_f32x4(uint32_t addr, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

// The rms-norm factors rr[m] = 1 / sqrt(mean(x[m]^2) + eps) of rows 0..M-1
// of x [M, In], the contraction split over the `split` ranks of a cluster,
// computed by the NCW consumer warps (threads 0 .. 32 NCW - 1).  This rank
// sums the squares of its range [k0, k1) of every row (warp w takes rows w,
// w + NCW, ... eight at a time, each lane its 16-byte chunks in order, two a
// row in flight together, then a fixed shuffle tree) and stores each partial
// into slot [rank] of every rank's ssq ([split][max_rows] f32) by st.async
// on that rank's stat barrier, whose transaction count the caller set to
// split * M * 4 bytes; every rank adds the slots in rank order, so every
// block of a row holds the same factor bit for bit.  Completes the
// cluster's initial barrier (cluster_wait) before the first remote store
// and ends with the consumers' named barrier 1.
template <int NCW>
__device__ __forceinline__ void row_norm_factors(const __nv_bfloat16* x, int M, int In, int k0,
                                                 int k1, float eps, int max_rows, float* ssq,
                                                 float* rr, uint32_t stat_bar, uint32_t rank,
                                                 int split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunk = (k1 - k0) / 8;
  bool waited = false;
  for (int mb = warp; mb < M; mb += 8 * NCW) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int c = lane; c < nchunk; c += 64) {
      uint4 v[8][2];  // chunks c and c + 32 of eight rows: 16 loads in flight
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = mb + j * NCW, ce = c + 32 * e;
          v[j][e] = m < M && ce < nchunk
                        ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * In + k0 + ce * 8))
                        : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = sum_sq8(sum_sq8(acc[j], v[j][0]), v[j][1]);
    }
    if (!waited) {
      cluster_wait();
      waited = true;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      // lane s stores the partial into slot [rank] of rank s
      const int m = mb + j * NCW;
      if (lane < split && m < M)
        st_async_f32(rank_addr(smem_u32(ssq + rank * max_rows + m), lane), v,
                     rank_addr(stat_bar, lane));
    }
  }
  if (!waited) cluster_wait();
  mbar_wait(stat_bar, 0);  // every rank's partials have landed
  for (int m = threadIdx.x; m < M; m += NCW * 32) {
    float tot = 0.f;
    for (int s = 0; s < split; ++s) tot += ssq[s * max_rows + m];
    rr[m] = 1.f / sqrtf(tot / (float)In + eps);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCW * 32) : "memory");  // rr for every consumer
}

// ---- wgmma ---------------------------------------------------------------------

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, 128-byte swizzle.  The start address advances in 16-byte units
// by adding to the descriptor.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of a wgmma operand across the
// asynchronous window (issue to wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// An error the wrapper reports as a failed tensor-map encode (CUresult added)
constexpr int kEncodeError = 0x10000;

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D tensor map over a row-major [rows, cols] array of `elem` bytes an
// element, box {box_cols, box_rows}.  Out-of-bounds rows read as zeros.
inline CUresult encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                          int elem, uint64_t cols, uint64_t rows, uint32_t box_cols,
                          uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A 3-D tensor map over a row-major [planes, rows, cols] array of `elem`
// bytes an element, box {box_cols, box_rows, 1}.  Out-of-bounds rows read as
// zeros.
inline CUresult encode_3d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int elem,
                          uint64_t cols, uint64_t rows, uint64_t planes, uint32_t box_cols,
                          uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * elem, cols * rows * elem};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A tensor map encoded by `encode(map)` once per key (a pointer and a
// shape) and cached: a map holds only the pointer, shape and strides, so an
// entry stays right for whatever later lives at that address with that
// shape.  Each call site (each Encode type) keeps its own cache.
template <typename Key, typename Encode>
inline CUresult cached_map(CUtensorMap* map, const Key& key, Encode encode) {
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return CUDA_SUCCESS;
  }
  const CUresult res = encode(map);
  if (res == CUDA_SUCCESS) {
    if (cache.size() >= 4096) cache.clear();
    cache.emplace(key, *map);
  }
  return res;
}

// A bf16 weight's map over its row-major [rows, cols] elements: boxes of 64
// columns (128 bytes a row) by 64 rows, 8 KB, under the 128-byte swizzle;
// encoded once per (pointer, shape).  B15's dense_matmul_fused and
// dense_mlp stream their weights in these boxes.
inline CUresult bf16_weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  return cached_map(map, std::make_tuple(w, rows, cols), [&](CUtensorMap* m) {
    return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, cols, rows, 64, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  });
}

}  // namespace sm90
}  // namespace md
