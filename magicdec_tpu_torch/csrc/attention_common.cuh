// The pieces the attention sources share: the operands (AttnArgs), a row's
// address in a contiguous cache or a page pool (RowAddr), mma.sync /
// ldmatrix / cp.async, the exact int4 conversion, and the pass that merges
// split partials (combine_kernel).  The decode kernels K1, K1q, B10 and
// B12's paged twins run on decode_attention_sm90.cu, the prefill kernels
// K2, K2q and B11 on prefill_attention_sm90.cu; the sm90 dots take the mma
// helpers.
//
// Contracts the attention kernels keep:
//
// Rows are packed t-major inside a kv head: row r is token t = r / G of query
// head h*G + r % G, so a row block covers consecutive tokens and its causal
// extent is known from its last row.
//
// Fresh rows (the window's own K/V, appended by the caller after the layer
// loop) are read AT THEIR POSITIONS [base, base + T): a tile takes cache rows
// below base and fresh rows from there on, as if they were appended already.
// Every query row then meets the same columns in the same tiles, in the same
// order, whether its token comes in a verify window or alone in an
// autoregressive step; with row-invariant dense dots the two give the same
// bits (the greedy spec == AR contract on the card).
//
// Masking follows magicdec_tpu's kernels exactly: scores of invisible columns
// are set to -1e30 (not -inf), the running max starts at -1e30, and the
// output is acc / max(l, 1e-30).  The quantized kernels add the scales as
// magicdec_tpu's _quant_online_update does: the score of column c is s_raw *
// (k_scale[c] * 1/sqrt(hd)), masked after scaling; the normaliser l sums the
// unscaled p, and the P.V product takes bf16(p * v_scale[c]).
//
// Page pools (PAGED = true).  The cache is a pool [L, P, ps, K] shared by
// all requests, and row r of request b lives in page table[b*npr + r/ps] at
// row r%ps (scales: pool [L, P, Hkv, ps]).  Only the address of a row
// changes (RowAddr); tiles, splits and arithmetic are the contiguous
// kernel's at S = npr*ps, so a paged launch gives the bits of a contiguous
// launch over the gathered cache.  RowAddr resolves a page per 16-byte chunk
// (and per scale, or bf16 pair of scales), so a tile may span pages of any size.  Rows at or
// past a request's visible length are never read through the table.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace md {

constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const __nv_bfloat16* q;      // [B, T, Hq, HD]
  const __nv_bfloat16* k;      // [L, B, S, Hkv*HD]  (bf16 caches)
  const __nv_bfloat16* v;
  const __nv_bfloat16* k_new;  // [B, T, Hkv*HD] fresh rows, or null
  const __nv_bfloat16* v_new;
  const int8_t* kq;            // [L, B, S, Hkv*HD]  (int8 caches;
                               //  int4: [L, B, S, (Hkv/2)*HD] packed)
  const int8_t* vq;
  const int8_t* kq_new;        // [B, T, Hkv*HD] fresh int8 rows, or null
  const int8_t* vq_new;
  const void* k_scale;         // [L, B, Hkv, S] f32, or bf16 (the kernel's
  const void* v_scale;         //  scale type)
  const void* ks_new;          // [B, Hkv, T] scales of the fresh rows
  const void* vs_new;
  const int* base_lens;        // [B]
  __nv_bfloat16* out;          // [B, T, Hq, HD]            (nsplit == 1)
  float* part_o;               // [B, Hkv, nsplit, R, HD]   (nsplit > 1)
  float* part_ml;              // [B, Hkv, nsplit, R, 2]
  const int* table;            // [B, npr] pool page of each logical page (PAGED)
  int layer, B, S, T, Hq, Hkv, nsplit, chunk;
  int P, ps, npr;              // PAGED: pool pages, rows per page, pages per
                               // request (S = npr * ps)
};

// Where KV position r of one (layer, request, head) lies: contiguous, row r
// of the request's rows (base + r * stride); paged, row r % ps of pool page
// table[r / ps] (base + table[r / ps] * page_stride + (r % ps) * stride).
template <typename T, bool PAGED>
struct RowAddr {
  const T* base;       // contiguous: position 0; paged: page 0 of the layer
  const int* table;    // paged: the request's row of the page table
  size_t page_stride;  // paged: elements from one page to the next
  int stride;          // elements from one position to the next inside a page
  int ps;              // paged: rows per page
  __device__ __forceinline__ const T* operator()(int r) const {
    if constexpr (PAGED)
      return base + (size_t)__ldg(table + r / ps) * page_stride + (size_t)(r % ps) * stride;
    else
      return base + (size_t)r * stride;
  }
};

// The rows of head lane offset h_lane of request b in layer a.layer of a
// cache (or pool) whose rows are K elements wide.
template <typename T, bool PAGED>
__device__ __forceinline__ RowAddr<T, PAGED> kv_rows(const AttnArgs& a, const T* cache, int b,
                                                     int K, int h_lane) {
  if constexpr (PAGED)
    return {cache + (size_t)a.layer * a.P * a.ps * K + h_lane, a.table + (size_t)b * a.npr,
            (size_t)a.ps * K, K, a.ps};
  else
    return {cache + (((size_t)a.layer * a.B + b) * a.S) * K + h_lane, nullptr, 0, K, 0};
}

// The scales (of type T) of kv head h of request b in layer a.layer:
// [L, B, Hkv, S] contiguous, [L, P, Hkv, ps] paged.
template <typename T, bool PAGED>
__device__ __forceinline__ RowAddr<T, PAGED> scale_rows(const AttnArgs& a, const T* scale, int b,
                                                        int h) {
  if constexpr (PAGED)
    return {scale + ((size_t)a.layer * a.P * a.Hkv + h) * a.ps, a.table + (size_t)b * a.npr,
            (size_t)a.Hkv * a.ps, 1, a.ps};
  else
    return {scale + (((size_t)a.layer * a.B + b) * a.Hkv + h) * a.S, nullptr, 0, 1, 0};
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, one register each; lane l gives
// the address of row l % 8 of matrix l / 8.  Lane l receives row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of each matrix (of its transpose with
// .trans): exactly an mma B fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy from global to shared memory; with valid false
// it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
// 4-byte asynchronous copy (the .ca form: .cg copies 16 bytes only); with
// valid false it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Four packed bytes (one word, byte 0 first) -> the four values of one
// nibble plane (shift 0: the low nibbles, 4: the high ones) as bf16, two
// words, lo holding bytes 0 and 1 (the int4 producer of
// prefill_attention_sm90.cu).  Exact, without the conversion unit: the
// nibble n of value v has n ^ 8 == v + 8 in [0, 15]; as the low mantissa
// bits under bf16's exponent of 2^7 it reads 128 + v + 8, and subtracting
// 136 (exact: the difference is representable) leaves v.
__device__ __forceinline__ void i4x4_to_bf16x4(uint32_t w, int shift, uint32_t& lo,
                                               uint32_t& hi) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t x[2] = {((__byte_perm(w, 0u, 0x4140) >> shift) & 0x000F000Fu) ^ 0x43084308u,
                   ((__byte_perm(w, 0u, 0x4342) >> shift) & 0x000F000Fu) ^ 0x43084308u};
  const __nv_bfloat162 v0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x[0]), bias);
  const __nv_bfloat162 v1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x[1]), bias);
  lo = *reinterpret_cast<const uint32_t*>(&v0);
  hi = *reinterpret_cast<const uint32_t*>(&v1);
}

// Merge the (o, m, l) partials of the splits of each (request, kv head)
// into the normalised bf16 output.  Grid (row blocks, Hkv, B): a thread a
// (row, 4 dims), its splits' loads independent (a pass to the max, one to
// the sums).  Row r (token t) reads the splits below its visible end base +
// t + 1 only: a split past it holds no position the row sees (its partial
// adds exact zeros), and a bf16 block with no visible position writes no
// partial at all.
constexpr int kCombineThreads = 128;
template <int HD>
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(AttnArgs a, int R) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  const int idx = blockIdx.x * kCombineThreads + threadIdx.x;
  if (idx >= GT * (HD / 4)) return;
  const int r = idx / (HD / 4), d = 4 * (idx % (HD / 4));
  const int lim = min(a.base_lens[b] + r / G + 1, a.S);
  const int ns = min(a.nsplit, (lim + a.chunk - 1) / a.chunk);
  const size_t row0 = ((size_t)b * a.Hkv + h) * a.nsplit * R + r;  // split s: row0 + s * R
  float m = kNegInf;
#pragma unroll 4
  for (int s = 0; s < ns; ++s) m = fmaxf(m, __ldg(a.part_ml + (row0 + (size_t)s * R) * 2));
  float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = 0; s < ns; ++s) {
    const size_t pr = row0 + (size_t)s * R;
    const float2 ml = __ldg(reinterpret_cast<const float2*>(a.part_ml + pr * 2));
    const float4 po = __ldg(reinterpret_cast<const float4*>(a.part_o + pr * HD + d));
    const float c = __expf(ml.x - m);
    l += ml.y * c;
    o[0] += po.x * c;
    o[1] += po.y * c;
    o[2] += po.z * c;
    o[3] += po.w * c;
  }
  const float lm = fmaxf(l, 1e-30f);
  const int t = r / G, gq = r % G;
  *reinterpret_cast<uint2*>(a.out + (((size_t)b * a.T + t) * a.Hq + h * G + gq) * HD + d) =
      make_uint2(pack_bf16x2(o[0] / lm, o[1] / lm), pack_bf16x2(o[2] / lm, o[3] / lm));
}

template <int HD>
inline void launch_combine(const AttnArgs& a, int R, cudaStream_t stream) {
  const int items = (a.Hq / a.Hkv) * a.T * (HD / 4);
  const dim3 grid((items + kCombineThreads - 1) / kCombineThreads, a.Hkv, a.B);
  combine_kernel<HD><<<grid, kCombineThreads, 0, stream>>>(a, R);
}

// The page pool's operands (S = npr * ps); false when they are not a pool's.
inline bool paged_shape(AttnArgs& a, const void* table, int P, int ps, int npr) {
  if (ps <= 0 || npr <= 0 || P <= 0) return false;
  a.table = static_cast<const int*>(table);
  a.P = P;
  a.ps = ps;
  a.npr = npr;
  a.S = npr * ps;
  return true;
}

}  // namespace md
