// Shared flash-attention core of the decode (K1, K1q, B10, B12) and bf16
// prefill (K2) kernels, which replace magicdec_tpu/ops/pallas/
// decode_attention.py (_decode_kernel, _decode_quant_kernel,
// _decode_quant4_kernel), paged_attention.py (_paged_call's kernels) and
// prefill_attention.py (_prefill_kernel).  The quantized prefill kernels
// (K2q, B11: _prefill_quant_kernel, _prefill_quant4_kernel) run on their own
// Hopper kernel, prefill_attention_sm90.cu.
//
// Bound: bytes for the decode (few query rows over a long cache: K1 and K1q
// stream the cache once), tensor-core operations and exponentials for K2
// (each visible (row, column) pair costs 4 hd flops and one exp; at hd = 64
// the two bounds are about equal on the H100).  The design serves both with
// one tile loop: one thread block serves one (request b, kv head h) and a
// run of W*16 grouped query rows; each warp owns 16 rows and keeps their
// fp32 online softmax state (running max m, normaliser l, accumulator o) in
// registers.  The block walks a range of KV rows in tiles of N rows staged
// in shared memory by cp.async, two stages deep (the next tile's copy
// overlaps this tile's arithmetic); each warp computes S = Q K^T and O += P
// V with the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; K
// and V fragments through ldmatrix).  That is the pre-Hopper tensor-core
// path: K2 runs S, softmax and P V in turn and stays at about 20% of its
// bound (PERF.md), and is next in line for the wgmma core of
// prefill_attention_sm90.cu.
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
// output is acc / max(l, 1e-30).
//
// int8 caches (QUANT = true: the K1q decode kernel).  The cache holds int8
// rows with one f32 scale per (token, kv head), scales laid out [L, B, Hkv,
// S] so a tile's columns of one head are contiguous.  A tile stages its int8
// rows (HD bytes a row, four 16-byte cp.async) and its k and v scales
// (4-byte cp.async each) two stages deep; after the copy lands, each thread
// converts the chunks it copied to bf16 (exact: |q| <= 127, by integer and
// float adds, i8x4_to_bf16x4) into the tile the tensor-core code reads, so
// the mma path is K1's.  The scales follow magicdec_tpu's
// _quant_online_update: the score of column c is s_raw * (k_scale[c] *
// 1/sqrt(hd)), masked after scaling; the normaliser l sums the unscaled p,
// and the P.V product takes bf16(p * v_scale[c]).
//
// int4 caches (QUANT and INT4: the B10 decode kernel).  The cache packs kv
// heads 2i and 2i+1 into the low and high nibbles of packed pseudo-head i,
// lane for lane, so a row is (Hkv/2)*HD bytes and head h's HD lanes sit at
// (h/2)*HD; the scales are the int8 path's.  A block of head h stages those
// HD bytes a row exactly as the int8 path stages its own, and converts the
// (h & 1) nibble plane (i4x4_to_bf16x4: exact, no conversion unit), so the
// tiles, the mma path and the scale order are K1q's.  Heads 2i and 2i+1 run
// in separate blocks that read the same packed bytes: the second read
// mostly hits L2 (the blocks of one request's heads run side by side), so
// DRAM traffic stays at the packed bytes, while the L2 traffic is that of
// an int8 cache.
//
// Page pools (PAGED = true: the B12 paged decode kernels).  The cache is a
// pool [L, P, ps, K] shared by all requests, and row r of request b lives
// in page table[b*npr + r/ps] at row r%ps (scales: pool [L, P, Hkv, ps]).
// Only the address of a row changes (RowAddr); tiles, splits and
// arithmetic are the contiguous kernel's at S = npr*ps, so a paged launch
// gives the bits of a contiguous launch over the gathered cache.  A page
// is resolved per 16-byte chunk (and per 4-byte scale), so a 32-row tile
// may span pages of any size.  Rows at or past a request's visible length
// are never read through the table.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace md {

constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const __nv_bfloat16* q;      // [B, T, Hq, HD]
  const __nv_bfloat16* k;      // [L, B, S, Hkv*HD]  (bf16 caches)
  const __nv_bfloat16* v;
  const __nv_bfloat16* k_new;  // [B, T, Hkv*HD] fresh rows, or null
  const __nv_bfloat16* v_new;
  const int8_t* kq;            // [L, B, S, Hkv*HD]  (int8 caches, QUANT;
                               //  int4: [L, B, S, (Hkv/2)*HD] packed)
  const int8_t* vq;
  const int8_t* kq_new;        // [B, T, Hkv*HD] fresh int8 rows, or null
  const int8_t* vq_new;
  const float* k_scale;        // [L, B, Hkv, S]
  const float* v_scale;
  const float* ks_new;         // [B, Hkv, T] scales of the fresh rows
  const float* vs_new;
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

// The scales of kv head h of request b in layer a.layer: [L, B, Hkv, S]
// contiguous, [L, P, Hkv, ps] paged.
template <bool PAGED>
__device__ __forceinline__ RowAddr<float, PAGED> scale_rows(const AttnArgs& a,
                                                            const float* scale, int b, int h) {
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

// Start copying KV positions [c0, c0 + N) into a padded shared tile:
// positions below `fresh_at` from the cache (row addresses from `cache`),
// from there on from the fresh rows (row stride `stride`).  Positions at
// or past c_end are zero-filled, so a masked column never multiplies
// uninitialised memory.
template <int HD, int N, int NT, typename Addr>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const Addr& cache,
                                          const __nv_bfloat16* fresh, int fresh_at,
                                          int stride, int c0, int c_end) {
  constexpr int kVec = HD / 8;
  constexpr int LD = HD + 8;
  for (int i = threadIdx.x; i < N * kVec; i += NT) {
    const int row = i / kVec, c8 = i % kVec, col = c0 + row;
    const bool valid = col < c_end;
    const __nv_bfloat16* src = !valid           ? cache.base
                               : col < fresh_at ? cache(col) + c8 * 8
                                                : fresh + (size_t)(col - fresh_at) * stride + c8 * 8;
    cp_async16(dst + row * LD + c8 * 8, src, valid);
  }
}

// int8 counterpart of load_tile: positions [c0, c0 + N) of one head, HD
// bytes a row, into dst [N][HD] bytes.
template <int HD, int N, int NT, typename Addr>
__device__ __forceinline__ void load_tile_i8(int8_t* dst, const Addr& cache,
                                             const int8_t* fresh, int fresh_at, int stride,
                                             int c0, int c_end) {
  constexpr int kVec = HD / 16;
  for (int i = threadIdx.x; i < N * kVec; i += NT) {
    const int row = i / kVec, c16 = i % kVec, col = c0 + row;
    const bool valid = col < c_end;
    const int8_t* src = !valid           ? cache.base
                        : col < fresh_at ? cache(col) + c16 * 16
                                         : fresh + (size_t)(col - fresh_at) * stride + c16 * 16;
    cp_async16(dst + row * HD + c16 * 16, src, valid);
  }
}

// The scales of positions [c0, c0 + N) of one head: `cache` addresses the
// head's scales (scale_rows), `fresh` points at the fresh rows' (T columns,
// the first at position fresh_at).  Zero past c_end.
template <int N, int NT, typename Addr>
__device__ __forceinline__ void load_scales(float* dst, const Addr& cache, const float* fresh,
                                            int fresh_at, int c0, int c_end) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const int col = c0 + i;
    const bool valid = col < c_end;
    const float* src = !valid ? cache.base : col < fresh_at ? cache(col) : fresh + (col - fresh_at);
    cp_async4(dst + i, src, valid);
  }
}

// Four int8 (one word, byte 0 first) -> four bf16 (two words, lo holds
// bytes 0 and 1), exactly and without the conversion unit, which runs at a
// fraction of the ALU rate and would bound K1q: byte v, its sign bit
// flipped (v + 128), goes under the exponent of 2^23, so the float is
// 2^23 + v + 128; subtracting 2^23 + 128 leaves v, and a float holding an
// integer of at most 8 significant bits is its bf16 in the upper half.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kMagic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kMagic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kMagic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kMagic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// int8 -> bf16 of the chunks of an int8 tile that this thread copied in
// load_tile_i8 (the same index walk), into the padded bf16 tile: the
// thread's own cp.async groups have landed once it has waited, so no
// barrier is needed before the conversion, only after it.
template <int HD, int N, int NT>
__device__ __forceinline__ void convert_tile(__nv_bfloat16* dst, const int8_t* src) {
  constexpr int kVec = HD / 16;
  constexpr int LD = HD + 8;
  for (int i = threadIdx.x; i < N * kVec; i += NT) {
    const int row = i / kVec, c16 = i % kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * HD + c16 * 16);
    uint32_t w[8];
    i8x4_to_bf16x4(raw.x, w[0], w[1]);
    i8x4_to_bf16x4(raw.y, w[2], w[3]);
    i8x4_to_bf16x4(raw.z, w[4], w[5]);
    i8x4_to_bf16x4(raw.w, w[6], w[7]);
    uint4* d = reinterpret_cast<uint4*>(dst + row * LD + c16 * 16);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Four packed bytes (one word, byte 0 first) -> the four values of one
// nibble plane (shift 0: the low nibbles, 4: the high ones) as bf16, two
// words, lo holding bytes 0 and 1.  Exact, without the conversion unit: the
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

// int4 counterpart of convert_tile: the chunks this thread copied in
// load_tile_i8 hold 16 lanes of packed pairs; their `shift` plane goes into
// the padded bf16 tile.
template <int HD, int N, int NT>
__device__ __forceinline__ void convert_tile_i4(__nv_bfloat16* dst, const int8_t* src,
                                                int shift) {
  constexpr int kVec = HD / 16;
  constexpr int LD = HD + 8;
  for (int i = threadIdx.x; i < N * kVec; i += NT) {
    const int row = i / kVec, c16 = i % kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * HD + c16 * 16);
    uint32_t w[8];
    i4x4_to_bf16x4(raw.x, shift, w[0], w[1]);
    i4x4_to_bf16x4(raw.y, shift, w[2], w[3]);
    i4x4_to_bf16x4(raw.z, shift, w[4], w[5]);
    i4x4_to_bf16x4(raw.w, shift, w[6], w[7]);
    uint4* d = reinterpret_cast<uint4*>(dst + row * LD + c16 * 16);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <int HD>
struct WarpState {
  uint32_t qf[HD / 16][4];  // Q as mma A fragments
  float o[HD / 8][4];       // O accumulator (mma C fragments)
  float m[2], l[2];         // rows g and g + 8 (l: this thread's partial sum)
};

// One online-softmax update of a warp's 16 rows with the N-column tile held
// in Ks/Vs.  Column col0 + c is visible to the thread's row i iff
// col0 + c < lim[i].  QUANT: ksc/vsc hold the tile's k and v scales.
template <int HD, int N, bool QUANT = false>
__device__ __forceinline__ void tile_update(WarpState<HD>& w, const __nv_bfloat16* Ks,
                                            const __nv_bfloat16* Vs, int col0,
                                            const int lim[2], float scale, int lane,
                                            const float* ksc = nullptr,
                                            const float* vsc = nullptr) {
  constexpr int LD = HD + 8;
  const int t4 = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's row address
  float s[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // S = Q K^T: B fragments of key blocks j and j + 1 (K rows are keys)
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, Ks + ((j + (mat >> 1)) * 8 + mrow) * LD + kk * 16 + (mat & 1) * 8);
      mma_bf16_16816(s[j], w.qf[kk], b[0], b[1]);
      mma_bf16_16816(s[j + 1], w.qf[kk], b[2], b[3]);
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, c = j * 8 + t4 * 2 + (e & 1);
      float f = scale;
      if constexpr (QUANT) f = ksc[c] * scale;
      const float x = col0 + c < lim[i] ? s[j][e] * f : kNegInf;
      s[j][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(w.m[i], mx[i]);
    corr[i] = __expf(w.m[i] - m_new);
    w.m[i] = m_new;
    w.l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = __expf(s[j][e] - w.m[i]);
      s[j][e] = p;
      w.l[i] += p;
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    w.o[n][0] *= corr[0];
    w.o[n][1] *= corr[0];
    w.o[n][2] *= corr[1];
    w.o[n][3] *= corr[1];
  }
  // O += P V: P (rounded to bf16, as the reference rounds p to the value
  // dtype; QUANT: p * v_scale) is re-used from the score registers as A
  // fragments; V's B fragments (V rows are keys) come transposed by ldmatrix.
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    if constexpr (QUANT) {
      // columns 16 kk + 2 t4 (+1) for s[2 kk], 16 kk + 8 + 2 t4 (+1) for s[2 kk + 1]
      const float* v0 = vsc + 16 * kk + 2 * t4;
      const float2 va = make_float2(v0[0], v0[1]);
      const float2 vb = make_float2(v0[8], v0[9]);
      a[0] = pack_bf16x2(s[2 * kk][0] * va.x, s[2 * kk][1] * va.y);
      a[1] = pack_bf16x2(s[2 * kk][2] * va.x, s[2 * kk][3] * va.y);
      a[2] = pack_bf16x2(s[2 * kk + 1][0] * vb.x, s[2 * kk + 1][1] * vb.y);
      a[3] = pack_bf16x2(s[2 * kk + 1][2] * vb.x, s[2 * kk + 1][3] * vb.y);
    } else {
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, Vs + (kk * 16 + (mat & 1) * 8 + mrow) * LD + (n + (mat >> 1)) * 8);
      mma_bf16_16816(w.o[n], a, b[0], b[1]);
      mma_bf16_16816(w.o[n + 1], a, b[2], b[3]);
    }
  }
}

// Shared tiles: bf16 K/V two stages deep; for int8 caches one bf16 tile
// (converted) plus two stages of int8 rows and their scales.
template <int HD, int N, bool QUANT>
struct TileSmem {
  __nv_bfloat16 K[2][N * (HD + 8)];
  __nv_bfloat16 V[2][N * (HD + 8)];
};
template <int HD, int N>
struct TileSmem<HD, N, true> {
  __nv_bfloat16 K[1][N * (HD + 8)];
  __nv_bfloat16 V[1][N * (HD + 8)];
  int8_t Kq[2][N * HD];
  int8_t Vq[2][N * HD];
  float Ks[2][N];
  float Vs[2][N];
};

// The kernel body.  Grid (row_blocks * nsplit, Hkv, B), W warps per block.
// INT4 (with QUANT): the cache rows and fresh rows are packed in head pairs.
// PAGED: the cache is a page pool read through a.table (RowAddr).
// Split `split` covers positions [split*chunk, (split+1)*chunk); token t sees
// positions [0, base + t + 1).  nsplit == 1 writes the normalised output;
// nsplit > 1 writes (o, m, l) partials that a combine pass merges.
template <int HD, int N, int W, int MIN_BLOCKS = 1, bool QUANT = false, bool INT4 = false,
          bool PAGED = false>
__global__ void __launch_bounds__(32 * W, MIN_BLOCKS) attend_kernel(AttnArgs a) {
  static_assert(QUANT || !INT4, "an int4 cache is a quantized cache");
  constexpr int NT = 32 * W;
  // two stages: the next tile's copy runs while this one is computed
  __shared__ __align__(16) TileSmem<HD, N, QUANT> sm;

  const int b = blockIdx.z, h = blockIdx.y;
  const int rb = blockIdx.x / a.nsplit, split = blockIdx.x % a.nsplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  // a cache row's width and the head's first lane in it
  const int K = INT4 ? (a.Hkv / 2) * HD : a.Hkv * HD;
  const int h_lane = INT4 ? (h >> 1) * HD : h * HD;
  const int base = a.base_lens[b];
  const bool fresh = QUANT ? a.kq_new != nullptr : a.k_new != nullptr;
  const int r_block = rb * 16 * W;
  const float scale = 1.f / sqrtf((float)HD);

  int row[2], lim[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r_block + warp * 16 + g + 8 * i;
    valid[i] = row[i] < GT;
    lim[i] = valid[i] ? min(base + row[i] / G + 1, a.S) : 0;
  }
  const int t_last = min((r_block + 16 * W - 1) / G, a.T - 1);
  const int hi = min(base + t_last + 1, a.S);
  const int lo = split * a.chunk;
  const int hi_s = min(hi, lo + a.chunk);

  WarpState<HD> w;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row[i] / G, gq = row[i] % G;
      const __nv_bfloat16* qp =
          a.q + (((size_t)b * a.T + t) * a.Hq + h * G + gq) * HD + kk * 16 + t4 * 2;
      w.qf[kk][i] = valid[i] ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
      w.qf[kk][i + 2] = valid[i] ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.f;
  w.m[0] = w.m[1] = kNegInf;
  w.l[0] = w.l[1] = 0.f;

  using CacheT = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;
  const CacheT* kc;
  const CacheT* vc;
  if constexpr (QUANT) {
    kc = a.kq;
    vc = a.vq;
  } else {
    kc = a.k;
    vc = a.v;
  }
  const RowAddr<CacheT, PAGED> krows = kv_rows<CacheT, PAGED>(a, kc, b, K, h_lane);
  const RowAddr<CacheT, PAGED> vrows = kv_rows<CacheT, PAGED>(a, vc, b, K, h_lane);
  RowAddr<float, PAGED> ksrows{}, vsrows{};
  if constexpr (QUANT) {
    ksrows = scale_rows<PAGED>(a, a.k_scale, b, h);
    vsrows = scale_rows<PAGED>(a, a.v_scale, b, h);
  }
  const size_t f_off = (size_t)b * a.T * K + h_lane;
  const int fresh_at = fresh ? base : a.S;  // first position read from k_new
  const int lim_s[2] = {min(lim[0], hi_s), min(lim[1], hi_s)};
  const __nv_bfloat16* kn = fresh ? a.k_new + f_off : nullptr;
  const __nv_bfloat16* vn = fresh ? a.v_new + f_off : nullptr;
  const int8_t* kqn = fresh ? a.kq_new + f_off : nullptr;
  const int8_t* vqn = fresh ? a.vq_new + f_off : nullptr;
  const size_t sn_off = ((size_t)b * a.Hkv + h) * a.T;
  const float* ksn = fresh ? a.ks_new + sn_off : nullptr;
  const float* vsn = fresh ? a.vs_new + sn_off : nullptr;
  // issue the copies of the tile at position c into stage st
  auto issue = [&](int st, int c) {
    if constexpr (QUANT) {
      load_tile_i8<HD, N, NT>(sm.Kq[st], krows, kqn, fresh_at, K, c, hi_s);
      load_tile_i8<HD, N, NT>(sm.Vq[st], vrows, vqn, fresh_at, K, c, hi_s);
      load_scales<N, NT>(sm.Ks[st], ksrows, ksn, fresh_at, c, hi_s);
      load_scales<N, NT>(sm.Vs[st], vsrows, vsn, fresh_at, c, hi_s);
    } else {
      load_tile<HD, N, NT>(sm.K[st], krows, kn, fresh_at, K, c, hi_s);
      load_tile<HD, N, NT>(sm.V[st], vrows, vn, fresh_at, K, c, hi_s);
    }
  };
  if (lo < hi_s) issue(0, lo);
  cp_async_commit();
  int stage = 0;
  for (int c0 = lo; c0 < hi_s; c0 += N) {
    // stage ^ 1 was released by the last iteration's barrier
    if (c0 + N < hi_s) issue(stage ^ 1, c0 + N);
    cp_async_commit();
    cp_async_wait<1>();  // all groups but the newest have landed: this stage
    if constexpr (INT4) {
      convert_tile_i4<HD, N, NT>(sm.K[0], sm.Kq[stage], (h & 1) * 4);
      convert_tile_i4<HD, N, NT>(sm.V[0], sm.Vq[stage], (h & 1) * 4);
    } else if constexpr (QUANT) {
      convert_tile<HD, N, NT>(sm.K[0], sm.Kq[stage]);
      convert_tile<HD, N, NT>(sm.V[0], sm.Vq[stage]);
    }
    if constexpr (QUANT) {
      __syncthreads();
      tile_update<HD, N, true>(w, sm.K[0], sm.V[0], c0, lim_s, scale, lane, sm.Ks[stage],
                               sm.Vs[stage]);
    } else {
      __syncthreads();
      tile_update<HD, N>(w, sm.K[stage], sm.V[stage], c0, lim_s, scale, lane);
    }
    __syncthreads();
    stage ^= 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    w.l[i] += __shfl_xor_sync(0xffffffffu, w.l[i], 1);
    w.l[i] += __shfl_xor_sync(0xffffffffu, w.l[i], 2);
  }

  if (a.nsplit == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!valid[i]) continue;
      const int t = row[i] / G, gq = row[i] % G;
      const float inv = 1.f / fmaxf(w.l[i], 1e-30f);
      __nv_bfloat16* op = a.out + (((size_t)b * a.T + t) * a.Hq + h * G + gq) * HD + t4 * 2;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(w.o[n][2 * i] * inv, w.o[n][2 * i + 1] * inv);
    }
  } else {
    const int R = (gridDim.x / a.nsplit) * 16 * W;
    const size_t part = ((size_t)b * a.Hkv + h) * a.nsplit + split;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* op = a.part_o + (part * R + row[i]) * HD + t4 * 2;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(op + n * 8) = make_float2(w.o[n][2 * i], w.o[n][2 * i + 1]);
      if (t4 == 0) {
        a.part_ml[(part * R + row[i]) * 2] = w.m[i];
        a.part_ml[(part * R + row[i]) * 2 + 1] = w.l[i];
      }
    }
  }
}

// Merge the (o, m, l) partials of the nsplit splits of each (request, kv
// head) into the normalised bf16 output.  Grid (Hkv, B).
template <int HD>
__global__ void combine_kernel(AttnArgs a, int R) {
  const int b = blockIdx.y, h = blockIdx.x;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  const size_t part0 = ((size_t)b * a.Hkv + h) * a.nsplit;
  for (int idx = threadIdx.x; idx < GT * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD;
    float m = kNegInf;
    for (int s = 0; s < a.nsplit; ++s) m = fmaxf(m, a.part_ml[((part0 + s) * R + r) * 2]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      const size_t pr = (part0 + s) * R + r;
      const float c = __expf(a.part_ml[pr * 2] - m);
      l += a.part_ml[pr * 2 + 1] * c;
      o += a.part_o[pr * HD + d] * c;
    }
    const int t = r / G, gq = r % G;
    a.out[(((size_t)b * a.T + t) * a.Hq + h * G + gq) * HD + d] =
        __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
}

// ---- host side of the quantized-cache entry points (K1q, B10) ----

// The entry points' operands of a quantized cache (int8, or int4 packed in
// head pairs with INT4): q [B, T, Hq, 64] bf16; k/v int8 [L, B, S, K] (K =
// Hkv*64, or (Hkv/2)*64 packed) with f32 scales [L, B, Hkv, S]; k_new/v_new
// [B, T, K] and ks_new/vs_new [B, Hkv, T], or all four null; base_lens [B];
// out [B, T, Hq, 64].  nullptr when the kernels do not take them.  One split
// (the decode entry points set their split plan after).
template <bool INT4>
inline bool quant_args(AttnArgs& a, const void* q, const void* k, const void* v,
                       const void* k_scale, const void* v_scale, const void* k_new,
                       const void* v_new, const void* ks_new, const void* vs_new,
                       const void* base_lens, void* out, int layer, int B, int S, int T,
                       int Hq, int Hkv, int hd) {
  if (hd != 64 || (INT4 && Hkv % 2 != 0) || (k_new == nullptr) != (ks_new == nullptr))
    return false;
  a = AttnArgs{};  // the bf16 fields stay null
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kq = static_cast<const int8_t*>(k);
  a.vq = static_cast<const int8_t*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.kq_new = static_cast<const int8_t*>(k_new);
  a.vq_new = static_cast<const int8_t*>(v_new);
  a.ks_new = static_cast<const float*>(ks_new);
  a.vs_new = static_cast<const float*>(vs_new);
  a.base_lens = static_cast<const int*>(base_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer;
  a.B = B;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.nsplit = 1;
  a.chunk = S;
  return true;
}

template <int W, bool QUANT, bool INT4, bool PAGED>
void launch_decode(const AttnArgs& a, cudaStream_t stream) {
  dim3 grid(a.nsplit, a.Hkv, a.B);
  attend_kernel<64, 32, W, 1, QUANT, INT4, PAGED><<<grid, 32 * W, 0, stream>>>(a);
  if (a.nsplit > 1) combine_kernel<64><<<dim3(a.Hkv, a.B), 256, 0, stream>>>(a, 16 * W);
}

// Decode (K1, K1q, B10; PAGED: their B12 twins): 32-row tiles, one block
// per (split, kv head, request) of 16 grouped query rows a warp (1 to 8
// warps), then the combine pass when a.nsplit > 1.  The caller sizes
// part_o/part_ml with R = 16 * W rows (rows_pad in
// kernels/decode_attention.py).  Returns cudaGetLastError().
template <bool QUANT, bool INT4, bool PAGED = false>
int decode_attend(const AttnArgs& a, cudaStream_t st) {
  const int rows = (a.Hq / a.Hkv) * a.T;
  if (rows <= 16)
    launch_decode<1, QUANT, INT4, PAGED>(a, st);
  else if (rows <= 32)
    launch_decode<2, QUANT, INT4, PAGED>(a, st);
  else if (rows <= 64)
    launch_decode<4, QUANT, INT4, PAGED>(a, st);
  else if (rows <= 128)
    launch_decode<8, QUANT, INT4, PAGED>(a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The bf16 counterpart of quant_args (K1; B12's bf16 entry point).
inline bool dense_args(AttnArgs& a, const void* q, const void* k, const void* v,
                       const void* k_new, const void* v_new, const void* base_lens, void* out,
                       int layer, int B, int S, int T, int Hq, int Hkv, int hd) {
  if (hd != 64) return false;
  a = AttnArgs{};  // the int8 fields stay null
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.base_lens = static_cast<const int*>(base_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer;
  a.B = B;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.nsplit = 1;
  a.chunk = S;
  return true;
}

}  // namespace md
