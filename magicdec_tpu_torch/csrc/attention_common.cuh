// Shared flash-attention core of the bf16 decode kernels K1
// (decode_attention.cu) and B12's bf16 pool (paged_attention.cu), which
// replace magicdec_tpu/ops/pallas/decode_attention.py (_decode_kernel,
// _whole_row_kernel) and paged_attention.py (_paged_call's bf16 kernel);
// and the pieces the other attention sources share: the operands
// (AttnArgs), a row's address in a contiguous cache or a page pool
// (RowAddr), mma.sync / ldmatrix / cp.async, the exact int8 and int4
// conversions, and the pass that merges split partials (combine_kernel).
// The quantized decode kernels K1q and B10 and their paged twins run on
// decode_attention_sm90.cu, the prefill kernels K2, K2q and B11 on
// prefill_attention_sm90.cu.
//
// Bound: bytes (few query rows over a long cache: K1 streams the cache
// once).  One thread block serves one (request b, kv head h, split of the
// positions) and a run of W*16 grouped query rows; each warp owns 16 rows
// and keeps their fp32 online softmax state (running max m, normaliser l,
// accumulator o) in registers.  The block walks its positions in tiles of
// N rows staged in shared memory by cp.async, two stages deep (the next
// tile's copy overlaps this tile's arithmetic); each warp computes S = Q K^T
// and O += P V with the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate; K and V fragments through ldmatrix).  K1 runs at 75-77% of
// its byte bound (PERF.md).
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
// launch over the gathered cache.  A page is resolved per 16-byte chunk (and
// per 4-byte scale), so a tile may span pages of any size.  Rows at or past
// a request's visible length are never read through the table.
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

template <int HD>
struct WarpState {
  uint32_t qf[HD / 16][4];  // Q as mma A fragments
  float o[HD / 8][4];       // O accumulator (mma C fragments)
  float m[2], l[2];         // rows g and g + 8 (l: this thread's partial sum)
};

// One online-softmax update of a warp's 16 rows with the N-column tile held
// in Ks/Vs.  Column col0 + c is visible to the thread's row i iff
// col0 + c < lim[i].
template <int HD, int N>
__device__ __forceinline__ void tile_update(WarpState<HD>& w, const __nv_bfloat16* Ks,
                                            const __nv_bfloat16* Vs, int col0,
                                            const int lim[2], float scale, int lane) {
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
      const float x = col0 + c < lim[i] ? s[j][e] * scale : kNegInf;
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
  // dtype) is re-used from the score registers as A fragments; V's B
  // fragments (V rows are keys) come transposed by ldmatrix.
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, Vs + (kk * 16 + (mat & 1) * 8 + mrow) * LD + (n + (mat >> 1)) * 8);
      mma_bf16_16816(w.o[n], a, b[0], b[1]);
      mma_bf16_16816(w.o[n + 1], a, b[2], b[3]);
    }
  }
}

// Shared tiles: bf16 K/V two stages deep.
template <int HD, int N>
struct TileSmem {
  __nv_bfloat16 K[2][N * (HD + 8)];
  __nv_bfloat16 V[2][N * (HD + 8)];
};

// The kernel body.  Grid (row_blocks * nsplit, Hkv, B), W warps per block.
// PAGED: the cache is a page pool read through a.table (RowAddr).
// Split `split` covers positions [split*chunk, (split+1)*chunk); token t sees
// positions [0, base + t + 1).  nsplit == 1 writes the normalised output;
// nsplit > 1 writes (o, m, l) partials that a combine pass merges.
template <int HD, int N, int W, int MIN_BLOCKS = 1, bool PAGED = false>
__global__ void __launch_bounds__(32 * W, MIN_BLOCKS) attend_kernel(AttnArgs a) {
  constexpr int NT = 32 * W;
  // two stages: the next tile's copy runs while this one is computed
  __shared__ __align__(16) TileSmem<HD, N> sm;

  const int b = blockIdx.z, h = blockIdx.y;
  const int rb = blockIdx.x / a.nsplit, split = blockIdx.x % a.nsplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  // a cache row's width and the head's first lane in it
  const int K = a.Hkv * HD;
  const int h_lane = h * HD;
  const int base = a.base_lens[b];
  const bool fresh = a.k_new != nullptr;
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

  const RowAddr<__nv_bfloat16, PAGED> krows = kv_rows<__nv_bfloat16, PAGED>(a, a.k, b, K, h_lane);
  const RowAddr<__nv_bfloat16, PAGED> vrows = kv_rows<__nv_bfloat16, PAGED>(a, a.v, b, K, h_lane);
  const size_t f_off = (size_t)b * a.T * K + h_lane;
  const int fresh_at = fresh ? base : a.S;  // first position read from k_new
  const int lim_s[2] = {min(lim[0], hi_s), min(lim[1], hi_s)};
  const __nv_bfloat16* kn = fresh ? a.k_new + f_off : nullptr;
  const __nv_bfloat16* vn = fresh ? a.v_new + f_off : nullptr;
  // issue the copies of the tile at position c into stage st
  auto issue = [&](int st, int c) {
    load_tile<HD, N, NT>(sm.K[st], krows, kn, fresh_at, K, c, hi_s);
    load_tile<HD, N, NT>(sm.V[st], vrows, vn, fresh_at, K, c, hi_s);
  };
  if (lo < hi_s) issue(0, lo);
  cp_async_commit();
  int stage = 0;
  for (int c0 = lo; c0 < hi_s; c0 += N) {
    // stage ^ 1 was released by the last iteration's barrier
    if (c0 + N < hi_s) issue(stage ^ 1, c0 + N);
    cp_async_commit();
    cp_async_wait<1>();  // all groups but the newest have landed: this stage
    __syncthreads();
    tile_update<HD, N>(w, sm.K[stage], sm.V[stage], c0, lim_s, scale, lane);
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

// ---- host side of the bf16 decode entry points (K1, B12 bf16) ----

template <int W, bool PAGED>
void launch_decode(const AttnArgs& a, cudaStream_t stream) {
  dim3 grid(a.nsplit, a.Hkv, a.B);
  attend_kernel<64, 32, W, 1, PAGED><<<grid, 32 * W, 0, stream>>>(a);
  if (a.nsplit > 1) combine_kernel<64><<<dim3(a.Hkv, a.B), 256, 0, stream>>>(a, 16 * W);
}

// Decode (K1; PAGED: B12's bf16 pool): 32-row tiles, one block per (split,
// kv head, request) of 16 grouped query rows a warp (1 to 8 warps), then the
// combine pass when a.nsplit > 1.  The caller sizes part_o/part_ml with R =
// 16 * W rows (rows_pad in kernels/decode_attention.py).  Returns
// cudaGetLastError().
template <bool PAGED = false>
int decode_attend(const AttnArgs& a, cudaStream_t st) {
  const int rows = (a.Hq / a.Hkv) * a.T;
  if (rows <= 16)
    launch_decode<1, PAGED>(a, st);
  else if (rows <= 32)
    launch_decode<2, PAGED>(a, st);
  else if (rows <= 64)
    launch_decode<4, PAGED>(a, st);
  else if (rows <= 128)
    launch_decode<8, PAGED>(a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The bf16 operands of K1 and B12's bf16 entry point: q [B, T, Hq, 64]; k/v
// [L, B, S, Hkv*64]; k_new/v_new [B, T, Hkv*64] or null; base_lens [B]; out
// [B, T, Hq, 64].  One split (the entry points set their split plan after).
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
