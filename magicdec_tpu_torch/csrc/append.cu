// K3 and K3q: in-place append of every layer's new KV rows into the stacked
// caches (K3q: int8 rows and their scales); B14: the same append one array
// at a time (rows, or scale columns).
//
// Replaces magicdec_tpu/ops/kv_cache.py append_all_rows_inplace, dense call
// (its inline kernel and _merge_rows_block): rows_k/rows_v [L, B, T, K] land
// at cache_k/cache_v [L, B, S, K] rows [pos_b, pos_b + T) of every layer,
// pos_b = write_pos[b]; a row that would land at or past S is dropped, as
// the Pallas kernel's row-range test drops it (jax.lax.dynamic_update_slice
// would clamp the start instead: ops/kv_cache.py keeps that op).
//
// Bound: HBM bytes, 2x the rows' bytes (read the rows, write them into the
// cache).  At T = 1..4 that is under a megabyte and the launch dominates.
// Design: one launch for k and v and all layers; each thread moves one
// 16-byte vector of a row of k and the same vector of v.  The TPU kernel
// merges 8-row blocks because its DMA granule is a block; here the write
// granule is the vector, so no cache row is read.  The scales are f32 or
// bf16 (the JAX package's kv_scale_dtype; the _bf16s entry points): a copy
// of the quantizer's already rounded values in their own type, so either
// is bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// TWO: k and v (K3); one array (B14 append_rows_inplace, cv and rv unused).
template <bool TWO>
__global__ void append_rows_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv,
                                   const uint4* __restrict__ rk,
                                   const uint4* __restrict__ rv, const int* __restrict__ pos,
                                   int B, int S, int T, int vec) {
  const int b = blockIdx.y, l = blockIdx.z;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T * vec) return;
  const int t = idx / vec, c = idx % vec;
  const int row = pos[b] + t;
  if (row < 0 || row >= S) return;  // past the cache: dropped
  const size_t src = (((size_t)l * B + b) * T + t) * vec + c;
  const size_t dst = (((size_t)l * B + b) * S + row) * vec + c;
  ck[dst] = rk[src];
  if (TWO) cv[dst] = rv[src];
}

// B14 append_scale_rows_inplace: scale rows srows [L, B, H, T] into scale
// [L, B, H, S] columns [pos_b, pos_b + T), columns at or past S dropped;
// thread idx < H*T of each (request, layer) moves one scale (SC: float, or
// the 16 bits of a bf16).
template <typename SC>
__global__ void append_scale_cols_kernel(SC* __restrict__ sc, const SC* __restrict__ sr,
                                         const int* __restrict__ pos, int B, int H, int S,
                                         int T) {
  const int b = blockIdx.y, l = blockIdx.z;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * T) return;
  const int h = idx / T, t = idx % T;
  const int col = pos[b] + t;
  if (col < 0 || col >= S) return;
  const size_t row = ((size_t)l * B + b) * H + h;
  sc[row * S + col] = sr[row * T + t];
}

}  // namespace

namespace md {

// K3q (replaces the quantized call of append_all_rows_inplace: its inline
// kernel, _merge_rows_block and _merge_scale_block).  As append_rows_kernel
// for the int8 rows, and in the same launch the scale rows srows [L, B, H, T]
// land at scale [L, B, H, S] columns [pos_b, pos_b + T), those at or past S
// dropped: thread idx < H*T of each (request, layer) moves one scale of k
// and one of v (SC: float, or the 16 bits of a bf16).  Both are copies, so
// the result is bit-exact; bound: HBM bytes, launch-bound at T <= 4.
template <typename SC>
__global__ void append_rows_quant_kernel(uint4* __restrict__ ck, uint4* __restrict__ cv,
                                         SC* __restrict__ sk, SC* __restrict__ sv,
                                         const uint4* __restrict__ rk,
                                         const uint4* __restrict__ rv,
                                         const SC* __restrict__ srk,
                                         const SC* __restrict__ srv,
                                         const int* __restrict__ pos, int B, int S, int T,
                                         int H, int vec) {
  const int b = blockIdx.y, l = blockIdx.z;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < T * vec) {
    const int t = idx / vec, c = idx % vec;
    const int r = pos[b] + t;
    if (r >= 0 && r < S) {
      const size_t src = (((size_t)l * B + b) * T + t) * vec + c;
      const size_t dst = (((size_t)l * B + b) * S + r) * vec + c;
      ck[dst] = rk[src];
      cv[dst] = rv[src];
    }
  }
  if (idx < H * T) {
    const int h = idx / T, t = idx % T;
    const int col = pos[b] + t;
    if (col >= 0 && col < S) {
      const size_t row = ((size_t)l * B + b) * H + h;
      sk[row * S + col] = srk[row * T + t];
      sv[row * S + col] = srv[row * T + t];
    }
  }
}

}  // namespace md

// row_bytes = K * element size, a multiple of 16.  Returns cudaGetLastError().
extern "C" int md_append_rows(void* cache_k, void* cache_v, const void* rows_k,
                              const void* rows_v, const void* write_pos, int L, int B,
                              int S, int T, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || T > S) return (int)cudaErrorInvalidValue;
  const int vec = row_bytes / 16;
  const int threads = 256;
  dim3 grid((T * vec + threads - 1) / threads, B, L);
  append_rows_kernel<true><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache_k), static_cast<uint4*>(cache_v),
      static_cast<const uint4*>(rows_k), static_cast<const uint4*>(rows_v),
      static_cast<const int*>(write_pos), B, S, T, vec);
  return (int)cudaGetLastError();
}

namespace {

template <typename SC>
int append_rows_quant(void* cache_k, void* cache_v, void* scale_k, void* scale_v,
                      const void* rows_k, const void* rows_v, const void* srows_k,
                      const void* srows_v, const void* write_pos, int L, int B, int S, int T,
                      int H, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || T > S) return (int)cudaErrorInvalidValue;
  const int vec = row_bytes / 16;
  const int threads = 256;
  const int work = T * (vec > H ? vec : H);
  dim3 grid((work + threads - 1) / threads, B, L);
  md::append_rows_quant_kernel<SC><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache_k), static_cast<uint4*>(cache_v), static_cast<SC*>(scale_k),
      static_cast<SC*>(scale_v), static_cast<const uint4*>(rows_k),
      static_cast<const uint4*>(rows_v), static_cast<const SC*>(srows_k),
      static_cast<const SC*>(srows_v), static_cast<const int*>(write_pos), B, S, T, H, vec);
  return (int)cudaGetLastError();
}

template <typename SC>
int append_scale_cols(void* scale, const void* rows, const void* write_pos, int L, int B, int H,
                      int S, int T, void* stream) {
  if (T > S) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((H * T + threads - 1) / threads, B, L);
  append_scale_cols_kernel<SC><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<SC*>(scale), static_cast<const SC*>(rows), static_cast<const int*>(write_pos),
      B, H, S, T);
  return (int)cudaGetLastError();
}

}  // namespace

// K3q: int8 rows (row_bytes = K, a multiple of 16) and their f32 scale rows
// srows_k/srows_v [L, B, H, T] into scale_k/scale_v [L, B, H, S], one launch;
// _bf16s: bf16 scales.  Returns cudaGetLastError().
extern "C" int md_append_rows_quant(void* cache_k, void* cache_v, void* scale_k, void* scale_v,
                                    const void* rows_k, const void* rows_v,
                                    const void* srows_k, const void* srows_v,
                                    const void* write_pos, int L, int B, int S, int T, int H,
                                    int row_bytes, void* stream) {
  return append_rows_quant<float>(cache_k, cache_v, scale_k, scale_v, rows_k, rows_v, srows_k,
                                  srows_v, write_pos, L, B, S, T, H, row_bytes, stream);
}

extern "C" int md_append_rows_quant_bf16s(void* cache_k, void* cache_v, void* scale_k,
                                          void* scale_v, const void* rows_k, const void* rows_v,
                                          const void* srows_k, const void* srows_v,
                                          const void* write_pos, int L, int B, int S, int T,
                                          int H, int row_bytes, void* stream) {
  return append_rows_quant<uint16_t>(cache_k, cache_v, scale_k, scale_v, rows_k, rows_v,
                                     srows_k, srows_v, write_pos, L, B, S, T, H, row_bytes,
                                     stream);
}

// B14 append_rows_inplace (replaces magicdec_tpu/ops/kv_cache.py
// append_rows_inplace, _inplace_rows_kernel): ONE array's rows [L, B, T, K]
// into cache [L, B, S, K] at write_pos, rows at or past S dropped; the copy
// kernel of K3, one launch per array (the point of the A/B against K3's
// single launch).  row_bytes = K * element size, a multiple of 16.  Returns
// cudaGetLastError().
extern "C" int md_append_array_rows(void* cache, const void* rows, const void* write_pos, int L,
                                    int B, int S, int T, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || T > S) return (int)cudaErrorInvalidValue;
  const int vec = row_bytes / 16;
  const int threads = 256;
  dim3 grid((T * vec + threads - 1) / threads, B, L);
  append_rows_kernel<false><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), nullptr, static_cast<const uint4*>(rows), nullptr,
      static_cast<const int*>(write_pos), B, S, T, vec);
  return (int)cudaGetLastError();
}

// B14 append_scale_rows_inplace (replaces append_scale_rows_inplace,
// _inplace_scale_kernel): f32 scale rows [L, B, H, T] into scale [L, B, H, S]
// at write_pos, columns at or past S dropped; _bf16s: bf16 scales.  Returns
// cudaGetLastError().
extern "C" int md_append_scale_cols(void* scale, const void* rows, const void* write_pos, int L,
                                    int B, int H, int S, int T, void* stream) {
  return append_scale_cols<float>(scale, rows, write_pos, L, B, H, S, T, stream);
}

extern "C" int md_append_scale_cols_bf16s(void* scale, const void* rows, const void* write_pos,
                                          int L, int B, int H, int S, int T, void* stream) {
  return append_scale_cols<uint16_t>(scale, rows, write_pos, L, B, H, S, T, stream);
}
