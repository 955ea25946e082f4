// B13: the paged append, over KV page pools shared by all requests of a
// serving batch.  (B12, the paged decode attention over bf16, int8 and int4
// pools, is the PAGED instance of the decode kernel in
// decode_attention_sm90.cu.)
//
// B13 replaces paged_attention.py append_paged_rows_inplace (its dense
// call :294 and quantized call :331, the _merge_rows_block and
// _merge_scale_block RMW blocks): rows [L, B, T, Kc] land at the logical
// positions [write_pos[b], write_pos[b] + T) of request b, every layer, k
// and v (and their scale rows [L, B, H, T]) in ONE launch; a row at or past
// S = npr*ps is dropped (no clamp and no shift, unlike K3's
// dynamic_update_slice start).  Design: K3/K3q's (one 16-byte vector of k
// and the same one of v per thread, one scale copy each, f32 or bf16 (the
// _bf16s entry point)), with each row's
// page looked up in the table; the TPU kernel's 8-row read-modify-write
// blocks exist for its DMA granule, so no pool row is read here.  Bound:
// HBM bytes, launch-bound at T <= 4.  Copies, so the result is bit-exact,
// and pool pages the table does not name stay untouched.
#include "attention_common.cuh"

namespace {

template <typename SC>
__global__ void append_paged_rows_kernel(uint4* __restrict__ pk, uint4* __restrict__ pv,
                                         SC* __restrict__ sk, SC* __restrict__ sv,
                                         const uint4* __restrict__ rk,
                                         const uint4* __restrict__ rv,
                                         const SC* __restrict__ srk,
                                         const SC* __restrict__ srv,
                                         const int* __restrict__ pos,
                                         const int* __restrict__ table, int B, int P, int ps,
                                         int npr, int T, int H, int vec) {
  const int b = blockIdx.y, l = blockIdx.z;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int S = npr * ps;
  const int* trow = table + (size_t)b * npr;
  if (idx < T * vec) {
    const int t = idx / vec, c = idx % vec;
    const int p = pos[b] + t;
    if (p >= 0 && p < S) {
      const size_t page = (size_t)l * P + trow[p / ps];
      const size_t src = (((size_t)l * B + b) * T + t) * vec + c;
      const size_t dst = (page * ps + p % ps) * vec + c;
      pk[dst] = rk[src];
      pv[dst] = rv[src];
    }
  }
  if (sk != nullptr && idx < H * T) {
    const int h = idx / T, t = idx % T;
    const int p = pos[b] + t;
    if (p >= 0 && p < S) {
      const size_t page = (size_t)l * P + trow[p / ps];
      const size_t src = (((size_t)l * B + b) * H + h) * T + t;
      const size_t dst = (page * H + h) * ps + p % ps;
      sk[dst] = srk[src];
      sv[dst] = srv[src];
    }
  }
}

template <typename SC>
int append_paged(void* pool_k, void* pool_v, void* spool_k, void* spool_v, const void* rows_k,
                 const void* rows_v, const void* srows_k, const void* srows_v,
                 const void* write_pos, const void* table, int L, int B, int P, int ps,
                 int npr, int T, int H, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || T < 1 || ps <= 0 || npr <= 0) return (int)cudaErrorInvalidValue;
  const int vec = row_bytes / 16;
  const int threads = 256;
  const int work = T * (vec > H ? vec : H);
  dim3 grid((work + threads - 1) / threads, B, L);
  append_paged_rows_kernel<SC><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool_k), static_cast<uint4*>(pool_v), static_cast<SC*>(spool_k),
      static_cast<SC*>(spool_v), static_cast<const uint4*>(rows_k),
      static_cast<const uint4*>(rows_v), static_cast<const SC*>(srows_k),
      static_cast<const SC*>(srows_v), static_cast<const int*>(write_pos),
      static_cast<const int*>(table), B, P, ps, npr, T, H, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// B13, dense call: rows_k/rows_v [L, B, T, Kc] (row_bytes = Kc * element
// size, a multiple of 16) into pool_k/pool_v [L, P, ps, Kc] at logical
// positions write_pos[b] + t < npr * ps through table [B, npr].  Returns
// cudaGetLastError().
extern "C" int md_append_paged_rows(void* pool_k, void* pool_v, const void* rows_k,
                                    const void* rows_v, const void* write_pos,
                                    const void* table, int L, int B, int P, int ps, int npr,
                                    int T, int row_bytes, void* stream) {
  return append_paged<float>(pool_k, pool_v, nullptr, nullptr, rows_k, rows_v, nullptr,
                             nullptr, write_pos, table, L, B, P, ps, npr, T, 0, row_bytes, stream);
}

// B13, quantized call: int8 (or packed int4) rows as above, and in the same
// launch their f32 scale rows srows_k/srows_v [L, B, H, T] into the scale
// pools spool_k/spool_v [L, P, H, ps]; _bf16s: bf16 scales.  Returns
// cudaGetLastError().
extern "C" int md_append_paged_rows_quant(void* pool_k, void* pool_v, void* spool_k,
                                          void* spool_v, const void* rows_k, const void* rows_v,
                                          const void* srows_k, const void* srows_v,
                                          const void* write_pos, const void* table, int L,
                                          int B, int P, int ps, int npr, int T, int H,
                                          int row_bytes, void* stream) {
  return append_paged<float>(pool_k, pool_v, spool_k, spool_v, rows_k, rows_v, srows_k, srows_v,
                             write_pos, table, L, B, P, ps, npr, T, H, row_bytes, stream);
}

extern "C" int md_append_paged_rows_quant_bf16s(void* pool_k, void* pool_v, void* spool_k,
                                                void* spool_v, const void* rows_k,
                                                const void* rows_v, const void* srows_k,
                                                const void* srows_v, const void* write_pos,
                                                const void* table, int L, int B, int P, int ps,
                                                int npr, int T, int H, int row_bytes,
                                                void* stream) {
  return append_paged<uint16_t>(pool_k, pool_v, spool_k, spool_v, rows_k, rows_v, srows_k,
                                srows_v, write_pos, table, L, B, P, ps, npr, T, H, row_bytes,
                                stream);
}
