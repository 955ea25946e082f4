// K2: chunked-prefill flash attention over the layer-stacked bf16 cache.
//
// Replaces magicdec_tpu/ops/pallas/prefill_attention.py flash_prefill_attend
// (_prefill_kernel).  A C-token chunk of request b attends the cache rows
// [0, base_b) of layer `layer` plus its own fresh rows with in-chunk causal
// masking (without fresh rows the cache holds the chunk and token t sees
// [0, base_b + t + 1)).
//
// Bound: tensor-core operations.  At the bench's chunk (C = 512, G = 4,
// hd = 64) every KV byte staged in shared memory feeds 128 query rows of one
// block, far over the ridge of ~295 flop/byte.  Design: each block takes 128
// grouped query rows (32 consecutive tokens x 4 heads of one kv head) of one
// (request, kv head), eight warps of 16 rows; it loops over the positions its
// tokens can see in tiles of 64 (cache rows below base, the chunk's fresh
// rows from there on, double-buffered in shared memory by cp.async), with an
// fp32 online softmax.  S = Q K^T and O += P V run on mma.sync m16n8k16 with
// fp32 accumulators.  The TPU kernel's sequential kv grid axis becomes the
// loop inside the block.  128 rows per block (not 64) halves the cache
// re-reads from L2.
#include "attention_common.cuh"

extern "C" int md_prefill_attend(const void* q, const void* k, const void* v,
                                 const void* k_new, const void* v_new,
                                 const void* base_lens, void* out, int layer, int B,
                                 int S, int T, int Hq, int Hkv, int hd, void* stream) {
  constexpr int W = 8, N = 64;
  md::AttnArgs a;
  if (!md::dense_args(a, q, k, v, k_new, v_new, base_lens, out, layer, B, S, T, Hq, Hkv, hd))
    return (int)cudaErrorInvalidValue;
  const int rows = (Hq / Hkv) * T;
  dim3 grid((rows + 16 * W - 1) / (16 * W), Hkv, B);
  // two resident blocks per SM (16 warps): caps the kernel at 128 registers
  md::attend_kernel<64, N, W, 2><<<grid, 32 * W, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
