// K2q: chunked-prefill flash attention over the layer-stacked int8 cache.
//
// Replaces magicdec_tpu/ops/pallas/prefill_attention.py
// flash_prefill_attend_quant (_prefill_quant_kernel, _prefill_call).  A
// C-token chunk of request b attends the int8 cache rows [0, base_b) of
// layer `layer` (f32 per-(token, kv head) scales) plus its own fresh int8
// rows and scales with in-chunk causal masking (without fresh rows the
// cache holds the chunk and token t sees [0, base_b + t + 1)).
//
// Bound: tensor-core operations, as K2 (the int8 rows halve the bytes, which
// were not the limit).  Design: K2's (128 grouped query rows of one
// (request, kv head) per block, eight warps, 64-row tiles, mma.sync with
// fp32 accumulators, two resident blocks per SM) with the int8 tile path of
// attention_common.cuh: int8 rows and scales staged by cp.async, converted
// to bf16 in shared memory, the scales applied to the scores and P as the
// TPU kernel applies them.
#include "attention_common.cuh"

// As md_prefill_attend, with int8 k/v (+ k_new/v_new) and f32 scales
// k_scale/v_scale [L, B, Hkv, S] (+ ks_new/vs_new [B, Hkv, T]).  Returns
// cudaGetLastError().
extern "C" int md_prefill_attend_quant(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* k_new, const void* v_new,
                                       const void* ks_new, const void* vs_new,
                                       const void* base_lens, void* out, int layer, int B,
                                       int S, int T, int Hq, int Hkv, int hd, void* stream) {
  md::AttnArgs a;
  if (!md::quant_args<false>(a, q, k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
                             base_lens, out, layer, B, S, T, Hq, Hkv, hd))
    return (int)cudaErrorInvalidValue;
  return md::prefill_attend_quant<false>(a, static_cast<cudaStream_t>(stream));
}
