// K1q: flash decode / verify attention over the layer-stacked int8 cache.
//
// Replaces magicdec_tpu/ops/pallas/decode_attention.py
// flash_decode_attend_quant (_decode_quant_kernel, _quant_online_update,
// blocked _decode_call; the int8 decode has no whole-row body).  A window of
// T <= 16 query tokens of request b attends the int8 cache rows [0, base_b)
// of layer `layer`, each with its f32 per-(token, kv head) k and v scale,
// plus, when given, its own T fresh int8 rows and their scales (causal: fresh
// column c is visible to token t iff c <= t); without fresh rows the cache
// holds the window and token t sees [0, base_b + t + 1).
//
// Bound: HBM bytes, about half of K1's: each visible row is HD int8 bytes of
// k and of v a head plus 4 bytes of scale each.  Design: K1's (split-KV,
// one-warp blocks, a combine pass, fresh rows read at their positions so a
// verify row and the same token's autoregressive step see identical tiles)
// with the int8 tile path of attention_common.cuh: the int8 rows and the
// scales land by cp.async two stages deep, each thread converts the chunks
// it copied to bf16 in shared memory, and the scales enter the scores and P
// as the TPU kernel applies them.  The conversion pass through shared
// memory costs a write, a read and a barrier per tile beyond K1's.
#include "attention_common.cuh"

// As md_decode_attend, with int8 k/v (+ k_new/v_new) and f32 scales
// k_scale/v_scale [L, B, Hkv, S] (+ ks_new/vs_new [B, Hkv, T]).  Returns
// cudaGetLastError().
extern "C" int md_decode_attend_quant(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* k_new, const void* v_new,
                                      const void* ks_new, const void* vs_new,
                                      const void* base_lens, void* out, void* part_o,
                                      void* part_ml, int layer, int B, int S, int T, int Hq,
                                      int Hkv, int hd, int nsplit, int chunk, void* stream) {
  md::AttnArgs a;
  if (!md::quant_args<false>(a, q, k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
                             base_lens, out, layer, B, S, T, Hq, Hkv, hd))
    return (int)cudaErrorInvalidValue;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.nsplit = nsplit;
  a.chunk = chunk;
  return md::decode_attend<true, false>(a, static_cast<cudaStream_t>(stream));
}
