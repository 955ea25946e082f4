// B10: flash decode / verify attention over the layer-stacked int4 cache,
// kv heads packed in pairs.
//
// Replaces magicdec_tpu/ops/pallas/decode_attention.py
// flash_decode_attend_quant4 (_decode_quant4_kernel, _unpack_int4_planes,
// blocked _decode_call).  A window of T <= 16 query tokens of request b
// attends the int4 cache rows [0, base_b) of layer `layer` (packed int8
// [L, B, S, (Hkv/2)*HD]: head h in the (h & 1) nibble plane of lanes
// (h/2)*HD), each with its f32 per-(token, kv head) k and v scale, plus,
// when given, its own T fresh packed rows and their scales (causal: fresh
// column c is visible to token t iff c <= t); without fresh rows the cache
// holds the window and token t sees [0, base_b + t + 1).
//
// Bound: HBM bytes, about a quarter of K1's: each visible row is HD/2 bytes
// of k and of v a head plus 4 bytes of scale each (the scales are ~11% of
// the bytes at hd 64).  Design: K1q's (split-KV with the same split plan,
// one-warp blocks, a combine pass, fresh rows read at their positions so a
// verify row and the same token's autoregressive step see identical tiles
// and splits) with the int4 tile path of attention_common.cuh: one block per
// (split, kv head, request), which stages its head's HD bytes of each
// packed row and converts its nibble plane to bf16 in shared memory.  The
// two heads of a pair read the same packed bytes in two blocks; the second
// read is served mostly by L2.
#include "attention_common.cuh"

// As md_decode_attend_quant, with packed int4 k/v [L, B, S, (Hkv/2)*hd]
// (+ k_new/v_new [B, T, (Hkv/2)*hd]); Hkv must be even.  Returns
// cudaGetLastError().
extern "C" int md_decode_attend_quant4(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* k_new, const void* v_new,
                                       const void* ks_new, const void* vs_new,
                                       const void* base_lens, void* out, void* part_o,
                                       void* part_ml, int layer, int B, int S, int T, int Hq,
                                       int Hkv, int hd, int nsplit, int chunk, void* stream) {
  md::AttnArgs a;
  if (!md::quant_args<true>(a, q, k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
                            base_lens, out, layer, B, S, T, Hq, Hkv, hd))
    return (int)cudaErrorInvalidValue;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.nsplit = nsplit;
  a.chunk = chunk;
  return md::decode_attend<true, true>(a, static_cast<cudaStream_t>(stream));
}
