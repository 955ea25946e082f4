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
  constexpr int W = 8, N = 64;
  if (hd != 64) return (int)cudaErrorInvalidValue;
  if ((k_new == nullptr) != (ks_new == nullptr)) return (int)cudaErrorInvalidValue;
  md::AttnArgs a{};  // the bf16 fields stay null
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
  const int rows = (Hq / Hkv) * T;
  dim3 grid((rows + 16 * W - 1) / (16 * W), Hkv, B);
  // two resident blocks per SM (16 warps): caps the kernel at 128 registers
  md::attend_kernel<64, N, W, 2, true>
      <<<grid, 32 * W, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
