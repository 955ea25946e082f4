// K1: flash decode / verify attention over the layer-stacked bf16 cache.
//
// Replaces magicdec_tpu/ops/pallas/decode_attention.py flash_decode_attend:
// both its blocked body (_decode_kernel) and its whole-row body
// (_whole_row_kernel).  A window of T <= 16 query tokens of request b attends
// the cache rows [0, base_b) of layer `layer` plus, when given, its own T
// fresh rows (causal: fresh column c is visible to token t iff c <= t);
// without fresh rows the cache holds the window and token t sees
// [0, base_b + t + 1).
//
// Bound: HBM bytes.  Each (request, kv head) reads its visible K/V rows
// once; the flops per byte are ~G*T, far under the tensor cores' ridge.
// Design: flash-decoding with a split over KV.  A TPU walks the KV blocks of
// one request in order and carries the softmax state in scratch; Hopper
// blocks run in parallel, so the KV rows of one (request, kv head) are cut
// into `nsplit` ranges, one 1-warp block each (G*T <= 16 rows fit one mma
// row tile), chosen so B*Hkv*nsplit blocks fill one wave of the 132 SMs even
// for the 640-row draft cache (kernels/decode_attention.py split_plan).
// Each split writes its (o, m, l) partial; a second small kernel merges them.  The fresh rows are read at their positions
// [base, base + T) (attention_common.cuh), so a verify row and the same
// token's autoregressive step see identical tiles.  Tiles past base + T are
// never loaded, as the TPU kernel's clamped index maps skip them.
#include "attention_common.cuh"

// Rows per (request, kv head) G*T are served by W = 1, 2, 4 or 8 warps of 16
// rows; the caller sizes part_o/part_ml with R = 16 * W (rows_pad in
// kernels/decode_attention.py).  Returns cudaGetLastError().
extern "C" int md_decode_attend(const void* q, const void* k, const void* v,
                                const void* k_new, const void* v_new,
                                const void* base_lens, void* out, void* part_o,
                                void* part_ml, int layer, int B, int S, int T, int Hq,
                                int Hkv, int hd, int nsplit, int chunk, void* stream) {
  md::AttnArgs a;
  if (!md::dense_args(a, q, k, v, k_new, v_new, base_lens, out, layer, B, S, T, Hq, Hkv, hd))
    return (int)cudaErrorInvalidValue;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.nsplit = nsplit;
  a.chunk = chunk;
  return md::decode_attend(a, static_cast<cudaStream_t>(stream));
}
