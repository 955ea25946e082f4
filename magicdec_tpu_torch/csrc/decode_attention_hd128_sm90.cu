// The head-dim-128 instances of the decode / verify attention kernels
// (decode_attention_sm90.cu's bodies, QD = 128), in a translation unit of
// their own so that they compile beside the head-dim-64 ones (kernels/
// build.py starts one nvcc a source): K1 (bf16 cache, both calls), K1q
// (int8), B10 (int4 packed in head pairs) and B12's bf16, int8 and int4
// pools, each quantized one on f32 and bf16 scales.  The 7B/8B targets
// (llama-2-7b-32k, llama-3.1-8b, Qwen2.5-7b) attend through them.  See
// decode_attention_sm90.cu for the design; only the template arguments
// differ.
#define MD_HD128_UNIT
#include "decode_attention_sm90.cu"

MD_DECODE_BF16(md_decode_attend_hd128, 128)
MD_PAGED_BF16(md_paged_decode_attend_hd128, 128)
MD_DECODE_QUANT(md_decode_attend_quant_hd128, false, false, 128)
MD_DECODE_QUANT(md_decode_attend_quant_bf16s_hd128, false, true, 128)
MD_DECODE_QUANT(md_decode_attend_quant4_hd128, true, false, 128)
MD_DECODE_QUANT(md_decode_attend_quant4_bf16s_hd128, true, true, 128)
MD_PAGED_QUANT(md_paged_decode_attend_quant_hd128, false, false, 128)
MD_PAGED_QUANT(md_paged_decode_attend_quant_bf16s_hd128, false, true, 128)
MD_PAGED_QUANT(md_paged_decode_attend_quant4_hd128, true, false, 128)
MD_PAGED_QUANT(md_paged_decode_attend_quant4_bf16s_hd128, true, true, 128)
