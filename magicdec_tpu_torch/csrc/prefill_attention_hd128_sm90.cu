// The head-dim-128 instances of the chunked-prefill attention kernels
// (prefill_attention_sm90.cu's prefill_sm90_kernel on Geo<128>), in a
// translation unit of their own so that they compile beside the
// head-dim-64 ones (kernels/build.py starts one nvcc a source): K2 (bf16
// cache), K2q (int8) and B11 (int4 packed in head pairs), each quantized one
// on f32 and bf16 scales.  The 7B/8B targets' chunked prefill runs on them.
// See prefill_attention_sm90.cu for the design; only the template arguments
// differ.
#define MD_HD128_UNIT
#include "prefill_attention_sm90.cu"

MD_PREFILL_BF16(md_prefill_attend_hd128, 128)
MD_PREFILL_QUANT(md_prefill_attend_quant_hd128, kI8, false, 128)
MD_PREFILL_QUANT(md_prefill_attend_quant_bf16s_hd128, kI8, true, 128)
MD_PREFILL_QUANT(md_prefill_attend_quant4_hd128, kI4, false, 128)
MD_PREFILL_QUANT(md_prefill_attend_quant4_bf16s_hd128, kI4, true, 128)
