"""Chip smoke test of the PyTorch / H100 port (``magicdec_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them.  Phases, each
of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build of every kernel from ``magicdec_tpu_torch/csrc`` (timed), with
   ptxas's registers, shared memory and spills of the Hopper kernels of B4/B6,
   B4-int4/B6-int4, the 128-row core of B4/B6/B4-int4 (``qmm_m128_kernel``,
   its template argument 0 int8, 1 group-wise int8, 2 int4), B5/B9 (both
   cores) and B15's dense_mlp (their bf16
   instance), B15's dense_matmul_fused, K2/K2q/B11 and the decode
   kernel's instances (K1 and B12-bf16 with one to three row tiles a warp,
   K1q, B10, B12's int8/int4 pools; the template arguments are the format
   (0 int8, 1 int4, 2 bf16), the kv heads a block, the row tiles a warp,
   paged, bf16 scales and the head dim), the head-dim-128 ones from
   ``csrc/*_hd128_sm90.cu`` (built beside the others, one nvcc a source);
3. kernel phase: each Hopper kernel against its plain PyTorch version at the
   shapes of the bench's main path (llama-3.2-1b widths, B=32, target cache
   8704 rows in bf16 and in int8 with f32 scales quantized from the same
   values by ``ops.kv_cache.quantize_kv_tokens``, draft cache 640 rows),
   within ``kernels.bf16_limit`` (2**-5 times the RMS of each output row
   plus 2**-6 |ref|), the appends bit for bit; each attention kernel run
   without the window's fresh rows must fail that bound, so the check can
   tell a kernel that drops them.  With each: its time (CUDA events around 20
   calls issued from Python, ``ms``), its device-only time (``device_ms``:
   the same launches, one per layer in turn for a weight- or layer-stacked
   case, captured in one CUDA graph and replayed between CUDA events; the
   library call's likewise, ``library_device_ms``; a case that cannot be
   captured fails the run), its bound
   (the largest of bytes over 3.35 TB/s, flops over 989 TFLOP/s and, for
   attention, one exponential a visible (row, column) pair over 16 ex2 a
   clock on each of 132 SMs at the card's maximum SM clock; the int8
   kernels' bytes include the scales), the plain version's time
   and a library yardstick (``library_ms``: ``scaled_dot_product_attention``
   on the (dequantized) bf16 K/V for the attention kernels, ``index_copy_``
   of the rows (and scales) for the appends; timed only, never used by the
   port); the bf16-scale instances (``--kv_scale bf16``: K1q, B10 at T = 4
   and 1, K2q, B11 at C = 512, bases 7680 and 0, K3q on int8 and packed rows
   and B14's scale columns at T = 4, 1 and 512, B12's int8 and int4 pools
   and B13 at ps 512 and 16), each also against the same kernel's f32
   instance on the widened scales, 0 bits differing (the appends' scale
   caches compared bit for bit), their bound counting 2 bytes a scale; B4
   (wqkv + norm, w13 + gate, w2 + residual) and B6 (the head) on group-wise
   int8 weights (group 128) at M = 32, 64 and 128 (wrong reference: the
   group scales shifted by one group); K2, K2q and B11 (C = 512 at bases
   7680 and 0, and SnapKV's
   32-token window chunk at base 8192) also under torch.profiler, which
   must see one launch of ``prefill_sm90_kernel`` a call; K1 (target T = 4, 1 and 9,
   draft T = 1 and 2), K1q and B10 too, which must see one
   ``decode_sm90_kernel`` and, with more than one split, one
   ``combine_kernel`` a call, and for K1, K1q and B10 every token of a T = 4
   window at the target cache bit-equal to the T = 1 step at its position
   over a cache holding the window's earlier rows; then the int8 dots of the
   draft's weight copy (B4 with its norm,
   gate and residual epilogues, B5, B6, and B9), at llama-3.2-1b widths and
   M = 32 and 64 (B9 at 256), and the quantized target's shapes at its
   decode_rows M = 128 (B4 wqkv + norm and wo + residual, B9, B6 on the
   head and on the tied ``quantize_embed`` table through
   ``quantization.quant_matmul``), and B4 (all three), B5 and B6 again at
   llama-3.1-8b widths (path (20)'s draft copy: D 4096, F 14336, wqkv 4096
   -> 6144, the head 4096 -> 128256) at M = 32 and 64, then the quantized
   8B target's 128-row dots (path (28)): B4 wqkv + norm and wo + residual,
   B9 and B6 on the same int8 weights, B4 on group-wise int8 weights (wqkv +
   norm, wo + residual, w13 + norm + gate, w2 + residual), B4-int4 (wqkv,
   wo + residual, w13 + gate, w2 + residual) and B6-int4 (the head), each
   timed over 16 layers' weights in turn (4 at 8B); every B4, B6 and
   B4-int4 case of 128 rows runs on the 128-row core
   (``csrc/quant_matmul_m128_sm90.cu``, its cases and kernels-line entries
   tagged ``[128-row core]``, the profiler's kernel ``qmm_m128_kernel``)
   (B4, B5, B6 and B9 also under torch.profiler, which must see one kernel
   launch a call: B5's ``ffn_sm90_kernel``, B9's ``ffn_wg_sm90_kernel``), each
   with a deliberately wrong reference (B4 without its norm or residual, B5
   without its first residual, B6 with its scales off by one column, B9
   without its residual) that must fail bf16_limit, their bound the int8
   weight's bytes, and ``torch.matmul`` on the dequantized bf16 weight as
   the library yardstick of B4 and B6; and the int4 capacity format: B10
   and B11 over the head-pair-packed int4 cache quantized from the same
   values by ``quantize_kv_tokens_int4`` (wrong references: without the
   fresh rows, and with the nibble planes swapped), K3q on packed rows bit
   for bit, and the group-wise int4 dots B4-int4 (wqkv, wo + residual, w13
   + gate, w2 + residual) and B6-int4 (the head), each under torch.profiler
   one kernel launch a call, at M = 32, 64 and 128 (wrong references: the group
   scales shifted by one group, the head's scales rolled by one column),
   their bound the packed weight and its scales; the head-dim-128
   instances of B10 and B11 at the longspec path's 8B target (32 query
   heads, 8 kv heads of 128 dims, B = 8, an int4 cache of 8320 rows: B10
   at T = 4 and 1, each window token bit-equal to its step; B11 at C = 512,
   bases 7680 and 0; each counted on ``hd128_launches``, wrong references
   without the fresh rows and with the nibble planes swapped, one kernel
   launch a call under torch.profiler, library: SDPA); the
   head-dim-128 instances of the 8B self-speculation paths
   (``head_dim128_self_spec_cases``: llama-3.1-8b, B = 32, the target cache
   8704 rows, the draft's 640): K1 at T = 4 and 1 and the draft's
   whole-row call, K1q at T = 4 and 1 (each window token bit-equal to its
   step), K2 and K2q at C = 512, bases 7680 and 0, the bf16-scale K1q, B10
   (T = 4), K2q and B11 (C = 512), each bit-equal to its f32 instance on the
   widened scales, K3 and K3q on the 8B cache rows at T = 4, 1 and 512 bit
   for bit, and B12's bf16, int8, int4 and bf16-scale int8 / int4 pools (8
   ragged slots of 8192 rows, 512-row pages) bit-equal to the contiguous
   kernel over the gathered pool, each launch counted on
   ``hd128_launches``; and the paged serving kernels at the serving paths' shapes (16 slots of
   8192 rows, page size 512 and 16, a random permuted table, ragged lengths
   including 0 and 8192 - T): B12 over bf16, int8 and packed int4 pools
   (wrong references: two table entries swapped, the fresh rows dropped),
   each also bit-equal to its contiguous kernel over the gathered pool
   (each pool under torch.profiler as K1, K1q and B10), and
   B13 into each pool bit for bit (library: SDPA on the gathered layer,
   ``index_copy_`` through the flattened page indices); B14, the per-array
   appends (rows on the int8 target cache and the draft's bf16 cache, f32
   scale columns) at T = 4, 1 and 512 with a window running past the cache's
   end, bit for bit (library: ``index_copy_`` of the kept rows); and B15,
   the target's bf16 dots (``dense_matmul_fused`` as wqkv + norm, wo +
   residual, w13 + norm and w2 + residual at M = 128, 16 and 8; ``dense_mlp``
   on ``ffn_sm90.cu``'s bf16 instance at M = 128 and 16 and at the 8B
   widths, M = 128; each under torch.profiler one kernel launch a call),
   within bf16_limit, with wrong
   references (without the norm, without the residual, the w13 halves
   swapped) that must fail it (library: ``torch.matmul`` on the weight;
   for ``dense_mlp`` the main path's FFN with the dense kernels off); and
   S1, the coupled-Gumbel sampled head (``kernels/sampling.py``), at 128,
   32, 16 and 8 rows of 128,256 logits (divisor 0.6) and on 128 top-p-filtered
   rows, against its plain version: tokens equal on every row whose
   top-two gap is at least 1e-4, a wrong reference (salt + 1) disagreeing
   on most rows, 4096 stream positions of a 4-token row sampling its
   softmax to 0.03; its bound the integer ALU (library: none);
4. main paths: ``magicdec_tpu_torch.bench.main`` (1) with ``--iters 1``
   (its defaults otherwise: int8 target cache, int8 draft weight copy), (2) with ``--kv_quant none
   --draft_quant none --iters 1`` (all bf16, one measured repeat instead of
   three), (3) with ``--B 2 --prefix_len 2048 --iters 1`` (the draft
   prefill chunk's 256 rows take B9), (4) with ``--kv_quant int4
   --draft_quant int4 --iters 1`` (the int4 capacity path: B10, B11, K3q on
   packed rows, B4-int4 and B6-int4; B5, B9, K1q and K2q must not launch),
   (5) with ``--kv_quant int4 --B 8 --prefix_len 4096 --iters 1`` (the
   int4 cache under the int8 draft copy, at path (15)'s shape), each with the launch counters zeroed just before and read
   just after: every kernel of the path launched, tokens per step >= 2.5
   (>= 1.8 on path (4), whose int4 draft copy of random weights accepts
   less), the spec and autoregressive streams agreeing on every committed
   token of every request, path (1)'s peak device memory below path (2)'s
   and path (4)'s below path (1)'s, each path's time to first token (its
   last measured spec encode) printed; (12) ``--quantize int8
   --prefix_len 4096 --iters 1``
   (int8 verify weights shared by the draft: B4, B9 and B6 launched at the
   target's 128 rows, counted by row count; B5 on the draft; no int4 dot)
   against path (1), then the row check below on those weights at B = 32, 4
   and 2; (13) ``--quantize int4 --quantize_embed --prefix_len 2048 --iters
   1`` (B4-int4 and B6-int4 at 128 rows; no int8 dot, B5 or B9); (28)
   ``--model llama-3.1-8b --quantize int8 --B 32 --prefix_len 2048 --max_gen
   40 --iters 1`` (``QUANTIZED_8B_ARGV``: the quantized 8B target, the
   draft sharing its int8 weights: B4, B9 and B6 at 8B widths and 128 rows,
   B4 and B6 on the 128-row core, the draft's B4 / B5 / B6 at 32 and 64
   rows, attention on the head-dim-128 instances, >= 2.0 tokens per step,
   its time to first token and peak memory printed); on (12), (13) and
   (28) every quantized dot of at most 256 rows (a decode pass) must launch
   a kernel, and every B4 / B6 / B4-int4 launch above 64 rows must be the
   128-row core's; (15) path
   (5) and (16) path (1) with ``--kv_scale bf16`` at B=8 x 4096 (a depth
   cut for the time limit), every quantized-KV kernel
   of the path on its bf16-scale instance alone, beside path (5) / (1);
   (17)-(19) ``magicdec_tpu_torch.longspec_benchmark`` (standalone-draft
   speculation, ``LONGSPEC_ARGV``: llama-3.1-8b verified by llama-3.2-1b,
   the coupled synthetic pair, the draft's int8 copy, B=8, the int4 target
   cache, 512-token prefill chunks, ``--baseline``, one batch each, no
   warmup batch): streamingllm at 8192
   and snapkv at 8224 of 8320 rows, full mode at 4096 of 4608, each
   failing unless spec == AR on every committed token of every batch, B10
   and B11 launched on their head-dim-128 instances alone, the draft's
   K1, K3, B4, B5, B6 (and K2 for full and snapkv) and the target's K3q
   launched, no int8 KV, paged, per-array, dense or int4 dot kernel, and
   >= 2.2 tokens per step in streamingllm and snapkv, S1 idle; (23) exact
   speculative sampling on the streamingllm draft (``--temperature 0.6
   --top_p 0.9``, 4096 of 4608 rows): spec sampling == baseline sampling
   on every committed token, >= 2.2 tokens per step, S1 launched once a
   sampled head; then a paged int4
   ``PagedServingLongSpecEngine`` serve of 4 requests of distinct lengths
   (3072..4095) through 8 slots against ``ServingLongSpecEngine``, every
   token equal, B12's int4 pool at head dim 128 once a layer per target
   pass; (20) ``bench --model llama-3.1-8b --iters 1`` (self-speculation
   at the paper's target, the bench's defaults but 8 rows (a depth cut):
   B=8 x 4096, the int8
   cache, the int8 draft copy): spec == AR on every committed token, >= 2.0
   tokens per step, K1q, K2q and the draft's whole-row K1 launched on their
   head-dim-128 instances alone, K3, K3q and the draft's B4, B5, B6 at 8B
   widths, its time to first token and peak memory printed; (21) the same
   with ``--kv_quant none --draft_quant none`` at B=8 x 2048 (K1 and K2 at
   head dim 128; its peak printed); (22) the paged 8B serves (``SERVE8B``: 2
   requests of distinct lengths in [1024, 2048] through 8 slots, 512-row
   pages, the draft sharing the target's bf16 weights) over a bf16, an
   int8 and bf16-scale int8 and int4 pools, each against ``ServingEngine``
   token for token, B12 at head dim 128 once a layer per target pass, B13
   launched, every bf16-scale instance at head dim 128 launched (the
   contiguous twins: K1q and B10);
   group-wise int8 verify weights (``quantize_params(bits=8,
   group_size=128)``): the row check at B = 32, 4 and 2, and a short
   ``SpecEngine`` run (B=4, prefix 2048, max_gen 32, the int8 cache on bf16
   scales, the appends as B14's per-array calls) with spec == AR, B4 and B6
   on the grouped weights, B5 and B9 idle; then the
   paged serving paths, ``magicdec_tpu_torch.serving_bench.main`` with
   ``SERVE_ARGV`` (16 slots, 32 requests of distinct lengths in [4096,
   8000], 512-row pages): (6) a bf16 pool, (7) an int8 pool, (8) an int8
   pool of 96 of the 256 pages, fewer than its requests need
   (backpressure), (9) an int4 pool, each serving the first 2 of the
   requests (the int8 pools 8) without a warmup serve
   (depth cuts for the time limit), each failing unless every kernel of
   the path launched, the paged decode kernel once a layer per target pass,
   tokens per step >= 1.8, and ``ServingEngine`` on the same prompts
   returns the same tokens for every request; on the int8 path, 2 requests
   each served alone through the same 16 slots return their served tokens,
   and the small pool peaks below the full one; (10) the default path over
   a 4096-token prefix with the JAX package's kernel A/B switches on, ``set_dense_kernels(True)``
   and ``MAGICDEC_PER_ARRAY_APPEND=1``: B14 and B15 launched, K3, K3q and
   B13 idle, spec == AR; ``bench --gamma 0 --B 2 --prefix_len 2048``: the
   gamma the autotune picks, spec == AR at it; (11) ``--mode snapkv --iters
   1`` (SnapKV self-speculation at the bench defaults, the prefix rounded to
   8224, after checking that ``torch.backends.cuda.matmul.allow_tf32`` is
   False so that the compression's scores run in float32): K2q (its chunks
   and the 32-token window chunk, counted exactly), K1q, K1, K3q, K3, B4,
   B5 and B6 launched, no paged, per-array, B9 or B15 kernel, spec == AR on
   all 32 requests, >= 2.5 tokens per step, its time to first token and
   peak memory beside path (1)'s and the compression's share of the
   encode printed; then the paged SnapKV serve (``SNAPKV_SERVE_ARGV``: 16
   slots, 16 requests of 7968 tokens, an int8 pool of 512-row pages): B12's
   int8 pool once a layer per target pass, B13 and K3 (the verify's two
   appends) launched, ``ServingEngine`` on the same prompts giving every
   token; then ``--kv_scale bf16`` serves over an int8 and an int4 pool (2
   requests each): B12, B13, K2q / B11 and K3q on bf16 scales alone, tokens
   equal to ``ServingEngine``'s;
5. C2, served == solo: 2 equal-length prompts (one admission bucket)
   served through 16 slots over an int8 pool, each against the same prompt
   served alone through the same slots and against a B=1 ``SpecEngine`` on
   the same weights; where tokens differ, again at a fixed row count (each
   prefill alone; the B=1 decode at the slots' rows and split plan), which
   must agree (the stream of 4 distinct lengths of earlier runs is cut for
   the time limit: (24) serves 4 distinct lengths against B=1 runs, sampled);
   (24) sampled serving (``SAMPLED_SERVE_ARGV``: ``serving_bench --paged
   --kv_quant int8 --temperature 0.8 --top_p 0.9``, llama-3.2-1b, 4
   requests of distinct lengths in [1024, 2048] through 8 slots): each
   request's tokens equal to a B=1 ``SpecEngine`` run of its prompt with its
   request id as the salt, at the slots' row count as C2 fixes it; S1
   launched once a sampled head;
   (14) the checkpoint round trip at full width: an HF-format
   llama-3.2-1b directory (two safetensors shards written by hand, the
   index, ``config.json``) from ``bench.make_params(tied=True)``, ``python
   -m magicdec_tpu_torch.convert_checkpoint --quantize int8`` on it (a
   process of its own, started before C2 and waited for after (24)),
   ``serving_bench --model`` on the bf16 file and on the int8 dump (8
   requests of 2048 tokens) each equal token for token to a serve of the
   in-memory params (the int8 one: ``quantize_params`` of them, scales
   rounded through bf16), and the int8 dump's NLL within 2% of the bf16
   file's on 4 windows of 2048 tokens (``quality.perplexity``, K2);
   (25) ``perplexity_benchmark`` at llama-3.2-1b (``PPL_ARGV``: 8 windows
   of 2048 tokens, 4 a batch, 512-token chunks) with ``--compare
   kv_int8``, ``kv_int4`` and ``int8``: the kv_int8 NLL within 1% of the
   bf16 one, the int8 weights' within 2%, kv_int4 finite, K2, K2q and
   B11 launched, the bf16 NLL equal to a direct ``quality.perplexity``
   call to 1e-6; (26) ``baseline_benchmark`` and ``selfspec_benchmark
   --benchmark --draft_quant --draft_budget 513`` on one batch of 8
   prompts of 4000 tokens over the int8 cache (``DRIVER_ARGV``): the
   self-spec committed tokens equal to the baseline's on every row, >=
   2.2 tokens per step, the autotune's gamma one of its candidates, K2q,
   K1q, K3q (and the draft's K1, K3, B4, B5, B6) launched; (27)
   ``profile_draft --iters 10`` (each chain's time finite and positive;
   K1, K3, B4, B5, B6 launched) and ``sweep_benchmark --set smoke`` (a
   bench process; one row with a result and its table line); (29) tensor
   parallelism (``TP_ARGV`` + ``TP_MESH``: ``selfspec_benchmark --model
   llama-3.1-8b --model_parallel 2 --dist_backend gloo --kv_quant int8
   --draft_quant int8``, B=8 x 1024, 32 tokens, 2 ranks on this card
   through ``parallel.multihost.launch``, then the autoregressive baseline
   on the same engine): the ranks agree, spec == AR on every committed token, >=
   2.0 tokens per step, every token equal to a TP 1 run of the same
   arguments except where TP 1's top-two logit gap is below twice
   ``SPREAD_LIMIT`` of TP 1's largest |logit|, the two runs' logits at the
   prompts' last position within ``SPREAD_LIMIT`` (0.025) of it and a
   control (rank 1 dropping wo's sums) beyond it, on each rank K2q, K1q,
   K1, K3q, K3, B4 and B6 launched (the attention at head dim 128 on 4
   local kv heads, B4 on the local wqkv's 3072 columns, B6 on the padded
   head shard's 64,256), B5, B9, B15's dense_mlp and every plain product of
   a decode pass idle, each rank's peak memory, all-reduces and gloo
   transport printed; (30) data parallelism (``DP_SERVE_ARGV`` +
   ``DP_MESH``: ``serving_bench --paged --kv_quant int8 --data_parallel 2
   --dist_backend gloo``, llama-3.2-1b, 8 requests of distinct lengths in
   [1024, 2048] through 8 slots, 16 pages that must block): the ranks
   agree, B12 (int8 pool) and B13 on both ranks, each request equal to its
   B=1 run (C2's fixed-row recheck where they differ), then
   ``--force_mesh --dist_backend nccl`` (one rank) equal to the meshless
   serve token for token;
6. row invariance at B=32, 4 and 2 (the verify of ``forward_target`` and
   of SnapKV's ``forward_verify_snapkv``), on cuBLAS and with the target's
   dots on B15: for each of the target's dots, and for two layers and the head, a
   row's bits at verify (B*(gamma+1) rows) against the AR step (B rows),
   at the live row count and padded to decode_rows; fails if the model's
   rows differ when padded, which the engine runs;
7. the dense A/B, ``profile_decode`` at B=32, ctx 8192, the int8 cache
   (baseline, verify and noctx steps), without then with ``--dense_kernels``
   (one run each: the two turns of earlier runs are a depth cut for the
   time limit), and ``kernel_benchmark --which append`` (merged against
   per-array appends);
8. profile: where the decode time goes at the bench's default shapes,
   over a 4096-token prompt, 24 generated tokens (``PROFILE_ARGV``; 80,
   then 40 in earlier runs, and 8192-token prompts) (spec
   generate and AR generate on the host clock, with the host time spent
   issuing draft steps, then under torch.profiler for the device's busy
   time and the kernels that take it), spec == AR again, and the AR step's
   decode_rows padding against its live rows, two alternating pairs in one
   run (the int4, SnapKV and ``--quantize int8`` profiles and two of the
   four pairs are cut for the time limit).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import itertools
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
EX2_PER_CLOCK_SM = 16     # compute capability 9.0: ex2 a clock per SM
SMS = 132                 # H100 SXM
PAD_PAIRS = 2             # profile_phase: AR generate padded / live, alternating pairs
# profile_phase: the bench's B=32, 24 of its 80 tokens over half its prompt
PROFILE_ARGV = ["--max_gen", "24", "--prefix_len", "4096"]
SM_CLOCK_HZ = None        # the card's maximum SM clock (nvidia-smi), set in main
INT32_PER_CLOCK_SM = 64   # compute capability 9.0: integer ALU lanes an SM
FP32_PER_CLOCK_SM = 128   # float32 lanes an SM (an FMA counted once)
# S1's work an element, counted from csrc/sampling_sm90.cu: integer, the
# hash's 20 rounds of add, rotate and xor (60), its 10 key injections and
# the counter's add, the bits' xor, shift and or, the loop's add and
# compare (76); float32, the uniform's subtract, add and max, two accurate
# logf (about 12 each), the IEEE division (about 5: a reciprocal and its
# refinement), the add and the two compares of the running max (35)
S1_INT_OPS, S1_FP32_OPS = 76, 35


def _cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _round(ms):
    return ms if ms is None else round(ms, 4)


def _bound(nbytes, flops, exps=0.0, int_ops=0.0, fp32_ops=0.0):
    """(ms, kind): the largest of the bytes over the HBM rate, the tensor
    flops over the bf16 peak and, for attention, the exponentials over the
    SMs' ex2 rate at the card's maximum SM clock; for S1 the operations are
    the integer and float32 ALU instructions over their lanes' rates (the
    slower pipe)."""
    alu = max(int_ops / INT32_PER_CLOCK_SM, fp32_ops / FP32_PER_CLOCK_SM) / (SMS * SM_CLOCK_HZ)
    times = {"bytes": nbytes / PEAK_BYTES_S,
             "operations": max(flops / PEAK_BF16_FLOPS, alu),
             "exp": exps / (EX2_PER_CLOCK_SM * SMS * SM_CLOCK_HZ) if exps else 0.0}
    kind = max(times, key=times.get)
    return times[kind] * 1e3, kind


def _outside(out, ref):
    """(max |out - ref|, elements outside kernels.bf16_limit(ref), the
    largest share of the bound any element uses)."""
    from magicdec_tpu_torch.kernels import bf16_limit

    diff = (out.float() - ref.float()).abs()
    share = diff / bf16_limit(ref)
    return diff.max().item(), int((share > 1).sum()), share.max().item()


def _err(out, ref):
    """max |out - ref| and a note of the bound's use, raising if any
    element is outside the bound."""
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    err, bad, share = _outside(out, ref)
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: max abs err "
                             f"{err:.4g}, {bad} elements outside bf16_limit "
                             f"(up to {share:.3g} of it)")
    return err, f"at most {share:.3f} of bf16_limit"


def _sdpa_inputs(q, k_layer, v_layer, base, k_new, v_new):
    """(q, k, v, mask) for scaled_dot_product_attention computing the same
    attention as the kernels over one layer [B, S, K] in bf16: cache rows <
    base plus causal fresh rows."""
    import torch

    B, T, Hq, hd = q.shape
    S, K = k_layer.shape[1], k_layer.shape[2]
    Hkv = K // hd
    kf = torch.cat([k_layer, k_new], dim=1).view(B, S + T, Hkv, hd).transpose(1, 2)
    vf = torch.cat([v_layer, v_new], dim=1).view(B, S + T, Hkv, hd).transpose(1, 2)
    kf = kf.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vf = vf.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    col = torch.arange(S + T, device=q.device)
    t = torch.arange(T, device=q.device)
    cache_vis = col[None, None, :] < base[:, None, None]
    fresh_vis = (col[None, :] - S <= t[:, None]) & (col[None, :] >= S)
    mask = (cache_vis | fresh_vis[None])[:, None]
    return q.transpose(1, 2).contiguous(), kf, vf, mask


BF16S = "[bf16 scales]"  # the cases and kernels-line entries of the bf16-scale instances
BF16S_CUT = ["--B", "8", "--prefix_len", "4096"]  # paths (5), (15), (16): a depth cut
# paths (10) and (12): the bench's 32 rows (the target's dots at 128) over
# half its prefix, a depth cut for the time limit
HALF_PREFIX = ["--prefix_len", "4096"]
GROUP8 = 128                    # the group-wise int8 weights' group
GROUPED8 = "[group-wise int8]"  # ... and of B4 / B6 on them
# the cases and kernels-line entries of B4, B6 and B4-int4 on the 128-row
# core (csrc/quant_matmul_m128_sm90.cu: every call of 65 to 256 rows)
M128 = "[128-row core]"
M128_KERNEL = "qmm_m128_kernel"


def _same_bits_as_f32(torch, what, out, run, caches, fresh):
    """A bf16-scale launch's output ``out`` against ``run`` (the same
    kernel) on the cache operands (k, k_scale, v, v_scale) and fresh rows
    with every scale widened to f32: 0 bits may differ."""
    wide = [c.float() if i % 2 else c for i, c in enumerate(caches)]
    wfresh = {n: t.float() if n in ("ks_new", "vs_new") else t for n, t in fresh.items()}
    twin = run(wide, wfresh)
    differ = int((out.view(torch.int16) != twin.view(torch.int16)).sum())
    print(f"[kernel] {what}: {differ} of {out.numel()} outputs differ in bits from the f32 "
          "instance on the widened scales", flush=True)
    if differ:
        raise AssertionError(f"{what}: the bf16-scale instance differs from the f32 one on the "
                             "widened scales")


def _same_scale_bits(name, case, got, wide, data=2):
    """An append's bf16-scale results (``data`` data arrays, then scales)
    against its f32 instance's on the widened scales, bit for bit."""
    import torch

    same = all(torch.equal(a, b) for a, b, in zip(got[:data], wide[:data])) and all(
        torch.equal(a.float().view(torch.int32), b.view(torch.int32))
        for a, b in zip(got[data:], wide[data:]))
    if not same:
        raise AssertionError(f"{name} {case}: the bf16-scale instance differs from the f32 one "
                             "on the widened scales")
    print(f"[kernel] {name} {case}: bit-equal to the f32 instance on the widened scales",
          flush=True)


def _swap_planes(packed):
    """Packed int4 bytes with their nibbles swapped: kv heads 2i and 2i+1
    exchanged (a wrong reference)."""
    return (packed << 4) | ((packed >> 4) & 0x0F)


def _case_kit(torch, record, gen, L, B, Hq, Hkv, hd, layer):
    """The kernel phase's attention and append cases at one model's widths
    (L layers, B requests, Hq and Hkv heads of hd dims; the checks read
    layer ``layer``), recorded by ``record`` under their names, and the
    operands' makers.  Returns a namespace of randn, quantize, dense_fresh,
    quant_fresh, attn_case and append_case."""
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import (dequant_kv, quantize_kv_tokens,
                                                 quantize_kv_tokens_int4)

    F = torch.nn.functional
    dev = torch.device("cuda")
    bf = torch.bfloat16
    K = Hkv * hd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    def quantize(x, fn=quantize_kv_tokens, scale_dtype=torch.float32):
        """[L, B, S, K] bf16 -> int8 [L, B, S, K] (``fn`` the int4
        quantizer: packed in head pairs, K / 2 bytes a row) and scales [L,
        B, Hkv, S] in ``scale_dtype``, one layer at a time (the float32
        temporaries of a whole cache would take 18 GB)."""
        Lx, Bx, Sx = x.shape[:3]
        width = K // 2 if fn is quantize_kv_tokens_int4 else K
        q = torch.empty((Lx, Bx, Sx, width), dtype=torch.int8, device=dev)
        s = torch.empty((Lx, Bx, Hkv, Sx), dtype=scale_dtype, device=dev)
        for l in range(Lx):
            q[l], s[l] = fn(x[l].view(Bx, Sx, Hkv, hd), scale_dtype=scale_dtype)
        return q, s

    def dense_fresh(T):
        return {"k_new": randn(B, T, K), "v_new": randn(B, T, K)}

    def quant_fresh(T, fn=quantize_kv_tokens, scale_dtype=torch.float32):
        (kn, ksn), (vn, vsn) = (fn(randn(B, T, Hkv, hd), scale_dtype=scale_dtype)
                                for _ in range(2))
        return {"k_new": kn, "v_new": vn, "ks_new": ksn, "vs_new": vsn}

    def swapped(plain, caches):
        """A wrong reference of an int4 kernel: its plain version over layer
        `layer` with the nibble planes of the cache and the fresh rows
        swapped."""
        kq, ks, vq, vs = (c[layer:layer + 1] for c in caches)

        def run(q, base, fresh):
            sw = {n: _swap_planes(t) if n in ("k_new", "v_new") else t
                  for n, t in fresh.items()}
            return plain(q, _swap_planes(kq), ks, _swap_planes(vq), vs, base, layer=0, **sw)
        return run

    def dense_layer(caches, fresh):
        """(k, v, k_new, v_new) of layer `layer` in bf16 for the library call."""
        if len(caches) == 2:
            return caches[0][layer], caches[1][layer], fresh["k_new"], fresh["v_new"]
        kq, ks, vq, vs = caches
        return (dequant_kv(kq[layer], ks[layer], hd, bf),
                dequant_kv(vq[layer], vs[layer], hd, bf),
                dequant_kv(fresh["k_new"], fresh["ks_new"], hd, bf),
                dequant_kv(fresh["v_new"], fresh["vs_new"], hd, bf))

    def attn_case(name, fn, plain, case, caches, make_fresh, T, base, plain_iters,
                  swap=False, profile=True):
        """caches: the cache operands as the kernel takes them, (k, v) or
        (k, k_scale, v, v_scale); make_fresh(T): the window's rows; swap: an
        int4 cache, whose plain version with the nibble planes swapped must
        fail too.  bf16 scales: the same kernel's f32 instance on the
        widened scales must give the same bits.  ``profile``: count the
        kernel launches a call under torch.profiler."""
        q = randn(B, T, Hq, hd)
        fresh = make_fresh(T)
        n128 = getattr(fn, "hd128_launches", 0)
        out = fn(q, *caches, base, layer=layer, **fresh)
        if hd == 128 and fn.hd128_launches != n128 + 1:
            raise AssertionError(f"{name} {case}: the launch did not take the head-dim-128 "
                                 "instance")
        ref = plain(q, *caches, base, layer=layer, **fresh)
        torch.cuda.synchronize()
        err, tol = _err(out, ref)
        if len(caches) == 4 and caches[1].dtype == bf:
            _same_bits_as_f32(torch, f"{name} {case}", out,
                              lambda c, f: fn(q, *c, base, layer=layer, **f), caches, fresh)
        # the same kernel without the fresh rows reads the cache where they
        # belong: bf16_limit must reject it
        wrongs = {"without the fresh rows": fn(q, *caches, base, layer=layer)}
        if swap:
            wrongs["the plain version with the nibble planes swapped"] = swapped(
                plain, caches)(q, base, fresh)
        for what, wrong in wrongs.items():
            wrong_err, wrong_bad, wrong_share = _outside(wrong, ref)
            print(f"[kernel] {name} {case}: {what} max_abs_err={wrong_err:.3e}, "
                  f"{wrong_bad} of {ref.numel()} elements outside bf16_limit (up to "
                  f"{wrong_share:.3g} of it)", flush=True)
            if not wrong_bad:
                raise AssertionError(f"{name} {case}: bf16_limit passes {what}")
        del wrongs
        # timed over the layers in turn: one layer of the draft cache fits
        # the 50 MB L2, which the model's pass never finds warm
        layers = itertools.cycle(range(L))
        ms = _cuda_ms(lambda: fn(q, *caches, base, layer=next(layers), **fresh))
        plain_ms = _cuda_ms(lambda: plain(q, *caches, base, layer=layer, **fresh),
                            iters=plain_iters, warmup=1)
        kl, vl, knl, vnl = dense_layer(caches, fresh)
        lib_args = _sdpa_inputs(q, kl, vl, base, knl, vnl)
        del kl, vl

        def lib():
            return F.scaled_dot_product_attention(lib_args[0], lib_args[1], lib_args[2],
                                                  attn_mask=lib_args[3])
        library_ms = _cuda_ms(lib)
        vis = base.double()
        pairs = float((vis[:, None] + torch.arange(1, T + 1, device=dev)).sum())
        # a visible row of k (and of v): its bytes (int4: K / 2) and, when
        # quantized, its Hkv scales
        row_bytes = (caches[0].shape[-1] * caches[0].element_size()
                     + (Hkv * caches[1].element_size() if len(caches) == 4 else 0))
        nbytes = (2 * q.numel() * 2 + 2 * float(vis.sum()) * row_bytes
                  + sum(t.numel() * t.element_size() for t in fresh.values()))
        flops = 4 * hd * Hq * pairs
        calls = [lambda l=l: fn(q, *caches, base, layer=l, **fresh) for l in range(L)]
        extra = None
        if not profile:
            pass
        elif fn in (PA.flash_prefill_attend, PA.flash_prefill_attend_quant,
                    PA.flash_prefill_attend_quant4):
            # K2 / K2q / B11: one launch of the Hopper kernel a call
            extra = _one_launch(torch, name, case, calls, kernel="prefill_sm90_kernel")
        elif fn in (DA.flash_decode_attend, DA.flash_decode_attend_quant,
                    DA.flash_decode_attend_quant4):
            # K1 (bf16), K1q, B10: one decode_sm90_kernel a call, and the
            # combine when the plan has more than one split
            plan = DA.split_plan if fn is DA.flash_decode_attend else DA.quant_split_plan
            nsplit = plan(B, Hkv, caches[0].shape[2], hd)[0]
            extra = _decode_sm90_launches(torch, name, case, calls, nsplit)
        # one exponential a visible (row, column) pair
        record(name, case, err, tol, ms, plain_ms, nbytes, flops, library_ms, calls, [lib],
               extra, exps=Hq * pairs)
        del lib_args



    def flat_index(rows, pos, T, S):
        """Flat row indices of the appended rows ([L, rows, S] viewed as one
        axis; rows = B for the data, B * Hkv for the scales, each request's
        rows at its position)."""
        lead = torch.arange(L * rows, device=dev).view(L, rows)[..., None] * S
        start = pos.long().repeat_interleave(rows // B)[None, :, None]
        return (lead + start + torch.arange(T, device=dev)[None, None]).reshape(-1)

    def append_case(name, fn, plain, caches, rows, pos, T, label=""):
        """Bit-exact against the plain version on copies of the caches, then
        timed; caches and rows in the wrapper's order, data then scales."""
        case = f"{label}T={T}"
        copies = [c.clone() for c in caches]
        fn(*copies[:2], *rows[:2], pos, *copies[2:], *rows[2:])
        if len(caches) == 4 and caches[2].dtype == bf:
            # the f32 instance on the widened scales writes the same values
            wide = [c.clone() if i < 2 else c.float() for i, c in enumerate(caches)]
            fn(*wide[:2], *rows[:2], pos, *wide[2:], *(r.float() for r in rows[2:]))
            _same_scale_bits(name, case, copies, wide)
            del wide
        plain(*caches[:2], *rows[:2], pos, *caches[2:], *rows[2:])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(copies, caches)):
            raise AssertionError(f"{name} {case}: kernel and plain version differ")
        del copies
        ms = _cuda_ms(lambda: fn(*caches[:2], *rows[:2], pos, *caches[2:], *rows[2:]))
        plain_ms = _cuda_ms(lambda: plain(*caches[:2], *rows[:2], pos, *caches[2:], *rows[2:]),
                            iters=5, warmup=1)
        S = caches[0].shape[2]
        flat = flat_index(B, pos, T, S)
        width = caches[0].shape[-1]
        pairs = [(caches[i].view(-1, width), flat, rows[i].reshape(-1, width)) for i in (0, 1)]
        if len(caches) == 4:
            sflat = flat_index(B * Hkv, pos, T, S)
            pairs += [(caches[i].view(-1), sflat, rows[i].reshape(-1)) for i in (2, 3)]
        library_ms = _cuda_ms(lambda: [c.index_copy_(0, i, r) for c, i, r in pairs])
        nbytes = 2 * sum(r.numel() * r.element_size() for r in rows)  # read + write
        call = lambda: fn(*caches[:2], *rows[:2], pos, *caches[2:], *rows[2:])  # noqa: E731
        lib = lambda: [c.index_copy_(0, i, r) for c, i, r in pairs]  # noqa: E731
        record(name, case, 0.0, "bit-exact", ms, plain_ms, nbytes, 0.0, library_ms,
               [call] * 10, [lib] * 10)

    return SimpleNamespace(randn=randn, quantize=quantize, dense_fresh=dense_fresh,
                           quant_fresh=quant_fresh, attn_case=attn_case,
                           append_case=append_case)


def kernel_phase(torch, gen):
    from magicdec_tpu_torch.kernel_benchmark import graph_ms
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens_int4

    dev = torch.device("cuda")
    L, B, Hq, Hkv, hd = 16, 32, 32, 8, 64
    K = Hkv * hd
    bf = torch.bfloat16
    S, Sd = 8704, 640
    layer = 5
    entries = {}

    def record(name, case, err, tol, ms, plain_ms, nbytes, flops, library_ms, calls,
               lib_calls=None, extra=None, exps=0.0, int_ops=0.0, fp32_ops=0.0):
        """One case: its host-issued times (``ms``, ``plain_ms``,
        ``library_ms``), and the device-only times of ``calls`` (the
        kernel's launches) and ``lib_calls`` (the library call's) from CUDA
        graph replay; a case that cannot be captured fails the run."""
        bound_ms, bound_by = _bound(nbytes, flops, exps, int_ops, fp32_ops)
        device_ms = graph_ms(calls)
        lib_device_ms = graph_ms(lib_calls) if lib_calls else None
        c = {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
             "device_ms": device_ms, "library_device_ms": lib_device_ms, **(extra or {})}
        entries.setdefault(name, []).append(c)
        print(f"[kernel] {name} {case}: max_abs_err={err:.3e} ({tol}) "
              f"ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}, {bound_ms / device_ms:.1%} of roofline) "
              f"library_ms={_round(library_ms)} library_device_ms={_round(lib_device_ms)}",
              flush=True)
        return c

    kit = _case_kit(torch, record, gen, L, B, Hq, Hkv, hd, layer)
    randn, quantize, dense_fresh, quant_fresh = (kit.randn, kit.quantize, kit.dense_fresh,
                                                 kit.quant_fresh)
    attn_case, append_case = kit.attn_case, kit.append_case

    def quantize4(x, scale_dtype=torch.float32):
        return quantize(x, quantize_kv_tokens_int4, scale_dtype)

    def quant4_fresh(T):
        return quant_fresh(T, quantize_kv_tokens_int4)

    def bf16s_fresh(T):
        return quant_fresh(T, scale_dtype=bf)

    def bf16s4_fresh(T):
        return quant_fresh(T, quantize_kv_tokens_int4, bf)

    k4, v4 = randn(L, B, S, K), randn(L, B, S, K)
    dk4, dv4 = randn(L, B, Sd, K), randn(L, B, Sd, K)

    # K1 at the target cache: verify (T = gamma + 1 = 4), the AR step and
    # the widest window bench --gamma 0 tries (gamma 8: 36 rows, three row
    # tiles a warp), ragged lengths around the bench's prefix
    base_t = torch.randint(8192, 8600, (B,), generator=gen, device=dev, dtype=torch.int32)
    base_d = torch.randint(513, 600, (B,), generator=gen, device=dev, dtype=torch.int32)
    for T in (4, 1, 9):
        attn_case("flash_decode_attend", DA.flash_decode_attend,
                  DA.flash_decode_attend_plain, f"target T={T} S={S}", (k4, v4),
                  dense_fresh, T, base_t, 3)
    _window_equals_steps(torch, "flash_decode_attend", DA.flash_decode_attend, (k4, v4), layer,
                         randn(B, 4, Hq, hd), base_t, dense_fresh(4))
    for T in (1, 2):
        attn_case("flash_decode_attend", DA.flash_decode_attend,
                  DA.flash_decode_attend_plain, f"draft T={T} S={Sd}", (dk4, dv4),
                  dense_fresh, T, base_d, 3)
    # the prefill chunks at the first and last bases of an encode, and
    # SnapKV's 32-token observation-window chunk at the bench's 8192-token
    # pre-window prefix
    prefill_shapes = ((512, 7680), (512, 0), (32, 8192))
    for C, base in prefill_shapes:
        attn_case("flash_prefill_attend", PA.flash_prefill_attend,
                  PA.flash_prefill_attend_plain, f"C={C} base={base}", (k4, v4),
                  dense_fresh, C, torch.full((B,), base, device=dev, dtype=torch.int32), 1)
    del dk4, dv4

    # K1q and K2q over the int8 cache quantized from the same values, at the
    # same lengths
    kq4, ks4 = quantize(k4)
    vq4, vs4 = quantize(v4)
    qcaches = (kq4, ks4, vq4, vs4)
    for T in (4, 1):
        attn_case("flash_decode_attend_quant", DA.flash_decode_attend_quant,
                  DA.flash_decode_attend_quant_plain, f"target T={T} S={S}", qcaches,
                  quant_fresh, T, base_t, 3)
    _window_equals_steps(torch, "flash_decode_attend_quant", DA.flash_decode_attend_quant,
                         qcaches, layer, randn(B, 4, Hq, hd), base_t, quant_fresh(4))
    for C, base in prefill_shapes:
        attn_case("flash_prefill_attend_quant", PA.flash_prefill_attend_quant,
                  PA.flash_prefill_attend_quant_plain, f"C={C} base={base}", qcaches,
                  quant_fresh, C, torch.full((B,), base, device=dev, dtype=torch.int32), 1)
    # B10 and B11 over the int4 cache packed in head pairs, quantized from
    # the same values
    kp4, kps4 = quantize4(k4)
    vp4, vps4 = quantize4(v4)
    pcaches = (kp4, kps4, vp4, vps4)
    for T in (4, 1):
        attn_case("flash_decode_attend_quant4", DA.flash_decode_attend_quant4,
                  DA.flash_decode_attend_quant4_plain, f"target T={T} S={S}", pcaches,
                  quant4_fresh, T, base_t, 3, swap=True)
    _window_equals_steps(torch, "flash_decode_attend_quant4", DA.flash_decode_attend_quant4,
                         pcaches, layer, randn(B, 4, Hq, hd), base_t, quant4_fresh(4))
    for C, base in prefill_shapes:
        attn_case("flash_prefill_attend_quant4", PA.flash_prefill_attend_quant4,
                  PA.flash_prefill_attend_quant4_plain, f"C={C} base={base}", pcaches,
                  quant4_fresh, C, torch.full((B,), base, device=dev, dtype=torch.int32), 1,
                  swap=True)
    # --kv_scale bf16: the same values quantized with bf16 scales (2 bytes a
    # scale); K1q, B10, K2q and B11 take their bf16-scale instances, each
    # also bit for bit against its f32 instance on the widened scales
    bcaches = (*quantize(k4, scale_dtype=bf), *quantize(v4, scale_dtype=bf))
    bpcaches = (*quantize4(k4, bf), *quantize4(v4, bf))
    for T in (4, 1):
        attn_case(f"flash_decode_attend_quant {BF16S}", DA.flash_decode_attend_quant,
                  DA.flash_decode_attend_quant_plain, f"target T={T} S={S}", bcaches,
                  bf16s_fresh, T, base_t, 3, profile=False)
        attn_case(f"flash_decode_attend_quant4 {BF16S}", DA.flash_decode_attend_quant4,
                  DA.flash_decode_attend_quant4_plain, f"target T={T} S={S}", bpcaches,
                  bf16s4_fresh, T, base_t, 3, swap=True, profile=False)
    for C, base in prefill_shapes[:2]:
        at = torch.full((B,), base, device=dev, dtype=torch.int32)
        attn_case(f"flash_prefill_attend_quant {BF16S}", PA.flash_prefill_attend_quant,
                  PA.flash_prefill_attend_quant_plain, f"C={C} base={base}", bcaches,
                  bf16s_fresh, C, at, 1, profile=False)
        attn_case(f"flash_prefill_attend_quant4 {BF16S}", PA.flash_prefill_attend_quant4,
                  PA.flash_prefill_attend_quant4_plain, f"C={C} base={base}", bpcaches,
                  bf16s4_fresh, C, at, 1, swap=True, profile=False)
    torch.cuda.empty_cache()

    # K3 and K3q: bit-exact against the plain versions on copies of the
    # target caches
    for T in (4, 1, 512):
        pos = torch.randint(0, S - T, (B,), generator=gen, device=dev, dtype=torch.int32)
        append_case("append_all_rows_inplace", AP.append_all_rows_inplace,
                    AP.append_all_rows_inplace_plain, (k4, v4),
                    (randn(L, B, T, K), randn(L, B, T, K)), pos, T)
    del k4, v4
    for T in (4, 1, 512):
        pos = torch.randint(0, S - T, (B,), generator=gen, device=dev, dtype=torch.int32)
        (rk, srk), (rv, srv) = (quantize(randn(L, B, T, K)) for _ in range(2))
        append_case("append_all_rows_inplace_quant", AP.append_all_rows_inplace_quant,
                    AP.append_all_rows_inplace_plain, (kq4, vq4, ks4, vs4),
                    (rk, rv, srk, srv), pos, T)
    del qcaches, kq4, ks4, vq4, vs4
    # K3q on the int4 cache's packed rows: (Hkv / 2) * hd bytes a row, the
    # scales of all Hkv heads
    for T in (4, 1, 512):
        pos = torch.randint(0, S - T, (B,), generator=gen, device=dev, dtype=torch.int32)
        (rk, srk), (rv, srv) = (quantize4(randn(L, B, T, K)) for _ in range(2))
        append_case("append_all_rows_inplace_quant", AP.append_all_rows_inplace_quant,
                    AP.append_all_rows_inplace_plain, (kp4, vp4, kps4, vps4),
                    (rk, rv, srk, srv), pos, T, label="packed int4 ")
    del pcaches, kp4, kps4, vp4, vps4
    # K3q into the bf16-scale caches, int8 and packed int4 rows
    for caches, qz, label in ((bcaches, quantize, "int8 "), (bpcaches, quantize4, "packed int4 ")):
        for T in (4, 1, 512):
            pos = torch.randint(0, S - T, (B,), generator=gen, device=dev, dtype=torch.int32)
            (rk, srk), (rv, srv) = (qz(randn(L, B, T, K), scale_dtype=bf) for _ in range(2))
            append_case(f"append_all_rows_inplace_quant {BF16S}",
                        AP.append_all_rows_inplace_quant, AP.append_all_rows_inplace_plain,
                        (caches[0], caches[2], caches[1], caches[3]), (rk, rv, srk, srv), pos,
                        T, label=label)
    del bcaches, bpcaches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    head_dim128_kernel_cases(torch, gen, record)
    t1 = time.perf_counter()
    head_dim128_self_spec_cases(torch, gen, record)
    print(f"[time] kernel phase: the head-dim-128 cases took {t1 - t0:.1f}s (B10, B11 at the "
          f"longspec shapes) and {time.perf_counter() - t1:.1f}s (the self-speculation "
          "instances, K3 / K3q and B12 at 8B rows)", flush=True)
    t0 = time.perf_counter()
    quant_kernel_cases(torch, gen, record)
    t1 = time.perf_counter()
    paged_kernel_cases(torch, gen, record)
    t2 = time.perf_counter()
    per_array_append_cases(torch, gen, record)
    t3 = time.perf_counter()
    dense_kernel_cases(torch, gen, record)
    t4 = time.perf_counter()
    sampling_kernel_cases(torch, gen, record)
    print(f"[time] kernel phase: the dots took {t1 - t0:.1f}s, the paged kernels "
          f"{t2 - t1:.1f}s, B14 {t3 - t2:.1f}s, B15 {t4 - t3:.1f}s, S1 "
          f"{time.perf_counter() - t4:.1f}s", flush=True)
    return entries


S1_GAP = 1e-4  # S1 against its plain version: rows whose top-two gap is below may flip


def sampling_kernel_cases(torch, gen, record):
    """S1 (``kernels/sampling.py gumbel_argmax``, the coupled-Gumbel sampled
    head) against its plain version on the same card tensors: R = 128 (the
    verify rows of B = 32), 32, 16 and 8 rows (the verify and draft steps of
    B = 8) of llama-3's 128,256 logits with the divisor 0.6, and 128
    top-p-filtered rows (-inf outside the nucleus, divisor 1).  The tokens
    must agree on every row whose plain top-two gap
    (logits / div + g) is at least S1_GAP, the rows under it printed; a
    wrong reference (every salt + 1) must disagree on most rows; 4096
    stream positions of one 4-token row must sample its softmax to 0.03
    (tests/test_sampling_spec.py:70).  max_abs_err counts the rows whose
    tokens differ (near ties only).  The bound: the integer ALU
    (S1_INT_OPS an element) against the float32 pipe and the logits'
    bytes; no single library call samples so (library: none)."""
    from magicdec_tpu_torch.kernels import sampling as S1
    from magicdec_tpu_torch.ops import prng
    from magicdec_tpu_torch.ops.sampling import get_sampling_logits

    dev = torch.device("cuda")
    V = 128256
    key = prng.PRNGKey(1234, device=dev)
    # 128 / 32: the verify rows of B = 32 / 8; 16 and 8: the first and later
    # draft steps of B = 8 (paths (23), (24))
    for R, top_p in ((128, None), (32, None), (16, None), (8, None), (128, 0.9)):
        x, div = torch.randn(R, V, generator=gen, device=dev), 0.6
        if top_p is not None:
            x, div = get_sampling_logits(x, top_p, 0.6), 1.0
        salt = torch.randint(0, 1 << 20, (R,), generator=gen, device=dev, dtype=torch.int32)
        idx = torch.randint(0, 1 << 16, (R,), generator=gen, device=dev, dtype=torch.int32)
        case = f"R={R} V={V} " + (f"top-p {top_p} filtered, div=1" if top_p else f"div={div}")

        def call(x=x, salt=salt, idx=idx, div=div):
            return S1.gumbel_argmax(x, key, salt, idx, div)

        got = call()
        want = S1.gumbel_argmax_plain(x, key, salt, idx, div)
        g = prng.gumbel(prng.fold_in(prng.fold_in(key, salt), idx), (V,))
        top = torch.topk(x / torch.tensor(div, device=dev) + g, 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).cpu()
        differ = (got != want).cpu()
        near = [(r, f"{gap[r].item():.3g}") for r in range(R) if gap[r] < S1_GAP]
        print(f"[kernel] gumbel_argmax {case}: rows under the {S1_GAP} gap {near}, rows "
              f"differing {differ.nonzero().flatten().tolist()}", flush=True)
        if (differ & (gap >= S1_GAP)).any():
            raise AssertionError(f"S1 disagrees with its plain version ({case}) on rows "
                                 f"{(differ & (gap >= S1_GAP)).nonzero().flatten().tolist()}")
        if top_p is not None and not torch.isfinite(x.gather(1, got.long()[:, None])).all():
            raise AssertionError(f"S1 sampled a token outside the nucleus ({case})")
        wrong = (S1.gumbel_argmax_plain(x, key, salt + 1, idx, div) == got).float().mean()
        if wrong > 0.5:
            raise AssertionError(f"S1 agrees with a wrong reference (salt + 1) on "
                                 f"{wrong.item():.1%} of the rows ({case})")
        del g, top
        ms = _cuda_ms(call)
        plain_ms = _cuda_ms(lambda: S1.gumbel_argmax_plain(x, key, salt, idx, div), iters=3,
                            warmup=1)
        record("gumbel_argmax", case, float(differ.sum()), "tokens: rows differing, near ties",
               ms, plain_ms, R * V * 4 + R * 12 + 16, 0.0, None, [call],
               extra={"wrong_reference_agrees": wrong.item()},
               int_ops=R * V * S1_INT_OPS, fp32_ops=R * V * S1_FP32_OPS)
        del x, got, want
    n = 4096
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]], device=dev).expand(n, 4).contiguous()
    toks = S1.gumbel_argmax(logits, key, torch.zeros(n, dtype=torch.int32, device=dev),
                            torch.arange(n, dtype=torch.int32, device=dev), 1.0)
    freq = torch.bincount(toks.long(), minlength=4).float() / n
    dev_max = (freq - torch.softmax(logits[0], -1)).abs().max().item()
    print(f"[kernel] gumbel_argmax: {n} stream positions of one 4-token row, frequencies "
          f"{[round(f, 4) for f in freq.tolist()]} against the softmax, max deviation "
          f"{dev_max:.4f} (bound 0.03)", flush=True)
    if dev_max > 0.03:
        raise AssertionError(f"S1's samples do not follow the softmax: {dev_max:.4f}")
    torch.cuda.empty_cache()


HD128 = "[hd128]"  # the cases and kernels-line entries of the head-dim-128 instances


def head_dim128_kernel_cases(torch, gen, record):
    """B10 and B11 at head dim 128, at the longspec path's 8B target
    (llama-3.1-8b: 32 query heads, 8 kv heads of 128 dims; B = 8; an int4
    cache of 8320 rows packed in head pairs, f32 scales, quantized from
    bf16 randn; 4 layers timed in turn, each 34 MB of packed k rows and as
    much of v, past the L2): B10 at the verify (T = 4) and the AR step
    (T = 1) at ragged lengths 8100..8300, each token of a window bit-equal
    to its step; B11 at the encode's last and first 512-token chunks (bases
    7680 and 0).
    The checks are ``_case_kit``'s attention case with the nibble planes
    swapped as a second wrong reference."""
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens_int4

    dev = torch.device("cuda")
    L, B, Hq, Hkv, hd, S, layer = 4, 8, 32, 8, 128, 8320, 1
    kit = _case_kit(torch, record, gen, L, B, Hq, Hkv, hd, layer)
    caches = ()
    for _ in range(2):  # k, then v
        caches += kit.quantize(kit.randn(L, B, S, Hkv * hd), quantize_kv_tokens_int4)
        torch.cuda.empty_cache()

    def fresh(T):
        return kit.quant_fresh(T, quantize_kv_tokens_int4)

    base_t = torch.randint(8100, 8300, (B,), generator=gen, device=dev, dtype=torch.int32)
    name = f"flash_decode_attend_quant4 {HD128}"
    for T in (4, 1):
        kit.attn_case(name, DA.flash_decode_attend_quant4, DA.flash_decode_attend_quant4_plain,
                      f"target T={T} S={S}", caches, fresh, T, base_t, 2, swap=True)
    _window_equals_steps(torch, name, DA.flash_decode_attend_quant4, caches, layer,
                         kit.randn(B, 4, Hq, hd), base_t, fresh(4))
    for at in (7680, 0):
        kit.attn_case(f"flash_prefill_attend_quant4 {HD128}", PA.flash_prefill_attend_quant4,
                      PA.flash_prefill_attend_quant4_plain, f"C=512 base={at}", caches, fresh,
                      512, torch.full((B,), at, device=dev, dtype=torch.int32), 1, swap=True)
    del caches
    torch.cuda.empty_cache()


def head_dim128_self_spec_cases(torch, gen, record):
    """K1, K1q, K2 and K2q at head dim 128, at the 8B self-speculation
    paths' shapes (llama-3.1-8b: 32 query heads, 8 kv heads of 128 dims;
    B = 32; the target cache 8704 rows, the draft's 640; 4 layers timed in
    turn, each 57 MB of bf16 k rows, past the L2): K1 at the verify (T = 4)
    and the AR step (T = 1), each window token bit-equal to its step, and
    the draft's whole-row call (T = 1 over 640 rows); K1q likewise at T = 4
    and 1; K2 and K2q at the encode's last and first 512-token chunks (bases
    7680 and 0); K3q and K3 on the 8B cache rows (1024 int8 or bf16 values
    a row) at T = 4, 1 and 512, bit-exact; the bf16-scale instances of K1q
    and B10 (T = 4) and of K2q and B11 (C = 512, base 7680), each bit-equal
    to its f32 instance on the widened scales; then B12's bf16, int8 and
    int4 pools and its bf16-scale int8 and int4 ones at the 8B serve's shape
    (8 ragged slots of 8192 rows, 512-row pages), each bit-equal to its
    contiguous kernel over the gathered pool.  Each within bf16_limit of
    its plain version, failing it without the fresh rows (the int4 ones also
    with the nibble planes swapped); each launch on the head-dim-128
    instance; the decode kernels one ``decode_sm90_kernel`` (and
    ``combine_kernel`` with splits) a call, the prefill ones one
    ``prefill_sm90_kernel``, under torch.profiler (the bf16-scale ones
    untraced).  library_ms: SDPA on the (dequantized) bf16 layer;
    ``index_copy_`` for the appends."""
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens, quantize_kv_tokens_int4

    dev = torch.device("cuda")
    L, B, Hq, Hkv, hd, layer = 4, 32, 32, 8, 128, 1
    S, Sd, K = 8704, 640, 8 * 128
    bf = torch.bfloat16
    kit = _case_kit(torch, record, gen, L, B, Hq, Hkv, hd, layer)
    randn, quantize, dense_fresh, quant_fresh = (kit.randn, kit.quantize, kit.dense_fresh,
                                                 kit.quant_fresh)
    attn_case = kit.attn_case

    base_t = torch.randint(8192, 8600, (B,), generator=gen, device=dev, dtype=torch.int32)
    base_d = torch.randint(513, 600, (B,), generator=gen, device=dev, dtype=torch.int32)
    chunks = [(512, torch.full((B,), at, device=dev, dtype=torch.int32)) for at in (7680, 0)]
    k4, v4 = randn(L, B, S, K), randn(L, B, S, K)
    name = f"flash_decode_attend {HD128}"
    for T in (4, 1):
        attn_case(name, DA.flash_decode_attend, DA.flash_decode_attend_plain,
                  f"target T={T} S={S}", (k4, v4), dense_fresh, T, base_t, 2)
    _window_equals_steps(torch, name, DA.flash_decode_attend, (k4, v4), layer,
                         randn(B, 4, Hq, hd), base_t, dense_fresh(4))
    dk, dv = randn(L, B, Sd, K), randn(L, B, Sd, K)
    attn_case(name, DA.flash_decode_attend, DA.flash_decode_attend_plain,
              f"draft T=1 S={Sd}", (dk, dv), dense_fresh, 1, base_d, 3)
    del dk, dv
    for C, at in chunks:
        attn_case(f"flash_prefill_attend {HD128}", PA.flash_prefill_attend,
                  PA.flash_prefill_attend_plain, f"C={C} base={int(at[0])}", (k4, v4),
                  dense_fresh, C, at, 1)
    kq, ks = quantize(k4)
    vq, vs = quantize(v4)
    qcaches = (kq, ks, vq, vs)
    name = f"flash_decode_attend_quant {HD128}"
    for T in (4, 1):
        attn_case(name, DA.flash_decode_attend_quant, DA.flash_decode_attend_quant_plain,
                  f"target T={T} S={S}", qcaches, quant_fresh, T, base_t, 2)
    _window_equals_steps(torch, name, DA.flash_decode_attend_quant, qcaches, layer,
                         randn(B, 4, Hq, hd), base_t, quant_fresh(4))
    for C, at in chunks:
        attn_case(f"flash_prefill_attend_quant {HD128}", PA.flash_prefill_attend_quant,
                  PA.flash_prefill_attend_quant_plain, f"C={C} base={int(at[0])}", qcaches,
                  quant_fresh, C, at, 1)
    # --kv_scale bf16 at head dim 128: int8 and packed int4, each launch
    # bit for bit its f32 instance on the widened scales
    for fmt, qz in (("", quantize_kv_tokens), ("4", quantize_kv_tokens_int4)):
        caches = (*quantize(k4, qz, bf), *quantize(v4, qz, bf))
        fresh = lambda T, qz=qz: quant_fresh(T, qz, bf)  # noqa: E731
        dec = getattr(DA, f"flash_decode_attend_quant{fmt}")
        pre = getattr(PA, f"flash_prefill_attend_quant{fmt}")
        attn_case(f"{dec.__name__} {BF16S} {HD128}", dec, getattr(DA, dec.__name__ + "_plain"),
                  f"target T=4 S={S}", caches, fresh, 4, base_t, 2, swap=bool(fmt),
                  profile=False)
        C, at = chunks[0]
        attn_case(f"{pre.__name__} {BF16S} {HD128}", pre, getattr(PA, pre.__name__ + "_plain"),
                  f"C={C} base={int(at[0])}", caches, fresh, C, at, 1, swap=bool(fmt),
                  profile=False)
        del caches
    # K3 and K3q on the 8B caches' rows (the appends take any row width;
    # path (20) writes these), bit-exact against the plain versions
    for T in (4, 1, 512):
        pos = torch.randint(0, S - T, (B,), generator=gen, device=dev, dtype=torch.int32)
        kit.append_case("append_all_rows_inplace", AP.append_all_rows_inplace,
                        AP.append_all_rows_inplace_plain, (k4, v4),
                        (randn(L, B, T, K), randn(L, B, T, K)), pos, T,
                        label="llama-3.1-8b rows ")
        (rk, srk), (rv, srv) = (quantize(randn(L, B, T, K)) for _ in range(2))
        kit.append_case("append_all_rows_inplace_quant", AP.append_all_rows_inplace_quant,
                        AP.append_all_rows_inplace_plain, (kq, vq, ks, vs),
                        (rk, rv, srk, srv), pos, T, label="llama-3.1-8b int8 rows ")
    del k4, v4, qcaches, kq, ks, vq, vs
    torch.cuda.empty_cache()
    paged_kernel_cases(torch, gen, record, L=L, B=8, hd=hd, page_sizes=(512,),
                       only=("flash_paged_decode_attend", "flash_paged_decode_attend_quant",
                             "flash_paged_decode_attend_quant4",
                             f"flash_paged_decode_attend_quant {BF16S}",
                             f"flash_paged_decode_attend_quant4 {BF16S}"),
                       suffix=f" {HD128}")
    torch.cuda.empty_cache()


def per_array_append_cases(torch, gen, record):
    """B14 (append_rows_inplace, append_scale_rows_inplace) bit for bit
    against their plain versions on the int8 target cache (8704 rows) and
    the draft's bf16 cache (640 rows) of the bench's main path (16 layers,
    B=32, 8 kv heads of 64), and on f32 scales [16, 32, 8, S] of both
    lengths, at T = 4, 1 and 512, ragged positions with one request whose
    window runs past the end (T > 1; wholly past it at T = 1): the kernel
    must drop the rows at or past S, as the plain version does.
    library_ms: index_copy_ of the kept rows (scale columns) through flat
    indices."""
    from magicdec_tpu_torch.kernels import append as AP

    dev = torch.device("cuda")
    L, B, Hkv, K = 16, 32, 8, 512

    def case(name, fn, plain, dst, src, pos, T, label):
        scales = name.startswith("append_scale_rows_inplace")
        S = dst.shape[-1] if scales else dst.shape[2]
        mine = dst.clone()
        fn(mine, src, pos)
        if dst.dtype == torch.bfloat16 and scales:
            wide = dst.float()
            fn(wide, src.float(), pos)
            _same_scale_bits(name, f"{label} T={T}", [mine], [wide], data=0)
            del wide
        plain(dst, src, pos)
        torch.cuda.synchronize()
        if not torch.equal(mine, dst):
            raise AssertionError(f"{name} {label} T={T}: kernel and plain version differ")
        del mine
        ms = _cuda_ms(lambda: fn(dst, src, pos))
        plain_ms = _cuda_ms(lambda: plain(dst, src, pos), iters=5, warmup=1)
        p = pos.long()[:, None] + torch.arange(T, device=dev)
        b, t = (p < S).nonzero(as_tuple=True)
        lb = torch.arange(L, device=dev)[:, None] * B + b[None]             # [L, kept]
        if scales:
            h = torch.arange(Hkv, device=dev)[None, None]
            flat = ((lb[..., None] * Hkv + h) * S + p[b, t][None, :, None]).reshape(-1)
            vals = src[:, b, :, t].permute(1, 0, 2).reshape(-1)
            pair = (dst.view(-1), flat, vals)
        else:
            flat = (lb * S + p[b, t][None]).reshape(-1)
            vals = src[:, b, t].reshape(-1, K)
            pair = (dst.view(-1, K), flat, vals)
        library_ms = _cuda_ms(lambda: pair[0].index_copy_(0, pair[1], pair[2]))
        nbytes = 2.0 * vals.numel() * vals.element_size()  # the kept rows, read and written
        record(name, f"{label} T={T} (request {B - 1} at {int(pos[-1])}: rows past {S} "
               "dropped)", 0.0, "bit-exact", ms, plain_ms, nbytes, 0.0, library_ms,
               [lambda: fn(dst, src, pos)] * 10,
               [lambda: pair[0].index_copy_(0, pair[1], pair[2])] * 10)

    caches = {
        "target int8 S=8704": torch.randint(-128, 128, (L, B, 8704, K), generator=gen,
                                            device=dev, dtype=torch.int8),
        "draft bf16 S=640": torch.randn((L, B, 640, K), generator=gen,
                                        device=dev).to(torch.bfloat16),
    }
    for label, cache in caches.items():
        S = cache.shape[2]
        scale = torch.rand((L, B, Hkv, S), generator=gen, device=dev)
        bscale = scale.to(torch.bfloat16)
        for T in (4, 1, 512):
            pos = torch.randint(0, S - T + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
            pos[-1] = S - T // 2 if T > 1 else S
            if cache.dtype == torch.int8:
                rows = torch.randint(-128, 128, (L, B, T, K), generator=gen, device=dev,
                                     dtype=torch.int8)
            else:
                rows = torch.randn((L, B, T, K), generator=gen, device=dev).to(cache.dtype)
            case("append_rows_inplace", AP.append_rows_inplace, AP.append_rows_inplace_plain,
                 cache, rows, pos, T, label)
            case("append_scale_rows_inplace", AP.append_scale_rows_inplace,
                 AP.append_scale_rows_inplace_plain, scale,
                 torch.rand((L, B, Hkv, T), generator=gen, device=dev), pos, T,
                 f"f32 scales S={S}")
            if cache.dtype == torch.int8:  # --kv_scale bf16: the target's bf16 scales
                case(f"append_scale_rows_inplace {BF16S}", AP.append_scale_rows_inplace,
                     AP.append_scale_rows_inplace_plain, bscale,
                     torch.rand((L, B, Hkv, T), generator=gen, device=dev).to(torch.bfloat16),
                     pos, T, f"bf16 scales S={S}")
        del scale
    del caches
    torch.cuda.empty_cache()


def dense_kernel_cases(torch, gen, record):
    """B15 against its plain versions at the target's bf16 widths
    (llama-3.2-1b: wqkv [2048, 3072], wo [2048, 2048], w13 [2048, 16384],
    w2 [8192, 2048]) and the target pass's row counts, M = decode_rows = 128
    (B=32, gamma 3), 16 and 8 (B=4 and 2): dense_matmul_fused as wqkv +
    norm, wo + residual, w13 + norm and w2 + residual, and dense_mlp (the
    FFN block with its residual, on ffn_sm90.cu's bf16 instance) at M = 128
    and 16 and at the llama-3.1-8b widths (D 4096, F 14336, M = 128, four
    layers), each timed over the layers' weights in turn and under
    torch.profiler one kernel launch a call, within bf16_limit of the plain
    version; wrong references that must fail it: without the norm, without
    the residual, with the w13 halves swapped.  Bound: the weight's bytes
    (with the rows in and out); library_ms: torch.matmul on the same weight,
    for dense_mlp the main path's own FFN with the dense kernels off
    (kernel_benchmark.cublas_ffn: rms_norm, the w13 dot, SiLU * up, the w2
    dot, the residual)."""
    from magicdec_tpu_torch.kernel_benchmark import cublas_ffn
    from magicdec_tpu_torch.kernels import dense_matmul as DK

    dev = torch.device("cuda")
    L, D, F = 16, 2048, 8192
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    weights = {"wqkv": randn(L, D, D + 1024, scale=D ** -0.5),
               "wo": randn(L, D, D, scale=0.25 * D ** -0.5),
               "w13": randn(L, D, 2 * F, scale=D ** -0.5),
               "w2": randn(L, F, D, scale=0.25 * F ** -0.5)}
    norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)

    def case(name, label, fn, plain, wrongs, args_of, keys, lib=None, M=128, library=None,
             ws=weights, nl=L):
        """``lib``: the lhs of torch.matmul on the case's weight; ``library``:
        a callable on the case's arguments (dense_mlp's composition)."""
        args = args_of(0)
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        err, tol = _err(out, ref)
        for what, wrong in wrongs.items():
            w_err, w_bad, w_share = _outside(wrong(*args), ref)
            print(f"[kernel] {name} {label}: {what} max_abs_err={w_err:.3e}, {w_bad} of "
                  f"{ref.numel()} elements outside bf16_limit (up to {w_share:.3g} of it)",
                  flush=True)
            if not w_bad:
                raise AssertionError(f"{name} {label}: bf16_limit passes {what}")
        layers = itertools.cycle(range(nl))
        ms = _cuda_ms(lambda: fn(*args_of(next(layers))))
        plain_ms = _cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        library_ms, lib_calls = None, None
        if lib is not None:
            lw = itertools.cycle([ws[keys[0]][l] for l in range(nl)])
            library_ms = _cuda_ms(lambda: torch.matmul(lib, next(lw)))
            lib_calls = [lambda w=ws[keys[0]][l]: torch.matmul(lib, w) for l in range(nl)]
        if library is not None:
            layers = itertools.cycle(range(nl))
            library_ms = _cuda_ms(lambda: library(*args_of(next(layers))))
            lib_calls = [lambda l=l: library(*args_of(l)) for l in range(nl)]
        # every operand read once (one layer's weights, rows, norm) and the
        # output written once
        moved = float(sum(a.numel() * a.element_size() for a in args)
                      + out.numel() * out.element_size())
        flops = 2.0 * M * sum(ws[k][0].numel() for k in keys)
        calls = [lambda l=l: fn(*args_of(l)) for l in range(nl)]
        extra = (_one_launch(torch, name, label, calls, ONE_LAUNCH[name]) if name in ONE_LAUNCH
                 else None)
        record(name, label, err, tol, ms, plain_ms, moved, flops, library_ms, calls, lib_calls,
               extra)

    def w(key, l):
        return weights[key][l]

    fused = lambda *a: DK.dense_matmul_fused(*a[:2], *a[2:], eps=1e-5)  # noqa: E731
    plain = lambda *a: DK.dense_matmul_fused_plain(*a[:2], *a[2:], eps=1e-5)  # noqa: E731
    for M in (128, 16, 8):
        x, a, res = randn(M, D, scale=3.0), randn(M, D), randn(M, D)
        g = randn(M, F, scale=0.5)
        case("dense_matmul_fused", f"wqkv + norm M={M}", fused, plain,
             {"without the norm": lambda x, wq, n: DK.dense_matmul_fused_plain(x, wq)},
             lambda l: (x, w("wqkv", l), norm_w), ["wqkv"], lib=x, M=M)
        case("dense_matmul_fused", f"wo + residual M={M}",
             lambda a, wo, r: DK.dense_matmul_fused(a, wo, res=r),
             lambda a, wo, r: DK.dense_matmul_fused_plain(a, wo, res=r),
             {"without the residual": lambda a, wo, r: DK.dense_matmul_fused_plain(a, wo)},
             lambda l: (a, w("wo", l), res), ["wo"], lib=a, M=M)
        case("dense_matmul_fused", f"w13 + norm M={M}", fused, plain,
             {"without the norm": lambda x, w13, n: DK.dense_matmul_fused_plain(x, w13)},
             lambda l: (x, w("w13", l), norm_w), ["w13"], lib=x, M=M)
        case("dense_matmul_fused", f"w2 + residual M={M}",
             lambda g, w2, r: DK.dense_matmul_fused(g, w2, res=r),
             lambda g, w2, r: DK.dense_matmul_fused_plain(g, w2, res=r),
             {"without the residual": lambda g, w2, r: DK.dense_matmul_fused_plain(g, w2)},
             lambda l: (g, w("w2", l), res), ["w2"], lib=g, M=M)

    def halves_swapped(w13):
        Fw = w13.shape[1] // 2
        return torch.cat([w13[:, Fw:], w13[:, :Fw]], dim=1).contiguous()

    mlp_wrongs = {
        "with the w13 halves swapped": lambda x, w13, w2, n, r: DK.dense_mlp_plain(
            x, halves_swapped(w13), w2, n, r, eps=1e-5),
        "without the residual": lambda x, w13, w2, n, r: DK.dense_mlp_plain(
            x, w13, w2, n, eps=1e-5)}

    def mlp(x, w13, w2, n, r):
        return DK.dense_mlp(x, w13, w2, n, r, eps=1e-5)

    def mlp_plain(x, w13, w2, n, r):
        return DK.dense_mlp_plain(x, w13, w2, n, r, eps=1e-5)

    for M in (128, 16):
        x, res = randn(M, D), randn(M, D)
        case("dense_mlp", f"FFN + residual M={M}", mlp, mlp_plain, mlp_wrongs,
             lambda l: (x, w("w13", l), w("w2", l), norm_w, res), ["w13", "w2"], M=M,
             library=cublas_ffn)
    del weights
    torch.cuda.empty_cache()
    # the llama-3.1-8b widths the dense routing takes (up to 146 rows)
    D8, F8, L8 = 4096, 14336, 4
    w8 = {"w13": randn(L8, D8, 2 * F8, scale=D8 ** -0.5),
          "w2": randn(L8, F8, D8, scale=0.25 * F8 ** -0.5)}
    n8 = (torch.rand((D8,), generator=gen, device=dev) + 0.5).to(bf)
    x, res = randn(128, D8), randn(128, D8)
    case("dense_mlp", "FFN + residual 8B widths M=128", mlp, mlp_plain, mlp_wrongs,
         lambda l: (x, w8["w13"][l], w8["w2"][l], n8, res), ["w13", "w2"], M=128,
         library=cublas_ffn, ws=w8, nl=L8)
    del w8
    torch.cuda.empty_cache()


def paged_kernel_cases(torch, gen, record, L=16, B=16, hd=64, page_sizes=(512, 16),
                       only=None, suffix=""):
    """B12 (bf16, int8 and packed int4 pools) and B13 (the same three) at
    the serving paths' shapes: llama-3.2-1b widths (16 layers, 8 kv heads of
    64, 32 query heads), 16 slots, T = 4, npr * ps = 8192 logical rows a
    slot, page size 512 and 16 (a 16-position tile is one whole page), the slots'
    pages a random permutation of the pool's user pages (pages 0..15 are the
    scratch pages), ragged base_lens including 0 and 8192 - T.  Each B12 is
    held against its plain version within bf16_limit and bit for bit against
    its contiguous kernel over the gathered pool (with and without the fresh
    rows); two wrong references must fail the bound: the kernel with two
    table entries of a request swapped, and without the fresh rows.  Each
    B13 is bit-exact against its plain version.  library_ms: SDPA on the
    gathered (and dequantized) layer, the gather untimed; for B13,
    index_copy_ through the flattened page indices.  The head-dim-128
    instances run the same cases at llama-3.1-8b's widths (``L`` layers of
    8 kv heads of ``hd`` dims, ``B`` slots, ``page_sizes``), the formats
    ``only`` names, recorded with ``suffix`` and without B13."""
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import paged_attention as PGA
    from magicdec_tpu_torch.ops import paged_kv as PKV
    from magicdec_tpu_torch.ops.kv_cache import (dequant_kv, quantize_kv_tokens,
                                                 quantize_kv_tokens_int4)

    F = torch.nn.functional
    dev = torch.device("cuda")
    Hq, Hkv, T, S = 32, 8, 4, 8192
    K = Hkv * hd
    lay = min(5, L - 1)  # the layer each check reads
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    base = torch.randint(0, S - T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    base[0], base[-1] = 0, S - T
    wide = int(base.argmax())  # the request whose table gets two entries swapped
    def bf16s(qz):
        return lambda x: qz(x, scale_dtype=bf)

    formats = {
        "flash_paged_decode_attend": (None, DA.flash_decode_attend,
                                      PGA.flash_paged_decode_attend_plain),
        "flash_paged_decode_attend_quant": (quantize_kv_tokens, DA.flash_decode_attend_quant,
                                            PGA.flash_paged_decode_attend_quant_plain),
        "flash_paged_decode_attend_quant4": (quantize_kv_tokens_int4,
                                             DA.flash_decode_attend_quant4,
                                             PGA.flash_paged_decode_attend_quant4_plain),
        # --kv_scale bf16: the bf16-scale instances, bit for bit against the
        # f32 ones on the widened scales
        f"flash_paged_decode_attend_quant {BF16S}": (
            bf16s(quantize_kv_tokens), DA.flash_decode_attend_quant,
            PGA.flash_paged_decode_attend_quant_plain),
        f"flash_paged_decode_attend_quant4 {BF16S}": (
            bf16s(quantize_kv_tokens_int4), DA.flash_decode_attend_quant4,
            PGA.flash_paged_decode_attend_quant4_plain),
    }
    formats = {n: f for n, f in formats.items() if only is None or n in only}
    for ps in page_sizes:
        npr = S // ps
        P = B * npr + B
        table = (torch.randperm(B * npr, generator=gen, device=dev) + B).to(torch.int32)
        table = table.reshape(B, npr).contiguous()
        swapped = table.clone()
        swapped[wide, 0], swapped[wide, npr - 1] = table[wide, npr - 1], table[wide, 0]
        dense = (randn(L, P, ps, K), randn(L, P, ps, K))
        for name, (qz, contig, plain) in formats.items():
            case = f"T={T} ps={ps}"
            if qz is None:
                pools = dense
                fresh = {"k_new": randn(B, T, K), "v_new": randn(B, T, K)}
            else:
                pools = []
                for x in dense:  # each layer's [P, ps] rows quantize as [B, T] tokens
                    qs = [qz(x[l].view(P, ps, Hkv, hd)) for l in range(L)]
                    pools += [torch.stack([a for a, _ in qs]), torch.stack([b for _, b in qs])]
                (kn, ksn), (vn, vsn) = (qz(randn(B, T, Hkv, hd)) for _ in range(2))
                fresh = {"k_new": kn, "v_new": vn, "ks_new": ksn, "vs_new": vsn}
            fn = getattr(PGA, name.split()[0])
            name += suffix
            q = randn(B, T, Hq, hd)
            out = fn(q, *pools, table, base, layer=lay, **fresh)
            ref = plain(q, *pools, table, base, layer=lay, **fresh)
            torch.cuda.synchronize()
            err, tol = _err(out, ref)
            if qz is not None and pools[1].dtype == bf:
                _same_bits_as_f32(torch, f"{name} {case}", out,
                                  lambda c, f: fn(q, *c, table, base, layer=lay, **f), pools,
                                  fresh)
            gathered = [PKV.scale_pool_gather(p, table) if qz and i % 2
                        else PKV.pool_gather(p, table) for i, p in enumerate(pools)]
            for kw in (fresh, {}):
                if not torch.equal(fn(q, *pools, table, base, layer=lay, **kw),
                                   contig(q, *gathered, base, layer=lay, **kw)):
                    raise AssertionError(f"{name} {case}: the paged kernel and the contiguous "
                                         "kernel over the gathered pool differ in bits")
            print(f"[kernel] {name} {case}: bit-equal to {contig.__name__} over the gathered "
                  "pool, with and without the fresh rows", flush=True)
            wrongs = {"with two table entries swapped": fn(q, *pools, swapped, base, layer=lay,
                                                           **fresh),
                      "without the fresh rows": fn(q, *pools, table, base, layer=lay)}
            for what, wrong in wrongs.items():
                w_err, w_bad, w_share = _outside(wrong, ref)
                print(f"[kernel] {name} {case}: {what} max_abs_err={w_err:.3e}, {w_bad} of "
                      f"{ref.numel()} elements outside bf16_limit (up to {w_share:.3g} of it)",
                      flush=True)
                if not w_bad:
                    raise AssertionError(f"{name} {case}: bf16_limit passes {what}")
            del wrongs
            layers = itertools.cycle(range(L))
            ms = _cuda_ms(lambda: fn(q, *pools, table, base, layer=next(layers), **fresh))
            plain_ms = _cuda_ms(lambda: plain(q, *pools, table, base, layer=lay, **fresh),
                                iters=3, warmup=1)
            if qz is None:
                kl, vl, knl, vnl = gathered[0][lay], gathered[1][lay], fresh["k_new"], fresh["v_new"]
            else:
                kl, vl = (dequant_kv(gathered[i][lay], gathered[i + 1][lay], hd, bf) for i in (0, 2))
                knl = dequant_kv(fresh["k_new"], fresh["ks_new"], hd, bf)
                vnl = dequant_kv(fresh["v_new"], fresh["vs_new"], hd, bf)
            del gathered
            lib_args = _sdpa_inputs(q, kl, vl, base, knl, vnl)
            del kl, vl

            def lib():
                return F.scaled_dot_product_attention(lib_args[0], lib_args[1], lib_args[2],
                                                      attn_mask=lib_args[3])
            library_ms = _cuda_ms(lib)
            vis = base.double()
            pairs = float((vis[:, None] + torch.arange(1, T + 1, device=dev)).sum())
            row_bytes = (pools[0].shape[-1] * pools[0].element_size()
                         + (Hkv * pools[1].element_size() if qz else 0))
            nbytes = (2 * q.numel() * 2 + 2 * float(vis.sum()) * row_bytes + table.numel() * 4
                      + sum(t.numel() * t.element_size() for t in fresh.values()))
            calls = [lambda l=l: fn(q, *pools, table, base, layer=l, **fresh) for l in range(L)]
            # every pool: decode_attention_sm90.cu's kernel, the contiguous plan
            plan = DA.split_plan if qz is None else DA.quant_split_plan
            extra = _decode_sm90_launches(torch, name, case, calls, plan(B, Hkv, S, hd)[0])
            record(name, case, err, tol, ms, plain_ms, nbytes, 4 * hd * Hq * pairs, library_ms,
                   calls, [lib], extra)
            del lib_args
            fmt = ("bf16" if qz is None else "packed int4" if "quant4" in name else "int8")
            fmt += " (bf16 scales)" if qz is not None and pools[1].dtype == bf else ""
            if not suffix:
                paged_append_case(torch, record, pools, table, base, T, f"{fmt} pool ps={ps} ",
                                  gen)
            del pools, fresh
            torch.cuda.empty_cache()
        del dense
        torch.cuda.empty_cache()


def paged_append_case(torch, record, pools, table, pos, T, label, gen):
    """B13 into copies of ``pools`` (bf16 (k, v) or quantized (k, k_scale,
    v, v_scale)) at ``pos``: bit-exact against the plain version, then
    timed; library_ms is index_copy_ through the flattened page indices."""
    from magicdec_tpu_torch.kernels import paged_attention as PGA

    dev = torch.device("cuda")
    L, P, ps, Kc = pools[0].shape
    B, npr = table.shape
    data = [pools[0], pools[2]] if len(pools) == 4 else list(pools)
    scales = [pools[1], pools[3]] if len(pools) == 4 else []
    if data[0].dtype == torch.int8:
        rows = [torch.randint(-128, 128, (L, B, T, Kc), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2)]
        H = scales[0].shape[2]
        srows = [torch.rand((L, B, H, T), generator=gen, device=dev).to(scales[0].dtype)
                 for _ in range(2)]
    else:
        rows = [torch.randn((L, B, T, Kc), generator=gen, device=dev).to(data[0].dtype)
                for _ in range(2)]
        srows = []
    ops = (*rows, pos, table)
    mine = [t.clone() for t in data + scales]
    out = PGA.append_paged_rows_inplace(*mine[:2], *ops, *mine[2:], *srows)
    name = "append_paged_rows_inplace"
    if scales and scales[0].dtype == torch.bfloat16:
        name += f" {BF16S}"
        wide = [t.clone() for t in data] + [t.float() for t in scales]
        PGA.append_paged_rows_inplace(*wide[:2], *ops, *wide[2:], *(r.float() for r in srows))
        _same_scale_bits(name, f"{label}T={T}", out, wide)
        del wide
    ref = PGA.append_paged_rows_inplace_plain(*data, *ops, *scales, *srows)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError(f"append_paged_rows_inplace {label}: kernel and plain version "
                             "differ")
    del mine, out, ref
    ms = _cuda_ms(lambda: PGA.append_paged_rows_inplace(*data, *ops, *scales, *srows))
    plain_ms = _cuda_ms(lambda: PGA.append_paged_rows_inplace_plain(*data, *ops, *scales,
                                                                    *srows),
                        iters=5, warmup=1)
    p = pos.long()[:, None] + torch.arange(T, device=dev)                       # [B, T]
    page = table.long().gather(1, p // ps)                                         # [B, T]
    lp = torch.arange(L, device=dev)[:, None, None] * P + page[None]               # [L, B, T]
    flat = (lp * ps + p % ps).reshape(-1)
    pairs = [(d.view(-1, Kc), flat, r.reshape(-1, Kc)) for d, r in zip(data, rows)]
    if scales:
        h = torch.arange(H, device=dev)[None, None, :, None]
        sflat = ((lp[:, :, None] * H + h) * ps + (p % ps)[None, :, None]).reshape(-1)
        pairs += [(s.view(-1), sflat, r.reshape(-1)) for s, r in zip(scales, srows)]
    library_ms = _cuda_ms(lambda: [d.index_copy_(0, i, r) for d, i, r in pairs])
    nbytes = (2 * sum(r.numel() * r.element_size() for r in rows + srows)
              + table.numel() * 4 + pos.numel() * 4)
    record(name, f"{label}T={T}", 0.0, "bit-exact", ms, plain_ms,
           nbytes, 0.0, library_ms,
           [lambda: PGA.append_paged_rows_inplace(*data, *ops, *scales, *srows)] * 10,
           [lambda: [d.index_copy_(0, i, r) for d, i, r in pairs]] * 10)


def quant_kernel_cases(torch, gen, record):
    """B4, B5, B6 (and B9) against their plain versions at the draft's
    shapes: llama-3.2-1b widths, int8 weights quantized by the port's
    quantize_params rule from bf16 N(0, 1/fan_in) weights, M = 32 (the
    draft's steps at B=32) and 64 (the first step's two tokens); B4, B5 and
    B6 again at llama-3.1-8b widths (path (20)'s draft copy).  Each is
    timed over the layers of a stacked weight in turn (16; 4 at 8B), as the
    draft pass streams them (one layer's weights would sit in the 50 MB L2
    otherwise);
    one deliberately wrong reference per case must fail bf16_limit.
    library_ms: torch.matmul on the dequantized bf16 weight (B4, B6)."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    dev = torch.device("cuda")
    L, D, F, V = 16, 2048, 8192, 128256
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def stack(In, Out, layers=L):
        w = Q.quantize_params({"layers": {"wo": randn(layers, In, Out, scale=In ** -0.5)}},
                              include_head=False)["layers"]["wo"]
        return w.q, w.scale.reshape(layers, Out)


    def nbytes(*tensors):
        return float(sum(t.numel() * t.element_size() for t in tensors))

    def case(name, label, fn, plain, wrong, args_of, keys, lib=None, M=32, kernel=None):
        """fn / plain / wrong(args) with args_of(layer) the operands;
        ``kernel``: what the profiled kernel's name holds, if not
        ``ONE_LAUNCH[name]``."""
        args = args_of(0)
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        err, tol = _err(out, ref)
        w_err, w_bad, w_share = _outside(wrong(*args), ref)
        print(f"[kernel] {name} {label}: the wrong reference has max_abs_err={w_err:.3e}, "
              f"{w_bad} of {ref.numel()} elements outside bf16_limit (up to "
              f"{w_share:.3g} of it)", flush=True)
        if not w_bad:
            raise AssertionError(f"{name} {label}: bf16_limit passes a wrong reference")
        n_layers = weights[keys[0]][0].shape[0]
        layers = itertools.cycle(range(n_layers))
        ms = _cuda_ms(lambda: fn(*args_of(next(layers))))
        plain_ms = _cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        calls = [lambda l=l: fn(*args_of(l)) for l in range(n_layers)]
        extra = None
        if M128 in name:
            kernel = kernel or M128_KERNEL
        if name.split()[0] in ONE_LAUNCH:
            extra = _one_launch(torch, name, label, calls, kernel or ONE_LAUNCH[name.split()[0]])
        library_ms, deq = None, None
        if lib is not None:
            deq = [dequant(k, l) for k in keys for l in range(weights[k][0].shape[0])]
            xs = itertools.cycle(deq)
            library_ms = _cuda_ms(lambda: torch.matmul(lib, next(xs)))
        moved = nbytes(*(t for k in keys for t in (weights[k][0][0], weights[k][1][0])),
                       *(a for a in args if a.dtype == bf), out)
        # an int4 byte holds two weights
        flops = 2.0 * M * sum(weights[k][0][0].numel() * (2 if is4(k) else 1) for k in keys)
        record(name, label, err, tol, ms, plain_ms, moved, flops, library_ms, calls,
               deq and [lambda d=d: torch.matmul(lib, d) for d in deq], extra)
        del deq

    def is4(key):
        """An int4 weight (keys ending in 4)."""
        return key.endswith("4")

    def dequant(key, l):
        q, s = w(key, l)
        if s.dim() == 2:  # group-wise, int4 or int8: [G, Out]
            bits = 4 if is4(key) else 8
            rows = q.shape[0] * (2 if bits == 4 else 1)
            return Q.dequantize_weight(Q.QuantizedWeight(q, s, bits, rows // s.shape[0]))
        return (q.float() * s).to(bf)

    def w(key, l):
        return weights[key][0][l], weights[key][1][l]

    weights = norm_w = None

    def draft_dots(D, F, kv, layers, model=""):
        """B4 (wqkv + norm, w13 + gate, w2 + residual), B5 and B6 at the
        draft's rows, M = 32 and 64, over ``layers`` layers of int8 weights
        at widths D and F (wqkv D -> D + 2 kv), quantized as the engine's
        draft copy; ``model`` heads each case's label."""
        nonlocal weights, norm_w
        weights = {"wqkv": stack(D, D + 2 * kv, layers), "wo": stack(D, D, layers),
                   "w13": stack(D, 2 * F, layers), "w2": stack(F, D, layers),
                   "lm_head": stack(D, V, layers=1)}
        norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
        for M in (32, 64):
            x = randn(M, D, scale=3.0)
            case("quant_matmul_fused", f"{model}wqkv + attention norm M={M}",
                 lambda x, q, s, n: QK.quant_matmul_fused(x, q, s, n),
                 lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, s, n),
                 lambda x, q, s, n: QK.quant_matmul_plain(x, q, s),  # without the norm
                 lambda l: (x, *w("wqkv", l), norm_w), ["wqkv"], lib=x, M=M)
        for M in (32, 64):
            x = randn(M, D, scale=3.0)
            case("quant_matmul_fused", f"{model}w13 + norm + SiLU gate M={M}",
                 lambda x, q, s, n: QK.quant_matmul_fused(x, q, s, n, gate=True),
                 lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, s, n, gate=True),
                 lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, s, gate=True),  # no norm
                 lambda l: (x, *w("w13", l), norm_w), ["w13"], lib=x, M=M)
            g, res = randn(M, F, scale=0.5), randn(M, D)
            case("quant_matmul_fused", f"{model}w2 + residual M={M}",
                 lambda x, q, s, r: QK.quant_matmul_fused(x, q, s, res=r),
                 lambda x, q, s, r: QK.quant_matmul_fused_plain(x, q, s, res=r),
                 lambda x, q, s, r: QK.quant_matmul_plain(x, q, s),  # without the residual
                 lambda l: (g, *w("w2", l), res), ["w2"], lib=g, M=M)
        for M in (32, 64):
            a, x = randn(M, D), randn(M, D)
            case("quant_layer_tail", f"{model}draft layer tail M={M}",
                 lambda *a: QK.quant_layer_tail(*a, eps=1e-5),
                 lambda *a: QK.quant_layer_tail_plain(*a, eps=1e-5),
                 # without the first residual: h = bf16(a @ wo * so)
                 lambda a, x, qo, so, *rest: QK.quant_layer_tail_plain(
                     a, torch.zeros_like(x), qo, so, *rest, eps=1e-5),
                 lambda l, a=a, x=x: (a, x, *w("wo", l), *w("w13", l), *w("w2", l), norm_w),
                 ["wo", "w13", "w2"], M=M)
        for M in (32, 64):
            x = randn(M, D, scale=0.5)
            case("quant_matmul", f"{model}lm_head [{D}, {V}] M={M}",
                 QK.quant_matmul, QK.quant_matmul_plain,
                 lambda x, q, s: QK.quant_matmul_plain(x, q, s.roll(1, -1)),  # scales off by one
                 lambda l: (x, *w("lm_head", l)), ["lm_head"], lib=x, M=M)

    draft_dots(D, F, 512, L)
    # B9: the draft's FFN where B5 declines (129..256 rows: the prefill chunk
    # of two requests); not on the B=32 path
    def mlp_case(label, M):
        x = randn(M, D)
        case("quant_mlp", label,
             lambda x, q13, s13, q2, s2, n: QK.quant_mlp(x, q13, s13, q2, s2, n, x, eps=1e-5),
             lambda x, q13, s13, q2, s2, n: QK.quant_mlp_plain(x, q13, s13, q2, s2, n, x,
                                                               eps=1e-5),
             lambda x, q13, s13, q2, s2, n: QK.quant_mlp_plain(x, q13, s13, q2, s2, n,
                                                               eps=1e-5),  # no residual
             lambda l: (x, *w("w13", l), *w("w2", l), norm_w), ["w13", "w2"], M=M,
             # up to 128 rows B9 runs on B5's mma.sync core
             kernel="ffn_sm90_kernel<" if M <= 128 else None)

    mlp_case("FFN + residual M=256", 256)

    def target_dots(model=""):
        """The quantized target (bench --quantize int8, a converted
        -int8.npz): its verify and padded AR step run every dot at
        decode_rows = 128 rows: B4 (wqkv + norm, wo + residual) and B6 (the
        head) on the 128-row core, B9 (the FFN) on B5's mma.sync core, over
        the int8 ``weights`` of draft_dots."""
        M = 128
        x = randn(M, D, scale=3.0)
        case(f"quant_matmul_fused {M128}", f"{model}target wqkv + attention norm M={M}",
             lambda x, q, s, n: QK.quant_matmul_fused(x, q, s, n),
             lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, s, n),
             lambda x, q, s, n: QK.quant_matmul_plain(x, q, s),  # without the norm
             lambda l: (x, *w("wqkv", l), norm_w), ["wqkv"], lib=x, M=M)
        a, res = randn(M, D), randn(M, D)
        case(f"quant_matmul_fused {M128}", f"{model}target wo + residual M={M}",
             lambda x, q, s, r: QK.quant_matmul_fused(x, q, s, res=r),
             lambda x, q, s, r: QK.quant_matmul_fused_plain(x, q, s, res=r),
             lambda x, q, s, r: QK.quant_matmul_plain(x, q, s),  # without the residual
             lambda l: (a, *w("wo", l), res), ["wo"], lib=a, M=M)
        mlp_case(f"{model}target FFN + residual M={M}", M)
        x = randn(M, D, scale=0.5)
        case(f"quant_matmul {M128}", f"{model}target lm_head [{D}, {V}] M={M}",
             QK.quant_matmul, QK.quant_matmul_plain,
             lambda x, q, s: QK.quant_matmul_plain(x, q, s.roll(1, -1)),  # scales off by one
             lambda l: (x, *w("lm_head", l)), ["lm_head"], lib=x, M=M)
        return x

    x = target_dots()
    del weights["lm_head"]
    # the tied head over quantize_embed's [D, V] table (bench --quantize_embed
    # on a tied model), through the routing of quantization.quant_matmul
    eq = Q.quantize_embed(randn(V, D))
    weights["embed_t"] = (eq.q[None], eq.scale)
    del eq
    case(f"quant_matmul {M128}", "tied quantize_embed head [2048, 128256] M=128",
         lambda x, q, s: Q.quant_matmul(x, Q.QuantizedWeight(q, s[None])),
         QK.quant_matmul_plain,
         lambda x, q, s: QK.quant_matmul_plain(x, q, s.roll(1, -1)),
         lambda l: (x, *w("embed_t", l)), ["embed_t"], lib=x, M=128)
    del weights
    torch.cuda.empty_cache()

    def shifted(s):
        return s.roll(1, 0)  # each group takes the scales of the group before

    # group-wise int8 (quantize_params(bits=8, group_size=128), scales
    # [L, G, Out]): B4 with its norm, gate or residual and B6, at the
    # draft's rows (the cluster core) and the target's decode_rows (the
    # 128-row core)
    def stack8g(In, Out, layers=L):
        w = Q.quantize_params({"layers": {"wo": randn(layers, In, Out, scale=In ** -0.5)}},
                              bits=8, group_size=GROUP8, include_head=False)["layers"]["wo"]
        return w.q, w.scale

    weights = {"wqkvg8": stack8g(D, D + 1024), "w13g8": stack8g(D, 2 * F),
               "w2g8": stack8g(F, D), "lm_headg8": stack8g(D, V, layers=1)}
    for M in (32, 64, 128):
        x, g, res = randn(M, D, scale=3.0), randn(M, F, scale=0.5), randn(M, D)
        fused8g = (f"quant_matmul_fused {M128}" if M == 128
                   else f"quant_matmul_fused {GROUPED8}")
        head8g = f"quant_matmul {M128}" if M == 128 else f"quant_matmul {GROUPED8}"
        tag = "group-wise int8 " if M == 128 else ""
        case(fused8g, f"{tag}wqkv + attention norm M={M}",
             lambda x, q, s, n: QK.quant_matmul_fused(x, q, s, n),
             lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, s, n),
             lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, shifted(s), n),
             lambda l: (x, *w("wqkvg8", l), norm_w), ["wqkvg8"], lib=x, M=M)
        case(fused8g, f"{tag}w13 + norm + SiLU gate M={M}",
             lambda x, q, s, n: QK.quant_matmul_fused(x, q, s, n, gate=True),
             lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, s, n, gate=True),
             lambda x, q, s, n: QK.quant_matmul_fused_plain(x, q, shifted(s), n, gate=True),
             lambda l: (x, *w("w13g8", l), norm_w), ["w13g8"], lib=x, M=M)
        case(fused8g, f"{tag}w2 + residual M={M}",
             lambda x, q, s, r: QK.quant_matmul_fused(x, q, s, res=r),
             lambda x, q, s, r: QK.quant_matmul_fused_plain(x, q, s, res=r),
             lambda x, q, s, r: QK.quant_matmul_fused_plain(x, q, shifted(s), res=r),
             lambda l: (g, *w("w2g8", l), res), ["w2g8"], lib=g, M=M)
        x = randn(M, D, scale=0.5)
        case(head8g, f"{tag}lm_head [2048, 128256] M={M}",
             QK.quant_matmul, QK.quant_matmul_plain,
             lambda x, q, s: QK.quant_matmul_plain(x, q, shifted(s)),
             lambda l: (x, *w("lm_headg8", l)), ["lm_headg8"], lib=x, M=M)
    del weights
    torch.cuda.empty_cache()

    # the int4 copy: groups of 128 contraction rows, scales [L, G, Out];
    # every dot takes its input normed already (no norm in the int4 kernels)
    def stack4(In, Out, layers=L):
        w = Q.quantize_params({"layers": {"wo": randn(layers, In, Out, scale=In ** -0.5)}},
                              bits=4, include_head=False)["layers"]["wo"]
        return w.q, w.scale

    weights = {"wqkv4": stack4(D, D + 1024), "wo4": stack4(D, D), "w134": stack4(D, 2 * F),
               "w24": stack4(F, D), "lm_head4": stack4(D, V, layers=1)}
    fused4, plain4 = QK.quant_matmul_fused_int4, QK.quant_matmul_fused_int4_plain

    # M = 128: the int4 target (bench --quantize int4) at decode_rows, on
    # the 128-row core
    for M in (32, 64, 128):
        target = "target " if M == 128 else ""
        b4 = f"quant_matmul_fused_int4 {M128}" if M == 128 else "quant_matmul_fused_int4"
        x, res = randn(M, D), randn(M, D)
        g = randn(M, F, scale=0.5)
        case(b4, f"{target}wqkv M={M}", fused4, plain4,
             lambda x, q, s: plain4(x, q, shifted(s)),
             lambda l: (x, *w("wqkv4", l)), ["wqkv4"], lib=x, M=M)
        case(b4, f"{target}wo + residual M={M}",
             lambda x, q, s, r: fused4(x, q, s, r), lambda x, q, s, r: plain4(x, q, s, r),
             lambda x, q, s, r: plain4(x, q, shifted(s), r),
             lambda l: (x, *w("wo4", l), res), ["wo4"], lib=x, M=M)
        case(b4, f"{target}w13 + SiLU gate M={M}",
             lambda x, q, s: fused4(x, q, s, gate=True),
             lambda x, q, s: plain4(x, q, s, gate=True),
             lambda x, q, s: plain4(x, q, shifted(s), gate=True),
             lambda l: (x, *w("w134", l)), ["w134"], lib=x, M=M)
        case(b4, f"{target}w2 + residual M={M}",
             lambda x, q, s, r: fused4(x, q, s, r), lambda x, q, s, r: plain4(x, q, s, r),
             lambda x, q, s, r: plain4(x, q, shifted(s), r),
             lambda l: (g, *w("w24", l), res), ["w24"], lib=g, M=M)
        x = randn(M, D, scale=0.5)
        case("quant_matmul_int4", f"{target}lm_head [2048, 128256] M={M}",
             QK.quant_matmul_int4, QK.quant_matmul_int4_plain,
             lambda x, q, s: QK.quant_matmul_int4_plain(x, q, s.roll(1, -1)),
             lambda l: (x, *w("lm_head4", l)), ["lm_head4"], lib=x, M=M)
    del weights
    torch.cuda.empty_cache()
    # the draft's int8 copy at llama-3.1-8b widths (path (20): D 4096, F
    # 14336, 8 kv heads of 128), 4 layers in turn (a layer's w13 alone is 117
    # MB, past the L2); then the quantized 8B target's 128-row dots on the
    # same weights (path (28)), and on group-wise int8 and int4 copies
    D, F = 4096, 14336
    draft_dots(D, F, 1024, 4, "llama-3.1-8b ")
    target_dots("llama-3.1-8b ")
    del weights
    torch.cuda.empty_cache()
    # two layers in turn (a layer's w13 is 117 MB int8, 59 MB int4: past the L2)
    M, L8, model = 128, 2, "llama-3.1-8b target "
    x, g, res = randn(M, D, scale=3.0), randn(M, F, scale=0.5), randn(M, D)
    weights = {"wqkvg8": stack8g(D, D + 2048, L8), "wog8": stack8g(D, D, L8),
               "w13g8": stack8g(D, 2 * F, L8), "w2g8": stack8g(F, D, L8)}
    for key, label, norm, gate, lhs in (("wqkvg8", "wqkv + attention norm", True, False, x),
                                        ("wog8", "wo + residual", False, False, x),
                                        ("w13g8", "w13 + norm + SiLU gate", True, True, x),
                                        ("w2g8", "w2 + residual", False, False, g)):
        # the norm weight, or the residual, as the operand after the scales;
        # the wrong references shift the group scales by one group
        kw = (lambda n, gate=gate: dict(norm_w=n, gate=gate)) if norm else (
            lambda r: dict(res=r))
        case(f"quant_matmul_fused {M128}", f"{model}group-wise int8 {label} M={M}",
             lambda x, q, s, e, kw=kw: QK.quant_matmul_fused(x, q, s, **kw(e)),
             lambda x, q, s, e, kw=kw: QK.quant_matmul_fused_plain(x, q, s, **kw(e)),
             lambda x, q, s, e, kw=kw: QK.quant_matmul_fused_plain(x, q, shifted(s), **kw(e)),
             lambda l, k=key, a=lhs, e=(norm_w if norm else res): (a, *w(k, l), e), [key],
             lib=lhs, M=M)
    del weights
    torch.cuda.empty_cache()
    weights = {"wqkv4": stack4(D, D + 2048, L8), "wo4": stack4(D, D, L8),
               "w134": stack4(D, 2 * F, L8), "w24": stack4(F, D, L8),
               "lm_head4": stack4(D, V, layers=1)}
    x = randn(M, D)
    case(f"quant_matmul_fused_int4 {M128}", f"{model}wqkv M={M}", fused4, plain4,
         lambda x, q, s: plain4(x, q, shifted(s)),
         lambda l: (x, *w("wqkv4", l)), ["wqkv4"], lib=x, M=M)
    case(f"quant_matmul_fused_int4 {M128}", f"{model}wo + residual M={M}",
         lambda x, q, s, r: fused4(x, q, s, r), lambda x, q, s, r: plain4(x, q, s, r),
         lambda x, q, s, r: plain4(x, q, s),  # without the residual
         lambda l: (x, *w("wo4", l), res), ["wo4"], lib=x, M=M)
    case(f"quant_matmul_fused_int4 {M128}", f"{model}w13 + SiLU gate M={M}",
         lambda x, q, s: fused4(x, q, s, gate=True), lambda x, q, s: plain4(x, q, s, gate=True),
         lambda x, q, s: plain4(x, q, shifted(s), gate=True),
         lambda l: (x, *w("w134", l)), ["w134"], lib=x, M=M)
    case(f"quant_matmul_fused_int4 {M128}", f"{model}w2 + residual M={M}",
         lambda x, q, s, r: fused4(x, q, s, r), lambda x, q, s, r: plain4(x, q, s, r),
         lambda x, q, s, r: plain4(x, q, shifted(s), r),
         lambda l: (g, *w("w24", l), res), ["w24"], lib=g, M=M)
    x = randn(M, D, scale=0.5)
    case("quant_matmul_int4", f"{model}lm_head [{D}, {V}] M={M}",
         QK.quant_matmul_int4, QK.quant_matmul_int4_plain,
         lambda x, q, s: QK.quant_matmul_int4_plain(x, q, s.roll(1, -1)),
         lambda l: (x, *w("lm_head4", l)), ["lm_head4"], lib=x, M=M)
    del weights, norm_w
    torch.cuda.empty_cache()


def _agreement(spec_out, spec_n, base_out, max_gen):
    """Spec vs AR tokens per request, over the tokens spec committed (at most
    max_gen; spec stops the batch when one request reaches max_gen, so
    most requests commit fewer).  Raises unless every request agrees on
    every such token; returns a printable summary."""
    prefix, compared = [], []
    for b in range(spec_out.shape[0]):
        n = min(int(spec_n[b]), max_gen)
        same = spec_out[b, :n] == base_out[b, :n]
        compared.append(n)
        prefix.append(n if same.all() else int(same.argmin()))
    agree = sum(p == n for p, n in zip(prefix, compared))
    summary = (f"spec/AR: {agree} of {len(prefix)} requests agree on every committed "
               f"token; common prefix mean={sum(prefix) / len(prefix):.2f} "
               f"min={min(prefix)} over tokens compared mean="
               f"{sum(compared) / len(compared):.2f} min={min(compared)}")
    if agree != len(prefix):
        raise AssertionError("spec and AR tokens differ: " + summary)
    return summary


def _zero_counts(wrappers):
    """Every wrapper's launch counters to 0 (and its bf16-scale,
    head-dim-128 and 128-row-core counts)."""
    for w in wrappers:
        w.launches = 0
        for count in ("bf16_scale_launches", "hd128_launches", "m128_launches"):
            if hasattr(w, count):
                setattr(w, count, 0)


def _read_counts(wrappers):
    """{wrapper: launches}, and {f"wrapper {BF16S}": its launches on bf16
    scales} for the quantized-KV wrappers, {f"wrapper {HD128}": its launches
    at head dim 128} for the attention wrappers, {f"wrapper {M128}": its
    launches on the 128-row core} for B4, B6 and B4-int4."""
    counts = {w.__name__: w.launches for w in wrappers}
    counts.update({f"{w.__name__} {BF16S}": w.bf16_scale_launches for w in wrappers
                   if hasattr(w, "bf16_scale_launches")})
    counts.update({f"{w.__name__} {HD128}": w.hd128_launches for w in wrappers
                   if hasattr(w, "hd128_launches")})
    counts.update({f"{w.__name__} {M128}": w.m128_launches for w in wrappers
                   if hasattr(w, "m128_launches")})
    return counts


def _all_on_bf16_scales(tag, launches, wrappers):
    """Raises unless each of ``wrappers`` launched, every launch on bf16
    scales; returns the printable counts."""
    counts = {w.__name__: (launches[f"{w.__name__} {BF16S}"], launches[w.__name__])
              for w in wrappers}
    summary = ", ".join(f"{n} {b} of {a}" for n, (b, a) in counts.items())
    print(f"[{tag}] launches on bf16 scales: {summary}", flush=True)
    bad = [n for n, (b, a) in counts.items() if not a or b != a]
    if bad:
        raise AssertionError(f"{tag}: {bad} did not run on bf16 scales alone ({summary})")
    return summary


def main_path(torch, wrappers, required, argv, forbidden=(), min_tokens_per_step=2.5):
    """The bench's main path with ``argv``; the counters are zeroed just
    before and read just after.  Fails unless every kernel in ``required``
    was launched, none in ``forbidden`` was, tokens per step reach
    ``min_tokens_per_step`` and spec == AR on every committed token.
    Returns (bench output, launches, peak GiB)."""
    from magicdec_tpu_torch import bench

    _zero_counts(wrappers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = bench.main(argv)
    wall = time.perf_counter() - t0
    launches = _read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = " ".join(argv) or "defaults"
    print(f"[main {tag}] wall={wall:.1f}s gamma={out['gamma']} launches={launches} "
          f"peak_mem={peak:.2f} GiB", flush=True)
    args = bench.parse_args(argv)
    print(f"[main {tag}] time to first token (the last measured spec encode, B={args.B} x "
          f"{args.prefix_len}): {out['encode_s']:.4f} s", flush=True)
    print(f"[main {tag}] " + _agreement(out["spec_output"], out["spec_committed"],
                                        out["base_output"], args.max_gen),
          flush=True)
    for w in required:
        if launches[w.__name__] <= 0:
            raise AssertionError(f"the main path ({tag}) never launched {w.__name__}")
    for w in forbidden:
        if launches[w.__name__]:
            raise AssertionError(f"the main path ({tag}) launched {w.__name__}, which it "
                                 "must not reach")
    if launches.get("gumbel_argmax"):
        raise AssertionError(f"the greedy main path ({tag}) launched S1")
    res = out["result"]
    if res["tokens_per_step"] < min_tokens_per_step:
        raise AssertionError(f"acceptance collapsed ({tag}): {res['tokens_per_step']} "
                             "tokens/step")
    return out, launches, peak


def snapkv_main_path(torch, wrappers, required, forbidden):
    """``main_path`` with ``--mode snapkv --iters 1``, the compression
    (``SpecEngine._snapkv_fill_draft``) timed inside each encode between
    synchronizations: its share of the last measured encode is printed.
    Fails unless K2q ran the 32-token window chunk too: its launches exceed
    the pre-window chunks' (16 layers x 16 chunks an encode)."""
    from magicdec_tpu_torch.engine.engine import SpecEngine
    from magicdec_tpu_torch.kernels import prefill_attention as PA

    fill = SpecEngine._snapkv_fill_draft
    times = []

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fill(self, *a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    SpecEngine._snapkv_fill_draft = timed
    try:
        out, launches, peak = main_path(torch, wrappers, required, ["--mode", "snapkv",
                                                                    "--iters", "1"],
                                        forbidden=forbidden)
    finally:
        SpecEngine._snapkv_fill_draft = fill
    # spec encodes: the warmup and the measured one; baseline encodes run
    # the 512-row chunks only (17 chunks at 8224 tokens)
    chunks = 16 * (2 * 17 + 2 * 16)
    if launches[PA.flash_prefill_attend_quant.__name__] != chunks + 16 * 2:
        raise AssertionError(f"K2q launched {launches[PA.flash_prefill_attend_quant.__name__]} "
                             f"times, not {chunks} chunk calls + 32 window-chunk calls")
    print(f"[snapkv] the compression (16 layers x 32 requests) took {times[-1]:.4f} s of the "
          f"last measured encode's {out['encode_s']:.4f} s ({times[-1] / out['encode_s']:.1%}; "
          f"every encode: {[round(t, 4) for t in times]} s)", flush=True)
    return out, launches, peak


# (28): bench --model llama-3.1-8b --quantize int8 at B=32 (decode_rows 128)
# over 2048-token prompts, 40 tokens
QUANTIZED_8B_ARGV = ["--model", "llama-3.1-8b", "--quantize", "int8", "--B", "32",
                     "--prefix_len", "2048", "--max_gen", "40", "--iters", "1"]
# the int8 / int4 weight wrappers whose launches the quantized-target paths
# count by row count (the target's passes run at decode_rows = 128 rows)
ROW_COUNTED = ("quant_matmul_fused", "quant_mlp", "quant_matmul", "quant_layer_tail",
               "quant_matmul_fused_int4", "quant_matmul_int4")


def quantized_main_path(torch, wrappers, required, argv, forbidden, at_128,
                        min_tokens_per_step=2.5):
    """``main_path`` with ``argv`` (a ``--quantize`` path), each int8 / int4
    weight wrapper's launches also counted by their row count (wrapping the
    module attributes the routing calls; the launch counters stay the
    wrappers' own).  Fails unless every wrapper in ``at_128`` launched at
    the target's 128 rows (B=32 x (gamma 3 + 1): the verify and the padded
    AR step), and unless every quantized dot of a decode pass (at most
    quantization.ROWS_CAP rows: the target's and the draft's steps) ran a
    kernel: only prefill chunks take the plain product.  Returns (bench
    output, launches, peak GiB, {wrapper: {rows: launches}})."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    rows = {n: {} for n in ROW_COUNTED}
    originals = {n: getattr(QK, n) for n in ROW_COUNTED}

    def spy_of(name, fn):
        def spy(x, *a, **kw):
            # the wrapper counts its launch on the module attribute, this spy:
            # pass the counts on to the wrapper's own counters
            spy.launches = spy.m128_launches = 0
            out = fn(x, *a, **kw)
            if spy.launches:
                fn.launches += spy.launches
                rows[name][x.shape[0]] = rows[name].get(x.shape[0], 0) + 1
            if spy.m128_launches:
                fn.m128_launches += spy.m128_launches
            return out
        spy.launches = spy.m128_launches = 0
        return spy

    # each outermost quantization.quant_matmul call: its rows, and whether a
    # kernel launched inside it
    shapes, undo = _dot_spy(torch)
    for name, fn in originals.items():
        setattr(QK, name, spy_of(name, fn))
    try:
        out, launches, peak = main_path(torch, wrappers, required, argv, forbidden=forbidden,
                                        min_tokens_per_step=min_tokens_per_step)
    finally:
        undo()
        for name, fn in originals.items():
            setattr(QK, name, fn)
    dots = {}
    for (m, _, _, route), n in shapes.items():
        dots[(m, route)] = dots.get((m, route), 0) + n
    tag = " ".join(argv)
    print(f"[main {tag}] launches by row count: "
          + ", ".join(f"{n} {dict(sorted(r.items()))}" for n, r in rows.items() if r),
          flush=True)
    print(f"[main {tag}] quantized dots by (rows, route): {dict(sorted(dots.items()))}",
          flush=True)
    for name in at_128:
        if not rows[name].get(128):
            raise AssertionError(f"the path ({tag}) never launched {name} at the target's "
                                 f"128 rows: {rows[name]}")
    plain = {m: n for (m, route), n in dots.items() if route == "plain" and m <= Q.ROWS_CAP}
    if plain:
        raise AssertionError(f"the path ({tag}) took the plain product on a decode pass: "
                             f"{plain} (rows: calls)")
    # B4, B6 and B4-int4 above 64 rows ran on the 128-row core, and only there
    for name in ("quant_matmul_fused", "quant_matmul", "quant_matmul_fused_int4"):
        wide = sum(n for m, n in rows[name].items() if m > QK.CLUSTER_ROWS)
        if launches[f"{name} {M128}"] != wide:
            raise AssertionError(f"the path ({tag}): {name} launched {wide} times above "
                                 f"{QK.CLUSTER_ROWS} rows, {launches[f'{name} {M128}']} on "
                                 "the 128-row core")
    return out, launches, peak, rows


def _bench_summary(out):
    r = out["result"]
    return (f"spec {r['value']} tok/s ({r['latency_ms_per_token']} ms/token), AR "
            f"{round(r['value'] / r['vs_baseline'], 2)} tok/s "
            f"({r['baseline_latency_ms_per_token']} ms/token), {r['tokens_per_step']} "
            f"tokens/step, time to first token {out['encode_s']:.4f} s")


# The longspec path (standalone-draft speculation): llama-3.1-8b verified
# by llama-3.2-1b (the coupled synthetic pair, the draft's int8 copy), B=8,
# the target's int4 cache, 512-token prefill chunks; streamingllm at 8192
# and snapkv at 8224 (the 32-token observation window last) of 8320 rows
# (the 16384 and 16416 of 16512 of earlier runs halved, a depth cut for the
# time limit), full mode at 4096 of 4608.  Each run times the one batch it runs (no
# warmup batch: the kernels are built and warm from the kernel phase, a
# depth cut for the time limit) and runs the target's AR baseline on it.
# (23): exact speculative sampling on the streamingllm draft at the JAX
# package's sample() defaults (temperature 0.6, top-p 0.9), a 4096-token
# prompt (a depth cut: the greedy run keeps 8192), its baseline sampling
# with the same key.
LONGSPEC_ARGV = ["--model", "llama-3.1-8b", "--draft_model", "llama-3.2-1b", "--B", "8",
                 "--kv_quant", "int4", "--draft_quant", "int8", "--prefill_chunk", "512",
                 "--baseline"]
# (tag, draft mode, tokens/step floor (0: none), flags)
LONGSPEC_RUNS = (
    ("streamingllm", "streamingllm", 2.2,
     ["--prefix_len", "8192", "--max_len", "8320", "--num_batches", "1",
      "--warmup_batches", "0"]),
    ("snapkv", "snapkv", 2.2, ["--mode", "snapkv", "--prefix_len", "8224", "--max_len",
                               "8320", "--num_batches", "1", "--warmup_batches", "0"]),
    ("full", "full", 0.0, ["--draft_budget", "-1", "--prefix_len", "4096", "--max_len", "4608",
                           "--num_batches", "1", "--warmup_batches", "0"]),
    ("sampled", "streamingllm", 2.2,
     ["--prefix_len", "4096", "--max_len", "4608", "--num_batches", "1", "--warmup_batches",
      "0", "--temperature", "0.6", "--top_p", "0.9"]))


def longspec_phase(torch, wrappers, required, forbidden):
    """``python -m magicdec_tpu_torch.longspec_benchmark`` with LONGSPEC_ARGV
    in each run of LONGSPEC_RUNS, the counters zeroed just before and read
    just after each run.  Fails unless spec == AR on every committed token
    of every batch (the sampled run: spec sampling == baseline sampling),
    B10 and B11 launched on their head-dim-128 instances (the 8B target's
    attention) and every launch of theirs was one, every
    kernel of ``required`` launched (full and snapkv: K2 too, the draft's
    prefill over its full cache) and none of ``forbidden``, and tokens per
    step reach the run's floor: 2.2 in streamingllm, snapkv and sampled
    (the JAX package's gate for the coupled pair; a sampling draft whose
    noise is not the target's reads near 1, the coupled pair 2.433 on an
    H100 80GB HBM3 at 700 W).  S1 launches on the sampled run
    only, once a head: (gamma + 1) a window and token0 for spec, one a step
    and token0 for the baseline.  Prints each run's spec and AR tok/s,
    tokens per step, time to first token (the timed batch's encode) and
    peak device memory.  Returns {tag: (result line, launches, peak GiB,
    encode s)}."""
    from magicdec_tpu_torch import longspec_benchmark
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.kernels import sampling as S1

    results = {}
    for run, mode, floor, extra in LONGSPEC_RUNS:
        argv = LONGSPEC_ARGV + extra
        _zero_counts(wrappers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = longspec_benchmark.main(argv)
        wall = time.perf_counter() - t0
        launches = _read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        res = out["result"]
        tag = f"longspec {run}"
        print(f"[{tag}] wall={wall:.1f}s launches={launches} peak_mem={peak:.2f} GiB",
              flush=True)
        if res is None or out["engine_mode"] != mode:
            raise AssertionError(f"{tag}: no timed batch, or the engine ran {out['engine_mode']}")
        args = longspec_benchmark.parse_args(argv)
        for i, (s, b) in enumerate(zip(out["spec"], out["base"])):
            print(f"[{tag}] batch {i}: " + _agreement(s["output"], s["num_committed"],
                                                     b["output"], args.max_gen), flush=True)
        if len(out["spec"]) != len(out["base"]) or not out["spec"]:
            raise AssertionError(f"{tag}: the AR baseline did not run on every batch")
        for w in (DA.flash_decode_attend_quant4, PA.flash_prefill_attend_quant4):
            n, n128 = launches[w.__name__], launches[f"{w.__name__} {HD128}"]
            if n128 <= 0 or n128 != n:
                raise AssertionError(f"{tag}: {w.__name__} launched {n} times, {n128} of them "
                                     "on its head-dim-128 instance")
        want = list(required) + ([PA.flash_prefill_attend] if mode != "streamingllm" else [])
        for w in want:
            if launches[w.__name__] <= 0:
                raise AssertionError(f"{tag} never launched {w.__name__}")
        for w in forbidden:
            if launches[w.__name__]:
                raise AssertionError(f"{tag} launched {w.__name__}, which it must not reach")
        if res["tokens_per_step"] < floor:
            raise AssertionError(f"{tag}: acceptance collapsed, {res['tokens_per_step']} "
                                 "tokens/step")
        heads = (sum(s["target_steps"] * (args.gamma + 1) + 1 for s in out["spec"])
                 + len(out["base"]) * args.max_gen) if args.temperature > 0 else 0
        if launches[S1.gumbel_argmax.__name__] != heads:
            raise AssertionError(f"{tag}: S1 launched {launches[S1.gumbel_argmax.__name__]} "
                                 f"times, not the run's {heads} sampled heads")
        timed = out["spec"][args.warmup_batches]
        ar_tps = res["value"] / res["vs_baseline"] if res["vs_baseline"] else float("nan")
        print(f"[{tag}] B={args.B} prefix={args.prefix_len}: spec {res['value']} tok/s, AR "
              f"{ar_tps:.2f} tok/s (vs_baseline {res['vs_baseline']}), "
              f"{res['tokens_per_step']} tokens/step, {timed['target_steps']} windows, time to "
              f"first token {timed['encode_s']:.4f} s, peak {peak:.2f} GiB; {res['metric']}",
              flush=True)
        results[run] = (res, launches, peak, timed["encode_s"])
        del out
    return results


# the paged int4 longspec serve: 4 requests of distinct lengths in [3072,
# 4096] through 8 slots (8 in earlier runs, a depth cut for the time
# limit), 512-row pages, the 8B target and the 1B draft
LONGSPEC_SERVE = dict(slots=8, lens=(3072, 3459, 3846, 4095),
                      max_len=4608, page_size=512, max_gen=32)


def longspec_serving_phase(torch, wrappers):
    """``PagedServingLongSpecEngine`` over an int4 pool against
    ``ServingLongSpecEngine`` on the same weights (the coupled 8B + 1B pair,
    the draft's int8 copy) and prompts: every request's tokens equal; B12's
    int4 pool on its head-dim-128 instance once a layer per target pass
    (32 layers x the windows), B13 launched.  Returns the paged serve's launches."""
    import numpy as np

    from magicdec_tpu_torch import bench
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.engine import EngineConfig
    from magicdec_tpu_torch.engine.serving import (PagedServingLongSpecEngine,
                                                   ServingLongSpecEngine)
    from magicdec_tpu_torch.kernels import paged_attention as PGA

    c = LONGSPEC_SERVE
    cfg, dcfg = ModelConfig.from_name("llama-3.1-8b"), ModelConfig.from_name("llama-3.2-1b")
    params, dparams = bench.make_longspec_params(cfg, dcfg, seed=1)
    ecfg = EngineConfig(mode="streamingllm", gamma=3, draft_budget=257, max_seq_len=c["max_len"],
                        chunk_size=128, prefill_chunk_size=512, max_gen=c["max_gen"],
                        eot_ids=(-1,), cache_dtype=torch.bfloat16, kv_quant="int4",
                        draft_quant="int8", page_size=c["page_size"])
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in c["lens"]]
    outs, stats = {}, {}
    for name, cls in (("contiguous", ServingLongSpecEngine), ("paged", PagedServingLongSpecEngine)):
        engine = cls(params, cfg, dparams, dcfg, ecfg)
        _zero_counts(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = engine.serve(prompts, B=c["slots"], windows_per_sync=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats[name] = (engine.last_serve_stats, _read_counts(wrappers))
        del engine
        torch.cuda.empty_cache()
        st = stats[name][0]
        print(f"[longspec serve {name}] {len(prompts)} requests through {c['slots']} slots in "
              f"{wall:.2f}s, {st['windows']} windows, {st['tokens_per_step']:.3f} tokens/step",
              flush=True)
    print("[longspec serve] " + _same_tokens("paged int4 pool against contiguous slots",
                                             outs["paged"], outs["contiguous"]), flush=True)
    st, launches = stats["paged"]
    name = PGA.flash_paged_decode_attend_quant4.__name__
    want = cfg.n_layer * st["windows"]
    if launches[f"{name} {HD128}"] != want or launches[name] != want:
        raise AssertionError(f"{name} launched {launches[name]} times "
                             f"({launches[f'{name} {HD128}']}"
                             f" at head dim 128), not {cfg.n_layer} layers x {st['windows']} "
                             "target passes")
    if launches[PGA.append_paged_rows_inplace.__name__] <= 0:
        raise AssertionError("the paged longspec serve never launched B13")
    del params, dparams
    torch.cuda.empty_cache()
    return launches


# The paged 8B serve (llama-3.1-8b, the draft sharing the target's bf16
# weights, serving_bench's default): 2 requests of distinct lengths in [1024,
# 2048] through 8 slots (4 in earlier runs, a depth cut for the time
# limit), 512-row pages; a short serve per pool format
SERVE8B = dict(slots=8, num_requests=2, prefix=2048, max_len=2560, page_size=512, max_gen=16)


def _all_at_hd128(tag, launches, wrappers):
    """Raises unless each of ``wrappers`` launched, every launch on its
    head-dim-128 instance; returns the printable counts."""
    counts = {w.__name__: (launches[f"{w.__name__} {HD128}"], launches[w.__name__])
              for w in wrappers}
    summary = ", ".join(f"{n} {h} of {a}" for n, (h, a) in counts.items())
    print(f"[{tag}] launches at head dim 128: {summary}", flush=True)
    bad = [n for n, (h, a) in counts.items() if not a or h != a]
    if bad:
        raise AssertionError(f"{tag}: {bad} did not run at head dim 128 alone ({summary})")
    return summary


def serve_8b_phase(torch, wrappers, kernels):
    """(22) The paged 8B serve: ``PagedServingEngine`` against
    ``ServingEngine`` on the same weights (``bench.make_params`` at
    llama-3.1-8b) and prompts, over a bf16, an int8, and bf16-scale int8
    and int4 pools, the counters zeroed just before and read just after
    each serve.  Every request's tokens equal; the paged serve's B12 on its
    head-dim-128 instance once a layer per target pass, B13 launched; the
    contiguous serve's K1 / K1q / B10 and both serves' K2 / K2q / B11 at
    head dim 128 (on bf16 scales for the bf16-scale pools); tokens per step
    >= 1.8.  Returns {kernels-line name: launches} of the head-dim-128
    instances these serves ran."""
    import numpy as np

    from magicdec_tpu_torch import bench
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.engine import EngineConfig
    from magicdec_tpu_torch.engine.serving import PagedServingEngine, ServingEngine
    from magicdec_tpu_torch.models.llama import fuse_exec_params

    DA, PA, PGA = (kernels[n] for n in ("DA", "PA", "PGA"))
    c = SERVE8B
    bf = torch.bfloat16
    cfg = ModelConfig.from_name("llama-3.1-8b")
    params = fuse_exec_params(bench.make_params(cfg, seed=0), cfg)
    rng = np.random.RandomState(108)
    lens = rng.choice(np.arange(c["prefix"] // 2, c["prefix"] + 1), c["num_requests"],
                      replace=False)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    formats = {
        "bf16": ({}, PGA.flash_paged_decode_attend, DA.flash_decode_attend,
                 PA.flash_prefill_attend),
        "int8": ({"kv_quant": "int8"}, PGA.flash_paged_decode_attend_quant,
                 DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant),
        "int8 bf16 scales": ({"kv_quant": "int8", "kv_scale_dtype": bf},
                             PGA.flash_paged_decode_attend_quant, DA.flash_decode_attend_quant,
                             PA.flash_prefill_attend_quant),
        "int4 bf16 scales": ({"kv_quant": "int4", "kv_scale_dtype": bf},
                             PGA.flash_paged_decode_attend_quant4,
                             DA.flash_decode_attend_quant4, PA.flash_prefill_attend_quant4),
    }
    result = {}
    for fmt, (kw, paged_fn, contig_fn, prefill_fn) in formats.items():
        ecfg = EngineConfig(mode="streamingllm", gamma=3, draft_budget=257,
                            max_seq_len=c["max_len"], chunk_size=128, prefill_chunk_size=512,
                            max_gen=c["max_gen"], eot_ids=(-1,), cache_dtype=bf,
                            page_size=c["page_size"], **kw)
        bf16s = "kv_scale_dtype" in kw
        outs = {}
        for name, cls, attend in (("paged", PagedServingEngine, paged_fn),
                                  ("contiguous", ServingEngine, contig_fn)):
            engine = cls(params, cfg, ecfg)
            _zero_counts(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = engine.serve(prompts, B=c["slots"], windows_per_sync=4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st, launches = engine.last_serve_stats, _read_counts(wrappers)
            del engine
            torch.cuda.empty_cache()
            tag = f"serve 8B {fmt} {name}"
            print(f"[{tag}] {len(prompts)} requests (lengths {min(lens)}..{max(lens)}) through "
                  f"{c['slots']} slots in {wall:.2f}s, {st['windows']} windows, "
                  f"{st['tokens_per_step']:.3f} tokens/step", flush=True)
            _all_at_hd128(tag, launches, [attend, prefill_fn, DA.flash_decode_attend])
            if bf16s:
                _all_on_bf16_scales(tag, launches, [attend, prefill_fn])
            if name == "paged":
                want = cfg.n_layer * st["windows"]
                if launches[attend.__name__] != want:
                    raise AssertionError(f"{tag}: {attend.__name__} launched "
                                         f"{launches[attend.__name__]} times, not "
                                         f"{cfg.n_layer} layers x {st['windows']} target passes")
                if launches[PGA.append_paged_rows_inplace.__name__] <= 0:
                    raise AssertionError(f"{tag}: B13 never launched")
            if st["tokens_per_step"] < 1.8:
                raise AssertionError(f"{tag}: acceptance collapsed: {st['tokens_per_step']} "
                                     "tokens/step")
            for w in (attend, prefill_fn, DA.flash_decode_attend):
                key = f"{w.__name__} {BF16S} {HD128}" if bf16s and w is not \
                    DA.flash_decode_attend else f"{w.__name__} {HD128}"
                result[key] = result.get(key, 0) + launches[w.__name__]
        print(f"[serve 8B {fmt}] " + _same_tokens("PagedServingEngine against ServingEngine",
                                                   outs["paged"], outs["contiguous"]),
              flush=True)
    del params
    torch.cuda.empty_cache()
    return result


# the checkpoint round trip's serves: 8 requests of 2048 tokens through 8
# contiguous slots (a depth cut for the time limit), the draft sharing the
# target's weights (serving_bench's default)
ROUND_TRIP_ARGV = ["--slots", "8", "--num_requests", "8", "--prefix_len", "2048",
                   "--max_len", "2304", "--skip_warmup"]
_HF_LAYER = (("self_attn.q_proj.weight", "wq", True), ("self_attn.k_proj.weight", "wk", True),
             ("self_attn.v_proj.weight", "wv", True), ("self_attn.o_proj.weight", "wo", True),
             ("mlp.gate_proj.weight", "w1", True), ("mlp.up_proj.weight", "w3", True),
             ("mlp.down_proj.weight", "w2", True),
             ("input_layernorm.weight", "attn_norm", False),
             ("post_attention_layernorm.weight", "ffn_norm", False))


def write_hf_checkpoint(torch, params, cfg, d):
    """An HF-format directory of bf16 ``params`` (the port's layout, a tied
    head): two safetensors shards written by hand (an 8-byte little-endian
    header length, the JSON header, the raw tensors), the shard index and
    ``config.json``.  Returns the bytes written."""
    L = cfg.n_layer
    named = [[("model.embed_tokens.weight", params["embed"])], [("model.norm.weight",
                                                                   params["final_norm"])]]
    for l in range(L):
        for hf, ours, transpose in _HF_LAYER:
            w = params["layers"][ours][l]
            named[l * 2 // L].append((f"model.layers.{l}.{hf}", w.T if transpose else w))
    weight_map, total = {}, 0
    for i, tensors in enumerate(named):
        fname = f"model-{i + 1:05d}-of-{len(named):05d}.safetensors"
        header, off = {}, 0
        for name, t in tensors:
            n = t.numel() * t.element_size()
            header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + n]}
            off += n
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(d, fname), "wb") as f:
            f.write(len(raw).to_bytes(8, "little") + raw)
            for _, t in tensors:
                f.write(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        total += 8 + len(raw) + off
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "hidden_size": cfg.dim,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": L, "num_attention_heads": cfg.n_head,
                   "num_key_value_heads": cfg.n_kv_head, "vocab_size": cfg.vocab_size,
                   "max_position_embeddings": cfg.block_size, "rms_norm_eps": cfg.norm_eps,
                   "rope_theta": cfg.rope_base, "tie_word_embeddings": True,
                   "rope_scaling": {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
                                    "low_freq_factor": cfg.low_freq_factor,
                                    "high_freq_factor": cfg.high_freq_factor,
                                    "original_max_position_embeddings":
                                        cfg.original_max_position_embeddings}}, f)
    return total


def start_checkpoint_conversion(torch):
    """(14)'s first half: an HF-format directory written from
    ``bench.make_params(tied=True)`` at llama-3.2-1b's full width into a
    temporary directory, and ``python -m
    magicdec_tpu_torch.convert_checkpoint --quantize int8`` on it started
    as a process of its own (on the card), which runs while the phases
    before ``checkpoint_round_trip_phase`` do (it reads and writes files;
    nothing it does is timed against them).  Returns the state that
    ``checkpoint_round_trip_phase`` finishes; ``stop_checkpoint_conversion``
    ends the process and removes the directory on any path."""
    import tempfile

    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig

    cfg = ModelConfig.from_name("llama-3.2-1b")
    params = make_params(cfg, tied=True, device=torch.device("cuda"))
    tmp = tempfile.mkdtemp(prefix="magicdec_ckpt_")
    run = {"tmp": tmp, "cfg": cfg, "params": params, "proc": None}
    try:
        hf_dir = os.path.join(tmp, "hf", "llama-3.2-1b")
        os.makedirs(hf_dir)
        t0 = time.perf_counter()
        run["written"] = write_hf_checkpoint(torch, params, cfg, hf_dir)
        print(f"[ckpt] wrote the HF directory ({run['written']} bytes, two shards) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        out_dir = os.path.join(tmp, "npz")
        os.makedirs(out_dir)
        run["bf16_path"] = os.path.join(out_dir, "llama-3.2-1b.npz")
        run["int8_path"] = os.path.join(out_dir, "llama-3.2-1b-int8.npz")
        run["t0"] = time.perf_counter()
        run["proc"] = subprocess.Popen(
            [sys.executable, "-m", "magicdec_tpu_torch.convert_checkpoint",
             "--checkpoint_dir", hf_dir, "--out", run["bf16_path"], "--quantize", "int8"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    except BaseException:
        stop_checkpoint_conversion(run)
        raise
    return run


def stop_checkpoint_conversion(run):
    """End ``start_checkpoint_conversion``'s process if it still runs and
    remove its temporary directory."""
    import shutil

    proc = run.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()
    shutil.rmtree(run["tmp"], ignore_errors=True)


def checkpoint_round_trip_phase(torch, wrappers, run):
    """(14) The checkpoint pipeline at llama-3.2-1b's full width, after
    ``start_checkpoint_conversion(torch)`` (``run``): the conversion's
    process must end at rc 0 (waited for here, at most 600 s from its
    start), then ``serving_bench --model
    .../llama-3.2-1b.npz`` against a serve of the in-memory params, and
    ``--model .../llama-3.2-1b-int8.npz`` against a serve of
    ``quantize_params`` of them with the scales rounded through bf16 (what
    ``serving_bench``'s ``load_converted(dtype=bfloat16)`` makes of the dump), each
    token for token; then the int8 dump's NLL within 2% of the bf16 file's
    on 4 synthetic windows of 2048 tokens (chunks of 512 on K2).  The
    temporary directory is removed at the end."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.data.datasets import synthetic_long_context_dataset
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.quality import perplexity
    from magicdec_tpu_torch.utils.checkpoint import load_converted

    dev = torch.device("cuda")
    cfg, params = run["cfg"], run.pop("params")
    load = serving_bench.load_params_and_config

    def serve(model, in_memory=None):
        """serving_bench's timed serve of ROUND_TRIP_ARGV: ``--model`` a
        converted file, or (``in_memory``) the given params."""
        if in_memory is not None:
            serving_bench.load_params_and_config = lambda m, device, mesh=None: (in_memory, cfg)
        try:
            for w in wrappers:
                w.launches = 0
            t0 = time.perf_counter()
            out = serving_bench.main(ROUND_TRIP_ARGV + ["--model", model])
            wall = time.perf_counter() - t0
        finally:
            serving_bench.load_params_and_config = load
        launched = sorted(w.__name__ for w in wrappers if w.launches)
        print(f"[ckpt] serve {model}{' (in memory)' if in_memory is not None else ''}: "
              f"wall {wall:.1f} s; {_serving_summary(out)}; kernels {launched}", flush=True)
        return out

    try:
        bf16_path, int8_path, proc = run["bf16_path"], run["int8_path"], run["proc"]
        t_wait = time.perf_counter()
        stdout, stderr = proc.communicate(
            timeout=max(1.0, 600 - (time.perf_counter() - run["t0"])))
        if proc.returncode:
            raise AssertionError(f"convert_checkpoint failed ({proc.returncode}): "
                                 f"{stderr[-3000:]}")
        sizes = {p: os.path.getsize(p) for p in (bf16_path, int8_path)}
        print(f"[ckpt] convert_checkpoint --quantize int8: the process ended "
              f"{time.perf_counter() - run['t0']:.2f} s after its start, "
              f"{time.perf_counter() - t_wait:.2f} s of them waited for here; read "
              f"{run['written']} bytes, wrote {sizes[bf16_path]} + "
              f"{sizes[int8_path]} bytes; its output: {stdout.strip()!r}", flush=True)

        out = serve(bf16_path)
        ref = serve("llama-3.2-1b", in_memory=params)
        print("[ckpt] " + _same_tokens("the converted bf16 file against the in-memory params",
                                       out["outputs"], ref["outputs"]), flush=True)
        del out, ref
        qparams = Q.quantize_params(params, bits=8)
        qparams = dict(qparams, layers={
            k: Q.QuantizedWeight(w.q, w.scale.to(torch.bfloat16).float(), w.bits, w.group_size)
            if Q.is_quantized(w) else w for k, w in qparams["layers"].items()})
        out = serve(int8_path)
        ref = serve("llama-3.2-1b-int8", in_memory=qparams)
        print("[ckpt] " + _same_tokens(
            "the converted int8 dump against quantize_params of the in-memory params "
            "(scales rounded through bf16)", out["outputs"], ref["outputs"]), flush=True)
        del out, ref, qparams

        data = synthetic_long_context_dataset(2048, num_seqs=4, vocab_size=cfg.vocab_size,
                                              seed=0)
        nll = {}
        for label, path in (("bf16", bf16_path), ("int8", int8_path)):
            t0 = time.perf_counter()
            p = load_converted(path, dtype=torch.bfloat16, device=dev)
            if Q.bits_from_path(path):
                p = Q.quantize_params(p, bits=Q.bits_from_path(path))
            t_load = time.perf_counter() - t0
            PA.flash_prefill_attend.launches = 0
            t0 = time.perf_counter()
            ppl, nll[label] = perplexity(p, cfg, data, batch_size=4, chunk_size=512)
            print(f"[ckpt] perplexity of the {label} file: nll {nll[label]:.6f}, ppl "
                  f"{ppl:.6g} (load {t_load:.2f} s, {os.path.getsize(path)} bytes read; "
                  f"eval {time.perf_counter() - t0:.2f} s, K2 launched "
                  f"{PA.flash_prefill_attend.launches} times)", flush=True)
            if not PA.flash_prefill_attend.launches:
                raise AssertionError("the perplexity gate never launched K2")
            del p
        drift = abs(nll["int8"] - nll["bf16"]) / nll["bf16"]
        print(f"[ckpt] the int8 dump's NLL is {drift:.4%} from the bf16 file's (gate 2%)",
              flush=True)
        if not drift < 0.02:
            raise AssertionError(f"the int8 dump's NLL drifts {drift:.4%} from the bf16 file's")
    finally:
        stop_checkpoint_conversion(run)
    del params
    torch.cuda.empty_cache()


# The serving paths: llama-3.2-1b widths, synthetic weights, gamma 3, draft
# budget 257, max_gen 80, 16 slots over 8192-row slots in 512-row pages, 32
# requests of distinct lengths in [4192, 7875] (--ragged with --seed 107;
# a prefix_len of 62 x 128 makes serving_bench's target prefill chunk 512).
SERVE_ARGV = ["--paged", "--slots", "16", "--num_requests", "32", "--prefix_len", "7936",
              "--ragged", "--seed", "107", "--max_len", "8192", "--page_size", "512"]


def _serving_summary(out):
    st = out["stats"]
    per_req = [(len(o) - 1) / max(n, 1) for o, n in zip(out["outputs"], st["request_passes"])]
    return (f"{out['result']['value']} tok/s, {len(out['outputs']) / out['seconds']:.3f} req/s, "
            f"mean queue {st['mean_queue_ms']:.1f} ms, mean service "
            f"{st['mean_service_ms']:.1f} ms, {st['admission_waves']} admission waves "
            f"taking {st['admission_time_s']:.2f} s of host time "
            f"({st['page_blocked']} refills with a free slot blocked on pages), "
            f"{st['windows']} windows, min free pages {st['min_free_pages']} of "
            f"{st['total_pages']}, tokens/step {st['tokens_per_step']:.3f} (per request min "
            f"{min(per_req):.3f}, max {max(per_req):.3f})")


def serving_path(torch, wrappers, required, paged_attend, extra, forbidden=(),
                 min_tokens_per_step=1.8):
    """``python -m magicdec_tpu_torch.serving_bench`` with SERVE_ARGV +
    ``extra`` (with ``--skip_warmup``, the timed serve only;
    else a warmup serve of 16 first), the counters zeroed just before and
    read just after.  Fails unless
    every kernel in ``required`` launched, none in ``forbidden`` did, the
    paged decode kernel ``paged_attend`` launched once a layer per target
    pass (16 x the windows of the serves), the prompts are the distinct
    lengths asked for, and tokens per step reach the floor.  Returns
    (serving_bench output, launches, peak GiB)."""
    from magicdec_tpu_torch import serving_bench

    argv = SERVE_ARGV + extra
    _zero_counts(wrappers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serving_bench.main(argv)
    wall = time.perf_counter() - t0
    launches = _read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = " ".join(extra) or "bf16 pool"
    print(f"[serve {tag}] wall={wall:.1f}s launches={launches} peak_mem={peak:.2f} GiB",
          flush=True)
    print(f"[serve {tag}] " + _serving_summary(out), flush=True)
    lens = [len(p) for p in out["prompts"]]
    if len(set(lens)) != len(lens) or min(lens) < 4096 or max(lens) > 8000:
        raise AssertionError(f"the prompt lengths are not distinct in [4096, 8000]: {lens}")
    for w in required:
        if launches[w.__name__] <= 0:
            raise AssertionError(f"the serving path ({tag}) never launched {w.__name__}")
    for w in forbidden:
        if launches[w.__name__]:
            raise AssertionError(f"the serving path ({tag}) launched {w.__name__}, which it "
                                 "must not reach")
    passes = out["stats"]["windows"] + (out["warmup_stats"] or {}).get("windows", 0)
    if launches[paged_attend.__name__] != 16 * passes:
        raise AssertionError(f"{paged_attend.__name__} launched "
                             f"{launches[paged_attend.__name__]} times, not 16 layers x "
                             f"{passes} target passes")
    if out["stats"]["tokens_per_step"] < min_tokens_per_step:
        raise AssertionError(f"acceptance collapsed ({tag}): "
                             f"{out['stats']['tokens_per_step']} tokens/step")
    return out, launches, peak


def _same_tokens(what, outs, refs):
    """Raises unless every request's tokens agree; returns a summary."""
    differ = [i for i, (o, r) in enumerate(zip(outs, refs)) if not np_equal(o, r)]
    if differ:
        i = differ[0]
        o, r = outs[i], refs[i]
        first = next((j for j in range(min(len(o), len(r))) if o[j] != r[j]),
                     min(len(o), len(r)))
        raise AssertionError(f"{what}: {len(differ)} of {len(outs)} requests differ; request "
                             f"{i} first at token {first} ({len(o)} against {len(r)} tokens)")
    return f"{what}: all {len(outs)} requests agree on every token"


def np_equal(a, b):
    return len(a) == len(b) and bool((a == b).all())


def contiguous_serve(argv, prompts):
    """The same prompts through ``ServingEngine`` (contiguous slots), slots
    and windows_per_sync of the paged run of ``argv``."""
    from magicdec_tpu_torch import serving_bench

    args = serving_bench.parse_args([a for a in argv if a != "--paged"])
    engine, _ = serving_bench.setup(args)
    return engine.serve(prompts, B=args.slots, windows_per_sync=args.windows_per_sync)


def serving_phase(torch, wrappers, kernels):
    """The paged serving paths (bf16, int8 at full and half capacity, int4
    pools), each against ServingEngine on the same prompts, and served ==
    solo on the int8 path.  Returns the launches of each kernel's path."""
    from magicdec_tpu_torch import serving_bench

    DA, PA, AP, PGA = (kernels[n] for n in ("DA", "PA", "AP", "PGA"))
    paged_all = [PGA.flash_paged_decode_attend, PGA.flash_paged_decode_attend_quant,
                 PGA.flash_paged_decode_attend_quant4]
    draft = [DA.flash_decode_attend, AP.append_all_rows_inplace]
    paths = {
        "bf16": ([], [PGA.flash_paged_decode_attend, PA.flash_prefill_attend]),
        "int8": (["--kv_quant", "int8"], [PGA.flash_paged_decode_attend_quant,
                                          PA.flash_prefill_attend_quant,
                                          AP.append_all_rows_inplace_quant]),
        "int4": (["--kv_quant", "int4"], [PGA.flash_paged_decode_attend_quant4,
                                          PA.flash_prefill_attend_quant4,
                                          AP.append_all_rows_inplace_quant]),
    }
    result = {}
    peaks = {}
    for fmt, (extra, own) in paths.items():
        # each skips the warmup serve and serves the first 2 of the 32
        # requests, int8 8 (its small pool must make a free slot wait for
        # pages; 12 in earlier runs): depth cuts that keep chip_smoke.py inside
        # its time limit
        n = "8" if fmt == "int8" else "2"
        extra = extra + ["--skip_warmup", "--num_requests", n]
        out, launches, peaks[fmt] = serving_path(
            torch, wrappers, own + draft + [PGA.append_paged_rows_inplace], own[0], extra,
            forbidden=[w for w in paged_all if w is not own[0]])
        result[own[0].__name__] = launches[own[0].__name__]
        if fmt == "bf16":
            result["append_paged_rows_inplace"] = launches["append_paged_rows_inplace"]
        t0 = time.perf_counter()
        contig = contiguous_serve(SERVE_ARGV + extra, out["prompts"])
        print(f"[serve {fmt}] " + _same_tokens(
            "PagedServingEngine against ServingEngine", out["outputs"], contig)
            + f" (contiguous serve {time.perf_counter() - t0:.1f}s)", flush=True)
        del contig
        if fmt != "int8":
            continue
        # backpressure: 96 of the 16 slots x 16 pages, where the 8 requests
        # need 106 (half the pages, 128, under 12 requests in earlier runs)
        half, _, peaks["int8 half"] = serving_path(
            torch, wrappers, own + draft + [PGA.append_paged_rows_inplace], own[0],
            extra + ["--total_pages", "96"], forbidden=paged_all[::2])
        print("[serve int8 half] " + _same_tokens("the small pool against the full pool",
                                                  half["outputs"], out["outputs"]), flush=True)
        if half["stats"]["page_blocked"] <= 0:
            raise AssertionError("the small pool never made a free slot wait for pages")
        # served == solo: each of 2 requests (4 in earlier runs, a depth cut
        # for the time limit) alone through the same 16 slots
        engine, _ = serving_bench.setup(serving_bench.parse_args(SERVE_ARGV + extra))
        idx = list(range(0, len(out["prompts"]), len(out["prompts"]) // 2))
        t0 = time.perf_counter()
        solo = [engine.serve([out["prompts"][i]], B=16, windows_per_sync=4)[0] for i in idx]
        print(f"[serve int8] " + _same_tokens(
            "served against solo (2 requests, each alone through the same 16 slots)",
            [out["outputs"][i] for i in idx], solo)
            + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
        del engine, solo
    print("[serve] peak device memory: " + ", ".join(f"{k} pool {v:.2f} GiB"
                                                     for k, v in peaks.items()), flush=True)
    if peaks["int8 half"] >= peaks["int8"]:
        raise AssertionError("the small pool did not peak below the full one")
    return result


# The paged SnapKV serve: 16 slots, 16 requests of one length (7936 rounds
# to 7968 = 62 x 128 + 32, SnapKV's shape contract; not ragged, which the
# contract refuses), an int8 pool of 512-row pages, the bf16 draft shared
# with the target (serving_bench's default)
SNAPKV_SERVE_ARGV = ["--mode", "snapkv", "--kv_quant", "int8", "--paged", "--slots", "16",
                     "--num_requests", "16", "--prefix_len", "7936", "--max_len", "8192",
                     "--page_size", "512", "--skip_warmup"]


def snapkv_serving_phase(torch, wrappers, kernels):
    """``serving_bench`` with SNAPKV_SERVE_ARGV, the counters zeroed just
    before and read just after: B12's int8 pool once a layer per target
    pass, B13 (the verify's target half), K3 (its draft half, contiguous),
    K2q and K3q (the admission's encode, window chunk included) and K1 (the
    draft) launched, no other paged kernel and no contiguous K1q; then
    ``ServingEngine`` on the same prompts must give every token.  Returns
    the launches."""
    from magicdec_tpu_torch import serving_bench

    DA, PA, AP, PGA = (kernels[n] for n in ("DA", "PA", "AP", "PGA"))
    for w in wrappers:
        w.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serving_bench.main(SNAPKV_SERVE_ARGV)
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve snapkv] wall={wall:.1f}s launches={launches} peak_mem={peak:.2f} GiB",
          flush=True)
    print("[serve snapkv] " + _serving_summary(out), flush=True)
    required = [PGA.flash_paged_decode_attend_quant, PGA.append_paged_rows_inplace,
                AP.append_all_rows_inplace, PA.flash_prefill_attend_quant,
                AP.append_all_rows_inplace_quant, DA.flash_decode_attend]
    forbidden = [PGA.flash_paged_decode_attend, PGA.flash_paged_decode_attend_quant4,
                 DA.flash_decode_attend_quant]
    for w in required:
        if launches[w.__name__] <= 0:
            raise AssertionError(f"the snapkv serve never launched {w.__name__}")
    for w in forbidden:
        if launches[w.__name__]:
            raise AssertionError(f"the snapkv serve launched {w.__name__}")
    passes = out["stats"]["windows"]
    if launches["flash_paged_decode_attend_quant"] != 16 * passes:
        raise AssertionError(f"B12-int8 launched {launches['flash_paged_decode_attend_quant']} "
                             f"times, not 16 layers x {passes} target passes")
    if out["stats"]["tokens_per_step"] < 1.8:
        raise AssertionError(f"snapkv serve acceptance collapsed: "
                             f"{out['stats']['tokens_per_step']} tokens/step")
    t0 = time.perf_counter()
    contig = contiguous_serve(SNAPKV_SERVE_ARGV, out["prompts"])
    print("[serve snapkv] " + _same_tokens("PagedServingEngine against ServingEngine",
                                           out["outputs"], contig)
          + f" (contiguous serve {time.perf_counter() - t0:.1f}s)", flush=True)
    return launches


# C2: served == solo (the JAX package's contract, tests/test_paged_serving.py
# _solo) at the serving path's widths: 16 slots, an int8 pool of 512-row
# pages, 2 requests of 2048-token prompts (one admission bucket; the 4 of
# earlier runs cut to 2 for the time limit)
SOLO_ARGV = ["--paged", "--slots", "16", "--num_requests", "2", "--prefix_len", "2048",
             "--max_len", "4096", "--page_size", "512", "--kv_quant", "int8"]


# the dense A/B: profile_decode at the bench's default shapes, target phases
AB_ARGV = ["--B", "32", "--ctx", "8192", "--kv_quant", "int8",
           "--phases", "baseline_step_ms,verify_step_ms,noctx_step_ms"]
APPEND_ARGV = ["--which", "append"]


def _first_diffs(outs, refs):
    """{request: first differing token} over the tokens both runs committed.
    Where one run commits more, it is the last window's acceptance, which
    the draft's row count steers; every committed token is the target's."""
    diffs = {}
    for i, (o, r) in enumerate(zip(outs, refs)):
        n = min(len(o), len(r))
        j = next((j for j in range(n) if o[j] != r[j]), None)
        if j is not None:
            diffs[i] = j
    return diffs


def solo_phase(torch):
    """C2: each served request against (a) the same prompt served alone
    through the same 16 slots and (b) a B=1 ``SpecEngine.generate`` on the
    same prompt and weights, for a stream of ``SOLO_ARGV``'s 2 equal-length
    prompts (one admission bucket: its prefill runs at 2x the chunk's rows; distinct
    lengths: (24)).  Where tokens differ at the live row counts, the check
    runs again at a fixed row count: the served stream with each request's
    prefill alone (a bucket of one), and the B=1 engine's target passes at
    the 16 slots' decode_rows and decode split plan; it fails unless they
    then agree.  Returns a summary per (stream, reference)."""
    import dataclasses
    import functools

    import numpy as np

    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.engine.engine import SpecEngine
    from magicdec_tpu_torch.kernels import decode_attention as DA

    args = serving_bench.parse_args(SOLO_ARGV)
    engine, _ = serving_bench.setup(args)
    slots, V, P = args.slots, engine.cfg.vocab_size, args.prefix_len
    rng = np.random.RandomState(11)
    n = args.num_requests
    streams = {f"one bucket of {n} equal-length prompts":
               [rng.randint(0, V, P).astype(np.int32) for _ in range(n)]}
    b1 = SpecEngine(engine.params, engine.cfg, engine.ecfg, device=engine.device)

    def serve(prompts, one_bucket_each=False):
        admit = engine.admit_many
        if one_bucket_each:  # every request's prefill alone
            engine.admit_many = lambda sst, wave: functools.reduce(
                lambda st, adm: admit(st, [adm]), wave, sst)
        try:
            outs = engine.serve(prompts, B=slots, windows_per_sync=args.windows_per_sync)
        finally:
            vars(engine).pop("admit_many", None)
        return outs, engine.last_serve_stats

    def solo_b1(prompt, fixed_rows=False):
        split_plan, quant_split_plan = DA.split_plan, DA.quant_split_plan
        if fixed_rows:  # the serving pass's rows and decode split plans
            b1._hinted = lambda B: dataclasses.replace(
                b1.cfg, decode_rows=slots * (b1.ecfg.gamma + 1))
            DA.split_plan = lambda B, Hkv, S, hd=64: split_plan(slots, Hkv, S, hd)
            DA.quant_split_plan = lambda B, Hkv, S, hd=64: quant_split_plan(slots, Hkv, S, hd)
        try:
            _, stats = b1.generate(b1.encode(prompt[None]))
        finally:
            vars(b1).pop("_hinted", None)
            DA.split_plan, DA.quant_split_plan = split_plan, quant_split_plan
        n = int(stats["num_committed"][0])
        return stats["output"][0, :n].cpu().numpy()

    summary = {}
    for stream, prompts in streams.items():
        t0 = time.perf_counter()
        served, st = serve(prompts)
        if stream.startswith("one bucket") and st["admission_waves"] != 1:
            raise AssertionError(f"C2 {stream}: admitted in {st['admission_waves']} waves")
        refs = {"served alone through the same 16 slots":
                lambda fixed: [serve([p])[0][0] for p in prompts],
                "a B=1 SpecEngine": lambda fixed: [solo_b1(p, fixed) for p in prompts]}
        for ref_name, make_ref in refs.items():
            ref = make_ref(False)
            diffs = _first_diffs(served, ref)
            if not diffs:
                line = f"all {n} requests agree on every token both committed"
                if any(len(o) != len(r) for o, r in zip(served, ref)):
                    line += (f" (token counts {[len(o) for o in served]} served, "
                             f"{[len(r) for r in ref]} in the reference)")
            else:
                line = (f"DIFFER at the live row counts: requests {sorted(diffs)}, first "
                        f"differing tokens {diffs} (of {[len(o) for o in served]} tokens)")
                fixed = _first_diffs(serve(prompts, one_bucket_each=True)[0], make_ref(True))
                if fixed:
                    raise AssertionError(f"C2 {stream} against {ref_name}: {line}; still "
                                         f"differ at a fixed row count: {fixed}")
                line += f"; at a fixed row count all {n} agree on every token"
            summary[(stream, ref_name)] = line
            print(f"[C2] {stream}, against {ref_name}: {line}", flush=True)
        print(f"[C2] {stream}: {time.perf_counter() - t0:.1f}s", flush=True)
    del engine, b1
    torch.cuda.empty_cache()
    return summary


# (24) sampled serving: 4 requests of distinct lengths in [1024, 2048]
# through 8 slots over an int8 pool, temperature 0.8, top-p 0.9 (the 8
# requests of earlier runs cut to 4 for the time limit)
SAMPLED_SERVE_ARGV = ["--paged", "--kv_quant", "int8", "--temperature", "0.8", "--top_p", "0.9",
                      "--slots", "8", "--num_requests", "4", "--prefix_len", "2048", "--ragged",
                      "--seed", "31", "--max_len", "4096", "--page_size", "512", "--skip_warmup"]


def sampled_serving_phase(torch, wrappers):
    """(24) ``serving_bench`` with SAMPLED_SERVE_ARGV (exact speculative
    sampling, llama-3.2-1b, the int8 pool; the key of ``--seed``, each
    request's id its salt), the counters zeroed just before and read just
    after.  Each request's tokens must equal its prompt alone through a
    B=1 ``SpecEngine`` with that salt (and reach 1.8 tokens per step, the
    serving paths' floor), at the served passes' row count as
    C2 fixes it (the prompts' lengths are distinct, so each prefill runs
    alone; the B=1 verify at the 8 slots' decode_rows and decode split
    plans, its encode as an admission's); S1 launched once a head: (gamma
    + 1) a window and one token0 an admission.  Returns the launches."""
    import dataclasses

    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.engine.engine import SpecEngine
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import sampling as S1
    from magicdec_tpu_torch.utils.seeding import sampling_rng

    _zero_counts(wrappers)
    t0 = time.perf_counter()
    out = serving_bench.main(SAMPLED_SERVE_ARGV)
    wall = time.perf_counter() - t0
    launches = _read_counts(wrappers)
    st = out["stats"]
    print(f"[sampled serve] wall={wall:.1f}s launches={launches}", flush=True)
    print("[sampled serve] " + _serving_summary(out), flush=True)
    prompts = out["prompts"]
    lens = [len(p) for p in prompts]
    if len(set(lens)) != len(lens):
        raise AssertionError(f"(24): the prompt lengths are not distinct: {lens}")
    args = serving_bench.parse_args(SAMPLED_SERVE_ARGV)
    heads = (args.gamma + 1) * st["windows"] + len(prompts)
    if launches[S1.gumbel_argmax.__name__] != heads:
        raise AssertionError(f"(24): S1 launched {launches[S1.gumbel_argmax.__name__]} times, "
                             f"not {heads} ({st['windows']} windows, {len(prompts)} admissions)")
    engine, _ = serving_bench.setup(args)
    b1 = SpecEngine(engine.params, engine.cfg, engine.ecfg, device=engine.device)
    del engine
    slots, key = args.slots, sampling_rng(args, b1.device)
    split_plan, quant_split_plan = DA.split_plan, DA.quant_split_plan
    refs = []
    t0 = time.perf_counter()
    for rid, prompt in enumerate(prompts):
        st1 = b1.encode(prompt[None], rng=key, salt=[rid])
        b1._hinted = lambda B: dataclasses.replace(b1.cfg, decode_rows=slots * (b1.ecfg.gamma + 1))
        DA.split_plan = lambda B, Hkv, S, hd=64: split_plan(slots, Hkv, S, hd)
        DA.quant_split_plan = lambda B, Hkv, S, hd=64: quant_split_plan(slots, Hkv, S, hd)
        try:
            _, stats = b1.generate(st1)
        finally:
            vars(b1).pop("_hinted", None)
            DA.split_plan, DA.quant_split_plan = split_plan, quant_split_plan
        refs.append(stats["output"][0, :int(stats["num_committed"][0])].cpu().numpy())
    diffs = _first_diffs(out["outputs"], refs)
    counts = ([len(o) for o in out["outputs"]], [len(r) for r in refs])
    print(f"[sampled serve] against B=1 SpecEngine runs by salt ({time.perf_counter() - t0:.1f}s):"
          f" first differing tokens {diffs}, token counts {counts[0]} served, {counts[1]} "
          "alone", flush=True)
    if diffs:
        raise AssertionError(f"(24): sampled served != solo by salt: requests {sorted(diffs)}")
    if st["tokens_per_step"] < 1.8:
        raise AssertionError(f"(24): acceptance collapsed, {st['tokens_per_step']} tokens/step")
    del b1
    torch.cuda.empty_cache()
    return launches


def dense_ab_phase(torch, wrappers):
    """The dense A/B: ``profile_decode`` at B=32, ctx 8192, the int8 cache,
    phases baseline, verify and noctx, without then with --dense_kernels
    (the turns off, on, on, off of earlier runs: a depth cut for the time
    limit); B15 must launch in the dense run only.  Then
    ``kernel_benchmark --which append``: K3q's merged launch against B14's
    four per-array launches.  Returns the figures."""
    from magicdec_tpu_torch import kernel_benchmark, profile_decode
    from magicdec_tpu_torch.kernels import dense_matmul as DK

    runs = {"cuBLAS": [], "B15": []}
    for dense in (False, True):
        for w in wrappers:
            w.launches = 0
        r = profile_decode.main(AB_ARGV + (["--dense_kernels"] if dense else []))
        used = DK.dense_matmul_fused.launches + DK.dense_mlp.launches
        if bool(used) != dense:
            raise AssertionError(f"profile_decode dense={dense}: {used} B15 launches")
        runs["B15" if dense else "cuBLAS"].append(r)
        torch.cuda.empty_cache()
    for phase in runs["B15"][0]:
        print(f"[A/B] {phase}: cuBLAS {[round(r[phase], 4) for r in runs['cuBLAS']]} ms, "
              f"B15 {[round(r[phase], 4) for r in runs['B15']]} ms", flush=True)
    append = kernel_benchmark.main(APPEND_ARGV)
    print(f"[A/B] appends (B=32, 16 layers, int8 rows and f32 scales): {append}", flush=True)
    return {"profile_decode": runs, "append": append}


def bf16_scale_serving_phase(torch, wrappers, kernels):
    """``serving_bench`` with SERVE_ARGV, ``--kv_scale bf16`` and an int8,
    then an int4 pool, 2 requests each (a depth cut for the time limit; 4
    in earlier runs),
    no warmup: B12, B13, K2q or B11 and
    K3q on their bf16-scale instances alone, B12 once a layer per target
    pass, each serve's tokens equal to ``ServingEngine``'s on the same
    prompts.  Returns the bf16-scale launches of B12 and B13."""
    DA, PA, AP, PGA = (kernels[n] for n in ("DA", "PA", "AP", "PGA"))
    draft = [DA.flash_decode_attend, AP.append_all_rows_inplace]
    result = {}
    for fmt, paged, prefill in (("int8", PGA.flash_paged_decode_attend_quant,
                                 PA.flash_prefill_attend_quant),
                                ("int4", PGA.flash_paged_decode_attend_quant4,
                                 PA.flash_prefill_attend_quant4)):
        extra = ["--kv_quant", fmt, "--kv_scale", "bf16", "--skip_warmup", "--num_requests", "2"]
        own = [paged, prefill, AP.append_all_rows_inplace_quant, PGA.append_paged_rows_inplace]
        out, launches, peak = serving_path(
            torch, wrappers, own + draft, paged, extra,
            forbidden=[w for w in (PGA.flash_paged_decode_attend,
                                   PGA.flash_paged_decode_attend_quant,
                                   PGA.flash_paged_decode_attend_quant4) if w is not paged])
        _all_on_bf16_scales(f"serve {fmt} bf16 scales", launches, own)
        t0 = time.perf_counter()
        contig = contiguous_serve(SERVE_ARGV + extra, out["prompts"])
        print(f"[serve {fmt} bf16 scales] " + _same_tokens(
            "PagedServingEngine against ServingEngine", out["outputs"], contig)
            + f" (contiguous serve {time.perf_counter() - t0:.1f}s); peak {peak:.2f} GiB",
            flush=True)
        # the paged kernels' counts (the bench paths count the contiguous ones)
        result.update({f"{w.__name__} {BF16S}": launches[f"{w.__name__} {BF16S}"]
                       for w in (paged, PGA.append_paged_rows_inplace)})
    return result


def grouped_int8_engine_phase(torch, wrappers):
    """A short ``SpecEngine`` run on group-wise int8 verify weights,
    ``quantize_params(make_params(cfg), bits=8, group_size=GROUP8)`` at the
    full llama-3.2-1b widths (the draft shares them): B=4, prefix 2048,
    max_gen 32, the int8 cache on bf16 scales and every append as B14's
    per-array calls (``MAGICDEC_PER_ARRAY_APPEND``).  Fails unless greedy
    spec == AR on every committed token, B4 and B6 launched on the grouped
    weights (their row counts printed), B5 and B9 idle (they decline G > 1),
    and B14's scale appends ran on bf16 scales alone.  Returns the
    launches."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    dev = torch.device("cuda")
    cfg = ModelConfig.from_name("llama-3.2-1b")
    params = Q.quantize_params(make_params(cfg, device=dev), bits=8, group_size=GROUP8)
    B, prefix, max_gen = 4, 2048, 32
    ecfg = EngineConfig(mode="streamingllm", gamma=3, draft_budget=513, max_seq_len=2560,
                        chunk_size=128, prefill_chunk_size=512, max_gen=max_gen, eot_ids=(-1,),
                        cache_dtype=torch.bfloat16, kv_quant="int8",
                        kv_scale_dtype=torch.bfloat16, draft_quant=False)
    prompt = torch.randint(0, cfg.vocab_size, (B, prefix), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    rows = {"quant_matmul_fused": {}, "quant_matmul": {}}
    originals = {n: getattr(QK, n) for n in rows}

    def spy_of(name, fn):
        def spy(x, q, scale, *a, **kw):
            spy.launches = spy.m128_launches = 0
            out = fn(x, q, scale, *a, **kw)
            if spy.launches:  # the wrapper counted on this spy: pass it on
                fn.launches += spy.launches
                key = (x.shape[0], scale.shape[0])  # (rows, scale groups)
                rows[name][key] = rows[name].get(key, 0) + 1
            fn.m128_launches += spy.m128_launches
            return out
        spy.launches = spy.m128_launches = 0
        return spy

    env = os.environ.get("MAGICDEC_PER_ARRAY_APPEND")
    os.environ["MAGICDEC_PER_ARRAY_APPEND"] = "1"
    for name, fn in originals.items():
        setattr(QK, name, spy_of(name, fn))
    try:
        engine = SpecEngine(params, cfg, ecfg, device=dev)
        _zero_counts(wrappers)
        st, stats = engine.generate(engine.encode(prompt))
        spec_out, committed = stats["output"].cpu().numpy(), stats["num_committed"].cpu().numpy()
        steps = int(stats["target_steps"])
        tps = float(stats["gen_tokens"].sum()) / max(steps, 1) / B
        del st
        st, bstats = engine.generate_baseline(engine.encode_baseline(prompt), max_new=max_gen)
        base_out = bstats["output"].cpu().numpy()
        del st, engine
        torch.cuda.synchronize()
        launches = _read_counts(wrappers)
    finally:
        for name, fn in originals.items():
            setattr(QK, name, fn)
        if env is None:
            os.environ.pop("MAGICDEC_PER_ARRAY_APPEND")
        else:
            os.environ["MAGICDEC_PER_ARRAY_APPEND"] = env
    tag = f"group-wise int8 target (group {GROUP8})"
    print(f"[{tag}] B={B} prefix={prefix}: {tps:.3f} tokens/step; launches by (rows, scale "
          f"groups): " + ", ".join(f"{n} {dict(sorted(r.items()))}" for n, r in rows.items()),
          flush=True)
    print(f"[{tag}] " + _agreement(spec_out, committed, base_out, max_gen), flush=True)
    for name, r in rows.items():
        if not any(g > 1 for _, g in r):
            raise AssertionError(f"{tag}: {name} never launched on the group-wise weights")
    for name in ("quant_layer_tail", "quant_mlp"):
        if launches[name]:
            raise AssertionError(f"{tag}: {name} launched on group-wise weights")
    _all_on_bf16_scales(tag, launches, [AP.append_scale_rows_inplace])
    del params
    torch.cuda.empty_cache()
    return launches


def row_invariance_phase(torch, B=32, dense=False, quantize=None, group_size=None):
    """Is a target row computed the same at verify (M = B*(gamma+1) rows) as
    at the AR step (M = B)?  At the bench's widths, each target dot alone,
    then two layers and the head: the logits of a 4-token verify window
    (``forward_target``'s and SnapKV's ``forward_verify_snapkv``, which must
    share its target pass) against 4 single-token steps, with the dots at
    the live row count and padded to decode_rows.  ``dense``: the model part with the target's
    bf16 dots on B15 (``quantization.set_dense_kernels``), which must
    launch; the dots alone are cuBLAS's and are skipped.  ``quantize``
    ('int8'): the model part on ``bench --quantize``'s target weights, its
    dots on B4 / B9 / B6, which must launch; with ``group_size``, on
    ``quantize_params(make_params(cfg), bits=8, group_size=group_size)``,
    its dots on B4 and B6 (B9 declines group-wise weights and must not
    launch)."""
    import dataclasses

    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.bench import make_params, make_params_quantized
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.kernels import dense_matmul as DK
    from magicdec_tpu_torch.kernels import quant_matmul as QK
    from magicdec_tpu_torch.models import llama as M

    dev = torch.device("cuda")
    cfg = dataclasses.replace(ModelConfig.from_name("llama-3.2-1b"), n_layer=2)
    if group_size:
        params = M.fuse_exec_params(Q.quantize_params(make_params(cfg, device=dev), bits=8,
                                                      group_size=group_size), cfg)
    elif quantize:
        params = make_params_quantized(cfg, 8 if quantize == "int8" else 4, device=dev)
    else:
        params = M.fuse_exec_params(make_params(cfg, device=dev), cfg)
    T, S, P = 4, 1024, 512
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (cfg.n_layer, B, S, cfg.n_kv_head * cfg.head_dim)
    caches = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev) for n in "kv"}
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    M.forward_target(params, cfg, prompt, torch.zeros(B, dtype=torch.int32, device=dev),
                     caches, head="none")
    # each dot alone on random rows: the verify pass's B*T-row operand against
    # the AR step's B rows, given as the model gives them (contiguous) and as
    # a strided view of the window (x[:, t])
    dots = {n: params["layers"][n][0] for n in ("wqkv", "wo", "w13", "w2")}
    dots["lm_head"] = params["lm_head"]
    for name, w in ({} if dense or quantize else dots).items():
        x = torch.randn((B, T, w.shape[0]), generator=gen, device=dev).to(torch.bfloat16)
        counts = []

        def dot(a, rows):
            """a [B, t, In] @ w with the rows padded to ``rows`` (0: live)."""
            n = a.shape[0] * a.shape[1]
            return M.matmul(M.pad_rows(a, rows), w)[:n].reshape(*a.shape[:2], -1)

        for rows in (0, B * T):
            verify = dot(x, rows)
            for contiguous in (True, False):
                ar = [x[:, t:t + 1] for t in range(T)]
                ar = [a.contiguous() if contiguous else a for a in ar]
                ar = torch.cat([dot(a, rows) for a in ar], dim=1)
                counts.append(int((verify != ar).sum()))
        print(f"[rows] dot {name} {tuple(w.shape)}: outputs that differ in bits between "
              f"verify and AR (contiguous / strided AR operand): live rows "
              f"{counts[0]} / {counts[1]}, padded to {B * T} rows {counts[2]} / "
              f"{counts[3]}, of {B * T * w.shape[1]}", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    lens = torch.full((B,), P, dtype=torch.int32, device=dev)
    tag = (" (B15 dense dots)" if dense else "") + (f" ({quantize} target weights)"
                                                     if quantize else "")
    tag += f" (group {group_size})" if group_size else ""
    quant_dots = ((QK.quant_matmul_fused, QK.quant_matmul) if group_size
                  else (QK.quant_matmul_fused, QK.quant_mlp, QK.quant_matmul)
                  if quantize == "int8"
                  else (QK.quant_matmul_fused_int4, QK.quant_matmul_int4) if quantize else ())
    for fn in (DK.dense_matmul_fused, DK.dense_mlp, QK.quant_mlp) + quant_dots:
        fn.launches = 0
    Q.set_dense_kernels(dense)
    dshape = (cfg.n_layer, B, 640, cfg.n_kv_head * cfg.head_dim)
    dfill = torch.full((B,), 513, dtype=torch.int32, device=dev)
    try:
        for rows in (0, B * T):
            hcfg = dataclasses.replace(cfg, decode_rows=rows)
            c = {n: t.clone() for n, t in caches.items()}
            verify, _ = M.forward_target(params, hcfg, tokens, lens, c, head="logits")
            c = {n: t.clone() for n, t in caches.items()}
            ar = torch.cat([M.forward_target(params, hcfg, tokens[:, t:t + 1], lens + t, c,
                                             head="logits")[0] for t in range(T)], dim=1)
            # SnapKV's verify (the target pass and the dual append into a
            # 640-row draft cache at fill 513)
            c = {n: t.clone() for n, t in caches.items()}
            c.update({n: torch.zeros(dshape, dtype=torch.bfloat16, device=dev)
                      for n in ("dk", "dv")})
            snap, _ = M.forward_verify_snapkv(params, hcfg, tokens, lens, dfill, c,
                                              head="logits")
            del c
            differ = int((verify != ar).any(-1).sum())
            differ_snap = int((snap != ar).any(-1).sum())
            print(f"[rows] B={B} decode_rows={rows}{tag}: {differ} of {B * T} target rows "
                  f"differ in bits between verify and AR, {int((verify != ar).sum())} of "
                  f"{ar.numel()} logits; the snapkv verify: {differ_snap} rows, "
                  f"{int((snap != ar).sum())} logits", flush=True)
            if rows and differ_snap:
                raise AssertionError(f"B={B}{tag}: the snapkv verify's target rows differ "
                                     "from AR even with the dots padded to decode_rows")
            if rows and differ:
                # the engine runs its target passes at decode_rows = B * (gamma + 1)
                # and rests on this for greedy spec == AR
                raise AssertionError(f"B={B}{tag}: target rows differ between verify and AR "
                                     "even with the dots padded to decode_rows")
    finally:
        Q.set_dense_kernels(False)
    if dense and not (DK.dense_matmul_fused.launches and DK.dense_mlp.launches):
        raise AssertionError(f"B={B}: the padded passes never launched B15")
    if not all(fn.launches for fn in quant_dots):
        raise AssertionError(f"B={B}{tag}: the passes never launched "
                             f"{[fn.__name__ for fn in quant_dots if not fn.launches]}")
    if group_size and QK.quant_mlp.launches:
        raise AssertionError(f"B={B}{tag}: B9 launched on group-wise weights")
    del params, caches


def _device_ms(event):
    t = getattr(event, "self_device_time_total", None)
    return (t if t is not None else event.self_cuda_time_total) / 1e3


def _profiled(torch, calls, attempts=8, want=1):
    """(kernel launches a call, device ms a call, kernel names) of ``calls``
    under torch.profiler, after one unprofiled pass.  The profiler now and
    then loses a run's events on the card (fewer kernels than the ``want``
    a call, never more; once three runs in a row, for 16 draft-attention
    calls of 18 us each; eight in a row, one of 16 B4 calls at
    M=64): such a run is profiled again, at most ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls:
        call()
    torch.cuda.synchronize()
    for _ in range(attempts):
        # a short spin kernel before and after the calls, not counted: a
        # run's first or last event is the one the profiler loses
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for call in calls:
                call()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "spin" not in e.key]
        launches = sum(e.count for e in kern)
        if launches >= want * len(calls):
            break
        print(f"[profiler] {launches} of {want * len(calls)} kernels seen: profiling again",
              flush=True)
    return (launches / len(calls), sum(_device_ms(e) for e in kern) / len(calls),
            {e.key[:60] for e in kern})


# The wrappers whose kernel is one launch a call (the profiler must count 1),
# with what the kernel's name holds
ONE_LAUNCH = {"quant_matmul_fused": "qmm_sm90_kernel<false",
              "quant_matmul": "qmm_sm90_kernel<false",
              "quant_layer_tail": "ffn_sm90_kernel",      # B5: the mma.sync core
              "quant_mlp": "ffn_wg_sm90_kernel",          # B9 at 256 rows: the wgmma core
              "quant_matmul_fused_int4": "qmm_sm90_kernel<true",
              "quant_matmul_int4": "qmm4_sm90_kernel",
              "dense_matmul_fused": "dmm_sm90_kernel",
              "dense_mlp": "ffn_bf16_sm90_kernel"}      # B15's FFN: the bf16 instance


def _one_launch(torch, name, label, calls, kernel=""):
    """The profiler's kernel launches a call of ``calls`` (one a call, of a
    kernel whose name holds ``kernel``, or the run fails), its device ms a
    call and the kernels' names."""
    per_call, prof_ms, kernels = _profiled(torch, calls)
    print(f"[kernel] {name} {label}: profiler: {per_call:g} kernel launches a call, "
          f"device ms a call {prof_ms:.4f} ({', '.join(sorted(kernels))})", flush=True)
    if per_call != 1 or not all(kernel in k for k in kernels):
        raise AssertionError(f"{name} {label}: {per_call} kernel launches a call "
                             f"({sorted(kernels)}), not one {kernel or 'kernel'}")
    return {"launches_per_call": per_call, "profiler_device_ms": prof_ms,
            "kernel": sorted(kernels)}


def _decode_sm90_launches(torch, name, label, calls, nsplit):
    """K1, K1q, B10 and B12 (each pool): the profiler must see one launch of
    ``decode_sm90_kernel`` a call, and one of ``combine_kernel`` when the
    plan has more than one split, and nothing else."""
    want = 2 if nsplit > 1 else 1
    per_call, prof_ms, kernels = _profiled(torch, calls, want=want)
    print(f"[kernel] {name} {label}: profiler: {per_call:g} kernel launches a call "
          f"({nsplit} splits), device ms a call {prof_ms:.4f} ({', '.join(sorted(kernels))})",
          flush=True)
    names = {"decode_sm90_kernel"} | ({"combine_kernel"} if nsplit > 1 else set())
    if per_call != want or {n for n in names if any(n in k for k in kernels)} != names \
            or not all(any(n in k for n in names) for k in kernels):
        raise AssertionError(f"{name} {label}: {per_call} kernel launches a call "
                             f"({sorted(kernels)}), not {want} of {sorted(names)}")
    return {"launches_per_call": per_call, "profiler_device_ms": prof_ms,
            "kernel": sorted(kernels)}


def _window_equals_steps(torch, name, fn, caches, layer, q, base, fresh):
    """Token t of a window (its fresh rows read at [base, base + T)) bit for
    bit against the T = 1 step at base + t over layer ``layer`` holding the
    window's rows before t, with fresh row t; caches (k, v) in bf16 or (k,
    k_scale, v, v_scale) quantized."""
    one = [c[layer:layer + 1] for c in caches]
    window = fn(q, *one, base, layer=0, **fresh)
    T = q.shape[1]
    for t in range(T):
        step_caches = [c.clone() for c in one]
        for b, n in enumerate(base.tolist()):
            step_caches[0][0, b, n:n + t] = fresh["k_new"][b, :t]
            step_caches[-2 if len(one) == 4 else 1][0, b, n:n + t] = fresh["v_new"][b, :t]
            if len(one) == 4:
                step_caches[1][0, b, :, n:n + t] = fresh["ks_new"][b, :, :t]
                step_caches[3][0, b, :, n:n + t] = fresh["vs_new"][b, :, :t]
        step_fresh = {n: f[:, :, t:t + 1].contiguous() if n in ("ks_new", "vs_new")
                      else f[:, t:t + 1] for n, f in fresh.items()}
        step = fn(q[:, t:t + 1], *step_caches, base + t, layer=0, **step_fresh)
        if not torch.equal(window[:, t:t + 1], step):
            raise AssertionError(f"{name}: token {t} of the T={T} window differs in bits from "
                                 f"the T=1 step at base + {t}")
        del step_caches
    print(f"[kernel] {name}: every token of a T={T} window bit-equal to its T=1 step "
          f"({len(base)} requests, ragged lengths)", flush=True)


def _instance(mangled):
    """A decode_sm90_kernel instance's template arguments in words (the
    mangled name, any other kernel's, as it is)."""
    import re

    m = re.search(r"decode_sm90_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)ELb(\d)ELi(\d+)E", mangled)
    if m is None:
        return mangled
    fmt, heads, tiles, paged, bf16s, hd = m.groups()
    return (f"decode_sm90_kernel<{('int8', 'int4', 'bf16')[int(fmt)]}, {heads} kv head(s) a "
            f"block, {tiles} row tile(s) a warp, {'paged' if paged == '1' else 'contiguous'}"
            f"{', bf16 scales' if bf16s == '1' else ''}, head dim {hd}>")


def _kernel_class(name):
    if "qmm4" in name or "qmm_sm90_kernel<true" in name or "qmm_m128_kernel<2" in name:
        return "int4 dots (B4/B6-int4)"
    if "qmm" in name or "ffn_" in name:
        return "int8 dots (B4/B5/B6) and split-K epilogues"
    if "md::" in name or "combine_kernel" in name or "append_rows_kernel" in name:
        return "port kernels"
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "cuBLAS GEMM"
    return "other PyTorch ops"


def profile_phase(torch, argv=(), pad_pairs=True, spec_only=False):
    """Spec generate and AR generate at the bench's shapes with ``argv``:
    host-clock wall time, then a profiled run for the device's busy time and
    the kernels that take it, then whether the spec and AR tokens agree;
    ``pad_pairs``: then the AR step padded against its live rows;
    ``spec_only``: spec generate alone (its AR is another path's)."""
    from torch.profiler import ProfilerActivity, profile

    from magicdec_tpu_torch import bench
    from magicdec_tpu_torch.models import llama as M

    args = bench.parse_args(list(argv))
    tag = " ".join(argv) or "defaults"
    engine, prompts = bench.setup(args)
    prompt = prompts[0]
    # the host time the engine spends issuing draft steps (no sync inside)
    draft_s = [0.0]
    forward_draft = M.forward_draft

    def timed_draft(*a, **kw):
        t0 = time.perf_counter()
        out = forward_draft(*a, **kw)
        draft_s[0] += time.perf_counter() - t0
        return out
    runs = (("spec", engine.encode, engine.generate),
            ("AR", engine.encode_baseline, engine.generate_baseline))[:1 if spec_only else 2]
    outputs = {}
    for name, encode, generate in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = encode(prompt)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        draft_s[0] = 0.0
        M.forward_draft = timed_draft
        t0 = time.perf_counter()
        try:
            st, stats = generate(st)
            torch.cuda.synchronize()
        finally:
            M.forward_draft = forward_draft
        wall_ms = (time.perf_counter() - t0) * 1e3
        outputs[name] = {k: v.cpu().numpy() for k, v in stats.items()}
        del st
        st = encode(prompt)
        torch.cuda.synchronize()
        # device activity only: the host-side op events, which nothing here
        # reads, made the trace's post-processing the slowest phase of the run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            st, _ = generate(st)
            torch.cuda.synchronize()
        del st
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_device_ms(e) for e in kern)
        if not kern or busy <= 0:
            raise AssertionError(f"the profiler saw no device time ({tag}, {name})")
        steps = (int(stats["target_steps"]) if name == "spec"
                 else int(stats["num_committed"][0]) - 1)
        by_class = {}
        for e in kern:
            c = _kernel_class(e.key)
            by_class[c] = by_class.get(c, 0.0) + _device_ms(e)
        print(f"[profile {tag}] {name}: encode {encode_s:.2f}s; generate "
              f"wall {wall_ms:.1f} ms over {steps} {'windows' if name == 'spec' else 'steps'} "
              f"({wall_ms / steps:.2f} ms each); device busy {busy:.1f} ms "
              f"({busy / wall_ms:.1%} of the wall, idle {1 - busy / wall_ms:.1%}); "
              + ", ".join(f"{c} {t:.1f} ms" for c, t in sorted(by_class.items())),
              flush=True)
        if name == "spec":
            print(f"[profile {tag}] spec: host time issuing draft steps "
                  f"{draft_s[0] * 1e3:.1f} ms ({draft_s[0] * 1e3 / steps:.2f} ms per window)",
                  flush=True)
        for e in sorted(kern, key=_device_ms, reverse=True)[:6]:
            print(f"[profile {tag}]   {_device_ms(e):8.2f} ms  x{e.count:<6d} {e.key[:90]}",
                  flush=True)
    if spec_only:
        del engine
        return
    print(f"[profile {tag}] " + _agreement(outputs["spec"]["output"],
                                           outputs["spec"]["num_committed"],
                                           outputs["AR"]["output"], args.max_gen), flush=True)
    if not pad_pairs:
        del engine
        return
    # the cost of the target's decode_rows padding: AR generate from one
    # encoded state with the AR step padded to B * (gamma + 1) rows (the
    # engine's passes) and at its live B rows, four pairs (a depth cut for the
    # time limit), alternating which side runs first
    # (verify passes have B * (gamma + 1) rows already)
    st = engine.encode_baseline(prompt)
    walls = {"padded": [], "live": []}
    for i in range(PAD_PAIRS):
        for label in (("padded", "live") if i % 2 == 0 else ("live", "padded")):
            if label == "live":
                engine._hinted = lambda B: engine.cfg
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stats = engine.generate_baseline(st)
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
            vars(engine).pop("_hinted", None)
    steps = int(stats["num_committed"][0]) - 1
    wins = sum(p < q for p, q in zip(walls["padded"], walls["live"]))
    quart = {k: [sorted(v)[i] / steps for i in (0, PAD_PAIRS // 2, PAD_PAIRS - 1)]
             for k, v in walls.items()}
    print(f"[pad] AR generate wall over {steps} steps, {PAD_PAIRS} alternating pairs: padded to "
          f"decode_rows {[round(t, 1) for t in walls['padded']]} ms, live rows "
          f"{[round(t, 1) for t in walls['live']]} ms; per step (least, median, most) "
          f"padded {[round(t, 2) for t in quart['padded']]} ms, live "
          f"{[round(t, 2) for t in quart['live']]} ms; padded faster in {wins} of {PAD_PAIRS} "
          "pairs", flush=True)
    del st, engine


# (25) the perplexity driver at llama-3.2-1b: 8 windows of 2048 tokens of
# the synthetic corpus, 4 a batch, 512-token chunks (K2 over the bf16 cache,
# K2q over int8, B11 over int4, K3 / K3q at T = 512; the quantized weights'
# dots run at 4 x 512 rows, above the quantized kernels' 256-row cap)
PPL_ARGV = ["--seq_len", "2048", "--num_seqs", "8", "--B", "4", "--chunk", "512",
            "--device", "cuda"]
# (25)'s gates: the JAX package's (tests/test_quality.py); kv_int4 has none
PPL_GATES = {"kv_int8": 0.01, "kv_int4": None, "int8": 0.02}


def perplexity_phase(torch, wrappers, kernels):
    """(25) ``perplexity_benchmark.main`` with ``--compare kv_int8``,
    ``kv_int4`` and ``int8`` (``PPL_ARGV``), the launch counters zeroed just
    before each and read just after.  Fails unless the NLL drifts stay
    within ``PPL_GATES``, every NLL is finite, K2 launched in each run, K2q
    under kv_int8 and B11 under kv_int4, and the bf16 NLL equals a direct
    ``quality.perplexity`` call on the driver's own params and windows to
    1e-6 relative.  Returns {compare: launches}."""
    from magicdec_tpu_torch import perplexity_benchmark as PB
    from magicdec_tpu_torch.quality import perplexity

    DA, PA, AP, QK = kernels["DA"], kernels["PA"], kernels["AP"], kernels["QK"]
    need = {"kv_int8": PA.flash_prefill_attend_quant, "kv_int4": PA.flash_prefill_attend_quant4,
            "int8": PA.flash_prefill_attend}
    named = [PA.flash_prefill_attend, PA.flash_prefill_attend_quant,
             PA.flash_prefill_attend_quant4, AP.append_all_rows_inplace,
             AP.append_all_rows_inplace_quant, QK.quant_matmul_fused, QK.quant_matmul,
             QK.quant_mlp, DA.flash_decode_attend]
    counts, bf16_nll = {}, None
    for compare, gate in PPL_GATES.items():
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        out = PB.main(PPL_ARGV + ["--compare", compare])
        wall = time.perf_counter() - t0
        launches = counts[compare] = _read_counts(wrappers)
        runs = out["runs"]
        (full, q), = [(runs["bf16"], r) for k, r in runs.items() if k != "bf16"]
        drift = abs(q["nll"] - full["nll"]) / full["nll"]
        print(f"[ppl {compare}] wall {wall:.1f} s; " + "; ".join(
            f"{k}: nll {r['nll']:.6f} ppl {r['ppl']:.6g} ({r['seconds']:.2f} s)"
            for k, r in runs.items())
            + f"; drift {drift:.4%} (gate {'none' if gate is None else f'{gate:.0%}'}); "
            "launches " + ", ".join(f"{w.__name__} {launches[w.__name__]}" for w in named),
            flush=True)
        if not all(math.isfinite(r["nll"]) for r in runs.values()):
            raise AssertionError(f"(25) --compare {compare}: a non-finite NLL {runs}")
        if gate is not None and not drift < gate:
            raise AssertionError(f"(25) --compare {compare}: the NLL drifts {drift:.4%}, "
                                 f"over {gate:.0%}")
        for w in (PA.flash_prefill_attend, need[compare]):
            if launches[w.__name__] <= 0:
                raise AssertionError(f"(25) --compare {compare} never launched {w.__name__}")
        if bf16_nll is None:
            bf16_nll = full["nll"]
        del out
    params, cfg, data = PB.setup(PB.parse_args(PPL_ARGV))
    _, direct = perplexity(params, cfg, data, batch_size=4, chunk_size=512)
    rel = abs(direct - bf16_nll) / direct
    print(f"[ppl] the driver's bf16 NLL {bf16_nll:.8f} against a direct quality.perplexity "
          f"call {direct:.8f}: {rel:.2e} relative (gate 1e-6)", flush=True)
    if not rel <= 1e-6:
        raise AssertionError(f"(25) the driver's bf16 NLL is {rel:.2e} from quality.perplexity's")
    del params, data
    torch.cuda.empty_cache()
    return counts


# (26) the reference-protocol drivers at llama-3.2-1b, one batch of 8
# synthetic prompts of 4000 tokens, the int8 cache, no warmup batch (the
# kernels are built and warm); the self-spec run with the bench's draft
# (its int8 copy, budget 513, gamma 3) and --benchmark
DRIVER_ARGV = ["--B", "8", "--prefix_len", "4000", "--max_len", "4096", "--kv_quant",
               "--num_batches", "1", "--warmup_batches", "0", "--device", "cuda"]
SELFSPEC_ARGV = ["--benchmark", "--draft_quant", "--draft_budget", "513", "--gamma", "3"]


def drivers_phase(torch, wrappers, kernels):
    """(26) ``baseline_benchmark.main`` and then ``selfspec_benchmark.main``
    (``DRIVER_ARGV``) on the same batch, the counters zeroed before and read
    after each.  Fails unless the self-spec committed tokens equal the
    baseline's on every row, tokens/step reach 2.2, the autotune's gamma is
    one of its candidates (1..8) with a positive prediction, the baseline
    launched K2q, K1q and K3q, and the self-spec run
    K2q, K1q, K3q, K1, K3, B4, B5 and B6."""
    from magicdec_tpu_torch import baseline_benchmark, selfspec_benchmark

    DA, PA, AP, QK = kernels["DA"], kernels["PA"], kernels["AP"], kernels["QK"]
    target = [PA.flash_prefill_attend_quant, DA.flash_decode_attend_quant,
              AP.append_all_rows_inplace_quant]
    draft = [DA.flash_decode_attend, AP.append_all_rows_inplace, QK.quant_matmul_fused,
             QK.quant_layer_tail, QK.quant_matmul]
    res = {}
    for name, module, argv, required in (
            ("baseline", baseline_benchmark, DRIVER_ARGV, target),
            ("selfspec", selfspec_benchmark, DRIVER_ARGV + SELFSPEC_ARGV, target + draft)):
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        out = module.main(argv)
        wall = time.perf_counter() - t0
        launches = _read_counts(wrappers)
        res[name] = (out, launches)
        print(f"[drivers {name}] wall {wall:.1f} s; {out['tokens_per_s']:.2f} tok/s; launches "
              + ", ".join(f"{w.__name__} {launches[w.__name__]}" for w in target + draft),
              flush=True)
        for w in required:
            if launches[w.__name__] <= 0:
                raise AssertionError(f"(26) {name} never launched {w.__name__}")
        if launches.get("gumbel_argmax"):
            raise AssertionError(f"(26) the greedy {name} launched S1")
    (base, _), (spec, _) = res["baseline"], res["selfspec"]
    sb, bb = spec["batches"][0], base["batches"][0]
    print("[drivers] self-spec against baseline: " + _agreement(
        sb["output"], sb["num_committed"], bb["output"], 80), flush=True)
    print(f"[drivers] self-spec {spec['tokens_per_s']:.2f} tok/s against the baseline's "
          f"{base['tokens_per_s']:.2f} ({spec['tokens_per_s'] / base['tokens_per_s']:.4f}x), "
          f"{spec['tokens_per_step']:.3f} tokens/step; phases (ms) "
          + ", ".join(f"{k} {v:.3f}" for k, v in spec["phases"].items())
          + f"; alpha {spec['alpha']:.3f}, autotuned gamma {spec['gamma']} (predicted "
          f"{spec['predicted_tokens_per_s']:.1f} tok/s)", flush=True)
    if spec["tokens_per_step"] < 2.2:
        raise AssertionError(f"(26) acceptance collapsed: {spec['tokens_per_step']} tokens/step")
    # the JAX driver's pick: pick_gamma's default candidates, 1 included (at
    # B=8 the host-bound draft step costs 65% of a verify, and gamma 1 wins)
    if spec["gamma"] not in (1, 2, 3, 4, 5, 6, 8) or not spec["predicted_tokens_per_s"] > 0:
        raise AssertionError(f"(26) the autotune picked gamma {spec['gamma']} (predicted "
                             f"{spec['predicted_tokens_per_s']} tok/s)")
    torch.cuda.empty_cache()
    return res


def _kernel_wrappers():
    """Every counted kernel wrapper, in the kernels line's groups (``main``'s
    list; a spawned rank builds its own)."""
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import dense_matmul as DK
    from magicdec_tpu_torch.kernels import paged_attention as PGA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.kernels import quant_matmul as QK
    from magicdec_tpu_torch.kernels import sampling as S1

    return [DA.flash_decode_attend, PA.flash_prefill_attend, AP.append_all_rows_inplace,
            DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant,
            AP.append_all_rows_inplace_quant, QK.quant_matmul_fused, QK.quant_layer_tail,
            QK.quant_matmul, QK.quant_mlp, DA.flash_decode_attend_quant4,
            PA.flash_prefill_attend_quant4, QK.quant_matmul_fused_int4, QK.quant_matmul_int4,
            PGA.flash_paged_decode_attend, PGA.flash_paged_decode_attend_quant,
            PGA.flash_paged_decode_attend_quant4, PGA.append_paged_rows_inplace,
            AP.append_rows_inplace, AP.append_scale_rows_inplace, DK.dense_matmul_fused,
            DK.dense_mlp, S1.gumbel_argmax]


def _dot_spy(torch):
    """Wraps ``quantization.quant_matmul``: each outermost call's (rows,
    contraction, output columns, "kernel" or "plain") counted in the returned
    dict (a kernel: some int8 / int4 wrapper launched inside it); the
    returned ``undo`` restores it."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    fns = [getattr(QK, n) for n in ROW_COUNTED]
    dots, depth, routed = {}, [0], Q.quant_matmul

    def spy(x, wq, *a, **kw):
        if depth[0]:
            return routed(x, wq, *a, **kw)
        before = sum(fn.launches for fn in fns)
        depth[0] += 1
        try:
            out = routed(x, wq, *a, **kw)
        finally:
            depth[0] -= 1
        key = (math.prod(x.shape[:-1]), wq.in_features, wq.q.shape[-1],
               "kernel" if sum(fn.launches for fn in fns) > before else "plain")
        dots[key] = dots.get(key, 0) + 1
        return out

    Q.quant_matmul = spy

    def undo():
        Q.quant_matmul = routed

    return dots, undo


# (29) tensor parallelism: selfspec_benchmark at llama-3.1-8b over 2 ranks
# (--model_parallel 2) sharing cuda:0 through gloo, the int8 cache and the
# int8 draft copy, B=8 over 1024-token prompts (2048 before: a depth cut for
# the time limit: gloo's prefill all-reduces cost 1.3 ms a MB on one H100), 32
# tokens; the same arguments at TP 1 (in this process) are the reference
TP_ARGV = ["--model", "llama-3.1-8b", "--kv_quant", "int8", "--draft_quant", "int8", "--B", "8",
           "--prefix_len", "1024", "--max_len", "1152", "--max_gen", "32", "--prefill_chunk",
           "512", "--num_batches", "1", "--warmup_batches", "0"]
TP_MESH = ["--model_parallel", "2", "--dist_backend", "gloo"]
# the largest difference between TP 2's and TP 1's float32 logits at the
# prompts' last position, over the largest |logit| of TP 1, may be at most
# SPREAD_LIMIT; the control (rank 1 keeping its own partial wo product in
# every layer of a prefill, the sum dropped) must exceed it.  Set from the
# card's readings at 2048-token prompts (NVIDIA H100 80GB HBM3, 700 W):
# sound 0.0126, control 0.0681.  A TP token may differ from TP 1's only
# where TP 1's top-two gap is below twice that limit of the largest |logit|
# (each of the two logits moving by at most the limit)
SPREAD_LIMIT = 0.025


def _capture_last_hidden(engine):
    """A list that gets the last prompt position's hidden states [B, D] of
    each of ``engine``'s encodes (its token-0 head's input)."""
    seen, head = [], engine._head_token

    def spy(x_last, *a, **kw):
        seen.append(x_last.clone())
        return head(x_last, *a, **kw)

    engine._head_token = spy
    return seen


def _logits_of(torch, engine, x):
    """The target's whole logits rows for hidden states [B, D], on the
    host, computed in float32 from the bf16 states (the final norm and the
    bf16 lm_head too, so the difference of two runs is not in steps of the
    head's bf16 rounding); gathered over the vocab split under TP."""
    from magicdec_tpu_torch.ops.norm import rms_norm

    p = engine.params
    y = rms_norm(x.float(), p["final_norm"].float(), engine.cfg.norm_eps) @ p["lm_head"].float()
    tp = p.get("shard")
    return (y if tp is None else tp.full_logits(y)).cpu().numpy()


def _drop_wo_sum(reduce, rank: int):
    """The control's ``collectives.all_reduce``: every rank takes part in
    every all-reduce, but rank 1 keeps its own partial wo product (the first
    of a layer's two sums, wo's then w2's) in place of the sum."""
    seen = [0]

    def faulty(t, op="sum", group=None):
        if op != "sum" or group is None:
            return reduce(t, op, group)
        own = t.clone() if seen[0] % 2 == 0 and rank == 1 else None
        seen[0] += 1
        reduce(t, op, group)
        return t if own is None else own

    return faulty


def _tp_rank(spec_argv):
    """One rank of path (29), in a process of its own: ``selfspec_benchmark``
    with the launch counters zeroed just before and read just after and the
    quantized dots by (rows, in, out, route); then, on the engine and batch
    it built (``baseline_benchmark.setup``'s), the autoregressive baseline,
    the target's logits at the prompts' last position, and the control's:
    the first request's prefill again with rank 1 dropping the sum of wo's
    products in every layer (``_drop_wo_sum``)."""
    import torch
    import torch.distributed as dist

    from magicdec_tpu_torch import baseline_benchmark, selfspec_benchmark
    from magicdec_tpu_torch.parallel import collectives, multihost

    dev = multihost.rank_device()
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = _kernel_wrappers()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    dots, undo = _dot_spy(torch)
    reduce, calls = collectives.all_reduce, {}

    def counted(t, op="sum", group=None):  # the all-reduces of the spec run, by op
        if group is not None:
            calls[op] = calls.get(op, 0) + 1
            calls[f"{op} MB"] = calls.get(f"{op} MB", 0.0) + t.numel() * t.element_size() / 1e6
        return reduce(t, op, group)

    setup, built = baseline_benchmark.setup, []

    def keep(*a, **kw):  # selfspec_benchmark's engine and batches, kept
        built.append(setup(*a, **kw))
        return built[-1]

    collectives.all_reduce, baseline_benchmark.setup = counted, keep
    try:
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        args = selfspec_benchmark.parse_args(spec_argv)
        spec = selfspec_benchmark.run(args)
        spec_s = time.perf_counter() - t0
        launches, spec_dots, spec_calls = _read_counts(wrappers), dict(dots), dict(calls)
        collectives.all_reduce, baseline_benchmark.setup = reduce, setup
        dots.clear()
        _zero_counts(wrappers)
        (engine, batches), = built
        last = _capture_last_hidden(engine)
        st = engine.encode_baseline(batches[0])
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, base = engine.generate_baseline(st, max_new=args.max_gen)
        base_output = base["output"].cpu().numpy()
        base_s = time.perf_counter() - t0
        base_launches = _read_counts(wrappers)
        logits = _logits_of(torch, engine, last[0])
        collectives.all_reduce = _drop_wo_sum(reduce, dist.get_rank())
        try:
            engine.encode_baseline(batches[0][:1])
        finally:
            collectives.all_reduce = reduce
        control = _logits_of(torch, engine, last[1])
        del engine, st, base, built
    finally:
        undo()
        collectives.all_reduce, baseline_benchmark.setup = reduce, setup
    # the gloo transport between the ranks on this card: one all-reduce of a
    # verify pass's residual rows (32 x 4096) and of a prefill chunk's (8 x 512)
    transport = {}
    for rows in (32, 4096):
        t = torch.ones((rows, 4096), dtype=torch.bfloat16, device=dev)
        dist.all_reduce(t)
        if cuda:
            torch.cuda.synchronize()
        n = 20 if rows < 1000 else 3
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t)
        if cuda:
            torch.cuda.synchronize()
        transport[f"[{rows}, 4096] bf16 ms"] = round((time.perf_counter() - t0) / n * 1e3, 4)
    b = spec["batches"][0]
    return {"rank": dist.get_rank(), "output": b["output"], "committed": b["num_committed"],
            "base_output": base_output, "logits": logits, "control": control,
            "tokens_per_step": spec["tokens_per_step"], "tokens_per_s": spec["tokens_per_s"],
            "base_tokens_per_s": base_output.shape[0] * (args.max_gen - 1) / base_s,
            "spec_s": spec_s, "base_s": base_s,
            "launches": launches, "base_launches": base_launches, "dots": spec_dots,
            "all_reduces": spec_calls, "transport": transport,
            "peak": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}


def _top_two_gap(torch, engine, prompt, committed):
    """TP 1's top-two logit gap at the position after
    ``prompt`` + ``committed`` tokens: one request's prefill in the
    engine's chunks, the last row's float32 logits."""
    import numpy as np

    from magicdec_tpu_torch.models import llama as M

    seq = torch.as_tensor(np.concatenate([prompt, committed]).astype(np.int32),
                          device=engine.device)[None]
    caches = engine._zero_target_caches(1)
    C = engine.ecfg.prefill_chunk_size or engine.ecfg.chunk_size
    lens = torch.zeros((1,), dtype=torch.int32, device=engine.device)
    for s in range(0, seq.shape[1], C):
        logits, caches = M.forward_target(engine.params, engine.cfg, seq[:, s:s + C], lens,
                                          caches, head="logits")
        lens = lens + seq[:, s:s + C].shape[1]
    top = torch.topk(logits[0, -1].float(), 2).values.tolist()
    return top[0] - top[1]


def tp_phase(torch):
    """(29): ``selfspec_benchmark`` with TP_ARGV + TP_MESH, 2 ranks on this
    card (``parallel.multihost.launch``, each rank ``_tp_rank``), against
    the same arguments at TP 1.  Fails unless the two ranks agree, spec ==
    AR on every committed token of the TP run, tokens per step >= 2.0, the
    two runs' logits at the prompts' last position differ by at most
    SPREAD_LIMIT of TP 1's largest |logit| while the control's (rank 1
    dropping wo's sums, ``_drop_wo_sum``) differ by more, each TP token
    equals TP 1's except where TP 1's top-two gap is below twice
    SPREAD_LIMIT of that largest |logit| (the first such token a request
    ends its comparison, printed), each rank launched K2q, K1q, K1, K3q, K3, B4 and
    B6 (the attention at head dim 128 on 4 local kv heads, B4 on the local
    wqkv's 3072 columns, B6 on the padded head shard's 64,256), and B5, B9,
    B15's dense_mlp and every plain product of a decode pass stayed idle.
    Prints each rank's peak memory.  Returns rank 0's launches."""
    import numpy as np

    from magicdec_tpu_torch import baseline_benchmark, selfspec_benchmark
    from magicdec_tpu_torch.parallel import multihost

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = multihost.launch(_tp_rank, (TP_ARGV + TP_MESH,), 2, backend="gloo", device="cuda")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        print(f"[tp (29)] rank {r['rank']}: spec {r['spec_s']:.1f} s, AR {r['base_s']:.1f} s, "
              f"{r['tokens_per_step']:.3f} tokens/step, spec {r['tokens_per_s']:.2f} tok/s, AR "
              f"{r['base_tokens_per_s']:.2f} tok/s, peak {r['peak']:.2f} GiB; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }", flush=True)
    print(f"[tp (29)] rank 0 quantized dots (rows, in, out, route): "
          f"{dict(sorted(r0['dots'].items()))}; both ranks {wall:.1f} s of wall", flush=True)
    print(f"[tp (29)] rank 0's all-reduces in the spec run (encode + generate): "
          f"{ {k: round(v, 1) for k, v in r0['all_reduces'].items()} }; gloo transport on "
          f"this card: {r0['transport']}", flush=True)
    for r in ranks[1:]:
        if not (np_equal(r["output"].reshape(-1), r0["output"].reshape(-1))
                and np_equal(r["base_output"].reshape(-1), r0["base_output"].reshape(-1))):
            raise AssertionError(f"(29): rank {r['rank']}'s tokens differ from rank 0's")
    args = selfspec_benchmark.parse_args(TP_ARGV)
    print("[tp (29)] TP 2 " + _agreement(r0["output"], r0["committed"], r0["base_output"],
                                          args.max_gen), flush=True)
    if r0["tokens_per_step"] < 2.0:
        raise AssertionError(f"(29): acceptance collapsed, {r0['tokens_per_step']} tokens/step")
    # TP 1: the same arguments in this process
    t0 = time.perf_counter()
    engine, batches = baseline_benchmark.setup(
        args, mode=args.mode, gamma=args.gamma, draft_budget=args.draft_budget,
        draft_quant=args.draft_quant or False, draft_quant_head=args.draft_head == "quant")
    last = _capture_last_hidden(engine)
    _, stats = engine.generate(engine.encode(batches[0]))
    out1, n1 = stats["output"].cpu().numpy(), stats["num_committed"].cpu().numpy()
    ref = _logits_of(torch, engine, last[0])
    scale = float(np.abs(ref).max())
    spread = float(np.abs(ref - r0["logits"]).max()) / scale
    control = float(np.abs(ref[:1] - r0["control"]).max()) / scale
    print(f"[tp (29)] TP 2 against TP 1 at the prompts' last position: the largest logit "
          f"difference is {spread:.6f} of TP 1's largest |logit| {scale:.4f} (limit "
          f"{SPREAD_LIMIT}); the control's (rank 1 dropping wo's sums) {control:.6f}",
          flush=True)
    bound, ties = 2 * SPREAD_LIMIT * scale, {}
    for b in range(out1.shape[0]):
        n = min(int(n1[b]), int(r0["committed"][b]), args.max_gen)
        j = next((j for j in range(n) if out1[b, j] != r0["output"][b, j]), None)
        if j is None:
            continue
        gap = _top_two_gap(torch, engine, batches[0][b], out1[b, :j])
        ties[b] = (j, round(gap, 6))
        if gap >= bound:
            raise AssertionError(f"(29): request {b} differs from TP 1 at token {j} where TP 1's "
                                 f"top-two gap is {gap}, not below {bound} (2 x {SPREAD_LIMIT} "
                                 f"of TP 1's largest |logit| {scale})")
    same = out1.shape[0] - len(ties)
    print(f"[tp (29)] TP 2 against TP 1 ({time.perf_counter() - t0:.1f} s): {same} of "
          f"{out1.shape[0]} requests equal on every token both committed; near ties (request: "
          f"(first differing token, TP 1 top-two gap)) {ties}, below {bound:.4f}", flush=True)
    need = ["flash_prefill_attend_quant", "flash_decode_attend_quant", "flash_decode_attend",
            "append_all_rows_inplace_quant", "append_all_rows_inplace", "quant_matmul_fused",
            "quant_matmul"]
    idle = ["quant_layer_tail", "quant_mlp", "dense_mlp"]
    for r in ranks:
        missing = [n for n in need if not r["launches"][n]]
        busy = [n for n in idle if r["launches"][n] or r["base_launches"][n]]
        attn = [n for n in need[:3] if r["launches"][f"{n} {HD128}"] != r["launches"][n]]
        plain = {k: v for k, v in r["dots"].items() if k[3] == "plain" and k[0] <= 256}
        if missing or busy or attn or plain:
            raise AssertionError(f"(29) rank {r['rank']}: never launched {missing}; launched "
                                 f"{busy}; off head dim 128: {attn}; plain decode dots {plain}")
        widths = {(k[2], k[3]) for k in r["dots"]}
        for w in ((3072, "kernel"), (64256, "kernel")):
            if w not in widths:
                raise AssertionError(f"(29) rank {r['rank']}: no {w[1]} dot at {w[0]} columns "
                                     f"(the local wqkv, the padded head shard): {widths}")
    if spread > SPREAD_LIMIT or control <= SPREAD_LIMIT:
        raise AssertionError(f"(29): the logit difference against TP 1 is {spread} (limit "
                             f"{SPREAD_LIMIT}), the control's {control} (must exceed it)")
    del engine, stats
    torch.cuda.empty_cache()
    return r0["launches"]


# (30) data parallelism: the paged int8 serve of llama-3.2-1b over 2 data
# ranks sharing cuda:0 through gloo (4 slots and 8 of the 16 pages a
# group: requests of 3 to 5 pages wait for them), 8 requests of distinct
# lengths in [1024, 2048], 32 tokens each (80 before: a depth cut for the
# time limit); then the same serve with --force_mesh (one rank, NCCL)
# against the meshless serve
DP_SERVE_ARGV = ["--paged", "--kv_quant", "int8", "--slots", "8", "--num_requests", "8",
                 "--prefix_len", "2048", "--ragged", "--seed", "41", "--max_len", "4096",
                 "--page_size", "512", "--total_pages", "16", "--max_gen", "32",
                 "--skip_warmup"]
DP_MESH = ["--data_parallel", "2", "--dist_backend", "gloo"]


def _dp_rank(argv):
    """One rank of path (30): ``serving_bench`` with the counters zeroed
    just before and read just after."""
    import torch
    import torch.distributed as dist

    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.parallel import multihost

    cuda = multihost.rank_device().type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = _kernel_wrappers()
    _zero_counts(wrappers)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = serving_bench.run(serving_bench.parse_args(argv))
    return {"rank": dist.get_rank(), "outputs": out["outputs"], "prompts": out["prompts"],
            "stats": out["stats"], "seconds": out["seconds"], "result": out["result"],
            "launches": _read_counts(wrappers),
            "peak": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}


def dp_phase(torch):
    """(30): ``serving_bench`` with DP_SERVE_ARGV + DP_MESH in 2 ranks on
    this card (each ``_dp_rank``).  Fails unless the ranks agree, the
    prompts are distinct lengths, a free slot waited for pages, B12 (int8
    pool) and B13 launched on both ranks, and each request equals its
    prompt alone through a B=1 ``SpecEngine`` (C2's rule: where the live
    row counts differ, again at the data group's row count and split plans,
    which must agree); then ``serving_bench --force_mesh --dist_backend
    nccl`` (one rank in this process) must equal the meshless serve token
    for token.  Returns rank 0's launches."""
    import dataclasses

    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.engine.engine import SpecEngine
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.parallel import multihost

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = multihost.launch(_dp_rank, (DP_SERVE_ARGV + DP_MESH,), 2, backend="gloo",
                             device="cuda")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        print(f"[dp (30)] rank {r['rank']}: serve {r['seconds']:.1f} s, peak {r['peak']:.2f} "
              f"GiB; launches { {k: v for k, v in r['launches'].items() if v} }", flush=True)
    print(f"[dp (30)] " + _serving_summary(r0) + f"; both ranks {wall:.1f} s of wall",
          flush=True)
    for r in ranks[1:]:
        if not all(np_equal(a, b) for a, b in zip(r["outputs"], r0["outputs"])):
            raise AssertionError(f"(30): rank {r['rank']}'s tokens differ from rank 0's")
    lens = [len(p) for p in r0["prompts"]]
    if len(set(lens)) != len(lens):
        raise AssertionError(f"(30): the prompt lengths are not distinct: {lens}")
    if r0["stats"]["page_blocked"] <= 0:
        raise AssertionError("(30): no free slot waited for pages")
    # served == solo, B=1 SpecEngine runs (meshless: the data axis keeps TP 1)
    args = serving_bench.parse_args(DP_SERVE_ARGV)
    engine, _ = serving_bench.setup(args)
    b1 = SpecEngine(engine.params, engine.cfg, engine.ecfg, device=engine.device)
    del engine
    slots = args.slots // 2  # a data group's
    split_plan, quant_split_plan = DA.split_plan, DA.quant_split_plan

    def solo(prompt, fixed):
        if fixed:  # the data group's rows and split plans
            b1._hinted = lambda B: dataclasses.replace(
                b1.cfg, decode_rows=slots * (b1.ecfg.gamma + 1))
            DA.split_plan = lambda B, Hkv, S, hd=64: split_plan(slots, Hkv, S, hd)
            DA.quant_split_plan = lambda B, Hkv, S, hd=64: quant_split_plan(slots, Hkv, S, hd)
        try:
            _, stats = b1.generate(b1.encode(prompt[None]))
        finally:
            vars(b1).pop("_hinted", None)
            DA.split_plan, DA.quant_split_plan = split_plan, quant_split_plan
        return stats["output"][0, :int(stats["num_committed"][0])].cpu().numpy()

    t0 = time.perf_counter()
    diffs = _first_diffs(r0["outputs"], [solo(p, False) for p in r0["prompts"]])
    line = f"all {len(lens)} requests agree with their B=1 runs on every token both committed"
    if diffs:
        # the requests that differ, again at the data group's row count
        again = sorted(diffs)
        fixed = {again[i]: j for i, j in _first_diffs(
            [r0["outputs"][i] for i in again], [solo(r0["prompts"][i], True) for i in again]).items()}
        if fixed:
            raise AssertionError(f"(30): served != solo at the live row counts {diffs} and at "
                                 f"the data group's row count {fixed}")
        line = (f"DIFFER at the live row counts (requests: first differing token {diffs}); "
                f"at the data group's {slots} slots' row count those {len(again)} agree")
    print(f"[dp (30)] served against B=1 ({time.perf_counter() - t0:.1f} s): {line}", flush=True)
    del b1
    torch.cuda.empty_cache()
    # the one NCCL check: --force_mesh (one rank, NCCL) against no mesh
    t0 = time.perf_counter()
    nccl = serving_bench.main(DP_SERVE_ARGV + ["--force_mesh", "--dist_backend", "nccl"])
    plain = serving_bench.main(DP_SERVE_ARGV)
    print("[dp (30)] " + _same_tokens("--force_mesh over NCCL against the meshless serve",
                                      nccl["outputs"], plain["outputs"])
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    for r in ranks:
        for n in ("flash_paged_decode_attend_quant", "append_paged_rows_inplace"):
            if not r["launches"][n]:
                raise AssertionError(f"(30) rank {r['rank']} never launched {n}")
    return r0["launches"]


def tools_phase(torch, wrappers, kernels):
    """(27) ``profile_draft.main --iters 10`` at its defaults (llama-3.2-1b,
    B=32, budget 513, the int8 draft copy; its counters read: K1, K3, B4, B5
    and B6 launched), each chain's time finite and positive; then
    ``sweep_benchmark --set smoke --device cuda`` (a bench process of its
    own), one row with a result and its table line."""
    from magicdec_tpu_torch import profile_draft, sweep_benchmark

    DA, AP, QK = kernels["DA"], kernels["AP"], kernels["QK"]
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    r = profile_draft.main(["--iters", "10"])
    wall = time.perf_counter() - t0
    launches = _read_counts(wrappers)
    used = [DA.flash_decode_attend, AP.append_all_rows_inplace, QK.quant_matmul_fused,
            QK.quant_layer_tail, QK.quant_matmul]
    print(f"[profile_draft] wall {wall:.1f} s; " + ", ".join(f"{k} {v:.4f}" for k, v in r.items())
          + "; launches " + ", ".join(f"{w.__name__} {launches[w.__name__]}" for w in used),
          flush=True)
    bad = [k for k in profile_draft.CHAINS if not (math.isfinite(r[k]) and r[k] > 0)]
    if bad:
        raise AssertionError(f"(27) profile_draft: {bad} not finite and positive ({r})")
    for w in used:
        if launches[w.__name__] <= 0:
            raise AssertionError(f"(27) profile_draft never launched {w.__name__}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sweep = sweep_benchmark.main(["--set", "smoke", "--device", "cuda"])
    print(f"[sweep] --set smoke: wall {time.perf_counter() - t0:.1f} s; rows {sweep['rows']}",
          flush=True)
    rows, table = sweep["rows"], sweep["table"]
    if len(rows) != 1 or "error" in rows[0] or "value" not in rows[0]:
        raise AssertionError(f"(27) the sweep's smoke row has no result: {rows}")
    if len(table) != 3 or not table[2].startswith("| smoke |"):
        raise AssertionError(f"(27) the sweep's table: {table}")
    return r, sweep


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from magicdec_tpu_torch import quantization as Q
        from magicdec_tpu_torch.kernels import append as AP
        from magicdec_tpu_torch.kernels import build
        from magicdec_tpu_torch.kernels import decode_attention as DA
        from magicdec_tpu_torch.kernels import dense_matmul as DK
        from magicdec_tpu_torch.kernels import paged_attention as PGA
        from magicdec_tpu_torch.kernels import prefill_attention as PA
        from magicdec_tpu_torch.kernels import quant_matmul as QK
    except ImportError as exc:
        print(f"chip_smoke: the magicdec_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(f"[device] maximum SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz (the exp bound's)", flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    def phase_done(name):
        print(f"[time] {name} done at {time.perf_counter() - t_start:.1f}s", flush=True)

    lib = build.build(verbose=True)
    print(f"[build] {lib.name} in {time.perf_counter() - t_start:.1f}s", flush=True)
    # registers, shared memory and spills of the Hopper kernels (B4/B6 and
    # B4-int4, B6-int4, B5/B9 and B15's dense_mlp (their bf16 instance),
    # B15's dense_matmul_fused, K2/K2q/B11, and the
    # decode kernel of K1, K1q, B10 and B12), each instantiation
    for source, kernel in (("quant_matmul_sm90", "qmm_sm90_kernel"),
                           ("quant_matmul_sm90", "qmm4_sm90_kernel"),
                           ("quant_matmul_m128_sm90", "qmm_m128_kernel"),
                           ("ffn_sm90", "ffn_sm90_kernel"),
                           ("ffn_sm90", "ffn_wg_sm90_kernel"),
                           ("ffn_sm90", "ffn_bf16_sm90_kernel"),
                           ("dense_matmul_sm90", "dmm_sm90_kernel"),
                           ("prefill_attention_sm90", "prefill_sm90_kernel"),
                           ("prefill_attention_hd128_sm90", "prefill_sm90_kernel"),
                           ("decode_attention_sm90", "decode_sm90_kernel"),
                           ("decode_attention_hd128_sm90", "decode_sm90_kernel")):
        log = build.BUILD_DIR / f"{source}.nvcc.log"
        ptxas = log.read_text().splitlines() if log.exists() else []
        for i, line in enumerate(ptxas):
            if "Compiling entry function" in line and kernel in line:
                detail = " | ".join(x.strip() for x in ptxas[i + 1:i + 4]
                                    if "ptxas" in x or "spill" in x)
                print(f"[ptxas] {_instance(line.split(chr(39))[1])}: {detail}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = kernel_phase(torch, gen)
    phase_done("kernel phase")

    dense = [DA.flash_decode_attend, PA.flash_prefill_attend, AP.append_all_rows_inplace]
    quant = [DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant,
             AP.append_all_rows_inplace_quant]
    dots = [QK.quant_matmul_fused, QK.quant_layer_tail, QK.quant_matmul]
    quant4 = [DA.flash_decode_attend_quant4, PA.flash_prefill_attend_quant4]
    dots4 = [QK.quant_matmul_fused_int4, QK.quant_matmul_int4]
    paged = [PGA.flash_paged_decode_attend, PGA.flash_paged_decode_attend_quant,
             PGA.flash_paged_decode_attend_quant4, PGA.append_paged_rows_inplace]
    per_array = [AP.append_rows_inplace, AP.append_scale_rows_inplace]
    dense_dots = [DK.dense_matmul_fused, DK.dense_mlp]
    wrappers = _kernel_wrappers()
    # (1) the default path (one measured repeat): the target on the int8 KV
    # kernels, the draft's int8 weight copy on B4/B5/B6 and its bf16 cache
    # on K1 and K3; B14 and B15 stay off by default
    out1, launches, peak8 = main_path(
        torch, wrappers, quant + dots + [DA.flash_decode_attend, AP.append_all_rows_inplace],
        ["--iters", "1"], forbidden=paged + per_array + dense_dots)
    # (2) all bf16 (one measured repeat): K2 carries the target prefill
    _, launches16, peak16 = main_path(
        torch, wrappers, dense, ["--kv_quant", "none", "--draft_quant", "none", "--iters", "1"])
    # (3) the defaults at two requests: the draft prefill chunk's 256 rows
    # take B9
    _, launches2, _ = main_path(torch, wrappers, quant + dots + [QK.quant_mlp],
                                ["--B", "2", "--prefix_len", "2048", "--iters", "1"])
    # (4) the int4 capacity path (one measured repeat): the target on B10,
    # B11 and K3q over packed rows, the draft's int4 copy on B4-int4 (norms
    # first) and B6-int4; B5, B9 and the int8 attention kernels stay idle.
    # Its acceptance floor is lower: an int4 draft copy of random synthetic
    # weights loses acceptance, as the JAX package records for its own
    # (alpha 0.82 -> 0.52, CLAUDE.md); a broken draft reads near 1
    _, launches4, peak4 = main_path(
        torch, wrappers,
        quant4 + dots4 + [AP.append_all_rows_inplace_quant, DA.flash_decode_attend,
                          AP.append_all_rows_inplace],
        ["--kv_quant", "int4", "--draft_quant", "int4", "--iters", "1"],
        forbidden=[QK.quant_layer_tail, QK.quant_mlp, DA.flash_decode_attend_quant,
                   PA.flash_prefill_attend_quant], min_tokens_per_step=1.8)
    # (5) the int4 cache under the default int8 draft copy (one measured
    # repeat) at B=8 x 4096, path (15)'s shape (BF16S_CUT, a depth cut for
    # the time limit): the cache format alone keeps the default's
    # acceptance floor
    out5, _, peak5 = main_path(
        torch, wrappers, quant4 + dots + [AP.append_all_rows_inplace_quant],
        ["--kv_quant", "int4"] + BF16S_CUT + ["--iters", "1"],
        forbidden=[DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant] + dots4)
    # (15) path (5) with bf16 scales, (16) path (1) with bf16 scales: every
    # quantized-KV kernel on its bf16-scale instance alone, at B=8 x 4096
    # (BF16S_CUT, a depth cut for the time limit)
    bf16_launches = {}
    for tag, argv, own, forbid, (peer, peer_peak, peer_tag) in (
            ("15", ["--kv_quant", "int4", "--kv_scale", "bf16"] + BF16S_CUT + ["--iters", "1"],
             quant4 + [AP.append_all_rows_inplace_quant],
             [DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant] + dots4,
             (out5, peak5, "(5)")),
            ("16", ["--kv_scale", "bf16"] + BF16S_CUT + ["--iters", "1"], quant,
             paged + per_array + dense_dots, (out1, peak8, "(1)"))):
        out_b, launches_b, peak_b = main_path(torch, wrappers, own + dots, argv,
                                              forbidden=forbid)
        _all_on_bf16_scales(f"main ({tag})", launches_b, own)
        bf16_launches.update({k: v for k, v in launches_b.items() if k.endswith(BF16S) and v})
        print(f"[main ({tag}) bf16 scales] {_bench_summary(out_b)}, peak {peak_b:.2f} GiB; "
              f"path {peer_tag} (f32 scales): {_bench_summary(peer)}, peak {peer_peak:.2f} GiB",
              flush=True)
    phase_done("paths (15), (16): --kv_scale bf16")
    # (11) SnapKV self-speculation at the bench defaults (one measured
    # repeat; the prefix rounds to 8224): no draft prefill, the draft cache
    # compressed from the target's; K2q also runs the 32-token window chunk,
    # the verify appends to both caches (K3q and K3).  The compression's
    # scores must run in full float32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is True: SnapKV's "
                             "scores would run in TF32")
    print("[snapkv] torch.backends.cuda.matmul.allow_tf32 is False: the compression's "
          "scores run in float32", flush=True)
    out_snap, launches_snap, peak_snap = snapkv_main_path(
        torch, wrappers, quant + dots + [DA.flash_decode_attend, AP.append_all_rows_inplace],
        forbidden=paged + per_array + dense_dots + [QK.quant_mlp])
    print(f"[snapkv] time to first token (B=32): snapkv {out_snap['encode_s']:.4f} s against "
          f"streamingllm's {out1['encode_s']:.4f} s (path (1)); peak device memory "
          f"{peak_snap:.2f} GiB against {peak8:.2f} GiB", flush=True)
    # (12) quantized verify weights (bench --quantize int8, one measured
    # repeat): the target's wqkv and wo on B4, its FFN on B9 and its head on
    # B6, each at decode_rows = 128 rows; the draft shares them (B4 / B5 /
    # B6 at 32 and 64 rows); no int4 dot and no draft copy
    out12, _, peak12, _ = quantized_main_path(
        torch, wrappers, quant + dots + [QK.quant_mlp, DA.flash_decode_attend,
                                         AP.append_all_rows_inplace],
        ["--quantize", "int8"] + HALF_PREFIX + ["--iters", "1"],
        paged + per_array + dense_dots + dots4,
        at_128=["quant_matmul_fused", "quant_mlp", "quant_matmul"])
    print(f"[quantize int8] {_bench_summary(out12)}, peak {peak12:.2f} GiB; path (1) (bf16 "
          f"verify weights): {_bench_summary(out1)}, peak {peak8:.2f} GiB", flush=True)
    for B in (32, 4, 2):
        row_invariance_phase(torch, B, quantize="int8")
    phase_done("path (12): --quantize int8")
    # group-wise int8 verify weights: the row check at B = 32, 4, 2 (128, 16
    # and 8 padded rows), then a short engine run
    for B in (32, 4, 2):
        row_invariance_phase(torch, B, quantize="int8", group_size=GROUP8)
    launches_g = grouped_int8_engine_phase(torch, wrappers)
    phase_done("group-wise int8 target")
    # (13) int4 verify weights with the int8 embedding table, prefix 2048
    # (one measured repeat; B=32, so the target still runs 128 rows): B4-int4
    # and B6-int4 on the target and the draft, no int8 dot
    out13, launches13, _, _ = quantized_main_path(
        torch, wrappers, dots4 + quant + [DA.flash_decode_attend, AP.append_all_rows_inplace],
        ["--quantize", "int4", "--quantize_embed", "--prefix_len", "2048", "--iters", "1"],
        paged + per_array + dense_dots + dots + [QK.quant_mlp],
        at_128=["quant_matmul_fused_int4", "quant_matmul_int4"])
    print(f"[quantize int4 + quantize_embed] {_bench_summary(out13)}", flush=True)
    phase_done("path (13): --quantize int4 --quantize_embed")
    # (28) the quantized llama-3.1-8b target (self-speculation, the draft
    # sharing the int8 weights; B=32 x 2048, 40 tokens: a depth cut for the
    # time limit): the target's wqkv and wo on B4 and its head on B6, both
    # on the 128-row core, its FFN on B9, all at 8B widths and 128 rows; the
    # draft's B4 / B5 / B6 at 32 and 64 rows; attention on the head-dim-128
    # instances; prefill chunks on the plain product, no decode pass
    out28, launches28, peak28, rows28 = quantized_main_path(
        torch, wrappers, quant + dots + [QK.quant_mlp, DA.flash_decode_attend,
                                         AP.append_all_rows_inplace],
        QUANTIZED_8B_ARGV, paged + per_array + dense_dots + dots4 + quant4,
        at_128=["quant_matmul_fused", "quant_mlp", "quant_matmul"], min_tokens_per_step=2.0)
    _all_at_hd128("main (28)", launches28, [DA.flash_decode_attend_quant,
                                            PA.flash_prefill_attend_quant, DA.flash_decode_attend])
    for name in ("quant_matmul_fused", "quant_matmul"):
        if not launches28[f"{name} {M128}"]:
            raise AssertionError(f"path (28) never launched {name} on the 128-row core")
    print(f"[main (28) llama-3.1-8b --quantize int8] {_bench_summary(out28)}, peak "
          f"{peak28:.2f} GiB; 128-row core launches: B4 "
          f"{launches28[f'quant_matmul_fused {M128}']}, B6 {launches28[f'quant_matmul {M128}']}",
          flush=True)
    phase_done("path (28): bench --model llama-3.1-8b --quantize int8")
    # (17)-(19) standalone-draft speculation at llama-3.1-8b + llama-3.2-1b:
    # the target on B10 and B11's head-dim-128 instances and K3q (packed
    # rows), the draft's int8 copy on B4 / B5 / B6, its cache on K1 and K3
    # (full, snapkv: its prefill on K2); then the paged int4 twin against
    # the contiguous one (B12's int4 pool at head dim 128)
    ls_results = longspec_phase(
        torch, wrappers, dots + [DA.flash_decode_attend, AP.append_all_rows_inplace,
                                 AP.append_all_rows_inplace_quant],
        forbidden=[DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant] + paged
        + per_array + dense_dots + dots4)
    phase_done("paths (17)-(19): longspec")
    ls_serve = longspec_serving_phase(torch, wrappers)
    phase_done("the paged int4 longspec serve")
    # (20) self-speculation at llama-3.1-8b, the bench's defaults otherwise
    # (B=8 x 4096, one measured repeat; the default's 32 rows and 8192 tokens are a depth
    # cut for the time limit): the target's int8 cache on K1q,
    # K2q and K3q at head dim 128, the draft's int8 copy on B4 / B5 / B6 at
    # 8B widths, its bf16 cache on K1 (the whole-row call) and K3.  A broken
    # draft reads near 1 token a step: the gate is 2.0 (the 1B paths keep 2.5)
    out20, launches20, peak20 = main_path(
        torch, wrappers, quant + dots + [DA.flash_decode_attend, AP.append_all_rows_inplace],
        ["--model", "llama-3.1-8b", "--B", "8", "--prefix_len", "4096", "--iters", "1"],
        forbidden=paged + per_array + dense_dots + quant4 + dots4, min_tokens_per_step=2.0)
    _all_at_hd128("main (20)", launches20, [DA.flash_decode_attend_quant,
                                            PA.flash_prefill_attend_quant, DA.flash_decode_attend])
    print(f"[main (20) llama-3.1-8b] {_bench_summary(out20)}, peak {peak20:.2f} GiB",
          flush=True)
    phase_done("path (20): bench --model llama-3.1-8b")
    # (21) all bf16 at llama-3.1-8b: K1 (the target's verify and AR step,
    # the draft's whole-row call) and K2 at head dim 128, at B=8 x 2048 (a
    # depth cut for the time limit: the default's B=32 x 8192 took 75 s)
    out21, launches21, peak21 = main_path(
        torch, wrappers, dense, ["--model", "llama-3.1-8b", "--kv_quant", "none",
                                 "--draft_quant", "none", "--B", "8", "--prefix_len", "2048",
                                 "--iters", "1"],
        forbidden=quant + dots + [QK.quant_mlp] + quant4 + dots4 + paged + per_array
        + dense_dots, min_tokens_per_step=2.0)
    _all_at_hd128("main (21)", launches21, [DA.flash_decode_attend, PA.flash_prefill_attend])
    print(f"[main (21) llama-3.1-8b all bf16, B=8 x 2048] {_bench_summary(out21)}, peak "
          f"{peak21:.2f} GiB", flush=True)
    phase_done("path (21): bench --model llama-3.1-8b, all bf16")
    serve8 = serve_8b_phase(torch, wrappers, {"DA": DA, "PA": PA, "PGA": PGA})
    phase_done("(22) the paged 8B serves")
    launches["flash_prefill_attend"] = launches16["flash_prefill_attend"]
    launches["quant_mlp"] = launches2["quant_mlp"]
    launches.update({w.__name__: launches4[w.__name__] for w in quant4 + dots4})
    print(f"[main] peak device memory: int8 KV + int8 draft {peak8:.2f} GiB, all bf16 "
          f"{peak16:.2f} GiB, int4 KV + int4 draft {peak4:.2f} GiB", flush=True)
    if peak8 >= peak16:
        raise AssertionError("the int8 path did not lower peak device memory")
    if peak4 >= peak8:
        raise AssertionError("the int4 path did not lower peak device memory below int8's")
    phase_done("main paths")
    # (10) the JAX package's kernel A/B configuration on the default path
    # (over HALF_PREFIX, a depth cut for the time limit):
    # the target's bf16 decode and verify dots on B15 (set_dense_kernels)
    # and every cache append as B14's per-array calls
    # (MAGICDEC_PER_ARRAY_APPEND), the merged appends idle
    env = os.environ.get("MAGICDEC_PER_ARRAY_APPEND")
    os.environ["MAGICDEC_PER_ARRAY_APPEND"] = "1"
    Q.set_dense_kernels(True)
    try:
        _, launches10, _ = main_path(
            torch, wrappers,
            per_array + dense_dots + [DA.flash_decode_attend_quant, DA.flash_decode_attend] + dots,
            HALF_PREFIX + ["--iters", "1"],
            forbidden=[AP.append_all_rows_inplace, AP.append_all_rows_inplace_quant,
                       PGA.append_paged_rows_inplace])
    finally:
        Q.set_dense_kernels(False)
        if env is None:
            os.environ.pop("MAGICDEC_PER_ARRAY_APPEND")
        else:
            os.environ["MAGICDEC_PER_ARRAY_APPEND"] = env
    launches.update({w.__name__: launches10[w.__name__] for w in per_array + dense_dots})
    phase_done("path (10): B14 and B15")
    # --gamma 0: the autotune's warmup at gamma 4, phase timers and pick
    main_path(torch, wrappers, quant + dots,
              ["--gamma", "0", "--B", "2", "--prefix_len", "2048", "--iters", "1"],
              min_tokens_per_step=1.8)
    phase_done("bench --gamma 0")
    # (6)-(9) the paged serving paths
    launches.update(serving_phase(torch, wrappers, {"DA": DA, "PA": PA, "AP": AP, "PGA": PGA}))
    phase_done("serving paths")
    snapkv_serving_phase(torch, wrappers, {"DA": DA, "PA": PA, "AP": AP, "PGA": PGA})
    phase_done("snapkv serve")
    bf16_launches.update(bf16_scale_serving_phase(torch, wrappers,
                                                  {"DA": DA, "PA": PA, "AP": AP, "PGA": PGA}))
    phase_done("bf16-scale serves")
    # (14) the checkpoint pipeline at full width: its conversion process
    # runs through C2 and (24)
    ckpt = start_checkpoint_conversion(torch)
    try:
        solo_phase(torch)
        phase_done("C2: served against solo")
        # (24) sampled serving: served == solo by salt
        launches24 = sampled_serving_phase(torch, wrappers)
        phase_done("(24) the sampled serve")
    except BaseException:
        stop_checkpoint_conversion(ckpt)
        raise
    checkpoint_round_trip_phase(torch, wrappers, ckpt)
    phase_done("path (14): the checkpoint round trip")
    kits = {"DA": DA, "PA": PA, "AP": AP, "QK": QK}
    # (25) the perplexity driver: K2, K2q and B11 (K3 / K3q at T = 512)
    perplexity_phase(torch, wrappers, kits)
    phase_done("(25) perplexity")
    # (26) the reference-protocol baseline and self-spec drivers
    drivers_phase(torch, wrappers, kits)
    phase_done("(26) baseline and self-spec drivers")
    # (27) profile_draft and the sweep's smoke row
    tools_phase(torch, wrappers, kits)
    phase_done("(27) profile_draft and the sweep")
    # (29) tensor parallelism: llama-3.1-8b over 2 gloo ranks on this card
    tp_phase(torch)
    phase_done("(29) TP 2 at llama-3.1-8b")
    # (30) the paged serve over 2 data ranks, then --force_mesh over NCCL
    dp_phase(torch)
    phase_done("(30) the serve over a data axis")
    # the row-invariance question (PERF.md): is a target row computed the
    # same at verify and at the AR step; at B=4 and 2 the live row counts
    # differ (cuBLAS's w2, torch's row mean), the padded ones the engine runs
    # must not, on cuBLAS and on B15
    for dense_rows in (False, True):
        for B in (32, 4, 2):
            row_invariance_phase(torch, B, dense=dense_rows)
    phase_done("row invariance")
    dense_ab_phase(torch, wrappers)
    phase_done("dense and append A/B")
    # the default path's profile only, over 24 generated tokens of a
    # 4096-token prompt (depth cuts for the time limit: the bench's 80, 40,
    # 8192-token prompts, and the int4, snapkv and --quantize int8 profiles
    # of earlier runs are in PERF.md)
    profile_phase(torch, PROFILE_ARGV)
    phase_done("profiles")

    meta = {
        "flash_decode_attend": ("magicdec_tpu_torch/csrc/decode_attention_sm90.cu",
                                "magicdec_tpu/ops/pallas/decode_attention.py:505"),
        "flash_prefill_attend": ("magicdec_tpu_torch/csrc/prefill_attention_sm90.cu",
                                 "magicdec_tpu/ops/pallas/prefill_attention.py:304"),
        "append_all_rows_inplace": ("magicdec_tpu_torch/csrc/append.cu",
                                    "magicdec_tpu/ops/kv_cache.py:374"),
        "flash_decode_attend_quant": ("magicdec_tpu_torch/csrc/decode_attention_sm90.cu",
                                      "magicdec_tpu/ops/pallas/decode_attention.py:547"),
        "flash_prefill_attend_quant": ("magicdec_tpu_torch/csrc/prefill_attention_sm90.cu",
                                       "magicdec_tpu/ops/pallas/prefill_attention.py:340"),
        "append_all_rows_inplace_quant": ("magicdec_tpu_torch/csrc/append.cu",
                                          "magicdec_tpu/ops/kv_cache.py:489"),
        "quant_matmul_fused": ("magicdec_tpu_torch/csrc/quant_matmul_sm90.cu",
                               "magicdec_tpu/ops/pallas/quant_matmul.py:301"),
        "quant_layer_tail": ("magicdec_tpu_torch/csrc/ffn_sm90.cu",
                             "magicdec_tpu/ops/pallas/quant_matmul.py:699"),
        "quant_matmul": ("magicdec_tpu_torch/csrc/quant_matmul_sm90.cu",
                         "magicdec_tpu/ops/pallas/quant_matmul.py:221"),
        "quant_mlp": ("magicdec_tpu_torch/csrc/ffn_sm90.cu",
                      "magicdec_tpu/ops/pallas/quant_matmul.py:749"),
        "flash_decode_attend_quant4": ("magicdec_tpu_torch/csrc/decode_attention_sm90.cu",
                                       "magicdec_tpu/ops/pallas/decode_attention.py:585"),
        "flash_prefill_attend_quant4": ("magicdec_tpu_torch/csrc/prefill_attention_sm90.cu",
                                        "magicdec_tpu/ops/pallas/prefill_attention.py:377"),
        # the bits=4 branches of quant_matmul_fused_pallas (:301) and
        # quant_matmul_pallas (:221)
        "quant_matmul_fused_int4": ("magicdec_tpu_torch/csrc/quant_matmul_sm90.cu",
                                    "magicdec_tpu/ops/pallas/quant_matmul.py:151"),
        "quant_matmul_int4": ("magicdec_tpu_torch/csrc/quant_matmul_sm90.cu",
                              "magicdec_tpu/ops/pallas/quant_matmul.py:189"),
        "flash_paged_decode_attend": ("magicdec_tpu_torch/csrc/decode_attention_sm90.cu",
                                      "magicdec_tpu/ops/pallas/paged_attention.py:122"),
        "flash_paged_decode_attend_quant": ("magicdec_tpu_torch/csrc/decode_attention_sm90.cu",
                                            "magicdec_tpu/ops/pallas/paged_attention.py:147"),
        "flash_paged_decode_attend_quant4": ("magicdec_tpu_torch/csrc/decode_attention_sm90.cu",
                                             "magicdec_tpu/ops/pallas/paged_attention.py:176"),
        "append_paged_rows_inplace": ("magicdec_tpu_torch/csrc/paged_attention.cu",
                                      "magicdec_tpu/ops/pallas/paged_attention.py:212"),
        "append_rows_inplace": ("magicdec_tpu_torch/csrc/append.cu",
                                "magicdec_tpu/ops/kv_cache.py:292"),
        "append_scale_rows_inplace": ("magicdec_tpu_torch/csrc/append.cu",
                                      "magicdec_tpu/ops/kv_cache.py:499"),
        "dense_matmul_fused": ("magicdec_tpu_torch/csrc/dense_matmul_sm90.cu",
                               "magicdec_tpu/ops/pallas/quant_matmul.py:507"),
        "dense_mlp": ("magicdec_tpu_torch/csrc/ffn_sm90.cu",
                      "magicdec_tpu/ops/pallas/quant_matmul.py:605"),
        # not a Pallas site: the JAX package samples with plain jnp
        "gumbel_argmax": ("magicdec_tpu_torch/csrc/sampling_sm90.cu",
                          "magicdec_tpu/ops/sampling.py:70"),
    }
    # the bf16-scale instances (their launches: paths (15), (16), the
    # bf16-scale serves and, for B14, the group-wise int8 engine run) and B4 /
    # B6 on group-wise int8 weights (that run)
    for name in list(meta):
        if f"{name} {BF16S}" in cases:
            meta[f"{name} {BF16S}"] = meta[name]
    launches.update(bf16_launches)
    launches[f"append_scale_rows_inplace {BF16S}"] = launches_g[
        f"append_scale_rows_inplace {BF16S}"]
    for name in ("quant_matmul_fused", "quant_matmul"):
        meta[f"{name} {GROUPED8}"] = meta[name]
        launches[f"{name} {GROUPED8}"] = launches_g[name]
    # B4, B6 and B4-int4 on the 128-row core: path (28) (and (12)) for the
    # int8 ones, path (13) for B4-int4
    for name, counts in (("quant_matmul_fused", launches28), ("quant_matmul", launches28),
                         ("quant_matmul_fused_int4", launches13)):
        meta[f"{name} {M128}"] = ("magicdec_tpu_torch/csrc/quant_matmul_m128_sm90.cu",
                                  meta[name][1])
        launches[f"{name} {M128}"] = counts[f"{name} {M128}"]
    # the head-dim-128 instances (csrc/*_hd128_sm90.cu): B10 and B11 on the
    # longspec streamingllm path (17), B12's int4 pool in the paged longspec
    # serve, K1q and K2q on path (20), K1 and K2 on path (21), B12's bf16 and
    # int8 pools and every bf16-scale instance in the paged 8B serves (22)
    # (the contiguous twins: K1q and B10)
    launches.update(serve8)
    # S1: the sampled longspec path (23); (24) printed beside it
    launches["gumbel_argmax"] = ls_results["sampled"][1]["gumbel_argmax"]
    print(f"[S1] launches: path (23) {launches['gumbel_argmax']}, path (24) "
          f"{launches24['gumbel_argmax']}", flush=True)
    for name, counts in (("flash_decode_attend_quant4", ls_results["streamingllm"][1]),
                         ("flash_prefill_attend_quant4", ls_results["streamingllm"][1]),
                         ("flash_paged_decode_attend_quant4", ls_serve),
                         ("flash_decode_attend_quant", launches20),
                         ("flash_prefill_attend_quant", launches20),
                         ("flash_decode_attend", launches21),
                         ("flash_prefill_attend", launches21)):
        launches[f"{name} {HD128}"] = counts[f"{name} {HD128}"]
    for name in [n for n in cases if n.endswith(HD128)]:
        source, replaces = meta[name.split()[0]]
        meta[name] = (source.replace("_sm90.cu", "_hd128_sm90.cu"), replaces)
    kernels = []
    for name, (source, replaces) in meta.items():
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name}: no path of this run launched it")
        head = cases[name][0]  # the first case is the headline shape
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
            "case": head["case"], "cases": cases[name]})
    print(smi, flush=True)  # again, so that the end of a long log keeps it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
