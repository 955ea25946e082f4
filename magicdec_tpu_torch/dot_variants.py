"""Variants of B15's ``dense_matmul_fused`` (``csrc/dense_matmul_sm90.cu``),
of B4-int4 and of B6-int4 (``csrc/quant_matmul_sm90.cu``) and of B5, B9
and B15's ``dense_mlp`` (``csrc/ffn_sm90.cu``) timed against each other on
the card, in one process.

    python -m magicdec_tpu_torch.dot_variants [--variants a,b,...] [--plans]

Each variant is one source with the text patches of ``VARIANTS`` below
(``current`` and ``int4_current``: the sources as they stand), compiled
alone with ``nvcc`` (all in parallel) into its own library under
``build/variants/``; the wrappers then run on it (``build.library``
swapped): ``dense_matmul_fused`` at the target's widths (wqkv + norm, wo +
residual, w13 + norm, w2 + residual; M = 128 and 16) or
``quant_matmul_fused_int4`` at the draft's (wqkv, wo + residual, w13 +
gate, w2 + residual; group 128, M = 32 and 64), over 16 layers' weights in
turn, or ``quant_matmul_int4`` on the int4 lm_head [2048, 128256] (M = 32
and 64), or B5 (``quant_layer_tail``, M = 32 and 64), B9 (``quant_mlp``
with its residual, M = 256) and ``dense_mlp`` (with its residual, M = 128
and 16) at llama-3.2-1b widths over 16 layers, device
ms a call by ``kernel_benchmark.graph_ms``.  For each variant
the script prints ptxas's registers and spills and, for the dense kernel,
the ``HGMMA`` instructions against the ``WARPGROUP.DEPBAR`` waits in
``cuobjdump -sass`` (one wait an ``HGMMA``: ptxas serialized the wgmmas).
``trace`` and ``int4_trace`` stamp ``%globaltimer`` at the phases of each
block's first item; the script prints, per case, the median and largest
microseconds of each phase over the blocks.  ``--ffn_plans`` times B5 and
B9 with each w13 split forced (the other dots keep the plan's), and
``dense_mlp`` at every (w13, w2) split pair.
``ffn_trace`` stamps each
block's entry, each dot's first landed stage, the norm's end and each
dot's end (its arrival at the grid barrier); the script prints each
stamp's median and latest microseconds after the first block's entry.
``ffn_bf16_wgmma`` runs ``dense_mlp`` at M <= 16 and 65..128 on the other
product core, ``wgmma``'s transposed product from shared memory.
``--plans`` also times the current dense kernel
over (split, boxes) plans of each shape (``dense_plan`` swapped).  The last
line is a JSON object of the device milliseconds.  Needs the card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "variants"
SOURCES = {"dense": "dense_matmul_sm90.cu", "int4": "quant_matmul_sm90.cu",
           "head": "quant_matmul_sm90.cu", "ffn": "ffn_sm90.cu",
           "m128": "quant_matmul_m128_sm90.cu"}


def _stamp(k: int, indent: str) -> str:
    return f"{indent}if (stamp && t == (int)blockIdx.x && p == 0) tr[{k}] = gtime();\n"


def _trace_patches(namespace: str, entry: str):
    """The %globaltimer array, its per-block pointer and entry stamp, and
    the C entry points that read and clear it."""
    return [
        (f"namespace md {{\nnamespace {namespace} {{\n",
         "__device__ unsigned long long g_trace[2048][8];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         f"  return t;\n}}\n\nnamespace md {{\nnamespace {namespace} {{\n"),
        ("  const uint32_t rank = cluster_rank();\n  const int split = gridDim.y;\n",
         "  const uint32_t rank = cluster_rank();\n  const int split = gridDim.y;\n"
         "  unsigned long long* tr = g_trace[blockIdx.x * gridDim.y + blockIdx.y];\n"
         "  const bool stamp = threadIdx.x == 0 && blockIdx.x < 2048 / gridDim.y;\n"
         "  if (stamp) tr[0] = gtime();\n"),
        (f'extern "C" int {entry}(',
         'extern "C" int md_trace_read(void* dst) {\n'
         "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n\n"
         'extern "C" int md_trace_clear() {\n'
         "  static unsigned long long zero[2048][8];\n"
         "  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));\n}\n\n"
         f'extern "C" int {entry}('),
    ]


def _ffn_stamp(k: str, indent: str, cond: str = "stamp") -> str:
    return f"{indent}if ({cond}) tr[{k}] = gtime();\n"


# B5/B9's stamps (the grid's timeline): 0 entry, 1 phase 0's first stage,
# 2 phase 0 done, 3 the block's share of hn written, 4 phase 1's first
# stage, 5 phase 1 done, 6 phase 2's first stage, 7 the end
_FFN_FIRST = "p == 0 ? 1 : 2 * p + 2"
_FFN_DONE = "p == 0 ? 2 : 2 * p + 3"
_FFN_TRACE = [("namespace md {\nnamespace ffn90 {\n",
               "__device__ unsigned g_smid[2048];\n\nnamespace md {\nnamespace ffn90 {\n")] + \
    _trace_patches("ffn90", "md_ffn_sm90_resident")[:1] + [
    ("  const uint32_t rank = C::CLUSTERED ? cluster_rank() : blockIdx.x % CLUSTER;\n\n"
     "  if (warp == NCW) {\n",
     "  const uint32_t rank = C::CLUSTERED ? cluster_rank() : blockIdx.x % CLUSTER;\n"
     "  unsigned long long* tr = g_trace[blockIdx.x % 2048];\n"
     "  const bool stamp = threadIdx.x == 0;\n" + _ffn_stamp("0", "  ") +
     "  if (stamp) { unsigned sm; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm)); "
     "g_smid[blockIdx.x % 2048] = sm; }\n"
     "\n  if (warp == NCW) {\n"),
    ("        mbar_wait(bars + 8 * s, par);  // the stage's boxes have landed\n",
     "        mbar_wait(bars + 8 * s, par);  // the stage's boxes have landed\n"
     + _ffn_stamp(_FFN_FIRST, "        ", "stamp && first_item && i == 0")),
    ("    if (p == 1) norm_rows<C>(a, g0, rr, sl);\n    // the fragment groups",
     "    if (p == 1) norm_rows<C>(a, g0, rr, sl);\n" + _ffn_stamp("3", "    ", "stamp && p == 1")
     + "    // the fragment groups"),
    ("    if (p < 2) phase_done<C>(a, 2 * p + 1 - a.first, g0);  // after phase 0 and 1\n  }\n}\n\n"
     "template <int MT>\n",
     _ffn_stamp(_FFN_DONE, "    ") + "    if (p < 2) phase_done<C>(a, 2 * p + 1 - a.first, g0);\n"
     "  }\n}\n\ntemplate <int MT>\n"),
    ("  const int c = 16 * wi + 2 * g + wg;  // this thread's column of each 64-column box\n",
     "  const int c = 16 * wi + 2 * g + wg;  // this thread's column of each 64-column box\n"
     "  unsigned long long* tr = g_trace[blockIdx.x % 2048];\n"
     "  const bool stamp = tid == 0;\n" + _ffn_stamp("0", "  ")),
    ("        mbar_wait(b.bars + 8 * s, par);  // the stage's boxes have landed\n",
     "        mbar_wait(b.bars + 8 * s, par);  // the stage's boxes have landed\n"
     + _ffn_stamp(_FFN_FIRST, "        ", "stamp && t == w.unit && i == 0")),
    ("    if (p == 1) norm_rows<C>(a, g0, rr, sl);\n    for (int t = w.unit;",
     "    if (p == 1) norm_rows<C>(a, g0, rr, sl);\n" + _ffn_stamp("3", "    ", "stamp && p == 1")
     + "    for (int t = w.unit;"),
    ("    if (p < 2) phase_done<C>(a, 2 * p + 1 - a.first, g0);  // after phase 1\n  }\n}\n\n"
     "// ---- host side",
     _ffn_stamp(_FFN_DONE, "    ") + "    if (p < 2) phase_done<C>(a, 2 * p + 1 - a.first, g0);\n"
     "  }\n}\n\n// ---- host side"),
] + _trace_patches("ffn90", "md_ffn_sm90_resident")[2:] + [
    ('extern "C" int md_trace_read(void* dst) {',
     'extern "C" int md_smid_read(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_smid, sizeof(g_smid));\n}\n\n"
     'extern "C" int md_trace_read(void* dst) {')]


def _wg_box(mt: int) -> str:
    """D += W^T x^T over one k16 step of weight box BOX: wgmma m64n(16 mt)k16,
    A the bf16 weight box MN-major (transposed, 128-byte swizzle), B the x
    tile K-major, both from the stage; d[4 j + e] is acc[j / 2][2 BOX + j %
    2][e] (box column 16 warp + g + 8 (e / 2), x row 8 j + 2 t4 + e % 2)."""
    regs = [f"acc[{j // 2}][2 * BOX + {j % 2}][{e}]" for j in range(2 * mt) for e in range(4)]
    k = len(regs)
    return (f"template <int BOX>\n__device__ __forceinline__ void wg_box{mt}("
            f"float (&acc)[{mt}][4][4], uint64_t da, uint64_t db) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{16 * mt}k16.f32.bf16.bf16 {{'
            + ", ".join(f"%{i}" for i in range(k))
            + f'}}, %{k}, %{k + 1}, p, 1, 1, 1, 0;\\n}}\\n"\n'
            "      : " + ", ".join(f'"+f"({r})' for r in regs)
            + '\n      : "l"(da), "l"(db), "r"(1));\n}\n\n')


# dense_mlp's other product core (the bf16 instance at M <= 16 and 65..128 rows,
# MT = 1 and 8): the transposed product out^T = W^T x^T on wgmma, the one
# consumer warpgroup issuing both boxes' k16 steps of a stage from shared
# memory (no ldmatrix, no fragments in registers), one stage's products in
# flight while the next lands; the epilogue and the split-K partials take
# the wgmma layout (a lane holds a weight column and x rows 2 t4, 2 t4 + 1).
_FFN_WGMMA = [
    ("// The body of the mma.sync core's kernels (ffn_sm90_kernel: int8 weights,\n",
     _wg_box(1) + _wg_box(8) +
     "// wgmma-layout partial of an item (see _wg_box) for reduce_item\n"
     "template <int MT>\n"
     "__device__ __forceinline__ void store_partial_wg(const Args& a, const Phase& ph, int rg,\n"
     "                                                 int t, int m0, int warp, int lane,\n"
     "                                                 const float (&acc)[MT][4][4]) {\n"
     "  const int c0 = ph.gate ? t * HALF : t * BN;\n"
     "  const int c1 = ph.gate ? ph.Out / 2 + t * HALF : t * BN + HALF;\n"
     "  float* part = a.part + (size_t)rg * a.M * ph.Out;\n"
     "#pragma unroll\n"
     "  for (int mt = 0; mt < MT; ++mt)\n"
     "#pragma unroll\n"
     "    for (int nb = 0; nb < 4; ++nb)\n"
     "#pragma unroll\n"
     "      for (int e = 0; e < 4; ++e) {\n"
     "        const int m = m0 + 16 * mt + 8 * (nb & 1) + 2 * (lane & 3) + (e & 1);\n"
     "        const int c = 16 * warp + (lane >> 2) + 8 * (e >> 1);\n"
     "        if (m < a.M) part[(size_t)m * ph.Out + ((nb >> 1) ? c1 : c0) + c] = acc[mt][nb][e];\n"
     "      }\n"
     "}\n\n"
     "// wgmma-layout epilogue of one fragment group (see _wg_box): bf16 only\n"
     "__device__ __forceinline__ void finish_group_wg(const Phase& ph, int M, int t, int row0,\n"
     "                                                int uw, int lane, const float (&v)[4][4]) {\n"
     "  const int g = lane >> 2, t4 = lane & 3;\n"
     "#pragma unroll\n"
     "  for (int q = 0; q < 2; ++q)\n"
     "#pragma unroll\n"
     "    for (int e = 0; e < 4; ++e) {\n"
     "      const int m = row0 + 8 * q + 2 * t4 + (e & 1), c = 16 * uw + g + 8 * (e >> 1);\n"
     "      if (m >= M) continue;\n"
     "      const float v0 = v[q][e], v1 = v[2 + q][e];\n"
     "      if (ph.gate) {\n"
     "        const float gv = bf16_round(v0), uv = bf16_round(v1);\n"
     "        ph.out[(size_t)m * (ph.Out / 2) + t * HALF + c] =\n"
     "            __float2bfloat16(gv * (1.f / (1.f + expf(-gv))) * uv);\n"
     "        continue;\n"
     "      }\n"
     "#pragma unroll\n"
     "      for (int box = 0; box < 2; ++box) {\n"
     "        const size_t n = (size_t)m * ph.Out + t * BN + box * HALF + c;\n"
     "        float y = bf16_round(box ? v1 : v0);\n"
     "        if (ph.res != nullptr) y += __bfloat162float(ph.res[n]);\n"
     "        ph.out[n] = __float2bfloat16(y);\n"
     "      }\n"
     "    }\n"
     "}\n\n"
     "// The body of the mma.sync core's kernels (ffn_sm90_kernel: int8 weights,\n"),
    ("  const int npass = (a.M + C::R - 1) / C::R;\n  int it = 0, red_n = 0, free_n = 0;\n",
     "  const int npass = (a.M + C::R - 1) / C::R;\n  int it = 0, red_n = 0, free_n = 0;\n"
     "  constexpr bool WG = BF16 && (MT == 1 || MT == 8);\n  int prev = -1;\n"),
    ("        const uint32_t xst = wst + 2 * C::W_BYTES;\n#pragma unroll KU\n",
     "        const uint32_t xst = wst + 2 * C::W_BYTES;\n"
     "        if constexpr (WG) {\n"
     "          wgmma_fence();\n"
     "#pragma unroll\n"
     "          for (int kk = 0; kk < BK / 16; ++kk) {\n"
     "            const uint64_t db = smem_desc(xst, 16, 1024) + 2 * kk;\n"
     "            if constexpr (MT == 1) {\n"
     "              wg_box1<0>(acc, smem_desc(wst, 1024, 1024) + 128 * kk, db);\n"
     "              wg_box1<1>(acc, smem_desc(wst + C::W_BYTES, 1024, 1024) + 128 * kk, db);\n"
     "            } else {\n"
     "              wg_box8<0>(acc, smem_desc(wst, 1024, 1024) + 128 * kk, db);\n"
     "              wg_box8<1>(acc, smem_desc(wst + C::W_BYTES, 1024, 1024) + 128 * kk, db);\n"
     "            }\n"
     "          }\n"
     "          wgmma_commit();\n"
     "          wgmma_wait<1>();  // the previous stage's products are done\n"
     "          if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));\n"
     "          prev = s;\n"
     "          continue;\n"
     "        }\n"
     "#pragma unroll KU\n"),
    ("        mbar_arrive(bars + 8 * (S + s));\n      }\n\n      if (split == 1) {\n",
     "        mbar_arrive(bars + 8 * (S + s));\n      }\n"
     "      if constexpr (WG) {\n"
     "        wgmma_wait<0>();\n"
     "#pragma unroll\n"
     "        for (int mt = 0; mt < MT; ++mt)\n"
     "#pragma unroll\n"
     "          for (int nb = 0; nb < 4; ++nb) fence_regs(acc[mt][nb]);\n"
     "        if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));\n"
     "        prev = -1;\n"
     "      }\n\n      if (split == 1) {\n"),
    ("          finish_group<BF16>(ph, a.M, t, m0 + mt * 16, warp, lane, acc[mt], ops, slots);\n",
     "          if constexpr (WG)\n"
     "            finish_group_wg(ph, a.M, t, m0 + mt * 16, warp, lane, acc[mt]);\n"
     "          else\n"
     "            finish_group<BF16>(ph, a.M, t, m0 + mt * 16, warp, lane, acc[mt], ops,\n"
     "                               slots);\n"),
    ("        store_partial<BF16>(a, ph, w.rg, t, m0, warp, lane, acc);\n",
     "        if constexpr (WG)\n"
     "          store_partial_wg<MT>(a, ph, w.rg, t, m0, warp, lane, acc);\n"
     "        else\n"
     "          store_partial<BF16>(a, ph, w.rg, t, m0, warp, lane, acc);\n"),
]
FFN_STAMPS = ("entry", "phase 0 first stage", "phase 0 done", "norm written",
              "phase 1 first stage", "phase 1 done", "phase 2 first stage", "end")
# B5/B9's ring, stage by stage (clock64 of blocks 0 and 100, their first 64
# stages): [it][0] the consumers start waiting for stage
# it, [1] it has landed, [2] they release it, [3] the producer found its
# slot free and issued it
_FFN_STAGE_TRACE = [
    ("namespace md {\nnamespace ffn90 {\n",
     "__device__ long long g_stages[2][64][4];\n\nnamespace md {\nnamespace ffn90 {\n"),
    ("        mbar_wait(b.bars + 8 * (S + s), par ^ 1);  // the consumers released the stage\n",
     "        mbar_wait(b.bars + 8 * (S + s), par ^ 1);  // the consumers released the stage\n"
     "        if ((blockIdx.x == 0 || blockIdx.x == 100) && it <= 64)\n"
     "          g_stages[blockIdx.x == 100][it - 1][3] = clock64();\n"),
    ("        mbar_wait(bars + 8 * s, par);  // the stage's boxes have landed\n",
     "        const bool st_trace = (blockIdx.x == 0 || blockIdx.x == 100) && threadIdx.x == 0 "
     "&& it <= 64;\n"
     "        if (st_trace) g_stages[blockIdx.x == 100][it - 1][0] = clock64();\n"
     "        mbar_wait(bars + 8 * s, par);  // the stage's boxes have landed\n"
     "        if (st_trace) g_stages[blockIdx.x == 100][it - 1][1] = clock64();\n"),
    ("        mbar_arrive(bars + 8 * (S + s));\n",
     "        mbar_arrive(bars + 8 * (S + s));\n"
     "        if (st_trace) g_stages[blockIdx.x == 100][it - 1][2] = clock64();\n"),
    ("        mbar_wait(b.bars + 8 * s, par);  // the stage's boxes have landed\n",
     "        const bool st_trace = (blockIdx.x == 0 || blockIdx.x == 100) && threadIdx.x == 0 "
     "&& it <= 64;\n"
     "        if (st_trace) g_stages[blockIdx.x == 100][it - 1][0] = clock64();\n"
     "        mbar_wait(b.bars + 8 * s, par);  // the stage's boxes have landed\n"
     "        if (st_trace) g_stages[blockIdx.x == 100][it - 1][1] = clock64();\n"),
    ("        mbar_arrive(b.bars + 8 * (S + s));\n",
     "        mbar_arrive(b.bars + 8 * (S + s));\n"
     "        if (st_trace) g_stages[blockIdx.x == 100][it - 1][2] = clock64();\n"),
    ('extern "C" int md_ffn_sm90_resident(',
     'extern "C" int md_stages_read(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_stages, sizeof(g_stages));\n}\n\n"
     'extern "C" int md_stages_clear() {\n'
     "  static long long zero[2][64][4];\n"
     "  return (int)cudaMemcpyToSymbol(g_stages, zero, sizeof(zero));\n}\n\n"
     'extern "C" int md_ffn_sm90_resident('),
]

# name -> (source, [(old text, new text), ...] applied in order)
VARIANTS = {
    "current": ("dense", []),
    # isolation: the ring, the norm and the reduction without the products
    "no_products": ("dense", [("            wgmma_x_w(acc[b], da + 2 * kk,",
                               "            if (kk < 0) wgmma_x_w(acc[b], da + 2 * kk,")]),
    # the weight loads start at once instead of after the norm's statistic
    "statistic_overlapped": ("dense", [
        ("    if (norm) mbar_wait(stat_bar, 0);\n    for (int t = blockIdx.x;",
         "    for (int t = blockIdx.x;")]),
    # %globaltimer at the phases of each block's first item: 0 entry, 1 the
    # norm's factors (or the cluster's start), 2 the first stage landed, 3
    # the products done, 4 the cluster barrier before the reduction, 5 the
    # partials landed (owners), 6 finished
    "trace": ("dense", _trace_patches("dsm90", "md_dense_matmul_sm90") + [
        ("  int it = 0, red_phase = 0;\n", "  if (stamp) tr[1] = gtime();\n"
         "  int it = 0, red_phase = 0;\n"),
        ("        mbar_wait(bars + 8 * s, (it / S) & 1);  // the stage's boxes have landed\n",
         "        mbar_wait(bars + 8 * s, (it / S) & 1);  // the stage's boxes have landed\n"
         "        if (stamp && i == 0 && t == (int)blockIdx.x && p == 0) tr[2] = gtime();\n"),
        ("      wgmma_wait<0>();\n", "      wgmma_wait<0>();\n" + _stamp(3, "      ")),
        ("      cluster_sync();\n      if (owned > 0 && tid == 0)",
         "      cluster_sync();\n" + _stamp(4, "      ") + "      if (owned > 0 && tid == 0)"),
        ("        ++red_phase;\n", "        ++red_phase;\n" + _stamp(5, "        ")),
        ("      // the owners have read their receive areas",
         _stamp(6, "      ") + "      // the owners have read their receive areas"),
    ]),
    # the same for B4-int4: 0 entry, 1 the cluster's start, 2 the first
    # stage landed, 3 the products done, 4 the partials landed (owners), 5
    # finished
    "int4_trace": ("int4", _trace_patches("sm90", "md_quant_matmul_sm90") + [
        ("  int it = 0, item = 0;\n", "  if (stamp) tr[1] = gtime();\n  int it = 0, item = 0;\n"),
        ("        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed\n",
         "        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed\n"
         "        if (stamp && i == 0 && t == (int)blockIdx.x && p == 0) tr[2] = gtime();\n"),
        ("      if (split == 1) {\n", _stamp(3, "      ") + "      if (split == 1) {\n"),
        ("      mbar_wait(red_bar, item & 1);  // every rank's partials of this rank's groups\n",
         "      mbar_wait(red_bar, item & 1);  // every rank's partials of this rank's groups\n"
         + _stamp(4, "      ")),
        ("      // between two items of a cluster the receive slots are reused\n"
         "      const bool last",
         _stamp(5, "      ") + "      // between two items of a cluster the receive slots are "
         "reused\n      const bool last"),
    ]),
    "int4_current": ("int4", []),
    # one block an SM at MT = 4 (no spills) instead of two with spills
    "int4_one_block": ("int4", [
        ("__launch_bounds__(NTHREADS, MT <= 4 ? 2 : 1)",
         "__launch_bounds__(NTHREADS, MT <= 4 && !(INT4 && MT == 4) ? 2 : 1)")]),
    # four stages at MT = 4 (then one block an SM)
    "int4_four_stages": ("int4", [
        ("INT4 ? (MT == 1 ? 6 : (MT == 2 ? 4 : 2))", "INT4 ? (MT == 1 ? 6 : (MT == 2 ? 4 : 4))"),
        ('  static_assert(MT == 8 || 2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");\n',
         "")]),
    # 32-row passes (MT = 2) for every M instead of 64-row ones
    "int4_32_row_passes": ("int4", [("const int rows = min(a.M, INT4 ? 64 : 128);",
                                     "const int rows = min(a.M, INT4 ? 32 : 128);")]),
    # B6-int4 (qmm4_sm90_kernel): as it stands, and with more k16 steps'
    # wgmmas in flight (three or four A register sets)
    "head_current": ("head", []),
    "head_sets3": ("head", [("constexpr int T4_SETS = 2;", "constexpr int T4_SETS = 3;")]),
    "head_sets4": ("head", [("constexpr int T4_SETS = 2;", "constexpr int T4_SETS = 4;")]),
    # isolation: the head without its products (loads, conversion, scaling)
    "head_no_products": ("head", [
        ("          wgmma_wx<N>(part[0], A[0], xd, first);\n"
         "          wgmma_wx<N>(part[1], A[1], xd, first);\n",
         "          if (kk < 0) wgmma_wx<N>(part[0], A[0], xd, first);\n"
         "          if (kk < 0) wgmma_wx<N>(part[1], A[1], xd, first);\n")]),
    # B5, B9 and B15's dense_mlp (csrc/ffn_sm90.cu): as they stand, traced,
    # and without the products (the ring, the barriers, the reductions and
    # epilogues alone); dense_mlp on the other product core (wgmma)
    "ffn_current": ("ffn", []),
    "ffn_trace": ("ffn", _FFN_TRACE),
    "ffn_stage_trace": ("ffn", _FFN_STAGE_TRACE),
    "ffn_bf16_wgmma": ("ffn", _FFN_WGMMA),
    # isolation: the x boxes read past the tensor (TMA fills them with zeros
    # and reads no memory), so the ring streams the weights alone
    "ffn_no_x": ("ffn", [
        ("&a.xmap[p], full, kt, m0);", "&a.xmap[p], full, kt, m0 + (1 << 20));"),
        ("b.bars + 8 * pend_s[j], pend_kt[j], pend_m[j]);",
         "b.bars + 8 * pend_s[j], pend_kt[j], pend_m[j] + (1 << 20));")]),
    # the 128-row core of B4 / B6 / B4-int4 (csrc/quant_matmul_m128_sm90.cu):
    # as it stands; traced (0 entry, 1 the statistic or the cluster's start,
    # 2 the first stage landed, 3 the products done, 4 the partials landed
    # (owners; with one split, the finish), 5 finished); without the products;
    # with the x tiles read past the tensor (TMA fills zeros and reads no
    # memory); without the norm's pass over each x stage
    "m128_current": ("m128", []),
    "m128_trace": ("m128", _trace_patches("qmt", "md_quant_matmul_m128_sm90") + [
        ("  const float* rr = reinterpret_cast<const float*>(smem + C::RR);\n",
         "  if (stamp) tr[1] = gtime();\n"
         "  const float* rr = reinterpret_cast<const float*>(smem + C::RR);\n"),
        ("        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed\n",
         "        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed\n"
         "        if (stamp && i == 0 && t == (int)blockIdx.x && p == 0) tr[2] = gtime();\n"),
        ("      wgmma_wait<0>();\n      fence_regs(acc);\n",
         "      wgmma_wait<0>();\n      fence_regs(acc);\n" + _stamp(3, "      ")),
        ("        continue;\n      }\n      // unit u = (wg, j)",
         _stamp(4, "        ") + _stamp(5, "        ") + "        continue;\n      }\n"
         "      // unit u = (wg, j)"),
        ("      mbar_wait(red_bar, item & 1);  // every rank's partials of this rank's units\n",
         "      mbar_wait(red_bar, item & 1);  // every rank's partials of this rank's units\n"
         + _stamp(4, "      ")),
        ("      // this rank has read its slots: the arrive of the next item's wait\n",
         _stamp(5, "      ")
         + "      // this rank has read its slots: the arrive of the next item's wait\n"),
    ]),
    "m128_no_products": ("m128", [
        ("            wgmma_n128(part, A, xd, first);", "            if (kk < 0) wgmma_n128(part, A, xd, first);"),
        ("            wgmma_n128(acc, A, xd, 1);", "            if (kk < 0) wgmma_n128(acc, A, xd, 1);")]),
    # four A register sets (three wgmma groups in flight a warpgroup)
    "m128_sets4": ("m128", [("constexpr int NSETS = 2; ", "constexpr int NSETS = 4; ")]),
    "m128_no_x": ("m128", [("&a.xmap, full, kt + 64 * j, p * N);",
                            "&a.xmap, full, kt + 64 * j, p * N + (1 << 20));")]),
    "m128_no_norm_pass": ("m128", [("  if (m0 + r >= M) return;", "  if (m0 + r >= M || M > 0) return;")]),
    "ffn_no_products": ("ffn", [
        ("mma_bf16_16816(acc[mt][nb], af, bf[nb][0], bf[nb][1]);",
         "if (kk < 0) mma_bf16_16816(acc[mt][nb], af, bf[nb][0], bf[nb][1]);"),
        ("          wgmma_n256(acc, A, smem_desc(xst, 16, 1024) + 2 * kk);",
         "          if (kk < 0) wgmma_n256(acc, A, smem_desc(xst, 16, 1024) + 2 * kk);")]),
}
# the phases between a trace variant's stamps
PHASES = {"trace": ("statistic", "first stage", "main loop", "barrier", "partials", "finish"),
          "int4_trace": ("start", "first stage", "main loop", "partials", "finish"),
          "m128_trace": ("start", "first stage", "main loop", "partials", "finish")}
PLANS = ((2, 2), (5, 2), (8, 2), (1, 4), (2, 4), (4, 4), (5, 4), (8, 4))
# label -> the plain version of a case's layer-0 call (dense_mlp), against
# which each variant's output is held (kernels.bf16_limit)
PLAIN = {}


def patched(name: str) -> str:
    """The source of variant ``name``; raises if a patch does not apply."""
    kind, patches = VARIANTS[name]
    text = (CSRC / SOURCES[kind]).read_text()
    for old, new in patches:
        if old not in text:
            raise ValueError(f"variant {name}: the source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build(names):
    from magicdec_tpu_torch.kernels import build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name in names:
        src = OUT_DIR / f"dots_{name}.cu"
        src.write_text(patched(name))
        lib = OUT_DIR / f"libdots_{name}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I", str(CSRC), "-o",
               str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        info = [x.strip() for x in out.splitlines() if ("Used" in x and "registers" in x)
                or ("spill" in x and " 0 bytes spill" not in x)]
        wait = ""
        if VARIANTS[name][0] == "dense":
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                                  text=True).stdout
            body = [f for f in sass.split("Function : ") if "dmm_sm90_kernelILi2ELi4E" in f[:80]]
            wait = (f"; <2, 4>: HGMMA {body[0].count('HGMMA')}, WARPGROUP.DEPBAR "
                    f"{body[0].count('WARPGROUP.DEPBAR')}") if body else "; no SASS"
        print(f"[variant] {name}: {' | '.join(info)}{wait}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        for entry, argtypes in build.SIGNATURES.items():
            fn = getattr(cdll, entry, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def _cases(kind, dev, gen):
    """[(label, In, Out, [one call a layer])] of the dense or the int4 dots,
    of the int4 head (one layer: 131 MB, past the L2), or of B5 and B9."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import dense_matmul as DK
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    L, D, F, bf = 16, 2048, 8192, torch.bfloat16
    if kind == "m128":
        return _m128_cases(dev, gen)
    if kind == "ffn":
        w = {}
        for name, (In, Out) in (("wo", (D, D)), ("w13", (D, 2 * F)), ("w2", (F, D))):
            qw = Q.quantize_weight((torch.randn((L, In, Out), generator=gen, device=dev)
                                    * In ** -0.5).to(bf))
            w[name] = (qw.q, qw.scale.reshape(L, Out))
        norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
        out = []
        for M in (32, 64):
            a, x = (torch.randn((M, D), generator=gen, device=dev).to(bf) for _ in range(2))
            out.append((f"B5 M={M}", D, D, [
                lambda l=l, a=a, x=x: QK.quant_layer_tail(
                    a, x, *(t[l] for n in ("wo", "w13", "w2") for t in w[n]), norm_w, eps=1e-5)
                for l in range(L)]))
        x = torch.randn((256, D), generator=gen, device=dev).to(bf)
        out.append(("B9 M=256", D, D, [
            lambda l=l: QK.quant_mlp(x, *(t[l] for n in ("w13", "w2") for t in w[n]), norm_w, x,
                                     eps=1e-5)
            for l in range(L)]))
        w13 = (torch.randn((L, D, 2 * F), generator=gen, device=dev) * D ** -0.5).to(bf)
        w2 = (torch.randn((L, F, D), generator=gen, device=dev) * (0.25 * F ** -0.5)).to(bf)
        for M in (128, 16):
            x, res = (torch.randn((M, D), generator=gen, device=dev).to(bf) for _ in range(2))
            out.append((f"dense_mlp M={M}", D, D, [
                lambda l=l, x=x, res=res: DK.dense_mlp(x, w13[l], w2[l], norm_w, res)
                for l in range(L)]))
            PLAIN[out[-1][0]] = lambda x=x, res=res: DK.dense_mlp_plain(x, w13[0], w2[0], norm_w,
                                                                       res)
        return out
    if kind == "head":
        V = 128256
        hw = Q.quantize_weight((torch.randn((D, V), generator=gen, device=dev)
                                * D ** -0.5).to(bf), bits=4)
        out = []
        for M in (32, 64):
            x = torch.randn((M, D), generator=gen, device=dev).to(bf)
            out.append((f"lm_head M={M}", D, V,
                        [lambda x=x: QK.quant_matmul_int4(x, hw.q, hw.scale)]))
        return out
    shapes = {"wqkv": (D, D + 1024), "wo": (D, D), "w13": (D, 2 * F), "w2": (F, D)}
    norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
    cases = []
    for name, (In, Out) in shapes.items():
        w = (torch.randn((L, In, Out), generator=gen, device=dev) * In ** -0.5).to(bf)
        if kind == "int4":
            qs = [Q.quantize_weight(w[l], bits=4) for l in range(L)]
            w = [(q.q, q.scale) for q in qs]
        for M in ((128, 16) if kind == "dense" else (32, 64)):
            x = torch.randn((M, In), generator=gen, device=dev).to(bf)
            res = torch.randn((M, Out), generator=gen, device=dev).to(bf)
            if kind == "dense":
                kw = dict(norm_w=norm_w) if name in ("wqkv", "w13") else dict(res=res)
                calls = [lambda l=l, x=x, kw=kw, w=w: DK.dense_matmul_fused(x, w[l], **kw)
                         for l in range(L)]
            else:
                kw = dict(gate=True) if name == "w13" else (dict(res=res) if name != "wqkv"
                                                             else {})
                calls = [lambda l=l, x=x, kw=kw, w=w: QK.quant_matmul_fused_int4(x, *w[l], **kw)
                         for l in range(L)]
            cases.append((f"{name} M={M}", In, Out, calls))
    return cases


def _m128_cases(dev, gen):
    """The quantized target's dots at 128 rows on the 128-row core: at
    llama-3.2-1b widths over 16 layers (int8 wqkv + norm, wo + residual and
    the head; group-wise int8 w13 + norm + gate; int4 w2 + residual) and at
    llama-3.1-8b widths over 4 (int8 wqkv + norm, wo + residual; group-wise
    int8 w13 + norm + gate and w2 + residual; int4 w13 + gate).  Each case:
    (label, In, Out, [one call a layer]), and its layer-0 plain version in
    PLAIN."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    bf, M = torch.bfloat16, 128
    out = []
    for tag, L, D, F, qkv, V in (("1b", 16, 2048, 8192, 3072, 128256),
                                 ("8b", 4, 4096, 14336, 6144, None)):
        norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
        shapes = [("wqkv_norm", D, qkv, 8, 0), ("wo_residual", D, D, 8, 0),
                  ("w13_norm_gate", D, 2 * F, 8, 128)]
        shapes += ([("w2_residual", F, D, 4, 128), ("lm_head", D, V, 8, 0)] if tag == "1b"
                   else [("w2_residual", F, D, 8, 128), ("w13_gate", D, 2 * F, 4, 128)])
        for name, In, Out, bits, group in shapes:
            layers = 1 if name == "lm_head" else L
            w = [Q.quantize_weight((torch.randn((In, Out), generator=gen, device=dev)
                                    * In ** -0.5).to(bf), bits=bits, group_size=group or None)
                 for _ in range(layers)]
            w = [(q.q, q.scale) for q in w]
            x = (torch.randn((M, In), generator=gen, device=dev) * 3).to(bf)
            res = torch.randn((M, Out), generator=gen, device=dev).to(bf)
            kw = ({"norm_w": norm_w} if name.endswith("norm") else
                  {"norm_w": norm_w, "gate": True} if name == "w13_norm_gate" else
                  {"gate": True} if name == "w13_gate" else
                  {"res": res} if name.endswith("residual") else {})
            if bits == 4:
                kw4 = {k: v for k, v in kw.items() if k != "norm_w"}
                fn, plain = (lambda x, q, s, kw4=kw4: QK.quant_matmul_fused_int4(x, q, s, **kw4),
                             lambda x, q, s, kw4=kw4: QK.quant_matmul_fused_int4_plain(
                                 x, q, s, **kw4))
            elif name == "lm_head":
                fn, plain = QK.quant_matmul, QK.quant_matmul_plain
            else:
                fn, plain = (lambda x, q, s, kw=kw: QK.quant_matmul_fused(x, q, s, **kw),
                             lambda x, q, s, kw=kw: QK.quant_matmul_fused_plain(x, q, s, **kw))
            label = f"{tag} {'int4 ' if bits == 4 else 'g8 ' if group else ''}{name}"
            out.append((label, In, Out, [lambda l=l, x=x, w=w, fn=fn: fn(x, *w[l])
                                         for l in range(layers)]))
            PLAIN[label] = lambda x=x, w=w, plain=plain: plain(x, *w[0])
    return out


def _trace(lib, name, label, call):
    import numpy as np

    lib.md_trace_clear()
    call()
    buf = np.zeros((2048, 8), dtype=np.uint64)
    lib.md_trace_read.argtypes = [ctypes.c_void_p]
    if lib.md_trace_read(buf.ctypes.data) != 0:
        raise RuntimeError("md_trace_read failed")
    names = PHASES[name]
    k = len(names)  # the last stamp
    rows = buf[buf[:, 0] > 0].astype(np.int64)
    for j in range(k - 1, k + 1):  # a block that owns nothing skips its last stamps
        rows[:, j] = np.where(rows[:, j] > 0, rows[:, j], rows[:, j - 1])
    d = np.diff(rows[:, :k + 1], axis=1) / 1e3
    span = (rows[:, k].max() - rows[:, 0].min()) / 1e3
    phases = "; ".join(f"{n} {np.median(d[:, i]):.2f} (max {d[:, i].max():.2f})"
                       for i, n in enumerate(names))
    print(f"[trace] {label}: {len(rows)} blocks, span {span:.2f} us; {phases}", flush=True)


def _trace_grid(lib, label, call):
    """Each FFN_STAMPS stamp's median and latest microseconds after the first
    block's entry, over the blocks that reached it."""
    import numpy as np

    lib.md_trace_clear()
    call()
    buf = np.zeros((2048, 8), dtype=np.uint64)
    lib.md_trace_read.argtypes = [ctypes.c_void_p]
    if lib.md_trace_read(buf.ctypes.data) != 0:
        raise RuntimeError("md_trace_read failed")
    rows = buf[buf[:, 0] > 0].astype(np.int64)
    t0 = rows[:, 0].min()
    parts = []
    for k, n in enumerate(FFN_STAMPS):
        v = (rows[:, k][rows[:, k] > 0] - t0) / 1e3
        if len(v):
            parts.append(f"{n} {np.median(v):.2f} (last {v.max():.2f}, {len(v)} blocks)")
    print(f"[trace] {label}: {len(rows)} blocks; " + "; ".join(parts), flush=True)
    if hasattr(lib, "md_smid_read"):
        sm = np.zeros(2048, dtype=np.uint32)
        lib.md_smid_read.argtypes = [ctypes.c_void_p]
        if lib.md_smid_read(sm.ctypes.data) == 0:
            n = len(rows)
            per_sm = np.bincount(sm[:n], minlength=132)
            print(f"[trace] {label}: SMs of cluster 0's ranks {sm[:8].tolist()}, cluster 1's "
                  f"{sm[8:16].tolist()}; blocks an SM {np.bincount(per_sm).tolist()}", flush=True)


def _trace_stages(lib, label, call):
    """The ring of two B5/B9 blocks, cycles a stage: the consumers' wait for
    it, their work on it, and how long a landed stage sat before they came
    to it or a freed slot before the producer refilled it."""
    import numpy as np

    lib.md_stages_clear()
    call()
    torch.cuda.synchronize()
    buf = np.zeros((2, 64, 4), dtype=np.int64)
    lib.md_stages_read.argtypes = [ctypes.c_void_p]
    if lib.md_stages_read(buf.ctypes.data) != 0:
        raise RuntimeError("md_stages_read failed")
    for b, blk in enumerate((0, 100)):
        rows = buf[b][buf[b][:, 2] > 0]
        if not len(rows):
            continue
        wait = rows[:, 1] - rows[:, 0]
        work = rows[:, 2] - rows[:, 1]
        issue_to_land = rows[:, 1] - rows[:, 3]
        gaps = rows[1:, 0] - rows[:-1, 2]  # between stages: the items' reductions, epilogues
        print(f"[stages] {label} block {blk}: {len(rows)} stages, {rows[-1, 2] - rows[0, 0]} "
              f"cycles; consumer wait median {np.median(wait):.0f} (max {wait.max()}) cycles, "
              f"work median {np.median(work):.0f} (max {work.max()}), issue to "
              f"landed-and-seen median {np.median(issue_to_land):.0f}; gaps over 200 cycles "
              f"(after stage: cycles): "
              + " ".join(f"{i}:{g}" for i, g in enumerate(gaps) if g > 200)
              + "; wait/work a stage: "
              + " ".join(f"{w}/{k}" for w, k in zip(wait[:40], work[:40])), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--plans", action="store_true")
    p.add_argument("--ffn_plans", action="store_true",
                   help="also time B5/B9 on the current source with each w13 split forced")
    p.add_argument("--m128_plans", action="store_true",
                   help="also time the 128-row core's cases with each split forced")
    args = p.parse_args(argv)
    from magicdec_tpu_torch.kernel_benchmark import graph_ms
    from magicdec_tpu_torch.kernels import build
    from magicdec_tpu_torch.kernels import dense_matmul as DK

    if not torch.cuda.is_available():
        raise SystemExit("dot_variants times the card's kernels: it needs a CUDA card")
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = _build(names)
    print(f"[variant] built {len(libs)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {kind: _cases(kind, dev, gen) for kind in {VARIANTS[n][0] for n in names}}
    results = {}
    library, plan = build.library, DK.dense_plan
    try:
        for name in names:
            build.library = lambda lib=libs[name]: lib
            for label, _, _, calls in cases[VARIANTS[name][0]]:
                ms = results[f"{name} {label}"] = graph_ms(calls)
                print(f"[variant] {name:22s} {label:10s} {ms:8.4f} ms", flush=True)
                if label in PLAIN:
                    from magicdec_tpu_torch.kernels import bf16_limit

                    out, ref = calls[0](), PLAIN[label]()
                    bad = int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())
                    print(f"[variant] {name} {label}: {bad} of {ref.numel()} outside "
                          "bf16_limit of the plain version", flush=True)
                if name in PHASES:
                    _trace(libs[name], name, label, calls[0])
                if name == "ffn_trace":
                    _trace_grid(libs[name], label, calls[0])
                if name == "ffn_stage_trace":
                    _trace_stages(libs[name], label, calls[0])
        if args.ffn_plans and "ffn_current" in names:
            from magicdec_tpu_torch.kernels import quant_matmul as QK

            build.library = lambda: libs["ffn_current"]
            plan = QK.ffn_plan
            try:
                for split in QK.FFN_SPLITS:
                    # the w13 dot (In = D, Out = 2F) takes ``split``, the others the plan's
                    QK.ffn_plan = lambda dots, m, r, sp=split: tuple(
                        sp if o == 2 * dots[-1][0] else plan([(i, o)], m, r)[0]
                        for i, o in dots)
                    for label, _, _, calls in cases["ffn"]:
                        if label.startswith("dense_mlp"):
                            continue
                        ms = results[f"ffn w13 split {split} {label}"] = graph_ms(calls)
                        print(f"[plan] {label:10s} w13 split {split}: {ms:8.4f} ms", flush=True)
            finally:
                QK.ffn_plan = plan
            # dense_mlp: every (w13, w2) split pair
            dplan = DK.dense_mlp_plan
            try:
                for s13 in QK.FFN_SPLITS:
                    for s2 in QK.FFN_SPLITS:
                        DK.dense_mlp_plan = lambda d, f, c, sp=(s13, s2): sp
                        for label, _, _, calls in cases["ffn"]:
                            if label.startswith("dense_mlp"):
                                ms = results[f"dense_mlp split {s13}x{s2} {label}"] = \
                                    graph_ms(calls)
                                print(f"[plan] {label:14s} split {s13} x {s2}: {ms:8.4f} ms",
                                      flush=True)
            finally:
                DK.dense_mlp_plan = dplan
        if args.m128_plans and "m128_current" in names:
            from magicdec_tpu_torch.kernels import quant_matmul as QK

            build.library = lambda: libs["m128_current"]
            plan = QK.m128_split_plan
            try:
                for label, In, Out, calls in cases["m128"]:
                    stage = 128 if "int4" in label else 64
                    unit = 128 if "int4" in label or "g8" in label else 64
                    for split in range(1, 9):
                        units = In // unit
                        if split > units or -(-units // -(-units // split)) != split:
                            continue
                        QK.m128_split_plan = lambda i, o, u, st, sp=split: sp
                        ms = results[f"m128 split {split} {label}"] = graph_ms(calls)
                        print(f"[plan] {label:22s} split {split}: {ms:8.4f} ms "
                              f"(the plan's: {plan(In, Out, unit, stage)})", flush=True)
            finally:
                QK.m128_split_plan = plan
        if args.plans and "current" in names:
            build.library = lambda: libs["current"]
            for label, In, Out, calls in cases["dense"]:
                for split, boxes in PLANS:
                    tiles = In // 64
                    if Out % (64 * boxes) or -(-tiles // -(-tiles // split)) != split:
                        continue
                    DK.dense_plan = lambda i, o, n, sb=(split, boxes): sb
                    ms = results[f"plan {split}x{boxes} {label}"] = graph_ms(calls)
                    print(f"[plan] {label:10s} split {split} boxes {boxes}: {ms:8.4f} ms",
                          flush=True)
                DK.dense_plan = plan
    finally:
        build.library, DK.dense_plan = library, plan
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": results}))
    return results


if __name__ == "__main__":
    main()
