"""Variants of B15's ``dense_matmul_fused`` (``csrc/dense_matmul_sm90.cu``),
of B4-int4 and of B6-int4 (``csrc/quant_matmul_sm90.cu``) timed against
each other on the card, in one process.

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
and 64), device ms a call by ``kernel_benchmark.graph_ms``.  For each variant
the script prints ptxas's registers and spills and, for the dense kernel,
the ``HGMMA`` instructions against the ``WARPGROUP.DEPBAR`` waits in
``cuobjdump -sass`` (one wait an ``HGMMA``: ptxas serialized the wgmmas).
``trace`` and ``int4_trace`` stamp ``%globaltimer`` at the phases of each
block's first item; the script prints, per case, the median and largest
microseconds of each phase over the blocks.  ``--plans`` also times the current dense kernel
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
           "head": "quant_matmul_sm90.cu"}


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
}
# the phases between a trace variant's stamps
PHASES = {"trace": ("statistic", "first stage", "main loop", "barrier", "partials", "finish"),
          "int4_trace": ("start", "first stage", "main loop", "partials", "finish")}
PLANS = ((2, 2), (5, 2), (8, 2), (1, 4), (2, 4), (4, 4), (5, 4), (8, 4))


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
    """[(label, [one call a layer])] of the dense or the int4 dots, or of the
    int4 head (one layer: 131 MB, past the L2)."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import dense_matmul as DK
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    L, D, F, bf = 16, 2048, 8192, torch.bfloat16
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--plans", action="store_true")
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
                if name in PHASES:
                    _trace(libs[name], name, label, calls[0])
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
