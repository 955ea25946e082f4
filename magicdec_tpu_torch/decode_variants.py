"""Variants of the decode attention kernel (``decode_sm90_kernel``: K1 over
the bf16 cache, K1q over int8, B10 over int4 packed in head pairs, and
B12's bf16 pool) timed against each other on the card, in one process.

    python -m magicdec_tpu_torch.decode_variants [--variants a,b,...]
        [--formats int8,int4,bf16,bf16_draft,bf16_paged] [--blocks 264,528]
        [--csrc DIR]

Each variant is a copy of the kernel sources (``--csrc``, default the
package's ``csrc/``) with the text patches of ``VARIANTS`` applied to the
files they name; its sources compile together with ``nvcc`` (all variants
in parallel) into ``build/variants/decode_<name>/``.  The wrappers
``flash_decode_attend_quant``, ``flash_decode_attend_quant4``,
``flash_decode_attend`` and ``flash_paged_decode_attend`` then run on it
(``build.library`` swapped, so the split plan is the wrappers' own) at the
bench's shapes, llama-3.2-1b widths and 16 layers: ``int8`` and ``int4``,
K1q and B10 at B=32 over an 8704-row cache quantized from bf16 randn,
ragged lengths in [8192, 8600), T = 4 and 1; ``bf16``, K1 over the same
bf16 cache at T = 4, 1 and 9; ``bf16_draft``, K1's whole-row draft call at
B=32 over 640 rows, lengths in [513, 600), T = 1 and 2; ``bf16_paged``, B12
over 16 slots of 8192 rows in 512-row pages (a permuted table), lengths
ragged in [0, 8188], T = 4; each with the window's fresh rows.  Device ms a
call by ``kernel_benchmark.graph_ms`` over the layers in turn, and the
elements of one layer outside ``kernels.bf16_limit`` of the plain version
(0 for a variant that computes the same function).  ``--blocks`` times the
bf16 formats again on ``current`` and the ``bf16_stages`` variants at each
given ``PLAN_BLOCKS`` (the blocks ``kernels/decode_attention.py
split_plan`` aims at; ``0`` means one split).  ptxas's registers and spills
of each variant are printed.  Besides ``current`` (the source as it
stands): ``copies_alone`` (every format) and ``compute_alone`` (int8, int4)
(isolation), ``blocks4`` (int8, int4: four blocks an SM at 128 registers,
with the wrappers' plan to match) and ``bf16_stages4`` / ``bf16_stages5``
(bf16: three or four tiles a warp in flight).

A trace variant records ``clock64`` at the phases of each tile of one
block (split 0 of request 0, kv head or pair 0, the first rows); the script
prints the mean cycles a tile of each phase over its middle tiles (bf16:
S and the softmax of the last row tile a warp holds).  ``parent_trace``
patches the PR 10 core (``attention_common.cuh``'s ``attend_kernel``, its
int8 and int4 instances in ``decode_attention_quant{,4}.cu``): it applies to
a checkout of that design only, run as

    PYTHONPATH=<checkout> python magicdec_tpu_torch/decode_variants.py \\
        --csrc <checkout>/magicdec_tpu_torch/csrc --variants parent_trace

so that the wrappers and their split plan are the checkout's.  The last line
is a JSON object of the device milliseconds.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "variants"

_PARENT_STAMP = (
    "static __device__ long long md_g_trace[64][8];\n"
    "#define MD_TRACE(c, k) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
    "threadIdx.x == 0 && (c) / 32 < 64) md_g_trace[(c) / 32][k] = clock64()\n")


def _reader(name: str, symbol: str) -> str:
    """A C entry point that copies the trace out and clears it."""
    return (f'extern "C" int {name}(void* dst) {{\n'
            f"  void* p = nullptr;\n"
            f"  cudaGetSymbolAddress(&p, {symbol});\n"
            f"  const int err = (int)cudaMemcpy(dst, p, sizeof({symbol}), "
            f"cudaMemcpyDeviceToHost);\n"
            f"  cudaMemset(p, 0, sizeof({symbol}));\n"
            f"  return err;\n}}\n")


_STAMP = ("static __device__ long long md_g_trace[4][64][8];\n"
          "#define MD_TRACE(k) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
          "lane == 0 && it < 64) md_g_trace[warp][it][k] = clock64()\n")

# name -> (sources compiled into the variant's library, {file: [(old, new), ...]})
VARIANTS = {
    "current": (["decode_attention_sm90.cu"], {}),
    # decode_sm90_kernel: clock64 by each warp of one block at the top of
    # each of its 16-position tiles (0), after the wait for it (1), after
    # issuing the copies of its tile two ahead (2), after S of every head
    # (ldmatrix, conversion, products) (3), after the softmax (4), after
    # P.V (5)
    "trace": (["decode_attention_sm90.cu"], {
        "decode_attention_sm90.cu": [
            ("namespace md {\nnamespace dq90 {\n", "namespace md {\nnamespace dq90 {\n" + _STAMP),
            ("    cp_async_wait<STAGES - 2>();  // this lane's copies of tile `it` have landed\n"
             "    __syncwarp();",
             "    MD_TRACE(0);\n"
             "    cp_async_wait<STAGES - 2>();  // this lane's copies of tile `it` have landed\n"
             "    __syncwarp();\n    MD_TRACE(1);"),
            ("    cp_async_commit();\n    const St& s = sm.ring[warp][it % STAGES];\n",
             "    cp_async_commit();\n    MD_TRACE(2);\n"
             "    const St& s = sm.ring[warp][it % STAGES];\n"),
            ("    // The online softmax of each head",
             "    MD_TRACE(3);\n    // The online softmax of each head"),
            # (both bodies: the bf16 comment starts the same)
            ("    // O += P V.  V words", "    MD_TRACE(4);\n    // O += P V.  V words"),
            ("          mma_bf16_16816(o[hh][4 * D + 2 * h2 + 1], pa[hh], o0, o1);\n        }\n"
             "      }\n  }\n  cp_async_wait<0>();\n",
             "          mma_bf16_16816(o[hh][4 * D + 2 * h2 + 1], pa[hh], o0, o1);\n        }\n"
             "      }\n    MD_TRACE(5);\n  }\n  cp_async_wait<0>();\n"),
            ('}  // namespace dq90\n}  // namespace md\n',
             '}  // namespace dq90\n}  // namespace md\n\n'
             + _reader("md_trace_read_int8", "md::dq90::md_g_trace")
             + _reader("md_trace_read_int4", "md::dq90::md_g_trace")
             + _reader("md_trace_read_bf16", "md::dq90::md_g_trace")),
            # the bf16 body's loop: the other five of the same six stamps
            ("    cp_async_wait<BF_STAGES - 2>();",
             "    MD_TRACE(0);\n    cp_async_wait<BF_STAGES - 2>();"),
            ("    __syncwarp();  // every lane's; and tile it - 1's reads are done\n",
             "    __syncwarp();  // every lane's; and tile it - 1's reads are done\n"
             "    MD_TRACE(1);\n"),
            ("    cp_async_commit();\n    const uint32_t ks = smem_u32(",
             "    cp_async_commit();\n    MD_TRACE(2);\n    const uint32_t ks = smem_u32("),
            ("      const bool whole = __all_sync(0xffffffffu, c0 + NR <= lim_min[mt]);\n",
             "      MD_TRACE(3);\n"
             "      const bool whole = __all_sync(0xffffffffu, c0 + NR <= lim_min[mt]);\n"),
            ("        mma_bf16_16816(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);\n      }\n    }\n"
             "  }\n",
             "        mma_bf16_16816(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);\n      }\n    }\n"
             "    MD_TRACE(5);\n  }\n"),
        ],
    }),
    # PR 10's attend_kernel<64, 32, 1, 1, QUANT, INT4>: clock64 at the top of
    # each 32-row tile (0), after issuing the next tile's copies (1), after
    # the wait for this tile (2), after the conversion to bf16 (3), after the
    # barrier (4), after S (5), after the softmax (6), after P.V (7); the
    # next tile's stamp 0 closes the second barrier
    "parent_trace": (["decode_attention_quant.cu", "decode_attention_quant4.cu"], {
        "attention_common.cuh": [
            ("namespace md {\n\nconstexpr float kNegInf = -1e30f;\n",
             "namespace md {\n\nconstexpr float kNegInf = -1e30f;\n" + _PARENT_STAMP),
            ("  float mx[2] = {kNegInf, kNegInf};\n",
             "  if constexpr (QUANT) MD_TRACE(col0, 5);\n  float mx[2] = {kNegInf, kNegInf};\n"),
            ("  // O += P V: P (rounded to bf16",
             "  if constexpr (QUANT) MD_TRACE(col0, 6);\n  // O += P V: P (rounded to bf16"),
            ("      mma_bf16_16816(w.o[n + 1], a, b[2], b[3]);\n    }\n  }\n}\n",
             "      mma_bf16_16816(w.o[n + 1], a, b[2], b[3]);\n    }\n  }\n"
             "  if constexpr (QUANT) MD_TRACE(col0, 7);\n}\n"),
            ("    if (c0 + N < hi_s) issue(stage ^ 1, c0 + N);\n    cp_async_commit();\n"
             "    cp_async_wait<1>();  // all groups but the newest have landed: this stage\n",
             "    MD_TRACE(c0, 0);\n"
             "    if (c0 + N < hi_s) issue(stage ^ 1, c0 + N);\n    cp_async_commit();\n"
             "    MD_TRACE(c0, 1);\n"
             "    cp_async_wait<1>();  // all groups but the newest have landed: this stage\n"
             "    MD_TRACE(c0, 2);\n"),
            ("    if constexpr (QUANT) {\n      __syncthreads();\n      tile_update<HD, N, true>",
             "    MD_TRACE(c0, 3);\n    if constexpr (QUANT) {\n      __syncthreads();\n"
             "      MD_TRACE(c0, 4);\n      tile_update<HD, N, true>"),
        ],
        "decode_attention_quant.cu": [
            ('#include "attention_common.cuh"\n',
             '#include "attention_common.cuh"\n\n' + _reader("md_trace_read_int8",
                                                            "md::md_g_trace")),
        ],
        "decode_attention_quant4.cu": [
            ('#include "attention_common.cuh"\n',
             '#include "attention_common.cuh"\n\n' + _reader("md_trace_read_int4",
                                                            "md::md_g_trace")),
        ],
    }),
}
# isolation: the copies without the arithmetic (each tile's products and
# softmax skipped), the arithmetic on whatever the rings hold (no copy is
# issued)
VARIANTS["copies_alone"] = (["decode_attention_sm90.cu"], {"decode_attention_sm90.cu": [
    ("    // S of each head.", "    if (false) {\n    // S of each head."),
    ("      }\n  }\n  cp_async_wait<0>();\n", "      }\n    }\n  }\n  cp_async_wait<0>();\n"),
    ("    // Each row tile: S = Q K^T", "    if (false) {\n    // Each row tile: S = Q K^T"),
    ("vb[2], vb[3]);\n      }\n    }\n  }\n  cp_async_wait<0>();\n",
     "vb[2], vb[3]);\n      }\n    }\n    }\n  }\n  cp_async_wait<0>();\n")]})
VARIANTS["compute_alone"] = (["decode_attention_sm90.cu"], {"decode_attention_sm90.cu": [
    ("    if (st < mine) issue(st, lo + (warp + st * NW) * NR);\n", ""),
    ("    if (it + STAGES - 1 < mine)\n"
     "      issue((it + STAGES - 1) % STAGES, lo + (warp + (it + STAGES - 1) * NW) * NR);\n",
     "")]})
# four pair blocks an SM (128 registers a thread), the plan's wave to match
VARIANTS["blocks4"] = (["decode_attention_sm90.cu"], {"decode_attention_sm90.cu": [
    ("(HEADS == 1 ? 4 : 3)", "(HEADS == 1 ? 4 : 4)")]})
# bf16: deeper rings (three or four tiles a warp in flight; the shared
# memory then holds three or two blocks an SM, as many as the plan aims at)
for _n in (4, 5):
    VARIANTS[f"bf16_stages{_n}"] = (["decode_attention_sm90.cu"], {"decode_attention_sm90.cu": [
        ("constexpr int BF_STAGES = 3;", f"constexpr int BF_STAGES = {_n};")]})
# the wrappers' plan of a variant: decode_attention attributes it sets
PLANS = {"blocks4": {"PLAN_BLOCKS": 132 * 4}}
# the formats a variant applies to (all when absent): compute_alone issues no
# copy, so the bf16 body would wait for its boxes forever
FORMATS = {"compute_alone": ("int8", "int4"), "blocks4": ("int8", "int4"),
           "parent_trace": ("int8", "int4"),
           **{f"bf16_stages{n}": ("bf16", "bf16_draft", "bf16_paged") for n in (4, 5)}}

# what each stamp of a trace variant closes, in order, and the traced warps
PHASES = {
    "parent_trace": ["issue the next copies", "wait for the tile", "convert to bf16",
                     "barrier", "S", "softmax", "P.V", "barrier and loop"],
    "trace": ["wait for the tile", "issue the copies two tiles ahead", "S", "softmax", "P.V",
              "loop"],
}
TRACE_WARPS = {"parent_trace": 1, "trace": 4}


def patched(name: str, csrc: Path = CSRC) -> dict:
    """{file name: text} of variant ``name``'s patched files; raises if a
    patch does not apply."""
    _, patches = VARIANTS[name]
    out = {}
    for fname, pairs in patches.items():
        text = (csrc / fname).read_text()
        for old, new in pairs:
            if old not in text:
                raise ValueError(f"variant {name}: {fname} no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        out[fname] = text
    return out


class _Library:
    """The C entry points of one variant's library, argtypes declared."""

    def __init__(self, path: Path):
        from magicdec_tpu_torch.kernels import build

        self.cdll = ctypes.CDLL(str(path))
        for entry, argtypes in build.SIGNATURES.items():
            fn = getattr(self.cdll, entry, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, entry, fn)


def _build(names, csrc: Path):
    from magicdec_tpu_torch.kernels import build

    nvcc = build.nvcc_path()
    procs = {}
    for name in names:
        vdir = OUT_DIR / f"decode_{name}"
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for src in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
            shutil.copy(src, vdir / src.name)
        for fname, text in patched(name, csrc).items():
            (vdir / fname).write_text(text)
        sources, _ = VARIANTS[name]
        lib = vdir / "libvariant.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-o", str(lib),
               *(str(vdir / s) for s in sources)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and ("attend" in line or "decode" in line):
                detail = " | ".join(x.split("ptxas info    :")[-1].strip()
                                    for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x)
                print(f"[variant] {name}: {line.split(chr(39))[1][:60]}: {detail}", flush=True)
        libs[name] = _Library(lib)
    return libs


def _trace(lib, name, fmt):
    import numpy as np

    read = getattr(lib.cdll, f"md_trace_read_{fmt.split('_')[0]}", None)
    if read is None:
        return
    nw, k = TRACE_WARPS[name], len(PHASES[name])
    buf = np.zeros((nw, 64, 8), dtype=np.int64)
    read.argtypes = [ctypes.c_void_p]
    if read(buf.ctypes.data) != 0:
        raise RuntimeError("md_trace_read failed")
    for w in range(nw):
        rows = buf[w][buf[w][:, 0] > 0].astype(np.float64)
        n = len(rows)
        mid = rows[8:n - 4] if n > 16 else rows
        ends = np.append(mid[1:, 0], np.nan)  # the next tile's first stamp
        stamps = np.concatenate([mid[:, :k], ends[:, None]], axis=1)[:-1]
        d = np.diff(stamps, axis=1).mean(axis=0)
        phases = "; ".join(f"{p} {c:.0f}" for p, c in zip(PHASES[name], d))
        print(f"[trace] {name} {fmt} warp {w}: {n} tiles, a tile "
              f"{np.diff(mid[:, 0]).mean():.0f} cycles over tiles 8 to {n - 5}: {phases}",
              flush=True)


def _time(name, lib, fmt, T, fn, q, caches, base, fresh, ref, results):
    """One variant on one case: the elements outside bf16_limit of the
    plain version on layer 0, the device ms a call over the 16 layers, and
    a trace variant's phases."""
    from magicdec_tpu_torch.kernel_benchmark import graph_ms
    from magicdec_tpu_torch.kernels import bf16_limit

    out = fn(q, *caches, base, layer=0, **fresh)
    torch.cuda.synchronize()
    outside = int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())
    ms = graph_ms([lambda l=l: fn(q, *caches, base, layer=l, **fresh)
                   for l in range(len(caches[0]))])
    results[f"{fmt}_T{T}_{name}"] = ms
    print(f"[variant] {fmt} T={T} {name:24s} {ms:8.4f} ms  {outside} elements outside "
          "bf16_limit", flush=True)
    if name in PHASES:
        _trace(lib, name, fmt)


def _cases(fmt, gen, dev):
    """(wrapper, plain version, caches, base, [(T, q, fresh)]) of one format
    (see the module docstring)."""
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import paged_attention as PGA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens, quantize_kv_tokens_int4

    L, Hq, Hkv, hd = 16, 32, 8, 64
    K = Hkv * hd
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def windows(B, Ts, quant=None):
        out = []
        for T in Ts:
            if quant is None:
                fresh = {"k_new": randn(B, T, K), "v_new": randn(B, T, K)}
            else:
                (kn, ksn), (vn, vsn) = (quant(randn(B, T, Hkv, hd)) for _ in range(2))
                fresh = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
            out.append((T, randn(B, T, Hq, hd), fresh))
        return out

    if fmt in ("int8", "int4"):
        B, S = 32, 8704
        qfn = quantize_kv_tokens if fmt == "int8" else quantize_kv_tokens_int4
        kq, ks, vq, vs = [], [], [], []
        for _ in range(L):  # a layer at a time: the float32 temporaries
            (k1, k2), (v1, v2) = (qfn(randn(B, S, Hkv, hd)) for _ in range(2))
            kq.append(k1), ks.append(k2), vq.append(v1), vs.append(v2)
        caches = tuple(torch.stack(x) for x in (kq, ks, vq, vs))
        base = torch.randint(8192, 8600, (B,), generator=gen, device=dev, dtype=torch.int32)
        fn = DA.flash_decode_attend_quant if fmt == "int8" else DA.flash_decode_attend_quant4
        plain = (DA.flash_decode_attend_quant_plain if fmt == "int8"
                 else DA.flash_decode_attend_quant4_plain)
        return fn, plain, caches, base, windows(B, (4, 1), qfn)
    if fmt == "bf16_paged":
        B, S, ps, T = 16, 8192, 512, 4
        npr = S // ps
        P = B * npr
        caches = (randn(L, P, ps, K), randn(L, P, ps, K),
                  torch.randperm(P, generator=gen, device=dev).to(torch.int32).reshape(B, npr))
        base = torch.randint(0, S - T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        return (PGA.flash_paged_decode_attend, PGA.flash_paged_decode_attend_plain, caches,
                base, windows(B, (T,)))
    B, S, lo, hi, Ts = ((32, 640, 513, 600, (1, 2)) if fmt == "bf16_draft"
                        else (32, 8704, 8192, 8600, (4, 1, 9)))
    caches = (randn(L, B, S, K), randn(L, B, S, K))
    base = torch.randint(lo, hi, (B,), generator=gen, device=dev, dtype=torch.int32)
    return DA.flash_decode_attend, DA.flash_decode_attend_plain, caches, base, windows(B, Ts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--formats", default="int8,int4")
    p.add_argument("--blocks", default="",
                   help="bf16 formats: PLAN_BLOCKS values to time on current (0: one split)")
    p.add_argument("--csrc", default=str(CSRC))
    args = p.parse_args(argv)
    from magicdec_tpu_torch.kernels import build
    from magicdec_tpu_torch.kernels import decode_attention as DA

    if not torch.cuda.is_available():
        raise SystemExit("decode_variants times the card's kernels: it needs a CUDA card")
    names = args.variants.split(",")
    blocks = [int(c) for c in args.blocks.split(",") if c]
    t0 = time.perf_counter()
    libs = _build(names, Path(args.csrc))
    print(f"[variant] built {len(libs)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    library = build.library
    try:
        for fmt in args.formats.split(","):
            fn, plain, caches, base, cases = _cases(fmt, gen, dev)
            for T, q, fresh in cases:
                ref = plain(q, *caches, base, layer=0, **fresh)
                runs = [(name, {}) for name in libs if fmt in FORMATS.get(name, (fmt,))]
                if fmt.startswith("bf16"):
                    runs += [(f"{name}_blocks{c}", {"PLAN_BLOCKS": c}) for c in blocks
                             for name in libs if name == "current" or "stages" in name]
                for label, plan in runs:
                    name = label.split("_blocks")[0]
                    lib = libs[name]
                    build.library = lambda lib=lib: lib
                    plan = {**PLANS.get(name, {}), **plan}
                    saved = {k: getattr(DA, k) for k in plan}
                    for k, v in plan.items():
                        setattr(DA, k, v)
                    try:
                        _time(label, lib, fmt, T, fn, q, caches, base, fresh, ref, results)
                    except RuntimeError as exc:  # a variant that does not launch
                        print(f"[variant] {fmt} T={T} {label}: {exc}", flush=True)
                    finally:
                        for k, v in saved.items():
                            setattr(DA, k, v)
            del caches
            torch.cuda.empty_cache()
    finally:
        build.library = library
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": results}))
    return results


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
