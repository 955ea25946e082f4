"""Variants of the quantized decode attention kernels K1q (int8) and B10
(int4 packed in head pairs) timed against each other on the card, in one
process.

    python -m magicdec_tpu_torch.decode_variants [--variants a,b,...]
        [--formats int8,int4] [--csrc DIR]

Each variant is a copy of the kernel sources (``--csrc``, default the
package's ``csrc/``) with the text patches of ``VARIANTS`` applied to the
files they name; its sources compile together with ``nvcc`` (all variants
in parallel) into ``build/variants/decode_<name>/``.  The wrappers
``flash_decode_attend_quant`` and ``flash_decode_attend_quant4`` then run on
it (``build.library`` swapped, so the split plan is the wrappers' own) at
the bench's shapes: llama-3.2-1b widths, B=32, a 16-layer cache of 8704
rows quantized from bf16 randn, ragged lengths in [8192, 8600), T = 4 and
1 with the window's fresh rows; device ms a call by
``kernel_benchmark.graph_ms`` over the layers in turn, and the elements of
one layer outside ``kernels.bf16_limit`` of the plain version (0 for a
variant that computes the same function).  ptxas's registers and spills of
each variant are printed.  Besides ``current`` (the source as it stands):
``copies_alone`` and ``compute_alone`` (isolation) and ``blocks4`` (four
blocks an SM at 128 registers, with the wrappers' plan to match).

A trace variant records ``clock64`` at the phases of each tile of one
block (split 0 of request 0, kv head or pair 0); the script prints the
mean cycles a tile of each phase over its middle tiles.  ``parent_trace``
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
            ("    // O += P V.  V words", "    MD_TRACE(4);\n    // O += P V.  V words"),
            ("          mma_bf16_16816(o[hh][4 * D + 2 * h2 + 1], pa[hh], o0, o1);\n        }\n"
             "      }\n  }\n  cp_async_wait<0>();\n",
             "          mma_bf16_16816(o[hh][4 * D + 2 * h2 + 1], pa[hh], o0, o1);\n        }\n"
             "      }\n    MD_TRACE(5);\n  }\n  cp_async_wait<0>();\n"),
            ('}  // namespace dq90\n}  // namespace md\n',
             '}  // namespace dq90\n}  // namespace md\n\n'
             + _reader("md_trace_read_int8", "md::dq90::md_g_trace")
             + _reader("md_trace_read_int4", "md::dq90::md_g_trace")),
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
    ("      }\n  }\n  cp_async_wait<0>();\n", "      }\n    }\n  }\n  cp_async_wait<0>();\n")]})
VARIANTS["compute_alone"] = (["decode_attention_sm90.cu"], {"decode_attention_sm90.cu": [
    ("    if (st < mine) issue(st, lo + (warp + st * NW) * NR);\n", ""),
    ("    if (it + STAGES - 1 < mine)\n"
     "      issue((it + STAGES - 1) % STAGES, lo + (warp + (it + STAGES - 1) * NW) * NR);\n",
     "")]})
# four pair blocks an SM (128 registers a thread), the plan's wave to match
VARIANTS["blocks4"] = (["decode_attention_sm90.cu"], {"decode_attention_sm90.cu": [
    ("__launch_bounds__(NW * 32, HEADS == 1 ? 4 : 3)",
     "__launch_bounds__(NW * 32, HEADS == 1 ? 4 : 4)")]})
# the wrappers' plan of a variant: decode_attention attributes it sets
PLANS = {"blocks4": {"QUANT_BLOCKS": 132 * 4}}

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

    read = getattr(lib.cdll, f"md_trace_read_{fmt}", None)
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--formats", default="int8,int4")
    p.add_argument("--csrc", default=str(CSRC))
    args = p.parse_args(argv)
    from magicdec_tpu_torch.kernels import build
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens, quantize_kv_tokens_int4

    if not torch.cuda.is_available():
        raise SystemExit("decode_variants times the card's kernels: it needs a CUDA card")
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = _build(names, Path(args.csrc))
    print(f"[variant] built {len(libs)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, S, Hq, Hkv, hd = 16, 32, 8704, 32, 8, 64
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    base = torch.randint(8192, 8600, (B,), generator=gen, device=dev, dtype=torch.int32)
    kinds = {"int8": (quantize_kv_tokens, DA.flash_decode_attend_quant,
                      DA.flash_decode_attend_quant_plain),
             "int4": (quantize_kv_tokens_int4, DA.flash_decode_attend_quant4,
                      DA.flash_decode_attend_quant4_plain)}
    results = {}
    library = build.library
    try:
        for fmt in args.formats.split(","):
            qfn, fn, plain = kinds[fmt]
            kq, ks, vq, vs = [], [], [], []
            for _ in range(L):  # a layer at a time: the float32 temporaries
                (k1, k2), (v1, v2) = (qfn(randn(B, S, Hkv, hd)) for _ in range(2))
                kq.append(k1), ks.append(k2), vq.append(v1), vs.append(v2)
            caches = tuple(torch.stack(x) for x in (kq, ks, vq, vs))
            del kq, ks, vq, vs
            for T in (4, 1):
                q = randn(B, T, Hq, hd)
                (kn, ksn), (vn, vsn) = (qfn(randn(B, T, Hkv, hd)) for _ in range(2))
                fresh = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
                ref = plain(q, *caches, base, layer=0, **fresh)
                for name, lib in libs.items():
                    build.library = lambda lib=lib: lib
                    saved = {k: getattr(DA, k) for k in PLANS.get(name, {})}
                    for k, v in PLANS.get(name, {}).items():
                        setattr(DA, k, v)
                    try:
                        _time(name, lib, fmt, T, fn, q, caches, base, fresh, ref, results)
                    except RuntimeError as exc:  # a variant that does not launch
                        print(f"[variant] {fmt} T={T} {name}: {exc}", flush=True)
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
