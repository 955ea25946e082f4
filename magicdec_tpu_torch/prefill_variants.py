"""Variants of the K2q/B11 kernel (``csrc/prefill_attention_sm90.cu``, the
int8 and int4 instances of ``prefill_sm90_kernel``; K2's bf16 instance
shares the consumers) timed against each other on the card, in one process.

    python -m magicdec_tpu_torch.prefill_variants [--variants a,b,...]
        [--formats int8,int4] [--bases 7680,0]

Each variant is the source with the text patches of ``VARIANTS`` below
(``current`` is the source as it stands).  Every variant compiles alone with
``nvcc`` (all in parallel) into its own library under ``build/variants/``;
its C entry points are called through ctypes with the wrapper's arguments at
the bench's shapes (llama-3.2-1b widths, B=32, a 16-layer cache of 8704 rows,
C=512 with the chunk's fresh rows), timed by ``kernel_benchmark.graph_ms``
over the layers in turn, and checked against the plain version on one layer
(the elements outside ``kernels.bf16_limit``: 0 for a variant that computes
the same function; the isolation variants do not).  For each variant the
script prints ptxas's registers and spills and counts, in ``cuobjdump
-sass``, the ``HGMMA`` instructions against the ``WARPGROUP.DEPBAR`` waits
(one wait an ``HGMMA``: ptxas serialized every wgmma).  A variant that
defines ``md_trace_read`` (``trace``) records ``clock64`` at the phases of
the last row block of (request 0, kv head 0); the script prints the mean
cycles a tile of each phase over tiles 8 to 55.  The last line is a JSON
object of the device milliseconds.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "prefill_attention_sm90.cu"
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "variants"

# clock64 at a phase of tile i, by the first thread of each warpgroup of one block
_T = ("if (blockIdx.x == gridDim.x - 1 && blockIdx.y == 0 && blockIdx.z == 0 && "
      "(threadIdx.x & 127) == 0 && i < 80) g_trace[wg][i][{}] = clock64();\n")


def _tr(k: int) -> str:
    return "      " + _T.format(k)


_NO_PRODUCER_WORK = [
    ("      for (int i = 0; i < min(ntiles, I8_STAGES); ++i) issue(i);\n", ""),
    ("      if (p == 0 && i + I8_STAGES < ntiles) issue(i + I8_STAGES);\n", ""),
    ("      mbar_wait(i8_full + 8 * s8, (i / I8_STAGES) & 1);         // the int8 tile landed\n",
     ""),
    ("          put(dst + kv * BF_TILE + k * RSTEP * 128, v);\n", ""),
]

# name -> [(old text, new text), ...], applied to the source in order
VARIANTS = {
    "current": [],
    # two consumer warpgroups (128 rows a block) with the registers of 384 threads
    "two_warpgroups": [
        ("constexpr int NCONS = 3; ", "constexpr int NCONS = 2; "),
        ("setmaxnreg.inc.sync.aligned.u32 152;", "setmaxnreg.inc.sync.aligned.u32 224;"),
    ],
    # FA3's in-warpgroup overlap: the next tile's S and this tile's P.V
    # issued together, the softmax under the P.V, P packed after its wait
    "in_warpgroup_overlap": [
        ("""    for (int i = 0; i < ntiles; ++i) {
      mbar_wait(bf_full + 8 * (i % BF_STAGES), (i / BF_STAGES) & 1);
      wgmma_fence();
      issue_qk(i);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(i);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[hf][4 * n] *= corr[0];
          o[hf][4 * n + 1] *= corr[0];
          o[hf][4 * n + 2] *= corr[1];
          o[hf][4 * n + 3] *= corr[1];
        }
      pack_p<HD, Q8>(s, scales(i) + SC_FLOATS, pa);
      wgmma_fence();
      issue_pv(i);
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) fence_regs(o[hf]);
      mbar_arrive(bf_empty + 8 * (i % BF_STAGES));
    }
""", """    mbar_wait(bf_full, 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    pack_p<HD, Q8>(s, scales(0) + SC_FLOATS, pa);
    for (int i = 1; i < ntiles; ++i) {
      mbar_wait(bf_full + 8 * (i % BF_STAGES), (i / BF_STAGES) & 1);
      wgmma_fence();
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();
      fence_regs(s);
      softmax(i);
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) fence_regs(o[hf]);
      mbar_arrive(bf_empty + 8 * ((i - 1) % BF_STAGES));
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[hf][4 * n] *= corr[0];
          o[hf][4 * n + 1] *= corr[0];
          o[hf][4 * n + 2] *= corr[1];
          o[hf][4 * n + 3] *= corr[1];
        }
      pack_p<HD, Q8>(s, scales(i) + SC_FLOATS, pa);
    }
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) fence_regs(o[hf]);
    mbar_arrive(bf_empty + 8 * ((ntiles - 1) % BF_STAGES));
"""),
    ],
    # isolation: the consumers on whatever the stages hold (the producer
    # only passes stages on), the producer with empty consumers
    "consumers_alone": _NO_PRODUCER_WORK,
    "consumers_alone_no_exp": _NO_PRODUCER_WORK + [
        ("  for (int j = 0; j < NS; ++j) s[j] = ex2(s[j] - m[(j >> 1) & 1]);",
         "  for (int j = 0; j < NS; ++j) s[j] = s[j] - m[(j >> 1) & 1];"),
    ],
    "producer_alone": [("      issue_qk(i);\n", ""), ("      softmax(i);\n", ""),
                       ("      issue_pv(i);\n", "")],
    # clock64 at the phases of each tile (consumers: 0 top, 1 tile landed,
    # 3 S done, 4 softmax done, 5 P.V done; producer: 0 top, 1 stage free,
    # 2 int8 landed, 3 converted, 4 handed on)
    "trace": [
        ("using namespace md::sm90;\n",
         "using namespace md::sm90;\n__device__ long long g_trace[4][80][8];\n"),
        ("    for (int i = 0; i < ntiles; ++i) {\n"
         "      mbar_wait(bf_full + 8 * (i % BF_STAGES), (i / BF_STAGES) & 1);\n",
         "    for (int i = 0; i < ntiles; ++i) {\n" + _tr(0)
         + "      mbar_wait(bf_full + 8 * (i % BF_STAGES), (i / BF_STAGES) & 1);\n" + _tr(1)),
        ("      wgmma_wait<0>();\n      fence_regs(s);\n      softmax(i);\n",
         "      wgmma_wait<0>();\n      fence_regs(s);\n" + _tr(3) + "      softmax(i);\n" + _tr(4)),
        ("      issue_pv(i);\n      wgmma_wait<0>();\n",
         "      issue_pv(i);\n      wgmma_wait<0>();\n" + _tr(5)),
        ("      mbar_wait(bf_empty + 8 * sb, ((i / BF_STAGES) & 1) ^ 1);"
         "  // the consumers let it go\n",
         _tr(0) + "      mbar_wait(bf_empty + 8 * sb, ((i / BF_STAGES) & 1) ^ 1);"
         "  // the consumers let it go\n" + _tr(1)),
        ("      mbar_wait(i8_full + 8 * s8, (i / I8_STAGES) & 1);         // the int8 tile landed\n",
         "      mbar_wait(i8_full + 8 * s8, (i / I8_STAGES) & 1);         // the int8 tile landed\n"
         + _tr(2)),
        ("      float* sc = reinterpret_cast<float*>(smem + BF_OFF + sb * BF_STAGE + 2 * BF_TILE);\n",
         _tr(3) + "      float* sc = reinterpret_cast<float*>(smem + BF_OFF + sb * BF_STAGE"
         " + 2 * BF_TILE);\n"),
        ('      asm volatile("bar.sync %0, 128;\\n" ::"n"(BAR_PRODUCER) : "memory");\n',
         '      asm volatile("bar.sync %0, 128;\\n" ::"n"(BAR_PRODUCER) : "memory");\n' + _tr(4)),
        ('extern "C" int md_prefill_attend_quant(',
         'extern "C" int md_trace_read(void* dst) {\n'
         '  return (int)cudaMemcpyFromSymbol(dst, md::pfa::g_trace, sizeof(md::pfa::g_trace));\n'
         '}\n\nextern "C" int md_prefill_attend_quant('),
    ],
}
TRACE_SHAPE = (4, 80, 8)  # g_trace: [consumer warpgroups + producer, tiles, phases]


def patched(name: str, source: str | None = None) -> str:
    """The source of variant ``name``; raises if a patch does not apply."""
    text = SOURCE.read_text() if source is None else source
    for old, new in VARIANTS[name]:
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
        src = OUT_DIR / f"{name}.cu"
        src.write_text(patched(name))
        lib = OUT_DIR / f"lib{name}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I", str(SOURCE.parent),
               "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-4000:]}")
        info = [x.strip() for x in out.splitlines()
                if ("Used" in x and "registers" in x) or ("spill" in x and " 0 bytes spill" not in x)]
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                              text=True).stdout
        body = [f for f in sass.split("Function : ") if "prefill_sm90_kernelILb0E" in f[:80]]
        wait = (f"HGMMA {body[0].count('HGMMA')}, WARPGROUP.DEPBAR "
                f"{body[0].count('WARPGROUP.DEPBAR')}") if body else "no SASS"
        print(f"[variant] {name}: {info[-1] if info else ''}; {wait}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        for entry in ("md_prefill_attend_quant", "md_prefill_attend_quant4"):
            fn = getattr(libs[name], entry)
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return libs


def _trace(lib, name):
    import numpy as np

    try:
        read = lib.md_trace_read
    except AttributeError:
        return
    buf = np.zeros(TRACE_SHAPE, dtype=np.int64)
    read.argtypes = [ctypes.c_void_p]
    if read(buf.ctypes.data) != 0:
        raise RuntimeError("md_trace_read failed")
    tiles = slice(8, 56)
    for wg in range(TRACE_SHAPE[0] - 1):
        t = buf[wg, tiles].astype(np.float64)
        print(f"[trace] {name} consumer warpgroup {wg}: a tile {np.diff(t[:, 0]).mean():.0f} "
              f"cycles; waiting for the tile {(t[:, 1] - t[:, 0]).mean():.0f}, for S "
              f"{(t[:, 3] - t[:, 1]).mean():.0f}, softmax {(t[:, 4] - t[:, 3]).mean():.0f}, "
              f"for P.V {(t[:, 5] - t[:, 4]).mean():.0f}", flush=True)
    t = buf[-1, tiles].astype(np.float64)
    print(f"[trace] {name} producer: a tile {np.diff(t[:, 0]).mean():.0f} cycles; waiting for "
          f"a stage {(t[:, 1] - t[:, 0]).mean():.0f}, for the int8 tile "
          f"{(t[:, 2] - t[:, 1]).mean():.0f}, converting {(t[:, 3] - t[:, 2]).mean():.0f}, "
          f"handing on {(t[:, 4] - t[:, 3]).mean():.0f}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--formats", default="int8")
    p.add_argument("--bases", default="7680,0")
    args = p.parse_args(argv)
    from magicdec_tpu_torch.kernel_benchmark import graph_ms
    from magicdec_tpu_torch.kernels import bf16_limit
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens, quantize_kv_tokens_int4

    if not torch.cuda.is_available():
        raise SystemExit("prefill_variants times the card's kernels: it needs a CUDA card")
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = _build(names)
    print(f"[variant] built {len(libs)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, S, C, Hq, Hkv, hd = 16, 32, 8704, 512, 32, 8, 64
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    quant = {"int8": (quantize_kv_tokens, "md_prefill_attend_quant"),
             "int4": (quantize_kv_tokens_int4, "md_prefill_attend_quant4")}
    results = {}
    for fmt in args.formats.split(","):
        qfn, entry = quant[fmt]
        kq, ks, vq, vs = [], [], [], []
        for _ in range(L):  # a layer at a time: the float32 temporaries
            (k1, k2), (v1, v2) = (qfn(randn(B, S, Hkv, hd)) for _ in range(2))
            kq.append(k1), ks.append(k2), vq.append(v1), vs.append(v2)
        kq, ks, vq, vs = (torch.stack(x) for x in (kq, ks, vq, vs))
        for base in (int(x) for x in args.bases.split(",")):
            q = randn(B, C, Hq, hd)
            (kn, ksn), (vn, vsn) = (qfn(randn(B, C, Hkv, hd)) for _ in range(2))
            lens = torch.full((B,), base, dtype=torch.int32, device=dev)
            ref = PA.flash_prefill_attend_quant_plain(q, kq, ks, vq, vs, lens, layer=5,
                                                      k_new=kn, v_new=vn, ks_new=ksn,
                                                      vs_new=vsn)
            for name, lib in libs.items():
                fn = getattr(lib, entry)
                out = torch.empty_like(q)

                def call(layer, fn=fn, out=out):
                    err = fn(q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                             vs.data_ptr(), kn.data_ptr(), vn.data_ptr(), ksn.data_ptr(),
                             vsn.data_ptr(), lens.data_ptr(), out.data_ptr(), layer, B, S, C,
                             Hq, Hkv, hd, torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"variant {name}: launch failed with {err}")
                call(5)
                torch.cuda.synchronize()
                outside = int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())
                ms = graph_ms([lambda layer=layer: call(layer) for layer in range(L)])
                results[f"{fmt}_base{base}_{name}"] = ms
                print(f"[variant] {fmt} C={C} base={base} {name:24s} {ms:8.4f} ms  "
                      f"{outside} elements outside bf16_limit", flush=True)
                if base > 0:
                    _trace(lib, name)
        del kq, ks, vq, vs
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": results}))
    return results


if __name__ == "__main__":
    main()
