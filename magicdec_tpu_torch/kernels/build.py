"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` into
one shared library with a plain C interface, ``build/kernels/
libmagicdec_kernels.so`` under the checkout, and loaded with ``ctypes``.
The sources compile in parallel (one ``nvcc`` each, all started together),
then one ``nvcc`` links them.  The build happens at the first launch and is
keyed by a hash of the sources and flags, so a checkout builds its kernels
by itself and an edit rebuilds them.  Nothing here runs at import: the CPU
tests import every module of the package without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmagicdec_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (pointers, the stream, ints,
# floats).  Each returns cudaGetLastError() after its launches.
SIGNATURES = {
    "md_decode_attend": [_P] * 9 + [_I] * 9 + [_P],
    "md_prefill_attend": [_P] * 7 + [_I] * 7 + [_P],
    "md_append_rows": [_P] * 5 + [_I] * 5 + [_P],
    "md_decode_attend_quant": [_P] * 13 + [_I] * 9 + [_P],
    "md_prefill_attend_quant": [_P] * 11 + [_I] * 7 + [_P],
    "md_append_rows_quant": [_P] * 9 + [_I] * 6 + [_P],
    "md_quant_matmul_sm90": [_P] * 6 + [_I] * 5 + [_F, _P],
    "md_quant_layer_tail_sm90": [_P] * 15 + [_I] * 9 + [_F, _P],
    "md_quant_mlp_sm90": [_P] * 12 + [_I] * 7 + [_F, _P],
    "md_ffn_sm90_resident": [_I, _I],
    "md_dense_mlp_sm90": [_P] * 10 + [_I] * 7 + [_F, _P],
    "md_decode_attend_quant4": [_P] * 13 + [_I] * 9 + [_P],
    "md_prefill_attend_quant4": [_P] * 11 + [_I] * 7 + [_P],
    "md_quant_matmul_int4_sm90": [_P] * 5 + [_I] * 6 + [_P],
    "md_quant_matmul_int4_t_sm90": [_P] * 4 + [_I] * 4 + [_P],
    "md_paged_decode_attend": [_P] * 10 + [_I] * 11 + [_P],
    "md_paged_decode_attend_quant": [_P] * 14 + [_I] * 11 + [_P],
    "md_paged_decode_attend_quant4": [_P] * 14 + [_I] * 11 + [_P],
    "md_append_paged_rows": [_P] * 6 + [_I] * 7 + [_P],
    "md_append_paged_rows_quant": [_P] * 10 + [_I] * 8 + [_P],
    "md_append_array_rows": [_P] * 3 + [_I] * 5 + [_P],
    "md_append_scale_cols": [_P] * 3 + [_I] * 5 + [_P],
    "md_dense_matmul_sm90": [_P] * 5 + [_I] * 5 + [_F, _P],
    "md_quant_matmul_grouped_sm90": [_P] * 6 + [_I] * 6 + [_F, _P],
}
# the bf16-scale instances of the quantized-KV kernels take the f32 ones'
# arguments
SIGNATURES.update({name + "_bf16s": SIGNATURES[name] for name in (
    "md_decode_attend_quant", "md_decode_attend_quant4", "md_paged_decode_attend_quant",
    "md_paged_decode_attend_quant4", "md_prefill_attend_quant", "md_prefill_attend_quant4",
    "md_append_rows_quant", "md_append_scale_cols", "md_append_paged_rows_quant")})
# the head-dim-128 instances (B10, B11, B12's int4 pool) take the head-dim-64
# ones' arguments
SIGNATURES.update({name + "_hd128": SIGNATURES[name] for name in (
    "md_decode_attend_quant4", "md_prefill_attend_quant4", "md_paged_decode_attend_quant4")})

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the port's CUDA kernels are built from source")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library is missing or stale; return its
    path.  The library is written under a temporary name and renamed, so
    concurrent builds never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".hash")
    key = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == key:
        return lib
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs = []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            if verbose and out:
                # -Xptxas=-v: each kernel's registers, shared memory, spills
                (BUILD_DIR / f"{src.stem}.nvcc.log").write_text(out)
                print(out)
            objs.append(str(obj))
        tmp_lib = Path(tmp) / LIB_NAME
        res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                              "-shared", "-o", str(tmp_lib), *objs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, lib)
    stamp.write_text(key)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# The sm_90a entry points' code for a failed tensor-map encode, plus its CUresult
ENCODE_ERROR = 0x10000


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch (or, from an
    sm_90a entry point, a failed tensor-map encode)."""
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
