"""Hopper kernels of the port, one module each, with their plain versions.

Each wrapper takes its plain PyTorch version for CPU tensors only; for CUDA
tensors it launches the kernel (built by ``build.py`` at first use) or
raises.  ``<wrapper>.launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import torch


def on_cpu(*tensors) -> bool:
    """True when every given tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device (the kernel runs).  Anything else
    raises: there is no silent fallback."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_bf16(*tensors) -> None:
    for t in tensors:
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bfloat16, got {t.dtype}")


def bf16_limit(ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel - plain| for a kernel's bf16 output:
    2**-5 times the RMS of the element's row (the last axis: one head's
    output) plus 2**-6 |ref| (two to four bf16 ulps).  The error of bf16
    softmax weights scales with the row, and a row shrinks with the rows it
    attends: RMS about 0.018 over the bench's 8k-row cache, about 1 for the
    first rows of a prefill.  A fixed atol would also pass a kernel that
    reads the wrong rows for the window; this bound fails it
    (``chip_smoke.py`` and the ``gpu`` tests check that it does)."""
    ref = ref.float()
    return 2.0 ** -5 * ref.pow(2).mean(-1, keepdim=True).sqrt() + 2.0 ** -6 * ref.abs()


SCALE_DTYPES = (torch.float32, torch.bfloat16)  # a quantized KV cache's scales


def scale_entry(entry: str, *scales) -> str:
    """The C entry point of a quantized-KV kernel for its scales: ``entry``
    for float32, its ``_bf16s`` instance for bfloat16.  Every given scale
    (the cache's and the fresh rows') must share one of the two dtypes;
    nothing is cast."""
    dtypes = {t.dtype for t in scales if t is not None}
    if len(dtypes) != 1 or not dtypes <= set(SCALE_DTYPES):
        raise TypeError(f"{entry}: the scales must all be float32 or all bfloat16, got "
                        f"{sorted(map(str, dtypes))}")
    return entry + ("_bf16s" if dtypes == {torch.bfloat16} else "")


# The attention kernels' C entry points that have a head-dim-128 instance
# (``<entry>_hd128``, f32 scales); every other attention entry point, and
# every bf16-scale instance, takes head dim 64 only.
HD128_ENTRIES = frozenset({"md_decode_attend_quant4", "md_prefill_attend_quant4",
                           "md_paged_decode_attend_quant4"})
HD128_ITEM = "ROADMAP item A16"  # the head-dim-128 instances still to port


def head_dim_entry(entry: str, hd: int) -> str:
    """The instance of attention entry point ``entry`` (after ``scale_entry``)
    for head dim ``hd``: ``entry`` at 64, ``entry + '_hd128'`` at 128 where
    the kernel has that instance.  Any other head dim raises here, before
    any launch, naming the ROADMAP item."""
    if hd == 64:
        return entry
    if hd == 128 and entry in HD128_ENTRIES:
        return entry + "_hd128"
    raise ValueError(
        f"{entry}: no instance for head dim {hd} (the attention kernels take head dim 64; "
        f"B10, B11 and B12's int4 pool also 128, on f32 scales); the other head-dim-128 "
        f"instances are {HD128_ITEM}")


def count_launch(wrapper, entry: str) -> None:
    """One kernel launch of ``wrapper``: its ``launches``, its
    ``bf16_scale_launches`` when ``entry`` is a bf16-scale instance and its
    ``hd128_launches`` when it is a head-dim-128 instance."""
    wrapper.launches += 1
    if entry.endswith("_bf16s"):
        wrapper.bf16_scale_launches += 1
    if entry.endswith("_hd128"):
        wrapper.hd128_launches += 1


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent operand), checked for
    the 16-byte alignment the kernels' vector loads need."""
    if t is None:
        return None
    p = t.data_ptr()
    require(p % 16 == 0, "kernel operands must be 16-byte aligned")
    return p
