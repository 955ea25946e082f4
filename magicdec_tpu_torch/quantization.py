"""Weight-only int8 quantization of the draft's weight copy (counterpart of
magicdec_tpu/quantization.py).

A quantized weight is a ``QuantizedWeight``: int8 ``q [..., In, Out]`` and
f32 ``scale [..., 1, Out]``, one scale per output column, the JAX package's
at-rest format (``convert.py`` moves it across bit for bit).  The model's
``matmul`` dispatches on it.

Routing follows the JAX package's shape predicates exactly, because they
choose between two numerics: a kernel (f32 accumulation, the f32 scale, then
one bf16 cast: B4/B5/B6/B9 in ``kernels/quant_matmul.py``) or the plain
product ``x @ q.to(x.dtype) * scale.to(x.dtype)`` that the JAX package leaves
to XLA (prefill-sized M).  The JAX package's VMEM budgets (``_pick_block_out``,
the 13 and 14 MiB budgets of ``quant_layer_tail`` and ``quant_mlp``) are
facts of the TPU and are dropped: at llama-3.2-1b widths they never decline
for M <= 128.  A pass whose rows are padded (a target pass at
``ModelConfig.decode_rows``) hands its dots the padded rows, so the JAX
package's ``rows_hint`` is the live row count here.

int4 and group-wise int8 are ROADMAP item A8.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from magicdec_tpu_torch.kernels import quant_matmul as K
from magicdec_tpu_torch.ops.norm import rms_norm

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")
ROWS_CAP = 256           # decode-sized rows: B4 and B6 route at most this many
TAIL_ROWS_CAP = 128      # B5
_QUANT_COLS = 16384      # columns quantized at a time (bounds the f32 temporaries)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # rounded to f32

# "pallas" (the JAX package's name for its kernel backend): the Hopper
# kernels wherever the shape rules route to a kernel.  "jnp": the plain
# product at every shape, as the JAX package's "jnp" backend computes it, for
# CPU tensors only: on the card the port runs its Hopper kernels.
_MATMUL_BACKEND = "pallas"


def set_matmul_backend(name: str) -> None:
    global _MATMUL_BACKEND
    if name not in ("jnp", "pallas"):
        raise ValueError(f"matmul backend must be 'jnp' or 'pallas', got {name!r}")
    _MATMUL_BACKEND = name


def matmul_backend() -> str:
    return _MATMUL_BACKEND


def _plain_backend(x: torch.Tensor) -> bool:
    """True under the "jnp" backend, which raises for a tensor off the CPU."""
    if _MATMUL_BACKEND == "pallas":
        return False
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"the 'jnp' matmul backend on a {x.device.type} tensor: the port runs its "
            "Hopper kernels only")
    return True


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """q int8 [..., In, Out]; scale f32 [..., 1, Out].  ``w[l]`` slices a
    layer-stacked weight (both arrays)."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    group_size: int = 0

    def __post_init__(self):
        if self.bits != 8:
            raise NotImplementedError("int4 weights are ROADMAP item A8")
        if self.scale.shape[-2] != 1:
            raise NotImplementedError("group-wise int8 weights are ROADMAP item A8")

    def __getitem__(self, idx):
        return QuantizedWeight(self.q[idx], self.scale[idx], self.bits, self.group_size)

    def to(self, device):
        return QuantizedWeight(self.q.to(device), self.scale.to(device), self.bits,
                               self.group_size)


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


def quantize_weight(w: torch.Tensor, bits: int = 8, group_size=None, *,
                    reciprocal: bool = False) -> QuantizedWeight:
    """Symmetric int8 per-output-channel quantization of [..., In, Out]
    weights, the JAX package's ``quantize_weight`` op for op: scale = amax
    over In / 127, at least 1e-10; q = clip(round(w / scale), -128, 127),
    rounding half to even.  ``reciprocal``: scale = amax * f32(1/127), which
    is what XLA makes of the division inside the JAX package's jitted
    ``quantize_params`` (one f32 ulp apart in some columns).  One layer and
    up to 16384 columns at a time, so the f32 temporaries stay small on the
    card."""
    In, Out = w.shape[-2], w.shape[-1]
    if bits != 8:
        raise NotImplementedError("int4 weights are ROADMAP item A8")
    if group_size not in (None, In):
        raise NotImplementedError("group-wise int8 weights are ROADMAP item A8")
    flat = w.reshape(-1, In, Out)
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((flat.shape[0], 1, Out), dtype=torch.float32, device=w.device)
    for i in range(flat.shape[0]):
        for c in range(0, Out, _QUANT_COLS):
            wf = flat[i, :, c:c + _QUANT_COLS].to(torch.float32)
            amax = wf.abs().amax(dim=0, keepdim=True)
            s = amax * _INV127 if reciprocal else amax / 127.0
            s = torch.clamp_min(s, 1e-10)
            q[i, :, c:c + _QUANT_COLS] = torch.clamp(torch.round(wf / s), -128, 127)
            scale[i, :, c:c + _QUANT_COLS] = s
    return QuantizedWeight(q.reshape(w.shape), scale.reshape(*w.shape[:-2], 1, Out),
                           bits=8, group_size=In)


def dequantize_weight(wq: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    return (wq.q.to(torch.float32) * wq.scale).to(dtype)


def quantize_params(params, bits: int = 8, group_size=None, include_head: bool = True,
                    materialize_tied_head: bool = False):
    """Quantize every linear weight of the layers (``QUANT_KEYS``) and, with
    ``include_head``, the lm_head; ``materialize_tied_head`` builds a
    quantized [D, V] head from a tied embedding.  Embeddings, norms and an
    unquantized head are the input's tensors, shared, not copied (the
    quantized embedding is ROADMAP item A8).  Bit for bit the JAX package's
    ``quantize_params``, whose jitted quantization scales by the f32
    reciprocal of 127."""
    qw = functools.partial(quantize_weight, bits=bits, group_size=group_size,
                           reciprocal=True)
    layers = dict(params["layers"])
    for key in QUANT_KEYS:
        if layers.get(key) is not None:
            layers[key] = qw(layers[key])
    out = dict(params, layers=layers)
    if include_head:
        head = params.get("lm_head")
        if head is not None and not is_quantized(head):
            out["lm_head"] = qw(head)
        elif materialize_tied_head and head is None:
            out["lm_head"] = qw(params["embed"].T)
    return out


def quant_matmul(x, wq: QuantizedWeight, norm=None, gate: bool = False, residual=None):
    """x [..., In] @ dequant(wq), routed as the JAX package routes it.

    ``norm``: (weight, eps), rms-norm x first; ``gate``: wq is the gate|up
    projection [In, 2F], returns silu(x @ w_gate) * (x @ w_up) [..., F];
    ``residual`` [..., Out] is added.  Under the "pallas" backend a 2-D
    weight at M <= 256 rows, In % 512 == 0 and F % 256 == 0 takes B4 (with
    any of the three) or B6 (without); the rest takes the plain product."""
    assert not (gate and residual is not None)
    lead = x.shape[:-1]
    M = math.prod(lead)
    In, Out = wq.q.shape[-2], wq.q.shape[-1]
    kernel = (not _plain_backend(x) and wq.q.dim() == 2 and M <= ROWS_CAP
              and In % 512 == 0)
    if norm is not None or gate or residual is not None:
        Fo = Out // 2 if gate else Out
        if kernel and Fo % 256 == 0:
            y = K.quant_matmul_fused(
                x.reshape(M, In), wq.q, wq.scale, norm[0] if norm is not None else None,
                residual.reshape(M, Fo) if residual is not None else None, gate=gate,
                eps=norm[1] if norm is not None else 1e-5)
            return y.reshape(*lead, Fo)
        if norm is not None:
            x = rms_norm(x, norm[0], norm[1])
        if gate:
            y = quant_matmul(x, wq)
            Fo = y.shape[-1] // 2
            return F.silu(y[..., :Fo]) * y[..., Fo:]
        if residual is not None:
            return residual + quant_matmul(x, wq)
    if kernel and Out % 256 == 0:
        return K.quant_matmul(x.reshape(M, In), wq.q, wq.scale).reshape(*lead, Out)
    return (x @ wq.q.to(x.dtype)) * wq.scale[..., 0, :].to(x.dtype)


def _all_2d(*ws) -> bool:
    return all(is_quantized(w) and w.q.dim() == 2 for w in ws)


def quant_mlp(x, w13: QuantizedWeight, w2: QuantizedWeight, norm, residual=None):
    """The FFN block, rms_norm -> silu-gated MLP -> w2 [+ residual], as B9
    where the JAX package takes ``quant_mlp_pallas`` (M <= 256,
    D % 128 == 0, D <= 4096, F % 128 == 0); else None.  The draft reaches
    it at 129 <= M <= 256 rows, where B5 declines."""
    if _plain_backend(x) or not _all_2d(w13, w2):
        return None
    lead = x.shape[:-1]
    D = x.shape[-1]
    Fh = w13.q.shape[1] // 2
    M = math.prod(lead)
    if not (tuple(w2.q.shape) == (Fh, D) and M <= ROWS_CAP
            and D % 128 == 0 and D <= 4096 and Fh % 128 == 0):
        return None
    y = K.quant_mlp(x.reshape(M, D), w13.q, w13.scale, w2.q, w2.scale, norm[0],
                    residual.reshape(M, D) if residual is not None else None, eps=norm[1])
    return y.reshape(*lead, D)


def quant_layer_tail(a, x, wo: QuantizedWeight, w13: QuantizedWeight, w2: QuantizedWeight,
                     norm):
    """The draft layer's whole tail, x + a @ wo then the FFN block with its
    residual, as B5 where the JAX package takes ``quant_layer_tail_pallas``
    (M <= 128, D % 128 == 0, K % 128 == 0, F % 128 == 0); else None.  Draft
    passes only, as in the JAX package."""
    if _plain_backend(x) or not _all_2d(wo, w13, w2):
        return None
    lead = x.shape[:-1]
    D, Kd = x.shape[-1], a.shape[-1]
    Fh = w13.q.shape[1] // 2
    M = math.prod(lead)
    if tuple(wo.q.shape) != (Kd, D) or tuple(w2.q.shape) != (Fh, D):
        return None
    if not (M <= TAIL_ROWS_CAP and D % 128 == 0 and Kd % 128 == 0 and Fh % 128 == 0):
        return None
    y = K.quant_layer_tail(a.reshape(M, Kd), x.reshape(M, D), wo.q, wo.scale, w13.q,
                           w13.scale, w2.q, w2.scale, norm[0], eps=norm[1])
    return y.reshape(*lead, D)
