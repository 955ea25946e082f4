"""Weight-only int8 and int4 quantization: the draft's weight copy, the
target's quantized verify weights and the quantized embedding
(counterpart of magicdec_tpu/quantization.py).

A quantized weight is a ``QuantizedWeight``: int8 ``q [..., In, Out]`` with
f32 ``scale [..., 1, Out]``, one scale per output column (or, with
``group_size``, group-wise ``scale [..., In/group, Out]``), or int4 packed in
contraction-row pairs into ``q [..., In/2, Out]`` (``pack_int4``) with
group-wise f32 ``scale [..., In/group, Out]`` (group 128 by default), the
JAX package's at-rest formats (``convert.py`` moves them across bit for
bit).  The model's ``matmul`` dispatches on it.

Routing follows the JAX package's shape predicates exactly, because they
choose between two numerics: a kernel (f32 accumulation, the f32 scale, then
one bf16 cast: B4/B5/B6/B9 in ``kernels/quant_matmul.py``) or the plain
product ``x @ q.to(x.dtype) * scale.to(x.dtype)`` (int4: ``x @ bf16(q * s)``,
dequantized by groups first) that the JAX package leaves to XLA
(prefill-sized M).  An int4 dot never takes the norm into its kernel: as in
the JAX package, the rms-norm runs first and B4-int4 takes the gate or the
residual, B6-int4 neither; B5 and B9 take int8 with one scale a column
only (group-wise int8 takes B4 with its norm, gate or residual, or B6, as the
JAX package routes it).  The JAX package's
VMEM budgets (``_pick_block_out``, the 13 and 14 MiB budgets of
``quant_layer_tail`` and ``quant_mlp``) are
facts of the TPU and are dropped: at llama-3.2-1b widths they never decline
for M <= 128.  A pass whose rows are padded (a target pass at
``ModelConfig.decode_rows``) hands its dots the padded rows, so the JAX
package's ``rows_hint`` is the live row count here.

The target's quantized weights (``bench --quantize``, a converted
``-int8.npz`` / ``-int4.npz`` dump; the draft then shares them) route by the
same predicates.  A target decode or verify pass runs at
``ModelConfig.decode_rows`` rows (B * (gamma + 1) = 128 at the bench's
B=32), padded once per pass, so the autoregressive step and the verify both
reach B4 (wqkv with its norm, wo with its residual), B9 (the FFN block) and
B6 (the head), or B4-int4 and B6-int4, at M = ``decode_rows`` with one
split plan; prefill chunks (M = B * C) take the plain product, as the JAX
package takes XLA's dequantized dot above its 256-row cap.  A quantized
embedding (``quantize_embed``, [D, V] int8 with per-vocab-column scales)
serves the lookup (``models.llama.embed_lookup``) and, tied, the head
through B6.

The target's bf16 dots on its decode and verify passes (``rows_hint`` =
``ModelConfig.decode_rows`` > 0) take B15 (``kernels/dense_matmul.py``)
when ``set_dense_kernels(True)``: ``dense_matmul`` and ``dense_mlp`` route
as the JAX package's do, and are off by default as there.  Their routing
keeps the JAX package's integer budgets (``_pick_block_out`` and
``dense_mlp``'s 14 MiB rule) as routing rules, not as TPU facts, because
they choose between two numerics: where ``dense_mlp`` declines, the block
runs as two ``dense_matmul`` calls with the SiLU between them, outside the
kernel; where ``_pick_block_out`` declines, the plain bf16 dot runs.  They
decline only at row counts the bench does not reach: at llama-3.2-1b widths
(D 2048, F 8192) ``dense_mlp`` declines above 402 rows (``decode_rows``
above 402, e.g. B=128 at gamma 3) and ``dense_matmul`` never does
(``rows_hint`` <= 512); at llama-3.1-8b widths (D 4096, F 14336)
``dense_mlp`` declines above 146 rows and the norm-fused wqkv and w13 dots
above 200 (B=32 at gamma 3 is 128 rows).  Routing reads ``rows_hint``,
never the live M, so the padded autoregressive step and the verify pass
take the same kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from magicdec_tpu_torch.kernels import dense_matmul as DK
from magicdec_tpu_torch.kernels import quant_matmul as K
from magicdec_tpu_torch.ops.norm import rms_norm

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")
ROWS_CAP = 256           # decode-sized rows: B4 and B6 route at most this many
TAIL_ROWS_CAP = 128      # B5
_QUANT_COLS = 16384      # columns quantized at a time (bounds the f32 temporaries)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # rounded to f32
_INV7 = torch.tensor(1.0 / 7.0, dtype=torch.float32).item()

# "pallas" (the JAX package's name for its kernel backend): the Hopper
# kernels wherever the shape rules route to a kernel.  "jnp": the plain
# product at every shape, as the JAX package's "jnp" backend computes it, for
# CPU tensors only: on the card the port runs its Hopper kernels.
_MATMUL_BACKEND = "pallas"


# the target's bf16 decode and verify dots on B15 (dense_matmul, dense_mlp):
# off by default, as in the JAX package
_DENSE_KERNELS = False


def set_dense_kernels(on: bool) -> None:
    global _DENSE_KERNELS
    _DENSE_KERNELS = bool(on)


def dense_kernels() -> bool:
    return _DENSE_KERNELS


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
    """bits 8: q int8 [..., In, Out], scale f32 [..., G, Out] (G = 1: one
    scale a column); bits 4: q packed int8 [..., In/2, Out], scale f32
    [..., G, Out]; G groups tile the contraction.  ``w[l]`` slices a layer-stacked weight (both
    arrays)."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    group_size: int = 0

    def __post_init__(self):
        if self.bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {self.bits}")

    @property
    def in_features(self) -> int:
        return self.q.shape[-2] * (2 if self.bits == 4 else 1)

    def __getitem__(self, idx):
        return QuantizedWeight(self.q[idx], self.scale[idx], self.bits, self.group_size)

    def to(self, device):
        return QuantizedWeight(self.q.to(device), self.scale.to(device), self.bits,
                               self.group_size)


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


def default_group_size(In: int, bits: int) -> int:
    """The JAX package's default: int8 one group (per output column); int4
    groups of 128 contraction rows, else 64, else 32, else one group."""
    if bits == 4:
        for g in (128, 64, 32):
            if In % g == 0:
                return g
    return In


def quantize_weight(w: torch.Tensor, bits: int = 8, group_size=None, *,
                    reciprocal: bool = False) -> QuantizedWeight:
    """Symmetric quantization of [..., In, Out] weights, the JAX package's
    ``quantize_weight`` op for op: per group of ``group_size`` contraction
    rows and output column (by default int8 the whole column, int4 128
    rows), scale = amax / qmax (127 or 7), at least 1e-10; q =
    clip(round(w / scale), -qmax - 1, qmax), rounding half to even; int4
    packed by ``pack_int4``.  ``reciprocal``: scale = amax * f32(1/qmax),
    which is what XLA makes of the division inside the JAX package's jitted
    ``quantize_params`` (one f32 ulp apart in some columns).  One layer and
    up to 16384 columns at a time, so the f32 temporaries stay small on the
    card."""
    In, Out = w.shape[-2], w.shape[-1]
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    gs = default_group_size(In, bits) if group_size is None else group_size
    if In % gs:
        raise ValueError(f"group size {gs} does not divide {In}")
    G = In // gs
    qmax = 127.0 if bits == 8 else 7.0
    inv = _INV127 if bits == 8 else _INV7
    flat = w.reshape(-1, In, Out)
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((flat.shape[0], G, Out), dtype=torch.float32, device=w.device)
    for i in range(flat.shape[0]):
        for c in range(0, Out, _QUANT_COLS):
            wf = flat[i, :, c:c + _QUANT_COLS].to(torch.float32).reshape(G, gs, -1)
            amax = wf.abs().amax(dim=1, keepdim=True)
            s = amax * inv if reciprocal else amax / qmax
            s = torch.clamp_min(s, 1e-10)
            q[i, :, c:c + _QUANT_COLS] = torch.clamp(
                torch.round(wf / s), -qmax - 1, qmax).reshape(In, -1)
            scale[i, :, c:c + _QUANT_COLS] = s[:, 0]
    q = q.reshape(w.shape)
    if bits == 4:
        q = pack_int4(q)
    return QuantizedWeight(q, scale.reshape(*w.shape[:-2], G, Out), bits=bits, group_size=gs)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] pairwise along the contraction axis (even
    rows in the low nibble) into int8 [..., In/2, Out]."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even row count, got {q.shape[-2]}")
    q = q.to(torch.int8)
    return (q[..., 0::2, :] & 0x0F) | (q[..., 1::2, :] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: int8 [..., In, Out], each nibble
    sign-extended (a shift pair for the low one, an arithmetic shift for the
    high one)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-2)                          # [..., In/2, 2, Out]
    return out.reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def dequantize_weight(wq: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """q * scale by groups, in float32, then ``dtype``."""
    q = unpack_int4(wq.q) if wq.bits == 4 else wq.q
    In, Out = q.shape[-2], q.shape[-1]
    G = wq.scale.shape[-2]
    grouped = q.reshape(*q.shape[:-2], G, In // G, Out).to(torch.float32)
    deq = grouped * wq.scale[..., :, None, :].to(torch.float32)
    return deq.reshape(*q.shape[:-2], In, Out).to(dtype)


def quantize_embed(embed: torch.Tensor, bits: int = 8) -> QuantizedWeight:
    """The embedding table quantized int8 TRANSPOSED, [D, V] with one scale
    per vocab column (the JAX package's ``quantize_embed``, which runs
    eagerly and so divides by 127): one format serves the lookup (token t
    is column t times scale[0, t], ``models.llama.embed_lookup``) and a tied
    head (``quant_matmul`` over it, B6).  int8 only: embeddings are
    quality-sensitive, and the JAX package's benchmarks never offer int4."""
    if bits != 8:
        raise ValueError(f"the quantized embedding is int8 only, got bits={bits}")
    return quantize_weight(embed.T, bits=8)


def quantize_params(params, bits: int = 8, group_size=None, include_head: bool = True,
                    materialize_tied_head: bool = False, include_embed: bool = False):
    """Quantize every linear weight of the layers (``QUANT_KEYS``) and, with
    ``include_head``, the lm_head; ``materialize_tied_head`` builds a
    quantized [D, V] head from a tied embedding; ``include_embed`` the
    int8 embedding (``quantize_embed``, whatever ``bits``).  Embeddings,
    norms and an unquantized head are the input's tensors, shared, not
    copied.  A leaf that is already quantized stays as it is, so a
    converted ``-int8.npz`` / ``-int4.npz`` dump goes through ``serving_bench``'s
    ``quantize_params`` unchanged (the JAX package's raises an
    AttributeError on such a tree).  Bit for bit the JAX package's
    ``quantize_params``, whose jitted quantization scales by the f32
    reciprocal of 127 (int8) or of 7 (int4), and whose eager
    ``quantize_embed`` divides."""
    qw = functools.partial(quantize_weight, bits=bits, group_size=group_size,
                           reciprocal=True)
    layers = dict(params["layers"])
    for key in QUANT_KEYS:
        if layers.get(key) is not None and not is_quantized(layers[key]):
            layers[key] = qw(layers[key])
    out = dict(params, layers=layers)
    embed = params.get("embed")
    if include_head:
        head = params.get("lm_head")
        if head is not None and not is_quantized(head):
            out["lm_head"] = qw(head)
        elif (materialize_tied_head and head is None and embed is not None
              and not is_quantized(embed)):
            out["lm_head"] = qw(embed.T)
    if include_embed and embed is not None and not is_quantized(embed):
        out["embed"] = quantize_embed(embed)
    return out


def bits_from_path(path) -> "int | None":
    """The checkpoint-name convention (the JAX package's ``bits_from_path``):
    8 for a path naming int8, 4 for int4, else None."""
    if "int8" in str(path):
        return 8
    if "int4" in str(path):
        return 4
    return None


def quant_matmul(x, wq: QuantizedWeight, norm=None, gate: bool = False, residual=None):
    """x [..., In] @ dequant(wq), routed as the JAX package routes it.

    ``norm``: (weight, eps), rms-norm x first; ``gate``: wq is the gate|up
    projection [In, 2F], returns silu(x @ w_gate) * (x @ w_up) [..., F];
    ``residual`` [..., Out] is added.  Under the "pallas" backend a 2-D
    weight at M <= 256 rows, In % 512 == 0 and F % 256 == 0 takes B4 (with
    any of the three; int4: B4-int4 after a plain rms-norm) or B6 (without;
    int4: B6-int4); the rest takes the plain product."""
    assert not (gate and residual is not None)
    lead = x.shape[:-1]
    M = math.prod(lead)
    In, Out = wq.in_features, wq.q.shape[-1]
    kernel = (not _plain_backend(x) and wq.q.dim() == 2 and M <= ROWS_CAP
              and In % 512 == 0)
    if norm is not None or gate or residual is not None:
        Fo = Out // 2 if gate else Out
        if kernel and Fo % 256 == 0:
            res = residual.reshape(M, Fo) if residual is not None else None
            if wq.bits == 4:
                xm = x.reshape(M, In)
                if norm is not None:
                    xm = rms_norm(xm, norm[0], norm[1])
                y = K.quant_matmul_fused_int4(xm, wq.q, wq.scale, res, gate=gate)
            else:
                y = K.quant_matmul_fused(
                    x.reshape(M, In), wq.q, wq.scale, norm[0] if norm is not None else None,
                    res, gate=gate, eps=norm[1] if norm is not None else 1e-5)
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
        fn = K.quant_matmul_int4 if wq.bits == 4 else K.quant_matmul
        return fn(x.reshape(M, In), wq.q, wq.scale).reshape(*lead, Out)
    if wq.scale.shape[-2] == 1:
        q = unpack_int4(wq.q) if wq.bits == 4 else wq.q
        return (x @ q.to(x.dtype)) * wq.scale[..., 0, :].to(x.dtype)
    # group-wise: dequantize by groups, then ONE dot (the JAX package's plain
    # path; its kernels scale each group's partial sum instead)
    return x @ dequantize_weight(wq, x.dtype)


def _all_int8_2d(*ws) -> bool:
    """B5 and B9 take 2-D int8 per-column weights only (the JAX package's
    ``quant_mlp`` and ``quant_layer_tail`` decline the rest, group-wise int8
    by its ``scale.shape[0] != 1``)."""
    return all(is_quantized(w) and w.q.dim() == 2 and w.bits == 8 and w.scale.shape[-2] == 1
               for w in ws)


def quant_mlp(x, w13: QuantizedWeight, w2: QuantizedWeight, norm, residual=None):
    """The FFN block, rms_norm -> silu-gated MLP -> w2 [+ residual], as B9
    where the JAX package takes ``quant_mlp_pallas`` (M <= 256,
    D % 128 == 0, D <= 4096, F % 128 == 0); else None.  The draft reaches
    it at 129 <= M <= 256 rows, where B5 declines.  None for int4."""
    if _plain_backend(x) or not _all_int8_2d(w13, w2):
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
    (M <= 128, D % 128 == 0, K % 128 == 0, F % 128 == 0); else None (and
    for int4).  Draft passes only, as in the JAX package."""
    if _plain_backend(x) or not _all_int8_2d(wo, w13, w2):
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


def _in_block_cap(In: int) -> int:
    for cand in (2048, 1024, 512):
        if In % cand == 0:
            return cand
    return In


def _pick_block_out(Out: int, rows: int, block_in: int, In: int, w_bytes_per_out: float,
                    norm: bool) -> int:
    """The JAX package's ``_pick_block_out``, kept as a routing rule: the
    widest output block whose modelled footprint at ``rows`` (the routing
    row count) fits 9 MiB, or 0 when none does (the plain dot runs)."""
    fixed = rows * (2 * block_in * 2)
    if norm:
        fixed += rows * In * 2
    budget = 9 * 1024 * 1024
    for bo in (8192, 4096, 3072, 2048, 1536, 1024, 768, 512, 384, 256):
        if Out % bo:
            continue
        if bo * w_bytes_per_out > 2 * 1024 * 1024 and bo > 256:
            continue
        if fixed + 2 * bo * w_bytes_per_out + rows * bo * 6 <= budget:
            return bo
    return 0


def _dense_routes(w, rows_hint: int, M: int) -> bool:
    """The JAX package's gate for the dense kernels: a decode or verify pass
    (``rows_hint`` > 0, at most 512, the live rows within it), the switch
    on, the "pallas" backend and a 2-D bf16-weight dot."""
    return (bool(rows_hint) and _DENSE_KERNELS and _MATMUL_BACKEND == "pallas"
            and not is_quantized(w) and w.dim() == 2 and rows_hint <= 512 and M <= rows_hint)


def dense_matmul(x, w, norm=None, residual=None, rows_hint: int = 0):
    """[residual +] rms_norm?(x) @ w for a dense (bf16) weight, as
    ``magicdec_tpu.quantization.dense_matmul`` routes it: B15's
    ``dense_matmul_fused`` on a target decode or verify pass where the JAX
    package takes ``dense_matmul_fused_pallas`` (In % 128 == 0,
    Out % 128 == 0, a block from ``_pick_block_out`` at ``rows_hint``
    rows), else the plain bf16 dot (cuBLAS on the card)."""
    lead = x.shape[:-1]
    M = math.prod(lead)
    In, Out = w.shape[-2], w.shape[-1]
    if _dense_routes(w, rows_hint, M) and In % 128 == 0 and Out % 128 == 0:
        block_in = In if norm is not None else min(_in_block_cap(In), In)
        if In % block_in:
            block_in = In
        if _pick_block_out(Out, rows_hint, block_in, In, block_in * 2, norm is not None):
            y = DK.dense_matmul_fused(
                x.reshape(M, In), w, norm[0] if norm is not None else None,
                residual.reshape(M, Out) if residual is not None else None,
                eps=norm[1] if norm is not None else 1e-5)
            return y.reshape(*lead, Out)
    if norm is not None:
        x = rms_norm(x, norm[0], norm[1])
    y = x @ w
    return y if residual is None else residual + y


def dense_mlp(x, w13, w2, norm, residual=None, rows_hint: int = 0):
    """The dense FFN block, rms_norm -> silu-gated MLP -> w2 [+ residual],
    as B15's ``dense_mlp`` where the JAX package takes ``dense_mlp_pallas``
    (w2 [F, D], D % 128 == 0, D <= 4096, an F block from its 14 MiB rule at
    ``rows_hint`` rows); else None, and the caller runs the block as
    ``dense_matmul`` pieces."""
    lead = x.shape[:-1]
    M = math.prod(lead)
    D = x.shape[-1]
    if not (_dense_routes(w13, rows_hint, M) and _dense_routes(w2, rows_hint, M)):
        return None
    F = w13.shape[1] // 2
    if tuple(w2.shape) != (F, D) or D % 128 or D > 4096:
        return None
    if not any(F % bf == 0 and 12 * D * bf + rows_hint * D * 14 <= 14 * 1024 * 1024
               for bf in (1024, 768, 512, 384, 256, 128)):
        return None
    y = DK.dense_mlp(x.reshape(M, D), w13, w2, norm[0],
                     residual.reshape(M, D) if residual is not None else None, eps=norm[1])
    return y.reshape(*lead, D)
