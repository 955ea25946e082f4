"""B4, B5, B6, B9: the int8 weight-only dots of the draft's weight copy, and
B4-int4, B6-int4: its group-wise int4 dots (CUDA: B4 and B6 in
``csrc/quant_matmul_sm90.cu``, the others in ``csrc/quant_matmul.cu``).

B4 ``quant_matmul_fused`` replaces magicdec_tpu/ops/pallas/quant_matmul.py
``quant_matmul_fused_pallas`` (``_fused_kernel``, int8): x @ (q * scale)
with an rms-norm prologue, a SiLU gate|up epilogue or a residual add.
B5 ``quant_layer_tail`` replaces ``quant_layer_tail_pallas``
(``_layer_tail_kernel``): a draft layer's wo + residual + FFN + residual.
B6 ``quant_matmul`` replaces ``quant_matmul_pallas`` (``_int8_kernel``): the
plain dequant dot (the draft's int8 lm_head).  B9 ``quant_mlp`` replaces
``quant_mlp_pallas`` (``_mlp_kernel``): the FFN block alone, norm to w2
and an optional residual, which the draft takes where B5 declines (129 to
256 rows, e.g. a prefill chunk of 2 requests).

Weights are int8 ``q [In, Out]`` with one f32 scale per output column
(``scale`` [1, Out] or [Out]).  Numerics of the kernels and of the plain
versions: acc = f32 sum of x * q; y = bf16(acc * scale) with the scale in
f32 (the reference scales each in-block partial, equal up to f32 rounding);
the norm is ``bf16(xf * rsqrt(mean(xf^2) + eps)) * bf16(norm_w)``; the gate
rounds g and u to bf16 and returns bf16(g * sigmoid(g) * u); a residual is
added in bf16.  Bound on the card: the weight's HBM bytes (see the sources
for the designs).  B4 and B6 are one launch a call: the contraction's
splits (``cluster_split_plan``, at most 8) form a thread-block cluster that
adds its f32 partial sums on chip, in split order.

The int4 dots replace the nibble-plane branches of the same Pallas calls:
``quant_matmul_fused_int4`` (B4-int4, ``_fused_kernel`` with bits=4: the
gate or residual epilogue, never the norm, which the reference applies
outside) and ``quant_matmul_int4`` (B6-int4, ``_int4_kernel``).  q is packed
int8 [In/2, Out] (contraction rows 2r and 2r+1 in the low and high nibble of
row r, ``quantization.pack_int4``) with f32 scales [In/group, Out].
Numerics: acc = sum over groups g in order of f32(x_g @ q_g) * s_g, then
one bf16 cast and B4's epilogue.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import on_cpu, ptr, require, require_bf16
from magicdec_tpu_torch.ops.norm import rms_norm

BN, BK = 128, 64      # output columns per block, contraction rows per stage
BK4 = 128             # contraction rows per int4 stage (64 packed rows)
TARGET_BLOCKS = 132   # one block per SM of the H100 before splitting further
MAX_SPLIT = 8         # B4/B6: the splits of a column tile form one portable cluster
ROWS_MAX = 256        # B4/B6 rows a launch (the routing's ROWS_CAP)
ENCODE_ERROR = 0x10000  # md_quant_matmul_sm90: a failed tensor-map encode, + CUresult


def split_plan(In: int, Out: int, unit: int = BK) -> int:
    """Contraction splits of one dot (B5, B9 and the int4 dots), cut in
    units of ``unit`` rows (an int4 dot's max(group, BK4): every split
    starts on a group boundary): enough that Out / BN column blocks times
    the splits fill the card's 132 SMs, no split empty.  Fixed by the
    weight's shape alone, so a row's sums run in the same order at every M."""
    tiles = In // unit
    want = max(1, min(tiles, -(-TARGET_BLOCKS // max(1, Out // BN))))
    per = -(-tiles // want)
    return -(-tiles // per)


def cluster_split_plan(In: int, Out: int) -> int:
    """B4/B6's contraction splits: at most MAX_SPLIT (one portable cluster
    per column tile), none empty.  One where the column tiles alone fill
    the 132 SMs (the blocks then walk the tiles); else the split that
    minimizes the contraction tiles the busiest SM streams, ceil(blocks /
    132) blocks an SM times the tiles a block streams; of equals, the most
    splits that keep every block resident (two an SM: more warps on the
    same bytes).  Fixed by the weight's shape alone, so a row's sums run in
    the same order at every M."""
    tiles = max(1, In // BK)
    ncol = max(1, Out // BN)
    if ncol >= TARGET_BLOCKS:
        return 1
    best = None
    for want in range(1, min(MAX_SPLIT, tiles) + 1):
        per = -(-tiles // want)
        split = -(-tiles // per)
        key = (-(-(ncol * split) // TARGET_BLOCKS) * per, ncol * split > 2 * TARGET_BLOCKS,
               -split)
        best = min(best or key, key)
    return -best[2]


def _scaled(x, q, scale):
    return (x.to(torch.float32) @ q.to(torch.float32)) * scale.reshape(-1).to(torch.float32)


def _scaled_int4(x, q, scale):
    """sum over groups g, in order, of f32(x_g @ q_g) * s_g: q packed
    [In/2, Out], scale [G, Out]."""
    from magicdec_tpu_torch.quantization import unpack_int4

    qf = unpack_int4(q).to(torch.float32)
    G = scale.shape[-2]
    gs = qf.shape[0] // G
    xf = x.to(torch.float32)
    sf = scale.reshape(G, -1).to(torch.float32)
    acc = torch.zeros((x.shape[0], qf.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc += (xf[:, g * gs:(g + 1) * gs] @ qf[g * gs:(g + 1) * gs]) * sf[g]
    return acc


def _epilogue(acc, dtype, res, gate):
    """B4's finish of the f32 sums: the SiLU gate of the bf16-rounded gate
    and up halves, or bf16(acc) plus a residual added in bf16."""
    if gate:
        F = acc.shape[-1] // 2
        g = acc[..., :F].to(dtype).to(torch.float32)
        u = acc[..., F:].to(dtype).to(torch.float32)
        return (g * torch.sigmoid(g) * u).to(dtype)
    y = acc.to(dtype)
    return y if res is None else y + res


def quant_matmul_plain(x, q, scale):
    """Plain version of B6: bf16(f32(x @ q) * scale), in x.dtype."""
    return _scaled(x, q, scale).to(x.dtype)


def quant_matmul_fused_plain(x, q, scale, norm_w=None, res=None, *, gate=False, eps=1e-5):
    """Plain version of B4 (see the module docstring for its rounding)."""
    if norm_w is not None:
        x = rms_norm(x, norm_w.to(x.dtype), eps)
    return _epilogue(_scaled(x, q, scale), x.dtype, res, gate)


def quant_matmul_int4_plain(x, q, scale):
    """Plain version of B6-int4: bf16 of the group-wise f32 sums."""
    return _scaled_int4(x, q, scale).to(x.dtype)


def quant_matmul_fused_int4_plain(x, q, scale, res=None, *, gate=False):
    """Plain version of B4-int4: B4's epilogue on the group-wise sums."""
    return _epilogue(_scaled_int4(x, q, scale), x.dtype, res, gate)


def quant_mlp_plain(x, q13, s13, q2, s2, norm_w, res=None, *, eps):
    """Plain version of B9: [res +] bf16(gate(rms(x) * norm_w @ q13 * s13)
    @ q2 * s2)."""
    gated = quant_matmul_fused_plain(x, q13, s13, norm_w, gate=True, eps=eps)
    return quant_matmul_fused_plain(gated, q2, s2, res=res)


def quant_layer_tail_plain(a, x, qo, so, q13, s13, q2, s2, norm_w, *, eps):
    """Plain version of B5: h = x + bf16(a @ qo * so), then B9 of h with
    the residual h."""
    h = quant_matmul_fused_plain(a, qo, so, res=x)
    return quant_mlp_plain(h, q13, s13, q2, s2, norm_w, h, eps=eps)


def _check_dot(x, q, scale, what):
    """(M, In, Out, flat f32 scale) of one dequant dot on the card; raises
    on what the kernel does not take."""
    require(x.dim() == 2 and q.dim() == 2, f"{what}: x [M, In] and q [In, Out] are 2-D")
    M, In = x.shape
    Out = q.shape[1]
    require(q.shape[0] == In and M >= 1, f"{what}: x {tuple(x.shape)} and q {tuple(q.shape)}")
    require(q.dtype == torch.int8 and q.is_contiguous(), f"{what}: q must be contiguous int8")
    require(In % BK == 0 and Out % BN == 0,
            f"{what}: the kernel takes In % {BK} == 0 and Out % {BN} == 0, got {In}, {Out}")
    require(scale.dtype == torch.float32 and scale.numel() == Out,
            f"{what}: one float32 scale per output column")
    return M, In, Out, scale.reshape(-1).contiguous()


def _launch_dot(x, q, scale, norm_w=None, res=None, gate=False, eps=1e-5, what=""):
    """B4 and B6 on the card: one launch, only ``out`` allocated."""
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, norm_w, res)
    M, In, Out, scale = _check_dot(x, q, scale, what)
    require(M <= ROWS_MAX, f"{what}: the kernel takes at most {ROWS_MAX} rows, got {M}")
    Fo = Out // 2 if gate else Out
    if norm_w is not None:
        require(norm_w.numel() == In, f"{what}: norm weight of {norm_w.numel()}, not {In}")
        norm_w = norm_w.reshape(-1).contiguous()
    if res is not None:
        require(res.shape == (M, Out), f"{what}: residual {tuple(res.shape)}, not {(M, Out)}")
        res = res.contiguous()
    out = torch.empty((M, Fo), dtype=torch.bfloat16, device=x.device)
    err = build.library().md_quant_matmul_sm90(
        ptr(x), ptr(q), ptr(scale), ptr(norm_w), ptr(res), ptr(out), M, In, Out, int(gate),
        cluster_split_plan(In, Out), float(eps), build.stream_ptr(x))
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - ENCODE_ERROR}")
    build.check(err, "md_quant_matmul_sm90")
    return out


def quant_matmul(x, q, scale):
    """B6: x [M, In] @ (q int8 [In, Out] * scale [Out]) -> [M, Out]."""
    if on_cpu(x, q, scale):
        return quant_matmul_plain(x, q, scale)
    out = _launch_dot(x, q, scale, what="quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_fused(x, q, scale, norm_w=None, res=None, *, gate=False, eps=1e-5):
    """B4: ``quant_matmul`` with the rms-norm of x first (``norm_w`` [In]),
    and either the SiLU gate over q's gate|up halves (``gate``: q [In, 2F],
    returns [M, F]) or a residual ``res`` [M, Out] added."""
    require(not (gate and res is not None), "the gate and the residual do not combine")
    if on_cpu(x, q, scale, norm_w, res):
        return quant_matmul_fused_plain(x, q, scale, norm_w, res, gate=gate, eps=eps)
    out = _launch_dot(x, q, scale, norm_w, res, gate, eps, what="quant_matmul_fused")
    quant_matmul_fused.launches += 1
    return out


quant_matmul_fused.launches = 0


def _check_ffn(x, q13, s13, q2, s2, norm_w, what):
    """(M, D, F, s13, s2, norm_w) of an int8 FFN block on the card; raises
    on what the kernels do not take."""
    M, D, F2, s13 = _check_dot(x, q13, s13, what + " w13")
    F = F2 // 2
    require(norm_w.numel() == D, f"{what}: norm weight of {norm_w.numel()}, not {D}")
    require(q2.shape == (F, D) and q2.dtype == torch.int8 and q2.is_contiguous()
            and F % BK == 0 and s2.dtype == torch.float32 and s2.numel() == D,
            f"{what}: w2 {tuple(q2.shape)} {q2.dtype} for F={F}, D={D}")
    return M, D, F, s13, s2.reshape(-1).contiguous(), norm_w.reshape(-1).contiguous()


def _ffn_scratch(M, D, F, dev, *splits):
    """hn [M, D], gated [M, F] and the partial sums of the largest phase."""
    part = torch.empty((max(splits) * M,), dtype=torch.float32, device=dev)
    return (torch.empty((M, D), dtype=torch.bfloat16, device=dev),
            torch.empty((M, F), dtype=torch.bfloat16, device=dev), part)


def quant_mlp(x, q13, s13, q2, s2, norm_w, res=None, *, eps):
    """B9: x [M, D]; q13 [D, 2F] (gate columns, then up), q2 [F, D] int8
    with per-column f32 scales; norm_w [D]; res [M, D] or None.  Returns
    [res +] the FFN block of x, [M, D]."""
    if on_cpu(x, q13, s13, q2, s2, norm_w, res):
        return quant_mlp_plain(x, q13, s13, q2, s2, norm_w, res, eps=eps)
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, norm_w, res)
    M, D, F, s13, s2, norm_w = _check_ffn(x, q13, s13, q2, s2, norm_w, "quant_mlp")
    if res is not None:
        require(res.shape == (M, D), f"quant_mlp: residual {tuple(res.shape)}, not {(M, D)}")
        res = res.contiguous()
    splits = (split_plan(D, 2 * F), split_plan(F, D))
    hn, gated, part = _ffn_scratch(M, D, F, x.device, splits[0] * 2 * F, splits[1] * D)
    out = torch.empty((M, D), dtype=torch.bfloat16, device=x.device)
    err = build.library().md_quant_mlp(
        ptr(x), ptr(q13), ptr(s13), ptr(q2), ptr(s2), ptr(norm_w), ptr(res), ptr(out),
        ptr(hn), ptr(gated), ptr(part), M, D, F, *splits, float(eps), build.stream_ptr(x))
    build.check(err, "md_quant_mlp")
    quant_mlp.launches += 1
    return out


quant_mlp.launches = 0


def quant_layer_tail(a, x, qo, so, q13, s13, q2, s2, norm_w, *, eps):
    """B5: a [M, K] attention output, x [M, D] the layer's input; qo [K, D],
    q13 [D, 2F], q2 [F, D] int8 with per-column f32 scales; norm_w [D] the
    FFN norm.  Returns the layer's output [M, D]."""
    if on_cpu(a, x, qo, so, q13, s13, q2, s2, norm_w):
        return quant_layer_tail_plain(a, x, qo, so, q13, s13, q2, s2, norm_w, eps=eps)
    from magicdec_tpu_torch.kernels import build

    a, x = a.contiguous(), x.contiguous()
    require_bf16(a, x, norm_w)
    M, K, D, so = _check_dot(a, qo, so, "quant_layer_tail wo")
    _, _, F, s13, s2, norm_w = _check_ffn(x, q13, s13, q2, s2, norm_w, "quant_layer_tail")
    require(x.shape == (M, D), f"quant_layer_tail: x {tuple(x.shape)}, not {(M, D)}")
    splits = (split_plan(K, D), split_plan(D, 2 * F), split_plan(F, D))
    hn, gated, part = _ffn_scratch(M, D, F, x.device, splits[0] * D, splits[1] * 2 * F,
                                   splits[2] * D)
    h, out = (torch.empty((M, D), dtype=torch.bfloat16, device=x.device) for _ in range(2))
    err = build.library().md_quant_layer_tail(
        ptr(a), ptr(x), ptr(qo), ptr(so), ptr(q13), ptr(s13), ptr(q2), ptr(s2),
        ptr(norm_w), ptr(out), ptr(h), ptr(hn), ptr(gated), ptr(part), M, K, D, F,
        *splits, float(eps), build.stream_ptr(x))
    build.check(err, "md_quant_layer_tail")
    quant_layer_tail.launches += 1
    return out


quant_layer_tail.launches = 0


def _launch_dot_int4(x, q, scale, res=None, gate=False, what=""):
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, res)
    require(x.dim() == 2 and q.dim() == 2 and scale.dim() == 2,
            f"{what}: x [M, In], packed q [In/2, Out] and scale [G, Out] are 2-D")
    M, In = x.shape
    Out = q.shape[1]
    G = scale.shape[0]
    require(q.shape[0] * 2 == In and M >= 1,
            f"{what}: x {tuple(x.shape)} and packed q {tuple(q.shape)}")
    require(q.dtype == torch.int8 and q.is_contiguous(), f"{what}: q must be contiguous int8")
    require(scale.dtype == torch.float32 and scale.shape[1] == Out and G >= 1 and In % G == 0,
            f"{what}: float32 scales [G, {Out}] with G dividing {In}, got {tuple(scale.shape)}")
    group = In // G
    require(group >= 32 and group & (group - 1) == 0 and In % max(group, BK4) == 0
            and Out % BN == 0,
            f"{what}: the kernel takes a power-of-two group >= 32, In % max(group, {BK4}) == 0 "
            f"and Out % {BN} == 0, got group {group}, In {In}, Out {Out}")
    Fo = Out // 2 if gate else Out
    if res is not None:
        require(res.shape == (M, Out), f"{what}: residual {tuple(res.shape)}, not {(M, Out)}")
        res = res.contiguous()
    split = split_plan(In, Out, max(group, BK4))
    dev = x.device
    out = torch.empty((M, Fo), dtype=torch.bfloat16, device=dev)
    part = (torch.empty((split, M, Out), dtype=torch.float32, device=dev)
            if split > 1 or gate else None)
    err = build.library().md_quant_matmul_int4(
        ptr(x), ptr(q), ptr(scale.contiguous()), ptr(res), ptr(out), ptr(part),
        M, In, Out, int(gate), split, group, build.stream_ptr(x))
    build.check(err, "md_quant_matmul_int4")
    return out


def quant_matmul_int4(x, q, scale):
    """B6-int4: x [M, In] @ dequant(q packed int4 [In/2, Out], scale f32
    [In/group, Out]) -> [M, Out]."""
    if on_cpu(x, q, scale):
        return quant_matmul_int4_plain(x, q, scale)
    out = _launch_dot_int4(x, q, scale, what="quant_matmul_int4")
    quant_matmul_int4.launches += 1
    return out


quant_matmul_int4.launches = 0


def quant_matmul_fused_int4(x, q, scale, res=None, *, gate=False):
    """B4-int4: ``quant_matmul_int4`` with either the SiLU gate over q's
    gate|up halves (``gate``: q [In/2, 2F], returns [M, F]) or a residual
    ``res`` [M, Out] added, or neither (the caller norms x first)."""
    require(not (gate and res is not None), "the gate and the residual do not combine")
    if on_cpu(x, q, scale, res):
        return quant_matmul_fused_int4_plain(x, q, scale, res, gate=gate)
    out = _launch_dot_int4(x, q, scale, res, gate, what="quant_matmul_fused_int4")
    quant_matmul_fused_int4.launches += 1
    return out


quant_matmul_fused_int4.launches = 0
