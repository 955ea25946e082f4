"""B15: the bf16 weight-streaming dots of the target's decode and verify
passes (CUDA: ``dense_matmul_fused`` in ``csrc/dense_matmul_sm90.cu``,
``dense_mlp`` in ``csrc/ffn_sm90.cu``).

``dense_matmul_fused`` replaces magicdec_tpu/ops/pallas/quant_matmul.py
``dense_matmul_fused_pallas`` (``_dense_fused_kernel``): [res +] rms_norm?(x)
@ w.  ``dense_mlp`` replaces ``dense_mlp_pallas`` (``_dense_mlp_kernel``):
the whole dense FFN block, norm, the w13 gate|up dot, the SiLU gate, the w2
dot and the residual.  Numerics of the kernels and of the plain versions:
the norm is ``bf16(xf * rsqrt(mean(xf^2) + eps)) * bf16(norm_w)``, the
product in bf16; a dot accumulates in f32 and is cast to bf16 once; a
residual is added in bf16; the MLP rounds g and u to bf16 first and gates
them as bf16(g * sigmoid(g) * u) in f32.  The kernels are row-invariant: a
row's bits do not depend on M or on the other rows (see the source), which
the target's padded autoregressive step needs.  Bound on the card: the
weight's HBM bytes.  ``dense_matmul_fused`` is one launch a call: wgmma
products on TMA-streamed weight boxes, the contraction's splits
(``dense_plan``, at most 5) a thread-block cluster that adds its f32
partials on chip in split order.  ``dense_mlp`` is one launch a call of the
persistent FFN kernel that also runs the draft's int8 B5 and B9
(``kernels/quant_matmul.py``), on bf16 weight boxes without scales: every
resident run of 8 blocks walks each dot's column tiles, a grid barrier
after the norm (each block takes its rows' statistic from x) and after
w13, each dot's splits (``dense_mlp_plan``: 1, 2, 4 or 8 ranks of a run)
added through L2 in split order, every M from 1 to 512 in one launch
(128-row passes above 128).
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import on_cpu, ptr, require, require_bf16
from magicdec_tpu_torch.kernels import quant_matmul as QK
from magicdec_tpu_torch.kernels.quant_matmul import BK, BN, TARGET_BLOCKS, _epilogue
from magicdec_tpu_torch.ops.norm import rms_norm

BOX = 64          # dense_matmul_fused: weight columns a TMA box
ROWS_MAX = 512    # dense_matmul_fused and dense_mlp rows a call (the dense routing's cap)
# dense_matmul_fused's largest split: at one block an SM, clusters of 8 ran
# up to 1.7x slower than clusters of 5 on the H100 (PERF.md, PR 9)
DENSE_SPLIT = 5


def dense_mlp_plan(D: int, F: int, clusters: int) -> tuple[int, int]:
    """The splits of ``dense_mlp``'s w13 [D, 2F] and w2 [F, D] dots:
    ``quant_matmul.ffn_split_plan`` on ``clusters``, the card's resident runs
    of 8 blocks of the bf16 core's 128-row pass (one block an SM), whatever
    core M picks, with the item cost of split-K through L2 (the wgmma
    core's).  Fixed by the weights' shapes and the card, never by M, so a
    row's sums run in the same order at every M (the greedy spec == AR
    contract: the AR step pads its rows to the verify pass's).  The grid is
    the resident runs of M's core; it only changes which block runs an
    item.  1B widths on the H100's 16 runs: w13 1, w2 8."""
    item = QK.FFN_ITEM_STAGES[QK.FFN_WG_ROWS]
    return tuple(QK.ffn_split_plan(In, Out, clusters, item) for In, Out in ((D, 2 * F), (F, D)))


def dense_plan(In: int, Out: int, norm: bool) -> tuple[int, int]:
    """(split, boxes) of ``dense_matmul_fused``, from the weight's shape and
    whether the dot norms x (both fixed at a call site), never from M, so a
    row's sums run in the same order at every M.  Boxes: the 64-column
    boxes a tile, 4 with the norm where they divide Out (every column
    tile's cluster reads x from L2 for the statistic and the tiles: half the
    tiles, half those bytes), else 2.  Split: the contraction's splits in
    BK-row tiles, none empty, at most DENSE_SPLIT, minimizing the tiles the
    busiest SM streams (ceil(blocks / 132) blocks an SM, one block an SM,
    times the tiles a block streams), of equals the fewest.  The H100
    measurements behind both choices are in PERF.md (PR 9,
    ``python -m magicdec_tpu_torch.dot_variants --plans``)."""
    boxes = 4 if norm and Out % (BOX * 4) == 0 else 2
    ncol = Out // (BOX * boxes)
    tiles = max(1, In // BK)
    best = None
    for want in range(1, min(DENSE_SPLIT, tiles) + 1):
        per = -(-tiles // want)
        split = -(-tiles // per)
        best = min(best or (1 << 30, 0), (-(-(ncol * split) // TARGET_BLOCKS) * per, split))
    return best[1], boxes


def _dot(x, w):
    return x.to(torch.float32) @ w.to(torch.float32)


def dense_matmul_fused_plain(x, w, norm_w=None, res=None, *, eps=1e-5):
    """Plain version of ``dense_matmul_fused``."""
    if norm_w is not None:
        x = rms_norm(x, norm_w.to(x.dtype), eps)
    return _epilogue(_dot(x, w), x.dtype, res, False)


def dense_mlp_plain(x, w13, w2, norm_w, res=None, *, eps=1e-5):
    """Plain version of ``dense_mlp``."""
    xn = rms_norm(x, norm_w.to(x.dtype), eps)
    gated = _epilogue(_dot(xn, w13), x.dtype, None, True)
    return _epilogue(_dot(gated, w2), x.dtype, res, False)


def _check_dot(x, w, what):
    """(M, In, Out) of one dense dot on the card; raises on what the kernel
    does not take."""
    require(x.dim() == 2 and w.dim() == 2, f"{what}: x [M, In] and w [In, Out] are 2-D")
    M, In = x.shape
    Out = w.shape[1]
    require(w.shape[0] == In and M >= 1, f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)}")
    require(w.is_contiguous(), f"{what}: w must be contiguous")
    require(In % BK == 0 and Out % BN == 0,
            f"{what}: the kernel takes In % {BK} == 0 and Out % {BN} == 0, got {In}, {Out}")
    return M, In, Out


def dense_matmul_fused(x, w, norm_w=None, res=None, *, eps=1e-5):
    """B15: x [M, In] @ w [In, Out] (bf16), with the rms-norm of x by
    ``norm_w`` [In] first and ``res`` [M, Out] added, each optional.  On the
    card: one launch, only ``out`` allocated, at most ROWS_MAX rows."""
    if on_cpu(x, w, norm_w, res):
        return dense_matmul_fused_plain(x, w, norm_w, res, eps=eps)
    out = _launch_fused(x, w, norm_w, res, eps)
    dense_matmul_fused.launches += 1
    return out


dense_matmul_fused.launches = 0


def _launch_fused(x, w, norm_w, res, eps):
    """``dense_matmul_fused`` on the card: one launch, only ``out``
    allocated."""
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, w, norm_w, res)
    M, In, Out = _check_dot(x, w, "dense_matmul_fused")
    require(M <= ROWS_MAX, f"dense_matmul_fused: the kernel takes at most {ROWS_MAX} rows, "
                           f"got {M}")
    if norm_w is not None:
        require(norm_w.numel() == In, f"dense_matmul_fused: norm weight of {norm_w.numel()}, "
                                      f"not {In}")
        norm_w = norm_w.reshape(-1).contiguous()
    if res is not None:
        require(res.shape == (M, Out), f"dense_matmul_fused: residual {tuple(res.shape)}, "
                                       f"not {(M, Out)}")
        res = res.contiguous()
    out = torch.empty((M, Out), dtype=torch.bfloat16, device=x.device)
    err = build.library().md_dense_matmul_sm90(
        ptr(x), ptr(w), ptr(norm_w), ptr(res), ptr(out), M, In, Out,
        *dense_plan(In, Out, norm_w is not None),
        float(eps), build.stream_ptr(x))
    build.check(err, "dense_matmul_fused (md_dense_matmul_sm90)")
    return out


def _launch_mlp(x, w13, w2, norm_w, res, eps):
    """``dense_mlp`` on the card (csrc/ffn_sm90.cu): one launch; scratch hn
    [M, D], gated [M, F] and, with a split dot, its f32 partials [split, M,
    Out]."""
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, w13, w2, norm_w, res)
    M, D, F2 = _check_dot(x, w13, "dense_mlp w13")
    F = F2 // 2
    require(M <= ROWS_MAX, f"dense_mlp: the kernel takes at most {ROWS_MAX} rows, got {M}")
    require(D % BN == 0 and D <= QK.FFN_MAX_D,
            f"dense_mlp: the kernel takes D % {BN} == 0 and D <= {QK.FFN_MAX_D}, got {D}")
    require(tuple(w2.shape) == (F, D) and w2.is_contiguous() and F % BK == 0,
            f"dense_mlp: w2 {tuple(w2.shape)} for F={F}, D={D}")
    require(norm_w.numel() == D, f"dense_mlp: norm weight of {norm_w.numel()}, not {D}")
    norm_w = norm_w.reshape(-1).contiguous()
    if res is not None:
        require(res.shape == (M, D), f"dense_mlp: residual {tuple(res.shape)}, not {(M, D)}")
        res = res.contiguous()
    dev = x.device
    splits = dense_mlp_plan(D, F, QK._resident(dev, QK.FFN_ROWS, bf16=True))
    clusters = QK._resident(dev, M, bf16=True)
    hn, out = (torch.empty((M, D), dtype=torch.bfloat16, device=dev) for _ in range(2))
    gated = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    part_rows = max((s * Out for s, Out in zip(splits, (2 * F, D)) if s > 1), default=0)
    part = (torch.empty((part_rows * M,), dtype=torch.float32, device=dev) if part_rows
            else None)
    err = build.library().md_dense_mlp_sm90(
        ptr(x), ptr(w13), ptr(w2), ptr(norm_w), ptr(res), ptr(out), ptr(hn), ptr(gated),
        ptr(part), ptr(QK._grid_barrier(dev)), M, D, F, *splits, clusters, 1, float(eps),
        build.stream_ptr(x))
    build.check(err, "dense_mlp (md_dense_mlp_sm90)")
    return out


def dense_mlp(x, w13, w2, norm_w, res=None, *, eps=1e-5):
    """B15: x [M, D]; w13 [D, 2F] (gate columns, then up), w2 [F, D], bf16;
    norm_w [D]; res [M, D] or None.  Returns [res +] the FFN block of x.  On
    the card: one launch, M <= ROWS_MAX."""
    if on_cpu(x, w13, w2, norm_w, res):
        return dense_mlp_plain(x, w13, w2, norm_w, res, eps=eps)
    out = _launch_mlp(x, w13, w2, norm_w, res, eps)
    dense_mlp.launches += 1
    return out


dense_mlp.launches = 0
