"""B4, B5, B6, B9: the int8 weight-only dots of the draft's weight copy, and
B4-int4, B6-int4: its group-wise int4 dots (CUDA: B4, B6, B4-int4 and
B6-int4 in ``csrc/quant_matmul_sm90.cu``, B5 and B9 in
``csrc/ffn_sm90.cu``).

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
(``scale`` [1, Out] or [Out]); B4 and B6 also take group-wise int8 scales
[In/group, Out] (group a power of two >= 32: the ``_grouped`` entry point),
summed as the int4 dots below sum theirs.  Numerics of the kernels and of
the plain versions: acc = f32 sum of x * q; y = bf16(acc * scale) with the
scale in f32 (the reference scales each in-block partial, equal up to f32
rounding);
the norm is ``bf16(xf * rsqrt(mean(xf^2) + eps)) * bf16(norm_w)``; the gate
rounds g and u to bf16 and returns bf16(g * sigmoid(g) * u); a residual is
added in bf16.  Bound on the card: the weight's HBM bytes (see the sources
for the designs).  B4 and B6 are one launch a call: the contraction's
splits (``cluster_split_plan``, at most 8) form a thread-block cluster that
adds its f32 partial sums on chip, in split order.  B5 and B9 are one
persistent launch a call: clusters of 8 blocks, as many as the card holds
at once, walk each dot's column tiles, grid barriers between the dots,
each dot's splits (``ffn_plan``: 1, 2, 4 or 8 ranks of a cluster) added in
split order.

The int4 dots replace the nibble-plane branches of the same Pallas calls:
``quant_matmul_fused_int4`` (B4-int4, ``_fused_kernel`` with bits=4: the
gate or residual epilogue, never the norm, which the reference applies
outside) and ``quant_matmul_int4`` (B6-int4, ``_int4_kernel``).  q is packed
int8 [In/2, Out] (contraction rows 2r and 2r+1 in the low and high nibble of
row r, ``quantization.pack_int4``) with f32 scales [In/group, Out].
Numerics: acc = sum over groups g in order of f32(x_g @ q_g) * s_g, then
one bf16 cast and B4's epilogue.  B4-int4 is one launch a call on B4's
cluster kernel, its splits cut on group boundaries
(``cluster_split_plan(In, Out, max(group, BK4))``).  B6-int4, the draft's
int4 lm_head, is one launch a call of its own kernel: the transposed
product out^T = q^T x^T on ``wgmma``, the nibbles converted in registers
as its A operand, no split of the contraction (the head's columns alone
fill the card), the groups summed in order.

B4, B6 and B4-int4 route by M alone (``dot_route``): up to CLUSTER_ROWS = 64
rows (the draft's steps) they run on the cluster core above; from 65 to 256
rows (the quantized target's decode_rows) on the 128-row core of
``csrc/quant_matmul_m128_sm90.cu``, the same transposed ``wgmma`` product
with x^T as a 128-row B operand, two consumer warpgroups and its own split
plan (``m128_split_plan``, a function of the weight's shape alone).  Its
launches are also counted on each wrapper's ``m128_launches``.
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
CLUSTER_ROWS = 64     # B4/B6/B4-int4 rows on the cluster core; above, the 128-row core
M128_TILE = 128       # the 128-row core's weight columns a tile (a block)
M128_ITEM_STAGES = 3  # a split item's cost beyond its stages (the on-chip reduction)
# the clusters of each split (1..8 blocks, one an SM) the H100 holds at once
# for the 128-row core (csrc md_quant_matmul_m128_resident; a card test holds
# the table to it): clusters must fit in one GPC, so splits that do not
# divide its SMs leave some idle
M128_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def cluster_split_plan(In: int, Out: int, unit: int = BK) -> int:
    """B4/B6's (and B4-int4's) contraction splits, cut in units of ``unit``
    rows (B4-int4: max(group, BK4), so every split starts on a group
    boundary): at most MAX_SPLIT (one portable cluster per column tile),
    none empty.  One where the column tiles alone fill the 132 SMs (the
    blocks then walk the tiles); else the split that minimizes the units
    the busiest SM streams, ceil(blocks / 132) blocks an SM times the units
    a block streams; of equals, the most splits that keep every block
    resident (two an SM: more warps on the same bytes).  Fixed by the
    weight's shape alone, so a row's sums run in the same order at every M."""
    tiles = max(1, In // unit)
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


def dot_route(M: int) -> str:
    """The core of B4, B6 and B4-int4 at M rows: "cluster" (M <= 64, the
    draft's steps: csrc/quant_matmul_sm90.cu) or "m128" (65..256, the
    quantized target's decode_rows: csrc/quant_matmul_m128_sm90.cu).  On
    the target M is always decode_rows, so its verify and padded AR step
    take one kernel and one plan."""
    return "cluster" if M <= CLUSTER_ROWS else "m128"


def m128_split_plan(In: int, Out: int, unit: int, stage: int) -> int:
    """The 128-row core's contraction splits, cut in units of ``unit`` rows
    (a multiple of the ``stage`` rows a ring stage brings: 64 int8, 128
    int4; group-wise, max(group, stage), so every split starts on a group
    boundary): at most MAX_SPLIT (one portable cluster a column tile of
    M128_TILE), none empty.  Of the splits, the one whose busiest SM
    streams the fewest stages: ceil(tiles / clusters) items of ceil(units
    / split) units, plus M128_ITEM_STAGES an item of a split dot, with
    M128_CLUSTERS[split] clusters on the card at once; of equals, the
    fewest splits.  Fixed by the weight's shape alone, so a row's sums run in the
    same order at every M the core serves."""
    units = max(1, In // unit)
    ntiles = max(1, Out // M128_TILE)
    per_unit = max(1, unit // stage)
    best = None
    for want in range(1, min(MAX_SPLIT, units) + 1):
        per = -(-units // want)
        split = -(-units // per)
        rounds = -(-ntiles // M128_CLUSTERS[split])
        key = (rounds * (per * per_unit + (M128_ITEM_STAGES if split > 1 else 0)), split)
        best = min(best or key, key)
    return best[1]


FFN_CLUSTER = 8            # B5/B9: blocks a cluster (the portable maximum)
FFN_SPLITS = (1, 2, 4, 8)  # a dot's splits: groups of ranks that cut the cluster evenly
FFN_ROWS = 128             # B5's rows a call, and the mma.sync core's; B9 takes ROWS_MAX
FFN_WG_ROWS = 256          # B9's rows above FFN_ROWS: the wgmma core, one pass
FFN_TILE_BARS = 1024       # split items a dot: their meeting words (csrc TILE_BARS)
FFN_MAX_D = 16384          # the norm's rows: their 32-column slots in shared memory
# what an item of a split dot costs beyond its stages (the partials'
# reduction, the group's wait for its slowest rank, the epilogue), in
# BK-row stages, for the mma.sync core (partials through DSMEM) and the
# wgmma core (through L2); fitted to the H100 sweep of the 1B w13 dot's
# splits (PERF.md, PR 12: python -m magicdec_tpu_torch.dot_variants
# --variants ffn_current --ffn_plans)
FFN_ITEM_STAGES = {FFN_ROWS: 2, FFN_WG_ROWS: 24}


def ffn_split_plan(In: int, Out: int, clusters: int, item_stages: int) -> int:
    """The contraction splits of one dot of the persistent FFN kernel (B5,
    B9, B15's ``dense_mlp``) on ``clusters`` resident clusters (or runs) of
    8 blocks: of the splits that cut a cluster into equal groups (1, 2, 4,
    8), none empty, the one whose busiest group
    streams the fewest stages, ceil(column tiles / groups) items of
    ceil(BK tiles / split) stages each, plus ``item_stages`` an item of a
    split dot; of equals, the fewest splits.  Fixed by the weight's shape
    and the card (its resident clusters) alone, so a row's sums run in the
    same order at every M a core serves."""
    ktiles, ntiles = In // BK, Out // BN
    best = None
    for split in FFN_SPLITS:
        per = -(-ktiles // split)
        if split > ktiles or -(-ktiles // per) != split:
            continue  # an empty split
        rounds = -(-ntiles // (clusters * (FFN_CLUSTER // split)))
        key = (rounds * (per + (item_stages if split > 1 else 0)), split)
        best = min(best or key, key)
    return best[1]


def ffn_rows_a_pass(M: int, bf16: bool = False) -> int:
    """The rows one pass of the persistent FFN kernel's product core covers
    at M rows: 16, 32, 64 or 128 on the mma.sync core, FFN_WG_ROWS on the
    wgmma core (int8 M > FFN_ROWS, B9 only); bf16 weights (B15's
    ``dense_mlp``) take the mma.sync core at every M, 128 rows a pass above
    FFN_ROWS.  The C side picks its core, and keys its resident count, by
    the same rule."""
    if bf16:
        return next((r for r in (16, 32, 64) if M <= r), FFN_ROWS)
    return next(r for r in (16, 32, 64, FFN_ROWS, FFN_WG_ROWS) if M <= r)


def ffn_plan(dots, M: int, resident: int) -> tuple[int, ...]:
    """The splits of each dot of one B5/B9 call at M rows, ``dots`` the
    (In, Out) of each dot in order, on ``resident`` clusters of 8 blocks:
    the clusters the card holds at once for the call's core
    (``md_ffn_sm90_resident``), which is also the grid (every cluster, so
    that a phase with fewer tiles than groups still spreads over every SM;
    the grid barrier needs every block on the card at once).  1B widths at
    the H100's 30 clusters (mma.sync core): wo 8, w13 4, w2 8; B9 at 256
    rows on 16 (wgmma core): w13 1, w2 8."""
    require(resident >= 1, f"ffn_plan: {resident} resident clusters")
    item = FFN_ITEM_STAGES[FFN_WG_ROWS if M > FFN_ROWS else FFN_ROWS]
    return tuple(ffn_split_plan(In, Out, resident, item) for In, Out in dots)


def _scaled(x, q, scale):
    """The f32 sums of an int8 dot, scaled: x @ q * s with one scale a
    column, or group-wise (scale [G, Out], G > 1) as ``_group_sums``."""
    if scale.dim() == 2 and scale.shape[0] > 1:
        return _group_sums(x, q.to(torch.float32), scale)
    return (x.to(torch.float32) @ q.to(torch.float32)) * scale.reshape(-1).to(torch.float32)


def _scaled_int4(x, q, scale):
    """``_group_sums`` of q packed int4 [In/2, Out]."""
    from magicdec_tpu_torch.quantization import unpack_int4

    return _group_sums(x, unpack_int4(q).to(torch.float32), scale)


def _group_sums(x, qf, scale):
    """sum over groups g, in order, of f32(x_g @ q_g) * s_g: qf f32
    [In, Out], scale [G, Out]."""
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


def _check_dot(x, q, scale, what, grouped=False):
    """(M, In, Out, f32 scale, group) of one int8 dequant dot on the card;
    raises on what the kernel does not take.  One scale a column (flat,
    group In); with ``grouped`` (B4, B6) also group-wise scales [G, Out],
    G > 1, whose group In / G must be a power of two >= 32."""
    require(x.dim() == 2 and q.dim() == 2, f"{what}: x [M, In] and q [In, Out] are 2-D")
    M, In = x.shape
    Out = q.shape[1]
    require(q.shape[0] == In and M >= 1, f"{what}: x {tuple(x.shape)} and q {tuple(q.shape)}")
    require(q.dtype == torch.int8 and q.is_contiguous(), f"{what}: q must be contiguous int8")
    require(In % BK == 0 and Out % BN == 0,
            f"{what}: the kernel takes In % {BK} == 0 and Out % {BN} == 0, got {In}, {Out}")
    require(scale.dtype == torch.float32, f"{what}: the scales must be float32")
    if grouped and scale.dim() == 2 and scale.shape[0] > 1:
        G = scale.shape[0]
        group = In // G
        require(scale.shape[1] == Out and G * group == In and group >= 32
                and group & (group - 1) == 0,
                f"{what}: group-wise int8 scales [G, {Out}] need a power-of-two group >= 32 "
                f"dividing {In}, got {tuple(scale.shape)}")
        return M, In, Out, scale.contiguous(), group
    require(scale.numel() == Out, f"{what}: one float32 scale per output column")
    return M, In, Out, scale.reshape(-1).contiguous(), In


def _launch_dot(x, q, scale, norm_w=None, res=None, gate=False, eps=1e-5, what=""):
    """B4 and B6 on the card: one launch on the core of ``dot_route(M)``,
    only ``out`` allocated."""
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, norm_w, res)
    M, In, Out, scale, group = _check_dot(x, q, scale, what, grouped=True)
    require(M <= ROWS_MAX, f"{what}: the kernel takes at most {ROWS_MAX} rows, got {M}")
    Fo = Out // 2 if gate else Out
    if norm_w is not None:
        require(norm_w.numel() == In, f"{what}: norm weight of {norm_w.numel()}, not {In}")
        norm_w = norm_w.reshape(-1).contiguous()
    if res is not None:
        require(res.shape == (M, Out), f"{what}: residual {tuple(res.shape)}, not {(M, Out)}")
        res = res.contiguous()
    out = torch.empty((M, Fo), dtype=torch.bfloat16, device=x.device)
    operands = (ptr(x), ptr(q), ptr(scale), ptr(norm_w), ptr(res), ptr(out), M, In, Out,
                int(gate))
    if dot_route(M) == "m128":  # group-wise: the splits start on group boundaries
        entry = "md_quant_matmul_m128_sm90"
        unit = BK if group == In else max(group, BK)
        err = build.library().md_quant_matmul_m128_sm90(
            *operands, m128_split_plan(In, Out, unit, BK), group, float(eps),
            build.stream_ptr(x))
    elif group == In:
        entry = "md_quant_matmul_sm90"
        err = build.library().md_quant_matmul_sm90(
            *operands, cluster_split_plan(In, Out), float(eps), build.stream_ptr(x))
    else:  # group-wise: the splits start on group boundaries
        entry = "md_quant_matmul_grouped_sm90"
        err = build.library().md_quant_matmul_grouped_sm90(
            *operands, cluster_split_plan(In, Out, max(group, BK)), group, float(eps),
            build.stream_ptr(x))
    build.check(err, f"{what} ({entry})")
    return out


def quant_matmul(x, q, scale):
    """B6: x [M, In] @ (q int8 [In, Out] * scale [Out], or group-wise
    scale [In/group, Out]) -> [M, Out]."""
    if on_cpu(x, q, scale):
        return quant_matmul_plain(x, q, scale)
    out = _launch_dot(x, q, scale, what="quant_matmul")
    _count(quant_matmul, x.shape[0])
    return out


def _count(wrapper, M: int) -> None:
    """One launch of B4, B6 or B4-int4 at M rows: ``launches``, and
    ``m128_launches`` on the 128-row core (``wrapper`` is the module's
    name for it, which a caller's spy may stand in for: the spy then holds
    both counts)."""
    wrapper.launches += 1
    if dot_route(M) == "m128":
        wrapper.m128_launches = getattr(wrapper, "m128_launches", 0) + 1


quant_matmul.launches = quant_matmul.m128_launches = 0


def quant_matmul_fused(x, q, scale, norm_w=None, res=None, *, gate=False, eps=1e-5):
    """B4: ``quant_matmul`` with the rms-norm of x first (``norm_w`` [In]),
    and either the SiLU gate over q's gate|up halves (``gate``: q [In, 2F],
    returns [M, F]) or a residual ``res`` [M, Out] added."""
    require(not (gate and res is not None), "the gate and the residual do not combine")
    if on_cpu(x, q, scale, norm_w, res):
        return quant_matmul_fused_plain(x, q, scale, norm_w, res, gate=gate, eps=eps)
    out = _launch_dot(x, q, scale, norm_w, res, gate, eps, what="quant_matmul_fused")
    _count(quant_matmul_fused, x.shape[0])
    return out


quant_matmul_fused.launches = quant_matmul_fused.m128_launches = 0


def _check_ffn(x, q13, s13, q2, s2, norm_w, what):
    """(M, D, F, s13, s2, norm_w) of an int8 FFN block on the card; raises
    on what the kernels do not take."""
    M, D, F2, s13, _ = _check_dot(x, q13, s13, what + " w13")
    F = F2 // 2
    require(M <= ROWS_MAX, f"{what}: the kernel takes at most {ROWS_MAX} rows, got {M}")
    require(norm_w.numel() == D, f"{what}: norm weight of {norm_w.numel()}, not {D}")
    require(D % BN == 0 and D <= FFN_MAX_D,
            f"{what}: the kernel takes D % {BN} == 0 and D <= {FFN_MAX_D}, got {D}")
    require(q2.shape == (F, D) and q2.dtype == torch.int8 and q2.is_contiguous()
            and F % BK == 0 and s2.dtype == torch.float32 and s2.numel() == D,
            f"{what}: w2 {tuple(q2.shape)} {q2.dtype} for F={F}, D={D}")
    return M, D, F, s13, s2.reshape(-1).contiguous(), norm_w.reshape(-1).contiguous()


_GRID_BARRIERS = {}   # device -> the persistent FFN kernel's grid barrier words
_RESIDENT = {}        # (device, bf16 weights, rows a pass) -> resident clusters


def _resident(dev, M: int, bf16: bool = False) -> int:
    """The clusters (or runs) of 8 blocks the card holds at once for the
    core serving M rows of int8 (B5, B9) or bf16 (B15's ``dense_mlp``: runs,
    no cluster) weights, read once a device, format and core: the two
    formats' cores hold different shared memory, so a grid sized for one
    can exceed the other's residency."""
    from magicdec_tpu_torch.kernels import build

    key = (dev, bool(bf16), ffn_rows_a_pass(M, bf16))
    if key not in _RESIDENT:
        with torch.cuda.device(dev):
            n = build.library().md_ffn_sm90_resident(M, int(bf16))
        build.check(-n if n < 0 else 0, "md_ffn_sm90_resident")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def _grid_barrier(dev):
    """The persistent FFN kernel's barrier words on ``dev`` (the grid's,
    then the wgmma core's tile barriers: 2 + 2 * FFN_TILE_BARS int32): one
    zeroed buffer a device, shared by B5, B9 and B15's ``dense_mlp``,
    allocated at the first call and kept (its words count generations, so
    calls in turn on one stream and a captured graph's replays need no
    reset)."""
    if dev not in _GRID_BARRIERS:
        _GRID_BARRIERS[dev] = torch.zeros(2 + 2 * FFN_TILE_BARS, dtype=torch.int32, device=dev)
    return _GRID_BARRIERS[dev]


def _launch_mlp(x, q13, s13, q2, s2, norm_w, res, eps, prefetch):
    """B9 on the card (csrc/ffn_sm90.cu): one launch; scratch hn [M, D],
    gated [M, F] and, on the wgmma core (M > 128) with a split dot, its f32
    partials."""
    from magicdec_tpu_torch.kernels import build

    x = x.contiguous()
    require_bf16(x, norm_w, res)
    M, D, F, s13, s2, norm_w = _check_ffn(x, q13, s13, q2, s2, norm_w, "quant_mlp")
    if res is not None:
        require(res.shape == (M, D), f"quant_mlp: residual {tuple(res.shape)}, not {(M, D)}")
        res = res.contiguous()
    dots = ((D, 2 * F), (F, D))
    clusters = _resident(x.device, M)
    splits = ffn_plan(dots, M, clusters)
    dev = x.device
    hn, out = (torch.empty((M, D), dtype=torch.bfloat16, device=dev) for _ in range(2))
    gated = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    # the wgmma core's split-K partials go through global memory
    part_rows = max((s * Out for (_, Out), s in zip(dots, splits) if s > 1), default=0)
    part = (torch.empty((part_rows * M,), dtype=torch.float32, device=dev)
            if ffn_rows_a_pass(M) == FFN_WG_ROWS and part_rows else None)
    err = build.library().md_quant_mlp_sm90(
        ptr(x), ptr(q13), ptr(s13), ptr(q2), ptr(s2), ptr(norm_w), ptr(res), ptr(out),
        ptr(hn), ptr(gated), ptr(part), ptr(_grid_barrier(dev)), M, D, F, *splits,
        clusters, int(prefetch), float(eps), build.stream_ptr(x))
    build.check(err, "md_quant_mlp_sm90")
    return out


def _launch_tail(a, x, qo, so, q13, s13, q2, s2, norm_w, eps, prefetch):
    """B5 on the card (csrc/ffn_sm90.cu): one launch; scratch h and hn
    [M, D], gated [M, F] and the statistic's slots [M, D / 32]."""
    from magicdec_tpu_torch.kernels import build

    a, x = a.contiguous(), x.contiguous()
    require_bf16(a, x, norm_w)
    M, K, D, so, _ = _check_dot(a, qo, so, "quant_layer_tail wo")
    _, _, F, s13, s2, norm_w = _check_ffn(x, q13, s13, q2, s2, norm_w, "quant_layer_tail")
    require(x.shape == (M, D), f"quant_layer_tail: x {tuple(x.shape)}, not {(M, D)}")
    require(M <= FFN_ROWS, f"quant_layer_tail: the kernel takes at most {FFN_ROWS} rows, got {M}")
    clusters = _resident(x.device, M)
    splits = ffn_plan(((K, D), (D, 2 * F), (F, D)), M, clusters)
    dev = x.device
    h, hn, out = (torch.empty((M, D), dtype=torch.bfloat16, device=dev) for _ in range(3))
    gated = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    slots = torch.empty((M, D // 32), dtype=torch.float32, device=dev)
    err = build.library().md_quant_layer_tail_sm90(
        ptr(a), ptr(x), ptr(qo), ptr(so), ptr(q13), ptr(s13), ptr(q2), ptr(s2), ptr(norm_w),
        ptr(out), ptr(h), ptr(hn), ptr(gated), ptr(slots), ptr(_grid_barrier(dev)), M, K, D, F,
        *splits, clusters, int(prefetch), float(eps), build.stream_ptr(x))
    build.check(err, "md_quant_layer_tail_sm90")
    return out


def quant_mlp(x, q13, s13, q2, s2, norm_w, res=None, *, eps, prefetch=True):
    """B9: x [M, D]; q13 [D, 2F] (gate columns, then up), q2 [F, D] int8
    with per-column f32 scales; norm_w [D]; res [M, D] or None; M <= 256.
    Returns [res +] the FFN block of x, [M, D].  ``prefetch=False`` holds
    the w2 weights until the grid barrier opens (to measure what issuing
    them early saves)."""
    if on_cpu(x, q13, s13, q2, s2, norm_w, res):
        return quant_mlp_plain(x, q13, s13, q2, s2, norm_w, res, eps=eps)
    out = _launch_mlp(x, q13, s13, q2, s2, norm_w, res, eps, prefetch)
    quant_mlp.launches += 1
    return out


quant_mlp.launches = 0


def quant_layer_tail(a, x, qo, so, q13, s13, q2, s2, norm_w, *, eps, prefetch=True):
    """B5: a [M, K] attention output, x [M, D] the layer's input; qo [K, D],
    q13 [D, 2F], q2 [F, D] int8 with per-column f32 scales; norm_w [D] the
    FFN norm; M <= 128.  Returns the layer's output [M, D].
    ``prefetch=False`` holds each dot's weights until the grid barrier
    before it opens (to measure what issuing them early saves)."""
    if on_cpu(a, x, qo, so, q13, s13, q2, s2, norm_w):
        return quant_layer_tail_plain(a, x, qo, so, q13, s13, q2, s2, norm_w, eps=eps)
    out = _launch_tail(a, x, qo, so, q13, s13, q2, s2, norm_w, eps, prefetch)
    quant_layer_tail.launches += 1
    return out


quant_layer_tail.launches = 0


def _check_dot_int4(x, q, scale, what):
    """(M, In, Out, group) of one int4 dot on the card; raises on what the
    kernels do not take."""
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
    return M, In, Out, group


def _launch_b6_int4(x, q, scale):
    """B6-int4 on the card (csrc/quant_matmul_sm90.cu): one launch, only
    ``out`` allocated, no split of the contraction."""
    from magicdec_tpu_torch.kernels import build

    what = "quant_matmul_int4"
    x = x.contiguous()
    require_bf16(x)
    M, In, Out, group = _check_dot_int4(x, q, scale, what)
    require(M <= ROWS_MAX, f"{what}: the kernel takes at most {ROWS_MAX} rows, got {M}")
    out = torch.empty((M, Out), dtype=torch.bfloat16, device=x.device)
    err = build.library().md_quant_matmul_int4_t_sm90(
        ptr(x), ptr(q), ptr(scale.contiguous()), ptr(out), M, In, Out, group,
        build.stream_ptr(x))
    build.check(err, f"{what} (md_quant_matmul_int4_t_sm90)")
    return out


def _launch_b4_int4(x, q, scale, res=None, gate=False):
    """B4-int4 on the card: one launch on the core of ``dot_route(M)``
    (csrc/quant_matmul_sm90.cu or csrc/quant_matmul_m128_sm90.cu), only
    ``out`` allocated."""
    from magicdec_tpu_torch.kernels import build

    what = "quant_matmul_fused_int4"
    x = x.contiguous()
    require_bf16(x, res)
    M, In, Out, group = _check_dot_int4(x, q, scale, what)
    require(M <= ROWS_MAX, f"{what}: the kernel takes at most {ROWS_MAX} rows, got {M}")
    if res is not None:
        require(res.shape == (M, Out), f"{what}: residual {tuple(res.shape)}, not {(M, Out)}")
        res = res.contiguous()
    out = torch.empty((M, Out // 2 if gate else Out), dtype=torch.bfloat16, device=x.device)
    operands = (ptr(x), ptr(q), ptr(scale.contiguous()), ptr(res), ptr(out), M, In, Out,
                int(gate))
    if dot_route(M) == "m128":
        entry = "md_quant_matmul_int4_m128_sm90"
        err = build.library().md_quant_matmul_int4_m128_sm90(
            *operands, m128_split_plan(In, Out, max(group, BK4), BK4), group,
            build.stream_ptr(x))
    else:
        entry = "md_quant_matmul_int4_sm90"
        err = build.library().md_quant_matmul_int4_sm90(
            *operands, cluster_split_plan(In, Out, max(group, BK4)), group, build.stream_ptr(x))
    build.check(err, f"{what} ({entry})")
    return out


def quant_matmul_int4(x, q, scale):
    """B6-int4: x [M, In] @ dequant(q packed int4 [In/2, Out], scale f32
    [In/group, Out]) -> [M, Out]."""
    if on_cpu(x, q, scale):
        return quant_matmul_int4_plain(x, q, scale)
    out = _launch_b6_int4(x, q, scale)
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
    out = _launch_b4_int4(x, q, scale, res, gate)
    _count(quant_matmul_fused_int4, x.shape[0])
    return out


quant_matmul_fused_int4.launches = quant_matmul_fused_int4.m128_launches = 0
