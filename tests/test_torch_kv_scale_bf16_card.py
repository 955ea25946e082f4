"""The bf16-scale instances of the quantized-KV kernels (``--kv_scale
bf16``) and B4 / B6 on group-wise int8 weights, on the card (``gpu``
marker; each test skips without a card):

    python -m pytest tests/test_torch_kv_scale_bf16_card.py -m gpu --noconftest

A bf16 scale widens to f32 exactly and the kernels keep their f32
arithmetic, so each bf16-scale launch (K1q, B10, K2q, B11, B12's int8 and
int4 pools, K3q, B13, B14's scale columns) must give the bits of the same
kernel's f32 instance on the widened scales: 0 bits may differ.  Each is
also held against its plain version within ``kernels.bf16_limit``, over
windows and pages that start at odd positions and scale rows of odd length
(the kernels' 2-byte scale loads) and at even ones (their 4-byte pair
copies), and over a cache poisoned past every visible end.  B4 and B6 on
group-wise int8 weights run at M = 32, 64 and 128 within bf16_limit of
their plain versions; a group the kernel does not take raises.

No JAX here: the card's machine has none.  The CPU parity tests are
tests/test_torch_kv_scale_bf16.py and tests/test_torch_quant_group_int8.py.
"""

import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import append as AP
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import paged_attention as PGA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.kernels import quant_matmul as QK
from magicdec_tpu_torch.ops import kv_cache as KV

L, HD, LAYER = 2, 64, 1
BF = torch.bfloat16
FMTS = {"int8": (KV.quantize_kv_tokens, DA.flash_decode_attend_quant,
                 DA.flash_decode_attend_quant_plain, PA.flash_prefill_attend_quant,
                 PA.flash_prefill_attend_quant_plain, PGA.flash_paged_decode_attend_quant),
        "int4": (KV.quantize_kv_tokens_int4, DA.flash_decode_attend_quant4,
                 DA.flash_decode_attend_quant4_plain, PA.flash_prefill_attend_quant4,
                 PA.flash_prefill_attend_quant4_plain, PGA.flash_paged_decode_attend_quant4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _quant(gen, fmt, lead, S, Hkv, device):
    """Rows [*lead, S, width] and bf16 scales [*lead, Hkv, S] quantized from
    bf16 randn (``quantize_kv_tokens(_int4)(scale_dtype=bf16)``)."""
    n = 1
    for d in lead:
        n *= d
    x = torch.randn((n, S, Hkv, HD), generator=gen, device=device).to(BF)
    q, s = FMTS[fmt][0](x, scale_dtype=BF)
    return q.reshape(*lead, S, -1), s.reshape(*lead, Hkv, S)


def _operands(gen, fmt, S, T, base, device, Hkv=8, G=4):
    """(q, caches (k, ks, v, vs) with bf16 scales, fresh rows, base)."""
    Bc = len(base)
    k, ks = _quant(gen, fmt, (L, Bc), S, Hkv, device)
    v, vs = _quant(gen, fmt, (L, Bc), S, Hkv, device)
    kn, ksn = _quant(gen, fmt, (Bc,), T, Hkv, device)
    vn, vsn = _quant(gen, fmt, (Bc,), T, Hkv, device)
    q = torch.randn((Bc, T, Hkv * G, HD), generator=gen, device=device).to(BF)
    fresh = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
    return q, (k, ks, v, vs), fresh, torch.tensor(base, dtype=torch.int32, device=device)


def _widened(caches, fresh):
    """The same operands with every scale widened to f32."""
    wide = tuple(c.float() if i % 2 else c for i, c in enumerate(caches))
    return wide, {n: t.float() if n in ("ks_new", "vs_new") else t for n, t in fresh.items()}


def _same_as_f32_and_plain(fn, plain, q, caches, fresh, base):
    """With and without the fresh rows: bit-equal to the f32 instance on the
    widened scales, finite and within bf16_limit of the plain version."""
    wide, wfresh = _widened(caches, fresh)
    for f, wf in ((fresh, wfresh), ({}, {})):
        out = fn(q, *caches, base, layer=LAYER, **f)
        assert torch.equal(out.view(torch.int16),
                           fn(q, *wide, base, layer=LAYER, **wf).view(torch.int16))
        assert torch.isfinite(out).all()
        assert _outside(out, plain(q, *caches, base, layer=LAYER, **f)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 257, 8704])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_decode_bf16_scales_equal_the_f32_instance_on_card(cuda, fmt, T, S):
    """K1q and B10: odd bases (the fresh window at an odd position) and an
    odd S (every scale row of odd length: each scale by its own load)."""
    gen = torch.Generator(device=cuda).manual_seed(T + S)
    _, fn, plain = FMTS[fmt][:3]
    q, caches, fresh, base = _operands(gen, fmt, S, T, [0, S // 3 | 1, S - T], cuda)
    _same_as_f32_and_plain(fn, plain, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_decode_bf16_scales_window_equals_steps_on_card(cuda, fmt):
    """A verify window's token t has the bits of the step at base + t."""
    from test_torch_kv_quant import window_equals_steps

    gen = torch.Generator(device=cuda).manual_seed(7)
    q, caches, fresh, base = _operands(gen, fmt, 8704, 4, [0, 2901, 8700], cuda)
    window_equals_steps(FMTS[fmt][1], q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 8704])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_decode_bf16_scales_poisoned_cache_on_card(cuda, fmt, S):
    """Rows past every visible end -128 with inf / NaN bf16 scales: never
    read, so the output is the clean cache's bit for bit."""
    from test_torch_kv_quant import poisoned_cache_matches_clean

    gen = torch.Generator(device=cuda).manual_seed(11)
    q, caches, fresh, base = _operands(gen, fmt, S, 4, [0, S // 3 | 1, S - 4], cuda)
    poisoned_cache_matches_clean(FMTS[fmt][1], FMTS[fmt][2], q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 200, 512])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_prefill_bf16_scales_equal_the_f32_instance_on_card(cuda, fmt, C):
    """K2q and B11 at bases that start a tile (0) or straddle one (37, 300,
    S - C - 5)."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    S = 1024
    fn, plain = FMTS[fmt][3:5]
    q, caches, fresh, base = _operands(gen, fmt, S, C, [0, 37, 300, S - C - 5], cuda)
    _same_as_f32_and_plain(fn, plain, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_prefill_bf16_scales_poisoned_cache_on_card(cuda, fmt):
    """Cache rows past base (the chunk's fresh rows take their place) and
    their scales inf / NaN: the output is the clean cache's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    S, C = 1024, 200
    fn = FMTS[fmt][3]
    q, caches, fresh, base = _operands(gen, fmt, S, C, [0, 37, 500], cuda)
    k, ks, v, vs = (c.clone() for c in caches)
    for b, n in enumerate(base.tolist()):
        k[:, b, n:], v[:, b, n:] = -128, -128
        ks[:, b, :, n:], vs[:, b, :, n:] = float("inf"), float("nan")
    out = fn(q, k, ks, v, vs, base, layer=LAYER, **fresh)
    assert torch.isfinite(out).all()
    assert torch.equal(out, fn(q, *caches, base, layer=LAYER, **fresh))


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [15, 16, 40, 512])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_paged_bf16_scales_on_card(cuda, fmt, ps):
    """B12's int8 and int4 pools on bf16 scales: bit-equal to the f32
    instance on the widened scale pools and to the contiguous kernel over
    the gathered pool, within bf16_limit of the plain version; pages of odd
    length (15: each scale by its own load) and of 16 rows (a 32-byte scale
    row a page)."""
    from magicdec_tpu_torch.ops import paged_kv as PKV

    gen = torch.Generator(device=cuda).manual_seed(ps)
    B, Hkv, G, T = 3, 8, 4, 4
    npr = 1024 // ps
    P = B * npr + 5
    table = torch.randperm(P, generator=gen, device=cuda)[: B * npr].reshape(B, npr)
    table = table.to(torch.int32).contiguous()
    k, ks = _quant(gen, fmt, (L, P), ps, Hkv, cuda)
    v, vs = _quant(gen, fmt, (L, P), ps, Hkv, cuda)
    pools = (k.contiguous(), ks.contiguous(), v.contiguous(), vs.contiguous())
    kn, ksn = _quant(gen, fmt, (B,), T, Hkv, cuda)
    vn, vsn = _quant(gen, fmt, (B,), T, Hkv, cuda)
    fresh = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
    q = torch.randn((B, T, Hkv * G, HD), generator=gen, device=cuda).to(BF)
    base = torch.tensor([0, 301, npr * ps - T], dtype=torch.int32, device=cuda)
    fn, contig = FMTS[fmt][5], FMTS[fmt][1]
    wide, wfresh = _widened(pools, fresh)
    gathered = [PKV.pool_gather(p, table) if i % 2 == 0 else PKV.scale_pool_gather(p, table)
                for i, p in enumerate(pools)]
    for f, wf in ((fresh, wfresh), ({}, {})):
        out = fn(q, *pools, table, base, layer=LAYER, **f)
        assert torch.equal(out, fn(q, *wide, table, base, layer=LAYER, **wf))
        assert torch.equal(out, contig(q, *gathered, base, layer=LAYER, **f))
        ref = PGA.flash_paged_decode_attend_quant_plain(q, *pools, table, base, layer=LAYER, **f)
        assert torch.isfinite(out).all() and _outside(out, ref) == 0


def _append_widened(fn, operands, scale_at):
    """``fn`` on copies of ``operands`` and on copies with the bf16 tensors
    at ``scale_at`` widened to f32: the data bit-equal, the scales equal to
    the widened ones bit for bit.  Returns the bf16 run's outputs."""
    got = [o.clone() if torch.is_tensor(o) else o for o in operands]
    wide = [(o.float() if i in scale_at else o.clone()) if torch.is_tensor(o) else o
            for i, o in enumerate(operands)]
    out = fn(*got)
    wout = fn(*wide)
    for a, b in zip(out, wout):
        if a.dtype == BF:
            assert torch.equal(a.float().view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 4, 512])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_append_bf16_scales_on_card(cuda, fmt, T):
    """K3q and B14's scale columns into bf16 scale caches: bit-equal to the
    plain versions and to the f32 instances on the widened scales; rows at
    or past S (a window running past the end, one wholly past it) dropped."""
    gen = torch.Generator(device=cuda).manual_seed(T)
    S, Bc = 1024, 4
    ck, sk = _quant(gen, fmt, (L, Bc), S, 8, cuda)
    cv, sv = _quant(gen, fmt, (L, Bc), S, 8, cuda)
    rk, srk = _quant(gen, fmt, (L, Bc), T, 8, cuda)
    rv, srv = _quant(gen, fmt, (L, Bc), T, 8, cuda)
    pos = torch.tensor([5, S - T, S - (T + 1) // 2, 2 * S], dtype=torch.int32, device=cuda)
    ops = [ck, cv, rk, rv, pos, sk, sv, srk, srv]
    got = _append_widened(AP.append_all_rows_inplace_quant, ops, {5, 6, 7, 8})
    want = AP.append_all_rows_inplace_plain(*(o.clone() for o in ops))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pos = torch.tensor([0, S - 128, S - T, S - 1], dtype=torch.int32, device=cuda)
    got = _append_widened(lambda s, r, p: (AP.append_scale_rows_inplace(s, r, p),),
                          [sk, srk, pos], {0, 1})
    assert torch.equal(got[0], AP.append_scale_rows_inplace_plain(sk.clone(), srk, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [15, 16, 512])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_paged_append_bf16_scales_on_card(cuda, fmt, ps):
    """B13 into bf16 scale pools: bit-equal to the plain version and to
    the f32 instance on the widened scale pools."""
    gen = torch.Generator(device=cuda).manual_seed(ps)
    Bc, Hkv, T = 4, 8, 4
    npr = 1024 // ps
    S, P = npr * ps, Bc * npr + 3
    table = torch.randperm(P, generator=gen, device=cuda)[: Bc * npr].reshape(Bc, npr)
    table = table.to(torch.int32).contiguous()
    pos = torch.tensor([0, ps - 2, S - T, S - 1], dtype=torch.int32, device=cuda)
    pk, psk = _quant(gen, fmt, (L, P), ps, Hkv, cuda)
    pv, psv = _quant(gen, fmt, (L, P), ps, Hkv, cuda)
    rk, srk = _quant(gen, fmt, (L, Bc), T, Hkv, cuda)
    rv, srv = _quant(gen, fmt, (L, Bc), T, Hkv, cuda)
    ops = [pk.contiguous(), pv.contiguous(), rk, rv, pos, table, psk.contiguous(),
           psv.contiguous(), srk, srv]
    got = _append_widened(PGA.append_paged_rows_inplace, ops, {6, 7, 8, 9})
    want = PGA.append_paged_rows_inplace_plain(*(o.clone() for o in ops))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_mixed_scale_dtypes_raise_on_card(cuda):
    """One dtype for the cache's scales and the fresh rows': nothing is cast."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, caches, fresh, base = _operands(gen, "int8", 256, 4, [0, 9, 100], cuda)
    with pytest.raises(TypeError, match="all be float32 or all bfloat16"):
        DA.flash_decode_attend_quant(q, *caches, base, layer=LAYER,
                                     **dict(fresh, ks_new=fresh["ks_new"].float()))
    k, ks, v, vs = caches
    with pytest.raises(TypeError, match="all be float32 or all bfloat16"):
        PA.flash_prefill_attend_quant(q, k, ks.float(), v, vs, base, layer=LAYER)


# -- B4 and B6 on group-wise int8 weights -----------------------------------------


def _grouped(gen, In, Out, group, device):
    w = torch.randn((In, Out), generator=gen, device=device) * In ** -0.5
    return Q.quantize_weight(w, bits=8, group_size=group, reciprocal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 64, 128])
@pytest.mark.parametrize("group", [32, 128])
def test_b4_b6_group_int8_on_card(cuda, group, M):
    """B4 (wqkv + norm, w13 + gate, w2 + residual) and B6 (a 1024-row head
    slice) on group-wise int8 weights at llama-3.2-1b widths, within
    bf16_limit of the plain versions; the scales shifted by one group must
    fail it; two calls bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(M + group)
    D, F = 2048, 8192
    norm_w = (torch.rand((D,), generator=gen, device=cuda) + 0.5).to(BF)
    x = (torch.randn((M, D), generator=gen, device=cuda) * 3).to(BF)
    g = (torch.randn((M, F), generator=gen, device=cuda) * 0.5).to(BF)
    res = torch.randn((M, D), generator=gen, device=cuda).to(BF)
    cases = [
        (_grouped(gen, D, D + 1024, group, cuda), x, dict(norm_w=norm_w)),
        (_grouped(gen, D, 2 * F, group, cuda), x, dict(norm_w=norm_w, gate=True)),
        (_grouped(gen, F, D, group, cuda), g, dict(res=res)),
    ]
    for w, a, kw in cases:
        out = QK.quant_matmul_fused(a, w.q, w.scale, **kw)
        ref = QK.quant_matmul_fused_plain(a, w.q, w.scale, **kw)
        assert torch.isfinite(out).all() and _outside(out, ref) == 0
        assert _outside(QK.quant_matmul_fused_plain(a, w.q, w.scale.roll(1, 0), **kw), ref) > 0
        assert torch.equal(out, QK.quant_matmul_fused(a, w.q, w.scale, **kw))
    head = _grouped(gen, D, 1024, group, cuda)
    out = QK.quant_matmul(x, head.q, head.scale)
    assert _outside(out, QK.quant_matmul_plain(x, head.q, head.scale)) == 0


@pytest.mark.gpu
def test_b4_group_int8_rows_equal_across_m_on_card(cuda):
    """A row's bits do not depend on the rows beside it within a core (the
    wrappers route by M alone: up to 64 rows the cluster core, 65 to 256 the
    128-row core): rows of a 64-row call (one pass of 64) equal the same
    rows called at 32, and rows of a 128-row call equal the same rows called
    at 65 and 100."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = _grouped(gen, 2048, 3072, 128, cuda)
    norm_w = (torch.rand((2048,), generator=gen, device=cuda) + 0.5).to(BF)
    x = (torch.randn((128, 2048), generator=gen, device=cuda) * 3).to(BF)
    for full_rows, rows in ((64, (32,)), (128, (65, 100))):
        full = QK.quant_matmul_fused(x[:full_rows], w.q, w.scale, norm_w)
        for M in rows:
            assert torch.equal(QK.quant_matmul_fused(x[:M], w.q, w.scale, norm_w), full[:M])


@pytest.mark.gpu
@pytest.mark.parametrize("group", [16, 96])
def test_b4_b6_group_int8_refuse_other_groups_on_card(cuda, group):
    """A group that is not a power of two >= 32 raises, naming the limit;
    the plain version never runs on the card."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    w = _grouped(gen, 1536 if group == 96 else 2048, 256, group, cuda)
    x = torch.randn((32, w.q.shape[0]), generator=gen, device=cuda).to(BF)
    for fn in (QK.quant_matmul, QK.quant_matmul_fused):
        with pytest.raises(ValueError, match="power-of-two group >= 32"):
            fn(x, w.q, w.scale)
