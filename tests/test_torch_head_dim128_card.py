"""The head-dim-128 instances of the attention kernels on the card (``gpu``
marker; skipped without one) against their plain versions, within
``kernels.bf16_limit``.  B10, B11 and B12's int4 pool at the 8B target's
widths (32 query heads, 8 kv heads of 128 dims, an int4 cache packed in
head pairs with f32 scales):

- B10 (``flash_decode_attend_quant4``): verify T = 4 and the AR step T = 1
  over 256 and 16512 rows (the longspec path's ``--max_len``), with and
  without the window's fresh rows; without them, or with the nibble planes
  swapped, the plain version must fail the bound; a window's token equal
  bit for bit to its autoregressive step; a cache poisoned past every
  visible end (bytes -128, scales inf / NaN) giving the clean cache's bits;
  two launches and a graph replay bit-equal;
- B11 (``flash_prefill_attend_quant4``): ragged chunks C = 64, 200, 512 at
  odd bases (0, 37, 300, S - C - 5: a 64-position tile straddling base),
  the longspec path's last chunk (C = 512 at base 15872 of 16512), a
  poisoned cache, two launches bit-equal;
- B12's int4 pool (``flash_paged_decode_attend_quant4``): 16 ragged slots
  (lengths 0 to S - T) through a permuted table at page sizes 16 and 512,
  each launch bit-equal to the contiguous B10 over the gathered pool, and a
  poisoned pool;
- K1 (the blocked call at T = 1, 4, 16 and the draft's whole-row call
  over 640 rows), K1q, K2, K2q and B12's bf16 and int8 pools at llama-3.1-8b's
  heads (32 and 8: G = 4) and llama-2-7b-32k's (32 and 32: G = 1): within
  the bound with and without the fresh rows, outside it without them; a
  cache poisoned past every visible end (bf16 rows inf / NaN, int8 rows
  -128 with inf / NaN scales) giving the clean bits; each window token bit
  for bit its T = 1 step; a paged launch bit for bit the contiguous one
  over the gathered pool (pages of 16, 40 and 512 rows); a CUDA-graph
  replay the eager bits;
- the bf16-scale instances of K1q, B10, K2q, B11 and B12's int8 and int4
  pools: bit for bit the f32 instances on the widened scales, poisoned
  caches the clean bits;
- a head dim without an instance (96) raises before any launch.

The head-dim-64 cases stay in their own files.  Run on the card with
``python -m pytest tests/test_torch_head_dim128_card.py -m gpu --noconftest``.
"""

import pytest
import torch

from magicdec_tpu_torch import kernels as K
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import paged_attention as PGA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV
from magicdec_tpu_torch.ops import paged_kv as PKV

HD, HKV, G, L, LAYER = 128, 8, 4, 2, 1
S8B = 16512  # the longspec path's --max_len

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _int4(gen, Lc, Bc, S, device):
    """Packed int4 rows [Lc, Bc, S, (HKV/2)*HD] and f32 scales [Lc, Bc, HKV,
    S] quantized from bf16 randn by the port's quantize_kv_tokens_int4."""
    x = torch.randn((Lc * Bc, S, HKV, HD), generator=gen, device=device).to(torch.bfloat16)
    q, s = KV.quantize_kv_tokens_int4(x)
    return q.reshape(Lc, Bc, S, -1), s.reshape(Lc, Bc, HKV, S)


def _operands(gen, cuda, S, T, base):
    """(q, caches (k, ks, v, vs), fresh rows, base) of len(base) requests."""
    Bc = len(base)
    k, ks = _int4(gen, L, Bc, S, cuda)
    v, vs = _int4(gen, L, Bc, S, cuda)
    fk, fks = _int4(gen, 1, Bc, T, cuda)
    fv, fvs = _int4(gen, 1, Bc, T, cuda)
    q = torch.randn((Bc, T, HKV * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    return q, (k, ks, v, vs), fresh, torch.tensor(base, dtype=torch.int32, device=cuda)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _swap_planes(packed):
    return ((packed << 4) | ((packed >> 4) & 0x0F)).to(torch.int8)


def _matches_plain(fn, plain, q, caches, fresh, base):
    """With and without the fresh rows within bf16_limit of the plain
    version, each launch on the head-dim-128 instance; without its fresh
    rows, and the plain version with the nibble planes swapped, outside."""
    for kw in ({}, fresh):
        n = fn.hd128_launches
        out = fn(q, *caches, base, layer=LAYER, **kw)
        ref = plain(q, *caches, base, layer=LAYER, **kw)
        assert fn.hd128_launches == n + 1
        assert torch.isfinite(out).all() and out.shape == q.shape
        assert _outside(out, ref) == 0
    assert _outside(fn(q, *caches, base, layer=LAYER), ref) > 0
    k, ks, v, vs = caches
    swapped = dict(fresh, k_new=_swap_planes(fresh["k_new"]), v_new=_swap_planes(fresh["v_new"]))
    assert _outside(plain(q, _swap_planes(k), ks, _swap_planes(v), vs, base, layer=LAYER,
                          **swapped), ref) > 0


def _poisoned(caches, base, end):
    """Copies with every row past base + end poisoned: int8 / int4 rows -128
    with inf (k) and NaN (v) scales; bf16 rows (k, v) inf and NaN."""
    out = [c.clone() for c in caches]
    for b, n in enumerate(base.tolist()):
        if len(out) == 2:
            out[0][:, b, n + end:] = float("inf")
            out[1][:, b, n + end:] = float("nan")
        else:
            out[0][:, b, n + end:] = -128
            out[2][:, b, n + end:] = -128
            out[1][:, b, :, n + end:] = float("inf")
            out[3][:, b, :, n + end:] = float("nan")
    return tuple(out)


def _poisoned_matches_clean(fn, plain, q, caches, fresh, base):
    T = q.shape[1]
    for kw, end in ((fresh, 0), ({}, T)):
        out = fn(q, *_poisoned(caches, base, end), base, layer=LAYER, **kw)
        assert torch.isfinite(out).all()
        assert torch.equal(out, fn(q, *caches, base, layer=LAYER, **kw))
        assert _outside(out, plain(q, *caches, base, layer=LAYER, **kw)) == 0


# -- B10 -----------------------------------------------------------------------


@pytest.mark.parametrize("S", [256, S8B])
@pytest.mark.parametrize("T", [1, 4])
def test_b10_hd128_matches_plain_on_card(cuda, T, S):
    gen = torch.Generator(device=cuda).manual_seed(T)
    q, caches, fresh, base = _operands(gen, cuda, S, T, [0, 37, S // 3, S - T])
    _matches_plain(DA.flash_decode_attend_quant4, DA.flash_decode_attend_quant4_plain, q,
                   caches, fresh, base)


def test_b10_hd128_window_equals_step_on_card(cuda):
    from test_torch_kv_quant import window_equals_steps

    gen = torch.Generator(device=cuda).manual_seed(40)
    q, caches, fresh, base = _operands(gen, cuda, S8B, 4, [0, 4097, S8B - 4])
    window_equals_steps(DA.flash_decode_attend_quant4, q, caches, fresh, base)


@pytest.mark.parametrize("S", [256, S8B])
def test_b10_hd128_poisoned_cache_on_card(cuda, S):
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, caches, fresh, base = _operands(gen, cuda, S, 4, [0, S // 3, S - 4])
    _poisoned_matches_clean(DA.flash_decode_attend_quant4, DA.flash_decode_attend_quant4_plain,
                            q, caches, fresh, base)


def test_b10_hd128_deterministic_and_graph_replay_on_card(cuda):
    from test_torch_kv_quant import deterministic_and_graph_replay

    gen = torch.Generator(device=cuda).manual_seed(42)
    q, caches, fresh, base = _operands(gen, cuda, S8B, 4, [0, 2900, 8700, S8B - 4])
    deterministic_and_graph_replay(DA.flash_decode_attend_quant4, q, caches, fresh, base)


# -- B11 -----------------------------------------------------------------------


@pytest.mark.parametrize("C", [64, 200, 512])
def test_b11_hd128_matches_plain_on_card(cuda, C):
    """Bases that start a 64-position tile (0), straddle one (37, 300, S -
    C - 5), with and without fresh rows."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    S = 1024
    q, caches, fresh, base = _operands(gen, cuda, S, C, [0, 37, 300, S - C - 5])
    _matches_plain(PA.flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4_plain, q,
                   caches, fresh, base)


def test_b11_hd128_last_chunk_of_the_longspec_encode_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, caches, fresh, base = _operands(gen, cuda, S8B, 512, [15872, 15872])
    _matches_plain(PA.flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4_plain, q,
                   caches, fresh, base)


def test_b11_hd128_poisoned_cache_and_deterministic_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, caches, fresh, base = _operands(gen, cuda, 1024, 200, [0, 300, 1024 - 205])
    _poisoned_matches_clean(PA.flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4_plain,
                            q, caches, fresh, base)
    first = PA.flash_prefill_attend_quant4(q, *caches, base, layer=LAYER, **fresh)
    for _ in range(3):
        assert torch.equal(PA.flash_prefill_attend_quant4(q, *caches, base, layer=LAYER,
                                                          **fresh), first)


# -- B12's int4 pool -----------------------------------------------------------


def _pool_case(gen, cuda, ps, T, lens, poison=False):
    """Contiguous caches of len(lens) slots over npr pages each, scattered
    into a pool through a permuted table (B scratch pages first, as the
    serving engine lays them out)."""
    Bc, S = len(lens), S8B if ps == 16 else 8192
    npr = S // ps
    q, caches, fresh, base = _operands(gen, cuda, npr * ps, T, lens)
    if poison:
        caches = _poisoned(caches, base, 0)
    P = Bc + Bc * npr
    perm = torch.randperm(Bc * npr, generator=gen, device=cuda) + Bc
    table = perm.view(Bc, npr).to(torch.int32).contiguous()
    k, ks, v, vs = caches
    pools = []
    for data, scale in ((k, ks), (v, vs)):
        pool = PKV.pool_scatter(torch.zeros((L, P, ps, data.shape[-1]), dtype=torch.int8,
                                            device=cuda), table, data)
        segs = (scale.reshape(L, Bc, HKV, npr, ps).permute(0, 1, 3, 2, 4)
                .reshape(L, Bc * npr, HKV, ps))
        spool = torch.zeros((L, P, HKV, ps), dtype=torch.float32, device=cuda)
        spool[:, table.reshape(-1).long()] = segs
        pools += [pool, spool]
    return q, caches, tuple(pools), table, fresh, base


@pytest.mark.parametrize("ps", [16, 512])
def test_b12_int4_hd128_matches_plain_and_contiguous_on_card(cuda, ps):
    """16 ragged slots (lengths 0 to S - T, odd bases): within bf16_limit of
    the plain version, bit-equal to B10 over the gathered pool."""
    gen = torch.Generator(device=cuda).manual_seed(ps)
    S, T = (S8B if ps == 16 else 8192), 4
    lens = [0, 1, 17, 37, 255, 513, 1000, 2049, 3001, 4095, 4097, 5000, 6143, 7001,
            S // 2 + 3, S - T]
    q, caches, pools, table, fresh, base = _pool_case(gen, cuda, ps, T, lens)
    fn = PGA.flash_paged_decode_attend_quant4
    for kw in ({}, fresh):
        n = fn.hd128_launches
        out = fn(q, *pools, table, base, layer=LAYER, **kw)
        assert fn.hd128_launches == n + 1
        ref = PGA.flash_paged_decode_attend_quant4_plain(q, *pools, table, base, layer=LAYER,
                                                         **kw)
        assert torch.isfinite(out).all() and _outside(out, ref) == 0
        assert torch.equal(out, DA.flash_decode_attend_quant4(q, *caches, base, layer=LAYER,
                                                              **kw))
    assert _outside(fn(q, *pools, table, base, layer=LAYER), ref) > 0


def test_b12_int4_hd128_poisoned_pool_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    lens = [0, 300, 4097, 8188]
    q, clean, _, table, fresh, base = _pool_case(gen, cuda, 512, 4, lens)
    gen = torch.Generator(device=cuda).manual_seed(9)
    _, _, pools, table_p, _, _ = _pool_case(gen, cuda, 512, 4, lens, poison=True)
    fn = PGA.flash_paged_decode_attend_quant4
    out = fn(q, *pools, table_p, base, layer=LAYER, **fresh)
    assert torch.isfinite(out).all()
    assert torch.equal(out, DA.flash_decode_attend_quant4(q, *clean, base, layer=LAYER, **fresh))


# -- K1, K1q, K2, K2q, B12's bf16 and int8 pools; bf16 scales -------------------

SHAPES = {"G4": (32, 8), "G1": (32, 32)}  # (Hq, Hkv): llama-3.1-8b, llama-2-7b-32k


def _dense_rows(gen, Lc, Bc, S, Hkv, device):
    return torch.randn((Lc, Bc, S, Hkv * HD), generator=gen, device=device).to(torch.bfloat16)


def _int8_rows(gen, Lc, Bc, S, Hkv, device, scale_dtype=torch.float32):
    x = torch.randn((Lc * Bc, S, Hkv, HD), generator=gen, device=device).to(torch.bfloat16)
    q, s = KV.quantize_kv_tokens(x, scale_dtype=scale_dtype)
    return q.reshape(Lc, Bc, S, -1), s.reshape(Lc, Bc, Hkv, S)


def _shape_operands(gen, cuda, fmt, shape, S, T, base, scale_dtype=torch.float32):
    """(q, caches, fresh rows, base) of len(base) requests at ``shape``'s
    heads: bf16 caches (k, v) or int8 (k, ks, v, vs) quantized from bf16
    randn, with scales in ``scale_dtype``."""
    Hq, Hkv = SHAPES[shape]
    Bc = len(base)
    q = torch.randn((Bc, T, Hq, HD), generator=gen, device=cuda).to(torch.bfloat16)
    if fmt == "bf16":
        caches = (_dense_rows(gen, L, Bc, S, Hkv, cuda), _dense_rows(gen, L, Bc, S, Hkv, cuda))
        fresh = dict(k_new=_dense_rows(gen, 1, Bc, T, Hkv, cuda)[0],
                     v_new=_dense_rows(gen, 1, Bc, T, Hkv, cuda)[0])
    else:
        k, ks = _int8_rows(gen, L, Bc, S, Hkv, cuda, scale_dtype)
        v, vs = _int8_rows(gen, L, Bc, S, Hkv, cuda, scale_dtype)
        (fk, fks), (fv, fvs) = (_int8_rows(gen, 1, Bc, T, Hkv, cuda, scale_dtype)
                                for _ in range(2))
        caches = (k, ks, v, vs)
        fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    return q, caches, fresh, torch.tensor(base, dtype=torch.int32, device=cuda)


def _checks(fn, plain, q, caches, fresh, base):
    """Within bf16_limit of the plain version with and without the fresh
    rows (each launch on the head-dim-128 instance), outside it without
    them; a cache poisoned past every visible end gives the clean bits."""
    for kw in ({}, fresh):
        n = fn.hd128_launches
        out = fn(q, *caches, base, layer=LAYER, **kw)
        ref = plain(q, *caches, base, layer=LAYER, **kw)
        assert fn.hd128_launches == n + 1
        assert torch.isfinite(out).all() and out.shape == q.shape
        assert _outside(out, ref) == 0
    assert _outside(fn(q, *caches, base, layer=LAYER), ref) > 0
    for kw, end in ((fresh, 0), ({}, q.shape[1])):
        out = fn(q, *_poisoned(caches, base, end), base, layer=LAYER, **kw)
        assert torch.isfinite(out).all()
        assert torch.equal(out, fn(q, *caches, base, layer=LAYER, **kw))


DECODE = {"bf16": (DA.flash_decode_attend, DA.flash_decode_attend_plain),
          "int8": (DA.flash_decode_attend_quant, DA.flash_decode_attend_quant_plain)}
PREFILL = {"bf16": (PA.flash_prefill_attend, PA.flash_prefill_attend_plain),
           "int8": (PA.flash_prefill_attend_quant, PA.flash_prefill_attend_quant_plain)}


@pytest.mark.parametrize("shape", ["G4", "G1"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("T,S", [(4, 1024), (1, 1024), (4, 8704), (16, 1024)])
def test_decode_hd128_matches_plain_on_card(cuda, fmt, shape, T, S):
    """K1 and K1q: the verify (T = 4), the AR step (T = 1) and a 16-token
    window (at G = 4 64 grouped rows: a block for each 16) over 1024 and the
    8B path's 8704 rows, ragged bases; poisoned caches give the clean
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(T + S)
    q, caches, fresh, base = _shape_operands(gen, cuda, fmt, shape, S, T,
                                             [0, 37, S // 3, S - T])
    _checks(*DECODE[fmt], q, caches, fresh, base)


@pytest.mark.parametrize("shape", ["G4", "G1"])
def test_k1_whole_row_hd128_on_card(cuda, shape):
    """The draft's call over its 640-row budget cache (B = 32, T = 1)."""
    gen = torch.Generator(device=cuda).manual_seed(640)
    base = [int(x) for x in torch.randint(0, 639, (32,), generator=gen, device=cuda)]
    base[0], base[-1] = 0, 639
    q, caches, fresh, base = _shape_operands(gen, cuda, "bf16", shape, 640, 1, base)
    _checks(*DECODE["bf16"], q, caches, fresh, base)


@pytest.mark.parametrize("shape", ["G4", "G1"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_decode_hd128_window_equals_step_and_graph_replay_on_card(cuda, fmt, shape):
    gen = torch.Generator(device=cuda).manual_seed(43)
    q, caches, fresh, base = _shape_operands(gen, cuda, fmt, shape, 8704, 4,
                                             [0, 4097, 8704 - 4])
    from test_torch_kv_quant import deterministic_and_graph_replay, window_equals_steps

    fn = DECODE[fmt][0]
    window_equals_steps(fn, q, caches, fresh, base)
    deterministic_and_graph_replay(fn, q, caches, fresh, base)


@pytest.mark.parametrize("shape", ["G4", "G1"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("C", [64, 200, 512])
def test_prefill_hd128_matches_plain_on_card(cuda, fmt, shape, C):
    """K2 and K2q: bases that start a 64-position tile (0) or straddle one
    (37, 300, S - C - 5); poisoned caches give the clean bits; two launches
    and a graph replay bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    S = 1024
    q, caches, fresh, base = _shape_operands(gen, cuda, fmt, shape, S, C,
                                             [0, 37, 300, S - C - 5])
    fn, plain = PREFILL[fmt]
    _checks(fn, plain, q, caches, fresh, base)
    if C == 200:
        from test_torch_kv_quant import deterministic_and_graph_replay

        deterministic_and_graph_replay(fn, q, caches, fresh, base)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_prefill_hd128_last_chunk_of_the_8b_encode_on_card(cuda, fmt):
    """The 8B path's last 512-token chunk (base 7680 of 8704) at G = 4."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, caches, fresh, base = _shape_operands(gen, cuda, fmt, "G4", 8704, 512, [7680, 7680])
    _checks(*PREFILL[fmt], q, caches, fresh, base)


def _pools_of(caches, table, P, ps):
    """The contiguous caches scattered into pools of P pages of ps rows
    through ``table`` (scales as [L, P, Hkv, ps])."""
    Bc, npr = table.shape
    pools = []
    for i, c in enumerate(caches):
        if len(caches) == 4 and i % 2:  # scales [L, Bc, Hkv, S]
            Hkv = c.shape[2]
            segs = (c.reshape(L, Bc, Hkv, npr, ps).permute(0, 1, 3, 2, 4)
                    .reshape(L, Bc * npr, Hkv, ps))
            pool = torch.zeros((L, P, Hkv, ps), dtype=c.dtype, device=c.device)
            pool[:, table.reshape(-1).long()] = segs
        else:
            pool = PKV.pool_scatter(torch.zeros((L, P, ps, c.shape[-1]), dtype=c.dtype,
                                                device=c.device), table, c)
        pools.append(pool)
    return tuple(pools)


PAGED = {"bf16": (PGA.flash_paged_decode_attend, PGA.flash_paged_decode_attend_plain),
         "int8": (PGA.flash_paged_decode_attend_quant,
                  PGA.flash_paged_decode_attend_quant_plain)}


@pytest.mark.parametrize("shape", ["G4", "G1"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [16, 40, 512])
def test_b12_hd128_matches_plain_and_contiguous_on_card(cuda, fmt, shape, ps):
    """B12's bf16 and int8 pools: 8 ragged slots through a permuted table
    (B scratch pages first), within bf16_limit of the plain version and bit
    for bit the contiguous kernel over the gathered pool, with and without
    the fresh rows; a graph replay gives the eager bits."""
    gen = torch.Generator(device=cuda).manual_seed(ps)
    npr = -(-4096 // ps)
    S, T = npr * ps, 4
    lens = [0, 1, 37, 513, 2049, 3001, S // 2 + 3, S - T]
    q, caches, fresh, base = _shape_operands(gen, cuda, fmt, shape, S, T, lens)
    Bc = len(lens)
    P = Bc + Bc * npr
    table = ((torch.randperm(Bc * npr, generator=gen, device=cuda) + Bc).to(torch.int32)
             .view(Bc, npr).contiguous())
    pools = _pools_of(caches, table, P, ps)
    fn, plain = PAGED[fmt]
    for kw in ({}, fresh):
        n = fn.hd128_launches
        out = fn(q, *pools, table, base, layer=LAYER, **kw)
        assert fn.hd128_launches == n + 1
        ref = plain(q, *pools, table, base, layer=LAYER, **kw)
        assert torch.isfinite(out).all() and _outside(out, ref) == 0
        assert torch.equal(out, DECODE[fmt][0](q, *caches, base, layer=LAYER, **kw))
    assert _outside(fn(q, *pools, table, base, layer=LAYER), ref) > 0
    from test_torch_kv_quant import deterministic_and_graph_replay

    deterministic_and_graph_replay(
        lambda q, *pools, layer, **kw: fn(q, *pools[:-1], table, pools[-1], layer=layer, **kw),
        q, pools, fresh, base)


BF16_SCALE = {
    "K1q": (DA.flash_decode_attend_quant, DA.flash_decode_attend_quant_plain, "int8", 4),
    "B10": (DA.flash_decode_attend_quant4, DA.flash_decode_attend_quant4_plain, "int4", 4),
    "K2q": (PA.flash_prefill_attend_quant, PA.flash_prefill_attend_quant_plain, "int8", 512),
    "B11": (PA.flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4_plain, "int4", 512),
}


def _widened(caches, fresh):
    """The bf16 scales (every second cache array, ks_new / vs_new) widened
    to float32."""
    return (tuple(c.float() if i % 2 else c for i, c in enumerate(caches)),
            {n: (a.float() if n.startswith(("ks", "vs")) else a) for n, a in fresh.items()})


@pytest.mark.parametrize("shape", ["G4", "G1"])
@pytest.mark.parametrize("kernel", list(BF16_SCALE))
def test_bf16_scales_hd128_equal_f32_on_widened_scales_on_card(cuda, kernel, shape):
    """K1q, B10, K2q and B11 on bf16 scales: each launch on its
    ``_bf16s_hd128`` instance gives the bits of the f32 instance on the
    widened scales (with and without the fresh rows), poisoned caches give
    the clean bits, and the result sits within bf16_limit of the plain
    version."""
    fn, plain, fmt, T = BF16_SCALE[kernel]
    gen = torch.Generator(device=cuda).manual_seed(len(kernel) + T)
    S = 8704 if T == 4 else 1024
    base = [0, 37, S // 3, S - T] if T == 4 else [0, 37, 300, S - T - 5]
    Hq, Hkv = SHAPES[shape]
    Bc = len(base)
    q = torch.randn((Bc, T, Hq, HD), generator=gen, device=cuda).to(torch.bfloat16)
    quant = KV.quantize_kv_tokens if fmt == "int8" else KV.quantize_kv_tokens_int4
    arrays = []
    for Lc, rows in ((L, S), (1, T)):
        for _ in range(2):
            x = torch.randn((Lc * Bc, rows, Hkv, HD), generator=gen, device=cuda).to(torch.bfloat16)
            qq, s = quant(x, scale_dtype=torch.bfloat16)
            arrays.append((qq.reshape(Lc, Bc, rows, -1), s.reshape(Lc, Bc, Hkv, rows)))
    (k, ks), (v, vs), (fk, fks), (fv, fvs) = arrays
    caches = (k, ks, v, vs)
    fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    base = torch.tensor(base, dtype=torch.int32, device=cuda)
    wide_caches, wide_fresh = _widened(caches, fresh)
    for kw, wkw in (({}, {}), (fresh, wide_fresh)):
        n, nb = fn.hd128_launches, fn.bf16_scale_launches
        out = fn(q, *caches, base, layer=LAYER, **kw)
        assert fn.hd128_launches == n + 1 and fn.bf16_scale_launches == nb + 1
        assert torch.equal(out, fn(q, *wide_caches, base, layer=LAYER, **wkw))
        assert _outside(out, plain(q, *caches, base, layer=LAYER, **kw)) == 0
    for kw, end in ((fresh, 0), ({}, T)):
        assert torch.equal(fn(q, *_poisoned(caches, base, end), base, layer=LAYER, **kw),
                           fn(q, *caches, base, layer=LAYER, **kw))


@pytest.mark.parametrize("shape", ["G4", "G1"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_b12_bf16_scales_hd128_on_card(cuda, fmt, shape):
    """B12's int8 and int4 pools on bf16 scale pools (512-row pages): the
    bits of the f32 instance on the widened scales, and of the contiguous
    kernel over the gathered pool."""
    gen = torch.Generator(device=cuda).manual_seed(5 + len(fmt))
    Hq, Hkv = SHAPES[shape]
    ps, npr, T = 512, 8, 4
    lens = [0, 300, 2049, npr * ps - T]
    Bc, S = len(lens), npr * ps
    quant = KV.quantize_kv_tokens if fmt == "int8" else KV.quantize_kv_tokens_int4
    arrays = []
    for Lc, rows in ((L, S), (1, T)):
        for _ in range(2):
            x = torch.randn((Lc * Bc, rows, Hkv, HD), generator=gen, device=cuda).to(torch.bfloat16)
            qq, s = quant(x, scale_dtype=torch.bfloat16)
            arrays.append((qq.reshape(Lc, Bc, rows, -1), s.reshape(Lc, Bc, Hkv, rows)))
    (k, ks), (v, vs), (fk, fks), (fv, fvs) = arrays
    caches = (k, ks, v, vs)
    fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    q = torch.randn((Bc, T, Hq, HD), generator=gen, device=cuda).to(torch.bfloat16)
    base = torch.tensor(lens, dtype=torch.int32, device=cuda)
    P = Bc + Bc * npr
    table = ((torch.randperm(Bc * npr, generator=gen, device=cuda) + Bc).to(torch.int32)
             .view(Bc, npr).contiguous())
    pools = _pools_of(caches, table, P, ps)
    wide_pools, wide_fresh = _widened(pools, fresh)
    fn = PGA.flash_paged_decode_attend_quant if fmt == "int8" else \
        PGA.flash_paged_decode_attend_quant4
    contiguous = DA.flash_decode_attend_quant if fmt == "int8" else \
        DA.flash_decode_attend_quant4
    for kw, wkw in (({}, {}), (fresh, wide_fresh)):
        n, nb = fn.hd128_launches, fn.bf16_scale_launches
        out = fn(q, *pools, table, base, layer=LAYER, **kw)
        assert fn.hd128_launches == n + 1 and fn.bf16_scale_launches == nb + 1
        assert torch.isfinite(out).all()
        assert torch.equal(out, fn(q, *wide_pools, table, base, layer=LAYER, **wkw))
        assert torch.equal(out, contiguous(q, *caches, base, layer=LAYER, **kw))


# -- head dims without an instance ---------------------------------------------


def test_head_dims_without_an_instance_raise_before_a_launch(cuda):
    """Head dim 96 on B10, B11, B12's int4 pool, K1q and K1: a ValueError
    naming the head dims the kernels take, and no launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    base = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    hd = 96
    x = torch.randn((2, 64, HKV, hd), generator=gen, device=cuda).to(torch.bfloat16)
    k, ks = KV.quantize_kv_tokens_int4(x)
    k, ks = k[None], ks[None]
    q = torch.randn((2, 4, HKV * G, hd), generator=gen, device=cuda).to(torch.bfloat16)
    for fn in (DA.flash_decode_attend_quant4, PA.flash_prefill_attend_quant4):
        n = fn.launches
        with pytest.raises(ValueError, match="head dims 64 and 128"):
            fn(q, k, ks, k, ks, base, layer=0)
        assert fn.launches == n
    table = torch.arange(2, dtype=torch.int32, device=cuda)[:, None]
    n = PGA.flash_paged_decode_attend_quant4.launches
    with pytest.raises(ValueError, match="head dims 64 and 128"):
        PGA.flash_paged_decode_attend_quant4(q, k.view(1, 2, 64, -1), ks, k.view(1, 2, 64, -1),
                                             ks, table, base, layer=0)
    assert PGA.flash_paged_decode_attend_quant4.launches == n
    k8, ks8 = KV.quantize_kv_tokens(x)
    dense = x.reshape(1, 2, 64, HKV * hd)
    for fn, args in ((DA.flash_decode_attend_quant, (k8[None], ks8[None], k8[None], ks8[None])),
                     (DA.flash_decode_attend, (dense, dense))):
        n = fn.launches
        with pytest.raises(ValueError, match="head dims 64 and 128"):
            fn(q, *args, base, layer=0)
        assert fn.launches == n
