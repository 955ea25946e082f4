"""The head-dim-128 instances of B10, B11 and B12's int4 pool on the card
(``gpu`` marker; skipped without one) against their plain versions, at the
8B target's widths (32 query heads, 8 kv heads of 128 dims, an int4 cache
packed in head pairs with f32 scales), within ``kernels.bf16_limit``:

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
- a head dim without an instance raises before any launch, naming the
  ROADMAP item.

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
    """Copies with every row past base + end set to -128, its scales inf and NaN."""
    k, ks, v, vs = (c.clone() for c in caches)
    for b, n in enumerate(base.tolist()):
        k[:, b, n + end:] = -128
        v[:, b, n + end:] = -128
        ks[:, b, :, n + end:] = float("inf")
        vs[:, b, :, n + end:] = float("nan")
    return k, ks, v, vs


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


# -- head dims without an instance ---------------------------------------------


def test_head_dims_without_an_instance_raise_before_a_launch(cuda):
    """Head dim 96 on B10, B11 and B12's int4 pool, and 128 on K1q, on the
    bf16-scale B10 and on K1: a ValueError naming the ROADMAP item, and no
    launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    base = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    for hd in (96,):
        x = torch.randn((2, 64, HKV, hd), generator=gen, device=cuda).to(torch.bfloat16)
        k, ks = KV.quantize_kv_tokens_int4(x)
        k, ks = k[None], ks[None]
        q = torch.randn((2, 4, HKV * G, hd), generator=gen, device=cuda).to(torch.bfloat16)
        for fn in (DA.flash_decode_attend_quant4, PA.flash_prefill_attend_quant4):
            n = fn.launches
            with pytest.raises(ValueError, match=K.HD128_ITEM):
                fn(q, k, ks, k, ks, base, layer=0)
            assert fn.launches == n
        table = torch.arange(2, dtype=torch.int32, device=cuda)[:, None]
        n = PGA.flash_paged_decode_attend_quant4.launches
        with pytest.raises(ValueError, match=K.HD128_ITEM):
            PGA.flash_paged_decode_attend_quant4(q, k.view(1, 2, 64, -1), ks, k.view(1, 2, 64, -1),
                                                 ks, table, base, layer=0)
        assert PGA.flash_paged_decode_attend_quant4.launches == n
    q = torch.randn((2, 4, HKV * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    x = torch.randn((2, 64, HKV, HD), generator=gen, device=cuda).to(torch.bfloat16)
    k8, ks8 = KV.quantize_kv_tokens(x)
    k4, ks4 = KV.quantize_kv_tokens_int4(x)
    dense = x.reshape(1, 2, 64, HKV * HD)
    for fn, args in ((DA.flash_decode_attend_quant, (k8[None], ks8[None], k8[None], ks8[None])),
                     (DA.flash_decode_attend_quant4, (k4[None], ks4[None].to(torch.bfloat16),
                                                      k4[None], ks4[None].to(torch.bfloat16))),
                     (DA.flash_decode_attend, (dense, dense))):
        n = fn.launches
        with pytest.raises(ValueError, match=K.HD128_ITEM):
            fn(q, *args, base, layer=0)
        assert fn.launches == n
