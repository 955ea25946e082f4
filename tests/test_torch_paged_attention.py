"""The port's page pools (B12 paged decode, B13 paged append, the
``ops/paged_kv.py`` helpers, the host allocator and scheduler) against the
JAX package, and the CUDA kernels against their plain versions on the card.

On the CPU: the plain versions against ``flash_paged_decode_attend*`` and
``append_paged_rows_inplace`` in Pallas interpret mode at
``tests/test_paged_attention.py``'s shapes (page size 128), and at page
size 16 against the JAX jnp oracle (``pool_gather`` + ``attend`` /
``attend_quant``): attention within atol = rtol = 2e-5 in float32 (the same
function summed in another order), appends and helpers bit for bit.  The
pools hold garbage (1e3) outside every request's visible rows: no version
may read it.

On the card (``gpu`` marker, skipped without one): each kernel within
``kernels.bf16_limit`` of its plain version and each append bit for bit, at
page sizes 16, 64 and 512 (16: a 32-row tile spans pages), and each paged
decode bit-equal to its contiguous kernel over the gathered cache (the
split plan is the contiguous one at S = npr*ps).  Run there with
``python -m pytest tests/test_torch_paged_attention.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import native as tnative
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import paged_attention as PGA
from magicdec_tpu_torch.ops import kv_cache as KV
from magicdec_tpu_torch.ops import paged_kv as PKV

TOL = dict(atol=2e-5, rtol=2e-5)
HD = 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _table(rng, B, npr, P):
    """Distinct random pool pages per (request, logical page)."""
    return rng.permutation(P)[: B * npr].reshape(B, npr).astype(np.int32)


def _pools(rng, L, P, ps, Hkv, table, base, T, bits):
    """(k, v) pools [L, P, ps, Kc] as numpy, with garbage past each request's
    rows base + T; quantized (bits 8 or 4): (kq, ks, vq, vs) with scale pools
    [L, P, Hkv, ps] and the garbage in the scales."""
    B, npr = table.shape
    S = npr * ps
    pools = []
    for sign in (1, -1):
        x = rng.randn(L, B, S, Hkv, HD).astype(np.float32)
        if not bits:
            for b, n in enumerate(base):
                x[:, b, n + T:] = sign * 1e3
            c = torch.from_numpy(x.reshape(L, B, S, Hkv * HD))
            pools.append(PKV.pool_scatter(torch.zeros(L, P, ps, Hkv * HD), torch.from_numpy(table),
                                          c).numpy())
            continue
        qz = KV.quantize_kv_tokens if bits == 8 else KV.quantize_kv_tokens_int4
        qs = [qz(torch.from_numpy(x[l])) for l in range(L)]
        q = torch.stack([a for a, _ in qs])
        s = torch.stack([b for _, b in qs])  # [L, B, Hkv, S]
        for b, n in enumerate(base):
            s[:, b, :, n + T:] = 1e3
        tbl = torch.from_numpy(table)
        qp = PKV.pool_scatter(torch.zeros((L, P, ps, q.shape[-1]), dtype=torch.int8), tbl, q)
        segs = s.reshape(L, B, Hkv, npr, ps).permute(0, 1, 3, 2, 4).reshape(L, B * npr, Hkv, ps)
        sp = torch.zeros(L, P, Hkv, ps)
        sp[:, tbl.reshape(-1).long()] = segs
        pools += [qp.numpy(), sp.numpy()]
    return pools


# -- B12 plain versions vs the Pallas paged kernels (interpret) ---------------


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_paged_decode_plain_matches_pallas(bits, fresh):
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas import paged_attention as JPA

    rng = np.random.RandomState(bits + fresh)
    L, B, Hkv, G, ps, npr, P, T = 2, 3, 2, 2, 128, 3, 12, 4
    table = _table(rng, B, npr, P)
    base = np.array([17, 200, npr * ps - T], np.int32)
    pools = _pools(rng, L, P, ps, Hkv, table, base, T, bits)
    q = rng.randn(B, T, Hkv * G, HD).astype(np.float32)
    kw, jkw = {}, {}
    if fresh:
        x = rng.randn(2, B, T, Hkv, HD).astype(np.float32)
        if bits:
            qz = KV.quantize_kv_tokens if bits == 8 else KV.quantize_kv_tokens_int4
            (kn, ksn), (vn, vsn) = qz(torch.from_numpy(x[0])), qz(torch.from_numpy(x[1]))
            kw = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
        else:
            kw = dict(k_new=torch.from_numpy(x[0].reshape(B, T, -1)),
                      v_new=torch.from_numpy(x[1].reshape(B, T, -1)))
        jkw = {n: jnp.asarray(t.numpy()) for n, t in kw.items()}
    jfn = {0: JPA.flash_paged_decode_attend, 8: JPA.flash_paged_decode_attend_quant,
           4: JPA.flash_paged_decode_attend_quant4}[bits]
    tfn = {0: PGA.flash_paged_decode_attend, 8: PGA.flash_paged_decode_attend_quant,
           4: PGA.flash_paged_decode_attend_quant4}[bits]
    jp = [jnp.asarray(p) for p in pools]
    tp = _t(*pools)
    for layer in range(L):
        ref = jfn(jnp.asarray(q), *jp, jnp.asarray(table), jnp.asarray(base), layer=layer,
                  interpret=True, **jkw)
        out = tfn(torch.from_numpy(q), *tp, torch.from_numpy(table), torch.from_numpy(base),
                  layer=layer, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_paged_decode_small_pages_match_jnp_oracle(bits):
    """Page size 16: the plain version against the JAX package's oracle,
    the gathered pool through ``attend`` / ``attend_quant``."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import paged_kv as JPKV
    from magicdec_tpu.ops.attention import attend, attend_quant

    rng = np.random.RandomState(10 + bits)
    L, B, Hkv, G, ps, npr, P, T = 2, 3, 2, 2, 16, 6, 24, 4
    table = _table(rng, B, npr, P)
    base = np.array([0, 37, npr * ps - T], np.int32)
    pools = _pools(rng, L, P, ps, Hkv, table, base, T, bits)
    q = rng.randn(B, T, Hkv * G, HD).astype(np.float32)
    jt, jb, jq = jnp.asarray(table), jnp.asarray(base), jnp.asarray(q)
    for layer in range(L):
        if bits:
            kq, ks, vq, vs = (jnp.asarray(p) for p in pools)
            ref = attend_quant(jq, JPKV.pool_gather(kq, jt)[layer],
                               JPKV.scale_pool_gather(ks, jt)[layer],
                               JPKV.pool_gather(vq, jt)[layer],
                               JPKV.scale_pool_gather(vs, jt)[layer], jb, causal=True)
            fn = PGA.flash_paged_decode_attend_quant if bits == 8 else \
                PGA.flash_paged_decode_attend_quant4
        else:
            k, v = (JPKV.pool_gather(jnp.asarray(p), jt)[layer] for p in pools)
            ref = attend(jq, k, v, jb, causal=True)
            fn = PGA.flash_paged_decode_attend
        out = fn(torch.from_numpy(q), *_t(*pools), torch.from_numpy(table),
                 torch.from_numpy(base), layer=layer)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# -- B13 plain version vs the Pallas paged append (interpret), bit for bit ----


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_paged_append_plain_matches_pallas(fmt):
    """write_pos: an interior row, S - T (the last rows), and S - 2 (two rows
    land, two fall past S and are dropped); pages the table does not name
    stay untouched."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas import paged_attention as JPA

    rng = np.random.RandomState({"bf16": 0, "int8": 1, "int4": 2}[fmt])
    L, B, Hkv, ps, npr, P, T = 3, 3, 2, 128, 2, 9, 4
    S = npr * ps
    table = _table(rng, B, npr, P)
    pos = np.array([123, S - T, S - 2], np.int32)
    Kc = Hkv * HD // (2 if fmt == "int4" else 1)
    if fmt == "bf16":
        import ml_dtypes

        def data(*shape):
            return rng.randn(*shape).astype(ml_dtypes.bfloat16)
        arrays = [data(L, P, ps, Kc), data(L, P, ps, Kc), data(L, B, T, Kc), data(L, B, T, Kc)]
    else:
        def data(*shape):
            return rng.randint(-128, 128, shape).astype(np.int8)
        arrays = [data(L, P, ps, Kc), data(L, P, ps, Kc), data(L, B, T, Kc), data(L, B, T, Kc),
                  rng.rand(L, P, Hkv, ps).astype(np.float32),
                  rng.rand(L, P, Hkv, ps).astype(np.float32),
                  rng.rand(L, B, Hkv, T).astype(np.float32),
                  rng.rand(L, B, Hkv, T).astype(np.float32)]
    pk, pv, rk, rv = arrays[:4]
    scales = arrays[4:]
    jargs = [jnp.asarray(a) for a in (pk, pv, rk, rv)] + [jnp.asarray(pos), jnp.asarray(table)]
    jkw = {}
    if scales:
        jkw = dict(zip(("scale_k", "scale_v", "srows_k", "srows_v"),
                       (jnp.asarray(a) for a in scales)))
    ref = JPA.append_paged_rows_inplace(*jargs, interpret=True, **jkw)

    def torch_of(a):
        return (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy()))
    tp = [torch_of(a) for a in (pk, pv)]
    ts = [torch_of(a) for a in scales]
    out = PGA.append_paged_rows_inplace(
        *tp, torch_of(rk), torch_of(rv), torch.from_numpy(pos), torch.from_numpy(table),
        *ts)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.float().numpy(), np.asarray(r, np.float32))
    used = set(table.ravel().tolist())
    for p in set(range(P)) - used:
        np.testing.assert_array_equal(out[0][:, p].float().numpy(), pk[:, p].astype(np.float32))
    # the rows past S were dropped, not written anywhere: request 2's last
    # page holds its two rows at ps-2, ps-1 and keeps rows 0, 1
    last = table[2, -1]
    np.testing.assert_array_equal(out[0][:, last, :2].float().numpy(),
                                  pk[:, last, :2].astype(np.float32))


# -- ops/paged_kv.py helpers vs the JAX package --------------------------------


def test_paged_kv_helpers_match_jax():
    import jax.numpy as jnp
    from magicdec_tpu.ops import paged_kv as JPKV

    rng = np.random.RandomState(7)
    L, B, H, ps, npr, P, K, T = 2, 3, 2, 16, 4, 14, 32, 5
    table = _table(rng, B, npr, P)
    pool = rng.randn(L, P, ps, K).astype(np.float32)
    spool = rng.rand(L, P, H, ps).astype(np.float32)
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    np.testing.assert_array_equal(PKV.pool_gather(torch.from_numpy(pool), tt).numpy(),
                                  np.asarray(JPKV.pool_gather(jnp.asarray(pool), jt)))
    np.testing.assert_array_equal(PKV.scale_pool_gather(torch.from_numpy(spool), tt).numpy(),
                                  np.asarray(JPKV.scale_pool_gather(jnp.asarray(spool), jt)))
    contig = rng.randn(L, B, npr * ps, K).astype(np.float32)
    np.testing.assert_array_equal(
        PKV.pool_scatter(torch.from_numpy(pool.copy()), tt, torch.from_numpy(contig)).numpy(),
        np.asarray(JPKV.pool_scatter(jnp.asarray(pool), jt, jnp.asarray(contig))))
    # the scatter appends; the last request's rows past npr * ps are dropped
    # (the JAX oracle's out-of-range page index drops them in its scatter)
    pos = np.array([0, 17, npr * ps - 2], np.int32)
    rows = rng.randn(L, B, T, K).astype(np.float32)
    srows = rng.rand(L, B, H, T).astype(np.float32)
    got = PKV.append_paged_rows_all_layers(torch.from_numpy(pool.copy()), torch.from_numpy(rows),
                                           torch.from_numpy(pos), tt)
    want = JPKV.append_paged_rows_all_layers(jnp.asarray(pool), jnp.asarray(rows),
                                             jnp.asarray(pos), jt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = PKV.append_paged_scale_rows_all_layers(torch.from_numpy(spool.copy()),
                                                 torch.from_numpy(srows),
                                                 torch.from_numpy(pos), tt)
    want = JPKV.append_paged_scale_rows_all_layers(jnp.asarray(spool), jnp.asarray(srows),
                                                   jnp.asarray(pos), jt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert PKV.alloc_pool(L, P, ps, K).shape == JPKV.alloc_pool(L, P, ps, K).shape
    assert PKV.alloc_scale_pool(L, P, H, ps).shape == JPKV.alloc_scale_pool(L, P, H, ps).shape


@pytest.mark.parametrize("ps", [16, 512])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_paged_quant_launch_once_against_a_fake_library(packed, ps, monkeypatch):
    """B12's int8 and int4 host side: one C call a wrapper call with the C
    signature kept (q, the pools, the scale pools, table, the four fresh
    operands, base_lens, out, part_o, part_ml, layer, B, P, ps, npr, T, Hq,
    Hkv, hd, nsplit, chunk, stream) and the contiguous kernel's plan at S =
    npr * ps (quant_split_plan), so a paged launch reads the positions of
    the contiguous one; one launch counted."""
    from magicdec_tpu_torch.kernels import build

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(PGA, "on_cpu", lambda *a: False)
    fn = PGA.flash_paged_decode_attend_quant4 if packed else PGA.flash_paged_decode_attend_quant
    entry = "md_paged_decode_attend_quant4" if packed else "md_paged_decode_attend_quant"
    L, B, Hkv, G, T, npr = 2, 3, 8, 4, 4, 8192 // ps
    P = B * npr + 2
    width = Hkv * HD // (2 if packed else 1)
    q = torch.zeros(B, T, Hkv * G, HD, dtype=torch.bfloat16)
    k, v = (torch.zeros(L, P, ps, width, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.zeros(L, P, Hkv, ps) for _ in range(2))
    table = torch.arange(B * npr, dtype=torch.int32).reshape(B, npr)
    fresh = dict(k_new=torch.zeros(B, T, width, dtype=torch.int8),
                 v_new=torch.zeros(B, T, width, dtype=torch.int8),
                 ks_new=torch.zeros(B, Hkv, T), vs_new=torch.zeros(B, Hkv, T))
    before = fn.launches
    out = fn(q, k, ks, v, vs, table, torch.tensor([0, 5, 8192 - T]), layer=1, **fresh)
    assert out.shape == q.shape and fn.launches == before + 1
    ((name, args),) = calls
    assert name == entry and len(args) == len(build.SIGNATURES[entry]) == 26
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                        vs.data_ptr(), table.data_ptr())
    nsplit, chunk = DA.quant_split_plan(B, Hkv, npr * ps)
    assert nsplit > 1 and args[12] is not None and args[13] is not None
    assert args[14:] == (1, B, P, ps, npr, T, Hkv * G, Hkv, HD, nsplit, chunk, 7)


def test_attend_cache_routes_pools_to_the_paged_kernels(monkeypatch):
    """A page table in the caches routes decode windows to B12 (the variant
    by the pool's format) and longer windows to the gathered contiguous
    route."""
    from magicdec_tpu_torch.ops import attention as A

    calls = []
    for name in ("flash_paged_decode_attend", "flash_paged_decode_attend_quant",
                 "flash_paged_decode_attend_quant4"):
        monkeypatch.setattr(PGA, name, lambda *a, _n=name, **k: calls.append(_n))
    rng = np.random.RandomState(8)
    L, B, Hkv, ps, npr, P = 1, 2, 2, 16, 2, 6
    table = torch.from_numpy(_table(rng, B, npr, P))
    q = torch.zeros(B, 4, 4, HD)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    dense = {"k": torch.zeros(L, P, ps, Hkv * HD), "v": torch.zeros(L, P, ps, Hkv * HD),
             "table": table}
    scales = {"ks": torch.ones(L, P, Hkv, ps), "vs": torch.ones(L, P, Hkv, ps)}
    i8 = {"k": torch.zeros(L, P, ps, Hkv * HD, dtype=torch.int8),
          "v": torch.zeros(L, P, ps, Hkv * HD, dtype=torch.int8), "table": table, **scales}
    i4 = {"k": torch.zeros(L, P, ps, Hkv * HD // 2, dtype=torch.int8),
          "v": torch.zeros(L, P, ps, Hkv * HD // 2, dtype=torch.int8), "table": table, **scales}
    for caches in (dense, i8, i4):
        A.attend_cache(q, caches, lens, layer=0)
    assert calls == ["flash_paged_decode_attend", "flash_paged_decode_attend_quant",
                     "flash_paged_decode_attend_quant4"]
    # a 20-token window gathers the layer: the plain contiguous prefill
    out = A.attend_cache(torch.zeros(B, 20, 4, HD), dense, torch.zeros(B, dtype=torch.int32),
                         layer=0)
    assert out.shape == (B, 20, 4, HD) and len(calls) == 3


# -- the host allocator and scheduler vs magicdec_tpu.native -------------------


def test_native_matches_jax_package():
    """A seeded script of admissions, releases, submissions, assignments
    and completions: tables, free pages, assignment order and stats equal."""
    from magicdec_tpu import native as jnative

    rng = np.random.RandomState(5)
    pages, ps, slots, cap = 40, 16, 6, 8
    ta, ja = tnative.PageAllocator(pages, ps, slots, cap), jnative.PageAllocator(pages, ps, slots,
                                                                                cap)
    ts, js = tnative.Scheduler(slots), jnative.Scheduler(slots)
    held = []
    for step in range(60):
        now = step * 10
        if rng.rand() < 0.6:
            n = int(rng.randint(1, cap * ps + 20))
            a, b = ta.admit(n), ja.admit(n)
            assert a == b
            if a >= 0:
                held.append(a)
        elif held:
            s = held.pop(rng.randint(len(held)))
            ta.release(s)
            ja.release(s)
        assert ta.free_pages() == ja.free_pages()
        for x, y in zip(ta.tables(), ja.tables()):
            np.testing.assert_array_equal(x, y)
        for rid in range(step * 3, step * 3 + int(rng.randint(0, 3))):
            ts.submit(rid, now)
            js.submit(rid, now)
        m = int(rng.randint(1, 4))
        assert ts.assign(now + 1, max_n=m) == js.assign(now + 1, max_n=m)
        for slot in range(slots):
            if rng.rand() < 0.3:
                assert ts.complete(slot, now + 5) == js.complete(slot, now + 5)
        assert ts.counts() == js.counts()
        np.testing.assert_allclose(ts.stats(), js.stats())


# -- the CUDA kernels on the card ----------------------------------------------


def _rand(gen, *shape, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _card_pools(gen, L, P, ps, Hkv, bits, device):
    """Pools on the card: bf16 (k, v), or quantized (kq, ks, vq, vs) from
    bf16 values, with scale pools [L, P, Hkv, ps]."""
    K = Hkv * HD
    if not bits:
        return [_rand(gen, L, P, ps, K, device=device) for _ in range(2)]
    qz = KV.quantize_kv_tokens if bits == 8 else KV.quantize_kv_tokens_int4
    out = []
    for _ in range(2):
        x = _rand(gen, L * P, ps, Hkv, HD, device=device)
        q, s = qz(x)
        out += [q.reshape(L, P, ps, -1).contiguous(), s.reshape(L, P, Hkv, ps).contiguous()]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 40, 64, 512])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_paged_decode_kernel_on_card(cuda, bits, ps):
    """Against the plain version within bf16_limit (without the fresh rows
    it must fail), and bit-equal to the contiguous kernel over the gathered
    pool, with and without fresh rows; pages of a multiple of 16 rows
    (whole tiles, a bf16 tile by TMA from its page) and of 40 (tiles across
    pages, each 16-byte chunk through its page)."""
    gen = torch.Generator(device=cuda).manual_seed(bits + ps)
    L, B, Hkv, G, T, layer = 2, 3, 8, 4, 4, 1
    npr = 1024 // ps
    P = B * npr + 5
    table = torch.randperm(P, generator=gen, device=cuda)[: B * npr].reshape(B, npr)
    table = table.to(torch.int32).contiguous()
    pools = _card_pools(gen, L, P, ps, Hkv, bits, cuda)
    q = _rand(gen, B, T, Hkv * G, HD, device=cuda)
    base = torch.tensor([0, 300, npr * ps - T], dtype=torch.int32, device=cuda)
    x = _rand(gen, 2, B, T, Hkv, HD, device=cuda)
    if bits:
        qz = KV.quantize_kv_tokens if bits == 8 else KV.quantize_kv_tokens_int4
        (kn, ksn), (vn, vsn) = qz(x[0]), qz(x[1])
        kw = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
        fn, contig = {8: (PGA.flash_paged_decode_attend_quant, DA.flash_decode_attend_quant),
                      4: (PGA.flash_paged_decode_attend_quant4,
                          DA.flash_decode_attend_quant4)}[bits]
        plain = PGA.flash_paged_decode_attend_quant_plain
        gathered = [PKV.pool_gather(p, table) if i % 2 == 0 else PKV.scale_pool_gather(p, table)
                    for i, p in enumerate(pools)]
    else:
        kw = dict(k_new=x[0].reshape(B, T, -1), v_new=x[1].reshape(B, T, -1))
        fn, contig = PGA.flash_paged_decode_attend, DA.flash_decode_attend
        plain = PGA.flash_paged_decode_attend_plain
        gathered = [PKV.pool_gather(p, table) for p in pools]
    for fresh in ({}, kw):
        out = fn(q, *pools, table, base, layer=layer, **fresh)
        ref = plain(q, *pools, table, base, layer=layer, **fresh)
        assert torch.isfinite(out).all() and _outside(out, ref) == 0
        assert torch.equal(out, contig(q, *gathered, base, layer=layer, **fresh))
    assert _outside(fn(q, *pools, table, base, layer=layer), ref) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 64, 512])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_paged_append_kernel_on_card(cuda, fmt, ps):
    gen = torch.Generator(device=cuda).manual_seed(ps)
    L, B, Hkv, T = 3, 4, 8, 4
    npr = 1024 // ps
    S, P = npr * ps, B * npr + 3
    table = torch.randperm(P, generator=gen, device=cuda)[: B * npr].reshape(B, npr)
    table = table.to(torch.int32).contiguous()
    pos = torch.tensor([0, ps - 2, S - T, S - 1], dtype=torch.int32, device=cuda)
    Kc = Hkv * HD // (2 if fmt == "int4" else 1)
    if fmt == "bf16":
        pools = [_rand(gen, L, P, ps, Kc, device=cuda) for _ in range(2)]
        rows = [_rand(gen, L, B, T, Kc, device=cuda) for _ in range(2)]
        scales, srows = [], []
    else:
        def i8(*shape):
            return torch.randint(-128, 128, shape, generator=gen, device=cuda,
                                 dtype=torch.int8)
        pools = [i8(L, P, ps, Kc) for _ in range(2)]
        rows = [i8(L, B, T, Kc) for _ in range(2)]
        scales = [torch.rand(L, P, Hkv, ps, generator=gen, device=cuda) for _ in range(2)]
        srows = [torch.rand(L, B, Hkv, T, generator=gen, device=cuda) for _ in range(2)]
    mine = [t.clone() for t in pools + scales]
    out = PGA.append_paged_rows_inplace(*mine[:2], *rows, pos, table, *mine[2:], *srows)
    ref = PGA.append_paged_rows_inplace_plain(*pools, *rows, pos, table, *scales, *srows)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
