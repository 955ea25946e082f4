"""The port's cache appends at the cache's end (K3/K3q drop the rows past
it, as the Pallas kernel does) and B14, the per-array appends that the
``MAGICDEC_PER_ARRAY_APPEND`` switch takes.

On the CPU, against the JAX package's Pallas kernels in interpret mode, bit
for bit: K3 and K3q (dense rows, int8 rows with their scales, packed int4
rows) with windows that run past the cache; ``append_rows_inplace`` and
``append_scale_rows_inplace`` at ragged positions, boundary blocks and past
the end; the merged and per-array appends at every position; the target
pass under the switch (1e-4, as tests/test_torch_model.py; the caches
exactly).  On the card (``gpu`` marker, skipped without one): B14 against
its plain version, bit for bit, at the shapes of ``chip_smoke.py``'s kernel
phase.

The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run where JAX is absent:
``python -m pytest tests/test_torch_append_per_array.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.kernels import append as AP

L, B, HKV = 2, 4, 2


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


def _arrays(rng, fmt, S, T, K=32):
    """(caches, rows) in the merged call's order: k, v (and k/v scales)."""
    if fmt == "dense":
        return ([rng.randn(L, B, S, K).astype(np.float32) for _ in range(2)],
                [rng.randn(L, B, T, K).astype(np.float32) for _ in range(2)])
    width = K // 2 if fmt == "int4" else K  # int4: kv heads packed in pairs
    data = [rng.randint(-128, 128, (L, B, n, width)).astype(np.int8) for n in (S, S, T, T)]
    scales = [rng.rand(L, B, HKV, n).astype(np.float32) for n in (S, S, T, T)]
    return data[:2] + scales[:2], data[2:] + scales[2:]


@pytest.mark.parametrize("T", [4, 13])
@pytest.mark.parametrize("fmt", ["dense", "int8", "int4"])
def test_merged_append_drops_rows_past_the_end_as_pallas(fmt, T):
    """K3/K3q (plain) against the Pallas merged append with windows that run
    past S: the rows before S land, the rest are dropped (C1)."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    S = 128  # the Pallas kernel merges 128-column scale blocks
    rng = np.random.RandomState(T)
    caches, rows = _arrays(rng, fmt, S, T)
    pos = np.array([S - T, S - T + 1, S - T // 2, S - 1], np.int32)
    args = caches[:2] + rows[:2] + [pos]
    if fmt != "dense":
        args += caches[2:] + rows[2:]
    ref = jkv.append_all_rows_inplace(*(jnp.asarray(a) for a in args), interpret=True)
    out = AP.append_all_rows_inplace(*_t(*args))
    assert len(out) == len(ref)
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the rows before S are the new rows; nothing else moved
    last = out[0][:, 3].numpy()
    np.testing.assert_array_equal(last[:, S - 1], rows[0][:, 3, 0])
    np.testing.assert_array_equal(last[:, :S - 1], caches[0][:, 3, :S - 1])


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("T", [1, 5, 8])
def test_append_rows_inplace_plain_matches_pallas(T, dtype):
    """B14's row append at ragged positions, at a block boundary and past
    the end (tests/test_append_kernels.py's cases, plus the drop)."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    S, K = 64, 256
    rng = np.random.RandomState(T)
    if dtype == np.int8:
        cache, rows = (rng.randint(-128, 128, (L, B, n, K)).astype(np.int8) for n in (S, T))
    else:
        cache, rows = (rng.randn(L, B, n, K).astype(np.float32) for n in (S, T))
    pos = np.array([0, 7, S - T, S - 1], np.int32)
    ref = jkv.append_rows_inplace(*(jnp.asarray(a) for a in (cache, rows, pos)),
                                  interpret=True)
    ct, rt, pt = _t(cache, rows, pos)
    out = AP.append_rows_inplace(ct, rt, pt)
    assert out is ct  # in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("T", [1, 5, 8])
def test_append_scale_rows_inplace_plain_matches_pallas(T):
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    H, S = 8, 256
    rng = np.random.RandomState(10 + T)
    scale = rng.rand(L, B, H, S).astype(np.float32)
    rows = rng.rand(L, B, H, T).astype(np.float32)
    pos = np.array([0, 100, S - T, S - 1], np.int32)
    ref = jkv.append_scale_rows_inplace(*(jnp.asarray(a) for a in (scale, rows, pos)),
                                        interpret=True)
    st, rt, pt = _t(scale, rows, pos)
    out = AP.append_scale_rows_inplace(st, rt, pt)
    assert out is st
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_merged_and_per_array_appends_agree_at_every_position():
    """One request per write position 0..S+2 (S - T < pos < S included):
    the port's K3q and its four B14 calls, and the JAX package's merged and
    per-array Pallas calls, all give the same caches."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    S, T, K = 128, 5, 32
    Bp = S + 3
    rng = np.random.RandomState(7)
    ck, cv, rk, rv = (rng.randint(-128, 128, (1, Bp, n, K)).astype(np.int8)
                      for n in (S, S, T, T))
    sk, sv, srk, srv = (rng.rand(1, Bp, HKV, n).astype(np.float32) for n in (S, S, T, T))
    pos = np.arange(Bp, dtype=np.int32)
    j = [jnp.asarray(a) for a in (ck, cv, rk, rv, pos, sk, sv, srk, srv)]
    merged_j = jkv.append_all_rows_inplace(*j, interpret=True)
    per_j = (jkv.append_rows_inplace(j[0], j[2], j[4], interpret=True),
             jkv.append_rows_inplace(j[1], j[3], j[4], interpret=True),
             jkv.append_scale_rows_inplace(j[5], j[7], j[4], interpret=True),
             jkv.append_scale_rows_inplace(j[6], j[8], j[4], interpret=True))
    merged_t = AP.append_all_rows_inplace(*_t(ck, cv, rk, rv, pos, sk, sv, srk, srv))
    ckt, cvt, rkt, rvt, post, skt, svt, srkt, srvt = _t(ck, cv, rk, rv, pos, sk, sv, srk, srv)
    per_t = (AP.append_rows_inplace(ckt, rkt, post), AP.append_rows_inplace(cvt, rvt, post),
             AP.append_scale_rows_inplace(skt, srkt, post),
             AP.append_scale_rows_inplace(svt, srvt, post))
    for a, b, c, d in zip(merged_j, per_j, merged_t, per_t):
        for got in (b, c.numpy(), d.numpy()):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(a))


def test_per_array_preconditions_raise():
    """The Pallas per-array kernels' blocks: S % 8 for rows, S % 128 for
    scale columns, and write_pos >= 0."""
    pos = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        AP.append_rows_inplace(torch.zeros(L, B, 60, 16), torch.zeros(L, B, 1, 16), pos)
    with pytest.raises(ValueError, match="multiple of 128"):
        AP.append_scale_rows_inplace(torch.zeros(L, B, 2, 64), torch.zeros(L, B, 2, 1), pos)
    with pytest.raises(ValueError, match=">= 0"):
        AP.append_rows_inplace(torch.zeros(L, B, 64, 16), torch.zeros(L, B, 1, 16), pos - 1)


def test_forward_target_per_array_append_matches_jax(monkeypatch):
    """Under MAGICDEC_PER_ARRAY_APPEND, both packages' target passes over an
    int8 cache (a prefill chunk, a verify window, a decode step) append
    through their per-array calls: the JAX pass with its flash backend
    (Pallas kernels in interpret mode; the switch is read at trace time, so
    it is set first), the port's through B14.  Logits to 1e-4, tokens
    exactly, the caches as tests/test_torch_kv_quant.py holds an int8 pass's:
    scales to 1e-5 relative, int8 rows within one step in at most 0.1% of
    the entries (the two passes' k and v differ in the last bits)."""
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy, params_from_jax
    from magicdec_tpu_torch.models import llama as TM
    from test_torch_model import _jax_tree, random_params

    monkeypatch.setenv("MAGICDEC_PER_ARRAY_APPEND", "1")
    kw = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=256, intermediate_size=256)
    jc, tc = jcfg.tiny_config(**kw), tcfg.tiny_config(**kw)
    npp = random_params(jc)
    jp = JM.fuse_exec_params(_jax_tree(npp), jc)
    tp = TM.fuse_exec_params(params_from_jax(npp), tc)
    calls = []
    for name in ("append_rows_inplace", "append_scale_rows_inplace"):
        monkeypatch.setattr(TM, name, lambda *a, _f=getattr(TM, name), _n=name:
                            calls.append(_n) or _f(*a))
    monkeypatch.setattr(TM, "append_all_rows_inplace",
                        lambda *a: pytest.fail("the merged append ran under the switch"))
    Bm, S, K = 2, 128, jc.n_kv_head * jc.head_dim
    caches = {"k": np.zeros((jc.n_layer, Bm, S, K), np.int8),
              "ks": np.zeros((jc.n_layer, Bm, jc.n_kv_head, S), np.float32)}
    caches["v"], caches["vs"] = caches["k"].copy(), caches["ks"].copy()
    rng = np.random.RandomState(3)
    for T, base in ((32, [0, 0]), (4, [32, 20]), (1, [36, 24])):
        tokens = rng.randint(0, jc.vocab_size, size=(Bm, T)).astype(np.int32)
        base = np.array(base, np.int32)
        yj, jcache = JM.forward_target(jp, jc, jnp.asarray(tokens), jnp.asarray(base),
                                       {n: jnp.asarray(a) for n, a in caches.items()},
                                       head="logits", backend="flash")
        yt, tcache = TM.forward_target(tp, tc, torch.from_numpy(tokens),
                                       torch.from_numpy(base), caches_from_jax(caches),
                                       head="logits")
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(yt.argmax(-1).numpy(), np.asarray(yj).argmax(-1))
        got = caches_to_numpy(tcache)
        caches = {n: np.asarray(a) for n, a in jcache.items()}
        for name in ("ks", "vs"):
            np.testing.assert_allclose(got[name], caches[name], rtol=1e-5, atol=0,
                                       err_msg=name)
        for name in ("k", "v"):
            diff = np.abs(got[name].astype(np.int32) - caches[name].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    # each pass: one call per array
    assert sorted(calls) == ["append_rows_inplace"] * 6 + ["append_scale_rows_inplace"] * 6


# -- on the card: B14 against its plain version, bit for bit ------------------


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 4, 512])
@pytest.mark.parametrize("cache", ["draft bf16 640 rows", "target int8 8704 rows"])
def test_per_array_append_kernels_match_plain_on_card(cuda, cache, T):
    gen = torch.Generator(device=cuda).manual_seed(T)
    Lc, Bc, H, K = 2, 4, 8, 512
    S = 640 if cache.startswith("draft") else 8704
    if cache.startswith("draft"):
        data = torch.randn((Lc, Bc, S, K), generator=gen, device=cuda).to(torch.bfloat16)
        rows = torch.randn((Lc, Bc, T, K), generator=gen, device=cuda).to(torch.bfloat16)
    else:
        data = torch.randint(-128, 128, (Lc, Bc, S, K), generator=gen, device=cuda,
                             dtype=torch.int8)
        rows = torch.randint(-128, 128, (Lc, Bc, T, K), generator=gen, device=cuda,
                             dtype=torch.int8)
    scale = torch.rand((Lc, Bc, H, S), generator=gen, device=cuda)
    srows = torch.rand((Lc, Bc, H, T), generator=gen, device=cuda)
    # ragged, the last row, a window running past the end, one past it all
    pos = torch.tensor([5, S - T, S - (T + 1) // 2, S + 3], dtype=torch.int32, device=cuda)
    got = AP.append_rows_inplace(data.clone(), rows, pos)
    want = AP.append_rows_inplace_plain(data, rows, pos)
    assert torch.equal(got, want)
    got = AP.append_scale_rows_inplace(scale.clone(), srows, pos)
    want = AP.append_scale_rows_inplace_plain(scale, srows, pos)
    assert torch.equal(got, want)
