"""Plain versions of the port's Hopper kernels vs the JAX package's Pallas
kernels in interpret mode (CPU), and the CUDA kernels vs their plain
versions on the card (``gpu`` marker; skipped without one).

Attention tolerance on the CPU: atol = rtol = 2e-5 in float32 (the same
function, summed in another order).  On the card, in bfloat16: within
``kernels.bf16_limit`` (2**-5 times the RMS of each output row plus 2**-6
|ref|), because the kernels round the softmax weights and the outputs to
bf16 and sum in another order; the kernel run without the window's fresh
rows must fail that bound.  The append is compared bit for bit.

The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run where JAX is absent:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.kernels import append as AP
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import prefill_attention as PA

TOL = dict(atol=2e-5, rtol=2e-5)
L, B, HKV, HD = 2, 4, 2, 64
LAYER = 1


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


def _caches(rng, S, base, T, garbage=1e3):
    """Stacked [L, B, S, K] caches holding garbage past each request's
    visible rows (base + T): the kernels must never read it."""
    k = rng.randn(L, B, S, HKV * HD).astype(np.float32)
    v = rng.randn(L, B, S, HKV * HD).astype(np.float32)
    for b, n in enumerate(base):
        k[:, b, n + T:] = garbage
        v[:, b, n + T:] = -garbage
    return k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("branch", ["blocked", "whole_row"])
def test_decode_plain_matches_pallas(branch, T, fresh):
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas.decode_attention import flash_decode_attend as j_decode

    S, G = 256, 2
    block_s = 128 if branch == "blocked" else S  # whole-row: block_s == S, B even
    rng = np.random.RandomState(T)
    base = np.array([17, 100, 200, S - T], np.int32)
    k, v = _caches(rng, S, base, 0 if fresh else T)
    q = rng.randn(B, T, HKV * G, HD).astype(np.float32)
    kn = rng.randn(B, T, HKV * HD).astype(np.float32)
    vn = rng.randn(B, T, HKV * HD).astype(np.float32)
    kw_j = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if fresh else {}
    ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base),
                   layer=LAYER, block_s=block_s, interpret=True, **kw_j)
    qt, kt, vt, bt, knt, vnt = _t(q, k, v, base, kn, vn)
    kw_t = dict(k_new=knt, v_new=vnt) if fresh else {}
    out = DA.flash_decode_attend(qt, kt, vt, bt, layer=LAYER, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_prefill_plain_matches_pallas(fresh):
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas.prefill_attention import flash_prefill_attend as j_prefill

    S, G, C = 256, 2, 64  # (G*C) % 128 == 0: the Pallas kernel's row blocks
    rng = np.random.RandomState(5)
    base = np.array([0, 64, 100, 192], np.int32)
    k, v = _caches(rng, S, base, 0 if fresh else C)
    q = rng.randn(B, C, HKV * G, HD).astype(np.float32)
    kn = rng.randn(B, C, HKV * HD).astype(np.float32)
    vn = rng.randn(B, C, HKV * HD).astype(np.float32)
    kw_j = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if fresh else {}
    ref = j_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base),
                    layer=LAYER, block_s=128, block_r=128, interpret=True, **kw_j)
    qt, kt, vt, bt, knt, vnt = _t(q, k, v, base, kn, vn)
    kw_t = dict(k_new=knt, v_new=vnt) if fresh else {}
    out = PA.flash_prefill_attend(qt, kt, vt, bt, layer=LAYER, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


class _FakeLibrary:
    """Records the arguments of K2's entry point (returns success)."""

    def __init__(self):
        self.calls = []

    def md_prefill_attend(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_prefill_launch_once_against_a_fake_library(fresh, monkeypatch):
    """K2's host side: one C call a wrapper call with the C signature kept
    (q, k, v, k_new, v_new, base_lens, out, layer, B, S, T, Hq, Hkv, hd,
    stream; the fresh rows null without them), the base lengths as int32,
    only the output allocated besides them; a failed launch raises."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(PA, "on_cpu", lambda *a: False)
    Bc, C, Hkv, G, S = 2, 64, 2, 4, 256
    bf = torch.bfloat16
    q = torch.zeros(Bc, C, Hkv * G, HD, dtype=bf)
    k, v = (torch.zeros(L, Bc, S, Hkv * HD, dtype=bf) for _ in range(2))
    kn, vn = (torch.zeros(Bc, C, Hkv * HD, dtype=bf) for _ in range(2))
    base = torch.tensor([0, 100], dtype=torch.int64)
    kw = dict(k_new=kn, v_new=vn) if fresh else {}
    out = PA.flash_prefill_attend(q, k, v, base, layer=LAYER, **kw)
    assert out.shape == q.shape and out.dtype == bf
    (args,) = lib.calls
    assert len(args) == 15 == len(build.SIGNATURES["md_prefill_attend"])
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert (args[3] is None) == (not fresh) and (args[4] is None) == (not fresh)
    assert args[6] == out.data_ptr()
    assert args[7:] == (LAYER, Bc, S, C, Hkv * G, Hkv, HD, 7)
    monkeypatch.setattr(lib, "md_prefill_attend", lambda *a: 1)
    with pytest.raises(RuntimeError, match="md_prefill_attend"):
        PA.flash_prefill_attend(q, k, v, base, layer=LAYER, **kw)


# -- K1's and B12-bf16's host side: the split plan and one C call a launch ----


@pytest.mark.parametrize("Hkv", [8, 2])
@pytest.mark.parametrize("S", [16, 100, 640, 8192, 8704])
@pytest.mark.parametrize("Bc", [1, 2, 16, 32])
def test_split_plan_covers_each_position_once(Bc, S, Hkv):
    """K1's plan (a block a kv head): whole 64-position rounds a split, the
    splits cover [0, S) exactly once (none empty), at most PLAN_BLOCKS
    blocks unless a request's kv heads alone exceed it, and the same plan,
    from (B, Hkv, S) alone, whatever the window length."""
    nsplit, chunk = DA.split_plan(Bc, Hkv, S)
    assert chunk % DA.PLAN_ROUND == 0 and nsplit >= 1
    assert (nsplit - 1) * chunk < S <= nsplit * chunk
    assert nsplit == 1 or Bc * Hkv * nsplit <= DA.PLAN_BLOCKS
    plans = set()
    for T in (1, 4, 9, 16):
        q = torch.zeros(Bc, T, 4 * Hkv, HD, dtype=torch.bfloat16)
        n, c, part_o, part_ml = DA.split_buffers(q, Hkv, S)
        plans.add((n, c))
        R = DA.rows_pad(4 * T)
        assert R >= 4 * T and R % 16 == 0
        assert (part_o is None) == (n == 1) == (part_ml is None)
        if n > 1:
            assert part_o.shape == (Bc, Hkv, n, R, HD) and part_ml.shape == (Bc, Hkv, n, R, 2)
    assert plans == {(nsplit, chunk)}


def test_split_plan_at_the_main_path():
    """The plans of the main path's shapes: the target cache (B=32, S=8704)
    and the draft's 640-row cache whole (256 blocks: one launch, no
    combine), the served pool (16 slots of 8192 rows) in three splits, and a
    small batch split further."""
    assert DA.split_plan(32, 8, 8704) == (1, 8704)
    assert DA.split_plan(32, 8, 640) == (1, 640)
    assert DA.split_plan(16, 8, 8192) == (3, 2752)
    assert DA.split_plan(2, 8, 8704) == (23, 384)


class _FakeDecodeLibrary:
    """Records the arguments of the bf16 decode entry points (returns
    success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("md_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("T", [1, 4, 9])
@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_decode_launch_once_against_a_fake_library(fresh, T, monkeypatch):
    """K1's host side: one C call a wrapper call with the C signature kept
    (q, k, v, k_new, v_new, base_lens, out, part_o, part_ml, layer, B, S, T,
    Hq, Hkv, hd, nsplit, chunk, stream), split_plan's plan and partials of
    rows_pad(G*T) rows (null with one split), one launch counted; a failed
    launch raises."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeDecodeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(DA, "on_cpu", lambda *a: False)
    Hkv, G = 8, 4
    bf = torch.bfloat16
    for Bc, S in ((2, 8704), (32, 640)):
        q = torch.zeros(Bc, T, Hkv * G, HD, dtype=bf)
        k, v = (torch.zeros(L, Bc, S, Hkv * HD, dtype=bf) for _ in range(2))
        kw = {}
        if fresh:
            kw = {n: torch.zeros(Bc, T, Hkv * HD, dtype=bf) for n in ("k_new", "v_new")}
        base = torch.tensor([0] * (Bc - 1) + [S - T], dtype=torch.int64)
        before = DA.flash_decode_attend.launches
        lib.calls.clear()
        out = DA.flash_decode_attend(q, k, v, base, layer=LAYER, **kw)
        assert out.shape == q.shape and out.dtype == bf
        assert DA.flash_decode_attend.launches == before + 1
        ((name, args),) = lib.calls
        assert name == "md_decode_attend" and len(args) == 19
        assert len(build.SIGNATURES[name]) == 19
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert (args[3] is None) == (args[4] is None) == (not fresh)
        assert args[6] == out.data_ptr()
        nsplit, chunk = DA.split_plan(Bc, Hkv, S)
        assert (args[7] is None) == (args[8] is None) == (nsplit == 1)
        assert args[9:] == (LAYER, Bc, S, T, Hkv * G, Hkv, HD, nsplit, chunk, 7)
    with pytest.raises(ValueError, match="window length"):  # G*T > 128 rows
        DA.flash_decode_attend(torch.zeros(Bc, 9, 16 * Hkv, HD, dtype=bf), k, v, base)
    lib.md_decode_attend = lambda *a: 1
    with pytest.raises(RuntimeError, match="md_decode_attend"):
        DA.flash_decode_attend(q, k, v, base, layer=LAYER, **kw)


@pytest.mark.parametrize("ps", [16, 40, 512])
def test_paged_decode_launch_once_against_a_fake_library(ps, monkeypatch):
    """B12-bf16's host side: one C call with the C signature kept (q, the
    pools, table, k_new, v_new, base_lens, out, part_o, part_ml, layer, B,
    P, ps, npr, T, Hq, Hkv, hd, nsplit, chunk, stream), and the plan of
    K1's launch over a cache of S = npr * ps rows: the same (nsplit,
    chunk) reach both entry points, so the paged launch reads the contiguous
    one's positions in the same splits and tiles."""
    from magicdec_tpu_torch.kernels import build
    from magicdec_tpu_torch.kernels import paged_attention as PGA

    lib = _FakeDecodeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(PGA, "on_cpu", lambda *a: False)
    monkeypatch.setattr(DA, "on_cpu", lambda *a: False)
    Bc, Hkv, G, T, npr = 3, 8, 4, 4, 8192 // ps
    S = npr * ps
    P = Bc * npr + 2
    bf = torch.bfloat16
    q = torch.zeros(Bc, T, Hkv * G, HD, dtype=bf)
    pk, pv = (torch.zeros(L, P, ps, Hkv * HD, dtype=bf) for _ in range(2))
    table = torch.arange(Bc * npr, dtype=torch.int32).reshape(Bc, npr)
    fresh = {n: torch.zeros(Bc, T, Hkv * HD, dtype=bf) for n in ("k_new", "v_new")}
    base = torch.tensor([0, 5, S - T])
    before = PGA.flash_paged_decode_attend.launches
    out = PGA.flash_paged_decode_attend(q, pk, pv, table, base, layer=1, **fresh)
    assert out.shape == q.shape and PGA.flash_paged_decode_attend.launches == before + 1
    k, v = (torch.zeros(L, Bc, S, Hkv * HD, dtype=bf) for _ in range(2))
    DA.flash_decode_attend(q, k, v, base, layer=1, **fresh)
    (name, args), (cname, cargs) = lib.calls
    assert name == "md_paged_decode_attend" and len(args) == 22
    assert len(build.SIGNATURES[name]) == 22 and cname == "md_decode_attend"
    assert args[:4] == (q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr())
    assert args[10:] == (1, Bc, P, ps, npr, T, Hkv * G, Hkv, HD) + cargs[-3:]
    assert cargs[-3:-1] == DA.split_plan(Bc, Hkv, S) and cargs[11] == S


@pytest.mark.parametrize("T", [1, 4, 13])
def test_append_plain_matches_pallas_bitwise(T):
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    S, K = 64, 32
    rng = np.random.RandomState(T)
    ck = rng.randn(L, B, S, K).astype(np.float32)
    cv = rng.randn(L, B, S, K).astype(np.float32)
    rk = rng.randn(L, B, T, K).astype(np.float32)
    rv = rng.randn(L, B, T, K).astype(np.float32)
    pos = np.array([0, 7, 30, S - T], np.int32)
    ok, ov = jkv.append_all_rows_inplace(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(rk),
                                         jnp.asarray(rv), jnp.asarray(pos), interpret=True)
    ckt, cvt, rkt, rvt, post = _t(ck, cv, rk, rv, pos)
    out_k, out_v = AP.append_all_rows_inplace(ckt, cvt, rkt, rvt, post)
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(ov))


# -- on the card: CUDA kernel vs plain version, bf16 --------------------------


def _rand(gen, *shape, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _gpu_close(out, ref):
    assert torch.isfinite(out).all()
    assert _outside(out, ref) == 0


def _gpu_not_close(wrong, ref):
    """The bound must tell a kernel that skips the fresh rows (and reads the
    cache where they belong) from the right answer."""
    assert _outside(wrong, ref) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 640, 8704])
@pytest.mark.parametrize("T", [1, 2, 4, 9, 16])
def test_decode_kernel_matches_plain_on_card(cuda, T, S):
    """K1 within bf16_limit of its plain version, with and without the
    fresh rows (without them it must fail), at the draft's whole cache (S =
    640, one split) and the target's, and at windows of one to three row
    tiles a warp (T = 9: 36 rows) and of two row blocks (T = 16: 64 rows)."""
    gen = torch.Generator(device=cuda).manual_seed(T)
    Bc, Hkv, G = 3, 8, 4
    k = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    v = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    q = _rand(gen, Bc, T, Hkv * G, HD, device=cuda)
    kn, vn = (_rand(gen, Bc, T, Hkv * HD, device=cuda) for _ in range(2))
    base = torch.tensor([0, S // 3, S - T], dtype=torch.int32, device=cuda)
    for kw in ({}, dict(k_new=kn, v_new=vn)):
        out = DA.flash_decode_attend(q, k, v, base, layer=LAYER, **kw)
        ref = DA.flash_decode_attend_plain(q, k, v, base, layer=LAYER, **kw)
        _gpu_close(out, ref)
    _gpu_not_close(DA.flash_decode_attend(q, k, v, base, layer=LAYER), ref)


def _decode_operands(cuda, S, T, base, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    Bc, Hkv, G = len(base), 8, 4
    k = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    v = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    q = _rand(gen, Bc, T, Hkv * G, HD, device=cuda)
    fresh = {n: _rand(gen, Bc, T, Hkv * HD, device=cuda) for n in ("k_new", "v_new")}
    return q, k, v, fresh, torch.tensor(base, dtype=torch.int32, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [640, 8704])
def test_decode_kernel_poisoned_cache_on_card(cuda, S):
    """K1 over a cache holding inf and NaN past every request's visible end
    (base with the fresh rows, base + T without), at bases that start a
    tile, straddle one and end the cache: the kernel never reads those rows
    (the TMA boxes stop below base, the edge tiles land zeros), so its
    output is the clean cache's bit for bit, and within bf16_limit."""
    T = 4
    q, k, v, fresh, base = _decode_operands(cuda, S, T, [0, 37, 300, S // 2 + 5, S - T], 50 + S)
    for kw, end in ((fresh, 0), ({}, T)):
        out = DA.flash_decode_attend(q, _poisoned(k, base, lambda n: n + end),
                                     _poisoned(v, base, lambda n: n + end), base, layer=LAYER,
                                     **kw)
        assert torch.isfinite(out).all()
        assert torch.equal(out, DA.flash_decode_attend(q, k, v, base, layer=LAYER, **kw))
        _gpu_close(out, DA.flash_decode_attend_plain(q, k, v, base, layer=LAYER, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [640, 8704])
def test_decode_kernel_deterministic_and_graph_replay_on_card(cuda, S):
    """Two launches bit-equal, and a CUDA graph's replay bit-equal to the
    eager launch (the tensor maps are encoded at capture, the split
    partials and their combine included)."""
    q, k, v, fresh, base = _decode_operands(cuda, S, 4, [0, S // 3, S - 4], 60)

    def run():
        return DA.flash_decode_attend(q, k, v, base, layer=LAYER, **fresh)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm the stream outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 9, 16])
@pytest.mark.parametrize("S", [640, 8704])
def test_decode_window_equals_step_on_card(cuda, S, T):
    """K1: a window's token t has the bits of the T = 1 step at base + t
    over a cache holding the window's rows before t (the split plan, warps
    and tiles depend on the static shapes only, and a row's arithmetic on
    neither the row tiles a warp holds nor the rows beside it), at bases 0,
    S // 3 and S - T."""
    q, k, v, fresh, base = _decode_operands(cuda, S, T, [0, S // 3, S - T], 70 + T)
    window = DA.flash_decode_attend(q, k, v, base, layer=LAYER, **fresh)
    for t in range(T):
        kc, vc = k.clone(), v.clone()
        for b, n in enumerate(base.tolist()):
            kc[LAYER, b, n:n + t] = fresh["k_new"][b, :t]
            vc[LAYER, b, n:n + t] = fresh["v_new"][b, :t]
        step = DA.flash_decode_attend(q[:, t:t + 1], kc, vc, base + t, layer=LAYER,
                                      k_new=fresh["k_new"][:, t:t + 1],
                                      v_new=fresh["v_new"][:, t:t + 1])
        assert torch.equal(window[:, t:t + 1], step), f"token {t}"


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 200])
def test_prefill_kernel_matches_plain_on_card(cuda, C):
    gen = torch.Generator(device=cuda).manual_seed(C)
    Bc, Hkv, G, S = 2, 8, 4, 1024
    k = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    v = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    q = _rand(gen, Bc, C, Hkv * G, HD, device=cuda)
    kn, vn = (_rand(gen, Bc, C, Hkv * HD, device=cuda) for _ in range(2))
    base = torch.tensor([0, S - C], dtype=torch.int32, device=cuda)
    for kw in ({}, dict(k_new=kn, v_new=vn)):
        out = PA.flash_prefill_attend(q, k, v, base, layer=LAYER, **kw)
        ref = PA.flash_prefill_attend_plain(q, k, v, base, layer=LAYER, **kw)
        _gpu_close(out, ref)
    _gpu_not_close(PA.flash_prefill_attend(q, k, v, base, layer=LAYER), ref)


def _poisoned(cache, base, end_of):
    """A copy of the [L, B, S, K] cache with inf and NaN in every row from
    each request's visible end on (a torch.empty cache may hold them)."""
    bad = cache.clone()
    for b, n in enumerate(base.tolist()):
        end = end_of(n)
        bad[:, b, end:] = float("inf")
        bad[:, b, end + 1::3] = float("nan")
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 200, 512])
def test_prefill_kernel_poisoned_cache_on_card(cuda, C):
    """K2 over a cache holding inf and NaN past every request's visible end
    (base + C without fresh rows, base with them), at bases that start a
    128-row tile (0), straddle one (37, 300) and end near S: finite and
    within the bound of the plain version on the clean cache (a masked p of
    0 times an inf V row would be NaN inside the products)."""
    gen = torch.Generator(device=cuda).manual_seed(20 + C)
    Bc, Hkv, G, S = 4, 8, 4, 1024
    k = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    v = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    q = _rand(gen, Bc, C, Hkv * G, HD, device=cuda)
    kn, vn = (_rand(gen, Bc, C, Hkv * HD, device=cuda) for _ in range(2))
    base = torch.tensor([0, 37, 300, S - C - 5], dtype=torch.int32, device=cuda)
    for fresh in (False, True):
        kw = dict(k_new=kn, v_new=vn) if fresh else {}
        end_of = (lambda n: n) if fresh else (lambda n: n + C)
        out = PA.flash_prefill_attend(q, _poisoned(k, base, end_of), _poisoned(v, base, end_of),
                                      base, layer=LAYER, **kw)
        _gpu_close(out, PA.flash_prefill_attend_plain(q, k, v, base, layer=LAYER, **kw))


def _prefill_operands(cuda, C=200, S=1024):
    gen = torch.Generator(device=cuda).manual_seed(12)
    Bc, Hkv, G = 3, 8, 4
    k = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    v = _rand(gen, L, Bc, S, Hkv * HD, device=cuda)
    q = _rand(gen, Bc, C, Hkv * G, HD, device=cuda)
    kn, vn = (_rand(gen, Bc, C, Hkv * HD, device=cuda) for _ in range(2))
    base = torch.tensor([0, 300, S - C - 5], dtype=torch.int32, device=cuda)
    return lambda: PA.flash_prefill_attend(q, k, v, base, layer=LAYER, k_new=kn, v_new=vn)


@pytest.mark.gpu
def test_prefill_kernel_deterministic_on_card(cuda):
    """Two launches on the same inputs are bit-equal (no atomics, no split
    of the KV range): encode and encode_baseline start from the same bits."""
    run = _prefill_operands(cuda)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.gpu
def test_prefill_graph_replay_matches_eager_on_card(cuda):
    """Captured in a CUDA graph, K2's replay is bit-equal to its eager launch
    (the tensor maps are encoded at capture)."""
    run = _prefill_operands(cuda)
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm the stream outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 4, 512])
def test_append_kernel_matches_plain_on_card(cuda, T):
    gen = torch.Generator(device=cuda).manual_seed(T)
    S, K = 1024, 512
    ck, cv = (_rand(gen, L, B, S, K, device=cuda) for _ in range(2))
    rk, rv = (_rand(gen, L, B, T, K, device=cuda) for _ in range(2))
    # ragged, the last row, a window running past the end, one wholly past it:
    # rows at or past S are dropped
    pos = torch.tensor([5, S - T, S - (T + 1) // 2, 2 * S], dtype=torch.int32,
                       device=cuda)
    ak, av = AP.append_all_rows_inplace(ck.clone(), cv.clone(), rk, rv, pos)
    pk, pv = AP.append_all_rows_inplace_plain(ck, cv, rk, rv, pos)
    assert torch.equal(ak, pk) and torch.equal(av, pv)
