"""B5 (``quant_layer_tail``) and B9 (``quant_mlp``) on their Hopper kernel,
``csrc/ffn_sm90.cu``: one persistent launch a call, a grid barrier between
the dots, each dot's contraction split over 1, 2, 4 or 8 ranks of a
cluster of 8 and added on chip in split order.

On the CPU: a plain model of the kernel's sum order (the statistic's
slots of 32 columns each, from phase 0's epilogue for B5 and from x for
B9, added in a fixed order; each dot's split-K partials added in split
order; g, u and gated rounded to bf16) against the plain versions in
float32 and against the Pallas kernels ``_layer_tail_kernel`` and
``_mlp_kernel`` in interpret mode (both packages on the "pallas" backend);
the split and grid plans; the host side against a fake library (one C
call a wrapper call, the plan's arguments, nothing but the kernel's
scratch allocated) and the shapes it refuses.  The kernel itself runs on
the card only: tests/test_torch_quant.py's ``gpu`` tests.

Tolerances: the model against the plain versions atol = rtol = 2e-5 in
float32 (another f32 summation order); against the Pallas kernels the same
in float32, and in bfloat16 ``kernels.bf16_limit``, as the card's tests
hold the kernel: the split-order sums move a bf16 product across a
rounding edge now and then, and one ulp of the product is several ulps of
product + residual where the two nearly cancel (B5's Pallas kernel also
normalizes h before rounding it to bf16 under XLA on the CPU, see
tests/test_torch_quant.py).
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import quant_matmul as QK
from test_torch_quant import T512, TOL, _ffn_operands

# the resident clusters of 8 on the H100 at two blocks an SM (GPC sizes cut
# 33 to 30: PERF.md, PR 12); the plans below are taken at this count
RESIDENT = 30


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas():
    """Both packages on their kernel backend ("pallas"), restored after."""
    from magicdec_tpu import quantization as JQ

    old_j, old_t = JQ._MATMUL_BACKEND, Q.matmul_backend()
    JQ.set_matmul_backend("pallas")
    Q.set_matmul_backend("pallas")
    yield
    JQ.set_matmul_backend(old_j)
    Q.set_matmul_backend(old_t)


# -- the kernel's sum order in plain torch ------------------------------------


def _split_dot(x, q, scale, split):
    """f32 x @ q over the contraction cut into ``split`` parts of whole BK
    tiles (as the kernel cuts it), the splits' partials added in split
    order, then the scale."""
    In, Out = q.shape
    per = -(-(In // QK.BK) // split) * QK.BK
    bounds = [(k, min(In, k + per)) for k in range(0, In, per)]
    assert len(bounds) == split and split in QK.FFN_SPLITS
    xf, acc = x.to(torch.float32), None
    for k0, k1 in bounds:
        part = xf[:, k0:k1] @ q[k0:k1].to(torch.float32)
        acc = part if acc is None else acc + part
    return acc * scale.reshape(-1).to(torch.float32)


def _quad(v):
    """(v0 + v1) + (v2 + v3) over the last axis of size 4."""
    return (v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])


def _row_total(slots):
    """The norm's reading of a row's slots [M, D / 32]: as groups of four,
    quarter q adding groups q, q + 4, ... in order (each group's four slots
    in order), the quarters added as a quad."""
    M = slots.shape[0]
    slots = slots.reshape(M, -1, 4)
    quarter = torch.zeros(M, 4)
    for j in range(slots.shape[1]):
        for e in range(4):
            quarter[:, j % 4] = quarter[:, j % 4] + slots[:, j, e]
    return _quad(quarter)


def _slot_statistic(h):
    """B5's row statistic from phase 0's epilogue: tile t's warp w owns
    columns 16 w .. + 15 of each 64-column half of the tile; its lane t4 sums
    the squares of its four columns of each half in order, the quad's lanes
    add as (l0 + l1) + (l2 + l3) into slot [row][4 t + w]."""
    hf = h.to(torch.float32)
    M, D = hf.shape
    # [M, tile, half, warp, lane t4, column j]
    sq = (hf * hf).reshape(M, D // 128, 2, 4, 4, 4)
    lane = torch.zeros(M, D // 128, 4, 4)
    for half in range(2):
        for j in range(4):
            lane = lane + sq[:, :, half, :, :, j]
    return _row_total(_quad(lane).reshape(M, -1))
def _x_statistic(x):
    """B9's row statistic: slot j of a row sums the squares of columns
    32 j .. 32 j + 31 in order."""
    xf = x.to(torch.float32)
    M, D = xf.shape
    sq = (xf * xf).reshape(M, D // 32, 32)
    slots = torch.zeros(M, D // 32)
    for c in range(32):
        slots = slots + sq[:, :, c]
    return _row_total(slots)


def _order_model(x, q13, s13, q2, s2, norm_w, res, tot, splits, eps):
    """Phases 1 and 2 of the kernel on rows x with the statistic ``tot``."""
    dt = x.dtype
    D = x.shape[1]
    r = 1.0 / torch.sqrt(tot / D + eps)
    hn = (x.to(torch.float32) * r[:, None]).to(dt) * norm_w.to(dt)
    acc = _split_dot(hn, q13, s13, splits[0])
    F = acc.shape[1] // 2
    g = acc[:, :F].to(dt).to(torch.float32)
    u = acc[:, F:].to(dt).to(torch.float32)
    gated = (g * torch.sigmoid(g) * u).to(dt)
    y = _split_dot(gated, q2, s2, splits[1]).to(dt)
    return y if res is None else y + res


def _tail_model(a, x, qo, so, q13, s13, q2, s2, norm_w, *, splits, eps):
    h = _split_dot(a, qo, so, splits[0]).to(x.dtype) + x
    return _order_model(h, q13, s13, q2, s2, norm_w, h, _slot_statistic(h), splits[1:], eps)


def _mlp_model(x, q13, s13, q2, s2, norm_w, res=None, *, splits, eps):
    return _order_model(x, q13, s13, q2, s2, norm_w, res, _x_statistic(x), splits, eps)


def _t512(dtype, seed, M=8):
    """(JAX, port) operands of B5 at the t512 widths (wo [512, 512], w13
    [512, 2048], w2 [1024, 512])."""
    D, F = T512["dim"], T512["intermediate_size"]
    return _ffn_operands(np.random.RandomState(seed), dtype, M, D, D, F)


# the splits the models take: the plan's at RESIDENT clusters, and eight
# for every dot, the most a cluster gives
_SPLITS = [None, (8, 8, 8)]


def _splits(ws, splits, M=8):
    return splits or QK.ffn_plan([tuple(w.q.shape) for w in ws], M, RESIDENT)


@pytest.mark.parametrize("splits", _SPLITS, ids=["plan", "split8"])
@pytest.mark.parametrize("kind", ["tail", "mlp_residual", "mlp"])
def test_order_model_matches_plain(kind, splits):
    _, (to, t13, t2), _, (ta, tx, tn) = _t512("float32", 11)
    sp = _splits((to, t13, t2), splits)
    if kind == "tail":
        got = _tail_model(ta, tx, to.q, to.scale, t13.q, t13.scale, t2.q, t2.scale, tn,
                          splits=sp, eps=1e-5)
        want = QK.quant_layer_tail_plain(ta, tx, to.q, to.scale, t13.q, t13.scale, t2.q,
                                         t2.scale, tn, eps=1e-5)
    else:
        res = tx if kind == "mlp_residual" else None
        got = _mlp_model(tx * 3, t13.q, t13.scale, t2.q, t2.scale, tn, res, splits=sp[1:],
                         eps=1e-5)
        want = QK.quant_mlp_plain(tx * 3, t13.q, t13.scale, t2.q, t2.scale, tn, res, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_slot_statistic_is_the_sum_of_squares():
    h = torch.randn(5, 512)
    np.testing.assert_allclose(_slot_statistic(h).numpy(), (h * h).sum(-1).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(_x_statistic(h).numpy(), (h * h).sum(-1).numpy(),
                               rtol=1e-5)


def _check(got, ref, dtype):
    """The module docstring's tolerances against a Pallas output."""
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    else:
        ref = torch.from_numpy(np.asarray(ref, dtype=np.float32))
        assert ((got.float() - ref).abs() <= bf16_limit(ref)).all()


@pytest.mark.parametrize("splits", _SPLITS, ids=["plan", "split8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_order_model_matches_pallas(dtype, splits, pallas):
    """The B5 model against ``_layer_tail_kernel`` (interpret), reached
    through the JAX package's routing."""
    from magicdec_tpu import quantization as JQ

    (jo, j13, j2), (to, t13, t2), (ja, jx, jn), (ta, tx, tn) = _t512(dtype, 12)
    ref = JQ.quant_layer_tail(ja, jx, jo, j13, j2, (jn, 1e-5))
    assert ref is not None, "the JAX package must route these shapes to its kernel"
    got = _tail_model(ta, tx, to.q, to.scale, t13.q, t13.scale, t2.q, t2.scale, tn,
                      splits=_splits((to, t13, t2), splits), eps=1e-5)
    _check(got, ref, dtype)


@pytest.mark.parametrize("splits", _SPLITS, ids=["plan", "split8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
def test_mlp_order_model_matches_pallas(residual, dtype, splits, pallas):
    """The B9 model against ``_mlp_kernel`` (interpret), reached through
    the JAX package's routing."""
    from magicdec_tpu import quantization as JQ

    (_, j13, j2), (to, t13, t2), (_, jx, jn), (_, tx, tn) = _t512(dtype, 13)
    jr, tr = (jx, tx) if residual else (None, None)
    ref = JQ.quant_mlp(jx * 2, j13, j2, (jn, 1e-5), residual=jr)
    assert ref is not None, "the JAX package must route these shapes to its kernel"
    got = _mlp_model(tx * 2, t13.q, t13.scale, t2.q, t2.scale, tn, tr,
                     splits=_splits((to, t13, t2), splits)[1:], eps=1e-5)
    _check(got, ref, dtype)


# -- B15's dense_mlp: the same phases on bf16 weights --------------------------


def _dense_mlp_model(x, w13, w2, norm_w, res=None, *, splits, eps):
    """dense_mlp on the bf16 instance: B9's order with no scales (a scale of
    one is exact in f32)."""
    ones = [torch.ones(w.shape[1]) for w in (w13, w2)]
    return _order_model(x, w13, ones[0], w2, ones[1], norm_w, res, _x_statistic(x), splits,
                        eps)


def _dense_operands(dtype, seed, M=8):
    """numpy and torch x, w13, w2, norm_w, res at the t512 widths
    (tiny_config(**T512): D 512, F 1024)."""
    rng = np.random.RandomState(seed)
    D, F = T512["dim"], T512["intermediate_size"]
    arrs = (rng.randn(M, D).astype(np.float32) * 2,
            (rng.randn(D, 2 * F) / np.sqrt(D)).astype(np.float32),
            (rng.randn(F, D) / np.sqrt(F)).astype(np.float32),
            (rng.rand(D) + 0.5).astype(np.float32), rng.randn(M, D).astype(np.float32))
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


# w13 (8 BK tiles) and w2 (16) cut into 1, 2, 4 and 8 splits
_DENSE_SPLITS = [(1, 1), (2, 2), (4, 4), (8, 8), (1, 8)]


@pytest.mark.parametrize("splits", _DENSE_SPLITS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
def test_dense_mlp_order_model_matches_plain(residual, splits):
    from magicdec_tpu_torch.kernels import dense_matmul as DK

    _, (x, w13, w2, nw, r) = _dense_operands("float32", 21)
    r = r if residual else None
    got = _dense_mlp_model(x, w13, w2, nw, r, splits=splits, eps=1e-5)
    want = DK.dense_mlp_plain(x, w13, w2, nw, r, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("splits", _DENSE_SPLITS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
def test_dense_mlp_order_model_matches_pallas(residual, dtype, splits):
    """The dense_mlp model against ``_dense_mlp_kernel`` (interpret, four
    F-blocks of 256)."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas.quant_matmul import dense_mlp_pallas

    (x, w13, w2, nw, r), (tx, t13, t2, tn, tr) = _dense_operands(dtype, 22)
    jd = getattr(jnp, dtype)
    ref = dense_mlp_pallas(jnp.asarray(x, jd), jnp.asarray(w13, jd), jnp.asarray(w2, jd),
                           jnp.asarray(nw, jd), jnp.asarray(r, jd) if residual else None,
                           block_f=256, norm_eps=1e-5, interpret=True)
    got = _dense_mlp_model(tx, t13, t2, tn, tr if residual else None, splits=splits, eps=1e-5)
    _check(got, ref, dtype)


# -- the plans ------------------------------------------------------------------


def _ffn_dots():
    """(In, Out) of B5's three dots at the 1B and 8B widths, t512 and the
    tiny test model."""
    from magicdec_tpu_torch import config as tcfg

    cfgs = [tcfg.ModelConfig.from_name("llama-3.2-1b"), tcfg.ModelConfig.from_name("llama-3-8b"),
            tcfg.tiny_config(**T512), tcfg.tiny_config()]
    out = []
    for c in cfgs:
        K, D, F = c.n_head * c.head_dim, c.dim, c.intermediate_size
        out.append(((K, D), (D, 2 * F), (F, D)))
    return out


@pytest.mark.parametrize("item", sorted(set(QK.FFN_ITEM_STAGES.values())))
@pytest.mark.parametrize("clusters", [1, 15, 30, 32])
@pytest.mark.parametrize("dots", _ffn_dots(), ids=["1b", "8b", "t512", "tiny"])
def test_ffn_split_plan_cuts_the_cluster_none_empty(dots, clusters, item):
    for In, Out in dots:
        split = QK.ffn_split_plan(In, Out, clusters, item)
        tiles = In // QK.BK
        per = -(-tiles // split)
        assert split in QK.FFN_SPLITS and QK.FFN_CLUSTER % split == 0
        assert tiles - (split - 1) * per > 0, (In, Out, split)


def test_ffn_split_plan_at_the_main_path():
    """1B at the H100's 30 clusters (two blocks an SM, the mma.sync core):
    wo 8, w13 4 (three rounds of 8 stages for some groups beat one of 32
    or two of 16 on the sweep), w2 8; at 32, B4's plan (w13 2).  The wgmma
    core's items reduce through L2: at its 16 runs of blocks, w13 1, w2 8.
    8B at 30: wo 4, w13 1, w2 4."""
    one, eight = _ffn_dots()[:2]
    mma, wg = QK.FFN_ITEM_STAGES[QK.FFN_ROWS], QK.FFN_ITEM_STAGES[QK.FFN_WG_ROWS]
    assert [QK.ffn_split_plan(*d, 30, mma) for d in one] == [8, 4, 8]
    assert [QK.ffn_split_plan(*d, 32, mma) for d in one] == [8, 2, 8]
    assert [QK.ffn_split_plan(*d, 16, wg) for d in one[1:]] == [1, 8]
    assert [QK.ffn_split_plan(*d, 30, mma) for d in eight] == [4, 1, 4]


@pytest.mark.parametrize("M", [32, 200])
@pytest.mark.parametrize("resident", [1, 5, 16, 31, 32, 33, 132])
@pytest.mark.parametrize("dots", _ffn_dots(), ids=["1b", "8b", "t512", "tiny"])
def test_ffn_plan_splits_on_the_resident_grid(dots, resident, M):
    """The splits follow ffn_split_plan on the resident clusters (the grid
    itself: never more clusters than the card holds at once, since a grid
    barrier over blocks not on the card never opens) with the item cost of
    the core that serves M rows, and every split cuts a cluster evenly."""
    splits = QK.ffn_plan(dots, M, resident)
    item = QK.FFN_ITEM_STAGES[QK.FFN_WG_ROWS if M > QK.FFN_ROWS else QK.FFN_ROWS]
    assert splits == tuple(QK.ffn_split_plan(*d, resident, item) for d in dots)
    assert all(QK.FFN_CLUSTER % s == 0 for s in splits)
    with pytest.raises(ValueError, match="resident"):
        QK.ffn_plan(dots, M, 0)


@pytest.mark.parametrize("M,rows", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64),
                                    (65, 128), (128, 128), (129, 256), (256, 256)])
def test_ffn_rows_a_pass(M, rows):
    """Up to 128 rows the mma.sync core, in one pass of 16, 32, 64 or 128
    rows; rows past 128 on the wgmma core, 256 in one pass."""
    assert QK.ffn_rows_a_pass(M) == rows


@pytest.mark.parametrize("M,rows", [(1, 16), (16, 16), (17, 32), (33, 64), (64, 64), (65, 128),
                                    (128, 128), (129, 128), (402, 128), (512, 128)])
def test_ffn_rows_a_pass_bf16(M, rows):
    """bf16 weights (dense_mlp): the mma.sync core at every M, 128 rows a
    pass above 128 (four passes at 402 rows)."""
    assert QK.ffn_rows_a_pass(M, bf16=True) == rows


# -- the host side --------------------------------------------------------------


class _FakeLibrary:
    """Records the B5/B9 entry points' arguments (returns success)."""

    def __init__(self):
        self.calls = []

    def md_quant_layer_tail_sm90(self, *args):
        self.calls.append(("tail", args))
        return 0

    def md_quant_mlp_sm90(self, *args):
        self.calls.append(("mlp", args))
        return 0


@pytest.fixture
def fake(monkeypatch):
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(QK, "_resident", lambda dev, M: RESIDENT)
    monkeypatch.setattr(QK, "_GRID_BARRIERS", {})
    return lib


def _ffn_weights(K, D, F):
    q = [torch.zeros(i, o, dtype=torch.int8) for i, o in ((K, D), (D, 2 * F), (F, D))]
    s = [torch.ones(1, o) for o in (D, 2 * F, D)]
    return q, s


def test_host_side_one_call_a_wrapper_call(fake):
    """One C call a wrapper call with the shape-only splits and the capped
    grid, every M from 1 to 128 (B5) and 256 (B9); one grid barrier buffer
    for every call."""
    K, D, F = 2048, 2048, 8192
    (qo, q13, q2), (so, s13, s2) = _ffn_weights(K, D, F)
    nw = torch.ones(D, dtype=torch.bfloat16)
    for M in (1, 17, 32, 64, 128):
        a, x = (torch.zeros(M, n, dtype=torch.bfloat16) for n in (K, D))
        out = QK._launch_tail(a, x, qo, so, q13, s13, q2, s2, nw, 1e-5, True)
        assert out.shape == (M, D) and out.dtype == torch.bfloat16
    for M, res in ((1, False), (129, True), (200, False), (256, True)):
        x = torch.zeros(M, D, dtype=torch.bfloat16)
        out = QK._launch_mlp(x, q13, s13, q2, s2, nw, x if res else None, 1e-5, False)
        assert out.shape == (M, D)
    tails = [c for k, c in fake.calls if k == "tail"]
    mlps = [c for k, c in fake.calls if k == "mlp"]
    assert len(tails) == 5 and len(mlps) == 4
    # ... ptrs (15, bar last), M, K, D, F, split_o, split_13, split_2, clusters, flags, eps,
    # stream
    assert {c[19:23] for c in tails} == {(8, 4, 8, 30)} and {c[23] for c in tails} == {1}
    assert [c[15] for c in tails] == [1, 17, 32, 64, 128]
    # ... res (6), ..., part (10), bar (11), M, D, F, split_13, split_2, clusters, flags,
    # eps, stream: above 128 rows the wgmma core, w2's partials in part (B9 takes its
    # statistic from x in the norm's blocks: no slots)
    assert [c[12] for c in mlps] == [1, 129, 200, 256]
    assert [c[15:18] for c in mlps] == [(4, 8, 30)] + [(1, 8, 30)] * 3
    assert {c[18] for c in mlps} == {0}
    assert [c[6] is None for c in mlps] == [True, False, True, False]
    assert [c[10] is None for c in mlps] == [True, False, False, False]
    assert len({c[14] for c in tails} | {c[11] for c in mlps}) == 1  # the barrier


@pytest.mark.parametrize("case", ["tail_rows", "mlp_rows", "odd_width", "odd_ffn", "dtype",
                                  "w2_shape"])
def test_host_side_raises_on_shapes_it_does_not_take(case, fake):
    K, D, F = 256, 256, 512
    (qo, q13, q2), (so, s13, s2) = _ffn_weights(K, D, F)
    nw = torch.ones(D, dtype=torch.bfloat16)
    x = torch.zeros(8, D, dtype=torch.bfloat16)
    if case == "tail_rows":
        a, x = torch.zeros(129, K, dtype=torch.bfloat16), torch.zeros(129, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="at most 128 rows"):
            QK._launch_tail(a, x, qo, so, q13, s13, q2, s2, nw, 1e-5, True)
    elif case == "mlp_rows":
        with pytest.raises(ValueError, match="at most 256 rows"):
            QK._launch_mlp(torch.zeros(257, D, dtype=torch.bfloat16), q13, s13, q2, s2, nw,
                           None, 1e-5, True)
    elif case == "odd_width":  # D % 128 != 0
        D2 = 192
        (_, q13, q2), (_, s13, s2) = _ffn_weights(K, D2, F)
        with pytest.raises(ValueError, match="D % 128"):
            QK._launch_mlp(torch.zeros(8, D2, dtype=torch.bfloat16), q13, s13, q2, s2,
                           torch.ones(D2, dtype=torch.bfloat16), None, 1e-5, True)
    elif case == "odd_ffn":  # 2F % 128 != 0
        (_, q13, q2), (_, s13, s2) = _ffn_weights(K, D, 96)
        with pytest.raises(ValueError, match="Out % 128"):
            QK._launch_mlp(x, q13, s13, q2, s2, nw, None, 1e-5, True)
    elif case == "dtype":
        with pytest.raises(TypeError, match="bfloat16"):
            QK._launch_mlp(x.float(), q13, s13, q2, s2, nw, None, 1e-5, True)
    else:
        with pytest.raises(ValueError, match="w2"):
            QK._launch_mlp(x, q13, s13, q2.t().contiguous(), s2, nw, None, 1e-5, True)
    assert fake.calls == []
