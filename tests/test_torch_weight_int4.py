"""The port's int4 draft weight copy (``EngineConfig.draft_quant="int4"``,
the bench's ``--draft_quant int4``): group-wise int4 weights, contraction
rows packed in pairs, one f32 scale per 128-row group and output column.

On the CPU, against the JAX package: packing and weight quantization bit for
bit; the plain versions of B6-int4 (``quant_matmul_int4``) and B4-int4
(``quant_matmul_fused_int4``: gate, residual, none) against the Pallas
kernels in interpret mode; the plain group-wise product against the JAX
package's jnp path; the routing of the draft's int4 dots; the draft pass
on the ``pallas`` backend at the t512 widths of tests/test_torch_quant.py,
where the JAX package's routing reaches its kernels (the engine's tokens
are in tests/test_torch_int4_engine.py); B4-int4's one-launch host side
(its split plan on group boundaries, one C call with only ``out``
allocated, against a fake library) and a plain model of its split and
group order against the plain version and the Pallas kernel, and B6-int4's
host side (one C call, only ``out`` allocated) and its order (split 1)
against both.  On the card (``gpu`` marker, skipped without one): each
CUDA kernel against its plain version, B4-int4 at M = 32 to 256 and groups
64 to 256, B6-int4 at the lm_head's width, each bit-equal across two
launches and under CUDA-graph replay.

Tolerances.  Packing, quantization, dequantization and conversion are
exact.  Plain versions against the Pallas kernels: atol = rtol = 2e-5 in
float32 (the kernels contract the even and odd columns of x as two dots,
the plain versions each group as one: another summation order); in
bfloat16 within ``kernels.bf16_limit`` of the Pallas output.  The draft
pass: tokens exactly, hidden states and caches to 1e-4.  On the card, in
bf16: within ``kernels.bf16_limit``, and a deliberately wrong reference
(the group scales shifted by one group, or rolled by one column) must fail
it.

The JAX package is imported inside the CPU tests only:
``python -m pytest tests/test_torch_weight_int4.py -m gpu --noconftest``
runs the card's tests where JAX is absent.
"""

import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import quant_matmul as QK

TOL = dict(atol=2e-5, rtol=2e-5)
T512 = dict(vocab_size=256, n_layer=2, n_head=8, n_kv_head=4, dim=512, intermediate_size=1024)
WRAPPERS = ("quant_matmul", "quant_matmul_fused", "quant_layer_tail", "quant_mlp",
            "quant_matmul_int4", "quant_matmul_fused_int4")


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


@pytest.fixture
def calls(monkeypatch):
    """The names of the kernel wrappers the port's routing calls, in order."""
    seen = []
    for name in WRAPPERS:
        fn = getattr(QK, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(QK, name, spy)
    return seen


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _jq4(w, group_size=None):
    """A JAX int4 QuantizedWeight of numpy weights w."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    return JQ.quantize_weight(jnp.asarray(w), bits=4, group_size=group_size)


def _tq(jw):
    """The port's QuantizedWeight moved from a JAX one."""
    from magicdec_tpu_torch.convert import params_from_jax

    return params_from_jax({"w": _np_tree(jw)})["w"]


def _compare(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        want = torch.from_numpy(np.asarray(want, dtype=np.float32))
        assert ((got.float() - want).abs() <= bf16_limit(want)).all()


# -- packing and quantization vs the JAX package, bit for bit -----------------


def test_pack_unpack_int4_match_jax():
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    rng = np.random.RandomState(0)
    q = rng.randint(-8, 8, (3, 64, 24)).astype(np.int8)
    packed = Q.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and packed.shape == (3, 32, 24)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JQ.pack_int4(jnp.asarray(q))))
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(Q.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(JQ.unpack_int4(jnp.asarray(every))))
    np.testing.assert_array_equal(Q.unpack_int4(packed).numpy(), q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", [((256, 96), None), ((3, 192, 40), None),
                                         ((128, 40), 32)], ids=["2d", "stacked", "group32"])
def test_quantize_weight_int4_matches_jax(shape, group, dtype):
    """The op, eager, bit for bit: groups of 128 (else 64, else 32) by
    default, scale = amax / 7, values clipped to [-8, 7], ties to even."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    w.reshape(-1, *shape[-2:])[0, :, 3] = 0.0          # an all-zero column: the 1e-10 clamp
    # amax 7 gives scale 1 in the first group: x.5 values are exact ties
    ties = np.concatenate([np.arange(29) * 0.5 - 7.0, [2.5, -2.5]])
    w.reshape(-1, *shape[-2:])[-1, :32, 0] = np.concatenate([[7.0], ties])
    jw = JQ.quantize_weight(jnp.asarray(w, getattr(jnp, dtype)), bits=4, group_size=group)
    tw = Q.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)), bits=4,
                           group_size=group)
    assert (tw.bits, tw.group_size) == (jw.bits, jw.group_size)
    assert tw.q.shape == jw.q.shape and tw.scale.shape == jw.scale.shape
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    vals = Q.unpack_int4(tw.q).reshape(-1, *shape[-2:])[-1, 1:32, 0].numpy()
    np.testing.assert_array_equal(vals, np.round(ties))
    np.testing.assert_array_equal(Q.dequantize_weight(tw, torch.float32).numpy(),
                                  np.asarray(JQ.dequantize_weight(jw, jnp.float32)))


def test_quantize_params_int4_matches_jax():
    """The JAX package's jitted quantize_params(bits=4) scales by f32(1/7)
    (XLA's rewrite of the division, as it does for int8's 127): the port's
    quantize_params does the same, bit for bit; the op divides."""
    import jax
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.models import llama as TM
    from magicdec_tpu_torch import config as tcfg
    from test_torch_model import _jax_tree, random_params

    cfg = tcfg.tiny_config(**T512)
    params = random_params(cfg)
    jp = jax.jit(functools.partial(JQ.quantize_params, bits=4))(_jax_tree(params))
    tp_in = TM.fuse_exec_params(params_from_jax(params), cfg)
    tp = Q.quantize_params(tp_in, bits=4)
    jp = TM.fuse_exec_params(params_from_jax(_np_tree(jp)), cfg)
    for key in ("wqkv", "wo", "w13", "w2"):
        w, jw = tp["layers"][key], jp["layers"][key]
        assert (w.bits, w.group_size) == (jw.bits, jw.group_size) == (4, 128), key
        assert w.scale.shape[-2] == w.in_features // 128 > 1, key
        np.testing.assert_array_equal(tp["layers"][key].q.numpy(), jp["layers"][key].q.numpy())
        np.testing.assert_array_equal(tp["layers"][key].scale.numpy(),
                                      jp["layers"][key].scale.numpy())
    np.testing.assert_array_equal(tp["lm_head"].scale.numpy(), jp["lm_head"].scale.numpy())
    eager = Q.quantize_weight(params_from_jax(params)["lm_head"], bits=4)
    differ = int((eager.scale != tp["lm_head"].scale).sum())
    assert differ > 0 and (eager.scale - tp["lm_head"].scale).abs().max() <= \
        tp["lm_head"].scale.abs().max() * 2 ** -23


def test_convert_int4_weight_round_trip_bitwise():
    from magicdec_tpu_torch.convert import params_from_jax, tensor_to_numpy

    rng = np.random.RandomState(4)
    jw = _np_tree(_jq4(rng.randn(2, 256, 48).astype(np.float32)))
    tree = {"layers": {"wo": jw, "w2": {"q": jw.q, "scale": jw.scale, "bits": 4,
                                         "group_size": 128}}}
    got = params_from_jax(tree, dtype=torch.bfloat16)
    for key in ("wo", "w2"):
        w = got["layers"][key]
        assert Q.is_quantized(w) and (w.bits, w.group_size) == (4, 128)
        assert w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
        np.testing.assert_array_equal(tensor_to_numpy(w.q), jw.q)
        np.testing.assert_array_equal(tensor_to_numpy(w.scale), jw.scale)
        assert (w[1].q.shape, w[1].scale.shape, w[1].in_features) == ((128, 48), (2, 48), 256)


# -- plain kernel versions vs the Pallas kernels (interpret) ------------------


def _operands(rng, dtype, M, In, Out, *extra):
    """x [M, In], an int4 [In, Out] weight (JAX and port) and unit-scale
    arrays of the shapes in ``extra``, in ``dtype``."""
    import jax.numpy as jnp

    jw = _jq4((rng.randn(In, Out) / np.sqrt(In)).astype(np.float32))
    arrays = [rng.randn(M, In).astype(np.float32)] + [
        (rng.rand(*s) + 0.5).astype(np.float32) for s in extra]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (jw, _tq(jw), [jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_int4_plain_matches_pallas(dtype):
    """B6-int4 against ``_int4_kernel``: two in-blocks of 8 groups each."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_pallas

    jw, tw, (jx,), (tx,) = _operands(np.random.RandomState(1), dtype, 8, 2048, 256)
    ref = quant_matmul_pallas(jx, jw.q, jw.scale, bits=4, group_size=jw.group_size,
                              block_in=1024, block_out=128, interpret=True)
    _compare(QK.quant_matmul_int4(tx, tw.q, tw.scale), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["none", "gate", "residual"])
def test_quant_matmul_fused_int4_plain_matches_pallas(epilogue, dtype):
    """B4-int4 against ``_fused_kernel`` with bits=4 (two in-blocks)."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_fused_pallas

    M, In, Out = 8, 2048, 256
    extra = [(M, Out)] if epilogue == "residual" else []
    jw, tw, ja, ta = _operands(np.random.RandomState(2), dtype, M, In, Out, *extra)
    kw = dict(bits=4, group_size=jw.group_size, block_in=1024, block_out=64, interpret=True)
    if epilogue == "none":
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, **kw)
        got = QK.quant_matmul_fused_int4(ta[0], tw.q, tw.scale)
    elif epilogue == "gate":
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, gate=True, **kw)
        got = QK.quant_matmul_fused_int4(ta[0], tw.q, tw.scale, gate=True)
    else:
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, None, ja[1], **kw)
        got = QK.quant_matmul_fused_int4(ta[0], tw.q, tw.scale, ta[1])
    _compare(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupwise_plain_product_matches_jax(dtype):
    """Prefill-sized rows take the plain product on both packages' pallas
    backends: x @ (q * s by groups, rounded to x's dtype), one dot.  The
    dequantized weights agree bit for bit; in bf16 the two CPU dots round
    differently in a few outputs (7 of 76,800 by one bf16 step at this
    seed), so the product is held to ``kernels.bf16_limit``."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    jw, tw, (jx,), (tx,) = _operands(np.random.RandomState(3), dtype, 300, 512, 256)
    old = JQ._MATMUL_BACKEND
    JQ.set_matmul_backend("pallas")
    try:
        ref = JQ.quant_matmul(jx, jw)
    finally:
        JQ.set_matmul_backend(old)
    got = Q.quant_matmul(tx, tw)
    td = getattr(torch, dtype)
    np.testing.assert_array_equal(Q.dequantize_weight(tw, td).float().numpy(),
                                  np.asarray(JQ.dequantize_weight(jw, jx.dtype), np.float32))
    _compare(got, ref, dtype)


# -- routing ------------------------------------------------------------------


def _t512_draft(seed=0):
    """(cfg, port params fused with their int4 draft copy) at the t512 widths."""
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.models import llama as TM
    from test_torch_model import random_params

    cfg = tcfg.tiny_config(**T512)
    params = TM.fuse_exec_params(params_from_jax(random_params(cfg, seed=seed)), cfg)
    return cfg, Q.quantize_params(params, bits=4)


@pytest.mark.parametrize("T", [1, 2], ids=["M32", "M64"])
def test_int4_draft_step_routes_to_kernels(T, pallas, calls):
    """A draft step at B=32 on the int4 copy: per layer B4-int4 four times
    (wqkv after the norm, wo + residual, w13 + gate, w2 + residual), B5 and
    B9 declining, then the head as B6-int4."""
    from magicdec_tpu_torch.models import llama as TM

    cfg, dq = _t512_draft()
    B, Sd = 32, 64
    K = cfg.n_kv_head * cfg.head_dim
    caches = {n: torch.zeros(cfg.n_layer, B, Sd, K) for n in ("dk", "dv")}
    fill = torch.full((B,), 8, dtype=torch.int32)
    TM.forward_draft(dq, cfg, torch.zeros(B, T, dtype=torch.int32), fill, fill, caches)
    assert calls == ["quant_matmul_fused_int4"] * 4 * cfg.n_layer + ["quant_matmul_int4"]


def test_int4_wrappers_never_fall_back():
    x = torch.zeros(4, 512, dtype=torch.bfloat16, device="meta")
    q = torch.zeros(256, 256, dtype=torch.int8, device="meta")
    s = torch.ones(4, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quant_matmul_int4(x, q, s)
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quant_matmul_fused_int4(x, q, s, torch.zeros(4, 256, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        QK.quant_matmul_fused_int4(x, q, torch.ones(4, 256), gate=True)


# -- B4-int4's one-launch cluster kernel: plan, host side, sum order ----------


@pytest.mark.parametrize("In,Out,group", [(2048, 3072, 128), (2048, 2048, 128),
                                          (2048, 16384, 128), (8192, 2048, 128),
                                          (2048, 3072, 32), (2048, 3072, 64),
                                          (2048, 3072, 256), (1024, 256, 128)])
def test_b4_int4_split_plan_on_group_boundaries(In, Out, group):
    """B4-int4's splits: at most 8, none empty, each starting on a group
    boundary (cut in units of max(group, 128) rows), from the shape alone."""
    unit = max(group, QK.BK4)
    split = QK.cluster_split_plan(In, Out, unit)
    units = In // unit
    per = -(-units // split)
    assert 1 <= split <= 8 and -(-units // per) == split
    bounds = [(k, min(In, k + per * unit)) for k in range(0, In, per * unit)]
    assert len(bounds) == split and all(k0 % group == 0 and k1 > k0 for k0, k1 in bounds)


class _FakeLibrary:
    """Records the arguments of the int4 entry points (returns success)."""

    def __init__(self):
        self.calls = []

    def md_quant_matmul_int4_sm90(self, *args):
        self.calls.append(("b4", args))
        return 0

    def md_quant_matmul_int4_t_sm90(self, *args):
        self.calls.append(("b6", args))
        return 0

    def md_quant_matmul_int4_m128_sm90(self, *args):
        self.calls.append(("b4_m128", args))
        return 0


@pytest.mark.parametrize("epilogue", ["none", "gate", "residual"])
def test_b4_int4_launch_once_with_a_shape_only_plan(epilogue, monkeypatch):
    """The B4-int4 host side: one kernel call a wrapper call, routed by M
    alone (1..64 rows the cluster core's ``md_quant_matmul_int4_sm90``,
    65..256 the 128-row core's ``md_quant_matmul_int4_m128_sm90``), each
    core's split from the weight's shape and group at every M it serves,
    nothing allocated but the output (rows past 256 raise); B6-int4 takes
    its own entry."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    In, Out, group = 8192, 2048, 128
    q = torch.zeros(In // 2, Out, dtype=torch.int8)
    s = torch.ones(In // group, Out)
    gate = epilogue == "gate"
    allocated = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocated.append(a) or empty(*a, **k))
    rows = (1, 17, 32, 64, 65, 160, 256)
    for M in rows:
        res = torch.zeros(M, Out, dtype=torch.bfloat16) if epilogue == "residual" else None
        out = QK._launch_b4_int4(torch.zeros(M, In, dtype=torch.bfloat16), q, s, res, gate)
        assert out.shape == (M, Out // 2 if gate else Out)
    assert allocated == [((M, Out // 2 if gate else Out),) for M in rows]
    assert [c[0] for c in lib.calls] == ["b4"] * 4 + ["b4_m128"] * 3
    assert [QK.dot_route(M) for M in rows] == ["cluster"] * 4 + ["m128"] * 3
    args = [c[1] for c in lib.calls]
    # x, q, scale, res, out, M, In, Out, gate, split, group, stream
    assert all(len(a) == 12 for a in args)
    assert {a[9] for a in args[:4]} == {QK.cluster_split_plan(In, Out, 128)} == {8}
    assert {a[9] for a in args[4:]} == {QK.m128_split_plan(In, Out, 128, QK.BK4)} == {6}
    assert {(a[8], a[10]) for a in args} == {(int(gate), group)}
    assert [a[5] for a in args] == list(rows)
    with pytest.raises(ValueError, match="at most 256 rows"):
        QK._launch_b4_int4(torch.zeros(257, In, dtype=torch.bfloat16), q, s)
    QK._launch_b6_int4(torch.zeros(32, In, dtype=torch.bfloat16), q, s)
    # x, q, scale, out, M, In, Out, group, stream: no split, no epilogue
    assert lib.calls[-1][0] == "b6" and len(lib.calls[-1][1]) == 9


@pytest.mark.parametrize("group", [32, 128, 256])
def test_b6_int4_launch_once_with_only_the_output(group, monkeypatch):
    """The B6-int4 host side: one kernel call a wrapper call at every M from
    1 to 256 with the shape and group passed as they are (no split), nothing
    allocated but the output; rows past 256 raise."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    In, Out = 2048, 128256
    q = torch.zeros(In // 2, Out, dtype=torch.int8)
    s = torch.ones(In // group, Out)
    allocated = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocated.append(a) or empty(*a, **k))
    rows = (1, 16, 17, 32, 33, 64, 65, 160, 256)
    for M in rows:
        x = torch.zeros(M, In, dtype=torch.bfloat16)
        out = QK._launch_b6_int4(x, q, s)
        assert out.shape == (M, Out) and out.dtype == torch.bfloat16
        assert lib.calls[-1][1][0] == x.data_ptr() and lib.calls[-1][1][3] == out.data_ptr()
    assert allocated == [((M, Out),) for M in rows]
    assert [c[0] for c in lib.calls] == ["b6"] * len(rows)
    assert [c[1][4:8] for c in lib.calls] == [(M, In, Out, group) for M in rows]
    with pytest.raises(ValueError, match="at most 256 rows"):
        QK._launch_b6_int4(torch.zeros(257, In, dtype=torch.bfloat16), q, s)
    with pytest.raises(ValueError, match="power-of-two group"):
        QK._launch_b6_int4(torch.zeros(4, In, dtype=torch.bfloat16), q, torch.ones(In // 16, Out))
    assert len(lib.calls) == len(rows)


def _int4_cluster_order_model(x, q, scale, res=None, *, gate=False, split=None):
    """B4-int4's sum order in plain torch: the contraction cut by
    cluster_split_plan (or into ``split`` parts) in units of max(group, 128)
    rows; in each split the groups in order, acc += f32(x_g @ q_g) * s_g;
    the splits' partials added in split order; then B4's epilogue.  With
    split 1 and no epilogue: B6-int4's order, the groups of the whole
    contraction in order."""
    from magicdec_tpu_torch.quantization import unpack_int4

    M, In = x.shape
    G = scale.shape[0]
    group = In // G
    unit = max(group, QK.BK4)
    if split is None:
        split = QK.cluster_split_plan(In, q.shape[1], unit)
    per = -(-(In // unit) // split) * unit
    qf = unpack_int4(q).to(torch.float32)
    xf = x.to(torch.float32)
    acc = None
    for k0 in range(0, In, per):
        part = torch.zeros((M, q.shape[1]), dtype=torch.float32)
        for g0 in range(k0, min(In, k0 + per), group):
            part += (xf[:, g0:g0 + group] @ qf[g0:g0 + group]) * scale[g0 // group].float()
        acc = part if acc is None else acc + part
    return QK._epilogue(acc, x.dtype, res, gate)


@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("epilogue", ["none", "gate", "residual"])
def test_int4_cluster_order_model_matches_plain(epilogue, group):
    """The split- and group-order model against the plain version in
    float32 (In 1024: 8 splits at groups 64 and 128, 4 at 256)."""
    M, In, Out = 8, 1024, 256
    extra = [(M, Out)] if epilogue == "residual" else []
    _, _, _, ta = _operands_group(np.random.RandomState(4), "float32", M, In, Out, group,
                                  *extra)
    x, q, s = ta[0], ta[-2], ta[-1]
    res = ta[1] if epilogue == "residual" else None
    assert QK.cluster_split_plan(In, Out, max(group, 128)) == In // max(group, 128)
    got = _int4_cluster_order_model(x, q, s, res, gate=epilogue == "gate")
    want = QK.quant_matmul_fused_int4_plain(x, q, s, res, gate=epilogue == "gate")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("group", [32, 64, 128, 256])
def test_b6_int4_order_model_matches_plain(group):
    """B6-int4's order (split 1, no epilogue: every group of the contraction
    in order) against the plain version in float32, at a narrow Out where
    cluster_split_plan would split."""
    M, In, Out = 8, 1024, 256
    _, _, _, ta = _operands_group(np.random.RandomState(7), "float32", M, In, Out, group)
    x, q, s = ta[0], ta[-2], ta[-1]
    assert QK.cluster_split_plan(In, Out, max(group, 128)) > 1
    got = _int4_cluster_order_model(x, q, s, split=1)
    np.testing.assert_allclose(got.numpy(), QK.quant_matmul_int4_plain(x, q, s).numpy(), **TOL)


def _operands_group(rng, dtype, M, In, Out, group, *extra):
    """_operands with an int4 weight of the given group: (jw, None, ja, ta
    + [q, scale] of the port)."""
    import jax.numpy as jnp

    jw = _jq4((rng.randn(In, Out) / np.sqrt(In)).astype(np.float32), group_size=group)
    tw = _tq(jw)
    arrays = [rng.randn(M, In).astype(np.float32)] + [
        (rng.rand(*s) + 0.5).astype(np.float32) for s in extra]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (jw, None, [jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays] + [tw.q, tw.scale])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["none", "gate", "residual"])
def test_int4_cluster_order_model_matches_pallas(epilogue, dtype):
    """The split- and group-order model against ``_fused_kernel`` with
    bits=4 in interpret mode (8 splits over In 1024, group 128)."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_fused_pallas

    M, In, Out = 8, 1024, 256
    extra = [(M, Out)] if epilogue == "residual" else []
    jw, _, ja, ta = _operands_group(np.random.RandomState(5), dtype, M, In, Out, 128, *extra)
    kw = dict(bits=4, group_size=jw.group_size, block_in=512, block_out=64, interpret=True)
    if epilogue == "residual":
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, None, ja[1], **kw)
    else:
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, gate=epilogue == "gate", **kw)
    got = _int4_cluster_order_model(ta[0], ta[-2], ta[-1],
                                    ta[1] if epilogue == "residual" else None,
                                    gate=epilogue == "gate")
    _compare(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [64, 128])
def test_b6_int4_order_model_matches_pallas(group, dtype):
    """B6-int4's order (split 1, no epilogue) against ``quant_matmul_pallas``
    with bits=4 (``_int4_kernel``) in interpret mode, at a narrow Out."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_pallas

    M, In, Out = 8, 1024, 256
    jw, _, ja, ta = _operands_group(np.random.RandomState(8), dtype, M, In, Out, group)
    ref = quant_matmul_pallas(ja[0], jw.q, jw.scale, bits=4, group_size=jw.group_size,
                              block_in=512, block_out=128, interpret=True)
    _compare(_int4_cluster_order_model(ta[0], ta[-2], ta[-1], split=1), ref, dtype)


# -- the draft pass and the engine vs the JAX package -------------------------


@functools.lru_cache(maxsize=None)
def _jax_t512():
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.models import llama as JM
    from test_torch_model import _jax_tree, random_params

    cfg = jcfg.tiny_config(**T512)
    params = JM.fuse_exec_params(_jax_tree(random_params(cfg)), cfg)
    return cfg, params, JQ.quantize_params(params, bits=4), jnp


@pytest.mark.parametrize("T", [1, 2])
def test_forward_draft_int4_matches_jax(T, pallas, monkeypatch):
    """One draft step with the int4 copy on both packages' kernel routes:
    the pre-head hidden states and the appended caches to 1e-4; the tokens
    of each package's int4 head on its own hidden states exactly."""
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy, params_from_jax
    from magicdec_tpu_torch.models import llama as TM

    jcfg, _, jdq, jnp = _jax_t512()
    tcfg, tdq = _t512_draft()
    np.testing.assert_array_equal(tdq["layers"]["w13"].q.numpy(),
                                  np.asarray(jdq["layers"]["w13"].q))
    rng = np.random.RandomState(6)
    B, Sd, K = 2, 64, jcfg.n_kv_head * jcfg.head_dim
    caches = {n: rng.randn(jcfg.n_layer, B, Sd, K).astype(np.float32) for n in ("dk", "dv")}
    tokens = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    fill = np.array([10, 33], np.int32)
    tdq = params_from_jax(_np_tree(jdq))
    j_head, t_head = JM.head_argmax, TM.head_argmax
    # the passes return their pre-head hidden states; each head runs after
    monkeypatch.setattr(JM, "head_argmax", lambda p, c, x: x)
    monkeypatch.setattr(TM, "head_argmax", lambda p, c, x: x)
    hj, jc = JM.forward_draft(jdq, jcfg, jnp.asarray(tokens), jnp.asarray(fill),
                              jnp.asarray(fill), {n: jnp.asarray(a) for n, a in caches.items()})
    ht, tc = TM.forward_draft(tdq, tcfg, torch.from_numpy(tokens), torch.from_numpy(fill),
                              torch.from_numpy(fill), caches_from_jax(caches))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4, rtol=1e-4)
    tc = caches_to_numpy(tc)
    for name in ("dk", "dv"):
        np.testing.assert_allclose(tc[name], np.asarray(jc[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(t_head(tdq, tcfg, ht).numpy(),
                                  np.asarray(j_head(jdq, jcfg, hj)))


# -- on the card: CUDA kernel vs plain version --------------------------------


def _card_weight(gen, In, Out, device, group=None):
    w = torch.randn((In, Out), generator=gen, device=device) / In ** 0.5
    qw = Q.quantize_weight(w.to(torch.bfloat16), bits=4, group_size=group)
    return qw.q, qw.scale


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 64, 160])
@pytest.mark.parametrize("kind", ["b6", "b4_none", "b4_gate", "b4_residual"])
def test_int4_kernels_match_plain_on_card(cuda, kind, M):
    """B6-int4 and B4-int4 against their plain versions (M = 160: three row
    groups); the reference with the scales rolled by one column (B6) or
    shifted by one group (B4) must fail the bound."""
    gen = torch.Generator(device=cuda).manual_seed(M)
    In, Out = 2048, 3072 if kind != "b4_gate" else 4096
    q, s = _card_weight(gen, In, Out, cuda)
    x = torch.randn((M, In), generator=gen, device=cuda).to(torch.bfloat16)
    shifted = s.roll(1, 0)
    if kind == "b6":
        out, ref = QK.quant_matmul_int4(x, q, s), QK.quant_matmul_int4_plain(x, q, s)
        wrong = QK.quant_matmul_int4_plain(x, q, s.roll(1, -1))
    elif kind == "b4_none":
        out, ref = QK.quant_matmul_fused_int4(x, q, s), QK.quant_matmul_fused_int4_plain(x, q, s)
        wrong = QK.quant_matmul_fused_int4_plain(x, q, shifted)
    elif kind == "b4_gate":
        out = QK.quant_matmul_fused_int4(x, q, s, gate=True)
        ref = QK.quant_matmul_fused_int4_plain(x, q, s, gate=True)
        wrong = QK.quant_matmul_fused_int4_plain(x, q, shifted, gate=True)
    else:
        res = torch.randn((M, Out), generator=gen, device=cuda).to(torch.bfloat16)
        out = QK.quant_matmul_fused_int4(x, q, s, res)
        ref = QK.quant_matmul_fused_int4_plain(x, q, s, res)
        wrong = QK.quant_matmul_fused_int4_plain(x, q, shifted, res)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _outside(out, ref) == 0
    assert _outside(wrong, ref) > 0


def _b4_int4_case(kind, M, In, Out, group, device, seed):
    """(run, plain, wrong) of one B4-int4 case; wrong shifts the scales by
    one group (none, gate) or drops the residual."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, s = _card_weight(gen, In, Out, device, group)
    x = torch.randn((M, In), generator=gen, device=device).to(torch.bfloat16)
    res = torch.randn((M, Out), generator=gen, device=device).to(torch.bfloat16)
    kw = {"none": {}, "gate": dict(gate=True), "residual": dict(res=res)}[kind]
    wrong = (lambda: QK.quant_matmul_fused_int4_plain(x, q, s)) if kind == "residual" else (
        lambda: QK.quant_matmul_fused_int4_plain(x, q, s.roll(1, 0), **kw))
    return (lambda: QK.quant_matmul_fused_int4(x, q, s, **kw),
            lambda: QK.quant_matmul_fused_int4_plain(x, q, s, **kw), wrong)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("M", [32, 64, 160, 256])
@pytest.mark.parametrize("kind", ["none", "gate", "residual"])
def test_b4_int4_kernel_groups_match_plain_on_card(cuda, kind, M, group):
    """B4-int4 on the cluster kernel at the wqkv width (w13's 4096 columns
    with the gate), M = 32 to 256 (160 and 256: several row passes), groups
    64 to 256; the wrong reference must fail the bound."""
    run, plain, wrong = _b4_int4_case(kind, M, 2048, 4096 if kind == "gate" else 3072, group,
                                      cuda, M + group)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _outside(out, ref) == 0
    assert _outside(wrong(), ref) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,In,Out,M", [("none", 2048, 3072, 32), ("residual", 2048, 2048, 64),
                                           ("gate", 2048, 16384, 32),
                                           ("residual", 8192, 2048, 64)])
def test_b4_int4_deterministic_and_graph_replay_on_card(cuda, kind, In, Out, M):
    """At the draft's shapes: two launches bit-equal (splits added in split
    order on chip, no atomics), CUDA-graph replay bit-equal to eager."""
    run, plain, _ = _b4_int4_case(kind, M, In, Out, 128, cuda, 9)
    eager = run()
    assert torch.equal(run(), eager)
    assert _outside(eager, plain()) == 0
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
@pytest.mark.parametrize("M", [32, 64, 160])
def test_b6_int4_head_on_card(cuda, M):
    """B6-int4 at the lm_head's width [2048, 128256]: within the bound of the
    plain version, which the reference with the scales rolled by one column
    fails; two launches bit-equal (no split, no atomics); CUDA-graph replay
    bit-equal to the eager launch."""
    gen = torch.Generator(device=cuda).manual_seed(100 + M)
    q, s = _card_weight(gen, 2048, 128256, cuda)
    x = torch.randn((M, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    eager = QK.quant_matmul_int4(x, q, s)
    ref = QK.quant_matmul_int4_plain(x, q, s)
    assert torch.isfinite(eager).all()
    assert _outside(eager, ref) == 0
    assert _outside(QK.quant_matmul_int4_plain(x, q, s.roll(1, -1)), ref) > 0
    assert torch.equal(QK.quant_matmul_int4(x, q, s), eager)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        QK.quant_matmul_int4(x, q, s)  # warm the stream outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = QK.quant_matmul_int4(x, q, s)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
