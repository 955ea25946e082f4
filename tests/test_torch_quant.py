"""The port's int8 draft weight copy (``EngineConfig.draft_quant``, the
bench's default ``--draft_quant int8``).

On the CPU, against the JAX package: weight quantization bit for bit; the
plain versions of B6 (``quant_matmul``), B4 (``quant_matmul_fused``: norm,
gate, residual), B5 (``quant_layer_tail``) and B9 (``quant_mlp``) against
the Pallas kernels in interpret mode; the routing of the draft's dots; the
draft pass and the engine on the ``pallas`` backend at widths where the JAX
package's routing reaches its kernels (the t512 widths of
tests/test_quantization.py:246-247: dim 512, F 1024, heads 8/4, vocab 256,
2 layers).  B4 and B6 run on one cluster kernel (csrc/quant_matmul_sm90.cu):
its split plan (at most 8 splits, none empty, a function of the weight's
shape) and a plain model of its sum order (the norm statistic and the
split-K partials added in split order) against the plain versions and the
Pallas kernels.  On the card (``gpu`` marker, skipped without one): each
CUDA kernel against its plain version, B4/B6 at M = 1 to 256 with every
epilogue, at the w2 and lm_head shapes, bit-equal across launches and
under CUDA-graph replay.

Tolerances.  Quantization and conversion are exact.  Plain versions against
the Pallas kernels: atol = rtol = 2e-5 in float32; in bfloat16 at most one
bf16 ulp on at most 0.1% of the elements, because the Pallas kernels scale
each in-block partial sum and the plain versions scale the whole sum once
(another f32 rounding, which moves a bf16 result across a rounding edge
now and then).  B5 in bfloat16 is held to ``kernels.bf16_limit`` instead:
its Pallas kernel, run by XLA on the CPU, normalizes h = x + part before
rounding it to bf16 (XLA's default ``xla_allow_excess_precision``), so 907
of its 2048 outputs here differ from the rounded-h numerics that its code,
B9, B4 and the port follow (with the flag off they agree bit for bit;
ROADMAP C).  The draft pass: tokens exactly, hidden states and caches
to 1e-4 (as the dense pass, tests/test_torch_model.py).  On the card, in
bf16: within ``kernels.bf16_limit``, and a deliberately wrong reference
must fail it.

The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run where JAX is absent:
``python -m pytest tests/test_torch_quant.py -m gpu --noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import bench
from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import quant_matmul as QK

TOL = dict(atol=2e-5, rtol=2e-5)
T512 = dict(vocab_size=256, n_layer=2, n_head=8, n_kv_head=4, dim=512, intermediate_size=1024)
WRAPPERS = ("quant_matmul", "quant_matmul_fused", "quant_layer_tail", "quant_mlp")


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


def _jq(w):
    """A JAX QuantizedWeight of numpy weights w."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    return JQ.quantize_weight(jnp.asarray(w))


def _tq(jw):
    """The port's QuantizedWeight moved from a JAX one."""
    from magicdec_tpu_torch.convert import params_from_jax

    return params_from_jax({"w": _np_tree(jw)})["w"]


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _check_bf16(got, want):
    """At most one bf16 ulp apart, in at most 0.1% of the elements."""
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    diff = np.abs(got - want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (diff <= ulp).all(), float((diff / ulp).max())
    assert (diff > 0).mean() <= 1e-3, int((diff > 0).sum())


def _compare(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _check_bf16(got, want)


# -- quantization vs the JAX package, bit for bit -----------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 40)], ids=["2d", "stacked"])
def test_quantize_weight_matches_jax(shape, dtype):
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w.reshape(-1, *shape[-2:])[0, :, 3] = 0.0          # an all-zero column: the 1e-10 clamp
    # amax 127 gives scale 1: x.5 values are exact ties (round half to even)
    w.reshape(-1, *shape[-2:])[-1, :, 0] = np.concatenate([[127.0], np.arange(63) - 31.5])
    jw = JQ.quantize_weight(jnp.asarray(w, getattr(jnp, dtype)))
    tw = Q.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tw.q.dtype == torch.int8 and tw.scale.dtype == torch.float32
    assert (tw.bits, tw.group_size) == (jw.bits, jw.group_size)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    ties = tw.q.reshape(-1, *shape[-2:])[-1, 1:, 0].numpy()
    np.testing.assert_array_equal(ties, np.round(np.arange(63) - 31.5))
    np.testing.assert_array_equal(Q.dequantize_weight(tw, torch.float32).numpy(),
                                  np.asarray(JQ.dequantize_weight(jw, jnp.float32)))


@pytest.mark.parametrize("head", ["quant", "shared", "tied"])
def test_quantize_params_matches_jax(head):
    """Which leaves are quantized (bit for bit), and which are the input's
    own tensors: embed, norms, and the bf16 head under include_head=False."""
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.models import llama as TM
    from test_torch_model import JCFG, TCFG, _jax_tree, random_params

    params = random_params(JCFG)
    if head == "tied":
        params["lm_head"] = None
    include = head != "shared"
    jp = JQ.quantize_params(_jax_tree(params), include_head=include,
                            materialize_tied_head=include)
    tp_in = TM.fuse_exec_params(params_from_jax(params), TCFG)
    tp = Q.quantize_params(tp_in, include_head=include, materialize_tied_head=include)
    jp = TM.fuse_exec_params(params_from_jax(_np_tree(jp)), TCFG)  # fused like the engine
    for key in ("wqkv", "wo", "w13", "w2"):
        assert Q.is_quantized(tp["layers"][key]), key
        np.testing.assert_array_equal(tp["layers"][key].q.numpy(), jp["layers"][key].q.numpy())
        np.testing.assert_array_equal(tp["layers"][key].scale.numpy(),
                                      jp["layers"][key].scale.numpy())
    for key in ("attn_norm", "ffn_norm"):
        assert tp["layers"][key] is tp_in["layers"][key]
    assert tp["embed"] is tp_in["embed"] and tp["final_norm"] is tp_in["final_norm"]
    if head == "shared":
        assert tp["lm_head"] is tp_in["lm_head"]
    else:
        assert Q.is_quantized(tp["lm_head"])
        np.testing.assert_array_equal(tp["lm_head"].q.numpy(), jp["lm_head"].q.numpy())
        np.testing.assert_array_equal(tp["lm_head"].scale.numpy(),
                                      jp["lm_head"].scale.numpy())


def test_int4_and_groupwise_raise_naming_a8():
    """Group-wise int8 weights are not ported (int4 verify weights are, since
    ``bench --quantize int4``: tests/test_torch_quantized_target.py; the int4
    draft copy: tests/test_torch_weight_int4.py)."""
    w = torch.randn(64, 32)
    with pytest.raises(NotImplementedError, match="A8"):
        Q.quantize_weight(w, group_size=32)
    with pytest.raises(NotImplementedError, match="A8"):
        Q.QuantizedWeight(torch.zeros(32, 32, dtype=torch.int8), torch.ones(2, 32), 8, 16)
    with pytest.raises(NotImplementedError, match="A8"):
        Q.quantize_params({"layers": {"wo": w}}, bits=8, group_size=32)


def test_convert_quantized_weight_round_trip_bitwise():
    """A JAX QuantizedWeight leaf (and its dict form) -> the port -> numpy,
    bit for bit; a dtype given for the float weights leaves it alone."""
    from magicdec_tpu_torch.convert import params_from_jax, tensor_to_numpy

    rng = np.random.RandomState(4)
    jw = _np_tree(_jq(rng.randn(2, 64, 48).astype(np.float32)))
    tree = {"layers": {"wo": jw, "w2": {"q": jw.q, "scale": jw.scale, "bits": 8,
                                         "group_size": 64}},
            "embed": rng.randn(8, 4).astype(np.float32)}
    got = params_from_jax(tree, dtype=torch.bfloat16)
    assert got["embed"].dtype == torch.bfloat16
    for key in ("wo", "w2"):
        w = got["layers"][key]
        assert Q.is_quantized(w) and w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
        np.testing.assert_array_equal(tensor_to_numpy(w.q), jw.q)
        np.testing.assert_array_equal(tensor_to_numpy(w.scale), jw.scale)
        assert (w[1].q.shape, w[1].scale.shape) == ((64, 48), (1, 48))


# -- plain kernel versions vs the Pallas kernels (interpret) ------------------


def _operands(rng, dtype, M, In, Out, *extra):
    """x [M, In] and a quantized [In, Out] weight (JAX and port), plus
    unit-scale arrays of the shapes in ``extra``, in ``dtype``."""
    import jax.numpy as jnp

    jw = _jq((rng.randn(In, Out) / np.sqrt(In)).astype(np.float32))
    arrays = [rng.randn(M, In).astype(np.float32)] + [
        (rng.rand(*s) + 0.5).astype(np.float32) for s in extra]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return (jw, _tq(jw), [jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_plain_matches_pallas(dtype):
    """B6 against ``_int8_kernel`` with two in-blocks."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_pallas

    jw, tw, (jx,), (tx,) = _operands(np.random.RandomState(1), dtype, 8, 512, 256)
    ref = quant_matmul_pallas(jx, jw.q, jw.scale, bits=8, group_size=jw.group_size,
                              block_in=256, block_out=128, interpret=True)
    _compare(QK.quant_matmul(tx, tw.q, tw.scale), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["norm", "gate", "residual"])
def test_quant_matmul_fused_plain_matches_pallas(epilogue, dtype):
    """B4 against ``_fused_kernel`` (int8): the norm with one in-block
    spanning the contraction (as the reference routes it), the gate and the
    residual with two in-blocks."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_fused_pallas

    M, In, Out = 8, 512, 256
    extra = {"norm": [(In,)], "gate": [], "residual": [(M, Out)]}[epilogue]
    jw, tw, ja, ta = _operands(np.random.RandomState(2), dtype, M, In, Out, *extra)
    kw = dict(bits=8, group_size=jw.group_size, block_out=64, interpret=True)
    if epilogue == "norm":
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, ja[1], block_in=In,
                                        norm=True, norm_eps=1e-5, **kw)
        got = QK.quant_matmul_fused(ta[0], tw.q, tw.scale, ta[1], eps=1e-5)
    elif epilogue == "gate":
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, block_in=256, gate=True, **kw)
        got = QK.quant_matmul_fused(ta[0], tw.q, tw.scale, gate=True)
    else:
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, None, ja[1], block_in=256, **kw)
        got = QK.quant_matmul_fused(ta[0], tw.q, tw.scale, res=ta[1])
    _compare(got, ref, dtype)


def _ffn_operands(rng, dtype, M, K, D, F):
    """(JAX, port) operand lists of B5: a, x, wo, w13, w2, norm_w."""
    import jax.numpy as jnp

    jws = [_jq((rng.randn(i, o) / np.sqrt(i)).astype(np.float32))
           for i, o in ((K, D), (D, 2 * F), (F, D))]
    a, x = rng.randn(M, K).astype(np.float32), rng.randn(M, D).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jarr = [jnp.asarray(v, jd) for v in (a, x, nw)]
    tarr = [torch.from_numpy(v).to(td) for v in (a, x, nw)]
    return jws, [_tq(w) for w in jws], jarr, tarr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_layer_tail_plain_matches_pallas(dtype):
    """B5 against ``_layer_tail_kernel`` over four F-blocks."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_layer_tail_pallas

    (jo, j13, j2), (to, t13, t2), (ja, jx, jn), (ta, tx, tn) = _ffn_operands(
        np.random.RandomState(3), dtype, 8, 256, 256, 512)
    ref = quant_layer_tail_pallas(ja, jx, jo.q, jo.scale, j13.q, j13.scale, j2.q, j2.scale,
                                  jn, block_f=128, norm_eps=1e-5, interpret=True)
    got = QK.quant_layer_tail(ta, tx, to.q, to.scale, t13.q, t13.scale, t2.q, t2.scale, tn,
                              eps=1e-5)
    if dtype == "float32":
        _compare(got, ref, dtype)
    else:  # see the module docstring
        ref = torch.from_numpy(np.asarray(ref, dtype=np.float32))
        assert ((got.float() - ref).abs() <= bf16_limit(ref)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
def test_quant_mlp_plain_matches_pallas(residual, dtype):
    """B9 against ``_mlp_kernel`` over four F-blocks."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_mlp_pallas

    (_, j13, j2), (_, t13, t2), (_, jx, jn), (_, tx, tn) = _ffn_operands(
        np.random.RandomState(5), dtype, 8, 128, 256, 512)
    jr, tr = (jx, tx) if residual else (None, None)
    ref = quant_mlp_pallas(jx * 2, j13.q, j13.scale, j2.q, j2.scale, jn, jr, block_f=128,
                           norm_eps=1e-5, interpret=True)
    got = QK.quant_mlp(tx * 2, t13.q, t13.scale, t2.q, t2.scale, tn, tr, eps=1e-5)
    _compare(got, ref, dtype)


# -- B4/B6's cluster kernel: split plan and sum order --------------------------


def _draft_dot_shapes(cfg):
    """(In, Out) of the draft's int8 dots at ``cfg``'s widths: wqkv, wo,
    w13, w2, lm_head."""
    D, F = cfg.dim, cfg.intermediate_size
    qkv = (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim
    return [(D, qkv), (D, D), (D, 2 * F), (F, D), (D, cfg.vocab_size)]


def _plan_shapes():
    from magicdec_tpu_torch import config as tcfg

    shapes = _draft_dot_shapes(tcfg.ModelConfig.from_name("llama-3.2-1b"))
    shapes += _draft_dot_shapes(tcfg.tiny_config())
    return shapes + _draft_dot_shapes(tcfg.tiny_config(**T512))


@pytest.mark.parametrize("In,Out", _plan_shapes())
def test_cluster_split_plan_capped_none_empty(In, Out):
    """At most MAX_SPLIT = 8 splits (the portable cluster), none empty, at
    the main path's shapes (llama-3.2-1b) and the test widths; one split
    where the column tiles fill the 132 SMs; every block resident (two an
    SM) unless one split is already too many."""
    split = QK.cluster_split_plan(In, Out)
    tiles = max(1, In // QK.BK)
    per = -(-tiles // split)
    ncol = max(1, Out // QK.BN)
    assert 1 <= split <= QK.MAX_SPLIT
    assert tiles - (split - 1) * per > 0
    assert split == 1 or ncol * split <= 2 * QK.TARGET_BLOCKS
    if ncol >= QK.TARGET_BLOCKS:
        assert split == 1


def test_cluster_split_plan_at_the_main_path():
    """llama-3.2-1b: wqkv 5 splits (120 blocks, one an SM: 6 would put two
    blocks on 12 SMs), wo 8, w13 2, w2 8 (the uncapped plan's 9 capped),
    lm_head 1 (its 1002 column tiles fill the card).  B15's dense_mlp on
    the persistent FFN kernel: at the H100's 16 resident runs of 8 blocks
    of its bf16 128-row core, w13 1 (128 column tiles, one a block) and w2
    8 (16 tiles, a run's eight ranks each)."""
    from magicdec_tpu_torch.kernels import dense_matmul as DM

    got = [QK.cluster_split_plan(*s) for s in _plan_shapes()[:5]]
    assert got == [5, 8, 2, 8, 1]
    assert DM.dense_mlp_plan(2048, 8192, 16) == (1, 8)


class _FakeLibrary:
    """Records the arguments of md_quant_matmul_sm90 (returns success)."""

    def __init__(self):
        self.calls = []

    def md_quant_matmul_sm90(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("gate", [False, True], ids=["plain", "gate"])
def test_b4_b6_launch_once_with_a_shape_only_plan(gate, monkeypatch):
    """The B4/B6 host side: one kernel call a wrapper call, the split from
    the weight's shape at every M from 1 to 256, nothing allocated but the
    output (rows past 256 raise)."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    In, Out = 8192, 2048
    q = torch.zeros(In, Out, dtype=torch.int8)
    s = torch.ones(1, Out)
    for M in (1, 17, 32, 64, 128, 160, 256):
        out = QK._launch_dot(torch.zeros(M, In, dtype=torch.bfloat16), q, s, gate=gate)
        assert out.shape == (M, Out // 2 if gate else Out)
    assert len(lib.calls) == 7
    args = lib.calls[0]
    assert len(args) == 13  # x, q, scale, norm_w, res, out, M, In, Out, gate, split, eps, stream
    assert {c[10] for c in lib.calls} == {QK.cluster_split_plan(In, Out)} == {8}
    assert [c[6] for c in lib.calls] == [1, 17, 32, 64, 128, 160, 256]
    with pytest.raises(ValueError, match="at most 256 rows"):
        QK._launch_dot(torch.zeros(257, In, dtype=torch.bfloat16), q, s)


def _cluster_order_model(x, q, scale, norm_w=None, res=None, *, gate=False, eps=1e-5):
    """B4/B6's sum order in plain torch: the contraction cut by
    cluster_split_plan; the norm's sum of squares as one partial a split,
    added in split order; each split's f32 partial product, the partials
    added in split order; then the scale and the epilogue."""
    M, In = x.shape
    split = QK.cluster_split_plan(In, q.shape[1])
    per = -(-(In // QK.BK) // split) * QK.BK
    bounds = [(k, min(In, k + per)) for k in range(0, In, per)]
    assert len(bounds) == split
    xf = x.to(torch.float32)
    if norm_w is not None:
        ss = torch.zeros(M, dtype=torch.float32)
        for k0, k1 in bounds:
            ss = ss + (xf[:, k0:k1] * xf[:, k0:k1]).sum(-1)
        r = 1.0 / torch.sqrt(ss / In + eps)
        xf = ((xf * r[:, None]).to(x.dtype) * norm_w.to(x.dtype)).to(torch.float32)
    acc = None
    for k0, k1 in bounds:
        part = xf[:, k0:k1] @ q[k0:k1].to(torch.float32)
        acc = part if acc is None else acc + part
    return QK._epilogue(acc * scale.reshape(-1).to(torch.float32), x.dtype, res, gate)


_EPILOGUES = ["norm", "gate", "residual", "none", "norm_gate"]


def _epilogue_args(epilogue, ta):
    """(norm_w, res, gate) of an epilogue from the port operands ta."""
    norm_w = ta[1] if epilogue.startswith("norm") else None
    res = ta[1] if epilogue == "residual" else None
    return norm_w, res, epilogue.endswith("gate")


@pytest.mark.parametrize("epilogue", _EPILOGUES)
def test_cluster_order_model_matches_plain(epilogue):
    """The split-order model against the plain version in float32, at a
    shape with 8 splits (In 512) and at the w2 shape's cap (In 1024, 16
    tiles in 8 splits)."""
    for In in (512, 1024):
        M, Out = 8, 256
        extra = {"norm": [(In,)], "norm_gate": [(In,)], "residual": [(M, Out)]}.get(epilogue, [])
        _, tw, _, ta = _operands(np.random.RandomState(9), "float32", M, In, Out, *extra)
        assert QK.cluster_split_plan(In, Out) == 8
        norm_w, res, gate = _epilogue_args(epilogue, ta)
        got = _cluster_order_model(ta[0], tw.q, tw.scale, norm_w, res, gate=gate)
        want = QK.quant_matmul_fused_plain(ta[0], tw.q, tw.scale, norm_w, res, gate=gate)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", _EPILOGUES)
def test_cluster_order_model_matches_pallas(epilogue, dtype):
    """The split-order model against ``_fused_kernel`` / ``_int8_kernel``
    in interpret mode (8 splits over In 512)."""
    from magicdec_tpu.ops.pallas.quant_matmul import quant_matmul_fused_pallas, quant_matmul_pallas

    M, In, Out = 8, 512, 256
    extra = {"norm": [(In,)], "norm_gate": [(In,)], "residual": [(M, Out)]}.get(epilogue, [])
    jw, tw, ja, ta = _operands(np.random.RandomState(10), dtype, M, In, Out, *extra)
    kw = dict(bits=8, group_size=jw.group_size, interpret=True)
    if epilogue == "none":
        ref = quant_matmul_pallas(ja[0], jw.q, jw.scale, block_in=256, block_out=128, **kw)
    elif epilogue.startswith("norm"):
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, ja[1], block_in=In, block_out=64,
                                        norm=True, norm_eps=1e-5,
                                        gate=epilogue == "norm_gate", **kw)
    elif epilogue == "gate":
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, block_in=256, block_out=64,
                                        gate=True, **kw)
    else:
        ref = quant_matmul_fused_pallas(ja[0], jw.q, jw.scale, None, ja[1], block_in=256,
                                        block_out=64, **kw)
    norm_w, res, gate = _epilogue_args(epilogue, ta)
    _compare(_cluster_order_model(ta[0], tw.q, tw.scale, norm_w, res, gate=gate), ref, dtype)


# -- routing ------------------------------------------------------------------


def _t512_draft(dtype=torch.float32, seed=0):
    """(cfg, port params fused with their int8 draft copy) at the t512 widths."""
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.models import llama as TM
    from test_torch_model import random_params

    cfg = tcfg.tiny_config(**T512)
    params = TM.fuse_exec_params(params_from_jax(random_params(cfg, seed=seed), dtype=dtype),
                                 cfg)
    return cfg, Q.quantize_params(params)


@pytest.mark.parametrize("T", [1, 2], ids=["M32", "M64"])
def test_draft_step_routes_to_kernels(T, pallas, calls):
    """A draft step at B=32 (M = 32, and 64 for the first step's two
    tokens): per layer the wqkv dot with its norm (B4) and the whole tail
    (B5), then the int8 head (B6)."""
    from magicdec_tpu_torch.models import llama as TM

    cfg, dq = _t512_draft()
    B, Sd = 32, 64
    K = cfg.n_kv_head * cfg.head_dim
    caches = {n: torch.zeros(cfg.n_layer, B, Sd, K) for n in ("dk", "dv")}
    fill = torch.full((B,), 8, dtype=torch.int32)
    TM.forward_draft(dq, cfg, torch.zeros(B, T, dtype=torch.int32), fill, fill, caches)
    assert calls == ["quant_matmul_fused", "quant_layer_tail"] * cfg.n_layer + ["quant_matmul"]


def test_draft_prefill_rows_take_the_plain_product(pallas, calls):
    """A draft prefill chunk at B=32, C=128 (M = 4096 rows) reaches no
    kernel: x @ q.to(x.dtype) * scale.to(x.dtype), as the JAX package."""
    from magicdec_tpu_torch.models import llama as TM

    cfg, dq = _t512_draft()
    B, C = 32, 128
    K = cfg.n_kv_head * cfg.head_dim
    caches = {n: torch.zeros(cfg.n_layer, B, 256, K) for n in ("dk", "dv")}
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=torch.Generator().manual_seed(0))
    TM.forward_streaming_draft_chunk(dq, cfg, tokens, 0, caches, budget=129, sink=4)
    assert calls == []
    w = dq["layers"]["wo"][0]
    x = torch.randn(B, C, w.q.shape[0])
    np.testing.assert_array_equal(Q.quant_matmul(x, w).numpy(),
                                  ((x @ w.q.float()) * w.scale[0]).numpy())


@pytest.mark.parametrize("M,expected", [
    (128, ["quant_layer_tail"]),
    (160, ["quant_matmul_fused", "quant_mlp"]),   # B5 declines above 128 rows
    (512, []),                                    # prefill-sized: the plain product
])
def test_layer_tail_routing_by_rows(M, expected, pallas, calls):
    from magicdec_tpu_torch.models import llama as TM

    cfg, dq = _t512_draft()
    wl = TM._layer(dq, 0)
    x = torch.randn(M, cfg.dim)
    out = torch.randn(1, M, cfg.n_head, cfg.head_dim)
    TM._layer_tail(x, out, wl, cfg, mega=True)
    assert calls == expected


def test_jnp_backend_reaches_no_kernel(calls):
    """The kernels are the default; the "jnp" backend computes the plain
    product on CPU tensors and raises for any other device, as the port
    runs its Hopper kernels only on the card."""
    from magicdec_tpu_torch.models import llama as TM

    cfg, dq = _t512_draft()
    assert Q.matmul_backend() == "pallas"
    caches = {n: torch.zeros(cfg.n_layer, 4, 64, cfg.n_kv_head * cfg.head_dim)
              for n in ("dk", "dv")}
    fill = torch.full((4,), 8, dtype=torch.int32)
    Q.set_matmul_backend("jnp")
    try:
        TM.forward_draft(dq, cfg, torch.zeros(4, 1, dtype=torch.int32), fill, fill, caches)
        assert calls == []
        w = dq["layers"]["wo"][0]
        x = torch.zeros(4, w.q.shape[0], device="meta")
        for route in (lambda: Q.quant_matmul(x, w),
                      lambda: Q.quant_layer_tail(x, x, w, dq["layers"]["w13"][0],
                                                 dq["layers"]["w2"][0], (None, 1e-5))):
            with pytest.raises(NotImplementedError, match="Hopper kernels only"):
                route()
    finally:
        Q.set_matmul_backend("pallas")


def test_quant_wrappers_never_fall_back():
    x = torch.zeros(4, 512, dtype=torch.bfloat16, device="meta")
    q = torch.zeros(512, 256, dtype=torch.int8, device="meta")
    s = torch.ones(1, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quant_matmul(x, q, s)
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quant_matmul_fused(x, q, s, res=torch.zeros(4, 256, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        QK.quant_matmul_fused(x, q, torch.ones(1, 256))
    q2 = torch.zeros(128, 512, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quant_mlp(x, q, s, q2, s, torch.ones(512, device="meta"), eps=1e-5)
    with pytest.raises(ValueError, match="several devices"):
        QK.quant_layer_tail(x, x, q, s, q, s, q2, s, torch.ones(512), eps=1e-5)


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
    return cfg, params, JQ.quantize_params(params), jnp


@pytest.mark.parametrize("T", [1, 2])
def test_forward_draft_int8_matches_jax(T, pallas, monkeypatch):
    """One draft step with the int8 copy on both packages' kernel routes:
    tokens exactly; the pre-head hidden states and the appended caches to
    1e-4."""
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

    def both():
        tj, jc = JM.forward_draft(jdq, jcfg, jnp.asarray(tokens), jnp.asarray(fill),
                                  jnp.asarray(fill), {n: jnp.asarray(a) for n, a in caches.items()})
        tt, tc = TM.forward_draft(params_from_jax(_np_tree(jdq)), tcfg, torch.from_numpy(tokens),
                                  torch.from_numpy(fill), torch.from_numpy(fill),
                                  caches_from_jax(caches))
        return np.asarray(tj), {n: np.asarray(a) for n, a in jc.items()}, tt, caches_to_numpy(tc)

    tj, jc, tt, tc = both()
    np.testing.assert_array_equal(tt.numpy(), tj)
    for name in ("dk", "dv"):
        np.testing.assert_allclose(tc[name], jc[name], atol=1e-4, rtol=1e-4, err_msg=name)
    # the hidden states the head reads
    monkeypatch.setattr(JM, "head_argmax", lambda p, c, x: x)
    monkeypatch.setattr(TM, "head_argmax", lambda p, c, x: x)
    hj, _, ht, _ = both()
    np.testing.assert_allclose(ht.numpy(), hj, atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _engine_runs():
    """(port spec, port AR, JAX spec, JAX AR) stats with the int8 draft copy
    on both kernel routes, prefix 96 (the sink+window eviction active)."""
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from test_torch_engine import ENGINE_KW, MAX_GEN

    jcfg, jparams, _, jnp = _jax_t512()
    tcfg, _ = _t512_draft()
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, size=(2, 96))
    old_j, old_t = JQ._MATMUL_BACKEND, Q.matmul_backend()
    JQ.set_matmul_backend("pallas")
    Q.set_matmul_backend("pallas")
    try:
        eng = SpecEngine(params_from_jax(_np_tree(jparams)), tcfg,
                         EngineConfig(cache_dtype=torch.float32, draft_quant="int8",
                                      **ENGINE_KW), device="cpu")
        assert Q.is_quantized(eng.draft_params["layers"]["wqkv"])
        assert not Q.is_quantized(eng.params["layers"]["wqkv"])
        _, spec = eng.generate(eng.encode(prompt))
        _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=MAX_GEN)
        jeng = JSpecEngine(jparams, jcfg, JEngineConfig(mode="streamingllm", draft_quant="int8",
                                                        cache_dtype=jnp.float32, **ENGINE_KW))
        jprompt = jnp.asarray(prompt, jnp.int32)
        _, jspec = jeng.generate(jeng.encode(jprompt))
        _, jbase = jeng.generate_baseline(jeng.encode_baseline(jprompt), max_new=MAX_GEN)
    finally:
        JQ.set_matmul_backend(old_j)
        Q.set_matmul_backend(old_t)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec), as_np(jbase), MAX_GEN


def test_int8_draft_engine_spec_matches_autoregressive():
    spec, base, _, _, max_gen = _engine_runs()
    n = spec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(len(n)):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])


def test_int8_draft_engine_matches_jax():
    spec, base, jspec, jbase, max_gen = _engine_runs()
    for key in ("output", "num_committed", "target_steps"):
        np.testing.assert_array_equal(spec[key], jspec[key], err_msg=key)
    np.testing.assert_array_equal(base["output"][:, :max_gen], jbase["output"][:, :max_gen])


def test_draft_quant_shared_head_shares_the_buffer():
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config()
    eng = SpecEngine(bench.make_params(cfg, device="cpu"), cfg,
                     EngineConfig(draft_budget=257, draft_quant="int8", draft_quant_head=False),
                     device="cpu")
    assert eng.draft_params["lm_head"] is eng.params["lm_head"]
    assert eng.draft_params["embed"] is eng.params["embed"]
    assert Q.is_quantized(eng.draft_params["layers"]["w13"])


def test_int8_draft_bench_protocol_acceptance(pallas, calls):
    """The bench's synthetic-weight gate (tests/test_bench_protocol.py:65-68)
    on its default path, int8 target cache and int8 draft copy, at dim 512
    so that the draft's dots reach the kernel wrappers: >= 2.5 tokens per
    gamma=3 window."""
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tcfg.tiny_config(vocab_size=1024, n_layer=4, n_head=8, n_kv_head=4,
                           dim=512, intermediate_size=1024)
    eng = SpecEngine(bench.make_params(cfg, device="cpu"), cfg,
                     EngineConfig(gamma=3, draft_budget=257, max_seq_len=1024,
                                  chunk_size=128, max_gen=64, eot_ids=(-1,),
                                  cache_dtype=torch.bfloat16, kv_quant="int8",
                                  draft_quant="int8"),
                     device="cpu")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 768))
    _, stats = eng.generate(eng.encode(prompt))
    assert {"quant_matmul_fused", "quant_layer_tail", "quant_matmul"} <= set(calls)
    steps = int(stats["target_steps"])
    assert steps > 0
    rate = int(stats["gen_tokens"].sum()) / steps / 4
    assert rate >= 2.5, f"int8-draft synthetic-weight protocol collapsed: {rate:.2f} tokens/step"


# -- on the card: CUDA kernel vs plain version --------------------------------


def _card_weight(gen, In, Out, device):
    w = torch.randn((In, Out), generator=gen, device=device) / In ** 0.5
    qw = Q.quantize_weight(w.to(torch.bfloat16))
    return qw.q, qw.scale


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _b4_b6_case(kind, M, In, Out, device, seed):
    """(run, plain, wrong) of a B6 / B4 case: zero-argument callables of the
    kernel, its plain version and a reference that must fail the bound (B6
    and B4 without an epilogue: the scales rolled by one column; B4: without
    its epilogue)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, s = _card_weight(gen, In, Out, device)
    x = torch.randn((M, In), generator=gen, device=device).to(torch.bfloat16)
    if kind == "b6":
        return (lambda: QK.quant_matmul(x, q, s), lambda: QK.quant_matmul_plain(x, q, s),
                lambda: QK.quant_matmul_plain(x, q, s.roll(1, -1)))
    if kind == "b4_none":
        return (lambda: QK.quant_matmul_fused(x, q, s),
                lambda: QK.quant_matmul_fused_plain(x, q, s),
                lambda: QK.quant_matmul_plain(x, q, s.roll(1, -1)))
    if kind == "b4_norm":
        nw = (torch.rand(In, generator=gen, device=device) + 0.5).to(torch.bfloat16)
        x3 = x * 3
        return (lambda: QK.quant_matmul_fused(x3, q, s, nw),
                lambda: QK.quant_matmul_fused_plain(x3, q, s, nw),
                lambda: QK.quant_matmul_plain(x3, q, s))
    if kind == "b4_norm_gate":
        nw = (torch.rand(In, generator=gen, device=device) + 0.5).to(torch.bfloat16)
        return (lambda: QK.quant_matmul_fused(x, q, s, nw, gate=True),
                lambda: QK.quant_matmul_fused_plain(x, q, s, nw, gate=True),
                lambda: QK.quant_matmul_fused_plain(x, q, s, gate=True))
    if kind == "b4_gate":
        return (lambda: QK.quant_matmul_fused(x, q, s, gate=True),
                lambda: QK.quant_matmul_fused_plain(x, q, s, gate=True),
                lambda: QK.quant_matmul_plain(x, q, s)[:, :Out // 2])
    res = torch.randn((M, Out), generator=gen, device=device).to(torch.bfloat16)
    return (lambda: QK.quant_matmul_fused(x, q, s, res=res),
            lambda: QK.quant_matmul_fused_plain(x, q, s, res=res),
            lambda: QK.quant_matmul_plain(x, q, s))


def _check_case(run, plain, wrong):
    out, ref = run(), plain()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _outside(out, ref) == 0
    assert _outside(wrong(), ref) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 64, 160, 1, 17, 128, 256])
@pytest.mark.parametrize("kind", ["b6", "b4_norm", "b4_gate", "b4_residual", "b4_none",
                                  "b4_norm_gate"])
def test_quant_matmul_kernels_match_plain_on_card(cuda, kind, M):
    """B6 and B4 against their plain versions at the wqkv width (In 2048,
    Out 3072; 4096 with the gate: 6 and 4 splits), M = 1 to 256 (160 and
    256: two row passes); a reference with the wrong scales or without the
    epilogue must fail the bound."""
    Out = 4096 if kind.endswith("gate") else 3072
    _check_case(*_b4_b6_case(kind, M, 2048, Out, cuda, M))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,In,Out,M", [
    ("b4_residual", 8192, 2048, 32),   # w2: the cap binds (9 -> 8 splits)
    ("b4_residual", 8192, 2048, 160),
    ("b4_gate", 2048, 16384, 64),      # w13 + gate, 2 splits
    ("b4_norm_gate", 2048, 16384, 32),
    ("b6", 2048, 128256, 32),          # the lm_head's full width, one split
])
def test_quant_matmul_kernels_at_draft_shapes_on_card(cuda, kind, In, Out, M):
    _check_case(*_b4_b6_case(kind, M, In, Out, cuda, 7))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,In,Out,M", [("b4_norm", 2048, 3072, 32),
                                           ("b4_residual", 8192, 2048, 64),
                                           ("b4_gate", 2048, 16384, 17),
                                           ("b6", 2048, 128256, 64)])
def test_quant_matmul_kernels_deterministic_on_card(cuda, kind, In, Out, M):
    """Two launches on the same inputs are bit-equal (splits added in split
    order on chip, no atomics)."""
    run, _, _ = _b4_b6_case(kind, M, In, Out, cuda, 3)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["b4_norm", "b4_gate", "b4_residual", "b6"])
def test_quant_matmul_graph_replay_matches_eager_on_card(cuda, kind):
    """B4/B6 captured in a CUDA graph: replay is bit-equal to the eager
    launch (the tensor maps are encoded at capture, the output is the
    graph's)."""
    run, _, _ = _b4_b6_case(kind, 32, 2048, 4096 if kind == "b4_gate" else 3072, cuda, 5)
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


def _ffn_case(kind, M, device, seed, K=2048, F=8192):
    """(run, plain, wrong) of a B5 / B9 case at D = K (the 1B widths by
    default): B5 with its first residual dropped, B9 without its residual
    as the reference that must fail the bound."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D = K
    (qo, so), (q13, s13), (q2, s2) = (_card_weight(gen, i, o, device)
                                      for i, o in ((K, D), (D, 2 * F), (F, D)))
    a = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    x = torch.randn((M, D), generator=gen, device=device).to(torch.bfloat16)
    nw = (torch.rand(D, generator=gen, device=device) + 0.5).to(torch.bfloat16)
    if kind == "b5":
        def wrong():
            h = QK.quant_matmul_plain(a, qo, so)  # without x
            return QK.quant_mlp_plain(h, q13, s13, q2, s2, nw, h, eps=1e-5)

        return (lambda: QK.quant_layer_tail(a, x, qo, so, q13, s13, q2, s2, nw, eps=1e-5),
                lambda: QK.quant_layer_tail_plain(a, x, qo, so, q13, s13, q2, s2, nw, eps=1e-5),
                wrong)
    return (lambda: QK.quant_mlp(x, q13, s13, q2, s2, nw, x, eps=1e-5),
            lambda: QK.quant_mlp_plain(x, q13, s13, q2, s2, nw, x, eps=1e-5),
            lambda: QK.quant_mlp_plain(x, q13, s13, q2, s2, nw, eps=1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,M", [("b5", 32), ("b5", 64), ("b5", 128),
                                    ("b9", 32), ("b9", 64), ("b9", 128), ("b9", 160),
                                    ("b5", 1), ("b5", 17), ("b9", 129), ("b9", 200),
                                    ("b9", 256)])
def test_ffn_kernels_match_plain_on_card(cuda, kind, M):
    """B5 (M <= 128) and B9 (M <= 256) against their plain versions at the
    draft's widths (B9 at 128 rows: the quantized target's FFN at
    decode_rows, the last row count of the mma.sync core), with the first
    residual dropped as the wrong reference."""
    _check_case(*_ffn_case(kind, M, cuda, M))


@pytest.mark.gpu
def test_ffn_kernel_at_8b_widths_on_card(cuda):
    """B5 at the 8B widths the port routes to it (D = K = 4096, F = 14336),
    M = 32."""
    _check_case(*_ffn_case("b5", 32, cuda, 8, K=4096, F=14336))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,M", [("b5", 32), ("b5", 128), ("b9", 256)])
def test_ffn_kernels_deterministic_and_graph_replay_on_card(cuda, kind, M):
    """Two calls give the same bits (splits added in split order, no
    atomics), and three replays of a captured call equal the eager one (the
    grid barrier's generation words carry over between launches)."""
    run = _ffn_case(kind, M, cuda, 3)[0]
    eager = run()
    assert torch.equal(run(), eager)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm the stream outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,M,kernel", [("b5", 32, "ffn_sm90_kernel<2>"),
                                           ("b9", 64, "ffn_sm90_kernel<4>"),
                                           ("b9", 256, "ffn_wg_sm90_kernel")])
def test_ffn_kernels_one_launch_a_call_on_card(cuda, kind, M, kernel):
    """torch.profiler sees one kernel launch a call: the mma.sync core up to
    128 rows, the wgmma core above."""
    from torch.profiler import ProfilerActivity, profile

    run = _ffn_case(kind, M, cuda, 4)[0]
    run()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then loses an event: profile again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in kern) >= 3:
            break
    assert sum(e.count for e in kern) == 3, [(e.key, e.count) for e in kern]
    assert all(kernel in e.key for e in kern), [e.key for e in kern]
