"""B15, the bf16 weight-streaming dots of the target's decode and verify
passes (``quantization.set_dense_kernels``, off by default as in the JAX
package).

On the CPU, against the JAX package: the plain versions against
``dense_matmul_fused_pallas`` and ``dense_mlp_pallas`` in interpret mode
(float32, 2e-5: the same function, summed in another order), at the shapes
of tests/test_pallas_kernels.py; the routing's row invariance on the port;
the engine with the dense kernels on against the JAX engine with its
own on, both on the "pallas" backend (tokens exactly; spec == AR).  On the
card (``gpu`` marker, skipped without one): each kernel against its plain
version within ``kernels.bf16_limit`` at the shapes of ``chip_smoke.py``'s
kernel phase (``dense_matmul_fused`` also at M = 512), and wrong
references that must fail it; ``dense_matmul_fused`` bit-equal across two
launches and under CUDA-graph replay, and row-invariant (the rows of an
M = 16 call equal those rows of an M = 128 call).  On the CPU also its
one-launch host side (``dense_plan``, one C call with only ``out``
allocated, against a fake library) and a plain model of its sum order
(split-K partials and the norm statistic added in split order) against the
plain version and the Pallas kernel.

The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run where JAX is absent:
``python -m pytest tests/test_torch_dense_matmul.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import dense_matmul as DK

TOL = dict(atol=2e-5, rtol=2e-5)


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
def dense_on():
    Q.set_dense_kernels(True)
    yield
    Q.set_dense_kernels(False)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("norm,res", [(True, True), (True, False), (False, True),
                                      (False, False)], ids=["norm_res", "norm", "res", "plain"])
def test_dense_matmul_fused_plain_matches_pallas(norm, res):
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas.quant_matmul import dense_matmul_fused_pallas

    rng = np.random.RandomState(41)
    In, Out, M = 128, 128, 8
    x = rng.randn(M, In).astype(np.float32)
    w = rng.randn(In, Out).astype(np.float32)
    nw = (rng.rand(In) + 0.5).astype(np.float32)
    r = rng.randn(M, Out).astype(np.float32)
    # without the norm the contraction splits into two 64-row blocks
    ref = dense_matmul_fused_pallas(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(nw) if norm else None,
                                    jnp.asarray(r) if res else None,
                                    block_in=In if norm else 64, block_out=64, norm=norm,
                                    norm_eps=1e-5, interpret=True)
    xt, wt, nwt, rt = _t(x, w, nw, r)
    out = DK.dense_matmul_fused(xt, wt, nwt if norm else None, rt if res else None, eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("res", [True, False], ids=["res", "no_res"])
def test_dense_mlp_plain_matches_pallas(res):
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas.quant_matmul import dense_mlp_pallas

    rng = np.random.RandomState(51)
    D, F, M = 256, 512, 8
    x = rng.randn(M, D).astype(np.float32)
    r = rng.randn(M, D).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    w13 = (rng.randn(D, 2 * F) * 0.05).astype(np.float32)
    w2 = (rng.randn(F, D) * 0.05).astype(np.float32)
    ref = dense_mlp_pallas(jnp.asarray(x), jnp.asarray(w13), jnp.asarray(w2), jnp.asarray(nw),
                           jnp.asarray(r) if res else None, block_f=128, norm_eps=1e-5,
                           interpret=True)
    xt, w13t, w2t, nwt, rt = _t(x, w13, w2, nw, r)
    out = DK.dense_mlp(xt, w13t, w2t, nwt, rt if res else None, eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dense_routing_rows_hint_m_invariant(monkeypatch, dense_on):
    """tests/test_pallas_kernels.py's routing contract on the port: with the
    same rows_hint a row gets the same bits at M=16 (verify) and M=4 (the
    AR step), on both sides of the kernel / plain-dot boundary; the hint,
    never M, decides which runs."""
    rng = np.random.RandomState(52)
    D, Out = 512, 512
    w, nw, big = _t((rng.randn(D, Out) * 0.05).astype(np.float32),
                    (rng.rand(D) + 0.5).astype(np.float32),
                    rng.randn(16, D).astype(np.float32))
    small = big[:4]
    ran = []
    monkeypatch.setattr(DK, "dense_matmul_fused",
                        lambda *a, _f=DK.dense_matmul_fused, **k: ran.append(a[0].shape[0])
                        or _f(*a, **k))
    for hint, kernel in ((16, True), (600, False)):
        ran.clear()
        yb = Q.dense_matmul(big, w, norm=(nw, 1e-5), rows_hint=hint)
        ys = Q.dense_matmul(small, w, norm=(nw, 1e-5), rows_hint=hint)
        assert ran == ([16, 4] if kernel else [])
        assert torch.equal(yb[:4], ys)


def test_dense_routing_follows_the_jax_package(dense_on):
    """Which function runs: the switch, the backend, the hint, the shape
    predicates and the two budgets, at llama-3.2-1b and llama-3.1-8b widths."""
    x = torch.zeros(4, 2048)
    w = torch.zeros(2048, 3072)
    assert Q.dense_mlp(x, torch.zeros(2048, 16384), torch.zeros(8192, 2048),
                       (torch.ones(2048), 1e-5), rows_hint=0) is None
    for rows, want in ((402, True), (403, False)):  # 1B: dense_mlp's 14 MiB rule
        y = Q.dense_mlp(x, torch.zeros(2048, 16384), torch.zeros(8192, 2048),
                        (torch.ones(2048), 1e-5), rows_hint=rows)
        assert (y is not None) == want
    for rows, want in ((146, True), (147, False)):  # 8B widths
        y = Q.dense_mlp(torch.zeros(4, 4096), torch.zeros(4096, 28672),
                        torch.zeros(14336, 4096), (torch.ones(4096), 1e-5), rows_hint=rows)
        assert (y is not None) == want
    assert Q._pick_block_out(6144, 200, 4096, 4096, 8192, True)
    assert not Q._pick_block_out(6144, 201, 4096, 4096, 8192, True)
    Q.set_matmul_backend("jnp")
    try:
        assert Q.dense_mlp(x, torch.zeros(2048, 16384), torch.zeros(8192, 2048),
                           (torch.ones(2048), 1e-5), rows_hint=8) is None
    finally:
        Q.set_matmul_backend("pallas")
    Q.set_dense_kernels(False)
    assert Q.dense_mlp(x, torch.zeros(2048, 16384), torch.zeros(8192, 2048),
                       (torch.ones(2048), 1e-5), rows_hint=8) is None
    assert torch.equal(Q.dense_matmul(x, w, rows_hint=8), x @ w)


def test_engine_dense_kernels_match_jax(dense_on):
    """tests/test_quantization.py's t512 engine (D=512, so the kernels
    route) with the dense kernels on in both packages and the "pallas"
    backend: the port's spec == AR, and both streams equal the JAX
    engine's, token for token."""
    import jax.numpy as jnp
    from bench import make_params
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.config import ModelConfig as JModelConfig
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    kw = dict(name="t512", block_size=512, vocab_size=256, n_layer=2, n_head=8, n_kv_head=4,
              dim=512, intermediate_size=1024)
    ekw = dict(gamma=3, draft_budget=65, max_seq_len=256, chunk_size=32, sink_size=8,
               max_gen=14, eot_ids=(-1,))
    jcfg = JModelConfig(**kw)
    jparams = make_params(jcfg, dtype=jnp.float32)
    prompt = np.random.RandomState(23).randint(0, 256, size=(2, 64)).astype(np.int32)
    old = JQ._MATMUL_BACKEND
    JQ.set_matmul_backend("pallas")
    JQ.set_dense_kernels(True)
    try:
        jeng = JSpecEngine(jparams, jcfg, JEngineConfig(mode="streamingllm",
                                                        cache_dtype=jnp.float32, **ekw))
        _, jspec = jeng.generate(jeng.encode(jnp.asarray(prompt)))
        _, jbase = jeng.generate_baseline(jeng.encode_baseline(jnp.asarray(prompt)),
                                          max_new=14)
    finally:
        JQ.set_matmul_backend(old)
        JQ.set_dense_kernels(False)
    np_params = {k: ({n: None if a is None else np.asarray(a) for n, a in v.items()}
                     if isinstance(v, dict) else (None if v is None else np.asarray(v)))
                 for k, v in jparams.items()}
    eng = SpecEngine(params_from_jax(np_params), ModelConfig(**kw),
                     EngineConfig(cache_dtype=torch.float32, **ekw), device="cpu")
    launches = []
    fused, mlp = DK.dense_matmul_fused, DK.dense_mlp
    DK.dense_matmul_fused = lambda *a, **k: launches.append("fused") or fused(*a, **k)
    DK.dense_mlp = lambda *a, **k: launches.append("mlp") or mlp(*a, **k)
    try:
        _, spec = eng.generate(eng.encode(prompt))
        _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=14)
    finally:
        DK.dense_matmul_fused, DK.dense_mlp = fused, mlp
    assert {"fused", "mlp"} <= set(launches)
    n = spec["num_committed"].numpy()
    assert n.max() >= 14
    for b in range(2):
        m = min(int(n[b]), 14)
        np.testing.assert_array_equal(spec["output"][b, :m].numpy(), base["output"][b, :m].numpy())
    np.testing.assert_array_equal(spec["output"].numpy(), np.asarray(jspec["output"]))
    np.testing.assert_array_equal(spec["num_committed"].numpy(),
                                  np.asarray(jspec["num_committed"]))
    np.testing.assert_array_equal(base["output"][:, :14].numpy(),
                                  np.asarray(jbase["output"])[:, :14])


# -- dense_matmul_fused's one-launch kernel: plan, host side, sum order -------


@pytest.mark.parametrize("In,Out,norm,want", [
    (2048, 3072, True, (5, 4)),     # wqkv: four boxes with the norm
    (2048, 2048, False, (5, 2)),    # wo
    (2048, 16384, True, (2, 4)),    # w13: 64 column tiles fill the card with 2 splits
    (8192, 2048, False, (5, 2)),    # w2: the cap binds
    (512, 256, False, (4, 2)),
    (128, 128, True, (2, 2)),       # 2 boxes where 4 do not divide Out
])
def test_dense_plan_is_shape_only(In, Out, norm, want):
    """At most 5 splits, none empty, 2 or 4 boxes that divide Out, from the
    weight's shape and the norm (never M); the target's shapes get the
    plans the kernel was measured with."""
    split, boxes = DK.dense_plan(In, Out, norm)
    assert (split, boxes) == want
    tiles = In // 64
    per = -(-tiles // split)
    assert 1 <= split <= DK.DENSE_SPLIT and -(-tiles // per) == split
    assert boxes in (2, 4) and Out % (64 * boxes) == 0


class _FakeLibrary:
    """Records the arguments of md_dense_matmul_sm90 (returns success)."""

    def __init__(self):
        self.calls = []

    def md_dense_matmul_sm90(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("norm,res", [(True, False), (False, True), (True, True)],
                         ids=["norm", "res", "norm_res"])
def test_dense_fused_launch_once_with_a_shape_only_plan(norm, res, monkeypatch):
    """The host side of dense_matmul_fused: one kernel call a wrapper call,
    the plan from the weight's shape at every M from 1 to 512, nothing
    allocated but the output (rows past 512 raise)."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    In, Out = 2048, 3072
    w = torch.zeros(In, Out, dtype=torch.bfloat16)
    nw = torch.ones(In, dtype=torch.bfloat16) if norm else None
    allocated = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocated.append(a) or empty(*a, **k))
    rows = (1, 8, 16, 64, 65, 128, 200, 512)
    for M in rows:
        r = torch.zeros(M, Out, dtype=torch.bfloat16) if res else None
        out = DK._launch_fused(torch.zeros(M, In, dtype=torch.bfloat16), w, nw, r, 1e-5)
        assert out.shape == (M, Out) and out.dtype == torch.bfloat16
    assert allocated == [((M, Out),) for M in rows]
    assert len(lib.calls) == len(rows)
    # x, w, norm_w, res, out, M, In, Out, split, boxes, eps, stream
    assert all(len(c) == 12 for c in lib.calls)
    assert {(c[8], c[9]) for c in lib.calls} == {DK.dense_plan(In, Out, norm)}
    assert DK.dense_plan(In, Out, norm) == ((5, 4) if norm else (5, 2))
    assert [c[5] for c in lib.calls] == list(rows)
    assert all((c[2] is None) != norm and (c[3] is None) != res for c in lib.calls)
    with pytest.raises(ValueError, match="at most 512 rows"):
        DK._launch_fused(torch.zeros(513, In, dtype=torch.bfloat16), w, nw, None, 1e-5)


def _dense_order_model(x, w, norm_w=None, res=None, *, eps=1e-5):
    """dense_matmul_fused's sum order in plain torch: the contraction cut by
    dense_plan; the norm's sum of squares as one partial a split, added in
    split order; each split's f32 partial product, the partials added in
    split order; then the bf16 epilogue."""
    M, In = x.shape
    split, _ = DK.dense_plan(In, w.shape[1], norm_w is not None)
    per = -(-(In // 64) // split) * 64
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
        part = xf[:, k0:k1] @ w[k0:k1].to(torch.float32)
        acc = part if acc is None else acc + part
    y = acc.to(x.dtype)
    return y if res is None else y + res


_DENSE_EPILOGUES = ["norm", "res", "norm_res", "none"]


def _dense_operands(dtype, M=8, In=512, Out=256, seed=61):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, In).astype(np.float32)
    w = (rng.randn(In, Out) / np.sqrt(In)).astype(np.float32)
    nw = (rng.rand(In) + 0.5).astype(np.float32)
    r = rng.randn(M, Out).astype(np.float32)
    td = getattr(torch, dtype)
    return (x, w, nw, r), [t.to(td) for t in _t(x, w, nw, r)]


@pytest.mark.parametrize("epilogue", _DENSE_EPILOGUES)
def test_dense_order_model_matches_plain(epilogue):
    """The split-order model against the plain version in float32, with 4
    splits of 2 tiles (In 512) and of 4 (In 1024) and 5 splits of 7 tiles
    and one of 4 (In 2048, w2's uneven cut)."""
    for In in (512, 1024, 2048):
        _, (x, w, nw, r) = _dense_operands("float32", In=In)
        assert DK.dense_plan(In, 256, "norm" in epilogue)[0] == (5 if In == 2048 else 4)
        kw = dict(norm_w=nw if "norm" in epilogue else None,
                  res=r if "res" in epilogue else None)
        np.testing.assert_allclose(_dense_order_model(x, w, **kw).numpy(),
                                   DK.dense_matmul_fused_plain(x, w, **kw).numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", _DENSE_EPILOGUES)
def test_dense_order_model_matches_pallas(epilogue, dtype):
    """The split-order model against ``_dense_fused_kernel`` in interpret
    mode (4 splits over In 512): float32 to 2e-5, bfloat16 within
    ``kernels.bf16_limit``."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas.quant_matmul import dense_matmul_fused_pallas

    (x, w, nw, r), (tx, tw, tnw, tr) = _dense_operands(dtype)
    norm, res = "norm" in epilogue, "res" in epilogue
    jd = getattr(jnp, dtype)
    ref = dense_matmul_fused_pallas(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                    jnp.asarray(nw, jd) if norm else None,
                                    jnp.asarray(r, jd) if res else None,
                                    block_in=512 if norm else 128, block_out=128, norm=norm,
                                    norm_eps=1e-5, interpret=True)
    got = _dense_order_model(tx, tw, tnw if norm else None, tr if res else None)
    want = np.asarray(ref, dtype=np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        want = torch.from_numpy(want)
        assert ((got.float() - want).abs() <= bf16_limit(want)).all()


def test_dot_variants_apply_to_the_sources():
    """Every variant of the B15 and B4-int4 kernels that dot_variants times
    still patches its source (the tool itself needs the card)."""
    from magicdec_tpu_torch import dot_variants as DV

    for name in DV.VARIANTS:
        text = DV.patched(name)
        assert (text == (DV.CSRC / DV.SOURCES[DV.VARIANTS[name][0]]).read_text()) == (
            not DV.VARIANTS[name][1])


def test_dense_wrappers_never_fall_back():
    x = torch.zeros(4, 512, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(512, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        DK.dense_matmul_fused(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        DK.dense_mlp(x, torch.zeros(512, 512, dtype=torch.bfloat16, device="meta"),
                     torch.zeros(256, 512, dtype=torch.bfloat16, device="meta"),
                     torch.ones(512, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        DK.dense_matmul_fused(x, torch.zeros(512, 256, dtype=torch.bfloat16))


# -- on the card: each kernel against its plain version, bf16 -----------------


def _rand(gen, *shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _fused_case(dot, M, device, seed=None):
    """(run, plain, wrong) of one dense_matmul_fused case at the target's
    widths; wrong drops the norm or the residual."""
    In, Out = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w13": (2048, 16384),
               "w2": (8192, 2048)}[dot.split()[0]]
    gen = torch.Generator(device=device).manual_seed(M if seed is None else seed)
    x = _rand(gen, M, In, device=device, scale=3.0)
    w = _rand(gen, In, Out, device=device, scale=In ** -0.5)
    nw = (torch.rand((In,), generator=gen, device=device) + 0.5).to(torch.bfloat16)
    res = _rand(gen, M, Out, device=device)
    kw = dict(norm_w=nw) if "norm" in dot else dict(res=res)
    return (lambda: DK.dense_matmul_fused(x, w, **kw),
            lambda: DK.dense_matmul_fused_plain(x, w, **kw),
            lambda: DK.dense_matmul_fused_plain(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [128, 16, 8, 512])
@pytest.mark.parametrize("dot", ["wqkv + norm", "wo + residual", "w13 + norm", "w2 + residual"])
def test_dense_matmul_fused_kernel_matches_plain_on_card(cuda, dot, M):
    run, plain, wrong = _fused_case(dot, M, cuda)
    out, ref = run(), plain()
    assert torch.isfinite(out).all() and _outside(out, ref) == 0
    assert _outside(wrong(), ref) > 0  # without the norm / residual


@pytest.mark.gpu
@pytest.mark.parametrize("dot", ["wqkv + norm", "wo + residual", "w13 + norm", "w2 + residual"])
def test_dense_matmul_fused_deterministic_and_graph_replay_on_card(cuda, dot):
    """Two launches bit-equal (split-K added in split order on chip, no
    atomics), and CUDA-graph replay bit-equal to the eager launch."""
    run, _, _ = _fused_case(dot, 128, cuda, seed=3)
    eager = run()
    assert torch.equal(run(), eager)
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
@pytest.mark.parametrize("dot", ["wqkv + norm", "wo + residual", "w13 + norm", "w2 + residual"])
def test_dense_matmul_fused_rows_bit_equal_across_m_on_card(cuda, dot):
    """Row invariance: the rows of an M = 16 call (the AR step at B = 4
    padded) equal the same rows of an M = 128 call bit for bit."""
    In, Out = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w13": (2048, 16384),
               "w2": (8192, 2048)}[dot.split()[0]]
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = _rand(gen, 128, In, device=cuda, scale=3.0)
    w = _rand(gen, In, Out, device=cuda, scale=In ** -0.5)
    nw = (torch.rand((In,), generator=gen, device=cuda) + 0.5).to(torch.bfloat16)
    res = _rand(gen, 128, Out, device=cuda)
    if "norm" in dot:
        big, small = (DK.dense_matmul_fused(x[:m].contiguous(), w, nw) for m in (128, 16))
    else:
        big, small = (DK.dense_matmul_fused(x[:m].contiguous(), w, res=res[:m].contiguous())
                      for m in (128, 16))
    assert torch.equal(big[:16], small)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [128, 16])
def test_dense_mlp_kernel_matches_plain_on_card(cuda, M):
    D, F = 2048, 8192
    gen = torch.Generator(device=cuda).manual_seed(M)
    x, res = _rand(gen, M, D, device=cuda), _rand(gen, M, D, device=cuda)
    w13 = _rand(gen, D, 2 * F, device=cuda, scale=D ** -0.5)
    w2 = _rand(gen, F, D, device=cuda, scale=0.25 * F ** -0.5)
    nw = (torch.rand((D,), generator=gen, device=cuda) + 0.5).to(torch.bfloat16)
    out = DK.dense_mlp(x, w13, w2, nw, res)
    ref = DK.dense_mlp_plain(x, w13, w2, nw, res)
    assert torch.isfinite(out).all() and _outside(out, ref) == 0
    swapped = torch.cat([w13[:, F:], w13[:, :F]], dim=1).contiguous()
    assert _outside(DK.dense_mlp_plain(x, swapped, w2, nw, res), ref) > 0
    assert _outside(DK.dense_mlp_plain(x, w13, w2, nw), ref) > 0
