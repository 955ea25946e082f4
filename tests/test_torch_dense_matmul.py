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
kernel phase, and wrong references that must fail it.

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


# -- on the card: each kernel against its plain version, bf16 -----------------


def _rand(gen, *shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [128, 16, 8])
@pytest.mark.parametrize("dot", ["wqkv + norm", "wo + residual", "w13 + norm", "w2 + residual"])
def test_dense_matmul_fused_kernel_matches_plain_on_card(cuda, dot, M):
    In, Out = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w13": (2048, 16384),
               "w2": (8192, 2048)}[dot.split()[0]]
    gen = torch.Generator(device=cuda).manual_seed(M)
    x = _rand(gen, M, In, device=cuda, scale=3.0)
    w = _rand(gen, In, Out, device=cuda, scale=In ** -0.5)
    nw = (torch.rand((In,), generator=gen, device=cuda) + 0.5).to(torch.bfloat16)
    res = _rand(gen, M, Out, device=cuda)
    kw = dict(norm_w=nw) if "norm" in dot else dict(res=res)
    out = DK.dense_matmul_fused(x, w, **kw)
    ref = DK.dense_matmul_fused_plain(x, w, **kw)
    assert torch.isfinite(out).all() and _outside(out, ref) == 0
    assert _outside(DK.dense_matmul_fused_plain(x, w), ref) > 0  # without the norm / residual


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
