"""bf16 KV-cache scales (``EngineConfig.kv_scale_dtype=torch.bfloat16``,
``--kv_scale bf16``) on the CPU, against the JAX package.

The quantizers with bf16 scales bit for bit; the plain versions of K1q,
B10, K2q, B11 and B12 (int8 and int4 pools) on bf16 scales against the
Pallas kernels in interpret mode (atol = rtol = 2e-5 in float32, as for f32
scales: the kernels scale the scores and p, the plain versions dequantize
first, another rounding order); K3q, B13 and B14 into bf16 scale caches bit
for bit (copies); ``caches_from_jax`` carrying bf16 scales bit for bit; the
engine's tokens (int8 and int4 caches, StreamingLLM and SnapKV drafts) equal
to its autoregressive ones and to the JAX engine's; a paged serve on bf16
scales equal to each request served alone.  The card's tests of the kernels
themselves: tests/test_torch_kv_scale_bf16_card.py.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

from magicdec_tpu_torch.kernels import append as AP
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import paged_attention as PGA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV

TOL = dict(atol=2e-5, rtol=2e-5)
L, B, HKV, HD, LAYER = 2, 4, 2, 64, 1
K = HKV * HD
QUANT = {"int8": (KV.quantize_kv_tokens, 1), "int4": (KV.quantize_kv_tokens_int4, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """numpy f32 -> numpy bfloat16 (round to nearest even, as torch)."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantize_kv_tokens_bf16_scales_match_jax(fmt):
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    x = (np.random.RandomState(0).randn(2, 7, 4, HD) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero head: the 1e-8 clamp
    jfn = jkv.quantize_kv_tokens if fmt == "int8" else jkv.quantize_kv_tokens_int4
    jq, js = jfn(jnp.asarray(x), scale_dtype=jnp.bfloat16)
    q, s = QUANT[fmt][0](torch.from_numpy(x), scale_dtype=torch.bfloat16)
    assert s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))


def _caches(rng, fmt, S, base, T):
    """Quantized caches [L, B, S, width] with bf16 scales [L, B, Hkv, S]
    (about unit scale once dequantized), garbage past each request's visible
    rows (base + T): never to be read."""
    width = K // QUANT[fmt][1]
    k, v = (rng.randint(-127, 128, (L, B, S, width)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.02, (L, B, HKV, S)).astype(np.float32) for _ in range(2))
    for b, n in enumerate(base):
        k[:, b, n + T:], v[:, b, n + T:] = 127, -127
        ks[:, b, :, n + T:] = vs[:, b, :, n + T:] = 1e3
    return k, _bf16(ks), v, _bf16(vs)


def _fresh(rng, fmt, T, Bc=B):
    """A window's rows as the model makes them, with bf16 scales."""
    x = rng.randn(2, Bc, T, HKV, HD).astype(np.float32)
    qz = QUANT[fmt][0]
    (kn, ksn), (vn, vsn) = (qz(torch.from_numpy(x[i]), scale_dtype=torch.bfloat16)
                            for i in range(2))
    return dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)


def _jax(t):
    import jax.numpy as jnp

    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())
    if np.asarray(t).dtype == ml_dtypes.bfloat16:
        return jnp.asarray(np.asarray(t, np.float32), jnp.bfloat16)
    return jnp.asarray(t)


KERNELS = {
    ("decode", "int8"): ("decode_attention", "flash_decode_attend_quant",
                         DA.flash_decode_attend_quant, dict(block_s=128)),
    ("decode", "int4"): ("decode_attention", "flash_decode_attend_quant4",
                         DA.flash_decode_attend_quant4, dict(block_s=128)),
    ("prefill", "int8"): ("prefill_attention", "flash_prefill_attend_quant",
                          PA.flash_prefill_attend_quant, dict(block_s=128, block_r=128)),
    ("prefill", "int4"): ("prefill_attention", "flash_prefill_attend_quant4",
                          PA.flash_prefill_attend_quant4, dict(block_s=128, block_r=128)),
}


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_attention_plain_bf16_scales_match_pallas(kind, fmt, fresh):
    """K1q, B10 (T = 4) and K2q, B11 (C = 64) on bf16 scales against the
    Pallas kernels (interpret), with the window's rows fresh or cached."""
    import importlib

    module, name, tfn, jkw = KERNELS[(kind, fmt)]
    jfn = getattr(importlib.import_module(f"magicdec_tpu.ops.pallas.{module}"), name)
    rng = np.random.RandomState(len(kind) + QUANT[fmt][1] + fresh)
    S, T = 256, (4 if kind == "decode" else 64)
    base = np.array([17, 100, 129, S - T] if kind == "decode" else [0, 64, 101, 192], np.int32)
    caches = _caches(rng, fmt, S, base, 0 if fresh else T)
    q = rng.randn(B, T, HKV * 2, HD).astype(np.float32)
    kw = _fresh(rng, fmt, T) if fresh else {}
    ref = jfn(*(_jax(a) for a in (q, *caches, base)), layer=LAYER, interpret=True, **jkw,
              **{n: _jax(t) for n, t in kw.items()})
    out = tfn(*(_torch(a) for a in (q, *caches, base)), layer=LAYER, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_paged_decode_plain_bf16_scales_match_pallas(fmt):
    """B12's int8 and int4 pools with bf16 scale pools, fresh rows on."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas import paged_attention as JPA

    rng = np.random.RandomState(QUANT[fmt][1])
    Bc, ps, npr, P, T = 3, 128, 3, 12, 4
    table = rng.permutation(P)[: Bc * npr].reshape(Bc, npr).astype(np.int32)
    base = np.array([17, 201, npr * ps - T], np.int32)
    width = K // QUANT[fmt][1]
    pools = [rng.randint(-127, 128, (L, P, ps, width)).astype(np.int8),
             _bf16(rng.uniform(0.01, 0.02, (L, P, HKV, ps))),
             rng.randint(-127, 128, (L, P, ps, width)).astype(np.int8),
             _bf16(rng.uniform(0.01, 0.02, (L, P, HKV, ps)))]
    q = rng.randn(Bc, T, HKV * 2, HD).astype(np.float32)
    kw = _fresh(rng, fmt, T, Bc)
    jfn = JPA.flash_paged_decode_attend_quant if fmt == "int8" else \
        JPA.flash_paged_decode_attend_quant4
    tfn = PGA.flash_paged_decode_attend_quant if fmt == "int8" else \
        PGA.flash_paged_decode_attend_quant4
    ref = jfn(jnp.asarray(q), *(_jax(p) for p in pools), jnp.asarray(table),
              jnp.asarray(base), layer=LAYER, interpret=True,
              **{n: _jax(t) for n, t in kw.items()})
    out = tfn(torch.from_numpy(q), *(_torch(p) for p in pools), torch.from_numpy(table),
              torch.from_numpy(base), layer=LAYER, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _assert_bits(got, want):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want, got.dtype))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_append_bf16_scales_match_pallas_bitwise(fmt):
    """K3q (int8 and packed int4 rows) and B14's scale columns into bf16
    scale caches, against the Pallas appends (interpret), bit for bit."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(30 + QUANT[fmt][1])
    S, T = 128, 4  # the Pallas kernels merge 128-column scale blocks
    width = K // QUANT[fmt][1]
    ck, cv, rk, rv = (rng.randint(-127, 128, shape).astype(np.int8)
                      for shape in [(L, B, S, width)] * 2 + [(L, B, T, width)] * 2)
    sk, sv, srk, srv = (_bf16(rng.rand(*shape))
                        for shape in [(L, B, HKV, S)] * 2 + [(L, B, HKV, T)] * 2)
    pos = np.array([0, 7, 100, S - T], np.int32)
    ops = (ck, cv, rk, rv, pos, sk, sv, srk, srv)
    ref = jkv.append_all_rows_inplace(*(_jax(a) for a in ops), interpret=True)
    out = AP.append_all_rows_inplace(*(_torch(a) for a in ops))
    assert out[2].dtype == torch.bfloat16
    for got, want in zip(out, ref):
        _assert_bits(got, want)
    ref = jkv.append_scale_rows_inplace(_jax(sk), _jax(srk), jnp.asarray(pos), interpret=True)
    _assert_bits(AP.append_scale_rows_inplace(_torch(sk), _torch(srk), torch.from_numpy(pos)),
                 ref)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_paged_append_bf16_scales_match_pallas_bitwise(fmt):
    """B13 into bf16 scale pools, rows past S dropped."""
    from magicdec_tpu.ops.pallas import paged_attention as JPA

    rng = np.random.RandomState(40 + QUANT[fmt][1])
    Bc, ps, npr, P, T = 3, 128, 2, 9, 4
    S = npr * ps
    table = rng.permutation(P)[: Bc * npr].reshape(Bc, npr).astype(np.int32)
    pos = np.array([123, S - T, S - 2], np.int32)
    width = K // QUANT[fmt][1]
    pk, pv = (rng.randint(-128, 128, (L, P, ps, width)).astype(np.int8) for _ in range(2))
    rk, rv = (rng.randint(-128, 128, (L, Bc, T, width)).astype(np.int8) for _ in range(2))
    scales = [_bf16(rng.rand(L, P, HKV, ps)) for _ in range(2)]
    srows = [_bf16(rng.rand(L, Bc, HKV, T)) for _ in range(2)]
    ref = JPA.append_paged_rows_inplace(
        *(_jax(a) for a in (pk, pv, rk, rv, pos, table)), interpret=True,
        **dict(zip(("scale_k", "scale_v", "srows_k", "srows_v"),
                   (_jax(a) for a in scales + srows))))
    out = PGA.append_paged_rows_inplace(*(_torch(a) for a in (pk, pv, rk, rv, pos, table)),
                                        *(_torch(a) for a in scales + srows))
    assert len(out) == 4 and out[2].dtype == torch.bfloat16
    for got, want in zip(out, ref):
        _assert_bits(got, want)


def test_caches_from_jax_bf16_scales_bitwise():
    """JAX int8 caches with bf16 scales -> the port -> numpy, bit for bit:
    the scales stay bf16, a dtype given for the float data leaves them
    alone."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv
    from magicdec_tpu_torch.convert import caches_from_jax

    rng = np.random.RandomState(4)
    kq, ks = jkv.quantize_kv_tokens(jnp.asarray(rng.randn(B, 16, HKV, HD), jnp.float32),
                                    scale_dtype=jnp.bfloat16)
    jax_caches = {"k": np.asarray(kq)[None], "ks": np.asarray(ks)[None],
                  "v": np.asarray(kq)[None], "vs": np.asarray(ks)[None]}
    tc = caches_from_jax(jax_caches, dtype=torch.float32)
    assert tc["k"].dtype == torch.int8 and tc["ks"].dtype == tc["vs"].dtype == torch.bfloat16
    for name in ("ks", "vs"):
        np.testing.assert_array_equal(tc[name].view(torch.int16).numpy(),
                                      jax_caches[name].view(np.int16))


# -- the engine and a paged serve against the JAX package ------------------------


@functools.lru_cache(maxsize=None)
def _engine_runs(kv_quant, mode):
    """(port spec, port AR, JAX spec) stats on tests/test_spec_parity.py's
    weights with the cache's scales in bf16."""
    import jax.numpy as jnp
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    import test_torch_engine as TE
    import test_torch_snapkv as TS

    kw = (dict(TS.ENGINE_KW, mode="snapkv") if mode == "snapkv"
          else dict(TE.ENGINE_KW, mode="streamingllm"))
    kw.update(kv_quant=kv_quant)
    prefix = 40 if mode == "snapkv" else 96
    prompt = np.random.RandomState(5).randint(0, 128, (2, prefix))
    eng = SpecEngine(params_from_jax(TE.PARAMS), TE.TCFG,
                     EngineConfig(cache_dtype=torch.float32, kv_scale_dtype=torch.bfloat16,
                                  **kw), device="cpu")
    st = eng.encode(prompt)
    assert st.ks.dtype == torch.bfloat16
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=kw["max_gen"])
    jparams = {k: ({n: None if a is None else jnp.asarray(a) for n, a in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v)) for k, v in TE.PARAMS.items()}
    jeng = JSpecEngine(jparams, TE.JCFG, JEngineConfig(cache_dtype=jnp.float32,
                                                       kv_scale_dtype=jnp.bfloat16, **kw))
    _, jspec = jeng.generate(jeng.encode(jnp.asarray(prompt, jnp.int32)))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec), kw["max_gen"]


@pytest.mark.parametrize("mode", ["streamingllm", "snapkv"])
@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_engine_bf16_scales_spec_matches_autoregressive_and_jax(kv_quant, mode):
    spec, base, jspec, max_gen = _engine_runs(kv_quant, mode)
    n, jn = spec["num_committed"], jspec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(len(n)):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])
        both = min(int(n[b]), int(jn[b]))
        np.testing.assert_array_equal(spec["output"][b, :both], jspec["output"][b, :both])


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_paged_serve_bf16_scales_equals_solo(kv_quant):
    """A paged serve over bf16 scale pools: each request served alone
    through the same slots gets the tokens it got in the stream."""
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig
    from magicdec_tpu_torch.engine.serving import PagedServingEngine
    import test_torch_serving as TV

    eng = PagedServingEngine(params_from_jax(TV.PARAMS), TV.TCFG,
                             EngineConfig(cache_dtype=torch.float32, kv_quant=kv_quant,
                                          kv_scale_dtype=torch.bfloat16, **TV.ENGINE_KW),
                             device="cpu")
    prompts = TV._prompts()[:3]
    outs = eng.serve(prompts, B=TV.SLOTS, windows_per_sync=2)
    assert eng.last_serve_stats["served"] == 3
    for prompt, out in zip(prompts, outs):
        np.testing.assert_array_equal(eng.serve([prompt], B=TV.SLOTS, windows_per_sync=2)[0],
                                      out)


# -- the host side: the bf16-scale instances' entry points ---------------------------


class _FakeLibrary:
    """Records every C call (returns success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _host_cases(fresh_dtype):
    """(wrapper, its C entry point, its arguments, the fresh rows, where the
    arguments' scales are) of every quantized-KV kernel on bf16 scales (the
    fresh rows' scales in ``fresh_dtype``)."""
    Bc, T, S, ps, npr = 2, 4, 256, 128, 2
    bf = torch.bfloat16
    q = torch.zeros(Bc, T, HKV * 2, HD, dtype=bf)
    base = torch.tensor([0, S - T], dtype=torch.int32)
    cases = []
    for fmt, width in (("int8", K), ("int4", K // 2)):
        c = torch.zeros(L, Bc, S, width, dtype=torch.int8)
        s = torch.zeros(L, Bc, HKV, S, dtype=bf)
        fresh = dict(k_new=torch.zeros(Bc, T, width, dtype=torch.int8),
                     v_new=torch.zeros(Bc, T, width, dtype=torch.int8),
                     ks_new=torch.zeros(Bc, HKV, T, dtype=fresh_dtype),
                     vs_new=torch.zeros(Bc, HKV, T, dtype=fresh_dtype))
        four = "4" if fmt == "int4" else ""
        cases.append((getattr(DA, f"flash_decode_attend_quant{four}"),
                      f"md_decode_attend_quant{four}", (q, c, s, c, s, base), fresh, (2, 4)))
        cases.append((getattr(PA, f"flash_prefill_attend_quant{four}"),
                      f"md_prefill_attend_quant{four}", (q, c, s, c, s, base), fresh, (2, 4)))
        pool = torch.zeros(L, Bc * npr, ps, width, dtype=torch.int8)
        spool = torch.zeros(L, Bc * npr, HKV, ps, dtype=bf)
        table = torch.arange(Bc * npr, dtype=torch.int32).reshape(Bc, npr)
        cases.append((getattr(PGA, f"flash_paged_decode_attend_quant{four}"),
                      f"md_paged_decode_attend_quant{four}",
                      (q, pool, spool, pool, spool, table, base), fresh, (2, 4)))
    rows = torch.zeros(L, Bc, T, K, dtype=torch.int8)
    srows = torch.zeros(L, Bc, HKV, T, dtype=fresh_dtype)
    c = torch.zeros(L, Bc, S, K, dtype=torch.int8)
    s = torch.zeros(L, Bc, HKV, S, dtype=bf)
    cases.append((AP.append_all_rows_inplace_quant, "md_append_rows_quant",
                  (c, c, rows, rows, base, s, s, srows, srows), {}, (5, 6)))
    cases.append((AP.append_scale_rows_inplace, "md_append_scale_cols", (s, srows, base), {},
                  (0,)))
    pool = torch.zeros(L, Bc * npr, ps, K, dtype=torch.int8)
    spool = torch.zeros(L, Bc * npr, HKV, ps, dtype=bf)
    table = torch.arange(Bc * npr, dtype=torch.int32).reshape(Bc, npr)
    cases.append((PGA.append_paged_rows_inplace, "md_append_paged_rows_quant",
                  (pool, pool, rows, rows, base, table, spool, spool, srows, srows), {},
                  (6, 7)))
    return cases


def test_bf16_scale_instances_launch_against_a_fake_library(monkeypatch):
    """Every quantized-KV wrapper on bf16 scales calls its ``_bf16s`` entry
    point once, with the f32 entry point's argument count, and counts the
    launch in ``launches`` and ``bf16_scale_launches``; f32 scales keep the
    f32 entry point; a bf16 cache with f32 fresh scales raises before any
    call (nothing is cast)."""
    from magicdec_tpu_torch import kernels as KN
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    for mod in (DA, PA, PGA, AP):
        monkeypatch.setattr(mod, "on_cpu", lambda *a: False)
    monkeypatch.setattr(KN, "on_cpu", lambda *a: False)
    for fn, entry, args, fresh, _ in _host_cases(torch.bfloat16):
        before = (fn.launches, fn.bf16_scale_launches)
        lib.calls.clear()
        fn(*args, **fresh)
        ((name, cargs),) = lib.calls
        assert name == entry + "_bf16s", (fn.__name__, name)
        assert len(cargs) == len(build.SIGNATURES[name]) == len(build.SIGNATURES[entry])
        assert (fn.launches, fn.bf16_scale_launches) == (before[0] + 1, before[1] + 1)
    for fn, entry, args, fresh, at in _host_cases(torch.float32):
        lib.calls.clear()
        with pytest.raises(TypeError, match="all be float32 or all bfloat16"):
            fn(*args, **fresh)
        assert lib.calls == []
        wide = tuple(a.float() if i in at else a for i, a in enumerate(args))
        fn(*wide, **fresh)
        assert [n for n, _ in lib.calls] == [entry], fn.__name__
