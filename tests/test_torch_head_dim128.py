"""The attention kernels' head-dim-128 instances in the port (CPU, plain
kernel versions), against the JAX package on numpy inputs made from a seed.

- The plain versions of K1 (the blocked call at T = 4 and 1, the whole-row
  call over a budget-sized cache), K1q, K2 and K2q (with and without the
  chunk's fresh rows), B12's bf16 and int8 pools, and the bf16-scale cases
  of K1q, K2q, B10, B11 and B12's int8 and int4 pools, each against its
  Pallas kernel in interpret mode at head dim 128, within atol = rtol =
  2e-5 (the head-dim-64 tests' tolerance: the kernels scale scores and p,
  the plain versions dequantize first).  Two shapes: llama-3.1-8b's heads
  (32 query, 8 kv: G = 4) and llama-2-7b-32k's (32 and 32: G = 1), each
  instance at both.  At G = 1 the JAX function is the package's plain
  reference (``attend_cache``'s jnp path, a paged pool gathered first),
  except for K1's blocked call, which runs its Pallas kernel there too: a
  Pallas kernel in interpret mode compiles once a (format, shape,
  operands), 3-5 s at 8 kv heads and 12-15 s at 32.
- A tiny head-dim-128 ``SpecEngine`` (StreamingLLM self-speculation) in the
  bench's two formats: the default (an int8 target cache, the draft's int8
  weight copy) and all dense (no KV or draft quantization, float32 caches
  here as the JAX comparisons run them; bf16 on the card): its tokens
  equal to the JAX package's ``SpecEngine`` on the same weights (through
  ``params_from_jax``) and prompts, and greedy spec equal to greedy AR.

The card's tests of the kernels themselves:
tests/test_torch_head_dim128_card.py.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import paged_attention as PGA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV
from test_torch_model import random_params

TOL = dict(atol=2e-5, rtol=2e-5)
HD, L, B, LAYER, S = 128, 2, 2, 1, 256
HEADS = {"G4": (32, 8), "G1": (32, 32)}  # (Hq, Hkv): llama-3.1-8b, llama-2-7b-32k
QUANT = {"int8": (KV.quantize_kv_tokens, 1), "int4": (KV.quantize_kv_tokens_int4, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _torch(a):
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(a):
    import jax.numpy as jnp

    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return jnp.asarray(a.float().numpy(), jnp.bfloat16)
        return jnp.asarray(a.numpy())
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return jnp.asarray(a.astype(np.float32), jnp.bfloat16)
    return jnp.asarray(a)


def _oracle(q, *ops, layer, **fresh):
    """The JAX package's plain reference of every attention kernel:
    ``attend_cache``'s jnp path over the kernel's operands (dense (k, v) or
    quantized (k, ks, v, vs), then a page table if paged, then base_lens;
    the fresh rows by the kernels' keyword names)."""
    from magicdec_tpu.ops.attention import attend_cache

    *ops, base = ops
    table = ops.pop() if ops[-1].ndim == 2 else None
    caches = dict(zip(("k", "v") if len(ops) == 2 else ("k", "ks", "v", "vs"), ops))
    if table is not None:
        caches["table"] = table
    fresh = {n[:-len("_new")]: a for n, a in fresh.items()}
    return attend_cache(q, caches, base, layer=layer, backend="jnp", fresh=fresh or None)


def _compare(jfn, tfn, args, kw, jkw, heads="G4"):
    """The JAX function (the Pallas kernel ``jfn`` in interpret mode; with
    ``heads`` "G1" the package's plain reference) and the port's wrapper
    (its plain version, on CPU tensors) on the same operands."""
    jargs = [_jax(a) for a in args]
    jfresh = {n: _jax(a) for n, a in kw.items()}
    if heads == "G4":
        ref = jfn(*jargs, layer=LAYER, interpret=True, **jkw, **jfresh)
    else:
        ref = _oracle(*jargs, layer=LAYER, **jfresh)
    out = tfn(*(_torch(a) for a in args), layer=LAYER, **{n: _torch(a) for n, a in kw.items()})
    assert out.shape == tuple(ref.shape)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **TOL)


def _dense(rng, Hkv, Sc, base, end):
    """f32 caches [L, B, Sc, Hkv*128]; rows past base + end hold 100 (never
    to be read)."""
    k, v = (rng.randn(L, B, Sc, Hkv * HD).astype(np.float32) for _ in range(2))
    for b, n in enumerate(base):
        k[:, b, n + end:] = v[:, b, n + end:] = 100.0
    return k, v


def _quant(rng, fmt, Hkv, Sc, base, end, bf16_scales=False):
    """int8 (or head-pair-packed int4) caches [L, B, Sc, width] with their
    scales [L, B, Hkv, Sc] quantized from unit-scale values; scales past
    base + end are 1e3 (never to be read)."""
    qz, pack = QUANT[fmt]
    out = []
    for _ in range(2):
        x = rng.randn(L * B, Sc, Hkv, HD).astype(np.float32)
        q, s = qz(torch.from_numpy(x))
        q = q.numpy().reshape(L, B, Sc, Hkv * HD // pack)
        s = s.numpy().reshape(L, B, Hkv, Sc)
        for b, n in enumerate(base):
            s[:, b, :, n + end:] = 1e3
        out += [q, _bf16(s) if bf16_scales else s]
    return out  # k, ks, v, vs


def _fresh_quant(rng, fmt, Hkv, T, bf16_scales=False):
    x = rng.randn(2, B, T, Hkv, HD).astype(np.float32)
    dt = torch.bfloat16 if bf16_scales else torch.float32
    (kn, ksn), (vn, vsn) = (QUANT[fmt][0](torch.from_numpy(x[i]), scale_dtype=dt)
                            for i in range(2))
    return dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)


# -- K1 and K1q ------------------------------------------------------------------


@pytest.mark.parametrize("heads,T,fresh", [("G4", 4, True), ("G1", 1, False)])
def test_k1_blocked_hd128_plain_matches_pallas(heads, T, fresh):
    """The target's verify (T = 4, the window's rows fresh) and AR step (T
    = 1, the cache holding the row) over a 256-row cache in 128-row blocks."""
    from magicdec_tpu.ops.pallas.decode_attention import flash_decode_attend

    rng = np.random.RandomState(T + 10 * fresh)
    Hq, Hkv = HEADS[heads]
    base = np.array([17, S - T], np.int32)
    k, v = _dense(rng, Hkv, S, base, 0 if fresh else T)
    q = rng.randn(B, T, Hq, HD).astype(np.float32)
    kw = dict(zip(("k_new", "v_new"), rng.randn(2, B, T, Hkv * HD).astype(np.float32))) \
        if fresh else {}
    _compare(flash_decode_attend, DA.flash_decode_attend, (q, k, v, base), kw,
             dict(block_s=128))


@pytest.mark.parametrize("heads", ["G4", "G1"])
def test_k1_whole_row_hd128_plain_matches_pallas(heads):
    """The draft's call over its budget-sized cache (one 128-row block of
    the whole row: the Pallas whole-row kernel), T = 1 with its fresh row."""
    from magicdec_tpu.ops.pallas.decode_attention import flash_decode_attend

    rng = np.random.RandomState(3)
    Hq, Hkv = HEADS[heads]
    Sd, base = 128, np.array([100, 127], np.int32)
    k, v = _dense(rng, Hkv, Sd, base, 0)
    q = rng.randn(B, 1, Hq, HD).astype(np.float32)
    kw = dict(zip(("k_new", "v_new"), rng.randn(2, B, 1, Hkv * HD).astype(np.float32)))
    _compare(flash_decode_attend, DA.flash_decode_attend, (q, k, v, base), kw,
             dict(block_s=Sd), heads)


DECODE_QUANT = {"int8": ("flash_decode_attend_quant", DA.flash_decode_attend_quant),
                "int4": ("flash_decode_attend_quant4", DA.flash_decode_attend_quant4)}
PREFILL_QUANT = {"int8": ("flash_prefill_attend_quant", PA.flash_prefill_attend_quant),
                 "int4": ("flash_prefill_attend_quant4", PA.flash_prefill_attend_quant4)}


def _decode_quant_case(fmt, heads, bf16_scales, seed):
    from magicdec_tpu.ops.pallas import decode_attention as JDA

    rng = np.random.RandomState(seed)
    Hq, Hkv = HEADS[heads]
    T, base = 4, np.array([17, S - 4], np.int32)
    caches = _quant(rng, fmt, Hkv, S, base, 0, bf16_scales)
    q = rng.randn(B, T, Hq, HD).astype(np.float32)
    name, tfn = DECODE_QUANT[fmt]
    _compare(getattr(JDA, name), tfn, (q, *caches, base),
             _fresh_quant(rng, fmt, Hkv, T, bf16_scales), dict(block_s=128), heads)


@pytest.mark.parametrize("heads", ["G4", "G1"])
def test_k1q_hd128_plain_matches_pallas(heads):
    """The int8 target's verify, T = 4 with its fresh rows, f32 scales."""
    _decode_quant_case("int8", heads, False, 20)


# -- K2 and K2q ------------------------------------------------------------------

C = 32  # G * C = 128 query rows: one Pallas row block at G = 4


def _both_shapes(*values):
    """(value, heads) cases: each value at G = 4 (id: the value's) and at
    G = 1 (id suffix -G1)."""
    name = {True: "fresh", False: "cached"}
    ids = [name.get(v, v) for v in values]
    return dict(argvalues=[(v, h) for h in HEADS for v in values],
                ids=ids + [i + "-G1" for i in ids])


@pytest.mark.parametrize("fresh,heads", **_both_shapes(True, False))
def test_k2_hd128_plain_matches_pallas(fresh, heads):
    """A 32-token chunk at bases 0 and 100 (a tile straddling base), the
    chunk's rows fresh or already in the cache."""
    from magicdec_tpu.ops.pallas.prefill_attention import flash_prefill_attend

    rng = np.random.RandomState(30 + fresh)
    Hq, Hkv = HEADS[heads]
    base = np.array([0, 100], np.int32)
    k, v = _dense(rng, Hkv, S, base, 0 if fresh else C)
    q = rng.randn(B, C, Hq, HD).astype(np.float32)
    kw = dict(zip(("k_new", "v_new"), rng.randn(2, B, C, Hkv * HD).astype(np.float32))) \
        if fresh else {}
    _compare(flash_prefill_attend, PA.flash_prefill_attend, (q, k, v, base), kw,
             dict(block_s=128, block_r=128), heads)


def _prefill_quant_case(fmt, heads, fresh, bf16_scales, seed):
    from magicdec_tpu.ops.pallas import prefill_attention as JPA

    rng = np.random.RandomState(seed)
    Hq, Hkv = HEADS[heads]
    base = np.array([0, 100], np.int32)
    caches = _quant(rng, fmt, Hkv, S, base, 0 if fresh else C, bf16_scales)
    q = rng.randn(B, C, Hq, HD).astype(np.float32)
    kw = _fresh_quant(rng, fmt, Hkv, C, bf16_scales) if fresh else {}
    name, tfn = PREFILL_QUANT[fmt]
    _compare(getattr(JPA, name), tfn, (q, *caches, base), kw, dict(block_s=128, block_r=128),
             heads)


@pytest.mark.parametrize("fresh,heads", **_both_shapes(True, False))
def test_k2q_hd128_plain_matches_pallas(fresh, heads):
    _prefill_quant_case("int8", heads, fresh, False, 40 + fresh)


# -- B12's pools -----------------------------------------------------------------

PS, NPR, P = 128, 2, 6  # 128-row pages, two a request, a pool of six


def _paged_case(fmt, heads, bf16_scales, seed):
    """B12 through a permuted table, T = 4 with fresh rows."""
    from magicdec_tpu.ops.pallas import paged_attention as JPA

    rng = np.random.RandomState(seed)
    Hq, Hkv = HEADS[heads]
    T = 4
    table = rng.permutation(P)[:B * NPR].reshape(B, NPR).astype(np.int32)
    base = np.array([17, NPR * PS - T], np.int32)
    q = rng.randn(B, T, Hq, HD).astype(np.float32)
    if fmt == "bf16":
        pools = [rng.randn(L, P, PS, Hkv * HD).astype(np.float32) for _ in range(2)]
        kw = dict(zip(("k_new", "v_new"), rng.randn(2, B, T, Hkv * HD).astype(np.float32)))
        jfn, tfn = JPA.flash_paged_decode_attend, PGA.flash_paged_decode_attend
    else:
        width = Hkv * HD // QUANT[fmt][1]
        scale = _bf16 if bf16_scales else (lambda a: a)
        pools = [rng.randint(-127, 128, (L, P, PS, width)).astype(np.int8),
                 scale(rng.uniform(0.01, 0.02, (L, P, Hkv, PS)).astype(np.float32)),
                 rng.randint(-127, 128, (L, P, PS, width)).astype(np.int8),
                 scale(rng.uniform(0.01, 0.02, (L, P, Hkv, PS)).astype(np.float32))]
        kw = _fresh_quant(rng, fmt, Hkv, T, bf16_scales)
        jfn, tfn = ((JPA.flash_paged_decode_attend_quant, PGA.flash_paged_decode_attend_quant)
                    if fmt == "int8" else
                    (JPA.flash_paged_decode_attend_quant4, PGA.flash_paged_decode_attend_quant4))
    _compare(jfn, tfn, (q, *pools, table, base), kw, {}, heads)


@pytest.mark.parametrize("fmt,heads", **_both_shapes("bf16", "int8"))
def test_b12_hd128_plain_matches_pallas(fmt, heads):
    _paged_case(fmt, heads, False, 50 + len(fmt))


# -- bf16 scales -----------------------------------------------------------------


@pytest.mark.parametrize("fmt,heads", **_both_shapes("int8", "int4"))
def test_decode_bf16_scales_hd128_plain_matches_pallas(fmt, heads):
    """K1q and B10 on bf16 scales (the cache's and the fresh rows')."""
    _decode_quant_case(fmt, heads, True, 60 + len(fmt))


@pytest.mark.parametrize("fmt,heads", **_both_shapes("int8", "int4"))
def test_prefill_bf16_scales_hd128_plain_matches_pallas(fmt, heads):
    """K2q and B11 on bf16 scales, the chunk's rows fresh."""
    _prefill_quant_case(fmt, heads, True, True, 70 + len(fmt))


@pytest.mark.parametrize("fmt,heads", **_both_shapes("int8", "int4"))
def test_b12_bf16_scales_hd128_plain_matches_pallas(fmt, heads):
    """B12's int8 and int4 pools on bf16 scale pools."""
    _paged_case(fmt, heads, True, 80 + len(fmt))


# -- a head-dim-128 SpecEngine against the JAX package -----------------------------

# head dim 128 (dim 2 x 128), two query heads on one kv head (G = 2)
ENGINE_KW = dict(vocab_size=128, n_layer=2, n_head=2, n_kv_head=1, dim=256,
                 intermediate_size=256)
ECFG = dict(gamma=3, draft_budget=33, max_seq_len=256, chunk_size=16, sink_size=4,
            max_gen=20, eot_ids=(-1,))
PARAMS = random_params(tcfg.tiny_config(**ENGINE_KW), seed=7)
PREFIX = 96  # past the budget: the sink + window eviction is active


@functools.lru_cache(maxsize=None)
def _engine_runs(quant):
    """(port spec, port AR, JAX spec) stats of StreamingLLM self-speculation
    with an int8 target cache and int8 draft weights (``quant``), or dense
    float32 caches and the shared weights."""
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine

    cfg = tcfg.tiny_config(**ENGINE_KW)
    assert cfg.head_dim == HD
    eng = SpecEngine(params_from_jax(PARAMS), cfg,
                     EngineConfig(mode="streamingllm", cache_dtype=torch.float32,
                                  kv_quant=quant, draft_quant="int8" if quant else False,
                                  **ECFG), device="cpu")
    prompt = np.random.RandomState(9).randint(0, ENGINE_KW["vocab_size"], (B, PREFIX))
    st = eng.encode(prompt)
    assert st.k.shape[-1] == cfg.n_kv_head * HD and st.k.dtype == (torch.int8 if quant else torch.float32)
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=ECFG["max_gen"])
    jparams = {k: ({n: None if a is None else jnp.asarray(a) for n, a in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v)) for k, v in PARAMS.items()}
    jeng = JSpecEngine(jparams, jcfg.tiny_config(**ENGINE_KW),
                       JEngineConfig(mode="streamingllm", kv_quant=quant,
                                     draft_quant="int8" if quant else False,
                                     cache_dtype=jnp.float32, **ECFG))
    _, jspec = jeng.generate(jeng.encode(jnp.asarray(prompt, jnp.int32)))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "dense"])
def test_hd128_engine_matches_jax_and_autoregressive(quant):
    spec, base, jspec = _engine_runs(quant)
    max_gen = ECFG["max_gen"]
    n = spec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(B):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])
    for key in ("output", "num_committed", "target_steps"):
        np.testing.assert_array_equal(spec[key], jspec[key], err_msg=key)
