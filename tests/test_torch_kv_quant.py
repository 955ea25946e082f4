"""The port's int8 target KV cache (``EngineConfig.kv_quant``, the bench's
default ``--kv_quant int8``).

On the CPU, against the JAX package: the plain quantized-KV ops bit for bit;
the plain versions of K1q (decode), K2q (prefill) and K3q (append) against
its Pallas kernels in interpret mode; the target pass over int8 caches; the
engine's tokens; the bench's defaults and metric name; K1q's and B10's
split plan and C calls against a fake library.  On the card (``gpu``
marker, skipped without one): each CUDA kernel against its plain version;
K1q's window tokens bit-equal to their autoregressive steps, a cache
poisoned past every visible end, two launches and a graph replay
bit-equal.

Tolerances.  Quantization, dequantization, the scale append and K3q are
exact (copies and the same float32 operations); the int8 rows a model pass
appends may differ by one step where a value lies within float rounding of
a .5 tie (its k and v differ from the JAX pass's in the last bits).  Attention on the CPU:
atol = rtol = 2e-5 in float32 (the same function; the kernels apply the k
scale to the score and the v scale to p, the plain versions dequantize
first: another rounding order).  The target pass: 1e-4 (as the dense pass,
tests/test_torch_model.py).  On the card, in bf16: within
``kernels.bf16_limit``; the kernel run without the window's fresh rows must
fail it.

The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run where JAX is absent:
``python -m pytest tests/test_torch_kv_quant.py -m gpu --noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import bench
from magicdec_tpu_torch.kernels import append as AP
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV

TOL = dict(atol=2e-5, rtol=2e-5)
L, B, HKV, HD = 2, 4, 2, 64
K = HKV * HD
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


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- plain quantized-KV ops vs the JAX package, bit for bit -------------------


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_quantize_kv_tokens_matches_jax(scale_dtype):
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 4, 16) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero head: the 1e-8 clamp
    # amax 127 gives scale 1 (exact in bf16 too): x.5 values are exact ties
    x[1, 3, 0] = np.concatenate([[127.0], np.arange(15) - 7 + 0.5])
    x[1, 3, 1] = -x[1, 3, 0]
    jq, js = jkv.quantize_kv_tokens(jnp.asarray(x), scale_dtype=getattr(jnp, scale_dtype))
    tq, ts = KV.quantize_kv_tokens(torch.from_numpy(x), scale_dtype=getattr(torch, scale_dtype))
    assert tq.dtype == torch.int8 and ts.dtype == getattr(torch, scale_dtype)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, dtype=np.float32))
    # round half to even: -6.5 -> -6, -5.5 -> -6, ..., 0.5 -> 0, 1.5 -> 2
    ties = tq.reshape(2, 5, 4, 16)[1, 3, 0, 1:].numpy()
    np.testing.assert_array_equal(ties, np.round(np.arange(15) - 7 + 0.5))
    assert (tq.reshape(2, 5, 4, 16)[0, 1, 2] == 0).all()


def test_dequant_kv_matches_jax():
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(1)
    q = rng.randint(-127, 128, (3, 40, K)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, (3, HKV, 40)).astype(np.float32)
    ref = jkv.dequant_kv(jnp.asarray(q), jnp.asarray(s), HD)
    np.testing.assert_array_equal(KV.dequant_kv(*_t(q, s), HD).numpy(), np.asarray(ref))


def test_append_scale_rows_matches_jax():
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(2)
    S, T = 32, 5
    scale = rng.rand(L, B, HKV, S).astype(np.float32)
    rows = rng.rand(L, B, HKV, T).astype(np.float32)
    pos = np.array([0, 9, S - T, S + 3], np.int32)  # the last clamps to S - T
    ref = jkv.append_scale_rows_all_layers(jnp.asarray(scale), jnp.asarray(rows),
                                           jnp.asarray(pos))
    got = KV.append_scale_rows_all_layers(*_t(scale, rows, pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- plain versions of K1q, K2q, K3q vs the Pallas kernels (interpret) --------


def _quant_caches(rng, S, base, T):
    """int8 caches [L, B, S, K] with f32 scales [L, B, Hkv, S] (dequantized
    values about unit scale), holding garbage past each request's visible
    rows (base + T): int8 +-127 with scales 1e3, never to be read."""
    k = rng.randint(-127, 128, (L, B, S, K)).astype(np.int8)
    v = rng.randint(-127, 128, (L, B, S, K)).astype(np.int8)
    ks = rng.uniform(0.01, 0.02, (L, B, HKV, S)).astype(np.float32)
    vs = rng.uniform(0.01, 0.02, (L, B, HKV, S)).astype(np.float32)
    for b, n in enumerate(base):
        k[:, b, n + T:], v[:, b, n + T:] = 127, -127
        ks[:, b, :, n + T:] = vs[:, b, :, n + T:] = 1e3
    return k, v, ks, vs


def _fresh(rng, T):
    """A window's rows as the model makes them: quantize_kv_tokens of
    unit-scale values (int8 [B, T, K], f32 scales [B, Hkv, T])."""
    x = rng.randn(2, B, T, HKV, HD).astype(np.float32)
    kn, ksn = KV.quantize_kv_tokens(torch.from_numpy(x[0]))
    vn, vsn = KV.quantize_kv_tokens(torch.from_numpy(x[1]))
    return kn.numpy(), vn.numpy(), ksn.numpy(), vsn.numpy()


def _attn_case(jfn, tfn, rng, S, G, T, base, fresh, **jkw):
    import jax.numpy as jnp

    k, v, ks, vs = _quant_caches(rng, S, base, 0 if fresh else T)
    q = rng.randn(B, T, HKV * G, HD).astype(np.float32)
    fresh_ops = dict(zip(("k_new", "v_new", "ks_new", "vs_new"), _fresh(rng, T)))
    kw_j = {n: jnp.asarray(a) for n, a in fresh_ops.items()} if fresh else {}
    ref = jfn(*(jnp.asarray(a) for a in (q, k, ks, v, vs, base)), layer=LAYER,
              interpret=True, **jkw, **kw_j)
    kw_t = {n: torch.from_numpy(a) for n, a in fresh_ops.items()} if fresh else {}
    out = tfn(*_t(q, k, ks, v, vs, base), layer=LAYER, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_decode_quant_plain_matches_pallas(T, fresh):
    from magicdec_tpu.ops.pallas.decode_attention import flash_decode_attend_quant

    S = 256
    base = np.array([17, 100, 200, S - T], np.int32)
    _attn_case(flash_decode_attend_quant, DA.flash_decode_attend_quant,
               np.random.RandomState(10 + T), S, 2, T, base, fresh, block_s=128)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_prefill_quant_plain_matches_pallas(fresh):
    from magicdec_tpu.ops.pallas.prefill_attention import flash_prefill_attend_quant

    S, C = 256, 64  # G*C = 128: the Pallas kernel's row block
    base = np.array([0, 64, 100, 192], np.int32)
    _attn_case(flash_prefill_attend_quant, PA.flash_prefill_attend_quant,
               np.random.RandomState(20), S, 2, C, base, fresh, block_s=128, block_r=128)


@pytest.mark.parametrize("T", [1, 4, 13])
def test_append_quant_plain_matches_pallas_bitwise(T):
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    S = 128  # the Pallas kernel merges 128-column scale blocks
    rng = np.random.RandomState(T)
    ck, cv, rk, rv = (rng.randint(-127, 128, shape).astype(np.int8)
                      for shape in [(L, B, S, K)] * 2 + [(L, B, T, K)] * 2)
    sk, sv, srk, srv = (rng.rand(*shape).astype(np.float32)
                        for shape in [(L, B, HKV, S)] * 2 + [(L, B, HKV, T)] * 2)
    pos = np.array([0, 7, 100, S - T], np.int32)
    ref = jkv.append_all_rows_inplace(*(jnp.asarray(a) for a in (ck, cv, rk, rv, pos,
                                                                  sk, sv, srk, srv)),
                                      interpret=True)
    out = AP.append_all_rows_inplace(*_t(ck, cv, rk, rv, pos, sk, sv, srk, srv))
    assert len(out) == 4
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K1q's and B10's host side: the split plan and one C call a launch -------


@pytest.mark.parametrize("Hkv", [8, 6, 3])
@pytest.mark.parametrize("S", [256, 8704])
@pytest.mark.parametrize("Bc", [1, 2, 16, 32])
def test_quant_split_plan_covers_each_position_once(Bc, S, Hkv):
    """K1q's and B10's plan (a block a pair of kv heads, or one when Hkv is
    odd): whole 64-position rounds a split, the splits cover [0, S) exactly
    once (none empty), a wave's worth of blocks at most, and the same plan
    whatever the window length."""
    nsplit, chunk = DA.quant_split_plan(Bc, Hkv, S)
    assert chunk % DA.PLAN_ROUND == 0 and nsplit >= 1
    assert (nsplit - 1) * chunk < S <= nsplit * chunk
    assert DA.quant_heads(Hkv) == {8: 2, 6: 2, 3: 1}[Hkv]
    blocks = Bc * Hkv // DA.quant_heads(Hkv)
    assert nsplit == 1 or blocks * nsplit <= DA.PLAN_BLOCKS
    plans = set()
    for T in (1, 4, 16):
        q = torch.zeros(Bc, T, 4 * Hkv, HD, dtype=torch.bfloat16)
        n, c, part_o, part_ml = DA.split_buffers(q, Hkv, S, quant=True)
        plans.add((n, c))
        R = DA.rows_pad(4 * T)
        assert (part_o is None) == (n == 1) == (part_ml is None)
        if n > 1:
            assert part_o.shape == (Bc, Hkv, n, R, HD) and part_ml.shape == (Bc, Hkv, n, R, 2)
            assert part_o.dtype == part_ml.dtype == torch.float32
    assert plans == {(nsplit, chunk)}


class _FakeQuantLibrary:
    """Records the arguments of the quantized decode entry points (returns
    success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("md_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_decode_quant_launch_once_against_a_fake_library(packed, fresh, monkeypatch):
    """K1q's and B10's host side: one C call a wrapper call with the C
    signature kept (q, k, v, k_scale, v_scale, the four fresh operands or
    null, base_lens, out, part_o, part_ml, layer, B, S, T, Hq, Hkv, hd,
    nsplit, chunk, stream), the plan of quant_split_plan and partials sized
    from it (null with one split), one launch counted; a failed launch
    raises."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeQuantLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(DA, "on_cpu", lambda *a: False)
    fn = DA.flash_decode_attend_quant4 if packed else DA.flash_decode_attend_quant
    entry = "md_decode_attend_quant4" if packed else "md_decode_attend_quant"
    Hkv, G, T = 8, 4, 4
    width = Hkv * HD // (2 if packed else 1)
    for Bc, S in ((2, 8704), (32, 256)):
        q = torch.zeros(Bc, T, Hkv * G, HD, dtype=torch.bfloat16)
        k, v = (torch.zeros(L, Bc, S, width, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.zeros(L, Bc, Hkv, S) for _ in range(2))
        kw = {}
        if fresh:
            kw = dict(k_new=torch.zeros(Bc, T, width, dtype=torch.int8),
                      v_new=torch.zeros(Bc, T, width, dtype=torch.int8),
                      ks_new=torch.zeros(Bc, Hkv, T), vs_new=torch.zeros(Bc, Hkv, T))
        base = torch.tensor([0] * (Bc - 1) + [S - T], dtype=torch.int64)
        before = fn.launches
        lib.calls.clear()
        out = fn(q, k, ks, v, vs, base, layer=LAYER, **kw)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert fn.launches == before + 1
        ((name, args),) = lib.calls
        assert name == entry and len(args) == len(build.SIGNATURES[entry]) == 23
        assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                            vs.data_ptr())
        assert all((a is None) == (not fresh) for a in args[5:9])
        assert args[10] == out.data_ptr()
        nsplit, chunk = DA.quant_split_plan(Bc, Hkv, S)
        assert (args[11] is None) == (args[12] is None) == (nsplit == 1)
        assert args[13:] == (LAYER, Bc, S, T, Hkv * G, Hkv, HD, nsplit, chunk, 7)
    failing = _FakeQuantLibrary()
    setattr(failing, entry, lambda *a: 1)
    monkeypatch.setattr(build, "library", lambda: failing)
    with pytest.raises(RuntimeError, match=entry):
        fn(q, k, ks, v, vs, base, layer=LAYER, **kw)


# -- model pass and engine vs the JAX package -------------------------------


def test_forward_target_int8_cache_matches_jax():
    """A 32-token prefill chunk, then a verify (T=4) and a decode (T=1)
    window at ragged lengths, over int8 caches.  Each window starts both
    packages from the same caches (the JAX pass's, moved across bit for
    bit): hidden states and logits agree to 1e-4, tokens exactly, and so do
    the appended caches and scales (int8 rows within the one-step rule)."""
    import jax.numpy as jnp
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy
    from magicdec_tpu_torch.models import llama as TM
    from test_torch_model import JCFG, TCFG, _both_params

    rng = np.random.RandomState(3)
    jp, tp = _both_params(True)
    Bm, S, Km = 2, 96, JCFG.n_kv_head * JCFG.head_dim
    caches = {"k": np.zeros((JCFG.n_layer, Bm, S, Km), np.int8),
              "ks": np.zeros((JCFG.n_layer, Bm, JCFG.n_kv_head, S), np.float32)}
    caches["v"], caches["vs"] = caches["k"].copy(), caches["ks"].copy()
    for T, base, head in ((32, [0, 0], "none"), (4, [32, 20], "logits"),
                          (1, [36, 24], "logits")):
        tokens = rng.randint(0, JCFG.vocab_size, size=(Bm, T)).astype(np.int32)
        base = np.array(base, np.int32)
        yj, jc = JM.forward_target(jp, JCFG, jnp.asarray(tokens), jnp.asarray(base),
                                   {n: jnp.asarray(a) for n, a in caches.items()}, head=head)
        yt, tc = TM.forward_target(tp, TCFG, torch.from_numpy(tokens),
                                   torch.from_numpy(base), caches_from_jax(caches), head=head)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
        if head == "logits":
            np.testing.assert_array_equal(yt.argmax(-1).numpy(), np.asarray(yj).argmax(-1))
        got = caches_to_numpy(tc)
        caches = {n: np.asarray(a) for n, a in jc.items()}
        assert got["k"].dtype == np.int8 and got["ks"].dtype == np.float32
        for name in ("ks", "vs"):
            np.testing.assert_allclose(got[name], caches[name], rtol=1e-5, atol=0,
                                       err_msg=name)
        # int8 data: a value whose x / scale lies within float rounding of a
        # .5 tie may round the other way, since the two packages' k and v
        # differ in the last bits: one step at most, in at most 0.1% of the
        # entries (1 of 12288 at this seed)
        for name in ("k", "v"):
            diff = np.abs(got[name].astype(np.int32) - caches[name].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name


@functools.lru_cache(maxsize=None)
def _engine_runs(prefix):
    """(port spec, port AR, JAX spec, JAX AR) stats at ``prefix`` with an
    int8 target cache, on tests/test_spec_parity.py's weights."""
    import jax.numpy as jnp
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from test_torch_engine import ENGINE_KW, JCFG, MAX_GEN, PARAMS, TCFG, _prompt

    eng = SpecEngine(params_from_jax(PARAMS), TCFG,
                     EngineConfig(cache_dtype=torch.float32, kv_quant=True, **ENGINE_KW),
                     device="cpu")
    prompt = _prompt(prefix)
    st = eng.encode(prompt)
    assert st.k.dtype == torch.int8 and st.ks.dtype == torch.float32
    assert st.dk.dtype == torch.float32  # the draft cache stays in cache_dtype
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=MAX_GEN)
    jparams = {k: ({n: None if a is None else jnp.asarray(a) for n, a in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v)) for k, v in PARAMS.items()}
    jeng = JSpecEngine(jparams, JCFG, JEngineConfig(mode="streamingllm", kv_quant=True,
                                                    cache_dtype=jnp.float32, **ENGINE_KW))
    jprompt = jnp.asarray(prompt, jnp.int32)
    _, jspec = jeng.generate(jeng.encode(jprompt))
    _, jbase = jeng.generate_baseline(jeng.encode_baseline(jprompt), max_new=MAX_GEN)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec), as_np(jbase), MAX_GEN


# prefix 32 < budget: the draft cache is the full cache; 96 > budget: the
# sink+window eviction is active
PREFIXES = [32, 96]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_int8_engine_spec_matches_autoregressive(prefix):
    spec, base, _, _, max_gen = _engine_runs(prefix)
    n = spec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(len(n)):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])


@pytest.mark.parametrize("prefix", PREFIXES)
def test_int8_engine_matches_jax(prefix):
    spec, base, jspec, jbase, max_gen = _engine_runs(prefix)
    for key in ("output", "num_committed", "target_steps"):
        np.testing.assert_array_equal(spec[key], jspec[key], err_msg=key)
    np.testing.assert_array_equal(base["output"][:, :max_gen], jbase["output"][:, :max_gen])


def test_int8_bench_protocol_acceptance():
    """The bench's synthetic-weight gate (tests/test_torch_engine.py) with
    the int8 target cache: >= 2.5 tokens per gamma=3 window."""
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tcfg.tiny_config(vocab_size=1024, n_layer=4, n_head=8, n_kv_head=4,
                           dim=256, intermediate_size=512)
    eng = SpecEngine(bench.make_params(cfg, device="cpu"), cfg,
                     EngineConfig(gamma=3, draft_budget=257, max_seq_len=1024,
                                  chunk_size=128, max_gen=64, eot_ids=(-1,),
                                  cache_dtype=torch.bfloat16, kv_quant="int8"),
                     device="cpu")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 768))
    _, stats = eng.generate(eng.encode(prompt))
    steps = int(stats["target_steps"])
    assert steps > 0
    rate = int(stats["gen_tokens"].sum()) / steps / 4
    assert rate >= 2.5, f"int8-KV synthetic-weight protocol collapsed: {rate:.2f} tokens/step"


@pytest.mark.parametrize("kw", [
    dict(kv_quant="int4", kv_scale_dtype=torch.bfloat16),
    dict(kv_quant=True, kv_scale_dtype=torch.bfloat16),
], ids=["int4_bf16_scales", "bf16_scales"])
def test_engine_bf16_scale_configs_run(kw):
    """The int8 and int4 caches with bf16 scales (``--kv_scale bf16``):
    the engine builds, keeps its scales in bf16 through an encode and a
    generate, and its spec tokens equal its autoregressive ones
    (tests/test_torch_kv_scale_bf16.py holds them against the JAX
    engine)."""
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config()
    eng = SpecEngine(bench.make_params(cfg, device="cpu"), cfg,
                     EngineConfig(draft_budget=257, max_seq_len=512, chunk_size=128,
                                  max_gen=8, cache_dtype=torch.float32, **kw), device="cpu")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 300))
    st = eng.encode(prompt)
    assert st.ks.dtype == st.vs.dtype == torch.bfloat16
    st, spec = eng.generate(st)
    assert st.ks.dtype == torch.bfloat16
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=8)
    for b in range(2):
        m = min(int(spec["num_committed"][b]), 8)
        assert m > 0
        assert torch.equal(spec["output"][b, :m], base["output"][b, :m])


# -- bench defaults and conversion ------------------------------------------


def test_bench_defaults_and_metric_tag():
    args = bench.parse_args([])
    assert (args.kv_quant, args.kv_scale, args.draft_quant) == ("int8", "f32", "int8")
    assert (args.draft_head, args.quant_backend) == ("quant", "pallas")
    assert bench.metric_name(args) == \
        "selfspec_streamingllm_tokens_per_s_llama-3.2-1b_kvq8_dq8_B32_ctx8192_torch"
    assert bench.metric_name(bench.parse_args(["--kv_quant", "none", "--draft_quant",
                                               "none"])) == \
        "selfspec_streamingllm_tokens_per_s_llama-3.2-1b_B32_ctx8192_torch"
    assert bench.parse_args(["--kv_quant"]).kv_quant == "int8"
    assert bench.parse_args(["--draft_quant"]).draft_quant == "int8"


@pytest.mark.parametrize("argv", [
    ["--kv_scale", "bf16"], ["--kv_quant", "int4", "--kv_scale", "bf16"],
], ids=lambda a: "_".join(a).replace("--", "").strip("_"))
def test_bench_bf16_scale_paths_set_up(argv):
    """``bench --kv_scale bf16`` (int8, and int4) builds its engine with bf16
    scale caches, which an encode fills."""
    engine, prompts = bench.setup(bench.parse_args(
        argv + ["--device", "cpu", "--model", "68m", "--B", "2", "--prefix_len", "256",
                "--draft_budget", "257", "--prefill_chunk", "128", "--max_gen", "8",
                "--iters", "1", "--draft_quant", "none"]))
    assert engine.ecfg.kv_scale_dtype == torch.bfloat16
    st = engine.encode(prompts[0])
    assert st.ks.dtype == st.vs.dtype == torch.bfloat16 and st.k.dtype == torch.int8


def test_convert_int8_caches_round_trip_bitwise():
    """JAX int8 caches and f32 scales -> the port -> numpy, bit for bit; a
    dtype given for the float data leaves them alone."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy

    rng = np.random.RandomState(4)
    kq, ks = jkv.quantize_kv_tokens(jnp.asarray(rng.randn(B, 16, HKV, HD), jnp.float32))
    dk = jnp.asarray(rng.randn(1, B, 8, K), jnp.bfloat16)
    jax_caches = {"k": np.asarray(kq)[None], "ks": np.asarray(ks)[None],
                  "v": np.asarray(kq)[None], "vs": np.asarray(ks)[None], "dk": np.asarray(dk)}
    tc = caches_from_jax(jax_caches, dtype=torch.bfloat16)
    assert tc["k"].dtype == torch.int8 and tc["ks"].dtype == torch.float32
    assert tc["dk"].dtype == torch.bfloat16
    back = caches_to_numpy(tc)
    for name in ("k", "v", "ks", "vs"):
        assert back[name].dtype == jax_caches[name].dtype
        np.testing.assert_array_equal(back[name], jax_caches[name], err_msg=name)
    np.testing.assert_array_equal(back["dk"], np.asarray(dk, dtype=np.float32))


def test_quant_wrappers_never_fall_back():
    q = torch.zeros(1, 1, 2, HD, device="meta")
    c = torch.zeros(1, 1, 8, HD, dtype=torch.int8, device="meta")
    s = torch.zeros(1, 1, 1, 8, device="meta")
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    for fn in (DA.flash_decode_attend_quant, PA.flash_prefill_attend_quant):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, c, s, c, s, lens)
    with pytest.raises(ValueError, match="several devices"):
        AP.append_all_rows_inplace(c, c, c[:, :, :1], c[:, :, :1], torch.zeros(1),
                                   s, s, s[..., :1], s[..., :1])


# -- on the card: CUDA kernel vs plain version --------------------------------


def _quant_cache_on_card(gen, Lc, Bc, S, Hkv, device):
    """int8 cache [Lc, Bc, S, Hkv*HD] and scales [Lc, Bc, Hkv, S] quantized
    from bf16 randn by the port's quantize_kv_tokens (realistic scales)."""
    x = torch.randn((Lc * Bc, S, Hkv, HD), generator=gen, device=device).to(torch.bfloat16)
    q, s = KV.quantize_kv_tokens(x)
    return q.reshape(Lc, Bc, S, Hkv * HD), s.reshape(Lc, Bc, Hkv, S)


def _fresh_on_card(gen, Bc, T, Hkv, device):
    x = torch.randn((2, Bc, T, Hkv, HD), generator=gen, device=device).to(torch.bfloat16)
    (kn, ksn), (vn, vsn) = KV.quantize_kv_tokens(x[0]), KV.quantize_kv_tokens(x[1])
    return dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _card_attn_case(fn, plain, gen, cuda, S, T, base):
    Bc, Hkv, G = len(base), 8, 4
    k, ks = _quant_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    v, vs = _quant_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    q = torch.randn((Bc, T, Hkv * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    base = torch.tensor(base, dtype=torch.int32, device=cuda)
    for kw in ({}, _fresh_on_card(gen, Bc, T, Hkv, cuda)):
        out = fn(q, k, ks, v, vs, base, layer=LAYER, **kw)
        ref = plain(q, k, ks, v, vs, base, layer=LAYER, **kw)
        assert torch.isfinite(out).all()
        assert _outside(out, ref) == 0
    # without its fresh rows the kernel reads the cache where they belong
    assert _outside(fn(q, k, ks, v, vs, base, layer=LAYER), ref) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 8704])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_decode_quant_kernel_matches_plain_on_card(cuda, T, S):
    gen = torch.Generator(device=cuda).manual_seed(T)
    _card_attn_case(DA.flash_decode_attend_quant, DA.flash_decode_attend_quant_plain, gen,
                    cuda, S, T, [0, S // 3, S - T])


def _decode_operands(gen, cuda, S, T, base, quant=_quant_cache_on_card, Hkv=8):
    """(q, caches (k, ks, v, vs), fresh rows, base) of a decode case on the
    card: len(base) requests, Hkv kv heads, G = 4."""
    Bc, G = len(base), 4
    k, ks = quant(gen, L, Bc, S, Hkv, cuda)
    v, vs = quant(gen, L, Bc, S, Hkv, cuda)
    fk, fks = quant(gen, 1, Bc, T, Hkv, cuda)
    fv, fvs = quant(gen, 1, Bc, T, Hkv, cuda)
    q = torch.randn((Bc, T, Hkv * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    return q, (k, ks, v, vs), fresh, torch.tensor(base, dtype=torch.int32, device=cuda)


def window_equals_steps(fn, q, caches, fresh, base):
    """Token t of the window (its fresh rows at [base, base + T)) against a
    T = 1 call at base + t over a cache that holds the window's rows before
    t, with fresh row t: bit for bit.  caches: (k, k_scale, v, v_scale)
    quantized, or (k, v) in bf16."""
    window = fn(q, *caches, base, layer=LAYER, **fresh)
    for t in range(q.shape[1]):
        cs = [c.clone() for c in caches]
        for b, n in enumerate(base.tolist()):
            cs[0][LAYER, b, n:n + t] = fresh["k_new"][b, :t]
            cs[len(cs) // 2][LAYER, b, n:n + t] = fresh["v_new"][b, :t]
            if len(cs) == 4:
                cs[1][LAYER, b, :, n:n + t] = fresh["ks_new"][b, :, :t]
                cs[3][LAYER, b, :, n:n + t] = fresh["vs_new"][b, :, :t]
        step = fn(q[:, t:t + 1], *cs, base + t, layer=LAYER,
                  **{n: (a[:, :, t:t + 1] if n in ("ks_new", "vs_new") else a[:, t:t + 1])
                     .contiguous() for n, a in fresh.items()})
        assert torch.equal(window[:, t:t + 1], step), f"token {t}"


def poisoned_cache_matches_clean(fn, plain, q, caches, fresh, base):
    """Rows past every visible end (base with the fresh rows, base + T
    without) set to -128 and their scales to inf and NaN: the kernel never
    reads them, so its output is the clean cache's bit for bit, finite and
    within bf16_limit of the plain version on the clean cache."""
    T = q.shape[1]
    for kw, end in ((fresh, 0), ({}, T)):
        k, ks, v, vs = (c.clone() for c in caches)
        for b, n in enumerate(base.tolist()):
            k[:, b, n + end:] = -128
            v[:, b, n + end:] = -128
            ks[:, b, :, n + end:] = float("inf")
            vs[:, b, :, n + end:] = float("nan")
        out = fn(q, k, ks, v, vs, base, layer=LAYER, **kw)
        assert torch.isfinite(out).all()
        assert torch.equal(out, fn(q, *caches, base, layer=LAYER, **kw))
        assert _outside(out, plain(q, *caches, base, layer=LAYER, **kw)) == 0


def deterministic_and_graph_replay(fn, q, caches, fresh, base):
    """Two launches bit-equal, and a CUDA graph's replay bit-equal to the
    eager launch (the split partials and their scratch included)."""
    def run():
        return fn(q, *caches, base, layer=LAYER, **fresh)
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
def test_decode_quant_window_equals_step_on_card(cuda):
    """K1q: a verify window's token t has the bits of the autoregressive
    step at base + t (the split plan, warps and tiles depend on the static
    shapes only), at bases 0, S // 3 and S - T of an 8704-row cache."""
    S, T = 8704, 4
    gen = torch.Generator(device=cuda).manual_seed(40)
    q, caches, fresh, base = _decode_operands(gen, cuda, S, T, [0, S // 3, S - T])
    window_equals_steps(DA.flash_decode_attend_quant, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv", [6, 3])
def test_decode_quant_kernel_head_groups_on_card(cuda, Hkv):
    """Three pair blocks a request (Hkv = 6), and the blocks of one int8
    head (Hkv odd): within bf16_limit of the plain version, and a window's
    tokens bit-equal to their steps."""
    S, T = 1024, 4
    gen = torch.Generator(device=cuda).manual_seed(43 + Hkv)
    kinds = [(DA.flash_decode_attend_quant, DA.flash_decode_attend_quant_plain,
              _quant_cache_on_card)]
    if Hkv % 2 == 0:
        from test_torch_kv_int4 import _int4_cache_on_card

        kinds.append((DA.flash_decode_attend_quant4, DA.flash_decode_attend_quant4_plain,
                      _int4_cache_on_card))
    for fn, plain, quant in kinds:
        q, caches, fresh, base = _decode_operands(gen, cuda, S, T, [0, 300, S - T], quant, Hkv)
        for kw in ({}, fresh):
            out = fn(q, *caches, base, layer=LAYER, **kw)
            assert _outside(out, plain(q, *caches, base, layer=LAYER, **kw)) == 0
        window_equals_steps(fn, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 8704])
def test_decode_quant_kernel_poisoned_cache_on_card(cuda, S):
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, caches, fresh, base = _decode_operands(gen, cuda, S, 4, [0, S // 3, S - 4])
    poisoned_cache_matches_clean(DA.flash_decode_attend_quant,
                                 DA.flash_decode_attend_quant_plain, q, caches, fresh, base)


@pytest.mark.gpu
def test_decode_quant_kernel_deterministic_and_graph_replay_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(42)
    q, caches, fresh, base = _decode_operands(gen, cuda, 8704, 4, [0, 2900, 8700])
    deterministic_and_graph_replay(DA.flash_decode_attend_quant, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 200, 512])
def test_prefill_quant_kernel_matches_plain_on_card(cuda, C):
    """Ragged chunks (C = 200: rows not a multiple of the 128-row block) at
    bases that start a 128-column tile (0), straddle one (37, 300, S - C -
    5: the tile takes cache rows below base and fresh rows from it on), with
    and without fresh rows."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    S = 1024
    _card_attn_case(PA.flash_prefill_attend_quant, PA.flash_prefill_attend_quant_plain, gen,
                    cuda, S, C, [0, 37, 300, S - C - 5])


def _prefill_quant_operands(cuda, C=200, S=1024):
    gen = torch.Generator(device=cuda).manual_seed(11)
    Bc, Hkv, G = 3, 8, 4
    k, ks = _quant_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    v, vs = _quant_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    fk, fks = _quant_cache_on_card(gen, 1, Bc, C, Hkv, cuda)
    fv, fvs = _quant_cache_on_card(gen, 1, Bc, C, Hkv, cuda)
    q = torch.randn((Bc, C, Hkv * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    base = torch.tensor([0, 300, S - C - 5], dtype=torch.int32, device=cuda)
    fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    return lambda: PA.flash_prefill_attend_quant(q, k, ks, v, vs, base, layer=LAYER, **fresh)


@pytest.mark.gpu
def test_prefill_quant_kernel_deterministic_on_card(cuda):
    """Two launches on the same inputs are bit-equal (no atomics, no split
    of the KV range): encode and encode_baseline start from the same bits."""
    run = _prefill_quant_operands(cuda)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.gpu
def test_prefill_quant_graph_replay_matches_eager_on_card(cuda):
    """Captured in a CUDA graph, the kernel's replay is bit-equal to its
    eager launch (the tensor maps are encoded at capture)."""
    run = _prefill_quant_operands(cuda)
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
def test_append_quant_kernel_matches_plain_on_card(cuda, T):
    gen = torch.Generator(device=cuda).manual_seed(T)
    S, Hkv = 1024, 8
    ck, sk = _quant_cache_on_card(gen, L, B, S, Hkv, cuda)
    cv, sv = _quant_cache_on_card(gen, L, B, S, Hkv, cuda)
    rk, srk = _quant_cache_on_card(gen, L, B, T, Hkv, cuda)
    rv, srv = _quant_cache_on_card(gen, L, B, T, Hkv, cuda)
    # ragged, the last row, a window running past the end, one wholly past it:
    # rows at or past S are dropped
    pos = torch.tensor([5, S - T, S - (T + 1) // 2, 2 * S], dtype=torch.int32,
                       device=cuda)
    got = AP.append_all_rows_inplace_quant(ck.clone(), cv.clone(), rk, rv, pos, sk.clone(),
                                           sv.clone(), srk, srv)
    want = AP.append_all_rows_inplace_plain(ck, cv, rk, rv, pos, sk, sv, srk, srv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

