"""Standalone-draft speculation in the port (CPU, plain kernel versions),
against the JAX package on numpy weights and prompts made from a seed.

- The head-dim-128 instances of B10, B11 and B12's int4 pool (the 8B
  target's attention on its int4 cache): their plain versions against the
  Pallas kernels in interpret mode at head dim 128, at the tolerance the
  head-dim-64 tests hold them to (2e-5, tests/test_torch_kv_int4.py); the
  head dims each attention entry point takes, and the ROADMAP item a
  missing instance names.
- ``LongSpecEngine``, every mode and prefix of tests/test_longspec.py (full
  48, streamingllm 96, snapkv 104): tokens equal to the JAX engine's on
  every token both commit, and greedy spec == the target's greedy AR; the
  prefill-chunk remainder; a full draft equal to the target proposing its
  own greedy continuation; the encoded state against the JAX encode; the
  8B + 1B path's formats at tiny widths (a head-dim-128 target on an int4
  cache, an int8 draft copy).  SnapKV selections near ties follow ROADMAP
  C's near-tie rule: committed tokens agree, acceptance may differ.
- ``bench.make_longspec_params``, the coupled synthetic pair: >= 2.2
  tokens per gamma = 3 window, and in band at 8 / 4 layers
  (tests/test_bench_protocol.py:76-133).
"""

import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import bench
from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch import kernels as K
from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.engine.engine import EngineConfig, LongSpecEngine
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import paged_attention as PGA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV
from magicdec_tpu_torch.ops import paged_kv as PKV
from test_torch_model import random_params

TOL = dict(atol=2e-5, rtol=2e-5)
HD = 128


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- B10, B11, B12-int4 at head dim 128: plain versions vs Pallas --------------


def _int4_layers(rng, L, Bc, S, Hkv, base, T):
    """Packed int4 caches [L, Bc, S, (Hkv/2)*128] with f32 scales [L, Bc,
    Hkv, S] quantized from unit-scale values, garbage (scales 1e3) past each
    request's visible rows base + T."""
    caches = []
    for _ in range(2):
        x = rng.randn(L, Bc, S, Hkv, HD).astype(np.float32)
        qs = [KV.quantize_kv_tokens_int4(torch.from_numpy(x[l])) for l in range(L)]
        q = torch.stack([a for a, _ in qs]).numpy()
        s = torch.stack([b for _, b in qs]).numpy()
        for b, n in enumerate(base):
            s[:, b, :, n + T:] = 1e3
        caches += [q, s]
    return caches  # k, ks, v, vs


def _fresh4(rng, Bc, T, Hkv):
    x = rng.randn(2, Bc, T, Hkv, HD).astype(np.float32)
    (kn, ksn), (vn, vsn) = (KV.quantize_kv_tokens_int4(torch.from_numpy(x[i])) for i in (0, 1))
    return dict(k_new=kn.numpy(), v_new=vn.numpy(), ks_new=ksn.numpy(), vs_new=vsn.numpy())


def _contiguous_case(jfn, tfn, seed, S, T, base, fresh, **jkw):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    L, Hkv, G = 2, 2, 2
    k, ks, v, vs = _int4_layers(rng, L, len(base), S, Hkv, base, 0 if fresh else T)
    q = rng.randn(len(base), T, Hkv * G, HD).astype(np.float32)
    fr = _fresh4(rng, len(base), T, Hkv) if fresh else {}
    ref = jfn(*(jnp.asarray(a) for a in (q, k, ks, v, vs, base)), layer=1, interpret=True,
              **{n: jnp.asarray(a) for n, a in fr.items()}, **jkw)
    out = tfn(*_t(q, k, ks, v, vs, base), layer=1, **{n: torch.from_numpy(a)
                                                     for n, a in fr.items()})
    assert out.shape == (len(base), T, Hkv * G, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("T", [1, 4])
def test_b10_hd128_plain_matches_pallas(T, fresh):
    from magicdec_tpu.ops.pallas.decode_attention import flash_decode_attend_quant4

    S = 256
    _contiguous_case(flash_decode_attend_quant4, DA.flash_decode_attend_quant4, 30 + T, S, T,
                     np.array([17, 131, S - T], np.int32), fresh, block_s=128)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_b11_hd128_plain_matches_pallas(fresh):
    from magicdec_tpu.ops.pallas.prefill_attention import flash_prefill_attend_quant4

    S, C = 256, 64  # G*C = 128: the Pallas kernel's row block
    _contiguous_case(flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4, 40, S, C,
                     np.array([0, 100, 192], np.int32), fresh, block_s=128, block_r=128)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_b12_int4_hd128_plain_matches_pallas(fresh):
    """The int4 pool at head dim 128 through a permuted table (page size
    128, three pages a request), layers 0 and 1."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.pallas import paged_attention as JPA

    rng = np.random.RandomState(50 + fresh)
    L, Hkv, G, ps, npr, P, T = 2, 2, 2, 128, 3, 12, 4
    table = rng.permutation(P)[:3 * npr].reshape(3, npr).astype(np.int32)
    base = np.array([17, 200, npr * ps - T], np.int32)
    k, ks, v, vs = _int4_layers(rng, L, 3, npr * ps, Hkv, base, 0 if fresh else T)
    tbl = torch.from_numpy(table)
    pools = []
    for q8, s in ((k, ks), (v, vs)):
        qp = PKV.pool_scatter(torch.zeros((L, P, ps, q8.shape[-1]), dtype=torch.int8), tbl,
                              torch.from_numpy(q8))
        segs = (torch.from_numpy(s).reshape(L, 3, Hkv, npr, ps).permute(0, 1, 3, 2, 4)
                .reshape(L, 3 * npr, Hkv, ps))
        sp = torch.zeros(L, P, Hkv, ps)
        sp[:, tbl.reshape(-1).long()] = segs
        pools += [qp.numpy(), sp.numpy()]
    q = rng.randn(3, T, Hkv * G, HD).astype(np.float32)
    fr = _fresh4(rng, 3, T, Hkv) if fresh else {}
    for layer in range(L):
        ref = JPA.flash_paged_decode_attend_quant4(
            jnp.asarray(q), *(jnp.asarray(p) for p in pools), jnp.asarray(table),
            jnp.asarray(base), layer=layer, interpret=True,
            **{n: jnp.asarray(a) for n, a in fr.items()})
        out = PGA.flash_paged_decode_attend_quant4(
            torch.from_numpy(q), *_t(*pools), tbl, torch.from_numpy(base), layer=layer,
            **{n: torch.from_numpy(a) for n, a in fr.items()})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


ENTRIES = ["md_decode_attend", "md_prefill_attend", "md_paged_decode_attend",
           "md_decode_attend_quant", "md_prefill_attend_quant", "md_paged_decode_attend_quant",
           "md_decode_attend_quant4", "md_prefill_attend_quant4",
           "md_paged_decode_attend_quant4"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_head_dim_entries(entry):
    """Head dim 64 takes every entry point as it is; 128 the ``_hd128``
    instances of B10, B11 and B12's int4 pool (f32 scales) and nothing
    else; any other head dim raises, naming the ROADMAP item, before a
    launch (the instances exist in the kernel library's signatures)."""
    from magicdec_tpu_torch.kernels import build

    assert K.head_dim_entry(entry, 64) == entry
    if entry in K.HD128_ENTRIES:
        assert K.head_dim_entry(entry, 128) == entry + "_hd128"
        assert entry + "_hd128" in build.SIGNATURES
        with pytest.raises(ValueError, match=K.HD128_ITEM):
            K.head_dim_entry(entry + "_bf16s", 128)
    else:
        with pytest.raises(ValueError, match=K.HD128_ITEM):
            K.head_dim_entry(entry, 128)
    for hd in (32, 80, 96, 256):
        with pytest.raises(ValueError, match=K.HD128_ITEM):
            K.head_dim_entry(entry, hd)


def test_hd128_split_plan_aims_at_two_blocks_an_sm():
    """The head-dim-128 instance holds two pair blocks an SM: its plan at
    the 8B target's verify (B=8, 8 kv heads, 16512 rows) fills 2 x 132
    blocks; head dim 64 keeps three an SM."""
    n128, c128 = DA.quant_split_plan(8, 8, 16512, 128)
    n64, _ = DA.quant_split_plan(8, 8, 16512)
    assert 8 * 4 * n128 <= 2 * 132 < 8 * 4 * (n128 + 1) and n128 * c128 >= 16512
    assert 8 * 4 * n64 <= 3 * 132 and n64 > n128


# -- LongSpecEngine vs the JAX package ------------------------------------------

KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
DKW = dict(vocab_size=128, n_layer=1, n_head=4, n_kv_head=2, dim=32, intermediate_size=64)
TARGET = random_params(tcfg.tiny_config(**KW), fan_in=False)  # tests/test_spec_parity.py's
DRAFT = random_params(tcfg.tiny_config(**DKW), seed=42, fan_in=False)  # tests/test_longspec.py's
B = 2


def _ecfg_kw(mode, max_gen=20, **kw):
    return dict(mode=mode, gamma=3, draft_budget=33, max_seq_len=256, chunk_size=16,
                window_size=8, sink_size=4, max_gen=max_gen, eot_ids=(-1,), **kw)


def _jax_tree(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree)


def _prompt(prefix, seed, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, prefix)).astype(np.int32)


def _port_engine(mode, tkw=KW, dkw=DKW, target=TARGET, draft=DRAFT, **kw):
    return LongSpecEngine(params_from_jax(target), tcfg.tiny_config(**tkw), params_from_jax(draft),
                          tcfg.tiny_config(**dkw),
                          EngineConfig(cache_dtype=torch.float32, **_ecfg_kw(mode, **kw)),
                          device="cpu")


def _jax_engine(mode, tkw=KW, dkw=DKW, target=TARGET, draft=DRAFT, **kw):
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import LongSpecEngine as JLongSpecEngine

    return JLongSpecEngine(_jax_tree(target), jcfg.tiny_config(**tkw), _jax_tree(draft),
                           jcfg.tiny_config(**dkw),
                           JEngineConfig(cache_dtype=jnp.float32, **_ecfg_kw(mode, **kw)))


def _np(stats):
    return {k: np.asarray(v) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def _runs(mode, prefix, seed=8):
    """(port spec, port AR, JAX spec) stats and the two encoded states."""
    import jax.numpy as jnp

    prompt = _prompt(prefix, seed)
    eng, jeng = _port_engine(mode), _jax_engine(mode)
    st = eng.encode(prompt)
    jst = jeng.encode(jnp.asarray(prompt))
    states = ({n: getattr(st, n).clone() for n in ("k", "v", "dk", "dv", "target_lens",
                                                   "draft_fill", "draft_pos", "token0")},
              {n: np.asarray(getattr(jst, n)) for n in ("k", "v", "dk", "dv", "target_lens",
                                                         "draft_fill", "draft_pos", "token0")})
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=20)
    _, jspec = jeng.generate(jst)
    return _np(spec), _np(base), _np(jspec), states


MODES = [("full", 48), ("streamingllm", 96), ("snapkv", 104)]


def _assert_committed(spec, base, jspec, max_gen):
    n, jn = spec["num_committed"], jspec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(len(n)):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])
        both = min(int(n[b]), int(jn[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :both], jspec["output"][b, :both])


@pytest.mark.parametrize("mode,prefix", MODES)
def test_longspec_matches_jax_and_autoregressive(mode, prefix):
    spec, base, jspec, _ = _runs(mode, prefix)
    _assert_committed(spec, base, jspec, 20)
    if mode != "snapkv":  # no selection: the windows themselves agree
        assert int(spec["target_steps"]) == int(jspec["target_steps"])


@pytest.mark.parametrize("mode,prefix", MODES)
def test_longspec_encode_matches_jax(mode, prefix):
    """Lengths, fills, positions and the first token exactly; the target
    cache and (full, streamingllm) the draft cache to 1e-4.  SnapKV: the
    draft's observation-window rows (slots budget - W .. budget) to 1e-4,
    nothing past the budget; which keys fill the slots before them may
    differ at near ties (ROADMAP C: the saturated softmax of these
    weights makes exact ties that each package orders by its own
    rounding), which moves acceptance only
    (``test_longspec_matches_jax_and_autoregressive``)."""
    got, want = _runs(mode, prefix)[3]
    for n in ("target_lens", "draft_fill", "draft_pos", "token0"):
        np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)
    for n in ("k", "v") + (() if mode == "snapkv" else ("dk", "dv")):
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n].numpy(), want[n], atol=1e-4, rtol=1e-4, err_msg=n)
    if mode == "snapkv":
        budget, W = 33, 8
        for n in ("dk", "dv"):
            assert got[n].shape == want[n].shape, n
            np.testing.assert_allclose(got[n][:, :, budget - W:budget].numpy(),
                                       want[n][:, :, budget - W:budget], atol=1e-4, rtol=1e-4,
                                       err_msg=n)
            assert not got[n][:, :, budget:].any() and not want[n][:, :, budget:].any()


def test_longspec_prefill_chunk_remainder():
    """prefill_chunk_size 48 over a prefix of 88 (a remainder of 40): the
    same tokens as chunks of chunk_size, in the port and in the JAX
    package."""
    import jax.numpy as jnp

    prompt = _prompt(88, 9)
    outs = []
    for kw in ({}, {"prefill_chunk_size": 48}):
        eng = _port_engine("streamingllm", max_gen=12, **kw)
        _, stats = eng.generate(eng.encode(prompt))
        outs.append(_np(stats))
    jeng = _jax_engine("streamingllm", max_gen=12, prefill_chunk_size=48)
    _, jstats = jeng.generate(jeng.encode(jnp.asarray(prompt)))
    outs.append(_np(jstats))
    for o in outs:
        assert o["num_committed"].max() >= 12
    for b in range(B):
        m = min(int(o["num_committed"][b]) for o in outs)
        for o in outs[1:]:
            np.testing.assert_array_equal(o["output"][b, :m], outs[0]["output"][b, :m])


def test_longspec_full_draft_equals_own_greedy():
    """With the target as its own uncompressed draft every proposal is
    accepted: at most ceil(max_gen / (gamma + 1)) + 1 target passes."""
    eng = _port_engine("full", dkw=KW, draft=TARGET, max_gen=12)
    _, stats = eng.generate(eng.encode(_prompt(48, 2)))
    assert int(stats["target_steps"]) <= -(-12 // 4) + 1
    assert eng.draft_cfg.n_layer == 2 and eng._draft_cap == 256


def test_longspec_draft_cache_and_modes():
    """The draft cache takes the draft's own shape; full mode keeps
    max_seq_len rows; the mode check admits full here only."""
    from magicdec_tpu_torch.engine.engine import SpecEngine

    for mode, cap in (("full", 256), ("streamingllm", 128), ("snapkv", 128)):
        eng = _port_engine(mode)
        tc, dc = eng._zero_caches(2)
        assert dc["dk"].shape == (1, 2, cap, 2 * 8), mode
        assert tc["k"].shape == (2, 2, 256, 2 * 16)
    with pytest.raises(ValueError, match="mode"):
        SpecEngine(params_from_jax(TARGET), tcfg.tiny_config(**KW),
                   EngineConfig(cache_dtype=torch.float32, **_ecfg_kw("full")), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        _port_engine("full", dkw=dict(DKW, vocab_size=64))


# the 8B + 1B path's formats at tiny widths: a head-dim-128 target (dim 2 x
# 128) on an int4 cache, a head-dim-64 draft with its int8 copy
HD128_KW = dict(vocab_size=128, n_layer=2, n_head=2, n_kv_head=2, dim=256,
                intermediate_size=256)
HD64_DKW = dict(vocab_size=128, n_layer=1, n_head=2, n_kv_head=2, dim=128,
                intermediate_size=128)


@pytest.mark.parametrize("mode,prefix", [("full", 48), ("snapkv", 104)])
def test_longspec_hd128_int4_target_int8_draft_matches_jax(mode, prefix):
    import jax.numpy as jnp

    target = random_params(tcfg.tiny_config(**HD128_KW), seed=5)
    draft = random_params(tcfg.tiny_config(**HD64_DKW), seed=6)
    kw = dict(tkw=HD128_KW, dkw=HD64_DKW, target=target, draft=draft, kv_quant="int4",
              draft_quant="int8")
    eng, jeng = _port_engine(mode, **kw), _jax_engine(mode, **kw)
    assert eng.cfg.head_dim == 128 and eng.draft_cfg.head_dim == 64
    prompt = _prompt(prefix, 11)
    st = eng.encode(prompt)
    assert st.k.shape == (2, B, 256, 128) and st.ks.shape == (2, B, 2, 256)
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=20)
    _, jspec = jeng.generate(jeng.encode(jnp.asarray(prompt)))
    _assert_committed(_np(spec), _np(base), _np(jspec), 20)


# -- the coupled synthetic pair -------------------------------------------------


def _coupled_rate(tkw, dkw, max_gen, seed_prompt, **ecfg_kw):
    tc, dc = tcfg.tiny_config(**tkw), tcfg.tiny_config(**dkw)
    tp, dp = bench.make_longspec_params(tc, dc, device="cpu")
    eng = LongSpecEngine(tp, tc, dp, dc, EngineConfig(
        mode="streamingllm", gamma=3, draft_budget=257, max_seq_len=1024, chunk_size=128,
        max_gen=max_gen, eot_ids=(-1,), cache_dtype=torch.bfloat16, **ecfg_kw), device="cpu")
    prompt = np.random.RandomState(seed_prompt).randint(0, 1024, (4, 768))
    _, stats = eng.generate(eng.encode(prompt))
    return int(stats["gen_tokens"].sum()) / int(stats["target_steps"]) / 4


def test_longspec_coupled_protocol_acceptance():
    """The JAX package's gate (tests/test_bench_protocol.py:76-106): >= 2.2
    tokens per gamma = 3 window with the int8 draft copy."""
    rate = _coupled_rate(dict(vocab_size=1024, n_layer=4, n_head=8, n_kv_head=4, dim=256,
                              intermediate_size=512),
                         dict(vocab_size=1024, n_layer=2, n_head=4, n_kv_head=2, dim=128,
                              intermediate_size=256), 64, 0, draft_quant="int8")
    assert rate >= 2.2, f"coupled longspec protocol degraded: {rate:.2f} tokens/step"


def test_longspec_coupled_protocol_depth_invariant():
    rate = _coupled_rate(dict(vocab_size=1024, n_layer=8, n_head=8, n_kv_head=4, dim=256,
                              intermediate_size=512),
                         dict(vocab_size=1024, n_layer=4, n_head=4, n_kv_head=2, dim=128,
                              intermediate_size=256), 48, 1)
    assert rate >= 2.2, f"depth scaling broken: {rate:.2f} tokens/step"


def test_make_longspec_params_construction():
    """The backbone's P is exactly semi-orthogonal (P P^T = I), so the
    target's embed A @ P times its head P^T @ C gives back the draft's A @
    C (up to bf16 rounding); default residuals 0.24 / sqrt(L_t) and 0.042 /
    sqrt(L_d); t_bits quantizes the target's stack and head, quantize_embed
    its table, and the draft stays bf16 with the same draws."""
    from magicdec_tpu_torch import quantization as Q

    tc = tcfg.tiny_config(vocab_size=256, n_layer=4, n_head=4, n_kv_head=2, dim=128,
                          intermediate_size=256)
    dc = tcfg.tiny_config(vocab_size=256, n_layer=2, n_head=2, n_kv_head=2, dim=64,
                          intermediate_size=128)
    tp, dp = bench.make_longspec_params(tc, dc, dtype=torch.bfloat16, device="cpu")
    assert tp["embed"].shape == (256, 128) and dp["embed"].shape == (256, 64)
    assert tp["lm_head"].shape == (128, 256) and dp["lm_head"].shape == (64, 256)
    A, C = dp["embed"].float(), dp["lm_head"].float()
    bigram = tp["embed"].float() @ tp["lm_head"].float()
    assert torch.corrcoef(torch.stack([bigram.flatten(), (A @ C).flatten()]))[0, 1] > 0.99
    wo_t = tp["layers"]["wo"].float().std() * np.sqrt(128)
    wo_d = dp["layers"]["wo"].float().std() * np.sqrt(64)
    assert abs(wo_t / (0.24 / 2) - 1) < 0.1 and abs(wo_d / (0.042 / np.sqrt(2)) - 1) < 0.1
    tq, dq = bench.make_longspec_params(tc, dc, t_bits=8, quantize_embed=True, device="cpu")
    assert Q.is_quantized(tq["layers"]["wqkv"]) and Q.is_quantized(tq["lm_head"])
    assert Q.is_quantized(tq["embed"]) and not Q.is_quantized(dq["layers"]["wqkv"])
    torch.testing.assert_close(dq["embed"], dp["embed"], atol=0, rtol=0)
    with pytest.raises(ValueError, match="vocabulary"):
        bench.make_longspec_params(tc, tcfg.tiny_config(vocab_size=128), device="cpu")
