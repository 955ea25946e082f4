"""SnapKV self-speculation in the port (CPU, plain kernel versions), against
the JAX package on numpy inputs made from a seed.

- ``ops/snapkv.py``: the average pool, and ``snapkv_compress`` with avg- and
  max-pooling over bf16, int8 and int4-packed caches: the same selected
  indices in the same order and the returned rows bit-equal.
- The model passes: the observation-window chunk (hidden states and window
  queries to 1e-4, caches as tests/test_torch_model.py and
  tests/test_torch_kv_quant.py hold them: 1e-4, int8 one step in <= 0.1%,
  scales rtol 1e-5); the last chunk with the compression inside equal, bit
  for bit, to the window chunk followed by the compression layer by layer;
  the verify's tokens exact and both caches' appends at the same
  tolerances, and its target pass bit-equal to ``forward_target``'s.
- The engine and both serving engines: greedy spec == AR in the port and
  tokens equal to the JAX engines'.

Near ties.  The window queries of the two packages differ in the last bits
(1e-4 above), and a selection at scores that are equal up to rounding can
then go either way: at tests/test_spec_parity.py's weights the softmax is
saturated, so the pooled scores hold exact ties (multiples of 1/5 of one
query's mass) that only the rounding of the pool's cumulative sum orders.
Where the two packages keep different keys, every such key must be a near
tie: its float64 score within ``NEAR_TIE`` (relative to the head's largest
score) of the last kept key's.  A different key moves acceptance only: the
committed tokens are the target's, so the engine's tokens equal the JAX
engine's on every token both committed, and the serving engines' (which run
every request to its own end) on every token.
"""

import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import bench, serving_bench
from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
from magicdec_tpu_torch.engine.serving import PagedServingEngine, ServingEngine
from magicdec_tpu_torch.models import llama as TM
from magicdec_tpu_torch.ops import kv_cache as KV
from magicdec_tpu_torch.ops import snapkv as TS

TOL = dict(atol=1e-4, rtol=1e-4)
NEAR_TIE = 1e-5
W, CHUNK, BUDGET = 8, 16, 33


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _head_scores(q, k, ctx, kernel=5):
    """An independent float64 model of SnapKV's scores: q [W, Hq, hd], k
    [>= ctx, Hkv, hd] numpy -> the avg-pooled, group-summed head scores
    [Hkv, ctx - W]."""
    Wq, Hq, hd = q.shape
    Hkv = k.shape[1]
    qg = q.astype(np.float64).reshape(Wq, Hkv, Hq // Hkv, hd).transpose(1, 2, 0, 3)
    s = np.einsum("kgwd,skd->kgws", qg, k[:ctx].astype(np.float64))
    s = np.where(np.arange(ctx)[None] <= ctx - Wq + np.arange(Wq)[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    mass = (p / p.sum(-1, keepdims=True))[..., :ctx - Wq].sum(2)
    pad = kernel // 2
    mp = np.pad(mass, [(0, 0), (0, 0), (pad, pad)])
    return np.mean([mp[..., i:i + ctx - Wq] for i in range(kernel)], axis=0).sum(1)


def _assert_near_ties(scores, ours, theirs, topk):
    """ours / theirs [Hkv, topk] key indices: every key kept by one and not
    the other scores within NEAR_TIE of the last kept key."""
    for h in range(scores.shape[0]):
        differ = set(ours[h].tolist()) ^ set(theirs[h].tolist())
        if not differ:
            continue
        kth = np.sort(scores[h])[::-1][topk - 1]
        gaps = [abs(scores[h, i] - kth) / scores[h].max() for i in differ]
        assert max(gaps) <= NEAR_TIE, (h, sorted(differ), max(gaps))


def _row_indices(rows, keys):
    """Indices into keys [ctx, Hkv, hd] of rows [n, Hkv, hd] (exact copies)."""
    out = np.empty(rows.shape[:2], np.int64)
    for j in range(rows.shape[0]):
        for h in range(rows.shape[1]):
            hit = np.nonzero((keys[:, h] == rows[j, h]).all(-1))[0]
            assert len(hit), (j, h)
            out[j, h] = hit[0]
    return out.T


# -- ops/snapkv.py ---------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_avg_pool_matches_jax(kernel):
    """The port sums each window directly; the JAX package differences a
    float32 cumulative sum, which reaches 25 here: within 2e-6 (about one
    float32 ulp of that sum)."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.snapkv import _avg_pool_1d

    x = np.random.RandomState(kernel).rand(3, 4, 50).astype(np.float32)
    np.testing.assert_allclose(TS._avg_pool_1d(torch.from_numpy(x), kernel).numpy(),
                               np.asarray(_avg_pool_1d(jnp.asarray(x), kernel)),
                               atol=2e-6, rtol=0)


def _compress_inputs(fmt, seed=0):
    """(q [B, W, Hq, hd] bf16 values as float32, k, v, k_scale, v_scale as
    numpy) for a cache format: bf16 values, or int8 / int4-packed data with
    f32 scales quantized by the port's ops (bit-equal to the JAX package's,
    tests/test_torch_kv_quant.py)."""
    rng = np.random.RandomState(seed)
    Bq, Hq, Hkv, hd, S = 2, 8, 4, 16, 128
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    q = bf(rng.randn(Bq, W, Hq, hd).astype(np.float32))
    kv = [rng.randn(Bq, S, Hkv, hd).astype(np.float32) for _ in range(2)]
    if fmt == "bf16":
        return q, bf(kv[0].reshape(Bq, S, -1)), bf(kv[1].reshape(Bq, S, -1)), None, None
    qz = KV.quantize_kv_tokens if fmt == "int8" else KV.quantize_kv_tokens_int4
    (k, ks), (v, vs) = (qz(torch.from_numpy(x).to(torch.bfloat16)) for x in kv)
    return q, k.numpy(), v.numpy(), ks.numpy(), vs.numpy()


@pytest.mark.parametrize("pooling", ["avgpool", "maxpool"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_snapkv_compress_matches_jax(fmt, pooling):
    """Same inputs, bf16 queries: the same keys in the same order (max
    pooling copies a value to its neighbours, so exact ties are ordered by
    the tie rule, lower index first, in both) and the rows bit-equal."""
    import jax.numpy as jnp
    from magicdec_tpu.ops.snapkv import snapkv_compress

    q, k, v, ks, vs = _compress_inputs(fmt)
    ctx, budget = 104, 41
    kw = dict(ctx_len=ctx, window=W, budget=budget, kernel_size=5, pooling=pooling)
    dt = torch.bfloat16 if fmt == "bf16" else None
    tk, tv = (torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a) for a in (k, v))
    scales = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                        v_scale=torch.from_numpy(vs))
    dk, dv, idx = TS.snapkv_compress(torch.from_numpy(q).to(torch.bfloat16), tk, tv,
                                     return_indices=True, **kw, **scales)
    jd = jnp.bfloat16 if fmt == "bf16" else None
    jdk, jdv = snapkv_compress(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jd), jnp.asarray(v, jd), **kw,
        **({} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))))
    assert dk.dtype == torch.bfloat16 and dk.shape == (2, budget, 4, 16)
    np.testing.assert_array_equal(dk.float().numpy(), np.asarray(jdk, np.float32))
    np.testing.assert_array_equal(dv.float().numpy(), np.asarray(jdv, np.float32))
    # the selected indices, recovered from the JAX rows, in order
    keys = (tk.float() if ks is None else
            KV.dequant_kv(tk, torch.from_numpy(ks), 16, torch.bfloat16).float())
    keys = keys.reshape(2, -1, 4, 16).numpy()
    for b in range(2):
        jidx = _row_indices(np.asarray(jdk, np.float32)[b, :budget - W], keys[b, :ctx - W])
        np.testing.assert_array_equal(idx[b].numpy(), jidx)
        # the window's own rows follow the selection
        np.testing.assert_array_equal(dk[b, budget - W:].float().numpy(),
                                      keys[b, ctx - W:ctx])


def test_snapkv_compress_groups_equal_single_requests():
    """Ten requests (groups of 8 and 2) give each request's keys and rows
    as the request compressed alone does, bit for bit, int8 cache."""
    rng = np.random.RandomState(4)
    Bq, Hq, Hkv, hd, S, ctx, budget = 10, 8, 4, 16, 128, 104, 41
    assert Bq > TS.GROUP
    q = torch.from_numpy(rng.randn(Bq, W, Hq, hd).astype(np.float32)).to(torch.bfloat16)
    (k, ks), (v, vs) = (KV.quantize_kv_tokens(
        torch.from_numpy(rng.randn(Bq, S, Hkv, hd).astype(np.float32))) for _ in range(2))
    kw = dict(ctx_len=ctx, window=W, budget=budget, return_indices=True)
    dk, dv, idx = TS.snapkv_compress(q, k, v, k_scale=ks, v_scale=vs, **kw)
    for b in range(Bq):
        one = TS.snapkv_compress(q[b:b + 1], k[b:b + 1], v[b:b + 1], k_scale=ks[b:b + 1],
                                 v_scale=vs[b:b + 1], **kw)
        for got, want in zip((dk, dv, idx), one):
            assert torch.equal(got[b:b + 1], want), b


def test_snapkv_compress_contract():
    q, k, v, _, _ = _compress_inputs("bf16")
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="too short"):
        TS.snapkv_compress(q, k, v, ctx_len=40, window=W, budget=41)
    with pytest.raises(ValueError, match="pooling"):
        TS.snapkv_compress(q, k, v, ctx_len=104, window=W, budget=41, pooling="sum")


# -- the model passes ------------------------------------------------------------------


def _window_operands(fmt, rng):
    """(JAX params, port params, caches after a 32-token prefill chunk as
    numpy, window tokens, base lengths) at tests/test_torch_model.py's
    tiny widths; fmt "f32" or "int8"."""
    import jax.numpy as jnp
    from magicdec_tpu.models import llama as JM
    from test_torch_model import JCFG, _both_params, _jax_tree

    jp, tp = _both_params(True)
    Bm, S, K = 2, 96, JCFG.n_kv_head * JCFG.head_dim
    if fmt == "f32":
        caches = {n: np.zeros((JCFG.n_layer, Bm, S, K), np.float32) for n in "kv"}
    else:
        caches = {n: np.zeros((JCFG.n_layer, Bm, S, K), np.int8) for n in "kv"}
        caches.update({n: np.zeros((JCFG.n_layer, Bm, JCFG.n_kv_head, S), np.float32)
                       for n in ("ks", "vs")})
    tokens = rng.randint(0, JCFG.vocab_size, size=(Bm, 40)).astype(np.int32)
    _, jc = JM.forward_target(jp, JCFG, jnp.asarray(tokens[:, :32]),
                              jnp.zeros((Bm,), jnp.int32), _jax_tree(caches), head="none")
    caches = {n: np.asarray(a) for n, a in jc.items()}
    return jp, tp, caches, tokens[:, 32:], np.full((Bm,), 32, np.int32)


def _assert_target_caches(got, want):
    """Port caches against the JAX pass's (tests/test_torch_kv_quant.py's
    rules for int8)."""
    for name, arr in want.items():
        if name in ("ks", "vs"):
            np.testing.assert_allclose(got[name], arr, rtol=1e-5, atol=0, err_msg=name)
        elif arr.dtype == np.int8:
            diff = np.abs(got[name].astype(np.int32) - arr.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(got[name], arr, err_msg=name, **TOL)


@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_forward_prefill_snapkv_window_matches_jax(fmt):
    """The W-token window chunk after a 32-token prefill: hidden states and
    the window queries to 1e-4, the appended caches as the target pass's;
    then the JAX package's last chunk (the compression inside) against the
    port's selection from its own window: the same keys up to near ties,
    and the rows of the keys both keep within 1e-4."""
    import jax.numpy as jnp
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy
    from test_torch_model import JCFG, TCFG

    jp, tp, caches, tokens, base = _window_operands(fmt, np.random.RandomState(5))
    xj, jc, qj = JM.forward_prefill_snapkv_window(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(base),
        {n: jnp.asarray(a) for n, a in caches.items()})
    xt, tc, qt = TM.forward_prefill_snapkv_window(
        tp, TCFG, torch.from_numpy(tokens), torch.from_numpy(base), caches_from_jax(caches))
    assert qt.shape == (JCFG.n_layer, 2, W, JCFG.n_head * JCFG.head_dim)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **TOL)
    _assert_target_caches(caches_to_numpy(tc), {n: np.asarray(a) for n, a in jc.items()})

    ctx, budget, hd, Hkv = 40, BUDGET, JCFG.head_dim, JCFG.n_kv_head
    Sd = 64
    dz = {n: np.zeros((JCFG.n_layer, 2, Sd, Hkv * hd), np.float32) for n in ("dk", "dv")}
    _, jlast = JM.forward_prefill_snapkv_last(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(base),
        {n: jnp.asarray(a) for n, a in {**caches, **dz}.items()}, ctx_len=ctx, window=W,
        budget=budget, head="none")
    jdk = np.asarray(jlast["dk"])
    topk = budget - W
    for l in range(JCFG.n_layer):
        scales = {} if fmt == "f32" else dict(k_scale=tc["ks"][l], v_scale=tc["vs"][l])
        dk, _, idx = TS.snapkv_compress(qt[l].reshape(2, W, JCFG.n_head, hd), tc["k"][l],
                                        tc["v"][l], ctx_len=ctx, window=W, budget=budget,
                                        return_indices=True, **scales)
        keys = (tc["k"][l] if fmt == "f32" else
                KV.dequant_kv(tc["k"][l], tc["ks"][l], hd, torch.float32))
        keys = keys.reshape(2, -1, Hkv, hd).numpy()
        jkeys = (np.asarray(jc["k"])[l] if fmt == "f32" else
                 np.asarray(KV.dequant_kv(torch.from_numpy(np.array(jc["k"])[l]),
                                          torch.from_numpy(np.array(jc["ks"])[l]), hd,
                                          torch.float32))).reshape(2, -1, Hkv, hd)
        for b in range(2):
            jrows = jdk[l, b, :topk].reshape(topk, Hkv, hd)
            jidx = _row_indices(jrows, jkeys[b, :ctx - W])
            _assert_near_ties(_head_scores(qt[l, b].reshape(W, -1, hd).numpy(), keys[b], ctx),
                              idx[b].numpy(), jidx, topk)
            same = idx[b].numpy() == jidx  # [Hkv, topk]
            np.testing.assert_allclose(dk[b, :topk].numpy().transpose(1, 0, 2)[same],
                                       jrows.transpose(1, 0, 2)[same], **TOL)


@pytest.mark.parametrize("fmt", ["f32", "int8", "int4"])
def test_forward_prefill_snapkv_last_equals_window_and_compression(fmt):
    """In the port: the last chunk with the compression inside the layer
    loop gives, bit for bit, the hidden states, the target caches and the
    draft slots of the window chunk followed by the engine's compression
    layer by layer."""
    rng = np.random.RandomState(6)
    tp = TM.fuse_exec_params(_tiny_port_params(), TCFG_SPEC)
    eng = SpecEngine(tp, TCFG_SPEC, EngineConfig(
        mode="snapkv", cache_dtype=torch.float32, kv_quant=fmt != "f32" and fmt,
        **ENGINE_KW), device="cpu")
    tokens = torch.from_numpy(rng.randint(0, TCFG_SPEC.vocab_size, size=(2, 72)))
    tc, dc = eng._zero_caches(2)
    lens, _ = eng._target_prefill(tokens[:, :64], tc)
    tc2 = {n: t.clone() for n, t in tc.items()}
    dc2 = {n: t.clone() for n, t in dc.items()}
    x, tc, qs = TM.forward_prefill_snapkv_window(eng.params, TCFG_SPEC, tokens[:, 64:], lens,
                                                 tc)
    eng._snapkv_fill_draft(tc, dc, qs, 72)
    x2, caches = TM.forward_prefill_snapkv_last(
        eng.params, TCFG_SPEC, tokens[:, 64:], lens, {**tc2, **dc2}, ctx_len=72, window=W,
        budget=BUDGET)
    assert torch.equal(x, x2)
    for name, t in {**tc, **dc}.items():
        assert torch.equal(caches[name], t), name
    assert dc["dk"][:, :, :BUDGET].abs().sum() > 0 and not dc["dk"][:, :, BUDGET:].any()


def test_forward_verify_snapkv_matches_jax_and_forward_target():
    """A T=4 verify at ragged lengths and draft fills: tokens equal the JAX
    pass's, the target's append and the draft's (at the fills, the live
    rows only) within 1e-4 (int8: one step in <= 0.1%); in the port its
    target pass is forward_target's, bit for bit, padded to decode_rows or
    not."""
    import dataclasses

    import jax.numpy as jnp
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy
    from test_torch_model import JCFG, TCFG

    rng = np.random.RandomState(7)
    for fmt in ("f32", "int8"):
        jp, tp, caches, _, _ = _window_operands(fmt, rng)
        K = JCFG.n_kv_head * JCFG.head_dim
        caches.update({n: rng.randn(JCFG.n_layer, 2, 64, K).astype(np.float32)
                       for n in ("dk", "dv")})
        tokens = rng.randint(0, JCFG.vocab_size, size=(2, 4)).astype(np.int32)
        base, fill = np.array([32, 20], np.int32), np.array([10, 33], np.int32)
        tj, jc = JM.forward_verify_snapkv(jp, JCFG, jnp.asarray(tokens), jnp.asarray(base),
                                          jnp.asarray(fill),
                                          {n: jnp.asarray(a) for n, a in caches.items()})
        tt, tc = TM.forward_verify_snapkv(tp, TCFG, torch.from_numpy(tokens),
                                          torch.from_numpy(base), torch.from_numpy(fill),
                                          caches_from_jax(caches))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        got = caches_to_numpy(tc)
        _assert_target_caches(got, {n: np.asarray(a) for n, a in jc.items()})
        # the draft rows land at the fills and nowhere else
        for b, f in enumerate(fill):
            np.testing.assert_array_equal(got["dk"][:, b, :f], caches["dk"][:, b, :f])
            np.testing.assert_array_equal(got["dk"][:, b, f + 4:], caches["dk"][:, b, f + 4:])
        for hint in (0, 8):
            cfg = dataclasses.replace(TCFG, decode_rows=hint)
            c1, c2 = caches_from_jax(caches), caches_from_jax(caches)
            lv, c1 = TM.forward_verify_snapkv(tp, cfg, torch.from_numpy(tokens),
                                              torch.from_numpy(base), torch.from_numpy(fill),
                                              c1, head="logits")
            lt, c2 = TM.forward_target(tp, cfg, torch.from_numpy(tokens),
                                       torch.from_numpy(base), c2, head="logits")
            assert torch.equal(lv, lt)
            for n in caches:
                if n not in ("dk", "dv"):
                    assert torch.equal(c1[n], c2[n]), n


# -- the engine ------------------------------------------------------------------------

KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
TCFG_SPEC = tcfg.tiny_config(**KW)
MAX_GEN = 24
ENGINE_KW = dict(gamma=3, draft_budget=BUDGET, max_seq_len=256, chunk_size=CHUNK,
                 window_size=W, sink_size=4, max_gen=MAX_GEN, eot_ids=(-1,))


def _tiny_port_params():
    from magicdec_tpu_torch.convert import params_from_jax
    from test_torch_engine import PARAMS

    return params_from_jax(PARAMS)


def _jax_params():
    import jax.numpy as jnp
    from test_torch_engine import PARAMS

    return {k: ({n: None if a is None else jnp.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else jnp.asarray(v)) for k, v in PARAMS.items()}


def _prompt(prefix, B=2, seed=0):
    return np.random.RandomState(seed).randint(0, KW["vocab_size"], size=(B, prefix))


@functools.lru_cache(maxsize=None)
def _engines(kv_quant):
    """The port's and the JAX package's snapkv engines with the int8 draft
    copy at tests/test_spec_parity.py's weights (one of each a cache
    format: the JAX engine compiles its loop once for both prefixes)."""
    import jax.numpy as jnp
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from test_torch_engine import JCFG

    kw = dict(ENGINE_KW, mode="snapkv", kv_quant=kv_quant, draft_quant="int8")
    return (SpecEngine(_tiny_port_params(), TCFG_SPEC,
                       EngineConfig(cache_dtype=torch.float32, **kw), device="cpu"),
            JSpecEngine(_jax_params(), JCFG, JEngineConfig(cache_dtype=jnp.float32, **kw)))


@functools.lru_cache(maxsize=None)
def _engine_runs(prefix, kv_quant):
    """(port spec, port AR, JAX spec) stats (the AR tokens of the two
    packages agree, tests/test_torch_engine.py)."""
    import jax.numpy as jnp

    eng, jeng = _engines(kv_quant)
    prompt = _prompt(prefix)
    st = eng.encode(prompt)
    assert (st.draft_fill == BUDGET).all() and (st.draft_pos == prefix).all()
    assert (st.target_lens == prefix).all()
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=MAX_GEN)
    jprompt = jnp.asarray(prompt, jnp.int32)
    _, jspec = jeng.generate(jeng.encode(jprompt))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec)


ENGINE_CASES = [(p, q) for q in (False, "int8", "int4") for p in (40, 104)]


@pytest.mark.parametrize("prefix,kv_quant", ENGINE_CASES,
                         ids=[f"{q or 'dense'}_{p}" for p, q in ENGINE_CASES])
def test_snapkv_engine_spec_matches_autoregressive_and_jax(prefix, kv_quant):
    spec, base, jspec = _engine_runs(prefix, kv_quant)
    n, jn = spec["num_committed"], jspec["num_committed"]
    assert n.max() >= MAX_GEN, n
    for b in range(len(n)):
        m = min(int(n[b]), MAX_GEN)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])
        both = min(int(n[b]), int(jn[b]))
        np.testing.assert_array_equal(spec["output"][b, :both], jspec["output"][b, :both])


def test_snapkv_encode_runs_no_streaming_draft_prefill(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the snapkv encode ran the streaming draft prefill")

    monkeypatch.setattr(TM, "forward_streaming_draft_chunk", refuse)
    monkeypatch.setattr(TM, "streaming_finalize_draft", refuse)
    eng = SpecEngine(_tiny_port_params(), TCFG_SPEC,
                     EngineConfig(mode="snapkv", cache_dtype=torch.float32, **ENGINE_KW),
                     device="cpu")
    st = eng.encode(_prompt(40))
    assert st.dk[:, :, :BUDGET].abs().sum() > 0


@pytest.mark.parametrize("prefix", [41, 48, 24])
def test_snapkv_shape_contract_raises(prefix):
    """prefix = window (mod chunk_size), and at least the draft budget (the
    compression's check, as in the JAX package)."""
    eng = SpecEngine(_tiny_port_params(), TCFG_SPEC,
                     EngineConfig(mode="snapkv", cache_dtype=torch.float32, **ENGINE_KW),
                     device="cpu")
    with pytest.raises(ValueError, match="window .mod chunk_size.|too short"):
        eng.encode(_prompt(prefix))


def test_snapkv_bench_protocol_acceptance():
    """The bench's synthetic weights at a CPU size (tests/test_bench_protocol.py:
    37-73, prefix 672 for the shape contract): >= 2.5 tokens per gamma=3
    window, the JAX package's snapkv gate."""
    cfg = tcfg.tiny_config(vocab_size=1024, n_layer=4, n_head=8, n_kv_head=4,
                           dim=256, intermediate_size=512)
    eng = SpecEngine(bench.make_params(cfg, device="cpu"), cfg,
                     EngineConfig(mode="snapkv", gamma=3, draft_budget=257, max_seq_len=1024,
                                  chunk_size=128, max_gen=64, eot_ids=(-1,),
                                  cache_dtype=torch.bfloat16), device="cpu")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 672))
    _, stats = eng.generate(eng.encode(prompt))
    steps = int(stats["target_steps"])
    assert steps > 0
    rate = int(stats["gen_tokens"].sum()) / steps / 4
    assert rate >= 2.5, f"snapkv acceptance collapsed: {rate:.2f} tokens/step"


# -- serving ---------------------------------------------------------------------------

SERVE_LENS = [40, 104, 40, 136, 104]
SERVE_KW = dict(ENGINE_KW, mode="snapkv", max_gen=10, page_size=64)


def _serve_prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, KW["vocab_size"], size=n).astype(np.int32) for n in SERVE_LENS]


@functools.lru_cache(maxsize=None)
def _port_serve(paged, kv_quant):
    cls = PagedServingEngine if paged else ServingEngine
    eng = cls(_tiny_port_params(), TCFG_SPEC,
              EngineConfig(cache_dtype=torch.float32, kv_quant=kv_quant, **SERVE_KW),
              device="cpu")
    return eng, eng.serve(_serve_prompts(), B=2, windows_per_sync=2)


SERVE_CASES = [(False, False), (True, "int8")]


@pytest.mark.parametrize("paged,kv_quant", SERVE_CASES, ids=["contiguous", "paged_int8"])
def test_snapkv_serving_matches_jax(paged, kv_quant):
    import jax.numpy as jnp
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.serving import PagedServingEngine as JPaged
    from magicdec_tpu.engine.serving import ServingEngine as JServing
    from test_torch_engine import JCFG

    _, outs = _port_serve(paged, kv_quant)
    jeng = (JPaged if paged else JServing)(
        _jax_params(), JCFG, JEngineConfig(cache_dtype=jnp.float32, kv_quant=kv_quant,
                                           attn_backend="jnp", **SERVE_KW))
    jouts = jeng.serve(_serve_prompts(), B=2, windows_per_sync=2)
    assert len(outs) == len(jouts) == len(SERVE_LENS)
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o, np.asarray(j))


def test_snapkv_paged_matches_contiguous_and_solo_in_port():
    """The bf16-format (float32 here) pool against contiguous slots, and
    each of three int8-pool requests served alone through the same slots."""
    _, contig = _port_serve(False, False)
    eng = PagedServingEngine(_tiny_port_params(), TCFG_SPEC,
                             EngineConfig(cache_dtype=torch.float32, **SERVE_KW), device="cpu")
    for p, c in zip(eng.serve(_serve_prompts(), B=2, windows_per_sync=2), contig):
        np.testing.assert_array_equal(p, c)
    eng8, outs8 = _port_serve(True, "int8")
    for prompt, out in zip(_serve_prompts()[:3], outs8):
        np.testing.assert_array_equal(eng8.serve([prompt], B=2, windows_per_sync=2)[0], out)


# -- the benchmark entry points --------------------------------------------------------


@pytest.fixture
def tiny_model(monkeypatch):
    monkeypatch.setattr(tcfg.ModelConfig, "from_name",
                        classmethod(lambda cls, name: tcfg.tiny_config(**KW)))


def test_bench_snapkv_runs_on_cpu(tiny_model, capsys):
    """``bench --mode snapkv`` at a tiny size: the prefix rounds to a
    multiple of 128 plus 32 (300 -> 288), spec == AR, the metric is tagged
    ``selfspec_snapkv``."""
    import json

    out = bench.main(["--device", "cpu", "--model", "tiny", "--mode", "snapkv", "--B", "2",
                      "--prefix_len", "300", "--draft_budget", "65", "--prefill_chunk", "128",
                      "--max_gen", "8", "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "selfspec_snapkv_tokens_per_s_tiny_kvq8_dq8_B2_ctx288_torch"
    assert line["tokens_per_step"] >= 1.0
    n = out["spec_committed"]
    for b in range(2):
        m = min(int(n[b]), 8)
        np.testing.assert_array_equal(out["spec_output"][b, :m], out["base_output"][b, :m])
    assert bench.parse_args(["--mode", "snapkv"]).prefix_len == 8224
    assert bench.parse_args([]).prefix_len == 8192


def test_serving_bench_snapkv_runs_on_cpu(tiny_model, capsys):
    import json

    out = serving_bench.main(["--device", "cpu", "--model", "tiny", "--mode", "snapkv",
                              "--paged", "--kv_quant", "int8", "--slots", "2",
                              "--num_requests", "3", "--prefix_len", "170", "--max_len", "512",
                              "--page_size", "128", "--max_gen", "8", "--draft_budget", "65",
                              "--skip_warmup"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serving_paged_snapkv_tokens_per_s_tiny_slots2_ctx160_torch"
    assert [len(p) for p in out["prompts"]] == [160] * 3
    # a request stops at the window that reaches max_gen: 9 to 9 + gamma tokens
    assert all(9 <= len(o) <= 12 for o in out["outputs"]) and out["stats"]["served"] == 3


def test_serving_bench_snapkv_ragged_raises(tiny_model):
    """Ragged lengths break the shape contract: the encode raises, as the
    JAX package's asserts."""
    args = serving_bench.parse_args(["--device", "cpu", "--model", "tiny", "--mode", "snapkv",
                                     "--slots", "2", "--num_requests", "3", "--prefix_len",
                                     "170", "--ragged", "--max_len", "512", "--max_gen", "8",
                                     "--draft_budget", "65", "--skip_warmup"])
    with pytest.raises(ValueError, match="window .mod chunk_size."):
        serving_bench.run(args)
