"""Quantized target weights in the port (``bench --quantize int8|int4``, a
converted ``-int8.npz`` / ``-int4.npz`` served by ``serving_bench --model``)
and the quantized embedding (``--quantize_embed``), on the CPU against the
JAX package.

- ``quantize_params`` leaves a quantized tree as it is (the JAX package's
  raises there: ROADMAP C); ``bits_from_path``; ``quantize_embed`` bit for
  bit, the quantized ``embed_lookup`` and tied head against the JAX
  package's.
- ``forward_target`` with int8 and int4 target weights against the JAX one
  at the t512 widths (dim 512, F 1024, heads 8/4, vocab 256, 2 layers), a
  decode step and a verify window at ``decode_rows`` = 8, both packages on
  their kernel backend (the JAX side's Pallas kernels in interpret mode):
  the port's routing reaches B4 (norm, residual), B9 and B6 (int8) or
  B4-int4 and B6-int4 (int4) on both passes; logits and caches to 1e-4,
  tokens exactly.
- Greedy spec == AR in the port on the kernel routes under int8, int4 and
  the quantized embedding, and the engine's tokens against the JAX
  engine's (the plain product on both sides, tiny widths).
- ``draft_quant`` on quantized target weights raises; the entry points:
  ``bench.setup`` with ``--quantize`` / ``--quantize_embed`` and
  ``serving_bench.setup --model <file>.npz`` on ``--device cpu``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import quant_matmul as QK
from magicdec_tpu_torch.models import llama as TM

TOL = dict(atol=1e-4, rtol=1e-4)
T512 = dict(vocab_size=256, n_layer=2, n_head=8, n_kv_head=4, dim=512, intermediate_size=1024)
TINY = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
WRAPPERS = ("quant_matmul", "quant_matmul_fused", "quant_layer_tail", "quant_mlp",
            "quant_matmul_int4", "quant_matmul_fused_int4")


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


@pytest.fixture
def calls(monkeypatch):
    """The names of the kernel wrappers the port's routing calls."""
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


def _jax_tree(tree):
    from test_torch_model import _jax_tree as jt

    return jt(tree)


@functools.lru_cache(maxsize=None)
def _quantized_pair(kw_items, bits, seed=0):
    """(JAX cfg, JAX quantized fused params, port cfg, port params moved
    from them) for ``tiny_config(**kw)`` weights quantized at ``bits`` by the
    JAX package (head included)."""
    from magicdec_tpu import config as jcfg
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.convert import params_from_jax
    from test_torch_model import random_params

    kw = dict(kw_items)
    jc = jcfg.tiny_config(**kw)
    jp = JM.fuse_exec_params(_jax_tree(random_params(jc, seed=seed)), jc)
    jq = JQ.quantize_params(jp, bits=bits)
    return jc, jq, tcfg.tiny_config(**kw), params_from_jax(_np_tree(jq))


# -- quantize_params, bits_from_path, the quantized embedding -------------------


def test_quantize_params_leaves_a_quantized_tree_as_it_is():
    """The port's ``quantize_params`` on an already-quantized tree is the
    identity, so a ``-int8.npz`` dump goes through ``serving_bench``; the JAX
    package's raises there (ROADMAP C: ``benchmarks/common.py:114-116``
    cannot serve its converter's own dump)."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import tiny_config

    cfg = tiny_config(dim=128, intermediate_size=256)
    params = make_params(cfg, device="cpu")
    for bits in (8, 4):
        qp = Q.quantize_params(params, bits=bits, include_embed=True)
        again = Q.quantize_params(qp, bits=8, include_embed=True, materialize_tied_head=True)
        assert again["embed"] is qp["embed"] and again["lm_head"] is qp["lm_head"]
        assert all(again["layers"][k] is v for k, v in qp["layers"].items())
        assert qp["layers"]["wq"].bits == bits and qp["embed"].bits == 8
    jq = JQ.quantize_params({"layers": {"wq": jnp.ones((128, 128), jnp.float32)}})
    with pytest.raises(AttributeError):
        JQ.quantize_params(jq)


def test_bits_from_path():
    assert Q.bits_from_path("/ckpt/llama-3.2-1b-int8.npz") == 8
    assert Q.bits_from_path("llama-3.2-1b-int4.npz") == 4
    assert Q.bits_from_path("llama-3.2-1b.npz") is None


def test_quantize_embed_matches_jax():
    """Bit for bit the JAX package's eager ``quantize_embed`` (it divides by
    127), and through ``quantize_params(include_embed=True)``; int4 is
    refused."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    e = (np.random.RandomState(0).randn(300, 64) * 0.7).astype(np.float32)
    t = torch.from_numpy(e).to(torch.bfloat16)
    want = JQ.quantize_embed(jnp.asarray(e, jnp.bfloat16))
    via_params = Q.quantize_params({"embed": t, "layers": {}}, include_embed=True)["embed"]
    for got in (Q.quantize_embed(t), via_params):
        assert tuple(got.q.shape) == (64, 300)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    with pytest.raises(ValueError, match="int8 only"):
        Q.quantize_embed(t, bits=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_embed_lookup_and_tied_head_match_jax(dtype):
    """The lookup (column t times its scale, then final_norm's dtype)
    exactly, and the tied head over the [D, V] table (the plain product
    here) to 1e-4, against the JAX package."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.models import llama as JM

    rng = np.random.RandomState(1)
    V, D = 96, 32
    embed = rng.randn(V, D).astype(np.float32)
    jq = JQ.quantize_embed(jnp.asarray(embed))
    tq = Q.quantize_embed(torch.from_numpy(embed))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tp = {"embed": tq, "final_norm": torch.ones(D, dtype=tdt), "lm_head": None}
    jp = {"embed": jq, "final_norm": jnp.ones((D,), jdt), "lm_head": None}
    toks = rng.randint(0, V, (2, 5))
    got = TM.embed_lookup(tp, torch.from_numpy(toks))
    want = JM.embed_lookup(jp, jnp.asarray(toks, jnp.int32))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    x = rng.randn(2, 3, D).astype(np.float32)
    np.testing.assert_allclose(TM.head_logits(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(JM.head_logits(jp, jnp.asarray(x))), **TOL)


# -- forward_target on quantized target weights against the JAX package -------


@pytest.mark.parametrize("bits,T", [(8, 4), (8, 1), (4, 4)],
                         ids=["int8-verify", "int8-ar_step", "int4-verify"])
def test_forward_target_quantized_matches_jax(bits, T, pallas, calls):
    """A decode step and a verify window over a prefilled int8 KV cache at
    ``decode_rows`` = 8 rows (B=2, gamma 3), both packages' dots on their
    kernels: logits and the appended caches to 1e-4, tokens exactly; the
    port's pass reached the target's kernels."""
    import jax.numpy as jnp
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy

    jc, jq, tc, tq = _quantized_pair(tuple(T512.items()), bits)
    rng = np.random.RandomState(5)
    B, S, P = 2, 64, 24
    K = jc.n_kv_head * jc.head_dim
    caches = {n: rng.randint(-127, 128, (jc.n_layer, B, S, K)).astype(np.int8) for n in "kv"}
    caches.update({n: (rng.rand(jc.n_layer, B, jc.n_kv_head, S) * 0.02).astype(np.float32)
                   for n in ("ks", "vs")})
    tokens = rng.randint(0, jc.vocab_size, (B, T)).astype(np.int32)
    base = np.array([P, P - 7], np.int32)
    lj, jcache = JM.forward_target(jq, dataclasses.replace(jc, decode_rows=8),
                                   jnp.asarray(tokens), jnp.asarray(base),
                                   {n: jnp.asarray(a) for n, a in caches.items()},
                                   head="logits")
    lt, tcache = TM.forward_target(tq, dataclasses.replace(tc, decode_rows=8),
                                   torch.from_numpy(tokens), torch.from_numpy(base),
                                   caches_from_jax(caches), head="logits")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(), np.asarray(lj).argmax(-1))
    got = caches_to_numpy(tcache)
    for name in ("ks", "vs"):
        np.testing.assert_allclose(got[name], np.asarray(jcache[name]), **TOL)
    for name in "kv":  # int8 rows: one quantization step where a value sits on an edge
        assert np.abs(got[name].astype(np.int32) - np.asarray(jcache[name], np.int32)).max() <= 1
    want = ({"quant_matmul_fused", "quant_mlp", "quant_matmul"} if bits == 8
            else {"quant_matmul_fused_int4", "quant_matmul_int4"})
    assert set(calls) == want, calls


# -- the engine: spec == AR on the kernel routes, tokens against the JAX engine


def _engine_kw(**kw):
    base = dict(gamma=3, draft_budget=65, max_seq_len=256, chunk_size=32, sink_size=8,
                max_gen=14, eot_ids=(-1,), cache_dtype=torch.float32, kv_quant="int8")
    base.update(kw)
    return base


@pytest.mark.parametrize("variant", ["int8", "int4", "embed"])
def test_quantized_target_spec_matches_autoregressive(variant, pallas, calls):
    """Greedy spec == greedy AR on the t512 widths, the target's dots on
    the kernel routes: int8 / int4 target weights (the draft sharing them,
    its tail on B5 under int8), or bf16 weights with the quantized
    embedding tied to the head (B6 over the [D, V] table on every pass; the
    int8 draft copy's prefill FFN on B9)."""
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config(**T512)
    params = make_params(cfg, dtype=torch.float32, device="cpu", tied=variant == "embed")
    draft_quant = False
    if variant == "embed":
        params = dict(params, embed=Q.quantize_embed(params["embed"]))
        draft_quant = "int8"
    else:
        params = Q.quantize_params(params, bits=8 if variant == "int8" else 4)
    eng = SpecEngine(params, cfg, EngineConfig(draft_quant=draft_quant, **_engine_kw()),
                     device="cpu")
    assert eng._hinted(2).decode_rows == 8
    prompt = np.random.RandomState(23).randint(0, cfg.vocab_size, (2, 64))
    _, spec = eng.generate(eng.encode(prompt))
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=14)
    n = spec["num_committed"].numpy()
    assert n.max() >= 14
    for b in range(2):
        m = min(int(n[b]), 14)
        np.testing.assert_array_equal(spec["output"].numpy()[b, :m],
                                      base["output"].numpy()[b, :m])
    want = {"int8": {"quant_matmul_fused", "quant_mlp", "quant_matmul", "quant_layer_tail"},
            "int4": {"quant_matmul_fused_int4", "quant_matmul_int4"},
            "embed": {"quant_matmul_fused", "quant_layer_tail", "quant_matmul", "quant_mlp"}
            }[variant]
    assert set(calls) == want, set(calls)


@pytest.mark.parametrize("variant", ["int8", "int4", "embed"])
def test_quantized_target_engine_matches_jax(variant):
    """The port's engine on quantized target weights (or the quantized
    embedding) commits the JAX engine's spec tokens on the same weights and
    prompt, and its AR stream equals them, the plain product on both sides
    ("jnp")."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    if variant == "embed":
        from magicdec_tpu import config as jcfg
        from magicdec_tpu.models import llama as JM
        from magicdec_tpu_torch import config as tcfg
        from test_torch_model import random_params

        jc, tc = jcfg.tiny_config(**TINY), tcfg.tiny_config(**TINY)
        jp = JM.fuse_exec_params(_jax_tree(random_params(jc)), jc)
        jp = dict(jp, embed=JQ.quantize_embed(jp["embed"]))
    else:
        jc, jp, tc, _ = _quantized_pair(tuple(TINY.items()), 8 if variant == "int8" else 4)
    tp = params_from_jax(_np_tree(jp))
    kw = _engine_kw(draft_budget=33, chunk_size=16, sink_size=4, max_gen=16, kv_quant=False)
    prompt = np.random.RandomState(7).randint(0, jc.vocab_size, (2, 48))
    old = Q.matmul_backend()
    Q.set_matmul_backend("jnp")
    try:
        eng = SpecEngine(tp, tc, EngineConfig(**kw), device="cpu")
        _, spec = eng.generate(eng.encode(prompt))
        _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=16)
    finally:
        Q.set_matmul_backend(old)
    jkw = dict(kw, cache_dtype=jnp.float32)
    jeng = JSpecEngine(jp, jc, JEngineConfig(mode="streamingllm", **jkw))
    _, jspec = jeng.generate(jeng.encode(jnp.asarray(prompt, jnp.int32)))
    for key in ("output", "num_committed", "target_steps"):
        np.testing.assert_array_equal(spec[key].numpy(), np.asarray(jspec[key]), err_msg=key)
    n = spec["num_committed"].numpy()
    for b in range(2):  # and the port's AR stream, as the JAX engine's spec commits it
        m = min(int(n[b]), 16)
        np.testing.assert_array_equal(base["output"].numpy()[b, :m],
                                      np.asarray(jspec["output"])[b, :m])


def test_draft_quant_on_quantized_target_raises():
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config()
    params = Q.quantize_params(make_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="draft shares the target's quantized weights"):
        SpecEngine(params, cfg, EngineConfig(draft_quant="int8", **_engine_kw()), device="cpu")
    eng = SpecEngine(params, cfg, EngineConfig(**_engine_kw()), device="cpu")
    assert eng.draft_params is eng.params


# -- the entry points ------------------------------------------------------------


BENCH_CPU = ["--device", "cpu", "--model", "68m", "--B", "2", "--prefix_len", "512",
             "--draft_budget", "257", "--prefill_chunk", "128", "--max_gen", "16",
             "--iters", "1"]


@pytest.mark.parametrize("flags", [["--quantize", "int8"], ["--quantize", "int4"],
                                   ["--quantize", "int8", "--quantize_embed"],
                                   ["--quantize_embed"]],
                         ids=["int8", "int4", "int8_embed", "embed"])
def test_bench_setup_quantized_target(flags, capsys):
    """``bench.setup``: --quantize builds the target layer by layer, equal
    bit for bit to ``quantize_params`` of the same draws, with a quantized
    head, and turns the draft copy off (its metric loses the _dq tag);
    --quantize_embed alone keeps the bf16 layers and the int8 draft copy."""
    from magicdec_tpu_torch import bench
    from magicdec_tpu_torch.config import ModelConfig

    args = bench.parse_args(BENCH_CPU + flags)
    engine, prompts = bench.setup(args)
    p = engine.params
    assert Q.is_quantized(p["embed"]) == ("--quantize_embed" in flags)
    if "--quantize" not in flags:
        assert not Q.is_quantized(p["layers"]["wqkv"]) and p["lm_head"].dtype == torch.bfloat16
        assert Q.is_quantized(engine.draft_params["layers"]["wqkv"])
        assert bench.metric_name(args).endswith("_kvq8_dq8_B2_ctx512_torch")
        return
    bits = 8 if flags[1] == "int8" else 4
    assert "draft_quant disabled" in capsys.readouterr().err
    assert engine.draft_params is p and args.draft_quant == "none"
    assert bench.metric_name(args) == f"selfspec_streamingllm_tokens_per_s_68m_int{bits}_kvq8_B2_ctx512_torch"
    assert p["lm_head"].bits == bits and tuple(p["lm_head"].q.shape)[-1] == 32000
    # the same draws stacked in bf16, then quantize_params
    cfg = ModelConfig.from_name("68m")
    gen = torch.Generator().manual_seed(0)
    layers = [bench._fused_layer(bench._synth_layer(gen, cfg, torch.device("cpu")))
              for _ in range(cfg.n_layer)]
    ref = Q.quantize_params({"layers": {k: torch.stack([lw[k] for lw in layers])
                                        for k in layers[0]}}, bits=bits)
    for k, w in ref["layers"].items():
        assert torch.equal(p["layers"][k].q, w.q) and torch.equal(p["layers"][k].scale, w.scale)


def test_serving_setup_loads_a_converted_file(tmp_path, capsys):
    """``serving_bench.setup --model <dir>/68m.npz`` serves the converted
    bf16 weights; ``--model <dir>/68m-int8.npz`` the dump as quantized
    verify weights, its scales rounded through bf16 as the JAX benchmarks load
    them, the draft sharing them and --draft_quant turned off."""
    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.utils.checkpoint import save_converted

    cfg = ModelConfig.from_name("68m")
    params = make_params(cfg, device="cpu", tied=True)
    save_converted(params, tmp_path / "68m.npz")
    qparams = Q.quantize_params(params, bits=8)
    save_converted(qparams, tmp_path / "68m-int8.npz")
    argv = ["--device", "cpu", "--slots", "2", "--num_requests", "2", "--prefix_len", "256",
            "--max_len", "512", "--max_gen", "8", "--draft_quant", "int8"]
    engine, prompts = serving_bench.setup(
        serving_bench.parse_args(argv + ["--model", str(tmp_path / "68m.npz")]))
    assert torch.equal(engine.params["embed"], params["embed"])
    assert engine.params["lm_head"] is None and len(prompts) == 2
    assert Q.is_quantized(engine.draft_params["layers"]["wqkv"])
    args = serving_bench.parse_args(argv + ["--model", str(tmp_path / "68m-int8.npz")])
    engine, _ = serving_bench.setup(args)
    assert args.draft_quant is None and "draft_quant disabled" in capsys.readouterr().err
    assert engine.draft_params is engine.params
    w = engine.params["layers"]["w2"]
    assert Q.is_quantized(w) and torch.equal(w.q, qparams["layers"]["w2"].q)
    assert torch.equal(w.scale, qparams["layers"]["w2"].scale.to(torch.bfloat16).float())
