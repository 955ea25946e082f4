"""The engine on the int4 capacity formats (``EngineConfig.kv_quant="int4"``
and ``draft_quant="int4"``, the bench's ``--kv_quant int4 --draft_quant
int4``), on the CPU against the JAX package: greedy spec tokens equal
greedy autoregressive tokens, and both equal the JAX engine's, with the
int4 target cache alone and with the int4 draft copy (tiny_config widths,
both packages' plain products), and with the int4 draft copy over the int8
cache on both packages' kernel routes (the t512 widths of
tests/test_torch_weight_int4.py, where the JAX package's routing reaches
its Pallas kernels, run in interpret mode).  Tokens exactly.
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_weight_int4 as W
from magicdec_tpu_torch import quantization as Q


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _kv_engine_runs(draft_quant):
    """(port spec, port AR, JAX spec, JAX AR) stats at prefix 96 (the
    sink+window eviction active) with an int4 target cache, on
    tests/test_spec_parity.py's weights; ``draft_quant`` "int4" adds the
    int4 draft copy (groups of 64 and 128 rows at these widths, on both
    packages' plain products)."""
    import jax.numpy as jnp
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from test_torch_engine import ENGINE_KW, JCFG, MAX_GEN, PARAMS, TCFG, _prompt

    eng = SpecEngine(params_from_jax(PARAMS), TCFG,
                     EngineConfig(cache_dtype=torch.float32, kv_quant="int4",
                                  draft_quant=draft_quant, **ENGINE_KW), device="cpu")
    prompt = _prompt(96)
    st = eng.encode(prompt)
    assert st.k.shape[-1] == (TCFG.n_kv_head // 2) * TCFG.head_dim and st.k.dtype == torch.int8
    assert st.dk.dtype == torch.float32  # the draft cache stays in cache_dtype
    _, spec = eng.generate(st)
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=MAX_GEN)
    jparams = {k: ({n: None if a is None else jnp.asarray(a) for n, a in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v)) for k, v in PARAMS.items()}
    jeng = JSpecEngine(jparams, JCFG, JEngineConfig(mode="streamingllm", kv_quant="int4",
                                                    draft_quant=draft_quant,
                                                    cache_dtype=jnp.float32, **ENGINE_KW))
    jprompt = jnp.asarray(prompt, jnp.int32)
    _, jspec = jeng.generate(jeng.encode(jprompt))
    _, jbase = jeng.generate_baseline(jeng.encode_baseline(jprompt), max_new=MAX_GEN)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec), as_np(jbase), MAX_GEN


@pytest.mark.parametrize("draft_quant", [False, "int4"], ids=["kv4", "kv4_dq4"])
def test_int4_engine_spec_matches_autoregressive(draft_quant):
    spec, base, _, _, max_gen = _kv_engine_runs(draft_quant)
    n = spec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(len(n)):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])


@pytest.mark.parametrize("draft_quant", [False, "int4"], ids=["kv4", "kv4_dq4"])
def test_int4_engine_matches_jax(draft_quant):
    spec, base, jspec, jbase, max_gen = _kv_engine_runs(draft_quant)
    for key in ("output", "num_committed", "target_steps"):
        np.testing.assert_array_equal(spec[key], jspec[key], err_msg=key)
    np.testing.assert_array_equal(base["output"][:, :max_gen], jbase["output"][:, :max_gen])


@functools.lru_cache(maxsize=None)
def _draft_engine_runs():
    """(port spec, port AR, JAX spec, JAX AR) stats with the int4 draft copy
    on both kernel routes (the int8 target cache of the bench's default),
    prefix 96 (the sink+window eviction active)."""
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from test_torch_engine import ENGINE_KW, MAX_GEN

    jcfg, jparams, _, jnp = W._jax_t512()
    tcfg, _ = W._t512_draft()
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, size=(2, 96))
    kw = dict(ENGINE_KW, draft_quant="int4", kv_quant="int8")
    old_j, old_t = JQ._MATMUL_BACKEND, Q.matmul_backend()
    JQ.set_matmul_backend("pallas")
    Q.set_matmul_backend("pallas")
    try:
        eng = SpecEngine(params_from_jax(W._np_tree(jparams)), tcfg,
                         EngineConfig(cache_dtype=torch.float32, **kw), device="cpu")
        assert eng.draft_params["layers"]["wqkv"].bits == 4
        assert not Q.is_quantized(eng.params["layers"]["wqkv"])
        _, spec = eng.generate(eng.encode(prompt))
        _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=MAX_GEN)
        jeng = JSpecEngine(jparams, jcfg, JEngineConfig(mode="streamingllm",
                                                        cache_dtype=jnp.float32, **kw))
        jprompt = jnp.asarray(prompt, jnp.int32)
        _, jspec = jeng.generate(jeng.encode(jprompt))
        _, jbase = jeng.generate_baseline(jeng.encode_baseline(jprompt), max_new=MAX_GEN)
    finally:
        JQ.set_matmul_backend(old_j)
        Q.set_matmul_backend(old_t)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(spec), as_np(base), as_np(jspec), as_np(jbase), MAX_GEN


def test_int4_draft_engine_spec_matches_autoregressive():
    spec, base, _, _, max_gen = _draft_engine_runs()
    n = spec["num_committed"]
    assert n.max() >= max_gen, n
    for b in range(len(n)):
        m = min(int(n[b]), max_gen)
        np.testing.assert_array_equal(spec["output"][b, :m], base["output"][b, :m])


def test_int4_draft_engine_matches_jax():
    spec, base, jspec, jbase, max_gen = _draft_engine_runs()
    for key in ("output", "num_committed", "target_steps"):
        np.testing.assert_array_equal(spec[key], jspec[key], err_msg=key)
    np.testing.assert_array_equal(base["output"][:, :max_gen], jbase["output"][:, :max_gen])
