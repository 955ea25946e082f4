"""Exact speculative sampling in the port (CPU, plain kernel versions), the
gates of tests/test_sampling_spec.py and tests/test_paged_serving.py:86.

- Spec sampling == baseline sampling token for token with the same key, in
  the three self-speculation cases (streamingllm at prefixes 96 and 32, the
  second with top-p 0.9; snapkv at 104) and the two standalone-draft cases
  (full 48, streamingllm 96); one self-spec case and one longspec case also
  equal the JAX package's sampled baseline on the same weights, prompt and
  key.  Sampling without a key raises; greedy leaves rng and salt None.
- Serving: each request served sampled (request id = salt) equals a B=1
  ``SpecEngine`` (``LongSpecEngine`` for the twin) run of its prompt with
  that salt, for ``ServingEngine``, ``PagedServingEngine`` and
  ``PagedServingLongSpecEngine``.

The drivers' sampled runs at ``--device cpu`` are in
tests/test_torch_serving.py and tests/test_torch_longspec_serving.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magicdec_tpu import config as jcfg
from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
from magicdec_tpu.engine.engine import SpecEngine as JSpecEngine
from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.engine.engine import EngineConfig, LongSpecEngine, SpecEngine
from magicdec_tpu_torch.engine.serving import (PagedServingEngine, PagedServingLongSpecEngine,
                                               ServingEngine)
from magicdec_tpu_torch.ops.prng import PRNGKey
from test_torch_longspec import DKW, DRAFT, KW, TARGET

SEED = 1234
B = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ecfg_kw(mode, *, temperature, top_p=1.0, max_gen=24, **kw):
    return dict(mode=mode, gamma=3, draft_budget=33, max_seq_len=256, chunk_size=16,
                window_size=8, sink_size=4, max_gen=max_gen, eot_ids=(-1,),
                temperature=temperature, top_p=top_p, **kw)


def _ecfg(mode, **kw):
    return EngineConfig(cache_dtype=torch.float32, **_ecfg_kw(mode, **kw))


def _prompt(prefix, seed):
    # tests/test_spec_parity.py _prompt's tokens
    return np.random.RandomState(seed).randint(0, KW["vocab_size"], size=(B, prefix))


@functools.lru_cache(maxsize=None)
def _port_params():
    return params_from_jax(TARGET), params_from_jax(DRAFT)


def _committed(stats, b, max_gen):
    n = min(int(stats["num_committed"][b]), max_gen)
    return np.asarray(stats["output"][b, :n])


def _port_baseline(engine, prompt, n):
    st = engine.encode_baseline(prompt, rng=PRNGKey(SEED))
    _, stats = engine.generate_baseline(st, max_new=n)
    return stats["output"][:, :n].numpy()


def _jax_baseline(mode, prompt, n, **kw):
    params = jax.tree_util.tree_map(jnp.asarray, TARGET)
    ecfg = JEngineConfig(cache_dtype=jnp.float32,
                         **_ecfg_kw("streamingllm" if mode == "full" else mode, **kw))
    engine = JSpecEngine(params, jcfg.tiny_config(**KW), ecfg)
    st = engine.encode_baseline(jnp.asarray(prompt, jnp.int32), rng=jax.random.PRNGKey(SEED))
    _, stats = engine.generate_baseline(st, max_new=n)
    return np.asarray(stats["output"][:, :n])


def _check_spec(stats, ref, max_gen, what):
    assert int(stats["num_committed"].max()) >= max_gen
    for b in range(B):
        out = _committed(stats, b, max_gen)
        np.testing.assert_array_equal(out, ref[b, :len(out)],
                                      err_msg=f"sampling exactness broken ({what})")


@pytest.mark.parametrize("mode,prefix,top_p,against_jax", [
    ("streamingllm", 96, 1.0, True),
    ("streamingllm", 32, 0.9, False),
    ("snapkv", 104, 1.0, False),
])
def test_selfspec_sampling_matches_baseline_sampling(mode, prefix, top_p, against_jax):
    max_gen = 24
    kw = dict(temperature=0.8, top_p=top_p, max_gen=max_gen)
    engine = SpecEngine(_port_params()[0], tcfg.tiny_config(**KW), _ecfg(mode, **kw),
                        device="cpu")
    prompt = _prompt(prefix, seed=5)
    ref = _port_baseline(engine, prompt, max_gen)
    _, stats = engine.generate(engine.encode(prompt, rng=PRNGKey(SEED)))
    _check_spec(stats, ref, max_gen, f"{mode} top_p={top_p}")
    if against_jax:
        np.testing.assert_array_equal(ref, _jax_baseline(mode, prompt, max_gen, **kw))


@pytest.mark.parametrize("mode,prefix,against_jax", [("full", 48, False),
                                                     ("streamingllm", 96, True)])
def test_longspec_sampling_matches_baseline_sampling(mode, prefix, against_jax):
    max_gen = 20
    kw = dict(temperature=0.7, max_gen=max_gen)
    target, draft = _port_params()
    engine = LongSpecEngine(target, tcfg.tiny_config(**KW), draft, tcfg.tiny_config(**DKW),
                            _ecfg(mode, **kw), device="cpu")
    prompt = _prompt(prefix, seed=9)
    ref = _port_baseline(engine, prompt, max_gen)
    _, stats = engine.generate(engine.encode(prompt, rng=PRNGKey(SEED)))
    _check_spec(stats, ref, max_gen, f"longspec {mode}")
    if against_jax:
        np.testing.assert_array_equal(ref, _jax_baseline(mode, prompt, max_gen, **kw))


def test_sampling_requires_rng():
    engine = SpecEngine(_port_params()[0], tcfg.tiny_config(**KW),
                        _ecfg("streamingllm", temperature=0.8), device="cpu")
    with pytest.raises(ValueError, match="rng"):
        engine.encode(_prompt(32, 0))
    with pytest.raises(ValueError, match="rng"):
        engine.encode_baseline(_prompt(32, 0))


def test_greedy_unaffected_by_sampling_fields():
    """temperature 0 keeps the argmax heads: rng and salt None, the tokens
    those of an engine built without the sampling fields."""
    prompt = _prompt(32, 0)
    engine = SpecEngine(_port_params()[0], tcfg.tiny_config(**KW),
                        _ecfg("streamingllm", temperature=0.0, top_p=0.9), device="cpu")
    st = engine.encode(prompt, rng=PRNGKey(SEED), salt=[3, 4])
    assert st.rng is None and st.salt is None
    plain = SpecEngine(_port_params()[0], tcfg.tiny_config(**KW),
                       EngineConfig(cache_dtype=torch.float32,
                                    **{k: v for k, v in _ecfg_kw("streamingllm",
                                                                 temperature=0.0).items()
                                       if k not in ("temperature", "top_p")}),
                       device="cpu")
    _, got = engine.generate(st)
    _, want = plain.generate(plain.encode(prompt))
    torch.testing.assert_close(got["output"], want["output"], rtol=0, atol=0)
    assert engine.encode_baseline(prompt).rng is None


SERVE_LENS = [48, 96, 48, 64]


@pytest.mark.parametrize("cls", [ServingEngine, PagedServingEngine, PagedServingLongSpecEngine],
                         ids=["contiguous", "paged", "paged_longspec"])
def test_sampled_serving_matches_solo_by_salt(cls):
    """Per-request salts (request ids) survive admission buckets and slot
    recycling: each request's tokens equal its prompt alone through a B=1
    engine with that salt (tests/test_paged_serving.py:86)."""
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, KW["vocab_size"], size=n).astype(np.int32) for n in SERVE_LENS]
    target, draft = _port_params()
    ecfg = _ecfg("streamingllm", temperature=0.8, top_p=0.9, max_gen=8, page_size=64)
    longspec = cls is PagedServingLongSpecEngine
    pair = ((target, tcfg.tiny_config(**KW), draft, tcfg.tiny_config(**DKW)) if longspec
            else (target, tcfg.tiny_config(**KW)))
    outs = cls(*pair, ecfg, device="cpu").serve(prompts, B=2, windows_per_sync=2,
                                                rng=PRNGKey(0))
    solo = (LongSpecEngine if longspec else SpecEngine)(*pair, ecfg, device="cpu")
    for rid, (prompt, out) in enumerate(zip(prompts, outs)):
        st = solo.encode(prompt[None], rng=PRNGKey(0), salt=[rid])
        _, stats = solo.generate(st)
        n = int(stats["num_committed"][0])
        np.testing.assert_array_equal(out, stats["output"][0, :n].numpy(),
                                      err_msg=f"request {rid}")
