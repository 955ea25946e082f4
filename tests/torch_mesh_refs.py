"""The JAX package's references for the port's mesh tests
(tests/test_torch_sharding.py, test_torch_sharding_quant.py,
test_torch_serving_mesh.py, test_torch_multihost.py): its single-device
autoregressive run.  Every mode of speculation commits the target's greedy
(or, with one key, sampled) tokens, which equal its autoregressive tokens
(tests/test_spec_parity.py, tests/test_sampling_spec.py), so one
autoregressive compile a cache format serves every case of that format:
the port's committed tokens must equal it wherever the port committed.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from magicdec_tpu import config as jcfg
from magicdec_tpu.engine.engine import EngineConfig, SpecEngine
from test_torch_model import _jax_tree

MAX_GEN, GAMMA = 8, 3
MAX_NEW = MAX_GEN + GAMMA + 1  # every token a window can commit past max_gen


def ecfg(**kw):
    base = dict(mode="streamingllm", gamma=GAMMA, draft_budget=33, max_seq_len=256,
                chunk_size=16, window_size=8, sink_size=4, max_gen=MAX_GEN, eot_ids=(-1,),
                cache_dtype=jnp.float32)
    base.update(kw)
    return EngineConfig(**base)


@functools.lru_cache(maxsize=None)
def engine(weights_key, cfg_kw, ecfg_kw=()):
    """The JAX package's engine (one a weights, config and cache format)."""
    return SpecEngine(_jax_tree(_WEIGHTS[weights_key]), jcfg.tiny_config(**dict(cfg_kw)),
                      ecfg(**dict(ecfg_kw)))


_WEIGHTS = {}


def register(name, weights):
    """Weights (a numpy tree) the references may name."""
    _WEIGHTS[name] = weights


@functools.lru_cache(maxsize=None)
def ar(weights_key, cfg_kw, prompts, ecfg_kw=(), max_new=MAX_NEW, rng=None):
    """The JAX package's autoregressive output [B, out_cap] for ``prompts``
    (a tuple of int tuples, one a request), its key ``rng`` under sampling."""
    eng = engine(weights_key, tuple(sorted(dict(cfg_kw).items())), tuple(sorted(ecfg_kw)))
    p = jnp.asarray(np.asarray(prompts, np.int32))
    key = None if rng is None else jax.random.PRNGKey(rng)
    _, out = eng.generate_baseline(eng.encode_baseline(p, rng=key), max_new=max_new)
    return np.asarray(out["output"])


def committed_equal(output, num_committed, ref):
    """Each request's committed tokens equal the reference's."""
    for b in range(output.shape[0]):
        n = int(num_committed[b])
        assert n >= 1
        np.testing.assert_array_equal(output[b, :n], ref[b, :n])
