"""The port's perplexity gate (``magicdec_tpu_torch/quality.py``) against
``magicdec_tpu.quality.perplexity`` on the same weights and windows (CPU):
the NLL to 1e-4 relative with a bf16 cache, an int8 and an int4 KV cache,
and float32 weights (another summation order, the same algorithm); a
quantized target's perplexity likewise; rows that do not fill a batch
dropped as there; a window shorter than a chunk runs as one chunk."""

import functools

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.quality import perplexity

KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
TCFG = tcfg.tiny_config(**KW)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, S, seed=0):
    return np.random.RandomState(seed).randint(0, KW["vocab_size"], size=(n, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _weights(bits):
    """(JAX params, port params): tests/test_torch_model.py's weights,
    quantized by the JAX package at ``bits`` (0: float32)."""
    import jax
    from magicdec_tpu import config as jcfg
    from magicdec_tpu import quantization as JQ
    from test_torch_model import _jax_tree, random_params

    jp = _jax_tree(random_params(jcfg.tiny_config(**KW)))
    if bits:
        jp = JQ.quantize_params(jp, bits=bits)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("bits", [0, 8], ids=["f32_weights", "int8_weights"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_perplexity_matches_jax(kv, bits):
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu.quality import perplexity as jax_perplexity

    jp, tp = _weights(bits)
    data = _windows(4, 64, seed=3)
    kv_quant = False if kv == "bf16" else kv
    ppl, nll = perplexity(tp, TCFG, data, batch_size=2, chunk_size=16,
                          cache_dtype=torch.bfloat16, kv_quant=kv_quant, device="cpu")
    jppl, jnll = jax_perplexity(jp, jcfg.tiny_config(**KW), data, batch_size=2, chunk_size=16,
                                cache_dtype=jnp.bfloat16, kv_quant=kv_quant)
    assert np.isfinite(nll) and nll > 0
    assert abs(nll - jnll) / jnll < 1e-4, (nll, jnll)
    assert abs(ppl - jppl) / jppl < 1e-4, (ppl, jppl)


def test_partial_batches_dropped_and_short_windows():
    _, tp = _weights(0)
    data = _windows(5, 32, seed=4)
    kw = dict(batch_size=2, chunk_size=16, cache_dtype=torch.float32, device="cpu")
    assert perplexity(tp, TCFG, data, **kw) == perplexity(tp, TCFG, data[:4], **kw)
    # a window shorter than the chunk is one chunk; no full batch raises
    short = perplexity(tp, TCFG, data[:2, :12], **kw)
    assert np.isfinite(short[1])
    with pytest.raises(ValueError, match="batch_size"):
        perplexity(tp, TCFG, data[:1], **kw)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        perplexity(tp, TCFG, data[:, :24], **kw)
