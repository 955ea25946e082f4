"""Served == solo against the JAX package's own contract
(tests/test_paged_serving.py ``_solo``): each request served through the
port's ``PagedServingEngine`` gets the tokens of a fixed-batch
``SpecEngine`` run at B=1 on the same prompt and weights (CPU, float32,
plain kernel versions, int8 pool, tokens exact).  Two streams: 4 requests
of distinct lengths, and 4 of one length, which one admission bucket
prefills together at 4x the chunk's rows.  ``chip_smoke.py`` runs the same
two checks on the card."""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
from magicdec_tpu_torch.engine.serving import PagedServingEngine
from test_torch_serving import ENGINE_KW, KW, PARAMS, TCFG

SLOTS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solo(engine, prompt):
    """The request alone through a B=1 SpecEngine (the JAX contract's
    reference): its committed tokens, the prefill's first one included."""
    st = engine.encode(np.asarray(prompt)[None])
    _, stats = engine.generate(st)
    n = int(stats["num_committed"][0])
    return stats["output"][0, :n].numpy()


@pytest.mark.parametrize("lens", [[48, 96, 144, 112], [96, 96, 96, 96]],
                         ids=["distinct_lengths", "one_bucket"])
def test_served_matches_b1_spec_engine(lens):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, KW["vocab_size"], size=n).astype(np.int32) for n in lens]
    ecfg = EngineConfig(cache_dtype=torch.float32, kv_quant="int8", **ENGINE_KW)
    params = params_from_jax(PARAMS)
    served = PagedServingEngine(params, TCFG, ecfg, device="cpu")
    outs = served.serve(prompts, B=SLOTS, windows_per_sync=2)
    if len(set(lens)) == 1:  # all four in one admission wave, one bucket
        assert served.last_serve_stats["admission_waves"] == 1
    solo = SpecEngine(params, TCFG, ecfg, device="cpu")
    for prompt, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, _solo(solo, prompt))
