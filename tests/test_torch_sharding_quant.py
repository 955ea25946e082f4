"""The port's mesh engines on the kernel paths' formats against the JAX
package: the counterparts of tests/test_sharding_flash.py (the int8 and
int4 caches, SnapKV over int8, the sampled head, odd local int4 heads
refused) and tests/test_sharding_quant.py (the int8 and int4 draft copies,
the standalone draft's int8 copy).  The port has one kernel path on every
mesh, so the JAX package's flash and jnp mesh variants share a port case.
One spawn of 8 gloo ranks runs every case (``torch_mesh_cases.py``) while
the JAX package's single-device references run here (``torch_mesh_refs.py``:
its autoregressive tokens, which every speculation mode commits, sampled
with the same key where the case samples); tokens must be equal.
"""

import numpy as np
import pytest

from magicdec_tpu import config as jcfg
from test_torch_model import random_params
from torch_mesh_cases import Spawn, prompt
from torch_mesh_refs import MAX_GEN, ar, committed_equal, register

KW = dict(vocab_size=128, n_layer=1, n_head=8, n_kv_head=4, dim=64, intermediate_size=128)
DKW = dict(vocab_size=128, n_layer=1, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
WEIGHTS = {"main": random_params(jcfg.tiny_config(**KW), seed=5, fan_in=False),
           "draft": random_params(jcfg.tiny_config(**DKW), seed=42, fan_in=False)}
register("quant/main", WEIGHTS["main"])
SAMPLED = {"temperature": 0.8, "top_p": 0.9}


def _engine(mesh=("mesh", 2, 4), **kw):
    base = dict(kind="engine", mesh=mesh, cfg=KW, weights="main", prompt=(4, 32, 0))
    base.update(kw)
    return base


CASES = [
    ("kv_int8", _engine(ecfg={"kv_quant": "int8"}, baseline=MAX_GEN)),
    ("kv_int4_model2", _engine(mesh=("mesh", 2, 2), ecfg={"kv_quant": "int4"})),
    ("snapkv_int8", _engine(ecfg={"mode": "snapkv", "kv_quant": "int8"}, prompt=(4, 40, 0))),
    ("sampled", _engine(ecfg=SAMPLED, rng=11, prompt=(4, 32, 7))),
    ("int4_odd_heads", dict(kind="int4_odd_heads", mesh=("mesh", 2, 4), cfg=KW,
                            weights="main")),
    ("draft_int8", _engine(ecfg={"draft_quant": "int8"})),
    ("draft_int4", _engine(ecfg={"draft_quant": "int4"})),
    ("longspec_draft_int8", _engine(mesh=("mesh", 2, 2), draft="draft", draft_cfg=DKW,
                                    ecfg={"mode": "full", "draft_quant": "int8"},
                                    prompt=(4, 32, 7))),
]


def _ar(name, **kw):
    """The JAX package's autoregressive tokens of case ``name``'s target: its
    cache format and sampling (a draft, its copy or its cache mode change
    which tokens are proposed, not which are committed)."""
    spec = dict(CASES)[name]
    e = spec.get("ecfg", {})
    fmt = tuple((k, v) for k, v in e.items() if k in ("kv_quant", "temperature", "top_p"))
    rows = tuple(map(tuple, prompt(*spec["prompt"]).tolist()))
    return ar("quant/main", tuple(KW.items()), rows, ecfg_kw=fmt, rng=spec.get("rng"), **kw)


REF_CASES = [name for name, spec in CASES if spec["kind"] == "engine"]


@pytest.fixture(scope="module")
def ranks():
    job = Spawn(CASES, WEIGHTS, world=8)
    for name in REF_CASES:  # the JAX references, while the ranks run
        _ar(name)
    return job.result()


def _ok(ranks, name):
    res = ranks[name]
    assert "error" not in res, res.get("error")
    assert res["ranks_agree"], f"{name}: the ranks of one mesh disagree"
    return res


@pytest.mark.parametrize("name", ["kv_int8", "kv_int4_model2", "snapkv_int8"])
def test_mesh_spec_matches_single_device(ranks, name):
    """The quantized caches at each rank's local heads (int4: 4 kv heads over
    2 model ranks, a packed pair a rank)."""
    res = _ok(ranks, name)
    committed_equal(res["output"], res["num_committed"], _ar(name))


def test_mesh_quantized_cache_is_local(ranks):
    """int8: this rank's 2 of 4 requests and 1 of 4 kv heads, scales too;
    int4: 2 heads packed into one head's bytes."""
    assert _ok(ranks, "kv_int8")["state_shapes"]["ks"] == (1, 2, 1, 256)
    assert _ok(ranks, "kv_int4_model2")["state_shapes"]["k"] == (1, 2, 256, 8)


def test_mesh_baseline_matches_single_device(ranks):
    res = _ok(ranks, "kv_int8")
    np.testing.assert_array_equal(res["base_output"], _ar("kv_int8", max_new=MAX_GEN))


def test_mesh_sampled_matches_single_device(ranks):
    """Gumbel-coupled sampling: every rank assembles the whole logits row
    (top-p reads it) and draws the same noise; the salts follow the data
    split."""
    res = _ok(ranks, "sampled")
    committed_equal(res["output"], res["num_committed"], _ar("sampled"))


def test_mesh_int4_kv_rejects_odd_local_heads(ranks):
    assert _ok(ranks, "int4_odd_heads")["raised"]


@pytest.mark.parametrize("name,bits", [("draft_int8", 8), ("draft_int4", 4)])
def test_sharded_selfspec_draft_quant_matches_single_device(ranks, name, bits):
    """The draft copy quantized from the whole weights, then split: wqkv's
    local columns (2 + 1 + 1 heads of 8 of 4 ranks' 16 + 8 + 8)."""
    res = _ok(ranks, name)
    assert res["draft_wqkv"] == ("QuantizedWeight", (1, 64 // (2 if bits == 4 else 1), 32))
    committed_equal(res["output"], res["num_committed"], _ar(name))


def test_sharded_longspec_draft_quant_matches_single_device(ranks):
    res = _ok(ranks, "longspec_draft_int8")
    assert res["draft_wqkv"][0] == "QuantizedWeight"
    committed_equal(res["output"], res["num_committed"], _ar("longspec_draft_int8"))
