"""The port's tensor- and data-parallel engines (``parallel/``, one gloo
rank a process on the CPU) against the JAX package: the counterparts of
tests/test_sharding.py.  Every case runs in one spawn of 8 ranks
(``torch_mesh_cases.py``) while the JAX package's single-device references
run here (``torch_mesh_refs.py``: its autoregressive tokens, which every
speculation mode commits); tokens must be equal, a TP prefill pass's
logits within 1e-4.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from magicdec_tpu import config as jcfg
from magicdec_tpu.models import llama as JM
from test_torch_model import random_params
from torch_mesh_cases import Spawn, prompt
from torch_mesh_refs import MAX_GEN, ar, committed_equal, engine, register

KW = dict(vocab_size=128, n_layer=1, n_head=8, n_kv_head=4, dim=64, intermediate_size=128)
PKW = dict(KW, n_kv_head=2)                # 2 kv heads on a 4-way model axis: padded
DKW = dict(vocab_size=128, n_layer=1, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
WEIGHTS = {"main": random_params(jcfg.tiny_config(**KW), seed=5, fan_in=False),
           "padded": random_params(jcfg.tiny_config(**PKW), seed=9, fan_in=False),
           "draft": random_params(jcfg.tiny_config(**DKW), seed=42, fan_in=False)}
for _name, _w in WEIGHTS.items():
    register(f"sharding/{_name}", _w)
MESH = ("mesh", 2, 4)


def _engine(**kw):
    base = dict(kind="engine", mesh=MESH, cfg=KW, weights="main", prompt=(4, 32, 0))
    base.update(kw)
    return base


CASES = [
    ("mesh_checks", dict(kind="mesh_checks", cfg=KW, weights="main")),
    ("spec_streamingllm", _engine()),
    ("spec_snapkv", _engine(ecfg={"mode": "snapkv"}, prompt=(4, 40, 0))),
    ("baseline", _engine(spec=False, baseline=MAX_GEN, prompt=(4, 32, 3))),
    ("longspec_submesh", _engine(mesh=("sub", 1, 2, 2), draft="draft", draft_cfg=DKW,
                                 ecfg={"mode": "full"}, prompt=(4, 32, 9))),
    ("hybrid_checks", dict(kind="hybrid_checks", ok=(4,), bad=(3,))),
    ("padded", _engine(cfg=PKW, weights="padded", baseline=MAX_GEN, prompt=(4, 32, 7))),
    ("padded_draft_quant", _engine(cfg=PKW, weights="padded", ecfg={"draft_quant": "int8"},
                                   prompt=(4, 32, 7))),
    ("prefill_logits", dict(kind="prefill_logits", mesh=MESH, cfg=KW, weights="main",
                            prompt=(4, 16, 2))),
]


def _ar(name, **kw):
    """The JAX package's autoregressive tokens for case ``name``'s weights
    and prompts (the target's: a standalone draft's case commits them too)."""
    spec = dict(CASES)[name]
    cfg = PKW if spec["weights"] == "padded" else KW
    rows = tuple(map(tuple, prompt(*spec["prompt"]).tolist()))
    return ar(f"sharding/{spec['weights']}", tuple(cfg.items()), rows, **kw)


REF_CASES = ("spec_streamingllm", "spec_snapkv", "baseline", "longspec_submesh", "padded")


@pytest.fixture(scope="module")
def ranks():
    """Every case in 8 gloo ranks, started before the references run."""
    job = Spawn(CASES, WEIGHTS, world=8)
    for name in REF_CASES:  # the JAX references, while the ranks run
        _ar(name)
    _ref_logits()
    return job.result()


@functools.lru_cache(maxsize=None)
def _ref_logits():
    eng = engine("sharding/main", tuple(sorted(KW.items())))
    cfg = jcfg.tiny_config(**KW)
    fwd = jax.jit(lambda p, t, l, c: JM.forward_target(p, cfg, t, l, c, head="logits")[0])
    return np.asarray(fwd(eng.params, jnp.asarray(prompt(4, 16, 2)), jnp.zeros((4,), jnp.int32),
                          eng._zero_target_caches(4)))


def _ok(ranks, name):
    res = ranks[name]
    assert "error" not in res, res.get("error")
    assert res["ranks_agree"], f"{name}: the ranks of one mesh disagree"
    return res


def test_mesh_construction_and_validation(ranks):
    res = _ok(ranks, "mesh_checks")
    assert res["shape"] == {"data": 2, "model": 4}
    assert res["bad_rejected"]


@pytest.mark.parametrize("name", ["spec_streamingllm", "spec_snapkv"])
def test_sharded_spec_matches_single_device(ranks, name):
    res = _ok(ranks, name)
    assert res["local_cfg"] == (2, 1, 8)  # 8 / 4 query heads, 4 / 4 kv heads, head dim 8
    committed_equal(res["output"], res["num_committed"], _ar(name))


def test_sharded_baseline_matches_single_device(ranks):
    res = _ok(ranks, "baseline")
    np.testing.assert_array_equal(res["base_output"], _ar("baseline", max_new=MAX_GEN))


def test_param_shardings_cover_all_leaves(ranks):
    """Every leaf of one of 4 model ranks: q/k/v and w1/w3 by columns, wo and
    w2 by rows, the head by vocab columns, the norms whole."""
    res = _ok(ranks, "mesh_checks")
    L, D, F, hd = 1, 64, 128, 8
    assert res["leaves"] == {"wq": (L, D, 2 * hd), "wk": (L, D, hd), "wv": (L, D, hd),
                             "bq": None, "bk": None, "bv": None, "wo": (L, 2 * hd, D),
                             "w1": (L, D, F // 4), "w3": (L, D, F // 4), "w2": (L, F // 4, D),
                             "attn_norm": (L, D), "ffn_norm": (L, D)}
    assert res["lm_head"] == (D, 128 // 4)
    assert res["shard"][0] == 4


def test_longspec_draft_submesh_matches_single_device(ranks):
    """Target TP over (mo, mi) = 2 x 2, the draft over mi alone."""
    res = _ok(ranks, "longspec_submesh")
    committed_equal(res["output"], res["num_committed"], _ar("longspec_submesh"))
    assert res["local_cfg"][:2] == (2, 1) and res["draft_cfg"] == (2, 1)


def test_hybrid_mesh_matches_the_mesh(ranks):
    """make_hybrid_mesh over one host's 8 ranks is make_mesh(2, 4) (the
    engine on a hybrid mesh across hosts: tests/test_torch_multihost.py); a
    model axis that does not divide the ranks is refused."""
    checks = _ok(ranks, "hybrid_checks")
    assert checks["shape"] == {"data": 2, "model": 4} and checks["bad_rejected"]
    assert checks["coords"] == _ok(ranks, "mesh_checks")["coords"]


def test_padded_kv_heads_tp_matches_single_device(ranks):
    """2 kv heads on a 4-way model axis pad to 4 zero-contribution heads
    (one a rank, 16 query heads in all); the head dim stays 8."""
    res = _ok(ranks, "padded")
    assert res["local_cfg"] == (4, 1, 8)
    committed_equal(res["output"], res["num_committed"], _ar("padded"))
    np.testing.assert_array_equal(res["base_output"], _ar("padded", max_new=MAX_GEN))


def test_padded_kv_heads_quantized_draft(ranks):
    """The padded int8 draft copy still commits the full-precision
    target's greedy output."""
    res = _ok(ranks, "padded_draft_quant")
    assert res["draft_wqkv"][0] == "QuantizedWeight"
    committed_equal(res["output"], res["num_committed"], _ar("padded"))


def test_tp_prefill_logits_match_jax(ranks):
    """A target prefill pass at data 2 x model 4: its logits (the vocab-split
    head gathered) within 1e-4 of the JAX package's one-device pass."""
    res = _ok(ranks, "prefill_logits")
    np.testing.assert_allclose(res["logits"], _ref_logits(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", ["llama-3.2-1b", "llama-3.1-8b"])
def test_shard_widths_route_to_the_kernels(monkeypatch, model, tp, bits):
    """Every quantized dot of a draft copy's shard at TP 2 and 4 routes to a
    kernel at the draft's 32 and the quantized target's 128 rows: wqkv's
    local columns (1536 / 768 at 1B, 3072 / 1536 at 8B) and w13 with their
    norm (and gate), wo and w2 (In 4096 / 2048, 7168 / 3584) and the head's
    vocab shard padded from 64,128 / 32,064 columns to a multiple of 256
    (shapes on the meta device, the kernels stubbed)."""
    import torch

    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.kernels import quant_matmul as QK
    from magicdec_tpu_torch.models import llama as M
    from magicdec_tpu_torch.parallel import sharding as S

    cfg = ModelConfig.from_name(model)
    D, F, hd, V = cfg.dim, cfg.intermediate_size, cfg.head_dim, cfg.vocab_size
    hq, hkv = cfg.n_head * hd, cfg.n_kv_head * hd

    def qw(In, Out):
        G = 1 if bits == 8 else In // 128
        return Q.QuantizedWeight(torch.empty((In // (2 if bits == 4 else 1), Out),
                                             dtype=torch.int8, device="meta"),
                                 torch.empty((G, Out), device="meta"), bits,
                                 In if bits == 8 else 128)

    full = {"wq": qw(D, hq), "wk": qw(D, hkv), "wv": qw(D, hkv), "wo": qw(hq, D),
            "w1": qw(D, F), "w3": qw(D, F), "w2": qw(F, D)}
    layers = {k: S.shard_leaf(w, k, cfg, tp, tp - 1) for k, w in full.items()}
    local = M.fuse_exec_params({"layers": layers}, cfg)["layers"]
    head = S.shard_head(qw(D, V), tp, tp - 1)
    assert local["wqkv"].q.shape[-1] == (hq + 2 * hkv) // tp
    assert layers["w2"].in_features == F // tp and layers["wo"].in_features == hq // tp
    assert head.q.shape[-1] % 256 == 0 and head.q.shape[-1] - V // tp < 256

    hits = []
    for name in ("quant_matmul_fused", "quant_matmul", "quant_matmul_fused_int4",
                 "quant_matmul_int4"):
        def stub(x, q, scale, *a, _n=name, gate=False, **kw):
            hits.append(_n)
            Out = q.shape[-1] // (2 if gate else 1)
            return torch.empty((x.shape[0], Out), dtype=torch.bfloat16, device="meta")
        monkeypatch.setattr(QK, name, stub)
    norm = (torch.empty((D,), device="meta"), 1e-5)
    for M_ in (32, 128):
        x = torch.empty((M_, D), dtype=torch.bfloat16, device="meta")
        calls = [lambda: Q.quant_matmul(x, local["wqkv"], norm=norm),
                 lambda: Q.quant_matmul(x, local["w13"], norm=norm, gate=True),
                 lambda: Q.quant_matmul(torch.empty((M_, F // tp), dtype=torch.bfloat16,
                                                    device="meta"), local["w2"]),
                 lambda: Q.quant_matmul(torch.empty((M_, hq // tp), dtype=torch.bfloat16,
                                                    device="meta"), local["wo"]),
                 lambda: Q.quant_matmul(x, head)]
        for call in calls:
            before = len(hits)
            call()
            assert len(hits) == before + 1, (M_, hits)
