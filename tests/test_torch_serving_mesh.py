"""The port's serving engines over a mesh (``engine/serving.py`` with
``mesh=``: slots and pages split over data ranks, each data group
tensor-parallel) against the JAX package: the counterparts of
tests/test_serving_mesh.py.  Every request served equals its solo run in
the JAX package (one device, B=1: its autoregressive tokens, which the
request commits alone, ``torch_mesh_refs.py``), and the data 2 x model 4
paged serve
also equals the JAX package's own serve on its 8-device mesh
(tests/conftest.py's virtual devices, its flash kernels in interpret
mode).  One spawn of 8 gloo ranks runs every case (``torch_mesh_cases.py``)
while the references run here.
"""

import functools

import numpy as np
import pytest

from magicdec_tpu import config as jcfg
from magicdec_tpu.engine.serving import PagedServingEngine as JPagedServingEngine
from magicdec_tpu.parallel import sharding as JS
from test_torch_model import _jax_tree, random_params
from torch_mesh_cases import Spawn, prompts
from torch_mesh_refs import GAMMA, ar, ecfg, register

KW = dict(vocab_size=128, n_layer=1, n_head=8, n_kv_head=4, dim=64, intermediate_size=128)
WEIGHTS = {"main": random_params(jcfg.tiny_config(**KW), seed=5, fan_in=False)}
register("serving/main", WEIGHTS["main"])
ECFG = {"max_gen": 6, "page_size": 64}
INT8 = dict(ECFG, kv_quant="int8")
INT4 = dict(ECFG, kv_quant="int4")
STREAM = ([32, 64, 32, 64, 32], 17)   # the data 2 x model 4 stream


def _serve(mesh, paged, ecfg, stream, B, **kw):
    return dict(kind="serve", mesh=mesh, paged=paged, cfg=KW, weights="main", ecfg=ecfg,
                prompts=stream, B=B, **kw)


CASES = [
    ("contiguous_model4", _serve(("mesh", 1, 4), False, INT8, ([32] * 4, 3), 2)),
    ("contiguous_data2_model4", _serve(("mesh", 2, 4), False, INT8, STREAM, 4)),
    ("paged_model4", _serve(("mesh", 1, 4), True, INT8, ([32, 64, 32, 64], 7), 2)),
    ("paged_int4_model2", _serve(("mesh", 1, 2), True, INT4, ([32, 64, 32], 11), 2)),
    ("paged_data2_model4", _serve(("mesh", 2, 4), True, INT8, STREAM, 4, total_pages=12)),
    ("paged_backpressure", _serve(("mesh", 1, 4), True, INT8, ([32, 32, 64, 32], 13), 3,
                                  total_pages=3, windows_per_sync=1)),
    ("paged_capacity_error", _serve(("mesh", 2, 4), True, INT8, STREAM, 4, total_pages=2)),
]


def _solo(cfg, stream):
    """Each prompt of ``stream`` alone through the JAX package (B=1, its
    autoregressive tokens: what the request commits served alone)."""
    fmt = tuple(sorted(cfg.items()))
    return [ar("serving/main", tuple(KW.items()), (tuple(p.tolist()),), ecfg_kw=fmt,
               max_new=cfg["max_gen"] + GAMMA + 1)[0] for p in prompts(*stream)]


@functools.lru_cache(maxsize=None)
def _jax_mesh_serve():
    """The JAX package's paged serve on data 2 x model 4 (flash kernels, the
    page axis over data, group-local page ids)."""
    eng = JPagedServingEngine(_jax_tree(WEIGHTS["main"]), jcfg.tiny_config(**KW),
                              ecfg(attn_backend="flash", **INT8),
                              mesh=JS.make_mesh(data=2, model=4))
    outs = eng.serve(prompts(*STREAM), B=4, windows_per_sync=2, total_pages=12)
    return outs, eng.last_serve_stats


SOLO = {name: (spec["ecfg"], spec["prompts"]) for name, spec in CASES
        if name != "paged_capacity_error"}


@pytest.fixture(scope="module")
def ranks():
    job = Spawn(CASES, WEIGHTS, world=8)
    for cfg, stream in SOLO.values():  # the references, while the ranks run
        _solo(cfg, stream)
    _jax_mesh_serve()
    return job.result()


def _ok(ranks, name):
    res = ranks[name]
    assert "error" not in res, res.get("error")
    assert res["ranks_agree"], f"{name}: the ranks of one mesh disagree"
    return res


def _served_equal_solo(res, name):
    cfg, stream = SOLO[name]
    solo = _solo(cfg, stream)
    assert len(res["outputs"]) == len(solo)
    for out, ref in zip(res["outputs"], solo):
        np.testing.assert_array_equal(out, ref[:len(out)])


@pytest.mark.parametrize("name", ["contiguous_model4", "contiguous_data2_model4"])
def test_serving_mesh_matches_solo(ranks, name):
    _served_equal_solo(_ok(ranks, name), name)


@pytest.mark.parametrize("name", ["paged_model4", "paged_int4_model2"])
def test_paged_serving_mesh_matches_solo(ranks, name):
    _served_equal_solo(_ok(ranks, name), name)


def test_paged_serving_data_model_mesh_matches_solo(ranks):
    """The pool's pages over data: each group its own slots, pages, table
    ids, scheduler and allocator; 12 pages (6 a group) make the groups wait
    for pages."""
    res = _ok(ranks, "paged_data2_model4")
    _served_equal_solo(res, "paged_data2_model4")
    assert res["stats"]["served"] == len(STREAM[0])
    assert res["stats"]["total_pages"] == 12


def test_paged_serving_data_model_mesh_matches_jax_mesh(ranks):
    """The same serve in the JAX package on its 8-device mesh: every token
    and the scheduler's placement (admission waves, the fewest free pages)."""
    res = _ok(ranks, "paged_data2_model4")
    outs, stats = _jax_mesh_serve()
    for out, ref in zip(res["outputs"], outs):
        np.testing.assert_array_equal(out, ref)
    for k in ("served", "admission_waves", "total_pages", "min_free_pages"):
        assert res["stats"][k] == stats[k], k


def test_paged_serving_mesh_backpressure_matches_solo(ranks):
    """3 pages for requests of 1, 1, 2 and 1 pages: the third waits."""
    res = _ok(ranks, "paged_backpressure")
    _served_equal_solo(res, "paged_backpressure")
    assert res["stats"]["page_blocked"] > 0 and res["stats"]["total_pages"] == 3


def test_paged_serving_mesh_capacity_error(ranks):
    """2 pages over 2 data groups leave 1 a group, below the longest
    request's 2: refused before any admission."""
    res = _ok(ranks, "paged_capacity_error")
    assert "cannot hold the longest request" in res.get("value_error", "")
