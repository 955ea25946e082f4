"""The port's hybrid mesh across hosts (``parallel/multihost.py``): 4 gloo
ranks as 2 hosts of 2 (``LOCAL_WORLD_SIZE`` 2, as torchrun sets it on
each host), the data axis across the hosts and the model axis within
each; the counterpart of tests/test_multihost.py.  The engine's spec and
baseline tokens equal the JAX package's single-device autoregressive run
(``torch_mesh_refs.py``), a model axis that would span hosts is refused,
the drivers run their mesh flags inside the ranks, and a failing rank
fails the launch.
"""

import numpy as np
import pytest

from magicdec_tpu import config as jcfg
from test_torch_model import random_params
from torch_mesh_cases import Spawn, prompt
from torch_mesh_refs import MAX_GEN, ar, committed_equal, register

KW = dict(vocab_size=128, n_layer=1, n_head=8, n_kv_head=4, dim=64, intermediate_size=128)
WEIGHTS = {"main": random_params(jcfg.tiny_config(**KW), seed=5, fan_in=False)}
register("multihost/main", WEIGHTS["main"])
B, PREFIX = 8, 32
# the drivers' mesh flags, run inside the 4 ranks (config names map to tiny
# configs there and here)
CONFIGS = {"tiny": dict(KW, n_layer=1), "small": dict(KW, n_layer=1, n_head=4, n_kv_head=2)}
COMMON = ["--device", "cpu", "--model", "tiny", "--B", "4", "--prefix_len", "160",
          "--max_len", "256", "--max_gen", "8", "--kv_quant"]
SERVE = ["--device", "cpu", "--model", "tiny", "--slots", "4", "--num_requests", "6",
         "--prefix_len", "160", "--ragged", "--max_len", "256", "--page_size", "64",
         "--max_gen", "8", "--paged", "--kv_quant", "int8", "--skip_warmup"]
LONGSPEC = ["--device", "cpu", "--model", "tiny", "--draft_model", "small", "--B", "4",
            "--prefix_len", "160", "--max_len", "256", "--max_gen", "8", "--num_batches",
            "1", "--warmup_batches", "0", "--baseline", "--prefill_chunk", "64"]
RUNS = {"selfspec": ("selfspec_benchmark", COMMON + ["--num_batches", "1", "--warmup_batches",
                                                     "0", "--draft_quant"]),
        "baseline": ("baseline_benchmark", COMMON + ["--num_batches", "1", "--warmup_batches",
                                                     "0"]),
        "serve": ("serving_bench", SERVE),
        "longspec": ("longspec_benchmark", LONGSPEC)}
MESH = {"selfspec": ["--data_parallel", "2", "--model_parallel", "2"],
        "baseline": ["--data_parallel", "2", "--model_parallel", "2"],
        "serve": ["--data_parallel", "4"],
        "longspec": ["--model_parallel_outer", "2", "--model_parallel_inner", "2"]}
CASES = [
    ("hybrid_checks", dict(kind="hybrid_checks", ok=(2,), bad=(4,))),
    ("hybrid_engine", dict(kind="engine", mesh=("hybrid", 2), cfg=KW, weights="main",
                           prompt=(B, PREFIX, 0), baseline=MAX_GEN)),
    ("drivers", dict(kind="driver", configs=CONFIGS,
                     runs={k: (m, argv + MESH[k]) for k, (m, argv) in RUNS.items()})),
]


def _ref():
    """The JAX package's autoregressive tokens for the engine case's prompts."""
    rows = tuple(map(tuple, prompt(B, PREFIX, 0).tolist()))
    return ar("multihost/main", tuple(KW.items()), rows)


@pytest.fixture(scope="module")
def ranks():
    job = Spawn(CASES, WEIGHTS, world=4, local_world=2)
    _ref()
    return job.result()


def _ok(ranks, name):
    res = ranks[name]
    assert "error" not in res, res.get("error")
    assert res["ranks_agree"], f"{name}: the ranks of one mesh disagree"
    return res


def test_hybrid_mesh_keeps_the_model_axis_within_a_host(ranks):
    """2 model ranks a host: data 2 x model 2; a model axis of 4 would span
    both hosts and is refused."""
    res = _ok(ranks, "hybrid_checks")
    assert res["shape"] == {"data": 2, "model": 2}
    assert res["bad_rejected"]


def test_two_host_hybrid_mesh_matches_single_device(ranks):
    res = _ok(ranks, "hybrid_engine")
    ref = _ref()
    committed_equal(res["output"], res["num_committed"], ref)
    np.testing.assert_array_equal(res["base_output"][:, :MAX_GEN], ref[:, :MAX_GEN])


@pytest.fixture(scope="module")
def meshless_serve():
    """``serving_bench`` without a mesh in this process, the same tiny config."""
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch import serving_bench
    from magicdec_tpu_torch.config import tiny_config

    from_name = tcfg.ModelConfig.from_name
    tcfg.ModelConfig.from_name = classmethod(lambda cls, name: tiny_config(**CONFIGS[name]))
    try:
        return serving_bench.run(serving_bench.parse_args(SERVE))["outputs"]
    finally:
        tcfg.ModelConfig.from_name = from_name


def _spec_equals_ar(spec, base, max_gen=8):
    (s_out, s_n), (b_out, _) = spec, base
    for b in range(s_out.shape[0]):
        m = min(int(s_n[b]), max_gen)
        np.testing.assert_array_equal(s_out[b, :m], b_out[b, :m])


def test_drivers_run_their_mesh_flags(ranks, meshless_serve):
    """The drivers spawn nothing inside a rank and build their mesh from the
    flags: ``selfspec_benchmark`` at data 2 x model 2 commits the tokens of
    ``baseline_benchmark`` on the same mesh; ``serving_bench`` over 4 data
    ranks serves the meshless serve's tokens; ``longspec_benchmark`` on the
    draft's sub-mesh (2 x 2) commits its own baseline's."""
    res = _ok(ranks, "drivers")
    _spec_equals_ar(res["selfspec"]["batches"][0], res["baseline"]["batches"][0])
    for out, ref in zip(res["serve"]["outputs"], meshless_serve):
        np.testing.assert_array_equal(out, ref)
    _spec_equals_ar(res["longspec"]["spec"][0], res["longspec"]["base"][0])


def test_a_failing_rank_fails_the_launch():
    """One rank's exception reaches the launcher (the drivers then exit
    non-zero); the other rank is stopped, not left waiting."""
    from magicdec_tpu_torch.parallel import multihost
    from torch_mesh_cases import failing_rank

    with pytest.raises(Exception, match="rank 1 fails"):
        multihost.launch(failing_rank, (1,), 2, device="cpu")
