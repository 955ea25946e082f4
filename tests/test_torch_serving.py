"""The port's serving engines (CPU, plain kernel versions): ``ServingEngine``
and ``PagedServingEngine`` against the JAX package's on the same weights and
prompts (mixed lengths, page size 64 as in ``tests/test_paged_serving.py``;
the JAX engines with ``attn_backend="jnp"``, so no serve runs in Pallas
interpret mode), tokens exact; inside the port, paged == contiguous, served
== the same request served alone through the same slots, backpressure below
the pool's capacity, int8 and int4 pools; and the serving benchmark CLI."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from magicdec_tpu import config as jcfg
from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
from magicdec_tpu.engine.serving import PagedServingEngine as JPaged
from magicdec_tpu.engine.serving import ServingEngine as JServing
from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch import serving_bench
from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.engine.engine import EngineConfig
from magicdec_tpu_torch.engine.serving import PagedServingEngine, ServingEngine
from test_torch_model import random_params

KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
JCFG, TCFG = jcfg.tiny_config(**KW), tcfg.tiny_config(**KW)
PARAMS = random_params(JCFG, fan_in=False)  # tests/test_spec_parity.py's weights
ENGINE_KW = dict(gamma=3, draft_budget=33, max_seq_len=256, chunk_size=16, sink_size=4,
                 max_gen=10, eot_ids=(-1,), page_size=64)
LENS = [48, 96, 48, 144, 96]
SLOTS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, KW["vocab_size"], size=n).astype(np.int32) for n in LENS]


@functools.lru_cache(maxsize=None)
def _port_engine(paged, kv_quant):
    cls = PagedServingEngine if paged else ServingEngine
    return cls(params_from_jax(PARAMS), TCFG,
               EngineConfig(cache_dtype=torch.float32, kv_quant=kv_quant, **ENGINE_KW),
               device="cpu")


@functools.lru_cache(maxsize=None)
def _port_serve(paged, kv_quant, total_pages=None):
    eng = _port_engine(paged, kv_quant)
    outs = eng.serve(_prompts(), B=SLOTS, windows_per_sync=2, total_pages=total_pages)
    return outs, eng.last_serve_stats


@functools.lru_cache(maxsize=None)
def _jax_serve(paged, kv_quant):
    params = {k: ({n: None if a is None else jnp.asarray(a) for n, a in v.items()}
                  if isinstance(v, dict) else jnp.asarray(v))
              for k, v in PARAMS.items()}
    cls = JPaged if paged else JServing
    eng = cls(params, JCFG, JEngineConfig(mode="streamingllm", cache_dtype=jnp.float32,
                                          kv_quant=kv_quant, attn_backend="jnp", **ENGINE_KW))
    outs = eng.serve(_prompts(), B=SLOTS, windows_per_sync=2)
    return [np.asarray(o) for o in outs], eng.last_serve_stats


CASES = [(False, False), (True, False), (True, "int8"), (True, "int4")]


@pytest.mark.parametrize("paged,kv_quant", CASES, ids=["contiguous", "paged", "paged_int8",
                                                       "paged_int4"])
def test_serving_matches_jax(paged, kv_quant):
    outs, st = _port_serve(paged, kv_quant)
    jouts, jst = _jax_serve(paged, kv_quant)
    assert len(outs) == len(jouts) == len(LENS)
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o, j)
    for key in ("served", "admission_waves", "mean_admissions_per_wave", "min_free_pages"):
        assert st[key] == jst[key], key


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_paged_matches_contiguous_in_port(kv_quant):
    paged, _ = _port_serve(True, kv_quant)
    contig = ServingEngine(params_from_jax(PARAMS), TCFG,
                           EngineConfig(cache_dtype=torch.float32, kv_quant=kv_quant,
                                        **ENGINE_KW), device="cpu")
    for p, c in zip(paged, contig.serve(_prompts(), B=SLOTS, windows_per_sync=2)):
        np.testing.assert_array_equal(p, c)


def test_served_matches_solo_in_port():
    """Each request served alone through the same slots gets the tokens it
    got in the stream (every pass at the same row count)."""
    outs, st = _port_serve(True, "int8")
    eng = _port_engine(True, "int8")
    for prompt, out in zip(_prompts()[:3], outs):
        solo = eng.serve([prompt], B=SLOTS, windows_per_sync=2)
        np.testing.assert_array_equal(solo[0], out)
    assert st["served"] == len(LENS) and len(st["request_passes"]) == len(LENS)
    assert st["tokens_per_step"] >= 1.0


def test_paged_backpressure_below_capacity():
    """A pool of 3 pages for 2 slots of 4 pages (capacity 8): the 144-token
    request needs all 3, so its admission must wait for both slots to drain
    (one more admission wave), and every request still gets its
    full-capacity tokens."""
    outs, st = _port_serve(True, False, total_pages=3)
    full, fst = _port_serve(True, False)
    for o, f in zip(outs, full):
        np.testing.assert_array_equal(o, f)
    assert st["total_pages"] == 3 and fst["total_pages"] == 8
    assert 0 <= st["min_free_pages"] < fst["min_free_pages"]
    assert st["admission_waves"] > fst["admission_waves"]
    assert st["page_blocked"] > 0 and fst["page_blocked"] == 0


def test_paged_config_checks():
    bad = [dict(page_size=60), dict(page_size=100, max_seq_len=300),
           dict(page_size=192, max_seq_len=384)]
    for kw in bad:
        eng = PagedServingEngine(params_from_jax(PARAMS), TCFG,
                                 EngineConfig(cache_dtype=torch.float32,
                                              **{**ENGINE_KW, **kw}), device="cpu")
        with pytest.raises(ValueError, match="page_size|multiple"):
            eng.init_serving(2)
    eng = _port_engine(True, False)
    with pytest.raises(ValueError, match="cannot hold the longest"):
        eng.serve(_prompts(), B=SLOTS, total_pages=2)


def test_synthetic_dataset_matches_jax():
    from magicdec_tpu.data.datasets import synthetic_long_context_dataset
    from magicdec_tpu_torch.data import datasets

    np.testing.assert_array_equal(
        datasets.synthetic_long_context_dataset(300, num_seqs=5, vocab_size=1000, seed=7),
        synthetic_long_context_dataset(300, num_seqs=5, vocab_size=1000, seed=7))


@pytest.mark.parametrize("argv", [
    # a standalone draft and the mesh flags are served now
    # (tests/test_torch_longspec_serving.py, tests/test_torch_serving_mesh.py)
    ["--attn_backend", "jnp"],
], ids=lambda a: "_".join(a).strip("-"))
def test_serving_bench_paths_not_ported_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP|Hopper"):
        serving_bench.run(serving_bench.parse_args(argv + ["--device", "cpu"]))


@pytest.mark.parametrize("argv", [
    pytest.param(["--mode", "full", "--temperature", "0.8"], id="mode_full"),
    pytest.param(["--temperature", "0.8"], id="temperature_0.8"),
])
def test_serving_bench_sampled_paths_run_on_cpu(monkeypatch, capsys, argv):
    """``serving_bench --temperature 0.8`` (which raised before sampling was
    ported), self-speculation and ``--mode full`` (the standalone-draft
    twin), at a tiny size: every request served, each equal to its prompt
    alone through a B=1 engine with its request id as the salt."""
    from magicdec_tpu_torch.ops.prng import PRNGKey

    monkeypatch.setattr(tcfg.ModelConfig, "from_name",
                        classmethod(lambda cls, name: tcfg.tiny_config(**KW)))
    common = ["--device", "cpu", "--model", "tiny", "--max_len", "256", "--page_size", "64",
              "--max_gen", "8", "--top_p", "0.9"] + argv
    out = serving_bench.main(common + ["--slots", "2", "--num_requests", "3", "--prefix_len",
                                       "96", "--skip_warmup"])
    assert out["stats"]["served"] == 3
    engine, _ = serving_bench.setup(serving_bench.parse_args(common))
    assert (engine.ecfg.temperature, engine.ecfg.top_p) == (0.8, 0.9)
    for rid, (prompt, got) in enumerate(zip(out["prompts"], out["outputs"])):
        _, stats = engine.generate(engine.encode(prompt[None], rng=PRNGKey(123), salt=[rid]))
        np.testing.assert_array_equal(got, stats["output"][0, :int(stats["num_committed"][0])])


def test_serving_bench_kv_scale_bf16_runs_on_cpu(monkeypatch, capsys):
    """``serving_bench --paged --kv_quant int8 --kv_scale bf16`` (it raised
    before the bf16-scale kernels) at a tiny size: every request served,
    and the same tokens as the contiguous engine on the same prompts."""
    import json

    monkeypatch.setattr(tcfg.ModelConfig, "from_name",
                        classmethod(lambda cls, name: tcfg.tiny_config(**KW)))
    argv = ["--device", "cpu", "--model", "tiny", "--slots", "2", "--num_requests", "3",
            "--prefix_len", "160", "--ragged", "--max_len", "512", "--page_size", "128",
            "--max_gen", "8", "--kv_quant", "int8", "--kv_scale", "bf16", "--skip_warmup"]
    out = serving_bench.main(argv + ["--paged"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] > 0 and out["stats"]["served"] == 3
    args = serving_bench.parse_args(argv)
    engine, _ = serving_bench.setup(args)
    assert engine.ecfg.kv_scale_dtype == torch.bfloat16
    for p, c in zip(out["outputs"], engine.serve(out["prompts"], B=args.slots,
                                                 windows_per_sync=args.windows_per_sync)):
        np.testing.assert_array_equal(p, c)


def test_serving_bench_runs_on_cpu(monkeypatch, capsys):
    """The benchmark CLI end to end at a tiny size: the JSON line is
    ``benchmarks/serving_benchmark.py``'s with ``_torch`` appended."""
    import json

    monkeypatch.setattr(tcfg.ModelConfig, "from_name",
                        classmethod(lambda cls, name: tcfg.tiny_config(**KW)))
    out = serving_bench.main(["--device", "cpu", "--model", "tiny", "--paged", "--slots", "2",
                              "--num_requests", "3", "--prefix_len", "160", "--ragged",
                              "--max_len", "512", "--page_size", "128", "--max_gen", "8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serving_paged_streamingllm_tokens_per_s_tiny_slots2_ctx160_torch"
    assert line["unit"] == "tok/s" and line["value"] > 0 and line["vs_baseline"] == 1.0
    assert [len(p) for p in out["prompts"]] != [160] * 3
    assert all(len(o) == 9 for o in out["outputs"]) and out["stats"]["served"] == 3
