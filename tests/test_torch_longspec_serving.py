"""The port's standalone-draft serving twins and benchmarks (CPU, plain kernel
versions), against the JAX package on the same numpy weights and prompts.

- ``ServingLongSpecEngine`` (full and streamingllm, as
  tests/test_serving.py's longspec case) and ``PagedServingLongSpecEngine``
  (tests/test_paged_serving.py:105-120): every request's tokens equal to the
  JAX twin's (``attn_backend="jnp"``) and to the port's ``LongSpecEngine``
  run on it alone; the paged twin over an int4 pool with a head-dim-128
  target and the int8 draft copy equal to the contiguous twin.
- ``serving_bench --mode full`` and ``--draft_model``, and the longspec
  benchmark (``python -m magicdec_tpu_torch.longspec_benchmark``) end to end at
  a tiny size: the JSON line, spec == AR (greedy and sampled), and the
  paths that raise.
"""

import functools
import json

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import config as tcfg
from magicdec_tpu_torch import longspec_benchmark, serving_bench
from magicdec_tpu_torch.convert import params_from_jax
from magicdec_tpu_torch.engine.engine import EngineConfig, LongSpecEngine
from magicdec_tpu_torch.engine.serving import PagedServingLongSpecEngine, ServingLongSpecEngine
from test_torch_longspec import DKW, DRAFT, HD64_DKW, HD128_KW, KW, TARGET, _jax_tree
from test_torch_model import random_params

SERVE_KW = dict(gamma=3, draft_budget=33, max_seq_len=256, chunk_size=16, window_size=8,
                sink_size=4, eot_ids=(-1,), page_size=64)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, size=n).astype(np.int32) for n in lens]


def _ecfg(mode, max_gen, **kw):
    return EngineConfig(mode=mode, max_gen=max_gen, cache_dtype=torch.float32, **SERVE_KW, **kw)


def _port(cls, mode, max_gen, tkw=KW, dkw=DKW, target=TARGET, draft=DRAFT, **kw):
    return cls(params_from_jax(target), tcfg.tiny_config(**tkw), params_from_jax(draft),
               tcfg.tiny_config(**dkw), _ecfg(mode, max_gen, **kw), device="cpu")


def _solo(prompt, mode, max_gen, **kw):
    eng = _port(LongSpecEngine, mode, max_gen, **kw)
    _, stats = eng.generate(eng.encode(prompt[None]))
    return stats["output"][0, :int(stats["num_committed"][0])].numpy()


def _jax_serve(paged, mode, max_gen, prompts):
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu.engine.engine import EngineConfig as JEngineConfig
    from magicdec_tpu.engine.serving import PagedServingLongSpecEngine as JPaged
    from magicdec_tpu.engine.serving import ServingLongSpecEngine as JServing

    jeng = (JPaged if paged else JServing)(
        _jax_tree(TARGET), jcfg.tiny_config(**KW), _jax_tree(DRAFT), jcfg.tiny_config(**DKW),
        JEngineConfig(mode=mode, max_gen=max_gen, cache_dtype=jnp.float32, attn_backend="jnp",
                      **SERVE_KW))
    return [np.asarray(o) for o in jeng.serve(prompts, B=2, windows_per_sync=2)]


@pytest.mark.parametrize("mode", ["full", "streamingllm"])
def test_serving_longspec_matches_jax_and_solo(mode):
    """tests/test_serving.py:86-90's case: three requests of 48 tokens
    through two slots."""
    prompts = _prompts([48, 48, 48], 7)
    eng = _port(ServingLongSpecEngine, mode, 10)
    outs = eng.serve(prompts, B=2, windows_per_sync=2)
    assert eng.last_serve_stats["served"] == 3
    for o, j in zip(outs, _jax_serve(False, mode, 10, prompts)):
        np.testing.assert_array_equal(o, j)
    for prompt, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _solo(prompt, mode, 10))


def test_paged_serving_longspec_matches_jax_and_solo():
    """tests/test_paged_serving.py:105-120's case: lengths 48, 96, 48 over
    pages of 64 rows; the draft cache stays contiguous a slot."""
    prompts = _prompts([48, 96, 48], 19)
    eng = _port(PagedServingLongSpecEngine, "streamingllm", 8)
    outs = eng.serve(prompts, B=2, windows_per_sync=2)
    st = eng.init_serving(2)
    assert st.spec.dk.shape == (1, 2, 128, 16) and st.spec.table.shape == (2, 4)
    for o, j in zip(outs, _jax_serve(True, "streamingllm", 8, prompts)):
        np.testing.assert_array_equal(o, j)
    for prompt, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _solo(prompt, "streamingllm", 8))


@functools.lru_cache(maxsize=None)
def _hd128_params():
    return (random_params(tcfg.tiny_config(**HD128_KW), seed=5),
            random_params(tcfg.tiny_config(**HD64_DKW), seed=6))


@pytest.mark.parametrize("mode", ["full", "streamingllm"])
def test_paged_int4_twin_matches_contiguous_twin(mode):
    """The longspec path's serving formats at tiny widths: a head-dim-128
    target over an int4 pool (B12's int4 pool) and the int8 draft copy,
    paged tokens equal to the contiguous twin's on distinct lengths."""
    target, draft = _hd128_params()
    prompts = _prompts([48, 96, 64, 80], 23)
    kw = dict(tkw=HD128_KW, dkw=HD64_DKW, target=target, draft=draft, kv_quant="int4",
              draft_quant="int8")
    paged = _port(PagedServingLongSpecEngine, mode, 8, **kw).serve(prompts, B=2,
                                                                   windows_per_sync=2)
    contig = _port(ServingLongSpecEngine, mode, 8, **kw).serve(prompts, B=2, windows_per_sync=2)
    for p, c in zip(paged, contig):
        np.testing.assert_array_equal(p, c)


# -- the benchmarks ----------------------------------------------------------------


@pytest.fixture
def tiny_pair(monkeypatch):
    """Config names resolve to tiny configs: 'big' to a two-layer target,
    anything else to a one-layer draft of the same vocabulary."""
    big = dict(vocab_size=1024, n_layer=2, n_head=4, n_kv_head=2, dim=128, intermediate_size=256)
    small = dict(big, n_layer=1, dim=64)
    monkeypatch.setattr(tcfg.ModelConfig, "from_name",
                        classmethod(lambda cls, name: tcfg.tiny_config(
                            **(big if name == "big" else small))))


def _spec_equals_ar(out, max_gen):
    for s, b in zip(out["spec"], out["base"]):
        for r in range(s["output"].shape[0]):
            m = min(int(s["num_committed"][r]), max_gen)
            np.testing.assert_array_equal(s["output"][r, :m], b["output"][r, :m])


@pytest.mark.parametrize("extra,mode,prefix", [
    ([], "streamingllm", 320), (["--draft_budget", "-1"], "full", 320),
    (["--mode", "snapkv"], "snapkv", 288)])
def test_longspec_benchmark_runs_on_cpu(tiny_pair, capsys, extra, mode, prefix):
    """The benchmark end to end at a tiny size: two batches of two requests,
    one timed, the baseline on the same batches, spec == AR on every
    committed token, the JAX benchmark's metric with ``_torch`` appended."""
    out = longspec_benchmark.main(
        ["--device", "cpu", "--model", "big", "--draft_model", "small", "--B", "2",
         "--prefix_len", str(prefix), "--max_len", "512", "--max_gen", "12",
         "--num_batches", "2", "--warmup_batches", "1", "--prefill_chunk", "64",
         "--kv_quant", "int4", "--draft_quant", "int8", "--baseline"] + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == (f"longspec_{mode}_tokens_per_s_big_draft_small_kvq4_dq8_B2_ctx"
                              f"{prefix}_torch")
    assert line["unit"] == "tok/s" and line["value"] > 0 and line["vs_baseline"] > 0
    assert line["tokens_per_step"] >= 1.0
    assert out["engine_mode"] == mode and len(out["spec"]) == len(out["base"]) == 2
    _spec_equals_ar(out, 12)


def test_longspec_benchmark_untimed_and_not_ported(tiny_pair, capsys):
    """The JAX benchmark's defaults (B=8 with 16 sequences: two batches, both
    warmup) time nothing and print no result; jnp backends raise (the
    draft's sub-mesh and a mesh run: tests/test_torch_sharding.py)."""
    out = longspec_benchmark.main(["--device", "cpu", "--model", "big", "--draft_model",
                                   "small", "--prefix_len", "160", "--max_len", "320",
                                   "--max_gen", "4", "--prefill_chunk", "64"])
    assert out["result"] is None and len(out["spec"]) == 2
    assert "{" not in capsys.readouterr().out
    for argv, item in ((["--quant_backend", "jnp"], "Hopper"),
                       (["--attn_backend", "jnp"], "Hopper")):
        with pytest.raises(NotImplementedError, match=item):
            longspec_benchmark.run(longspec_benchmark.parse_args(argv + ["--device", "cpu"]))


def test_longspec_benchmark_samples_on_cpu(tiny_pair, capsys):
    """``--temperature 0.5`` (which raised before sampling was ported) with
    ``--baseline``: the sampled spec equals the sampled baseline on every
    committed token of both batches, and differs from the greedy run."""
    argv = ["--device", "cpu", "--model", "big", "--draft_model", "small", "--B", "2",
            "--prefix_len", "160", "--max_len", "320", "--max_gen", "12", "--prefill_chunk",
            "64", "--num_batches", "2", "--warmup_batches", "1", "--baseline"]
    out = longspec_benchmark.main(argv + ["--temperature", "0.5", "--top_p", "0.9"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["value"] > 0
    _spec_equals_ar(out, 12)
    greedy = longspec_benchmark.run(longspec_benchmark.parse_args(argv))
    assert any((s["output"] != g["output"]).any() for s, g in zip(out["spec"], greedy["spec"]))


@pytest.mark.parametrize("argv", [["--mode", "full"], ["--draft_model", "small", "--paged"]],
                         ids=["mode_full", "draft_model_paged"])
def test_serving_bench_standalone_draft_runs_on_cpu(tiny_pair, capsys, argv):
    """``serving_bench --mode full`` (the draft: ``--model``'s weights, its
    own greedy continuation) and ``--draft_model`` (a separate draft) build
    the twins as the JAX benchmark does and serve every request."""
    out = serving_bench.main(["--device", "cpu", "--model", "big", "--slots", "2",
                              "--num_requests", "3", "--prefix_len", "160", "--max_len", "512",
                              "--page_size", "128", "--max_gen", "8", "--skip_warmup"] + argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mode = "full" if "full" in argv else "streamingllm"
    assert line["metric"] == (f"serving{'_paged' if '--paged' in argv else ''}_{mode}"
                              "_tokens_per_s_big_slots2_ctx160_torch")
    assert out["stats"]["served"] == 3 and all(len(o) >= 9 for o in out["outputs"])
    engine, _ = serving_bench.setup(serving_bench.parse_args(
        ["--device", "cpu", "--model", "big", "--max_len", "512", "--page_size", "128"] + argv))
    want = PagedServingLongSpecEngine if "--paged" in argv else ServingLongSpecEngine
    assert type(engine) is want
    assert engine.draft_cfg.n_layer == (2 if "full" in argv else 1)
    if "full" in argv:  # the target drafting for itself over its whole cache
        assert out["stats"]["tokens_per_step"] >= 3.0
