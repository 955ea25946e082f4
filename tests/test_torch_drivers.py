"""The port's reference-protocol drivers on the CPU at tiny shapes
(``ModelConfig.from_name`` patched to a ``tiny_config``; plain kernel
versions): the perplexity driver against ``magicdec_tpu.quality`` on the
JAX package's ``make_params`` weights and its ``load_dataset`` windows (bf16
and an int8 cache, 1e-4 relative NLL); the baseline and self-spec drivers'
committed tokens equal; ``bench --prefill_max_call`` carried with the
tokens unchanged; ``--model_name`` through a stub tokenizer in
``serving_bench`` and ``longspec_benchmark``, and the synthetic fallback
with its stderr line; the sweep's parsing and table with ``subprocess.run``
patched; a CPU rehearsal of ``profile_draft``."""

import argparse
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import common
from magicdec_tpu_torch import config as tcfg

KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, dim=64, intermediate_size=128)
TCFG = tcfg.tiny_config(**KW)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(tcfg.ModelConfig, "from_name",
                        classmethod(lambda cls, name: tcfg.tiny_config(**KW)))


class Tok:
    """A stub tokenizer: a token a character (tests/test_data.py's)."""
    vocab_size = KW["vocab_size"]
    bos_token_id = 2

    def encode(self, text):
        return [ord(c) % KW["vocab_size"] for c in text]


@pytest.fixture
def stub_transformers(monkeypatch):
    """``transformers`` as a stub module whose AutoTokenizer loads ``Tok``
    for the name "stub" and raises for any other (no hub lookup)."""
    names = []

    def from_pretrained(name):
        names.append(name)
        if name != "stub":
            raise OSError(f"{name} is not a local tokenizer")
        return Tok()

    mod = types.ModuleType("transformers")
    mod.AutoTokenizer = types.SimpleNamespace(from_pretrained=from_pretrained)
    monkeypatch.setitem(sys.modules, "transformers", mod)
    return names


@pytest.mark.parametrize("compare", [None, "kv_int8"], ids=["bf16", "kv_int8"])
def test_perplexity_driver_matches_jax(compare, monkeypatch, capsys):
    import jax

    from bench import make_params
    from benchmarks import common as jcommon
    from magicdec_tpu import config as jcfg
    from magicdec_tpu.quality import perplexity as jax_perplexity
    from magicdec_tpu_torch import perplexity_benchmark as PB
    from magicdec_tpu_torch.convert import params_from_jax

    jc = jcfg.tiny_config(**KW)
    jp = make_params(jc)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    monkeypatch.setattr(common, "load_params_and_config", lambda model, device: (tp, TCFG))
    argv = ["--device", "cpu", "--model", "tiny", "--seq_len", "64", "--num_seqs", "5", "--B",
            "2", "--chunk", "16"] + (["--compare", compare] if compare else [])
    out = PB.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out["result"]
    ref_args = argparse.Namespace(model_name=None, prefix_len=64, B=2, seed=123, dataset="pg19")
    data = jcommon.load_dataset(ref_args, KW["vocab_size"])[:5]
    np.testing.assert_array_equal(out["data"], data)
    ref = {}
    for label, kv in (("bf16", False), ("bf16+kv_int8", "int8")):
        if label in out["runs"]:
            ref[label] = jax_perplexity(jp, jc, data, batch_size=2, chunk_size=16, kv_quant=kv)
            nll = out["runs"][label]["nll"]
            assert abs(nll - ref[label][1]) / ref[label][1] < 1e-4, (label, nll, ref[label])
    assert set(ref) == set(out["runs"]) == ({"bf16", "bf16+kv_int8"} if compare else {"bf16"})
    tag = compare or "bf16"
    assert line["metric"] == f"perplexity_{tag}_tiny_torch"
    assert line["unit"] == "ppl"
    if compare:
        assert line["vs_baseline"] == round(out["runs"]["bf16+kv_int8"]["ppl"]
                                            / out["runs"]["bf16"]["ppl"], 6)


DRIVER_ARGV = ["--device", "cpu", "--model", "tiny", "--B", "2", "--prefix_len", "384",
               "--max_len", "512", "--max_gen", "16", "--num_batches", "2",
               "--warmup_batches", "1", "--kv_quant"]


def test_baseline_and_selfspec_tokens_agree(tiny, capsys):
    from magicdec_tpu_torch import baseline_benchmark, selfspec_benchmark

    base = baseline_benchmark.main(DRIVER_ARGV)
    spec = selfspec_benchmark.main(DRIVER_ARGV + ["--draft_quant", "--benchmark", "--gamma", "3"])
    out = capsys.readouterr().out
    assert f"Final tokens per second :{base['tokens_per_s']:.2f}" in out
    assert "total time :" in out and "large model step: " in out
    assert "acceptance alpha: " in out and "autotuned gamma: " in out
    assert len(base["batches"]) == len(spec["batches"]) == 2
    for b, s in zip(base["batches"], spec["batches"]):
        assert b["gen_tokens"] == 2 * 15
        for r in range(2):
            m = min(int(s["num_committed"][r]), 16)
            np.testing.assert_array_equal(s["output"][r, :m], b["output"][r, :m])
    assert spec["tokens_per_step"] > 1 and spec["gamma"] in (1, 2, 3, 4, 5, 6, 8)
    assert set(spec["phases"]) >= {"draft_step_ms", "verify_step_ms", "window_ms_est"}
    with pytest.raises(ValueError, match="128k\\+1"):
        selfspec_benchmark.parse_args(DRIVER_ARGV + ["--draft_budget", "300"])
    with pytest.raises(NotImplementedError, match="A15"):
        baseline_benchmark.main(DRIVER_ARGV + ["--model_parallel", "2"])


def test_prefill_max_call_carried_tokens_unchanged(tiny):
    from magicdec_tpu_torch import bench

    argv = ["--device", "cpu", "--model", "tiny", "--B", "2", "--prefix_len", "256",
            "--draft_budget", "257", "--prefill_chunk", "64", "--max_gen", "8", "--iters", "1"]
    assert bench.parse_args(argv).prefill_max_call == 8192
    engine, _ = bench.setup(bench.parse_args(argv + ["--prefill_max_call", "128"]))
    assert engine.ecfg.prefill_max_call_tokens == 128
    ref = bench.run(bench.parse_args(argv))
    out = bench.run(bench.parse_args(argv + ["--prefill_max_call", "128"]))
    for k in ("spec_output", "spec_committed", "base_output"):
        np.testing.assert_array_equal(out[k], ref[k])


def _serving_prompts(args):
    from magicdec_tpu_torch import serving_bench

    return serving_bench.setup(args)[1]


def _longspec_prompts(args):
    from magicdec_tpu_torch import longspec_benchmark

    return [row for batch in longspec_benchmark.setup(args)[1] for row in batch]


DRIVERS = {
    "serving_bench": (["--slots", "2", "--num_requests", "3", "--prefix_len", "160",
                       "--max_len", "512", "--max_gen", "8"], _serving_prompts),
    "longspec_benchmark": (["--draft_model", "tiny", "--B", "2", "--prefix_len", "160",
                            "--max_len", "512", "--max_gen", "8", "--num_batches", "2"],
                           _longspec_prompts),
}


def _parse(name, argv):
    import importlib

    return importlib.import_module(f"magicdec_tpu_torch.{name}").parse_args(
        ["--device", "cpu", "--model", "tiny"] + argv)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_model_name_through_a_stub_tokenizer(name, tiny, stub_transformers, tmp_path,
                                             monkeypatch):
    """``--model_name`` no longer raises: the prompts are that tokenizer's
    pg19 windows (its BOS forced), or, where ``Data/pg19`` is missing,
    ``convert_pg19_dataset``'s synthetic fallback at the tokenizer's
    vocabulary."""
    from magicdec_tpu.data import datasets as JD

    argv, prompts_of = DRIVERS[name]
    monkeypatch.chdir(tmp_path)
    args = _parse(name, argv + ["--model_name", "stub"])
    fallback = JD.convert_pg19_dataset(Tok(), args.prefix_len)
    for got, row in zip(prompts_of(args), fallback):
        np.testing.assert_array_equal(np.asarray(got).ravel(), row[:np.asarray(got).size])
    books = tmp_path / "Data" / "pg19"
    books.mkdir(parents=True)
    (books / "book.json").write_text(json.dumps({"text": "magic decoding " * 1400}))
    windows = JD.convert_pg19_dataset(Tok(), args.prefix_len)
    assert len(windows) and not np.array_equal(windows[0], fallback[0])
    got = [np.asarray(p).ravel() for p in prompts_of(_parse(name, argv + ["--model_name", "stub"]))]
    for i, p in enumerate(got):
        np.testing.assert_array_equal(p, windows[i % len(windows), :p.size])
    assert stub_transformers == ["stub"] * 2


@pytest.mark.parametrize("missing", ["import", "load"])
@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_model_name_falls_back_to_the_synthetic_corpus(name, missing, tiny, stub_transformers,
                                                       monkeypatch, capsys):
    """Where ``transformers`` is absent (the card's machine) or the
    tokenizer does not load, the driver says so on stderr and serves the
    same prompts as without ``--model_name``."""
    argv, prompts_of = DRIVERS[name]
    if missing == "import":
        monkeypatch.setitem(sys.modules, "transformers", None)
    got = prompts_of(_parse(name, argv + ["--model_name", "no-such-tokenizer"]))
    err = capsys.readouterr().err
    assert "[driver] tokenizer unavailable (" in err and "); synthetic corpus" in err
    ref = prompts_of(_parse(name, argv))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_sweep_parses_rows_and_prints_the_table(monkeypatch, tmp_path, capsys):
    from magicdec_tpu_torch import sweep_benchmark as SW

    ok = {"metric": "m", "value": 812.4, "unit": "tok/s", "vs_baseline": 1.5, "tokens_per_step": 3.1}
    calls = []

    def fake_run(cmd, capture_output, text, timeout, cwd):
        calls.append(cmd)
        label = len(calls)
        if label == 1:
            return subprocess.CompletedProcess(cmd, 0, stdout="total time :1s\n" + json.dumps(ok)
                                               + "\n{\"later\": 1}\n", stderr="")
        if label == 2:
            return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="a\nb\nTraceback\nboom")
        if label == 3:
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps(dict(ok, tokens_per_step=None)),
                                           stderr="")

    monkeypatch.setattr(SW.subprocess, "run", fake_run)
    monkeypatch.setitem(SW.SETS, "quick", [("a", ["--gamma", "3"]), ("b", ["--B", "48"]),
                                          ("c", []), ("d", (SW.LONGSPEC, ["--B", "4"]))])
    out_path = tmp_path / "sweep.jsonl"
    r = SW.main(["--set", "quick", "--out", str(out_path), "--device", "cpu"])
    assert [c[1:3] for c in calls] == [["-m", SW.BENCH]] * 3 + [["-m", SW.LONGSPEC]]
    assert calls[0][3:] == ["--gamma", "3", "--device", "cpu"] and calls[3][-2:] == ["--device", "cpu"]
    assert r["rows"] == [dict(ok, label="a"), {"label": "b", "error": "rc=1"},
                         {"label": "c", "error": "timeout"},
                         dict(ok, tokens_per_step=None, label="d")]
    assert r["table"] == ["| Config | Spec tok/s | Speedup vs AR | tokens/step |",
                          "|---|---|---|---|", "| a | 812 | 1.50× | 3.10 |", "| b | — | rc=1 | — |",
                          "| c | — | timeout | — |", "| d | 812 | 1.50× | — |"]
    assert capsys.readouterr().out.strip().splitlines() == r["table"]
    assert [json.loads(x) for x in out_path.read_text().splitlines()] == r["rows"]
    assert SW.parse_args([]).device == "cuda" and SW.parse_args([]).set == "ladder"
    assert [label for label, _ in SW.SETS["smoke"]] == ["smoke"]


def test_profile_draft_runs_on_cpu(capsys):
    from magicdec_tpu_torch import profile_draft

    r = profile_draft.main(["--device", "cpu", "--model", "68m", "--B", "2", "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["detail"] == r and line["unit"] == "ms"
    assert line["metric"] == "profile_draft_68m_B2_budget513_dqint8_torch"
    assert set(profile_draft.CHAINS) <= set(r)
    assert all(np.isfinite(v) and v > 0 for v in r.values())
    assert {f"dot_{k}_x2_ms" for k in ("wqkv", "wo", "w13", "w2")} <= set(r)
