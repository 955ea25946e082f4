"""The port's tooling: its copy of the gamma autotune against
magicdec_tpu/engine/autotune.py, and CPU rehearsals of the decode profiler,
the kernel benchmark and ``bench --gamma 0`` (plain kernel versions, tiny
shapes), each printing its JSON line last."""

import json

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.engine import autotune as AT


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_autotune_copy_matches_jax():
    from magicdec_tpu.engine import autotune as JAT

    for alpha in np.linspace(0.0, 1.0, 11):
        for gamma in range(0, 9):
            assert AT.expected_tokens_per_window(alpha, gamma) == \
                JAT.expected_tokens_per_window(alpha, gamma)
        for td, tv in ((0.5, 10.0), (2.0, 10.0), (5.0, 6.0), (9.0, 8.0), (0.1, 40.0)):
            cands = tuple(range(2, 9))
            assert AT.pick_gamma(alpha, td, tv, cands) == JAT.pick_gamma(alpha, td, tv, cands)
            assert AT.pick_gamma(alpha, td, tv) == JAT.pick_gamma(alpha, td, tv)
            assert AT.window_throughput(alpha, 3, td, tv) == \
                JAT.window_throughput(alpha, 3, td, tv)
    for tpw in (0.5, 1.0, 1.7, 2.6, 3.9, 4.0, 5.0):
        for gamma in (1, 3, 4):
            assert AT.alpha_from_window_stats(tpw, gamma) == \
                JAT.alpha_from_window_stats(tpw, gamma)
            assert AT.pick_gamma_from_run(tpw, gamma, 1.0, 7.0) == \
                JAT.pick_gamma_from_run(tpw, gamma, 1.0, 7.0)
    with pytest.raises(ValueError):
        AT.expected_tokens_per_window(1.5, 3)
    with pytest.raises(ValueError):
        AT.pick_gamma(0.5, 1.0, 1.0, ())


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_profile_decode_runs_on_cpu(capsys):
    from magicdec_tpu_torch import profile_decode

    r = profile_decode.main(["--device", "cpu", "--model", "68m", "--B", "2", "--ctx", "256",
                             "--seq_round", "128", "--iters", "2", "--draft_quant", "int8",
                             "--dense_kernels"])
    line = _last_json(capsys)
    assert set(r) == set(profile_decode.PHASES) == set(line["detail"])
    assert line["device"] == "cpu" and all(v > 0 for v in r.values())
    from magicdec_tpu_torch import quantization as Q

    assert not Q.dense_kernels()  # restored


def test_profile_decode_phase_subset_and_unported_flags(capsys):
    from magicdec_tpu_torch import profile_decode

    r = profile_decode.main(["--device", "cpu", "--model", "68m", "--B", "1", "--ctx", "128",
                             "--seq_round", "128", "--iters", "2", "--kv_quant", "int8",
                             "--phases", "verify_step_ms,noctx_step_ms"])
    assert set(r) == {"verify_step_ms", "noctx_step_ms"}
    with pytest.raises(NotImplementedError, match="A8"):
        profile_decode.main(["--device", "cpu", "--quantize", "int8"])


def test_kernel_benchmark_append_runs_on_cpu(capsys, monkeypatch):
    """The merged-vs-per-array append A/B: both sides' launches run (K3q's
    wrapper once a step, B14's four)."""
    from magicdec_tpu_torch import kernel_benchmark
    from magicdec_tpu_torch.kernels import append as AP

    calls = []
    for name in ("append_all_rows_inplace_quant", "append_rows_inplace",
                 "append_scale_rows_inplace"):
        monkeypatch.setattr(AP, name, lambda *a, _f=getattr(AP, name), _n=name:
                            calls.append(_n) or _f(*a))
    r = kernel_benchmark.main(["--device", "cpu", "--which", "append", "--B", "2",
                               "--iters", "2"])
    line = _last_json(capsys)
    assert set(r) == {f"append_T{t}_{k}" for t in (1, 5) for k in ("merged", "per_array")}
    assert line["detail"] == r and line["device"] == "cpu"
    assert calls.count("append_rows_inplace") == 2 * calls.count("append_all_rows_inplace_quant")
    assert calls.count("append_scale_rows_inplace") == calls.count("append_rows_inplace") > 0


def test_kernel_benchmark_prefill_runs_on_cpu(capsys, monkeypatch):
    """The prefill cases: K2, K2q and B11 over the layer stack (one call a
    layer, at each base, with the chunk's fresh rows) and the SDPA
    yardstick, each case a time; on the CPU the wrappers take their plain
    versions."""
    from magicdec_tpu_torch import kernel_benchmark
    from magicdec_tpu_torch.kernels import prefill_attention as PA

    calls = []
    for name in ("flash_prefill_attend", "flash_prefill_attend_quant",
                 "flash_prefill_attend_quant4"):
        monkeypatch.setattr(PA, name, lambda *a, _f=getattr(PA, name), _n=name, **kw:
                            calls.append((_n, kw["layer"], int(a[-1][0]),
                                          kw.get("k_new") is not None)) or _f(*a, **kw))
    r = kernel_benchmark.main(["--device", "cpu", "--which", "prefill", "--model", "68m",
                               "--B", "2", "--S", "384", "--C", "64", "--bases", "128,0"])
    line = _last_json(capsys)
    kinds = ("bf16", "int8", "int4", "sdpa")
    assert set(r) == {f"prefill_{k}_base{b}" for k in kinds for b in (128, 0)}
    assert line["detail"] == r and line["device"] == "cpu"
    assert all(v > 0 for v in r.values())
    # two layers a case, each with its fresh rows, at each base
    for name in ("flash_prefill_attend", "flash_prefill_attend_quant",
                 "flash_prefill_attend_quant4"):
        assert sorted((l, b) for n, l, b, f in calls if n == name and f) == \
            [(0, 0), (0, 128), (1, 0), (1, 128)]


def test_kernel_benchmark_encode_runs_on_cpu(capsys):
    """The encode cases: SpecEngine.encode and encode_baseline, two timed
    runs each, with the bench's flags passed through."""
    from magicdec_tpu_torch import kernel_benchmark

    r = kernel_benchmark.main([
        "--device", "cpu", "--which", "encode", "--bench_args",
        "--model 68m --B 2 --prefix_len 256 --draft_budget 257 --prefill_chunk 128 "
        "--max_gen 8 --kv_quant int8 --draft_quant none"])
    line = _last_json(capsys)
    assert set(r) == {f"encode_{k}_{i}" for k in ("spec", "baseline") for i in (0, 1)}
    assert line["detail"] == r and all(v > 0 for v in r.values())


@pytest.mark.parametrize("which", ["decode", "paged"])
def test_kernel_benchmark_decode_and_paged_run_on_cpu(which, capsys, monkeypatch, tmp_path):
    """The decode cases (K1, K1q, B10 at T = 1 and --T) and the paged ones
    (B12 over bf16, int8 and int4 pools at each page size dividing S): one
    call a layer with the window's fresh rows, each case a time, and with
    --dump each case's layer-0 output saved."""
    from magicdec_tpu_torch import kernel_benchmark
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import paged_attention as PGA

    mod = DA if which == "decode" else PGA
    names = ([f"flash_{'paged_' if which == 'paged' else ''}decode_attend{k}"
              for k in ("", "_quant", "_quant4")])
    calls = []
    for name in names:
        monkeypatch.setattr(mod, name, lambda *a, _f=getattr(mod, name), _n=name, **kw:
                            calls.append((_n, kw["layer"], kw.get("k_new") is not None))
                            or _f(*a, **kw))
    dump = tmp_path / "out.pt"
    r = kernel_benchmark.main(["--device", "cpu", "--which", which, "--model", "68m",
                               "--B", "2", "--S", "512", "--T", "4", "--dump", str(dump)])
    line = _last_json(capsys)
    kinds = ("bf16", "int8", "int4")
    if which == "decode":
        want = {f"decode_{k}_T{t}" for k in kinds for t in (1, 4)}
    else:
        want = {f"paged_{k}_ps{ps}_T4" for k in kinds for ps in (512, 16)}
    assert set(r) == want and line["detail"] == r and all(v > 0 for v in r.values())
    per_case = 1 + 2  # the dumped layer-0 call, then the two layers timed
    assert len(calls) == per_case * len(want) and all(fresh for _, _, fresh in calls)
    assert sorted({layer for _, layer, _ in calls}) == [0, 1]
    saved = torch.load(dump)
    assert set(saved) == want and all(torch.isfinite(v.float()).all() for v in saved.values())


def test_decode_variants_apply_to_the_sources():
    """The decode kernel's variants decode_variants times still apply to
    the source: ``current`` is the source, ``trace`` adds its six stamps to
    the quantized body and to the bf16 body and the readers, the isolation
    variants drop the arithmetic (both bodies) or the copies (the quantized
    body, the only formats it runs), ``blocks4`` raises the quantized launch
    bound; ``parent_trace`` patches the one-warp core, which this tree no
    longer has."""
    from magicdec_tpu_torch import decode_variants as DV

    assert DV.patched("current") == {}
    (text,) = DV.patched("trace").values()
    assert text.count("MD_TRACE(") == 13  # the macro and six stamps a body
    for fmt in ("int8", "int4", "bf16"):
        assert f'extern "C" int md_trace_read_{fmt}' in text
    assert len(DV.PHASES["trace"]) == 6
    (alone,) = DV.patched("copies_alone").values()
    assert alone.count("if (false) {") == 2
    assert DV.FORMATS["compute_alone"] == ("int8", "int4")
    (alone,) = DV.patched("compute_alone").values()
    assert "issue(st" not in alone and "issue((it" not in alone
    (blocks,) = DV.patched("blocks4").values()
    assert "HEADS == 1 ? 4 : 4" in blocks and DV.PLANS["blocks4"]["PLAN_BLOCKS"] == 132 * 4
    with pytest.raises((ValueError, FileNotFoundError)):
        DV.patched("parent_trace")


def test_prefill_variants_apply_to_the_source():
    """Every variant of the K2q/B11 kernel that prefill_variants times still
    applies to the source (each patch's text is there), and says what it
    does: the trace variant adds its reader, the isolation variants drop the
    producer's conversion or the consumers' products."""
    from magicdec_tpu_torch import prefill_variants as PV

    source = PV.SOURCE.read_text()
    assert PV.patched("current") == source
    texts = {name: PV.patched(name) for name in PV.VARIANTS}
    assert 'extern "C" int md_trace_read' in texts["trace"]
    assert texts["trace"].count("clock64()") == 10  # five phases each side
    assert "put(dst" not in texts["consumers_alone"]
    assert "ex2(s[j]" not in texts["consumers_alone_no_exp"]
    assert "issue_qk(i);" not in texts["producer_alone"]
    assert "issue_pv(i - 1);" in texts["in_warpgroup_overlap"]
    assert "NCONS = 2;" in texts["two_warpgroups"]
    with pytest.raises(ValueError, match="no longer holds"):
        PV.patched("two_warpgroups", source.replace("NCONS = 3;", "NCONS = 4;"))


def test_bench_returns_encode_seconds_on_cpu(capsys):
    """``bench.run`` returns the last measured spec encode's wall seconds
    (the time to the first token) beside its arrays, out of the JSON line."""
    from magicdec_tpu_torch import bench

    out = bench.main(["--device", "cpu", "--model", "68m", "--B", "2", "--prefix_len", "256",
                      "--draft_budget", "257", "--prefill_chunk", "128", "--max_gen", "8",
                      "--iters", "1", "--kv_quant", "int8", "--draft_quant", "none"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["encode_s"] > 0.0
    assert "encode_s" not in line and line == out["result"]


def test_bench_gamma_autotune_runs_on_cpu(capsys):
    """``bench --gamma 0``: warmup at gamma 4, the phase timers, a pick in
    2..8, the run at the pick; spec == AR there, and the bench's JSON."""
    from magicdec_tpu_torch import bench

    out = bench.main(["--device", "cpu", "--model", "68m", "--B", "2", "--prefix_len", "384",
                      "--draft_budget", "257", "--prefill_chunk", "128", "--max_gen", "12",
                      "--iters", "1", "--gamma", "0", "--kv_quant", "none",
                      "--draft_quant", "none"])
    captured = capsys.readouterr()
    assert "[bench] autotune: alpha=" in captured.err
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line == out["result"] and line["tokens_per_step"] >= 1.0
    assert 2 <= out["gamma"] <= 8
    assert f"gamma={out['gamma']} " in captured.err
    n = out["spec_committed"]
    for b in range(2):
        m = min(int(n[b]), 12)
        np.testing.assert_array_equal(out["spec_output"][b, :m], out["base_output"][b, :m])


def test_time_phases_on_a_live_state():
    """The phase timers at an encoded state's lengths and shapes: every
    phase timed, the window estimate their sum, the state left as it was."""
    from magicdec_tpu_torch.convert import params_from_jax
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from magicdec_tpu_torch.engine.profiling import time_phases
    from test_torch_engine import ENGINE_KW, PARAMS, TCFG, _prompt

    eng = SpecEngine(params_from_jax(PARAMS), TCFG,
                     EngineConfig(cache_dtype=torch.float32, kv_quant="int8", **ENGINE_KW),
                     device="cpu")
    st = eng.encode(_prompt(32))
    before = [t.clone() for t in (st.target_lens, st.draft_fill, st.k, st.dk)]
    r = time_phases(eng, st, iters=2)
    assert set(r) == {"draft_step_ms", "verify_step_ms", "baseline_step_ms", "window_ms_est"}
    assert all(v > 0 for v in r.values())
    assert r["window_ms_est"] == r["draft_step_ms"] * eng.ecfg.gamma + r["verify_step_ms"]
    for a, b in zip(before, (st.target_lens, st.draft_fill, st.k, st.dk)):
        assert torch.equal(a, b)
