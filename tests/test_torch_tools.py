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
