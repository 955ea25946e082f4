"""Package boundaries of the PyTorch port: it imports nothing of JAX or of the
JAX package, its entry points refuse to run without a card unless asked for
the CPU, the paths not ported yet say so, and its kernel wrappers never fall
back silently."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "magicdec_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "magicdec_tpu")


def _imported_modules(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_jax(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_card(no_card):
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_params(cfg)
    params = make_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpecEngine(params, cfg, EngineConfig(draft_budget=257))
    # the reference-protocol drivers and tools: cuda by default, raising
    # before any work without a card; the sweep passes its device to every
    # row; prepare_ruler is host-only text generation
    from magicdec_tpu_torch import (baseline_benchmark, perplexity_benchmark, prepare_ruler,
                                    profile_draft, selfspec_benchmark, sweep_benchmark)

    for mod in (perplexity_benchmark, baseline_benchmark, selfspec_benchmark):
        args = mod.parse_args([])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(args)
    assert profile_draft.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_draft.main([])
    args = sweep_benchmark.parse_args([])
    assert args.device == "cuda"
    for _, extra in sweep_benchmark.SETS["ladder"] + sweep_benchmark.SETS["alpha"]:
        assert sweep_benchmark.command(extra, args.device)[-2:] == ["--device", "cuda"]
    assert "device" not in vars(prepare_ruler.parse_args(["--task", "qa", "--out", "x"]))


def test_chip_smoke_fails_without_card(no_card, capsys):
    import chip_smoke

    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--attn_backend", "jnp"], ["--quant_backend", "jnp"],
], ids=lambda a: "_".join(a).strip("-"))
def test_bench_paths_not_ported_raise(argv):
    from magicdec_tpu_torch import bench

    with pytest.raises(NotImplementedError, match="ROADMAP|Hopper"):
        bench.run(bench.parse_args(argv + ["--device", "cpu"]))


def test_bench_kv_scale_bf16_runs_on_cpu(capsys):
    """``bench --kv_scale bf16`` end to end at a tiny size (it raised before
    the bf16-scale kernels): the JSON line, spec == AR on every committed
    token, and the metric name untagged, as the JAX package's."""
    import json

    import numpy as np

    from magicdec_tpu_torch import bench

    argv = ["--device", "cpu", "--model", "68m", "--B", "2", "--prefix_len", "256",
            "--draft_budget", "257", "--prefill_chunk", "128", "--max_gen", "8", "--iters", "1",
            "--kv_scale", "bf16", "--draft_quant", "none"]
    out = bench.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out["result"]
    f32 = [a if a != "bf16" else "f32" for a in argv]
    assert line["metric"] == bench.metric_name(bench.parse_args(f32))
    for b in range(2):
        m = min(int(out["spec_committed"][b]), 8)
        np.testing.assert_array_equal(out["spec_output"][b, :m], out["base_output"][b, :m])


def test_kernel_wrappers_never_fall_back():
    """Only CPU tensors take the plain version: other devices, or tensors on
    several devices, raise instead of running anything."""
    from magicdec_tpu_torch.kernels.append import append_all_rows_inplace
    from magicdec_tpu_torch.kernels.decode_attention import flash_decode_attend

    q = torch.zeros(1, 1, 2, 64, device="meta")
    c = torch.zeros(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_decode_attend(q, c, c, torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        append_all_rows_inplace(c, c, c[:, :, :1], c[:, :, :1], torch.zeros(1))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from magicdec_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
