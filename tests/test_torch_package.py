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


def test_chip_smoke_fails_without_card(no_card, capsys):
    import chip_smoke

    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--kv_scale", "bf16"],
    ["--attn_backend", "jnp"], ["--quant_backend", "jnp"],
], ids=lambda a: "_".join(a).strip("-"))
def test_bench_paths_not_ported_raise(argv):
    from magicdec_tpu_torch import bench

    with pytest.raises(NotImplementedError, match="ROADMAP|Hopper"):
        bench.run(bench.parse_args(argv + ["--device", "cpu"]))


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
