"""The port's checkpoint pipeline (``magicdec_tpu_torch/utils/checkpoint.py``,
``python -m magicdec_tpu_torch.convert_checkpoint``) on the CPU.

- Logit parity with HF ``transformers`` (the four cases of
  tests/test_model_parity.py on the port's ``forward_target``: standard,
  linear and llama3 rope; a Qwen-style bias with a tied head; incremental
  decode against the full forward; the argmax head), atol 2e-4 / rtol 2e-3
  (1e-4 / 1e-3 incremental), as there.
- The port's safetensors reader against the ``safetensors`` package, on a
  sharded ``save_pretrained`` directory and a single file, F32 / F16 /
  BF16 (I8 / I32 on the single file): equal tensors, bit for bit.
- The disk path of tests/test_checkpoint_disk.py: ``save_pretrained`` ->
  the port's converter -> ``load_converted`` -> the port's engine, equal to
  HF ``generate`` token for token, spec committing the same stream; the CLI
  as a subprocess with ``--quantize int8`` / ``int4``, the dump's
  perplexity within 2% of the float32 conversion's.
- The ``.npz`` at rest across the packages, both ways, bit for bit: the
  bf16 conversion and the ``-int8`` / ``-int4`` dumps (the JAX script's and
  the port's CLI's equal), loaded with ``dtype=None`` and with
  ``dtype=bfloat16``, which rounds a dump's scales through bf16 in both
  packages.
"""

import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.models import llama as TM
from magicdec_tpu_torch.utils import checkpoint as CK

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_model(**kw):
    from test_model_parity import _make_hf_llama

    return _make_hf_llama(**kw)


def _caches(cfg, B, S, dtype=torch.float32):
    shape = (cfg.n_layer, B, S, cfg.n_kv_head * cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype) for n in "kv"}


def _logits(params, cfg, tokens, caches, lens=None):
    tokens = torch.as_tensor(tokens, dtype=torch.int32)
    if lens is None:
        lens = torch.zeros(tokens.shape[0], dtype=torch.int32)
    return TM.forward_target(params, cfg, tokens, lens, caches, head="logits")


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.as_tensor(np.asarray(tokens)).long()).logits.numpy()


def _hf_port(**kw):
    model = _hf_model(**kw)
    cfg = CK.config_from_hf(model.config)
    return model, cfg, CK.params_from_hf_model(model, cfg)


# -- logit parity with HF transformers ----------------------------------------


@pytest.mark.parametrize("rope_scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
], ids=["standard", "linear", "llama3"])
def test_prefill_logits_match_hf(rope_scaling):
    model, cfg, params = _hf_port(rope_scaling=rope_scaling)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, 17))
    logits, _ = _logits(params, cfg, tokens, _caches(cfg, 2, 32))
    np.testing.assert_allclose(logits.numpy(), _hf_logits(model, tokens), atol=2e-4, rtol=2e-3)


def test_qwen_style_bias_and_tied_embeddings():
    model, cfg, params = _hf_port(seed=3, tie=True, attention_bias=True)
    assert cfg.qkv_bias and cfg.tie_word_embeddings
    assert params["lm_head"] is None and params["layers"]["bq"] is not None
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(1, 9))
    logits, _ = _logits(params, cfg, tokens, _caches(cfg, 1, 16))
    np.testing.assert_allclose(logits.numpy(), _hf_logits(model, tokens), atol=2e-4, rtol=2e-3)


def test_incremental_decode_matches_full_forward():
    """Two 4-token prefill chunks, then single-token decode steps == one
    forward over all 12 tokens (the cache path)."""
    _, cfg, params = _hf_port(seed=7)
    B, T = 3, 12
    tokens = torch.as_tensor(np.random.RandomState(2).randint(0, cfg.vocab_size, (B, T)),
                             dtype=torch.int32)
    full, _ = _logits(params, cfg, tokens, _caches(cfg, B, 32))
    caches, lens, outs = _caches(cfg, B, 32), torch.zeros(B, dtype=torch.int32), []
    for a, b in [(0, 4), (4, 8)] + [(t, t + 1) for t in range(8, T)]:
        logits, caches = _logits(params, cfg, tokens[:, a:b], caches, lens)
        lens = lens + (b - a)
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=1e-4, rtol=1e-3)


def test_argmax_head_matches_logits_argmax():
    _, cfg, params = _hf_port(seed=11)
    tokens = torch.as_tensor(np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 6)),
                             dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    toks, _ = TM.forward_target(params, cfg, tokens, zero, _caches(cfg, 2, 16))
    logits, _ = _logits(params, cfg, tokens, _caches(cfg, 2, 16))
    np.testing.assert_array_equal(toks.numpy(), logits.argmax(-1).numpy())


# -- the safetensors reader against the safetensors package ---------------------


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("layout", ["sharded", "single"])
def test_safetensors_reader_matches_package(layout, dtype, tmp_path):
    from safetensors.torch import load_file, save_file

    dt = getattr(torch, dtype)
    if layout == "sharded":
        model = _hf_model(seed=5).to(dt)
        model.save_pretrained(str(tmp_path), safe_serialization=True, max_shard_size="40KB")
        assert (tmp_path / "model.safetensors.index.json").exists()
    else:
        gen = torch.Generator().manual_seed(0)
        save_file({"w": torch.randn((7, 5), generator=gen).to(dt),
                   "odd": torch.randn((3,), generator=gen).to(dt),  # unaligned offsets follow
                   "i8": torch.randint(-128, 127, (9,), generator=gen, dtype=torch.int8),
                   "i32": torch.randint(-2**31, 2**31 - 1, (2, 3), generator=gen,
                                        dtype=torch.int32),
                   "empty": torch.zeros((0, 4), dtype=dt)},
                  str(tmp_path / "model.safetensors"))
    files = sorted(tmp_path.glob("*.safetensors"))
    assert len(files) > (1 if layout == "sharded" else 0)
    want = {}
    for f in files:
        want.update(load_file(str(f)))
    got = CK.load_hf_checkpoint_dir(str(tmp_path))
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k].view(torch.uint8) if t.numel() else got[k],
                           t.view(torch.uint8) if t.numel() else t), k


def test_safetensors_reader_refuses_an_unknown_dtype(tmp_path):
    from safetensors.torch import save_file

    save_file({"w": torch.zeros(3, dtype=torch.float64)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        CK.load_hf_checkpoint_dir(str(tmp_path))


# -- the disk path: save_pretrained -> converter -> engine == HF generate -------


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A tiny tied-embedding HF Llama saved as sharded safetensors."""
    d = tmp_path_factory.mktemp("hf") / "tiny-llama"
    model = _hf_model(seed=3, tie=True)
    model.save_pretrained(str(d), safe_serialization=True, max_shard_size="60KB")
    return d, model


def _ecfg(**kw):
    from magicdec_tpu_torch.engine.engine import EngineConfig

    base = dict(mode="streamingllm", gamma=3, draft_budget=33, max_seq_len=256,
                chunk_size=16, window_size=8, sink_size=4, max_gen=16, eot_ids=(-1,),
                cache_dtype=torch.float32)
    base.update(kw)
    return EngineConfig(**base)


def test_disk_convert_and_greedy_matches_hf_generate(ckpt_dir):
    from magicdec_tpu_torch.engine.engine import SpecEngine

    d, model = ckpt_dir
    out = d / "port.npz"
    CK.convert_hf_checkpoint(str(d), str(out), dtype=torch.float32)
    cfg = CK.config_from_checkpoint_dir(str(d))
    params = CK.load_converted(str(out), dtype=torch.float32)
    assert params["lm_head"] is None  # the tied head survives the round trip

    B, prefix, new = 2, 33, 12
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, size=(B, prefix))
    engine = SpecEngine(params, cfg, _ecfg(), device="cpu")
    _, stats = engine.generate_baseline(engine.encode_baseline(prompt), max_new=new)
    ours = stats["output"].numpy()[:, :new]
    with torch.no_grad():
        hf = model.generate(torch.from_numpy(prompt).long(), max_new_tokens=new,
                            do_sample=False)
    np.testing.assert_array_equal(ours, hf.numpy()[:, prefix:])
    # the spec engine commits the same greedy stream from the same file
    _, spec = engine.generate(engine.encode(prompt))
    n = spec["num_committed"].numpy()
    for b in range(B):
        m = min(int(n[b]), new)
        np.testing.assert_array_equal(spec["output"].numpy()[b, :m], ours[b, :m])


def _cli(d, *extra):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "magicdec_tpu_torch.convert_checkpoint",
                        "--checkpoint_dir", str(d), *extra], capture_output=True, text=True,
                       env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_convert_cli_quantized_dump_and_quality_gate(ckpt_dir, bits):
    """The CLI (a subprocess, on the CPU) writes the bf16 file and its
    quantized dump; the dump loads as quantized weights, and its NLL is
    within 2% of the float32 conversion's."""
    from magicdec_tpu_torch.quality import perplexity

    d, _ = ckpt_dir
    out = d / f"cli{bits}.npz"
    stdout = _cli(d, "--out", str(out), "--quantize", f"int{bits}", "--device", "cpu")
    qout = d / f"cli{bits}-int{bits}.npz"
    assert f"wrote {out}" in stdout and f"wrote {qout}" in stdout
    cfg = CK.config_from_checkpoint_dir(str(d))
    assert Q.bits_from_path(qout) == bits
    qparams = CK.load_converted(str(qout), dtype=torch.float32)
    wq = qparams["layers"]["wq"]
    assert Q.is_quantized(wq) and wq.bits == bits and qparams["lm_head"] is None
    f32 = d / "f32.npz"
    CK.convert_hf_checkpoint(str(d), str(f32), dtype=torch.float32)
    params = CK.load_converted(str(f32))
    data = np.random.RandomState(11).randint(0, cfg.vocab_size, size=(2, 64))
    kw = dict(batch_size=2, chunk_size=16, cache_dtype=torch.float32, device="cpu")
    _, nll = perplexity(params, cfg, data, **kw)
    _, nll_q = perplexity(qparams, cfg, data, **kw)
    assert np.isfinite(nll) and np.isfinite(nll_q)
    assert abs(nll_q - nll) / nll < 0.02, (nll, nll_q)


# -- the .npz across the two packages --------------------------------------------


def _jax_convert_script(d, out, quantize):
    """The JAX package's CLI, scripts/convert_checkpoint.py, run in this
    process (JAX on the CPU)."""
    argv = sys.argv
    sys.argv = ["convert_checkpoint.py", "--checkpoint_dir", str(d), "--out", str(out),
                "--quantize", quantize]
    try:
        runpy.run_path(str(REPO / "scripts" / "convert_checkpoint.py"), run_name="__main__")
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def dumps(ckpt_dir):
    """{(package, fmt): path}: the bf16 conversion and the -int8 / -int4
    dumps written by the JAX script and by the port's CLI."""
    d, _ = ckpt_dir
    files = {}
    for bits in ("int8", "int4"):
        _jax_convert_script(d, d / f"jax_{bits}.npz", bits)
        _cli(d, "--out", str(d / f"port_{bits}.npz"), "--quantize", bits, "--device", "cpu")
        for pkg in ("jax", "port"):
            files[(pkg, "bf16")] = d / f"{pkg}_{bits}.npz"
            files[(pkg, bits)] = d / f"{pkg}_{bits}-{bits}.npz"
    return files


def _flat(tree, prefix=""):
    """{dotted key: numpy} of a params tree of either package (quantized
    weights as .q / .scale / .bits / .group_size; bf16 widened to f32)."""
    out = {}
    if tree is None:
        out[prefix[:-1]] = None
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif hasattr(tree, "q") and hasattr(tree, "scale"):
        for f in ("q", "scale"):
            out[prefix + f] = _flat(getattr(tree, f), prefix)[prefix[:-1]]
        out[prefix + "bits"] = int(tree.bits)
        out[prefix + "group_size"] = int(tree.group_size)
    else:
        a = tree.float().numpy() if isinstance(tree, torch.Tensor) and \
            tree.dtype == torch.bfloat16 else np.asarray(tree)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        out[prefix[:-1]] = (str(tree.dtype).split(".")[-1], a)
    return out


def _assert_same_tree(port_tree, jax_tree, ordered=True):
    a, b = _flat(port_tree), _flat(jax_tree)
    assert (list(a) if ordered else sorted(a)) == (list(b) if ordered else sorted(b))
    for k in a:
        if a[k] is None or isinstance(a[k], int):
            assert a[k] == b[k], k
            continue
        (da, xa), (db, xb) = a[k], b[k]
        assert da == db, (k, da, db)
        np.testing.assert_array_equal(xa, xb, err_msg=k)


@pytest.mark.parametrize("dtype", ["stored", "bfloat16"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_loads_alike_in_both_packages(dumps, writer, fmt, dtype):
    """A file written by either package loads in both to the same tree, bit
    for bit: leaf order, dtypes, quantized data, group sizes, and under
    ``dtype=bfloat16`` the scales rounded through bf16 (the JAX package's
    cast, kept by the port), which differ from the stored f32 scales."""
    import jax.numpy as jnp

    from magicdec_tpu.utils.checkpoint import load_converted as jax_load

    path = dumps[(writer, fmt)]
    tdt, jdt = (None, None) if dtype == "stored" else (torch.bfloat16, jnp.bfloat16)
    port, jax_tree = CK.load_converted(str(path), dtype=tdt), jax_load(str(path), dtype=jdt)
    _assert_same_tree(port, jax_tree)
    if fmt != "bf16":
        stored = np.load(str(path))["layers.wq.scale"]
        got = port["layers"]["wq"].scale.numpy()
        if dtype == "stored":
            np.testing.assert_array_equal(got, stored)
        else:  # the bf16 rounding of the scales (ROADMAP C: the reference's cast)
            assert got.dtype == np.float32 and not np.array_equal(got, stored)
            np.testing.assert_array_equal(
                got, torch.from_numpy(stored).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_port_cli_writes_the_jax_scripts_file(dumps, fmt):
    """The port's CLI and the JAX script write the same arrays under the same
    keys in the same order (the quantization on the CPU, scales by the f32
    reciprocal as XLA computes the JAX package's jitted division)."""
    a, b = np.load(str(dumps[("port", fmt)])), np.load(str(dumps[("jax", fmt)]))
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype.kind == b[k].dtype.kind and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_save_converted_round_trip(tmp_path):
    """``save_converted`` of a quantized tree (bf16 leaves, an int8 and an
    int4 weight, a tied head, absent biases) loads back to the same tree."""
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import tiny_config

    cfg = tiny_config(dim=128, intermediate_size=256)
    params = make_params(cfg, tied=True, device="cpu")
    params = dict(params, layers=dict(params["layers"],
                                      wq=Q.quantize_weight(params["layers"]["wq"]),
                                      w1=Q.quantize_weight(params["layers"]["w1"], bits=4)))
    path = tmp_path / "tiny.npz"
    nbytes = CK.save_converted(params, path)
    assert nbytes > 0
    back = CK.load_converted(str(path))
    _assert_same_tree(back, params, ordered=False)
