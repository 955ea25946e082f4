"""Checkpoint pipeline of the port: HF Llama/Qwen safetensors -> the
layer-stacked parameter dict, and the converted ``.npz`` at rest
(counterpart of magicdec_tpu/utils/checkpoint.py).

- ``params_from_hf_state_dict`` / ``params_from_hf_model`` /
  ``config_from_hf``: HF names and ``[out, in]`` weights -> the port's
  layout (``[in, out]``, layers stacked), no rotary permutation (the port's
  rope is HF's rotate-half), optional q/k/v biases, a tied head as
  ``lm_head None``.
- ``load_hf_checkpoint_dir``: the port's own safetensors reader (an 8-byte
  little-endian header length, a JSON header, then the raw tensors, read
  through ``torch.frombuffer`` over a copy-on-write ``mmap``), sharded
  through ``model.safetensors.index.json`` or a single file; F32, F16,
  BF16, I8 and I32.  It needs no ``safetensors`` package.
- ``convert_hf_checkpoint`` / ``load_converted`` / ``save_converted``: the
  JAX package's at-rest ``.npz`` format, flat keys (``embed``,
  ``layers.wq``, ``final_norm``, ...), bf16 leaves as raw 2-byte void
  (``'V2'``, what ``np.savez`` makes of an ``ml_dtypes`` bfloat16 array),
  quantized leaves as ``<name>.q`` / ``.scale`` / ``.bits``; a tied head
  and absent biases are left out.  A file written by either package loads
  in the other bit for bit, with no ``ml_dtypes``.

A conversion holds the bf16 result and at most one float32 copy of one
layer of one leaf at a time, and writes the ``.npz`` leaf by leaf.
"""

from __future__ import annotations

import json
import mmap
import struct
import types
import zipfile
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from magicdec_tpu_torch.config import ModelConfig

# HF parameter name templates for Llama/Qwen/Mistral/Yi-family decoders.
_LAYER_KEYS = {
    "q": "model.layers.{i}.self_attn.q_proj.weight",
    "k": "model.layers.{i}.self_attn.k_proj.weight",
    "v": "model.layers.{i}.self_attn.v_proj.weight",
    "qb": "model.layers.{i}.self_attn.q_proj.bias",
    "kb": "model.layers.{i}.self_attn.k_proj.bias",
    "vb": "model.layers.{i}.self_attn.v_proj.bias",
    "o": "model.layers.{i}.self_attn.o_proj.weight",
    "w1": "model.layers.{i}.mlp.gate_proj.weight",
    "w3": "model.layers.{i}.mlp.up_proj.weight",
    "w2": "model.layers.{i}.mlp.down_proj.weight",
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "ffn_norm": "model.layers.{i}.post_attention_layernorm.weight",
}

# our leaf -> (HF template, transposed), in the JAX package's leaf order
_LEAVES = (("wq", "q", True), ("wk", "k", True), ("wv", "v", True),
           ("bq", "qb", False), ("bk", "kb", False), ("bv", "vb", False),
           ("wo", "o", True), ("w1", "w1", True), ("w2", "w2", True), ("w3", "w3", True),
           ("attn_norm", "attn_norm", False), ("ffn_norm", "ffn_norm", False))
_BIASES = ("bq", "bk", "bv")

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I8": torch.int8, "I32": torch.int32}


# ---------------------------------------------------------------------------
# HF state dict -> params
# ---------------------------------------------------------------------------

def _leaf(state: Mapping[str, Any], name: str, dtype, transpose: bool = False):
    """One HF tensor through float32 (as the JAX package reads it) to dtype."""
    t = state[name]
    t = t.detach() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    t = t.to("cpu", torch.float32)
    return (t.T if transpose else t).to(dtype).contiguous()


def _stacked_leaf(state, cfg: ModelConfig, leaf: str, dtype) -> Optional[torch.Tensor]:
    """Leaf ``leaf`` of every layer stacked [L, ...], or None (an absent bias)."""
    hf, transpose = next((h, t) for n, h, t in _LEAVES if n == leaf)
    if leaf in _BIASES and not cfg.qkv_bias:
        return None
    first = _leaf(state, _LAYER_KEYS[hf].format(i=0), dtype, transpose)
    out = torch.empty((cfg.n_layer, *first.shape), dtype=dtype)
    out[0] = first
    del first
    for i in range(1, cfg.n_layer):
        out[i] = _leaf(state, _LAYER_KEYS[hf].format(i=i), dtype, transpose)
    return out


def _iter_hf_leaves(state, cfg: ModelConfig, dtype) -> Iterator[Tuple[str, Any]]:
    """(flat key, tensor or None) of every leaf, built one at a time, in the
    JAX package's order: embed, the layer leaves, final_norm, lm_head."""
    yield "embed", _leaf(state, "model.embed_tokens.weight", dtype)
    for name, _, _ in _LEAVES:
        yield f"layers.{name}", _stacked_leaf(state, cfg, name, dtype)
    yield "final_norm", _leaf(state, "model.norm.weight", dtype)
    # a tied head (reference convert_hf_checkpoint.py:147-149)
    yield "lm_head", (_leaf(state, "lm_head.weight", dtype, transpose=True)
                      if "lm_head.weight" in state else None)


def params_from_hf_state_dict(state: Mapping[str, Any], cfg: ModelConfig,
                              dtype=torch.bfloat16) -> Dict[str, Any]:
    """The params dict from an HF-format state dict (HF names -> torch
    tensors or numpy arrays).  HF Linear stores [out, in]; the port's layout
    is [in, out], so weights transpose."""
    return unflatten(dict(_iter_hf_leaves(state, cfg, dtype)))


def params_from_hf_model(hf_model, cfg: Optional[ModelConfig] = None,
                         dtype=torch.float32) -> Dict[str, Any]:
    """Convert an in-memory ``transformers`` causal LM (the parity tests)."""
    if cfg is None:
        cfg = config_from_hf(hf_model.config)
    state = dict(hf_model.state_dict())
    if getattr(hf_model.config, "tie_word_embeddings", False):
        state.pop("lm_head.weight", None)
    return params_from_hf_state_dict(state, cfg, dtype=dtype)


def config_from_hf(hf_cfg) -> ModelConfig:
    """The port's ModelConfig from a transformers LlamaConfig / Qwen2Config
    (or its ``config.json`` as a namespace): standard, ``linear`` and
    ``llama3`` rope scaling, q/k/v biases, a tied head."""
    rope_scaling = getattr(hf_cfg, "rope_scaling", None) or {}
    kw: Dict[str, Any] = {}
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if rope_type == "llama3":
        kw.update(rope_scaling_factor=rope_scaling["factor"],
                  low_freq_factor=rope_scaling["low_freq_factor"],
                  high_freq_factor=rope_scaling["high_freq_factor"],
                  original_max_position_embeddings=rope_scaling[
                      "original_max_position_embeddings"])
    elif rope_type == "linear":
        kw.update(rope_scaling_factor=rope_scaling["factor"])
    return ModelConfig(
        name=getattr(hf_cfg, "name_or_path", "hf"),
        block_size=hf_cfg.max_position_embeddings,
        vocab_size=hf_cfg.vocab_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        n_kv_head=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        dim=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        rope_base=getattr(hf_cfg, "rope_theta", 10000.0),
        norm_eps=hf_cfg.rms_norm_eps,
        qkv_bias=bool(getattr(hf_cfg, "attention_bias", False)
                      or hf_cfg.model_type == "qwen2"),
        tie_word_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        **kw,
    )


# ---------------------------------------------------------------------------
# safetensors, read without the safetensors package
# ---------------------------------------------------------------------------

def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write map of the file (nothing is read until a tensor is used;
    writing a tensor never reaches the file)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {key!r} has dtype {meta['dtype']}; the reader "
                             f"takes {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        size = dtype.itemsize
        count = (end - begin) // size
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {key!r} holds {end - begin} bytes for shape "
                             f"{shape} of {meta['dtype']}")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % size == 0:
            out[key] = torch.frombuffer(mm, dtype=dtype, count=count,
                                        offset=base + begin).reshape(shape)
        else:  # an unaligned tensor: copy its bytes
            out[key] = torch.frombuffer(bytearray(mm[base + begin:base + end]),
                                        dtype=dtype).reshape(shape)
    return out


def load_hf_checkpoint_dir(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """Read an HF checkpoint directory: the shards its
    ``model.safetensors.index.json`` names, else every ``*.safetensors``."""
    d = Path(checkpoint_dir)
    index = d / "model.safetensors.index.json"
    if index.exists():
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted({d / name for name in weight_map.values()})
    else:
        files = sorted(d.glob("*.safetensors"))
    state: Dict[str, torch.Tensor] = {}
    for path in files:
        state.update(read_safetensors(path))
    if not state:
        raise FileNotFoundError(f"no safetensors found under {checkpoint_dir}")
    return state


def config_from_checkpoint_dir(checkpoint_dir: str,
                               model_name: Optional[str] = None) -> ModelConfig:
    """The ModelConfig of an on-disk HF checkpoint: the fuzzy name registry
    first, else the directory's own ``config.json``."""
    name = model_name or Path(checkpoint_dir).name
    try:
        return ModelConfig.from_name(name)
    except KeyError:
        cfg_path = Path(checkpoint_dir) / "config.json"
        if not cfg_path.exists():
            raise
        with open(cfg_path) as f:
            raw = json.load(f)
        raw.setdefault("name_or_path", name)
        raw.setdefault("model_type", "llama")
        return config_from_hf(types.SimpleNamespace(**raw))


# ---------------------------------------------------------------------------
# the converted .npz, in the JAX package's format
# ---------------------------------------------------------------------------

def array_at_rest(t: torch.Tensor) -> np.ndarray:
    """A tensor at rest: bf16 as raw 2-byte void, the rest as itself."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def tensor_from_rest(a: np.ndarray) -> torch.Tensor:
    """Inverse of ``array_at_rest``: a 2-byte void array is bf16."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a void leaf of {a.dtype.itemsize} bytes is not bfloat16")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def flat_leaves(params, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(key, numpy array) of every leaf at rest, in the tree's order: a
    ``QuantizedWeight`` as ``.q`` / ``.scale`` / ``.bits``; None is left
    out."""
    from magicdec_tpu_torch.quantization import QuantizedWeight

    if params is None:
        return
    if isinstance(params, QuantizedWeight):
        yield prefix + "q", array_at_rest(params.q)
        yield prefix + "scale", array_at_rest(params.scale)
        yield prefix + "bits", np.asarray(params.bits)
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from flat_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], array_at_rest(params)


class NpzWriter:
    """An ``.npz`` written one array at a time, as ``np.savez`` writes it
    (stored, zip64), so a whole model never waits in memory as numpy."""

    def __init__(self, path):
        self._zf = zipfile.ZipFile(str(path), mode="w", compression=zipfile.ZIP_STORED,
                                   allowZip64=True)
        self.nbytes = 0

    def write(self, key: str, arr: np.ndarray):
        with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
        self.nbytes += arr.nbytes

    def close(self):
        self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_converted(params, path) -> int:
    """Write a params dict (quantized leaves included) as a converted
    ``.npz``; returns the bytes of array data written."""
    with NpzWriter(path) as w:
        for key, arr in flat_leaves(params):
            w.write(key, arr)
    return w.nbytes


def convert_hf_checkpoint(checkpoint_dir: str, out_path: str,
                          model_name: Optional[str] = None,
                          dtype=torch.bfloat16) -> int:
    """HF directory -> one ``.npz`` of the params in ``dtype`` (the JAX
    package's ``convert_hf_checkpoint``), built and written a leaf at a
    time; returns the bytes of array data written."""
    cfg = config_from_checkpoint_dir(checkpoint_dir, model_name)
    state = load_hf_checkpoint_dir(checkpoint_dir)
    with NpzWriter(out_path) as w:
        for key, leaf in _iter_hf_leaves(state, cfg, dtype):
            if leaf is not None:
                w.write(key, array_at_rest(leaf))
            del leaf
    return w.nbytes


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat dotted keys -> the nested params dict; a tied head and absent
    biases come back as None."""
    params: Dict[str, Any] = {}
    for key, value in flat.items():
        node = params
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    params.setdefault("lm_head", None)
    for name in _BIASES:
        params.setdefault("layers", {}).setdefault(name, None)
    return params


def load_converted(path: str, dtype=None, device="cpu") -> Dict[str, Any]:
    """Load an ``.npz`` written by ``convert_hf_checkpoint`` (or a
    ``--quantize`` dump, of either package) into the params dict; quantized
    leaves become ``QuantizedWeight`` with ``group_size = In / G``.

    ``dtype`` casts every leaf that is not int8 and not a ``.bits`` count,
    **a quantized weight's f32 scales included**, before the scales are
    widened back to float32: the JAX package's ``load_converted`` does the
    same, so ``dtype=torch.bfloat16`` (what ``serving_bench`` loads with) rounds
    the scales through bf16, a relative change of up to 2**-8 against the
    scales written.  The port keeps this so that its tokens equal the JAX
    package's on the same file."""
    from magicdec_tpu_torch.quantization import QuantizedWeight

    flat: Dict[str, Any] = {}
    with np.load(str(path)) as raw:
        for key in raw.files:
            t = tensor_from_rest(raw[key])
            if not (t.dtype == torch.int8 or key.endswith(".bits")) and dtype is not None:
                t = t.to(dtype)
            flat[key] = t.to(device)

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"q", "scale", "bits"}:
            bits = int(node["bits"])
            scale = node["scale"].to(torch.float32)
            full_in = node["q"].shape[-2] * (2 if bits == 4 else 1)
            return QuantizedWeight(node["q"], scale, bits=bits,
                                   group_size=full_in // scale.shape[-2])
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(unflatten(flat))
