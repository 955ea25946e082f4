"""Shared plumbing of the port's reference-protocol drivers (counterpart of
``benchmarks/common.py``): the common flags, the weights, the prompt
corpus, the timers and ``--printoutput``.

The flags and defaults are the JAX drivers', except that
``--attn_backend`` defaults to ``flash`` (the port runs its Hopper kernels
only; ``jnp`` raises), ``--platform`` is accepted for parity (``--device``
picks the device) and ``--device`` is added (``cuda`` unless the caller
asks for ``cpu``, which runs the plain kernel versions).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from magicdec_tpu_torch.utils.seeding import sampling_rng  # noqa: F401 (the drivers' rng)


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--model", type=str, default="llama-3.2-1b",
                   help="config name (synthetic weights) or a converted checkpoint .npz "
                        "(-int8 / -int4 in its name: quantized weights)")
    p.add_argument("--model_name", type=str, default=None,
                   help="HF tokenizer name or directory (transformers' AutoTokenizer); "
                        "without it, or where it does not load, the synthetic corpus")
    p.add_argument("--dataset", type=str, default="pg19", help="pg19 or c4 (with --model_name)")
    p.add_argument("--B", type=int, default=8)
    p.add_argument("--prefix_len", type=int, default=4000)
    p.add_argument("--max_len", type=int, default=4096)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--printoutput", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="a device mesh is ROADMAP item A15 (> 1 raises)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="a device mesh is ROADMAP item A15 (> 1 raises)")
    p.add_argument("--compile", action="store_true",
                   help="accepted for CLI parity; the port runs eagerly")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="> 0: exact Gumbel-coupled speculative sampling (0 = greedy)")
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--attn_backend", default="flash", choices=["jnp", "flash"],
                   help="flash: the Hopper kernels (the port runs no other)")
    p.add_argument("--kv_quant", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="quantized target KV cache (int8 halves, int4 quarters the bytes "
                        "decode streams)")
    p.add_argument("--draft_head", default="quant", choices=["quant", "shared"],
                   help="shared: the quantized draft copy reuses the target's lm_head")
    p.add_argument("--draft_quant", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="quantize the DRAFT pass's weights; the output still equals the "
                        "full-precision target's")
    p.add_argument("--kv_scale", default="f32", choices=["f32", "bf16"],
                   help="quantized-cache scale dtype")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="target prefill chunk size (0 = EngineConfig.chunk_size)")
    p.add_argument("--force_mesh", action="store_true",
                   help="a device mesh is ROADMAP item A15 (raises)")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="accepted for CLI parity; --device picks the device")
    p.add_argument("--device", default="cuda")
    return p


def not_ported(args):
    """Why the port cannot run ``args`` yet, or None."""
    if args.data_parallel * args.model_parallel > 1 or args.force_mesh:
        return "a device mesh is ROADMAP item A15"
    if args.attn_backend != "flash":
        return "--attn_backend jnp: the port runs its Hopper kernels only"
    return None


def load_params_and_config(model: str, device):
    """(params, cfg) for ``--model``: a converted ``.npz`` (its config from
    the path, ``ModelConfig.from_name``; loaded with ``dtype=bfloat16``,
    which rounds a dump's scales through bf16 as the JAX drivers do; then
    ``quantize_params`` when ``bits_from_path`` says so, which leaves the
    dump's quantized leaves as they are), or a config name with
    ``bench.make_params``'s synthetic weights."""
    import torch

    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig

    if str(model).endswith(".npz"):
        from magicdec_tpu_torch.utils.checkpoint import load_converted

        cfg = ModelConfig.from_name(str(model))
        params = load_converted(str(model), dtype=torch.bfloat16, device=device)
        bits = Q.bits_from_path(str(model))
        if bits:
            params = Q.quantize_params(params, bits=bits)
        return params, cfg
    cfg = ModelConfig.from_name(model)
    return make_params(cfg, device=device), cfg


def _tokenizer(name):
    """``AutoTokenizer.from_pretrained(name)``, or None (and the reason on
    stderr) where ``transformers`` or the tokenizer does not load."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name)
    except Exception as e:
        print(f"[driver] tokenizer unavailable ({e}); synthetic corpus", file=sys.stderr)
        return None


def load_dataset(args, vocab_size: int) -> np.ndarray:
    """The prompt windows [N, prefix_len]: with ``--model_name``, its
    tokenizer over ``--dataset`` (pg19 or c4; each falls back to its
    synthetic corpus when its files are missing); else, or when the
    tokenizer does not load, ``max(2B, 16)`` synthetic sequences of
    ``--seed``."""
    from magicdec_tpu_torch.data import datasets as D

    tok = _tokenizer(args.model_name) if args.model_name else None
    if tok is None:
        return D.synthetic_long_context_dataset(args.prefix_len, num_seqs=max(args.B * 2, 16),
                                                vocab_size=vocab_size, seed=args.seed)
    if args.dataset == "pg19":
        return D.convert_pg19_dataset(tok, args.prefix_len)
    if args.dataset == "c4":
        return D.convert_c4_dataset(tok, args.prefix_len)
    raise ValueError(args.dataset)


def eot_ids_for(args, cfg) -> tuple:
    """The stop ids: a never-matching id (synthetic prompts cannot end a
    sequence meaningfully), as the JAX drivers use."""
    return (-1,)


def engine_config(args, **kw):
    """The reference drivers' ``EngineConfig`` (``max_len``, ``max_gen``,
    the stop ids, sampling, ``prefill_chunk``, the cache formats) with a
    bf16 cache; ``kw`` adds the driver's own fields."""
    import torch

    from magicdec_tpu_torch.engine.engine import EngineConfig

    return EngineConfig(
        max_seq_len=args.max_len, max_gen=args.max_gen, eot_ids=eot_ids_for(args, None),
        temperature=args.temperature, top_p=args.top_p, prefill_chunk_size=args.prefill_chunk,
        cache_dtype=torch.bfloat16, kv_quant=args.kv_quant or False,
        kv_scale_dtype=torch.bfloat16 if args.kv_scale == "bf16" else torch.float32, **kw)


class Timer:
    """Accumulated wall seconds of ``with`` blocks; with a CUDA ``device``
    each block starts and ends on a ``torch.cuda.synchronize``."""

    def __init__(self, device=None):
        self.t = 0.0
        self.device = device

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._sync()
        self.t += time.perf_counter() - self.t0


def print_output(args, stats, max_rows: int = 4):
    """``--printoutput``: the decoded text of the first ``max_rows``
    continuations on stderr (their token ids without a tokenizer)."""
    if not getattr(args, "printoutput", False):
        return
    out = stats["output"].cpu().numpy()
    n = stats["num_committed"].cpu().numpy().reshape(-1)
    tok = _tokenizer(args.model_name) if getattr(args, "model_name", None) else None
    for b in range(min(out.shape[0], max_rows)):
        ids = out[b, : int(n[b])].tolist()
        text = tok.decode(ids) if tok is not None else str(ids)
        print(f"[output {b}] {text}", file=sys.stderr)
