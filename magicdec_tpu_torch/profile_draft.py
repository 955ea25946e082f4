"""Draft-step breakdown of the port (counterpart of ``scripts/profile_draft.py``).

    python -m magicdec_tpu_torch.profile_draft [--B 32] [--budget 513] [--iters 30]
        [--draft_quant int8|int4|none] [--device cpu]

Splits one self-speculation draft step (llama-3.2-1b widths, synthetic
weights, the draft's quantized copy of them with its head, a bf16 draft
cache of ``--budget`` rows filled) into chains timed apart:

  - full_draft_step:  ``forward_draft``, token to token (on the card K1's
                      whole-row call, the K3 append, B4, B5 and B6)
  - dots_only:        every layer's dots as the draft step runs them (the
                      norm-fused wqkv, the layer tail) with the attention
                      output replaced by q: no rope, attention or append
  - attend_append:    every layer's cache attention with fixed fresh rows,
                      then the one post-loop append
  - head_only:        final norm, lm head and argmax
  - dot_<w>_x<L>:     each weight's dot alone (layer 0's weight, the plain
                      product's row count B), times the layer count

Each chain is ``engine/profiling.py``'s: n steps between CUDA events (on
``--device cpu`` the host clock, a CPU time), the median of three after a
warmup chain; states are built for the measurement (zeros, timing does not
depend on values).  Prints a line a chain, then one JSON line last.
"""

from __future__ import annotations

import argparse
import json

import torch

from magicdec_tpu_torch import resolve_device

CHAINS = ("full_draft_step_ms", "dots_only_ms", "attend_append_ms", "head_only_ms")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="llama-3.2-1b")
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--budget", type=int, default=513)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--draft_quant", default="int8", choices=["int8", "int4", "none"])
    p.add_argument("--quant_backend", default="pallas", choices=["jnp", "pallas"])
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="accepted for CLI parity; --device picks the device")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Time the chains; returns {chain: ms}."""
    args = parse_args(argv)
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.profiling import _chain
    from magicdec_tpu_torch.models import llama as M
    from magicdec_tpu_torch.ops import attention as attn_ops

    dev = resolve_device(args.device)
    cfg = ModelConfig.from_name(args.model)
    params = M.fuse_exec_params(make_params(cfg, device=dev), cfg)
    dparams = params
    if args.draft_quant != "none":
        dparams = Q.quantize_params(params, bits=8 if args.draft_quant == "int8" else 4,
                                    include_head=True, materialize_tied_head=True)
    B, L = args.B, cfg.n_layer
    cap = -(-(args.budget + 96) // 128) * 128
    hd, Hq, Hkv, D = cfg.head_dim, cfg.n_head, cfg.n_kv_head, cfg.dim
    dshape = (L, B, cap, Hkv * hd)

    def fill():
        return torch.full((B,), args.budget, dtype=torch.int32, device=dev)

    def zeros_x():
        return torch.zeros((B, D), dtype=torch.bfloat16, device=dev)

    def caches():
        return {n: torch.zeros(dshape, dtype=torch.bfloat16, device=dev) for n in ("dk", "dv")}

    # the full draft step (token -> token) on a fresh cache a chain
    def full_step(st, w):
        tok, f, c = st
        nxt, c = M.forward_draft(w, cfg, tok, f, f, c)
        return nxt, f + 1, c

    # dots only: each layer's wqkv (its norm fused) and the layer tail, the
    # attention output replaced by q
    def dots_step(st, w):
        (x,) = st
        for l in range(L):
            wl = M._layer(w, l)
            q, _, _ = M._qkv(x, wl, cfg, B, 1)
            x = M._layer_tail(x, q, wl, cfg, mega=True)
        return (x,)

    # attend + append only: each layer's cache attention with fixed fresh
    # rows, then the one post-loop append
    def attend_step(st, w):
        x, c = st
        f = fill()
        per_layer = []
        for l in range(L):
            q = x[:, None, None, :hd].expand(B, 1, Hq, hd).contiguous()
            kv = x[:, :Hkv * hd].reshape(B, 1, Hkv, hd)
            rows = M._kv_rows(kv, kv, c, prefix="d")
            out = attn_ops.attend_cache(q, c, f, layer=l, prefix="d", fresh=rows)
            x = x + out.reshape(B, Hq * hd)[:, :D]
            per_layer.append(rows)
        c = M._append_rows(c, {n: torch.stack([r[n] for r in per_layer]) for n in per_layer[0]},
                           f, prefix="d")
        return x, c

    def head_step(st, w):
        (x,) = st
        t = M.head_argmax(w, cfg, x)
        return (x + t[:, None].to(x.dtype) * 1e-9,)

    chains = {
        "full_draft_step_ms": (full_step, args.iters,
                               lambda: (torch.zeros((B, 1), dtype=torch.int32, device=dev),
                                        fill(), caches())),
        "dots_only_ms": (dots_step, args.iters, lambda: (zeros_x(),)),
        "attend_append_ms": (attend_step, args.iters, lambda: (zeros_x(), caches())),
        "head_only_ms": (head_step, args.iters, lambda: (zeros_x(),)),
    }
    old = Q.matmul_backend()
    Q.set_matmul_backend(args.quant_backend)
    results = {}
    try:
        for name, (fn, n, mk) in chains.items():
            results[name] = _chain(fn, n, mk, dparams)() * 1e3
        # each weight's dot alone, layer 0's weight, times the layer count
        for key in ("wqkv", "wo", "w13", "w2"):
            w = dparams["layers"][key]
            w0 = (Q.QuantizedWeight(w.q[0], w.scale[0], w.bits, w.group_size)
                  if Q.is_quantized(w) else w[0])
            In = w0.in_features if Q.is_quantized(w0) else w0.shape[0]

            def step(st, w, In=In):
                y = M.matmul(st[0], w)
                reps = -(-In // y.shape[1])
                return ((y if reps == 1 else y.repeat(1, reps))[:, :In].contiguous(),)

            results[f"dot_{key}_x{L}_ms"] = _chain(
                step, args.iters * 4,
                lambda In=In: (torch.zeros((B, In), dtype=torch.bfloat16, device=dev),),
                w0)() * 1e3 * L
    finally:
        Q.set_matmul_backend(old)
    for k, v in results.items():
        print(f"{k:28s} {v:8.3f}", flush=True)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"metric": f"profile_draft_{args.model}_B{B}_budget{args.budget}_"
                                f"dq{args.draft_quant}_torch",
                      "unit": "ms", "device": device, "detail": results}))
    return results


if __name__ == "__main__":
    main()
