"""Decode-phase profile of the port (counterpart of
``scripts/profile_decode.py``).

    python -m magicdec_tpu_torch.profile_decode [--B 32] [--ctx 8192]
        [--kv_quant int8] [--draft_quant int8] [--gamma 4] [--dense_kernels]
        [--phases baseline_step_ms,verify_step_ms] [--device cpu]

Times the spec window's steps in isolation at a given context and batch,
so the gap to the card's bound is attributable:

  - baseline_step:  1-token target pass, with the in-place append
  - draft_step:     1-token draft pass over the budget cache
  - verify_step:    (gamma+1)-token target pass, with the append
  - noctx_step:     1-token target pass at lens=0 (weights and overhead,
                    no KV read): the cost apart from attention
  - head_ms:        final norm + lm_head matmul + argmax alone

On the card each phase also runs one step under ``torch.profiler`` after
its chain: ``{phase}_device_busy_ms``, the sum of its kernels' device time
(what the card spends on the step, host issue aside), and
``{phase}_dots_device_ms``, the share of the weight dots' own kernels (B4 /
B6 / B4-int4 / B6-int4 and B5 / B9: ``qmm`` and ``ffn_`` in the kernel's
name).

The target passes run at ``decode_rows`` = B * (gamma + 1) rows, as the
engine runs them; ``--dense_kernels`` sends their bf16 dots to B15
(``quantization.set_dense_kernels``); ``--quantize int8|int4`` profiles the
quantized-target window (B4/B9/B6, or B4-int4/B6-int4, at ``decode_rows``
rows), its draft step on the same weights.  Caches are built directly (no
prefill) with constant contents, once per timed chain: timing does not
depend on values.  Each phase is timed by ``engine/profiling.py``'s chain
(CUDA events around n back-to-back steps; on ``--device cpu``, the host
clock, a CPU time).  Prints the summary of ``scripts/profile_decode.py``,
then one JSON line with every phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from magicdec_tpu_torch import resolve_device

PHASES = ("baseline_step_ms", "draft_step_ms", "verify_step_ms", "noctx_step_ms", "head_ms")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="llama-3.2-1b")
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--ctx", type=int, default=8192)
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--draft_budget", type=int, default=513)
    p.add_argument("--kv_quant", default=None, choices=["int8", "int4"])
    p.add_argument("--quantize", default=None, choices=["int8", "int4"],
                   help="quantized verify weights (quantize_params of the synthetic "
                        "weights, head included); the draft step then shares them")
    p.add_argument("--draft_quant", default=None, choices=["int8", "int4"],
                   help="quantized draft-pass weight copy (EngineConfig.draft_quant): "
                        "draft_step runs on it")
    p.add_argument("--quant_backend", default="pallas", choices=["jnp", "pallas"])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--seq_round", type=int, default=2048)
    p.add_argument("--phases", default=None,
                   help="comma-separated subset of: " + ",".join(PHASES))
    p.add_argument("--dense_kernels", action="store_true",
                   help="A/B: the target's bf16 decode and verify dots on B15 "
                        "(quantization.set_dense_kernels)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _device_busy(fn, mk, w):
    """(device ms of all kernels, device ms of the weight dots' kernels) of
    one step of ``fn`` under torch.profiler, after a warm step."""
    from torch.profiler import ProfilerActivity, profile

    st = fn(mk(), w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(st, w)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(e):
        t = getattr(e, "self_device_time_total", None)
        return (t if t is not None else e.self_cuda_time_total) / 1e3

    return (sum(ms(e) for e in kern),
            sum(ms(e) for e in kern if "qmm" in e.key or "ffn_" in e.key))


def main(argv=None):
    """Run the profile; returns {phase: ms}."""
    args = parse_args(argv)
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.profiling import _chain
    from magicdec_tpu_torch.models import llama as M

    dev = resolve_device(args.device)
    cfg = ModelConfig.from_name(args.model)
    params = M.fuse_exec_params(make_params(cfg, device=dev), cfg)
    if args.quantize:
        params = Q.quantize_params(params, bits=8 if args.quantize == "int8" else 4)
    dparams = params
    if args.draft_quant and not args.quantize:
        dparams = Q.quantize_params(params, bits=8 if args.draft_quant == "int8" else 4)

    B, ctx, g = args.B, args.ctx, args.gamma
    hcfg = dataclasses.replace(cfg, decode_rows=B * (g + 1))
    S = -(-(ctx + 80 + g + 2) // args.seq_round) * args.seq_round
    L, Hkv, hd = cfg.n_layer, cfg.n_kv_head, cfg.head_dim
    K = Hkv * hd

    def make_tcaches():
        if args.kv_quant:
            lanes = K // 2 if args.kv_quant == "int4" else K
            return {"k": torch.ones((L, B, S, lanes), dtype=torch.int8, device=dev),
                    "v": torch.ones((L, B, S, lanes), dtype=torch.int8, device=dev),
                    "ks": torch.full((L, B, Hkv, S), 0.01, device=dev),
                    "vs": torch.full((L, B, Hkv, S), 0.01, device=dev)}
        return {n: torch.full((L, B, S, K), 0.1, dtype=torch.bfloat16, device=dev)
                for n in "kv"}

    dcap = -(-(args.draft_budget + 80 + g + 2) // 128) * 128

    def make_dcaches():
        return {n: torch.full((L, B, dcap, K), 0.1, dtype=torch.bfloat16, device=dev)
                for n in ("dk", "dv")}

    def full(v, *shape):
        return torch.full(shape or (B,), v, dtype=torch.int32, device=dev)

    def baseline_step(st, params):
        tok, lens, caches = st
        nxt, caches = M.forward_target(params, hcfg, tok, lens, caches)
        return nxt, lens + 1, caches

    def noctx_step(st, params):
        tok, lens, caches = st
        nxt, caches = M.forward_target(params, hcfg, tok, lens, caches)
        return nxt, lens, caches  # lens stays 0

    def draft_step(st, dparams):
        tok, fill, caches = st
        nxt, caches = M.forward_draft(dparams, cfg, tok, fill, fill, caches)
        return nxt, fill + 1, caches

    def verify_step(st, params):
        buf, lens, caches = st
        out, caches = M.forward_target(params, hcfg, buf, lens, caches)
        return torch.cat([out[:, :1], out[:, :-1]], 1), lens + g + 1, caches

    def head_only(st, params):
        (x,) = st
        t = M.head_argmax(params, hcfg, x)
        return (x + t[..., None].to(x.dtype) * 0 + 1e-6,)

    n = args.iters
    x_np = (np.random.RandomState(0).randn(B, 1, cfg.dim) * 0.1).astype(np.float32)
    phases = {
        "baseline_step_ms": (baseline_step, n,
                             lambda: (full(0, B, 1), full(ctx), make_tcaches()), params),
        "draft_step_ms": (draft_step, n,
                          lambda: (full(0, B, 1), full(args.draft_budget), make_dcaches()),
                          dparams),
        "verify_step_ms": (verify_step, max(2, n // 2),
                           lambda: (full(0, B, g + 1), full(ctx), make_tcaches()), params),
        "noctx_step_ms": (noctx_step, n,
                          lambda: (full(0, B, 1), full(0), make_tcaches()), params),
        "head_ms": (head_only, n,
                    lambda: (torch.from_numpy(x_np).to(dev, torch.bfloat16),), params),
    }
    want = args.phases.split(",") if args.phases else list(PHASES)
    unknown = sorted(set(want) - set(PHASES))
    if unknown:
        raise ValueError(f"unknown phases {unknown}; choose from {PHASES}")
    old = Q.matmul_backend(), Q.dense_kernels()
    Q.set_matmul_backend(args.quant_backend)
    Q.set_dense_kernels(args.dense_kernels)
    r = {}
    try:
        for name in want:
            fn, nn, mk, w = phases[name]
            t0 = time.perf_counter()
            r[name] = _chain(fn, nn, mk, w)() * 1e3
            print(f"{name:28s} {r[name]:10.3f}   (wall {time.perf_counter() - t0:.0f}s)",
                  flush=True)
            if dev.type == "cuda":
                busy, dots = _device_busy(fn, mk, w)
                r[name[:-3] + "_device_busy_ms"], r[name[:-3] + "_dots_device_ms"] = busy, dots
                print(f"{name[:-3] + '_device_busy_ms':28s} {busy:10.3f}   (the weight dots' "
                      f"kernels {dots:.3f})", flush=True)
    finally:
        Q.set_matmul_backend(old[0])
        Q.set_dense_kernels(old[1])

    if "draft_step_ms" in r and "verify_step_ms" in r:
        w = r["draft_step_ms"] * g + r["verify_step_ms"]
        print(f"{'window_ms_est':28s} {w:10.3f}", flush=True)
        print(f"{'tok_per_s_spec_at_3.4':28s} {3.4 * B / w * 1e3:10.3f}", flush=True)
    if "baseline_step_ms" in r:
        print(f"{'tok_per_s_ar':28s} {B / r['baseline_step_ms'] * 1e3:10.3f}", flush=True)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = ("_dense" if args.dense_kernels else "") + (f"_{args.quantize}" if args.quantize else "")
    print(json.dumps({"metric": f"profile_decode_{args.model}_B{B}_ctx{ctx}{tag}_torch",
                      "unit": "ms", "device": device, "detail": r}))
    return r


if __name__ == "__main__":
    main()
