"""Standalone-draft speculation benchmark of the port (counterpart of
``benchmarks/longspec_benchmark.py``).

    python -m magicdec_tpu_torch.longspec_benchmark --model llama-3.1-8b \\
        --draft_model llama-3.2-1b --B 8 --prefix_len 16384 --max_len 16512 \\
        --kv_quant int4 --draft_quant int8 --prefill_chunk 512 [--mode snapkv] \\
        [--draft_budget -1] [--baseline]

A smaller draft model speculates ``--gamma`` tokens a window over its own
cache (``engine.engine.LongSpecEngine``): ``--draft_budget -1`` keeps its
whole cache (full mode), otherwise ``--mode`` picks the StreamingLLM or the
SnapKV-compressed cache (a SnapKV prefix must be a multiple of 128 plus the
32-token window, e.g. 16416; it is not rounded here).  Same flags,
defaults and JSON line as the JAX benchmark, with ``_torch`` appended to the
metric, except that ``--attn_backend`` defaults to ``flash`` (the port runs
its Hopper kernels only; ``jnp`` raises), ``--device`` picks the device
(``cpu`` runs the plain kernel versions), and the draft's sub-mesh
(``--model_parallel_outer`` / ``--model_parallel_inner``) and every other
mesh raise, naming ROADMAP item A15.  Weights: for two config names, the
coupled synthetic pair (``bench.make_longspec_params``: ``--quantize``
quantizes the target's stack and head as they are drawn,
``--target_residual`` / ``--draft_residual`` set its residual scales); a
``.npz`` for either model loads both through
``common.load_params_and_config`` (``--quantize`` then quantizes the
target's weights).  Prompts: ``common.load_dataset`` (the synthetic
long-context corpus of ``--seed``, or with ``--model_name`` that
tokenizer's ``--dataset`` windows), ``--B``
requests a batch, ``--num_batches`` batches of which the first
``--warmup_batches`` are not timed; decode-loop wall time between
``torch.cuda.synchronize()`` calls.  ``--baseline``: the target's
autoregressive decoding on the same batches (``vs_baseline``).
``--temperature`` > 0 runs exact speculative sampling (``--top_p``; the
key of ``--seed``, request b of a batch salt b), the baseline sampling with
the same key.  Per-batch
lines go to stderr, the JAX benchmark's totals to stdout, and the last line on
stdout is the JSON result, printed when a batch was timed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from magicdec_tpu_torch import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, default="llama-3.2-1b",
                   help="target: config name (synthetic weights) or a converted checkpoint .npz")
    p.add_argument("--model_name", type=str, default=None,
                   help="HF tokenizer name or directory: --dataset's windows through it "
                        "(common.load_dataset; the synthetic corpus where it does not load)")
    p.add_argument("--dataset", type=str, default="pg19")
    p.add_argument("--B", type=int, default=8)
    p.add_argument("--prefix_len", type=int, default=4000)
    p.add_argument("--max_len", type=int, default=4096)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--printoutput", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--compile", action="store_true",
                   help="accepted for CLI parity; the port runs eagerly")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--attn_backend", default="flash", choices=["jnp", "flash"])
    p.add_argument("--kv_quant", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"])
    p.add_argument("--draft_head", default="quant", choices=["quant", "shared"])
    p.add_argument("--draft_quant", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="quantize the standalone draft's weights (its tied head materialized)")
    p.add_argument("--kv_scale", default="f32", choices=["f32", "bf16"])
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="prefill chunk of both models (0 = the 128-token eviction chunk)")
    p.add_argument("--force_mesh", action="store_true")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="accepted for CLI parity; --device picks the device")
    p.add_argument("--draft_model", type=str, default="llama-3.2-1b")
    p.add_argument("--mode", default="streamingllm", choices=["streamingllm", "snapkv"])
    p.add_argument("--gamma", type=int, default=3)
    p.add_argument("--draft_budget", type=int, default=257,
                   help="-1: the draft keeps its whole cache (full mode)")
    p.add_argument("--max_gen", type=int, default=80)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--warmup_batches", type=int, default=2)
    p.add_argument("--model_parallel_outer", type=int, default=0)
    p.add_argument("--model_parallel_inner", type=int, default=0)
    p.add_argument("--quantize", choices=["int8", "int4"], default=None,
                   help="quantize the TARGET's weights")
    p.add_argument("--quantize_embed", action="store_true")
    p.add_argument("--baseline", action="store_true",
                   help="also run the target's autoregressive baseline on the same batches")
    p.add_argument("--target_residual", type=float, default=None,
                   help="coupled synthetic pair: the target stack's residual scale "
                        "(default 0.24/sqrt(L))")
    p.add_argument("--draft_residual", type=float, default=None)
    p.add_argument("--quant_backend", default="pallas", choices=["jnp", "pallas"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _not_ported(args):
    if args.model_parallel_outer or args.model_parallel_inner:
        return ("the draft's sub-mesh (--model_parallel_outer / --model_parallel_inner) is "
                "ROADMAP item A15")
    if args.data_parallel * args.model_parallel > 1 or args.force_mesh:
        return "a device mesh is ROADMAP item A15"
    if args.attn_backend != "flash":
        return "--attn_backend jnp: the port runs its Hopper kernels only"
    if args.quant_backend != "pallas":
        return "--quant_backend jnp: the port runs its Hopper kernels only"
    return None


def draft_mode(args):
    """(mode, draft budget): ``--draft_budget -1`` selects full mode."""
    return ("full", 257) if args.draft_budget == -1 else (args.mode, args.draft_budget)


def metric_name(args) -> str:
    """The JAX benchmark's metric, ``_torch`` appended."""
    qtag = f"_{args.quantize}" if args.quantize else ""
    qtag += f"_kvq{args.kv_quant[3:]}" if args.kv_quant else ""
    qtag += f"_dq{args.draft_quant[3:]}" if args.draft_quant else ""
    return (f"longspec_{draft_mode(args)[0]}_tokens_per_s_{args.model}_draft_{args.draft_model}"
            f"{qtag}_B{args.B}_ctx{args.prefix_len}_torch")


def load_pair(args, dev):
    """(params, cfg, draft params, draft cfg) for ``--model`` and
    ``--draft_model``."""
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.common import load_params_and_config
    from magicdec_tpu_torch.config import ModelConfig

    bits = None if not args.quantize else 8 if args.quantize == "int8" else 4
    if not str(args.model).endswith(".npz") and not str(args.draft_model).endswith(".npz"):
        from magicdec_tpu_torch.bench import make_longspec_params

        cfg = ModelConfig.from_name(args.model)
        dcfg = ModelConfig.from_name(args.draft_model)
        params, dparams = make_longspec_params(
            cfg, dcfg, t_bits=bits, quantize_embed=args.quantize_embed,
            target_residual=args.target_residual, draft_residual=args.draft_residual,
            device=dev)
        return params, cfg, dparams, dcfg
    params, cfg = load_params_and_config(args.model, dev)
    dparams, dcfg = load_params_and_config(args.draft_model, dev)
    if bits:
        params = Q.quantize_params(params, bits=bits, include_embed=args.quantize_embed)
    return params, cfg, dparams, dcfg


def setup(args):
    """(engine, batches [num_batches] of [B, prefix_len] prompts); raises
    NotImplementedError for a path the port does not run yet."""
    missing = _not_ported(args)
    if missing:
        raise NotImplementedError(missing)
    import torch

    from magicdec_tpu_torch.common import load_dataset
    from magicdec_tpu_torch.data.datasets import batch_iterator
    from magicdec_tpu_torch.engine.engine import EngineConfig, LongSpecEngine
    from magicdec_tpu_torch.utils.seeding import setup_seed

    dev = resolve_device(args.device)
    setup_seed(args.seed)
    params, cfg, dparams, dcfg = load_pair(args, dev)
    mode, budget = draft_mode(args)
    ecfg = EngineConfig(
        mode=mode, gamma=args.gamma, draft_budget=budget, max_seq_len=args.max_len,
        max_gen=args.max_gen, eot_ids=(-1,), prefill_chunk_size=args.prefill_chunk,
        cache_dtype=torch.bfloat16, kv_quant=args.kv_quant or False,
        kv_scale_dtype=torch.bfloat16 if args.kv_scale == "bf16" else torch.float32,
        draft_quant=args.draft_quant or False, draft_quant_head=args.draft_head == "quant",
        temperature=args.temperature, top_p=args.top_p)
    engine = LongSpecEngine(params, cfg, dparams, dcfg, ecfg, device=dev)
    # the engine holds its own (fused, quantized) copies; these go
    del params, dparams
    data = load_dataset(args, min(cfg.vocab_size, dcfg.vocab_size))
    batches = [b[:, :args.prefix_len]
               for b in batch_iterator(data[:args.num_batches * args.B], args.B)]
    return engine, batches


def run(args):
    """Every batch spec (and, with ``--baseline``, AR); returns {'result': the
    JSON dict or None when no batch was timed, 'spec': [per batch {'output',
    'num_committed', 'target_steps', 'seconds', 'encode_s'}], 'base': [per
    batch {'output', 'num_committed', 'seconds'}], 'engine_mode'}."""
    import torch

    from magicdec_tpu_torch.utils.seeding import sampling_rng

    engine, batches = setup(args)
    cuda = engine.device.type == "cuda"
    rng = sampling_rng(args, engine.device)  # --temperature > 0: the key of --seed

    def sync():
        if cuda:
            torch.cuda.synchronize(engine.device)

    spec_runs, base_runs = [], []
    total_time, total_tokens, total_steps = 0.0, 0, 0
    for i, prompt in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        st = engine.encode(prompt, rng=rng)
        sync()
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, stats = engine.generate(st)
        sync()
        dt = time.perf_counter() - t0
        del st
        gen = int(stats["gen_tokens"].sum())
        steps = int(stats["target_steps"])
        warm = i < args.warmup_batches
        if not warm:
            total_time += dt
            total_tokens += gen
            total_steps += steps
        spec_runs.append({"output": stats["output"].cpu().numpy(),
                          "num_committed": stats["num_committed"].cpu().numpy(),
                          "target_steps": steps, "seconds": dt, "encode_s": encode_s})
        print(f"[batch {i}] {gen} tok, {steps} target steps, {dt:.3f}s ({gen / dt:.1f} tok/s), "
              f"encode {encode_s:.3f}s{' [warmup]' if warm else ''}", file=sys.stderr)
        if args.printoutput:
            for b in range(min(4, args.B)):
                n = int(stats["num_committed"][b])
                print(f"[output {b}] {stats['output'][b, :n].tolist()}", file=sys.stderr)
        del stats
    if total_time > 0:
        print(f"total time :{total_time:.5f}s, time per iter :{total_time / total_steps:.5f}s, "
              f"decoding step: {total_tokens}, large model step: {total_steps}")
        print(f"Final tokens per second :{total_tokens / total_time:.2f}")

    base_tps = 0.0
    if args.baseline and total_time > 0:
        bt, btok = 0.0, 0
        for i, prompt in enumerate(batches):
            st = engine.encode_baseline(prompt, rng=rng)
            sync()
            t0 = time.perf_counter()
            st, stats = engine.generate_baseline(st, max_new=args.max_gen)
            sync()
            dt = time.perf_counter() - t0
            del st
            gen = int(stats["gen_tokens"].sum())
            warm = i < args.warmup_batches
            if not warm:
                bt += dt
                btok += gen
            base_runs.append({"output": stats["output"].cpu().numpy(),
                              "num_committed": stats["num_committed"].cpu().numpy(),
                              "seconds": dt})
            print(f"[baseline batch {i}] {gen} tok, {dt:.3f}s ({gen / dt:.1f} tok/s)"
                  f"{' [warmup]' if warm else ''}", file=sys.stderr)
            del stats
        base_tps = btok / bt if bt > 0 else 0.0
        print(f"Baseline tokens per second :{base_tps:.2f}")

    result = None
    if total_time > 0:
        tps = total_tokens / total_time
        result = {"metric": metric_name(args), "value": round(tps, 2), "unit": "tok/s",
                  "vs_baseline": round(tps / base_tps, 4) if base_tps else 1.0,
                  "tokens_per_step": round(total_tokens / max(total_steps, 1) / args.B, 3)}
    else:
        print("[longspec] no batch was timed (--num_batches batches of --B requests, the first "
              "--warmup_batches untimed): no result", file=sys.stderr)
    return {"result": result, "spec": spec_runs, "base": base_runs,
            "engine_mode": engine.ecfg.mode}


def main(argv=None):
    out = run(parse_args(argv))
    if out["result"] is not None:
        print(json.dumps(out["result"]))
    return out


if __name__ == "__main__":
    main()
