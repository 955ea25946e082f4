"""Self-speculation driver of the port (counterpart of
``benchmarks/selfspec_benchmark.py``).

    python -m magicdec_tpu_torch.selfspec_benchmark --mode streamingllm \\
        --model llama-3.2-1b --B 8 --prefix_len 4000 --max_len 4096 \\
        --draft_budget 513 --gamma 3 [--kv_quant] [--draft_quant] [--benchmark]

The reference protocol of ``baseline_benchmark`` (the same windows,
batches and warmup rule) through ``SpecEngine``: ``--mode`` picks the
draft cache (StreamingLLM or SnapKV), ``--draft_budget`` must be 128k + 1,
``--gamma`` tokens a window.  The reference's metrics: total time, time per
target step, decoding steps, target steps and tokens per second on stdout,
per-batch lines (tokens per target step per sequence, the acceptance
proxy) on stderr.  ``--benchmark``: the phase timers on a fresh encode of
the first batch (``engine/profiling.time_phases``: the target's verify
step, the draft step, the window estimate) and the gamma autotune from the
measured acceptance (``engine/autotune``).  On the card, ``--kv_quant
--draft_quant`` runs the bench's self-spec kernels: K2q, K1q and K3q on
the target, the draft's int8 copy on B4, B5 and B6, its cache on K1 (the
whole-row call) and K3; without ``--draft_quant`` (the JAX driver's
default) the draft's dots are cuBLAS on the shared bf16 weights.
"""

from __future__ import annotations

import argparse
import sys

from magicdec_tpu_torch import baseline_benchmark, common


def parse_args(argv=None):
    p = common.add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    p.add_argument("--mode", default="streamingllm", choices=["streamingllm", "snapkv"])
    p.add_argument("--gamma", type=int, default=3)
    p.add_argument("--draft_budget", type=int, default=257)
    p.add_argument("--max_gen", type=int, default=80)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--warmup_batches", type=int, default=2)
    args = p.parse_args(argv)
    # the reference's shape contracts
    if not args.prefix_len < args.max_len:
        raise ValueError(f"--prefix_len {args.prefix_len} must be below --max_len {args.max_len}")
    if (args.draft_budget - 1) % 128:
        raise ValueError(f"draft budget must be 128k+1, got {args.draft_budget}")
    return args


def run(args):
    """Every batch, then ``--benchmark``'s phases and autotune; returns
    {'tokens_per_s', 'tokens_per_step' (committed tokens per target step per
    sequence; None when no batch was timed), 'batches': [per batch
    {'output', 'num_committed', 'gen_tokens', 'target_steps', 'seconds'}],
    'phases' (ms, or None), 'alpha', 'gamma' (the autotuned gamma, or None),
    'predicted_tokens_per_s'}."""
    engine, batches = baseline_benchmark.setup(
        args, mode=args.mode, gamma=args.gamma, draft_budget=args.draft_budget,
        draft_quant=args.draft_quant or False, draft_quant_head=args.draft_head == "quant")
    rng = common.sampling_rng(args, engine.device)
    total_time, total_tokens, total_steps, runs = 0.0, 0, 0, []
    for i, prompt in enumerate(batches):
        st = engine.encode(prompt, rng=rng)
        with common.Timer(engine.device) as t:
            st, stats = engine.generate(st)
        del st
        gen = int(stats["gen_tokens"].sum())
        steps = int(stats["target_steps"])
        warm = i < args.warmup_batches
        if not warm:
            total_time += t.t
            total_tokens += gen
            total_steps += steps
        runs.append({"output": stats["output"].cpu().numpy(),
                     "num_committed": stats["num_committed"].cpu().numpy(),
                     "gen_tokens": gen, "target_steps": steps, "seconds": t.t})
        print(f"[batch {i}] {gen} tok, {steps} target steps, {t.t:.3f}s ({gen / t.t:.1f} tok/s, "
              f"{gen / steps / args.B:.2f} tok/step/seq){' [warmup]' if warm else ''}",
              file=sys.stderr)
        common.print_output(args, stats)
    out = {"tokens_per_s": None, "tokens_per_step": None, "batches": runs, "phases": None,
           "alpha": None, "gamma": None, "predicted_tokens_per_s": None}
    if total_time > 0:
        out["tokens_per_s"] = total_tokens / total_time
        out["tokens_per_step"] = total_tokens / total_steps / args.B
        print("total time :{:.5f}s, time per iter :{:.5f}s, decoding step: {}, "
              "large model step: {}".format(total_time, total_time / total_steps,
                                            total_tokens, total_steps))
        print(f"Final tokens per second :{out['tokens_per_s']:.2f}")

    if args.benchmark and batches:
        from magicdec_tpu_torch.engine import autotune as AT
        from magicdec_tpu_torch.engine.profiling import time_phases

        st = engine.encode(batches[0])
        phases = out["phases"] = time_phases(engine, st)
        del st
        print("target time :{:.5f}s, draft time :{:.5f}s (per step); "
              "est window: {:.5f}s".format(phases["verify_step_ms"] / 1e3,
                                           phases["draft_step_ms"] / 1e3,
                                           phases["window_ms_est"] / 1e3))
        if total_steps > 0:
            alpha = AT.alpha_from_window_stats(out["tokens_per_step"], args.gamma)
            g_star = AT.pick_gamma(alpha, phases["draft_step_ms"], phases["verify_step_ms"])
            pred = (AT.expected_tokens_per_window(alpha, g_star) * args.B
                    / (g_star * phases["draft_step_ms"] + phases["verify_step_ms"]) * 1e3)
            out.update(alpha=alpha, gamma=g_star, predicted_tokens_per_s=pred)
            print(f"acceptance alpha: {alpha:.3f}; autotuned gamma: {g_star} "
                  f"(predicted {pred:.1f} tok/s vs measured {out['tokens_per_s']:.1f} at "
                  f"gamma={args.gamma})")
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
