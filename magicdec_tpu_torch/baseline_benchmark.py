"""Autoregressive baseline driver of the port (counterpart of
``benchmarks/baseline_benchmark.py``).

    python -m magicdec_tpu_torch.baseline_benchmark --model llama-3.2-1b --B 8 \\
        --prefix_len 4000 --max_len 4096 [--kv_quant]

The reference protocol: the prompt windows of ``common.load_dataset``
(``--B`` a batch, ``batch_iterator``: in order, the last partial batch
dropped, ``--num_batches`` batches), each prefilled (``encode_baseline``)
then decoded for ``--max_gen`` greedy tokens (``generate_baseline``), the
decode loop timed between ``torch.cuda.synchronize()`` calls, the first
``--warmup_batches`` batches not counted.  On the card the target runs K2q
(the prefill chunks), K1q at T=1 and K3q with ``--kv_quant``, K2 / K1 / K3
without it.  Same flags and defaults as the JAX driver (``common``); the
per-batch lines go to stderr, ``Final tokens per second :`` to stdout.
"""

from __future__ import annotations

import argparse
import sys

from magicdec_tpu_torch import common, resolve_device


def parse_args(argv=None):
    p = common.add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    p.add_argument("--max_gen", type=int, default=80)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--warmup_batches", type=int, default=2)
    return p.parse_args(argv)


def setup(args, **ecfg_kw):
    """(engine, batches [B, prefix_len] int32 numpy) for the parsed
    arguments; raises NotImplementedError for a path the port does not run
    yet."""
    missing = common.not_ported(args)
    if missing:
        raise NotImplementedError(missing)
    import numpy as np

    from magicdec_tpu_torch.data.datasets import batch_iterator
    from magicdec_tpu_torch.engine.engine import SpecEngine
    from magicdec_tpu_torch.utils.seeding import setup_seed

    dev = resolve_device(args.device)
    setup_seed(args.seed)
    params, cfg = common.load_params_and_config(args.model, dev)
    engine = SpecEngine(params, cfg, common.engine_config(args, **ecfg_kw), device=dev)
    del params
    data = common.load_dataset(args, cfg.vocab_size)
    batches = [np.ascontiguousarray(b[:, :args.prefix_len], np.int32)
               for b in batch_iterator(data[:args.num_batches * args.B], args.B)]
    return engine, batches


def run(args):
    """Every batch; returns {'tokens_per_s' (None when no batch was timed),
    'batches': [per batch {'output', 'num_committed', 'gen_tokens',
    'seconds'}]}."""
    engine, batches = setup(args)
    rng = common.sampling_rng(args, engine.device)
    total_time, total_tokens, runs = 0.0, 0, []
    for i, prompt in enumerate(batches):
        st = engine.encode_baseline(prompt, rng=rng)
        with common.Timer(engine.device) as t:
            st, stats = engine.generate_baseline(st, max_new=args.max_gen)
        del st
        gen = int(stats["gen_tokens"].sum())
        warm = i < args.warmup_batches
        if not warm:
            total_time += t.t
            total_tokens += gen
        runs.append({"output": stats["output"].cpu().numpy(),
                     "num_committed": stats["num_committed"].cpu().numpy(),
                     "gen_tokens": gen, "seconds": t.t})
        print(f"[batch {i}] {gen} tokens in {t.t:.3f}s ({gen / t.t:.1f} tok/s)"
              f"{' [warmup]' if warm else ''}", file=sys.stderr)
        common.print_output(args, stats)
    tps = total_tokens / total_time if total_time > 0 else None
    if tps is not None:
        print(f"Final tokens per second :{tps:.2f}")
    return {"tokens_per_s": tps, "batches": runs}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
