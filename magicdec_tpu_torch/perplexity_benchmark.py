"""Perplexity gate driver of the port (counterpart of
``benchmarks/perplexity_benchmark.py``).

    python -m magicdec_tpu_torch.perplexity_benchmark --model llama-3.2-1b \\
        --seq_len 2048 --B 4 [--compare int8|int4|kv_int8|kv_int4] [--quantize int8|int4]

Teacher-forced perplexity (``quality.perplexity``) over ``--num_seqs``
windows of ``--seq_len`` tokens (``common.load_dataset`` windowing by
``--seq_len``: the synthetic corpus of ``--seed``, or with ``--model_name``
that tokenizer's ``--dataset`` windows), ``min(B, windows)`` windows a batch,
``--chunk`` tokens a prefill chunk.  ``--compare int8|int4`` evaluates the
full-precision weights and ``quantize_params`` of them; ``--compare
kv_int8|kv_int4`` the bf16 cache and the quantized cache on the same
weights; ``--quantize`` the quantized weights alone.  On the card the
chunks run K2 over the bf16 cache, K2q over an int8 and B11 over an int4
cache, and the K3 / K3q appends at T = ``--chunk``; quantized weights run
their dots at B x chunk rows, above the quantized kernels' 256-row routing
cap, so they take the plain product (cuBLAS on the dequantized weight).
Same flags, defaults and JSON line as the JAX driver, with ``_torch``
appended to the metric (``vs_baseline`` = quantized ppl / full ppl); the
per-run lines go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from magicdec_tpu_torch import common, resolve_device


def parse_args(argv=None):
    p = common.add_common_args(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    p.add_argument("--seq_len", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=512)
    p.add_argument("--num_seqs", type=int, default=8)
    p.add_argument("--quantize", choices=["int8", "int4"], default=None,
                   help="evaluate the quantized model only")
    p.add_argument("--compare", choices=["int8", "int4", "kv_int8", "kv_int4"], default=None,
                   help="evaluate full precision AND this quantization (kv_int8 / kv_int4 = "
                        "quantized KV cache, weights untouched); the JSON line reports the "
                        "quantized ppl with vs_baseline = ppl_quant / ppl_full")
    return p.parse_args(argv)


def metric_name(args, tag: str) -> str:
    return f"perplexity_{tag}_{args.model.split('/')[-1]}_torch"


def setup(args):
    """(params, cfg, data [num_seqs, seq_len]) for the parsed arguments."""
    missing = common.not_ported(args)
    if missing:
        raise NotImplementedError(missing)
    from magicdec_tpu_torch.utils.seeding import setup_seed

    dev = resolve_device(args.device)
    setup_seed(args.seed)
    params, cfg = common.load_params_and_config(args.model, dev)
    args.prefix_len = args.seq_len  # the data loader windows by prefix_len
    data = common.load_dataset(args, cfg.vocab_size)[:args.num_seqs]
    return params, cfg, data


def run(args):
    """Every evaluation the flags ask for; returns {'result': the JSON dict,
    'runs': {label: {'ppl', 'nll', 'seconds'}} (labels as the stderr lines:
    'bf16', 'bf16+kv_int8', 'int8', ...), 'data': the windows}."""
    import torch

    from magicdec_tpu_torch import quality
    from magicdec_tpu_torch import quantization as Q

    params, cfg, data = setup(args)
    dev = resolve_device(args.device)
    runs = {}

    def evaluate(ps, tag, kv_quant=None):
        kv = (args.kv_quant or False) if kv_quant is None else kv_quant
        label = f"{tag}{f'+kv_{kv}' if kv else ''}"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ppl, nll = quality.perplexity(ps, cfg, data, batch_size=min(args.B, len(data)),
                                      chunk_size=args.chunk, kv_quant=kv, device=dev)
        runs[label] = {"ppl": ppl, "nll": nll, "seconds": time.perf_counter() - t0}
        print(f"[ppl] {label}: ppl={ppl:.4f} nll/token={nll:.5f} ({len(data)} x "
              f"{args.seq_len} tokens, {runs[label]['seconds']:.2f} s)", file=sys.stderr)
        return ppl

    if args.compare in ("kv_int8", "kv_int4"):
        ppl_full = evaluate(params, "bf16", kv_quant=False)
        ppl_q = evaluate(params, "bf16", kv_quant=args.compare.removeprefix("kv_"))
        tag, ratio = args.compare, ppl_q / ppl_full
    elif args.compare:
        bits = 8 if args.compare == "int8" else 4
        ppl_full = evaluate(params, "bf16")
        ppl_q = evaluate(Q.quantize_params(params, bits=bits), args.compare)
        tag, ratio = args.compare, ppl_q / ppl_full
    else:
        if args.quantize:
            params = Q.quantize_params(params, bits=8 if args.quantize == "int8" else 4)
        tag = args.quantize or "bf16"
        ppl_q, ratio = evaluate(params, tag), 1.0
    result = {"metric": metric_name(args, tag), "value": round(ppl_q, 4), "unit": "ppl",
              "vs_baseline": round(ratio, 6) if args.compare else 1.0}
    return {"result": result, "runs": runs, "data": data}


def main(argv=None):
    out = run(parse_args(argv))
    print(json.dumps(out["result"]))
    return out


if __name__ == "__main__":
    main()
