"""RULER task JSON-lines generation (counterpart of
``scripts/prepare_ruler.py``).

    python -m magicdec_tpu_torch.prepare_ruler --task niah_single --out niah.jsonl \\
        --num_samples 16 --context_words 4000

Writes ``--num_samples`` rows of ``data/ruler/synthetic.py``'s ``--task``
(``--context_words`` applies to every task but the two word-extraction
ones), the rows of the JAX package's generator for the same seed.
"""

from __future__ import annotations

import argparse

from magicdec_tpu_torch.data.ruler.synthetic import TASKS, write_jsonl


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", choices=sorted(TASKS), required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--context_words", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def main(argv=None):
    """Write the file; returns {'path', 'samples'}."""
    args = parse_args(argv)
    kw = dict(num_samples=args.num_samples, seed=args.seed)
    if "words_extraction" not in args.task:
        kw["context_words"] = args.context_words
    n = write_jsonl(args.task, args.out, **kw)
    print(f"wrote {n} samples to {args.out}")
    return {"path": args.out, "samples": n}


if __name__ == "__main__":
    main()
