"""The speed-up ladder of the port (counterpart of
``benchmarks/sweep_benchmark.py``).

    python -m magicdec_tpu_torch.sweep_benchmark [--set ladder|quick|smoke|alpha] \\
        [--out sweep.jsonl] [--device cuda]

Each row runs ``python -m magicdec_tpu_torch.bench`` (the ``alpha`` set:
``magicdec_tpu_torch.longspec_benchmark``) in a fresh process, so a device
out-of-memory ends that row only and every row gets the whole card; the
first stdout line starting with ``{`` is the row's result.  Prints a
markdown table (spec tok/s, speed-up against AR, tokens per step) and,
with ``--out``, writes the results as JSON lines.  The ``ladder``,
``quick`` and ``alpha`` rows are the JAX driver's; its ``smoke`` row runs
the JAX package's plain CPU backends, which the port does not have, so the
port's ``smoke`` row is the bench's rehearsal at the 68m widths (``--B 2
--prefix_len 512 --draft_budget 257 --prefill_chunk 128 --max_gen 12
--iters 1``).  ``--device`` is passed to every row.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = "magicdec_tpu_torch.bench"
LONGSPEC = "magicdec_tpu_torch.longspec_benchmark"

LADDER = [
    # (label, bench args)
    ("8k/B32 bf16", ["--kv_quant", "none", "--draft_quant", "none", "--gamma", "3"]),
    ("8k/B32 int8+dq8", ["--gamma", "3"]),
    ("8k/B48 int4+dq8", ["--kv_quant", "int4", "--B", "48", "--gamma", "3"]),
    ("16k/B32 int4+dq8", ["--kv_quant", "int4", "--prefix_len", "16384", "--gamma", "4"]),
    ("24k/B24 int4+dq8", ["--kv_quant", "int4", "--prefix_len", "24576", "--B", "24",
                          "--gamma", "4", "--kv_scale", "bf16"]),
    ("32k/B32 int4+dq8", ["--kv_quant", "int4", "--prefix_len", "32768", "--B", "32",
                          "--gamma", "4", "--kv_scale", "bf16", "--draft_head", "shared",
                          "--iters", "2"]),
    ("8k/B96 int4+dq8", ["--kv_quant", "int4", "--B", "96", "--gamma", "3", "--kv_scale",
                         "bf16", "--draft_head", "shared", "--prefill_max_call", "4096",
                         "--prefill_chunk", "256"]),
    ("8k/B128 int4+int8w", ["--kv_quant", "int4", "--B", "128", "--gamma", "3", "--quantize",
                            "int8", "--draft_budget", "257", "--kv_scale", "bf16",
                            "--quantize_embed", "--prefill_max_call", "4096",
                            "--prefill_chunk", "128"]),
    ("32k/B32 snapkv int4+dq8", ["--mode", "snapkv", "--kv_quant", "int4", "--prefix_len",
                                 "32768", "--B", "32", "--gamma", "4", "--kv_scale", "bf16",
                                 "--draft_head", "shared", "--quantize_embed",
                                 "--draft_budget", "257", "--iters", "2", "--prefill_chunk",
                                 "256", "--prefill_max_call", "4096"]),
]
QUICK = LADDER[1:2]
SMOKE = [("smoke", ["--model", "68m", "--B", "2", "--prefix_len", "512", "--draft_budget",
                    "257", "--prefill_chunk", "128", "--max_gen", "12", "--iters", "1"])]

_ALPHA_16K = ["--model", "llama-3.1-8b", "--draft_model", "llama-3.2-1b", "--attn_backend",
              "flash", "--quantize", "int4", "--kv_quant", "int4", "--draft_quant", "int8",
              "--mode", "snapkv", "--B", "8", "--prefix_len", "16416", "--max_len", "18432",
              "--gamma", "3", "--kv_scale", "bf16", "--quantize_embed", "--draft_head",
              "shared", "--num_batches", "2", "--warmup_batches", "1", "--baseline"]
_ALPHA_32K = ["--model", "llama-3.1-8b", "--draft_model", "llama-3.2-1b", "--attn_backend",
              "flash", "--quantize", "int4", "--kv_quant", "int4", "--draft_quant", "int8",
              "--B", "4", "--prefix_len", "32768", "--max_len", "34816", "--gamma", "4",
              "--kv_scale", "bf16", "--quantize_embed", "--draft_head", "shared",
              "--num_batches", "2", "--warmup_batches", "1", "--baseline"]
# acceptance sensitivity: three target residual scales a shape (the JSON
# line's tokens_per_step carries the measured acceptance for the curve);
# each row is another synthetic calibration of the same shape
ALPHA = (
    [(f"16k/B8 snapkv res={r or 'default'}",
      (LONGSPEC, _ALPHA_16K + (["--target_residual", str(r)] if r else [])))
     for r in (None, 0.08, 0.015)]
    + [(f"32k/B4 res={r or 'default'}",
        (LONGSPEC, _ALPHA_32K + (["--target_residual", str(r)] if r else [])))
       for r in (None, 0.08, 0.015)]
)
SETS = {"ladder": LADDER, "quick": QUICK, "smoke": SMOKE, "alpha": ALPHA}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--set", default="ladder", choices=sorted(SETS))
    p.add_argument("--out", default=None, help="JSONL output path")
    p.add_argument("--timeout", type=int, default=3600, help="per-config s")
    p.add_argument("--device", default="cuda", help="passed to every row")
    return p.parse_args(argv)


def command(extra, device):
    """The row's command line: the bench (or the named driver module) with
    its flags and ``--device``."""
    module, flags = extra if isinstance(extra, tuple) else (BENCH, extra)
    return [sys.executable, "-m", module] + flags + ["--device", device]


def table(rows):
    """The markdown table's lines."""
    lines = ["| Config | Spec tok/s | Speedup vs AR | tokens/step |", "|---|---|---|---|"]
    for rec in rows:
        if "error" in rec:
            lines.append(f"| {rec['label']} | — | {rec['error']} | — |")
        else:
            tps = rec.get("tokens_per_step")
            tcell = f"{tps:.2f}" if tps else "—"
            lines.append(f"| {rec['label']} | {rec['value']:.0f} | {rec['vs_baseline']:.2f}× | "
                         f"{tcell} |")
    return lines


def main(argv=None):
    """Run the set; returns {'rows': each row's result dict (its 'label'
    added; {'label', 'error'} for a failed row), 'table': the table's
    lines}."""
    args = parse_args(argv)
    rows = []
    for label, extra in SETS[args.set]:
        cmd = command(extra, args.device)
        print(f"[sweep] {label}: {' '.join(cmd)}", file=sys.stderr, flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                               cwd=ROOT)
        except subprocess.TimeoutExpired:
            print(f"[sweep] {label}: TIMEOUT", file=sys.stderr)
            rows.append({"label": label, "error": "timeout"})
            continue
        line = next((ln for ln in r.stdout.splitlines() if ln.startswith("{")), None)
        if r.returncode != 0 or line is None:
            tail = (r.stderr or r.stdout).splitlines()[-3:]
            print(f"[sweep] {label}: FAILED rc={r.returncode} {tail}", file=sys.stderr)
            rows.append({"label": label, "error": f"rc={r.returncode}"})
            continue
        rec = json.loads(line)
        rec["label"] = label
        rows.append(rec)
        print(f"[sweep] {label}: {rec['value']} {rec['unit']} ({rec['vs_baseline']}x)",
              file=sys.stderr, flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for rec in rows:
                f.write(json.dumps(rec) + "\n")
    lines = table(rows)
    print("\n" + "\n".join(lines))
    return {"rows": rows, "table": lines}


if __name__ == "__main__":
    main()
