"""Offline HF -> port checkpoint conversion (counterpart of
``scripts/convert_checkpoint.py``):

    python -m magicdec_tpu_torch.convert_checkpoint --checkpoint_dir DIR \\
        [--model_name llama-3.2-1b] [--out model.npz] [--quantize int8|int4] \\
        [--device cuda|cpu]

Writes one ``.npz`` of the layer-stacked params in bf16 (``<DIR>/model.npz``
by default), in the JAX package's format, so either package loads it
(``utils/checkpoint.py``).  With ``--quantize``, also ``<stem>-int8.npz`` /
``<stem>-int4.npz``: the bf16 file loaded back and quantized as the port's
``quantize_params`` quantizes (the layers' dots and the head) on
``--device`` (the card unless ``--device cpu``), a leaf at a time, equal
bit for bit to the JAX script's dump.  ``serving_bench --model`` loads a
name holding ``int8`` / ``int4`` as quantized verify weights
(``quantization.bits_from_path``).  Reads safetensors without the
``safetensors`` package.  One line per file written goes to stdout.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from magicdec_tpu_torch import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", type=Path, required=True)
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--quantize", choices=["int8", "int4"], default=None)
    p.add_argument("--device", default="cuda",
                   help="where --quantize quantizes (cpu: the plain host path)")
    return p.parse_args(argv)


def quantize_dump(path: Path, bits: int, device) -> Path:
    """``<stem>-int8.npz`` / ``-int4.npz`` beside the bf16 ``path``: each
    quantizable leaf loaded, quantized on ``device`` and written before the
    next is touched.  Returns the dump's path."""
    import numpy as np

    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.utils import checkpoint as CK

    out = path.with_name(path.stem + f"-int{bits}.npz")
    quantize = {f"layers.{k}" for k in Q.QUANT_KEYS} | {"lm_head"}
    with np.load(str(path)) as raw, CK.NpzWriter(out) as w:
        for key in raw.files:
            arr = raw[key]
            if key in quantize:
                qw = Q.quantize_weight(CK.tensor_from_rest(arr).to(device), bits=bits,
                                       reciprocal=True)
                for name, leaf in CK.flat_leaves(qw, key + "."):
                    w.write(name, leaf)
                del qw
            else:
                w.write(key, arr)
    return out


def main(argv=None):
    from magicdec_tpu_torch.utils.checkpoint import convert_hf_checkpoint

    args = parse_args(argv)
    out = args.out or (args.checkpoint_dir / "model.npz")
    t0 = time.perf_counter()
    nbytes = convert_hf_checkpoint(str(args.checkpoint_dir), str(out),
                                   model_name=args.model_name)
    print(f"wrote {out} ({nbytes} bytes of arrays in {time.perf_counter() - t0:.2f} s)",
          flush=True)
    if args.quantize:
        dev = resolve_device(args.device)
        t0 = time.perf_counter()
        qout = quantize_dump(Path(out), 8 if args.quantize == "int8" else 4, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"wrote {qout} ({qout.stat().st_size} bytes in "
              f"{time.perf_counter() - t0:.2f} s on {dev.type})", flush=True)


if __name__ == "__main__":
    main()
