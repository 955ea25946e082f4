"""Attention and append kernel microbenchmarks of the port: each Hopper
kernel against its plain PyTorch version (counterpart of
``benchmarks/kernel_benchmark.py``, whose "xla" rows are the plain versions
here).

    python -m magicdec_tpu_torch.kernel_benchmark [--B 32] [--S 8704] [--C 512]
        [--which all|decode|prefill|append|paged] [--device cpu]

Each case is timed by ``engine/profiling.py``'s chain: ``--iters`` launches
back to back, each attention launch's output feeding the next one's queries,
between CUDA events (on ``--device cpu``: the host clock, a CPU time).  The
last line is the JSON result; ``detail`` holds every case in ms.

Cases (``--which``):
  decode   K1 and K1q at T = 1 and ``--T`` (the verify window) over one
           layer of an S-row cache, every request at length S - T;
  prefill  K2 and K2q over a ``--C``-row chunk at length S - C, and the
           int8 cache dequantized then K2;
  append   the in-place appends over the layer stack (int8 rows of 2048-row
           caches with their f32 scales) at T = 1 and ``--T``: K3q's one
           merged launch (``append_T{t}_merged``) against B14's four
           per-array launches (``append_T{t}_per_array``, the
           ``MAGICDEC_PER_ARRAY_APPEND`` path);
  paged    B12 over bf16 and int8 pools, one layer, a permuted page table.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from magicdec_tpu_torch import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="llama-3.2-1b")
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--S", type=int, default=8704, help="cache capacity (tile of 512)")
    p.add_argument("--C", type=int, default=512, help="prefill chunk rows")
    p.add_argument("--T", type=int, default=5, help="verify window gamma+1 for the decode kernels")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--which", default="all",
                   choices=["all", "decode", "prefill", "append", "paged"])
    return p.parse_args(argv)


def main(argv=None):
    """Run the cases; returns {case: ms}."""
    args = parse_args(argv)
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.profiling import _chain
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import paged_attention as PGA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import dequant_kv, quantize_kv_tokens

    dev = resolve_device(args.device)
    cfg = ModelConfig.from_name(args.model)
    B, S, C, T = args.B, args.S, args.C, args.T
    Hq, Hkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    K = Hkv * hd
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    results = {}

    def bench(name, fn, q, *rest):
        """fn(q, *rest) -> an array shaped like q, timed as a chain whose
        launches each take the previous output as queries."""
        ms = _chain(lambda st, w: (fn(st[0], *w),), args.iters, lambda: (q.clone(),),
                    rest)() * 1e3
        results[name] = round(ms, 4)
        print(f"[kernel] {name:32s} {ms:8.4f} ms", file=sys.stderr, flush=True)

    def lens(n):
        return torch.full((B,), n, dtype=torch.int32, device=dev)

    if args.which in ("all", "decode", "prefill"):
        k4, v4 = randn(B, S, Hkv, hd), randn(B, S, Hkv, hd)
        k, v = k4.reshape(1, B, S, K), v4.reshape(1, B, S, K)
        (kq, ks), (vq, vs) = quantize_kv_tokens(k4), quantize_kv_tokens(v4)
        kq, ks, vq, vs = kq[None], ks[None], vq[None], vs[None]
        del k4, v4

    if args.which in ("all", "decode"):
        for t in sorted({1, T}):
            q = randn(B, t, Hq, hd)
            bench(f"decode_T{t}_plain", DA.flash_decode_attend_plain, q, k, v, lens(S - t))
            bench(f"decode_T{t}_flash", DA.flash_decode_attend, q, k, v, lens(S - t))
            bench(f"decode_T{t}_int8_plain", DA.flash_decode_attend_quant_plain, q, kq, ks,
                  vq, vs, lens(S - t))
            bench(f"decode_T{t}_int8_flash", DA.flash_decode_attend_quant, q, kq, ks, vq, vs,
                  lens(S - t))

    if args.which in ("all", "prefill"):
        q = randn(B, C, Hq, hd)
        bench("prefill_flash", PA.flash_prefill_attend, q, k, v, lens(S - C))
        bench("prefill_int8_flash", PA.flash_prefill_attend_quant, q, kq, ks, vq, vs,
              lens(S - C))

        def dequant_then_flash(x, kq, ks, vq, vs, base):
            kd = dequant_kv(kq[0], ks[0], hd, x.dtype)[None]
            vd = dequant_kv(vq[0], vs[0], hd, x.dtype)[None]
            return PA.flash_prefill_attend(x, kd, vd, base)

        bench("prefill_int8_dequant_flash", dequant_then_flash, q, kq, ks, vq, vs, lens(S - C))

    if args.which in ("all", "decode", "prefill"):
        del k, v, kq, ks, vq, vs

    if args.which in ("all", "append"):
        # in-place appends at decode and verify windows over the layer stack
        # (their cost does not depend on S; a small S keeps the caches cheap
        # to rebuild for each chain)
        L, Sa = cfg.n_layer, 2048
        pos = lens(Sa // 2)

        def mk_state():
            return (torch.zeros((L, B, Sa, K), dtype=torch.int8, device=dev),
                    torch.zeros((L, B, Sa, K), dtype=torch.int8, device=dev),
                    torch.zeros((L, B, Hkv, Sa), device=dev),
                    torch.zeros((L, B, Hkv, Sa), device=dev))

        def merged(st, w):
            ck, cv, sk, sv = st
            pos, rows, srows = w
            return AP.append_all_rows_inplace_quant(ck, cv, rows, rows, pos, sk, sv, srows,
                                                    srows)

        def per_array(st, w):
            ck, cv, sk, sv = st
            pos, rows, srows = w
            return (AP.append_rows_inplace(ck, rows, pos), AP.append_rows_inplace(cv, rows, pos),
                    AP.append_scale_rows_inplace(sk, srows, pos),
                    AP.append_scale_rows_inplace(sv, srows, pos))

        for t in sorted({1, T}):
            rows = torch.ones((L, B, t, K), dtype=torch.int8, device=dev)
            srows = torch.ones((L, B, Hkv, t), device=dev)
            for name, fn in ((f"append_T{t}_merged", merged),
                             (f"append_T{t}_per_array", per_array)):
                ms = _chain(fn, args.iters, mk_state, (pos, rows, srows))() * 1e3
                results[name] = round(ms, 4)
                print(f"[kernel] {name:32s} {ms:8.4f} ms", file=sys.stderr, flush=True)

    if args.which in ("all", "paged"):
        # page-table indirection at the contiguous kernel's logical shape:
        # one layer of pools, a permuted table
        ps = 2048 if S % 2048 == 0 else (512 if S % 512 == 0 else 128)
        npr = S // ps
        perm = torch.randperm(B * npr, generator=gen, device=dev).to(torch.int32)
        table = perm.reshape(B, npr).contiguous()
        kp, vp = (torch.zeros((1, B * npr, ps, K), dtype=bf, device=dev) for _ in range(2))
        kp8 = torch.zeros((1, B * npr, ps, K), dtype=torch.int8, device=dev)
        sk8 = torch.zeros((1, B * npr, Hkv, ps), device=dev)
        for t in sorted({1, T}):
            q = randn(B, t, Hq, hd)
            bench(f"paged_decode_T{t}_flash", PGA.flash_paged_decode_attend, q, kp, vp, table,
                  lens(S - t))
            bench(f"paged_decode_T{t}_int8_flash", PGA.flash_paged_decode_attend_quant, q, kp8,
                  sk8, kp8, sk8, table, lens(S - t))

    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"metric": f"kernel_bench_{args.model}_B{B}_S{S}_torch",
                      "value": results.get("decode_T1_flash", 0.0), "unit": "ms",
                      "vs_baseline": 1.0, "device": device, "detail": results}))
    return results


if __name__ == "__main__":
    main()
