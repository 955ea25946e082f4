"""Attention and append kernel microbenchmarks of the port: each Hopper
kernel against its plain PyTorch version (counterpart of
``benchmarks/kernel_benchmark.py``, whose "xla" rows are the plain versions
here).

    python -m magicdec_tpu_torch.kernel_benchmark [--B 32] [--S 8704] [--C 512]
        [--bases 7680,0] [--which all|decode|prefill|append|paged|encode|dots]
        [--bench_args "--B 32 ..."] [--device cpu]

Each case is timed by ``engine/profiling.py``'s chain: ``--iters`` launches
back to back, each attention launch's output feeding the next one's queries,
between CUDA events (on ``--device cpu``: the host clock, a CPU time).  The
last line is the JSON result; ``detail`` holds every case in ms.

Cases (``--which``):
  decode   K1 and K1q at T = 1 and ``--T`` (the verify window) over one
           layer of an S-row cache, every request at length S - T;
  prefill  K2 (bf16 cache), K2q (int8) and B11 (int4 packed in head
           pairs) over a ``--C``-row chunk with its fresh rows, at each of
           ``--bases`` (the bench's last chunk, 7680, and its first, 0), over
           the layer stack's caches in turn: ``prefill_{kind}_base{n}`` is
           the device time a call (``graph_ms``, one call per layer
           captured in a CUDA graph and replayed; on ``--device cpu`` the
           host clock over the plain versions), ``prefill_sdpa_base{n}``
           ``scaled_dot_product_attention`` on one layer's bf16 K/V with the
           same visibility as a mask (the library yardstick).  Like
           ``dots`` it uses only the wrappers' public signatures, so an A/B
           against an older checkout runs in one call
           (PYTHONPATH=<checkout> python magicdec_tpu_torch/kernel_benchmark.py
           --which prefill);
  append   the in-place appends over the layer stack (int8 rows of 2048-row
           caches with their f32 scales) at T = 1 and ``--T``: K3q's one
           merged launch (``append_T{t}_merged``) against B14's four
           per-array launches (``append_T{t}_per_array``, the
           ``MAGICDEC_PER_ARRAY_APPEND`` path);
  paged    B12 over bf16 and int8 pools, one layer, a permuted page table;
  encode   (not in "all") the time to first token at the bench's shapes:
           the wall milliseconds of ``SpecEngine.encode`` (target and draft
           prefill, ``encode_spec_{r}``) and ``encode_baseline`` (target
           prefill, ``encode_baseline_{r}``), two runs each after a warm one,
           between synchronizations, with the bench's flags from
           ``--bench_args`` (its defaults otherwise).  It uses only
           ``bench.setup`` and the engine's methods, so an A/B against an
           older checkout runs as for ``prefill``;
  dots     (the card only; not in "all") the draft's int8 dots B4 (wqkv +
           norm, w13 + norm + gate, w2 + residual) and B6 (the lm_head) at
           the model's widths and M = B and 2B rows, over the layer stack's
           weights in turn: ``{dot}_M{m}_device`` is the device time a call
           (``graph_ms``: one call per layer captured in a CUDA graph,
           replayed between CUDA events), ``_matmul_device`` torch.matmul
           on the dequantized bf16 weight (the library yardstick).
           ``chip_smoke.py`` times the same dots with the same ``graph_ms``
           beside its correctness checks; this case exists for A/B runs:
           it uses only the wrappers' public signatures, so the file also
           runs against an older checkout of the package, whose own
           ``chip_smoke.py`` may have no device times (PYTHONPATH=<checkout>
           python magicdec_tpu_torch/kernel_benchmark.py --which dots).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from magicdec_tpu_torch import resolve_device


def graph_ms(calls, reps: int = 20) -> float:
    """Device milliseconds a call of ``calls`` (zero-argument callables, e.g.
    one per layer): run once on a side stream, then all captured in one CUDA
    graph, the graph replayed ``reps`` times between CUDA events, the time
    divided by reps * len(calls).  No host issue is in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(calls))
    del graph
    return ms


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="llama-3.2-1b")
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--S", type=int, default=8704, help="cache capacity (tile of 512)")
    p.add_argument("--C", type=int, default=512, help="prefill chunk rows")
    p.add_argument("--bases", default="7680,0",
                   help="prefill: the chunk's visible cache lengths, comma-separated")
    p.add_argument("--T", type=int, default=5, help="verify window gamma+1 for the decode kernels")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--which", default="all",
                   choices=["all", "decode", "prefill", "append", "paged", "encode", "dots"])
    p.add_argument("--bench_args", default="",
                   help="encode: the bench's flags, one string (its defaults otherwise)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the cases; returns {case: ms}."""
    args = parse_args(argv)
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.profiling import _chain
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import paged_attention as PGA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens

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

    if args.which in ("all", "decode"):
        k4, v4 = randn(B, S, Hkv, hd), randn(B, S, Hkv, hd)
        k, v = k4.reshape(1, B, S, K), v4.reshape(1, B, S, K)
        (kq, ks), (vq, vs) = quantize_kv_tokens(k4), quantize_kv_tokens(v4)
        kq, ks, vq, vs = kq[None], ks[None], vq[None], vs[None]
        del k4, v4
        for t in sorted({1, T}):
            q = randn(B, t, Hq, hd)
            bench(f"decode_T{t}_plain", DA.flash_decode_attend_plain, q, k, v, lens(S - t))
            bench(f"decode_T{t}_flash", DA.flash_decode_attend, q, k, v, lens(S - t))
            bench(f"decode_T{t}_int8_plain", DA.flash_decode_attend_quant_plain, q, kq, ks,
                  vq, vs, lens(S - t))
            bench(f"decode_T{t}_int8_flash", DA.flash_decode_attend_quant, q, kq, ks, vq, vs,
                  lens(S - t))
        del k, v, kq, ks, vq, vs

    if args.which in ("all", "prefill"):
        results.update(_prefill(cfg, B, S, C, [int(x) for x in args.bases.split(",")], dev,
                                gen))

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

    if args.which == "encode":
        results.update(_encode(args.bench_args.split() + ["--device", args.device], dev))

    if args.which == "dots":
        results.update(_dots(cfg, B, dev, gen))

    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"metric": f"kernel_bench_{args.model}_B{B}_S{S}_torch",
                      "value": results.get("decode_T1_flash", 0.0), "unit": "ms",
                      "vs_baseline": 1.0, "device": device, "detail": results}))
    return results


def _prefill(cfg, B, S, C, bases, dev, gen):
    """The ``prefill`` cases (see the module docstring); returns {case: ms}."""
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens, quantize_kv_tokens_int4

    L, Hq, Hkv, hd = cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    K = Hkv * hd
    bf = torch.bfloat16
    cuda = dev.type == "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def quantize(x, fn):
        """[L, B, S, K] bf16 -> (rows [L, B, S, width] int8, scales [L, B,
        Hkv, S]), a layer at a time (a whole cache's float32 temporaries
        would not fit)."""
        pairs = [fn(x[l].view(B, S, Hkv, hd)) for l in range(L)]
        return torch.stack([r for r, _ in pairs]), torch.stack([s for _, s in pairs])

    def timed(calls):
        if cuda:
            return graph_ms(calls)
        t0 = time.perf_counter()
        for call in calls:
            call()
        return (time.perf_counter() - t0) * 1e3 / len(calls)

    kb, vb = randn(L, B, S, K), randn(L, B, S, K)
    # the wrappers' operand order: (k, v), or (k, k_scale, v, v_scale)
    caches = {"bf16": (kb, vb),
              "int8": (*quantize(kb, quantize_kv_tokens), *quantize(vb, quantize_kv_tokens)),
              "int4": (*quantize(kb, quantize_kv_tokens_int4),
                       *quantize(vb, quantize_kv_tokens_int4))}
    fns = {"bf16": PA.flash_prefill_attend, "int8": PA.flash_prefill_attend_quant,
           "int4": PA.flash_prefill_attend_quant4}
    results = {}
    for base in bases:
        lens = torch.full((B,), base, dtype=torch.int32, device=dev)
        q = randn(B, C, Hq, hd)
        kn, vn = randn(B, C, K), randn(B, C, K)
        fresh = {"bf16": {"k_new": kn, "v_new": vn}}
        for kind, fn_q in (("int8", quantize_kv_tokens), ("int4", quantize_kv_tokens_int4)):
            (kq, ks), (vq, vs) = (fn_q(x.view(B, C, Hkv, hd)) for x in (kn, vn))
            fresh[kind] = {"k_new": kq, "v_new": vq, "ks_new": ks, "vs_new": vs}
        for kind, fn in fns.items():
            calls = [lambda l=l, fn=fn, kind=kind: fn(q, *caches[kind], lens, layer=l,
                                                      **fresh[kind]) for l in range(L)]
            results[f"prefill_{kind}_base{base}"] = timed(calls)
        # SDPA on layer 0's bf16 K/V with the fresh rows appended, the same
        # visibility as a mask
        kf = torch.cat([kb[0], kn], 1).view(B, S + C, Hkv, hd).transpose(1, 2)
        vf = torch.cat([vb[0], vn], 1).view(B, S + C, Hkv, hd).transpose(1, 2)
        kf = kf.repeat_interleave(Hq // Hkv, 1).contiguous()
        vf = vf.repeat_interleave(Hq // Hkv, 1).contiguous()
        col = torch.arange(S + C, device=dev)
        t = torch.arange(C, device=dev)
        mask = ((col[None, None] < lens[:, None, None])
                | ((col[None] >= S) & (col[None] - S <= t[:, None]))[None])[:, None]
        qt = q.transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        results[f"prefill_sdpa_base{base}"] = timed(
            [lambda: sdpa(qt, kf, vf, attn_mask=mask)])
        del kf, vf, mask
        for name in [n for n in results if n.endswith(f"_base{base}")]:
            print(f"[kernel] {name:32s} {results[name]:8.4f} ms", file=sys.stderr, flush=True)
    del caches, kb, vb
    if cuda:
        torch.cuda.empty_cache()
    return results


def _encode(bench_argv, dev):
    """The ``encode`` cases (see the module docstring); returns {case: ms}."""
    from magicdec_tpu_torch import bench

    engine, prompts = bench.setup(bench.parse_args(bench_argv))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results = {}
    for name, encode in (("encode_spec", engine.encode),
                         ("encode_baseline", engine.encode_baseline)):
        encode(prompts[0])  # warm: kernel builds, allocator, cuBLAS heuristics
        for r in range(2):
            sync()
            t0 = time.perf_counter()
            st = encode(prompts[0])
            sync()
            results[f"{name}_{r}"] = (time.perf_counter() - t0) * 1e3
            del st
            print(f"[encode] {name}_{r:<26d} {results[f'{name}_{r}']:10.1f} ms", file=sys.stderr,
                  flush=True)
    return results


def _dots(cfg, B, dev, gen):
    """The ``dots`` cases (see the module docstring); returns {case: ms}."""
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    if dev.type != "cuda":
        raise SystemExit("--which dots times the card's kernels: it needs --device cuda")
    L, D, F, V = cfg.n_layer, cfg.dim, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim
    bf = torch.bfloat16

    def stack(In, Out, layers=L):
        q = torch.randint(-127, 128, (layers, In, Out), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, torch.rand((layers, Out), generator=gen, device=dev) / (127 * In ** 0.5)

    weights = {"wqkv_norm": stack(D, qkv), "w13_norm_gate": stack(D, 2 * F),
               "w2_residual": stack(F, D), "lm_head": stack(D, V, layers=1)}
    norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
    results = {}
    for M in (B, 2 * B):
        x, g, res = (torch.randn((M, n), generator=gen, device=dev).to(bf) for n in (D, F, D))
        kernels = {
            "wqkv_norm": lambda q, s: QK.quant_matmul_fused(x, q, s, norm_w),
            "w13_norm_gate": lambda q, s: QK.quant_matmul_fused(x, q, s, norm_w, gate=True),
            "w2_residual": lambda q, s: QK.quant_matmul_fused(g, q, s, res=res),
            "lm_head": lambda q, s: QK.quant_matmul(x, q, s),
        }
        for name, fn in kernels.items():
            q, s = weights[name]
            calls = [lambda l=l: fn(q[l], s[l]) for l in range(q.shape[0])]
            lhs = g if name == "w2_residual" else x
            deq = [(q[l].float() * s[l]).to(bf) for l in range(q.shape[0])]
            lib = [lambda w=w: torch.matmul(lhs, w) for w in deq]
            for tag, ms in ((f"{name}_M{M}_device", graph_ms(calls)),
                            (f"{name}_M{M}_matmul_device", graph_ms(lib))):
                results[tag] = ms
                print(f"[kernel] {tag:32s} {ms:8.4f} ms", file=sys.stderr, flush=True)
            del deq, lib
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
