"""Attention and append kernel microbenchmarks of the port: each Hopper
kernel against its plain PyTorch version (counterpart of
``benchmarks/kernel_benchmark.py``, whose "xla" rows are the plain versions
here).

    python -m magicdec_tpu_torch.kernel_benchmark [--B 32] [--S 8704] [--C 512]
        [--bases 7680,0] [--which all|decode|prefill|append|paged|encode|dots|dense_mlp]
        [--bench_args "--B 32 ..."] [--device cpu]

The ``append`` cases are timed by ``engine/profiling.py``'s chain:
``--iters`` launches back to back between CUDA events (on ``--device cpu``:
the host clock, a CPU time); the attention cases by ``graph_ms`` (below).  The
last line is the JSON result; ``detail`` holds every case in ms.

Cases (``--which``):
  decode   K1 (bf16 cache), K1q (int8) and B10 (int4 packed in head
           pairs) at T = 1 and ``--T`` (the verify window) with the
           window's fresh rows, over the layer stack's S-row caches in turn,
           the requests' lengths ragged in [S - S/17, S - S/85 - T) (the
           bench's 8192 ... 8600 at S = 8704): ``decode_{kind}_T{t}`` is
           the device time a call (``graph_ms``, one call a layer captured
           in a CUDA graph; on ``--device cpu`` the host clock over the
           plain versions).  An A/B against an older checkout runs as for
           ``prefill``;
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
           ``MAGICDEC_PER_ARRAY_APPEND`` path); on the card also
           ``launch_floor_device``, one ``add_`` on one element by
           ``graph_ms``: the least device time any kernel launch takes;
  paged    B12 over bf16, int8 and int4 pools of the layer stack at page
           sizes 512 and 16 (those dividing S), a permuted page table,
           lengths ragged in [0, S - T]: ``paged_{kind}_ps{ps}_T{t}``,
           device time a call as for ``decode`` (A/B likewise);
  encode   (not in "all") the time to first token at the bench's shapes:
           the wall milliseconds of ``SpecEngine.encode`` (target and draft
           prefill, ``encode_spec_{r}``) and ``encode_baseline`` (target
           prefill, ``encode_baseline_{r}``), two runs each after a warm one,
           between synchronizations, with the bench's flags from
           ``--bench_args`` (its defaults otherwise).  It uses only
           ``bench.setup`` and the engine's methods, so an A/B against an
           older checkout runs as for ``prefill``;
  dots     (the card only; not in "all") the draft's int8 dots B4 (wqkv +
           norm, wo + residual, w13 + norm + gate, w2 + residual), B5 (the
           three as one layer tail, ``tail_M{m}``) and B6 (the lm_head), B9
           (the FFN block at 256 rows, ``mlp_M256``; B5 and B9 also with
           ``prefetch=False``, ``_no_prefetch``, where the wrappers take it) and
           its int4 dots B4-int4 (``int4_`` wqkv, wo + residual, w13 +
           gate, w2 + residual; group 128) and B6-int4 (``int4_lm_head``)
           at the model's widths and M = B and 2B rows, and the target's
           bf16 dots B15 (``dense_matmul_fused``: ``dense_`` wqkv + norm,
           wo + residual, w13 + norm, w2 + residual) at M = 128 (the verify
           rows at B = 32, gamma 3) and 16, over the layer stack's weights
           in turn: ``{dot}_M{m}_device`` is the device time a call
           (``graph_ms``: one call per layer captured in a CUDA graph,
           replayed between CUDA events), ``_matmul_device`` torch.matmul
           on a bf16 weight of the same shape (the library yardstick).
           ``chip_smoke.py`` times the same dots with the same ``graph_ms``
           beside its correctness checks; this case exists for A/B runs:
           it uses only the wrappers' public signatures, so the file also
           runs against an older checkout of the package, whose own
           ``chip_smoke.py`` may have no device times (PYTHONPATH=<checkout>
           python magicdec_tpu_torch/kernel_benchmark.py --which dots).
           B15's ``dense_mlp`` (the FFN block with its residual) at M =
           128, 16 and 402: ``dense_mlp_M{m}_device`` beside
           ``dense_mlp_M{m}_cublas_device``, the main path's own FFN with
           the dense kernels off (``cublas_ffn``);
  dense_mlp  (the card only; not in "all") the ``dense_mlp`` cases of
           ``dots`` alone, for the A/B against an older checkout.
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
                   choices=["all", "decode", "prefill", "append", "paged", "encode", "dots",
                            "dense_mlp"])
    p.add_argument("--bench_args", default="",
                   help="encode: the bench's flags, one string (its defaults otherwise)")
    p.add_argument("--dump", default="",
                   help="decode, paged: torch.save each case's layer-0 output to this file "
                            "(to compare two checkouts' bits)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the cases; returns {case: ms}."""
    args = parse_args(argv)
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.profiling import _chain
    from magicdec_tpu_torch.kernels import append as AP

    dev = resolve_device(args.device)
    cfg = ModelConfig.from_name(args.model)
    B, S, C, T = args.B, args.S, args.C, args.T
    Hkv, hd = cfg.n_kv_head, cfg.head_dim
    K = Hkv * hd
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def lens(n):
        return torch.full((B,), n, dtype=torch.int32, device=dev)

    outputs = {}
    if args.which in ("all", "decode"):
        results.update(_decode(cfg, B, S, T, dev, gen, outputs))

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
        if dev.type == "cuda":
            one = torch.zeros(1, device=dev)
            results["launch_floor_device"] = graph_ms([lambda: one.add_(1)] * L)
            print(f"[kernel] {'launch_floor_device':32s} {results['launch_floor_device']:8.4f} "
                  "ms", file=sys.stderr, flush=True)

    if args.which in ("all", "paged"):
        results.update(_paged(cfg, B, S, T, dev, gen, outputs))
    if args.dump:
        torch.save(outputs, args.dump)

    if args.which == "encode":
        results.update(_encode(args.bench_args.split() + ["--device", args.device], dev))

    if args.which == "dots":
        results.update(_dots(cfg, B, dev, gen))
    if args.which == "dense_mlp":
        results.update(_dots_dense_mlp(cfg, dev, gen))

    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"metric": f"kernel_bench_{args.model}_B{B}_S{S}_torch",
                      "value": results.get("decode_bf16_T1", 0.0), "unit": "ms",
                      "vs_baseline": 1.0, "device": device, "detail": results}))
    return results


def _timed(calls, dev):
    """Device ms a call of ``calls`` (graph replay) on the card; on the CPU
    the host clock over one pass."""
    if dev.type == "cuda":
        return graph_ms(calls)
    t0 = time.perf_counter()
    for call in calls:
        call()
    return (time.perf_counter() - t0) * 1e3 / len(calls)


def _quant_operands(shape, Hkv, gen, dev):
    """Random int8 rows (int8 values, or packed int4 pairs) of ``shape``
    and f32 scales [.., Hkv, rows] for timing: a kernel's time does not
    depend on the values."""
    q = torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((*shape[:-2], Hkv, shape[-2]), generator=gen, device=dev) / 64
    return q, s


def _decode(cfg, B, S, T, dev, gen, outputs):
    """The ``decode`` cases (see the module docstring); returns {case: ms}."""
    from magicdec_tpu_torch.kernels import decode_attention as DA

    L, Hq, Hkv, hd = cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    K = Hkv * hd
    bf = torch.bfloat16
    lo = S - S // 17
    base = torch.randint(lo, max(lo + 1, S - S // 85 - T), (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    kinds = {"bf16": (DA.flash_decode_attend, K), "int8": (DA.flash_decode_attend_quant, K),
             "int4": (DA.flash_decode_attend_quant4, K // 2)}
    results = {}
    for kind, (fn, width) in kinds.items():
        if kind == "bf16":
            caches = tuple(torch.randn((L, B, S, K), generator=gen, device=dev).to(bf)
                           for _ in range(2))
        else:
            k, ks = _quant_operands((L, B, S, width), Hkv, gen, dev)
            v, vs = _quant_operands((L, B, S, width), Hkv, gen, dev)
            caches = (k, ks, v, vs)
        for t in sorted({1, T}):
            q = torch.randn((B, t, Hq, hd), generator=gen, device=dev).to(bf)
            if kind == "bf16":
                fresh = {"k_new": torch.randn((B, t, K), generator=gen, device=dev).to(bf),
                         "v_new": torch.randn((B, t, K), generator=gen, device=dev).to(bf)}
            else:
                (kn, ksn), (vn, vsn) = (_quant_operands((B, t, width), Hkv, gen, dev)
                                        for _ in range(2))
                fresh = {"k_new": kn, "v_new": vn, "ks_new": ksn, "vs_new": vsn}
            calls = [lambda l=l, q=q, fresh=fresh: fn(q, *caches, base, layer=l, **fresh)
                     for l in range(L)]
            name = f"decode_{kind}_T{t}"
            outputs[name] = calls[0]().cpu()
            results[name] = _timed(calls, dev)
            print(f"[kernel] {name:32s} {results[name]:8.4f} ms", file=sys.stderr, flush=True)
        del caches
    return results


def _paged(cfg, B, S, T, dev, gen, outputs):
    """The ``paged`` cases (see the module docstring); returns {case: ms}."""
    from magicdec_tpu_torch.kernels import paged_attention as PGA

    L, Hq, Hkv, hd = cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    K = Hkv * hd
    bf = torch.bfloat16
    base = torch.randint(0, S - T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    kinds = {"bf16": (PGA.flash_paged_decode_attend, K),
             "int8": (PGA.flash_paged_decode_attend_quant, K),
             "int4": (PGA.flash_paged_decode_attend_quant4, K // 2)}
    q = torch.randn((B, T, Hq, hd), generator=gen, device=dev).to(bf)
    results = {}
    for ps in (p for p in (512, 16) if S % p == 0):
        npr = S // ps
        P = B * npr
        table = torch.randperm(P, generator=gen, device=dev).to(torch.int32).reshape(B, npr)
        for kind, (fn, width) in kinds.items():
            if kind == "bf16":
                pools = tuple(torch.randn((L, P, ps, K), generator=gen, device=dev).to(bf)
                              for _ in range(2))
                fresh = {"k_new": torch.randn((B, T, K), generator=gen, device=dev).to(bf),
                         "v_new": torch.randn((B, T, K), generator=gen, device=dev).to(bf)}
            else:
                k, ks = _quant_operands((L, P, ps, width), Hkv, gen, dev)
                v, vs = _quant_operands((L, P, ps, width), Hkv, gen, dev)
                pools = (k, ks, v, vs)
                (kn, ksn), (vn, vsn) = (_quant_operands((B, T, width), Hkv, gen, dev)
                                        for _ in range(2))
                fresh = {"k_new": kn, "v_new": vn, "ks_new": ksn, "vs_new": vsn}
            calls = [lambda l=l, fn=fn, pools=pools, fresh=fresh:
                     fn(q, *pools, table, base, layer=l, **fresh) for l in range(L)]
            name = f"paged_{kind}_ps{ps}_T{T}"
            outputs[name] = calls[0]().cpu()
            results[name] = _timed(calls, dev)
            print(f"[kernel] {name:32s} {results[name]:8.4f} ms", file=sys.stderr, flush=True)
            del pools
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

    Kd = cfg.n_head * cfg.head_dim
    weights = {"wqkv_norm": stack(D, qkv), "wo_residual": stack(Kd, D),
               "w13_norm_gate": stack(D, 2 * F), "w2_residual": stack(F, D),
               "lm_head": stack(D, V, layers=1)}
    norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
    results = {}
    for M in (B, 2 * B):
        x, g, res = (torch.randn((M, n), generator=gen, device=dev).to(bf) for n in (D, F, D))
        o = torch.randn((M, Kd), generator=gen, device=dev).to(bf)
        kernels = {
            "wqkv_norm": lambda q, s: QK.quant_matmul_fused(x, q, s, norm_w),
            "wo_residual": lambda q, s: QK.quant_matmul_fused(o, q, s, res=res),
            "w13_norm_gate": lambda q, s: QK.quant_matmul_fused(x, q, s, norm_w, gate=True),
            "w2_residual": lambda q, s: QK.quant_matmul_fused(g, q, s, res=res),
            "lm_head": lambda q, s: QK.quant_matmul(x, q, s),
        }
        _timed_dots(results, M, kernels, weights,
                    lambda name: {"w2_residual": g, "wo_residual": o}.get(name, x), gen, dev)
    results.update(_dots_ffn(B, weights, norm_w, dev, gen))
    del weights
    results.update(_dots_int4(cfg, B, dev, gen))
    results.update(_dots_dense(cfg, dev, gen))
    results.update(_dots_dense_mlp(cfg, dev, gen))
    return results


def _timed_dots(results, M, kernels, weights, lhs_of, gen, dev):
    """``{dot}_M{m}_device`` and ``_matmul_device`` (torch.matmul on a bf16
    weight of the dot's [In, Out], one per layer) of each kernel
    ``kernels[name](*weights[name] of one layer)``."""
    for name, fn in kernels.items():
        stack = weights[name]
        layers = stack[0].shape[0]
        calls = [lambda l=l: fn(*(t[l] for t in stack)) for l in range(layers)]
        lhs = lhs_of(name)
        lib_w = [torch.randn((lhs.shape[1], stack[0].shape[-1]), generator=gen,
                             device=dev).to(torch.bfloat16) for _ in range(layers)]
        lib = [lambda w=w: torch.matmul(lhs, w) for w in lib_w]
        for tag, ms in ((f"{name}_M{M}_device", graph_ms(calls)),
                        (f"{name}_M{M}_matmul_device", graph_ms(lib))):
            results[tag] = ms
            print(f"[kernel] {tag:40s} {ms:8.4f} ms", file=sys.stderr, flush=True)
        del lib_w, lib
        torch.cuda.empty_cache()


def _dots_ffn(B, weights, norm_w, dev, gen):
    """B5 (``tail_M{m}_device``: wo + residual + FFN + residual, the three
    B4 pieces' weights in one call) at M = B and 2B and B9 (``mlp_M256``:
    the FFN block with its residual, the draft prefill chunk of two
    requests) over the layer stack in turn; where the wrapper takes
    ``prefetch`` also ``_no_prefetch``, each dot's weights held until the
    grid barrier before it opens (what issuing them early saves)."""
    import inspect

    from magicdec_tpu_torch.kernels import quant_matmul as QK

    bf = torch.bfloat16
    (qo, so), (q13, s13), (q2, s2) = (weights[k] for k in
                                      ("wo_residual", "w13_norm_gate", "w2_residual"))
    L, Kd, D = qo.shape
    variants = {"": {}}
    if "prefetch" in inspect.signature(QK.quant_layer_tail).parameters:
        variants["_no_prefetch"] = {"prefetch": False}
    results = {}

    def timed(tag, calls):
        results[tag] = graph_ms(calls)
        print(f"[kernel] {tag:40s} {results[tag]:8.4f} ms", file=sys.stderr, flush=True)

    for M in (B, 2 * B):
        a, x = (torch.randn((M, n), generator=gen, device=dev).to(bf) for n in (Kd, D))
        for name, kw in variants.items():
            timed(f"tail{name}_M{M}_device",
                  [lambda l=l, kw=kw: QK.quant_layer_tail(a, x, qo[l], so[l], q13[l], s13[l], q2[l],
                                                          s2[l], norm_w, eps=1e-5, **kw)
                   for l in range(L)])
    x = torch.randn((256, D), generator=gen, device=dev).to(bf)
    for name, kw in variants.items():
        timed(f"mlp{name}_M256_device",
              [lambda l=l, kw=kw: QK.quant_mlp(x, q13[l], s13[l], q2[l], s2[l], norm_w, x,
                                               eps=1e-5, **kw)
               for l in range(L)])
    return results


def _dots_int4(cfg, B, dev, gen):
    """B4-int4 and B6-int4 at M = B and 2B: packed int4 weights [L, In/2,
    Out] of random bytes with f32 scales per 128-row group."""
    from magicdec_tpu_torch.kernels import quant_matmul as QK

    L, D, F, V = cfg.n_layer, cfg.dim, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim
    bf = torch.bfloat16

    def stack(In, Out, layers=L):
        q = torch.randint(-128, 128, (layers, In // 2, Out), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, torch.rand((layers, In // 128, Out), generator=gen, device=dev) / (8 * In ** 0.5)

    weights = {"int4_wqkv": stack(D, qkv), "int4_wo_residual": stack(D, D),
               "int4_w13_gate": stack(D, 2 * F), "int4_w2_residual": stack(F, D),
               "int4_lm_head": stack(D, V, layers=1)}
    results = {}
    for M in (B, 2 * B):
        x, g, res = (torch.randn((M, n), generator=gen, device=dev).to(bf) for n in (D, F, D))
        kernels = {
            "int4_wqkv": lambda q, s: QK.quant_matmul_fused_int4(x, q, s),
            "int4_wo_residual": lambda q, s: QK.quant_matmul_fused_int4(x, q, s, res),
            "int4_w13_gate": lambda q, s: QK.quant_matmul_fused_int4(x, q, s, gate=True),
            "int4_w2_residual": lambda q, s: QK.quant_matmul_fused_int4(g, q, s, res),
            "int4_lm_head": lambda q, s: QK.quant_matmul_int4(x, q, s),
        }
        _timed_dots(results, M, kernels, weights,
                    lambda name: g if name == "int4_w2_residual" else x, gen, dev)
    return results


def _dots_dense(cfg, dev, gen):
    """B15's dense_matmul_fused at M = 128 and 16 on bf16 weights."""
    from magicdec_tpu_torch.kernels import dense_matmul as DK

    L, D, F = cfg.n_layer, cfg.dim, cfg.intermediate_size
    qkv = (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim
    bf = torch.bfloat16

    def stack(In, Out):
        return (torch.randn((L, In, Out), generator=gen, device=dev) * In ** -0.5).to(bf),

    weights = {"dense_wqkv_norm": stack(D, qkv), "dense_wo_residual": stack(D, D),
               "dense_w13_norm": stack(D, 2 * F), "dense_w2_residual": stack(F, D)}
    norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
    results = {}
    for M in (128, 16):
        x, g, res = (torch.randn((M, n), generator=gen, device=dev).to(bf) for n in (D, F, D))
        kernels = {
            "dense_wqkv_norm": lambda w: DK.dense_matmul_fused(x, w, norm_w),
            "dense_wo_residual": lambda w: DK.dense_matmul_fused(x, w, res=res),
            "dense_w13_norm": lambda w: DK.dense_matmul_fused(x, w, norm_w),
            "dense_w2_residual": lambda w: DK.dense_matmul_fused(g, w, res=res),
        }
        _timed_dots(results, M, kernels, weights,
                    lambda name: g if name == "dense_w2_residual" else x, gen, dev)
    return results


def cublas_ffn(x, w13, w2, norm_w, res, eps=1e-5):
    """The main path's FFN block with the dense kernels off
    (``models/llama.py _mlp``): rms_norm, the w13 dot, SiLU(gate) * up, the
    w2 dot and the residual, cuBLAS's dots between PyTorch's elementwise
    ops.  ``dense_mlp``'s library column: timed only, the port's kernel
    path never calls it."""
    import torch.nn.functional as F

    from magicdec_tpu_torch.ops.norm import rms_norm

    gu = rms_norm(x, norm_w, eps) @ w13
    Fh = gu.shape[-1] // 2
    return res + (F.silu(gu[..., :Fh]) * gu[..., Fh:]) @ w2


def _dots_dense_mlp(cfg, dev, gen, rows=(128, 16, 402)):
    """B15's dense_mlp (with its residual) at M = 128, 16 and 402 beside
    ``cublas_ffn``, over the layer stack's bf16 w13 and w2 in turn."""
    from magicdec_tpu_torch.kernels import dense_matmul as DK

    if dev.type != "cuda":
        raise SystemExit("dense_mlp times the card's kernels: it needs --device cuda")
    L, D, F = cfg.n_layer, cfg.dim, cfg.intermediate_size
    bf = torch.bfloat16
    w13 = (torch.randn((L, D, 2 * F), generator=gen, device=dev) * D ** -0.5).to(bf)
    w2 = (torch.randn((L, F, D), generator=gen, device=dev) * (0.25 * F ** -0.5)).to(bf)
    norm_w = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(bf)
    results = {}
    for M in rows:
        x, res = (torch.randn((M, D), generator=gen, device=dev).to(bf) for _ in range(2))
        for tag, fn in ((f"dense_mlp_M{M}_device", DK.dense_mlp),
                        (f"dense_mlp_M{M}_cublas_device", cublas_ffn)):
            results[tag] = graph_ms([lambda l=l, fn=fn: fn(x, w13[l], w2[l], norm_w, res)
                                     for l in range(L)])
            print(f"[kernel] {tag:40s} {results[tag]:8.4f} ms", file=sys.stderr, flush=True)
    del w13, w2
    torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
