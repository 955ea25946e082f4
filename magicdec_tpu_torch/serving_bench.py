"""Continuous-batching serving benchmark of the port (counterpart of
``benchmarks/serving_benchmark.py``).

    python -m magicdec_tpu_torch.serving_bench [--paged] [--slots 4] ...

A stream of requests is served through a fixed number of batch slots with
StreamingLLM self-speculation (``--mode snapkv``: the SnapKV draft cache,
the prefix rounded to a multiple of 128 plus 32 before the corpus is built,
as the JAX benchmark does; ``--ragged`` lengths then break SnapKV's shape
contract and the encode raises, as the JAX package's asserts); finished
slots are recycled with freshly prefilled queued prompts
(``engine/serving.py``; ``--paged``: over a shared KV page pool,
``PagedServingEngine``; ``--draft_model`` or ``--mode full``: a standalone
draft, ``ServingLongSpecEngine`` / ``PagedServingLongSpecEngine``, whose
weights load as ``--model``'s do, ``--model``'s own when no draft is
named).  Same flags, defaults and JSON line
as ``benchmarks/serving_benchmark.py``, with ``_torch`` appended to the
metric, except that ``--attn_backend`` defaults to ``flash`` (the port runs
its Hopper kernels only; ``jnp`` raises) and ``--device`` picks the device
(``cpu`` runs the plain kernel versions).  ``--temperature`` > 0 serves
with exact speculative sampling (``--top_p``; the key of ``--seed``, each
request's id its salt).  ``--model`` is a config name
(synthetic weights, ``bench.make_params``) or a converted checkpoint
``.npz`` (``convert_checkpoint``; its config from the file name, loaded in
bf16 and, for a name holding ``int8`` / ``int4``, as quantized verify
weights that the draft shares, ``--draft_quant`` then off), as
``benchmarks/common.py load_params_and_config`` loads it
(``common.load_params_and_config``).  Prompts: ``common.load_dataset``,
the synthetic long-context corpus of ``--seed`` (``max(2B, 16)``
sequences), or with ``--model_name`` that tokenizer's ``--dataset``
windows.  A warmup
serve of the first ``--slots`` requests (kernel build, allocator, cuBLAS
heuristics; ``--skip_warmup``: none) precedes the timed serve; throughput
counts committed tokens over the timed serve's wall time, admissions
included.  Throughput and scheduler statistics go to stderr; the single
JSON line on stdout is the result.  ``--data_parallel`` splits the slots
(and a paged pool's pages) over data ranks, ``--model_parallel`` runs each
data group tensor-parallel, ``--force_mesh`` builds a one-rank mesh
(``parallel/``: a process a rank, spawned here; ``--dist_backend``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from magicdec_tpu_torch import resolve_device
from magicdec_tpu_torch.common import add_mesh_args, load_dataset, load_params_and_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, default="llama-3.2-1b",
                   help="config name (synthetic weights) or a converted checkpoint .npz "
                        "(-int8 / -int4 in its name: quantized verify weights)")
    p.add_argument("--model_name", type=str, default=None,
                   help="HF tokenizer name or directory: --dataset's windows through it "
                        "(common.load_dataset; the synthetic corpus where it does not load)")
    p.add_argument("--dataset", type=str, default="pg19")
    p.add_argument("--B", type=int, default=8,
                   help="sizes the synthetic corpus (max(2B, 16) sequences)")
    p.add_argument("--prefix_len", type=int, default=4000)
    p.add_argument("--max_len", type=int, default=4096)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--printoutput", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--compile", action="store_true",
                   help="accepted for CLI parity; the port runs eagerly")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--attn_backend", default="flash", choices=["jnp", "flash"])
    p.add_argument("--kv_quant", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"])
    p.add_argument("--draft_head", default="quant", choices=["quant", "shared"])
    p.add_argument("--draft_quant", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"])
    p.add_argument("--kv_scale", default="f32", choices=["f32", "bf16"])
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="accepted for CLI parity; as in the JAX benchmark, the prefill "
                        "chunk follows --prefix_len")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="accepted for CLI parity; --device picks the device")
    p.add_argument("--mode", default="streamingllm", choices=["streamingllm", "snapkv", "full"])
    p.add_argument("--draft_model", type=str, default=None)
    p.add_argument("--slots", type=int, default=4, help="batch slots")
    p.add_argument("--num_requests", type=int, default=12)
    p.add_argument("--gamma", type=int, default=3)
    p.add_argument("--draft_budget", type=int, default=257)
    p.add_argument("--max_gen", type=int, default=80)
    p.add_argument("--windows_per_sync", type=int, default=4)
    p.add_argument("--paged", action="store_true",
                   help="serve over a shared KV page pool (capacity = the sum of the "
                        "request lengths)")
    p.add_argument("--page_size", type=int, default=2048)
    p.add_argument("--total_pages", type=int, default=0,
                   help="pool size in pages (0 = full slots x npr capacity); below "
                        "capacity, FCFS admission blocks on pages")
    p.add_argument("--ragged", action="store_true",
                   help="prompt lengths uniform in [prefix_len//2, prefix_len]")
    p.add_argument("--device", default="cuda")
    p.add_argument("--skip_warmup", action="store_true",
                   help="no warmup serve (for a process whose kernels are built and warm)")
    add_mesh_args(p)
    args = p.parse_args(argv)
    if args.mode == "snapkv":
        from magicdec_tpu_torch.bench import snapkv_prefix

        args.prefix_len = snapkv_prefix(args.prefix_len)
    return args


def _not_ported(args):
    if args.attn_backend != "flash":
        return "--attn_backend jnp: the port runs its Hopper kernels only"
    return None


def metric_name(args) -> str:
    return (f"serving{'_paged' if args.paged else ''}_{args.mode}_tokens_per_s_"
            f"{args.model.split('/')[-1]}_slots{args.slots}_ctx{args.prefix_len}_torch")


def setup(args):
    """(engine, prompts) for the parsed arguments; raises NotImplementedError
    for a path the port does not run yet."""
    missing = _not_ported(args)
    if missing:
        raise NotImplementedError(missing)
    import torch

    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.engine.engine import EngineConfig
    from magicdec_tpu_torch.engine.serving import (PagedServingEngine,
                                                   PagedServingLongSpecEngine, ServingEngine,
                                                   ServingLongSpecEngine)
    from magicdec_tpu_torch.models.llama import fuse_exec_params

    from magicdec_tpu_torch.parallel.multihost import build_mesh

    mesh = build_mesh(args)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    params, cfg = load_params_and_config(args.model, dev, mesh)
    params = fuse_exec_params(params, cfg)
    draft = None
    if args.draft_model or args.mode == "full":
        # a standalone draft, as benchmarks/serving_benchmark.py:83-86 builds it
        draft = load_params_and_config(args.draft_model or args.model, dev, mesh)
    drafted = params if draft is None else draft[0]
    if args.draft_quant and any(Q.is_quantized(w) for w in drafted["layers"].values()):
        # the draft runs these quantized weights, as bench --quantize
        print(f"[serving] {args.draft_model or args.model}: the draft runs its quantized "
              "weights (draft_quant disabled)", file=sys.stderr)
        args.draft_quant = None
    prefix = args.prefix_len
    ecfg = EngineConfig(
        mode=args.mode, gamma=args.gamma, draft_budget=args.draft_budget,
        max_seq_len=args.max_len, chunk_size=128,
        prefill_chunk_size=(min(512, prefix) if prefix % 512 == 0 or prefix % 128 == 0
                            else 128),
        max_gen=args.max_gen, eot_ids=(-1,), cache_dtype=torch.bfloat16,
        page_size=args.page_size, kv_quant=args.kv_quant or False,
        kv_scale_dtype=torch.bfloat16 if args.kv_scale == "bf16" else torch.float32,
        draft_quant=args.draft_quant or False,
        draft_quant_head=args.draft_head == "quant",
        temperature=args.temperature, top_p=args.top_p)
    if draft is not None:
        cls = PagedServingLongSpecEngine if args.paged else ServingLongSpecEngine
        engine = cls(params, cfg, *draft, ecfg, device=dev, mesh=mesh)
        del draft, drafted
    else:
        engine = (PagedServingEngine if args.paged else ServingEngine)(params, cfg, ecfg,
                                                                       device=dev, mesh=mesh)
    del params
    data = load_dataset(args, cfg.vocab_size)
    lens = [prefix] * args.num_requests
    if args.ragged:
        lrng = np.random.RandomState(args.seed)
        lens = [int(lrng.randint(prefix // 2, prefix + 1)) for _ in range(args.num_requests)]
    prompts = [np.asarray(data[i % len(data), :lens[i]], np.int32)
               for i in range(args.num_requests)]
    return engine, prompts


def run(args):
    """Warmup serve, then the timed serve.  Returns {'result': the JSON
    dict, 'outputs': each request's tokens, 'prompts', 'stats': the timed
    serve's ``last_serve_stats``, 'warmup_stats' (None without a warmup),
    'seconds'}."""
    import torch

    from magicdec_tpu_torch.utils.seeding import sampling_rng

    engine, prompts = setup(args)
    # --temperature > 0: the key of --seed, each request's id its salt
    serve_kw = dict(windows_per_sync=args.windows_per_sync,
                    rng=sampling_rng(args, engine.device))
    if args.paged and args.total_pages:
        serve_kw["total_pages"] = args.total_pages

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    warmup_stats = None
    if not args.skip_warmup:
        engine.serve(prompts[:args.slots], B=args.slots, **serve_kw)
        warmup_stats = engine.last_serve_stats
    sync()
    t0 = time.perf_counter()
    outs = engine.serve(prompts, B=args.slots, **serve_kw)
    sync()
    dt = time.perf_counter() - t0
    toks = int(sum(len(o) for o in outs))
    st = engine.last_serve_stats
    print(f"[serving] {args.num_requests} reqs x {args.prefix_len} ctx through "
          f"{args.slots} slots: {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"{args.num_requests / dt:.2f} req/s)", file=sys.stderr)
    print(f"[serving] scheduler: mean queue {st['mean_queue_ms']:.1f}ms, mean service "
          f"{st['mean_service_ms']:.1f}ms ({st['served']} served, "
          f"{st['admission_waves']} admission waves, {st['windows']} windows, "
          f"{st['tokens_per_step']:.3f} tokens/step)", file=sys.stderr)
    if args.paged:
        print(f"[serving] pages: {st['total_pages']} total, min free {st['min_free_pages']}",
              file=sys.stderr)
    if args.printoutput:
        for i, o in enumerate(outs):
            print(f"[serving] request {i}: {o.tolist()}", file=sys.stderr)
    result = {"metric": metric_name(args), "value": round(toks / dt, 2), "unit": "tok/s",
              "vs_baseline": 1.0}
    return {"result": result, "outputs": outs, "prompts": prompts, "stats": st,
            "warmup_stats": warmup_stats, "seconds": dt}


def main(argv=None):
    from magicdec_tpu_torch.parallel.multihost import run_driver

    out = run_driver("magicdec_tpu_torch.serving_bench", parse_args(argv))
    print(json.dumps(out["result"]))
    return out


if __name__ == "__main__":
    main()
