"""The rank side of the port's mesh tests (tests/test_torch_sharding.py,
test_torch_sharding_quant.py, test_torch_serving_mesh.py,
test_torch_multihost.py): every case of a test module runs inside one
spawn of gloo ranks on the CPU, and the module's tests are parametrized
over the results.

    python tests/torch_mesh_cases.py IN.pkl OUT.pkl

IN holds {"world", "local_world", "weights": {name: numpy tree}, "cases":
[(name, spec), ...]}; OUT gets {name: rank 0's result, or {"error": ...}},
each result with "ranks_agree": whether every rank of the case's mesh
returned the same.  Imports torch and the port only (no JAX): the test
modules hold the results against the JAX package in their own process.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magicdec_tpu_torch.config import tiny_config  # noqa: E402
from magicdec_tpu_torch.convert import params_from_jax  # noqa: E402


def prompt(B, prefix, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, prefix)).astype(np.int32)


def prompts(lens, seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def _ecfg(kw):
    from magicdec_tpu_torch.engine.engine import EngineConfig

    base = dict(mode="streamingllm", gamma=3, draft_budget=33, max_seq_len=256, chunk_size=16,
                window_size=8, sink_size=4, max_gen=8, eot_ids=(-1,),
                cache_dtype=torch.float32)
    base.update(kw)
    return EngineConfig(**base)


def _mesh(spec):
    """(mesh or None for a rank outside it)."""
    from magicdec_tpu_torch.parallel import multihost as MH
    from magicdec_tpu_torch.parallel import sharding as S

    kind, *dims = spec
    if kind == "mesh":
        return S.make_mesh(*dims, ranks=range(dims[0] * dims[1]))
    if kind == "sub":
        return S.make_submesh_mesh(*dims, ranks=range(int(np.prod(dims))))
    if kind == "hybrid":
        return MH.make_hybrid_mesh(*dims)
    raise ValueError(kind)


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else t


def case_engine(spec, weights):
    """A SpecEngine / LongSpecEngine on a mesh: the spec run and/or the
    baseline, as numpy."""
    from magicdec_tpu_torch.engine.engine import LongSpecEngine, SpecEngine
    from magicdec_tpu_torch.ops.prng import PRNGKey

    mesh = _mesh(spec["mesh"])
    if mesh is None:
        return None
    cfg = tiny_config(**spec["cfg"])
    params = params_from_jax(weights[spec["weights"]])
    ecfg = _ecfg(spec.get("ecfg", {}))
    if "draft" in spec:
        dcfg = tiny_config(**spec["draft_cfg"])
        eng = LongSpecEngine(params, cfg, params_from_jax(weights[spec["draft"]]), dcfg, ecfg,
                             device="cpu", mesh=mesh)
    else:
        eng = SpecEngine(params, cfg, ecfg, device="cpu", mesh=mesh)
    p = prompt(*spec["prompt"])
    rng = None if spec.get("rng") is None else PRNGKey(spec["rng"])
    out = {"local_cfg": (eng.cfg.n_head, eng.cfg.n_kv_head, eng.cfg.head_dim),
           "draft_cfg": (eng.draft_cfg.n_head, eng.draft_cfg.n_kv_head)}
    if spec.get("spec", True):
        st = eng.encode(p, rng=rng)
        out["state_shapes"] = {n: tuple(getattr(st, n).shape) for n in ("k", "ks", "dk")
                               if getattr(st, n) is not None}
        _, stats = eng.generate(st)
        out.update(output=_np(stats["output"]), num_committed=_np(stats["num_committed"]))
        wq = eng.draft_params["layers"]["wqkv"]
        out["draft_wqkv"] = (type(wq).__name__, tuple(getattr(wq, "q", wq).shape))
    if spec.get("baseline"):
        _, b = eng.generate_baseline(eng.encode_baseline(p, rng=rng), max_new=spec["baseline"])
        out["base_output"] = _np(b["output"])
    return out


def case_prefill_logits(spec, weights):
    """One target prefill pass's logits [B, T, V] on a TP mesh."""
    from magicdec_tpu_torch.engine.engine import SpecEngine
    from magicdec_tpu_torch.models import llama as M

    mesh = _mesh(spec["mesh"])
    if mesh is None:
        return None
    cfg = tiny_config(**spec["cfg"])
    eng = SpecEngine(params_from_jax(weights[spec["weights"]]), cfg, _ecfg({}), device="cpu",
                     mesh=mesh)
    B, T, seed = spec["prompt"]
    caches = eng._zero_target_caches(B)
    logits, _ = M.forward_target(eng.params, eng.cfg, torch.as_tensor(prompt(B, T, seed)),
                                 torch.zeros((B,), dtype=torch.int32), caches, head="logits")
    return {"logits": _np(logits)}


def case_mesh_checks(spec, weights):
    """Mesh construction and validation, and the split of every leaf."""
    from magicdec_tpu_torch.parallel import sharding as S

    mesh = S.make_mesh(2, 4)
    cfg = tiny_config(**spec["cfg"])
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    S.validate_mesh(cfg, mesh)
    try:
        S.validate_mesh(tiny_config(n_head=6, n_kv_head=3, dim=48), mesh)
        out["bad_rejected"] = False
    except ValueError:
        out["bad_rejected"] = True
    local = S.shard_params(params_from_jax(weights[spec["weights"]]), cfg, mesh)
    out["leaves"] = {k: (None if w is None else tuple(w.shape))
                     for k, w in local["layers"].items()}
    out["lm_head"] = tuple(local["lm_head"].shape)
    out["shard"] = (local["shard"].size, local["shard"].index)
    return out


def case_int4_odd_heads(spec, weights):
    """4 kv heads over 4 model ranks: one local head, which int4 packing
    cannot pair; the engine refuses."""
    from magicdec_tpu_torch.engine.engine import SpecEngine

    mesh = _mesh(spec["mesh"])
    if mesh is None:
        return None
    try:
        SpecEngine(params_from_jax(weights[spec["weights"]]), tiny_config(**spec["cfg"]),
                   _ecfg({"kv_quant": "int4"}), device="cpu", mesh=mesh)
    except ValueError as e:
        return {"raised": "int4" in str(e)}
    return {"raised": False}


def case_hybrid_checks(spec, weights):
    """make_hybrid_mesh's shape, and a model axis across hosts refused."""
    from magicdec_tpu_torch.parallel import multihost as MH

    mesh = MH.make_hybrid_mesh(*spec["ok"])
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    try:
        MH.make_hybrid_mesh(*spec["bad"])
        out["bad_rejected"] = False
    except ValueError:
        out["bad_rejected"] = True
    return out


def case_serve(spec, weights):
    """A serving engine's serve on a mesh: outputs and stats."""
    from magicdec_tpu_torch.engine import serving as SV

    mesh = _mesh(spec["mesh"])
    if mesh is None:
        return None
    cls = SV.PagedServingEngine if spec["paged"] else SV.ServingEngine
    eng = cls(params_from_jax(weights[spec["weights"]]), tiny_config(**spec["cfg"]),
              _ecfg(spec["ecfg"]), device="cpu", mesh=mesh)
    kw = {k: spec[k] for k in ("total_pages",) if k in spec}
    try:
        outs = eng.serve(prompts(*spec["prompts"]), B=spec["B"],
                         windows_per_sync=spec.get("windows_per_sync", 2), **kw)
    except ValueError as e:
        return {"value_error": str(e)}
    st = dict(eng.last_serve_stats)
    return {"outputs": outs, "stats": st}


def case_driver(spec, weights):
    """A driver's ``run`` under its mesh flags inside the ranks (the mesh
    spans every rank), config names mapped to tiny configs: per run, the
    outputs of its batches (``batches`` / ``spec`` / ``base``) or serve."""
    import importlib

    from magicdec_tpu_torch import config as tcfg

    configs = spec["configs"]
    from_name = tcfg.ModelConfig.from_name
    tcfg.ModelConfig.from_name = classmethod(lambda cls, name: tiny_config(**configs[name]))
    try:
        out = {}
        for tag, (module, argv) in spec["runs"].items():
            mod = importlib.import_module(f"magicdec_tpu_torch.{module}")
            res = mod.run(mod.parse_args(argv))
            if "outputs" in res:
                out[tag] = {"outputs": res["outputs"]}
            else:
                out[tag] = {k: [(r["output"], r["num_committed"]) for r in res[k]]
                            for k in ("batches", "spec", "base") if k in res}
        return out
    finally:
        tcfg.ModelConfig.from_name = from_name


KINDS = {"engine": case_engine, "prefill_logits": case_prefill_logits,
         "mesh_checks": case_mesh_checks, "int4_odd_heads": case_int4_odd_heads,
         "hybrid_checks": case_hybrid_checks, "serve": case_serve, "driver": case_driver}


def run_cases(cases, weights):
    torch.set_num_threads(1)
    out = {}
    import time

    for name, spec in cases:
        t0 = time.perf_counter()
        try:
            out[name] = KINDS[spec["kind"]](spec, weights)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        print(f"[case] {name}: {time.perf_counter() - t0:.2f} s at {time.time():.2f}",
              file=sys.stderr, flush=True)
    return out


def _same(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a
                                            if k not in ("coords", "stats", "state_shapes", "shard"))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def failing_rank(bad_rank):
    """Raises on rank ``bad_rank`` only (the launcher's failure test)."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails")
    return dist.get_rank()


class Spawn:
    """The cases of a test module in ``world`` gloo ranks, started in a
    process of their own (its own session, so that a stuck rank dies with
    it) while the caller computes its references; ``result()`` waits.  The
    ranks run at a lower priority (nice 10): beside the other test files of
    a parallel run they take the cycles those leave."""

    def __init__(self, cases, weights, world, local_world=None, timeout=300):
        import subprocess
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="torch_mesh_")
        self.src, self.dst = (os.path.join(self.dir, n) for n in ("in.pkl", "out.pkl"))
        with open(self.src, "wb") as f:
            pickle.dump({"world": world, "local_world": local_world, "cases": cases,
                         "weights": weights}, f)
        self.log = open(os.path.join(self.dir, "log.txt"), "w+")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), self.src,
                                      self.dst], stdout=self.log, stderr=subprocess.STDOUT,
                                     env=env, start_new_session=True,
                                     preexec_fn=lambda: os.nice(10))
        self.timeout = timeout
        self._result = None

    def result(self):
        import shutil
        import signal
        import subprocess

        if self._result is None:
            try:
                rc = self.proc.wait(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()
                rc = "timeout"
            self.log.seek(0)
            log = self.log.read()
            self.log.close()
            if rc != 0:
                shutil.rmtree(self.dir, ignore_errors=True)
                raise RuntimeError(f"the ranks failed ({rc}):\n{log[-6000:]}")
            with open(self.dst, "rb") as f:
                self._result = pickle.load(f)
            shutil.rmtree(self.dir, ignore_errors=True)
        return self._result


def main(src, dst):
    import time

    from magicdec_tpu_torch.parallel import multihost as MH

    print(f"[main] start {time.time():.2f}", file=sys.stderr, flush=True)
    with open(src, "rb") as f:
        job = pickle.load(f)
    per_rank = MH.launch(run_cases, (job["cases"], job["weights"]), job["world"],
                         device="cpu", local_world_size=job.get("local_world"))
    results = {}
    for name, _ in job["cases"]:
        got = [r[name] for r in per_rank if r[name] is not None]
        res = dict(got[0])
        res["ranks_agree"] = all(_same(got[0], g) for g in got[1:])
        results[name] = res
    with open(dst, "wb") as f:
        pickle.dump(results, f)
    print(f"[main] end {time.time():.2f}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
