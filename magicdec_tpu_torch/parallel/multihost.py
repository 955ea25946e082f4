"""Process bootstrap, the hybrid mesh and the launcher of the port's
parallel runs (counterpart of magicdec_tpu/parallel/multihost.py).

One process a rank, each on one device, as the reference runs
(``Engine/tp.py:54-64``, torchrun + NCCL): never ranks as threads of one
process, because every Hopper launcher sets its shared-memory attribute
once a process, on the device current at its first call
(``static const ... cudaFuncSetAttribute`` in ``csrc/*_sm90.cu``).

- ``initialize``: ``torch.distributed.init_process_group`` with the rank's
  device made current first: ``cuda:{local_rank % device_count}``, or the
  CPU.  The backend is explicit: NCCL by default on CUDA, gloo on the CPU.
  NCCL refuses two ranks on one device (its first collective fails with
  ``ncclInvalidUsage`` on the H100), so more ranks than devices on a host
  under NCCL raise here, naming ``--dist_backend gloo``; gloo takes CUDA
  tensors in ``all_reduce`` (on the H100 too), so several ranks may share
  one card under it.
- ``make_hybrid_mesh``: data x model with the model axis inside a host
  (``LOCAL_WORLD_SIZE`` ranks): the per-layer all-reduces stay on the
  host's links, only batch work crosses hosts.
- ``launch``: spawns ``world_size`` ranks with ``torch.multiprocessing``
  (spawn), runs a function in each and returns each rank's result; a rank
  that fails makes it raise.  ``run_driver`` is the drivers' entry: it
  spawns ``data x model`` ranks when a run asks for more than one and is
  not already a rank (no ``RANK`` in the environment, as under torchrun);
  rank 0 alone writes to stdout.
"""

from __future__ import annotations

import os
import pickle
import socket
import sys
import tempfile
from typing import Optional

import torch

_STATE = {"device": None, "local_world": 1}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_backend(backend: str, device: str, local_world: int) -> str:
    """The backend for ``local_world`` ranks a host on ``device`` ("cuda"
    or "cpu"): ``backend`` if given, else NCCL on CUDA and gloo on the CPU.
    Raises where NCCL cannot run: CPU tensors, or more ranks than devices."""
    dev = torch.device(device).type
    backend = backend or ("nccl" if dev == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist_backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl":
        if dev != "cuda":
            raise ValueError("the nccl backend takes CUDA tensors only; use --dist_backend gloo "
                             "on the CPU")
        count = torch.cuda.device_count()
        if local_world > count:
            raise ValueError(
                f"{local_world} ranks on {count} CUDA device(s): NCCL refuses two ranks on one "
                "device; pass --dist_backend gloo to share a device between ranks")
    return backend


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device: str = "cuda") -> torch.device:
    """Join the process group (values from torchrun's environment where not
    given) with this rank's device current; returns the device."""
    from magicdec_tpu_torch import resolve_device

    import torch.distributed as dist

    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    dev = resolve_device(device)
    backend = check_backend(backend, dev.type, local_world)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)  # before the first launch and the group's setup
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _STATE.update(device=dev, local_world=local_world)
    return dev


def rank_device() -> torch.device:
    """This rank's device (``initialize``'s)."""
    if _STATE["device"] is None:
        raise RuntimeError("parallel.multihost.initialize has not run in this process")
    return _STATE["device"]


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, local_world=1)


def make_hybrid_mesh(model_axis: int, data_axis: Optional[int] = None):
    """data (across hosts) x model (within a host) over every rank: ranks
    are numbered host by host, so the model-minor layout keeps each model
    group on one host.  Raises when a model axis would span hosts."""
    import torch.distributed as dist

    from magicdec_tpu_torch.parallel import sharding as S

    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks not divisible by model axis {model_axis}")
    data_axis = data_axis or n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(f"mesh {data_axis}x{model_axis} != {n} ranks")
    local = _STATE["local_world"]
    if model_axis > local and local > 1:
        raise ValueError(f"model axis {model_axis} would span hosts ({local} local ranks); "
                         "keep TP within a host and scale batch across hosts")
    return S.make_mesh(data_axis, model_axis)


def _rank_main(rank, world_size, local_world, port, backend, device, out_dir):
    with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank % local_world), LOCAL_WORLD_SIZE=str(local_world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    if rank:
        sys.stdout = open(os.devnull, "w")
    initialize(backend, f"tcp://localhost:{port}", world_size, rank, device)
    try:
        result = fn(*args)
    finally:
        shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn, args=(), world_size: int = 2, *, backend: Optional[str] = None,
           device: str = "cuda", local_world_size: Optional[int] = None) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned ranks (``fn`` importable
    by name); returns the ranks' results in rank order.  ``local_world_size``
    ranks make a host (default all): ``LOCAL_WORLD_SIZE`` as torchrun sets
    it, which ``make_hybrid_mesh`` reads."""
    import torch.multiprocessing as mp

    local = local_world_size or world_size
    check_backend(backend, device, local)
    with tempfile.TemporaryDirectory() as out_dir:
        # the job goes through a file: a spawn's pipe holds 64 KB, and a
        # larger argument would hold each start until its rank had imported
        # torch, one rank after another
        with open(os.path.join(out_dir, "job.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.spawn(_rank_main, args=(world_size, local, free_port(), backend, device, out_dir),
                 nprocs=world_size, join=True)
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _call(module: str, name: str, *args):
    import importlib

    return getattr(importlib.import_module(module), name)(*args)


def mesh_world(args) -> int:
    """The ranks a driver's mesh flags ask for (0 without a mesh)."""
    mo, mi = getattr(args, "model_parallel_outer", 0), getattr(args, "model_parallel_inner", 0)
    model = mo * mi if (mo and mi) else args.model_parallel
    n = args.data_parallel * model
    return n if (n > 1 or getattr(args, "force_mesh", False)) else 0


def run_driver(module: str, args, name: str = "run"):
    """A driver's ``run(args)`` under its mesh flags: in this process
    without a mesh, or inside a rank already (a launch, torchrun), or for a
    one-rank mesh (``--force_mesh``); else in ``data x model`` spawned
    ranks, returning rank 0's result."""
    import torch.distributed as dist

    world = mesh_world(args)
    if not world or dist.is_initialized():
        return _call(module, name, args)
    if world == 1 or "RANK" in os.environ:
        # under torchrun its environment says the rest; else one rank here
        kw = ({} if "RANK" in os.environ else
              dict(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0))
        initialize(args.dist_backend, device=args.device, **kw)
        try:
            return _call(module, name, args)
        finally:
            shutdown()
    return launch(_call, (module, name, args), world, backend=args.dist_backend,
                  device=args.device)[0]


def build_mesh(args):
    """The mesh of a driver's flags (None without one), inside a rank."""
    from magicdec_tpu_torch.parallel import sharding as S

    if not mesh_world(args):
        return None
    mo, mi = getattr(args, "model_parallel_outer", 0), getattr(args, "model_parallel_inner", 0)
    if mo and mi:
        return S.make_submesh_mesh(args.data_parallel, mo, mi)
    return S.make_mesh(args.data_parallel, args.model_parallel)
