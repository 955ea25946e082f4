"""The collectives of tensor and data parallelism, each built on
``torch.distributed.all_reduce`` (sum, max or min) alone, the operation
that both of the port's backends take on CUDA and CPU tensors (gloo and
NCCL; ``broadcast`` is not needed).

- ``all_reduce``: the transport every other function goes through, in
  place; a ``None`` group (a model axis of one rank) does nothing.
- ``gather_rows``: an all-gather of equal row blocks as the sum of
  zero-filled buffers, each rank's block written at its offset: x + 0 == x,
  so the result is exact in every dtype.
- ``vocab_argmax``: the greedy head over a vocab-split lm_head by two
  all-reduces (the reference's ``Engine/SnapKV/model.py:178-188``): the MAX
  of the local maxima, then the MIN of the global index among the ranks
  that hold that maximum, so ties go to the lowest global index, as
  ``torch.argmax`` breaks them on one device.
- a head that needs the whole logits row (sampling: top-p reads the whole
  row, and S1 then runs unchanged; ``head="logits"``) gathers it by
  ``gather_rows`` over the vocab axis (``ops.shard.ModelShard``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (and returned); the identity
    when ``group`` is None."""
    if group is None:
        return t
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def gather_rows(local: torch.Tensor, index: int, size: int, group, dim: int = 0) -> torch.Tensor:
    """The ``size`` ranks' equal blocks along ``dim`` concatenated in rank
    order, on every rank: this rank's ``local`` block is block ``index``."""
    if group is None:
        return local
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.narrow(dim, index * n, n).copy_(local)
    return all_reduce(full, "sum", group)


def vocab_argmax(local_logits: torch.Tensor, offset: int, group) -> torch.Tensor:
    """int32 argmax over a vocab-split row: ``local_logits`` [..., V_local]
    holds global columns [offset, offset + V_local)."""
    idx = torch.argmax(local_logits, dim=-1)
    if group is None:
        return idx.to(torch.int32)
    val = local_logits.float().amax(dim=-1)
    gmax = all_reduce(val.clone(), "max", group)
    big = torch.iinfo(torch.int32).max
    cand = torch.where(val == gmax, idx.to(torch.int32) + offset,
                       torch.full_like(idx, big, dtype=torch.int32))
    return all_reduce(cand, "min", group)
