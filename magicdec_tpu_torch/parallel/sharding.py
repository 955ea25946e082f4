"""Tensor- and data-parallel meshes over ``torch.distributed`` ranks
(counterpart of magicdec_tpu/parallel/sharding.py).

The JAX package is one program over a ``jax.sharding.Mesh``: XLA splits
its arrays by PartitionSpecs and inserts the collectives.  The port is the
reference's own design (``Engine/tp.py:54-64``): one process a rank
(``parallel/multihost.py``), each holding its shard of every array and
calling the collectives itself (``parallel/collectives.py``).  A ``Mesh``
is one rank's view of the grid of ranks: its coordinates and, for each
axis line it takes part in, the process group of the ranks that share its
other coordinates.

Axes:
  data  -- the batch: each data coordinate holds B / data requests (its
           caches, tokens and lengths), and under paged serving its own
           share of the pool's pages (``engine/serving.py``);
  model -- heads: wq / wk / wv / w1 / w3 and the biases split by columns,
           wo / w2 by rows (their products summed over the model group
           before the residual, ``models/llama.py``), the lm_head by vocab
           columns; the embedding, the norms and a tied head (llama-3.2-1b,
           ``lm_head`` None) are whole on every rank.  Each rank's caches
           hold its whole kv heads.
  (data, mo, mi) -- the standalone draft's sub-mesh: the target splits over
           mo x mi, the draft over mi alone (the reference's
           ``--draft_rank_group``).

A rank holds its shard's arrays as plain tensors and its config's local
head counts (``local_config``), so every kernel runs on its local shapes
unchanged.  ``shard_params`` slices them from the full tree, and quantized
leaves by the JAX package's ``quant_param_pspecs`` rules: a column-split
weight splits ``q`` and its scale columns, a row-split one ``q``'s rows and,
with group-wise scales (G > 1), their group axis (else the scales are
whole).  A non-divisible kv-head count is padded first
(``pad_heads_for_tp``: zero heads, exactly +0.0 in every output).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.config import ModelConfig
from magicdec_tpu_torch.ops.shard import ModelShard

VOCAB_PAD = 256  # a quantized head's local columns pad to this (B6's routing: Out % 256)


class Mesh:
    """One rank's view of a grid of ranks ``grid`` (an int array shaped by
    the axes ``axis_names``): its coordinates, its device and the process
    group of each axis line it lies on (``group(axes)``)."""

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str], rank: int, device,
                 groups: Dict[Tuple[str, ...], object]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.rank = rank
        pos = np.argwhere(grid == rank)[0]
        self.coords = dict(zip(self.axis_names, (int(p) for p in pos)))
        self.device = torch.device(device)
        self._groups = groups

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes``."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's coordinates
        off ``axes``."""
        return self._groups[tuple(axes)]

    @property
    def data(self) -> int:
        return self.shape.get("data", 1)

    def data_rows(self, B: int) -> Tuple[int, int]:
        """[lo, hi) of the batch rows this rank's data coordinate holds."""
        if B % self.data:
            raise ValueError(f"batch {B} does not divide over data={self.data}")
        n = B // self.data
        return self.coords["data"] * n, (self.coords["data"] + 1) * n

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, {self.device})"


def _line_axes(names: Tuple[str, ...]):
    """The axis sets whose lines get a process group."""
    if "model" in names:
        return [("model",), ("data",)]
    return [("mo", "mi"), ("mi",), ("data",)]


def _build(shape: Sequence[int], names: Sequence[str], ranks=None) -> Optional[Mesh]:
    import torch.distributed as dist

    from magicdec_tpu_torch.parallel import multihost

    if not dist.is_initialized():
        raise RuntimeError("a Mesh needs torch.distributed: call parallel.multihost.initialize "
                           "first (the drivers' launcher does)")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = math.prod(shape)
    if len(ranks) < n:
        raise ValueError(f"need {n} ranks, have {len(ranks)}")
    grid = np.asarray(ranks[:n]).reshape(shape)
    names = tuple(names)
    me = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order (new_group's contract)
    for axes in _line_axes(names):
        ax = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in ax]
        lines = grid.transpose(other + ax).reshape(-1, math.prod(grid.shape[i] for i in ax))
        groups[axes] = None
        for line in lines:
            g = dist.new_group(ranks=[int(r) for r in line])
            if me in line:
                groups[axes] = g
    if me not in grid:
        return None
    return Mesh(grid, names, me, multihost.rank_device(), groups)


def make_mesh(data: int = 1, model: int = 1, ranks=None) -> Optional[Mesh]:
    """A (data, model) mesh over ``ranks`` (default every rank, in order;
    the first data * model of them): model minor, as the JAX package
    reshapes its devices.  Every rank must call it; a rank outside the
    mesh gets None."""
    return _build((data, model), ("data", "model"), ranks)


def make_submesh_mesh(data: int, model_outer: int, model_inner: int, ranks=None):
    """The draft sub-mesh (data, mo, mi): the target tensor-parallel over
    mo x mi, the standalone draft over mi alone, replicated over mo, so its
    per-layer collectives span model_inner ranks."""
    return _build((data, model_outer, model_inner), ("data", "mo", "mi"), ranks)


def model_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """The axes acting as 'model' for the target."""
    return ("model",) if "model" in mesh.axis_names else ("mo", "mi")


def draft_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """The axes acting as 'model' for a standalone draft."""
    return ("model",) if "model" in mesh.axis_names else ("mi",)


def validate_mesh(cfg: ModelConfig, mesh: Mesh, axes=None) -> None:
    axes = axes or model_axes_of(mesh)
    model = mesh.size(axes)
    if cfg.n_kv_head % model:
        raise ValueError(f"n_kv_head={cfg.n_kv_head} not divisible by model axis {model}; "
                         "engines pad automatically (pad_heads_for_tp), direct callers "
                         "should pad first")
    if cfg.vocab_size % model:
        raise ValueError("vocab not divisible by model axis")


def local_config(cfg: ModelConfig, size: int) -> ModelConfig:
    """The config one of ``size`` model ranks runs: its local head counts,
    the model's head dim."""
    if size == 1:
        return cfg
    return dataclasses.replace(cfg, n_head=cfg.n_head // size,
                               n_kv_head=cfg.n_kv_head // size)


# -- the split rules (the JAX package's param_pspecs / quant_param_pspecs) --

def _sections(key: str, cfg: ModelConfig):
    """The output-column sections of a column-split leaf (each split alone:
    a fused leaf is the concatenation of its parts' local columns)."""
    hd = cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_kv_head * hd
    return {"wq": (nq,), "bq": (nq,), "wk": (nkv,), "wv": (nkv,), "bk": (nkv,), "bv": (nkv,),
            "wqkv": (nq, nkv, nkv), "bqkv": (nq, nkv, nkv), "w1": (cfg.intermediate_size,),
            "w3": (cfg.intermediate_size,),
            "w13": (cfg.intermediate_size, cfg.intermediate_size)}.get(key)


_ROW_KEYS = ("wo", "w2")


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that keeps no view of the full tensor alive."""
    return t.clone(memory_format=torch.contiguous_format)


def _split_cols(t: torch.Tensor, sections, size: int, index: int) -> torch.Tensor:
    parts, lo = [], 0
    for n in sections:
        if n % size:
            raise ValueError(f"{n} columns do not split over {size} model ranks")
        k = n // size
        parts.append(t[..., lo + index * k:lo + (index + 1) * k])
        lo += n
    return _own(parts[0]) if len(parts) == 1 else torch.cat(parts, dim=-1)


def _split_rows(t: torch.Tensor, size: int, index: int) -> torch.Tensor:
    n = t.shape[-2]
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} model ranks")
    k = n // size
    return _own(t[..., index * k:(index + 1) * k, :])


def shard_leaf(w, key: str, cfg: ModelConfig, size: int, index: int):
    """This rank's shard of layer leaf ``key`` (dense or quantized)."""
    if w is None or size == 1:
        return w
    sections = _sections(key, cfg)
    if Q.is_quantized(w):
        if sections is not None:
            return Q.QuantizedWeight(_split_cols(w.q, sections, size, index),
                                     _split_cols(w.scale, sections, size, index),
                                     w.bits, w.group_size)
        if key in _ROW_KEYS:
            G = w.scale.shape[-2]
            scale = _split_rows(w.scale, size, index) if G > 1 else w.scale
            return Q.QuantizedWeight(_split_rows(w.q, size, index), scale, w.bits, w.group_size)
        return w
    if sections is not None:
        return _split_cols(w, sections, size, index)
    if key in _ROW_KEYS:
        return _split_rows(w, size, index)
    return w  # the norms


def pad_vocab_columns(w: Q.QuantizedWeight, multiple: int = VOCAB_PAD) -> Q.QuantizedWeight:
    """A quantized head shard's columns padded with zero ``q`` and zero
    scales to a multiple of ``multiple``, so that B6 (and B6-int4) take it
    (their routing needs Out % 256 == 0: llama-3's 128,256 columns give
    64,128 at TP 2 and 32,064 at TP 4, neither a multiple).  The padded
    logits are exactly 0 and ``ModelShard`` drops them before any use."""
    pad = -w.q.shape[-1] % multiple
    if not pad:
        return w
    return Q.QuantizedWeight(F.pad(w.q, (0, pad)), F.pad(w.scale, (0, pad)), w.bits,
                             w.group_size)


def shard_head(head, size: int, index: int):
    """This rank's vocab columns of an lm_head [D, V] (a quantized one
    padded by ``pad_vocab_columns``)."""
    if head is None:
        return None
    V = head.q.shape[-1] if Q.is_quantized(head) else head.shape[-1]
    if Q.is_quantized(head):
        return pad_vocab_columns(Q.QuantizedWeight(
            _split_cols(head.q, (V,), size, index), _split_cols(head.scale, (V,), size, index),
            head.bits, head.group_size))
    return _split_cols(head, (V,), size, index)


def shard_params(params, cfg: ModelConfig, mesh: Mesh, axes=None):
    """This rank's shard of a (padded) params tree, dense or quantized
    leaves, fused (wqkv, w13) or not; with more than one model rank it
    carries the ``"shard"`` record the model layer joins the shards by.
    The embedding, the norms and a tied head stay whole (shared with
    ``params``); every split leaf is a copy, so ``params`` can be freed."""
    axes = axes or model_axes_of(mesh)
    size, index = mesh.size(axes), mesh.index(axes)
    if size == 1:
        return params
    layers = {k: shard_leaf(w, k, cfg, size, index) for k, w in params["layers"].items()}
    out = dict(params, layers=layers, lm_head=shard_head(params.get("lm_head"), size, index))
    out["shard"] = ModelShard(size, index, mesh.group(axes), cfg.vocab_size)
    return out


def quantize_sharded(params, cfg: ModelConfig, mesh: Mesh, axes=None, *, local=None,
                     device=None, bits: int = 8, include_head: bool = True,
                     materialize_tied_head: bool = False):
    """``shard_params(quantization.quantize_params(params, ...))`` (the JAX
    package's quantize-then-``shard_quant_params`` order: a row-split int8
    weight keeps the scales of its whole columns), one leaf at a time, so
    the full quantized tree never exists.  ``local``: this rank's shard of
    ``params`` (``shard_params``), whose embedding, norms and unquantized
    head the copy shares, as ``quantize_params`` shares them.  ``device``:
    where each whole leaf is quantized (default where it lies)."""
    axes = axes or model_axes_of(mesh)
    size, index = mesh.size(axes), mesh.index(axes)
    local = local if local is not None else shard_params(params, cfg, mesh, axes)
    on = (lambda t: t) if device is None else (lambda t: None if t is None else t.to(device))
    layers = dict(local["layers"])
    for k, w in params["layers"].items():
        if k in Q.QUANT_KEYS and w is not None and not Q.is_quantized(w):
            qw = Q.quantize_params({"layers": {k: on(w)}}, bits=bits, include_head=False)
            layers[k] = shard_leaf(qw["layers"][k], k, cfg, size, index)
            del qw
    out = dict(local, layers=layers)
    if include_head:
        # the embedding is whole on every rank: local's (already on the device)
        q = Q.quantize_params({"layers": {}, "embed": local.get("embed"),
                               "lm_head": on(params.get("lm_head"))}, bits=bits,
                              include_head=True, materialize_tied_head=materialize_tied_head)
        if Q.is_quantized(q.get("lm_head")) and not Q.is_quantized(params.get("lm_head")):
            out["lm_head"] = shard_head(q["lm_head"], size, index) if size > 1 else q["lm_head"]
    return out


def unfuse_params(params, cfg: ModelConfig):
    """The inverse of ``models.llama.fuse_exec_params``: wqkv -> wq | wk |
    wv, bqkv -> bq | bk | bv and w13 -> w1 | w3 (views of their columns)."""
    L = dict(params["layers"])
    if "wqkv" not in L and "w13" not in L:
        return params

    def cut(w, sections):
        if w is None:
            return [None] * len(sections)
        bounds = np.cumsum((0,) + tuple(sections))
        if Q.is_quantized(w):
            return [Q.QuantizedWeight(w.q[..., a:b], w.scale[..., a:b], w.bits, w.group_size)
                    for a, b in zip(bounds[:-1], bounds[1:])]
        return [w[..., a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    L["wq"], L["wk"], L["wv"] = cut(L.pop("wqkv"), _sections("wqkv", cfg))
    bq = L.pop("bqkv", None)
    if bq is not None:
        L["bq"], L["bk"], L["bv"] = cut(bq, _sections("bqkv", cfg))
    L["w1"], L["w3"] = cut(L.pop("w13"), _sections("w13", cfg))
    return dict(params, layers=L)


def pad_heads_for_tp(params, cfg: ModelConfig, mesh: Mesh, axes=None):
    """Pad kv heads (and their q-head groups) to the model axis: zero kv
    heads (k = v = 0, so their attention output is exactly 0), zero q-head
    groups and zero wo rows, each contributing exactly +0.0 to every real
    output, so one device's outputs are kept (the JAX package's
    ``pad_heads_for_tp``; the reference round-robins uneven head sets
    instead, ``Engine/tp.py:36-52``).  GQA groups stay contiguous per kv
    head, so end-padding keeps the real heads' grouping.  Returns (params,
    cfg) unchanged when already divisible.  Quantized leaves: dense and
    int8 per-channel only (quantize after padding for int4 or group-wise);
    params must be unfused (``unfuse_params``)."""
    axes = axes or model_axes_of(mesh)
    model = mesh.size(axes)
    if cfg.n_kv_head % model == 0:
        return params, cfg
    hkv2 = -(-cfg.n_kv_head // model) * model
    hq2 = hkv2 * cfg.gqa_groups
    hd = cfg.head_dim

    def pad_axis(w, axis, new):
        if w is None:
            return None
        if Q.is_quantized(w):
            if w.bits != 8 or w.scale.shape[-2] != 1:
                raise NotImplementedError("pad_heads_for_tp supports dense and int8 per-channel "
                                          "weights; quantize after padding for int4/group-wise")
            ndim = w.q.dim()
            ax = axis % ndim
            qpad = [0, 0] * ndim
            qpad[2 * (ndim - 1 - ax) + 1] = new - w.q.shape[ax]
            scale = w.scale
            if ax == ndim - 1:  # the output axis: the scale columns pad too
                scale = F.pad(scale, (0, new - scale.shape[-1]))
            return Q.QuantizedWeight(F.pad(w.q, qpad), scale, w.bits, w.group_size)
        ndim = w.dim()
        ax = axis % ndim
        pad = [0, 0] * ndim
        pad[2 * (ndim - 1 - ax) + 1] = new - w.shape[ax]
        return F.pad(w, pad)

    L = dict(params["layers"])
    assert "wqkv" not in L and "w13" not in L, "pad before fuse_exec_params"
    L["wq"] = pad_axis(L["wq"], -1, hq2 * hd)
    L["wk"] = pad_axis(L["wk"], -1, hkv2 * hd)
    L["wv"] = pad_axis(L["wv"], -1, hkv2 * hd)
    L["wo"] = pad_axis(L["wo"], -2, hq2 * hd)
    for b, n in (("bq", hq2), ("bk", hkv2), ("bv", hkv2)):
        if L.get(b) is not None:
            L[b] = pad_axis(L[b], -1, n * hd)
    return dict(params, layers=L), dataclasses.replace(cfg, n_head=hq2, n_kv_head=hkv2)
