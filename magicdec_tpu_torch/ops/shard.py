"""The per-shard record of tensor parallelism that the model layer carries
(counterpart of magicdec_tpu/ops/shard.py).

The JAX package is one program over a mesh: its ``FlashShard`` wraps each
Pallas kernel in ``shard_map`` so that the kernel sees one shard's batch
rows and whole kv heads.  The port runs one process a rank
(``parallel/multihost.py``), so every rank already holds its shard's local
arrays and its kernels run on them unchanged; what is left of the record is
what the layer loop needs to join the shards:

- ``ModelShard``: the model group of a vocab- and head-split model, as the
  ``"shard"`` entry of its params (``parallel/sharding.shard_params``).
  ``models/llama.py`` sums the row-split wo and w2 products over it, and
  runs the vocab-split head's argmax and full logits row through it;
- the int4 cache's even-local-heads rule (the JAX package's
  ``engine.py:240-248``);
- ``group_table_row``: a paged slot's page-table row in its data group's
  local page ids (the JAX package's ``serving.py:585-590``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from magicdec_tpu_torch.parallel import collectives as C


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShard:
    """One rank's place in a model group of ``size`` ranks (``index`` in it,
    ``group`` its process group) over a model of ``vocab`` columns."""

    size: int
    index: int
    group: Any
    vocab: int

    @property
    def vocab_local(self) -> int:
        return self.vocab // self.size

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial products ``t``, in place."""
        return C.all_reduce(t, "sum", self.group)

    def argmax(self, local_logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens (int32) from this rank's vocab columns; columns past
        ``vocab_local`` are the zero padding of a quantized head
        (``sharding.pad_vocab_columns``) and are dropped first."""
        return C.vocab_argmax(local_logits[..., :self.vocab_local],
                              self.index * self.vocab_local, self.group)

    def full_logits(self, local_logits: torch.Tensor) -> torch.Tensor:
        """The whole vocab row [..., V] on every rank."""
        return C.gather_rows(local_logits[..., :self.vocab_local].contiguous(), self.index,
                             self.size, self.group, dim=-1)


def check_int4_local_heads(cfg, size: int) -> None:
    """An int4 cache packs adjacent kv heads in pairs: every model rank
    needs an even count of them."""
    if (cfg.n_kv_head // size) % 2:
        raise ValueError(
            "kv_quant='int4' packs adjacent kv-head pairs: each model shard needs an even "
            f"local head count, got {cfg.n_kv_head} heads / {size} shards")


def group_table_row(pages: np.ndarray, slot_local: int, scratch: int) -> np.ndarray:
    """A slot's page-table row in its group's local page ids: the group's
    allocator pages ``pages`` (-1 past the slot's) shifted past the
    ``scratch`` per-slot scratch pages, the unused tail pointed at the
    slot's own scratch page ``slot_local`` (never read)."""
    row = pages.copy()
    row[row >= 0] += scratch
    row[row < 0] = slot_local
    return row.astype(np.int32)
