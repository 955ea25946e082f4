"""Decode state of the engines (counterpart of magicdec_tpu/engine/state.py).

Plain dataclasses of tensors.  The caches inside are updated in place by the
model passes; the other fields are replaced each window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class SpecState:
    """Self-speculation state: target cache + StreamingLLM draft cache."""

    k: torch.Tensor              # target KV cache [L, B, S, Hkv*hd]
    v: torch.Tensor
    target_lens: torch.Tensor    # [B] visible target length
    dk: torch.Tensor             # draft cache [L, B, Sd, Hkv*hd]
    dv: torch.Tensor
    draft_fill: torch.Tensor     # [B] draft append slot and causal base
    draft_pos: torch.Tensor      # [B] rope position of the next draft token
    token0: torch.Tensor         # [B] next window's committed slot-0 token
    output: torch.Tensor         # [B, cap] generated tokens
    num_committed: torch.Tensor  # [B] tokens written into output
    target_steps: torch.Tensor   # scalar int32: verify calls so far
    done: torch.Tensor           # scalar bool (batch-global, like the reference)
    db_tokens: torch.Tensor      # [B, 2] StreamingLLM double-buffer tokens
    db_update: torch.Tensor      # [B] in {1, 2}
    # int8 target-cache scales [L, B, Hkv, S] (EngineConfig.kv_quant; None
    # for a bf16 cache), the ops.kv_cache.quantize_kv_tokens layout
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    # Gumbel-coupled sampling (EngineConfig.temperature > 0; None when
    # greedy): rng the stream key (ops/prng.py, int64 [2]), salt [B] int32
    # the per-request noise-stream identity (ops/sampling.py coupled_gumbel)
    rng: Optional[torch.Tensor] = None
    salt: Optional[torch.Tensor] = None
    # Paged serving (engine/serving.PagedServingEngine): k/v (+ks/vs) are page
    # POOLS [L, P, ps, Kc] (+ [L, P, Hkv, ps]) shared by the slots, and table
    # [B, npr] int32 maps a slot's logical pages to pool pages.  None:
    # contiguous caches.
    table: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ServingState:
    """Continuous-batching state (engine/serving.py)."""

    spec: SpecState
    active: torch.Tensor         # [B] bool: the slot holds a live request
    done: torch.Tensor           # [B] bool: its request finished, awaiting drain


@dataclasses.dataclass
class BaselineState:
    """Autoregressive decode state (one full cache)."""

    k: torch.Tensor
    v: torch.Tensor
    lens: torch.Tensor
    token0: torch.Tensor
    output: torch.Tensor
    num_committed: torch.Tensor
    ks: Optional[torch.Tensor] = None  # int8-cache scales, as in SpecState
    vs: Optional[torch.Tensor] = None
    rng: Optional[torch.Tensor] = None   # sampling key and salt, as in SpecState
    salt: Optional[torch.Tensor] = None
