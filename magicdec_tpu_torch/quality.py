"""Model quality: teacher-forced perplexity (counterpart of
magicdec_tpu/quality.py), the gate that holds a converted checkpoint and its
int8 / int4 dump, or a quantized KV cache, to the float model.

Windows [N, S] are evaluated independently, ``batch_size`` at a time, each
as chunks of ``chunk_size`` tokens through ``models.llama.forward_target``
with the cache carried from chunk to chunk (on the card the chunks run the
prefill kernels: K2 over a bf16 cache, K2q / B11 under ``kv_quant``), a
float32 log-softmax over the logits, and the last position of each window
masked (it has no next token).  Rows that do not fill a batch are dropped,
like the reference's ``drop_last=True`` loader.  One scalar is read back a
batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from magicdec_tpu_torch import resolve_device
from magicdec_tpu_torch.config import ModelConfig
from magicdec_tpu_torch.engine.engine import _to_device, kv_quant_bits
from magicdec_tpu_torch.models import llama as M


def _zero_caches(cfg: ModelConfig, B: int, S: int, cache_dtype, kv_quant, device):
    """The target cache of ``perplexity``'s windows: ``cache_dtype``, or
    int8 (int4 packed in kv-head pairs) with zero f32 scales."""
    bits = kv_quant_bits(kv_quant)
    lanes = cfg.n_kv_head * cfg.head_dim
    shape = (cfg.n_layer, B, S, lanes // 2 if bits == 4 else lanes)
    caches = {n: torch.zeros(shape, dtype=torch.int8 if bits else cache_dtype, device=device)
              for n in "kv"}
    if bits:
        caches.update({n: torch.zeros((cfg.n_layer, B, cfg.n_kv_head, S),
                                      dtype=torch.float32, device=device)
                       for n in ("ks", "vs")})
    return caches


def _window_nll(params, cfg: ModelConfig, tokens: torch.Tensor, C: int, cache_dtype,
                kv_quant) -> torch.Tensor:
    """Total NLL (float32, on the device) of tokens [B, S], chunked by C."""
    B, S = tokens.shape
    dev = tokens.device
    caches = _zero_caches(cfg, B, S, cache_dtype, kv_quant, dev)
    # the target of position p is tokens[p + 1]; the last position has none
    tgt = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype, device=dev)], 1)
    lens = torch.zeros((B,), dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    cols = torch.arange(C, dtype=torch.int32, device=dev)
    for i in range(0, S, C):
        logits, caches = M.forward_target(params, cfg, tokens[:, i:i + C], lens, caches,
                                          head="logits")
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(lp, -1, tgt[:, i:i + C, None].long())[..., 0]
        pos = lens[:, None] + cols[None]
        total = total + torch.where(pos < S - 1, nll, torch.zeros_like(nll)).sum()
        lens = lens + C
    return total


@torch.no_grad()
def perplexity(params, cfg: ModelConfig, data, *, batch_size: int = 8,
               chunk_size: int = 512, cache_dtype=torch.bfloat16, kv_quant=False,
               device="cuda") -> Tuple[float, float]:
    """Teacher-forced perplexity over ``data`` [N, S] token windows; returns
    (ppl, nll per token).  ``kv_quant`` (False / True / 'int8' / 'int4',
    ``EngineConfig.kv_quant``) evaluates with the quantized KV cache.
    ``params`` are moved to ``device`` (a quantized tree as it is)."""
    dev = resolve_device(device)
    data = np.asarray(data)
    N, S = data.shape
    if not (S % chunk_size == 0 or S < chunk_size):
        raise ValueError(f"seq_len {S} must be a multiple of chunk_size {chunk_size}")
    C = min(chunk_size, S)
    params = _to_device(params, dev)
    total, count = 0.0, 0
    for i in range(0, N - batch_size + 1, batch_size):
        batch = torch.as_tensor(data[i:i + batch_size], dtype=torch.int32).to(dev)
        total += float(_window_nll(params, cfg, batch, C, cache_dtype, kv_quant))
        count += batch_size * (S - 1)
    if count == 0:
        raise ValueError(f"need at least batch_size={batch_size} rows, got {N}")
    nll = total / count
    return float(np.exp(nll)), nll  # inf past float64's range, as the JAX package gives
