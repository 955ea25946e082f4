"""Batched GQA attention over length-governed KV caches (counterpart of
magicdec_tpu/ops/attention.py).

``attend`` is the plain numerics oracle: ragged per-request lengths, causal
masking aligned so the END of the query window meets the end of the visible
KV, GQA, fp32 softmax; ``attend_quant`` is its quantized-cache counterpart
(dequantize, then attend).  ``attend_cache`` dispatches a layer of the
stacked ``[L, B, S, K]`` caches (bf16, or int8 or packed int4 with scales) to the
Hopper kernels: the decode kernel for small windows (T <= 16), the prefill
kernel for chunks; a page pool (caches holding a ``table``) takes the paged
decode kernel for small windows and is gathered for longer ones.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
DECODE_MAX_T = 16  # windows up to this many tokens take the decode kernel


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           base_lens: torch.Tensor) -> torch.Tensor:
    """Multi-token decode / verify / chunked-prefill attention.

    q [B, T, Hq, D]; k_cache/v_cache [B, S, Hkv*D] (already holding the T new
    tokens); base_lens [B] int32, the visible length BEFORE the T tokens.
    Query row t attends slots [0, base + t + 1).  Returns [B, T, Hq, D] in
    q.dtype.
    """
    B, T, Hq, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2] // D
    G = Hq // Hkv
    kh = k_cache.reshape(B, S, Hkv, D).to(torch.float32).permute(0, 2, 3, 1)
    vh = v_cache.reshape(B, S, Hkv, D).to(torch.float32).transpose(1, 2)
    qg = (q.reshape(B, T, Hkv, G, D).to(torch.float32).permute(0, 2, 3, 1, 4)
          .reshape(B, Hkv, G * T, D))
    # scores [B, Hkv, G, T, S]
    scores = (torch.matmul(qg, kh) * (1.0 / math.sqrt(D))).view(B, Hkv, G, T, S)
    col = torch.arange(S, device=q.device)
    row = torch.arange(T, device=q.device)
    limit = base_lens.to(torch.int64)[:, None, None] + row[None, :, None] + 1  # [B, T, 1]
    mask = col[None, None, :] < limit  # [B, T, S]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1).view(B, Hkv, G * T, S)
    out = torch.matmul(probs, vh).view(B, Hkv, G, T, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def attend_quant(q, k_cache, k_scale, v_cache, v_scale, base_lens) -> torch.Tensor:
    """``attend`` over quantized caches (int8 [B, S, Hkv*hd], or int4
    head-pair-packed [B, S, (Hkv//2)*hd]) with per-(token, head) scales
    [B, Hkv, S]: dequantize to float32, then attend."""
    from magicdec_tpu_torch.ops.kv_cache import dequant_kv

    hd = q.shape[-1]
    return attend(q, dequant_kv(k_cache, k_scale, hd), dequant_kv(v_cache, v_scale, hd),
                  base_lens)


def attend_cache(q, caches, base_lens, *, layer: int, prefix: str = "",
                 fresh=None) -> torch.Tensor:
    """Causal attention over layer ``layer`` of the stacked caches.

    caches: {'k', 'v'} (``prefix`` renames them: the draft cache is
    {'dk', 'dv'}) with tensors [L, B, S, Hkv*hd]; a quantized cache also
    holds its scales {'ks', 'vs'} [L, B, Hkv, S], and is int4 packed in head
    pairs when its rows are (Hkv//2)*hd wide (Hkv from the scales, as in the
    JAX package).  The kernels take the whole
    stacked cache and the layer index: no [B, S, K] slice is copied.
    ``fresh``: the rows of the T window tokens when the cache does not hold
    them yet, in the cache's at-rest format ({'k', 'v'} [B, T, K], plus
    {'ks', 'vs'} [B, Hkv, T] for a quantized cache); the caller appends these
    exact rows after the layer loop, so attending them as fresh operands
    equals attending the appended cache.  Page pools (``caches[prefix +
    'table']`` set: ``attend_cache_paged``) take the same layout rules.
    """
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.ops.kv_cache import is_packed_int4

    if caches.get(prefix + "table") is not None:
        return attend_cache_paged(q, caches, base_lens, layer=layer, prefix=prefix,
                                  fresh=fresh)
    decode = q.shape[1] <= DECODE_MAX_T
    k, v = caches[prefix + "k"], caches[prefix + "v"]
    ks = caches.get(prefix + "ks")
    if ks is not None:
        fresh_kw = {} if fresh is None else dict(
            k_new=fresh["k"], v_new=fresh["v"], ks_new=fresh["ks"], vs_new=fresh["vs"])
        if is_packed_int4(k, ks, q.shape[-1]):
            fn = DA.flash_decode_attend_quant4 if decode else PA.flash_prefill_attend_quant4
        else:
            fn = DA.flash_decode_attend_quant if decode else PA.flash_prefill_attend_quant
        return fn(q, k, ks, v, caches[prefix + "vs"], base_lens, layer=layer, **fresh_kw)
    fresh_kw = {} if fresh is None else dict(k_new=fresh["k"], v_new=fresh["v"])
    fn = DA.flash_decode_attend if decode else PA.flash_prefill_attend
    return fn(q, k, v, base_lens, layer=layer, **fresh_kw)


def attend_cache_paged(q, caches, base_lens, *, layer: int, prefix: str = "",
                       fresh=None) -> torch.Tensor:
    """``attend_cache`` over page pools (paged serving): {'k', 'v'} [L, P,
    ps, Kc] (+ {'ks', 'vs'} [L, P, Hkv, ps]) and 'table' [B, npr] int32.
    Decode windows (T <= 16) take the paged kernels (B12); longer windows
    gather the layer into the contiguous layout and take the contiguous
    route, as the JAX package does (``_attend_cache_paged``): the serving
    loop runs decode windows only, and admission encodes contiguously."""
    from magicdec_tpu_torch.kernels import paged_attention as PGA
    from magicdec_tpu_torch.ops.kv_cache import is_packed_int4
    from magicdec_tpu_torch.ops.paged_kv import pool_gather, scale_pool_gather

    table = caches[prefix + "table"]
    k, v = caches[prefix + "k"], caches[prefix + "v"]
    ks = caches.get(prefix + "ks")
    if q.shape[1] <= DECODE_MAX_T:
        if ks is not None:
            fresh_kw = {} if fresh is None else dict(
                k_new=fresh["k"], v_new=fresh["v"], ks_new=fresh["ks"], vs_new=fresh["vs"])
            fn = (PGA.flash_paged_decode_attend_quant4 if is_packed_int4(k, ks, q.shape[-1])
                  else PGA.flash_paged_decode_attend_quant)
            return fn(q, k, ks, v, caches[prefix + "vs"], table, base_lens, layer=layer,
                      **fresh_kw)
        fresh_kw = {} if fresh is None else dict(k_new=fresh["k"], v_new=fresh["v"])
        return PGA.flash_paged_decode_attend(q, k, v, table, base_lens, layer=layer,
                                             **fresh_kw)
    sl = slice(layer, layer + 1)
    contig = {prefix + "k": pool_gather(k[sl], table), prefix + "v": pool_gather(v[sl], table)}
    if ks is not None:
        contig[prefix + "ks"] = scale_pool_gather(ks[sl], table)
        contig[prefix + "vs"] = scale_pool_gather(caches[prefix + "vs"][sl], table)
    return attend_cache(q, contig, base_lens, layer=0, prefix=prefix, fresh=fresh)
