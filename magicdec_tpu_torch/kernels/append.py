"""K3 and K3q: in-place append of all layers' new KV rows (CUDA,
``csrc/append.cu``).

Replaces magicdec_tpu/ops/kv_cache.py ``append_all_rows_inplace``: K3 its
dense call, K3q its quantized call, which also writes each row's
per-(token, kv head) scales.  Bound on the card: HBM bytes, twice the rows'
bytes; at decode windows (T = 1..4) the launch itself dominates.  One
launch writes k and v (and their scales) of every layer with vector copies
and never reads the cache.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import on_cpu, ptr, require
from magicdec_tpu_torch.ops.kv_cache import append_rows_all_layers, append_scale_rows_all_layers


def append_all_rows_inplace_plain(cache_k, cache_v, rows_k, rows_v, write_pos,
                                  scale_k=None, scale_v=None, srows_k=None, srows_v=None):
    append_rows_all_layers(cache_k, rows_k, write_pos)
    append_rows_all_layers(cache_v, rows_v, write_pos)
    if scale_k is None:
        return cache_k, cache_v
    append_scale_rows_all_layers(scale_k, srows_k, write_pos)
    append_scale_rows_all_layers(scale_v, srows_v, write_pos)
    return cache_k, cache_v, scale_k, scale_v


def _check_rows(cache_k, cache_v, rows_k, rows_v):
    """(L, B, S, T, row bytes) of a row append; raises on what the kernels
    do not take.  Returns the rows in the cache's dtype, contiguous."""
    L, B, S, K = cache_k.shape
    T = rows_k.shape[2]
    require(cache_v.shape == cache_k.shape and cache_v.dtype == cache_k.dtype,
            "k and v caches differ in shape or dtype")
    require(rows_k.shape == (L, B, T, K) and rows_v.shape == rows_k.shape,
            f"rows {tuple(rows_k.shape)} do not match cache {tuple(cache_k.shape)}")
    require(1 <= T <= S, "window longer than the cache")
    require(cache_k.is_contiguous() and cache_v.is_contiguous(),
            "caches must be contiguous")
    row_bytes = K * cache_k.element_size()
    require(row_bytes % 16 == 0, "a cache row must be a multiple of 16 bytes")
    rows_k = rows_k.to(cache_k.dtype).contiguous()
    rows_v = rows_v.to(cache_k.dtype).contiguous()
    return (L, B, S, T, row_bytes), rows_k, rows_v


def append_all_rows_inplace(cache_k, cache_v, rows_k, rows_v, write_pos,
                            scale_k=None, scale_v=None, srows_k=None, srows_v=None):
    """Write rows_k/rows_v [L, B, T, K] into cache_k/cache_v [L, B, S, K] at
    rows [start_b, start_b + T), start_b = clamp(write_pos[b], 0, S - T), in
    place.  Returns (cache_k, cache_v).  With the scales of an int8 cache
    (scale_k/scale_v [L, B, H, S], srows_k/srows_v [L, B, H, T]) this is the
    quantized call, ``append_all_rows_inplace_quant``, which returns
    (cache_k, cache_v, scale_k, scale_v)."""
    if scale_k is not None:
        return append_all_rows_inplace_quant(cache_k, cache_v, rows_k, rows_v, write_pos,
                                             scale_k, scale_v, srows_k, srows_v)
    if on_cpu(cache_k, cache_v, rows_k, rows_v, write_pos):
        return append_all_rows_inplace_plain(cache_k, cache_v, rows_k, rows_v,
                                             write_pos)
    from magicdec_tpu_torch.kernels import build

    (L, B, S, T, row_bytes), rows_k, rows_v = _check_rows(cache_k, cache_v, rows_k, rows_v)
    pos = write_pos.to(torch.int32).contiguous()
    err = build.library().md_append_rows(
        ptr(cache_k), ptr(cache_v), ptr(rows_k), ptr(rows_v), ptr(pos),
        L, B, S, T, row_bytes, build.stream_ptr(cache_k))
    build.check(err, "md_append_rows")
    append_all_rows_inplace.launches += 1
    return cache_k, cache_v


append_all_rows_inplace.launches = 0


def append_all_rows_inplace_quant(cache_k, cache_v, rows_k, rows_v, write_pos,
                                  scale_k, scale_v, srows_k, srows_v):
    """The quantized call of ``append_all_rows_inplace``: int8 rows and
    their f32 scale columns, all layers, in ONE launch and in place.
    Returns (cache_k, cache_v, scale_k, scale_v)."""
    if on_cpu(cache_k, cache_v, rows_k, rows_v, write_pos, scale_k, scale_v, srows_k,
              srows_v):
        return append_all_rows_inplace_plain(cache_k, cache_v, rows_k, rows_v, write_pos,
                                             scale_k, scale_v, srows_k, srows_v)
    from magicdec_tpu_torch.kernels import build

    (L, B, S, T, row_bytes), rows_k, rows_v = _check_rows(cache_k, cache_v, rows_k, rows_v)
    H = scale_k.shape[2]
    require(scale_k.shape == (L, B, H, S) and scale_v.shape == scale_k.shape,
            f"scales {tuple(scale_k.shape)} do not match cache {tuple(cache_k.shape)}")
    require(srows_k.shape == (L, B, H, T) and srows_v.shape == srows_k.shape,
            f"scale rows {tuple(srows_k.shape)} do not match scales {tuple(scale_k.shape)}")
    require(scale_k.dtype == scale_v.dtype == torch.float32,
            "the scales must be float32 (bf16 scales are ROADMAP item A8)")
    require(scale_k.is_contiguous() and scale_v.is_contiguous(), "scales must be contiguous")
    srows_k = srows_k.to(torch.float32).contiguous()
    srows_v = srows_v.to(torch.float32).contiguous()
    pos = write_pos.to(torch.int32).contiguous()
    err = build.library().md_append_rows_quant(
        ptr(cache_k), ptr(cache_v), ptr(scale_k), ptr(scale_v), ptr(rows_k), ptr(rows_v),
        ptr(srows_k), ptr(srows_v), ptr(pos), L, B, S, T, H, row_bytes,
        build.stream_ptr(cache_k))
    build.check(err, "md_append_rows_quant")
    append_all_rows_inplace_quant.launches += 1
    return cache_k, cache_v, scale_k, scale_v


append_all_rows_inplace_quant.launches = 0
