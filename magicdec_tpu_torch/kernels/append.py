"""K3 and K3q: in-place append of all layers' new KV rows; B14: the same
append one array at a time (CUDA, ``csrc/append.cu``).

K3 and K3q replace magicdec_tpu/ops/kv_cache.py ``append_all_rows_inplace``:
K3 its dense call, K3q its quantized call, which also writes each row's
per-(token, kv head) scales.  B14 replaces ``append_rows_inplace`` and
``append_scale_rows_inplace``, the per-array calls that the JAX package's
``MAGICDEC_PER_ARRAY_APPEND`` A/B switch takes instead.  New row t of
request b lands at ``write_pos[b] + t``; a row (or scale column) that would
land at or past the cache's end is dropped, as the Pallas kernels' row-range
test drops it (``ops/kv_cache.py``'s jnp counterpart clamps the start
instead).  Bound on the card: HBM bytes, twice the rows' bytes; at decode
windows (T = 1..4) the launch itself dominates.  Each launch writes its
arrays of every layer with vector copies and never reads the cache.  The
scales are float32 or bfloat16 (the ``_bf16s`` instances, counted by
``bf16_scale_launches``): copies either way, bit for bit.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import count_launch, on_cpu, ptr, require, scale_entry


def _kept(write_pos, T: int, S: int):
    """(b, t, row) index vectors of the new rows that land inside [0, S)."""
    p = write_pos.to(torch.int64)[:, None] + torch.arange(T, device=write_pos.device)
    b, t = ((p >= 0) & (p < S)).nonzero(as_tuple=True)
    return b, t, p[b, t]


def append_rows_inplace_plain(cache, rows, write_pos):
    """Plain version of B14's row append: rows [L, B, T, K] into cache
    [L, B, S, K] at write_pos [B], rows at or past S dropped; in place."""
    b, t, row = _kept(write_pos, rows.shape[2], cache.shape[2])
    cache[:, b, row] = rows[:, b, t].to(cache.dtype)
    return cache


def append_scale_rows_inplace_plain(scale, rows, write_pos):
    """Plain version of B14's scale append: rows [L, B, H, T] into scale
    [L, B, H, S] at write_pos [B], columns at or past S dropped; in place."""
    b, t, col = _kept(write_pos, rows.shape[3], scale.shape[3])
    scale[:, b, :, col] = rows[:, b, :, t].to(scale.dtype)
    return scale


def append_all_rows_inplace_plain(cache_k, cache_v, rows_k, rows_v, write_pos,
                                  scale_k=None, scale_v=None, srows_k=None, srows_v=None):
    """Plain version of K3 and K3q: the per-array appends of every array."""
    append_rows_inplace_plain(cache_k, rows_k, write_pos)
    append_rows_inplace_plain(cache_v, rows_v, write_pos)
    if scale_k is None:
        return cache_k, cache_v
    append_scale_rows_inplace_plain(scale_k, srows_k, write_pos)
    append_scale_rows_inplace_plain(scale_v, srows_v, write_pos)
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
    rows [write_pos[b], write_pos[b] + T), in place, dropping the rows that
    would land at or past S.  Returns (cache_k, cache_v).  With the scales of an int8 cache
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
    their scale columns (float32 or bfloat16, one dtype), all layers, in ONE
    launch and in place.  Returns (cache_k, cache_v, scale_k, scale_v)."""
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
    require(scale_k.is_contiguous() and scale_v.is_contiguous(), "scales must be contiguous")
    entry = scale_entry("md_append_rows_quant", scale_k, scale_v, srows_k, srows_v)
    srows_k, srows_v = srows_k.contiguous(), srows_v.contiguous()
    pos = write_pos.to(torch.int32).contiguous()
    err = getattr(build.library(), entry)(
        ptr(cache_k), ptr(cache_v), ptr(scale_k), ptr(scale_v), ptr(rows_k), ptr(rows_v),
        ptr(srows_k), ptr(srows_v), ptr(pos), L, B, S, T, H, row_bytes,
        build.stream_ptr(cache_k))
    build.check(err, entry)
    count_launch(append_all_rows_inplace_quant, entry)
    return cache_k, cache_v, scale_k, scale_v


append_all_rows_inplace_quant.launches = 0
append_all_rows_inplace_quant.bf16_scale_launches = 0


def _check_per_array(write_pos, S: int, align: int, what: str):
    """The Pallas per-array kernels' preconditions: S a multiple of their
    block (8 rows; 128 scale columns) and write_pos >= 0.  A card's
    write_pos is not read back (that would stall the host); there the
    kernel drops a row before 0 as it drops one past S."""
    require(S % align == 0, f"{what}: the cache length {S} must be a multiple of {align}")
    if write_pos.device.type == "cpu":
        require(bool((write_pos >= 0).all()), f"{what}: write_pos must be >= 0")


def append_rows_inplace(cache, rows, write_pos):
    """B14: rows [L, B, T, K] into ONE cache array [L, B, S, K] (bf16, or
    int8 rows, packed int4 included) at rows [write_pos[b], write_pos[b] +
    T), in place, rows at or past S dropped.  One launch; returns cache."""
    L, B, S, K = cache.shape
    _check_per_array(write_pos, S, 8, "append_rows_inplace")
    if on_cpu(cache, rows, write_pos):
        return append_rows_inplace_plain(cache, rows, write_pos)
    from magicdec_tpu_torch.kernels import build

    T = rows.shape[2]
    require(rows.shape == (L, B, T, K), f"rows {tuple(rows.shape)} do not match cache "
                                        f"{tuple(cache.shape)}")
    require(1 <= T <= S, "window longer than the cache")
    require(cache.is_contiguous(), "the cache must be contiguous")
    row_bytes = K * cache.element_size()
    require(row_bytes % 16 == 0, "a cache row must be a multiple of 16 bytes")
    rows = rows.to(cache.dtype).contiguous()
    pos = write_pos.to(torch.int32).contiguous()
    err = build.library().md_append_array_rows(ptr(cache), ptr(rows), ptr(pos), L, B, S, T,
                                               row_bytes, build.stream_ptr(cache))
    build.check(err, "md_append_array_rows")
    append_rows_inplace.launches += 1
    return cache


append_rows_inplace.launches = 0


def append_scale_rows_inplace(scale, rows, write_pos):
    """B14: scale rows [L, B, H, T] into ONE scale array [L, B, H, S] at
    columns [write_pos[b], write_pos[b] + T), in place, columns at or past S
    dropped; float32 or bfloat16, one dtype.  One launch; returns scale."""
    L, B, H, S = scale.shape
    _check_per_array(write_pos, S, 128, "append_scale_rows_inplace")
    if on_cpu(scale, rows, write_pos):
        return append_scale_rows_inplace_plain(scale, rows, write_pos)
    from magicdec_tpu_torch.kernels import build

    T = rows.shape[3]
    require(rows.shape == (L, B, H, T), f"scale rows {tuple(rows.shape)} do not match "
                                        f"scales {tuple(scale.shape)}")
    require(1 <= T <= S, "window longer than the cache")
    require(scale.is_contiguous(), "the scales must be contiguous")
    entry = scale_entry("md_append_scale_cols", scale, rows)
    rows = rows.contiguous()
    pos = write_pos.to(torch.int32).contiguous()
    err = getattr(build.library(), entry)(ptr(scale), ptr(rows), ptr(pos), L, B, H, S, T,
                                          build.stream_ptr(scale))
    build.check(err, entry)
    count_launch(append_scale_rows_inplace, entry)
    return scale


append_scale_rows_inplace.launches = 0
append_scale_rows_inplace.bf16_scale_launches = 0
