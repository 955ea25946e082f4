"""KV page pools of the paged serving engine (counterpart of the pool half
of magicdec_tpu/ops/paged_kv.py).

A pool is ``[L, P, ps, Kc]`` (Kc = Hkv*hd for a dense or int8 pool,
(Hkv//2)*hd for int4 packed in head pairs), with scale pools
``[L, P, Hkv, ps]`` for a quantized one; a page table ``[B, npr]`` int32
maps logical page j of request b to pool page ``table[b, j]``, so request
b's logical row r lies in page ``table[b, r // ps]`` at row ``r % ps``.
These are the plain versions: the gathers serve tests and the gathered
route of ``ops.attention.attend_cache`` (windows longer than the decode
kernel's 16 tokens), and the appends are the plain versions of the paged
append kernel (``kernels/paged_attention.py``).  Writes are in place.
"""

from __future__ import annotations

import torch


def alloc_pool(n_layer: int, n_pages: int, page_size: int, lane_width: int,
               dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """[L, P, ps, Kc] zero page pool."""
    return torch.zeros((n_layer, n_pages, page_size, lane_width), dtype=dtype, device=device)


def alloc_scale_pool(n_layer: int, n_pages: int, n_kv: int, page_size: int,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[L, P, Hkv, ps] zero scale pool of a quantized pool."""
    return torch.zeros((n_layer, n_pages, n_kv, page_size), dtype=dtype, device=device)


def pool_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[L, P, ps, Kc] + [B, npr] -> the contiguous view [L, B, npr*ps, Kc]
    (a copy)."""
    L, _, ps, Kc = pool.shape
    B, npr = table.shape
    return pool[:, table.reshape(-1).long()].reshape(L, B, npr * ps, Kc)


def scale_pool_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[L, P, H, ps] + [B, npr] -> [L, B, H, npr*ps] (a copy)."""
    L, _, H, ps = pool.shape
    B, npr = table.shape
    g = pool[:, table.reshape(-1).long()].reshape(L, B, npr, H, ps)
    return g.transpose(2, 3).reshape(L, B, H, npr * ps)


def pool_scatter(pool: torch.Tensor, table: torch.Tensor,
                 contiguous: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pool_gather``: write [L, B, npr*ps, Kc] into the pool's
    pages, in place; returns the pool."""
    L, _, ps, Kc = pool.shape
    B, npr = table.shape
    pool[:, table.reshape(-1).long()] = contiguous.reshape(L, B * npr, ps, Kc).to(pool.dtype)
    return pool


def _logical_rows(write_pos, table, T: int, ps: int):
    """(b, page, row) index tensors [n] of the positions [write_pos[b],
    write_pos[b] + T) that lie inside a request's npr*ps rows, and the (b, t)
    of each, for the paged appends: a row outside is dropped, as the Pallas
    kernel drops it (no clamp, no shift)."""
    B, npr = table.shape
    pos = write_pos.to(torch.int64)[:, None] + torch.arange(T, device=table.device)  # [B, T]
    keep = (pos >= 0) & (pos < npr * ps)
    b_idx, t_idx = keep.nonzero(as_tuple=True)
    p = pos[b_idx, t_idx]
    page = table.long()[b_idx, p // ps]
    return b_idx, t_idx, page, p % ps


def append_paged_rows_all_layers(pool: torch.Tensor, rows: torch.Tensor,
                                 write_pos: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Write rows [L, B, T, Kc] into the pool [L, P, ps, Kc] at request b's
    logical positions [write_pos[b], write_pos[b] + T), in place, dropping
    any row at or past npr*ps; returns the pool."""
    b_idx, t_idx, page, slot = _logical_rows(write_pos, table, rows.shape[2], pool.shape[2])
    pool[:, page, slot] = rows[:, b_idx, t_idx].to(pool.dtype)
    return pool


def append_paged_scale_rows_all_layers(spool: torch.Tensor, srows: torch.Tensor,
                                       write_pos: torch.Tensor,
                                       table: torch.Tensor) -> torch.Tensor:
    """Scale counterpart: srows [L, B, H, T] into spool [L, P, H, ps], in
    place, dropping columns at or past npr*ps; returns the scale pool."""
    b_idx, t_idx, page, slot = _logical_rows(write_pos, table, srows.shape[3], spool.shape[3])
    # advanced indices on dims 1 and 3 (split by a slice) lead: the view is [n, L, H]
    spool[:, page, :, slot] = srows[:, b_idx, :, t_idx].to(spool.dtype)
    return spool
