"""B12 and B13: decode attention over KV page pools and the paged append
(CUDA: B12 in ``csrc/decode_attention_sm90.cu``, B13 in
``csrc/paged_attention.cu``).

B12 replaces magicdec_tpu/ops/pallas/paged_attention.py
``flash_paged_decode_attend``, ``flash_paged_decode_attend_quant`` and
``flash_paged_decode_attend_quant4`` (``_paged_call``): the K1, K1q and B10
decode kernels with each KV row read from the page the table names.  The
split plan is the contiguous kernels' at S = npr*ps, so on the card a paged
launch equals the contiguous launch over the gathered cache bit for bit.
B13 replaces ``append_paged_rows_inplace``: every layer's new k/v rows (and
their scales) into pool pages through the table, in one launch, dropping
rows at or past npr*ps.  Bound on the card: HBM bytes for both.  On a CUDA
tensor a wrapper launches its kernel or raises; the pool is never gathered
there.  The plain versions (CPU tensors) gather one layer and run the
contiguous plain versions.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import (count_launch, head_dim_entry, on_cpu, ptr, require,
                                        require_bf16, scale_entry)
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.ops.paged_kv import (append_paged_rows_all_layers,
                                             append_paged_scale_rows_all_layers, pool_gather,
                                             scale_pool_gather)


def flash_paged_decode_attend_plain(q, k_pool, v_pool, table, base_lens, *, layer=0,
                                    k_new=None, v_new=None):
    """Plain version: ``flash_decode_attend_plain`` over layer ``layer`` of
    the gathered pools."""
    kc = pool_gather(k_pool[layer:layer + 1], table)
    vc = pool_gather(v_pool[layer:layer + 1], table)
    return DA.flash_decode_attend_plain(q, kc, vc, base_lens, layer=0, k_new=k_new,
                                        v_new=v_new)


def flash_paged_decode_attend_quant_plain(q, k_pool, k_scale, v_pool, v_scale, table,
                                          base_lens, *, layer=0, k_new=None, v_new=None,
                                          ks_new=None, vs_new=None):
    """Plain version of both quantized pools (int8, or int4 packed in head
    pairs): ``flash_decode_attend_quant_plain`` over the gathered layer."""
    sl = slice(layer, layer + 1)
    return DA.flash_decode_attend_quant_plain(
        q, pool_gather(k_pool[sl], table), scale_pool_gather(k_scale[sl], table),
        pool_gather(v_pool[sl], table), scale_pool_gather(v_scale[sl], table), base_lens,
        layer=0, k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)


flash_paged_decode_attend_quant4_plain = flash_paged_decode_attend_quant_plain


def _check_table(table, B, P):
    """The page table as the kernels take it: int32 [B, npr], contiguous."""
    require(table.dim() == 2 and table.shape[0] == B, f"table {tuple(table.shape)} is not [B, npr]")
    require(table.dtype == torch.int32 and table.is_contiguous(),
            "the page table must be contiguous int32")
    require(P >= 1, "empty pool")


def flash_paged_decode_attend(q, k_pool, v_pool, table, base_lens, *, layer=0, k_new=None,
                              v_new=None):
    """B12 over a bf16 pool: attention of a T <= 16 token window.

    q [B, T, Hq, hd] (G*T <= 128 rows); k_pool/v_pool [L, P, ps, Hkv*hd];
    table [B, npr] int32 (pages of any size; a page of a multiple of 16 rows
    holds whole tiles, which land by TMA);
    base_lens [B] int32, the visible length before the window; k_new/v_new
    [B, T, Hkv*hd] the window's rows when the pool does not hold them yet.
    Returns [B, T, Hq, hd] in q.dtype; hd is 64 or 128 (``hd128_launches``).
    """
    if on_cpu(q, k_pool, v_pool, table, base_lens, k_new, v_new):
        return flash_paged_decode_attend_plain(q, k_pool, v_pool, table, base_lens,
                                               layer=layer, k_new=k_new, v_new=v_new)
    from magicdec_tpu_torch.kernels import build

    B, T, Hq, hd = q.shape
    entry = head_dim_entry("md_paged_decode_attend", hd)
    L, P, ps, K = k_pool.shape
    Hkv = K // hd
    _check_table(table, B, P)
    npr = table.shape[1]
    require(Hkv * hd == K and Hq % Hkv == 0, "shape mismatch")
    require(v_pool.shape == k_pool.shape and 0 <= layer < L and 1 <= T <= 16
            and Hq // Hkv * T <= 128, "bad pool shape, layer or window length")
    require(k_pool.is_contiguous() and v_pool.is_contiguous(), "pools must be contiguous")
    if k_new is not None:
        k_new = k_new.reshape(B, T, K).to(q.dtype).contiguous()
        v_new = v_new.reshape(B, T, K).to(q.dtype).contiguous()
    q = q.contiguous()
    require_bf16(q, k_pool, v_pool)
    lens = base_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit, chunk, part_o, part_ml = DA.split_buffers(q, Hkv, npr * ps)
    err = getattr(build.library(), entry)(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(k_new), ptr(v_new), ptr(lens),
        ptr(out), ptr(part_o), ptr(part_ml), layer, B, P, ps, npr, T, Hq, Hkv, hd, nsplit,
        chunk, build.stream_ptr(q))
    build.check(err, entry)
    count_launch(flash_paged_decode_attend, entry)
    return out


flash_paged_decode_attend.launches = 0
flash_paged_decode_attend.hd128_launches = 0


def _launch_paged_quant(entry, q, k_pool, k_scale, v_pool, v_scale, table, base_lens, layer,
                        fresh, packed):
    """One launch of the int8 or packed-int4 B12 entry point (its
    bf16-scale instance for bf16 scales, its ``_hd128`` instance at head dim
    128); returns the output and the entry point launched."""
    from magicdec_tpu_torch.kernels import build

    B, T, Hq, hd = q.shape
    L, P, ps, Kc = k_pool.shape
    require(k_scale.dim() == 4, f"scale pool {tuple(k_scale.shape)} must be [L, P, Hkv, ps]")
    Hkv = k_scale.shape[2]
    _check_table(table, B, P)
    npr = table.shape[1]
    want = (Hkv // 2) * hd if packed else Hkv * hd
    require(Kc == want and Hq % Hkv == 0 and not (packed and Hkv % 2), "shape mismatch")
    require(v_pool.shape == k_pool.shape and 0 <= layer < L and 1 <= T <= 16,
            "bad pool shape, layer or window length")
    require(k_scale.shape == (L, P, Hkv, ps) and v_scale.shape == k_scale.shape,
            f"scale pools {tuple(k_scale.shape)} do not match the pool {tuple(k_pool.shape)}")
    require(k_pool.dtype == v_pool.dtype == torch.int8, "the pool must be int8")
    require(all(t.is_contiguous() for t in (k_pool, v_pool, k_scale, v_scale)),
            "pools must be contiguous")
    require_bf16(q)
    k_new, v_new, ks_new, vs_new = DA.quant_fresh_operands(B, T, Hkv, Kc, *fresh)
    entry = head_dim_entry(scale_entry(entry, k_scale, v_scale, ks_new, vs_new), hd)
    q = q.contiguous()
    lens = base_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit, chunk, part_o, part_ml = DA.split_buffers(q, Hkv, npr * ps, quant=True)
    err = getattr(build.library(), entry)(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale), ptr(v_scale), ptr(table), ptr(k_new),
        ptr(v_new), ptr(ks_new), ptr(vs_new), ptr(lens), ptr(out), ptr(part_o), ptr(part_ml),
        layer, B, P, ps, npr, T, Hq, Hkv, hd, nsplit, chunk, build.stream_ptr(q))
    build.check(err, entry)
    return out, entry


def flash_paged_decode_attend_quant(q, k_pool, k_scale, v_pool, v_scale, table, base_lens, *,
                                    layer=0, k_new=None, v_new=None, ks_new=None,
                                    vs_new=None):
    """B12 over an int8 pool: pools int8 [L, P, ps, Hkv*hd], scale pools f32
    or bf16 [L, P, Hkv, ps]; fresh rows int8 [B, T, Hkv*hd] with scales
    [B, Hkv, T] in the pools' scale dtype; otherwise as
    ``flash_paged_decode_attend`` (``hd128_launches``)."""
    fresh = (k_new, v_new, ks_new, vs_new)
    if on_cpu(q, k_pool, k_scale, v_pool, v_scale, table, base_lens, *fresh):
        return flash_paged_decode_attend_quant_plain(
            q, k_pool, k_scale, v_pool, v_scale, table, base_lens, layer=layer,
            k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)
    out, entry = _launch_paged_quant("md_paged_decode_attend_quant", q, k_pool, k_scale,
                                     v_pool, v_scale, table, base_lens, layer, fresh,
                                     packed=False)
    count_launch(flash_paged_decode_attend_quant, entry)
    return out


flash_paged_decode_attend_quant.launches = 0
flash_paged_decode_attend_quant.bf16_scale_launches = 0
flash_paged_decode_attend_quant.hd128_launches = 0


def flash_paged_decode_attend_quant4(q, k_pool, k_scale, v_pool, v_scale, table, base_lens, *,
                                     layer=0, k_new=None, v_new=None, ks_new=None,
                                     vs_new=None):
    """B12 over an int4 pool packed in head pairs: pools int8 [L, P, ps,
    (Hkv//2)*hd], scale pools f32 or bf16 [L, P, Hkv, ps] (Hkv from the scales);
    fresh rows packed [B, T, (Hkv//2)*hd] with scales [B, Hkv, T].  hd is
    64 or 128 (``hd128_launches``)."""
    fresh = (k_new, v_new, ks_new, vs_new)
    if on_cpu(q, k_pool, k_scale, v_pool, v_scale, table, base_lens, *fresh):
        return flash_paged_decode_attend_quant4_plain(
            q, k_pool, k_scale, v_pool, v_scale, table, base_lens, layer=layer,
            k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)
    out, entry = _launch_paged_quant("md_paged_decode_attend_quant4", q, k_pool, k_scale,
                                     v_pool, v_scale, table, base_lens, layer, fresh,
                                     packed=True)
    count_launch(flash_paged_decode_attend_quant4, entry)
    return out


flash_paged_decode_attend_quant4.launches = 0
flash_paged_decode_attend_quant4.bf16_scale_launches = 0
flash_paged_decode_attend_quant4.hd128_launches = 0


def append_paged_rows_inplace_plain(pool_k, pool_v, rows_k, rows_v, write_pos, table,
                                    scale_k=None, scale_v=None, srows_k=None, srows_v=None):
    append_paged_rows_all_layers(pool_k, rows_k, write_pos, table)
    append_paged_rows_all_layers(pool_v, rows_v, write_pos, table)
    if scale_k is None:
        return pool_k, pool_v
    append_paged_scale_rows_all_layers(scale_k, srows_k, write_pos, table)
    append_paged_scale_rows_all_layers(scale_v, srows_v, write_pos, table)
    return pool_k, pool_v, scale_k, scale_v


def append_paged_rows_inplace(pool_k, pool_v, rows_k, rows_v, write_pos, table,
                              scale_k=None, scale_v=None, srows_k=None, srows_v=None):
    """B13: write rows_k/rows_v [L, B, T, Kc] into pool_k/pool_v [L, P, ps,
    Kc] at request b's logical positions [write_pos[b], write_pos[b] + T)
    through table [B, npr], every layer, in place; a row at or past npr*ps
    is dropped.  With a quantized pool's scale pools (scale_k/scale_v
    [L, P, H, ps], srows_k/srows_v [L, B, H, T], float32 or bfloat16, one
    dtype; bf16 takes the ``_bf16s`` instance, ``bf16_scale_launches``) the
    scale columns land in the same launch.  Returns (pool_k, pool_v[,
    scale_k, scale_v])."""
    quant = scale_k is not None
    if on_cpu(pool_k, pool_v, rows_k, rows_v, write_pos, table, scale_k, scale_v, srows_k,
              srows_v):
        return append_paged_rows_inplace_plain(pool_k, pool_v, rows_k, rows_v, write_pos,
                                               table, scale_k, scale_v, srows_k, srows_v)
    from magicdec_tpu_torch.kernels import build

    L, P, ps, Kc = pool_k.shape
    B, T = rows_k.shape[1], rows_k.shape[2]
    _check_table(table, B, P)
    npr = table.shape[1]
    require(pool_v.shape == pool_k.shape and pool_v.dtype == pool_k.dtype,
            "k and v pools differ in shape or dtype")
    require(rows_k.shape == (L, B, T, Kc) and rows_v.shape == rows_k.shape and T >= 1,
            f"rows {tuple(rows_k.shape)} do not match the pool {tuple(pool_k.shape)}")
    require(pool_k.is_contiguous() and pool_v.is_contiguous(), "pools must be contiguous")
    row_bytes = Kc * pool_k.element_size()
    require(row_bytes % 16 == 0, "a pool row must be a multiple of 16 bytes")
    rows_k = rows_k.to(pool_k.dtype).contiguous()
    rows_v = rows_v.to(pool_k.dtype).contiguous()
    pos = write_pos.to(torch.int32).contiguous()
    lib, stream = build.library(), build.stream_ptr(pool_k)
    if not quant:
        err = lib.md_append_paged_rows(ptr(pool_k), ptr(pool_v), ptr(rows_k), ptr(rows_v),
                                       ptr(pos), ptr(table), L, B, P, ps, npr, T, row_bytes,
                                       stream)
        build.check(err, "md_append_paged_rows")
        append_paged_rows_inplace.launches += 1
        return pool_k, pool_v
    H = scale_k.shape[2]
    require(scale_k.shape == (L, P, H, ps) and scale_v.shape == scale_k.shape,
            f"scale pools {tuple(scale_k.shape)} do not match the pool {tuple(pool_k.shape)}")
    require(srows_k.shape == (L, B, H, T) and srows_v.shape == srows_k.shape,
            f"scale rows {tuple(srows_k.shape)} do not match the scale pools")
    require(scale_k.is_contiguous() and scale_v.is_contiguous(), "scale pools must be contiguous")
    entry = scale_entry("md_append_paged_rows_quant", scale_k, scale_v, srows_k, srows_v)
    srows_k, srows_v = srows_k.contiguous(), srows_v.contiguous()
    err = getattr(lib, entry)(
        ptr(pool_k), ptr(pool_v), ptr(scale_k), ptr(scale_v), ptr(rows_k), ptr(rows_v),
        ptr(srows_k), ptr(srows_v), ptr(pos), ptr(table), L, B, P, ps, npr, T, H, row_bytes,
        stream)
    build.check(err, entry)
    count_launch(append_paged_rows_inplace, entry)
    return pool_k, pool_v, scale_k, scale_v


append_paged_rows_inplace.launches = 0
append_paged_rows_inplace.bf16_scale_launches = 0
