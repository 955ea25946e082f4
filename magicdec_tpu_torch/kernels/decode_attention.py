"""K1, K1q and B10: flash decode / verify attention (CUDA,
``csrc/decode_attention_sm90.cu``).

K1 replaces magicdec_tpu/ops/pallas/decode_attention.py
``flash_decode_attend`` (both ``_decode_kernel`` and ``_whole_row_kernel``);
K1q replaces ``flash_decode_attend_quant`` (``_decode_quant_kernel``) over
an int8 cache with per-(token, kv head) f32 or bf16 scales (bf16: the
kernel's ``_bf16s`` instance, each scale widened to f32 as it is read, so
its bits equal the f32 instance's on the widened values); B10 replaces
``flash_decode_attend_quant4`` (``_decode_quant4_kernel``) over an int4
cache packed in head pairs with the same scales.  Bound on the card: HBM
bytes (each visible K/V row is read once and feeds only G*T query rows;
int8 rows halve them, int4 rows quarter them).  All run one kernel,
``decode_sm90_kernel`` (four warps a block, each with its own ring of
16-position tiles), which splits each (request, kv head)'s KV rows over
several blocks; a second pass merges their softmax partials — see the
source for the design.  K1 splits by ``split_plan`` (a block a kv head,
three blocks an SM at most), K1q and B10 by ``quant_split_plan`` (a block a
pair of kv heads, or one int8 head when Hkv is odd, one wave).  Every kernel
takes head dim 64 and 128 (its ``_hd128`` instance, on either scale dtype:
the 7B/8B targets' caches, built from ``csrc/decode_attention_hd128_sm90.cu``
and counted in each wrapper's ``hd128_launches``); any other head dim
raises before a launch (``kernels.head_dim_entry``).
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import (count_launch, head_dim_entry, on_cpu, ptr, require,
                                        require_bf16, scale_entry)
from magicdec_tpu_torch.ops.attention import attend
from magicdec_tpu_torch.ops.kv_cache import (append_rows_all_layers,
                                             append_scale_rows_all_layers, dequant_kv)

# A block of either format's kernel has four warps taking 16 positions each
# a round, so splits are whole rounds of 64 positions.  A plan aims at
# PLAN_BLOCKS blocks, three an SM, and splits no further: the int8 pair
# blocks' registers hold three an SM; a bf16 block keeps 32 KB of tiles in
# flight, so a (request, kv head) a block already streams the target cache
# at 91% of the HBM rate (B=32; H100 80GB HBM3 at 700 W), and a split adds a
# partial to write and merge; a ragged serve (16 slots) takes three
# splits, a block past its request's visible end exiting at once (PERF.md:
# `decode_variants --blocks`).
PLAN_ROUND = 64
PLAN_BLOCKS = 3 * 132
# the head-dim-128 instances hold two blocks an SM (quantized: the output of
# two heads in registers; bf16: 8 KB stages), so their plans aim at two an SM
PLAN_BLOCKS_HD128 = 2 * 132


def _plan(blocks: int, S: int, plan_blocks: int = PLAN_BLOCKS):
    """(nsplit, chunk) of `blocks` blocks a split over S positions."""
    rounds = -(-S // PLAN_ROUND)
    nsplit = max(1, min(rounds, plan_blocks // blocks))
    chunk = -(-rounds // nsplit) * PLAN_ROUND
    return -(-S // chunk), chunk


def split_plan(B: int, Hkv: int, S: int, hd: int = 64):
    """(nsplit, chunk) of K1 and B12's bf16 pool (a block a kv head): KV
    splits per (request, kv head) and positions per split.  A function of
    (B, Hkv, S) and the head dim only: no host read of the lengths, nothing
    from T or the query rows, and the same for a pool of npr pages of ps
    rows as for a cache of S = npr * ps, so a verify row equals its
    autoregressive step and a paged launch the contiguous one, bit for bit
    (head dim 128: two blocks an SM)."""
    return _plan(B * Hkv, S, PLAN_BLOCKS_HD128 if hd == 128 else PLAN_BLOCKS)


def quant_heads(Hkv: int) -> int:
    """The kv heads one K1q / B10 block serves: a pair (int8: one when Hkv
    is odd)."""
    return 2 if Hkv % 2 == 0 else 1


def quant_split_plan(B: int, Hkv: int, S: int, hd: int = 64):
    """(nsplit, chunk) of K1q and B10: KV splits per (request, block of
    kv heads) and positions per split, fixed from static shapes as
    ``split_plan``'s (the head dim: two blocks an SM at 128)."""
    return _plan(B * (Hkv // quant_heads(Hkv)), S,
                 PLAN_BLOCKS_HD128 if hd == 128 else PLAN_BLOCKS)


def rows_pad(rows: int) -> int:
    """Rows of a split's partial per (request, kv head): the grouped query
    rows padded to 16 * 2^k (the kernel's R)."""
    w = 1
    while 16 * w < rows:
        w *= 2
    return 16 * w


def split_buffers(q, Hkv: int, S: int, quant: bool = False):
    """(nsplit, chunk, part_o, part_ml) of a decode launch over S positions:
    the split plan (K1's ``split_plan``, or with ``quant`` K1q's and B10's
    ``quant_split_plan``) and, with more than one split, the f32 partials
    the combine pass merges (None otherwise)."""
    B, T, Hq, hd = q.shape
    nsplit, chunk = quant_split_plan(B, Hkv, S, hd) if quant else split_plan(B, Hkv, S, hd)
    if nsplit == 1:
        return nsplit, chunk, None, None
    R = rows_pad(Hq // Hkv * T)
    part_o = torch.empty((B, Hkv, nsplit, R, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, Hkv, nsplit, R, 2), dtype=torch.float32, device=q.device)
    return nsplit, chunk, part_o, part_ml


def _visible_layer(cache, layer, rows, base_lens):
    """Layer ``layer`` of the cache with the fresh rows written at base_lens
    (a copy): what the cache will hold once the caller appends them."""
    c = cache[layer]
    if rows is None:
        return c
    c = c.clone()
    append_rows_all_layers(c[None], rows.reshape(c.shape[0], -1, c.shape[2])[None],
                           base_lens)
    return c


def flash_decode_attend_plain(q, k_cache, v_cache, base_lens, *, layer=0,
                              k_new=None, v_new=None):
    """Plain version: attend over the layer with the fresh rows appended.
    Each query token runs as its own T = 1 call, so a row's arithmetic is
    the same whatever the window length (verify T = gamma + 1 and the
    autoregressive step T = 1 give the same bits on the CPU)."""
    kc = _visible_layer(k_cache, layer, k_new, base_lens)
    vc = _visible_layer(v_cache, layer, v_new, base_lens)
    base = base_lens.to(torch.int64)
    return torch.cat([attend(q[:, t:t + 1], kc, vc, base + t)
                      for t in range(q.shape[1])], dim=1)


def flash_decode_attend(q, k_cache, v_cache, base_lens, *, layer=0,
                        k_new=None, v_new=None):
    """Attention of a T <= 16 token window over layer ``layer``.

    q [B, T, Hq, hd] (G*T <= 128 rows); k_cache/v_cache [L, B, S, Hkv*hd];
    base_lens [B] int32, the visible length before the window; k_new/v_new
    [B, T, Hkv*hd] the window's rows when the cache does not hold them yet.
    Returns [B, T, Hq, hd] in q.dtype; hd is 64 or 128 (``hd128_launches``).
    """
    if on_cpu(q, k_cache, v_cache, base_lens, k_new, v_new):
        return flash_decode_attend_plain(q, k_cache, v_cache, base_lens,
                                         layer=layer, k_new=k_new, v_new=v_new)
    from magicdec_tpu_torch.kernels import build

    B, T, Hq, hd = q.shape
    entry = head_dim_entry("md_decode_attend", hd)
    L, Bc, S, K = k_cache.shape
    Hkv = K // hd
    require(Bc == B and Hkv * hd == K and Hq % Hkv == 0, "shape mismatch")
    require(v_cache.shape == k_cache.shape and 0 <= layer < L and 1 <= T <= 16
            and Hq // Hkv * T <= 128, "bad cache shape, layer or window length")
    require(k_cache.is_contiguous() and v_cache.is_contiguous(), "caches must be contiguous")
    fresh = k_new is not None
    if fresh:
        k_new = k_new.reshape(B, T, K).to(q.dtype).contiguous()
        v_new = v_new.reshape(B, T, K).to(q.dtype).contiguous()
    q = q.contiguous()
    require_bf16(q, k_cache, v_cache)
    lens = base_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit, chunk, part_o, part_ml = split_buffers(q, Hkv, S)
    err = getattr(build.library(), entry)(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_new), ptr(v_new), ptr(lens), ptr(out),
        ptr(part_o), ptr(part_ml), layer, B, S, T, Hq, Hkv, hd, nsplit, chunk,
        build.stream_ptr(q))
    build.check(err, entry)
    count_launch(flash_decode_attend, entry)
    return out


flash_decode_attend.launches = 0
flash_decode_attend.hd128_launches = 0


def visible_layer_quant(cache, scale, layer, rows, srows, base_lens):
    """Layer ``layer`` of a quantized cache (int8 or packed int4) and its
    scales, with the fresh rows and their scales written at base_lens (into
    copies)."""
    c, s = cache[layer], scale[layer]
    if rows is not None:
        c, s = c.clone(), s.clone()
        append_rows_all_layers(c[None], rows.reshape(c.shape[0], -1, c.shape[2])[None],
                               base_lens)
        append_scale_rows_all_layers(s[None], srows[None], base_lens)
    return c, s


def flash_decode_attend_quant_plain(q, k_cache, k_scale, v_cache, v_scale, base_lens, *,
                                    layer=0, k_new=None, v_new=None, ks_new=None,
                                    vs_new=None):
    """Plain version: dequantize the layer (int8 or packed int4) with the
    fresh rows appended, then attend one query token at a time, as
    ``flash_decode_attend_plain``."""
    hd = q.shape[-1]
    kc = dequant_kv(*visible_layer_quant(k_cache, k_scale, layer, k_new, ks_new, base_lens), hd)
    vc = dequant_kv(*visible_layer_quant(v_cache, v_scale, layer, v_new, vs_new, base_lens), hd)
    base = base_lens.to(torch.int64)
    return torch.cat([attend(q[:, t:t + 1], kc, vc, base + t)
                      for t in range(q.shape[1])], dim=1)


def check_quant_operands(q, k_cache, k_scale, v_cache, v_scale, k_new, v_new, ks_new,
                         vs_new, *, packed=False):
    """Shapes, types and layouts the quantized attention kernels take (K1q,
    K2q; ``packed``: the int4 B10, B11).  Hkv comes from the scales: a
    packed row is (Hkv//2)*hd bytes wide; the scales are float32 or bfloat16,
    one dtype for the cache's and the fresh rows' (``scale_entry`` picks the
    instance).  Returns Hkv and the fresh operands made contiguous (None when
    absent)."""
    B, T, Hq, hd = q.shape
    L, Bc, S, K = k_cache.shape
    require(k_scale.dim() == 4, f"scales {tuple(k_scale.shape)} must be [L, B, Hkv, S]")
    Hkv = k_scale.shape[2]
    want = (Hkv // 2) * hd if packed else Hkv * hd
    require(Bc == B and K == want and Hkv >= 1 and Hq % Hkv == 0
            and not (packed and Hkv % 2), "shape mismatch"
            + (" (an int4 cache packs an even kv-head count in pairs)" if packed else ""))
    require(v_cache.shape == k_cache.shape, "k and v caches differ in shape")
    require(k_scale.shape == (L, B, Hkv, S) and v_scale.shape == k_scale.shape,
            f"scales {tuple(k_scale.shape)} do not match the cache {tuple(k_cache.shape)}")
    require(k_cache.dtype == v_cache.dtype == torch.int8, "the cache must be int8")
    require(all(t.is_contiguous() for t in (k_cache, v_cache, k_scale, v_scale)),
            "caches and scales must be contiguous")
    require_bf16(q)
    return Hkv, quant_fresh_operands(B, T, Hkv, K, k_new, v_new, ks_new, vs_new)


def quant_fresh_operands(B, T, Hkv, K, k_new, v_new, ks_new, vs_new):
    """The fresh rows of a quantized window (int8 [B, T, K] with scales
    [B, Hkv, T]) made contiguous, or four Nones when absent."""
    if k_new is None:
        return None, None, None, None
    require(ks_new is not None and vs_new is not None, "fresh rows need their scales")
    k_new = k_new.reshape(B, T, K).contiguous()
    v_new = v_new.reshape(B, T, K).contiguous()
    ks_new = ks_new.reshape(B, Hkv, T).contiguous()
    vs_new = vs_new.reshape(B, Hkv, T).contiguous()
    require(k_new.dtype == v_new.dtype == torch.int8, "fresh rows must be int8")
    return k_new, v_new, ks_new, vs_new


def _launch_decode_quant(entry, q, k_cache, k_scale, v_cache, v_scale, base_lens, layer,
                         fresh, packed):
    """One launch of K1q (``md_decode_attend_quant``) or B10
    (``md_decode_attend_quant4``), or their bf16-scale instances, each at
    head dim 64 or 128 (``_hd128``); returns the output and the entry point
    launched."""
    from magicdec_tpu_torch.kernels import build

    B, T, Hq, hd = q.shape
    L, _, S, _ = k_cache.shape
    require(0 <= layer < L and 1 <= T <= 16, "bad layer or window length")
    Hkv, (k_new, v_new, ks_new, vs_new) = check_quant_operands(
        q, k_cache, k_scale, v_cache, v_scale, *fresh, packed=packed)
    entry = head_dim_entry(scale_entry(entry, k_scale, v_scale, ks_new, vs_new), hd)
    q = q.contiguous()
    lens = base_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit, chunk, part_o, part_ml = split_buffers(q, Hkv, S, quant=True)
    err = getattr(build.library(), entry)(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(k_new),
        ptr(v_new), ptr(ks_new), ptr(vs_new), ptr(lens), ptr(out), ptr(part_o),
        ptr(part_ml), layer, B, S, T, Hq, Hkv, hd, nsplit, chunk, build.stream_ptr(q))
    build.check(err, entry)
    return out, entry


def flash_decode_attend_quant(q, k_cache, k_scale, v_cache, v_scale, base_lens, *,
                              layer=0, k_new=None, v_new=None, ks_new=None, vs_new=None):
    """``flash_decode_attend`` over an int8 cache.

    q [B, T, Hq, hd] bf16 (T <= 16); k_cache/v_cache int8 [L, B, S, Hkv*hd];
    k_scale/v_scale f32 or bf16 [L, B, Hkv, S]; base_lens [B] int32;
    k_new/v_new int8 [B, T, Hkv*hd] with ks_new/vs_new [B, Hkv, T] in the
    scales' dtype: the window's rows when the cache does not hold them yet.
    Returns [B, T, Hq, hd] in q.dtype.  ``bf16_scale_launches`` counts the
    launches on bf16 scales, ``hd128_launches`` those at head dim 128.
    """
    if on_cpu(q, k_cache, k_scale, v_cache, v_scale, base_lens, k_new, v_new, ks_new,
              vs_new):
        return flash_decode_attend_quant_plain(
            q, k_cache, k_scale, v_cache, v_scale, base_lens, layer=layer,
            k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)
    out, entry = _launch_decode_quant("md_decode_attend_quant", q, k_cache, k_scale, v_cache,
                                      v_scale, base_lens, layer,
                                      (k_new, v_new, ks_new, vs_new), packed=False)
    count_launch(flash_decode_attend_quant, entry)
    return out


flash_decode_attend_quant.launches = 0
flash_decode_attend_quant.bf16_scale_launches = 0
flash_decode_attend_quant.hd128_launches = 0

# The plain versions dequantize by dequant_kv, which reads either layout.
flash_decode_attend_quant4_plain = flash_decode_attend_quant_plain


def flash_decode_attend_quant4(q, k_cache, k_scale, v_cache, v_scale, base_lens, *,
                               layer=0, k_new=None, v_new=None, ks_new=None, vs_new=None):
    """B10: ``flash_decode_attend_quant`` over an int4 cache packed in head
    pairs (``ops.kv_cache.quantize_kv_tokens_int4``).

    q [B, T, Hq, hd] bf16 (T <= 16); k_cache/v_cache int8 [L, B, S,
    (Hkv//2)*hd]; k_scale/v_scale f32 or bf16 [L, B, Hkv, S]; base_lens [B]
    int32; k_new/v_new packed int8 [B, T, (Hkv//2)*hd] with ks_new/vs_new
    [B, Hkv, T].  Returns [B, T, Hq, hd] in q.dtype.  hd is 64 or 128 (the
    ``_hd128`` instance, counted in ``hd128_launches``).
    """
    if on_cpu(q, k_cache, k_scale, v_cache, v_scale, base_lens, k_new, v_new, ks_new,
              vs_new):
        return flash_decode_attend_quant4_plain(
            q, k_cache, k_scale, v_cache, v_scale, base_lens, layer=layer,
            k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)
    out, entry = _launch_decode_quant("md_decode_attend_quant4", q, k_cache, k_scale, v_cache,
                                      v_scale, base_lens, layer,
                                      (k_new, v_new, ks_new, vs_new), packed=True)
    count_launch(flash_decode_attend_quant4, entry)
    return out


flash_decode_attend_quant4.launches = 0
flash_decode_attend_quant4.bf16_scale_launches = 0
flash_decode_attend_quant4.hd128_launches = 0
