"""K2, K2q and B11: chunked-prefill flash attention (CUDA for Hopper).

All three run on ``csrc/prefill_attention_sm90.cu``, one launch a call of
``prefill_sm90_kernel`` instantiated for the cache's format.  K2 replaces
magicdec_tpu/ops/pallas/prefill_attention.py ``flash_prefill_attend``
(``_prefill_kernel``) over the bf16 cache; K2q and B11 replace
``flash_prefill_attend_quant`` (``_prefill_quant_kernel``) over an int8
cache with per-(token, kv head) f32 scales and
``flash_prefill_attend_quant4`` (``_prefill_quant4_kernel``) over an int4
cache packed in head pairs.  Bound on the card: tensor-core operations and
exponentials, about equally (4 hd flops and one exp a visible (row,
column) pair).  The kernel is warp-specialized: ``wgmma`` products, K/V
rows by TMA into an mbarrier ring, three consumer warpgroups running the
softmax, and a producer warpgroup that issues the loads and, for the
quantized formats, converts int8 (int4) tiles to bf16; for bf16 it writes
by hand only the tiles whose rows past the visible end must read as zeros
— see the source for the design.  Every kernel takes head dim 64 and 128
(its ``_hd128`` instance, on either scale dtype, from
``csrc/prefill_attention_hd128_sm90.cu``: 64-position tiles, each bf16 row
in two 64-value swizzled halves; ``hd128_launches``); any other head dim
raises before a launch (``kernels.head_dim_entry``).
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import (count_launch, head_dim_entry, on_cpu, ptr, require,
                                        require_bf16, scale_entry)
from magicdec_tpu_torch.kernels.decode_attention import (check_quant_operands,
                                                         visible_layer_quant)
from magicdec_tpu_torch.ops.attention import attend, attend_quant
from magicdec_tpu_torch.ops.kv_cache import append_rows_all_layers


def flash_prefill_attend_plain(q, k_cache, v_cache, base_lens, *, layer=0,
                               k_new=None, v_new=None):
    """Plain version: per request, attend over the layer with the chunk's
    fresh rows appended (one request at a time bounds the [Hq, C, S] fp32
    score tensor)."""
    B, C = q.shape[:2]
    outs = []
    for b in range(B):
        kc = k_cache[layer, b:b + 1]
        vc = v_cache[layer, b:b + 1]
        lens = base_lens[b:b + 1]
        if k_new is not None:
            kc = append_rows_all_layers(kc.clone()[None],
                                        k_new[b:b + 1].reshape(1, 1, C, -1), lens)[0]
            vc = append_rows_all_layers(vc.clone()[None],
                                        v_new[b:b + 1].reshape(1, 1, C, -1), lens)[0]
        outs.append(attend(q[b:b + 1], kc, vc, lens))
    return torch.cat(outs, dim=0)


def flash_prefill_attend(q, k_cache, v_cache, base_lens, *, layer=0,
                         k_new=None, v_new=None):
    """Attention of a C-token chunk over layer ``layer`` with causal masking
    inside the chunk.

    q [B, C, Hq, hd]; k_cache/v_cache [L, B, S, Hkv*hd];
    base_lens [B] int32; k_new/v_new [B, C, Hkv*hd] the chunk's rows when the
    cache does not hold them yet.  Returns [B, C, Hq, hd] in q.dtype; hd is
    64 or 128 (``hd128_launches``).
    """
    if on_cpu(q, k_cache, v_cache, base_lens, k_new, v_new):
        return flash_prefill_attend_plain(q, k_cache, v_cache, base_lens,
                                          layer=layer, k_new=k_new, v_new=v_new)
    from magicdec_tpu_torch.kernels import build

    B, C, Hq, hd = q.shape
    entry = head_dim_entry("md_prefill_attend", hd)
    L, Bc, S, K = k_cache.shape
    Hkv = K // hd
    require(Bc == B and Hkv * hd == K and Hq % Hkv == 0, "shape mismatch")
    require(v_cache.shape == k_cache.shape and 0 <= layer < L, "bad cache shape or layer")
    require(k_cache.is_contiguous() and v_cache.is_contiguous(), "caches must be contiguous")
    if k_new is not None:
        k_new = k_new.reshape(B, C, K).to(q.dtype).contiguous()
        v_new = v_new.reshape(B, C, K).to(q.dtype).contiguous()
    q = q.contiguous()
    require_bf16(q, k_cache, v_cache)
    lens = base_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = getattr(build.library(), entry)(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_new), ptr(v_new), ptr(lens), ptr(out),
        layer, B, S, C, Hq, Hkv, hd, build.stream_ptr(q))
    build.check(err, entry)
    count_launch(flash_prefill_attend, entry)
    return out


flash_prefill_attend.launches = 0
flash_prefill_attend.hd128_launches = 0


def flash_prefill_attend_quant_plain(q, k_cache, k_scale, v_cache, v_scale, base_lens, *,
                                     layer=0, k_new=None, v_new=None, ks_new=None,
                                     vs_new=None):
    """Plain version: per request, ``attend_quant`` over the layer (int8 or
    packed int4) with the chunk's fresh rows appended."""
    fresh = k_new is not None
    outs = []
    for b in range(q.shape[0]):
        one = slice(b, b + 1)
        lens = base_lens[one]
        kc = visible_layer_quant(k_cache[:, one], k_scale[:, one], layer,
                                 k_new[one] if fresh else None,
                                 ks_new[one] if fresh else None, lens)
        vc = visible_layer_quant(v_cache[:, one], v_scale[:, one], layer,
                                 v_new[one] if fresh else None,
                                 vs_new[one] if fresh else None, lens)
        outs.append(attend_quant(q[one], kc[0], kc[1], vc[0], vc[1], lens))
    return torch.cat(outs, dim=0)


def _launch_prefill_quant(entry, q, k_cache, k_scale, v_cache, v_scale, base_lens, layer,
                          fresh, packed):
    """One launch of K2q (``md_prefill_attend_quant``) or B11
    (``md_prefill_attend_quant4``), or their bf16-scale instances, each at
    head dim 64 or 128 (``_hd128``); returns the output and the entry point
    launched (a failed tensor-map encode raises)."""
    from magicdec_tpu_torch.kernels import build

    B, C, Hq, hd = q.shape
    L, _, S, _ = k_cache.shape
    require(0 <= layer < L, "bad layer")
    Hkv, (k_new, v_new, ks_new, vs_new) = check_quant_operands(
        q, k_cache, k_scale, v_cache, v_scale, *fresh, packed=packed)
    entry = head_dim_entry(scale_entry(entry, k_scale, v_scale, ks_new, vs_new), hd)
    q = q.contiguous()
    lens = base_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = getattr(build.library(), entry)(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(k_new),
        ptr(v_new), ptr(ks_new), ptr(vs_new), ptr(lens), ptr(out),
        layer, B, S, C, Hq, Hkv, hd, build.stream_ptr(q))
    build.check(err, entry)
    return out, entry


def flash_prefill_attend_quant(q, k_cache, k_scale, v_cache, v_scale, base_lens, *,
                               layer=0, k_new=None, v_new=None, ks_new=None, vs_new=None):
    """``flash_prefill_attend`` over an int8 cache.

    q [B, C, Hq, hd] bf16; k_cache/v_cache int8 [L, B, S, Hkv*hd];
    k_scale/v_scale f32 or bf16 [L, B, Hkv, S] (bf16: the ``_bf16s``
    instance, ``bf16_scale_launches``); base_lens [B] int32; k_new/v_new int8
    [B, C, Hkv*hd] with ks_new/vs_new [B, Hkv, C] in the scales' dtype: the
    chunk's rows when the cache does not hold them yet.  Returns [B, C, Hq,
    hd] in q.dtype.
    """
    if on_cpu(q, k_cache, k_scale, v_cache, v_scale, base_lens, k_new, v_new, ks_new,
              vs_new):
        return flash_prefill_attend_quant_plain(
            q, k_cache, k_scale, v_cache, v_scale, base_lens, layer=layer,
            k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)
    out, entry = _launch_prefill_quant("md_prefill_attend_quant", q, k_cache, k_scale,
                                       v_cache, v_scale, base_lens, layer,
                                       (k_new, v_new, ks_new, vs_new), packed=False)
    count_launch(flash_prefill_attend_quant, entry)
    return out


flash_prefill_attend_quant.launches = 0
flash_prefill_attend_quant.bf16_scale_launches = 0
flash_prefill_attend_quant.hd128_launches = 0

# The plain version dequantizes by dequant_kv, which reads either layout.
flash_prefill_attend_quant4_plain = flash_prefill_attend_quant_plain


def flash_prefill_attend_quant4(q, k_cache, k_scale, v_cache, v_scale, base_lens, *,
                                layer=0, k_new=None, v_new=None, ks_new=None, vs_new=None):
    """B11: ``flash_prefill_attend_quant`` over an int4 cache packed in head
    pairs: k_cache/v_cache int8 [L, B, S, (Hkv//2)*hd], k_new/v_new packed
    int8 [B, C, (Hkv//2)*hd]; the rest as ``flash_prefill_attend_quant``.
    hd is 64 or 128 (``hd128_launches``)."""
    if on_cpu(q, k_cache, k_scale, v_cache, v_scale, base_lens, k_new, v_new, ks_new,
              vs_new):
        return flash_prefill_attend_quant4_plain(
            q, k_cache, k_scale, v_cache, v_scale, base_lens, layer=layer,
            k_new=k_new, v_new=v_new, ks_new=ks_new, vs_new=vs_new)
    out, entry = _launch_prefill_quant("md_prefill_attend_quant4", q, k_cache, k_scale,
                                       v_cache, v_scale, base_lens, layer,
                                       (k_new, v_new, ks_new, vs_new), packed=True)
    count_launch(flash_prefill_attend_quant4, entry)
    return out


flash_prefill_attend_quant4.launches = 0
flash_prefill_attend_quant4.bf16_scale_launches = 0
flash_prefill_attend_quant4.hd128_launches = 0
