"""Layer-stacked KV-cache appends and int8 / int4 KV quantization
(counterpart of magicdec_tpu/ops/kv_cache.py).

Caches are ``[L, B, S, Hkv*hd]``: the head axis folded minor, the JAX
package's at-rest layout, so a cache moves between the two packages bit for
bit.  A quantized cache holds int8 data in that layout, or int4 packed in
head pairs into ``[L, B, S, (Hkv//2)*hd]`` int8, plus per-(token, kv head)
scales ``[L, B, Hkv, S]`` (the cache-length axis minor, as in the JAX
package).  The layer loop reads the stacked cache and collects each layer's
new rows; ONE append after the loop writes them, in place.  The Hopper
kernels for that append and their plain versions are ``kernels/append.py``;
they drop the rows that would land past the cache's end, as the Pallas
kernels do.  This module's ``append_rows_all_layers`` is the counterpart
of the JAX package's jnp op, which clamps the start instead.
"""

from __future__ import annotations

import torch


def append_rows_all_layers(cache: torch.Tensor, rows: torch.Tensor,
                           write_pos: torch.Tensor) -> torch.Tensor:
    """Write rows [L, B, T, K] into cache [L, B, S, K] at write_pos [B], in
    place, and return the cache.

    The start index clamps to [0, S - T] as ``jax.lax.dynamic_update_slice``
    does, so no write lands past S; the engines assert capacity from static
    shapes, so the clamp never engages on their path.
    """
    L, B, S, K = cache.shape
    T = rows.shape[2]
    start = write_pos.to(torch.int64).clamp(0, S - T)
    t_idx = start[:, None] + torch.arange(T, device=cache.device)  # [B, T]
    b_idx = torch.arange(B, device=cache.device)[:, None]
    cache[:, b_idx, t_idx] = rows.to(cache.dtype)
    return cache


def append_scale_rows_all_layers(scale: torch.Tensor, rows: torch.Tensor,
                                 write_pos: torch.Tensor) -> torch.Tensor:
    """Scale counterpart of ``append_rows_all_layers``: rows [L, B, H, T]
    into scale [L, B, H, S] at columns [start_b, start_b + T), start_b =
    clamp(write_pos[b], 0, S - T), in place."""
    L, B, H, S = scale.shape
    T = rows.shape[3]
    start = write_pos.to(torch.int64).clamp(0, S - T)
    t_idx = start[:, None] + torch.arange(T, device=scale.device)  # [B, T]
    b_idx = torch.arange(B, device=scale.device)[:, None]
    # advanced indices on dims 1 and 3 (split by a slice) lead the result:
    # the indexed view is [B, T, L, H]
    scale[:, b_idx, :, t_idx] = rows.permute(1, 3, 0, 2).to(scale.dtype)
    return scale


def quantize_kv_tokens(x: torch.Tensor, scale_dtype=torch.float32):
    """Per-(token, kv head) symmetric int8 quantization of new KV entries.

    x [B, T, Hkv, hd] -> (q int8 [B, T, Hkv*hd], scale [B, Hkv, T] in
    ``scale_dtype``).  scale = max(amax, 1e-8) / 127, rounded to its dtype;
    q = clip(round(x / scale), -127, 127) against the ROUNDED scale, with
    round half to even, so dequantization is exactly q * stored scale.
    """
    B, T = x.shape[:2]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)                                   # [B, T, H]
    scale = (torch.clamp(amax, min=1e-8) / 127.0).to(scale_dtype)
    sf = scale.to(torch.float32)
    q = torch.clamp(torch.round(xf / sf[..., None]), -127, 127).to(torch.int8)
    return q.reshape(B, T, -1), scale.transpose(1, 2).contiguous()


def is_packed_int4(cache: torch.Tensor, scale: torch.Tensor, head_dim: int) -> bool:
    """True when a quantized cache [..., S, K] holds head-pair-packed int4
    rows: K == (H // 2) * hd with H the scale's head count ([..., H, S])."""
    return cache.shape[-1] == (scale.shape[-2] // 2) * head_dim


def dequant_kv(cache: torch.Tensor, scale: torch.Tensor, head_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """Quantized cache with scales [B, H, S] -> dense [B, S, H*hd] in
    ``dtype``.  The layout is detected from the lane width against the
    scale's head count, as in the JAX package: int8 [B, S, H*hd], or int4
    head-pair-packed [B, S, (H//2)*hd] (``pack_int4_heads``)."""
    B, S, K = cache.shape
    H = scale.shape[1]
    if is_packed_int4(cache, scale, head_dim):
        x = unpack_int4_heads(cache, head_dim).to(torch.float32)
    else:
        x = cache.reshape(B, S, H, head_dim).to(torch.float32)
    x = x * scale.transpose(1, 2).to(torch.float32)[..., None]
    return x.reshape(B, S, H * head_dim).to(dtype)


# int4 KV, head-pair packed: kv head 2i rides the LOW nibble and kv head 2i+1
# the HIGH nibble of packed pseudo-head i, lane for lane (packed lane i*hd + l
# holds (head 2i, lane l) | (head 2i+1, lane l) << 4).  Values are symmetric
# int4 in [-7, 7]; the scales keep the int8 layout [B, H, S], one per
# (token, kv head).  A quarter of bf16's bytes.


def pack_int4_heads(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], [..., H, hd] (H even) -> packed int8
    [..., (H//2)*hd]."""
    *lead, H, hd = q.shape
    if H % 2:
        raise ValueError(f"int4 packing needs an even kv-head count, got {H}")
    pairs = q.to(torch.int8).reshape(*lead, H // 2, 2, hd)
    packed = (pairs[..., 0, :] & 0x0F) | (pairs[..., 1, :] << 4)
    return packed.reshape(*lead, (H // 2) * hd)


def unpack_int4_heads(packed: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Packed int8 [..., (H//2)*hd] -> int8 values [..., H, hd]: the low
    nibble sign-extended by a shift pair, the high one by an arithmetic
    shift."""
    *lead, Kp = packed.shape
    p = packed.reshape(*lead, Kp // head_dim, head_dim)
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * (Kp // head_dim), head_dim)


def quantize_kv_tokens_int4(x: torch.Tensor, scale_dtype=torch.float32):
    """Per-(token, kv head) symmetric int4 quantization with head-pair
    packing: x [B, T, H, hd] -> (packed int8 [B, T, (H//2)*hd], scale
    [B, H, T] in ``scale_dtype``).  scale = max(amax, 1e-8) / 7, rounded to
    its dtype; q = clip(round(x / scale), -7, 7) against the rounded scale,
    round half to even."""
    B, T = x.shape[:2]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)                                   # [B, T, H]
    scale = (torch.clamp(amax, min=1e-8) / 7.0).to(scale_dtype)
    sf = scale.to(torch.float32)
    q = torch.clamp(torch.round(xf / sf[..., None]), -7, 7).to(torch.int8)
    return pack_int4_heads(q), scale.transpose(1, 2).contiguous()
