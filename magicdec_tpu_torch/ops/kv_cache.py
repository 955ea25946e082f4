"""Layer-stacked KV-cache appends and int8 KV quantization (counterpart of
magicdec_tpu/ops/kv_cache.py).

Caches are ``[L, B, S, Hkv*hd]``: the head axis folded minor, the JAX
package's at-rest layout, so a cache moves between the two packages bit for
bit.  A quantized cache holds int8 data in that layout plus per-(token, kv
head) scales ``[L, B, Hkv, S]`` (the cache-length axis minor, as in the JAX
package).  The layer loop reads the stacked cache and collects each layer's
new rows; ONE append after the loop writes them, in place.  The Hopper
kernel for that append is ``kernels/append.py``; this module holds its plain
version.
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


def dequant_kv(cache: torch.Tensor, scale: torch.Tensor, head_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """int8 cache [B, S, H*hd] with scales [B, H, S] -> dense [B, S, H*hd]
    in ``dtype`` (the int4 layout arrives with ROADMAP item A8)."""
    B, S, K = cache.shape
    H = scale.shape[1]
    x = cache.reshape(B, S, H, head_dim).to(torch.float32)
    x = x * scale.transpose(1, 2).to(torch.float32)[..., None]
    return x.reshape(B, S, H * head_dim).to(dtype)
