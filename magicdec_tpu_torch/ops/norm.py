"""RMS norm in the reference's rounding order (magicdec_tpu/models/llama.py
``rms_norm``), shared by the model and the plain versions of the int8 dots."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 norm, cast to x.dtype, THEN scaled by w (the reference's order)."""
    xf = x.to(torch.float32)
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return norm.to(x.dtype) * w
