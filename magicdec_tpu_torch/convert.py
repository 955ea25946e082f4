"""Move weights and state between the JAX package and the port.

The JAX package's parameter pytree (before or after its
``fuse_exec_params``) arrives as nested dicts of numpy arrays (the caller
maps ``np.asarray`` over the tree), caches and lengths as numpy arrays.
Layouts are kept: caches ``[L, B, S, Hkv*hd]``, weights ``[In, Out]``,
``embed [V, D]``, ``lm_head [D, V]`` or None.  bfloat16 travels as float32,
which holds every bfloat16 value exactly, so a weight or a cache compares
bit for bit across the two packages.  A quantized weight (the JAX package's
``QuantizedWeight``, or any object or dict with ``q``, ``scale``, ``bits``
and ``group_size``) becomes the port's ``QuantizedWeight`` with its int8 data
(int4: packed pairs, ``[In/2, Out]``) and f32 scales (``[G, Out]``) in their
own dtypes; an int4 cache's packed rows ``[L, B, S, (Hkv/2)*hd]`` move as
any int8 cache.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16 else a.dtype))
    if bf16 and dtype is None:
        dtype = torch.bfloat16
    return t.to(device=device, dtype=dtype)


def _quant_fields(leaf):
    """(q, scale, bits, group_size) of a quantized-weight leaf, else None."""
    names = ("q", "scale", "bits", "group_size")
    if isinstance(leaf, dict):
        return tuple(leaf[n] for n in names) if set(names) <= leaf.keys() else None
    if all(hasattr(leaf, n) for n in names):
        return tuple(getattr(leaf, n) for n in names)
    return None


def params_from_jax(tree, device="cpu", dtype=None):
    """Nested dict of numpy arrays (None leaves kept) -> dict of tensors;
    ``dtype`` casts the float weights, never a quantized weight's data or
    scales."""
    fields = _quant_fields(tree)
    if fields is not None:
        from magicdec_tpu_torch.quantization import QuantizedWeight

        q, scale, bits, group_size = fields
        return QuantizedWeight(tensor_from_numpy(q, device), tensor_from_numpy(scale, device),
                               bits=int(bits), group_size=int(group_size))
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if tree is None:
        return None
    return tensor_from_numpy(tree, device, dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 widens exactly to float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def caches_from_jax(caches, device="cpu", dtype=None):
    """{'k','v','dk',...: numpy [L, B, S, K]} -> dict of tensors.  ``dtype``
    casts the float KV data only: int8 caches and the scale arrays of a
    quantized cache ({'ks','vs'} [L, B, Hkv, S]) keep their own dtype, so
    they move bit for bit."""
    def keep(name, a):
        return name.endswith(("ks", "vs")) or np.issubdtype(np.asarray(a).dtype, np.integer)

    return {k: tensor_from_numpy(v, device, None if keep(k, v) else dtype)
            for k, v in caches.items()}


def caches_to_numpy(caches):
    """Dict of cache tensors -> dict of numpy arrays (the JAX layout)."""
    return {k: tensor_to_numpy(v) for k, v in caches.items()}
