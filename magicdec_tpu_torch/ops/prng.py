"""Counter-based random bits: JAX's threefry2x32 PRNG, reproduced in PyTorch.

The port's keys and noise equal the JAX package's (``jax.random`` with its
default ``threefry2x32`` implementation and ``jax_threefry_partitionable``
on): a key is two uint32 words, ``fold_in`` hashes a word into a key, and the
random bits of element n of a shape are the xor of the two output words of
``threefry2x32(key, (n >> 32, n & 0xFFFFFFFF))``.  Threefry is a pure hash
of (key, counter), so no generator state is involved and the bits are the
same on any device, in any order and under any batching.

uint32 arithmetic is emulated in int64 tensors, every result masked to 32
bits.  Counterparts (read, not imported): ``jax/_src/prng.py``
``threefry_seed``, ``_threefry2x32_lowering``, ``threefry_fold_in`` and
``_threefry_random_bits_partitionable``; ``jax/_src/random.py`` ``_uniform``
and ``_gumbel`` (mode "low").  The uniform floats are bit-equal to JAX's;
the Gumbel noise takes two float32 logs, whose last bit may differ between
libraries (XLA's, torch's and CUDA's ``logf`` are each within an ulp or so).
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)  # the Gumbel uniform's lower bound


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed, ``jax.random.PRNGKey``'s words: int64 [2]
    holding [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1); all int64 tensors or ints of uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2] and int data [...] (taken as
    uint32) broadcast to new keys [..., 2] = threefry2x32(key, (0, data))."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element of ``shape`` under each key [..., 2]:
    int64 [..., *shape], element n (the flat index within ``shape``) hashing
    the counter (n >> 32, n & 0xFFFFFFFF), its two words xored."""
    shape = tuple(shape)
    n = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=key.device)
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, n >> 32, n & MASK)
    return (y0 ^ y1).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), ``jax.random.uniform``'s bits:
    the top 23 random bits as the mantissa of a float in [1, 2), minus 1,
    times (maxval - minval) plus minval, at least minval."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, span = np.float32(minval), np.float32(maxval) - np.float32(minval)
    f = f * torch.tensor(span, device=f.device) + torch.tensor(lo, device=f.device)
    return torch.clamp_min(f, float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel noise, ``jax.random.gumbel``'s "low" mode:
    -log(-log(u)) of uniforms u in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))
