"""Determinism helpers (counterpart of magicdec_tpu/utils/seeding.py and
``benchmarks/common.py sampling_rng``)."""

from __future__ import annotations

import random

import numpy as np
import torch

from magicdec_tpu_torch.ops.prng import PRNGKey


def setup_seed(seed: int, device=None) -> torch.Tensor:
    """Seed numpy, ``random`` and torch; return the port's key of ``seed``
    (``ops/prng.py PRNGKey``, the JAX package's key words)."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return PRNGKey(seed, device=device)


def sampling_rng(args, device=None):
    """The ``rng`` of an engine's encode and serve: the key of ``--seed``
    when ``--temperature`` > 0, else None (greedy)."""
    if getattr(args, "temperature", 0.0) > 0:
        return PRNGKey(args.seed, device=device)
    return None
