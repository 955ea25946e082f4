"""S1: the coupled-Gumbel sampled head (CUDA, ``csrc/sampling_sm90.cu``).

Not a Pallas site: the JAX package samples with plain ``jnp``
(``magicdec_tpu/ops/sampling.py:70 gumbel_sample_tokens``: the argmax of the
logits over the temperature plus ``coupled_gumbel``'s noise), which XLA
fuses into one pass.  In eager PyTorch the threefry noise alone is some
180 int64 operations over every logit; S1 makes each row's noise in
registers and reduces it to the token in the same pass.

``gumbel_argmax(logits [R, V] f32, key, salt [R], idx [R], div)`` -> int32
[R]: for each row r the lowest v maximizing logits[r, v] / div + g[r, v],
where g[r] = gumbel(fold_in(fold_in(key, salt[r]), idx[r]), (V,)) (JAX's
threefry bits, ``ops/prng.py``).  Bound on the card: the integer ALU (the
hash's 20 rounds an element) well above the R·V·4 bytes it reads.  The
result does not depend on how many rows a launch carries or how a row is
split across blocks (an exact max, lowest index on ties), so a row samples
the same token at verify and at the autoregressive step.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels import on_cpu, require

BLOCKS_PER_SM = 4          # the split's target: this many blocks (of 256 threads) an SM
MIN_COLUMNS = 2048         # no block takes fewer columns of a row


def gumbel_argmax_plain(logits, key, salt, idx, div: float):
    """Plain version of S1: argmax(logits / div + coupled Gumbel noise) per
    row (PyTorch on any device; the division a true one)."""
    from magicdec_tpu_torch.ops.sampling import coupled_gumbel

    g = coupled_gumbel(key, salt, idx[:, None], logits.shape[-1])[:, 0]
    d = torch.tensor(div, dtype=torch.float32, device=logits.device)
    return torch.argmax(logits.float() / d + g, dim=-1).to(torch.int32)


def split_plan(R: int, V: int, sms: int) -> int:
    """Blocks a row: about BLOCKS_PER_SM blocks an SM over all rows, no
    block under MIN_COLUMNS columns.  Any split gives the same tokens."""
    want = -(-BLOCKS_PER_SM * sms // R)
    return max(1, min(want, -(-V // MIN_COLUMNS)))


_scratch = {}


def _partials(dev, R: int, nsplit: int):
    """Per-device scratch: each block's (max, index) partial and a finished
    count a row, which the row's last block resets to 0 (so replays of a
    captured graph start clean)."""
    s = _scratch.get(dev)
    if s is None or s[0].numel() < R * nsplit or s[2].numel() < R:
        # grown, never shrunk; sized for any row count a pass gives at once,
        # so that a captured graph's pointers stay live
        n = max(R * nsplit, 1 << 14, 0 if s is None else s[0].numel())
        rows = max(R, 1 << 10, 0 if s is None else s[2].numel())
        s = (torch.empty(n, dtype=torch.float32, device=dev),
             torch.empty(n, dtype=torch.int32, device=dev),
             torch.zeros(rows, dtype=torch.int32, device=dev))
        _scratch[dev] = s
    return s


def gumbel_argmax(logits, key, salt, idx, div: float):
    """S1: int32 [R] tokens argmax(logits / div + g) for logits [R, V]
    float32 (rows may be strided), key int64 [2] (``prng.PRNGKey``), salt
    and idx int [R]; the plain version for CPU tensors."""
    if on_cpu(logits, key, salt, idx):
        return gumbel_argmax_plain(logits, key, salt, idx, div)
    from magicdec_tpu_torch.kernels import build

    R, V = logits.shape
    require(logits.dtype == torch.float32, f"S1 takes float32 logits, got {logits.dtype}")
    require(logits.stride(-1) == 1, "S1 needs unit-stride rows")
    require(key.shape == (2,) and key.dtype == torch.int64, "S1 takes an int64 [2] key")
    require(salt.shape == (R,) and idx.shape == (R,), "salt and idx must be [R]")
    salt = salt.to(torch.int32).contiguous()
    idx = idx.to(torch.int32).contiguous()
    key = key.contiguous()
    dev = logits.device
    nsplit = split_plan(R, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    pval, pidx, count = _partials(dev, R, nsplit)
    out = torch.empty(R, dtype=torch.int32, device=dev)
    err = build.library().md_gumbel_argmax(
        logits.data_ptr(), key.data_ptr(), salt.data_ptr(), idx.data_ptr(), out.data_ptr(),
        pval.data_ptr(), pidx.data_ptr(), count.data_ptr(), R, V,
        logits.stride(0) if R > 1 else V, nsplit,
        float(div), build.stream_ptr(logits))
    build.check(err, "md_gumbel_argmax")
    gumbel_argmax.launches += 1
    return out


gumbel_argmax.launches = 0
