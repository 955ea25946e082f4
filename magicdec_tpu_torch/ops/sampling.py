"""Samplers (counterpart of magicdec_tpu/ops/sampling.py).

Temperature and top-p filtering, a categorical sample, the greedy batched
argmax, and the coupled Gumbel noise of exact speculative sampling: draft
and target perturb their logits with the same noise row per (request,
output-stream position), so the greedy-match acceptance commits exact
samples from the target distribution, and spec output equals sampled
autoregressive output token for token.  The keys and noise are the JAX
package's (``ops/prng.py``); the operations keep its order: float32, a
true division by max(temperature, 1e-5), the top-p threshold from the
descending sort's cumulative softmax, the lowest index on argmax ties.
``gumbel_sample_tokens`` runs its argmax over perturbed logits on S1
(``kernels/sampling.py``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from magicdec_tpu_torch.kernels.sampling import gumbel_argmax
from magicdec_tpu_torch.ops import prng


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device: an operand that CUDA's binary
    kernels do not take as a host scalar (which turns a division into a
    product with the reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def get_sampling_logits(logits: torch.Tensor, top_p: float, temperature: float) -> torch.Tensor:
    """Temperature + nucleus filtering: logits / max(temperature, 1e-5),
    those outside the top-p nucleus set to -inf.  The nucleus keeps the
    largest logit and every next one while the cumulative probability of
    those before it is below top_p."""
    logits = logits / _f32(max(temperature, 1e-5), logits)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < _f32(top_p, cum)], dim=-1)
    inf = torch.tensor(float("inf"), device=logits.device)
    threshold = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, -inf)


def sample(rng: torch.Tensor, logits: torch.Tensor, top_p: float = 0.9,
           temperature: float = 0.6) -> torch.Tensor:
    """A categorical sample from the top-p filtered distribution
    (``jax.random.categorical``: argmax of the logits plus Gumbel noise
    drawn over their whole shape) -> int32 [...]."""
    filtered = get_sampling_logits(logits.float(), top_p, temperature)
    g = prng.gumbel(rng, filtered.shape)
    return torch.argmax(g + filtered, dim=-1).to(torch.int32)


def sampling_argmax_batch(logits: torch.Tensor) -> torch.Tensor:
    """Greedy batched argmax (lowest index on ties) -> int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def coupled_gumbel(key: torch.Tensor, salt: torch.Tensor, idx: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """Per-(request, output-stream-position) Gumbel noise rows: salt [B]
    int32 (request identity), idx [B, T] int32 (the candidate token's index
    in the output stream) -> float32 [B, T, vocab], the row of (salt, idx)
    drawn under fold_in(fold_in(key, salt), idx).  A position that a window
    rejects gets the same row again when it is proposed next."""
    k = prng.fold_in(prng.fold_in(key, salt)[:, None], idx)
    return prng.gumbel(k, (vocab,))


def gumbel_sample_tokens(logits: torch.Tensor, key: torch.Tensor, salt: torch.Tensor,
                         idx: torch.Tensor, *, temperature: float,
                         top_p: float = 1.0) -> torch.Tensor:
    """argmax(filtered(logits) / temperature + coupled gumbel) -> int32
    [B, T] for logits [B, T, V].  With top_p < 1 the filter divides by the
    temperature here and S1 divides by 1; otherwise S1 divides."""
    B, T, V = logits.shape
    logits = logits.float()
    if top_p < 1.0:
        logits, div = get_sampling_logits(logits, top_p, temperature), 1.0
    else:
        div = max(temperature, 1e-5)
    rows_salt = salt.to(torch.int32)[:, None].expand(B, T).reshape(B * T)
    tok = gumbel_argmax(logits.reshape(B * T, V), key, rows_salt,
                        idx.to(torch.int32).reshape(B * T), div)
    return tok.reshape(B, T)
