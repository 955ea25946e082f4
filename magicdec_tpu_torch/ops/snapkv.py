"""SnapKV draft-cache construction: observation-window top-k compression
(counterpart of magicdec_tpu/ops/snapkv.py).

Every prefix key is scored by the attention mass the last ``window``
(already roped) queries put on it; the scores are pooled along the cache
axis, summed over each GQA group, and the top-(budget - window) keys of each
kv head are kept, followed by the window's own rows.  Selected rows keep
their original rope, so the draft cache is position-incoherent across heads:
the draft only ever attends over it.

As in the JAX package: the causal mask inside the observation window applies
to every GQA group, and the scores carry no 1/sqrt(d) scaling (the SnapKV
reference omits it; it sets the softmax temperature and so the selection).

Numerics, stated:

- The score product runs in full float32 on the dequantized keys
  (``torch.matmul`` of float32 tensors: on the card it takes TF32 only when
  ``torch.backends.cuda.matmul.allow_tf32`` is True, PyTorch's default is
  False, and ``chip_smoke.py`` checks that it stays False).
- The average pool sums each window directly, as the SnapKV reference's
  ``avg_pool1d`` does; the JAX package differences a cumulative sum, whose
  rounding grows with the cache (``_avg_pool_1d``).  The two agree to that
  rounding.
- Ties: the top-k is a stable descending sort, so equal scores keep the
  lower key index first, the order ``jax.lax.top_k`` gives.  ``torch.topk``
  is not used: it leaves the order of equal scores unspecified.
- The card sums the scores in another order than the CPU, so two keys whose
  scores lie within rounding of each other may swap places and the card may
  keep a different key.  That moves acceptance only, never the greedy
  output: the target's verify decides every committed token.

Memory: requests are compressed in groups of ``GROUP``.  A quantized cache
(int8, or int4 packed in head pairs) is dequantized per group, into the
query dtype as the JAX package does, never for the whole batch (the JAX
package's reason: a 2+ GiB transient at 32k and B=32).  One request's
score tensor is [Hkv, G, W, ctx] float32: 8 x 4 x 32 x 8224 x 4 bytes =
33.7 MB at llama-3.2-1b widths and the bench's 8224-token prefix, with its
softmax of the same size beside it and the keys in float32 (16.8 MB) and
both dequantized caches (2 x 8.4 MB); a group of 8 holds about 0.85 GB.
Grouping only amortizes the host's issue: a request-at-a-time loop is
16 layers x 32 requests = 512 rounds of about 20 small ops at the bench's
defaults.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magicdec_tpu_torch.ops.kv_cache import dequant_kv

NEG_INF = -1e30
GROUP = 8  # requests compressed together (the transient's bound, above)


def _avg_pool_1d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """``avg_pool1d(kernel, stride=1, padding=kernel//2,
    count_include_pad=True)`` over the last axis: the window's ``kernel``
    values summed left to right, then divided.  The JAX package differences
    a float32 cumulative sum instead, whose rounding grows with the cache:
    at 8192 rows its sums reach the window's mass (32), so a pooled score
    carries an error near one ulp of 32 (4e-6), about 3e-4 of a mean key's
    head score (4 groups x 32 queries / 8192 keys).  The direct sum keeps
    each score to float32 rounding, in the same order on the card and on
    the CPU."""
    pad = kernel // 2
    xp = F.pad(x, (pad, pad))
    n = x.shape[-1]
    total = xp[..., :n]
    for i in range(1, kernel):
        total = total + xp[..., i:i + n]
    return total / kernel


def _max_pool_1d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Max over a centred window of ``kernel`` columns, -inf past the ends."""
    pad = kernel // 2
    xp = F.pad(x, (pad, pad), value=float("-inf"))
    n = x.shape[-1]
    return torch.stack([xp[..., i:i + n] for i in range(kernel)], dim=0).amax(dim=0)


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest of each row of ``score``, largest first, equal scores
    in index order (``jax.lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def snapkv_compress(q_win, k_cache, v_cache, *, ctx_len: int, window: int, budget: int,
                    kernel_size: int = 5, pooling: str = "avgpool", k_scale=None,
                    v_scale=None, return_indices: bool = False):
    """Select the compressed draft KV set.

    q_win [B, W, Hq, hd]: the roped queries of the last ``window`` prefill
    tokens (positions ctx_len - W .. ctx_len - 1).  k_cache / v_cache
    [B, S, Hkv*hd] with the first ctx_len rows filled, or a quantized cache
    (int8, or int4 packed in head pairs) when ``k_scale`` / ``v_scale``
    [B, Hkv, S] are given.  Returns (dk, dv) [B, budget, Hkv, hd] in the
    dense cache's dtype, or in q_win's dtype for a quantized cache; with
    ``return_indices`` also the selected key indices [B, Hkv, budget - W].
    """
    B, W, Hq, hd = q_win.shape
    quant = k_scale is not None
    Hkv = k_scale.shape[1] if quant else k_cache.shape[2] // hd
    G = Hq // Hkv
    topk = budget - window
    if W != window:
        raise ValueError(f"q_win holds {W} queries, not the window of {window}")
    if ctx_len - window < topk:
        raise ValueError(f"a prefix of {ctx_len} is too short for a draft budget of {budget} "
                         f"with a window of {window}")
    if pooling not in ("avgpool", "maxpool"):
        raise ValueError(f"pooling must be 'avgpool' or 'maxpool', got {pooling!r}")
    pre = ctx_len - W
    dev = q_win.device
    # query i (position pre + i) sees keys j <= pre + i
    col = torch.arange(ctx_len, device=dev)
    row = torch.arange(W, device=dev)
    hidden = col[None, :] > pre + row[:, None]  # [W, ctx]
    pool = _avg_pool_1d if pooling == "avgpool" else _max_pool_1d
    heads = torch.arange(Hkv, device=dev)[None, :, None]
    dks, dvs, idxs = [], [], []
    for b0 in range(0, B, GROUP):
        sl = slice(b0, min(b0 + GROUP, B))
        if quant:
            kb = dequant_kv(k_cache[sl, :ctx_len], k_scale[sl, :, :ctx_len], hd, q_win.dtype)
            vb = dequant_kv(v_cache[sl, :ctx_len], v_scale[sl, :, :ctx_len], hd, q_win.dtype)
        else:
            kb, vb = k_cache[sl, :ctx_len], v_cache[sl, :ctx_len]
        g = kb.shape[0]
        kb = kb.reshape(g, ctx_len, Hkv, hd)
        vb = vb.reshape(g, ctx_len, Hkv, hd)
        qg = q_win[sl].reshape(g, W, Hkv, G, hd).permute(0, 2, 3, 1, 4).to(torch.float32)
        kt = kb.to(torch.float32).permute(0, 2, 3, 1)                 # [g, Hkv, hd, ctx]
        scores = torch.matmul(qg.reshape(g, Hkv, G * W, hd), kt).view(g, Hkv, G, W, ctx_len)
        del kt
        scores.masked_fill_(hidden, NEG_INF)
        mass = torch.softmax(scores, dim=-1)[..., :pre].sum(dim=3)    # [g, Hkv, G, pre]
        del scores
        idx = _top_indices(pool(mass, kernel_size).sum(dim=2), topk)  # [g, Hkv, topk]
        reqs = torch.arange(g, device=dev)[:, None, None]
        for cache, out in ((kb, dks), (vb, dvs)):
            sel = cache[reqs, idx, heads].permute(0, 2, 1, 3)          # [g, topk, Hkv, hd]
            out.append(torch.cat([sel, cache[:, pre:ctx_len]], dim=1))
        idxs.append(idx)
    dk, dv = torch.cat(dks), torch.cat(dvs)
    return (dk, dv, torch.cat(idxs)) if return_indices else (dk, dv)
