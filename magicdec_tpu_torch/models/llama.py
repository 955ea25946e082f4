"""Llama-family decoder passes (counterpart of magicdec_tpu/models/llama.py).

Parameters are a plain dict of tensors in the JAX package's layout
(``convert.py`` moves them across bit for bit):

    embed      [V, D]
    layers.wq [L, D, Hq*hd]  wk/wv [L, D, Hkv*hd]  (fused: wqkv [L, D, ...])
    layers.wo [L, Hq*hd, D]  w1/w3 [L, D, F] (fused: w13 [L, D, 2F])  w2 [L, F, D]
    layers.attn_norm/ffn_norm [L, D]      final_norm [D]
    lm_head    [D, V] (None when tied to embed)

The JAX ``lax.scan`` over layers is a Python loop over the stacked weights.
Target and draft decode passes read the stacked caches ``[L, B, S, K]``
without writing them: each layer attends its new KV as fresh-row operands of
the attention kernel, and ONE in-place append after the loop writes every
layer's rows (``kernels/append.py``; into pool pages through the page
table under paged serving, ``kernels/paged_attention.py``).  A target
cache may be int8, or int4 packed in head pairs, with per-(token, kv head)
scales {'ks', 'vs'}
(``EngineConfig.kv_quant``): its new rows are quantized once and the same
rows are attended and appended.  The bf16 dense dots are
``torch.matmul`` (the reference leaves them to XLA), except on a target
decode or verify pass with ``quantization.set_dense_kernels(True)``, where
they take B15 as the JAX package's do (``cfg.decode_rows`` as the rows
hint).  A weight may be an
int8 or int4 ``quantization.QuantizedWeight`` (the draft's weight copy,
``EngineConfig.draft_quant``, or the target's own under ``bench
--quantize`` and a converted ``-int8.npz`` / ``-int4.npz``, which the draft
then shares): ``matmul`` dispatches on it; with int8 the attention norm
rides the wqkv dot (B4), draft decode passes run each layer's tail as one
B5 call, target decode and verify passes (``decode_rows`` rows) wo with its
residual on B4 and the FFN block on B9, and the head is B6; with int4 every
dot is B4-int4 (the norms run first) and the head B6-int4.  A quantized
embedding ([D, V] int8, ``quantization.quantize_embed``) is gathered a
column a token and serves a tied head through B6.  Every target pass
(``forward_target``, and SnapKV's window chunk and dual-append verify)
runs one layer loop, ``_target_layers``.

Tensor parallelism (``parallel/sharding.py``): a rank's params hold its
heads' columns of wq / wk / wv (fused, the concatenation of its local
columns), w1 / w3's columns, wo / w2's rows and the lm_head's vocab
columns, and their ``"shard"`` entry (``ops.shard.ModelShard``); ``cfg``
holds the local head counts.  wo's and w2's products are then partial
sums, added over the model group before the residual, so B5 (which fuses
across that sum) and the grid-barrier FFN kernels (B9, B15's
``dense_mlp``) are not taken; the head's argmax runs over the vocab split
by two all-reduces and its logits row (sampling, ``head="logits"``) is
gathered whole.  Rows stay padded to ``decode_rows``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import torch
import torch.nn.functional as F

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.config import ModelConfig
from magicdec_tpu_torch.kernels.append import (append_all_rows_inplace, append_rows_inplace,
                                               append_scale_rows_inplace)
from magicdec_tpu_torch.kernels.paged_attention import append_paged_rows_inplace
from magicdec_tpu_torch.ops import attention as attn_ops
from magicdec_tpu_torch.ops import sampling as S
from magicdec_tpu_torch.ops.kv_cache import (is_packed_int4, quantize_kv_tokens,
                                             quantize_kv_tokens_int4)
from magicdec_tpu_torch.ops.norm import rms_norm
from magicdec_tpu_torch.ops.rope import (apply_rope, apply_rope_cs, rope_cos_sin,
                                         rope_inv_freq)
from magicdec_tpu_torch.ops.streamingllm import stream_update_raw

Params = Dict[str, Any]


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., In] @ w [In, Out], dense or a ``QuantizedWeight``."""
    if Q.is_quantized(w):
        return Q.quant_matmul(x, w)
    return x @ w


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [..., N] as [max(M, rows), N]: its M rows, then zero rows.

    A target decode or verify pass runs its residual stream padded to
    ``ModelConfig.decode_rows`` = B * (gamma + 1) rows, once per pass: the
    autoregressive step (M = B) then runs every dot and rms-norm at the
    verify pass's row count, so a row gets the same arithmetic at both,
    whatever cuBLAS or torch's row reduction picks by M (on the H100,
    cuBLAS's w2 dot at B = 4 and 8 and the row mean at B = 2 to 8 give
    other bits otherwise, which breaks the greedy spec == AR contract;
    ``chip_smoke.py``'s row-invariance phase).  Zero rows stay zero through
    every layer, and attention reads the live rows only."""
    xm = x.reshape(-1, x.shape[-1])
    return F.pad(xm, (0, 0, 0, rows - xm.shape[0])) if xm.shape[0] < rows else xm


def _qkv(x, wl, cfg: ModelConfig, B: int, T: int):
    """RAW (pre-norm) x [R, D], R >= B*T (the rows past B*T are padding) ->
    q [B,T,Hq,hd], k,v [B,T,Hkv,hd] (pre-rope) of the first B*T rows."""
    hd = cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_kv_head * hd
    norm = (wl["attn_norm"], cfg.norm_eps)
    if "wqkv" in wl:
        if Q.is_quantized(wl["wqkv"]) and wl.get("bqkv") is None:
            qkv = Q.quant_matmul(x, wl["wqkv"], norm=norm)
        else:
            if Q.is_quantized(wl["wqkv"]):
                qkv = matmul(rms_norm(x, *norm), wl["wqkv"])
            else:
                qkv = Q.dense_matmul(x, wl["wqkv"], norm=norm, rows_hint=cfg.decode_rows)
            if wl.get("bqkv") is not None:
                qkv = qkv + wl["bqkv"]
        qkv = qkv[:B * T]
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        xn = rms_norm(x, *norm)
        q, k, v = (matmul(xn, wl[n])[:B * T] for n in ("wq", "wk", "wv"))
        if wl.get("bq") is not None:
            q, k, v = q + wl["bq"], k + wl["bk"], v + wl["bv"]
    return (q.reshape(B, T, cfg.n_head, hd), k.reshape(B, T, cfg.n_kv_head, hd),
            v.reshape(B, T, cfg.n_kv_head, hd))


def _mlp(x, wl, cfg: ModelConfig, residual=None, tp=None, fused: bool = True):
    """rms_norm -> silu-gated MLP [+ residual].  An int8 w13 takes the norm
    and the gate into its dot and w2 the residual (B4 where routed); a bf16
    w13 on a target decode or verify pass takes B15 where routed
    (``quantization.dense_mlp``, else ``dense_matmul`` pieces).  ``tp``
    (``ops.shard.ModelShard``): w13's columns and w2's rows are this rank's,
    so w2's product is a partial sum, added over the model group before the
    residual; the pieces run unfused (``fused=False``: B9 and B15's
    ``dense_mlp`` are grid-barrier kernels over the whole block), as the
    JAX package's mesh engines fuse nothing."""
    if tp is not None:
        y = tp.all_reduce(_mlp(x, wl, cfg, fused=False))
        return y if residual is None else residual + y
    norm = (wl["ffn_norm"], cfg.norm_eps)
    if "w13" in wl and Q.is_quantized(wl["w13"]):
        y = Q.quant_mlp(x, wl["w13"], wl["w2"], norm, residual=residual) if fused else None
        if y is not None:
            return y
        gated = Q.quant_matmul(x, wl["w13"], norm=norm, gate=True)
        return Q.quant_matmul(gated, wl["w2"], residual=residual)
    if "w13" in wl:
        hint = cfg.decode_rows
        y = (Q.dense_mlp(x, wl["w13"], wl["w2"], norm, residual=residual, rows_hint=hint)
             if fused else None)
        if y is not None:
            return y
        gu = Q.dense_matmul(x, wl["w13"], norm=norm, rows_hint=hint)
        Fh = gu.shape[-1] // 2
        return Q.dense_matmul(F.silu(gu[..., :Fh]) * gu[..., Fh:], wl["w2"],
                              residual=residual, rows_hint=hint)
    xn = rms_norm(x, *norm)
    y = matmul(F.silu(matmul(xn, wl["w1"])) * matmul(xn, wl["w3"]), wl["w2"])
    return y if residual is None else residual + y


def _layer_tail(x, out, wl, cfg: ModelConfig, *, mega: bool = False, tp=None):
    """x [R, D] + out @ wo, then the FFN block with its residual; out
    [B, T, Hq, hd] is the attention output of x's first B*T rows, padded
    with zero rows to R.  An int8 wo adds x in its dot's epilogue.  ``mega``
    (draft decode passes only, as in the JAX package): an int8 layer's
    whole tail as one B5 call where it routes.  ``tp``: wo's rows are this
    rank's heads, so its product is summed over the model group before the
    residual is added (and B5, which fuses across that sum, is not taken)."""
    o = pad_rows(out.reshape(-1, cfg.n_head * cfg.head_dim), x.shape[0])
    if mega and tp is None and Q.is_quantized(wl["wo"]) and "w13" in wl:
        y = Q.quant_layer_tail(o, x, wl["wo"], wl["w13"], wl["w2"],
                               (wl["ffn_norm"], cfg.norm_eps))
        if y is not None:
            return y
    res = x if tp is None else None
    if Q.is_quantized(wl["wo"]):
        h = Q.quant_matmul(o, wl["wo"], residual=res)
    else:
        h = Q.dense_matmul(o, wl["wo"], residual=res, rows_hint=cfg.decode_rows)
    if tp is not None:
        h = x + tp.all_reduce(h)
    return _mlp(h, wl, cfg, residual=h, tp=tp)


def fuse_exec_params(params: Params, cfg: ModelConfig, *, consume: bool = False) -> Params:
    """wq|wk|wv -> wqkv and w1|w3 -> w13, concatenated on the output axis:
    one QKV dot and one gate/up dot per layer.  Bit-identical (each output
    column contracts independently); quantized weights concatenate their
    data and their scales ([..., G, Out]: the groups tile the shared
    contraction axis) and must share bits and group size.  Idempotent.
    ``consume``: the parts are taken out of ``params["layers"]`` itself, so
    a tree that nothing else holds (a rank's fresh shards) frees each
    group's parts once their concatenation exists."""
    L = params["layers"] if consume else dict(params["layers"])
    if "wqkv" in L or "w13" in L:
        return params

    def cat(*ws):
        if any(Q.is_quantized(w) for w in ws):
            w0 = ws[0]
            if not all(Q.is_quantized(w) and (w.bits, w.group_size, w.scale.shape[-2])
                       == (w0.bits, w0.group_size, w0.scale.shape[-2]) for w in ws):
                raise ValueError("fusing quantized weights needs one quantization config")
            return Q.QuantizedWeight(torch.cat([w.q for w in ws], dim=-1),
                                     torch.cat([w.scale for w in ws], dim=-1),
                                     ws[0].bits, ws[0].group_size)
        return torch.cat(ws, dim=-1)

    L["wqkv"] = cat(L.pop("wq"), L.pop("wk"), L.pop("wv"))
    bq, bk, bv = L.pop("bq", None), L.pop("bk", None), L.pop("bv", None)
    L["bqkv"] = torch.cat([bq, bk, bv], dim=-1) if bq is not None else None
    L["w13"] = cat(L.pop("w1"), L.pop("w3"))
    return dict(params, layers=L)


def _layer(params: Params, l: int) -> Params:
    return {n: t[l] for n, t in params["layers"].items() if t is not None}


def head_logits(params: Params, x_normed):
    """The lm head: ``lm_head``, else the tied embedding (a quantized table
    is stored [D, V] already, ``quantization.quantize_embed``).  A
    vocab-split head (params' ``"shard"``) gives the whole row on every
    rank."""
    if params.get("lm_head") is not None:
        y = matmul(x_normed, params["lm_head"])
        tp = params.get("shard")
        return y if tp is None else tp.full_logits(y)
    embed = params["embed"]
    return matmul(x_normed, embed if Q.is_quantized(embed) else embed.T)


def head_argmax(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """Final norm + lm head + greedy argmax (lowest index on ties) -> int32;
    over a vocab-split head, the two all-reduces of ``ModelShard.argmax``."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    tp = params.get("shard")
    if tp is not None and params.get("lm_head") is not None:
        return tp.argmax(matmul(x, params["lm_head"]))
    return torch.argmax(head_logits(params, x), dim=-1).to(torch.int32)


def embed_lookup(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Input embedding rows for tokens [...].  A quantized table
    (``quantization.quantize_embed``, [D, V] int8, a scale per vocab
    column) gives token t as column t times scale[0, t] in float32, then
    ``final_norm``'s dtype, as the JAX package's ``embed_lookup``: the bf16
    table never exists."""
    embed = params["embed"]
    if Q.is_quantized(embed):
        idx = tokens.long()
        x = embed.q.T[idx].to(torch.float32)                  # [..., D]
        s = embed.scale[0][idx].to(torch.float32)             # [...]
        return (x * s[..., None]).to(params["final_norm"].dtype)
    return embed[tokens.long()]


def _attn_project(x, wl, cfg, B, T, cs_q, cs_k):
    """Pre-norm + projections + rope of x [R, D]'s first B*T rows; cs_k=None
    leaves k un-roped (the StreamingLLM draft prefill stores raw keys)."""
    q, k, v = _qkv(x, wl, cfg, B, T)
    q = apply_rope_cs(q, *cs_q)
    if cs_k is not None:
        k = apply_rope_cs(k, *cs_k)
    return q, k, v


def _kv_rows(k, v, caches, prefix=""):
    """The layer's new KV in the cache's at-rest format (the dense cache
    dtype, or int8 data, or int4 packed in head pairs when the cache's rows
    are (Hkv//2)*hd wide, with per-(token, head) scales): these exact rows
    are both the kernel's fresh operands and what the post-loop append
    writes."""
    sc = caches.get(prefix + "ks")
    if sc is not None:
        qz = (quantize_kv_tokens_int4 if is_packed_int4(caches[prefix + "k"], sc, k.shape[-1])
              else quantize_kv_tokens)
        kq, ksn = qz(k, scale_dtype=sc.dtype)
        vq, vsn = qz(v, scale_dtype=sc.dtype)
        return {"k": kq, "v": vq, "ks": ksn, "vs": vsn}
    B, T = k.shape[:2]
    dt = caches[prefix + "k"].dtype
    return {"k": k.reshape(B, T, -1).to(dt), "v": v.reshape(B, T, -1).to(dt)}


def _append_rows(caches, rows, write_pos, prefix=""):
    """One in-place append of every layer's rows {'k','v'} [L, B, T, K]
    (with their scales {'ks','vs'} [L, B, Hkv, T] for an int8 cache); into
    the pages of a page pool through its table when the caches hold one
    (paged serving, B13).  With ``MAGICDEC_PER_ARRAY_APPEND`` set (the JAX
    package's A/B switch, read at each call as the JAX package reads it at
    each trace), a contiguous cache takes one B14 call per array instead of
    the merged K3/K3q launch."""
    scales = ((caches[prefix + "ks"], caches[prefix + "vs"], rows["ks"], rows["vs"])
              if "ks" in rows else ())
    table = caches.get(prefix + "table")
    if table is not None:
        append_paged_rows_inplace(caches[prefix + "k"], caches[prefix + "v"], rows["k"],
                                  rows["v"], write_pos, table, *scales)
    elif os.environ.get("MAGICDEC_PER_ARRAY_APPEND"):
        for n in ("k", "v"):
            append_rows_inplace(caches[prefix + n], rows[n], write_pos)
        if scales:
            for n in ("ks", "vs"):
                append_scale_rows_inplace(caches[prefix + n], rows[n], write_pos)
    else:
        append_all_rows_inplace(caches[prefix + "k"], caches[prefix + "v"],
                                rows["k"], rows["v"], write_pos, *scales)
    return caches


def _target_attend(q, k, v, caches, l, base_lens):
    """Attend layer l of the target cache with the layer's new KV as fresh
    operands; return the rows for the post-loop append."""
    rows = _kv_rows(k, v, caches)
    out = attn_ops.attend_cache(q, caches, base_lens, layer=l, fresh=rows)
    return out, rows


def _head(params, cfg, x, head, B, T, sample=None):
    """The head over x [R, D]; returns its first B*T rows as [B, T, ...].
    ``sample`` (see ``head_sample``) replaces the 'argmax' head's argmax
    with the coupled-Gumbel sample of those rows' logits."""
    if head == "logits" or (head == "argmax" and sample is not None):
        out = head_logits(params, rms_norm(x, params["final_norm"], cfg.norm_eps))
    elif head == "none":
        out = x
    else:
        out = head_argmax(params, cfg, x)
    out = out[:B * T].reshape(B, T, *out.shape[1:])
    if head == "argmax" and sample is not None:
        return S.gumbel_sample_tokens(out, sample["key"], sample["salt"], sample["idx"],
                                      temperature=sample["temperature"],
                                      top_p=sample["top_p"])
    return out


def head_sample(params: Params, cfg: ModelConfig, x, sample) -> torch.Tensor:
    """Final norm + lm head + coupled-Gumbel categorical sample -> int32
    [B, T] for x [B, T, D], the head run over x's rows padded to
    ``cfg.decode_rows`` (``pad_rows``).

    ``sample``: {'key': the key (``ops/prng.py``), 'salt': [B] int32, 'idx':
    [B, T] int32 output-stream indices, 'temperature': float, 'top_p':
    float}.  The shared noise a (request, stream position) is what makes
    speculative sampling exact under the greedy-match acceptance
    (``ops/sampling.py``)."""
    B, T = x.shape[:2]
    return _head(params, cfg, pad_rows(x, cfg.decode_rows), "argmax", B, T, sample)


def _decode_layers(params, cfg, x, B, T, cs, attend_fn, *, mega=False):
    """Run every layer over x [R, D] (the rows past B*T are padding);
    attend_fn(q, k, v, l) -> (attn_out, rows); ``mega`` as in
    ``_layer_tail``.  Returns x and the rows stacked [L, ...] ({'k','v'}
    [L, B, T, K], and {'ks','vs'} [L, B, Hkv, T] for an int8 cache) for the
    post-loop append."""
    per_layer = []
    tp = params.get("shard")
    for l in range(cfg.n_layer):
        wl = _layer(params, l)
        q, k, v = _attn_project(x, wl, cfg, B, T, cs, cs)
        out, rows = attend_fn(q, k, v, l)
        per_layer.append(rows)
        x = _layer_tail(x, out, wl, cfg, mega=mega, tp=tp)
    return x, {n: torch.stack([r[n] for r in per_layer]) for n in per_layer[0]}


def _target_layers(params, cfg, tokens, base_lens, caches, collect=None):
    """Embed tokens [B, T], pad to ``cfg.decode_rows`` and run every layer
    over the target cache at positions base_lens + arange(T), attending the
    layer's new KV as fresh operands; ``collect(l, q, k, v, rows) -> dict``
    adds its tensors (of the live rows) to layer l's rows.  Returns x [R, D]
    and the rows stacked [L, ...].  Every target pass takes this one path, so a
    target row gets the same arithmetic at the verify and at the
    autoregressive step, whichever pass runs the verify."""
    B, T = tokens.shape
    pos = base_lens[:, None] + torch.arange(T, device=tokens.device, dtype=torch.int32)
    cs = rope_cos_sin(pos, rope_inv_freq(cfg, tokens.device))
    x = pad_rows(embed_lookup(params, tokens), cfg.decode_rows)

    def attend_fn(q, k, v, l):
        out, rows = _target_attend(q, k, v, caches, l, base_lens)
        return out, (rows if collect is None else {**rows, **collect(l, q, k, v, rows)})

    return _decode_layers(params, cfg, x, B, T, cs, attend_fn)


def forward_target(params: Params, cfg: ModelConfig, tokens, base_lens, caches,
                   *, head: str = "argmax", sample=None):
    """Decode / verify / prefill chunk over the full target cache.

    tokens [B, T]; base_lens [B] int32 = visible cache length before this
    call; caches {'k','v'} [L, B, S, K] (+ {'ks','vs'} [L, B, Hkv, S] for an
    int8 cache), appended in place at base_lens.
    Positions are base_lens + arange(T).  head: 'argmax' | 'logits' | 'none'
    (final hidden states); ``sample`` (``head_sample``) samples instead of
    the argmax.  ``cfg.decode_rows`` pads the pass's rows to that count
    (``pad_rows``).  Returns (head output, caches).
    """
    B, T = tokens.shape
    x, rows = _target_layers(params, cfg, tokens, base_lens, caches)
    caches = _append_rows(caches, rows, base_lens)
    return _head(params, cfg, x, head, B, T, sample), caches


def forward_verify_snapkv(params: Params, cfg: ModelConfig, tokens, base_lens, draft_fill,
                          caches, *, head: str = "argmax", sample=None):
    """SnapKV self-speculation verify: ``forward_target``'s pass, then a
    dual append.

    The T window tokens' k, v (roped at their real positions) go into the
    target cache at base_lens and, in the draft cache's dtype, into the
    draft cache at draft_fill [B], over the slots the draft speculated
    (the JAX package's ``forward_verify_snapkv``).  The draft rows are the
    live rows' only, never the decode_rows padding.  caches: the target's
    {'k','v'[,'ks','vs','table']} and the draft's {'dk','dv'}; the draft
    cache stays contiguous under paged serving.  ``sample`` as in
    ``forward_target``.  Returns (head output, caches)."""
    B, T = tokens.shape

    def draft_rows(l, q, k, v, rows):
        d = _kv_rows(k, v, caches, prefix="d")
        return {"dk": d["k"], "dv": d["v"]}

    x, rows = _target_layers(params, cfg, tokens, base_lens, caches, collect=draft_rows)
    caches = _append_rows(caches, rows, base_lens)
    caches = _append_rows(caches, {"k": rows["dk"], "v": rows["dv"]}, draft_fill, prefix="d")
    return _head(params, cfg, x, head, B, T, sample), caches


def forward_prefill_snapkv_window(params: Params, cfg: ModelConfig, tokens, base_lens,
                                  caches):
    """The SnapKV observation-window chunk without the compression: the
    target's forward and append of tokens [B, W] at base_lens, collecting
    each layer's roped window queries.

    Returns (x [B, W, D] final hidden states, caches with the window
    appended, qs [L, B, W, Hq*hd]).  The engine then compresses layer by
    layer (``ops.snapkv.snapkv_compress``); the values equal
    ``forward_prefill_snapkv_last``'s, which compresses inside the layer
    loop from the same queries and the same appended rows."""
    B, W = tokens.shape
    x, rows = _target_layers(params, cfg, tokens, base_lens, caches,
                             collect=lambda l, q, k, v, rows: {"q": q.reshape(B, W, -1)})
    caches = _append_rows(caches, rows, base_lens)
    return _head(params, cfg, x, "none", B, W), caches, rows["q"]


def forward_prefill_snapkv_last(params: Params, cfg: ModelConfig, tokens, base_lens, caches,
                                *, ctx_len: int, window: int, budget: int,
                                kernel_size: int = 5, pooling: str = "avgpool",
                                head: str = "none", sample=None):
    """The last SnapKV prefill chunk with the compression inside the layer
    loop (the JAX package's ``forward_prefill_snapkv_last``): the target's
    forward and append of tokens [B, window] at base_lens, and per layer
    the draft set compressed from the layer's cache with the window's rows
    written, filling draft slots [0, budget) of every layer.

    ctx_len: the prefix length after this chunk.  caches: the target's and
    the draft's {'dk','dv'}.  Each layer's compression reads a copy of the
    layer with the window written (the cache itself is appended after the
    loop).  ``sample`` as in ``forward_target``.  Returns (head output,
    caches)."""
    from magicdec_tpu_torch.ops.kv_cache import (append_rows_all_layers,
                                                 append_scale_rows_all_layers)
    from magicdec_tpu_torch.ops.snapkv import snapkv_compress

    B, T = tokens.shape

    def compress(l, q, k, v, rows):
        layer = {}
        for n in ("k", "v"):
            layer[n] = append_rows_all_layers(caches[n][l:l + 1].clone(), rows[n][None],
                                              base_lens)[0]
        for n in ("ks", "vs"):
            if n in rows:
                layer[n] = append_scale_rows_all_layers(caches[n][l:l + 1].clone(),
                                                        rows[n][None], base_lens)[0]
        dk, dv = snapkv_compress(q[:, -window:], layer["k"], layer["v"], ctx_len=ctx_len,
                                 window=window, budget=budget, kernel_size=kernel_size,
                                 pooling=pooling, k_scale=layer.get("ks"),
                                 v_scale=layer.get("vs"))
        return {"dk": dk.reshape(B, budget, -1), "dv": dv.reshape(B, budget, -1)}

    x, rows = _target_layers(params, cfg, tokens, base_lens, caches, collect=compress)
    caches = _append_rows(caches, rows, base_lens)
    caches["dk"][:, :, :budget] = rows["dk"]
    caches["dv"][:, :, :budget] = rows["dv"]
    return _head(params, cfg, x, head, B, T, sample), caches


def forward_streaming_draft_chunk(params: Params, cfg: ModelConfig, tokens,
                                  fill: int, caches, *, budget: int, sink: int):
    """One StreamingLLM draft-prefill chunk: raw-key storage with sink+window
    eviction, attention against the window re-roped at SLOT positions, queries
    roped at real positions while growing and clamped once full.

    tokens [B, C]; fill = min(tokens so far, budget), a host integer;
    caches {'dk','dv'} [L, B, Sd, K], updated in place.  Returns (final
    hidden states, caches): the draft prefill's logits are never read.
    """
    B, C = tokens.shape
    dev = tokens.device
    vis = min(fill + C, budget)
    base = torch.full((B,), vis - C, dtype=torch.int32, device=dev)
    inv_freq = rope_inv_freq(cfg, dev)
    cs_q = rope_cos_sin(base[:, None] + torch.arange(C, device=dev, dtype=torch.int32),
                        inv_freq)
    cs_slot = rope_cos_sin(torch.arange(budget, device=dev)[None], inv_freq)
    hd, Hkv = cfg.head_dim, cfg.n_kv_head
    x = embed_lookup(params, tokens).reshape(B * C, -1)
    for l in range(cfg.n_layer):
        wl = _layer(params, l)
        q, k, v = _attn_project(x, wl, cfg, B, C, cs_q, None)
        dk, dv = caches["dk"][l], caches["dv"][l]
        stream_update_raw(dk, dv, k, v, fill, budget=budget, sink=sink)
        k_att = apply_rope_cs(dk[:, :budget].reshape(B, budget, Hkv, hd), *cs_slot)
        out = attn_ops.attend(q, k_att.reshape(B, budget, -1), dv[:, :budget], base)
        x = _layer_tail(x, out, wl, cfg, tp=params.get("shard"))
    return x.reshape(B, C, -1), caches


def streaming_finalize_draft(cfg: ModelConfig, caches, *, budget: int):
    """Persist the slot-roped draft keys after the last prefill chunk, in
    place, so decode appends roped keys at slot positions."""
    dk = caches["dk"]
    L, B, _, K = dk.shape
    hd = cfg.head_dim
    slot_pos = torch.arange(budget, device=dk.device)[None]
    inv_freq = rope_inv_freq(cfg, dk.device)
    for l in range(L):
        roped = apply_rope(dk[l, :, :budget].reshape(B, budget, K // hd, hd),
                           slot_pos, inv_freq)
        dk[l, :, :budget] = roped.reshape(B, budget, K)
    return caches


def forward_draft(params: Params, cfg: ModelConfig, tokens, draft_fill, rope_pos,
                  caches, *, sample=None):
    """Draft decode step over the budget-sized draft cache.

    tokens [B, T]; draft_fill [B] = append position and causal base;
    rope_pos [B] = rope position of the first token (slot positions for
    StreamingLLM); caches {'dk','dv'}, appended in place at draft_fill.
    Returns (argmax tokens [B, T] int32, or with ``sample`` the
    coupled-Gumbel sample (``head_sample``), caches).
    """
    B, T = tokens.shape
    pos = rope_pos[:, None] + torch.arange(T, device=tokens.device, dtype=torch.int32)
    cs = rope_cos_sin(pos, rope_inv_freq(cfg, tokens.device))
    x = embed_lookup(params, tokens).reshape(B * T, -1)

    def attend_fn(q, k, v, l):
        rows = _kv_rows(k, v, caches, prefix="d")
        out = attn_ops.attend_cache(q, caches, draft_fill, layer=l, prefix="d",
                                    fresh=rows)
        return out, rows

    x, rows = _decode_layers(params, cfg, x, B, T, cs, attend_fn, mega=True)
    caches = _append_rows(caches, rows, draft_fill, prefix="d")
    if sample is not None:
        return _head(params, cfg, x, "argmax", B, T, sample), caches
    return head_argmax(params, cfg, x.reshape(B, T, -1)), caches
