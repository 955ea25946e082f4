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
layer's rows (``kernels/append.py``).  A target cache may be int8 with
per-(token, kv head) scales {'ks', 'vs'} (``EngineConfig.kv_quant``): its
new rows are quantized once and the same rows are attended and appended.  The bf16 dense dots are
``torch.matmul`` (the reference leaves them to XLA).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from magicdec_tpu_torch.config import ModelConfig
from magicdec_tpu_torch.kernels.append import append_all_rows_inplace
from magicdec_tpu_torch.ops import attention as attn_ops
from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens
from magicdec_tpu_torch.ops.rope import (apply_rope, apply_rope_cs, rope_cos_sin,
                                         rope_inv_freq)
from magicdec_tpu_torch.ops.streamingllm import stream_update_raw

Params = Dict[str, Any]


def matmul(x: torch.Tensor, w: torch.Tensor, rows_hint: int = 0) -> torch.Tensor:
    """x [..., In] @ w [In, Out].

    ``rows_hint`` (ModelConfig.decode_rows) pads the rows to that count, so
    the autoregressive step (M = B) and the verify pass (M = B * (gamma + 1))
    run one GEMM shape and each row gets the same arithmetic, whatever a
    BLAS picks by M.  The engine leaves it 0: on the H100 the rows come out
    the same without it (``chip_smoke.py`` checks)."""
    if not rows_hint:
        return x @ w
    lead = x.shape[:-1]
    M = math.prod(lead)
    xm = x.reshape(M, x.shape[-1])
    if M < rows_hint:
        xm = torch.cat([xm, xm.new_zeros(rows_hint - M, xm.shape[1])])
    return (xm @ w)[:M].reshape(*lead, w.shape[-1])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 norm, cast to x.dtype, THEN scaled by w (the reference's order)."""
    xf = x.to(torch.float32)
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return norm.to(x.dtype) * w


def _qkv(x, wl, cfg: ModelConfig):
    """RAW (pre-norm) x [B, T, D] -> q [B,T,Hq,hd], k,v [B,T,Hkv,hd] (pre-rope)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_kv_head * hd
    hint = cfg.decode_rows
    xn = rms_norm(x, wl["attn_norm"], cfg.norm_eps)
    if "wqkv" in wl:
        qkv = matmul(xn, wl["wqkv"], hint)
        if wl.get("bqkv") is not None:
            qkv = qkv + wl["bqkv"]
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q, k, v = (matmul(xn, wl[n], hint) for n in ("wq", "wk", "wv"))
        if wl.get("bq") is not None:
            q, k, v = q + wl["bq"], k + wl["bk"], v + wl["bv"]
    return (q.reshape(B, T, cfg.n_head, hd), k.reshape(B, T, cfg.n_kv_head, hd),
            v.reshape(B, T, cfg.n_kv_head, hd))


def _mlp(x, wl, cfg: ModelConfig, residual=None):
    """rms_norm -> silu-gated MLP [+ residual]."""
    hint = cfg.decode_rows
    xn = rms_norm(x, wl["ffn_norm"], cfg.norm_eps)
    if "w13" in wl:
        gu = matmul(xn, wl["w13"], hint)
        Fh = gu.shape[-1] // 2
        gate, up = gu[..., :Fh], gu[..., Fh:]
    else:
        gate, up = matmul(xn, wl["w1"], hint), matmul(xn, wl["w3"], hint)
    y = matmul(F.silu(gate) * up, wl["w2"], hint)
    return y if residual is None else residual + y


def _wo_residual(x, out, wl, cfg: ModelConfig):
    """h = x + attn_out @ wo."""
    B, t = out.shape[:2]
    o = out.reshape(B, t, cfg.n_head * cfg.head_dim)
    return x + matmul(o, wl["wo"], cfg.decode_rows)


def _layer_tail(x, out, wl, cfg: ModelConfig):
    """x + out @ wo, then the FFN block with its residual."""
    h = _wo_residual(x, out, wl, cfg)
    return _mlp(h, wl, cfg, residual=h)


def fuse_exec_params(params: Params, cfg: ModelConfig) -> Params:
    """wq|wk|wv -> wqkv and w1|w3 -> w13, concatenated on the output axis:
    one QKV dot and one gate/up dot per layer.  Bit-identical (each output
    column contracts independently).  Idempotent."""
    L = dict(params["layers"])
    if "wqkv" in L or "w13" in L:
        return params
    L["wqkv"] = torch.cat([L.pop("wq"), L.pop("wk"), L.pop("wv")], dim=-1)
    bq, bk, bv = L.pop("bq", None), L.pop("bk", None), L.pop("bv", None)
    L["bqkv"] = torch.cat([bq, bk, bv], dim=-1) if bq is not None else None
    L["w13"] = torch.cat([L.pop("w1"), L.pop("w3")], dim=-1)
    return dict(params, layers=L)


def _layer(params: Params, l: int) -> Params:
    return {n: t[l] for n, t in params["layers"].items() if t is not None}


def head_logits(params: Params, x_normed, rows_hint: int = 0):
    if params.get("lm_head") is not None:
        return matmul(x_normed, params["lm_head"], rows_hint)
    return matmul(x_normed, params["embed"].T, rows_hint)  # tied embeddings


def head_argmax(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """Final norm + lm head + greedy argmax (lowest index on ties) -> int32."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, x, rows_hint=cfg.decode_rows)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def embed_lookup(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _attn_project(x, wl, cfg, cs_q, cs_k):
    """Pre-norm + projections + rope; cs_k=None leaves k un-roped (the
    StreamingLLM draft prefill stores raw keys)."""
    q, k, v = _qkv(x, wl, cfg)
    q = apply_rope_cs(q, *cs_q)
    if cs_k is not None:
        k = apply_rope_cs(k, *cs_k)
    return q, k, v


def _kv_rows(k, v, caches, prefix=""):
    """The layer's new KV in the cache's at-rest format (the dense cache
    dtype, or int8 data + per-(token, head) scales): these exact rows are
    both the kernel's fresh operands and what the post-loop append writes."""
    sc = caches.get(prefix + "ks")
    if sc is not None:
        kq, ksn = quantize_kv_tokens(k, scale_dtype=sc.dtype)
        vq, vsn = quantize_kv_tokens(v, scale_dtype=sc.dtype)
        return {"k": kq, "v": vq, "ks": ksn, "vs": vsn}
    B, T = k.shape[:2]
    dt = caches[prefix + "k"].dtype
    return {"k": k.reshape(B, T, -1).to(dt), "v": v.reshape(B, T, -1).to(dt)}


def _append_rows(caches, rows, write_pos, prefix=""):
    """One in-place append of every layer's rows {'k','v'} [L, B, T, K]
    (with their scales {'ks','vs'} [L, B, Hkv, T] for an int8 cache)."""
    scales = ((caches[prefix + "ks"], caches[prefix + "vs"], rows["ks"], rows["vs"])
              if "ks" in rows else ())
    append_all_rows_inplace(caches[prefix + "k"], caches[prefix + "v"],
                            rows["k"], rows["v"], write_pos, *scales)
    return caches


def _target_attend(q, k, v, caches, l, base_lens):
    """Attend layer l of the target cache with the layer's new KV as fresh
    operands; return the rows for the post-loop append."""
    rows = _kv_rows(k, v, caches)
    out = attn_ops.attend_cache(q, caches, base_lens, layer=l, fresh=rows)
    return out, rows


def _head(params, cfg, x, head):
    if head == "logits":
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return head_logits(params, x, rows_hint=cfg.decode_rows)
    if head == "none":
        return x
    return head_argmax(params, cfg, x)


def _decode_layers(params, cfg, x, caches, cs, attend_fn):
    """Run every layer; attend_fn(q, k, v, l) -> (attn_out, rows).  Returns
    x and the rows stacked [L, ...] ({'k','v'} [L, B, T, K], and
    {'ks','vs'} [L, B, Hkv, T] for an int8 cache) for the post-loop append."""
    per_layer = []
    for l in range(cfg.n_layer):
        wl = _layer(params, l)
        q, k, v = _attn_project(x, wl, cfg, cs, cs)
        out, rows = attend_fn(q, k, v, l)
        per_layer.append(rows)
        x = _layer_tail(x, out, wl, cfg)
    return x, {n: torch.stack([r[n] for r in per_layer]) for n in per_layer[0]}


def forward_target(params: Params, cfg: ModelConfig, tokens, base_lens, caches,
                   *, head: str = "argmax"):
    """Decode / verify / prefill chunk over the full target cache.

    tokens [B, T]; base_lens [B] int32 = visible cache length before this
    call; caches {'k','v'} [L, B, S, K] (+ {'ks','vs'} [L, B, Hkv, S] for an
    int8 cache), appended in place at base_lens.
    Positions are base_lens + arange(T).  head: 'argmax' | 'logits' | 'none'
    (final hidden states).  Returns (head output, caches).
    """
    T = tokens.shape[1]
    pos = base_lens[:, None] + torch.arange(T, device=tokens.device, dtype=torch.int32)
    cs = rope_cos_sin(pos, rope_inv_freq(cfg, tokens.device))
    x = embed_lookup(params, tokens)
    x, rows = _decode_layers(
        params, cfg, x, caches, cs,
        lambda q, k, v, l: _target_attend(q, k, v, caches, l, base_lens))
    caches = _append_rows(caches, rows, base_lens)
    return _head(params, cfg, x, head), caches


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
    x = embed_lookup(params, tokens)
    for l in range(cfg.n_layer):
        wl = _layer(params, l)
        q, k, v = _attn_project(x, wl, cfg, cs_q, None)
        dk, dv = caches["dk"][l], caches["dv"][l]
        stream_update_raw(dk, dv, k, v, fill, budget=budget, sink=sink)
        k_att = apply_rope_cs(dk[:, :budget].reshape(B, budget, Hkv, hd), *cs_slot)
        out = attn_ops.attend(q, k_att.reshape(B, budget, -1), dv[:, :budget], base)
        x = _layer_tail(x, out, wl, cfg)
    return x, caches


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
                  caches):
    """Draft decode step over the budget-sized draft cache.

    tokens [B, T]; draft_fill [B] = append position and causal base;
    rope_pos [B] = rope position of the first token (slot positions for
    StreamingLLM); caches {'dk','dv'}, appended in place at draft_fill.
    Returns (argmax tokens [B, T] int32, caches).
    """
    T = tokens.shape[1]
    pos = rope_pos[:, None] + torch.arange(T, device=tokens.device, dtype=torch.int32)
    cs = rope_cos_sin(pos, rope_inv_freq(cfg, tokens.device))
    x = embed_lookup(params, tokens)

    def attend_fn(q, k, v, l):
        rows = _kv_rows(k, v, caches, prefix="d")
        out = attn_ops.attend_cache(q, caches, draft_fill, layer=l, prefix="d",
                                    fresh=rows)
        return out, rows

    x, rows = _decode_layers(params, cfg, x, caches, cs, attend_fn)
    caches = _append_rows(caches, rows, draft_fill, prefix="d")
    return head_argmax(params, cfg, x), caches
