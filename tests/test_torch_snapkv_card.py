"""SnapKV's new shapes on the card (``gpu`` marker; skipped without one).

The observation-window chunk runs the prefill kernels at C = 32 rows (128
query rows at G = 4) near the end of the bench's 8704-row cache: K2q, K2
and B11 at base 8192 (a 64-row tile boundary) and at bases that are not a
multiple of 64 (the straddle and visible-end tiles of
``csrc/prefill_attention_sm90.cu``), each within ``kernels.bf16_limit`` of
its plain version, with and without the window's fresh rows (without them
it must fail).  ``snapkv_compress`` on the card against the same call on
the CPU at the bench's widths (32 query heads, 8 kv heads of 64, a window
of 32, budget 513, an 8224-token prefix in an 8704-row cache): where the two
keep the same key the rows are bit-equal, and a key kept by one only is a
near tie, its float64 score within ``test_torch_snapkv.NEAR_TIE`` (1e-5 of
the head's largest score) of the last kept key's: the card sums the scores
in another order.

No JAX here: ``python -m pytest tests/test_torch_snapkv_card.py -m gpu
--noconftest``.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV
from magicdec_tpu_torch.ops.snapkv import snapkv_compress
from test_torch_kernels import _gpu_close, _gpu_not_close, _rand
from test_torch_kv_int4 import _card_attn_case as int4_case
from test_torch_kv_quant import _card_attn_case as int8_case
from test_torch_snapkv import _assert_near_ties, _head_scores

S, C = 8704, 32
BASES = [8192, 8161, 8100]  # 8161 and 8100: not a multiple of 64
LAYER = 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_prefill_quant_window_chunk_on_card(cuda):
    int8_case(PA.flash_prefill_attend_quant, PA.flash_prefill_attend_quant_plain,
              torch.Generator(device=cuda).manual_seed(32), cuda, S, C, BASES)


@pytest.mark.gpu
def test_prefill_quant4_window_chunk_on_card(cuda):
    int4_case(PA.flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4_plain,
              torch.Generator(device=cuda).manual_seed(33), cuda, S, C, BASES)


@pytest.mark.gpu
def test_prefill_window_chunk_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(34)
    Bc, Hkv, G, hd = len(BASES), 8, 4, 64
    k = _rand(gen, 2, Bc, S, Hkv * hd, device=cuda)
    v = _rand(gen, 2, Bc, S, Hkv * hd, device=cuda)
    q = _rand(gen, Bc, C, Hkv * G, hd, device=cuda)
    kn, vn = (_rand(gen, Bc, C, Hkv * hd, device=cuda) for _ in range(2))
    base = torch.tensor(BASES, dtype=torch.int32, device=cuda)
    for kw in ({}, dict(k_new=kn, v_new=vn)):
        out = PA.flash_prefill_attend(q, k, v, base, layer=LAYER, **kw)
        ref = PA.flash_prefill_attend_plain(q, k, v, base, layer=LAYER, **kw)
        _gpu_close(out, ref)
    _gpu_not_close(PA.flash_prefill_attend(q, k, v, base, layer=LAYER), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_snapkv_compress_on_card_matches_cpu(cuda, fmt):
    assert not torch.backends.cuda.matmul.allow_tf32, "the scores must run in full float32"
    gen = torch.Generator(device=cuda).manual_seed(35)
    Bc, W, Hq, Hkv, hd, ctx, budget = 2, 32, 32, 8, 64, 8224, 513
    q = (torch.randn((Bc, W, Hq, hd), generator=gen, device=cuda) * 0.5).to(torch.bfloat16)
    x = (torch.randn((2, Bc, S, Hkv, hd), generator=gen, device=cuda) * 0.5)
    if fmt == "bf16":
        k, v = (x[i].to(torch.bfloat16).reshape(Bc, S, -1) for i in range(2))
        scales = {}
        keys = k
    else:
        (k, ks), (v, vs) = (KV.quantize_kv_tokens(x[i].to(torch.bfloat16)) for i in range(2))
        scales = dict(k_scale=ks, v_scale=vs)
        keys = KV.dequant_kv(k, ks, hd, torch.bfloat16)
    kw = dict(ctx_len=ctx, window=W, budget=budget, return_indices=True)
    dk, dv, idx = snapkv_compress(q, k, v, **kw, **scales)
    cpu = {n: t.cpu() for n, t in scales.items()}
    cdk, cdv, cidx = snapkv_compress(q.cpu(), k.cpu(), v.cpu(), **kw, **cpu)
    topk = budget - W
    same = (idx.cpu() == cidx).permute(0, 2, 1)  # [B, topk, Hkv]
    agree = float(same.float().mean())
    print(f"snapkv on the card ({fmt}): {agree:.6f} of the kept keys agree with the CPU's")
    assert agree > 0.99
    for got, want in ((dk, cdk), (dv, cdv)):
        got = got.cpu()
        assert torch.equal(got[:, topk:], want[:, topk:])  # the window's own rows
        assert torch.equal(got[:, :topk][same], want[:, :topk][same])
    keys = keys.float().reshape(Bc, S, Hkv, hd).cpu().numpy()
    for b in range(Bc):
        scores = _head_scores(q[b].float().cpu().numpy(), keys[b], ctx)
        _assert_near_ties(scores, idx[b].cpu().numpy(), cidx[b].numpy(), topk)
