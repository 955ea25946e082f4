"""On the card (``gpu`` marker, skipped without one): the int8 / int4 weight
kernels at the shapes the quantized TARGET gives them (``bench --quantize``,
a converted ``-int8.npz`` / ``-int4.npz``), M = ``decode_rows`` = 128 rows
(B=32, gamma 3) at llama-3.2-1b widths, each against its plain version
within ``kernels.bf16_limit``, with a deliberately wrong reference that must
fail the bound:

- B4: wqkv with the attention norm [2048, 3072], wo with the residual
  [2048, 2048]; B9: the FFN block (F = 8192) at exactly 128 rows, the last
  row count of ``ffn_sm90.cu``'s ``mma.sync`` core; B6: the head [2048,
  128256], and the tied head over ``quantize_embed``'s [D, V] table, routed
  by ``quantization.quant_matmul``;
- B4-int4 (wqkv, wo + residual, w13 + gate, w2 + residual) and B6-int4 (the
  head) at M = 128;
- two launches bit-equal at M = 128 (the padded AR step and the verify
  take the same launch);
- the quantized target's ``forward_target`` (two layers, a 4-token verify
  window of 32 requests over an int8 cache at decode_rows 128) on the card
  against the same function on the CPU (the plain versions): hidden states
  and logits within ``bf16_limit``, and the head's tokens equal wherever
  the CPU's two best logits are further apart than that bound (elsewhere
  two bf16 logits tie within rounding, and either token is the function's
  answer).

    python -m pytest tests/test_torch_quant.py tests/test_torch_quantized_target_card.py \\
        -m gpu --noconftest
"""

import dataclasses

import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import quant_matmul as QK

M = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _check(run, plain, wrong):
    out, ref = run(), plain()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _outside(out, ref) == 0
    assert _outside(wrong(), ref) > 0
    assert torch.equal(run(), out)  # two launches, the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("kind,In,Out", [("b4_norm", 2048, 3072), ("b4_residual", 2048, 2048),
                                         ("b6", 2048, 128256)],
                         ids=["wqkv_norm", "wo_residual", "head"])
def test_int8_target_dots_at_128_rows_on_card(cuda, kind, In, Out):
    from test_torch_quant import _b4_b6_case

    _check(*_b4_b6_case(kind, M, In, Out, cuda, 11))


@pytest.mark.gpu
def test_b9_target_ffn_at_128_rows_on_card(cuda):
    from test_torch_quant import _ffn_case

    _check(*_ffn_case("b9", M, cuda, 12))


@pytest.mark.gpu
def test_tied_quantized_embed_head_at_128_rows_on_card(cuda):
    """``head_logits`` over ``quantize_embed``'s [D, V] table routes to B6
    at 128 rows: within the bound of the plain version, and of the bf16
    product with the dequantized table; the scales rolled by one column
    fail it."""
    from magicdec_tpu_torch.models import llama as TM

    gen = torch.Generator(device=cuda).manual_seed(13)
    embed = torch.randn((128256, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    eq = Q.quantize_embed(embed)
    assert tuple(eq.q.shape) == (2048, 128256)
    x = (torch.randn((M, 2048), generator=gen, device=cuda) * 0.05).to(torch.bfloat16)
    q, s = eq.q, eq.scale
    launches = QK.quant_matmul.launches
    _check(lambda: TM.head_logits({"embed": eq, "lm_head": None}, x),
           lambda: QK.quant_matmul_plain(x, q, s),
           lambda: QK.quant_matmul_plain(x, q, s.roll(1, -1)))
    assert QK.quant_matmul.launches == launches + 2  # _check runs it twice
    deq = Q.dequantize_weight(eq)
    assert _outside(TM.head_logits({"embed": eq, "lm_head": None}, x), x @ deq) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,In,Out", [("none", 2048, 3072), ("residual", 2048, 2048),
                                         ("gate", 2048, 16384), ("residual", 8192, 2048)],
                         ids=["wqkv", "wo_residual", "w13_gate", "w2_residual"])
def test_int4_target_dots_at_128_rows_on_card(cuda, kind, In, Out):
    from test_torch_weight_int4 import _b4_int4_case

    _check(*_b4_int4_case(kind, M, In, Out, 128, cuda, 14))


@pytest.mark.gpu
def test_b6_int4_target_head_at_128_rows_on_card(cuda):
    from test_torch_weight_int4 import _card_weight

    gen = torch.Generator(device=cuda).manual_seed(15)
    q, s = _card_weight(gen, 2048, 128256, cuda)
    x = torch.randn((M, 2048), generator=gen, device=cuda).to(torch.bfloat16)
    _check(lambda: QK.quant_matmul_int4(x, q, s), lambda: QK.quant_matmul_int4_plain(x, q, s),
           lambda: QK.quant_matmul_int4_plain(x, q, s.roll(1, -1)))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_forward_target_on_card_matches_cpu(cuda, bits):
    from magicdec_tpu_torch.bench import make_params_quantized
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.engine import _to_device
    from magicdec_tpu_torch.models import llama as TM
    from magicdec_tpu_torch.ops.kv_cache import quantize_kv_tokens

    B, T, S, P = 32, 4, 640, 512
    # two layers, and a 32768-token vocab so that the CPU's head stays quick
    cfg = dataclasses.replace(ModelConfig.from_name("llama-3.2-1b"), n_layer=2,
                              vocab_size=32768, decode_rows=B * T)
    cpu = torch.device("cpu")
    params = make_params_quantized(cfg, bits, seed=3, device=cpu)
    gen = torch.Generator().manual_seed(4)
    Hkv, hd = cfg.n_kv_head, cfg.head_dim
    caches = {}
    for n in "kv":
        x = torch.randn((cfg.n_layer, B, S, Hkv, hd), generator=gen).to(torch.bfloat16)
        qs = [quantize_kv_tokens(x[l]) for l in range(cfg.n_layer)]
        caches[n] = torch.stack([q.reshape(B, S, Hkv * hd) for q, _ in qs])
        caches[n + "s"] = torch.stack([s for _, s in qs])
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, dtype=torch.int32)
    lens = torch.full((B,), P, dtype=torch.int32)

    def run(dev):
        p, c = _to_device(params, dev), {n: t.to(dev) for n, t in caches.items()}
        x, _ = TM.forward_target(p, cfg, tokens.to(dev), lens.to(dev), c, head="none")
        xn = TM.rms_norm(x, p["final_norm"], cfg.norm_eps)
        return x.cpu(), TM.head_logits(p, xn.reshape(B * T, -1)).float().cpu()

    launches = {f: getattr(QK, f).launches for f in ("quant_matmul_fused", "quant_mlp",
                                                      "quant_matmul", "quant_matmul_fused_int4",
                                                      "quant_matmul_int4")}
    x_card, logits_card = run(cuda)
    ran = {f: getattr(QK, f).launches - n for f, n in launches.items()}
    want = (["quant_matmul_fused", "quant_mlp", "quant_matmul"] if bits == 8
            else ["quant_matmul_fused_int4", "quant_matmul_int4"])
    assert all(ran[f] > 0 for f in want) and not any(ran[f] for f in ran if f not in want), ran
    x_cpu, logits_cpu = run(cpu)
    assert torch.isfinite(x_card.float()).all()
    assert _outside(x_card, x_cpu) == 0
    assert _outside(logits_card, logits_cpu) == 0
    top2 = logits_cpu.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > bf16_limit(logits_cpu).amax(-1)
    assert int(clear.sum()) >= B * T // 4, int(clear.sum())
    assert torch.equal(logits_card.argmax(-1)[clear], logits_cpu.argmax(-1)[clear])
