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
- the 128-row core (``csrc/quant_matmul_m128_sm90.cu``, every B4, B6 and
  B4-int4 call of 65 to 256 rows) at llama-3.2-1b and llama-3.1-8b widths
  (D 4096, F 14336, wqkv 4096 -> 6144, the head 4096 -> 128256): int8 one
  scale a column (wqkv + norm, wo + residual, the head), group-wise int8
  and int4 (group 128: wqkv, wo, w13 + gate, w2 + residual), each within
  the bound of its plain version with a wrong reference failing it, every
  entry of a NaN-filled ``out`` written, two launches and a CUDA-graph
  replay bit-equal, one kernel launch a call under torch.profiler and
  counted on the wrapper's ``m128_launches``; a row's bits the same at
  every M the core serves (65 to 256); B9 and B6-int4 at 8B widths;
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


# -- the 128-row core: 1B and 8B widths ------------------------------------------

# (format, epilogue, In, Out): the quantized target's dots at llama-3.2-1b
# and llama-3.1-8b widths
M128_CASES = [(f, k, *dims) for f, k, dims in (
    ("int8", "norm", (2048, 3072)), ("int8", "residual", (2048, 2048)),
    ("int8", "head", (2048, 128256)),
    ("int8g", "norm", (2048, 3072)), ("int8g", "norm_gate", (2048, 16384)),
    ("int8g", "residual", (8192, 2048)),
    ("int4", "none", (2048, 3072)), ("int4", "residual", (2048, 2048)),
    ("int4", "gate", (2048, 16384)), ("int4", "residual", (8192, 2048)),
    ("int8", "norm", (4096, 6144)), ("int8", "residual", (4096, 4096)),
    ("int8", "head", (4096, 128256)),
    ("int8g", "norm", (4096, 6144)), ("int8g", "residual", (4096, 4096)),
    ("int8g", "norm_gate", (4096, 28672)), ("int8g", "residual", (14336, 4096)),
    ("int4", "none", (4096, 6144)), ("int4", "residual", (4096, 4096)),
    ("int4", "gate", (4096, 28672)), ("int4", "residual", (14336, 4096)))]


def _m128_operands(fmt, kind, In, Out, device, seed, M=M):
    """(x, q, scale, kw) of one dot on the 128-row core: int8 one scale a
    column, group-wise int8 or int4 (group 128), kw the epilogue's keyword
    arguments (norm_w, gate, res)."""
    from test_torch_weight_int4 import _card_weight as _card_weight4

    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((M, In), generator=gen, device=device)
         * (3.0 if kind.startswith("norm") else 1.0)).to(torch.bfloat16)
    res = torch.randn((M, Out), generator=gen, device=device).to(torch.bfloat16)
    nw = (torch.rand(In, generator=gen, device=device) + 0.5).to(torch.bfloat16)
    if fmt == "int4":
        q, s = _card_weight4(gen, In, Out, device, 128)
    else:
        w = torch.randn((In, Out), generator=gen, device=device) * In ** -0.5
        qw = Q.quantize_weight(w, bits=8, group_size=128 if fmt == "int8g" else None,
                               reciprocal=True)
        q, s = qw.q, qw.scale
    kw = {"none": {}, "head": {}, "gate": dict(gate=True), "residual": dict(res=res),
          "norm": dict(norm_w=nw), "norm_gate": dict(norm_w=nw, gate=True)}[kind]
    return x, q, s, kw


def _m128_fns(fmt, kind):
    """(wrapper, plain) of a dot: B4-int4, B6 (the head) or B4."""
    if fmt == "int4":
        return QK.quant_matmul_fused_int4, QK.quant_matmul_fused_int4_plain
    if kind == "head":
        return QK.quant_matmul, QK.quant_matmul_plain
    return QK.quant_matmul_fused, QK.quant_matmul_fused_plain


def _m128_case(fmt, kind, In, Out, device, seed):
    """(wrapper, run, plain, wrong) of one dot at M rows on the 128-row
    core; wrong drops the norm or the residual, shifts the group scales by
    one group (int4 without a residual) or rolls the head's scales by one
    column."""
    x, q, s, kw = _m128_operands(fmt, kind, In, Out, device, seed)
    fn, plain = _m128_fns(fmt, kind)
    if kind == "head":
        wrong = lambda: plain(x, q, s.roll(1, -1))  # noqa: E731
    elif fmt == "int4" and kind != "residual":
        wrong = lambda: plain(x, q, s.roll(1, 0), **kw)  # noqa: E731
    else:  # without the norm or the residual
        wrong = lambda: plain(x, q, s, gate=kw.get("gate", False))  # noqa: E731
    return fn, lambda: fn(x, q, s, **kw), lambda: plain(x, q, s, **kw), wrong


def _graph_output(run):
    """run() captured in a CUDA graph (after a warm call on a side stream),
    replayed twice: the captured output after each replay."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = run()
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(captured.clone())
    return outs


def _one_launch(run):
    """torch.profiler's kernel launches of one run() (short spin kernels
    around it, not counted: the profiler now and then loses a run's first or
    last event); three tries."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            run()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "spin" not in e.key
                 for _ in range(e.count)]
        if names:
            break
    return names


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,kind,In,Out", M128_CASES,
                         ids=[f"{f}-{k}-{i}x{o}" for f, k, i, o in M128_CASES])
def test_m128_core_at_128_rows_on_card(cuda, fmt, kind, In, Out, monkeypatch):
    """Each dot of the quantized target at decode_rows = 128 on the 128-row
    core: within bf16_limit of its plain version, the wrong reference
    outside it, every entry of a NaN-filled output written, two launches
    and a graph replay bit-equal, one launch of ``qmm_m128_kernel`` a call,
    counted on ``m128_launches``."""
    wrapper, run, plain, wrong = _m128_case(fmt, kind, In, Out, cuda, In + Out)
    ref = plain()
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: empty(*a, **k).fill_(float("nan")))
    launches = (wrapper.launches, wrapper.m128_launches)
    out = run()
    monkeypatch.setattr(torch, "empty", empty)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.m128_launches) == (launches[0] + 1, launches[1] + 1)
    assert torch.isfinite(out).all()
    assert _outside(out, ref) == 0
    assert _outside(wrong(), ref) > 0
    assert torch.equal(run(), out)
    assert all(torch.equal(o, out) for o in _graph_output(run))
    names = _one_launch(run)
    assert len(names) == 1 and "qmm_m128_kernel" in names[0], names


@pytest.mark.gpu
def test_m128_cluster_table_is_the_cards_on_card(cuda):
    """``M128_CLUSTERS``, the residency the 128-row core's split plan
    assumes, is the card's for every format and split (the grid's width is
    read from the card; a table that differs costs time, not bits)."""
    from magicdec_tpu_torch.kernels import build

    got = {(fmt, split): build.library().md_quant_matmul_m128_resident(fmt, split)
           for fmt in range(3) for split in range(1, 9)}
    assert got == {(fmt, split): QK.M128_CLUSTERS[split] for fmt, split in got}, got


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,kind,In,Out", [("int8", "norm", 2048, 3072),
                                             ("int8g", "norm_gate", 2048, 16384),
                                             ("int4", "residual", 8192, 2048)])
def test_m128_core_rows_equal_across_m_on_card(cuda, fmt, kind, In, Out):
    """A row's bits do not depend on the rows beside it on the 128-row
    core: the first rows of a 256-row call (two passes) equal calls at 65,
    100, 128 and 200 rows."""
    x, q, s, kw = _m128_operands(fmt, kind, In, Out, cuda, 7, M=256)
    fn, _ = _m128_fns(fmt, kind)
    full = fn(x, q, s, **kw)
    for rows in (65, 100, 128, 200):
        cut = {k: v[:rows] if k == "res" else v for k, v in kw.items()}
        assert torch.equal(fn(x[:rows], q, s, **cut), full[:rows]), rows


@pytest.mark.gpu
def test_b9_and_b6_int4_at_8b_widths_on_card(cuda):
    """B9 (the FFN block, D 4096, F 14336) and B6-int4 (the head 4096 ->
    128256) at 128 rows, the two of the quantized 8B target's dots that do
    not run on the 128-row core."""
    from test_torch_quant import _ffn_case
    from test_torch_weight_int4 import _card_weight as _card_weight4

    _check(*_ffn_case("b9", M, cuda, 16, K=4096, F=14336))
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, s = _card_weight4(gen, 4096, 128256, cuda)
    x = torch.randn((M, 4096), generator=gen, device=cuda).to(torch.bfloat16)
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
