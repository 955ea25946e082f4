"""Tensor parallelism on the card (``gpu`` marker; skipped without one):
gloo ranks sharing cuda:0 (``parallel/multihost.py``).

- The vocab-split greedy head at TP 4 of llama-3's 128,256 columns: each
  rank's 32,064 columns of an int8 head, padded to 32,256 with zero
  columns (``sharding.pad_vocab_columns``), run on B6 (routed: Out % 256
  == 0), within ``bf16_limit`` of the plain version; the two-all-reduce
  argmax equals ``torch.argmax`` over the whole row the four shards make,
  also with NaN and +inf written over the padding.
- TP 2 self-speculation at llama-3.2-1b widths over 2 layers (the int8
  cache and the int8 draft copy): spec == AR on every committed token, the
  kernels launched on each rank, B5 and B9 idle.
- NCCL refuses two ranks on one device: the launcher raises first, naming
  ``--dist_backend gloo``.

No JAX here: ``python -m pytest tests/test_torch_sharding_card.py -m gpu
--noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.parallel import multihost

V = 128256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _argmax_rank():
    """One of 4 model ranks: its padded head shard on B6, the vocab-split
    argmax, and the shard's logits for the whole row."""
    import torch.distributed as dist

    from magicdec_tpu_torch import kernels
    from magicdec_tpu_torch import quantization as Q
    from magicdec_tpu_torch.kernels import quant_matmul as QK
    from magicdec_tpu_torch.ops.shard import ModelShard
    from magicdec_tpu_torch.parallel import sharding as S

    mesh = S.make_mesh(1, 4)
    r = mesh.index(("model",))
    gen = torch.Generator(device="cuda").manual_seed(7)  # the same head on every rank
    w = torch.randn(2048, V, generator=gen, device="cuda", dtype=torch.bfloat16) * 0.02
    x = torch.randn(32, 2048, generator=gen, device="cuda", dtype=torch.bfloat16)
    head = S.shard_head(Q.quantize_weight(w, 8), 4, r)
    del w
    shard = ModelShard(4, r, mesh.group(("model",)), V)
    QK.quant_matmul.launches = 0
    local = Q.quant_matmul(x, head)
    plain = QK.quant_matmul(x.cpu(), head.q.cpu(), head.scale.cpu())
    err_ok = bool(((local.float().cpu() - plain.float()).abs()
                   <= kernels.bf16_limit(plain)).all())
    tokens = shard.argmax(local)
    poisoned = local.clone()
    poisoned[:, V // 4:] = float("nan")
    poisoned[::2, V // 4:] = float("inf")
    out = {"rank": dist.get_rank(), "cols": tuple(head.q.shape), "launches":
           QK.quant_matmul.launches, "err_ok": err_ok, "tokens": tokens.cpu().numpy(),
           "poisoned": shard.argmax(poisoned).cpu().numpy(),
           "row": shard.full_logits(local).float().cpu().numpy()}
    return out


@pytest.mark.gpu
def test_vocab_split_argmax_on_padded_b6_shards(cuda):
    ranks = multihost.launch(_argmax_rank, (), 4, backend="gloo", device="cuda")
    full = ranks[0]["row"]
    assert full.shape == (32, V)
    ref = np.argmax(full, axis=-1)
    for r in ranks:
        assert r["cols"] == (2048, 32256) and r["launches"] == 1 and r["err_ok"], r["rank"]
        np.testing.assert_array_equal(r["tokens"], ref)
        np.testing.assert_array_equal(r["poisoned"], ref)
        np.testing.assert_array_equal(r["row"], full)


def _tp_spec_rank():
    """One of 2 model ranks: spec and AR at llama-3.2-1b widths, 2 layers."""
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import ModelConfig
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine
    from magicdec_tpu_torch.kernels import append as AP
    from magicdec_tpu_torch.kernels import decode_attention as DA
    from magicdec_tpu_torch.kernels import prefill_attention as PA
    from magicdec_tpu_torch.kernels import quant_matmul as QK
    from magicdec_tpu_torch.parallel import sharding as S

    cfg = dataclasses.replace(ModelConfig.from_name("llama-3.2-1b"), n_layer=2)
    wrappers = [PA.flash_prefill_attend_quant, DA.flash_decode_attend_quant,
                DA.flash_decode_attend, AP.append_all_rows_inplace_quant,
                AP.append_all_rows_inplace, QK.quant_matmul_fused, QK.quant_matmul,
                QK.quant_layer_tail, QK.quant_mlp]
    for w in wrappers:
        w.launches = 0
    ecfg = EngineConfig(draft_budget=257, max_seq_len=1280, max_gen=24, kv_quant="int8",
                        draft_quant="int8", prefill_chunk_size=512)
    eng = SpecEngine(make_params(cfg, device="cuda"), cfg, ecfg, mesh=S.make_mesh(1, 2))
    prompt = np.random.RandomState(3).randint(0, V, size=(4, 1024)).astype(np.int32)
    _, spec = eng.generate(eng.encode(prompt))
    _, base = eng.generate_baseline(eng.encode_baseline(prompt), max_new=24)
    return {"output": spec["output"].cpu().numpy(), "n": spec["num_committed"].cpu().numpy(),
            "base": base["output"].cpu().numpy(),
            "launches": {w.__name__: w.launches for w in wrappers}}


@pytest.mark.gpu
def test_tp2_spec_equals_autoregressive(cuda):
    ranks = multihost.launch(_tp_spec_rank, (), 2, backend="gloo", device="cuda")
    for r in ranks:
        np.testing.assert_array_equal(r["output"], ranks[0]["output"])
        for b in range(r["output"].shape[0]):
            n = min(int(r["n"][b]), 24)
            np.testing.assert_array_equal(r["output"][b, :n], r["base"][b, :n])
        la = r["launches"]
        assert not la["quant_layer_tail"] and not la["quant_mlp"], la
        assert all(v > 0 for k, v in la.items() if k not in ("quant_layer_tail", "quant_mlp")), la


@pytest.mark.gpu
def test_nccl_two_ranks_on_one_device_refused(cuda):
    if torch.cuda.device_count() > 1:
        pytest.skip("one device: NCCL's refusal needs more ranks than devices")
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        multihost.launch(_argmax_rank, (), 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        multihost.check_backend(None, "cuda", 2)
