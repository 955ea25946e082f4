"""S1, the coupled-Gumbel sampled head, on the card (``gpu`` marker; skipped
without one).

- S1 against its plain version on the same card tensors at R = 32 and 128
  rows of llama-3's 128,256-entry vocabulary, with the divisor 0.6 and on
  a top-p-filtered input (rows holding -inf): the tokens equal on every
  row whose plain top-two gap (of logits / div + g) is at least 1e-4 (the
  card's logf and torch's may differ in the last bit, which moves g by
  about 1e-7); a wrong reference (every salt + 1) disagrees on most rows.
- A poisoned allocation: NaN and +inf past V in each row's storage
  (a strided [R, V] view) must not be read.
- A row's token does not depend on the rows a launch carries (the split
  plan changes with R); two launches and a CUDA-graph replay agree.
- A tiny config (head dim 64, bf16, vocabulary 4096) on the card: sampled
  self-speculation equals the sampled autoregressive baseline on every
  committed token, with S1 launched by both.

No JAX here: ``python -m pytest tests/test_torch_sampling_card.py -m gpu
--noconftest``.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.kernels import sampling as S1
from magicdec_tpu_torch.ops import prng
from magicdec_tpu_torch.ops.sampling import get_sampling_logits

V = 128256
GAP = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(cuda, R, seed, top_p=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(R, V, generator=gen, device=cuda)
    div = 0.6
    if top_p is not None:
        x, div = get_sampling_logits(x, top_p, 0.6), 1.0
    salt = torch.randint(0, 1000, (R,), generator=gen, device=cuda, dtype=torch.int32)
    idx = torch.randint(0, 20000, (R,), generator=gen, device=cuda, dtype=torch.int32)
    return x, prng.PRNGKey(1234, device=cuda), salt, idx, div


def _gaps(x, key, salt, idx, div):
    g = prng.gumbel(prng.fold_in(prng.fold_in(key, salt), idx), (x.shape[1],))
    top = torch.topk(x / torch.tensor(div, device=x.device) + g, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("R", [32, 128])
@pytest.mark.parametrize("top_p", [None, 0.9])
def test_s1_matches_plain_on_card(cuda, R, top_p):
    x, key, salt, idx, div = _inputs(cuda, R, seed=R, top_p=top_p)
    before = S1.gumbel_argmax.launches
    got = S1.gumbel_argmax(x, key, salt, idx, div)
    torch.cuda.synchronize()
    assert S1.gumbel_argmax.launches == before + 1 and got.dtype == torch.int32
    want = S1.gumbel_argmax_plain(x, key, salt, idx, div)
    gaps = _gaps(x, key, salt, idx, div)
    differ = (got != want).cpu().numpy()
    assert not (differ & (gaps >= GAP)).any(), f"rows {np.flatnonzero(differ)} gaps {gaps}"
    if top_p is not None:
        assert torch.isfinite(x.gather(1, got.long()[:, None])).all()
    wrong = S1.gumbel_argmax_plain(x, key, salt + 1, idx, div)
    assert (got != wrong).float().mean() > 0.9


@pytest.mark.gpu
def test_s1_reads_no_logit_past_v(cuda):
    R = 16
    x, key, salt, idx, div = _inputs(cuda, R, seed=5)
    store = torch.full((R, V + 96), float("nan"), device=cuda)
    store[:, V + 32:] = float("inf")
    store[:, :V] = x
    got = S1.gumbel_argmax(store[:, :V], key, salt, idx, div)
    torch.testing.assert_close(got, S1.gumbel_argmax(x, key, salt, idx, div), rtol=0, atol=0)
    assert (got < V).all()


@pytest.mark.gpu
def test_s1_rows_independent_of_launch_and_graph(cuda):
    R = 64
    x, key, salt, idx, div = _inputs(cuda, R, seed=6)
    rows = S1.gumbel_argmax(x, key, salt, idx, div)
    assert S1.split_plan(R, V, 132) != S1.split_plan(1, V, 132)
    for r in (0, 17, 63):
        alone = S1.gumbel_argmax(x[r:r + 1], key, salt[r:r + 1], idx[r:r + 1], div)
        assert alone.item() == rows[r].item()
    torch.testing.assert_close(S1.gumbel_argmax(x, key, salt, idx, div), rows, rtol=0, atol=0)
    out = {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S1.gumbel_argmax(x, key, salt, idx, div)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out["tok"] = S1.gumbel_argmax(x, key, salt, idx, div)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out["tok"], rows, rtol=0, atol=0)


@pytest.mark.gpu
def test_tiny_sampled_spec_matches_baseline_on_card(cuda):
    from magicdec_tpu_torch.bench import make_params
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config(vocab_size=4096, n_layer=2, n_head=4, n_kv_head=2, dim=256,
                      intermediate_size=512)
    ecfg = EngineConfig(gamma=3, draft_budget=257, max_seq_len=1024, chunk_size=128,
                        sink_size=16, max_gen=32, eot_ids=(-1,), temperature=0.8, top_p=0.9)
    engine = SpecEngine(make_params(cfg, seed=2, device=cuda), cfg, ecfg, device=cuda)
    prompt = np.random.RandomState(0).randint(0, 4096, size=(4, 512))
    key = prng.PRNGKey(7, device=cuda)
    before = S1.gumbel_argmax.launches
    _, spec = engine.generate(engine.encode(prompt, rng=key))
    _, base = engine.generate_baseline(engine.encode_baseline(prompt, rng=key), max_new=32)
    assert S1.gumbel_argmax.launches > before
    out, ref = spec["output"].cpu().numpy(), base["output"].cpu().numpy()
    n = spec["num_committed"].cpu().numpy()
    assert n.max() >= 32
    for b in range(4):
        m = min(int(n[b]), 32)
        np.testing.assert_array_equal(out[b, :m], ref[b, :m], err_msg=f"request {b}")
