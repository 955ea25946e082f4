"""The port's samplers and threefry keys (``ops/prng.py``, ``ops/sampling.py``,
``kernels/sampling.py``'s plain version of S1) against the JAX package's
(``magicdec_tpu/ops/sampling.py``, ``jax.random``) on the same inputs.

- ``PRNGKey``, ``fold_in``, the random bits and the uniforms: bit for bit,
  for several seeds, salts and stream indices, at V = 1000 and on a row of
  128,256 (llama-3's vocabulary).
- ``coupled_gumbel``: within 4 ulp of JAX's at the scale max(|g|, 1).  Its
  two float32 logs are XLA's in JAX and torch's here, which differ in the
  last bit of about a quarter of the entries; an ulp of the inner log
  (near 1) moves g by about 1.2e-7 whatever g is, so the ulp is counted at
  max(|g|, 1).  Determinism and distinct streams as
  tests/test_sampling_spec.py.
- ``get_sampling_logits``: the same kept set and values equal to 1e-6 at
  top_p 0.8, 0.9 and 0.99; ``sample``, ``sampling_argmax_batch`` and
  ``gumbel_sample_tokens`` (with and without top-p): tokens equal to
  JAX's.  A token that could flip on the noise's last bits would show its
  top-two gap in the failure message.
- The frequencies of 4096 stream positions of one 4-token row against its
  softmax (tests/test_sampling_spec.py:70); S1's split plan.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magicdec_tpu.ops import sampling as JS
from magicdec_tpu_torch.kernels import sampling as S1
from magicdec_tpu_torch.ops import prng
from magicdec_tpu_torch.ops import sampling as S

EPS = np.finfo(np.float32).eps
SEED = 1234


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 123, SEED, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), _key_np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed,salt,idx", [(0, 0, 0), (SEED, 3, 1), (123, 77, 4095),
                                          (SEED, 2**31 - 1, 70000)])
def test_fold_in_and_uniform_bits_match_jax(seed, salt, idx):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), salt), idx)
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), salt), idx)
    np.testing.assert_array_equal(tk.numpy(), _key_np(jk))
    np.testing.assert_array_equal(prng.random_bits(tk, (1000,)).numpy(),
                                  np.asarray(jax.random.bits(jk, (1000,))).astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    ju = np.asarray(jax.random.uniform(jk, (1000,), minval=tiny))
    tu = prng.uniform(tk, (1000,), prng.TINY, 1.0).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


def test_uniform_bits_match_jax_on_a_llama3_row():
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 5), 17)
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), 5), 17)
    tiny = float(np.finfo(np.float32).tiny)
    ju = np.asarray(jax.random.uniform(jk, (128256,), minval=tiny))
    tu = prng.uniform(tk, (128256,), prng.TINY, 1.0).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    # the flat index of a 2-D shape counts as JAX's does
    np.testing.assert_array_equal(prng.random_bits(tk, (3, 5)).numpy(),
                                  np.asarray(jax.random.bits(jk, (3, 5))).astype(np.int64))


def _ulps(a, b):
    """|a - b| in float32 ulps at the scale max(|b|, 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (EPS * np.maximum(np.abs(b), 1.0))


@pytest.mark.parametrize("vocab", [1000, 128256])
def test_coupled_gumbel_within_4_ulp_of_jax(vocab):
    salt = np.asarray([0, 7], np.int32)
    idx = np.asarray([[0, 1], [4095, 12]], np.int32)
    if vocab > 1000:
        salt, idx = salt[:1], idx[:1, :1]
    g = S.coupled_gumbel(prng.PRNGKey(SEED), torch.from_numpy(salt), torch.from_numpy(idx), vocab)
    jg = np.asarray(JS.coupled_gumbel(jax.random.PRNGKey(SEED), jnp.asarray(salt),
                                      jnp.asarray(idx), vocab))
    assert g.dtype == torch.float32 and g.shape == jg.shape
    assert _ulps(g.numpy(), jg).max() <= 4


def test_coupled_gumbel_deterministic_and_stream_distinct():
    key = prng.PRNGKey(SEED)
    salt = torch.tensor([0, 1], dtype=torch.int32)
    idx = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32)
    g1 = S.coupled_gumbel(key, salt, idx, 16)
    torch.testing.assert_close(g1, S.coupled_gumbel(key, salt, idx, 16), rtol=0, atol=0)
    assert not torch.allclose(g1[0, 0], g1[0, 1])
    assert not torch.allclose(g1[0, 0], g1[1, 0])
    g3 = S.coupled_gumbel(key, salt, torch.tensor([[1, 0], [1, 1]], dtype=torch.int32), 16)
    torch.testing.assert_close(g3[0, 1], g1[0, 0], rtol=0, atol=0)
    torch.testing.assert_close(g3[1, 0], g1[1, 1], rtol=0, atol=0)


@pytest.mark.parametrize("top_p", [0.8, 0.9, 0.99])
def test_get_sampling_logits_matches_jax(top_p):
    x = np.random.RandomState(0).randn(3, 5, 1000).astype(np.float32) * 3
    got = S.get_sampling_logits(torch.from_numpy(x), top_p, 0.6).numpy()
    want = np.asarray(JS.get_sampling_logits(jnp.asarray(x), top_p, 0.6))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)
    assert 0 < kept.sum(-1).min() and kept.sum(-1).max() < 1000


def _top_two_gap(values):
    s = np.sort(values, axis=-1)
    return s[..., -1] - s[..., -2]


def test_sample_and_argmax_batch_match_jax():
    x = np.random.RandomState(1).randn(6, 500).astype(np.float32) * 2
    for seed in (0, 9):
        got = S.sample(prng.PRNGKey(seed), torch.from_numpy(x)).numpy()
        want = np.asarray(JS.sample(jax.random.PRNGKey(seed), jnp.asarray(x)))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    y = np.random.RandomState(0).randn(4, 3, 10).astype(np.float32)
    y[0, 0, 3] = y[0, 0, 7] = 9.0  # a tie: the lowest index
    got = S.sampling_argmax_batch(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.sampling_argmax_batch(jnp.asarray(y))))
    assert got.dtype == np.int32 and got[0, 0] == 3


@pytest.mark.parametrize("top_p,temperature", [(1.0, 0.6), (0.9, 0.6), (1.0, 1.3)])
def test_gumbel_sample_tokens_matches_jax(top_p, temperature):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 2000).astype(np.float32) * 2
    salt = np.asarray([4, 0, 9], np.int32)
    idx = rng.randint(0, 5000, size=(3, 4)).astype(np.int32)
    got = S.gumbel_sample_tokens(torch.from_numpy(x), prng.PRNGKey(SEED), torch.from_numpy(salt),
                                 torch.from_numpy(idx), temperature=temperature,
                                 top_p=top_p).numpy()
    want = np.asarray(JS.gumbel_sample_tokens(jnp.asarray(x), jax.random.PRNGKey(SEED),
                                              jnp.asarray(salt), jnp.asarray(idx),
                                              temperature=temperature, top_p=top_p))
    g = S.coupled_gumbel(prng.PRNGKey(SEED), torch.from_numpy(salt), torch.from_numpy(idx),
                         2000).numpy()
    gap = _top_two_gap(x / temperature + g)
    np.testing.assert_array_equal(got, want, err_msg=f"top-two gaps {gap[got != want]}")
    assert got.dtype == np.int32


def test_gumbel_sample_matches_categorical_distribution():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    n = 4096
    toks = S.gumbel_sample_tokens(logits[:, None].expand(1, n, 4), prng.PRNGKey(SEED),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.arange(n, dtype=torch.int32)[None], temperature=1.0)
    freq = np.bincount(toks[0].numpy(), minlength=4) / n
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(), atol=0.03)
    top = S.gumbel_sample_tokens(torch.tensor([[[4.0, 3.5, -2.0, -3.0]]]).expand(1, 500, 4),
                                 prng.PRNGKey(SEED), torch.zeros(1, dtype=torch.int32),
                                 torch.arange(500, dtype=torch.int32)[None], temperature=1.0,
                                 top_p=0.9)
    assert set(np.unique(top.numpy())) <= {0, 1}


def test_s1_plain_rows_and_split_plan():
    """S1's plain version: the rows of gumbel_sample_tokens, the launch's row
    count not mattering (a row alone gives its token in the batch); the
    split plan fills the card at few rows and keeps 2048 columns a block."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(5, 3000).astype(np.float32))
    key, salt = prng.PRNGKey(7), torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    idx = torch.tensor([0, 9, 9, 100, 2], dtype=torch.int32)
    rows = S1.gumbel_argmax(x, key, salt, idx, 0.8)
    for r in range(5):
        assert S1.gumbel_argmax(x[r:r + 1], key, salt[r:r + 1], idx[r:r + 1], 0.8)[0] == rows[r]
    assert S1.gumbel_argmax.launches == 0  # CPU tensors: the plain version
    assert S1.split_plan(128, 128256, 132) == 5
    assert S1.split_plan(8, 128256, 132) == 63
    assert S1.split_plan(32, 1000, 132) == 1
