"""The port's int4 target KV cache (``EngineConfig.kv_quant="int4"``, the
bench's ``--kv_quant int4``): kv heads packed in pairs into int8 rows of
(Hkv//2)*hd bytes, with the int8 path's f32 per-(token, kv head) scales.

On the CPU, against the JAX package: the int4 KV ops bit for bit; the plain
versions of B10 (decode) and B11 (prefill) against its Pallas kernels in
interpret mode; K3q's plain version on packed rows; the target pass over an
int4 cache; the bench's metric tag; conversion (the engine's tokens are in
tests/test_torch_int4_engine.py).  On the card (``gpu`` marker,
skipped without one): B10, B11 and K3q at the packed width against their
plain versions; B10's window ≡ step, poisoned-cache, determinism and
graph-replay checks (the helpers of tests/test_torch_kv_quant.py).

Tolerances.  Packing, unpacking, quantization, dequantization and the append
are exact.  JAX's jitted passes quantize with x * f32(1/7) where the op and
the port divide by 7 (XLA's rewrite under jit): one f32 ulp in some scales,
and then an int4 value within rounding of a .5 tie may round the other way.
Attention on the CPU: atol = rtol = 2e-5 in float32 (the kernels apply the
k scale to the score and the v scale to p, the plain versions dequantize
first).  The target pass: 1e-4 (as the dense pass).  On the card, in bf16:
within ``kernels.bf16_limit``; the kernel without the window's fresh rows,
and a reference with the nibble planes swapped, must fail it.

The JAX package is imported inside the CPU tests only:
``python -m pytest tests/test_torch_kv_int4.py -m gpu --noconftest`` runs
the card's tests where JAX is absent.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import bench
from magicdec_tpu_torch.kernels import append as AP
from magicdec_tpu_torch.kernels import bf16_limit
from magicdec_tpu_torch.kernels import decode_attention as DA
from magicdec_tpu_torch.kernels import prefill_attention as PA
from magicdec_tpu_torch.ops import kv_cache as KV

TOL = dict(atol=2e-5, rtol=2e-5)
L, B, HKV, HD = 2, 4, 2, 64
KP = (HKV // 2) * HD  # packed row width
LAYER = 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- int4 KV ops vs the JAX package, bit for bit ------------------------------


def test_pack_unpack_int4_heads_match_jax():
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(0)
    q = rng.randint(-7, 8, (3, 5, 4, 16)).astype(np.int8)
    packed = KV.pack_int4_heads(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and packed.shape == (3, 5, 32)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jkv.pack_int4_heads(jnp.asarray(q))))
    # every byte value unpacks as the JAX package unpacks it
    every = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    np.testing.assert_array_equal(KV.unpack_int4_heads(torch.from_numpy(every), 64).numpy(),
                                  np.asarray(jkv.unpack_int4_heads(jnp.asarray(every), 64)))
    np.testing.assert_array_equal(KV.unpack_int4_heads(packed, 16).numpy(), q)
    with pytest.raises(ValueError, match="even kv-head"):
        KV.pack_int4_heads(torch.zeros(2, 3, 16, dtype=torch.int8))


def test_quantize_kv_tokens_int4_matches_jax():
    """Bit for bit against the JAX op; under jax.jit the division by 7
    becomes a multiply by f32(1/7) (one ulp in some scales)."""
    import jax
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 4, 16) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero head: the 1e-8 clamp
    # amax 7 gives scale 1: x.5 values are exact ties (round half to even)
    x[1, 3, 0] = np.concatenate([[7.0], np.arange(15) * 0.5 - 3.5])
    x[1, 3, 1] = -x[1, 3, 0]
    jq, js = jkv.quantize_kv_tokens_int4(jnp.asarray(x))
    tq, ts = KV.quantize_kv_tokens_int4(torch.from_numpy(x))
    assert tq.shape == (2, 5, 32) and ts.shape == (2, 4, 5) and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    vals = KV.unpack_int4_heads(tq, 16).reshape(2, 5, 4, 16)
    np.testing.assert_array_equal(vals[1, 3, 0, 1:].numpy(), np.round(np.arange(15) * 0.5 - 3.5))
    assert (vals[0, 1, 2] == 0).all() and vals.abs().max() <= 7
    _, js_jit = jax.jit(jkv.quantize_kv_tokens_int4)(jnp.asarray(x))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js_jit), rtol=2 ** -23, atol=0)


def test_dequant_kv_detects_the_int4_layout():
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    rng = np.random.RandomState(2)
    packed = rng.randint(-128, 128, (3, 40, KP)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, (3, HKV, 40)).astype(np.float32)
    ref = jkv.dequant_kv(jnp.asarray(packed), jnp.asarray(s), HD)
    got = KV.dequant_kv(*_t(packed, s), HD)
    assert got.shape == (3, 40, HKV * HD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- plain versions of B10, B11 (and K3q on packed rows) vs Pallas ------------


def _int4_caches(rng, S, base, T):
    """Packed int4 caches [L, B, S, KP] with f32 scales [L, B, Hkv, S]
    (dequantized values about unit scale), holding garbage past each
    request's visible rows (base + T): packed bytes of +-7 pairs with scales
    1e3, never to be read."""
    k = rng.randint(-128, 128, (L, B, S, KP)).astype(np.int8)
    v = rng.randint(-128, 128, (L, B, S, KP)).astype(np.int8)
    ks = rng.uniform(0.1, 0.2, (L, B, HKV, S)).astype(np.float32)
    vs = rng.uniform(0.1, 0.2, (L, B, HKV, S)).astype(np.float32)
    for b, n in enumerate(base):
        k[:, b, n + T:], v[:, b, n + T:] = 0x77, -0x77
        ks[:, b, :, n + T:] = vs[:, b, :, n + T:] = 1e3
    return k, v, ks, vs


def _fresh(rng, T):
    """A window's rows as the model makes them: quantize_kv_tokens_int4 of
    unit-scale values (packed [B, T, KP], f32 scales [B, Hkv, T])."""
    x = rng.randn(2, B, T, HKV, HD).astype(np.float32)
    kn, ksn = KV.quantize_kv_tokens_int4(torch.from_numpy(x[0]))
    vn, vsn = KV.quantize_kv_tokens_int4(torch.from_numpy(x[1]))
    return kn.numpy(), vn.numpy(), ksn.numpy(), vsn.numpy()


def _attn_case(jfn, tfn, rng, S, G, T, base, fresh, **jkw):
    import jax.numpy as jnp

    k, v, ks, vs = _int4_caches(rng, S, base, 0 if fresh else T)
    q = rng.randn(B, T, HKV * G, HD).astype(np.float32)
    fresh_ops = dict(zip(("k_new", "v_new", "ks_new", "vs_new"), _fresh(rng, T)))
    kw_j = {n: jnp.asarray(a) for n, a in fresh_ops.items()} if fresh else {}
    ref = jfn(*(jnp.asarray(a) for a in (q, k, ks, v, vs, base)), layer=LAYER,
              interpret=True, **jkw, **kw_j)
    kw_t = {n: torch.from_numpy(a) for n, a in fresh_ops.items()} if fresh else {}
    out = tfn(*_t(q, k, ks, v, vs, base), layer=LAYER, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
@pytest.mark.parametrize("T", [1, 4])
def test_decode_quant4_plain_matches_pallas(T, fresh):
    from magicdec_tpu.ops.pallas.decode_attention import flash_decode_attend_quant4

    S = 256
    base = np.array([17, 100, 200, S - T], np.int32)
    _attn_case(flash_decode_attend_quant4, DA.flash_decode_attend_quant4,
               np.random.RandomState(10 + T), S, 2, T, base, fresh, block_s=128)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "cached"])
def test_prefill_quant4_plain_matches_pallas(fresh):
    from magicdec_tpu.ops.pallas.prefill_attention import flash_prefill_attend_quant4

    S, C = 256, 64  # G*C = 128: the Pallas kernel's row block
    base = np.array([0, 64, 100, 192], np.int32)
    _attn_case(flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4,
               np.random.RandomState(20), S, 2, C, base, fresh, block_s=128, block_r=128)


@pytest.mark.parametrize("T", [1, 4])
def test_append_quant_packed_rows_match_pallas_bitwise(T):
    """K3q appends packed int4 rows like int8 ones: the row width comes from
    the cache, the head count from the scales."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv

    S = 128
    rng = np.random.RandomState(30 + T)
    ck, cv, rk, rv = (rng.randint(-128, 128, shape).astype(np.int8)
                      for shape in [(L, B, S, KP)] * 2 + [(L, B, T, KP)] * 2)
    sk, sv, srk, srv = (rng.rand(*shape).astype(np.float32)
                        for shape in [(L, B, HKV, S)] * 2 + [(L, B, HKV, T)] * 2)
    pos = np.array([0, 7, 100, S - T], np.int32)
    ref = jkv.append_all_rows_inplace(*(jnp.asarray(a) for a in (ck, cv, rk, rv, pos,
                                                                  sk, sv, srk, srv)),
                                      interpret=True)
    out = AP.append_all_rows_inplace(*_t(ck, cv, rk, rv, pos, sk, sv, srk, srv))
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attend_cache_routes_packed_caches_to_the_int4_kernels(monkeypatch):
    """A cache whose rows are (Hkv//2)*hd wide, Hkv from the scales, takes
    B10 (T <= 16) or B11; an int8 cache of the same scales K1q or K2q."""
    from magicdec_tpu_torch.ops import attention as attn_ops

    seen = []
    for mod, names in ((DA, ("flash_decode_attend_quant", "flash_decode_attend_quant4")),
                       (PA, ("flash_prefill_attend_quant", "flash_prefill_attend_quant4"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw: seen.append(_n))
    s = torch.zeros(1, 1, 4, 32)
    for width in (2 * HD, 4 * HD):
        caches = {"k": torch.zeros(1, 1, 32, width, dtype=torch.int8), "ks": s, "vs": s}
        caches["v"] = caches["k"]
        for T in (4, 32):
            attn_ops.attend_cache(torch.zeros(1, T, 8, HD), caches, torch.zeros(1), layer=0)
    assert seen == ["flash_decode_attend_quant4", "flash_prefill_attend_quant4",
                    "flash_decode_attend_quant", "flash_prefill_attend_quant"]


# -- model pass and engine vs the JAX package -------------------------------


def test_forward_target_int4_cache_matches_jax():
    """A 32-token prefill chunk, then a verify (T=4) and a decode (T=1)
    window at ragged lengths, over int4 caches, each window from the same
    caches (the JAX pass's, moved across bit for bit): hidden states and
    logits to 1e-4, tokens exactly; the appended scales to 1e-5 as the int8
    test holds them (the two packages' k and v differ in the last bits
    before quantization, and the jit scales by the reciprocal of 7), and the
    packed values to one int4 step in at most 1% of the entries."""
    import jax.numpy as jnp
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy
    from magicdec_tpu_torch.models import llama as TM
    from test_torch_model import JCFG, TCFG, _both_params

    rng = np.random.RandomState(3)
    jp, tp = _both_params(True)
    Bm, S = 2, 96
    kp = (JCFG.n_kv_head // 2) * JCFG.head_dim
    caches = {"k": np.zeros((JCFG.n_layer, Bm, S, kp), np.int8),
              "ks": np.zeros((JCFG.n_layer, Bm, JCFG.n_kv_head, S), np.float32)}
    caches["v"], caches["vs"] = caches["k"].copy(), caches["ks"].copy()
    for T, base, head in ((32, [0, 0], "none"), (4, [32, 20], "logits"),
                          (1, [36, 24], "logits")):
        tokens = rng.randint(0, JCFG.vocab_size, size=(Bm, T)).astype(np.int32)
        base = np.array(base, np.int32)
        yj, jc = JM.forward_target(jp, JCFG, jnp.asarray(tokens), jnp.asarray(base),
                                   {n: jnp.asarray(a) for n, a in caches.items()}, head=head)
        yt, tc = TM.forward_target(tp, TCFG, torch.from_numpy(tokens),
                                   torch.from_numpy(base), caches_from_jax(caches), head=head)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
        if head == "logits":
            np.testing.assert_array_equal(yt.argmax(-1).numpy(), np.asarray(yj).argmax(-1))
        got = caches_to_numpy(tc)
        caches = {n: np.asarray(a) for n, a in jc.items()}
        assert got["k"].shape == caches["k"].shape and got["k"].dtype == np.int8
        for name in ("ks", "vs"):
            np.testing.assert_allclose(got[name], caches[name], rtol=1e-5, atol=0,
                                       err_msg=name)
        for name in ("k", "v"):
            a = KV.unpack_int4_heads(torch.from_numpy(got[name]), JCFG.head_dim).int()
            b = KV.unpack_int4_heads(torch.from_numpy(caches[name]), JCFG.head_dim).int()
            diff = (a - b).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-2, name


def test_int4_odd_kv_heads_raise():
    from magicdec_tpu_torch.config import tiny_config
    from magicdec_tpu_torch.engine.engine import EngineConfig, SpecEngine

    cfg = tiny_config(n_head=3, n_kv_head=3)
    with pytest.raises(ValueError, match="even kv-head"):
        SpecEngine(bench.make_params(cfg, device="cpu"), cfg,
                   EngineConfig(draft_budget=257, kv_quant="int4"), device="cpu")


def test_int4_bench_flags_and_metric_tag():
    """--kv_quant int4 --draft_quant int4 sets up the engine on the CPU
    (each flag alone too), tagged as bench.py tags it; the defaults stay."""
    args = bench.parse_args(["--kv_quant", "int4", "--draft_quant", "int4"])
    assert bench.metric_name(args) == \
        "selfspec_streamingllm_tokens_per_s_llama-3.2-1b_kvq4_dq4_B32_ctx8192_torch"
    assert bench.metric_name(bench.parse_args(["--kv_quant", "int4"])) == \
        "selfspec_streamingllm_tokens_per_s_llama-3.2-1b_kvq4_dq8_B32_ctx8192_torch"
    assert bench.metric_name(bench.parse_args(["--draft_quant", "int4"])) == \
        "selfspec_streamingllm_tokens_per_s_llama-3.2-1b_kvq8_dq4_B32_ctx8192_torch"
    assert (bench.parse_args([]).kv_quant, bench.parse_args([]).draft_quant) == ("int8", "int8")
    tiny = ["--device", "cpu", "--model", "68m", "--B", "2", "--prefix_len", "256",
            "--draft_budget", "257", "--iters", "1"]
    for kv, dq, bits in (("int4", "int4", 4), ("int4", "int8", 8), ("int8", "int4", 4)):
        engine, prompts = bench.setup(bench.parse_args(tiny + ["--kv_quant", kv,
                                                               "--draft_quant", dq]))
        st = engine.encode_baseline(prompts[0])
        c = engine.cfg
        width = c.n_kv_head * c.head_dim // (2 if kv == "int4" else 1)
        assert st.k.shape[-1] == width and st.ks.shape[2] == c.n_kv_head
        assert engine.draft_params["layers"]["w13"].bits == bits


def test_convert_int4_caches_round_trip_bitwise():
    """JAX packed int4 caches and their f32 scales -> the port -> numpy, bit
    for bit."""
    import jax.numpy as jnp
    from magicdec_tpu.ops import kv_cache as jkv
    from magicdec_tpu_torch.convert import caches_from_jax, caches_to_numpy

    rng = np.random.RandomState(4)
    kq, ks = jkv.quantize_kv_tokens_int4(jnp.asarray(rng.randn(B, 16, HKV, HD), jnp.float32))
    jax_caches = {"k": np.asarray(kq)[None], "ks": np.asarray(ks)[None],
                  "v": np.asarray(kq)[None], "vs": np.asarray(ks)[None]}
    tc = caches_from_jax(jax_caches, dtype=torch.bfloat16)
    assert tc["k"].dtype == torch.int8 and tc["k"].shape[-1] == KP
    back = caches_to_numpy(tc)
    for name in ("k", "v", "ks", "vs"):
        assert back[name].dtype == jax_caches[name].dtype
        np.testing.assert_array_equal(back[name], jax_caches[name], err_msg=name)


def test_int4_attention_wrappers_never_fall_back():
    q = torch.zeros(1, 1, 2, HD, device="meta")
    c = torch.zeros(1, 1, 8, HD, dtype=torch.int8, device="meta")
    s = torch.zeros(1, 1, 2, 8, device="meta")
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    for fn in (DA.flash_decode_attend_quant4, PA.flash_prefill_attend_quant4):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, c, s, c, s, lens)
        with pytest.raises(ValueError, match="several devices"):
            fn(q, c, s, c, s, torch.zeros(1, dtype=torch.int32))


# -- on the card: CUDA kernel vs plain version --------------------------------


def _int4_cache_on_card(gen, Lc, Bc, S, Hkv, device):
    """Packed int4 cache [Lc, Bc, S, (Hkv//2)*HD] and scales [Lc, Bc, Hkv, S]
    quantized from bf16 randn by the port's quantize_kv_tokens_int4."""
    x = torch.randn((Lc * Bc, S, Hkv, HD), generator=gen, device=device).to(torch.bfloat16)
    q, s = KV.quantize_kv_tokens_int4(x)
    return q.reshape(Lc, Bc, S, -1), s.reshape(Lc, Bc, Hkv, S)


def _swap_planes(packed):
    """The packed bytes with their nibbles swapped: heads 2i and 2i+1
    exchanged (a wrong reference)."""
    return ((packed << 4) | ((packed >> 4) & 0x0F)).to(torch.int8)


def _outside(out, ref):
    return int(((out.float() - ref.float()).abs() > bf16_limit(ref)).sum())


def _card_attn_case(fn, plain, gen, cuda, S, T, base):
    Bc, Hkv, G = len(base), 8, 4
    k, ks = _int4_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    v, vs = _int4_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    q = torch.randn((Bc, T, Hkv * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    base = torch.tensor(base, dtype=torch.int32, device=cuda)
    x = torch.randn((2, Bc, T, Hkv, HD), generator=gen, device=cuda).to(torch.bfloat16)
    (kn, ksn), (vn, vsn) = KV.quantize_kv_tokens_int4(x[0]), KV.quantize_kv_tokens_int4(x[1])
    fresh = dict(k_new=kn, v_new=vn, ks_new=ksn, vs_new=vsn)
    for kw in ({}, fresh):
        out = fn(q, k, ks, v, vs, base, layer=LAYER, **kw)
        ref = plain(q, k, ks, v, vs, base, layer=LAYER, **kw)
        assert torch.isfinite(out).all()
        assert _outside(out, ref) == 0
    # without its fresh rows the kernel reads the cache where they belong
    assert _outside(fn(q, k, ks, v, vs, base, layer=LAYER), ref) > 0
    swapped = dict(fresh, k_new=_swap_planes(kn), v_new=_swap_planes(vn))
    assert _outside(plain(q, _swap_planes(k), ks, _swap_planes(v), vs, base, layer=LAYER,
                          **swapped), ref) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 8704])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_decode_quant4_kernel_matches_plain_on_card(cuda, T, S):
    gen = torch.Generator(device=cuda).manual_seed(T)
    _card_attn_case(DA.flash_decode_attend_quant4, DA.flash_decode_attend_quant4_plain, gen,
                    cuda, S, T, [0, S // 3, S - T])


def _decode4_operands(gen, cuda, S, T, base):
    from test_torch_kv_quant import _decode_operands

    return _decode_operands(gen, cuda, S, T, base, quant=_int4_cache_on_card)


@pytest.mark.gpu
def test_decode_quant4_window_equals_step_on_card(cuda):
    """B10: a verify window's token t has the bits of the autoregressive
    step at base + t, at bases 0, S // 3 and S - T of an 8704-row cache."""
    from test_torch_kv_quant import window_equals_steps

    S, T = 8704, 4
    gen = torch.Generator(device=cuda).manual_seed(40)
    q, caches, fresh, base = _decode4_operands(gen, cuda, S, T, [0, S // 3, S - T])
    window_equals_steps(DA.flash_decode_attend_quant4, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 8704])
def test_decode_quant4_kernel_poisoned_cache_on_card(cuda, S):
    from test_torch_kv_quant import poisoned_cache_matches_clean

    gen = torch.Generator(device=cuda).manual_seed(41)
    q, caches, fresh, base = _decode4_operands(gen, cuda, S, 4, [0, S // 3, S - 4])
    poisoned_cache_matches_clean(DA.flash_decode_attend_quant4,
                                 DA.flash_decode_attend_quant4_plain, q, caches, fresh, base)


@pytest.mark.gpu
def test_decode_quant4_kernel_deterministic_and_graph_replay_on_card(cuda):
    from test_torch_kv_quant import deterministic_and_graph_replay

    gen = torch.Generator(device=cuda).manual_seed(42)
    q, caches, fresh, base = _decode4_operands(gen, cuda, 8704, 4, [0, 2900, 8700])
    deterministic_and_graph_replay(DA.flash_decode_attend_quant4, q, caches, fresh, base)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 200, 512])
def test_prefill_quant4_kernel_matches_plain_on_card(cuda, C):
    """Ragged chunks (C = 200: rows not a multiple of the 128-row block) at
    bases that start a 128-column tile (0), straddle one (37, 300, S - C -
    5: the tile takes cache rows below base and fresh rows from it on), with
    and without fresh rows."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    S = 1024
    _card_attn_case(PA.flash_prefill_attend_quant4, PA.flash_prefill_attend_quant4_plain, gen,
                    cuda, S, C, [0, 37, 300, S - C - 5])


def _prefill_quant4_operands(cuda, C=200, S=1024):
    gen = torch.Generator(device=cuda).manual_seed(11)
    Bc, Hkv, G = 3, 8, 4
    k, ks = _int4_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    v, vs = _int4_cache_on_card(gen, L, Bc, S, Hkv, cuda)
    fk, fks = _int4_cache_on_card(gen, 1, Bc, C, Hkv, cuda)
    fv, fvs = _int4_cache_on_card(gen, 1, Bc, C, Hkv, cuda)
    q = torch.randn((Bc, C, Hkv * G, HD), generator=gen, device=cuda).to(torch.bfloat16)
    base = torch.tensor([0, 300, S - C - 5], dtype=torch.int32, device=cuda)
    fresh = dict(k_new=fk[0], v_new=fv[0], ks_new=fks[0], vs_new=fvs[0])
    return lambda: PA.flash_prefill_attend_quant4(q, k, ks, v, vs, base, layer=LAYER, **fresh)


@pytest.mark.gpu
def test_prefill_quant4_kernel_deterministic_on_card(cuda):
    """Two launches on the same inputs are bit-equal (no atomics, no split
    of the KV range): encode and encode_baseline start from the same bits."""
    run = _prefill_quant4_operands(cuda)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.gpu
def test_prefill_quant4_graph_replay_matches_eager_on_card(cuda):
    """Captured in a CUDA graph, the kernel's replay is bit-equal to its
    eager launch (the tensor maps are encoded at capture)."""
    run = _prefill_quant4_operands(cuda)
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm the stream outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 4, 512])
def test_append_quant_packed_rows_kernel_matches_plain_on_card(cuda, T):
    gen = torch.Generator(device=cuda).manual_seed(T)
    S, Hkv = 1024, 8
    ck, sk = _int4_cache_on_card(gen, L, B, S, Hkv, cuda)
    cv, sv = _int4_cache_on_card(gen, L, B, S, Hkv, cuda)
    rk, srk = _int4_cache_on_card(gen, L, B, T, Hkv, cuda)
    rv, srv = _int4_cache_on_card(gen, L, B, T, Hkv, cuda)
    # ragged, the last row, a window running past the end, one wholly past it:
    # rows at or past S are dropped
    pos = torch.tensor([5, S - T, S - (T + 1) // 2, 2 * S], dtype=torch.int32,
                       device=cuda)
    got = AP.append_all_rows_inplace_quant(ck.clone(), cv.clone(), rk, rv, pos, sk.clone(),
                                           sv.clone(), srk, srv)
    want = AP.append_all_rows_inplace_plain(ck, cv, rk, rv, pos, sk, sv, srk, srv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
