"""Group-wise int8 weights (``quantize_params(bits=8, group_size=g)``, scales
[In/g, Out]) in the port, on the CPU against the JAX package.

- ``quantize_weight`` and ``quantize_params`` with int8 groups bit for bit.
- B4's plain version (norm, SiLU gate, residual) and B6's against
  ``quant_matmul_fused_pallas`` / ``quant_matmul_pallas`` (interpret) at
  group 32: atol = rtol = 1e-4 in float32 (both sum each group's products
  in a fresh f32 partial and add the scaled partials in group order; the
  dots inside a group sum in another order).
- B5 and B9 decline group-wise weights in both packages.
- B4 / B6's host side: the grouped entry point, its split cut on group
  boundaries, one C call; a group the kernel does not take raises.
- A JAX-written ``.npz`` with G > 1 int8 leaves loads in the port to the
  same leaves, and ``forward_target`` on it (both packages on their kernel
  backend) gives the JAX package's logits within 1e-4.

The card's tests: tests/test_torch_kv_scale_bf16_card.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from magicdec_tpu_torch import quantization as Q
from magicdec_tpu_torch.kernels import quant_matmul as QK

TOL = dict(atol=1e-4, rtol=1e-4)
T512 = dict(vocab_size=256, n_layer=2, n_head=8, n_kv_head=4, dim=512, intermediate_size=1024)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas():
    """Both packages on their kernel backend ("pallas"), restored after."""
    from magicdec_tpu import quantization as JQ

    old_j, old_t = JQ._MATMUL_BACKEND, Q.matmul_backend()
    JQ.set_matmul_backend("pallas")
    Q.set_matmul_backend("pallas")
    yield
    JQ.set_matmul_backend(old_j)
    Q.set_matmul_backend(old_t)


@pytest.mark.parametrize("group", [16, 32, 128])
def test_quantize_group_int8_matches_jax(group):
    """``quantize_weight`` (eager: the division) and ``quantize_params``
    (the JAX package's jitted quantization: the f32 reciprocal) bit for bit."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    w = (np.random.RandomState(group).randn(2, 256, 96) * 0.05).astype(np.float32)
    w[0, :group, 3] = 0.0  # an all-zero group: the 1e-10 clamp
    jw = JQ.quantize_weight(jnp.asarray(w), bits=8, group_size=group)
    tw = Q.quantize_weight(torch.from_numpy(w), bits=8, group_size=group)
    assert (tw.bits, tw.group_size) == (8, group) and tuple(tw.scale.shape) == (2, 256 // group, 96)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    jp = JQ.quantize_params({"layers": {"wo": jnp.asarray(w)}, "lm_head": None}, bits=8,
                            group_size=group)
    tp = Q.quantize_params({"layers": {"wo": torch.from_numpy(w)}, "lm_head": None}, bits=8,
                           group_size=group)
    np.testing.assert_array_equal(tp["layers"]["wo"].q.numpy(), np.asarray(jp["layers"]["wo"].q))
    np.testing.assert_array_equal(tp["layers"]["wo"].scale.numpy(),
                                  np.asarray(jp["layers"]["wo"].scale))


@pytest.mark.parametrize("epilogue", ["norm", "gate", "residual", "none"])
def test_b4_b6_plain_group_int8_match_pallas(epilogue):
    """At group 32 (16 groups in each 512-row block of the contraction)."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.ops.pallas.quant_matmul import (quant_matmul_fused_pallas,
                                                      quant_matmul_pallas)

    rng = np.random.RandomState(len(epilogue))
    M, In, Out, group = 8, 512, 512, 32
    x = rng.randn(M, In).astype(np.float32)
    nw = (rng.rand(In) + 0.5).astype(np.float32)
    res = rng.randn(M, Out).astype(np.float32)
    jw = JQ.quantize_weight(jnp.asarray(rng.randn(In, Out).astype(np.float32)), bits=8,
                            group_size=group)
    q, s = torch.from_numpy(np.asarray(jw.q)), torch.from_numpy(np.asarray(jw.scale))
    xt, nwt, rt = (torch.from_numpy(a) for a in (x, nw, res))
    blocks = dict(bits=8, group_size=group, block_in=In, block_out=256, interpret=True)
    if epilogue == "none":
        ref = quant_matmul_pallas(jnp.asarray(x), jw.q, jw.scale, **blocks)
        out = QK.quant_matmul(xt, q, s)
    else:
        kw = {"norm": dict(norm_w=nwt), "gate": dict(norm_w=nwt, gate=True),
              "residual": dict(res=rt)}[epilogue]
        jkw = dict(norm_w=jnp.asarray(nw) if "norm_w" in kw else None,
                   res=jnp.asarray(res) if "res" in kw else None, norm="norm_w" in kw,
                   gate=kw.get("gate", False))
        ref = quant_matmul_fused_pallas(jnp.asarray(x), jw.q, jw.scale, **jkw, **blocks)
        out = QK.quant_matmul_fused(xt, q, s, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_b5_b9_decline_group_int8_in_both_packages(pallas):
    """Group-wise int8 FFN weights: B5 (``quant_layer_tail``) and B9
    (``quant_mlp``) return None in both packages, so the FFN runs as B4
    calls; per-column weights of the same shapes still take them."""
    import jax.numpy as jnp
    from magicdec_tpu import quantization as JQ

    rng = np.random.RandomState(9)
    D, F, M = 256, 512, 8
    ws = {n: rng.randn(*shape).astype(np.float32) for n, shape in
          (("wo", (D, D)), ("w13", (D, 2 * F)), ("w2", (F, D)))}
    x, a = rng.randn(M, D).astype(np.float32), rng.randn(M, D).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    for group, declines in ((32, True), (None, False)):
        tq = {n: Q.quantize_weight(torch.from_numpy(w), group_size=group) for n, w in ws.items()}
        jq = {n: JQ.quantize_weight(jnp.asarray(w), bits=8, group_size=group)
              for n, w in ws.items()}
        xt, at, nwt = (torch.from_numpy(v) for v in (x, a, nw))
        jx, ja, jnw = (jnp.asarray(v) for v in (x, a, nw))
        got = (Q.quant_mlp(xt, tq["w13"], tq["w2"], (nwt, 1e-5)),
               Q.quant_layer_tail(at, xt, tq["wo"], tq["w13"], tq["w2"], (nwt, 1e-5)),
               JQ.quant_mlp(jx, jq["w13"], jq["w2"], (jnw, 1e-5)),
               JQ.quant_layer_tail(ja, jx, jq["wo"], jq["w13"], jq["w2"], (jnw, 1e-5)))
        assert all((g is None) == declines for g in got), (group, [g is None for g in got])


class _FakeLibrary:
    """Records the C calls of B4 / B6 (returns success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("group", [32, 128, 512])
def test_b4_b6_group_int8_launch_against_a_fake_library(group, monkeypatch):
    """The grouped entry points with the group and a split cut on group
    boundaries, one C call a wrapper call: at the target's 128 rows the
    128-row core (``md_quant_matmul_m128_sm90``, ``m128_split_plan(In, Out,
    max(group, 64), 64)``), at the draft's 32 the cluster core
    (``md_quant_matmul_grouped_sm90``, ``cluster_split_plan(In, Out,
    max(group, 64))``); a group the kernel does not take raises before any
    call, and one scale a column keeps group In on the 128-row core and
    ``md_quant_matmul_sm90`` on the cluster core."""
    from magicdec_tpu_torch.kernels import build

    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 7)
    In, Out = 2048, 3072
    q = torch.zeros(In, Out, dtype=torch.int8)
    x = torch.zeros(128, In, dtype=torch.bfloat16)
    QK._launch_dot(x, q, torch.ones(In // group, Out), torch.ones(In, dtype=torch.bfloat16))
    ((name, args),) = lib.calls
    assert name == "md_quant_matmul_m128_sm90" and len(args) == 14
    assert args[6:12] == (128, In, Out, 0, QK.m128_split_plan(In, Out, max(group, 64), 64),
                          group)
    lib.calls.clear()
    QK._launch_dot(x[:32], q, torch.ones(In // group, Out), torch.ones(In, dtype=torch.bfloat16))
    ((name, args),) = lib.calls
    assert name == "md_quant_matmul_grouped_sm90" and len(args) == 14
    assert args[6:12] == (32, In, Out, 0, QK.cluster_split_plan(In, Out, max(group, 64)), group)
    lib.calls.clear()
    QK._launch_dot(x, q, torch.ones(1, Out))
    QK._launch_dot(x[:32], q, torch.ones(1, Out))
    assert [n for n, _ in lib.calls] == ["md_quant_matmul_m128_sm90", "md_quant_matmul_sm90"]
    assert lib.calls[0][1][11] == In
    lib.calls.clear()
    for bad in (16, 96):
        qb = torch.zeros(96 * 16, 256, dtype=torch.int8)
        with pytest.raises(ValueError, match="power-of-two group >= 32"):
            QK._launch_dot(torch.zeros(8, 96 * 16, dtype=torch.bfloat16), qb,
                           torch.ones(96 * 16 // bad, 256))
    assert lib.calls == []


def _flatten_jax(tree, flat, prefix=""):
    """The JAX package's converter's flattening (scripts/convert_checkpoint.py)."""
    from magicdec_tpu import quantization as JQ

    if tree is None:
        return flat
    if isinstance(tree, JQ.QuantizedWeight):
        flat[prefix + "q"] = np.asarray(tree.q)
        flat[prefix + "scale"] = np.asarray(tree.scale)
        flat[prefix + "bits"] = np.asarray(tree.bits)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_jax(v, flat, f"{prefix}{k}.")
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def test_group_int8_npz_loads_alike_and_forward_target_matches_jax(tmp_path, pallas,
                                                                   monkeypatch):
    """A JAX-written ``.npz`` of group-wise int8 verify weights (group 32):
    the port's ``load_converted`` gives the JAX package's leaves (data,
    scales, group size); ``forward_target`` at decode_rows = 8 over an int8
    KV cache gives its logits within 1e-4, the port's dots on B4 and B6
    (never B9)."""
    import jax.numpy as jnp
    from magicdec_tpu import config as jcfg
    from magicdec_tpu import quantization as JQ
    from magicdec_tpu.models import llama as JM
    from magicdec_tpu.utils.checkpoint import load_converted as jax_load
    from magicdec_tpu_torch import config as tcfg
    from magicdec_tpu_torch.convert import caches_from_jax
    from magicdec_tpu_torch.models import llama as TM
    from magicdec_tpu_torch.utils.checkpoint import load_converted
    from test_torch_model import _jax_tree, random_params

    jc, tc = jcfg.tiny_config(**T512), tcfg.tiny_config(**T512)
    jq = JQ.quantize_params(_jax_tree(random_params(jc, seed=2)), bits=8, group_size=32)
    path = tmp_path / "tiny-int8.npz"
    np.savez(path, **_flatten_jax(jq, {}))
    tp, jp = load_converted(str(path)), jax_load(str(path))
    for name in ("wq", "w2"):
        t, j = tp["layers"][name], jp["layers"][name]
        assert (t.bits, t.group_size) == (j.bits, j.group_size) == (8, 32)
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    seen = []
    for name in ("quant_matmul", "quant_matmul_fused", "quant_mlp", "quant_layer_tail"):
        fn = getattr(QK, name)
        monkeypatch.setattr(QK, name, lambda *a, _fn=fn, _n=name, **k: seen.append(_n)
                            or _fn(*a, **k))
    rng = np.random.RandomState(5)
    B, S, P, T = 2, 64, 24, 4
    Kw = jc.n_kv_head * jc.head_dim
    caches = {n: rng.randint(-127, 128, (jc.n_layer, B, S, Kw)).astype(np.int8) for n in "kv"}
    caches.update({n: (rng.rand(jc.n_layer, B, jc.n_kv_head, S) * 0.02).astype(np.float32)
                   for n in ("ks", "vs")})
    tokens = rng.randint(0, jc.vocab_size, (B, T)).astype(np.int32)
    base = np.array([P, P - 7], np.int32)
    lj, _ = JM.forward_target(JM.fuse_exec_params(jp, jc), dataclasses.replace(jc, decode_rows=8),
                              jnp.asarray(tokens), jnp.asarray(base),
                              {n: jnp.asarray(a) for n, a in caches.items()}, head="logits")
    lt, _ = TM.forward_target(TM.fuse_exec_params(tp, tc), dataclasses.replace(tc, decode_rows=8),
                              torch.from_numpy(tokens), torch.from_numpy(base),
                              caches_from_jax(caches), head="logits")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert set(seen) == {"quant_matmul_fused", "quant_matmul"}
