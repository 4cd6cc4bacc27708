"""The opt-in kernel configuration of sfast_tpu_torch against sfast_tpu on
the CPU: K3′+K5 GroupNorm, K4 linear+GEGLU and K6 int8 flash attention.

On the CPU the port's kernel wrappers take their plain versions, so these
tests hold the plain versions (the kernels' specification) against JAX's
Pallas kernels run in interpret mode, as ``tests/ops/*`` run them.
Inputs come from seeded numpy.  Tolerances:

- GroupNorm and GEGLU in f32: 1e-5 relative to the output's scale, the
  same math summed in another order;
- int8 attention: the two sides quantize the same f32 values, but their
  means are summed in another order, so a few values land on the other
  side of an int8 rounding boundary: rms 2e-3 relative between them, and
  each within 0.015 rms of exact attention (``tests/ops/test_attention.py``).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import layers as JL
from sfast_tpu.models.unet_2d_condition import _backends as j_backends
from sfast_tpu.ops.attention import xla_attention as j_xla_attention
from sfast_tpu.ops.flash_attention import flash_attention_int8 as j_flash_int8
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import layers as L
from sfast_tpu_torch.models.unet_2d_condition import backends
from sfast_tpu_torch.ops.attention import flash_ok
from sfast_tpu_torch.ops.flash_attention_int8 import (
    KV_TILE,
    flash_attention_int8,
    flash_attention_int8_ref,
    kernel_inputs,
    kernel_layout,
    quantize_qkv,
)
from sfast_tpu_torch.ops.geglu import geglu_ok, linear_geglu, linear_geglu_fused_ref
from sfast_tpu_torch.ops.group_norm import group_norm

# the modules themselves: sfast_tpu.ops re-exports functions of the same names
j_attention = importlib.import_module("sfast_tpu.ops.attention")
j_geglu = importlib.import_module("sfast_tpu.ops.geglu")
j_group_norm = importlib.import_module("sfast_tpu.ops.group_norm")
t_attention = importlib.import_module("sfast_tpu_torch.ops.attention")

F32_TOL = 1e-5
INT8_PAIR_RMS = 2e-3
INT8_EXACT_RMS = 0.015


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6))


def _rms_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean() / (ref**2).mean())


# ---------------------------------------------------------------------------
# K3′ + K5: the two-kernel GroupNorm, and the hybrid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "act,groups,eps",
    [(None, 8, 1e-5), ("silu", 8, 1e-6), ("gelu", 8, 1e-5),
     (None, 32, 1e-6), ("silu", 32, 1e-5), ("gelu", 32, 1e-6)],
)
@pytest.mark.parametrize("backend", ["kernel", "hybrid"])
def test_group_norm_kernel_routes_match_pallas(backend, act, groups, eps):
    rng = np.random.default_rng(11)
    x = _randn(rng, 2, 6, 5, 64) + 0.4
    g, b = _randn(rng, 64, scale=0.3) + 1.0, _randn(rng, 64, scale=0.2)
    jfn = j_group_norm.group_norm_pallas if backend == "kernel" else j_group_norm.group_norm_hybrid
    ref = jfn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups=groups, eps=eps,
              act=act, interpret=True)
    got = group_norm(_t(x), _t(g), _t(b), groups=groups, eps=eps, act=act, backend=backend)
    _close(got, ref, F32_TOL)


def test_group_norm_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        group_norm(torch.zeros(1, 2, 2, 8), torch.ones(8), torch.zeros(8), groups=4,
                   backend="pallas")


# ---------------------------------------------------------------------------
# K4: fused linear + tanh GEGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,f", [(18, 64, 48), (64, 640, 256)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_linear_geglu_fused_ref_matches_pallas(m, k, f, with_bias):
    rng = np.random.default_rng(12)
    x = _randn(rng, 2, m // 2, k)
    w = _randn(rng, k, 2 * f, scale=k**-0.5)  # JAX's (K, 2F)
    b = _randn(rng, 2 * f, scale=0.5) if with_bias else None
    ref = j_geglu.linear_geglu_pallas(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), interpret=True
    )
    wt = _t(w.T)  # the port's (2F, K)
    got = linear_geglu_fused_ref(_t(x), wt, None if b is None else _t(b))
    assert got.shape == (2, m // 2, f)
    _close(got, ref, F32_TOL)
    # the forced route is the kernel wrapper, its plain version on the CPU
    forced = linear_geglu(_t(x), wt, None if b is None else _t(b), backend="kernel")
    np.testing.assert_array_equal(forced.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# K6: int8 flash attention
# ---------------------------------------------------------------------------

INT8_SHAPES = [
    (1, 2, 256, 256, 40, False),
    (1, 2, 128, 77, 32, False),   # ragged kv: one padded block
    (2, 1, 200, 300, 64, False),  # ragged q and kv
    (1, 2, 256, 256, 40, True),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", INT8_SHAPES)
def test_flash_attention_int8_ref_matches_pallas(b, h, sq, sk, d, causal):
    rng = np.random.default_rng(13)
    q = _randn(rng, b, h, sq, d)
    k = _randn(rng, b, h, sk, d) + 0.7
    v = _randn(rng, b, h, sk, d) - 0.3
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = j_flash_int8(jq, jk, jv, causal=causal, block_q=128, block_k=128, interpret=True)
    got = flash_attention_int8_ref(_t(q), _t(k), _t(v), causal=causal, block_k=128)
    assert tuple(got.shape) == ref.shape
    assert _rms_rel(got, ref) <= INT8_PAIR_RMS
    exact = np.asarray(j_xla_attention(jq, jk, jv, causal=causal))
    assert _rms_rel(got, exact) <= INT8_EXACT_RMS
    assert _rms_rel(ref, exact) <= INT8_EXACT_RMS
    # on CPU tensors the kernel wrapper is the plain version at K6's tile
    np.testing.assert_array_equal(
        flash_attention_int8(_t(q), _t(k), _t(v), causal=causal).numpy(),
        flash_attention_int8_ref(_t(q), _t(k), _t(v), causal=causal, block_k=KV_TILE).numpy(),
    )


def test_flash_attention_int8_kernel_layout_gives_p_v():
    """K6 builds the A fragments of p·v from the s32 C fragments of q·kᵀ that
    a thread already holds, and the B fragments from 32-bit loads of the
    wrapper's permuted vᵀ.  Emulate both, lane by lane, with the PTX
    fragment layouts of mma.m16n8k16 (C) and mma.m16n8k32 (A, B), and check
    that the products add up to p·v."""
    rng = np.random.default_rng(14)
    rows, kv, d = 16, 2 * KV_TILE, 40
    p = rng.integers(0, 128, (rows, kv)).astype(np.int64)
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, kv - 5, d)).astype(np.int8))
    vt, _ = kernel_layout(v8, torch.zeros(1, kv - 5))
    vt = vt[0].numpy().astype(np.int64)  # (d, kv padded to a tile multiple)
    assert vt.shape == (d, kv)
    v = np.zeros((kv, d), np.int64)
    v[: kv - 5] = v8[0].numpy()
    out = np.zeros((rows, d), np.int64)
    for tile0 in range(0, kv, KV_TILE):
        for c in range(KV_TILE // 32):
            a = np.zeros((16, 32), np.int64)  # the logical A of this k32 step
            for lane in range(32):
                g, t = lane // 4, lane % 4

                def held(r, j):  # the lane's C-fragment values of row r, n8 tile j
                    return [p[r, tile0 + j * 8 + 2 * t + e] for e in (0, 1)]

                for r in (g, g + 8):
                    # the kernel's pack4: registers a0/a1 (row g/g+8, cols
                    # 4t..4t+3) from tiles 4c, 4c+1; a2/a3 (cols 16+4t..)
                    # from tiles 4c+2, 4c+3
                    a[r, 4 * t: 4 * t + 4] = held(r, 4 * c) + held(r, 4 * c + 1)
                    a[r, 16 + 4 * t: 20 + 4 * t] = held(r, 4 * c + 2) + held(r, 4 * c + 3)
            for n in range(d // 8):
                b = np.zeros((32, 8), np.int64)  # the logical B: (k, column)
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    row = vt[n * 8 + g, tile0 + c * 32:]
                    b[4 * t: 4 * t + 4, g] = row[4 * t: 4 * t + 4]
                    b[16 + 4 * t: 20 + 4 * t, g] = row[16 + 4 * t: 20 + 4 * t]
                out[:, n * 8: n * 8 + 8] += a @ b
    np.testing.assert_array_equal(out, p @ v)


@pytest.mark.parametrize("b,h", [(1, 2), (2, 3), (1, 1)])
def test_flash_attention_int8_kernel_inputs_are_contiguous(b, h):
    """K6 indexes its inputs as contiguous arrays; with one batch the
    head-split views reshape to (BH, S, D) without a copy, so the wrapper
    must ask for contiguity itself."""
    rng = np.random.default_rng(16)
    sq, sk, d = 40, 77, 16

    def heads(s):  # a head-split view of a (B, S, H·D) projection
        return _t(_randn(rng, b, s, h * d)).view(b, s, h, d).transpose(1, 2)

    q, k, v = heads(sq), heads(sk), heads(sk)
    got = kernel_inputs(q, k, v, 0.25)
    assert all(t.is_contiguous() for t in got)
    q8, k8, v8, sqk, sv, corr, vm = quantize_qkv(q, k, v, 0.25)
    vt, corr_p = kernel_layout(v8, corr)
    for a, r in zip(got, (q8, k8, vt, sqk, sv, corr_p, vm)):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
    assert got[2].shape == (b * h, d, 2 * KV_TILE) and got[5].shape == (b * h, 2 * KV_TILE)


# ---------------------------------------------------------------------------
# module level: a transformer with the K5, K4 and K6 routes forced
# ---------------------------------------------------------------------------


def test_spatial_transformer_kernel_routes_match_jax(monkeypatch):
    c, heads, ctx_dim = 128, 4, 48
    p = JL.init_spatial_transformer(0, c, heads, ctx_dim, dtype=jnp.float32)
    m = L.Transformer2DModel(c, heads, ctx_dim, dtype=torch.float32)
    sd = {}
    from_jax._put_spatial_transformer(sd, "", p)
    m.load_state_dict(sd)
    rng = np.random.default_rng(15)
    x, ctx = _randn(rng, 2, 16, 16, c), _randn(rng, 2, 9, ctx_dim)

    def interp(fn):  # callers pass interpret=False explicitly: override it
        return lambda *a, **kw: fn(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(j_group_norm, "group_norm_pallas", interp(j_group_norm.group_norm_pallas))
    monkeypatch.setattr(j_geglu, "linear_geglu_pallas", interp(j_geglu.linear_geglu_pallas))
    monkeypatch.setattr(j_attention, "flash_attention_int8", interp(j_attention.flash_attention_int8))
    # JAX's effective kv block here is min(1024, round_up(256, 128)) = 256
    monkeypatch.setattr(t_attention, "flash_attention_int8",
                        functools.partial(flash_attention_int8_ref, block_k=256))
    ref = JL.spatial_transformer_fwd(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(ctx), heads=heads,
        gn_backend="pallas", geglu_backend="pallas", attn_backend="flash_int8",
    )
    with torch.no_grad():
        got = m(_t(x), _t(ctx), gn_backend="kernel", geglu_backend="kernel",
                attn_backend="flash_int8")
    assert tuple(got.shape) == ref.shape
    assert _rms_rel(got, ref) <= INT8_PAIR_RMS
    # and the kernel routes are not the plain ones: tanh GELU and int8
    with torch.no_grad():
        plain = m(_t(x), _t(ctx))
    assert _rms_rel(got, plain) > 10 * _rms_rel(got, ref)


# ---------------------------------------------------------------------------
# routing rules against JAX's
# ---------------------------------------------------------------------------


def _on_tpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("m,k,f", [
    (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),  # SD1.5 levels 1, 2, mid
    (8192, 320, 1280),                                         # level 0: K % 128 != 0
    (64, 128, 64), (64, 256, 96), (64, 384, 128),
])
def test_geglu_rule_matches_jax(monkeypatch, m, k, f):
    _on_tpu(monkeypatch)
    seen = []
    monkeypatch.setattr(j_geglu, "linear_geglu_pallas", lambda *a, **kw: seen.append("pallas"))
    monkeypatch.setattr(j_geglu, "linear_geglu_xla", lambda *a, **kw: seen.append("xla"))
    x = jax.ShapeDtypeStruct((m, k), jnp.bfloat16)
    j_geglu.linear_geglu(x, jax.ShapeDtypeStruct((k, 2 * f), jnp.bfloat16))
    assert geglu_ok((m, k), (2 * f, k), torch.bfloat16, "cuda") is (seen == ["pallas"])
    assert not geglu_ok((m, k), (2 * f, k), torch.bfloat16, "cpu")
    assert not geglu_ok((m, k), (2 * f, k), torch.float32, "cuda")


@pytest.mark.parametrize("sq,sk,d", [
    (4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80), (256, 256, 160),
    (4096, 4096, 80), (1024, 1024, 64), (1023, 4096, 64), (2048, 2048, 160),
])
def test_int8_attention_rule_matches_jax(monkeypatch, sq, sk, d):
    _on_tpu(monkeypatch)
    seen = []
    for name in ("flash_attention", "flash_attention_int8", "xla_attention"):
        monkeypatch.setattr(j_attention, name, lambda *a, _n=name, **kw: seen.append(_n))
    q = jax.ShapeDtypeStruct((2, 8, sq, d), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((2, 8, sk, d), jnp.bfloat16)
    j_attention.dot_product_attention(q, kv, kv, backend="int8")
    ours = flash_ok(q.shape, kv.shape, torch.bfloat16, "cuda")
    assert seen == ["flash_attention_int8" if ours else "xla_attention"]


def test_int8_route_takes_k6_and_forced_route_always(monkeypatch):
    seen = []
    monkeypatch.setattr(t_attention, "flash_attention_int8", lambda *a, **kw: seen.append("k6"))
    monkeypatch.setattr(t_attention, "flash_attention", lambda *a, **kw: seen.append("k1"))
    monkeypatch.setattr(t_attention, "flash_ok", lambda *a: True)
    q = torch.zeros(1, 1, 8, 8)
    for backend in (None, "int8", "flash_int8", "plain"):
        t_attention.dot_product_attention(q, q, q, backend=backend)
    monkeypatch.setattr(t_attention, "flash_ok", lambda *a: False)
    for backend in ("int8", "flash_int8"):
        t_attention.dot_product_attention(q, q, q, backend=backend)
    assert seen == ["k1", "k6", "k6", "k6"]


_KNOBS = ["enable_flash_attention", "enable_int8_attention", "enable_fused_group_norm",
          "enable_fused_linear_geglu", "enable_fused_conv"]


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("bits", range(0, 32, 3))
def test_backends_map_the_knobs_as_jax(kernels, bits):
    knobs = {name: bool(bits >> i & 1) for i, name in enumerate(_KNOBS)}
    ours = backends(CompilationConfig(enable_kernels=kernels, **knobs))
    theirs = j_backends(JaxConfig(enable_pallas=kernels, **knobs))
    names = {"xla": "plain", "pallas": "kernel"}
    assert ours == {key: names.get(val, val) for key, val in theirs.items()}


def test_optin_config_defaults_mirror_jax():
    ours, theirs = dataclasses.asdict(CompilationConfig()), dataclasses.asdict(JaxConfig())
    assert {k: ours[k] for k in _KNOBS} == {k: theirs[k] for k in _KNOBS}
