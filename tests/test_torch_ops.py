"""sfast_tpu_torch ops against their sfast_tpu counterparts on the CPU.

Inputs come from seeded numpy and go through both packages; JAX's Pallas
kernels run in interpret mode, as ``tests/ops/*`` run them.  On the CPU
the port's kernel wrappers take their plain PyTorch versions, so these
tests hold the plain versions (the kernels' specification) against the
Pallas kernels.  Tolerances:

- f32 plain ops: 1e-5 relative to the output's scale — the same math in
  the same precision, summed in another order;
- Pallas interpret mode vs the plain versions: the flash kernel's online
  softmax agrees to ~1e-5 in f32 (2e-4 bound); the conv kernel stages its
  normalized input in bf16 while the plain version keeps f32, so its
  outputs and statistics agree to ~2⁻⁹ relative (1e-2 bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.ops import conv_pallas as jcp
from sfast_tpu.ops.attention import xla_attention as j_xla_attention
from sfast_tpu.ops.conv import conv2d as j_conv2d
from sfast_tpu.ops.flash_attention import flash_attention as j_flash_attention
from sfast_tpu.ops.geglu import linear_geglu_xla as j_linear_geglu
from sfast_tpu.ops.group_norm import group_norm_stats as j_group_norm_stats
from sfast_tpu.ops.group_norm import group_norm_xla as j_group_norm
from sfast_tpu.ops.layer_norm import layer_norm as j_layer_norm
from sfast_tpu.ops.linear import linear as j_linear
from sfast_tpu_torch.ops import fused_conv
from sfast_tpu_torch.ops.attention import dot_product_attention
from sfast_tpu_torch.ops.conv import conv2d
from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
from sfast_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from sfast_tpu_torch.ops.geglu import linear_geglu, linear_geglu_fused
from sfast_tpu_torch.ops.group_norm import (
    group_norm,
    group_norm_apply,
    group_norm_fused,
    group_norm_stats,
    group_norm_stats_ref,
)
from sfast_tpu_torch.ops.layer_norm import layer_norm, layer_norm_fused, layer_norm_ok, row_stride
from sfast_tpu_torch.ops.linear import linear
from sfast_tpu_torch.runtime import cuda_build

F32_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6))


def _bf16_round(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# plain ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", [None, "silu"])
def test_linear_matches_jax(act):
    rng = _rng(1)
    x, w, b = _randn(rng, 3, 5, 16), _randn(rng, 16, 24, scale=0.25), _randn(rng, 24)
    ref = j_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act)
    got = linear(_t(x), _t(w.T), _t(b), act=act)
    _close(got, ref, F32_TOL)


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1)])
def test_conv2d_matches_jax(stride, padding, k):
    rng = _rng(2)
    x, w, b = _randn(rng, 2, 9, 11, 8), _randn(rng, k, k, 8, 12, scale=0.2), _randn(rng, 12)
    ref = j_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding)
    got = conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride, padding=padding)
    assert got.shape == ref.shape
    _close(got, ref, F32_TOL)


def test_layer_norm_matches_jax():
    rng = _rng(3)
    x, g, b = _randn(rng, 2, 7, 48) + 0.5, _randn(rng, 48), _randn(rng, 48)
    ref = j_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    _close(layer_norm(_t(x), _t(g), _t(b)), ref, F32_TOL)


@pytest.mark.parametrize("backend,affine", [("plain", True), ("plain", False),
                                            ("kernel", True), ("kernel", False)])
def test_layer_norm_backends_match_jax(backend, affine):
    """Both routes on the CPU: ``'plain'``, and ``'kernel'``, whose wrapper
    takes the plain form for a CPU tensor (K7's specification), with and
    without gamma and beta."""
    rng = _rng(3)
    x, g, b = _randn(rng, 3, 5, 40) - 0.25, _randn(rng, 40), _randn(rng, 40)
    gb = (jnp.asarray(g), jnp.asarray(b)) if affine else (None, None)
    ref = j_layer_norm(jnp.asarray(x), *gb)
    got = layer_norm(_t(x), *((_t(g), _t(b)) if affine else (None, None)), backend=backend)
    _close(got, ref, F32_TOL)


def _like(shape, dtype=torch.bfloat16, device="cuda", stride=None):
    """What ``layer_norm_ok`` reads of a tensor, without a card: shape,
    strides, dtype and device."""
    import types

    t = torch.empty(shape) if stride is None else torch.empty_strided(shape, stride)
    return types.SimpleNamespace(shape=t.shape, stride=t.stride, dtype=dtype,
                                 device=torch.device(device))


# the UNets' LayerNorm rows (M, C): SD1.5 level 0 at CFG batch 2, SDXL's
# levels 1 and 2, SVD's spatial level 0 and its temporal (B·H·W, F, C) view
@pytest.mark.parametrize("shape", [(2, 4096, 320), (2, 4096, 640), (2, 1024, 1280),
                                   (50, 9216, 320), (18432, 25, 320), (7, 24)])
def test_layer_norm_rule_takes_k7_on_the_card(shape):
    assert layer_norm_ok(_like(shape), False)
    assert layer_norm_ok(_like(shape), False, torch.ones(shape[-1]), torch.zeros(shape[-1]))


@pytest.mark.parametrize("x,grad,affine_dtype", [
    (_like((2, 64, 320), device="cpu"), False, torch.float32),
    (_like((2, 64, 320), device="meta"), False, torch.float32),
    (_like((2, 64, 320), dtype=torch.float32), False, torch.float32),
    (_like((2, 64, 320), stride=(320 * 64, 1, 64)), False, torch.float32),  # last dim strided
    (_like((2, 64, 320), stride=(1, 2 * 320, 2)), False, torch.float32),  # rows not one run
    (_like((2, 64, 20)), False, torch.float32),    # C % 8 != 0
    (_like((2, 64, 8192)), False, torch.float32),  # wider than K7's rows
    (_like((2, 64, 320)), False, torch.bfloat16),  # bf16 gamma and beta
    (_like((2, 64, 320)), True, torch.float32),    # autograd records the call
], ids=["cpu", "meta", "f32", "last-dim-strided", "rows-not-uniform", "c20", "c8192",
        "bf16-affine", "grad"])
def test_layer_norm_rule_keeps_the_plain_form(x, grad, affine_dtype):
    c = x.shape[-1]
    assert not layer_norm_ok(x, grad, torch.ones(c, dtype=affine_dtype),
                             torch.zeros(c, dtype=affine_dtype))


def test_layer_norm_row_stride():
    assert row_stride((2, 3, 8), (24, 8, 1)) == 8
    assert row_stride((2, 3, 8), (48, 16, 1)) == 16  # a slice of wider rows
    assert row_stride((1, 3, 8), (999, 16, 1)) == 16  # a dim of one has any stride
    assert row_stride((8,), (1,)) == 8
    assert row_stride((2, 3, 8), (64, 16, 1)) is None  # two runs of rows
    assert row_stride((2, 8), (8, 2)) is None


@pytest.mark.parametrize("act,groups", [(None, 8), ("silu", 8), ("silu", 32)])
def test_group_norm_matches_jax(act, groups):
    rng = _rng(4)
    x, g, b = _randn(rng, 2, 6, 5, 64) + 0.3, _randn(rng, 64), _randn(rng, 64)
    ref = j_group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups=groups, act=act)
    _close(group_norm(_t(x), _t(g), _t(b), groups=groups, act=act), ref, F32_TOL)


def test_group_norm_rejects_indivisible_channels():
    with pytest.raises(ValueError, match="divisible"):
        group_norm(torch.zeros(1, 2, 2, 30), torch.ones(30), torch.zeros(30), groups=8)


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear_geglu_matches_jax_erf_path(with_bias):
    rng = _rng(5)
    x, w = _randn(rng, 2, 9, 32), _randn(rng, 32, 2 * 40, scale=0.2)
    b = _randn(rng, 80) if with_bias else None
    ref = j_linear_geglu(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = linear_geglu(_t(x), _t(w.T), None if b is None else _t(b))
    assert got.shape == (2, 9, 40)
    _close(got, ref, F32_TOL)


# ---------------------------------------------------------------------------
# K1: flash attention
# ---------------------------------------------------------------------------

# the shapes of tests/ops/test_attention.py, including SD1.5's d = 40
# cross-attention against 77 context tokens
FLASH_SHAPES = [
    (1, 2, 256, 256, 64, False),
    (1, 2, 256, 77, 40, False),
    (2, 1, 130, 130, 80, False),
    (1, 1, 64, 64, 160, False),
    (1, 2, 128, 128, 64, True),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", FLASH_SHAPES)
def test_flash_attention_ref_matches_pallas(b, h, sq, sk, d, causal):
    rng = _rng(6)
    q, k, v = _randn(rng, b, h, sq, d), _randn(rng, b, h, sk, d), _randn(rng, b, h, sk, d)
    ref = j_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, block_q=128, block_k=128,
    )
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    _close(got, ref, 2e-4)
    # on CPU tensors the kernel wrapper is its plain version
    np.testing.assert_array_equal(
        flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy(), got.numpy()
    )


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_jax_xla_attention(causal):
    rng = _rng(7)
    q, k, v = _randn(rng, 2, 3, 20, 16), _randn(rng, 2, 3, 20, 16), _randn(rng, 2, 3, 20, 16)
    ref = j_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = dot_product_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, ref, F32_TOL)


def test_unknown_backend_and_activation_are_rejected():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="backend"):
        dot_product_attention(q, q, q, backend="xformers")
    with pytest.raises(ValueError, match="activation"):
        linear(q, torch.zeros(8, 8), act="gelu")


# ---------------------------------------------------------------------------
# K2: fused GN+SiLU → 3×3 conv, and K3: GroupNorm statistics
# ---------------------------------------------------------------------------

CONV_CASES = [
    # n, h, w, c, f, groups, gn, bias_batch, residual, output_scale, emit_stats
    (2, 10, 12, 32, 16, 8, True, True, False, 1.0, True),    # resnet conv1
    (1, 9, 7, 16, 16, 8, True, False, True, 2.0, False),     # resnet conv2, odd H/W
    (2, 6, 10, 64, 128, 16, True, True, True, 1.5, True),    # everything at once
    (1, 5, 7, 32, 32, 8, False, False, False, 1.0, False),   # upsample conv: no GN
]


@pytest.mark.parametrize("n,h,w,c,f,groups,gn,bb,res,oscale,stats", CONV_CASES)
def test_conv3x3_block_ref_matches_pallas(n, h, w, c, f, groups, gn, bb, res, oscale, stats):
    rng = _rng(8)
    # the Pallas kernel stages its inputs in bf16: round them first
    x = _bf16_round(_randn(rng, n, h, w, c))
    wt = _bf16_round(_randn(rng, 3, 3, c, f, scale=(9 * c) ** -0.5))
    bias = _randn(rng, f)
    kw_np = {}
    if gn:
        gamma, beta = _randn(rng, c, scale=0.3) + 1, _randn(rng, c, scale=0.1)
        sc, sh = jcp.gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                               groups=groups, interpret=True)
        kw_np.update(gn_scale=np.asarray(sc), gn_shift=np.asarray(sh))
    if bb:
        kw_np["bias_batch"] = _randn(rng, n, f)
    if res:
        kw_np["residual"] = _bf16_round(_randn(rng, n, h, w, f))
    ref = jcp.conv3x3_block(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
        **{k: jnp.asarray(v) for k, v in kw_np.items()},
        output_scale=oscale, emit_stats=stats, interpret=True,
    )
    got = fused_conv.conv3x3_block(
        _t(x), _t(wt), _t(bias), **{k: _t(v) for k, v in kw_np.items()},
        output_scale=oscale, emit_stats=stats,
    )
    if not stats:
        ref, got = (ref,), (got,)
    assert len(got) == len(ref)
    for g_, r_ in zip(got, ref):
        assert tuple(g_.shape) == tuple(r_.shape)
        _close(g_, r_, 1e-2)


@pytest.mark.parametrize("n,h,w,c,groups", [(2, 8, 8, 64, 8), (1, 16, 12, 32, 32), (1, 5, 3, 40, 4)])
def test_group_norm_stats_ref_matches_pallas(n, h, w, c, groups):
    x = _randn(_rng(9), n, h, w, c) + 0.5
    jm, jr = j_group_norm_stats(jnp.asarray(x), groups=groups, eps=1e-6, interpret=True)
    m, r = group_norm_stats_ref(_t(x), groups=groups, eps=1e-6)
    assert m.shape == r.shape == (n, 1, 1, c)
    _close(m, jm, F32_TOL)
    _close(r, jr, F32_TOL)
    m2, r2 = group_norm_stats(_t(x), groups=groups, eps=1e-6)
    np.testing.assert_array_equal(m2.numpy(), m.numpy())
    np.testing.assert_array_equal(r2.numpy(), r.numpy())


def test_gn_affine_and_affine_from_stats_match_jax():
    rng = _rng(10)
    x, gamma, beta = _randn(rng, 2, 6, 5, 32) + 0.2, _randn(rng, 32), _randn(rng, 32)
    sc, sh = fused_conv.gn_affine(_t(x), _t(gamma), _t(beta), groups=8, eps=1e-6)
    jsc, jsh = jcp.gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                             groups=8, eps=1e-6, interpret=True)
    _close(sc, jsc, F32_TOL)
    _close(sh, jsh, F32_TOL)
    s1, s2 = x.sum(axis=(1, 2)), (x * x).sum(axis=(1, 2))
    sc2, sh2 = fused_conv.affine_from_stats(_t(s1), _t(s2), 30, _t(gamma), _t(beta), groups=8, eps=1e-6)
    jsc2, jsh2 = jcp.affine_from_stats(jnp.asarray(s1), jnp.asarray(s2), 30, jnp.asarray(gamma),
                                       jnp.asarray(beta), groups=8, eps=1e-6)
    _close(sc2, jsc2, F32_TOL)
    _close(sh2, jsh2, F32_TOL)
    # GN(x)·gamma + beta == x·scale + shift
    gn = j_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=8, eps=1e-6)
    _close(_t(x) * sc[:, None, None, :] + sh[:, None, None, :], gn, 1e-4)


# ---------------------------------------------------------------------------
# wrapper contract: CPU → plain version, CUDA → kernel, anything else raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kernel",
    ["flash_attention", "conv3x3", "group_norm_stats", "group_norm_apply", "linear_geglu",
     "flash_attention_int8", "group_norm_fused", "layer_norm"],
)
def test_kernel_wrappers_raise_off_cpu_and_cuda(kernel):
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "flash_attention":
            q = torch.empty(1, 2, 64, 40, **meta)
            flash_attention(q, q, q)
        elif kernel == "conv3x3":
            fused_conv.conv3x3_block(torch.empty(1, 8, 8, 16, **meta), torch.empty(3, 3, 16, 16, **meta))
        elif kernel == "group_norm_stats":
            group_norm_stats(torch.empty(1, 8, 8, 64, **meta), groups=8)
        elif kernel == "group_norm_apply":
            stats = torch.empty(1, 1, 1, 64, **meta)
            group_norm_apply(torch.empty(1, 8, 8, 64, **meta), stats, stats,
                             torch.empty(64, **meta), torch.empty(64, **meta))
        elif kernel == "linear_geglu":
            linear_geglu_fused(torch.empty(4, 128, **meta), torch.empty(256, 128, **meta))
        elif kernel == "group_norm_fused":
            group_norm_fused(torch.empty(1, 8, 8, 64, **meta), torch.empty(64, **meta),
                             torch.empty(64, **meta), groups=8)
        elif kernel == "layer_norm":
            layer_norm_fused(torch.empty(4, 64, **meta))
        else:
            q = torch.empty(1, 2, 64, 40, **meta)
            flash_attention_int8(q, q, q)


def test_cpu_calls_launch_nothing():
    cuda_build.reset_launch_counts()
    x = torch.randn(1, 8, 8, 16)
    fused_conv.conv3x3_gn_silu(x, torch.randn(3, 3, 16, 16))
    fused_conv.gn_affine(x, torch.ones(16), torch.zeros(16), groups=8)
    q = torch.randn(1, 1, 8, 8)
    flash_attention(q, q, q)
    flash_attention_int8(q, q, q)
    group_norm(x, torch.ones(16), torch.zeros(16), groups=8, act="gelu", backend="kernel")
    linear_geglu_fused(torch.randn(4, 32), torch.randn(128, 32))
    layer_norm(x.bfloat16(), backend="kernel")
    assert cuda_build.launch_counts == {
        "flash_attention": 0, "quantize_qkv": 0, "flash_attention_int8": 0, "conv3x3": 0,
        "group_norm_stats": 0, "group_norm_apply": 0, "group_norm_fused": 0, "linear_geglu": 0,
        "layer_norm": 0,
    }
