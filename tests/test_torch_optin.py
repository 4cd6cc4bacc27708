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

import contextlib
import dataclasses
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

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
    flash_attention_int8,
    flash_attention_int8_ref,
    kernel_inputs,
    kernel_layout,
    kv_tile,
    permute_kv,
    quantize_qkv,
)
from sfast_tpu_torch.ops.geglu import geglu_ok, linear_geglu, linear_geglu_fused_ref
from sfast_tpu_torch.ops.group_norm import (
    fused_plan,
    group_norm,
    group_norm_fused,
    group_norm_fused_ref,
    group_norm_ok,
    stats_chunks,
)

# the modules themselves: sfast_tpu.ops re-exports functions of the same names
j_attention = importlib.import_module("sfast_tpu.ops.attention")
j_flash = importlib.import_module("sfast_tpu.ops.flash_attention")
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


def _gn_case(act, groups, eps, c):
    # the first cases keep their original ids, from before C was a parameter
    name = f"{act}-{groups}-{eps:g}" + ("" if c == 64 else f"-{c}")
    return pytest.param(act, groups, eps, c, id=name)


@pytest.mark.parametrize(
    "act,groups,eps,c",
    [_gn_case(*case) for case in [
        (None, 8, 1e-5, 64), ("silu", 8, 1e-6, 64), ("gelu", 8, 1e-5, 64),
        (None, 32, 1e-6, 64), ("silu", 32, 1e-5, 64), ("gelu", 32, 1e-6, 64),
        # the UNet's widths at G = 32: 10, 30 and 80 channels a group
        (None, 32, 1e-6, 320), ("silu", 32, 1e-5, 320), ("gelu", 32, 1e-5, 320),
        (None, 32, 1e-6, 960), ("silu", 32, 1e-5, 960), ("gelu", 32, 1e-6, 960),
        (None, 32, 1e-6, 2560), ("silu", 32, 1e-5, 2560), ("gelu", 32, 1e-6, 2560),
    ]],
)
@pytest.mark.parametrize("backend", ["kernel", "hybrid"])
def test_group_norm_kernel_routes_match_pallas(backend, act, groups, eps, c):
    rng = np.random.default_rng(11)
    hw = (6, 5) if c == 64 else (3, 2)
    x = _randn(rng, 2, *hw, c) + 0.4
    g, b = _randn(rng, c, scale=0.3) + 1.0, _randn(rng, c, scale=0.2)
    jfn = j_group_norm.group_norm_pallas if backend == "kernel" else j_group_norm.group_norm_hybrid
    ref = jfn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups=groups, eps=eps,
              act=act, interpret=True)
    got = group_norm(_t(x), _t(g), _t(b), groups=groups, eps=eps, act=act, backend=backend)
    _close(got, ref, F32_TOL)
    # with 8 channels a group or more the route is the fused GroupNorm, its
    # plain version here (fewer take K3 then K5)
    assert (fused_plan(2, hw[0] * hw[1], c, groups) is not None) is (c // groups >= 8)
    if backend == "kernel":
        y, mean, rstd = group_norm_fused(_t(x), _t(g), _t(b), groups=groups, eps=eps, act=act,
                                         stats=True)
        np.testing.assert_array_equal(y.numpy(), got.numpy())
        jm, jr = j_group_norm.group_norm_stats(jnp.asarray(x), groups=groups, eps=eps,
                                              interpret=True)
        _close(mean, jm, F32_TOL)
        _close(rstd, jr, F32_TOL)


def test_group_norm_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        group_norm(torch.zeros(1, 2, 2, 8), torch.ones(8), torch.zeros(8), groups=4,
                   backend="pallas")


# Every distinct UNet GroupNorm of the opt-in path at 512² (batch 2):
# (H = W, C, act), as chip_smoke.py's UNET_GN; and the VAE decoder's resnet
# inputs (batch 1), which take K3 in fused_conv.gn_affine
UNET_GN = [
    (64, 320, "silu"), (64, 320, None), (64, 640, "silu"), (64, 960, "silu"),
    (32, 320, "silu"), (32, 640, "silu"), (32, 640, None), (32, 960, "silu"),
    (32, 1280, "silu"), (32, 1920, "silu"),
    (16, 640, "silu"), (16, 1280, "silu"), (16, 1280, None), (16, 1920, "silu"),
    (16, 2560, "silu"),
    (8, 1280, "silu"), (8, 1280, None), (8, 2560, "silu"),
]
VAE_GN = [(128, 512), (256, 512), (256, 256), (512, 256), (512, 128)]
SMEM_LIMIT = 232448  # the H100's shared memory a CTA can use


def _calls(monkeypatch, x, gamma, beta, backend, groups=32):
    """Which kernels, or the plain form, group_norm(x, backend=backend)
    calls, with each stubbed out (no compute)."""
    seen = []
    gn_mod = importlib.import_module("sfast_tpu_torch.ops.group_norm")
    monkeypatch.setattr(gn_mod, "_group_norm_plain", lambda *a, **kw: seen.append("plain"))
    monkeypatch.setattr(gn_mod, "group_norm_fused", lambda *a, **kw: seen.append("fused"))
    monkeypatch.setattr(gn_mod, "group_norm_stats",
                        lambda *a, **kw: seen.append("K3") or (None, None))
    monkeypatch.setattr(gn_mod, "group_norm_apply", lambda *a, **kw: seen.append("K5"))
    group_norm(x, gamma, beta, groups=groups, act="silu", backend=backend)
    return seen


def _route(monkeypatch, n, hw, c):
    """Which kernels group_norm(backend='kernel') calls for an (n, hw, hw, c)
    tensor."""
    x = torch.empty(n, hw, hw, c, device="meta")
    return _calls(monkeypatch, x, torch.ones(c), torch.zeros(c), "kernel")


@pytest.mark.parametrize("hw,c,act", UNET_GN)
def test_fused_rule_takes_every_unet_groupnorm(monkeypatch, hw, c, act):
    plan = fused_plan(2, hw * hw, c, 32)
    assert plan is not None and _route(monkeypatch, 2, hw, c) == ["fused"]
    vb = plan.band_groups * (c // 32) // 8
    assert 32 % plan.band_groups == 0 and plan.band_groups * (c // 32) % 8 == 0 and vb >= 4
    assert plan.cluster in (2, 4, 8, 16) and (plan.cluster - 1) * plan.rows < hw * hw <= plan.cluster * plan.rows
    assert plan.rp % 32 == 0 and plan.threads == plan.rp * vb <= 512 and plan.smem <= SMEM_LIMIT
    # at least one CTA per SM of the card's 132, each of at most 512 rows,
    # and two an SM where a tile is large
    assert 2 * (32 // plan.band_groups) * plan.cluster >= 64 and plan.rows <= 512
    assert plan.smem <= 116 * 1024


@pytest.mark.parametrize("hw,c", VAE_GN)
def test_fused_rule_at_vae_shapes(monkeypatch, hw, c):
    """Beyond 128² a VAE map's band tile does not fit a cluster of 8 CTAs:
    those calls take K3 then K5.  At 128²·512 (batch 1) the 16 CTAs of
    each of 16 bands hold 1024 rows of 64 bytes (66 KB each): it fits, and
    takes the fused kernel."""
    plan = fused_plan(1, hw * hw, c, 32)
    if hw == 128:
        assert plan is not None and plan.smem <= SMEM_LIMIT
        assert _route(monkeypatch, 1, hw, c) == ["fused"]
    else:
        assert plan is None and _route(monkeypatch, 1, hw, c) == ["K3", "K5"]


@pytest.mark.parametrize("n,hw,c,cluster", [
    (2, 64, 960, 16),     # the UNet's 64²·960: 8 CTAs would hold 124 KB each, 16 hold 62 KB
    (1, 160, 512, 16),    # 16 CTAs of 101 KB
    (1, 176, 512, None),  # 16 CTAs of 122 KB, one an SM; 8 do not fit at all
    (1, 192, 512, None),
])
def test_fused_rule_takes_16_ctas_only_two_an_sm(monkeypatch, n, hw, c, cluster):
    """Clusters of 16 CTAs (non-portable) only where each CTA fits two an
    SM: at one an SM they would need 16 free SMs of one GPC.  A shape that
    fits neither 8 CTAs nor 16 at two an SM takes K3 then K5."""
    plan = fused_plan(n, hw * hw, c, 32)
    if cluster is None:
        assert plan is None and _route(monkeypatch, n, hw, c) == ["K3", "K5"]
    else:
        assert plan.cluster == cluster and plan.smem <= 116 * 1024
        assert _route(monkeypatch, n, hw, c) == ["fused"]


# SDXL's UNet at 128² latents: up level 2's resnet entries at 960 and 640
# channels and its 320-channel blocks (batch 2)
SDXL_128_GN = [(128, 320), (128, 640), (128, 960)]


@pytest.mark.parametrize("n,hw,c", [(2, hw, c) for hw, c, _ in UNET_GN]
                         + [(1, hw, c) for hw, c in VAE_GN]
                         + [(2, hw, c) for hw, c in SDXL_128_GN])
def test_group_norm_rule_takes_a_kernel_on_the_card(n, hw, c):
    """backend=None: on the card every bf16 GroupNorm of the UNets and the
    VAE decoder takes the kernel route (the fused GroupNorm, or K3 then K5
    where ``fused_plan`` refuses the shape)."""
    assert group_norm_ok((n, hw, hw, c), 32, torch.bfloat16, "cuda", False)


@pytest.mark.parametrize("shape,groups,dtype,device,grad", [
    ((2, 64, 64, 320), 32, torch.bfloat16, "cpu", False),
    ((2, 64, 64, 320), 32, torch.bfloat16, "meta", False),
    ((2, 64, 64, 320), 32, torch.float32, "cuda", False),
    ((2, 8, 8, 20), 4, torch.bfloat16, "cuda", False),       # C % 8 != 0
    ((1, 8, 8, 2048), 1024, torch.bfloat16, "cuda", False),  # more groups than K3 holds
    ((2, 64, 64, 320), 32, torch.bfloat16, "cuda", True),    # autograd records the call
], ids=["cpu", "meta", "f32", "c20", "groups1024", "grad"])
def test_group_norm_rule_keeps_the_plain_route(shape, groups, dtype, device, grad):
    assert not group_norm_ok(shape, groups, dtype, device, grad)


@pytest.mark.parametrize("device,n,hw,c,dtype,grad,backend,expected", [
    ("cuda", 2, 64, 320, torch.bfloat16, False, None, ["fused"]),
    ("cuda", 2, 8, 2560, torch.bfloat16, False, None, ["fused"]),
    ("cuda", 1, 64, 512, torch.bfloat16, False, None, ["fused"]),  # the VAE decoder's 64² maps
    ("cuda", 2, 128, 960, torch.bfloat16, False, None, ["K3", "K5"]),
    ("cuda", 1, 512, 128, torch.bfloat16, False, None, ["K3", "K5"]),  # conv_norm_out
    ("cuda", 2, 64, 320, torch.float32, False, None, ["plain"]),
    ("cuda", 2, 64, 320, torch.bfloat16, True, None, ["plain"]),
    ("cuda", 2, 64, 320, torch.bfloat16, False, "plain", ["plain"]),
    ("cuda", 2, 128, 960, torch.bfloat16, False, "plain", ["plain"]),
    ("cpu", 2, 4, 320, torch.bfloat16, False, None, ["plain"]),
], ids=["64sq-320", "8sq-2560", "vae-64sq-512", "128sq-960", "512sq-128", "f32", "grad",
        "plain", "plain-128sq-960", "cpu"])
def test_group_norm_default_route_dispatch(monkeypatch, device, n, hw, c, dtype, grad, backend,
                                           expected):
    """group_norm(backend=None) reaches the fused GroupNorm where the rule
    and ``fused_plan`` take the call, K3 then K5 where only the rule does,
    and the plain form otherwise; ``'plain'`` never reaches a kernel."""
    # on the card's device type, fake tensors: shape, dtype and device, no storage
    with contextlib.nullcontext() if device == "cpu" else FakeTensorMode():
        x = torch.empty(n, hw, hw, c, device=device, dtype=dtype, requires_grad=grad)
        g, b = torch.ones(c, device=device), torch.zeros(c, device=device)
        assert _calls(monkeypatch, x, g, b, backend) == expected


def test_group_norm_default_route_on_the_cpu_is_the_plain_route():
    """The CPU tests against JAX see the plain form under backend=None."""
    rng = np.random.default_rng(3)
    x = torch.tensor(_randn(rng, 2, 4, 3, 64)).to(torch.bfloat16)
    g, b = _t(_randn(rng, 64, scale=0.3) + 1.0), _t(_randn(rng, 64, scale=0.2))
    got = group_norm(x, g, b, groups=8, act="silu")
    torch.testing.assert_close(got, group_norm(x, g, b, groups=8, act="silu", backend="plain"),
                               rtol=0, atol=0)


def _fused_emulation(x, plan, groups, eps):
    """csrc/group_norm_fused.cu's partition and folds in f32 numpy: returns
    how often each (sample, row, channel) was read by the statistics and
    written by the apply, and the (n, c) mean and rstd that every CTA of a
    cluster computes."""
    n, hw, c = x.shape
    cpg, bg = c // groups, plan.band_groups
    bc = bg * cpg
    vb, rp, nw = bc // 8, plan.rp, plan.threads // 32
    m = nw // vb
    read = np.zeros((n, hw, c), np.int32)
    written = np.zeros((n, hw, c), np.int32)
    mean, rstd = np.zeros((n, c), np.float32), np.zeros((n, c), np.float32)
    t = np.arange(plan.threads)
    v, rl = t % vb, t // vb  # the apply's threads
    for s in range(n):
        for band in range(groups // bg):
            c0 = band * bc
            gparts = []
            for rank in range(plan.cluster):
                r0 = rank * plan.rows
                rows = max(0, min(plan.rows, hw - r0))
                # warp w: vector w % vb, rows (w // vb) * 32 + lane, step 32 m
                wred = np.zeros((nw, 4), np.float32)
                for w in range(nw):
                    wv = w % vb
                    r = np.arange(rows)
                    r = r[r // 32 % m == w // vb]
                    ch = c0 + 8 * wv + np.arange(8)
                    np.add.at(read[s], (r0 + r[:, None], ch), 1)
                    xv = x[s, r0 + r[:, None], ch]
                    s1, s2 = xv.sum(0, dtype=np.float32), (xv * xv).sum(0, dtype=np.float32)
                    ga = wv * 8 // cpg
                    jb = (ga + 1) * cpg - wv * 8
                    wred[w] = [s1[:jb].sum(), s2[:jb].sum(), s1[jb:].sum(), s2[jb:].sum()]
                gpart = np.zeros((2, bg), np.float32)
                for stat in range(2):
                    for g in range(bg):
                        for b in range(m):
                            for u in range(g * cpg // 8, ((g + 1) * cpg - 1) // 8 + 1):
                                slot = 0 if u * 8 >= g * cpg else 2
                                gpart[stat, g] += wred[b * vb + u, slot + stat]
                gparts.append(gpart)
                for k in range(-(-rows // rp)):
                    r = rl + k * rp
                    ok = r < rows
                    np.add.at(written[s], (r0 + r[ok, None], c0 + 8 * v[ok, None] + np.arange(8)), 1)
            tot = np.zeros((2, bg), np.float32)
            for gpart in gparts:  # the cluster's sums, in rank order
                tot += gpart
            cnt = np.float32(hw * cpg)
            mu = tot[0] / cnt
            r = 1.0 / np.sqrt(tot[1] / cnt - mu * mu + np.float32(eps))
            mean[s, c0:c0 + bc] = np.repeat(mu, cpg)
            rstd[s, c0:c0 + bc] = np.repeat(r, cpg)
    return read, written, mean, rstd


@pytest.mark.parametrize("n,hw,c,groups", [
    (2, 64 * 64, 320, 32), (2, 64 * 64, 960, 32), (2, 32 * 32, 1920, 32), (2, 16 * 16, 2560, 32),
    (2, 8 * 8, 1280, 32), (1, 128 * 128, 512, 32),              # main-path and VAE shapes
    (1, 15, 256, 32), (3, 63, 320, 32), (2, 30, 64, 8), (1, 1, 40, 4),  # odd H·W, C = 8·G
])
def test_fused_partition_covers_each_element_once(n, hw, c, groups):
    """The bands tile the channels, the cluster's CTAs the rows, and the
    warps (statistics) and threads (apply) each tile: every (sample, row,
    channel) is summed and written exactly once, and the kernel's fold
    order gives the plain statistics."""
    plan = fused_plan(n, hw, c, groups)
    assert plan is not None
    rng = np.random.default_rng(18)
    x = (rng.standard_normal((n, hw, c)) + 0.3).astype(np.float32)
    read, written, mean, rstd = _fused_emulation(x, plan, groups, 1e-5)
    assert (read == 1).all() and (written == 1).all()
    rm, rr = (a.reshape(n, c).numpy() for a in group_norm_fused_ref(
        _t(x).reshape(n, hw, 1, c), torch.ones(c), torch.zeros(c), groups=groups, eps=1e-5)[1:])
    _close(mean, rm, F32_TOL)
    _close(rstd, rr, F32_TOL)


@pytest.mark.parametrize("n,hw,c", [(2, h * h, c) for h, c, _ in UNET_GN[:: 2]]
                         + [(1, h * h, c) for h, c in VAE_GN])
def test_stats_chunks_cover_rows_and_bound_partials(n, hw, c):
    """K3's ticket route: its chunks cover every row once, give at most two
    blocks an SM, sum at least 32 KB of x a block where the map has it, and
    write partials of at most an eighth of x's bytes."""
    rows, chunks = stats_chunks(n, hw, c, 32)
    assert (chunks - 1) * rows < hw <= chunks * rows
    assert n * chunks * 2 * 32 * 4 <= n * hw * c * 2 / 8
    assert n * chunks <= 256 and (rows * c * 2 >= 32 * 1024 or n * chunks >= 255)


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
        flash_attention_int8_ref(_t(q), _t(k), _t(v), causal=causal, block_k=kv_tile(d)).numpy(),
    )


def _jax_int8_kernel_inputs(monkeypatch, q, k, v):
    """The operands JAX's flash_attention_int8 hands its Pallas kernel:
    (q_i8, k_i8, v_i8, sqk, sv, corr), captured by a stand-in pallas_call."""
    seen = []

    def pallas_call(kernel, *, out_shape, **kw):
        def run(*args):
            seen.append([np.asarray(a) for a in args])
            return jnp.zeros(out_shape.shape, out_shape.dtype)

        return run

    monkeypatch.setattr(j_flash, "pl", types.SimpleNamespace(
        pallas_call=pallas_call, BlockSpec=j_flash.pl.BlockSpec))
    j_flash_int8(*(jnp.asarray(a) for a in (q, k, v)), block_q=128, block_k=128)
    return seen[0]


def _codes_close(got, ref):
    """int8 codes within one level, and off by one on at most 0.1% of them:
    the two sides sum the means in another order, so a value on a rounding
    boundary may land on its other side."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 256, 256, 40), (2, 1, 200, 77, 32),
                                         (1, 1, 64, 300, 80)])
def test_flash_attention_int8_kernel_inputs_match_jax_quantization(monkeypatch, b, h, sq, sk, d):
    """K6's input layout (rows zero-padded to KP, vᵀ in the permuted kv
    order, corr zero past Sk), built by the plain kernel_inputs, holds
    JAX's quantization of the same q, k, v."""
    rng = np.random.default_rng(17)
    q, k, v = _randn(rng, b, h, sq, d), _randn(rng, b, h, sk, d) + 0.7, _randn(rng, b, h, sk, d)
    jq8, jk8, jv8, jsqk, jsv, jcorr = _jax_int8_kernel_inputs(monkeypatch, q, k, v)
    got = kernel_inputs(_t(q), _t(k), _t(v), 1.0 / np.sqrt(d))
    bh, kp, skp = b * h, -(-d // 32) * 32, -(-sk // 16) * 16
    assert got.q8.shape == (bh, sq, kp) and got.k8.shape == (bh, sk, kp)
    assert got.vt.shape == (bh, d, skp) and got.corr.shape == (bh, skp)
    _codes_close(got.q8[:, :, :d].numpy(), jq8[:, :sq, :d])
    _codes_close(got.k8[:, :, :d].numpy(), jk8[:, :sk, :d])
    assert not got.q8[:, :, d:].any() and not got.k8[:, :, d:].any()
    # vᵀ back in kv order: position 4a + 2b + c of a group holds kv 8b + 2a + c
    order = permute_kv(torch.arange(skp)[None])[0]
    vt = np.zeros((bh, d, skp), np.int8)
    vt[:, :, order.numpy()] = got.vt.numpy()
    _codes_close(vt[:, :, :sk], jv8[:, :sk, :d].transpose(0, 2, 1))
    assert not vt[:, :, sk:].any() and not got.corr[:, sk:].any()
    np.testing.assert_allclose(got.sqk.numpy(), jsqk.reshape(bh), rtol=1e-6)
    np.testing.assert_allclose(got.sv.numpy(), jsv[:, 0, :d], rtol=1e-6)
    np.testing.assert_allclose(got.corr[:, :sk].numpy(), jcorr[:, 0, :sk], rtol=0,
                               atol=1e-6 * np.abs(jcorr).max())


def test_flash_attention_int8_kernel_layout_gives_p_v():
    """K6 builds the A registers of p·v (wgmma s8, mma.m16n8k32's A
    fragment over a warp's 16 rows) from the s32 accumulator values of q·kᵀ
    that a thread already holds, and reads B K-major from the vᵀ rows of the
    layout.  Emulate both, lane by lane, over two of K6's kv tiles at
    d = 40, and check that the products add up to p·v."""
    rng = np.random.default_rng(14)
    d = 40
    tile = kv_tile(d)
    rows, kv = 16, 2 * tile
    p = rng.integers(0, 128, (rows, kv)).astype(np.int64)
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, kv - 5, d)).astype(np.int8))
    vt = kernel_layout(torch.zeros(1, 1, d, dtype=torch.int8), torch.zeros(1, 1, d,
                       dtype=torch.int8), v8, torch.ones(1), torch.ones(1, d),
                       torch.zeros(1, kv - 5), torch.zeros(1, 1, d)).vt
    vt = vt[0].numpy().astype(np.int64)  # (d, kv): K-major rows of B
    assert vt.shape == (d, kv)
    v = np.zeros((kv, d), np.int64)
    v[: kv - 5] = v8[0].numpy()
    out = np.zeros((rows, d), np.int64)
    for tile0 in range(0, kv, tile):
        for c in range(tile // 32):
            a = np.zeros((16, 32), np.int64)  # the logical A of this k32 step
            for lane in range(32):
                g, t = lane // 4, lane % 4

                def held(r, j):  # the lane's accumulator values of row r, n8 block j
                    return [p[r, tile0 + j * 8 + 2 * t + e] for e in (0, 1)]

                for r in (g, g + 8):
                    # pack_p: a[0]/a[1] (row g/g+8, cols 4t..4t+3) from blocks
                    # 4c, 4c+1; a[2]/a[3] (cols 16+4t..) from blocks 4c+2, 4c+3
                    a[r, 4 * t: 4 * t + 4] = held(r, 4 * c) + held(r, 4 * c + 1)
                    a[r, 16 + 4 * t: 20 + 4 * t] = held(r, 4 * c + 2) + held(r, 4 * c + 3)
            b = vt[:, tile0 + 32 * c: tile0 + 32 * c + 32].T  # (k, n), K-major
            out += a @ b
    np.testing.assert_array_equal(out, p @ v)


@pytest.mark.parametrize("b,h", [(1, 2), (2, 3), (1, 1)])
def test_flash_attention_int8_kernel_inputs_are_contiguous(b, h):
    """K6 indexes its inputs as contiguous arrays; with one batch the
    head-split views reshape to (BH, S, D) without a copy, so the layout
    must ask for contiguity itself."""
    rng = np.random.default_rng(16)
    sq, sk, d = 40, 77, 16

    def heads(s):  # a head-split view of a (B, S, H·D) projection
        return _t(_randn(rng, b, s, h * d)).view(b, s, h, d).transpose(1, 2)

    q, k, v = heads(sq), heads(sk), heads(sk)
    got = kernel_inputs(q, k, v, 0.25)
    assert all(t.is_contiguous() for t in got)
    for a, r in zip(got, kernel_layout(*quantize_qkv(q, k, v, 0.25))):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
    assert got.vt.shape == (b * h, d, 80) and got.corr.shape == (b * h, 80)
    assert got.q8.shape == (b * h, sq, 32) and got.vm.shape == (b * h, d)


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
    """Every route JAX has, as JAX maps it; and the LayerNorm's, which JAX
    lacks (its LayerNorm is one XLA fusion): the auto rule, or the plain
    form with the kernels off."""
    knobs = {name: bool(bits >> i & 1) for i, name in enumerate(_KNOBS)}
    ours = backends(CompilationConfig(enable_kernels=kernels, **knobs))
    theirs = j_backends(JaxConfig(enable_pallas=kernels, **knobs))
    names = {"xla": "plain", "pallas": "kernel"}
    assert ours.pop("ln") == (None if kernels else "plain")
    assert ours == {key: names.get(val, val) for key, val in theirs.items()}


def test_optin_config_defaults_mirror_jax():
    ours, theirs = dataclasses.asdict(CompilationConfig()), dataclasses.asdict(JaxConfig())
    assert {k: ours[k] for k in _KNOBS} == {k: theirs[k] for k in _KNOBS}
