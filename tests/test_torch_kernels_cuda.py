"""The hand-written CUDA kernels against their plain versions, on a card.

Edge cases beyond the main-path shapes that ``chip_smoke.py`` checks:
ragged and strided tensors, other head dims, causal masking, odd spatial
sizes, narrow channels, the epilogue options and the input checks.  Every
test skips without a CUDA card.  The file imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances are those of ``chip_smoke.py``: relative rms 1e-2 for K1 and
2e-2 for K2 outputs in bf16, 1e-3 relative for the f32 statistics (Σy
against Σ|y|, since Σy may cancel); K5 and K4 within 1e-2 rms of their
f32 plain versions (bf16 output rounding), and the fused GroupNorm's y
within 1e-2 and its statistics within 1e-3 of K3 then K5 in plain torch;
K6 within 2e-2 rms of its plain
version at the kernel's tile (the same math; exp2 and the order of sums
flip a few int8 roundings of p) and 0.015 of exact attention; K6's
pre-processing within one int8 level of its plain version on at most 0.1%
of the codes (the means are summed in another order) and 1e-6 relative in
its f32 outputs.
"""

import pytest
import torch

from sfast_tpu_torch.ops import fused_conv
from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
from sfast_tpu_torch.ops.flash_attention_int8 import (
    flash_attention_int8,
    flash_attention_int8_ref,
    kernel_inputs,
    kv_tile,
    quantize_qkv_cuda,
)
from sfast_tpu_torch.ops.geglu import linear_geglu_fused, linear_geglu_fused_ref
from sfast_tpu_torch.ops.group_norm import (
    fused_plan,
    group_norm,
    group_norm_apply,
    group_norm_apply_ref,
    group_norm_fused,
    group_norm_fused_ref,
    group_norm_stats,
    group_norm_stats_ref,
)
from sfast_tpu_torch.runtime import cuda_build

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rms_rel(got, ref):
    d = got.float() - ref.float()
    return (d.pow(2).mean().sqrt() / ref.float().pow(2).mean().sqrt()).item()


def _max_rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(BF16)


@pytest.mark.parametrize(
    "b,h,sq,sk,d,causal,strided",
    [
        (1, 2, 300, 77, 40, False, True),    # cross-attention, ragged q and kv
        (2, 4, 1024, 1024, 80, False, True),
        (1, 2, 256, 256, 64, True, False),
        (1, 1, 130, 130, 160, False, False),
        (1, 1, 1, 5, 16, False, False),
        (1, 3, 300, 300, 40, True, True),    # causal at the ones-column head dim
        (1, 2, 300, 300, 160, True, True),   # causal with 64-row kv tiles
        (2, 4, 500, 1000, 56, False, True),  # d padded to 64
    ],
)
def test_flash_attention_matches_plain(dev, b, h, sq, sk, d, causal, strided):
    if strided:  # head-split views of (B, S, H·D), as the UNet passes them
        q = _randn(dev, b, sq, h * d, seed=1).view(b, sq, h, d).transpose(1, 2)
        k = _randn(dev, b, sk, h * d, seed=2).view(b, sk, h, d).transpose(1, 2)
        v = _randn(dev, b, sk, h * d, seed=3).view(b, sk, h, d).transpose(1, 2)
    else:
        q, k, v = (_randn(dev, b, h, s, d, seed=i) for i, s in ((1, sq), (2, sk), (3, sk)))
    before = cuda_build.launch_counts["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["flash_attention"] == before + 1
    assert got.shape == (b, h, sq, d) and got.dtype == BF16
    assert _rms_rel(got, flash_attention_ref(q, k, v, causal=causal)) <= 1e-2


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("sk", [1000, 77 * 3])  # not multiples of the 128- or 64-row kv tile
def test_flash_attention_head_dims_ragged_kv_and_edge_heads(dev, d, sk):
    """Batch 1, head-split views of (1, S, H·d): the kernel's tensor maps
    take d as their innermost extent, so the first head must not see the
    second's columns and the last head's pad columns arrive as zeros (a
    48-wide box at d = 40 would read past it).  Two calls agree bit for
    bit."""
    b, h, sq = 1, 5, 384
    q = _randn(dev, b, sq, h * d, seed=1).view(b, sq, h, d).transpose(1, 2)
    k = _randn(dev, b, sk, h * d, seed=2).view(b, sk, h, d).transpose(1, 2)
    v = _randn(dev, b, sk, h * d, seed=3).view(b, sk, h, d).transpose(1, 2)
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v)
    assert torch.equal(got, again)
    for head in (0, h - 1):
        assert _rms_rel(got[:, head], ref[:, head]) <= 1e-2


def test_flash_attention_rejects_what_it_cannot_run(dev):
    q = torch.zeros(1, 1, 64, 40, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q)
    for d in (30, 192):
        q = torch.zeros(1, 1, 64, d, device=dev, dtype=BF16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, q, q)
    q = torch.zeros(1, 1, 64, 40, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="scale must be positive"):
        flash_attention(q, q, q, scale=-0.1)


@pytest.mark.parametrize(
    "n,h,w,c,f,gn,bias,res,oscale,stats",
    [
        (2, 37, 45, 64, 40, True, "batch", True, 2.0, True),
        (1, 5, 7, 8, 16, True, "batch", False, 1.0, True),
        (1, 130, 129, 128, 136, True, "vector", True, 1.0, False),  # F not a tile multiple
        (2, 16, 16, 32, 32, False, None, False, 1.0, True),
        (1, 35, 21, 256, 264, True, "batch", False, 1.0, True),   # H·W not a patch multiple
        (1, 24, 40, 512, 512, False, "vector", False, 1.0, False),  # 256-channel blocks
        (1, 19, 17, 512, 256, True, "vector", True, 0.5, True),
        (2, 20, 12, 320, 320, True, "batch", True, 1.0, False),   # the UNet's 320 channels
    ],
)
def test_conv3x3_block_matches_plain(dev, n, h, w, c, f, gn, bias, res, oscale, stats):
    g = torch.Generator(device=dev).manual_seed(4)
    x = _randn(dev, n, h, w, c, seed=5)
    wt = (torch.randn((3, 3, c, f), generator=g, device=dev) / (9 * c) ** 0.5).to(BF16)
    if n == 1:  # also the modules' layout: an HWIO view of (F, 3, 3, C) memory
        wt = wt.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    kw = dict(output_scale=oscale, emit_stats=stats)
    if gn:
        kw["gn_scale"] = torch.rand((n, c), generator=g, device=dev) + 0.5
        kw["gn_shift"] = torch.randn((n, c), generator=g, device=dev) * 0.1
    if bias == "batch":
        kw["bias_batch"] = torch.randn((n, f), generator=g, device=dev)
    if res:
        kw["residual"] = _randn(dev, n, h, w, f, seed=6)
    b_vec = torch.randn((f,), generator=g, device=dev) if bias == "vector" else None
    got = fused_conv.conv3x3_block(x, wt, b_vec, **kw)
    torch.cuda.synchronize()
    ref = fused_conv.conv3x3_block_ref(x, wt, b_vec, **kw)
    if stats:
        (got, s1, s2), (ref, r1, r2) = got, ref
        # Σy can cancel to near 0 (no bias), and the plain version rounds y
        # to bf16 before summing, so its error is measured against Σ|y|
        abs_sum = ref.float().abs().sum(dim=(1, 2)).max()
        assert ((s1 - r1).abs().max() / abs_sum).item() <= 1e-3
        assert _max_rel(s2, r2) <= 1e-3
    assert got.shape == (n, h, w, f)
    assert _rms_rel(got, ref) <= 2e-2


@pytest.mark.parametrize("c,f", [(128, 128), (256, 256), (512, 512)])
def test_conv3x3_gn_far_shift_and_repeatable_stats(dev, c, f):
    """A GroupNorm shift far from 0: the halo outside the image must be
    set back to 0 after the affine and SiLU (silu(shift) is about 3 here),
    as the plain version pads after the GroupNorm.  Σy and Σy² agree bit
    for bit across two calls."""
    g = torch.Generator(device=dev).manual_seed(8)
    n, h, w = 1, 21, 27
    x = _randn(dev, n, h, w, c, seed=9)
    wt = (torch.randn((f, 3, 3, c), generator=g, device=dev) / (9 * c) ** 0.5).to(BF16)
    wt = wt.permute(1, 2, 3, 0)
    kw = dict(
        gn_scale=torch.rand((n, c), generator=g, device=dev) + 0.5,
        gn_shift=torch.randn((n, c), generator=g, device=dev) * 0.1 + 3.0,
        bias_batch=torch.randn((n, f), generator=g, device=dev),
        emit_stats=True,
    )
    got, s1, s2 = fused_conv.conv3x3_block(x, wt, **kw)
    _, s1b, s2b = fused_conv.conv3x3_block(x, wt, **kw)
    torch.cuda.synchronize()
    ref, r1, r2 = fused_conv.conv3x3_block_ref(x, wt, **kw)
    assert torch.equal(s1, s1b) and torch.equal(s2, s2b)
    assert _rms_rel(got, ref) <= 2e-2
    # the border rows and columns are where a wrong halo shows
    assert _rms_rel(got[:, [0, -1]], ref[:, [0, -1]]) <= 2e-2
    assert _rms_rel(got[:, :, [0, -1]], ref[:, :, [0, -1]]) <= 2e-2
    assert _max_rel(s2, r2) <= 1e-3


def test_conv3x3_block_rejects_what_it_cannot_run(dev):
    x = torch.zeros(1, 8, 8, 12, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="C % 8"):
        fused_conv.conv3x3_block(x, torch.zeros(3, 3, 12, 16, device=dev, dtype=BF16))
    with pytest.raises(ValueError, match="weight"):
        fused_conv.conv3x3_block(x, torch.zeros(1, 1, 12, 16, device=dev, dtype=BF16))


@pytest.mark.parametrize(
    "n,h,w,c,groups",
    [(2, 37, 45, 64, 32), (1, 9, 7, 40, 4), (3, 64, 64, 320, 32),
     (2, 8, 8, 1280, 32), (2, 64, 64, 960, 32), (2, 8, 8, 2560, 32)],  # UNet: K3′
)
def test_group_norm_stats_matches_plain(dev, n, h, w, c, groups):
    x = _randn(dev, n, h, w, c, seed=7) + 0.5
    mean, rstd = group_norm_stats(x, groups=groups, eps=1e-6)
    torch.cuda.synchronize()
    rm, rr = group_norm_stats_ref(x, groups=groups, eps=1e-6)
    assert _max_rel(mean, rm) <= 1e-3 and _max_rel(rstd, rr) <= 1e-3


def test_group_norm_stats_rejects_f32(dev):
    with pytest.raises(ValueError, match="bf16"):
        group_norm_stats(torch.zeros(1, 4, 4, 64, device=dev), groups=8)


@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("n,h,w,c", [(2, 9, 7, 40), (1, 5, 3, 8), (2, 16, 16, 2560)])
def test_group_norm_apply_matches_plain(dev, act, n, h, w, c):
    x = _randn(dev, n, h, w, c, seed=8) + 0.3
    g = torch.Generator(device=dev).manual_seed(9)
    gamma = torch.rand((c,), generator=g, device=dev) + 0.5
    beta = torch.randn((c,), generator=g, device=dev) * 0.2
    mean, rstd = group_norm_stats(x, groups=8, eps=1e-6)
    before = cuda_build.launch_counts["group_norm_apply"]
    got = group_norm_apply(x, mean, rstd, gamma, beta, act=act)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["group_norm_apply"] == before + 1
    assert got.shape == x.shape and got.dtype == BF16
    assert _rms_rel(got, group_norm_apply_ref(x, mean, rstd, gamma, beta, act=act)) <= 1e-2


def test_group_norm_apply_rejects_what_it_cannot_run(dev):
    stats = (torch.zeros(1, 1, 1, 12, device=dev), torch.ones(1, 1, 1, 12, device=dev))
    one, zero = torch.ones(12, device=dev), torch.zeros(12, device=dev)
    with pytest.raises(ValueError, match="C % 8"):
        group_norm_apply(torch.zeros(1, 4, 4, 12, device=dev, dtype=BF16), *stats, one, zero)
    with pytest.raises(ValueError, match="bf16"):
        group_norm_apply(torch.zeros(1, 4, 4, 16, device=dev), *stats, one, zero)
    with pytest.raises(ValueError, match="activation"):
        group_norm_apply(torch.zeros(1, 4, 4, 16, device=dev, dtype=BF16), *stats, one, zero,
                         act="relu")


def test_group_norm_stats_one_launch_and_repeatable(dev):
    """K3 is one CUDA kernel a call (its fold runs in the same launch) and
    gives the same bits twice, at VAE maps (128²·512, 256²·256) and a
    small UNet map."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for shape in [(1, 128, 128, 512), (2, 16, 16, 2560), (1, 256, 256, 256)]:
        x = _randn(dev, *shape, seed=10) + 0.5
        first = group_norm_stats(x, groups=32, eps=1e-6)
        # the profiler now and then returns a trace with no kernel row;
        # such a trace is taken again
        for _ in range(3):
            before = cuda_build.launch_counts["group_norm_stats"]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                again = group_norm_stats(x, groups=32, eps=1e-6)
                torch.cuda.synchronize()
            assert cuda_build.launch_counts["group_norm_stats"] == before + 1
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if kernels:
                break
        assert [e.count for e in kernels] == [1], [(e.key, e.count) for e in kernels]
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_group_norm_stats_on_two_streams_at_once(dev):
    """K3's fold tickets belong to a stream: calls on two streams that run
    at the same time each fold their own samples."""
    xs = [_randn(dev, 2, 64, 64, 512, seed=s) + 0.5 * s for s in (14, 15)]
    refs = [group_norm_stats_ref(x, groups=32, eps=1e-6) for x in xs]
    streams = [torch.cuda.Stream(device=dev) for _ in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for x, st, out in zip(xs, streams, outs):
            with torch.cuda.stream(st):
                out.append(group_norm_stats(x, groups=32, eps=1e-6))
    torch.cuda.synchronize()
    for out, (rm, rr) in zip(outs, refs):
        for mean, rstd in out:
            assert _max_rel(mean, rm) <= 1e-3 and _max_rel(rstd, rr) <= 1e-3


@pytest.mark.parametrize(
    "n,h,w,c,groups,act,eps",
    [(1, 9, 7, 320, 32, "silu", 1e-5), (3, 5, 3, 256, 32, "gelu", 1e-6),  # batch 3, C = 8·G
     (2, 15, 17, 960, 32, None, 1e-6), (1, 1, 1, 64, 8, "silu", 1e-5),
     (2, 8, 8, 2560, 32, "silu", 1e-5), (2, 64, 64, 960, 32, "silu", 1e-5),
     (1, 128, 128, 512, 32, None, 1e-6), (2, 33, 31, 640, 16, "gelu", 1e-5)],
)
def test_group_norm_fused_matches_plain(dev, n, h, w, c, groups, act, eps):
    x = _randn(dev, n, h, w, c, seed=11) + 0.3
    g = torch.Generator(device=dev).manual_seed(12)
    gamma = torch.rand((c,), generator=g, device=dev) + 0.5
    beta = torch.randn((c,), generator=g, device=dev) * 0.2
    assert fused_plan(n, h * w, c, groups) is not None
    before = cuda_build.launch_counts["group_norm_fused"]
    y, mean, rstd = group_norm_fused(x, gamma, beta, groups=groups, eps=eps, act=act, stats=True)
    again = group_norm_fused(x, gamma, beta, groups=groups, eps=eps, act=act)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["group_norm_fused"] == before + 2
    assert y.shape == x.shape and y.dtype == BF16 and torch.equal(y, again)
    ry, rm, rr = group_norm_fused_ref(x, gamma, beta, groups=groups, eps=eps, act=act)
    assert _max_rel(mean, rm) <= 1e-3 and _max_rel(rstd, rr) <= 1e-3
    assert _rms_rel(y, ry) <= 1e-2


def test_group_norm_kernel_route_is_one_fused_launch(dev):
    x = _randn(dev, 2, 16, 16, 1280, seed=13)
    one, zero = torch.ones(1280, device=dev), torch.zeros(1280, device=dev)
    cuda_build.reset_launch_counts()
    group_norm(x, one, zero, groups=32, act="silu", backend="kernel")
    assert {k: v for k, v in cuda_build.launch_counts.items() if v} == {"group_norm_fused": 1}


def test_group_norm_fused_rejects_what_it_cannot_run(dev):
    one, zero = torch.ones(12, device=dev), torch.zeros(12, device=dev)
    with pytest.raises(ValueError, match="C % 8"):
        group_norm_fused(torch.zeros(1, 4, 4, 12, device=dev, dtype=BF16), one, zero, groups=4)
    with pytest.raises(ValueError, match="bf16"):
        group_norm_fused(torch.zeros(1, 4, 4, 16, device=dev), one[:8].repeat(2),
                         zero[:8].repeat(2), groups=4)
    with pytest.raises(ValueError, match="activation"):
        group_norm_fused(torch.zeros(1, 4, 4, 16, device=dev, dtype=BF16), one[:8].repeat(2),
                         zero[:8].repeat(2), groups=4, act="relu")


@pytest.mark.parametrize("f", [64, 320, 2560])
@pytest.mark.parametrize("k", [32, 96, 640, 1280])
@pytest.mark.parametrize("m", [1, 18, 130, 2048])
def test_linear_geglu_matches_plain(dev, m, k, f):
    """Any M, a K tail narrower than the kernel's 64-wide k tile, a bf16, an
    f32 or no bias, and an x that is not 16-byte aligned."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = _randn(dev, m, k, seed=11)
    w = (torch.randn((2 * f, k), generator=g, device=dev) / k**0.5).to(BF16)
    b = torch.randn((2 * f,), generator=g, device=dev)
    unaligned = torch.empty(m * k + 8, device=dev, dtype=BF16)[1: 1 + m * k].view(m, k)
    unaligned.copy_(x)
    for xx, bb in ((x, b.to(BF16)), (x, b), (x, None), (unaligned, b.to(BF16))):
        before = cuda_build.launch_counts["linear_geglu"]
        got = linear_geglu_fused(xx, w, bb)
        torch.cuda.synchronize()
        assert cuda_build.launch_counts["linear_geglu"] == before + 1
        assert got.shape == (m, f) and got.dtype == BF16
        assert _rms_rel(got, linear_geglu_fused_ref(x, w, bb)) <= 1e-2


def test_linear_geglu_leading_dims(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    x = _randn(dev, 2, 77, 640, seed=13)
    w = (torch.randn((2 * 2560, 640), generator=g, device=dev) / 640**0.5).to(BF16)
    got = linear_geglu_fused(x, w)
    assert got.shape == (2, 77, 2560)
    assert _rms_rel(got, linear_geglu_fused_ref(x, w)) <= 1e-2


def test_linear_geglu_rejects_what_it_cannot_run(dev):
    x = torch.zeros(4, 40, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="K % 32"):
        linear_geglu_fused(x, torch.zeros(128, 40, device=dev, dtype=BF16))
    x = torch.zeros(4, 64, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="F % 64"):
        linear_geglu_fused(x, torch.zeros(96, 64, device=dev, dtype=BF16))
    with pytest.raises(ValueError, match="bf16"):
        linear_geglu_fused(x.float(), torch.zeros(128, 64, device=dev))
    w = torch.zeros(128, 64, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match=r"b \(2F,\)"):
        linear_geglu_fused(x, w, torch.zeros(64, device=dev))


def _heads(dev, b, s, h, d, seed, shift=0.0):
    """A head-split (B, H, S, D) view of a (B, S, H·D) projection, as the
    UNet passes q, k and v."""
    x = _randn(dev, b, s, h * d, seed=seed).float() + shift
    return x.to(BF16).view(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("batch,causal", [(1, False), (2, True)])
@pytest.mark.parametrize("sk", [64, 231, 1000, 4096])
@pytest.mark.parametrize("d", [32, 40, 64, 80, 160])
def test_flash_attention_int8_matches_plain(dev, d, sk, batch, causal):
    """Head-split views, held at the first and the last head against the
    plain version at the kernel's tile and against exact attention; two
    calls agree bit for bit."""
    h, sq = 3, 300 if sk < 4096 else 4096
    q, k, v = _heads(dev, batch, sq, h, d, 12), _heads(dev, batch, sk, h, d, 13, 0.5), \
        _heads(dev, batch, sk, h, d, 14, -0.3)
    before = dict(cuda_build.launch_counts)
    got = flash_attention_int8(q, k, v, causal=causal)
    again = flash_attention_int8(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["flash_attention_int8"] == before["flash_attention_int8"] + 2
    assert cuda_build.launch_counts["quantize_qkv"] == before["quantize_qkv"] + 2
    assert got.shape == (batch, h, sq, d) and got.dtype == BF16
    assert torch.equal(got, again)
    ref = flash_attention_int8_ref(q, k, v, causal=causal, block_k=kv_tile(d))
    exact = flash_attention_ref(q, k, v, causal=causal)
    for head in (0, h - 1):
        assert _rms_rel(got[:, head], ref[:, head]) <= 2e-2
        assert _rms_rel(got[:, head], exact[:, head]) <= 0.015


@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 8, 4096, 4096, 40), (1, 3, 300, 77, 40),
                                         (2, 2, 256, 231, 80), (1, 1, 130, 1000, 160)])
def test_quantize_qkv_matches_plain(dev, b, h, sq, sk, d):
    q, k, v = _heads(dev, b, sq, h, d, 15), _heads(dev, b, sk, h, d, 16, 0.5), \
        _heads(dev, b, sk, h, d, 17, -0.3)
    got = quantize_qkv_cuda(q, k, v, d ** -0.5)
    again = quantize_qkv_cuda(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    ref = kernel_inputs(q.float(), k.float(), v.float(), d ** -0.5)
    for name, a, r, a2 in zip(got._fields, got, ref, again):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.equal(a, a2), name
        if a.dtype == torch.int8:
            diff = (a.int() - r.int()).abs()
            assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3, name
        else:
            assert _max_rel(a, r) <= 1e-6, name


def test_flash_attention_int8_rejects_what_it_cannot_run(dev):
    q = torch.zeros(1, 1, 64, 40, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_int8(q, q, q)
    for d in (36, 192):
        q = torch.zeros(1, 1, 64, d, device=dev, dtype=BF16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_int8(q, q, q)
