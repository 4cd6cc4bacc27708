"""The hand-written CUDA kernels against their plain versions, on a card.

Edge cases beyond the main-path shapes that ``chip_smoke.py`` checks:
ragged and strided tensors, other head dims, causal masking, odd spatial
sizes, narrow channels, the epilogue options and the input checks.  Every
test skips without a CUDA card.  The file imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

The int8 products of the quantized paths (``torch._int_mm``, a library
call, and the W8A8 conv's im2col on it) equal their plain f64 versions
exactly; the quantized ops on the card are within 2^-7 of their largest
output (a bf16 rounding or two) of the same ops on the CPU.

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
its f32 outputs.  K7 (the LayerNorm) against the plain form on the card:
at most one bf16 ulp of |y| on any element, |y| taken at least 2^-10
(below that the gap is set by the f32 statistics, which both compute, not
by the rounding of y), and a mean absolute gap under 1e-3 of the mean |y|.
"""

import dataclasses

import pytest
import torch

from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.models import TINY_UNET, UNet2DConditionModel, init_weights_
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
from sfast_tpu_torch.ops.layer_norm import layer_norm, layer_norm_fused, layer_norm_plain
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step

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


@pytest.mark.parametrize("b,h,s", [(2, 10, 4096), (2, 20, 1024)], ids=["64^2", "32^2"])
def test_flash_attention_at_the_sdxl_shapes(dev, b, h, s):
    """SDXL 1024²'s self-attention at head dim 64 (``launch<64, ...>``):
    10 heads over the 64² level's 4096 tokens and 20 over the 32² level's
    1024, as head-split views of (B, S, H·64); two calls agree bit for
    bit."""
    d = 64
    q, k, v = (_randn(dev, b, s, h * d, seed=i).view(b, s, h, d).transpose(1, 2)
               for i in (1, 2, 3))
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rms_rel(got, flash_attention_ref(q, k, v)) <= 1e-2


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
     (2, 8, 8, 1280, 32), (2, 64, 64, 960, 32), (2, 8, 8, 2560, 32),  # UNet: K3′
     (2, 128, 128, 960, 32)],  # SDXL's 128²·960, which the fused GroupNorm does not take
)
def test_group_norm_stats_matches_plain(dev, n, h, w, c, groups):
    x = _randn(dev, n, h, w, c, seed=7) + 0.5
    mean, rstd = group_norm_stats(x, groups=groups, eps=1e-6)
    torch.cuda.synchronize()
    rm, rr = group_norm_stats_ref(x, groups=groups, eps=1e-6)
    assert _max_rel(mean, rm) <= 1e-3 and _max_rel(rstd, rr) <= 1e-3


# The VAE encoder's fused resnets widen the channels in conv1, which no
# decoder call does: K2 at 256²·128→256 and 128²·256→512, K3 on their inputs
@pytest.mark.parametrize("hw,c,f", [(256, 128, 256), (128, 256, 512)])
def test_encoder_conv1_matches_plain(dev, hw, c, f):
    g = torch.Generator(device=dev).manual_seed(10)
    x = _randn(dev, 1, hw, hw, c, seed=11)
    wt = (torch.randn((f, 3, 3, c), generator=g, device=dev) / (9 * c) ** 0.5).to(BF16)
    wt = wt.permute(1, 2, 3, 0)
    kw = dict(gn_scale=torch.rand((1, c), generator=g, device=dev) + 0.5,
              gn_shift=torch.randn((1, c), generator=g, device=dev) * 0.1,
              bias_batch=torch.randn((1, f), generator=g, device=dev), emit_stats=True)
    got, s1, s2 = fused_conv.conv3x3_block(x, wt, **kw)
    torch.cuda.synchronize()
    ref, r1, r2 = fused_conv.conv3x3_block_ref(x, wt, **kw)
    assert got.shape == (1, hw, hw, f)
    assert _rms_rel(got, ref) <= 2e-2
    assert _max_rel(s1, r1) <= 1e-3 and _max_rel(s2, r2) <= 1e-3


@pytest.mark.parametrize("hw,c", [(256, 128), (128, 256)])
def test_encoder_group_norm_stats_matches_plain(dev, hw, c):
    x = _randn(dev, 1, hw, hw, c, seed=12) + 0.5
    mean, rstd = group_norm_stats(x, groups=32, eps=1e-6)
    torch.cuda.synchronize()
    rm, rr = group_norm_stats_ref(x, groups=32, eps=1e-6)
    assert _max_rel(mean, rm) <= 1e-3 and _max_rel(rstd, rr) <= 1e-3


def test_widening_resnet_kernel_route_matches_plain(dev):
    """The whole fused resnet at the encoder's 256²·128→256: K3, conv1, and
    conv2 with the 1×1 shortcut's output as its residual."""
    from sfast_tpu_torch.models.layers import ResnetBlock2D, init_weights_

    rn = init_weights_(ResnetBlock2D(128, 256, None, groups=32, eps=1e-6, device=dev,
                                     dtype=BF16), torch.Generator(device=dev).manual_seed(13))
    x = _randn(dev, 1, 256, 256, 128, seed=14)
    with torch.no_grad():
        got, ref = rn(x), rn(x, conv_backend="plain")
    assert rn.conv_shortcut is not None and got.shape == (1, 256, 256, 256)
    assert _rms_rel(got, ref) <= 2e-2


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
     (1, 128, 128, 512, 32, None, 1e-6), (2, 33, 31, 640, 16, "gelu", 1e-5),
     (2, 128, 128, 320, 32, "silu", 1e-5), (2, 128, 128, 640, 32, "silu", 1e-5)],  # SDXL 128²
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


# (M, C): the instantiated widths at the UNets' rows (SVD's level 0 spatial
# and temporal, 460,800 rows of 320; its level 1, 115,200 of 640; its level
# 2, 28,800 of 1280; SDXL's 8,192 of 640 and 2,048 of 1280; SD1.5's 8,192
# of 320), short and ragged row counts, and the generic path's widths
LN_CASES = [(1, 320), (37, 640), (4096, 768), (300, 1024), (2048, 1280), (8192, 320),
            (8192, 640), (28800, 1280), (115200, 640), (460800, 320),
            (513, 200), (3, 4096), (1000, 8), (77, 1152)]


def _ln_inputs(dev, m, c, seed):
    """Rows off zero mean (the E[x²] − E[x]² form at work) and LayerNorm
    weights as trained ones look: gamma near 1, beta near 0."""
    x = (_randn(dev, m, c, seed=seed).float() * 1.5 + 0.75).to(BF16)
    g = 1 + 0.1 * _randn(dev, c, seed=seed + 1).float()
    b = 0.1 * _randn(dev, c, seed=seed + 2).float()
    return x, g, b


def _assert_ln_close(got, ref):
    got, ref = got.float(), ref.float()
    gap = (got - ref).abs()
    scale = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -10)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    assert bool((gap <= ulp).all()), f"{int((gap > ulp).sum())} elements beyond one bf16 ulp"
    assert gap.mean().item() < 1e-3 * ref.abs().mean().item()


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "bare"])
@pytest.mark.parametrize("m,c", LN_CASES)
def test_layer_norm_matches_plain(dev, m, c, affine):
    x, g, b = _ln_inputs(dev, m, c, seed=70)
    g, b = (g, b) if affine else (None, None)
    before = cuda_build.launch_counts["layer_norm"]
    with torch.no_grad():
        got = layer_norm_fused(x, g, b)
        ref = layer_norm_plain(x, g, b)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["layer_norm"] == before + 1
    assert got.shape == x.shape and got.dtype == BF16
    _assert_ln_close(got, ref)


def test_layer_norm_leading_dims_and_strided_rows(dev):
    """(B, S, C) rows, a slice of wider rows (read at their stride, no
    copy) and rows that are no uniform run (copied first)."""
    x, g, b = _ln_inputs(dev, 2 * 300, 640 + 64, seed=71)
    wide = x.reshape(2, 300, 704)
    for view in (wide[..., :640].contiguous(), wide[..., :640], wide[..., 64:],
                 wide[..., :640].transpose(0, 1)):
        got = layer_norm_fused(view, g[:640], b[:640])
        _assert_ln_close(got, layer_norm_plain(view, g[:640], b[:640]))


def test_layer_norm_rule_routes_bf16_to_k7(dev):
    x, g, b = _ln_inputs(dev, 64, 320, seed=72)
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        layer_norm(x, g, b)
        layer_norm(x.float(), g, b)  # f32: the plain form
        layer_norm(x, g, b, backend="plain")
    with torch.enable_grad():  # autograd records the call: the plain form
        layer_norm(x, g.clone().requires_grad_(), b)
    assert {k: v for k, v in cuda_build.launch_counts.items() if v} == {"layer_norm": 1}


def test_layer_norm_in_a_cuda_graph_equals_eager(dev):
    """Captured at SDXL's level-1 rows: the replay equals the eager call bit
    for bit, and follows new values written into the input."""
    x, g, b = _ln_inputs(dev, 8192, 640, seed=73)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad():
        with torch.cuda.stream(side):
            layer_norm_fused(x, g, b)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = layer_norm_fused(x, g, b)
        for seed in (74, 75):
            x.copy_(_ln_inputs(dev, 8192, 640, seed=seed)[0])
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, layer_norm_fused(x, g, b))


def test_layer_norm_rejects_what_it_cannot_run(dev):
    with pytest.raises(ValueError, match="bf16"):
        layer_norm_fused(torch.zeros(4, 64, device=dev))
    with pytest.raises(ValueError, match="C % 8"):
        layer_norm_fused(torch.zeros(4, 20, device=dev, dtype=BF16))
    with pytest.raises(ValueError, match="C <= 4096"):
        layer_norm_fused(torch.zeros(4, 8192, device=dev, dtype=BF16))
    with pytest.raises(ValueError, match="gamma"):
        layer_norm_fused(torch.zeros(4, 64, device=dev, dtype=BF16), torch.ones(32, device=dev))


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


# ---------------------------------------------------------------------------
# Stable Video Diffusion's shapes: K1 at batch 50 (the CFG pair of 25
# frames) over 576×1024's 9,216 and 2,304 tokens, K2 and K3 at the temporal
# decoder's 576×1024 maps for a chunk of frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,s", [(5, 9216), (10, 2304)], ids=["level0", "level1"])
def test_flash_attention_at_the_svd_shapes(dev, h, s):
    """(50, h, s, 64) head-split views; the plain version on the first and
    last batch rows (its f32 scores at the whole level-0 shape would take
    85 GB).  Two calls agree bit for bit."""
    b, d = 50, 64
    q, k, v = (_randn(dev, b, s, h * d, seed=i).view(b, s, h, d).transpose(1, 2)
               for i in (31, 32, 33))
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    rows = [0, b - 1]
    assert _rms_rel(got[rows], flash_attention_ref(q[rows], k[rows], v[rows])) <= 1e-2


def _svd_conv1(dev, n, c, f, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(dev, n, 576, 1024, c, seed=seed + 1)
    wt = (torch.randn((f, 3, 3, c), generator=g, device=dev) / (9 * c) ** 0.5).to(BF16)
    kw = dict(gn_scale=torch.rand((n, c), generator=g, device=dev) + 0.5,
              gn_shift=torch.randn((n, c), generator=g, device=dev) * 0.1,
              bias_batch=torch.randn((n, f), generator=g, device=dev), emit_stats=True)
    return x, wt.permute(1, 2, 3, 0), kw


@pytest.mark.parametrize("n", [5, 25], ids=["chunk5", "chunk25"])
def test_conv3x3_at_the_svd_decoder_shape(dev, n):
    """The decoder's conv1 at 576×1024·256→128 for a chunk of 5 frames, and
    of 25, whose input of 3.8·10⁹ elements is beyond 2³¹: the kernel's
    offsets are 64-bit.  A conv is per frame, so the plain version runs on
    3 frames of the 25."""
    x, wt, kw = _svd_conv1(dev, n, 256, 128, 34)
    got, s1, s2 = fused_conv.conv3x3_block(x, wt, **kw)
    torch.cuda.synchronize()
    frames = [0, n // 2, n - 1]
    ref, r1, r2 = fused_conv.conv3x3_block_ref(
        x[frames], wt, **{k: v[frames] if torch.is_tensor(v) else v for k, v in kw.items()})
    assert got.shape == (n, 576, 1024, 128)
    assert _rms_rel(got[frames], ref) <= 2e-2
    assert _max_rel(s2[frames], r2) <= 1e-3
    abs_sum = ref.float().abs().sum(dim=(1, 2)).max()
    assert ((s1[frames] - r1).abs().max() / abs_sum).item() <= 1e-3


@pytest.mark.parametrize("n,c", [(5, 128), (25, 256)], ids=["chunk5", "chunk25"])
def test_group_norm_stats_at_the_svd_decoder_shape(dev, n, c):
    x = _randn(dev, n, 576, 1024, c, seed=36) + 0.5
    mean, rstd = group_norm_stats(x, groups=32, eps=1e-6)
    torch.cuda.synchronize()
    frames = [0, n - 1]
    rm, rr = group_norm_stats_ref(x[frames], groups=32, eps=1e-6)
    assert _max_rel(mean[frames], rm) <= 1e-3 and _max_rel(rstd[frames], rr) <= 1e-3


# ---------------------------------------------------------------------------
# the int8 products of the quantized paths (torch._int_mm, a library call)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [
    (8192, 640, 5120),  # SDXL's level-1 GEGLU proj
    (4, 1024, 320),     # SVD's to_k on one image token at 2 frames: M at most 16
    (50, 12, 20),       # K and N not multiples of 8
])
def test_int_mm_is_exact_at_every_shape(dev, m, k, n):
    """cuBLASLt's int32 sums equal the plain f64 product; ``_int_mm``'s shape
    rules (M above 16, K and N multiples of 8) are met by zero padding."""
    from sfast_tpu_torch.ops.quant import int_mm, int_mm_ref

    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    got = int_mm(a, w.t())
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, int_mm_ref(a, w.t()))


@pytest.mark.parametrize("n,h,w,c,f,kh,kw,stride,pad", [
    (2, 64, 64, 960, 320, 3, 3, 1, 1),    # SD1.5's up_blocks.3.resnets.0.conv1
    (2, 32, 32, 320, 320, 3, 3, 2, 1),    # a downsampler
    (2, 16, 16, 640, 320, 1, 1, 1, 0),    # a conv_shortcut
    (2, 4, 1152, 320, 320, 3, 1, 1, (1, 0)),  # SVD's temporal conv on the folded plane
])
def test_w8a8_conv_is_exact(dev, n, h, w, c, f, kh, kw, stride, pad):
    from sfast_tpu_torch.ops.quant import int_conv2d, int_conv2d_ref

    g = torch.Generator(device=dev).manual_seed(4)
    xq = torch.randint(-127, 128, (n, h, w, c), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (f, c, kh, kw), generator=g, device=dev, dtype=torch.int8)
    wq = wq.contiguous(memory_format=torch.channels_last)
    got = int_conv2d(xq, wq, stride=stride, padding=pad)
    assert got.dtype == torch.int32
    assert torch.equal(got, int_conv2d_ref(xq, wq, stride=stride, padding=pad))


def test_quantized_linears_and_convs_match_their_cpu_route(dev):
    """The W8A16, dynamic and static W8A8 ops on the card against the same
    ops on the CPU (the plain int32 product): int8 codes and int32 sums are
    the same, so bf16 outputs agree to one bf16 rounding."""
    from sfast_tpu_torch.ops import quant as q

    x = _randn(dev, 2, 77, 640, seed=5)
    w = _randn(dev, 1280, 640, seed=6) / 25
    b = _randn(dev, 1280, seed=7)
    wq, ws = q.quantize_weight(w)
    a = (x.float().abs().amax() / 127).reshape(())
    for fn in (lambda *t: q.linear_w8a8(t[0], t[1], t[2], t[3], act="gelu"),
               lambda *t: q.linear_w8a8_static(t[0], t[1], t[2], t[4], t[3]),
               lambda *t: q.int8_linear(t[0], t[1], t[2], t[3])):
        got = fn(x, wq, ws, b, a)
        ref = fn(*(t.cpu() for t in (x, wq, ws, b, a)))
        assert _max_rel(got.cpu(), ref) <= 2 ** -7
    xc = _randn(dev, 2, 32, 32, 320, seed=8)
    cw = _randn(dev, 320, 320, 3, 3, seed=9) / 54
    cq, cs = q.quantize_conv_weight(cw)
    got = q.conv2d_w8a8(xc, cq, cs, b[:320], padding=1, act="silu")
    ref = q.conv2d_w8a8(xc.cpu(), cq.cpu(), cs.cpu(), b[:320].cpu(), padding=1, act="silu")
    assert _max_rel(got.cpu(), ref) <= 2 ** -7


# ---------------------------------------------------------------------------
# SDXL 1024² under the opt-in configuration: K4, K6 at head dim 64, K2 on
# the UNet's 128² resnets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,f", [(8192, 640, 2560), (2048, 1280, 5120)])
def test_linear_geglu_at_the_sdxl_shapes(dev, m, k, f):
    g = torch.Generator(device=dev).manual_seed(40)
    x = _randn(dev, m, k, seed=41)
    w = (torch.randn((2 * f, k), generator=g, device=dev) / k**0.5).to(BF16)
    b = (torch.randn((2 * f,), generator=g, device=dev) * 0.1).to(BF16)
    got = linear_geglu_fused(x, w, b)
    torch.cuda.synchronize()
    assert _rms_rel(got, linear_geglu_fused_ref(x, w, b)) <= 1e-2


@pytest.mark.parametrize("b,h,s", [(2, 10, 4096), (2, 20, 1024)], ids=["64^2", "32^2"])
def test_flash_attention_int8_at_the_sdxl_shapes(dev, b, h, s):
    d = 64
    q, k, v = (_randn(dev, b, s, h * d, seed=i).view(b, s, h, d).transpose(1, 2) + off
               for i, off in ((42, 0.0), (43, 0.5), (44, -0.3)))
    got = flash_attention_int8(q, k, v)
    again = flash_attention_int8(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rms_rel(got, flash_attention_int8_ref(q, k, v, block_k=kv_tile(d))) <= 2e-2
    assert _rms_rel(got, flash_attention_ref(q, k, v)) <= 0.015


@pytest.mark.parametrize("c,f,kind", [(960, 320, "conv1"), (320, 320, "conv2"),
                                      (640, 640, "upsample")])
def test_conv3x3_at_the_sdxl_unet_shapes(dev, c, f, kind):
    g = torch.Generator(device=dev).manual_seed(45)
    n = 2
    x = _randn(dev, n, 128, 128, c, seed=46)
    wt = (torch.randn((f, 3, 3, c), generator=g, device=dev) / (9 * c) ** 0.5).to(BF16)
    wt = wt.permute(1, 2, 3, 0)
    kw = {}
    if kind != "upsample":
        kw.update(gn_scale=torch.rand((n, c), generator=g, device=dev) + 0.5,
                  gn_shift=torch.randn((n, c), generator=g, device=dev) * 0.1)
    if kind == "conv1":
        kw.update(bias_batch=torch.randn((n, f), generator=g, device=dev), emit_stats=True)
    else:
        kw["bias"] = torch.randn((f,), generator=g, device=dev)
    if kind == "conv2":
        kw["residual"] = _randn(dev, n, 128, 128, f, seed=47)
    got = fused_conv.conv3x3_block(x, wt, **kw)
    torch.cuda.synchronize()
    ref = fused_conv.conv3x3_block_ref(x, wt, **kw)
    if kind == "conv1":
        (got, s1, s2), (ref, r1, r2) = got, ref
        assert _max_rel(s1, r1) <= 1e-3 and _max_rel(s2, r2) <= 1e-3
    assert _rms_rel(got, ref) <= 2e-2


def _grad_cases(dev):
    """kernel name → (wrapper, its inputs, the first requiring grad)."""
    def leaf(t):
        return t.detach().requires_grad_(True)

    q, k, v = (_randn(dev, 1, 2, 1024, 40, seed=s) for s in (50, 51, 52))
    x = _randn(dev, 2, 16, 16, 320, seed=53)
    c = x.shape[-1]
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    mean, rstd = group_norm_stats(x, groups=32)
    w3 = (_randn(dev, 64, 3, 3, c, seed=54) / 54).permute(1, 2, 3, 0)
    xg, wg = _randn(dev, 128, 128, seed=55), _randn(dev, 512, 128, seed=56) / 12
    return {
        "flash_attention": (flash_attention, (leaf(q), k, v)),
        "flash_attention_int8": (flash_attention_int8, (leaf(q), k, v)),
        "group_norm_stats": (lambda x: group_norm_stats(x, groups=32), (leaf(x),)),
        "group_norm_apply": (group_norm_apply, (leaf(x), mean, rstd, ones, zeros)),
        "group_norm_fused": (lambda x, g, b: group_norm_fused(x, g, b, groups=32),
                             (leaf(x), ones, zeros)),
        "conv3x3": (fused_conv.conv3x3_block, (leaf(x), w3)),
        "linear_geglu": (linear_geglu_fused, (leaf(xg), wg)),
        "layer_norm": (layer_norm_fused, (leaf(x), ones, zeros)),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_int8",
                                    "group_norm_stats", "group_norm_apply",
                                    "group_norm_fused", "conv3x3", "linear_geglu",
                                    "layer_norm"])
def test_a_launch_under_autograd_refuses_the_backward(dev, kernel):
    """Each wrapper with an input that requires grad: the forward launches
    and gives the values it gives under ``no_grad``; the backward raises,
    naming the kernel and ``enable_kernels=False``."""
    fn, inputs = _grad_cases(dev)[kernel]
    with torch.no_grad():
        ref = fn(*inputs)
    got = fn(*inputs)
    outs = [t for t in (got if isinstance(got, tuple) else (got,)) if t is not None]
    refs = [t for t in (ref if isinstance(ref, tuple) else (ref,)) if t is not None]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, refs))
    assert all(t.requires_grad for t in outs)
    name = "quantize_qkv|flash_attention_int8" if kernel == "flash_attention_int8" else kernel
    with pytest.raises(RuntimeError, match=f"({name}): .*enable_kernels=False"):
        sum(t.float().sum() for t in outs).backward()


def test_lora_train_step_on_the_card(dev):
    """The trainer on a tiny bf16 UNet whose three level-0
    self-attentions (32² latents: 1,024 tokens) take K1 under the default
    configuration: with ``enable_kernels=False`` a step launches nothing
    and moves every B; under the default the backward raises, and the LoRA
    and the optimizer's state stay as they were."""
    g = torch.Generator(device=dev).manual_seed(60)
    cfg = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
    unet = init_weights_(UNet2DConditionModel(cfg, device=dev, dtype=BF16), g)
    batch = {"latents": torch.randn((2, 32, 32, 4), generator=g, device=dev),
             "context": torch.randn((2, 7, 64), generator=g, device=dev)}
    lora, opt = lora_training_setup(unet, rank=2)
    step = make_lora_train_step(unet, opt, ccfg=CompilationConfig(enable_kernels=False))
    cuda_build.reset_launch_counts()
    loss = step(lora, batch, torch.Generator(device=dev).manual_seed(61))
    assert torch.isfinite(loss) and not any(cuda_build.launch_counts.values())
    assert all(f["b"].abs().max() > 0 for f in lora.values())
    before = {m: {k: f[k].detach().clone() for k in ("a", "b")} for m, f in lora.items()}
    state = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.state.items()}
    default = make_lora_train_step(unet, opt)
    with pytest.raises(RuntimeError, match="flash_attention: .*enable_kernels=False"):
        default(lora, batch, torch.Generator(device=dev).manual_seed(62))
    assert cuda_build.launch_counts["flash_attention"] == 3  # level 0: 1 down, 2 up
    assert all(torch.equal(f[k], before[m][k]) for m, f in lora.items() for k in ("a", "b"))
    assert all(torch.equal(opt.state[p][k], v) for p in opt.state
               for k, v in state[id(p)].items())
