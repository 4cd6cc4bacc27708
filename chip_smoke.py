#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sfast_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   the torch / CUDA versions;
2. build the hand-written kernels from ``sfast_tpu_torch/csrc`` (nvcc, into
   ``build/sfast_tpu_torch/``) and print the build seconds;
3. hold each kernel against its plain PyTorch version in bf16 at the shapes
   the main path gives it, and time both: CUDA events around one call,
   and the device time of its kernels (torch.profiler); time beside it the
   one PyTorch call that computes the same function where there is one
   (``library_ms``), and state its bound (``bound_ms``: operations over
   the peak rate against bytes over the memory rate) and the share of it
   reached.  K6 is timed whole and as its two parts, the pre-processing
   (``quantize_qkv``) and the body, beside K1 at the same shape; the fused
   GroupNorm beside K3+K5 and the library GroupNorm at every UNet
   GroupNorm shape, with both routes' sums over one UNet eval;
4. run SD1.5 text2img at full width with seeded random weights — 512²,
   batch 1, DPM++ 50 steps, CFG 7.5 — through ``StableDiffusionPipeline``;
   count the kernel launches of one image, time 3 more, check the image,
   profile one more (device time, the device's idle share and the count
   of CUDA kernels an image launches; a trace whose rows of the port's
   kernels disagree with the counted launches is taken again), and hold
   one UNet eval and one VAE decode against the plain route;
5. the same pipeline under the opt-in kernel configuration
   (``enable_fused_group_norm``, ``enable_fused_linear_geglu``,
   ``enable_int8_attention``), which takes the fused GroupNorm (the
   counterpart of K3′+K5), K4 and K6 in the UNet:
   the same launch count, timing, image and profile steps, and one UNet
   eval held against the plain route.

The line before the last is ``{"kernels": [...]}``: per kernel its
launches per image on each path, the main-path case's numbers and every
case under ``cases``.  The last is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# Tolerances of the kernel-vs-plain checks, on bf16 inputs.  The kernels
# accumulate in f32 like their plain versions but round elsewhere (p to
# bf16 before the row sum in K1; K2 keeps the conv output in f32 where
# cuDNN rounds it to bf16), so relative rms errors of a few 1e-3 are
# expected; the bounds leave a factor of about 3 to 5.
K1_RMS_REL = 1e-2
K2_RMS_REL = 2e-2
STATS_REL = 1e-3  # K2's Σy, Σy², K3's and the fused GroupNorm's mean, rstd: f32 sums, other order
# K5, the fused GroupNorm and K4 against f32 plain versions: the kernels
# round their output to bf16 once (2^-9 relative), so rms errors of a few
# 1e-3 are expected.
K5_RMS_REL = 1e-2
K4_RMS_REL = 1e-2
# K6 against its plain version at the kernel's kv tile: the same int8 math,
# with exp2 and sums in another order flipping a few roundings of p; and
# against exact attention, the bound of the JAX package's own int8 test.
K6_RMS_REL = 1e-2
K6_EXACT_RMS_REL = 0.015
# K6's pre-processing against its plain version: the means are summed in
# another order, so a value on a rounding boundary may take the next int8
# level; the f32 outputs (scales, corr, v's mean) agree to 1e-6
PREP_CODE_SHARE = 1e-3
PREP_F32_REL = 1e-6
# Full-model kernel route vs plain route: one UNet eval and one VAE
# decode in bf16 at random weights, where tens of layers compound those
# per-kernel errors.
MODEL_RMS_REL = 5e-2
# The opt-in route adds int8 attention (about 1e-2 at each level-0
# attention output) and the tanh GELU of K4 against the plain erf GELU.
OPTIN_MODEL_RMS_REL = 1e-1
STEPS = 50
# The card's published peaks (H100 SXM, dense): bf16 and int8 tensor-core
# rates and device memory; the exp2 rate of the MUFU units (16 per clock
# per SM, 132 SMs) at the 1.98 GHz boost clock, K1's second floor
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12
EXP2_PER_S = 16 * 132 * 1.98e9
# launches of one image: 5 level-0 self-attentions x 50 steps; 9 fused VAE
# resnets x 2 + 3 upsample convs; one K3 per fused resnet.  Opt-in: every
# UNet GroupNorm (22 resnets x 2 + 16 transformers + conv_norm_out = 61 per
# eval) is one fused GroupNorm; 11 of the 16 GEGLUs pass the width rule
# (K = 320 fails it); the 5 level-0 self-attentions take K6.
EXPECTED_LAUNCHES = {
    "flash_attention": 5 * STEPS, "quantize_qkv": 0, "flash_attention_int8": 0,
    "conv3x3": 21, "group_norm_stats": 9, "group_norm_apply": 0, "group_norm_fused": 0,
    "linear_geglu": 0,
}
EXPECTED_OPTIN_LAUNCHES = {
    "flash_attention": 0, "quantize_qkv": 5 * STEPS, "flash_attention_int8": 5 * STEPS,
    "conv3x3": 21, "group_norm_stats": 9, "group_norm_apply": 0,
    "group_norm_fused": 61 * STEPS, "linear_geglu": 11 * STEPS,
}

KERNELS = {
    "flash_attention": ("sfast_tpu_torch/csrc/flash_attention.cu",
                        "sfast_tpu/ops/flash_attention.py:52"),
    "flash_attention_int8": ("sfast_tpu_torch/csrc/flash_attention_int8.cu",
                             "sfast_tpu/ops/flash_attention.py:183"),
    # K6's pre-processing: XLA ops before the Pallas kernel in JAX
    "quantize_qkv": ("sfast_tpu_torch/csrc/quantize_qkv.cu",
                     "sfast_tpu/ops/flash_attention.py:326"),
    "conv3x3": ("sfast_tpu_torch/csrc/conv3x3.cu", "sfast_tpu/ops/conv_pallas.py:53"),
    "group_norm_stats": ("sfast_tpu_torch/csrc/group_norm_stats.cu",
                         "sfast_tpu/ops/group_norm.py:76"),
    "group_norm_apply": ("sfast_tpu_torch/csrc/group_norm_apply.cu",
                         "sfast_tpu/ops/group_norm.py:105"),
    # the pair _stats_kernel then _norm_apply_kernel of group_norm_pallas
    "group_norm_fused": ("sfast_tpu_torch/csrc/group_norm_fused.cu",
                         "sfast_tpu/ops/group_norm.py:76,105"),
    "linear_geglu": ("sfast_tpu_torch/csrc/geglu.cu", "sfast_tpu/ops/geglu.py:43"),
}

# Every distinct UNet GroupNorm of the opt-in path at 512² (batch 2):
# (H = W, C, act, times one UNet eval runs it: 61 in all); act None is a
# transformer's norm (eps 1e-6)
UNET_GN = [
    (64, 320, "silu", 8), (64, 320, None, 5), (64, 640, "silu", 2), (64, 960, "silu", 1),
    (32, 320, "silu", 1), (32, 640, "silu", 6), (32, 640, None, 5), (32, 960, "silu", 1),
    (32, 1280, "silu", 1), (32, 1920, "silu", 1),
    (16, 640, "silu", 1), (16, 1280, "silu", 6), (16, 1280, None, 5), (16, 1920, "silu", 1),
    (16, 2560, "silu", 2),
    (8, 1280, "silu", 11), (8, 1280, None, 1), (8, 2560, "silu", 3),
]
# K4's calls: (M, K, F) of the feed-forwards at levels 1, 2 and mid
UNET_GEGLU = [(2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120)]
# The device kernels each launch counted by cuda_build.launch_counts runs
# once, by a piece of their names in the profiler
KERNEL_ROWS = {
    "flash_attention": ("flash_fwd_kernel",),
    "quantize_qkv": ("::stats_kernel(", "::quantize_kernel("),
    "flash_attention_int8": ("flash_int8_kernel",),
    "conv3x3": ("conv3x3_kernel",),
    "group_norm_stats": ("gn_stats_kernel",),
    "group_norm_apply": ("gn_apply_kernel",),
    "group_norm_fused": ("gn_fused_kernel",),
    "linear_geglu": ("geglu_kernel",),
}


def log(*a):
    print(*a, flush=True)


def rel_errors(got, ref):
    """(max |err|, max |err| / max |ref|, rms err / rms ref) in f32."""
    got, ref = got.float(), ref.float()
    d = got - ref
    max_abs = d.abs().max().item()
    return (
        max_abs,
        max_abs / max(ref.abs().max().item(), 1e-30),
        (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-30)).item(),
    )


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of one call, each timed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, floor_ms, iters=10, names=False, tries=5):
    """Mean device milliseconds of one call: the kernel rows of a
    torch.profiler trace.  CUDA events around one call also time the host's
    launch of it, which is most of what they read below ~0.1 ms.  With
    ``names`` also returns the names of the kernels that ran.

    The profiler now and then loses kernel rows, and the trace then reads
    too low.  A trace with no kernel row, with a kernel counted a number of
    times that is not a multiple of the calls, or whose time is not above
    ``floor_ms`` (the function's bound) is taken again; after ``tries``
    such traces this raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in rows) / iters / 1e3
        if rows and all(e.count % iters == 0 for e in rows) and ms > floor_ms:
            return (ms, sorted({e.key for e in rows})) if names else ms
        log(f"    profiler trace of {iters} calls lost kernel rows: {ms:.4f} ms per call, "
            f"bound {floor_ms:.4f} ms, counts {[e.count for e in rows]}; tracing again")
    raise RuntimeError(f"device_ms: {tries} profiler traces lost kernel rows "
                       f"(last: {ms:.4f} ms per call against a bound of {floor_ms:.4f} ms)")


def bound(flops, nbytes, peak=PEAK_BF16):
    """(least ms the card could take, what sets it): the operations over
    the peak rate of their type against every input read once and every
    output written once over the memory rate."""
    op_ms, byte_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def record(out, name, case, max_abs, t, bnd, lib=None, **extra):
    """Log one case of a kernel and keep it under ``out[name]``.  ``lib`` is
    (library device ms, what the call is) or None."""
    ms, plain_ms, dev, plain_dev = t
    row = {
        "case": case, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "device_ms": dev, "plain_device_ms": plain_dev,
        "library_ms": None if lib is None else lib[0],
        "library": "none" if lib is None else lib[1],
        "bound_ms": bnd[0], "bound_by": bnd[1], "share_of_bound": bnd[0] / dev,
        **extra,
    }
    lib_text = "none" if lib is None else f"{lib[0]:.4f} ({lib[1]})"
    log(f"    {name} {case}: device {dev:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
        f"{100 * bnd[0] / dev:.1f}% of bound; library {lib_text}")
    out.setdefault(name, []).append(row)


def time_pair(kernel, plain, bnd):
    """(kernel ms, plain ms, kernel device ms, plain device ms): CUDA-event
    medians timed in turns plain, kernel, kernel, plain, then device times,
    each above ``bnd``, the function's bound."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel, bnd[0]), device_ms(plain, bnd[0])


def timing_text(t):
    return (f"kernel {t[0]:.4f} ms (device {t[2]:.4f})  "
            f"plain {t[1]:.4f} ms (device {t[3]:.4f})")


def sdpa_backend(names):
    """Which of PyTorch's attention backends ran, from its kernels' names."""
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "mem-efficient"),
                         ("efficient", "mem-efficient")):
        if key in text:
            return backend
    return "math"


def check_kernels(torch, dev):
    """Phase 3.  Returns {kernel: [case, ...]}, the main-path case first:
    errors, kernel / plain / library times, bound."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from sfast_tpu_torch.ops.fused_conv import conv3x3_block, conv3x3_block_ref
    from sfast_tpu_torch.ops.group_norm import group_norm_stats, group_norm_stats_ref

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    out = {}
    # K1: UNet level-0 self-attention, q/k/v as head-split views of the
    # (B, S, H·D) projections; then a ragged kv tail (1000 = 7·128 + 104)
    for b, h, sq, sk, d in [(2, 8, 4096, 4096, 40), (2, 8, 4096, 1000, 40)]:
        q = randn(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        k = randn(b, sk, h * d).view(b, sk, h, d).transpose(1, 2)
        v = randn(b, sk, h * d).view(b, sk, h, d).transpose(1, 2)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        max_abs, max_rel, rms = rel_errors(got, flash_attention_ref(q, k, v))
        again = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K1: two calls on the same inputs differ")
        nbytes = 2 * b * h * d * (2 * sq + 2 * sk)  # q, k, v in, o out
        bnd = bound(4 * b * h * sq * sk * d, nbytes)
        t = time_pair(lambda: flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v),
                      bnd)
        sdpa_ms, sdpa_names = device_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                        bnd[0], names=True)
        log(f"K1 flash_attention q={tuple(q.shape)} kv={sk}: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e}  {timing_text(t)}")
        if not rms <= K1_RMS_REL:
            raise AssertionError(f"K1 rms rel error {rms} > {K1_RMS_REL}")
        record(out, "flash_attention", f"({b}, {h}, {sq}x{sk}, {d})", max_abs, t, bnd,
               (sdpa_ms, f"F.scaled_dot_product_attention, {sdpa_backend(sdpa_names)} backend"),
               exp2_floor_ms=b * h * sq * sk / EXP2_PER_S * 1e3)

    # K2: every distinct call of the VAE decoder's main path — the fused
    # resnets' conv1 (GN in, per-batch bias, stats out) and conv2 (GN in,
    # bias, residual in), including the 512→256 and 256→128 channel
    # changes, and the three upsample convs (no GN)
    cases = [
        (128, 512, 512, "conv1"), (128, 512, 512, "conv2"), (128, 512, 512, "upsample"),
        (256, 512, 256, "conv1"), (256, 256, 256, "conv1"), (256, 256, 256, "conv2"),
        (256, 512, 512, "upsample"),
        (512, 256, 128, "conv1"), (512, 128, 128, "conv1"), (512, 128, 128, "conv2"),
        (512, 256, 256, "upsample"),
    ]
    for hw, c, f, kind in cases:
        x = randn(1, hw, hw, c)
        # HWIO view of (F, 3, 3, C) memory, as the modules pass their weights
        w = (torch.randn((f, 3, 3, c), generator=g, device=dev) / (9 * c) ** 0.5).to(bf16)
        w = w.permute(1, 2, 3, 0)
        kw = {}
        if kind != "upsample":
            kw["gn_scale"] = torch.rand((1, c), generator=g, device=dev) + 0.5
            kw["gn_shift"] = torch.randn((1, c), generator=g, device=dev) * 0.1
        if kind == "conv1":
            kw.update(bias_batch=torch.randn((1, f), generator=g, device=dev), emit_stats=True)
        else:
            kw["bias"] = torch.randn((f,), generator=g, device=dev)
        if kind == "conv2":
            kw["residual"] = randn(1, hw, hw, f)
        got = conv3x3_block(x, w, **kw)
        torch.cuda.synchronize()
        ref = conv3x3_block_ref(x, w, **kw)
        if kind == "conv1":
            again = conv3x3_block(x, w, **kw)
            got, s1, s2 = got
            ref, r1, r2 = ref
            if not (torch.equal(s1, again[1]) and torch.equal(s2, again[2])):
                raise AssertionError("K2: two calls give different statistics")
            stats_err = max(rel_errors(s1, r1)[1], rel_errors(s2, r2)[1])
            if not stats_err <= STATS_REL:
                raise AssertionError(f"K2 stats rel error {stats_err} > {STATS_REL}")
        max_abs, max_rel, rms = rel_errors(got, ref)
        flops, conv_bytes = 2 * hw * hw * 9 * c * f, 2 * (hw * hw * c + 9 * c * f + hw * hw * f)
        bnd = bound(flops, conv_bytes + (2 * hw * hw * f if kind == "conv2" else 0))
        t = time_pair(lambda: conv3x3_block(x, w, **kw), lambda: conv3x3_block_ref(x, w, **kw),
                      bnd)
        # cuDNN's bf16 conv with bias on the channels-last NCHW views: the
        # same function where there is no GroupNorm in front (upsample), a
        # lower floor where there is (conv1, conv2)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        bc = kw.get("bias", kw.get("bias_batch", torch.zeros(1, f, device=dev))).reshape(f).to(bf16)
        lib_ms = device_ms(lambda: F.conv2d(xc, wc, bc, padding=1), bound(flops, conv_bytes)[0])
        extra = f" stats_rel {stats_err:.3e}" if kind == "conv1" else ""
        log(f"K2 conv3x3 {kind} {hw}²·{c}→{f}: max_rel {max_rel:.3e} rms_rel {rms:.3e}"
            f"{extra}  {timing_text(t)}")
        if not rms <= K2_RMS_REL:
            raise AssertionError(f"K2 rms rel error {rms} > {K2_RMS_REL}")
        record(out, "conv3x3", f"{kind} {hw}^2 {c}->{f}", max_abs, t, bnd,
               (lib_ms, "F.conv2d + bias" + (", same function" if kind == "upsample"
                                             else ", without the GroupNorm: a lower floor")))

    # K3: the fused-resnet entries' GroupNorm statistics (32 groups, eps 1e-6)
    for hw, c in [(128, 512), (256, 512), (256, 256), (512, 256), (512, 128)]:
        x = randn(1, hw, hw, c) + 0.5
        mean, rstd = group_norm_stats(x, groups=32, eps=1e-6)
        torch.cuda.synchronize()
        rm, rr = group_norm_stats_ref(x, groups=32, eps=1e-6)
        em, er = rel_errors(mean, rm), rel_errors(rstd, rr)
        bnd = bound(0, 2 * x.numel())
        t = time_pair(lambda: group_norm_stats(x, groups=32, eps=1e-6),
                      lambda: group_norm_stats_ref(x, groups=32, eps=1e-6), bnd)
        log(f"K3 group_norm_stats {hw}²·{c}: mean max_rel {em[1]:.3e} rstd "
            f"max_rel {er[1]:.3e}  {timing_text(t)}")
        if not max(em[1], er[1]) <= STATS_REL:
            raise AssertionError(f"K3 rel error {max(em[1], er[1])} > {STATS_REL}")
        xg = x.view(1, hw * hw, 32, c // 32)
        record(out, "group_norm_stats", f"K3 {hw}^2 {c}", max(em[0], er[0]), t, bnd,
               (device_ms(lambda: torch.var_mean(xg, dim=(1, 3)), bnd[0]), "torch.var_mean"))

    check_optin_kernels(torch, dev, randn, out)
    return out


def check_optin_kernels(torch, dev, randn, out):
    """Phase 3, the opt-in path's kernels: the fused GroupNorm, and K3 and
    K5 alone, at every UNet GroupNorm shape, K4 at its three shapes, K6 and
    its pre-processing at the level-0 shape and a ragged kv."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from sfast_tpu_torch.ops.flash_attention_int8 import (
        flash_attention_int8,
        flash_attention_int8_body,
        flash_attention_int8_ref,
        kernel_inputs,
        kv_tile,
        quantize_qkv_cuda,
    )
    from sfast_tpu_torch.ops.geglu import (
        linear_geglu_fused,
        linear_geglu_fused_ref,
        linear_geglu_plain,
    )
    from sfast_tpu_torch.ops.group_norm import (
        group_norm_apply,
        group_norm_apply_ref,
        group_norm_fused,
        group_norm_fused_ref,
        group_norm_stats,
        group_norm_stats_ref,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    per_eval = {"fused": 0.0, "K3+K5": 0.0, "library": 0.0}
    for hw, c, act, count in UNET_GN:
        eps = 1e-5 if act else 1e-6
        x = randn(2, hw, hw, c) + 0.3
        gamma = torch.rand((c,), generator=g, device=dev) + 0.5
        beta = torch.randn((c,), generator=g, device=dev) * 0.2
        kw = dict(groups=32, eps=eps, act=act)
        y, fm, fr = group_norm_fused(x, gamma, beta, stats=True, **kw)
        again = group_norm_fused(x, gamma, beta, **kw)
        mean, rstd = group_norm_stats(x, groups=32, eps=eps)
        got = group_norm_apply(x, mean, rstd, gamma, beta, act=act)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"fused GroupNorm (2, {hw}², {c}): two calls differ")
        ry, rm, rr = group_norm_fused_ref(x, gamma, beta, **kw)
        f_stats = max(rel_errors(fm, rm)[1], rel_errors(fr, rr)[1])
        f_abs, _, f_rms = rel_errors(y, ry)
        stats_err = max(rel_errors(mean, rm)[1], rel_errors(rstd, rr)[1])
        max_abs, max_rel, rms = rel_errors(got, group_norm_apply_ref(x, mean, rstd, gamma, beta,
                                                                      act=act))
        bnd, st_bnd = bound(0, 4 * x.numel()), bound(0, 2 * x.numel())
        ft = time_pair(lambda: group_norm_fused(x, gamma, beta, **kw),
                       lambda: group_norm_fused_ref(x, gamma, beta, **kw), bnd)
        t = time_pair(lambda: group_norm_apply(x, mean, rstd, gamma, beta, act=act),
                      lambda: group_norm_apply_ref(x, mean, rstd, gamma, beta, act=act), bnd)
        st = time_pair(lambda: group_norm_stats(x, groups=32, eps=eps),
                       lambda: group_norm_stats_ref(x, groups=32, eps=eps), st_bnd)
        # the library GroupNorm on the channels-last NCHW view, SiLU after it
        xc, gb, bb = x.permute(0, 3, 1, 2), gamma.to(x.dtype), beta.to(x.dtype)

        def library():
            o = F.group_norm(xc, 32, gb, bb, eps)
            return F.silu(o) if act == "silu" else o

        lib_ms = device_ms(library, bnd[0])
        pair_ms = st[2] + t[2]
        for route, ms in (("fused", ft[2]), ("K3+K5", pair_ms), ("library", lib_ms)):
            per_eval[route] += count * ms
        log(f"group_norm (2, {hw}², {c}) act={act}: fused stats_rel {f_stats:.3e} rms_rel "
            f"{f_rms:.3e}  {timing_text(ft)}; K3+K5 device {pair_ms:.4f} ms (K5 rms_rel "
            f"{rms:.3e}  {timing_text(t)}; K3 stats_rel {stats_err:.3e}  {timing_text(st)}); "
            f"library {lib_ms:.4f} ms")
        if not (f_rms <= K5_RMS_REL and rms <= K5_RMS_REL):
            raise AssertionError(f"GroupNorm rms rel error: fused {f_rms}, K5 {rms} > {K5_RMS_REL}")
        if not (f_stats <= STATS_REL and stats_err <= STATS_REL):
            raise AssertionError(f"GroupNorm stats rel error: fused {f_stats}, K3 {stats_err} "
                                 f"> {STATS_REL}")
        case = f"(2, {hw}^2, {c}) {act or 'none'}"
        record(out, "group_norm_fused", case, f_abs, ft, bnd,
               (lib_ms, "F.group_norm" + (" + F.silu" if act == "silu" else "")),
               stats_max_rel=f_stats, k3_k5_device_ms=pair_ms, per_eval=count)
        record(out, "group_norm_apply", case, max_abs, t, bnd)
        xg = x.view(2, hw * hw, 32, c // 32)
        stats_abs = max(rel_errors(mean, rm)[0], rel_errors(rstd, rr)[0])
        record(out, "group_norm_stats", "K3 " + case, stats_abs, st, st_bnd,
               (device_ms(lambda: torch.var_mean(xg, dim=(1, 3)), st_bnd[0]), "torch.var_mean"))
    log("GroupNorm device ms over one UNet eval's 61 GroupNorms: "
        + ", ".join(f"{route} {ms:.4f}" for route, ms in per_eval.items()))
    out["group_norm_per_eval_ms"] = per_eval

    for m, k, f in UNET_GEGLU:
        x = randn(m, k)
        w = (torch.randn((2 * f, k), generator=g, device=dev) / k**0.5).to(torch.bfloat16)
        b = (torch.randn((2 * f,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        got = linear_geglu_fused(x, w, b)
        torch.cuda.synchronize()
        max_abs, max_rel, rms = rel_errors(got, linear_geglu_fused_ref(x, w, b))
        bnd = bound(2 * m * k * 2 * f, 2 * (m * k + 2 * f * k + 2 * f + m * f))
        t = time_pair(lambda: linear_geglu_fused(x, w, b),
                      lambda: linear_geglu_fused_ref(x, w, b), bnd)
        unfused_ms = device_ms(lambda: linear_geglu_plain(x, w, b), bnd[0])
        log(f"K4 linear_geglu M={m} K={k} F={f}: max_rel {max_rel:.3e} rms_rel {rms:.3e}  "
            f"{timing_text(t)}  (unfused bf16 erf route: device {unfused_ms:.4f} ms)")
        if not rms <= K4_RMS_REL:
            raise AssertionError(f"K4 rms rel error {rms} > {K4_RMS_REL}")
        record(out, "linear_geglu", f"M={m} K={k} F={f}", max_abs, t, bnd,
               unfused_route_ms=unfused_ms)

    # K6: level-0 self-attention, head-split views; then a ragged kv tail.
    # The whole call (pre-processing and body) is held against the plain
    # version, the pre-processing alone against its own, and the body timed
    # alone on the pre-processing's output; K1 at the same shape beside it.
    for b, h, sq, sk, d in [(2, 8, 4096, 4096, 40), (2, 8, 4096, 1000, 40)]:
        q = randn(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        k = (randn(b, sk, h * d) + 0.5).view(b, sk, h, d).transpose(1, 2)
        v = (randn(b, sk, h * d) - 0.3).view(b, sk, h, d).transpose(1, 2)
        scale = d ** -0.5
        got = flash_attention_int8(q, k, v)
        again = flash_attention_int8(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K6: two calls on the same inputs differ")
        max_abs, max_rel, rms = rel_errors(got, flash_attention_int8_ref(q, k, v,
                                                                         block_k=kv_tile(d)))
        exact = rel_errors(got, flash_attention_ref(q, k, v))[2]
        inputs = quantize_qkv_cuda(q, k, v, scale)
        code_diff, code_share, f32_rel = prep_errors(
            torch, inputs, kernel_inputs(q.float(), k.float(), v.float(), scale))
        bnd = bound(4 * b * h * sq * sk * d, 2 * b * h * d * (2 * sq + 2 * sk), PEAK_INT8)
        t = time_pair(lambda: flash_attention_int8(q, k, v),
                      lambda: flash_attention_int8_ref(q, k, v, block_k=kv_tile(d)), bnd)
        prep_bnd = bound(0, sum(x.numel() * x.element_size() for x in (q, k, v, *inputs)))
        prep_t = time_pair(lambda: quantize_qkv_cuda(q, k, v, scale),
                           lambda: kernel_inputs(q, k, v, scale), prep_bnd)
        body_ms = device_ms(lambda: flash_attention_int8_body(inputs, q.shape), bnd[0])
        k1_ms = device_ms(lambda: flash_attention(q, k, v), bnd[0])
        exp2_floor = b * h * sq * sk / EXP2_PER_S * 1e3
        log(f"K6 flash_attention_int8 q={tuple(q.shape)} kv={sk}: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e} (exact attention: rms_rel {exact:.3e}); pre-processing: codes "
            f"off by {code_diff} on {code_share:.2e} of them, f32 max_rel {f32_rel:.2e}  "
            f"{timing_text(t)}; device: pre-processing {prep_t[2]:.4f} ms, body {body_ms:.4f} "
            f"ms, K1 at this shape {k1_ms:.4f} ms, exp2 floor {exp2_floor:.4f} ms")
        if not rms <= K6_RMS_REL:
            raise AssertionError(f"K6 rms rel error {rms} > {K6_RMS_REL}")
        if not exact <= K6_EXACT_RMS_REL:
            raise AssertionError(f"K6 vs exact attention: rms rel {exact} > {K6_EXACT_RMS_REL}")
        if not (code_diff <= 1 and code_share <= PREP_CODE_SHARE and f32_rel <= PREP_F32_REL):
            raise AssertionError(f"K6 pre-processing: codes off by {code_diff} on {code_share} "
                                 f"of them, f32 rel {f32_rel}")
        case = f"({b}, {h}, {sq}x{sk}, {d})"
        record(out, "flash_attention_int8", case, max_abs, t, bnd, exp2_floor_ms=exp2_floor,
               prep_device_ms=prep_t[2], body_device_ms=body_ms, k1_device_ms=k1_ms)
        record(out, "quantize_qkv", case, float(code_diff), prep_t, prep_bnd,
               code_mismatch_share=code_share, f32_max_rel=f32_rel)


def prep_errors(torch, got, ref):
    """K6's pre-processing against its plain version: (largest int8 code
    difference, share of codes that differ, largest relative error of the
    f32 outputs), each two calls bit-identical."""
    diff, share, rel = 0, 0.0, 0.0
    for name, a, r in zip(got._fields, got, ref):
        if a.shape != r.shape or a.dtype != r.dtype:
            raise AssertionError(f"K6 pre-processing {name}: {a.shape} {a.dtype} != "
                                 f"{r.shape} {r.dtype}")
        if a.dtype == torch.int8:
            dd = (a.int() - r.int()).abs()
            diff = max(diff, dd.max().item())
            share = max(share, (dd > 0).float().mean().item())
        else:
            rel = max(rel, rel_errors(a, r)[1])
    return diff, share, rel


def build_pipeline(torch, dev):
    """SD1.5 at full width with seeded random weights, through the entry
    points a user calls."""
    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import (
        SD15_TEXT_ENCODER, SD15_UNET, SD_VAE, AutoencoderKL, CLIPTextModel,
        UNet2DConditionModel, init_weights_,
    )
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    unet = init_weights_(UNet2DConditionModel(SD15_UNET, device=dev, dtype=bf16), gen)
    vae = init_weights_(AutoencoderKL(SD_VAE, device=dev, dtype=bf16), gen)
    te = init_weights_(CLIPTextModel(SD15_TEXT_ENCODER, device=dev, dtype=bf16), gen)
    pipe = sfast_tpu_torch.compile(
        StableDiffusionPipeline(unet, vae, te, DPMSolverMultistepScheduler(),
                                device=dev, dtype=bf16),
        CompilationConfig.Default(),
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (unet, vae, te) for p in m.parameters())
    log(f"models built: {n_params / 1e6:.1f} M params in {time.perf_counter() - t0:.1f} s")
    return pipe


def run_path(torch, dev, pipe, name, cfg, expected, model_bound):
    """Phases 4 and 5: one path of the pipeline under ``cfg``.  Returns the
    launch counts of one image."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import SD_VAE
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    bf16 = torch.bfloat16
    pipe.set_compilation_config(cfg)
    prompt_ids = torch.randint(0, 49408, (1, 77), generator=torch.Generator().manual_seed(1))
    kw = dict(prompt_ids=prompt_ids, height=512, width=512,
              num_inference_steps=STEPS, guidance_scale=7.5)

    def timed(**extra):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(**kw, **extra)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # the counted main-path run (also the warm-up)
    cuda_build.reset_launch_counts()
    out, warm_ms = timed(seed=0)
    counts = dict(cuda_build.launch_counts)
    log(f"[{name}] launches per image: {counts} (first run {warm_ms:.1f} ms)")
    if counts != expected:
        raise AssertionError(f"[{name}] launch counts {counts} != {expected}")
    img = out.images
    if img.shape != (1, 512, 512, 3) or str(img.dtype) != "uint8":
        raise AssertionError(f"[{name}] image {img.shape} {img.dtype}")

    torch.cuda.reset_peak_memory_stats()
    runs = [timed(seed=s)[1] for s in (1, 2, 3)]
    log(f"[{name}] e2e ms: runs {[round(r, 3) for r in runs]} median "
        f"{statistics.median(runs):.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    lat = torch.randn((1, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    image_f = pipe(**kw, latents=lat, output_type="float").images
    if not bool(torch.isfinite(image_f).all()) or image_f.float().std().item() == 0.0:
        raise AssertionError(f"[{name}] decoded image is not finite or is constant")
    u8_a = denormalize_to_uint8(image_f)
    u8_b = pipe(**kw, latents=lat, output_type="pt").images
    # the kernels are deterministic; one level allows for the libraries'
    # (cuBLAS, cuDNN) choice of algorithm between calls
    diff = (u8_a.int() - u8_b.int()).abs().max().item()
    log(f"[{name}] same latents twice: max uint8 difference {diff}; image std "
        f"{image_f.float().std().item():.4f}")
    if diff > 1:
        raise AssertionError(f"[{name}] two runs with the same latents differ by {diff} levels")

    profile_image(torch, lambda: pipe(**kw, seed=4), name)

    # kernel route vs plain route at full width
    gen = torch.Generator(device=dev).manual_seed(6)
    with torch.inference_mode():
        ctx = pipe.encode_prompt(prompt_ids.to(dev))
        x = torch.randn((2, 64, 64, 4), generator=gen, device=dev).to(bf16)
        t = torch.full((2,), 801.0, device=dev)
        z = torch.randn((1, 64, 64, 4), generator=gen, device=dev) / SD_VAE.scaling_factor
        res = {}
        for route, rcfg in (("kernels", cfg), ("plain", CompilationConfig(enable_kernels=False))):
            pipe.set_compilation_config(rcfg)
            res[route] = (pipe.unet(x, t, ctx), pipe.vae.decode(z))
        pipe.set_compilation_config(CompilationConfig.Default())
    for i, what in enumerate(("UNet eps", "VAE image")):
        _, max_rel, rms = rel_errors(res["kernels"][i], res["plain"][i])
        log(f"[{name}] {what}, kernel route vs plain route: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e}")
        if not rms <= model_bound:
            raise AssertionError(f"[{name}] {what}: rms rel {rms} > {model_bound}")
    return counts


def profile_image(torch, run, name, tries=5):
    """One image under torch.profiler: device time, the device's idle share
    of the image's wall time and the count of CUDA kernels the image
    launches (every host dispatch that reaches the card).  The profiler now
    and then loses kernel rows; a trace whose rows of the port's kernels do
    not match the launches ``cuda_build`` counted during it is taken again,
    and after ``tries`` such traces this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sfast_tpu_torch.runtime import cuda_build

    run()  # an unprofiled image right before, for its wall time
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    for _ in range(tries):
        cuda_build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        launches = dict(cuda_build.launch_counts)
        events = prof.key_averages()
        # the kernels' own rows: an operator's row repeats its kernels' time
        rows = [e for e in events if e.device_type == DeviceType.CUDA]
        seen = {k: [sum(e.count for e in rows if piece in e.key) for piece in pieces]
                for k, pieces in KERNEL_ROWS.items()}
        lost = {k: c for k, c in seen.items() if any(n != launches[k] for n in c)}
        if not lost:
            break
        log(f"    [{name}] profiler trace lost kernel rows: rows {lost} against launches "
            f"{launches}; tracing again")
    else:
        raise RuntimeError(f"[{name}] {tries} profiler traces of one image lost kernel rows")
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    n_kernels = sum(e.count for e in rows)
    log(f"[{name}] profile: device time {dev_ms:.1f} ms per image; unprofiled image "
        f"{wall_ms:.1f} ms -> device idle {100 * (1 - dev_ms / wall_ms):.1f}%; "
        f"{n_kernels} CUDA kernels per image")
    log(events.table(sort_by="self_device_time_total", row_limit=15))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.runtime import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.library()
    built = cuda_build.build_seconds
    log(f"kernels: {path.name} "
        + (f"built in {built:.1f} s" if built is not None else "already built")
        + f", loaded after {time.perf_counter() - t0:.1f} s")

    measured = check_kernels(torch, dev)
    pipe = build_pipeline(torch, dev)
    default = run_path(torch, dev, pipe, "default", CompilationConfig.Default(),
                       EXPECTED_LAUNCHES, MODEL_RMS_REL)
    optin_cfg = CompilationConfig(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                                  enable_int8_attention=True)
    optin = run_path(torch, dev, pipe, "opt-in", optin_cfg, EXPECTED_OPTIN_LAUNCHES,
                     OPTIN_MODEL_RMS_REL)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        first = measured[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": default[name] + optin[name],
            "launches_per_image": {"default": default[name], "optin": optin[name]},
            **{key: first[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "plain_device_ms", "share_of_bound", "library")},
            "cases": measured[name],
        })
    print(json.dumps({"kernels": kernels,
                      "group_norm_per_eval_ms": measured["group_norm_per_eval_ms"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
