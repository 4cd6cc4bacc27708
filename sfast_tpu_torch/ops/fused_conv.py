"""K2: fused GroupNorm+SiLU → 3×3 conv with bias / residual / output-scale
epilogue and in-kernel GroupNorm statistics (``csrc/conv3x3.cu``).

Counterpart of ``sfast_tpu/ops/conv_pallas.py`` with the same entry points
(``:137-439``): :func:`conv3x3_block`, :func:`conv3x3_gn_silu`,
:func:`affine_from_stats` and :func:`gn_affine`.  The TPU block-size
arguments are gone.  The weight is HWIO ``(3, 3, C, F)`` as in JAX; the
kernel reads it as (F, 3·3·C) rows, so an HWIO tensor that is the
``permute(2, 3, 1, 0)`` view of a channels_last OIHW weight — what the
modules pass (``Conv2d.hwio_weight``) — goes in without a copy, and any
other is copied once per call.
:func:`conv3x3_block` launches the kernel for CUDA tensors and takes
:func:`conv3x3_block_ref` for CPU tensors; any other device raises.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sfast_tpu_torch.ops.group_norm import group_norm_stats
from sfast_tpu_torch.runtime import cuda_build

_PATCH_H, _PATCH_W = 16, 8  # output pixels per block: TH x TW in csrc/conv3x3.cu

def _bias_rows(bias, bias_batch, n: int, f: int, device) -> torch.Tensor:
    """The epilogue's per-(batch, channel) bias, (N, F) f32."""
    if bias_batch is not None:
        return bias_batch.float().reshape(n, f)
    if bias is None:
        return torch.zeros((n, f), dtype=torch.float32, device=device)
    return bias.float().reshape(1, f).expand(n, f)


def conv3x3_block_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    bias_batch: Optional[torch.Tensor] = None,
    gn_scale: Optional[torch.Tensor] = None,
    gn_shift: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    output_scale: float = 1.0,
    emit_stats: bool = False,
):
    """Plain version of K2: the normalized input rounds to ``x.dtype``, the
    conv runs in ``x.dtype`` (cuDNN for bf16 on the card), the epilogue and
    the statistics in f32."""
    n, _, _, _ = x.shape
    f = w.shape[-1]
    if gn_scale is not None:
        xf = x.float() * gn_scale[:, None, None, :] + gn_shift[:, None, None, :]
        x = F.silu(xf).to(x.dtype)
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype), padding=1
    ).permute(0, 2, 3, 1).float()
    y = y + _bias_rows(bias, bias_batch, n, f, x.device)[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    if output_scale != 1.0:
        y = y * (1.0 / output_scale)
    out = y.to(x.dtype)
    if not emit_stats:
        return out
    return out, y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))


@cuda_build.no_backward("conv3x3")
def conv3x3_block(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    bias_batch: Optional[torch.Tensor] = None,  # (N, F): conv bias + temb proj
    gn_scale: Optional[torch.Tensor] = None,    # (N, C) f32: rstd·gamma
    gn_shift: Optional[torch.Tensor] = None,    # (N, C) f32: beta − mean·rstd·gamma
    residual: Optional[torch.Tensor] = None,    # (N, H, W, F)
    output_scale: float = 1.0,
    emit_stats: bool = False,
):
    """``y = (conv3x3(silu(x·gn_scale + gn_shift), w) + bias [+ residual])
    / output_scale`` over NHWC, SAME padding, stride 1.

    With ``emit_stats`` returns ``(y, s1, s2)``: per-(batch, channel) Σy
    and Σy² (f32) over the H·W pixels, for :func:`affine_from_stats`.
    On CUDA: bf16 x, w and residual, C % 8 == 0 and F % 8 == 0."""
    kw = dict(
        bias_batch=bias_batch, gn_scale=gn_scale, gn_shift=gn_shift,
        residual=residual, output_scale=output_scale, emit_stats=emit_stats,
    )
    if x.device.type == "cpu":
        return conv3x3_block_ref(x, w, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_block: unsupported device {x.device}")
    n, h, wd, c = x.shape
    if w.shape[:3] != (3, 3, c):
        raise ValueError(f"conv3x3_block: weight {tuple(w.shape)} for input {tuple(x.shape)}")
    f = w.shape[3]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or c % 8 or f % 8:
        raise ValueError(
            f"conv3x3_block: needs bf16 x and w with C % 8 == 0 and F % 8 == 0, "
            f"got {x.dtype}/{w.dtype} C={c} F={f}"
        )
    if (gn_scale is None) != (gn_shift is None):
        raise ValueError("conv3x3_block: gn_scale and gn_shift go together")
    x = x.contiguous()
    w_rows = w.permute(3, 0, 1, 2).contiguous()  # (F, 3, 3, C): a view when w came from OIHW channels_last
    # TMA reads both from 16-byte aligned addresses
    x, w_rows = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w_rows))
    bias2 = _bias_rows(bias, bias_batch, n, f, x.device).contiguous()
    if gn_scale is not None:
        gn_scale = gn_scale.float().reshape(n, c).contiguous()
        gn_shift = gn_shift.float().reshape(n, c).contiguous()
    if residual is not None:
        if residual.shape != (n, h, wd, f) or residual.dtype != torch.bfloat16:
            raise ValueError(
                f"conv3x3_block: residual {tuple(residual.shape)} {residual.dtype}"
            )
        residual = residual.contiguous()
    out = torch.empty((n, h, wd, f), dtype=x.dtype, device=x.device)
    # one partial (Σy, Σy²) row per patch of output pixels, summed below in
    # a fixed order, so the statistics repeat exactly from run to run
    pixel_blocks = -(-h // _PATCH_H) * -(-wd // _PATCH_W)
    partials = (
        torch.empty((2, n, pixel_blocks, f), dtype=torch.float32, device=x.device)
        if emit_stats else None
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = cuda_build.library().sfast_conv3x3_bf16(
        x.data_ptr(), w_rows.data_ptr(), bias2.data_ptr(), ptr(gn_scale),
        ptr(gn_shift), ptr(residual), out.data_ptr(), ptr(partials),
        n, h, wd, c, f, 1.0 / output_scale, cuda_build.stream_ptr(x),
    )
    cuda_build.check(err, "conv3x3_block")
    cuda_build.count_launch("conv3x3")
    if not emit_stats:
        return out
    s1, s2 = partials.sum(dim=2)
    return out, s1, s2


def conv3x3_gn_silu(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    gn_scale: Optional[torch.Tensor] = None,
    gn_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``conv3x3(silu(x·gn_scale + gn_shift), w) + bias`` — the simple entry
    point (the upsample convs)."""
    return conv3x3_block(x, w, bias, gn_scale=gn_scale, gn_shift=gn_shift)


def affine_from_stats(
    s1: torch.Tensor,
    s2: torch.Tensor,
    count: int,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    groups: int = 32,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm (scale, shift), each (N, C) f32, from per-channel Σy and
    Σy² over ``count`` pixels."""
    n, c = s1.shape
    cpg = c // groups
    cnt = float(count * cpg)
    mean = s1.reshape(n, groups, cpg).sum(-1) / cnt
    var = s2.reshape(n, groups, cpg).sum(-1) / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    scale = rstd.repeat_interleave(cpg, dim=1) * gamma.float().reshape(1, c)
    shift = beta.float().reshape(1, c) - mean.repeat_interleave(cpg, dim=1) * scale
    return scale, shift


def gn_affine(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    groups: int = 32,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) GroupNorm (scale, shift), each (N, C) f32, with
    ``x·scale + shift ≡ GN(x)·gamma + beta``; statistics from K3."""
    n, _, _, c = x.shape
    mean, rstd = group_norm_stats(x, groups=groups, eps=eps)
    scale = rstd.reshape(n, c) * gamma.float().reshape(1, c)
    shift = beta.float().reshape(1, c) - mean.reshape(n, c) * scale
    return scale, shift
