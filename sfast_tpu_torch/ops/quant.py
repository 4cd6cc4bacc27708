"""Int8 quantization: the W8A16 linear, and the dynamic and calibrated
(static) W8A8 linear and conv.

Counterpart of ``sfast_tpu/ops/quant.py``.  JAX computes the int8 products
with XLA ops (``dot_general`` / ``conv_general_dilated`` with an int32
result); no Pallas kernel is involved, so the port takes a library call
for them: :func:`int_mm`, ``torch._int_mm`` (cuBLASLt) on the card, and
the W8A8 conv as an NHWC im2col on it.  Both give the exact int32 sums,
as their plain versions do (:func:`int_mm_ref`, :func:`int_conv2d_ref`),
so the card check is equality.

Layouts are the port's: a linear weight (out, in), its scale per output
channel over ``in`` (JAX's weight is (in, out), its scale over axis 0); a
conv weight OIHW (channels_last in memory), its scale per output channel
over (in, kh, kw).

Rounding is round-half-even (``torch.round``, as ``jnp.round``).  The
dynamic path divides, ``round(x / scale)``; the static path multiplies by
the f32 reciprocal, ``round(x · (1 / a_scale))``: they differ at ties, as
in JAX.  The epilogue is JAX's: the int32 sums cast to f32 times
``(x_scale · w_scale)`` (the scales multiplied first), then ``+ b`` and
``+ residual`` in f32, the activation in f32 (erf GELU), and one cast to
``x.dtype``.  The dynamic scale stays a 0-d device tensor: nothing here
syncs with the host, so every op captures into a CUDA graph.
"""

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[int, Tuple[int, int]]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight → (int8 (out, in), f32 scale (out,))."""
    wf = w.float()
    scale = (wf.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
    wq = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return wq, scale


def quantize_conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW conv weight → (int8 OIHW, kept channels_last; f32 scale
    (out,)).  JAX's weight is HWIO: ``wq.permute(2, 3, 1, 0)`` is its
    int8 weight."""
    wf = w.float()
    scale = (wf.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-8)
    wq = torch.round(wf / scale[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return wq.contiguous(memory_format=torch.channels_last), scale


def dynamic_quant_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activations → (int8, 0-d f32 scale on x's device), computed from
    this call's ``max |x|``."""
    xf = x.float()
    scale = (xf.abs().amax() / 127.0).clamp_min(1e-8)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def quant_static(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Activations → int8 with a calibrated 0-d f32 scale, multiplying by
    its f32 reciprocal as JAX's ``_quant_static``."""
    return torch.round(x.float() * (1.0 / a_scale)).clamp(-127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# the int8 × int8 → int32 products
# ---------------------------------------------------------------------------


def int_mm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int_mm`: the product in f64, exact while
    |sum| < 2⁵³ (each term is at most 127², so any K below 5·10¹¹)."""
    return (a.double() @ b.double()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` with its shape rules met by zero padding, which
    leaves every sum as it is: M above 16, K and N multiples of 8."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = (32 if m <= 16 else m), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a, b)
    return out if (mp, np_) == (m, n) else out[:m, :n]


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32.  On CUDA tensors
    ``torch._int_mm`` (``b`` is best a transposed (N, K) row-major weight,
    cuBLASLt's TN form); on the CPU the plain version."""
    if a.is_cuda:
        return _int_mm_cuda(a, b)
    return int_mm_ref(a, b)


def _pads(padding: Padding) -> Tuple[int, int]:
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


def int_conv2d(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1,
               padding: Padding = 0) -> torch.Tensor:
    """NHWC int8 x (N, H, W, C), OIHW int8 w (F, C, kh, kw) → (N, Ho, Wo,
    F) int32: an im2col of (N·Ho·Wo, kh·kw·C) int8, one :func:`int_mm`.
    ``padding`` is per side, one for both axes or (H, W).  The columns take
    kh·kw times x's bytes (int8), where JAX's conv takes none."""
    n, h, w, c = xq.shape
    f, _, kh, kw = wq.shape
    ph, pw = _pads(padding)
    if (kh, kw, stride, ph, pw) == (1, 1, 1, 0, 0):
        cols = xq.reshape(n * h * w, c)
        ho, wo = h, w
    else:
        xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
        ho, wo = (h + 2 * ph - kh) // stride + 1, (w + 2 * pw - kw) // stride + 1
        # (N, Ho, Wo, C, kh, kw) windows → (N·Ho·Wo, kh·kw·C) in (kh, kw, C) order
        win = xp.unfold(1, kh, stride).unfold(2, kw, stride)
        cols = win.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * c)
    wmat = wq.permute(0, 2, 3, 1).reshape(f, kh * kw * c)  # a view of channels_last
    return int_mm(cols, wmat.t()).reshape(n, ho, wo, f)


def int_conv2d_ref(xq: torch.Tensor, wq: torch.Tensor, *, stride: int = 1,
                   padding: Padding = 0) -> torch.Tensor:
    """Plain version of :func:`int_conv2d`: ``F.conv2d`` in f64, exact as
    :func:`int_mm_ref`."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=stride,
                 padding=_pads(padding))
    return y.permute(0, 2, 3, 1).to(torch.int32)


# ---------------------------------------------------------------------------
# the quantized linear and conv
# ---------------------------------------------------------------------------


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return F.relu(y)
    if act == "gelu":
        return F.gelu(y)
    if act == "silu":
        return y * torch.sigmoid(y)
    raise ValueError(f"unknown activation: {act}")


def _epilogue(acc, scale, b, residual, act, dtype) -> torch.Tensor:
    y = acc.float() * scale
    if b is not None:
        y = y + b.float()
    if residual is not None:
        y = y + residual.float()
    return _act(y, act).to(dtype)


def _linear_int8(x, xq, scale, wq, b, act):
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t()).reshape(*x.shape[:-1], wq.shape[0])
    return _epilogue(acc, scale, b, None, act, x.dtype)


def linear_w8a8(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, act: Optional[str] = None) -> torch.Tensor:
    """W8A8 linear, the activation quantized per tensor on the fly: x
    (..., in), wq (out, in) int8, w_scale (out,)."""
    xq, x_scale = dynamic_quant_per_tensor(x)
    return _linear_int8(x, xq, x_scale * w_scale, wq, b, act)


def linear_w8a8_static(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                       a_scale: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                       act: Optional[str] = None) -> torch.Tensor:
    """W8A8 linear with a calibrated 0-d f32 activation scale."""
    return _linear_int8(x, quant_static(x, a_scale), a_scale * w_scale, wq, b, act)


def int8_linear(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, act: Optional[str] = None) -> torch.Tensor:
    """W8A16: ``act(x @ dequant(wq)ᵀ + b)``: the int8 weight cast to x's
    dtype, the product in x's dtype (cuBLAS accumulates in f32; a bf16
    output is rounded once, as the port's plain ``linear``), then the
    per-channel scale, the bias and the activation in f32."""
    y = F.linear(x, wq.to(x.dtype))
    return _epilogue(y, scale, b, None, act, x.dtype)


def conv2d_w8a8(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, stride: int = 1, padding: Padding = 0,
                act: Optional[str] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 NHWC conv, the activation quantized per tensor on the fly: x
    (N, H, W, C), wq (F, C, kh, kw) int8, w_scale (F,)."""
    xq, x_scale = dynamic_quant_per_tensor(x)
    acc = int_conv2d(xq, wq, stride=stride, padding=padding)
    return _epilogue(acc, x_scale * w_scale, b, residual, act, x.dtype)


def conv2d_w8a8_static(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                       a_scale: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                       stride: int = 1, padding: Padding = 0, act: Optional[str] = None,
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 NHWC conv with a calibrated 0-d f32 activation scale."""
    acc = int_conv2d(quant_static(x, a_scale), wq, stride=stride, padding=padding)
    return _epilogue(acc, a_scale * w_scale, b, residual, act, x.dtype)
