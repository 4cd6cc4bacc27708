"""Building blocks of the diffusion models, as ``nn.Module``s.

Counterpart of ``sfast_tpu/models/layers.py``.  The modules carry
diffusers' state-dict names (``to_out.0``, ``ff.net.0.proj``,
``upsamplers.0.conv``...) with PyTorch's weight layouts (Linear (out, in),
conv OIHW); activations stay NHWC, as in JAX, and every op goes through
``sfast_tpu_torch.ops``.  Normalization parameters are f32 whatever the
model's dtype, as JAX keeps them.

A ``Linear`` or a conv quantized in place (``quant/dynamic_quant.py``) has
no ``weight``; it holds ``w_q`` (W8A16) or ``w_q8`` (W8A8), ``w_scale`` and
maybe a calibrated ``a_scale``, and its forward routes by what it holds,
as JAX's ``apply_linear`` / ``apply_conv`` (``layers.py:147-185``):
``ops.quant``'s W8A16 linear, or its W8A8 linear and conv, static where
``a_scale`` is held.  JAX keeps a W8A8 conv's weight under ``w_q``; here
``w_q8`` names int8 compute for both.

Routing, as in JAX (``layers.py:472-486, 576-590, 614-636, 693-696``):
``attn_backend`` (``ops.attention``: ``None``, ``'int8'``, ``'flash_int8'``
or ``'plain'``), ``conv_backend`` (``None`` = auto rule or ``'plain'``),
``gn_backend`` (``ops.group_norm``: ``None`` = auto rule, on the card the
fused GroupNorm for bf16, ``'kernel'``, ``'hybrid'`` or ``'plain'``) and
``geglu_backend`` (``ops.geglu``: ``None`` = auto rule, ``'kernel'`` or
``'plain'``) and ``ln_backend`` (``ops.layer_norm``: ``None`` = auto rule,
on the card K7 for bf16, ``'kernel'`` or ``'plain'``); the models derive
them from their ``CompilationConfig``.  A ``LayerNorm`` module takes the
plain form unless its caller names a backend: the UNets' transformer blocks
pass theirs, and the CLIP encoders and the IP-Adapter projection, which sit
outside the UNet's configuration, stay plain.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfast_tpu_torch.ops.attention import dot_product_attention
from sfast_tpu_torch.ops.conv import conv2d
from sfast_tpu_torch.ops.fused_conv import (
    affine_from_stats,
    conv3x3_block,
    conv3x3_gn_silu,
    gn_affine,
)
from sfast_tpu_torch.ops.geglu import linear_geglu
from sfast_tpu_torch.ops.group_norm import group_norm
from sfast_tpu_torch.ops.layer_norm import layer_norm
from sfast_tpu_torch.ops.linear import linear
from sfast_tpu_torch.ops.quant import (
    conv2d_w8a8,
    conv2d_w8a8_static,
    int8_linear,
    linear_w8a8,
    linear_w8a8_static,
)

# ---------------------------------------------------------------------------
# Parameter-holding leaves: PyTorch's modules with NHWC forwards
# ---------------------------------------------------------------------------


def quantized_linear(m: nn.Linear, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """A quantized linear's forward, by what it holds (JAX ``apply_linear``)."""
    a_scale = getattr(m, "a_scale", None)
    if getattr(m, "w_q8", None) is not None:
        if a_scale is not None:
            return linear_w8a8_static(x, m.w_q8, m.w_scale, a_scale, m.bias, act=act)
        return linear_w8a8(x, m.w_q8, m.w_scale, m.bias, act=act)
    return int8_linear(x, m.w_q, m.w_scale, m.bias, act=act)


def quantized_conv(m: nn.Module, x: torch.Tensor, stride: int, padding) -> torch.Tensor:
    """A W8A8 conv's forward (JAX ``apply_conv``): x NHWC, ``w_q8`` (F, C,
    kh, kw) int8, static where ``a_scale`` is held."""
    a_scale = getattr(m, "a_scale", None)
    if a_scale is not None:
        return conv2d_w8a8_static(x, m.w_q8, m.w_scale, a_scale, m.bias, stride=stride,
                                  padding=padding)
    return conv2d_w8a8(x, m.w_q8, m.w_scale, m.bias, stride=stride, padding=padding)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        if self.weight is None:
            return quantized_linear(self, x, act)
        return linear(x, self.weight, self.bias, act=act)


class Conv2d(nn.Conv2d):
    """NHWC conv with an OIHW weight, kept channels_last: the layout cuDNN
    reads for an NHWC input, and in memory the (F, 3, 3, C) layout K2 reads,
    so neither route ever copies it.  The weight is permuted into that
    layout once, here, and ``load_state_dict`` copies into it in place."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.weight.data = self.weight.data.contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            return quantized_conv(self, x, self.stride[0], self.padding)
        return conv2d(
            x, self.weight, self.bias, stride=self.stride[0], padding=self.padding[0]
        )

    def hwio_weight(self) -> torch.Tensor:
        """The weight as the HWIO view JAX's signature takes (no copy)."""
        return self.weight.detach().permute(2, 3, 1, 0)


class GroupNorm(nn.GroupNorm):
    def forward(
        self, x: torch.Tensor, act: Optional[str] = None, backend: Optional[str] = None
    ) -> torch.Tensor:
        return group_norm(
            x, self.weight, self.bias, groups=self.num_groups, eps=self.eps, act=act,
            backend=backend,
        )


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor, backend: Optional[str] = "plain") -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps, backend=backend)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights at the scales of JAX's ``init_*``
    (``layers.py:118-137``): linear and conv weights N(0, 1/fan_in) (3·C
    for a temporal (3, 1, 1) conv), biases 0, norms (1, 0), embeddings and
    any parameter held bare by a module of no other kind (CLIP vision's
    class token, an SVD ``mix_factor``) N(0, 0.02²).
    Values are drawn on ``generator``'s device in f32, in module order,
    then cast."""

    def randn_(p: torch.Tensor, std: float) -> None:
        r = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
        p.copy_(r * std)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            randn_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            randn_(m.weight, 0.02)
        else:
            for p in m.parameters(recurse=False):
                randn_(p, 0.02)
    return module


# ---------------------------------------------------------------------------
# Timestep embeddings (diffusers Timesteps + TimestepEmbedding)
# ---------------------------------------------------------------------------


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """diffusers ``Timesteps``: (N,) timesteps → (N, dim) f32.  ``t`` may be
    any positions: a video's frame indices too (the SVD UNet's
    ``time_pos_embed``)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    emb = torch.exp(exponent / (half - freq_shift))[None, :] * t.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """diffusers TimestepEmbedding (``out_dim``: ``linear_2``'s width, else
    ``time_dim``); with ``cond_proj_dim``, the bias-free ``cond_proj`` of
    an LCM-distilled UNet, which adds the projected guidance embedding to
    the timestep embedding (JAX ``layers.py:293-320``)."""

    def __init__(self, cin: int, time_dim: int, *, out_dim: Optional[int] = None,
                 cond_proj_dim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.linear_1 = Linear(cin, time_dim, **mk)
        self.linear_2 = Linear(time_dim, out_dim or time_dim, **mk)
        self.cond_proj = (Linear(cond_proj_dim, cin, bias=False, **mk)
                          if cond_proj_dim is not None else None)

    def forward(self, t_emb: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is not None and self.cond_proj is not None:
            t_emb = t_emb + self.cond_proj(cond.to(t_emb.dtype))
        return self.linear_2(self.linear_1(t_emb, act="silu"))


def guidance_scale_embedding(w, dim: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embedding of a guidance weight (diffusers'
    ``LatentConsistencyModelPipeline.get_guidance_scale_embedding``, JAX
    ``layers.py:323-342``): ``w`` times 1000 over log-spaced frequencies,
    the sin half then the cos half.  The caller passes ``w = gs − 1``;
    ``w`` is a scalar or (B,), the result (B, dim)."""
    w = torch.atleast_1d(torch.as_tensor(w)).float() * 1000.0
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device)
                      * (-math.log(10000.0) / (half - 1)))
    emb = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def lcm_timestep_cond(guidance_scale, tcond_dim: Optional[int], batch: int):
    """The LCM ``timestep_cond`` input (B, tcond_dim) from the guidance
    scale (``w = gs − 1``), or None for a UNet without ``cond_proj``: the
    one site of the convention, for the stepwise and the fused paths of
    both pipelines (JAX ``layers.py:345-357``)."""
    if tcond_dim is None:
        return None
    return guidance_scale_embedding(guidance_scale - 1.0, tcond_dim).expand(batch, tcond_dim)


# ---------------------------------------------------------------------------
# ResnetBlock2D
# ---------------------------------------------------------------------------

# A 3×3 conv takes the fused kernel from 128² pixels up (JAX ``layers.py:393``).
FUSED_CONV_MIN_HW = 16384


def fused_conv_ok(
    x_shape, dtype: torch.dtype, device_type: str, kernel_size, backend: Optional[str]
) -> bool:
    """The auto rule for K2 (JAX ``_fused_conv_ok``, with "on TPU" read as
    "tensor on CUDA"): a bf16 NHWC input on CUDA with H·W ≥ 128² and a 3×3
    weight, unless the caller chose the plain path."""
    return (
        backend != "plain"
        and tuple(kernel_size) == (3, 3)
        and dtype == torch.bfloat16
        and device_type == "cuda"
        and x_shape[1] * x_shape[2] >= FUSED_CONV_MIN_HW
    )


def _fused_ok(conv: Conv2d, x: torch.Tensor, backend: Optional[str]) -> bool:
    """K2 takes a bf16 weight: a quantized conv never (JAX ``layers.py:399``)."""
    return conv.weight is not None and fused_conv_ok(
        x.shape, x.dtype, x.device.type, conv.kernel_size, backend)


class ResnetBlock2D(nn.Module):
    def __init__(
        self,
        cin: int,
        cout: int,
        temb_dim: Optional[int],
        *,
        groups: int = 32,
        eps: float = 1e-5,
        device=None,
        dtype=None,
    ):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        mk = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(groups, cin, eps=eps, **f32)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, **mk)
        self.time_emb_proj = Linear(temb_dim, cout, **mk) if temb_dim is not None else None
        self.norm2 = GroupNorm(groups, cout, eps=eps, **f32)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, **mk)
        self.conv_shortcut = Conv2d(cin, cout, 1, **mk) if cin != cout else None

    def _temb(self, temb: torch.Tensor) -> torch.Tensor:
        return self.time_emb_proj(F.silu(temb.float()).to(temb.dtype))

    def forward(
        self,
        x: torch.Tensor,
        temb: Optional[torch.Tensor] = None,
        *,
        gn_backend: Optional[str] = None,
        conv_backend: Optional[str] = None,
        output_scale: float = 1.0,
    ) -> torch.Tensor:
        """diffusers ResnetBlock2D over NHWC.  Above the K2 threshold the
        block is two fused launches (JAX ``layers.py:428-470``): conv1 takes
        GN1 from K3's statistics, folds the temb projection into a
        per-batch bias and emits its output's sums; conv2 takes GN2 from
        those sums and adds the skip and the output scale."""
        groups, eps = self.norm1.num_groups, self.norm1.eps
        use_temb = temb is not None and self.time_emb_proj is not None
        if _fused_ok(self.conv1, x, conv_backend) and _fused_ok(self.conv2, x, conv_backend):
            n, hh, ww, _ = x.shape
            sc1, sh1 = gn_affine(x, self.norm1.weight, self.norm1.bias, groups=groups, eps=eps)
            bias_b = self.conv1.bias.float()[None, :]
            if use_temb:
                bias_b = bias_b + self._temb(temb).float()
            else:
                bias_b = bias_b.expand(n, -1)
            h, s1, s2 = conv3x3_block(
                x, self.conv1.hwio_weight(), bias_batch=bias_b,
                gn_scale=sc1, gn_shift=sh1, emit_stats=True,
            )
            sc2, sh2 = affine_from_stats(
                s1, s2, hh * ww, self.norm2.weight, self.norm2.bias,
                groups=groups, eps=eps,
            )
            skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
            return conv3x3_block(
                h, self.conv2.hwio_weight(), self.conv2.bias,
                gn_scale=sc2, gn_shift=sh2, residual=skip, output_scale=output_scale,
            )

        h = self.conv1(self.norm1(x, act="silu", backend=gn_backend))
        if use_temb:
            h = h + self._temb(temb)[:, None, None, :].to(h.dtype)
        h = self.conv2(self.norm2(h, act="silu", backend=gn_backend))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return ((skip.float() + h.float()) / output_scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention, feed-forward, transformer blocks
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Multi-head self- or cross-attention over (B, S, D) tokens.

    An IP-Adapter (``ip_adapter.load_ip_adapter``) gives a cross-attention
    the bias-free ``to_k_ip`` / ``to_v_ip`` of diffusers'
    ``IPAdapterAttnProcessor``; with ``ip_embeds`` (B, N, context_dim) the
    forward adds ``ip_scale · attention(q, k_ip, v_ip)`` before ``to_out``
    (JAX ``layers.py:520-560``).

    Under tensor parallelism (``parallel/tensor_parallel.py``) the module
    holds ``heads / tp`` heads: the projections yield the rank's shard, so
    the head dim and the output width are read from q's width.  The IP
    projections are column-split with ``to_q`` (JAX leaves them replicated
    and GSPMD copes; explicit local heads cannot), so load an IP-Adapter
    before sharding."""

    tp_pair = (("to_q", "to_k", "to_v"), "to_out.0", ("to_k_ip", "to_v_ip"))

    def __init__(
        self,
        dim: int,
        heads: int,
        *,
        context_dim: Optional[int] = None,
        qkv_bias: bool = False,
        device=None,
        dtype=None,
    ):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        ctx = context_dim or dim
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=qkv_bias, **mk)
        self.to_k = Linear(ctx, dim, bias=qkv_bias, **mk)
        self.to_v = Linear(ctx, dim, bias=qkv_bias, **mk)
        self.to_out = nn.ModuleList([Linear(dim, dim, **mk)])
        self.to_k_ip: Optional[Linear] = None
        self.to_v_ip: Optional[Linear] = None

    def add_ip_projections(self) -> None:
        """Give this attention the IP-Adapter's two projections, on its own
        device and dtype (zero until loaded)."""
        if getattr(self, "tp_local", False):
            raise ValueError("this attention is tensor-parallel (its heads are the rank's); "
                             "load the IP-Adapter before sharding")
        k = self.to_k  # maybe quantized: read its sizes, and to_out's bias for the rest
        b = self.to_out[0].bias
        mk = dict(device=b.device, dtype=b.dtype)
        self.to_k_ip = Linear(k.in_features, k.out_features, bias=False, **mk)
        self.to_v_ip = Linear(k.in_features, k.out_features, bias=False, **mk)
        with torch.no_grad():
            self.to_k_ip.weight.zero_()
            self.to_v_ip.weight.zero_()

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        *,
        causal: bool = False,
        attn_backend: Optional[str] = None,
        ip_embeds: Optional[torch.Tensor] = None,
        ip_scale=1.0,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        ctx = x if context is None else context
        q = self.to_q(x)
        dh = q.shape[-1] // self.heads

        def split_heads(t):  # (B, S, H·dh) → (B, H, S, dh) view
            return t.view(b, -1, self.heads, dh).transpose(1, 2)

        q = split_heads(q)
        out = dot_product_attention(
            q, split_heads(self.to_k(ctx)), split_heads(self.to_v(ctx)),
            causal=causal, backend=attn_backend,
        )
        if ip_embeds is not None and self.to_k_ip is not None:
            e = ip_embeds.to(x.dtype)
            ip = dot_product_attention(q, split_heads(self.to_k_ip(e)),
                                       split_heads(self.to_v_ip(e)), backend=attn_backend)
            # ``ip_scale`` is a Python float or a 0-d f32 tensor: either way
            # the term stays in x's dtype (a 0-d tensor does not promote a
            # bf16 one), as JAX's stepwise path, which passes a float
            # (stable_diffusion.py:936-937).  JAX's fused loop passes a 0-d
            # f32 array, which promotes the sum to f32 from here on.
            out = out + ip_scale * ip
        return self.to_out[0](out.transpose(1, 2).reshape(b, s, -1))


class GEGLU(nn.Module):
    """``proj``'s (2F, d) weight holds the hidden rows, then the gate rows:
    a column shard takes its slice of each half
    (``parallel/sharding.out_chunks``)."""

    def __init__(self, dim: int, inner: int, *, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(dim, inner * 2, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, backend: Optional[str] = None) -> torch.Tensor:
        if self.proj.weight is None or not getattr(self.proj, "local_gemm", True):
            # quantized: the int8 linear, then hidden · gelu(gate) with the
            # erf GELU in f32; never K4 (JAX layers.py:578-590).  A
            # tensor-parallel proj outside its pair gathers or reduces in its
            # forward, which this takes too
            h, gate = self.proj(x).chunk(2, dim=-1)
            return (h.float() * F.gelu(gate.float())).to(x.dtype)
        return linear_geglu(x, self.proj.weight, self.proj.bias, backend=backend)


class FeedForward(nn.Module):
    """diffusers FeedForward: ``net = [GEGLU, Dropout, Linear]``."""

    tp_pair = (("net.0.proj",), "net.2", ())

    def __init__(self, dim: int, mult: int = 4, *, device=None, dtype=None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([
            GEGLU(dim, inner, device=device, dtype=dtype),
            nn.Identity(),  # dropout slot, keeps diffusers' index of the out proj
            Linear(inner, dim, device=device, dtype=dtype),
        ])

    def forward(self, x: torch.Tensor, geglu_backend: Optional[str] = None) -> torch.Tensor:
        return self.net[2](self.net[0](x, backend=geglu_backend))


class BasicTransformerBlock(nn.Module):
    """diffusers BasicTransformerBlock (pre-LN): self-attention,
    cross-attention and GEGLU feed-forward, each residual."""

    def __init__(self, dim: int, heads: int, context_dim: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.norm1 = LayerNorm(dim, **f32)
        self.attn1 = Attention(dim, heads, **mk)
        self.norm2 = LayerNorm(dim, **f32)
        self.attn2 = Attention(dim, heads, context_dim=context_dim, **mk)
        self.norm3 = LayerNorm(dim, **f32)
        self.ff = FeedForward(dim, **mk)

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor,
        *,
        attn_backend: Optional[str] = None,
        geglu_backend: Optional[str] = None,
        ln_backend: Optional[str] = None,
        ip_embeds: Optional[torch.Tensor] = None,
        ip_scale=1.0,
    ) -> torch.Tensor:
        """``ip_embeds`` / ``ip_scale`` (IP-Adapter) reach ``attn2`` only."""
        x = x + self.attn1(self.norm1(x, ln_backend), attn_backend=attn_backend)
        x = x + self.attn2(self.norm2(x, ln_backend), context, attn_backend=attn_backend,
                           ip_embeds=ip_embeds, ip_scale=ip_scale)
        return x + self.ff(self.norm3(x, ln_backend), geglu_backend=geglu_backend)


class Transformer2DModel(nn.Module):
    """diffusers Transformer2DModel over NHWC: GN(32 groups, eps 1e-6) →
    proj_in → blocks over (B, H·W, C) tokens → proj_out → + residual.  In
    NHWC the token view is a free reshape."""

    def __init__(
        self,
        channels: int,
        heads: int,
        context_dim: int,
        *,
        depth: int = 1,
        use_linear_projection: bool = False,
        device=None,
        dtype=None,
    ):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(32, channels, eps=1e-6, device=device, dtype=torch.float32)
        if use_linear_projection:
            self.proj_in = Linear(channels, channels, **mk)
            self.proj_out = Linear(channels, channels, **mk)
        else:
            self.proj_in = Conv2d(channels, channels, 1, **mk)
            self.proj_out = Conv2d(channels, channels, 1, **mk)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim, **mk) for _ in range(depth)]
        )

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor,
        *,
        gn_backend: Optional[str] = None,
        attn_backend: Optional[str] = None,
        geglu_backend: Optional[str] = None,
        ln_backend: Optional[str] = None,
        ip_embeds: Optional[torch.Tensor] = None,
        ip_scale=1.0,
    ) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        h = self.norm(x, backend=gn_backend)
        if self.use_linear_projection:
            h = self.proj_in(h.reshape(b, hgt * wid, c))
        else:
            h = self.proj_in(h).reshape(b, hgt * wid, c)
        for blk in self.transformer_blocks:
            h = blk(h, context, attn_backend=attn_backend, geglu_backend=geglu_backend,
                    ln_backend=ln_backend, ip_embeds=ip_embeds, ip_scale=ip_scale)
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(b, hgt, wid, c)
        else:
            h = self.proj_out(h.reshape(b, hgt, wid, c))
        return h + x


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


class Downsample2D(nn.Module):
    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, *, conv_backend: Optional[str] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        if _fused_ok(self.conv, x, conv_backend):
            # JAX layers.py:761-764: the post-upsample conv through K2
            return conv3x3_gn_silu(x, self.conv.hwio_weight(), self.conv.bias)
        return self.conv(x)
