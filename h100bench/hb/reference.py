"""The plain reference: CLIP text encoders, the UNet, the VAE decoder.

Straightforward PyTorch after diffusers' ``UNet2DConditionModel`` and
``AutoencoderKL`` and transformers' ``CLIPTextModel`` /
``CLIPTextModelWithProjection``, in NCHW, with their state-dict names.  It
imports nothing but torch: no kernel, no graph, no cache, and nothing of
the program under test.  The benchmark runs it in float32 with TF32 off.

Every matrix product and convolution passes both operands through the
module's ``operand`` function, the identity by default.
:func:`set_operand_precision` swaps it for an fp8 (e4m3, per-tensor scale)
round trip: the reference computed one precision below the bfloat16 that
the configurations state, which is the control that a comparison has to
fail.
"""

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its absolute maximum onto 448), returned in ``x``'s dtype.  Under
    autograd the rounding passes the gradient through unchanged."""
    d = x.detach()
    scale = d.abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = ((d.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - d) if x.requires_grad else q


OPERANDS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": identity,
    "fp8": fp8_round_trip,
}


class Operand:
    """Mixin: a module whose products read their operands through
    ``self.operand``."""

    operand: Callable[[torch.Tensor], torch.Tensor] = staticmethod(identity)


def set_operand_precision(model: nn.Module, precision: str) -> nn.Module:
    """Make every product of ``model`` read its operands in ``precision``
    (a key of :data:`OPERANDS`)."""
    fn = OPERANDS[precision]
    for m in model.modules():
        if isinstance(m, Operand):
            m.operand = fn
    return model


class Linear(nn.Linear, Operand):
    def forward(self, x):
        q = self.operand
        return F.linear(q(x), q(self.weight), self.bias)


class Conv2d(nn.Conv2d, Operand):
    def forward(self, x):
        q = self.operand
        return F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding)


def attention(q, k, v, operand, causal: bool = False):
    """softmax(q·kᵀ/√d)·v over (B, H, S, D), materialized."""
    s = torch.matmul(operand(q), operand(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(operand(torch.softmax(s, dim=-1)), operand(v))


def sinusoid(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, shift: float = 0.0):
    """diffusers' ``get_timestep_embedding``: (N,) → (N, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    e = t.float()[:, None] * freqs[None, :]
    e = torch.cat([torch.cos(e), torch.sin(e)] if flip_sin_to_cos else
                  [torch.sin(e), torch.cos(e)], dim=-1)
    return F.pad(e, (0, 1)) if dim % 2 else e


# ---------------------------------------------------------------------------
# CLIP text encoders
# ---------------------------------------------------------------------------


class CLIPAttention(nn.Module, Operand):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, x):
        b, s, d = x.shape

        def split(t):
            return t.view(b, s, self.heads, -1).transpose(1, 2)

        o = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                      self.operand, causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, d, inner, act):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["hidden_size"]
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.get("layer_norm_eps", 1e-5))
        self.self_attn = CLIPAttention(d, cfg["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.get("layer_norm_eps", 1e-5))
        self.mlp = CLIPMLP(d, cfg["intermediate_size"], cfg["hidden_act"])

    def forward(self, h):
        h = h + self.self_attn(self.layer_norm1(h))
        return h + self.mlp(self.layer_norm2(h))


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                               cfg["hidden_size"])


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg) for _ in range(cfg["num_hidden_layers"]))


class _TextTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"],
                                             eps=cfg.get("layer_norm_eps", 1e-5))


class CLIPTextModel(nn.Module):
    """``forward(ids)`` → (hidden states of every layer, the pooled output
    projected where the model has ``text_projection``, else None).
    ``hidden[-1]`` is the last layer's output with the final LayerNorm,
    ``hidden[-2]`` the penultimate layer's without it (transformers'
    ``hidden_states[-2]``)."""

    def __init__(self, cfg: dict, eos_token_id: int):
        super().__init__()
        self.text_model = _TextTransformer(cfg)
        self.eos_token_id = eos_token_id
        with_projection = cfg.get("_class_name", cfg.get("architectures", [""])[0]) in (
            "CLIPTextModelWithProjection",)
        self.text_projection = (Linear(cfg["hidden_size"], cfg["projection_dim"], bias=False)
                                if with_projection else None)

    def forward(self, ids: torch.Tensor):
        tm = self.text_model
        e = tm.embeddings
        h = e.token_embedding(ids) + e.position_embedding.weight[: ids.shape[1]]
        hidden = [h]
        for layer in tm.encoder.layers:
            h = layer(h)
            hidden.append(h)
        hidden[-1] = tm.final_layer_norm(h)
        pooled = None
        if self.text_projection is not None:
            at = (ids == self.eos_token_id).int().argmax(dim=-1)
            rows = torch.arange(ids.shape[0], device=ids.device)
            pooled = self.text_projection(hidden[-1][rows, at])
        return hidden, pooled


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module, Operand):
    def __init__(self, d, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(d, d, bias=False)
        self.to_k = Linear(ctx_dim or d, d, bias=False)
        self.to_v = Linear(ctx_dim or d, d, bias=False)
        self.to_out = nn.ModuleList([Linear(d, d)])

    def forward(self, x, ctx=None):
        b, s, d = x.shape
        ctx = x if ctx is None else ctx

        def split(t):
            return t.view(b, -1, self.heads, d // self.heads).transpose(1, 2)

        o = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)),
                      self.operand)
        return self.to_out[0](o.transpose(1, 2).reshape(b, s, d))


class GEGLU(nn.Module):
    def __init__(self, d, inner):
        super().__init__()
        self.proj = Linear(d, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(d, 4 * d), nn.Identity(), Linear(4 * d, d)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, d, heads, ctx_dim):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(d) for _ in range(3))
        self.attn1 = Attention(d, heads)
        self.attn2 = Attention(d, heads, ctx_dim)
        self.ff = FeedForward(d)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, c, heads, ctx_dim, depth, linear_proj):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = nn.GroupNorm(32, c, eps=1e-6)
        self.proj_in = Linear(c, c) if linear_proj else Conv2d(c, c, 1)
        self.proj_out = Linear(c, c) if linear_proj else Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, heads, ctx_dim) for _ in range(depth))

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.linear_proj:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for blk in self.transformer_blocks:
            h = blk(h, ctx)
        if self.linear_proj:
            h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        return h + x


class Downsample2D(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim, cond_proj_dim=None):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)
        self.cond_proj = Linear(cond_proj_dim, cin, bias=False) if cond_proj_dim else None

    def forward(self, x, cond=None):
        if cond is not None:
            x = x + self.cond_proj(cond)
        return self.linear_2(F.silu(self.linear_1(x)))


class _Block(nn.Module):
    def __init__(self, resnets, attentions, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([down]) if down else None
        self.upsamplers = nn.ModuleList([up]) if up else None


def _per_level(v, n: int) -> Sequence[int]:
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class UNet2DConditionModel(nn.Module):
    """diffusers' UNet2DConditionModel of the published ``config.json``
    (SD1.5 and SDXL): ``forward(sample, t, context, added=None,
    timestep_cond=None)``, NCHW.  ``attention_head_dim`` is read as the
    number of heads, as diffusers reads it for these models."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        boc = cfg["block_out_channels"]
        n = len(boc)
        heads = _per_level(cfg["attention_head_dim"], n)
        depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
        lpb = cfg["layers_per_block"]
        groups, eps = cfg["norm_num_groups"], cfg.get("norm_eps", 1e-5)
        ctx = cfg["cross_attention_dim"]
        lin = cfg.get("use_linear_projection", False)
        temb = 4 * boc[0]

        def resnet(i, o):
            return ResnetBlock2D(i, o, temb, groups, eps)

        def transformer(c, level):
            return Transformer2DModel(c, heads[level], ctx, depth[level], lin)

        self.conv_in = Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb, cfg.get("time_cond_proj_dim"))
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg["projection_class_embeddings_input_dim"], temb)
        down, c_out = [], boc[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            c_in, c_out = c_out, boc[i]
            down.append(_Block(
                [resnet(c_in if j == 0 else c_out, c_out) for j in range(lpb)],
                [transformer(c_out, i) for _ in range(lpb)] if kind.startswith("CrossAttn")
                else None,
                down=Downsample2D(c_out) if i < n - 1 else None))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block([resnet(boc[-1], boc[-1]), resnet(boc[-1], boc[-1])],
                                [transformer(boc[-1], n - 1)])
        up, rev = [], list(reversed(boc))
        c_prev = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            c_out, c_skip = rev[i], rev[min(i + 1, n - 1)]
            up.append(_Block(
                [resnet((c_prev if j == 0 else c_out) + (c_skip if j == lpb else c_out), c_out)
                 for j in range(lpb + 1)],
                [transformer(c_out, n - 1 - i) for _ in range(lpb + 1)]
                if kind.startswith("CrossAttn") else None,
                up=Upsample2D(c_out) if i < n - 1 else None))
            c_prev = c_out
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=eps)
        self.conv_out = Conv2d(boc[0], cfg["out_channels"], 3, padding=1)

    def embedding(self, t, batch, added=None, timestep_cond=None):
        cfg = self.cfg
        t = t.reshape(-1).expand(batch) if t.numel() == 1 else t
        flip, shift = cfg.get("flip_sin_to_cos", True), cfg.get("freq_shift", 0)
        emb = self.time_embedding(sinusoid(t, cfg["block_out_channels"][0], flip, shift),
                                  timestep_cond)
        if cfg.get("addition_embed_type") == "text_time":
            ids = sinusoid(added["time_ids"].reshape(-1), cfg["addition_time_embed_dim"],
                           flip, shift).reshape(batch, -1)
            emb = emb + self.add_embedding(torch.cat([added["text_embeds"], ids], dim=-1))
        return emb

    def forward(self, x, t, ctx, added=None, timestep_cond=None):
        emb = self.embedding(t, x.shape[0], added, timestep_cond)
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(h, emb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, emb), ctx), emb)
        for blk in self.up_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, skips.pop()], dim=1), emb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, ctx)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# ---------------------------------------------------------------------------
# VAE (the decoder runs; the encoder's parameters are held so that the state
# dict is the published model's)
# ---------------------------------------------------------------------------


class VAEAttention(nn.Module, Operand):
    def __init__(self, c, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        o = attention(self.to_q(h)[:, None], self.to_k(h)[:, None], self.to_v(h)[:, None],
                      self.operand)[:, 0]
        return x + self.to_out[0](o).transpose(1, 2).reshape(b, c, hh, ww)


class _Mid(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock2D(c, c, None, groups, 1e-6) for _ in range(2))
        self.attentions = nn.ModuleList([VAEAttention(c, groups)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class EncoderDownsample(nn.Module):
    """The encoder's stride-2 conv (held, not run)."""

    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)


class _Coder(nn.Module):
    """The encoder's or the decoder's modules under their published names."""

    def __init__(self, cfg: dict, decoder: bool):
        super().__init__()
        boc, groups, lpb = cfg["block_out_channels"], cfg["norm_num_groups"], cfg[
            "layers_per_block"]
        chans = list(reversed(boc)) if decoder else list(boc)
        self.conv_in = Conv2d(cfg["latent_channels"] if decoder else cfg["in_channels"],
                              chans[0], 3, padding=1)
        if decoder:
            self.mid_block = _Mid(chans[0], groups)
        blocks, c_prev = [], chans[0]
        for i, c in enumerate(chans):
            last = i == len(chans) - 1
            res = [ResnetBlock2D(c_prev if j == 0 else c, c, None, groups, 1e-6)
                   for j in range(lpb + (1 if decoder else 0))]
            if decoder:
                blocks.append(_Block(res, None, up=None if last else Upsample2D(c)))
            else:
                blocks.append(_Block(res, None, down=None if last else EncoderDownsample(c)))
            c_prev = c
        if decoder:
            self.up_blocks = nn.ModuleList(blocks)
        else:
            self.down_blocks = nn.ModuleList(blocks)
            self.mid_block = _Mid(chans[-1], groups)
        self.conv_norm_out = nn.GroupNorm(groups, boc[0] if decoder else chans[-1], eps=1e-6)
        self.conv_out = Conv2d(boc[0] if decoder else chans[-1],
                               cfg["out_channels"] if decoder else 2 * cfg["latent_channels"],
                               3, padding=1)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        lc = cfg["latent_channels"]
        self.scaling_factor = cfg["scaling_factor"]
        self.encoder = _Coder(cfg, decoder=False)
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)
        self.decoder = _Coder(cfg, decoder=True)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents already divided by the scaling factor → image in about
        [-1, 1], NCHW."""
        d = self.decoder
        h = d.mid_block(d.conv_in(self.post_quant_conv(z)))
        for blk in d.up_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        return d.conv_out(F.silu(d.conv_norm_out(h)))


def levels(image: torch.Tensor) -> torch.Tensor:
    """An image in [-1, 1] as unrounded uint8 levels in [0, 255]."""
    return (image.float() / 2 + 0.5).clamp(0.0, 1.0) * 255.0


def no_tf32() -> None:
    """float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
