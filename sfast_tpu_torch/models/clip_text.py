"""CLIP text encoder — transformers' ``CLIPTextModel``, last hidden state.

Counterpart of ``sfast_tpu/models/clip_text.py`` for SD1.5's encoder
(CLIP ViT-L/14: quick_gelu, causal self-attention, final LayerNorm).  The
module carries transformers' state-dict names (``text_model.encoder.
layers.{i}.self_attn.q_proj``...).  Attention runs on the plain path
(seq 77), as JAX forces it (``clip_text.py:128``).
"""

import dataclasses

import torch
import torch.nn as nn

from sfast_tpu_torch.models.layers import LayerNorm, Linear
from sfast_tpu_torch.ops.attention import dot_product_attention
from sfast_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    # what SD1.5's tokenizer pads with (EOS), used to synthesize the
    # empty-prompt ids when no tokenizer is attached
    pad_token_id: int = 49407


SD15_TEXT_ENCODER = CLIPTextConfig()
# JAX's tiny config keeps SD1.5's EOS id 49407, past its 1000-token vocab;
# JAX clamps the lookup to row 999, which this config names outright.
TINY_TEXT_ENCODER = CLIPTextConfig(
    vocab_size=1000, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
    eos_token_id=999, pad_token_id=999,
)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.heads = heads
        self.q_proj = Linear(dim, dim, **mk)
        self.k_proj = Linear(dim, dim, **mk)
        self.v_proj = Linear(dim, dim, **mk)
        self.out_proj = Linear(dim, dim, **mk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape

        def split_heads(t):
            return t.view(b, s, self.heads, d // self.heads).transpose(1, 2)

        out = dot_product_attention(
            split_heads(self.q_proj(x)), split_heads(self.k_proj(x)),
            split_heads(self.v_proj(x)), causal=True, backend="plain",
        )
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, inner: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, inner, device=device, dtype=dtype)
        self.fc2 = Linear(inner, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x).float()
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu
        return self.fc2(h.to(x.dtype))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, **f32)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, **mk)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, **f32)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, **mk)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn(self.layer_norm1(h))
        return h + self.mlp(self.layer_norm2(h))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **mk)
        self.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **mk
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        return self.token_embedding(input_ids) + self.position_embedding.weight[:s]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.num_layers)]
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, device=device, dtype=dtype)
        self.encoder = CLIPEncoder(cfg, device=device, dtype=dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, device=device, dtype=torch.float32)


class CLIPTextModel(nn.Module):
    """``forward(input_ids (B, S) int) → last_hidden_state (B, S, D)``."""

    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT_ENCODER, *, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg, device=resolve_device(device), dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        h = tm.embeddings(input_ids)
        for layer in tm.encoder.layers:
            h = layer(h)
        return tm.final_layer_norm(h)
