"""CLIP text encoders — transformers' ``CLIPTextModel`` and
``CLIPTextModelWithProjection``.

Counterpart of ``sfast_tpu/models/clip_text.py``: SD1.5's encoder (CLIP
ViT-L/14: quick_gelu, last hidden state), SD2.x's (OpenCLIP ViT-H: exact
gelu) and SDXL's two (ViT-L and OpenCLIP ViT-bigG with its projection).
The module carries transformers' state-dict names (``text_model.encoder.
layers.{i}.self_attn.q_proj``..., the projection's ``text_projection``
at the top level).  Attention runs on the plain path (seq 77), as JAX
forces it (``clip_text.py:128``).

``forward(ids, output=...)`` returns what a pipeline reads and no more:
``'last'``, the last hidden state (SD1.5); ``'penultimate'``, the output
of layer L−1 before the final LayerNorm (JAX's ``hidden_states[-2]``;
SD2.x and SDXL's first encoder), which runs L−1 layers; or
``'penultimate_pooled'``, that and the projected pooled output (JAX's
``text_embeds``, the final LayerNorm's output at the first EOS; SDXL's
second encoder).  A captured graph is keyed by the mode.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    hidden_act: str = "quick_gelu"  # 'quick_gelu' (ViT-L) | 'gelu' (OpenCLIP, exact erf)
    projection_dim: Optional[int] = None  # set for CLIPTextModelWithProjection
    # the pooled output sits at the first EOS
    eos_token_id: int = 49407
    # what the paired tokenizer pads with: EOS for SD1.5's, 0 ('!') for
    # SD2.x's and SDXL's second; used to synthesize the empty-prompt ids
    # when no tokenizer is attached
    pad_token_id: int = 49407


SD15_TEXT_ENCODER = CLIPTextConfig()
SD21_TEXT_ENCODER = CLIPTextConfig(
    hidden_size=1024, intermediate_size=4096, num_layers=23, num_heads=16, hidden_act="gelu",
    pad_token_id=0,
)
SDXL_TEXT_ENCODER_2 = CLIPTextConfig(
    hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20, hidden_act="gelu",
    projection_dim=1280, pad_token_id=0,
)
# JAX's tiny config keeps SD1.5's EOS id 49407, past its 1000-token vocab;
# JAX clamps the lookup to row 999, which this config names outright.
TINY_TEXT_ENCODER = CLIPTextConfig(
    vocab_size=1000, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
    eos_token_id=999, pad_token_id=999,
)


class CLIPAttention(nn.Module):
    """Causal for text, not for an image's patches (``causal=False``).  Its
    heads under tensor parallelism: as ``layers.Attention``'s."""

    tp_pair = (("q_proj", "k_proj", "v_proj"), "out_proj", ())

    def __init__(self, dim: int, heads: int, *, causal: bool = True, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        self.heads = heads
        self.causal = causal
        self.q_proj = Linear(dim, dim, **mk)
        self.k_proj = Linear(dim, dim, **mk)
        self.v_proj = Linear(dim, dim, **mk)
        self.out_proj = Linear(dim, dim, **mk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape

        def split_heads(t):
            return t.view(b, s, self.heads, -1).transpose(1, 2)

        out = dot_product_attention(
            split_heads(self.q_proj(x)), split_heads(self.k_proj(x)),
            split_heads(self.v_proj(x)), causal=self.causal, backend="plain",
        )
        return self.out_proj(out.transpose(1, 2).reshape(b, s, -1))


class CLIPMLP(nn.Module):
    tp_pair = (("fc1",), "fc2", ())

    def __init__(self, dim: int, inner: int, act: str = "quick_gelu", *, device=None,
                 dtype=None):
        super().__init__()
        if act not in ("quick_gelu", "gelu"):
            raise ValueError(f"hidden_act {act!r}")
        self.act = act
        self.fc1 = Linear(dim, inner, device=device, dtype=dtype)
        self.fc2 = Linear(inner, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x).float()
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h.to(x.dtype))


class CLIPEncoderLayer(nn.Module):
    """One pre-LN layer; ``cfg`` is a text or a vision config."""

    def __init__(self, cfg, *, causal: bool = True, device=None, dtype=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, **f32)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, causal=causal, **mk)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, **f32)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act, **mk)

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
    def __init__(self, cfg, *, causal: bool = True, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, causal=causal, device=device,
                                                      dtype=dtype)
                                     for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, device=device, dtype=dtype)
        self.encoder = CLIPEncoder(cfg, device=device, dtype=dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, device=device, dtype=torch.float32)


_OUTPUTS = ("last", "penultimate", "penultimate_pooled")


class CLIPTextModel(nn.Module):
    """``forward(input_ids (B, S) int, output='last')``: see the module
    docstring for the modes.  With ``projection_dim`` the module holds
    transformers' ``CLIPTextModelWithProjection`` weights."""

    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT_ENCODER, *, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        device = resolve_device(device)
        self.text_model = CLIPTextTransformer(cfg, device=device, dtype=dtype)
        self.text_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False, device=device, dtype=dtype)
            if cfg.projection_dim is not None else None
        )

    def forward(self, input_ids: torch.Tensor, output: str = "last"):
        if output not in _OUTPUTS:
            raise ValueError(f"output {output!r}: one of {_OUTPUTS}")
        if output == "penultimate_pooled" and self.text_projection is None:
            raise ValueError("'penultimate_pooled' needs a text_projection (projection_dim)")
        tm = self.text_model
        layers = tm.encoder.layers
        h = tm.embeddings(input_ids)
        for layer in layers[:-1]:
            h = layer(h)
        if output == "penultimate":
            return h
        penultimate = h
        last = tm.final_layer_norm(layers[-1](h))
        if output == "last":
            return last
        # the pooled output: the final LayerNorm's output at the first EOS
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        return penultimate, self.text_projection(pooled)
