"""A diffusers pipeline → the port's pipeline of the port's models.

Counterpart of ``sfast_tpu/interop/diffusers_adapter.py``:
``sfast_tpu_torch.compile(pipe)`` lands here when a slot of ``pipe`` holds
a torch module that is not one of the port's models (diffusers' UNet,
transformers' CLIP...).  Each slot is read through its ``.config`` and its
``.state_dict()`` only, never called: the port builds its own model of the
same configuration on the card (``runtime/device.py``: the CPU only when
the caller asks for it), in ``CompilationConfig.param_dtype``, and loads
the state dict with ``strict=True``.  Neither diffusers nor transformers is
imported: a slot is duck-typed, as the reference probes its pipeline's
attributes (``diffusion_pipeline_compiler.py:88-124``).

The port's modules take diffusers' and transformers' names and shapes, so
a state dict loads as it is but for :func:`map_state_dict`'s cases: the
legacy VAE attention names, 1×1 convs stored where the port holds linear
weights (or the reverse), transformers' ``position_ids`` buffer, and a
CLIP text encoder without ``text_projection`` (whose config still states a
``projection_dim``).

The config readers are the port's own copies of JAX's
(``sfast_tpu/interop/convert_unet.py:22``, ``convert_vae.py:17,111``,
``convert_svd.py:25``, ``convert_clip.py:13,89``), into the port's config
classes, which carry no dtype.
"""

import dataclasses
import logging
from typing import Any, Dict, Optional

import torch

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models import (
    AutoencoderKL,
    AutoencoderKLTemporalDecoder,
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionModel,
    ControlNetConfig,
    ControlNetModel,
    SVDUNetConfig,
    TemporalVAEConfig,
    UNet2DConditionModel,
    UNetConfig,
    UNetSpatioTemporalConditionModel,
    VAEConfig,
)
from sfast_tpu_torch.runtime.device import resolve_device
from sfast_tpu_torch.schedulers import (
    DDIMScheduler,
    DPMSolverMultistepScheduler,
    EulerAncestralDiscreteScheduler,
    EulerDiscreteScheduler,
    LCMScheduler,
    SchedulerConfig,
)

logger = logging.getLogger(__name__)

# diffusers' legacy VAE attention names -> the current ones, which the port takes
_LEGACY_VAE_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v",
                         "proj_attn": "to_out.0"}


# ---------------------------------------------------------------------------
# config readers
# ---------------------------------------------------------------------------


def _per_level(v, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


def unet_config_from_diffusers(cfg: Dict[str, Any]) -> UNetConfig:
    """A ``UNet2DConditionModel`` config dict → :class:`UNetConfig`.
    ``attention_head_dim`` is read as the heads per level where
    ``num_attention_heads`` is absent (diffusers' legacy SD naming)."""
    n = len(cfg["block_out_channels"])
    heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    return UNetConfig(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        layers_per_block=cfg["layers_per_block"],
        transformer_layers_per_block=_per_level(cfg.get("transformer_layers_per_block", 1), n),
        num_heads=_per_level(heads, n),
        cross_attention_dim=cfg["cross_attention_dim"],
        use_linear_projection=cfg.get("use_linear_projection", False),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim") or 256,
        projection_class_embeddings_input_dim=cfg.get("projection_class_embeddings_input_dim"),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
        time_cond_proj_dim=cfg.get("time_cond_proj_dim"),
    )


def vae_config_from_diffusers(cfg: Dict[str, Any], cls=VAEConfig):
    """An ``AutoencoderKL`` config dict → :class:`VAEConfig` (``cls``)."""
    return cls(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def temporal_vae_config_from_diffusers(cfg: Dict[str, Any]) -> TemporalVAEConfig:
    """An ``AutoencoderKLTemporalDecoder`` config dict → :class:`TemporalVAEConfig`."""
    return vae_config_from_diffusers(cfg, TemporalVAEConfig)


def svd_config_from_diffusers(cfg: Dict[str, Any]) -> SVDUNetConfig:
    """A ``UNetSpatioTemporalConditionModel`` config dict → :class:`SVDUNetConfig`."""
    n = len(cfg["block_out_channels"])
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim")
    return SVDUNetConfig(
        sample_size=cfg.get("sample_size", 96),
        in_channels=cfg.get("in_channels", 8),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        transformer_layers_per_block=_per_level(cfg.get("transformer_layers_per_block", 1), n),
        num_heads=_per_level(heads, n),
        cross_attention_dim=cfg.get("cross_attention_dim", 1024),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=cfg.get(
            "projection_class_embeddings_input_dim", 768),
        num_frames=cfg.get("num_frames", 25),
    )


def clip_config_from_hf(hf_config) -> CLIPTextConfig:
    """A transformers ``CLIPTextConfig`` (read by attribute) → :class:`CLIPTextConfig`."""
    return CLIPTextConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        max_position_embeddings=hf_config.max_position_embeddings,
        hidden_act=hf_config.hidden_act,
        projection_dim=getattr(hf_config, "projection_dim", None),
        eos_token_id=getattr(hf_config, "eos_token_id", 49407) or 49407,
    )


def clip_vision_config_from_hf(hf_config) -> CLIPVisionConfig:
    """A transformers ``CLIPVisionConfig`` (read by attribute) → :class:`CLIPVisionConfig`."""
    return CLIPVisionConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        projection_dim=getattr(hf_config, "projection_dim", None),
        hidden_act=hf_config.hidden_act,
    )


# ---------------------------------------------------------------------------
# state dicts and models
# ---------------------------------------------------------------------------


def _legacy_name(key: str) -> str:
    parts = key.split(".")
    if len(parts) >= 3 and "attentions" in parts and parts[-2] in _LEGACY_VAE_ATTENTION:
        parts[-2] = _LEGACY_VAE_ATTENTION[parts[-2]]
    return ".".join(parts)


def map_state_dict(sd: Dict[str, torch.Tensor], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``sd`` (diffusers' or transformers' names) with the keys and shapes
    of ``module``'s state dict: legacy VAE attention names renamed
    (``query`` → ``to_q``, ``proj_attn`` → ``to_out.0``...), a 1×1 conv
    weight (C, C, 1, 1) reshaped to the linear (C, C) the module holds or
    the reverse, and ``position_ids`` buffers the module does not hold
    dropped.  Anything else is left for ``load_state_dict(strict=True)``
    to refuse."""
    own = module.state_dict()
    out = {}
    for key, t in sd.items():
        if key not in own and key.endswith("position_ids"):
            continue
        if key not in own and _legacy_name(key) in own:
            key = _legacy_name(key)
        want = own.get(key)
        if want is not None and t.shape != want.shape and t.numel() == want.numel() and (
                tuple(t.shape[:2]) == tuple(want.shape[:2])):
            t = t.reshape(want.shape)  # a 1×1 conv as a linear, or the reverse
        out[key] = t
    return out


def _load(module: torch.nn.Module, sd) -> torch.nn.Module:
    with torch.no_grad():
        module.load_state_dict(map_state_dict(sd, module), strict=True)
    return module.eval()


def _torch_dtype(name) -> torch.dtype:
    dtype = getattr(torch, str(name).replace("torch.", ""), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"param_dtype {name!r} is not a torch dtype")
    return dtype


def convert_unet(torch_unet, device, dtype) -> UNet2DConditionModel:
    cfg = unet_config_from_diffusers(dict(torch_unet.config))
    return _load(UNet2DConditionModel(cfg, device=device, dtype=dtype), torch_unet.state_dict())


def convert_svd_unet(torch_unet, device, dtype) -> UNetSpatioTemporalConditionModel:
    cfg = svd_config_from_diffusers(dict(torch_unet.config))
    return _load(UNetSpatioTemporalConditionModel(cfg, device=device, dtype=dtype),
                 torch_unet.state_dict())


def convert_vae(torch_vae, device, dtype):
    """An ``AutoencoderKL``, or SVD's ``AutoencoderKLTemporalDecoder`` (by its
    class name or its ``decoder.time_conv_out``)."""
    sd = torch_vae.state_dict()
    raw = dict(torch_vae.config)
    if (type(torch_vae).__name__ == "AutoencoderKLTemporalDecoder"
            or "decoder.time_conv_out.weight" in sd):
        return _load(AutoencoderKLTemporalDecoder(temporal_vae_config_from_diffusers(raw),
                                                  device=device, dtype=dtype), sd)
    return _load(AutoencoderKL(vae_config_from_diffusers(raw), device=device, dtype=dtype), sd)


def convert_text_encoder(torch_te, device, dtype) -> CLIPTextModel:
    sd = torch_te.state_dict()
    cfg = clip_config_from_hf(torch_te.config)
    if "text_projection.weight" not in sd:  # a CLIPTextModel: its config names one anyway
        cfg = dataclasses.replace(cfg, projection_dim=None)
    return _load(CLIPTextModel(cfg, device=device, dtype=dtype), sd)


def convert_image_encoder(torch_enc, device, dtype) -> CLIPVisionModel:
    sd = torch_enc.state_dict()
    cfg = clip_vision_config_from_hf(getattr(torch_enc.config, "vision_config", torch_enc.config))
    if "visual_projection.weight" not in sd:
        cfg = dataclasses.replace(cfg, projection_dim=None)
    return _load(CLIPVisionModel(cfg, device=device, dtype=dtype), sd)


def convert_controlnet(torch_cn, device, dtype) -> ControlNetModel:
    raw = dict(torch_cn.config)
    n = len(raw["block_out_channels"])
    ucfg = unet_config_from_diffusers({**raw, "up_block_types": ("UpBlock2D",) * n,
                                       "out_channels": raw.get("in_channels", 4)})
    cfg = ControlNetConfig(
        unet=ucfg,
        conditioning_channels=raw.get("conditioning_channels", 3),
        conditioning_embedding_out_channels=tuple(
            raw.get("conditioning_embedding_out_channels", (16, 32, 96, 256))),
    )
    return _load(ControlNetModel(cfg, device=device, dtype=dtype), torch_cn.state_dict())


def _convert_scheduler(torch_scheduler):
    """A diffusers scheduler → the port's, by class name and config; an
    unknown name falls back to DPM++ with a warning, as in JAX
    (``diffusers_adapter.py:245-283``)."""
    if torch_scheduler is None:
        return DPMSolverMultistepScheduler()
    name = type(torch_scheduler).__name__
    raw = dict(torch_scheduler.config)
    cfg = SchedulerConfig(
        num_train_timesteps=raw.get("num_train_timesteps", 1000),
        beta_start=raw.get("beta_start", 0.00085),
        beta_end=raw.get("beta_end", 0.012),
        beta_schedule=raw.get("beta_schedule", "scaled_linear"),
        prediction_type=raw.get("prediction_type", "epsilon"),
        timestep_spacing=raw.get("timestep_spacing", "leading"),
        steps_offset=raw.get("steps_offset", 1),
        use_karras_sigmas=raw.get("use_karras_sigmas", False) or False,
    )
    if "DPMSolver" in name:
        return DPMSolverMultistepScheduler(config=cfg)
    if "EulerAncestral" in name:
        return EulerAncestralDiscreteScheduler(config=cfg)
    if "Euler" in name:
        return EulerDiscreteScheduler(config=cfg)
    if "LCM" in name:
        return LCMScheduler(config=cfg)
    if "DDIM" in name:
        return DDIMScheduler(config=cfg)
    logger.warning("unknown scheduler %s; defaulting to DPMSolverMultistep", name)
    return DPMSolverMultistepScheduler(config=cfg)


def convert_pipeline(torch_pipe, config: Optional[CompilationConfig] = None, device=None):
    """The port's pipeline of ``torch_pipe``'s models: SVD when its UNet is
    spatio-temporal, SDXL when it has a ``text_encoder_2``, else SD (with
    its ``controlnet``, if any; penultimate conditioning for a 23-layer
    text encoder, SD2.x's).  Tokenizers pass through as they are."""
    from sfast_tpu_torch.pipelines import (
        StableDiffusionPipeline,
        StableDiffusionXLPipeline,
        StableVideoDiffusionPipeline,
    )

    config = config or CompilationConfig.Default()
    device = resolve_device(device)
    dtype = _torch_dtype(config.param_dtype)
    unet = torch_pipe.unet
    if "SpatioTemporal" in type(unet).__name__ or "Video" in type(torch_pipe).__name__:
        vae = convert_vae(torch_pipe.vae, device, dtype)
        return StableVideoDiffusionPipeline(
            convert_svd_unet(unet, device, dtype), vae,
            convert_image_encoder(torch_pipe.image_encoder, device, dtype),
            device=device, dtype=dtype)

    kwargs = dict(unet=convert_unet(unet, device, dtype),
                  vae=convert_vae(torch_pipe.vae, device, dtype),
                  text_encoder=convert_text_encoder(torch_pipe.text_encoder, device, dtype),
                  scheduler=_convert_scheduler(getattr(torch_pipe, "scheduler", None)),
                  tokenizer=getattr(torch_pipe, "tokenizer", None), device=device, dtype=dtype)
    kwargs["vae_encode"] = kwargs["vae"]
    if getattr(torch_pipe, "text_encoder_2", None) is not None:
        return StableDiffusionXLPipeline(
            text_encoder_2=convert_text_encoder(torch_pipe.text_encoder_2, device, dtype),
            tokenizer_2=getattr(torch_pipe, "tokenizer_2", None), **kwargs)
    if getattr(torch_pipe, "controlnet", None) is not None:
        kwargs["controlnet"] = convert_controlnet(torch_pipe.controlnet, device, dtype)
    pipe = StableDiffusionPipeline(**kwargs)
    if kwargs["text_encoder"].config.num_layers == 23:  # SD2.x
        pipe.clip_skip_mode = "penultimate"
    return pipe
