"""The models of the port: CLIP text encoders, UNet, VAE (SD1.5, SD2.x,
SDXL), the Tiny VAE (TAESD), ControlNet, the CLIP vision encoder (IP-Adapter, SVD), and Stable
Video Diffusion's spatio-temporal UNet and temporal VAE."""

from sfast_tpu_torch.models.autoencoder_kl import (
    SD_VAE,
    SDXL_VAE,
    TINY_TEST_VAE,
    AutoencoderKL,
    VAEConfig,
)
from sfast_tpu_torch.models.autoencoder_tiny import (
    TAESD,
    TINY_TEST_TAESD,
    AutoencoderTiny,
    TinyVAEConfig,
    init_tiny_vae_weights_,
)
from sfast_tpu_torch.models.autoencoder_kl_temporal import (
    SVD_VAE,
    TINY_TEMPORAL_VAE,
    AutoencoderKLTemporalDecoder,
    TemporalVAEConfig,
    init_temporal_vae_weights_,
)
from sfast_tpu_torch.models.clip_text import (
    SD15_TEXT_ENCODER,
    SD21_TEXT_ENCODER,
    SDXL_TEXT_ENCODER_2,
    TINY_TEXT_ENCODER,
    CLIPTextConfig,
    CLIPTextModel,
)
from sfast_tpu_torch.models.clip_vision import (
    TINY_IMAGE_ENCODER,
    VIT_H_IMAGE_ENCODER,
    VIT_L_IMAGE_ENCODER,
    CLIPVisionConfig,
    CLIPVisionModel,
)
from sfast_tpu_torch.models.controlnet import (
    SD15_CONTROLNET,
    TINY_CONTROLNET,
    ControlNetConfig,
    ControlNetModel,
    init_controlnet_weights_,
)
from sfast_tpu_torch.models.layers import init_weights_
from sfast_tpu_torch.models.unet_spatio_temporal import (
    SVD_UNET,
    TINY_SVD_UNET,
    SVDUNetConfig,
    UNetSpatioTemporalConditionModel,
    init_svd_unet_weights_,
)
from sfast_tpu_torch.models.unet_2d_condition import (
    SD15_UNET,
    SD21_UNET,
    SDXL_UNET,
    TINY_UNET,
    UNet2DConditionModel,
    UNetConfig,
)

__all__ = [
    "AutoencoderKL", "AutoencoderKLTemporalDecoder", "AutoencoderTiny", "TAESD",
    "TINY_TEST_TAESD", "TinyVAEConfig", "init_tiny_vae_weights_", "CLIPTextConfig", "CLIPTextModel",
    "CLIPVisionConfig", "CLIPVisionModel", "ControlNetConfig", "ControlNetModel",
    "SD15_CONTROLNET", "SD15_TEXT_ENCODER", "SD15_UNET", "SD21_TEXT_ENCODER", "SD21_UNET",
    "SDXL_TEXT_ENCODER_2", "SDXL_UNET", "SDXL_VAE", "SD_VAE", "SVDUNetConfig", "SVD_UNET",
    "SVD_VAE", "TINY_CONTROLNET", "TINY_IMAGE_ENCODER", "TINY_SVD_UNET", "TINY_TEMPORAL_VAE",
    "TINY_TEST_VAE", "TINY_TEXT_ENCODER", "TINY_UNET", "TemporalVAEConfig",
    "UNet2DConditionModel", "UNetConfig", "UNetSpatioTemporalConditionModel", "VAEConfig",
    "VIT_H_IMAGE_ENCODER", "VIT_L_IMAGE_ENCODER", "init_controlnet_weights_",
    "init_svd_unet_weights_", "init_temporal_vae_weights_", "init_weights_",
]
