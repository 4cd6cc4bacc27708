"""Pipelines of the port: SD1.5 and SDXL text2img, img2img and inpainting."""

from sfast_tpu_torch.pipelines.stable_diffusion import PipelineOutput, StableDiffusionPipeline
from sfast_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline

__all__ = ["PipelineOutput", "StableDiffusionPipeline", "StableDiffusionXLPipeline"]
