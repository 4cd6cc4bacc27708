"""Pipelines of the port: SD1.5 and SDXL text2img, img2img and inpainting,
and Stable Video Diffusion image-to-video."""

from sfast_tpu_torch.pipelines.stable_diffusion import PipelineOutput, StableDiffusionPipeline
from sfast_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
from sfast_tpu_torch.pipelines.stable_video_diffusion import StableVideoDiffusionPipeline

__all__ = ["PipelineOutput", "StableDiffusionPipeline", "StableDiffusionXLPipeline",
           "StableVideoDiffusionPipeline"]
