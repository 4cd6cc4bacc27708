"""Pipelines of the port: SD1.5 text2img, img2img and inpainting."""

from sfast_tpu_torch.pipelines.stable_diffusion import PipelineOutput, StableDiffusionPipeline

__all__ = ["PipelineOutput", "StableDiffusionPipeline"]
