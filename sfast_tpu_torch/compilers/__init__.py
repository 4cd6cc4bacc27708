"""Compiling a pipeline: CUDA graphs per input signature for its models."""

from sfast_tpu_torch.compilers.diffusion_pipeline_compiler import (
    CompiledModel,
    compile,
    compile_model,
    compile_unet,
    compile_vae,
)

__all__ = ["CompiledModel", "compile", "compile_model", "compile_unet", "compile_vae"]
