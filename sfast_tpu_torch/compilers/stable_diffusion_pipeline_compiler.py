"""Deprecated alias of :mod:`diffusion_pipeline_compiler`, as JAX keeps one
(``sfast_tpu/compilers/stable_diffusion_pipeline_compiler.py``) after the
reference's back-compat module."""

import warnings

from sfast_tpu_torch.compilers.diffusion_pipeline_compiler import (  # noqa: F401
    CompiledModel,
    compile,
    compile_model,
    compile_unet,
    compile_vae,
)
from sfast_tpu_torch.config import CompilationConfig  # noqa: F401

warnings.warn(
    "sfast_tpu_torch.compilers.stable_diffusion_pipeline_compiler is deprecated; "
    "use sfast_tpu_torch.compilers.diffusion_pipeline_compiler",
    DeprecationWarning,
    stacklevel=2,
)
