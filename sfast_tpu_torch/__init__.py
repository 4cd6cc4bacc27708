"""sfast_tpu_torch — the PyTorch / CUDA port of sfast_tpu.

The JAX package ``sfast_tpu`` stays the reference.  This package runs
SD1.5 and SDXL text2img, img2img and inpainting (prompt strings through
``text/clip_tokenizer.py``, LoRA hot-swap through ``lora.py``; DPM++,
Euler, Euler ancestral, DDIM, EDM Euler and LCM, an LCM-distilled UNet
included), and SD1.5 with a ControlNet (``models/controlnet.py``) and an
IP-Adapter (``ip_adapter.py``, its CLIP vision encoder in
``models/clip_vision.py``), and Stable Video Diffusion image-to-video
(``pipelines/stable_video_diffusion.py``: the spatio-temporal UNet and the
temporal VAE decoder), on an NVIDIA H100 with PyTorch, through CUDA kernels written by
hand for Hopper, eight sources in ``csrc/``: flash attention
(K1), the fused GroupNorm+SiLU→3×3 conv (K2), GroupNorm statistics (K3),
GroupNorm apply (K5), the fused GroupNorm (K3′ and K5 in one launch),
linear + GEGLU (K4), and int8 flash attention (K6) with its quantization
of q, k and v.  Each has a plain PyTorch version beside it, which is what
runs for CPU tensors.  The kernels are built with nvcc at first use;
importing the package builds and loads nothing.

``compile`` wraps the pipeline's models so that each replays a CUDA graph
per input signature (``runtime/tracing.py``), first converting a
diffusers pipeline into the port's pipeline of the port's models
(``interop/diffusers_adapter.py``); ``compile_model``, ``compile_unet``
and ``compile_vae`` wrap one model alone (an IP-Adapter's image encoder),
``lazy_jit`` any function.  A pipeline serves many requests with ``map``
and captures new shapes in the background with ``warmup(background=True)``.  ``quant`` quantizes a
pipeline's UNet and ControlNet to int8 (W8A16, dynamic W8A8, or static
W8A8 from a calibration); ``models.AutoencoderTiny`` (TAESD) can take the
VAE's slots.  ``training`` fine-tunes a LoRA of the UNet with
``CompilationConfig(enable_kernels=False)``: no kernel has a backward, and
each refuses one loudly (``runtime/cuda_build.no_backward``).  ``profile``,
``utils.checkpoint``, ``utils.debug``, ``utils.term_image`` and
``text.fetch_vocab`` are the JAX package's tools.  ``parallel`` runs the
models over a ``torch.distributed`` mesh (``CompilationConfig(mesh=...)``:
Megatron tensor parallelism, ring attention over ``sp``), one process per
device.
"""

from sfast_tpu_torch.utils.env import setup_environment

setup_environment()

from sfast_tpu_torch import quant  # noqa: E402
from sfast_tpu_torch.compilers import (  # noqa: E402
    compile,
    compile_model,
    compile_unet,
    compile_vae,
)
from sfast_tpu_torch.config import CompilationConfig  # noqa: E402
from sfast_tpu_torch.runtime.tracing import lazy_jit  # noqa: E402
from sfast_tpu_torch.version import __version__  # noqa: E402

__all__ = ["CompilationConfig", "__version__", "compile", "compile_model", "compile_unet",
           "compile_vae", "lazy_jit", "quant"]
