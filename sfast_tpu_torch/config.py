"""Compilation configuration of the PyTorch port.

The fields the SD1.5 text2img slice reads, with the same defaults as
``sfast_tpu.config.CompilationConfig``:

- ``enable_flash_attention``: long self-attention goes to the hand-written
  flash kernel (K1) when its tensors lie on a CUDA device;
- ``enable_int8_attention``: that attention takes the int8 flash kernel
  (K6) instead of K1.  Off by default, as in JAX;
- ``enable_fused_group_norm``: every UNet GroupNorm runs as the statistics
  kernel (K3) then the normalize kernel (K5).  Off by default, as in JAX;
- ``enable_fused_linear_geglu``: the feed-forward's linear + GEGLU may take
  the dual-GEMM kernel (K4) where its widths allow.  Off by default, as in
  JAX; the kernel computes the tanh GELU of the Pallas kernel, the plain
  route diffusers' erf GELU;
- ``enable_fused_conv``: the UNet's 3×3 convs may take the fused
  GroupNorm+SiLU→conv kernel (K2).  Off by default, as in JAX; the VAE
  decoder takes K2 regardless, as it does in JAX;
- ``enable_kernels`` (≙ ``enable_pallas``): one switch for every
  hand-written kernel.  False sends every op to its plain PyTorch version.
"""

import dataclasses


@dataclasses.dataclass
class CompilationConfig:
    enable_flash_attention: bool = True
    enable_int8_attention: bool = False
    enable_fused_group_norm: bool = False
    enable_fused_linear_geglu: bool = False
    enable_fused_conv: bool = False
    enable_kernels: bool = True

    @staticmethod
    def Default() -> "CompilationConfig":
        return CompilationConfig()
