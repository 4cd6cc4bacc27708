"""What the example scripts share: seeded random models at the init scales
(``models.init_weights_``), a diffusers checkpoint through the port's
adapter, prompt ids, timing on the card."""

import argparse
import time

import torch

import sfast_tpu_torch
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    ControlNetModel,
    UNet2DConditionModel,
    init_controlnet_weights_,
    init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline

DTYPE = torch.bfloat16


def device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="where the models run (cuda, or cpu)")


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def sd_pipeline(device, scheduler, unet_cfg, vae_cfg, text_cfg, *, controlnet_cfg=None,
                seed: int = 0) -> StableDiffusionPipeline:
    """An SD pipeline of seeded random models of these configs."""
    g = generator(device, seed)
    mk = dict(device=device, dtype=DTYPE)
    unet = init_weights_(UNet2DConditionModel(unet_cfg, **mk), g)
    vae = init_weights_(AutoencoderKL(vae_cfg, **mk), g)
    te = init_weights_(CLIPTextModel(text_cfg, **mk), g)
    cn = None
    if controlnet_cfg is not None:
        cn = init_controlnet_weights_(ControlNetModel(controlnet_cfg, **mk), g)
    return StableDiffusionPipeline(unet, vae, te, scheduler, vae_encode=vae, controlnet=cn,
                                   device=device, dtype=DTYPE)


def from_diffusers(path: str, config: CompilationConfig, device, cls_name: str =
                   "StableDiffusionPipeline", **kw):
    """A local diffusers checkpoint, converted and compiled by the port
    (``interop/diffusers_adapter.py``); needs diffusers installed."""
    import diffusers

    pipe = getattr(diffusers, cls_name).from_pretrained(path, **kw)
    return sfast_tpu_torch.compile(pipe, config, device=device)


def prompt_ids(text_encoder, seed: int = 0) -> torch.Tensor:
    """Seeded random ids of the text encoder's vocabulary, (1, 77)."""
    vocab = text_encoder.config.vocab_size
    return torch.randint(0, vocab, (1, 77), generator=torch.Generator().manual_seed(seed))


def timed(device, fn):
    """(fn(), seconds), synchronized with the card around it."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def graph_count(pipe) -> int:
    """The CUDA graphs ``pipe`` holds: its compiled models', its scheduler
    step's and its fused loops' (0 on the CPU, where nothing is captured)."""
    holders = [getattr(getattr(pipe, a, None), "_call", None)
               for a in ("text_encoder", "image_encoder", "unet", "controlnet", "vae",
                         "vae_encode")]
    holders += [getattr(pipe.scheduler, "_step", None), getattr(pipe, "_decode_u8", None)]
    holders += list(getattr(pipe, "_fused_loops", {}).values())
    return sum(getattr(h, "cache_size", 0) for h in holders if h is not None)
