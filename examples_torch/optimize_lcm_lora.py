#!/usr/bin/env python
"""LCM-LoRA: a regular SD1.5 made a few-step model by merging the
latent-consistency LoRA and switching to the LCM scheduler — the port's
version of ``examples/optimize_lcm_lora.py`` (same flags).

With ``--lora`` (a diffusers / PEFT or kohya file, safetensors or torch)
the real factors are merged; without one a seeded random LoRA shows the
flow: merged into the captured graphs' weights in place, nothing captured
again, and swapped back to the base.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import torch  # noqa: E402

import sfast_tpu_torch  # noqa: E402
from examples_torch import _common  # noqa: E402
from sfast_tpu_torch import CompilationConfig  # noqa: E402
from sfast_tpu_torch.lora import (  # noqa: E402
    convert_diffusers_lora,
    init_lora_params,
    switch_lora,
)
from sfast_tpu_torch.models import SD15_TEXT_ENCODER, SD15_UNET, SD_VAE  # noqa: E402
from sfast_tpu_torch.schedulers import LCMScheduler  # noqa: E402

UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG = SD15_UNET, SD_VAE, SD15_TEXT_ENCODER


def load_lora_state_dict(path):
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None, help="diffusers SD checkpoint dir")
    p.add_argument("--lora", default=None, help="LCM-LoRA weights file")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--warmups", type=int, default=1)
    _common.device_arg(p)
    args = p.parse_args(argv)

    config = CompilationConfig(fuse_denoising_loop=True)
    if args.model:
        pipe = _common.from_diffusers(args.model, config, args.device)
    else:
        pipe = sfast_tpu_torch.compile(_common.sd_pipeline(
            args.device, LCMScheduler(), UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG), config)
    pipe.scheduler = LCMScheduler()

    base = {k: v.clone() for k, v in pipe.unet.module.state_dict().items()}
    if args.lora:
        lora, _ = convert_diffusers_lora(load_lora_state_dict(args.lora))
    else:
        lora = init_lora_params(_common.generator(args.device, 7), base, rank=4,
                                targets=("to_q", "to_v"))
        print("note: no --lora given; merging a random demo LoRA")

    kw = dict(prompt_ids=_common.prompt_ids(pipe.text_encoder), height=args.size,
              width=args.size, num_inference_steps=args.steps, guidance_scale=1.0)
    for i in range(args.warmups):
        pipe(seed=i, **kw)
    # fuse_lora's counterpart: merged into the weights the graphs read
    before = _common.graph_count(pipe)
    switch_lora(pipe.unet, base, lora, scale=args.lora_scale)
    out, dt = _common.timed(args.device, lambda: pipe(seed=99, **kw))
    print(f"LCM-LoRA {args.steps}-step e2e: {dt * 1e3:.1f} ms ({tuple(out.images.shape)})")
    pipe.unet.update_params(base)  # back to the base weights
    pipe(seed=99, **kw)
    captured = _common.graph_count(pipe) - before
    if captured:
        raise RuntimeError(f"the LoRA swaps captured {captured} graphs")
    return {"ms": dt * 1e3, "images": out.images, "graphs": before}


if __name__ == "__main__":
    main()
