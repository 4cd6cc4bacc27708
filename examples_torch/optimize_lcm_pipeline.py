#!/usr/bin/env python
"""LCM few-step inference — the port's version of
``examples/optimize_lcm_pipeline.py`` (same flags).  Few steps stress the
fixed cost of a call, which the graphs and the fused loop take away."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import sfast_tpu_torch  # noqa: E402
from examples_torch import _common  # noqa: E402
from sfast_tpu_torch import CompilationConfig  # noqa: E402
from sfast_tpu_torch.models import SD15_TEXT_ENCODER, SD15_UNET, SD_VAE  # noqa: E402
from sfast_tpu_torch.schedulers import LCMScheduler  # noqa: E402

UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG = SD15_UNET, SD_VAE, SD15_TEXT_ENCODER


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--size", type=int, default=512)
    _common.device_arg(p)
    args = p.parse_args(argv)

    config = CompilationConfig(fuse_denoising_loop=True)
    if args.model:
        pipe = _common.from_diffusers(args.model, config, args.device)
    else:
        pipe = sfast_tpu_torch.compile(_common.sd_pipeline(
            args.device, LCMScheduler(), UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG), config)
    pipe.scheduler = LCMScheduler()  # what makes few steps work
    kw = dict(prompt_ids=_common.prompt_ids(pipe.text_encoder), height=args.size,
              width=args.size, num_inference_steps=args.steps, guidance_scale=1.0)
    pipe(seed=0, **kw)  # warm-up: captures the graphs
    out, dt = _common.timed(args.device, lambda: pipe(seed=1, **kw))
    print(f"LCM {args.steps}-step e2e: {dt * 1e3:.1f} ms")
    return {"ms": dt * 1e3, "images": out.images}


if __name__ == "__main__":
    main()
