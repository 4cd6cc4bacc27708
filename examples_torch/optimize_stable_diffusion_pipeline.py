#!/usr/bin/env python
"""SD1.5 text-to-image with sfast_tpu_torch — the port's version of
``examples/optimize_stable_diffusion_pipeline.py`` (same flags).

With ``--model`` a local diffusers checkpoint is converted by the port's
adapter and compiled; without it the SD1.5 architecture is built with
seeded random weights at the init scales, which exercises every graph and
kernel at full width (weight values do not change latency).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import sfast_tpu_torch  # noqa: E402
from examples_torch import _common  # noqa: E402
from sfast_tpu_torch import CompilationConfig  # noqa: E402
from sfast_tpu_torch.models import SD15_TEXT_ENCODER, SD15_UNET, SD_VAE  # noqa: E402
from sfast_tpu_torch.profile import IterationProfiler  # noqa: E402
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler  # noqa: E402
from sfast_tpu_torch.utils.term_image import print_image  # noqa: E402

UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG = SD15_UNET, SD_VAE, SD15_TEXT_ENCODER


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None, help="diffusers checkpoint dir")
    p.add_argument("--prompt", default="a photo of an astronaut riding a horse")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmups", type=int, default=1)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--fuse-loop", action="store_true", default=True)
    p.add_argument("--no-fuse-loop", dest="fuse_loop", action="store_false")
    p.add_argument("--quantize", action="store_true", help="int8 linears (W8A16)")
    p.add_argument("--show", action="store_true", help="render to terminal")
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="after the timed runs, serve N images via pipe.map(window=2) and "
                        "report sustained ms/image")
    _common.device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = CompilationConfig(fuse_denoising_loop=args.fuse_loop)
    if args.model:
        pipe = _common.from_diffusers(args.model, config, args.device)
    else:
        pipe = sfast_tpu_torch.compile(_common.sd_pipeline(
            args.device, DPMSolverMultistepScheduler(), UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG,
            seed=args.seed), config)
    if args.quantize:
        from sfast_tpu_torch.quant import quantize_pipeline

        quantize_pipeline(pipe)

    if getattr(pipe, "tokenizer", None) is not None:
        kw = dict(prompt=args.prompt)
    else:
        kw = dict(prompt_ids=_common.prompt_ids(pipe.text_encoder))
    kw.update(height=args.height, width=args.width, num_inference_steps=args.steps,
              guidance_scale=args.guidance)

    for _ in range(args.warmups):
        _, dt = _common.timed(args.device, lambda: pipe(seed=args.seed, **kw))
        print(f"warmup (incl. capture): {dt:.1f} s")
    times = []
    out = None
    for i in range(args.repeats):
        prof = None if args.fuse_loop else IterationProfiler()
        out, dt = _common.timed(args.device, lambda: pipe(
            seed=args.seed + i, callback_on_step_end=prof, **kw))
        times.append(dt)
        extra = f", {prof.summary()}" if prof else ""
        print(f"run {i}: {dt * 1e3:.1f} ms{extra}")
    if times:
        best = min(times)
        print(f"best e2e: {best * 1e3:.1f} ms ({args.steps / best:.2f} it/s equivalent)")

    if args.serve:
        item = kw.pop("prompt", None)
        if item is None:
            item = kw.pop("prompt_ids")

        def serve():
            return [r.images for r in pipe.map([item] * args.serve, window=2, seed=args.seed,
                                               **kw)]

        served, dt = _common.timed(args.device, serve)
        if len(served) != args.serve:
            raise RuntimeError(f"served {len(served)} of {args.serve} images")
        per = dt / args.serve
        print(f"sustained serving ({args.serve} images, window=2): {per * 1e3:.1f} ms/image "
              f"({60 / per:.1f} images/min)")

    if args.show and out is not None:
        print_image(out.images[0])
    return {"times": times, "images": None if out is None else out.images}


if __name__ == "__main__":
    main()
