#!/usr/bin/env python
"""SVD image-to-video — the port's version of
``examples/optimize_stable_video_diffusion_pipeline.py`` (same flags): a
clip of 25 frames at 576×1024 with its decode in chunks
(``decode_chunk_size``).  Without ``--model`` the SVD-XT UNet, the temporal
VAE and the ViT-H image encoder are seeded random weights."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sfast_tpu_torch  # noqa: E402
from examples_torch import _common  # noqa: E402
from sfast_tpu_torch import CompilationConfig  # noqa: E402
from sfast_tpu_torch.models import (  # noqa: E402
    SVD_UNET,
    SVD_VAE,
    VIT_H_IMAGE_ENCODER,
    AutoencoderKLTemporalDecoder,
    CLIPVisionModel,
    UNetSpatioTemporalConditionModel,
    init_svd_unet_weights_,
    init_temporal_vae_weights_,
    init_weights_,
)
from sfast_tpu_torch.pipelines import StableVideoDiffusionPipeline  # noqa: E402

UNET_CONFIG, VAE_CONFIG, IMAGE_ENCODER_CONFIG = SVD_UNET, SVD_VAE, VIT_H_IMAGE_ENCODER


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None, help="diffusers SVD checkpoint")
    p.add_argument("--image", default=None, help="conditioning image (png)")
    p.add_argument("--frames", type=int, default=25)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--decode-chunk-size", type=int, default=5)
    _common.device_arg(p)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    if args.model:
        pipe = _common.from_diffusers(args.model, CompilationConfig(), dev,
                                      "StableVideoDiffusionPipeline")
    else:
        g = _common.generator(dev, 42)
        mk = dict(device=dev, dtype=_common.DTYPE)
        unet = init_svd_unet_weights_(UNetSpatioTemporalConditionModel(UNET_CONFIG, **mk), g)
        vae = init_temporal_vae_weights_(AutoencoderKLTemporalDecoder(VAE_CONFIG, **mk), g)
        enc = init_weights_(CLIPVisionModel(IMAGE_ENCODER_CONFIG, **mk), g)
        pipe = sfast_tpu_torch.compile(
            StableVideoDiffusionPipeline(unet, vae, enc, device=dev, dtype=_common.DTYPE),
            CompilationConfig())

    if args.image:
        from PIL import Image

        img = np.asarray(Image.open(args.image).convert("RGB"))[None]
    else:
        img = np.random.RandomState(0).randint(0, 255, (1, args.height, args.width, 3), np.uint8)
    kw = dict(num_frames=args.frames, height=args.height, width=args.width,
              num_inference_steps=args.steps, decode_chunk_size=args.decode_chunk_size)
    _, dt = _common.timed(dev, lambda: pipe(img, seed=0, **kw))
    print(f"warmup (incl. capture): {dt:.1f} s")
    out, dt = _common.timed(dev, lambda: pipe(img, seed=1, **kw))
    print(f"SVD e2e: {dt:.1f} s/clip, frames: {tuple(out.images.shape)}")
    return {"s": dt, "frames": out.images}


if __name__ == "__main__":
    main()
