#!/usr/bin/env python
"""InstantID-style identity-preserving generation — the port's version of
``examples/optimize_instant_id_pipeline.py`` (same flags).

InstantID composes two conditioning paths driven by one face:

- an **IP-Adapter**: the identity embedding becomes extra cross-attention
  tokens in every attn2 (decoupled K/V, scaled by ``ip_adapter_scale``);
- a **ControlNet**: the face-keypoint image conditions the structure
  (scaled by ``controlnet_conditioning_scale``).

Face analysis (insightface) is outside the compiler in both packages: pass
a precomputed embedding (``--face-embed`` .npy) and keypoint image, what
the reference's FaceAnalysis produces before the pipeline runs.  Without
checkpoints the models and the adapter are seeded random weights.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sfast_tpu_torch  # noqa: E402
from examples_torch import _common  # noqa: E402
from sfast_tpu_torch import CompilationConfig  # noqa: E402
from sfast_tpu_torch.ip_adapter import (  # noqa: E402
    init_ip_adapter_params,
    ip_image_embed,
    load_ip_adapter,
)
from sfast_tpu_torch.models import (  # noqa: E402
    SD15_CONTROLNET,
    SD15_TEXT_ENCODER,
    SD15_UNET,
    SD_VAE,
)
from sfast_tpu_torch.schedulers import EulerAncestralDiscreteScheduler  # noqa: E402

UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG = SD15_UNET, SD_VAE, SD15_TEXT_ENCODER
CONTROLNET_CONFIG = SD15_CONTROLNET
FACE_EMBED_DIM = 1024  # insightface's antelopev2 embedding, as InstantID's image_proj takes


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None, help="diffusers SD checkpoint dir")
    p.add_argument("--controlnet", default=None, help="InstantID ControlNet dir")
    p.add_argument("--ip-adapter", default=None, help="ip-adapter.bin path")
    p.add_argument("--face-embed", default=None, help=".npy identity embedding")
    p.add_argument("--kps-image", default=None, help="keypoint image (npy/png)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--controlnet-scale", type=float, default=0.8)
    p.add_argument("--ip-adapter-scale", type=float, default=0.8)
    p.add_argument("--warmups", type=int, default=1)
    _common.device_arg(p)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    config = CompilationConfig()
    if args.model:
        import diffusers

        cn = diffusers.ControlNetModel.from_pretrained(args.controlnet)
        pipe = _common.from_diffusers(args.model, config, dev,
                                      "StableDiffusionControlNetPipeline", controlnet=cn)
        pipe.scheduler = EulerAncestralDiscreteScheduler()
    else:
        pipe = sfast_tpu_torch.compile(_common.sd_pipeline(
            dev, EulerAncestralDiscreteScheduler(), UNET_CONFIG, VAE_CONFIG, TEXT_CONFIG,
            controlnet_cfg=CONTROLNET_CONFIG), config)

    # IP-Adapter: decoupled K/V projections added to every attn2 in place
    if args.ip_adapter:
        ip_sd = torch.load(args.ip_adapter, map_location="cpu")
    else:
        ip_sd = init_ip_adapter_params(_common.generator(dev, 3), pipe.unet,
                                       clip_embed_dim=FACE_EMBED_DIM)
        print("note: no --ip-adapter given; random adapter weights")
    image_proj = load_ip_adapter(pipe.unet, ip_sd)

    if args.face_embed:
        face = torch.from_numpy(np.load(args.face_embed).astype(np.float32))[None].to(dev)
    else:
        face = torch.randn((1, FACE_EMBED_DIM), generator=_common.generator(dev, 5), device=dev)
    with torch.inference_mode():
        tokens = ip_image_embed(image_proj, face)
    tokens = torch.cat([torch.zeros_like(tokens), tokens])  # [uncond; cond] for CFG

    if args.kps_image and args.kps_image.endswith(".npy"):
        kps = np.load(args.kps_image)
    elif args.kps_image:
        from PIL import Image

        kps = np.asarray(Image.open(args.kps_image).convert("RGB"))[None]
    else:
        kps = np.zeros((1, args.size, args.size, 3), np.uint8)

    kw = dict(prompt_ids=_common.prompt_ids(pipe.text_encoder), height=args.size,
              width=args.size, num_inference_steps=args.steps,
              control_image=torch.from_numpy(kps).to(dev),
              controlnet_conditioning_scale=args.controlnet_scale,
              ip_adapter_embeds=tokens, ip_adapter_scale=args.ip_adapter_scale)
    for i in range(args.warmups):
        pipe(seed=i, **kw)
    out, dt = _common.timed(dev, lambda: pipe(seed=42, **kw))
    print(f"InstantID-style {args.steps}-step e2e: {dt * 1e3:.1f} ms "
          f"({dt * 1e3 / args.steps:.1f} ms/step, {tuple(out.images.shape)})")
    return {"ms": dt * 1e3, "images": out.images}


if __name__ == "__main__":
    main()
