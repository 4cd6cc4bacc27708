"""The reference's image-to-video sampling, as diffusers'
``StableVideoDiffusionPipeline`` runs SVD-XT with its published
``EulerDiscreteScheduler`` (v-prediction, continuous timesteps, Karras
sigmas from σ_max 700 to σ_min 0.002, ρ 7, "leading" spacing): plain torch
and numpy, nothing of the program under test.

One clip of one conditioning image:

1. the CLIP image embedding of the image resized to the encoder's square
   and CLIP-normalized (the uncond row zeros);
2. the image plus ``noise_aug_strength`` × Gaussian noise, VAE-encoded to
   its posterior mean (not scaled by the scaling factor), repeated for
   every frame (the uncond rows zeros), concatenated to the scaled noisy
   latents on the channels;
3. the micro-conditioning ids (fps − 1, motion bucket, augmentation);
4. ``steps`` Euler steps of the v-prediction denoiser, c_skip = 1/(σ²+1),
   c_out = −σ/√(σ²+1), c_in = 1/√(σ²+1), c_noise = ¼·log σ, from noise
   scaled by √(σ_max² + 1), with classifier-free guidance at a per-frame
   scale, a linear ramp from the minimum to the maximum guidance;
5. the latents ÷ the scaling factor decoded ``decode_chunk_size`` frames at
   a time, each chunk a video of its own frames.

Departures from diffusers, on purpose:

- the random draws are made by the program's published convention, so that
  both sides draw the same numbers: a ``torch.Generator`` on the card
  seeded with the request's seed draws the augmentation noise (1, H, W, 3)
  and then the initial latents (1, F, h, w, 4), NHWC, in float32;
- the image reaches the CLIP encoder through the resize that
  ``sfast_tpu`` and its port use, ``jax.image.resize``'s antialiased
  bilinear (a triangle filter widened by the scale, half-pixel centres,
  weights normalized), written out here (:func:`resize_weights`), not
  diffusers' Gaussian blur and bicubic resize.
"""

import numpy as np
import torch

from families.svd_lib.reference import levels, time_ids

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class EDMEuler:
    """The Karras sigmas and the v-prediction Euler step."""

    def __init__(self, steps: int, sigma_min: float, sigma_max: float, rho: float):
        ramp = np.linspace(0, 1, steps)
        hi, lo = sigma_max ** (1 / rho), sigma_min ** (1 / rho)
        sig = ((hi + ramp * (lo - hi)) ** rho).astype(np.float32)
        self.sigmas = [float(s) for s in sig] + [0.0]
        self.timesteps = [float(0.25 * np.log(np.float32(s))) for s in sig]
        self.init_sigma = float(np.sqrt(float(sig.max()) ** 2 + 1))
        self.steps = steps

    def scale(self, x, i):
        return x / (self.sigmas[i] ** 2 + 1) ** 0.5

    def step(self, out, i, x):
        s, s_next = self.sigmas[i], self.sigmas[i + 1]
        denoised = out * (-s / (s**2 + 1) ** 0.5) + x / (s**2 + 1)
        return x + (s_next - s) * (x - denoised) / s


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of an antialiased bilinear resize along one
    axis: output pixel o samples at (o + ½)·n_in/n_out − ½ with the triangle
    1 − |x|/k, k = max(n_in/n_out, 1), each row normalized to sum 1."""
    k = max(n_in / n_out, 1.0)
    at = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * n_in / n_out - 0.5
    w = (1.0 - (at[:, None] - torch.arange(n_in, dtype=torch.float64, device=device)).abs()
         / k).clamp_min(0.0)
    return (w / w.sum(dim=1, keepdim=True)).float()


def clip_pixels(image: torch.Tensor, side: int) -> torch.Tensor:
    """(1, 3, H, W) in [-1, 1] → the encoder's input (1, 3, side, side):
    [0, 1], resized, CLIP-normalized."""
    x = (image + 1.0) / 2.0
    _, _, hh, ww = x.shape
    if hh != side:
        x = torch.einsum("oh,bchw->bcow", resize_weights(hh, side, x.device), x)
    if ww != side:
        x = torch.einsum("ow,bchw->bcho", resize_weights(ww, side, x.device), x)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def draws(seed: int, height: int, width: int, frames: int, latent_channels: int, factor: int,
          device):
    """(augmentation noise (1, H, W, 3), initial latents (1, F, h, w, C)),
    float32, drawn in that order from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    aug = torch.randn((1, height, width, 3), generator=gen, device=device)
    lat = torch.randn((1, frames, height // factor, width // factor, latent_channels),
                      generator=gen, device=device)
    return aug, lat


@torch.no_grad()
def sample(cfg: dict, traffic: dict, models: dict, image: np.ndarray, seed: int,
           device) -> torch.Tensor:
    """The reference's clip of one request: unrounded uint8 levels (F, H, W,
    3) in float32.  ``image`` is the (H, W, 3) uint8 conditioning image."""
    tr, sch = traffic, cfg["scheduler"]
    frames, hh, ww = tr["frames"], tr["height"], tr["width"]
    unet, vae, enc = models["unet"], models["vae"], models["image_encoder"]
    factor = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    lc = cfg["vae"]["latent_channels"]
    if image.shape[:2] != (hh, ww):
        raise ValueError(f"a {image.shape[:2]} image for a {hh}x{ww} clip: the reference "
                         "does not resize the conditioning image")
    img = torch.as_tensor(image, device=device).float().permute(2, 0, 1)[None] / 127.5 - 1.0
    emb = enc(clip_pixels(img, enc.image_size))[:, None]
    ctx = torch.cat([torch.zeros_like(emb), emb])
    aug, noise = draws(seed, hh, ww, frames, lc, factor, device)
    mean = vae.encode(img + tr["noise_aug_strength"] * aug.permute(0, 3, 1, 2))
    cond = mean[:, None].repeat(1, frames, 1, 1, 1)
    cond = torch.cat([torch.zeros_like(cond), cond])
    ids = time_ids(tr["fps"], tr["motion_bucket_id"], tr["noise_aug_strength"], 2, device)
    sampler = EDMEuler(tr["steps"], sch["sigma_min"], sch["sigma_max"], sch["rho"])
    x = noise.permute(0, 1, 4, 2, 3) * sampler.init_sigma  # (1, F, C, h, w)
    ramp = torch.linspace(tr["min_guidance_scale"], tr["max_guidance_scale"], frames,
                          device=device).reshape(1, frames, 1, 1, 1)
    for i in range(sampler.steps):
        xin = torch.cat([sampler.scale(torch.cat([x, x]), i), cond], dim=2)
        t = torch.tensor(sampler.timesteps[i], device=device)
        out_u, out_c = unet(xin, t, ctx, ids).chunk(2)
        x = sampler.step(out_u + ramp * (out_c - out_u), i, x)
    z = x.flatten(0, 1) / cfg["vae"]["scaling_factor"]
    k = tr["decode_chunk_size"]
    out = torch.cat([vae.decode(z[s:s + k], num_frames=z[s:s + k].shape[0])
                     for s in range(0, z.shape[0], k)])
    return levels(out.permute(0, 2, 3, 1))
