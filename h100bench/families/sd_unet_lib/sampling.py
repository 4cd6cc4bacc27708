"""The reference's samplers and text conditioning: DPM-Solver++ (2M),
Euler and LCM as diffusers defines them for these models (scaled-linear
betas 0.00085 to 0.012 over 1000 steps, "leading" spacing, offset 1),
tables in float64, steps in float32.  Plain torch and numpy; nothing of
the program under test.

The initial latents and the LCM step noise are drawn again here, by the
program's published convention: a ``torch.Generator`` on the card seeded
with the request's seed, ``randn`` of the NHWC latent shape in float32
(scaled by the scheduler's initial sigma), and for a scheduler that takes
noise, ``randn`` of (steps, B, h, w, 4) from a generator seeded with
``seed · 0x9E3779B97F4A7C15 + 1 mod 2⁶³``.
"""

from typing import Optional

import numpy as np
import torch

from families.sd_unet_lib.prompts import empty_prompt_ids, ids_for_encoder_2
from families.sd_unet_lib.reference import levels

N_TRAIN = 1000
STEP_NOISE_MIX = 0x9E3779B97F4A7C15


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085**0.5, 0.012**0.5, N_TRAIN, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def leading_timesteps(n: int) -> np.ndarray:
    return (np.arange(n) * (N_TRAIN // n))[::-1].astype(np.int64) + 1


def initial_latents(seed: int, shape, device, sigma: float = 1.0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * sigma


def step_noise(seed: int, steps: int, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed((seed * STEP_NOISE_MIX + 1) % 2**63)
    return torch.randn((steps, *shape), generator=gen, device=device, dtype=torch.float32)


class DPMSolverPP2M:
    """Second-order multistep DPM-Solver++ on ε; the first step and the last
    are first order, the last one lands on σ ≈ 0."""

    needs_noise = False

    def __init__(self, steps: int):
        ac = alphas_cumprod()
        self.timesteps = leading_timesteps(steps)
        kd = np.sqrt((1 - ac) / ac)[self.timesteps]
        kd = np.concatenate([kd, [1e-10]])
        self.alpha = 1.0 / np.sqrt(1.0 + kd**2)
        self.sigma = kd * self.alpha
        self.lam = np.log(self.alpha / self.sigma)
        self.steps = steps
        self.init_sigma = 1.0

    def scale(self, x, i):
        return x

    def step(self, eps, i, x, x0_prev, noise=None):
        a, s = self.alpha, self.sigma
        x0 = (x - s[i] * eps) / a[i]
        h = self.lam[i + 1] - self.lam[i]
        d = x0
        if 0 < i < self.steps - 1:
            r = (self.lam[i] - self.lam[i - 1]) / h
            d = x0 + 0.5 * (x0 - x0_prev) / r
        return (s[i + 1] / s[i]) * x - a[i + 1] * np.expm1(-h) * d, x0


class EulerDiscrete:
    """Euler on the k-diffusion σ: x ← x + (σ_{i+1} − σ_i)·ε."""

    needs_noise = False

    def __init__(self, steps: int):
        ac = alphas_cumprod()
        self.timesteps = leading_timesteps(steps)
        self.kd = np.concatenate([np.sqrt((1 - ac) / ac)[self.timesteps], [0.0]])
        self.init_sigma = float(np.sqrt(self.kd[0] ** 2 + 1))
        self.steps = steps

    def scale(self, x, i):
        return x / float(np.sqrt(self.kd[i] ** 2 + 1))

    def step(self, eps, i, x, x0_prev, noise=None):
        return x + (self.kd[i + 1] - self.kd[i]) * eps, None


class LCM:
    """The latent consistency model's sampler: the distilled 50-step grid,
    the boundary condition (σ_data 0.5, timestep scaling 10), re-noised to
    the next timestep after every step but the last."""

    needs_noise = True

    def __init__(self, steps: int, origin_steps: int = 50):
        ac = alphas_cumprod()
        k = N_TRAIN // origin_steps
        origin = np.arange(1, origin_steps + 1) * k - 1
        self.timesteps = origin[::-1][:: len(origin) // steps][:steps].astype(np.int64)
        self.a = np.sqrt(ac[self.timesteps])
        self.s = np.sqrt(1 - ac[self.timesteps])
        self.steps = steps
        self.init_sigma = 1.0

    def scale(self, x, i):
        return x

    def step(self, eps, i, x, x0_prev, noise=None):
        x0 = (x - self.s[i] * eps) / self.a[i]
        c = self.timesteps[i] * 10.0
        c_skip, c_out = 0.25 / (c * c + 0.25), c / np.sqrt(c * c + 0.25)
        den = c_out * x0 + c_skip * x
        if i == self.steps - 1:
            return den, None
        return self.a[i + 1] * den + self.s[i + 1] * noise, None


SAMPLERS = {
    "DPMSolverMultistepScheduler": DPMSolverPP2M,
    "EulerDiscreteScheduler": EulerDiscrete,
    "LCMScheduler": LCM,
}


@torch.no_grad()
def conditioning(cfg: dict, models: dict, ids: np.ndarray, use_cfg: bool, device):
    """(context, SDXL's added conditioning or None) of the prompt ``ids``
    for the UNet's batch: [uncond; cond] with CFG."""
    t = torch.as_tensor(ids, device=device)
    if "text_encoder_2" not in cfg:
        def enc(x):
            return models["text_encoder"](x)[0][-1]
        ctx = enc(t)
        if use_cfg:
            ctx = torch.cat([enc(torch.as_tensor(empty_prompt_ids(), device=device)), ctx])
        return ctx, None
    h1, _ = models["text_encoder"](t)
    h2, pooled = models["text_encoder_2"](torch.as_tensor(ids_for_encoder_2(ids), device=device))
    ctx = torch.cat([h1[-2], h2[-2]], dim=-1)
    if use_cfg:  # no negative prompt: zero uncond embeddings
        ctx, pooled = torch.cat([torch.zeros_like(ctx), ctx]), torch.cat(
            [torch.zeros_like(pooled), pooled])
    return ctx, pooled


@torch.no_grad()
def sample(cfg: dict, traffic: dict, models: dict, ids: np.ndarray, seed: int,
           device) -> torch.Tensor:
    """The reference's image of one request, as unrounded uint8 levels
    (1, H, W, 3) in float32."""
    steps, gs = traffic["steps"], traffic["guidance_scale"]
    use_cfg = gs > 1.0
    sampler = SAMPLERS[traffic["scheduler"]](steps)
    ctx, pooled = conditioning(cfg, models, ids, use_cfg, device)
    unet, vae = models["unet"], models["vae"]
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    shape = (1, traffic["height"] // f, traffic["width"] // f, cfg["vae"]["latent_channels"])
    x = initial_latents(seed, shape, device, sampler.init_sigma).permute(0, 3, 1, 2)
    noise = (step_noise(seed, steps, shape, device).permute(0, 1, 4, 2, 3)
             if sampler.needs_noise else None)
    added = None
    if pooled is not None:
        tid = torch.tensor([traffic["height"], traffic["width"], 0, 0, traffic["height"],
                            traffic["width"]], dtype=torch.float32, device=device)
        added = {"text_embeds": pooled, "time_ids": tid.repeat(pooled.shape[0], 1)}
    x0_prev: Optional[torch.Tensor] = None
    for i in range(steps):
        xin = sampler.scale(torch.cat([x, x]) if use_cfg else x, i)
        t = torch.tensor(float(sampler.timesteps[i]), device=device)
        eps = unet(xin, t, ctx, added)
        if use_cfg:
            eu, ec = eps.chunk(2)
            eps = eu + gs * (ec - eu)
        x, x0_prev = sampler.step(eps, i, x, x0_prev, None if noise is None else noise[i])
    image = vae.decode(x / cfg["vae"]["scaling_factor"])
    return levels(image.permute(0, 2, 3, 1))
