"""Stable Video Diffusion: one image to a clip of frames.

Counterpart of ``sfast_tpu/pipelines/stable_video_diffusion.py``
(diffusers' ``StableVideoDiffusionPipeline`` semantics):

1. the conditioning image, resized to the clip's size, gives the CLIP
   image embedding (one context token; a zero row for the uncond branch)
   and, noise-augmented and VAE-encoded, the posterior mean — not scaled
   by the VAE's scaling factor — repeated per frame (zero in the uncond
   half), which the UNet takes channel-concatenated with the noisy
   latents (``in_channels`` 8);
2. the micro-conditioning ids (fps − 1, motion bucket, noise augmentation)
   feed the UNet's addition embedding;
3. EDM-Euler steps (v-prediction by default, as SVD checkpoints are
   trained) with classifier-free guidance at a per-frame scale, a linear
   ramp from ``min_guidance_scale`` to ``max_guidance_scale``;
4. the latents decode in chunks of ``decode_chunk_size`` frames to uint8.

After ``sfast_tpu_torch.compile`` the image encoder, the VAE encode, the
UNet and the EDM step replay CUDA graphs; the context, the conditioning
latents, the micro-ids and the guidance ramp are device tensors and graph
inputs, so a new guidance range, fps or motion bucket captures nothing.
Under ``fuse_denoising_loop`` the N steps are one graph, keyed by (steps,
frames).  Each decoded chunk is one graph of the decode and the uint8
conversion, one per chunk size; a chunk is copied to pinned host memory
without blocking, and the call synchronizes once at the end.  Under a
profiler session a call is one ``sfast.request`` span and that sync, with
the frames' ``.numpy()``, one ``sfast.wait`` inside it.

A temporal decoder (``AutoencoderKLTemporalDecoder``, what SVD checkpoints
ship) decodes each chunk as a video of its frames; a standard
``AutoencoderKL`` in the ``vae`` slot decodes frame by frame, as JAX keeps
it.  The augmentation noise and the initial latents are drawn from one
generator seeded per call; torch's Philox is not JAX's threefry, so clips
from a seed differ between the packages: the tests hand the port JAX's
draws (``aug_noise``, ``latents``).
"""

from typing import Optional

import numpy as np
import torch

from sfast_tpu_torch.models.autoencoder_kl_temporal import AutoencoderKLTemporalDecoder
from sfast_tpu_torch.pipelines.stable_diffusion import PipelineBase, PipelineOutput
from sfast_tpu_torch.profile import spans
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction
from sfast_tpu_torch.schedulers.edm_euler import EDMEulerScheduler
from sfast_tpu_torch.utils.image import (
    clip_normalize,
    denormalize_to_uint8,
    preprocess_image,
    resize_bilinear,
)


def _module(m):
    """The module a compiled slot wraps (the fused graphs call it, not its
    graph), or ``m``."""
    return getattr(m, "module", m)


class StableVideoDiffusionPipeline(PipelineBase):
    def __init__(self, unet, vae, image_encoder, scheduler=None, *, vae_encode=None,
                 device=None, dtype: torch.dtype = torch.bfloat16):
        """``vae_encode`` encodes the conditioning image: the VAE module
        itself (its ``encode``) where None; ``sfast_tpu_torch.compile``
        wraps it as a model of its own beside the decode."""
        super().__init__(scheduler or EDMEulerScheduler(),
                         device if device is not None else unet.conv_in.weight.device, dtype)
        self.unet = unet
        self.vae = vae
        self.vae_encode = vae if vae_encode is None else vae_encode
        self.image_encoder = image_encoder
        self._decode_u8 = None

    def _submodels(self):
        return (self.unet, self.vae, self.vae_encode, self.image_encoder)

    def _drop_fused_loops(self) -> None:
        super()._drop_fused_loops()
        if isinstance(self._decode_u8, LazyCompiledFunction):
            self._decode_u8.clear_cache()
        self._decode_u8 = None

    def _encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] → the CLIP image embedding (B, 1, D):
        [0, 1], resized to the encoder's square (antialiased), normalized."""
        side = self.image_encoder.config.image_size
        px = clip_normalize(resize_bilinear((image.float() + 1.0) / 2.0, side, side))
        out = self.image_encoder(px.to(self.dtype))
        emb = out["image_embeds"] if "image_embeds" in out else out["pooler_output"]
        return emb[:, None, :]

    def prepare_conditioning(self, image, *, num_frames: int, height: int, width: int,
                             fps: int = 7, motion_bucket_id: int = 127,
                             noise_aug_strength: float = 0.02,
                             aug_noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
        """The UNet's loop-invariant conditioning, as JAX's
        ``prepare_conditioning``: (context (2B, 1, D) = [zeros; image
        embedding], conditioning latents (2B, F, h, w, 4) = [zeros; the
        posterior mean per frame], micro-ids (2B, 3) f32), each on the
        device.  ``aug_noise`` (B, H, W, 3) is the augmentation noise,
        drawn from ``generator`` where None."""
        img = preprocess_image(image, self.dtype, self.device)
        if tuple(img.shape[1:3]) != (height, width):
            img = resize_bilinear(img.float(), height, width).to(self.dtype)
        b = img.shape[0]
        emb = self._encode_image(img)
        context = torch.cat([torch.zeros_like(emb), emb])
        if aug_noise is None:
            aug_noise = torch.randn(img.shape, generator=generator, device=self.device)
        aug = torch.as_tensor(aug_noise, device=self.device).float()
        mean, _ = self.vae_encode.encode((img.float() + noise_aug_strength * aug).to(self.dtype))
        cond = mean[:, None].expand(b, num_frames, *mean.shape[1:])
        cond = torch.cat([torch.zeros_like(cond), cond])
        ids = torch.tensor([[fps - 1, motion_bucket_id, noise_aug_strength]] * (2 * b),
                           dtype=torch.float32)
        return context, cond, ids.to(self.device)

    def _guidance_ramp(self, lo: float, hi: float, num_frames: int) -> torch.Tensor:
        """The per-frame guidance scale, (1, F, 1, 1, 1) f32 on the device."""
        ramp = torch.linspace(lo, hi, num_frames, dtype=torch.float32)
        return ramp.reshape(1, num_frames, 1, 1, 1).to(self.device)

    @staticmethod
    def _denoise_step(unet, scheduler, state, i, step, latents, cond, context, ids, ramp):
        """One step: the CFG batch scaled and concatenated with the
        conditioning latents, the UNet, the per-frame guidance (in f32, as
        JAX promotes), the EDM step (``step``: the step index, an int or a
        device index)."""
        lat_in = scheduler.scale_model_input(state, torch.cat([latents, latents]), i)
        lat_in = torch.cat([lat_in, cond.to(lat_in.dtype)], dim=-1)
        out_u, out_c = unet(lat_in, state["timesteps"][i], context, ids).chunk(2)
        latents, _ = scheduler.step(state, out_u + ramp * (out_c - out_u), step, latents)
        return latents

    def _fused_loop(self, num_steps: int, num_frames: int):
        """The N-step loop as one function (≙ JAX's ``_build_fused_loop``):
        a :class:`LazyCompiledFunction` named ``svd_denoise_loop_{N}_f{F}``
        when graphs are on, keyed by (steps, frames)."""
        key = (num_steps, num_frames)
        loop = self._fused_loops.get(key)
        if loop is None:
            unet = _module(self.unet)
            scheduler = getattr(self.scheduler, "_scheduler", self.scheduler)

            def svd_denoise_loop(latents, cond, context, ids, ramp, state):
                for i in range(num_steps):
                    latents = self._denoise_step(unet, scheduler, state, i, i, latents, cond,
                                                 context, ids, ramp)
                return latents

            loop = svd_denoise_loop
            if self._ccfg.enable_cuda_graph:
                # one warm-up call: the loop is N evals of modules whose
                # first-call setup one eval does, and one call of the 25-step
                # loop at 25 frames takes about 27 s (an H100 80GB HBM3 at
                # 700 W, chip_smoke.py phase 13)
                name = f"svd_denoise_loop_{num_steps}_f{num_frames}"
                loop = global_executable_cache().register(
                    name, LazyCompiledFunction(svd_denoise_loop, name=name, warmup_calls=1,
                                               reads=(unet,)))
            self._fused_loops[key] = loop
        return loop

    def _decoder_u8(self):
        """A chunk of latent frames → uint8 frames, one graph per chunk size
        when graphs are on (≙ JAX's ``_build_decode_u8``)."""
        if self._decode_u8 is None:
            vae = _module(self.vae)
            temporal = isinstance(vae, AutoencoderKLTemporalDecoder)

            def svd_decode_u8(chunk):
                img = vae.decode(chunk, num_frames=chunk.shape[0]) if temporal else vae.decode(chunk)
                return denormalize_to_uint8(img)

            fn = svd_decode_u8
            if self._ccfg.enable_cuda_graph:
                fn = global_executable_cache().register(
                    "svd_decode_u8",
                    LazyCompiledFunction(svd_decode_u8, name="svd_decode_u8", reads=(vae,)))
            self._decode_u8 = fn
        return self._decode_u8

    def _decode(self, latents: torch.Tensor, chunk: int) -> np.ndarray:
        """(B, F, h, w, 4) latents → (B·F, H, W, 3) uint8 frames on the host
        (pinned from a CUDA device): each chunk's copy is issued without
        blocking, and the stream is synchronized once, inside one
        ``sfast.wait`` span with the frames' ``.numpy()``."""
        b, f, lh, lw, c = latents.shape
        flat = latents.reshape(b * f, lh, lw, c) / self.vae.config.scaling_factor
        dec = self._decoder_u8()
        sf = self.vae_scale_factor
        shape = (b * f, lh * sf, lw * sf, 3)
        on_card = self.device.type == "cuda"
        host = torch.empty(shape, dtype=torch.uint8, pin_memory=on_card)
        for s in range(0, b * f, chunk):
            host[s:s + chunk].copy_(dec(flat[s:s + chunk]), non_blocking=on_card)
        with spans.wait():
            if on_card:
                torch.cuda.current_stream(self.device).synchronize()
            return host.numpy()

    @spans.as_request
    @torch.inference_mode()
    def __call__(
        self,
        image,
        *,
        num_frames: Optional[int] = None,
        height: int = 576,
        width: int = 1024,
        num_inference_steps: int = 25,
        min_guidance_scale: float = 1.0,
        max_guidance_scale: float = 3.0,
        fps: int = 7,
        motion_bucket_id: int = 127,
        noise_aug_strength: float = 0.02,
        decode_chunk_size: Optional[int] = None,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        aug_noise: Optional[torch.Tensor] = None,
        output_type: str = "np",  # 'np' (uint8, host) | 'latent'
    ) -> PipelineOutput:
        """``image``: PIL, uint8 or float (B, H, W, 3) or (H, W, 3), resized
        to ``height`` × ``width``.  ``latents`` (B, F, h, w, 4) are the
        initial noise before it is scaled by σ_max, as diffusers takes them;
        ``aug_noise`` (B, height, width, 3) the augmentation's.  Returns
        (B, F, height, width, 3) uint8 frames, or the latents.  Under a
        profiler session the call is an ``sfast.request`` span
        (``profile/spans.py``)."""
        self._sched_guard()
        num_frames = num_frames or self.unet.config.num_frames
        chunk = decode_chunk_size or num_frames
        gen = torch.Generator(device=self.device).manual_seed(seed)
        context, cond, ids = self.prepare_conditioning(
            image, num_frames=num_frames, height=height, width=width, fps=fps,
            motion_bucket_id=motion_bucket_id, noise_aug_strength=noise_aug_strength,
            aug_noise=aug_noise, generator=gen)
        b = context.shape[0] // 2
        sf = self.vae_scale_factor
        shape = (b, num_frames, height // sf, width // sf, self.vae.config.latent_channels)
        state, steps = self._scheduler_state(num_inference_steps)
        if latents is None:
            latents = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        latents = torch.as_tensor(latents, device=self.device).float()
        if tuple(latents.shape) != shape:
            raise ValueError(f"latents of shape {tuple(latents.shape)} for {shape}")
        latents = (latents * self._init_noise_sigma(state)).to(self.dtype)
        if hasattr(self.scheduler, "prepare_state"):
            state = self.scheduler.prepare_state(state, latents)
        ramp = self._guidance_ramp(min_guidance_scale, max_guidance_scale, num_frames)

        if self._ccfg.fuse_denoising_loop:
            loop = self._fused_loop(num_inference_steps, num_frames)
            latents = loop(latents, cond, context, ids, ramp, state)
        else:
            for i in range(num_inference_steps):
                latents = self._denoise_step(self.unet, self.scheduler, state, i, steps[i],
                                             latents, cond, context, ids, ramp)
        if output_type == "latent":
            return PipelineOutput(latents)
        if output_type != "np":
            raise ValueError(f"unknown output_type: {output_type!r}")
        frames = self._decode(latents, chunk)
        return PipelineOutput(frames.reshape(b, num_frames, height, width, 3))
