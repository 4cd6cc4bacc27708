"""Stable Diffusion text2img pipeline with classifier-free guidance.

Counterpart of ``sfast_tpu/pipelines/stable_diffusion.py`` (``:80-215``,
``:353-464``, ``:678-967``): CLIP encode of [uncond; cond], then per step
the UNet on the CFG batch, the guidance combine and the scheduler step,
then the VAE decode of ``latents / scaling_factor`` and the uint8
conversion.  Prompts come as token ids (``prompt_ids``); the tokenizer is
a later slice.

Two ways through the denoising loop, as in JAX:

- **stepwise** (default): a Python loop; after ``sfast_tpu_torch.compile``
  each step replays the UNet's graph and the DPM++ step's graph.  The step
  index, the timestep and the guidance scale are device tensors, so one
  graph of each serves every step;
- **fused** (``fuse_denoising_loop``): the N steps (CFG concat, UNet,
  guidance combine, step) are one CUDA graph, keyed by the step count and
  CFG (JAX's ``lkey``, ``:899-902``) and by the latents' shape and dtype.

JAX's single-dispatch fused pipeline (``:466-647``) is three graphs here:
CLIP, the loop and the VAE decode; the initial latents are drawn eagerly
before them (torch's Philox is not JAX's threefry, so images from a seed
differ between the packages in any case).
"""

from typing import Optional

import torch

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.shape_bucket import pad_batch, unpad_batch
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction
from sfast_tpu_torch.utils.image import denormalize_to_uint8


class PipelineOutput:
    def __init__(self, images):
        self.images = images


class StableDiffusionPipeline:
    def __init__(
        self,
        unet,
        vae,
        text_encoder,
        scheduler,
        *,
        device=None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.scheduler = scheduler
        self.device = torch.device(device) if device is not None else unet.conv_in.weight.device
        self.dtype = dtype
        self._ccfg = CompilationConfig.Default()
        # fused loops by (steps, CFG): a loop's graph bakes its trip count in
        self._fused_loops = {}
        self._sched_states = {}
        self._sched_obj = scheduler
        self._dev_scalars = {}

    def set_compilation_config(self, ccfg: CompilationConfig) -> None:
        """Apply ``ccfg`` to every submodel and drop every graph — the fused
        loops and the submodels' and scheduler's own: a graph bakes in the
        kernel routes it was captured with."""
        self._ccfg = ccfg
        self._drop_fused_loops()
        for m in (self.unet, self.vae, self.text_encoder, self.scheduler):
            if hasattr(m, "set_compilation_config"):
                m.set_compilation_config(ccfg)
            elif m is not self.scheduler:
                m.compilation_config = ccfg

    def _drop_fused_loops(self) -> None:
        for loop in self._fused_loops.values():
            if isinstance(loop, LazyCompiledFunction):
                loop.clear_cache()  # the registry keeps the function, not its graphs
        self._fused_loops = {}

    def _sched_guard(self) -> None:
        """A swapped ``pipe.scheduler`` drops the fused loops (they call the
        old scheduler's step) and the cached scheduler states."""
        if self._sched_obj is not self.scheduler:
            self._drop_fused_loops()
            self._sched_states = {}
            self._sched_obj = self.scheduler

    def _scheduler_state(self, num_steps: int):
        """(state with its tables on the device, the step indices 0..N-1 on
        the device), cached per step count."""
        entry = self._sched_states.get(num_steps)
        if entry is None:
            sched = self.scheduler
            state = sched.device_state(sched.set_timesteps(num_steps), self.device)
            entry = (state, torch.arange(num_steps, device=self.device))
            self._sched_states[num_steps] = entry
        return entry

    def _dev_scalar(self, v) -> torch.Tensor:
        """A 0-d f32 device tensor of ``v``, cached by value: a graph reads
        the guidance scale as an input, never as a baked-in constant."""
        v = float(v)
        t = self._dev_scalars.get(v)
        if t is None:
            t = self._dev_scalars[v] = torch.tensor(v, dtype=torch.float32, device=self.device)
        return t

    def warmup(self, resolutions=((512, 512),), steps=(50,), batch_sizes=(1,)) -> None:
        """Capture every graph of a (H, W) × steps × batch grid by running
        one image of each (a capture needs its warm-up calls anyway)."""
        for b in batch_sizes:
            ids = torch.zeros((int(b), 77), dtype=torch.long, device=self.device)
            for h, w in resolutions:
                for s in steps:
                    self(prompt_ids=ids, height=int(h), width=int(w),
                         num_inference_steps=int(s), output_type="pt")

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae.config.block_out_channels) - 1)

    def _empty_prompt_ids(self, prompt_ids: torch.Tensor) -> torch.Tensor:
        """Ids of the empty prompt "" without a tokenizer: [BOS, EOS, pad...]
        (JAX ``stable_diffusion.py:261-276``)."""
        cfg = self.text_encoder.config
        ids = torch.full_like(prompt_ids, cfg.pad_token_id)
        ids[:, 0] = prompt_ids[:, 0]  # BOS, copied from the prompt
        ids[:, 1] = cfg.eos_token_id
        return ids

    def encode_prompt(self, prompt_ids, negative_prompt_ids=None, do_cfg: bool = True):
        """Text embeddings: (2B, S, D) as [uncond; cond] with CFG, else (B, S, D)."""
        if not do_cfg:
            return self.text_encoder(prompt_ids)
        if negative_prompt_ids is None:
            negative_prompt_ids = self._empty_prompt_ids(prompt_ids)
        return self.text_encoder(torch.cat([negative_prompt_ids, prompt_ids]))

    @staticmethod
    def _unet_eps(unet, scheduler, state, i, latents, context, guidance_scale, use_cfg):
        """One UNet eval on the CFG batch and the guidance combine (``i``
        an int: the timestep is a view of the device table)."""
        lat_in = torch.cat([latents, latents]) if use_cfg else latents
        lat_in = scheduler.scale_model_input(state, lat_in, i)
        eps = unet(lat_in, state["timesteps"][i], context)
        if not use_cfg:
            return eps
        eps_u, eps_c = eps.float().chunk(2)  # in f32, as JAX promotes bf16 eps
        return eps_u + guidance_scale * (eps_c - eps_u)

    def _fused_loop(self, num_steps: int, use_cfg: bool):
        """The N-step loop as one function (≙ JAX's ``_build_fused_loop``),
        a :class:`LazyCompiledFunction` when graphs are on."""
        key = (num_steps, use_cfg)
        loop = self._fused_loops.get(key)
        if loop is None:
            # the loop is captured whole, so it calls the module and the
            # scheduler themselves, not their graphs
            unet = getattr(self.unet, "module", self.unet)
            scheduler = getattr(self.scheduler, "_scheduler", self.scheduler)

            def denoise_loop(latents, context, state, guidance_scale):
                for i in range(num_steps):
                    eps = self._unet_eps(unet, scheduler, state, i, latents, context,
                                         guidance_scale, use_cfg)
                    latents, state = scheduler.step(state, eps, i, latents)
                return latents

            loop = denoise_loop
            if self._ccfg.enable_cuda_graph:
                name = f"denoise_loop_{num_steps}" + ("" if use_cfg else "_nocfg")
                loop = global_executable_cache().register(
                    name, LazyCompiledFunction(denoise_loop, name=name))
            self._fused_loops[key] = loop
        return loop

    @torch.inference_mode()
    def __call__(
        self,
        *,
        prompt_ids,
        negative_prompt_ids=None,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "np",  # 'np' | 'pt' (uint8) | 'float' | 'latent'
    ) -> PipelineOutput:
        self._sched_guard()
        dev = self.device
        buckets = self._ccfg.batch_buckets
        prompt_ids = torch.as_tensor(prompt_ids, device=dev).long()
        real_b = prompt_ids.shape[0]
        if buckets:  # pad the batch to its bucket; padded rows are dropped
            prompt_ids, _ = pad_batch(prompt_ids, buckets)
        if negative_prompt_ids is not None:
            negative_prompt_ids = torch.as_tensor(negative_prompt_ids, device=dev).long()
            if buckets:
                negative_prompt_ids, _ = pad_batch(negative_prompt_ids, buckets)
        sf = self.vae_scale_factor
        lat_shape = (real_b, height // sf, width // sf, self.vae.config.latent_channels)
        use_cfg = guidance_scale > 1.0
        context = self.encode_prompt(prompt_ids, negative_prompt_ids, do_cfg=use_cfg)

        sched = self.scheduler
        state, steps = self._scheduler_state(num_inference_steps)
        if latents is None:  # drawn at the real batch, so padding changes no row
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn(lat_shape, generator=gen, device=dev, dtype=torch.float32)
            latents = latents * sched.init_noise_sigma
        latents = torch.as_tensor(latents).to(device=dev, dtype=self.dtype)
        if buckets:
            latents, _ = pad_batch(latents, buckets)
        state = sched.prepare_state(state, latents)
        gs = self._dev_scalar(guidance_scale)

        if self._ccfg.fuse_denoising_loop:
            latents = self._fused_loop(num_inference_steps, use_cfg)(latents, context, state, gs)
        else:
            for i in range(num_inference_steps):
                eps = self._unet_eps(self.unet, sched, state, i, latents, context, gs, use_cfg)
                latents, state = sched.step(state, eps, steps[i], latents)

        if output_type == "latent":
            return PipelineOutput(unpad_batch(latents, real_b))
        # the whole (bucket-padded) batch is decoded, so that the decode's
        # graph is keyed by the bucket too; padded rows are dropped after
        image = unpad_batch(self.vae.decode(latents / self.vae.config.scaling_factor), real_b)
        if output_type == "float":
            return PipelineOutput(image)
        image = denormalize_to_uint8(image)
        if output_type == "pt":
            return PipelineOutput(image)
        if output_type == "np":
            return PipelineOutput(image.cpu().numpy())
        raise ValueError(f"unknown output_type: {output_type!r}")
