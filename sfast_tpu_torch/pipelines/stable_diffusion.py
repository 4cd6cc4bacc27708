"""Stable Diffusion text2img, img2img and inpainting with classifier-free
guidance.

Counterpart of ``sfast_tpu/pipelines/stable_diffusion.py`` (``:80-215``,
``:230-276``, ``:353-464``, ``:649-967``): CLIP encode of [uncond; cond],
then per step the UNet on the CFG batch, the guidance combine and the
scheduler step, then the VAE decode of ``latents / scaling_factor`` and
the uint8 conversion.  Prompts come as strings through a CLIP tokenizer
(``text/clip_tokenizer.py``) or as token ids (``prompt_ids``).

img2img (``image=``, ``strength=``) encodes the image with ``vae_encode``
(the VAE's ``encode``), samples the posterior, forward-noises it to step
``N − int(N·strength)`` and runs the steps from there; inpainting
(``mask_image=``, white = repaint) also blends the kept region back after
each step, at the noise level of the next step and clean after the last.

Two ways through the denoising loop, as in JAX:

- **stepwise** (default): a Python loop; after ``sfast_tpu_torch.compile``
  each step replays the UNet's graph and the DPM++ step's graph.  The step
  index, the timestep and the guidance scale are device tensors, so one
  graph of each serves every step;
- **fused** (``fuse_denoising_loop``): the N steps (CFG concat, UNet,
  guidance combine, step) are one CUDA graph, keyed by the step count,
  CFG, the LCM guidance-embedding width and whether the scheduler takes
  noise (JAX's ``lkey``, ``:899-902``), and by the latents' shape and
  dtype.  img2img entering after step 0 and inpainting take the stepwise
  loop, as in JAX (``:820-825``).

A scheduler that ``needs_noise`` (LCM, ancestral Euler) takes fresh noise
every step.  JAX splits its key once a step inside the loop
(``:444-449``, ``:928-945``); here ``_step_noise`` draws the noise of all
N steps into one buffer before the loop, on the card, from a generator
seeded per call.  The stepwise path hands ``buf[i]`` to the (graphed)
step as an ordinary input and the fused loop takes the buffer as an input,
so no graph draws random numbers: a capture's three warm-up calls would
advance a generator, and a graph would bake in its Philox state.

A ControlNet (``controlnet=``, ``control_image=``) runs before the UNet on
the CFG batch each step, and its residuals feed the UNet; IP-Adapter tokens
(``ip_adapter_embeds=``, [uncond; cond] with CFG) reach every attn2 that
holds IP projections (``ip_adapter.py``).  Both scales enter every graph as
0-d device tensors, so a new scale captures nothing.  The stepwise path
embeds the control image inside each ControlNet eval, as JAX's stepwise
path does (``:313-349``); the fused loop embeds it once before its steps
(``:395-410``) and is keyed by both branches as well (JAX's ``_cn`` /
``_ip``, ``:455-462``).

An LCM-distilled UNet (``time_cond_proj_dim``) takes the guidance scale as
an embedding (``timestep_cond``) and runs without CFG whatever the scale;
any UNet runs without CFG at a scale ≤ 1 (JAX ``:736-742``).

Serving (JAX ``:172-215``, ``:969-1031``): ``map`` yields the images of
many requests in order and dispatches image i+1 before it waits for image
i, each copied to pinned host memory without blocking; a steady-state
graphed call reaches no host sync before it returns (prompt ids cross to
the device through pinned memory), so the next call's host work overlaps
the device's.  ``warmup(background=True)`` captures a grid of shapes on a
thread of its own while the caller serves (``runtime/tracing.py`` says what
makes that safe).  ``callback_on_step_end(pipe, i, t, {"latents": ...})``
runs after each executed step and sends the call down the stepwise loop,
as in JAX (``:728-731``).

JAX's single-dispatch fused pipeline (``:466-647``) is three graphs here:
CLIP, the loop and the VAE decode; the initial latents, img2img's two
noise draws and the step noise are drawn eagerly before them (torch's
Philox is not JAX's threefry, so images from a seed differ between the
packages in any case).
"""

import collections
import threading
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.models.layers import lcm_timestep_cond
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.shape_bucket import pad_batch, unpad_batch
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction
from sfast_tpu_torch.schedulers import common
from sfast_tpu_torch.text.clip_tokenizer import CLIPTokenizer, find_vocab_files
from sfast_tpu_torch.utils.image import (
    denormalize_to_uint8,
    preprocess_control_image,
    preprocess_image,
    preprocess_mask_image,
    to_pil,
)


# mixes a call's seed into the seed of its step noise (a 64-bit odd constant,
# the golden ratio's)
_STEP_NOISE_MIX = 0x9E3779B97F4A7C15


class PipelineOutput:
    def __init__(self, images):
        self.images = images


class WarmupThread(threading.Thread):
    """The daemon thread of ``warmup(background=True)``, started.  It keeps
    what the warm-up raised, and :meth:`join` raises it again: a warm-up
    that fails never passes unseen."""

    def __init__(self, work: Callable[[], None]):
        super().__init__(daemon=True, name="sfast-warmup")
        self._work = work
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._work()
        except BaseException as e:  # kept for join()
            self.error = e

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


def _to_host_async(image: torch.Tensor):
    """(host tensor, event or None): a card image copied into pinned host
    memory of its own without blocking, with the event that marks the end
    of the copy; a host image as it is."""
    if not image.is_cuda:
        return image, None
    host = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
    host.copy_(image, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(image.device))
    return host, done


class PipelineBase:
    """What every pipeline of the port shares: its compilation config and
    its graphs (the fused loops of ``_fused_loops``, dropped on a new config
    or scheduler), the scheduler states per step count, and device scalars.
    A subclass sets the models and names them in ``_submodels``."""

    def __init__(self, scheduler, device, dtype: torch.dtype):
        self.scheduler = scheduler
        self.device = torch.device(device)
        self.dtype = dtype
        self._ccfg = CompilationConfig.Default()
        # fused loops by their key (the SD loop's: steps, CFG, LCM embedding
        # width, step noise, then "cn" and "ip" where it runs those
        # branches): a loop's graph bakes its trip count and branches in
        self._fused_loops = {}
        self._sched_states = {}
        self._sched_obj = scheduler
        self._dev_scalars = {}

    def _submodels(self):
        raise NotImplementedError

    @staticmethod
    def check_compilation_config(ccfg: CompilationConfig) -> None:
        """Raise for a config the pipelines cannot run: they hand their
        models NHWC tensors, so ``memory_format='NCHW'`` is for models
        compiled alone (``compile_model``, ``compile_unet``...)."""
        if ccfg.memory_format != "NHWC":
            raise ValueError(
                f"memory_format={ccfg.memory_format!r}: a pipeline's models take NHWC "
                "tensors; 'NCHW' is for a model compiled alone (compile_model)")

    def set_compilation_config(self, ccfg: CompilationConfig) -> None:
        """Apply ``ccfg`` to every submodel and drop every graph — the fused
        loops and the submodels' and scheduler's own: a graph bakes in the
        kernel routes it was captured with."""
        self.check_compilation_config(ccfg)
        self._ccfg = ccfg
        self._drop_fused_loops()
        for m in (*self._submodels(), self.scheduler):
            if m is None:
                continue
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
        the device), cached per step count.  A scheduler without its own
        ``device_state`` has its numpy tables uploaded as they are."""
        entry = self._sched_states.get(num_steps)
        if entry is None:
            sched = self.scheduler
            host = sched.set_timesteps(num_steps)
            if hasattr(sched, "device_state"):
                state = sched.device_state(host, self.device)
            else:
                state = common.device_state(host, self.device)
            entry = (state, torch.arange(num_steps, device=self.device))
            self._sched_states[num_steps] = entry
        return entry

    def _to_device(self, t) -> torch.Tensor:
        """``t`` (a tensor, array or list) on the pipeline's device.  A host
        tensor crosses to the card through pinned memory without blocking:
        a copy from pageable memory synchronizes the stream, and ``map``
        would then overlap nothing."""
        t = torch.as_tensor(t)
        if t.device.type == "cpu" and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _dev_scalar(self, v) -> torch.Tensor:
        """A 0-d f32 device tensor of ``v``, cached by value: a graph reads
        the guidance scale as an input, never as a baked-in constant."""
        v = float(v)
        t = self._dev_scalars.get(v)
        if t is None:
            t = self._dev_scalars[v] = torch.tensor(v, dtype=torch.float32, device=self.device)
        return t

    def _init_noise_sigma(self, state):
        """What the initial noise is scaled by: the state's
        ``init_noise_sigma`` where it holds one (Euler, EDM), else the
        scheduler's attribute, else 1 (JAX ``:796``)."""
        if "init_noise_sigma" in state:
            return state["init_noise_sigma"]
        return getattr(self.scheduler, "init_noise_sigma", 1.0)

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae.config.block_out_channels) - 1)


class StableDiffusionPipeline(PipelineBase):
    # the conditioning: the CLIP's last hidden state ('last', SD1.5) or its
    # penultimate one ('penultimate', SD2.x), for both CFG halves (JAX
    # ``stable_diffusion.py:57-58, 278-304``)
    clip_skip_mode = "last"

    def __init__(
        self,
        unet,
        vae,
        text_encoder,
        scheduler,
        *,
        vae_encode=None,
        tokenizer=None,
        controlnet=None,
        device=None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        """``vae_encode`` is what img2img encodes with: the VAE module itself
        (its ``encode``), which ``sfast_tpu_torch.compile`` wraps as a model
        of its own beside the decode.  ``controlnet`` is a
        ``ControlNetModel``, run by ``control_image=``."""
        super().__init__(scheduler, device if device is not None else unet.conv_in.weight.device,
                         dtype)
        self.unet = unet
        self.controlnet = controlnet
        self.vae = vae
        self.vae_encode = vae_encode
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer

    def _submodels(self):
        return (self.unet, self.controlnet, self.vae, self.vae_encode, self.text_encoder)

    def warmup(self, resolutions=((512, 512),), steps=(50,), batch_sizes=(1,),
               background: bool = False) -> Optional[WarmupThread]:
        """Capture every graph of a (H, W) × steps × batch grid by running
        one image of each (a capture needs its warm-up calls anyway).  With
        ``background`` the grid runs on a started :class:`WarmupThread`,
        returned, while the caller serves shapes already captured; its
        ``join()`` raises what the warm-up raised.  Else returns None once
        every image of the grid has run."""
        def run():
            for b in batch_sizes:
                ids = torch.zeros((int(b), 77), dtype=torch.long, device=self.device)
                for h, w in resolutions:
                    for s in steps:
                        self(prompt_ids=ids, height=int(h), width=int(w),
                             num_inference_steps=int(s), output_type="pt")

        if background:
            thread = WarmupThread(run)
            thread.start()
            return thread
        run()
        return None

    def tokenize(self, prompt: Union[str, List[str]]) -> torch.Tensor:
        """Prompt strings → (B, 77) token ids on the pipeline's device.
        Without a tokenizer, one is built from the CLIP vocabulary that
        ``find_vocab_files`` finds; raises when there is none."""
        if prompt is None:
            raise ValueError("pass a prompt or prompt_ids")
        if self.tokenizer is None:
            found = find_vocab_files(None)
            if found is not None:
                self.tokenizer = CLIPTokenizer.from_files(*found)
        if self.tokenizer is None:
            raise ValueError(
                "no tokenizer attached and no CLIP vocab files found; pass prompt_ids, "
                "construct the pipeline with tokenizer=, or provide vocab.json + merges.txt "
                "via SFAST_TPU_CLIP_VOCAB or sfast_tpu_torch/text/data/")
        if isinstance(prompt, str):
            prompt = [prompt]
        enc = self.tokenizer(prompt, padding="max_length",
                             max_length=self.tokenizer.model_max_length, truncation=True,
                             return_tensors="pt")
        return self._to_device(enc.input_ids).long()

    def _empty_prompt_ids(self, prompt_ids: torch.Tensor) -> torch.Tensor:
        """Ids of the empty prompt "" (JAX ``stable_diffusion.py:261-276``):
        the tokenizer's when one is attached, else [BOS, EOS, pad...]."""
        if self.tokenizer is not None:
            return self.tokenize([""] * prompt_ids.shape[0])
        cfg = self.text_encoder.config
        ids = torch.full_like(prompt_ids, cfg.pad_token_id)
        ids[:, 0] = prompt_ids[:, 0]  # BOS, copied from the prompt
        ids[:, 1] = cfg.eos_token_id
        return ids

    def encode_prompt(self, prompt_ids, negative_prompt_ids=None, do_cfg: bool = True):
        """Text embeddings: (2B, S, D) as [uncond; cond] with CFG, else (B,
        S, D), from the hidden state ``clip_skip_mode`` names."""
        if self.clip_skip_mode not in ("last", "penultimate"):
            raise ValueError(f"clip_skip_mode {self.clip_skip_mode!r}: 'last' or 'penultimate'")
        if do_cfg:
            if negative_prompt_ids is None:
                negative_prompt_ids = self._empty_prompt_ids(prompt_ids)
            prompt_ids = torch.cat([negative_prompt_ids, prompt_ids])
        return self.text_encoder(prompt_ids, output=self.clip_skip_mode)

    @property
    def _lcm_cond_dim(self) -> Optional[int]:
        """The UNet's ``time_cond_proj_dim``: set for an LCM-distilled UNet,
        which takes the guidance scale as an embedding, not CFG."""
        return getattr(self.unet.config, "time_cond_proj_dim", None)

    def _use_cfg(self, guidance_scale: float) -> bool:
        return self._lcm_cond_dim is None and guidance_scale > 1.0

    @staticmethod
    def _unet_eps(unet, scheduler, state, i, latents, context, guidance_scale, use_cfg,
                  tcond=None, added=None, controlnet=None, control=None, ip=None):
        """One UNet eval on the CFG batch and the guidance combine (``i``
        an int: the timestep is a view of the device table).  ``tcond`` is
        an LCM UNet's guidance embedding, ``added`` SDXL's
        ``added_cond_kwargs``; ``control`` is (control image on the CFG
        batch or None, scale, its embedding or None) for ``controlnet``,
        which runs first; ``ip`` is (IP tokens, scale)."""
        lat_in = torch.cat([latents, latents]) if use_cfg else latents
        lat_in = scheduler.scale_model_input(state, lat_in, i)
        t = state["timesteps"][i]
        kw = {}
        if added is not None:
            kw["added_cond_kwargs"] = added
        if tcond is not None:
            kw["timestep_cond"] = tcond
        if control is not None:
            image, scale, embed = control
            cn_kw = {"conditioning_scale": scale}
            if added is not None:
                cn_kw["added_cond_kwargs"] = added
            if embed is not None:
                cn_kw["cond_embed"] = embed
            down, mid = controlnet(lat_in, t, context, image, **cn_kw)
            kw["down_block_additional_residuals"] = down
            kw["mid_block_additional_residual"] = mid
        if ip is not None:
            kw["ip_adapter_embeds"], kw["ip_adapter_scale"] = ip
        eps = unet(lat_in, t, context, **kw)
        if not use_cfg:
            return eps
        eps_u, eps_c = eps.float().chunk(2)  # in f32, as JAX promotes bf16 eps
        return eps_u + guidance_scale * (eps_c - eps_u)

    def _fused_loop(self, num_steps: int, use_cfg: bool, tcond_dim: Optional[int] = None,
                    needs_noise: bool = False, with_control: bool = False,
                    with_ip: bool = False):
        """The N-step loop as one function (≙ JAX's ``_build_fused_loop``),
        a :class:`LazyCompiledFunction` when graphs are on.  It takes the
        latents, the context, the state, the guidance scale, the step noise
        buffer (None unless ``needs_noise``), SDXL's added conditioning
        (None for SD), and ``control`` (the control image on the CFG batch
        and its scale) and ``ip`` (the IP tokens and their scale), each
        None unless the loop runs that branch."""
        branches = (("cn",) if with_control else ()) + (("ip",) if with_ip else ())
        key = (num_steps, use_cfg, tcond_dim, needs_noise, *branches)
        loop = self._fused_loops.get(key)
        if loop is None:
            # the loop is captured whole, so it calls the modules and the
            # scheduler themselves, not their graphs
            unet = getattr(self.unet, "module", self.unet)
            controlnet = getattr(self.controlnet, "module", self.controlnet)
            scheduler = getattr(self.scheduler, "_scheduler", self.scheduler)

            def denoise_loop(latents, context, state, guidance_scale, noise, added, control,
                             ip):
                tcond = lcm_timestep_cond(guidance_scale, tcond_dim, latents.shape[0])
                if with_control:  # the control image's embedding, once for N steps
                    image, scale = control
                    control = (None, scale, controlnet.cond_embed(image))
                for i in range(num_steps):
                    eps = self._unet_eps(unet, scheduler, state, i, latents, context,
                                         guidance_scale, use_cfg, tcond, added, controlnet,
                                         control, ip)
                    if needs_noise:
                        latents, state = scheduler.step(state, eps, i, latents, noise=noise[i])
                    else:
                        latents, state = scheduler.step(state, eps, i, latents)
                return latents

            loop = denoise_loop
            if self._ccfg.enable_cuda_graph:
                name = (f"denoise_loop_{num_steps}" + "".join(f"_{b}" for b in branches)
                        + ("" if use_cfg else "_nocfg")
                        + (f"_tc{tcond_dim}" if tcond_dim else "")
                        + ("_noise" if needs_noise else ""))
                loop = global_executable_cache().register(
                    name, LazyCompiledFunction(denoise_loop, name=name,
                                               reads=(unet, controlnet)))
            self._fused_loops[key] = loop
        return loop

    def _add_noise(self, state, original, noise, i):
        """The scheduler's forward diffusion to step ``i``, or the VP one of
        ``schedulers/common.py`` for a scheduler without its own."""
        add = getattr(self.scheduler, "add_noise", None) or common.add_noise
        return add(state, original, noise, i)

    def _img2img_noise(self, shape, seed: int):
        """img2img's two draws, f32 on the device from one generator seeded
        with ``seed``: the posterior sample's noise, then the forward
        noise."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tuple(torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
                     for _ in range(2))

    def _step_noise(self, shape, num_steps: int, seed: int) -> torch.Tensor:
        """The noise of every step of a ``needs_noise`` scheduler: an
        (N, *shape) f32 buffer drawn on the device, before the loop, from a
        generator seeded per call with ``seed`` mixed by a fixed odd
        constant, so that it is not the stream of the initial latents of
        any seed."""
        gen = torch.Generator(device=self.device).manual_seed(
            (seed * _STEP_NOISE_MIX + 1) % 2**63)
        return torch.randn((num_steps, *shape), generator=gen, device=self.device,
                           dtype=torch.float32)

    def _inpaint_blend(self, state, latents, keep_mask, init, noise, steps, i, num_steps):
        """After step ``i``, the kept region (``keep_mask`` 1) is the
        encoded image forward-noised to step ``i + 1``, the noise level the
        next UNet eval expects, and clean after the last step; the repaint
        region keeps the denoised latents (JAX ``:649-676``, the blend
        diffusers applies with a 4-channel UNet).  The step index is read
        on the device, so the blend waits on no host sync."""
        init_at = self._add_noise(state, init, noise, steps[i + 1]) if i < num_steps - 1 else init
        out = keep_mask * init_at + (1.0 - keep_mask) * latents.float()
        return out.to(latents.dtype)

    def _prompt_batch(self, prompt, prompt_ids, negative_prompt_ids):
        """(prompt ids, negative prompt ids or None, the real batch), on the
        device and padded to the batch bucket when buckets are on."""
        buckets = self._ccfg.batch_buckets
        if prompt_ids is None:
            prompt_ids = self.tokenize(prompt)
        prompt_ids = self._to_device(prompt_ids).long()
        real_b = prompt_ids.shape[0]
        if buckets:  # pad the batch to its bucket; padded rows are dropped
            prompt_ids, _ = pad_batch(prompt_ids, buckets)
        if negative_prompt_ids is not None:
            negative_prompt_ids = self._to_device(negative_prompt_ids).long()
            if buckets:
                negative_prompt_ids, _ = pad_batch(negative_prompt_ids, buckets)
        return prompt_ids, negative_prompt_ids, real_b

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Optional[Union[str, List[str]]] = None,
        *,
        prompt_ids=None,
        negative_prompt_ids=None,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        image=None,
        strength: float = 0.8,
        mask_image=None,
        control_image=None,
        controlnet_conditioning_scale: float = 1.0,
        ip_adapter_embeds=None,
        ip_adapter_scale: float = 1.0,
        output_type: str = "np",  # 'np' | 'pil' | 'pt' (uint8) | 'float' | 'latent'
        callback_on_step_end: Optional[Callable] = None,
    ) -> PipelineOutput:
        """``control_image`` (B or 1 images, (B, H, W, 3) uint8 or float in
        [0, 1], at the output's H × W) runs ``controlnet``;
        ``ip_adapter_embeds`` are IP-Adapter tokens for the UNet's batch,
        (2B, N, D) as [uncond; cond] with CFG, else (B, N, D).
        ``callback_on_step_end(pipe, i, t, {"latents": latents})`` runs
        after each executed step (``t`` its timestep, a 0-d device tensor);
        ``output_type='pt'`` leaves the uint8 images on the device (JAX's
        ``'device'``)."""
        self._sched_guard()
        prompt_ids, negative_prompt_ids, real_b = self._prompt_batch(
            prompt, prompt_ids, negative_prompt_ids)
        use_cfg = self._use_cfg(guidance_scale)
        context = self.encode_prompt(prompt_ids, negative_prompt_ids, do_cfg=use_cfg)
        return self._generate(
            context, None, use_cfg, real_b, height=height, width=width,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, seed=seed,
            latents=latents, image=image, strength=strength, mask_image=mask_image,
            output_type=output_type, callback_on_step_end=callback_on_step_end,
            control=self._control_input(control_image, controlnet_conditioning_scale, real_b,
                                        height, width, use_cfg),
            ip=self._ip_input(ip_adapter_embeds, ip_adapter_scale, real_b, use_cfg))

    def _control_input(self, control_image, scale, real_b, height, width, use_cfg):
        """(the control image on the device, [0, 1], broadcast from batch 1
        to the prompt batch, padded to its bucket, doubled for CFG; the
        scale as a 0-d device tensor), or None without a control image."""
        if control_image is None:
            return None
        if self.controlnet is None:
            raise ValueError("pipeline has no controlnet model")
        ctrl = preprocess_control_image(control_image, self.dtype, self.device)
        if tuple(ctrl.shape[1:3]) != (height, width):
            raise ValueError(f"control image of {tuple(ctrl.shape[1:3])} for a "
                             f"{height}x{width} image")
        if ctrl.shape[0] == 1 and real_b > 1:  # one control image for the batch (diffusers)
            ctrl = ctrl.expand(real_b, -1, -1, -1)
        elif ctrl.shape[0] != real_b:
            raise ValueError(f"{ctrl.shape[0]} control images for a batch of {real_b}")
        if self._ccfg.batch_buckets:
            ctrl, _ = pad_batch(ctrl, self._ccfg.batch_buckets)
        ctrl = torch.cat([ctrl, ctrl]) if use_cfg else ctrl.contiguous()
        return ctrl, self._dev_scalar(scale)

    def _ip_input(self, embeds, scale, real_b, use_cfg):
        """(the IP tokens on the device, each CFG half padded to the batch
        bucket; the scale as a 0-d device tensor), or None."""
        if embeds is None:
            return None
        embeds = torch.as_tensor(embeds, device=self.device)
        halves = 2 if use_cfg else 1
        if embeds.shape[0] != halves * real_b:
            raise ValueError(f"ip_adapter_embeds has {embeds.shape[0]} rows; the UNet's batch "
                             f"is {halves * real_b}" + (" ([uncond; cond])" if use_cfg else ""))
        if self._ccfg.batch_buckets:
            embeds = torch.cat([pad_batch(h, self._ccfg.batch_buckets)[0]
                                for h in embeds.chunk(halves)])
        return embeds, self._dev_scalar(scale)

    def _generate(self, context, added, use_cfg, real_b, *, height, width, num_inference_steps,
                  guidance_scale, seed, latents, image, strength, mask_image, output_type,
                  callback_on_step_end=None, control=None, ip=None):
        """From the text conditioning to the output: the initial latents
        (drawn, given, or img2img's encoded and forward-noised image), the
        denoising loop, the decode.  ``added`` is SDXL's added conditioning,
        None for SD; ``control`` and ``ip`` are ``_control_input``'s and
        ``_ip_input``'s, or None.  A step callback takes the stepwise loop."""
        dev = self.device
        buckets = self._ccfg.batch_buckets
        sf = self.vae_scale_factor
        lat_shape = (real_b, height // sf, width // sf, self.vae.config.latent_channels)

        sched = self.scheduler
        state, steps = self._scheduler_state(num_inference_steps)
        start_index, keep_mask = 0, None
        # drawn at the real batch, so padding changes no row
        if image is not None:
            if self.vae_encode is None:
                raise ValueError("pipeline has no vae_encode model for img2img")
            mean, logvar = self.vae_encode.encode(preprocess_image(image, self.dtype, dev))
            n_enc, noise = self._img2img_noise(mean.shape, seed)
            z = mean + torch.exp(0.5 * logvar) * n_enc.to(mean.dtype)
            init = (z * self.vae.config.scaling_factor).float()
            start_index = max(num_inference_steps - int(num_inference_steps * strength), 0)
            latents = self._add_noise(state, init, noise, start_index)
            if mask_image is not None:
                keep_mask = preprocess_mask_image(mask_image, *init.shape[1:3], dev)
                if buckets:
                    keep_mask = keep_mask.expand(init.shape[0], -1, -1, -1)
                    keep_mask, init, noise = (pad_batch(t, buckets)[0]
                                              for t in (keep_mask, init, noise))
        elif mask_image is not None:
            raise ValueError("inpainting requires `image` with `mask_image`")
        elif latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn(lat_shape, generator=gen, device=dev, dtype=torch.float32)
            latents = latents * self._init_noise_sigma(state)
        latents = torch.as_tensor(latents).to(device=dev, dtype=self.dtype)
        if buckets:
            latents, _ = pad_batch(latents, buckets)
        if hasattr(sched, "prepare_state"):
            state = sched.prepare_state(state, latents)
        gs = self._dev_scalar(guidance_scale)
        tcond_dim = self._lcm_cond_dim
        step_noise = None
        if getattr(sched, "needs_noise", False):
            step_noise = self._step_noise((real_b, *latents.shape[1:]), num_inference_steps, seed)
            if latents.shape[0] != real_b:  # zero noise for the padded rows
                step_noise = torch.cat([step_noise, step_noise.new_zeros(
                    (num_inference_steps, latents.shape[0] - real_b, *latents.shape[1:]))], 1)

        if (self._ccfg.fuse_denoising_loop and callback_on_step_end is None
                and start_index == 0 and keep_mask is None):
            loop = self._fused_loop(num_inference_steps, use_cfg, tcond_dim,
                                    step_noise is not None, control is not None, ip is not None)
            latents = loop(latents, context, state, gs, step_noise, added, control, ip)
        else:
            tcond = lcm_timestep_cond(gs, tcond_dim, latents.shape[0])
            if control is not None:  # embedded inside each ControlNet eval
                control = (*control, None)
            for i in range(start_index, num_inference_steps):
                t = state["timesteps"][i]
                eps = self._unet_eps(self.unet, sched, state, i, latents, context, gs, use_cfg,
                                     tcond, added, self.controlnet, control, ip)
                if step_noise is not None:
                    latents, state = sched.step(state, eps, steps[i], latents,
                                                noise=step_noise[i])
                else:
                    latents, state = sched.step(state, eps, steps[i], latents)
                if keep_mask is not None:
                    latents = self._inpaint_blend(state, latents, keep_mask, init, noise, steps,
                                                  i, num_inference_steps)
                if callback_on_step_end is not None:
                    callback_on_step_end(self, i, t, {"latents": latents})

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
        if output_type == "pil":
            return PipelineOutput(to_pil(image))
        raise ValueError(f"unknown output_type: {output_type!r}")

    def map(self, prompts, *, window: int = 2, output_type: str = "np", **kwargs):
        """Serve many requests: yields one :class:`PipelineOutput` per item
        of ``prompts``, in order (JAX ``:969-1031``).  Image i+1 is
        dispatched before image i is fetched: each call runs with
        ``output_type='pt'`` on the serving stream, its image is copied to
        pinned host memory of its own without blocking, and image i is
        waited for once image i + window − 1 has been dispatched, so the
        host work of the next call overlaps the device's work on this one.

        An item is a prompt string, a list of them, or pre-tokenized ids (a
        tensor or array); ``kwargs`` go to ``__call__``."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if output_type not in ("np", "pil"):
            raise ValueError(
                f"map() yields host images; output_type must be 'np' or 'pil', got "
                f"{output_type!r}")

        def fetch(entry):
            host, done = entry
            if done is not None:
                done.synchronize()
            images = np.array(host.numpy())  # out of the pinned buffer
            return PipelineOutput(to_pil(images) if output_type == "pil" else images)

        pending = collections.deque()
        for p in prompts:
            if isinstance(p, (str, list)):
                out = self(p, output_type="pt", **kwargs)
            elif hasattr(p, "shape"):  # pre-tokenized ids
                out = self(prompt_ids=p, output_type="pt", **kwargs)
            else:
                raise TypeError(
                    "map() items must be a prompt str, a list of prompt strs, or a "
                    f"pre-tokenized ids array (has .shape); got {type(p).__name__}")
            pending.append(_to_host_async(out.images))
            if len(pending) >= window:
                yield fetch(pending.popleft())
        while pending:
            yield fetch(pending.popleft())
