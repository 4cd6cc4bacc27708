"""Activation-range calibration for static W8A8.

Counterpart of ``sfast_tpu/quant/calibrate.py``.  Static W8A8 quantizes a
site's input with a constant scale, ``max |x| / 127`` over calibration
calls, where dynamic W8A8 computes ``max |x|`` every call (a reduction
pass, then the quantize).  JAX measured the dynamic route end to end as a
loss on its TPU, which is why it calibrates.

A calibration runs the model eagerly (its modules, never a captured
graph) with forward pre-hooks on the sites JAX records, the ones its
``apply_linear`` / ``apply_conv`` see (``layers.py:140-185``): every
linear the forward calls and the resnet, resampling and temporal convs
(JAX's conv targets).  A GEGLU's ``proj`` is not called by its module (the
GEGLU reads its weight), so it is not recorded, as JAX's ``linear_geglu``
bypasses ``apply_linear``: after ``quantize_pipeline(mode='w8a8',
act_scales=cal)`` it runs dynamic W8A8, the other linears static.  Convs
run the plain route for the calibration even under ``enable_fused_conv``,
so that their inputs are seen.

Each hook keeps a running max of ``|x|`` in f32 on the device, per site
over the calls; the values reach the host in one copy at the end.  The
hooks write into a thread-local sink, so a forward in another thread
(a request being served) records nothing.  Ranges are keyed by the
port's module names; ``interop.from_jax.calibration_from_jax`` maps a
JAX calibration (keyed by weight paths) to them.

JAX draws its calibration latents with ``jax.random``; every function
here takes ``latents=`` (and, for SVD, ``aug_noise=``, as its pipeline
does), so that another package's draws can be handed in.
"""

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from sfast_tpu_torch.interop.from_jax import jax_key
from sfast_tpu_torch.quant.dynamic_quant import _CONV_TARGETS, _is_conv
from sfast_tpu_torch.utils.image import preprocess_control_image

_TLS = threading.local()


@contextlib.contextmanager
def _sink(out: Dict):
    prev = getattr(_TLS, "sink", None)
    _TLS.sink = out
    try:
        yield out
    finally:
        _TLS.sink = prev


def _record(key, module, args) -> None:
    sink = getattr(_TLS, "sink", None)
    if sink is None:
        return
    a = args[0].detach().float().abs().amax()
    prev = sink.get(key)
    sink[key] = a if prev is None else torch.maximum(prev, a)


@dataclasses.dataclass
class Calibration:
    """Per-site activation ranges keyed by the port's module names."""

    amax: Dict[str, float]

    def scale_for(self, name: str) -> Optional[float]:
        a = self.amax.get(name)
        return None if a is None else max(a, 1e-6) / 127.0


def calibration_sites(module: nn.Module):
    """(name, module) of the sites a calibration records."""
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, nn.Linear) or (_is_conv(m) and jax_key(name) in _CONV_TARGETS)]


@contextlib.contextmanager
def _plain_convs(modules):
    saved = [(m, m.compilation_config) for m in modules]
    for m, cfg in saved:
        m.compilation_config = dataclasses.replace(cfg, enable_fused_conv=False)
    try:
        yield
    finally:
        for m, cfg in saved:
            m.compilation_config = cfg


def calibrate_forward(fn: Callable, inputs: Sequence[tuple],
                      modules: Mapping[str, nn.Module]) -> Dict[str, Calibration]:
    """Run ``fn(*args)`` for each ``args`` of ``inputs`` with the sites of
    each of ``modules`` hooked; return a :class:`Calibration` per name of
    ``modules``."""
    sink: Dict = {}
    handles = [m.register_forward_pre_hook(functools.partial(_record, (tag, name)))
               for tag, mod in modules.items() for name, m in calibration_sites(mod)]
    try:
        with _sink(sink), _plain_convs(modules.values()), torch.inference_mode():
            for args in inputs:
                fn(*args)
    finally:
        for h in handles:
            h.remove()
    keys = list(sink)
    vals = torch.stack([sink[k] for k in keys]).cpu().tolist() if keys else []
    out = {tag: {} for tag in modules}
    for (tag, name), v in zip(keys, vals):
        out[tag][name] = v
    return {tag: Calibration(amax=amax) for tag, amax in out.items()}


def _module(m):
    return getattr(m, "module", m)


def _draws(pipe, latents, n: int, shape, seed: int):
    """The calibration's standard-normal draws: ``latents`` when given,
    else drawn on the device from ``seed``."""
    if latents is None:
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        return [torch.randn(shape, generator=gen, device=pipe.device) for _ in range(n)]
    if len(latents) != n:
        raise ValueError(f"{len(latents)} latents for {n} calibration calls")
    return [torch.as_tensor(lat, device=pipe.device).float() for lat in latents]


def _noised_inputs(pipe, b2: int, height: int, width: int, timesteps, latents, seed: int):
    """(latents, timestep) per timestep: the first draw at the scheduler's
    initial noise scale, the later ones at unit scale (JAX ``:214-224``)."""
    sf = pipe.vae_scale_factor
    shape = (b2, height // sf, width // sf, pipe.vae.config.latent_channels)
    init_sigma = float(pipe._init_noise_sigma(pipe.scheduler.set_timesteps(50)))
    out = []
    for i, (t, z) in enumerate(zip(timesteps, _draws(pipe, latents, len(timesteps), shape,
                                                      seed))):
        scale = 1.0 + (init_sigma - 1.0) * (i == 0)
        out.append(((z * scale).to(pipe.dtype),
                    torch.tensor(float(t), dtype=torch.float32, device=pipe.device)))
    return out


@torch.inference_mode()
def calibrate_pipeline(pipe, prompt_ids, *, height: int = 512, width: int = 512,
                       timesteps: Sequence[int] = (999, 700, 400, 100), seed: int = 0,
                       latents=None) -> Calibration:
    """The UNet's activation ranges under real text conditioning, on noise
    latents at several timesteps (``latents``: one standard-normal draw
    per timestep, (2B, H/8, W/8, 4), before the first one's scale).  An
    SDXL pipeline conditions as its ``__call__`` does by default: zero
    uncond and pooled halves, and the micro-conditioning ids of an
    uncropped ``height`` × ``width`` image."""
    unet = _module(pipe.unet)
    ids = torch.as_tensor(prompt_ids, device=pipe.device).long()
    added = None
    if hasattr(pipe, "encode_prompt_xl"):
        cond, pooled_c = pipe.encode_prompt_xl(ids, ids)
        context = torch.cat([torch.zeros_like(cond), cond])
        pooled = torch.cat([torch.zeros_like(pooled_c), pooled_c])
        added = {"text_embeds": pooled,
                 "time_ids": pipe._time_ids((height, width), (0, 0), (height, width),
                                            ids.shape[0])}
    else:
        context = pipe.encode_prompt(ids)

    def fn(lat, t):
        if added is None:
            return unet(lat, t, context)
        return unet(lat, t, context, added_cond_kwargs=added)

    inputs = _noised_inputs(pipe, context.shape[0], height, width, timesteps, latents, seed)
    return calibrate_forward(fn, inputs, {"unet": unet})["unet"]


@torch.inference_mode()
def calibrate_controlnet_pipeline(pipe, prompt_ids, control_image, *, height: int = 512,
                                  width: int = 512,
                                  timesteps: Sequence[int] = (999, 700, 400, 100),
                                  conditioning_scale: float = 1.0, seed: int = 0,
                                  latents=None) -> Tuple[Calibration, Calibration]:
    """The UNet's and the ControlNet's ranges together: each call runs the
    ControlNet and feeds its residuals to the UNet, as the denoising loop
    does, so the UNet sees the distribution it serves.  Returns
    ``(unet_cal, controlnet_cal)`` for ``quantize_pipeline(act_scales=,
    controlnet_act_scales=, quantize_controlnet=True)``."""
    if pipe.controlnet is None:
        raise ValueError("pipeline has no controlnet model")
    unet, cn = _module(pipe.unet), _module(pipe.controlnet)
    context = pipe.encode_prompt(torch.as_tensor(prompt_ids, device=pipe.device).long())
    b2 = context.shape[0]
    ctrl = preprocess_control_image(control_image, pipe.dtype, pipe.device)
    if tuple(ctrl.shape[1:3]) != (height, width):
        raise ValueError(f"control image {ctrl.shape[1]}x{ctrl.shape[2]} does not match "
                         f"requested {height}x{width}")
    if ctrl.shape[0] != b2:
        ctrl = ctrl.repeat(b2 // ctrl.shape[0], 1, 1, 1)

    def fn(lat, t):
        tt = t.expand(b2)
        down, mid = cn(lat, tt, context, ctrl, conditioning_scale=conditioning_scale)
        return unet(lat, tt, context, down_block_additional_residuals=down,
                    mid_block_additional_residual=mid)

    inputs = _noised_inputs(pipe, b2, height, width, timesteps, latents, seed)
    cals = calibrate_forward(fn, inputs, {"unet": unet, "controlnet": cn})
    return cals["unet"], cals["controlnet"]


@torch.inference_mode()
def calibrate_svd_pipeline(pipe, image, *, num_frames: Optional[int] = None, height: int = 576,
                           width: int = 1024, num_inference_steps: int = 25,
                           step_indices: Sequence[int] = (0, 8, 16, 24), fps: int = 7,
                           motion_bucket_id: int = 127, noise_aug_strength: float = 0.02,
                           seed: int = 0, aug_noise=None, latents=None) -> Calibration:
    """The SVD UNet's ranges with the pipeline's own conditioning
    (``prepare_conditioning``, the code ``__call__`` runs; ``aug_noise``
    as there) and latents at the EDM noise level of several step indices
    (``latents``: one standard-normal draw (B, F, h, w, 4) per index),
    each run as the denoising loop's body runs them."""
    unet = _module(pipe.unet)
    num_frames = num_frames or unet.config.num_frames
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    context, cond, add_ids = pipe.prepare_conditioning(
        image, num_frames=num_frames, height=height, width=width, fps=fps,
        motion_bucket_id=motion_bucket_id, noise_aug_strength=noise_aug_strength,
        aug_noise=aug_noise, generator=gen)
    b = context.shape[0] // 2
    sf = pipe.vae_scale_factor
    shape = (b, num_frames, height // sf, width // sf, pipe.vae.config.latent_channels)
    state, _ = pipe._scheduler_state(num_inference_steps)
    for i in step_indices:
        if not 0 <= int(i) < num_inference_steps:
            raise ValueError(f"step index {i} outside [0, {num_inference_steps})")
    if latents is None:
        latents = [torch.randn(shape, generator=gen, device=pipe.device) for _ in step_indices]
    draws = _draws(pipe, latents, len(step_indices), shape, seed)
    inputs = []
    for i, z in zip(step_indices, draws):
        i = int(i)
        lat = (z * state["sigmas"][i]).to(pipe.dtype)
        lat_in = pipe.scheduler.scale_model_input(state, torch.cat([lat, lat]), i)
        lat_in = torch.cat([lat_in, cond.to(lat_in.dtype)], dim=-1)
        inputs.append((lat_in, state["timesteps"][i].expand(2 * b)))
    return calibrate_forward(lambda lat_in, tt: unet(lat_in, tt, context, add_ids), inputs,
                             {"unet": unet})["unet"]
