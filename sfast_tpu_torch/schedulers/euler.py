"""Euler discrete scheduler (k-diffusion parametrization): deterministic
and ancestral, with optional Karras sigma respacing — SDXL's scheduler.

Counterpart of ``sfast_tpu/schedulers/euler.py`` (``:19-99``).  The
latents live in k-diffusion x-space: ``init_noise_sigma`` (in the state,
``sqrt(σ_0² + 1)``) scales the initial noise, ``scale_model_input``
divides by ``sqrt(σ_i² + 1)`` and ``add_noise`` is ``z + σ·noise``.  Every
table read at the step index is a gather (``common.table_at``), so that
with a 0-d device tensor as the index one captured graph serves every
step.  The ancestral step takes its noise as an input (``noise=``): the
pipeline draws the noise of every step before the loop.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sfast_tpu_torch.schedulers.common import (
    SchedulerConfig,
    TableState,
    alphas_cumprod,
    karras_respace,
    select_timesteps,
    table_at,
)


def _kd_sigmas(cfg: SchedulerConfig, num_steps: int):
    """(σ of each step, its train timestep), as JAX's ``_kd_sigmas``."""
    ac = alphas_cumprod(cfg)
    all_sigmas = np.sqrt((1 - ac) / ac)
    ts = select_timesteps(cfg, num_steps)
    sigmas = all_sigmas[ts]
    if cfg.use_karras_sigmas:
        sigmas = karras_respace(sigmas, num_steps)
        # back to (fractional) train timesteps by log-sigma interpolation
        log_all = np.log(all_sigmas)
        ts = np.interp(np.log(sigmas), log_all, np.arange(len(log_all)))
    return sigmas, ts


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler(TableState):
    config: SchedulerConfig = SchedulerConfig()
    ancestral: bool = False
    order: int = 1

    @property
    def needs_noise(self) -> bool:
        return self.ancestral

    def set_timesteps(self, num_steps: int) -> Dict:
        """Host tables: f32 timesteps, the num_steps + 1 sigmas (the last
        0) and ``init_noise_sigma``."""
        sigmas, ts = _kd_sigmas(self.config, num_steps)
        sigmas = np.concatenate([sigmas, [0.0]])
        return {
            "timesteps": np.asarray(ts, np.float32),
            "sigmas": np.asarray(sigmas, np.float32),
            "init_noise_sigma": np.float32(np.sqrt(sigmas[0] ** 2 + 1)),
        }

    def scale_model_input(self, state: Dict, sample: torch.Tensor, i) -> torch.Tensor:
        s = table_at(state["sigmas"], i, sample)
        return (sample.float() / torch.sqrt(s**2 + 1)).to(sample.dtype)

    def add_noise(self, state: Dict, original: torch.Tensor, noise: torch.Tensor, i):
        """Forward-diffuse for img2img's entry in x-space (diffusers'
        ``EulerDiscreteScheduler.add_noise``): ``z + σ_i·noise``, not the
        VP form."""
        return original + table_at(state["sigmas"], i, original) * noise

    def _pred_x0(self, model_output, sample, sigma):
        pt = self.config.prediction_type
        if pt == "epsilon":
            return sample - sigma * model_output
        if pt == "v_prediction":
            return model_output * (-sigma / torch.sqrt(sigma**2 + 1)) + sample / (sigma**2 + 1)
        if pt == "sample":
            return model_output
        raise ValueError(pt)

    def step(
        self, state: Dict, model_output: torch.Tensor, i, sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict]:
        """One Euler step from σ_i to σ_{i+1} (ancestral: down to σ_down,
        then ``sqrt(var)·noise`` back up); returns the new sample in
        ``sample.dtype`` and the state unchanged.  ``i`` is an int or a 0-d
        integer tensor on the sample's device."""
        dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        sigma = table_at(state["sigmas"], i, sample)
        sigma_next = table_at(state["sigmas"], i + 1, sample)
        x0 = self._pred_x0(model_output, sample, sigma)
        d = (sample - x0) / sigma
        if self.ancestral:
            if noise is None:
                raise ValueError("ancestral Euler requires noise")
            var = sigma_next**2 * (sigma**2 - sigma_next**2) / sigma**2
            sigma_down = torch.sqrt(torch.clamp(sigma_next**2 - var, min=0.0))
            prev = sample + (sigma_down - sigma) * d
            prev = prev + torch.sqrt(var) * noise.float()
        else:
            prev = sample + (sigma_next - sigma) * d
        return prev.to(dtype), state


def EulerAncestralDiscreteScheduler(config: SchedulerConfig = SchedulerConfig()):
    return EulerDiscreteScheduler(config=config, ancestral=True)
