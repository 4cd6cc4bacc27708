"""LCM scheduler (Latent Consistency Models, 1-8 step inference).

Counterpart of ``sfast_tpu/schedulers/lcm.py`` (``:17-89``): LCM's
distilled timestep grid, a consistency step to the denoised sample, then
every step but the last re-noised to the next timestep with the step's
noise (``needs_noise``: the pipeline draws the noise of every step before
the loop and passes it as ``noise=``).  The last-step choice is a
``torch.where`` on a device comparison when the step index is a device
tensor, so that one captured graph serves every step; a Python ``if``
there would bake the capture step's branch into it.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sfast_tpu_torch.schedulers.common import (
    SchedulerConfig,
    TableState,
    alphas_cumprod,
    predicted_x0,
    table_at,
)


@dataclasses.dataclass(frozen=True)
class LCMScheduler(TableState):
    config: SchedulerConfig = SchedulerConfig()
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
    order: int = 1
    needs_noise: bool = True

    @property
    def init_noise_sigma(self) -> float:
        return 1.0  # VP-space latents

    def set_timesteps(self, num_steps: int) -> Dict:
        n = self.config.num_train_timesteps
        k = n // self.original_inference_steps
        # LCM's distilled timestep grid, then an even subset of num_steps
        lcm_origin = np.asarray(range(1, self.original_inference_steps + 1)) * k - 1
        skip = len(lcm_origin) // num_steps
        ts = lcm_origin[::-1][::skip][:num_steps]
        ac = alphas_cumprod(self.config)
        a, s = np.sqrt(ac[ts]), np.sqrt(1 - ac[ts])
        # the next step's pair (toward clean); after the last, clean
        return {
            "timesteps": np.asarray(ts, np.float32),
            "alpha_t": np.asarray(a, np.float32),
            "sigma_t": np.asarray(s, np.float32),
            "alpha_prev": np.asarray(np.concatenate([a[1:], [1.0]]), np.float32),
            "sigma_prev": np.asarray(np.concatenate([s[1:], [0.0]]), np.float32),
            "num_steps": num_steps,
        }

    def scale_model_input(self, state: Dict, sample: torch.Tensor, i) -> torch.Tensor:
        return sample

    def _boundary(self, t):
        s = t * self.timestep_scaling
        c_skip = self.sigma_data**2 / (s**2 + self.sigma_data**2)
        c_out = s / torch.sqrt(s**2 + self.sigma_data**2)
        return c_skip, c_out

    def step(
        self, state: Dict, model_output: torch.Tensor, i, sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict]:
        """One consistency step at step ``i`` (an int or a 0-d integer
        tensor on the sample's device); ``noise`` re-noises to step
        ``i + 1`` (zeros when None)."""
        dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        a_t, s_t, t = (table_at(state[k], i, sample) for k in ("alpha_t", "sigma_t", "timesteps"))
        x0 = predicted_x0(self.config, model_output, sample, a_t, s_t)
        c_skip, c_out = self._boundary(t)
        denoised = c_out * x0 + c_skip * sample
        a_p, s_p = (table_at(state[k], i, sample) for k in ("alpha_prev", "sigma_prev"))
        if noise is None:
            noise = torch.zeros_like(sample)
        renoised = a_p * denoised + s_p * noise.float()
        is_last = i == state["num_steps"] - 1
        if torch.is_tensor(is_last):
            prev = torch.where(is_last, denoised, renoised)
        else:  # an int index: this step's branch, as in a captured loop's own step
            prev = denoised if is_last else renoised
        return prev.to(dtype), state
