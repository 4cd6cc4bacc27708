"""EDM Euler scheduler (Karras et al. 2022 preconditioning), the SVD
sampler: sigmas on a Karras rho-ramp, the model wrapped with c_in, c_skip,
c_out and c_noise, deterministic Euler steps.

Counterpart of ``sfast_tpu/schedulers/edm_euler.py``.  The model's
timestep is ``c_noise = 0.25·log σ`` and ``init_noise_sigma`` (in the
state) is σ_max.  Table reads at the step index are gathers
(``common.table_at``), so one captured graph serves every step.

The model predicts v, as SVD checkpoints are trained: c_out = −σ·σ_d /
√(σ² + σ_d²), as diffusers' ``EulerDiscreteScheduler`` with
``prediction_type='v_prediction'`` and generative-models'
``VScalingWithEDMcNoise`` define it.  ``sfast_tpu``'s scheduler takes
Karras' positive c_out; a UNet of negated output steps the same.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from sfast_tpu_torch.schedulers.common import TableState, table_at


@dataclasses.dataclass(frozen=True)
class EDMEulerScheduler(TableState):
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    sigma_data: float = 1.0
    rho: float = 7.0
    order: int = 1

    def set_timesteps(self, num_steps: int) -> Dict:
        ramp = np.linspace(0, 1, num_steps)
        inv = 1.0 / self.rho
        smax, smin = self.sigma_max**inv, self.sigma_min**inv
        sigmas = (smax + ramp * (smin - smax)) ** self.rho
        sigmas = np.concatenate([sigmas, [0.0]])
        return {
            "timesteps": np.asarray(0.25 * np.log(sigmas[:-1]), np.float32),
            "sigmas": np.asarray(sigmas, np.float32),
            "init_noise_sigma": np.float32(sigmas[0]),
        }

    def _c(self, sigma):
        """(c_skip, c_out, c_in) at ``sigma``."""
        sd2 = self.sigma_data**2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = -sigma * self.sigma_data / torch.sqrt(sigma**2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma**2 + sd2)
        return c_skip, c_out, c_in

    def scale_model_input(self, state: Dict, sample: torch.Tensor, i) -> torch.Tensor:
        _, _, c_in = self._c(table_at(state["sigmas"], i, sample))
        return (sample.float() * c_in).to(sample.dtype)

    def step(
        self, state: Dict, model_output: torch.Tensor, i, sample: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict]:
        dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        sigma = table_at(state["sigmas"], i, sample)
        sigma_next = table_at(state["sigmas"], i + 1, sample)
        c_skip, c_out, _ = self._c(sigma)
        denoised = c_skip * sample + c_out * model_output
        d = (sample - denoised) / sigma
        return (sample + (sigma_next - sigma) * d).to(dtype), state
