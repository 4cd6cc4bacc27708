"""DDIM scheduler (eta = 0, deterministic).

Counterpart of ``sfast_tpu/schedulers/ddim.py``: per step the VP
``alpha_t`` / ``sigma_t`` of its timestep, extended with the clean point
(1, 0); a step predicts x0 and eps and moves to the next step's pair.
Table reads at the step index are gathers (``common.table_at``), so one
captured graph serves every step.  img2img's forward diffusion is
``common.add_noise`` (the VP form), as in JAX.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from sfast_tpu_torch.schedulers.common import (
    SchedulerConfig,
    TableState,
    alphas_cumprod,
    predicted_eps,
    predicted_x0,
    select_timesteps,
    table_at,
)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler(TableState):
    config: SchedulerConfig = SchedulerConfig()
    order: int = 1

    @property
    def init_noise_sigma(self) -> float:
        return 1.0  # VP-space latents

    def set_timesteps(self, num_steps: int) -> Dict:
        ac = alphas_cumprod(self.config)
        ts = select_timesteps(self.config, num_steps)
        a = np.concatenate([np.sqrt(ac[ts]), [1.0]])
        s = np.concatenate([np.sqrt(1.0 - ac[ts]), [0.0]])
        return {
            "timesteps": np.asarray(ts, np.float32),
            "alpha_t": np.asarray(a, np.float32),
            "sigma_t": np.asarray(s, np.float32),
        }

    def scale_model_input(self, state: Dict, sample: torch.Tensor, i) -> torch.Tensor:
        return sample

    def step(
        self, state: Dict, model_output: torch.Tensor, i, sample: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict]:
        dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        a_t, s_t = (table_at(state[k], i, sample) for k in ("alpha_t", "sigma_t"))
        a_p, s_p = (table_at(state[k], i + 1, sample) for k in ("alpha_t", "sigma_t"))
        x0 = predicted_x0(self.config, model_output, sample, a_t, s_t)
        eps = predicted_eps(self.config, model_output, sample, a_t, s_t)
        return (a_p * x0 + s_p * eps).to(dtype), state
