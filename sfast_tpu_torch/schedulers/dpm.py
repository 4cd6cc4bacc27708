"""DPM-Solver++ (2M) multistep scheduler — the 50-step scheduler of the
headline configuration.

Counterpart of ``sfast_tpu/schedulers/dpm.py`` (``:21-135``), with its
fields and defaults (``solver_order=2``, ``lower_order_final=True``).  The
per-step coefficients are f32 numpy scalars computed on the host from the
sigma table, as JAX computes them in f32, and gathered into one table;
``device_state`` uploads it once.  The step reads its row by index, and
selects the order with ``torch.where`` on device flags, JAX's branch-free
form, so that with a 0-d device tensor as the step index one captured
graph serves every step.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from sfast_tpu_torch.schedulers.common import (
    SchedulerConfig,
    alphas_cumprod,
    karras_respace,
    select_timesteps,
    table_at,
)

_SIGMA_FLOOR = 1e-10
# the columns of a step's row of the coefficient table
_RATIO, _A_PHI, _R, _X0_S, _X0_A = range(5)


def _alpha_sigma(kd_sigma: np.float32) -> Tuple[np.float32, np.float32]:
    alpha = np.float32(1.0) / np.sqrt(np.float32(1.0) + kd_sigma * kd_sigma)
    return alpha, kd_sigma * alpha


def coefficients(sigmas: np.ndarray, num_steps: int) -> np.ndarray:
    """(num_steps, 5) f32: per step i, σ_{i+1}/σ_i in VP form (ratio),
    α_{i+1}·expm1(−h), the step ratio r (floored at 1e-20), and the (σ, α)
    of the x0 prediction at σ_i."""
    rows = []
    for i in range(num_steps):
        a_t, st_t = _alpha_sigma(sigmas[i + 1])
        a_s0, st_s0 = _alpha_sigma(sigmas[i])
        a_s1, st_s1 = _alpha_sigma(sigmas[max(i - 1, 0)])
        lam_t = np.log(a_t / st_t)
        lam_s0 = np.log(a_s0 / st_s0)
        lam_s1 = np.log(a_s1 / st_s1)
        h = lam_t - lam_s0
        r = (lam_s0 - lam_s1) / h
        rows.append((st_t / st_s0, a_t * np.expm1(-h), max(r, np.float32(1e-20)), st_s0, a_s0))
    return np.asarray(rows, np.float32).reshape(num_steps, 5)


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistepScheduler:
    config: SchedulerConfig = SchedulerConfig()
    solver_order: int = 2
    lower_order_final: bool = True
    order: int = 1  # pipeline-visible: one model eval per step
    init_noise_sigma: float = 1.0

    def set_timesteps(self, num_steps: int) -> Dict:
        """Host tables: f32 timesteps and the num_steps + 1 sigmas."""
        ac = alphas_cumprod(self.config)
        all_sigmas = np.sqrt((1 - ac) / ac)
        ts = select_timesteps(self.config, num_steps)
        sigmas = all_sigmas[ts]
        if self.config.use_karras_sigmas:
            sigmas = karras_respace(sigmas, num_steps)
            log_all = np.log(all_sigmas)
            ts = np.interp(np.log(sigmas), log_all, np.arange(len(log_all)))
        sigmas = np.concatenate([sigmas, [_SIGMA_FLOOR]])
        return {
            "timesteps": np.asarray(ts, np.float32),
            "sigmas": np.asarray(sigmas, np.float32),
            "x0_prev": None,  # last x0 prediction
            # the first EXECUTED step is first order (img2img enters late)
            "has_history": False,
            "num_steps": num_steps,
        }

    def device_state(self, state: Dict, device) -> Dict:
        """``state`` with its tables on ``device``: the timesteps, the
        sigmas and the coefficient table the step reads."""
        new = dict(state)
        new["timesteps"] = torch.as_tensor(np.asarray(state["timesteps"]), device=device)
        new["sigmas"] = torch.as_tensor(np.asarray(state["sigmas"]), device=device)
        new["table"] = torch.from_numpy(
            coefficients(np.asarray(state["sigmas"]), state["num_steps"])).to(device)
        return new

    def prepare_state(self, state: Dict, sample: torch.Tensor) -> Dict:
        """The state a run of steps on ``sample`` starts from: the tables on
        its device, a latent-shaped f32 ``x0_prev`` and ``has_history`` a
        0-d device bool, so that every step's state has one signature."""
        table = state.get("table")
        new = state if table is not None and table.device == sample.device else \
            self.device_state(state, sample.device)
        new = dict(new)
        new["x0_prev"] = torch.zeros(sample.shape, dtype=torch.float32, device=sample.device)
        new["has_history"] = torch.zeros((), dtype=torch.bool, device=sample.device)
        return new

    def scale_model_input(self, state: Dict, sample: torch.Tensor, i) -> torch.Tensor:
        return sample  # VP-space latents: identity, as init_noise_sigma == 1

    def add_noise(self, state: Dict, original: torch.Tensor, noise: torch.Tensor, i):
        """Forward-diffuse to step ``i`` for img2img's entry (JAX
        ``dpm.py:67-77``, diffusers' ``add_noise``): the latents are
        VP-space, ``alpha·original + sigma·noise`` with (alpha, sigma) from
        the kd sigma of step ``i``.  ``i`` is an int or a 0-d integer
        tensor on the samples' device."""
        kd = table_at(state["sigmas"], i, original)
        alpha = 1.0 / torch.sqrt(1.0 + kd * kd)
        return alpha * original + (kd * alpha) * noise

    def _pred_x0(self, model_output, sample, s, a):
        pt = self.config.prediction_type
        if pt == "epsilon":
            return (sample - s * model_output) / a
        if pt == "v_prediction":
            return a * sample - s * model_output
        if pt == "sample":
            return model_output
        raise ValueError(pt)

    def step(
        self, state: Dict, model_output: torch.Tensor, i, sample: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict]:
        """One solver step from sigma[i] to sigma[i+1]; returns the new
        sample (in ``sample.dtype``) and the new state.  ``i`` is an int or
        a 0-d integer tensor on the sample's device."""
        dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        table = state.get("table")
        if table is None:  # a host state from set_timesteps
            table = torch.from_numpy(
                coefficients(np.asarray(state["sigmas"]), state["num_steps"])).to(sample.device)
        row = table.index_select(0, i.reshape(1))[0] if torch.is_tensor(i) else table[i]
        ratio, a_phi, r = row[_RATIO], row[_A_PHI], row[_R]
        x0 = self._pred_x0(model_output, sample, row[_X0_S], row[_X0_A])
        prev = ratio * sample - a_phi * x0  # first order
        if self.solver_order >= 2:
            has_history = torch.as_tensor(state["has_history"], device=sample.device)
            use_first = ~has_history
            if self.lower_order_final:
                use_first = use_first | (i == state["num_steps"] - 1)
            x0_prev = state["x0_prev"]
            if x0_prev is None:
                x0_prev = torch.zeros_like(x0)
            d1 = (x0 - x0_prev) / r
            prev = torch.where(use_first, prev, ratio * sample - a_phi * (x0 + 0.5 * d1))

        new_state = dict(state)
        new_state["x0_prev"] = x0
        new_state["has_history"] = torch.ones((), dtype=torch.bool, device=sample.device)
        return prev.to(dtype), new_state
