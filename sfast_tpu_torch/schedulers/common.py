"""Scheduler tables (diffusers semantics): betas, ᾱ, timestep spacing and
Karras respacing.

Counterpart of ``sfast_tpu/schedulers/common.py``; these are host-side
numpy tables computed once per ``set_timesteps``, identical to JAX's, the
x0 / eps conversions of the VP schedulers (DDIM), the upload of a host
state's tables (``device_state``), and the forward diffusion of img2img's
entry for schedulers whose state holds VP ``alpha_t`` / ``sigma_t``
tables.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # 'linear' | 'scaled_linear' | 'squaredcos_cap_v2'
    prediction_type: str = "epsilon"  # 'epsilon' | 'v_prediction' | 'sample'
    timestep_spacing: str = "leading"  # 'leading' | 'trailing' | 'linspace'
    steps_offset: int = 1
    use_karras_sigmas: bool = False


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(n + 1, dtype=np.float64) / n

        def bar(u):
            return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

        return np.clip(1 - bar(t[1:]) / bar(t[:-1]), 0, 0.999)
    raise ValueError(cfg.beta_schedule)


def alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(cfg))


def select_timesteps(cfg: SchedulerConfig, num_steps: int) -> np.ndarray:
    """Integer train-timestep indices for ``num_steps`` steps, descending."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        ratio = n // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
        return ts + cfg.steps_offset
    if cfg.timestep_spacing == "trailing":
        return np.round(np.arange(n, 0, -n / num_steps)).astype(np.int64) - 1
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, n - 1, num_steps).round()[::-1].astype(np.int64)
    raise ValueError(cfg.timestep_spacing)


def karras_respace(sigmas: np.ndarray, num_steps: int, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) sigmas between the discrete schedule's min and max."""
    smin, smax = sigmas[sigmas > 0].min(), sigmas.max()
    ramp = np.linspace(0, 1, num_steps)
    inv_rho = 1.0 / rho
    return (smax**inv_rho + ramp * (smin**inv_rho - smax**inv_rho)) ** rho


def table_at(table, i, like: torch.Tensor) -> torch.Tensor:
    """``table[i]`` as a 0-d f32 tensor on ``like``'s device.  ``i`` is an
    int or a 0-d integer tensor on that device, read there by a gather, so
    that a device index costs no host sync."""
    table = torch.as_tensor(table, dtype=torch.float32, device=like.device)
    if torch.is_tensor(i):
        return table.index_select(0, i.reshape(1).to(like.device))[0]
    return table[i]


def predicted_x0(cfg: SchedulerConfig, model_output, sample, alpha_t, sigma_t):
    """The x0 prediction of a model output, given
    ``x_t = alpha_t·x0 + sigma_t·noise``."""
    if cfg.prediction_type == "epsilon":
        return (sample - sigma_t * model_output) / alpha_t
    if cfg.prediction_type == "v_prediction":
        return alpha_t * sample - sigma_t * model_output
    if cfg.prediction_type == "sample":
        return model_output
    raise ValueError(cfg.prediction_type)


def predicted_eps(cfg: SchedulerConfig, model_output, sample, alpha_t, sigma_t):
    if cfg.prediction_type == "epsilon":
        return model_output
    if cfg.prediction_type == "v_prediction":
        return sigma_t * sample + alpha_t * model_output
    if cfg.prediction_type == "sample":
        return (sample - alpha_t * model_output) / sigma_t
    raise ValueError(cfg.prediction_type)


def device_state(state: dict, device) -> dict:
    """``state`` with every table on ``device``: numpy arrays and scalars
    as f32 tensors (a 0-d one for a scalar), tensors moved; ints stay.  A
    step then reads its tables by a gather at a device step index, and a
    graph takes them as inputs."""
    new = dict(state)
    for k, v in state.items():
        if isinstance(v, (np.ndarray, np.floating)):
            new[k] = torch.as_tensor(np.asarray(v, np.float32), device=device)
        elif torch.is_tensor(v):
            new[k] = v.to(device)
    return new


def on_device(state: dict, like: torch.Tensor) -> dict:
    """``state`` itself when every table of it lies on ``like``'s device,
    else :func:`device_state` of it there."""
    if all(torch.is_tensor(v) and v.device == like.device for v in state.values()
           if torch.is_tensor(v) or isinstance(v, (np.ndarray, np.floating))):
        return state
    return device_state(state, like.device)


class TableState:
    """``device_state`` / ``prepare_state`` of a scheduler whose state is
    its tables alone (Euler, DDIM, EDM Euler, LCM): uploaded once, and
    nothing shaped like the latents."""

    def device_state(self, state: dict, device) -> dict:
        return device_state(state, device)

    def prepare_state(self, state: dict, sample: torch.Tensor) -> dict:
        return on_device(state, sample)


def add_noise(state, original: torch.Tensor, noise: torch.Tensor, timestep_index):
    """Forward-diffuse clean samples to inference step ``timestep_index``
    (img2img's entry): ``alpha_t·original + sigma_t·noise``."""
    a = table_at(state["alpha_t"], timestep_index, original)
    s = table_at(state["sigma_t"], timestep_index, original)
    return a * original + s * noise
