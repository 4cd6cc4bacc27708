"""Schedulers of the port: DPM-Solver++ (2M), Euler (and ancestral), DDIM,
EDM Euler and LCM, and their captured step."""

from sfast_tpu_torch.schedulers.common import SchedulerConfig
from sfast_tpu_torch.schedulers.compile import CompiledScheduler, compile_scheduler
from sfast_tpu_torch.schedulers.ddim import DDIMScheduler
from sfast_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler
from sfast_tpu_torch.schedulers.edm_euler import EDMEulerScheduler
from sfast_tpu_torch.schedulers.euler import (
    EulerAncestralDiscreteScheduler,
    EulerDiscreteScheduler,
)
from sfast_tpu_torch.schedulers.lcm import LCMScheduler

__all__ = [
    "CompiledScheduler", "DDIMScheduler", "DPMSolverMultistepScheduler", "EDMEulerScheduler",
    "EulerAncestralDiscreteScheduler", "EulerDiscreteScheduler", "LCMScheduler",
    "SchedulerConfig", "compile_scheduler",
]
