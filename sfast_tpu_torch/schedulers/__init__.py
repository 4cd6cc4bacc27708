"""Schedulers of the port: DPM-Solver++ (2M), and its captured step."""

from sfast_tpu_torch.schedulers.common import SchedulerConfig
from sfast_tpu_torch.schedulers.compile import CompiledScheduler, compile_scheduler
from sfast_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler

__all__ = ["CompiledScheduler", "DPMSolverMultistepScheduler", "SchedulerConfig",
           "compile_scheduler"]
