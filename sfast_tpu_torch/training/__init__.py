"""LoRA training (``lora_trainer.py``): the step, eager or one CUDA graph."""

from sfast_tpu_torch.training.lora_trainer import (
    LoraTrainStep,
    lora_factors,
    lora_training_setup,
    make_lora_train_step,
)

__all__ = ["LoraTrainStep", "lora_factors", "lora_training_setup", "make_lora_train_step"]
