"""LoRA training (``lora_trainer.py``)."""

from sfast_tpu_torch.training.lora_trainer import (
    lora_factors,
    lora_training_setup,
    make_lora_train_step,
)

__all__ = ["lora_factors", "lora_training_setup", "make_lora_train_step"]
