"""Tiny configurations and traffic of the same shape as the cells', for
the CPU tests."""

import copy
import time
from pathlib import Path

import torch

SD = {
    "name": "tiny_sd", "pipeline": "StableDiffusionPipeline", "dtype": "float32",
    "unet": {"attention_head_dim": 4, "block_out_channels": [32, 64], "cross_attention_dim": 32,
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "in_channels": 4,
             "out_channels": 4, "layers_per_block": 1, "norm_num_groups": 8, "sample_size": 8,
             "flip_sin_to_cos": True, "freq_shift": 0},
    "vae": {"block_out_channels": [32, 64], "in_channels": 3, "out_channels": 3,
            "latent_channels": 4, "layers_per_block": 1, "norm_num_groups": 8,
            "scaling_factor": 0.18215},
    "text_encoder": {"architectures": ["CLIPTextModel"], "hidden_act": "quick_gelu",
                     "hidden_size": 32, "intermediate_size": 64, "max_position_embeddings": 77,
                     "num_attention_heads": 4, "num_hidden_layers": 2, "vocab_size": 49408,
                     "eos_token_id": 49407, "pad_token_id": 49407, "projection_dim": 32,
                     "output": "last"},
}

XL = copy.deepcopy(SD)
XL["name"], XL["pipeline"] = "tiny_xl", "StableDiffusionXLPipeline"
XL["unet"].update({
    "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "attention_head_dim": [2, 4], "transformer_layers_per_block": [1, 2],
    "cross_attention_dim": 64, "projection_class_embeddings_input_dim": 32 + 6 * 8,
    "use_linear_projection": True, "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "UpBlock2D"]})
XL["text_encoder"]["output"] = "penultimate"
XL["text_encoder_2"] = dict(SD["text_encoder"], architectures=["CLIPTextModelWithProjection"],
                            hidden_act="gelu", pad_token_id=0, output="penultimate_pooled")

DPM = {"call": "call", "scheduler": "DPMSolverMultistepScheduler", "steps": 4,
       "guidance_scale": 7.5, "height": 64, "width": 64, "check_requests": 2,
       "trace_requests": 1}
EULER = dict(DPM, scheduler="EulerDiscreteScheduler", steps=3, guidance_scale=5.0)
LCM_MAP = {"call": "map", "window": 2, "scheduler": "LCMScheduler", "steps": 4,
           "guidance_scale": 1.0, "height": 64, "width": 64, "check_requests": 3,
           "trace_requests": 2}
TRAIN = {"call": "train", "batch": 4, "latent_hw": 8, "rank": 4, "learning_rate": 1e-4,
         "kernels": False, "pool_steps": 8, "trace_steps": 2}


def cell(cfg, traffic, seed=2**31 + 12345, seconds=0.5):
    """A cell on the CPU in this checkout, as a run makes it: the program's
    build directory is the checkout's (nothing is built without a card)."""
    from hb.drive import Cell

    return Cell("tiny", cfg, traffic, seed, seconds, False, torch.device("cpu"),
                Path(__file__).resolve().parents[2], time.perf_counter())
