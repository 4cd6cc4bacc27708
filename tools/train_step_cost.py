#!/usr/bin/env python3
"""The work of one LoRA train step of SD1.5's UNet, counted, not timed.

    python3 tools/train_step_cost.py [BATCH]

Runs ``sfast_tpu_torch.training``'s step (``enable_kernels=False``, the
route that trains) on the ``meta`` device, where tensors have shapes but
no storage: nothing is computed and no memory is taken, so it runs
anywhere in seconds.  ``torch.utils.flop_counter.FlopCounterMode`` counts
the matmul and conv FLOPs of the forward and the backward pass; the
materialized level-0 self-attention scores (B·heads·4096² f32 at each of
the 5 blocks) are counted from the shapes.  The UNet's forward alone is
counted too: the backward takes weight gradients only at the LoRA's
target linears, so a step is less than three forwards.  It prints one
JSON object:
the FLOPs, the score bytes, and the least time an H100 could take for
each at the dense bf16 rate and memory rate that ``chip_smoke.py``
holds its kernels against, the figures a step time is held against.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from chip_smoke import HBM_BYTES_PER_S, PEAK_BF16  # noqa: E402


def main(batch: int = 4) -> dict:
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import SD15_UNET, UNet2DConditionModel
    from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step

    meta = torch.device("meta")
    unet = UNet2DConditionModel(SD15_UNET, device=meta, dtype=torch.bfloat16)
    lora, opt = lora_training_setup(unet, rank=4, generator=torch.Generator())
    step = make_lora_train_step(unet, opt, ccfg=CompilationConfig(enable_kernels=False))
    hw = SD15_UNET.sample_size
    batch_ = {"latents": torch.empty((batch, hw, hw, 4), device=meta),
              "context": torch.empty((batch, 77, SD15_UNET.cross_attention_dim), device=meta)}
    t = torch.zeros((batch,), dtype=torch.long, device=meta)
    noise = torch.empty((batch, hw, hw, 4), device=meta)
    with FlopCounterMode(display=False) as counter:
        step(lora, batch_, t=t, noise=noise)
    flops = counter.get_total_flops()
    unet.compilation_config = CompilationConfig(enable_kernels=False)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        unet(batch_["latents"], t.float(), batch_["context"])
    forward = counter.get_total_flops()
    score_bytes = 5 * batch * SD15_UNET.num_heads[0] * (hw * hw) ** 2 * 4
    return {"batch": batch, "forward_flops": forward, "train_step_flops": flops,
            "flops_bound_ms": flops / PEAK_BF16 * 1e3,
            "level0_scores_f32_bytes_each": score_bytes // 5,
            "level0_scores_f32_bytes": score_bytes,
            "one_pass_over_scores_ms": score_bytes / HBM_BYTES_PER_S * 1e3}


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)))
