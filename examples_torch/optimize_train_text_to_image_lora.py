#!/usr/bin/env python
"""LoRA text-to-image fine-tuning of SD1.5's UNet — the port's version of
``examples/optimize_train_text_to_image_lora.py`` (same flags).

The step is ``training.make_lora_train_step`` with every op on its plain
PyTorch version (``enable_kernels=False``: no hand-written kernel has a
backward).  On the card it replays the forward, autograd's backward and
AdamW as one CUDA graph (``enable_cuda_graph``, on by default), as JAX's
example jits its step; the first step warms up three times and captures.
``--mesh dp×tp`` trains one process per card under torchrun, the UNet
tensor-parallel over ``tp`` and the batch split over ``dp``:

    torchrun --nproc-per-node 4 examples_torch/optimize_train_text_to_image_lora.py --mesh 2x2

Data loading is left to the caller (pre-encoded latents and text
embeddings); this trains on seeded synthetic data.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from examples_torch import _common  # noqa: E402
from sfast_tpu_torch import CompilationConfig, compile_model  # noqa: E402
from sfast_tpu_torch.models import SD15_UNET, UNet2DConditionModel, init_weights_  # noqa: E402
from sfast_tpu_torch.parallel import make_mesh  # noqa: E402
from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step  # noqa: E402

UNET_CONFIG = SD15_UNET
LATENT_HW = 64  # 512² images
CONTEXT_LEN = 77


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--mesh", default=None, help="e.g. 2x4 for dp=2,tp=4")
    _common.device_arg(p)
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    started = False
    mesh = None
    if args.mesh:
        dp, tp = (int(v) for v in args.mesh.split("x"))
        if not dist.is_initialized():  # torchrun's environment
            if dev.type == "cuda":
                dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(dev)
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            started = True
        mesh = make_mesh((dp, tp), ("dp", "tp"))
    say = print if not dist.is_initialized() or dist.get_rank() == 0 else (lambda *a: None)
    try:
        ccfg = CompilationConfig(enable_kernels=False, mesh=mesh)
        unet = init_weights_(UNet2DConditionModel(UNET_CONFIG, device=dev, dtype=_common.DTYPE),
                             _common.generator(dev, 0))
        unet = compile_model(unet, ccfg, name="unet")
        lora, opt = lora_training_setup(unet, rank=args.rank, learning_rate=args.lr)
        step = make_lora_train_step(unet, opt, ccfg=ccfg)
        g = _common.generator(dev, 1)  # the same draws on every rank
        losses = []
        for i in range(args.steps):
            batch = {"latents": torch.randn((args.batch, LATENT_HW, LATENT_HW, 4), generator=g,
                                            device=dev, dtype=_common.DTYPE),
                     "context": torch.randn((args.batch, CONTEXT_LEN,
                                             UNET_CONFIG.cross_attention_dim), generator=g,
                                            device=dev, dtype=_common.DTYPE)}
            loss, dt = _common.timed(dev, lambda: float(step(lora, batch, g)))
            losses.append(loss)
            say(f"step {i}: loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        return {"losses": losses, "lora": lora}
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
