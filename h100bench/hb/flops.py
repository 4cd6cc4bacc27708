"""Model FLOPs of one request or one train step, counted once a cell by
``torch.utils.flop_counter.FlopCounterMode`` over the reference on the
``meta`` device: the same count whatever the program uses to do the work,
so that the whole step's share of the peak still bounds a later PR's gain
after a kernel is taken off the path."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from hb import inputs
from hb.program import reference_modules


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def request_flops(cfg: dict, traffic: dict) -> dict:
    """{'text', 'unet_eval', 'decode', 'request'} FLOPs of one image."""
    mods = reference_modules(cfg)
    meta = torch.device("meta")
    use_cfg = traffic["guidance_scale"] > 1.0
    b = 2 if use_cfg else 1
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    h, w = traffic["height"] // f, traffic["width"] // f
    lc = cfg["vae"]["latent_channels"]
    ids = torch.zeros((1, inputs.SEQ), dtype=torch.long, device=meta)
    sdxl = "text_encoder_2" in cfg
    # SD1.5 encodes the uncond prompt too; SDXL's uncond is zeros
    n_text = 2 if use_cfg and not sdxl else 1
    text = n_text * sum(_count(lambda m=mods[s]: m(ids)) for s in ("text_encoder",
                                                                    "text_encoder_2") if s in mods)
    ctx_dim = cfg["unet"]["cross_attention_dim"]
    x = torch.zeros((b, lc, h, w), device=meta)
    ctx = torch.zeros((b, inputs.SEQ, ctx_dim), device=meta)
    t = torch.zeros((), device=meta)
    added = None
    if sdxl:
        added = {"text_embeds": torch.zeros((b, cfg["text_encoder_2"]["projection_dim"]),
                                            device=meta),
                 "time_ids": torch.zeros((b, 6), device=meta)}
    unet = _count(lambda: mods["unet"](x, t, ctx, added))
    decode = _count(lambda: mods["vae"].decode(torch.zeros((1, lc, h, w), device=meta)))
    return {"text": text, "unet_eval": unet, "decode": decode,
            "request": text + traffic["steps"] * unet + decode}


def train_step_flops(cfg: dict, traffic: dict) -> int:
    """FLOPs of one LoRA train step: the forward, and the backward that the
    LoRA factors' gradients need (the base weights take none)."""
    from hb.ref_training import lora_loss

    mods = reference_modules(cfg)
    meta = torch.device("meta")
    unet = mods["unet"]
    rank, b, hw = traffic["rank"], traffic["batch"], traffic["latent_hw"]
    lc = cfg["vae"]["latent_channels"]
    lora = {}
    state = unet.state_dict()
    for mod in sorted(k[:-len(".weight")] for k in state if k.endswith(
            (".to_q.weight", ".to_k.weight", ".to_v.weight", ".to_out.0.weight"))):
        dout, din = state[mod + ".weight"].shape
        lora[mod] = {"a": torch.zeros((din, rank), device=meta, requires_grad=True),
                     "b": torch.zeros((rank, dout), device=meta, requires_grad=True)}
    batch = {"latents": torch.zeros((b, hw, hw, lc), device=meta),
             "context": torch.zeros((b, inputs.SEQ, cfg["unet"]["cross_attention_dim"]),
                                    device=meta),
             "t": torch.zeros((b,), dtype=torch.long, device=meta),
             "noise": torch.zeros((b, hw, hw, lc), device=meta)}
    ac = torch.as_tensor(np.zeros(1000, np.float32), device=meta)

    def step():
        lora_loss(unet, state, lora, batch, ac).backward()

    return _count(step)
