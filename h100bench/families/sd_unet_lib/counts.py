"""The counts of the ``sd_unet`` family that the whole step's share of the
peak and the kernel rooflines read: the model FLOPs of a request or a
train step, and the calls of the port's hand-written kernels that a
request makes, reckoned from the configuration's shapes.

FLOPs are counted by ``FlopCounterMode`` over the reference on the
``meta`` device (``hb/flops.py``): the same count whatever the program
uses to do the work.

The reckoning follows the port's routes as they stand, copied as rules:
self-attention of head dim d over S tokens goes to K1 (``flash_attention``)
where d ≤ 160, d % 8 == 0 and S ≥ 1024 (d ≤ 64) or S ≥ 2048; the VAE
decoder's resnets and upsample convs at 128² pixels and above go to K2
(``conv3x3``; two calls a resnet: conv1 after GroupNorm+SiLU, conv2 with
the residual).  A metric compares the count reckoned here with the
launches the program counted and with the kernel rows of the trace; where
they disagree the reckoning is stale and the metric reads nothing.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from families.sd_unet_lib.port import per_level
from families.sd_unet_lib.prompts import SEQ
from hb.flops import count

K1_MAX_D, K1_SMALL_D, K1_MIN_S_SMALL_D, K1_MIN_S = 160, 64, 1024, 2048
K2_MIN_PIXELS = 128 * 128


def request_flops(mods: dict, cfg: dict, traffic: dict) -> dict:
    """{'text', 'unet_eval', 'decode', 'request'} FLOPs of one image, from
    the reference modules ``mods`` on ``meta``."""
    meta = torch.device("meta")
    use_cfg = traffic["guidance_scale"] > 1.0
    b = 2 if use_cfg else 1
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    h, w = traffic["height"] // f, traffic["width"] // f
    lc = cfg["vae"]["latent_channels"]
    ids = torch.zeros((1, SEQ), dtype=torch.long, device=meta)
    sdxl = "text_encoder_2" in cfg
    # SD1.5 encodes the uncond prompt too; SDXL's uncond is zeros
    n_text = 2 if use_cfg and not sdxl else 1
    text = n_text * sum(count(lambda m=mods[s]: m(ids)) for s in ("text_encoder",
                                                                   "text_encoder_2") if s in mods)
    ctx_dim = cfg["unet"]["cross_attention_dim"]
    x = torch.zeros((b, lc, h, w), device=meta)
    ctx = torch.zeros((b, SEQ, ctx_dim), device=meta)
    t = torch.zeros((), device=meta)
    added = None
    if sdxl:
        added = {"text_embeds": torch.zeros((b, cfg["text_encoder_2"]["projection_dim"]),
                                            device=meta),
                 "time_ids": torch.zeros((b, 6), device=meta)}
    unet = count(lambda: mods["unet"](x, t, ctx, added))
    decode = count(lambda: mods["vae"].decode(torch.zeros((1, lc, h, w), device=meta)))
    return {"text": text, "unet_eval": unet, "decode": decode,
            "request": text + traffic["steps"] * unet + decode}


def train_step_flops(unet, cfg: dict, traffic: dict) -> int:
    """FLOPs of one LoRA train step of the reference ``unet`` on ``meta``:
    the forward, and the backward that the LoRA factors' gradients need
    (the base weights take none)."""
    from families.sd_unet_lib.training import lora_loss

    meta = torch.device("meta")
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
             "context": torch.zeros((b, SEQ, cfg["unet"]["cross_attention_dim"]), device=meta),
             "t": torch.zeros((b,), dtype=torch.long, device=meta),
             "noise": torch.zeros((b, hw, hw, lc), device=meta)}
    ac = torch.as_tensor(np.zeros(1000, np.float32), device=meta)

    def step():
        lora_loss(unet, state, lora, batch, ac).backward()

    return count(step)


def k1_calls(cfg: dict, traffic: dict) -> Dict[Tuple[int, int, int, int, int], int]:
    """{(b, heads, query tokens, key tokens, head dim): calls} of K1 for
    one request: the UNet's self-attention, whose queries and keys are the
    same tokens."""
    u = cfg["unet"]
    n = len(u["block_out_channels"])
    heads = per_level(u["attention_head_dim"], n)
    depth = per_level(u.get("transformer_layers_per_block", 1), n)
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    b = 2 if traffic["guidance_scale"] > 1.0 else 1
    lpb = u["layers_per_block"]
    per_eval: Dict[Tuple[int, int, int, int, int], int] = {}

    def add(level, blocks):
        c = u["block_out_channels"][level]
        d = c // heads[level]
        s = (traffic["height"] // f // 2**level) * (traffic["width"] // f // 2**level)
        min_s = K1_MIN_S_SMALL_D if d <= K1_SMALL_D else K1_MIN_S
        if d <= K1_MAX_D and d % 8 == 0 and s >= min_s:
            key = (b, heads[level], s, s, d)
            per_eval[key] = per_eval.get(key, 0) + blocks * depth[level]

    for i, kind in enumerate(u["down_block_types"]):
        if kind.startswith("CrossAttn"):
            add(i, lpb)
    add(n - 1, 1)  # the mid block
    for j, kind in enumerate(u["up_block_types"]):
        if kind.startswith("CrossAttn"):
            add(n - 1 - j, lpb + 1)
    return {k: v * traffic["steps"] for k, v in per_eval.items()}


def k2_calls(cfg: dict, traffic: dict) -> Dict[Tuple[int, int, int, int, bool], int]:
    """{(pixels, C_in, C_out, batch, residual): calls} of K2 for one
    request's decode."""
    v = cfg["vae"]
    rev = list(reversed(v["block_out_channels"]))
    f = 2 ** (len(rev) - 1)
    hw = (traffic["height"] // f) * (traffic["width"] // f)
    out: Dict[Tuple[int, int, int, int, bool], int] = {}

    def add(key, k=1):
        out[key] = out.get(key, 0) + k

    def resnet(px, cin, cout):
        if px >= K2_MIN_PIXELS:
            add((px, cin, cout, 1, False))
            add((px, cout, cout, 1, True))

    for _ in range(2):  # the mid block's resnets, at the latents' size
        resnet(hw, rev[0], rev[0])
    c_prev = rev[0]
    for i, c in enumerate(rev):
        for j in range(v["layers_per_block"] + 1):
            resnet(hw, c_prev if j == 0 else c, c)
        c_prev = c
        if i < len(rev) - 1:
            hw *= 4
            if hw >= K2_MIN_PIXELS:
                add((hw, c, c, 1, False))
    return out
