"""The counts of the ``svd`` family that the whole step's share of the peak
and the kernel rooflines read: the model FLOPs of one clip, and the calls
of the port's hand-written kernels that one clip makes, reckoned from the
cell's shapes.

FLOPs are counted by ``FlopCounterMode`` over the reference on the
``meta`` device (``hb/flops.py``): the same count whatever the program
uses to do the work.

The reckoning follows the port's routes as they stand, the same rules as
the ``sd_unet`` family's (its constants are imported): the UNet's spatial
self-attention of head dim d over S tokens goes to K1 where d ≤ 160, d % 8
== 0 and S ≥ 1024 (d ≤ 64) or S ≥ 2048, at the CFG batch of 2 × frames;
the temporal attentions (S = frames), the cross-attentions (one image
token) and the shorter levels do not.  A spatial resnet of the VAE (the
encoder's on the conditioning image, the temporal decoder's on a chunk of
frames) at 128² pixels and above is two K2 calls (conv1 after
GroupNorm+SiLU, conv2 with the residual), and so is each decoder upsample
conv at that size, at the batch of the chunk.
"""

from typing import Dict, Tuple

import torch

from families.sd_unet_lib.counts import (
    K1_MAX_D,
    K1_MIN_S,
    K1_MIN_S_SMALL_D,
    K1_SMALL_D,
    K2_MIN_PIXELS,
)
from families.sd_unet_lib.port import per_level
from hb.flops import count


def chunks(frames: int, chunk: int) -> list:
    """The frames of each decode call."""
    return [min(chunk, frames - s) for s in range(0, frames, chunk)]


def latent_hw(cfg: dict, traffic: dict) -> Tuple[int, int]:
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return traffic["height"] // f, traffic["width"] // f


def request_flops(mods: dict, cfg: dict, traffic: dict) -> dict:
    """{'image_encoder', 'vae_encode', 'unet_eval', 'decode', 'request'}
    FLOPs of one clip, from the reference modules ``mods`` on ``meta``."""
    meta = torch.device("meta")
    tr, u = traffic, cfg["unet"]
    frames = tr["frames"]
    h, w = latent_hw(cfg, tr)
    lc = cfg["vae"]["latent_channels"]
    side = cfg["image_encoder"]["image_size"]
    enc = count(lambda: mods["image_encoder"](torch.zeros((1, 3, side, side), device=meta)))
    vae_encode = count(lambda: mods["vae"].encode(
        torch.zeros((1, 3, tr["height"], tr["width"]), device=meta)))
    x = torch.zeros((2, frames, u["in_channels"], h, w), device=meta)
    ctx = torch.zeros((2, 1, u["cross_attention_dim"]), device=meta)
    ids = torch.zeros((2, 3), device=meta)
    unet = count(lambda: mods["unet"](x, torch.zeros((), device=meta), ctx, ids))
    decode = sum(count(lambda k=k: mods["vae"].decode(torch.zeros((k, lc, h, w), device=meta),
                                                      num_frames=k))
                 for k in chunks(frames, tr["decode_chunk_size"]))
    return {"image_encoder": enc, "vae_encode": vae_encode, "unet_eval": unet, "decode": decode,
            "request": enc + vae_encode + tr["steps"] * unet + decode}


def k1_calls(cfg: dict, traffic: dict) -> Dict[Tuple[int, int, int, int, int], int]:
    """{(b, heads, query tokens, key tokens, head dim): calls} of K1 for
    one clip: the UNet's spatial self-attentions."""
    u = cfg["unet"]
    boc = u["block_out_channels"]
    n = len(boc)
    heads = per_level(u["num_attention_heads"], n)
    depth = per_level(u.get("transformer_layers_per_block", 1), n)
    h, w = latent_hw(cfg, traffic)
    b = 2 * traffic["frames"]
    lpb = u["layers_per_block"]
    per_eval: Dict[Tuple[int, int, int, int, int], int] = {}

    def add(level, blocks):
        d = boc[level] // heads[level]
        s = (h // 2**level) * (w // 2**level)
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
    """{(pixels, C_in, C_out, batch, residual): calls} of K2 for one clip:
    the conditioning image's encode, then each decoded chunk."""
    v = cfg["vae"]
    boc, lpb = v["block_out_channels"], v["layers_per_block"]
    out: Dict[Tuple[int, int, int, int, bool], int] = {}

    def add(key, k=1):
        out[key] = out.get(key, 0) + k

    def resnet(px, cin, cout, batch, k=1):
        if px >= K2_MIN_PIXELS:
            add((px, cin, cout, batch, False), k)
            add((px, cout, cout, batch, True), k)

    px, c_prev = traffic["height"] * traffic["width"], boc[0]
    for i, c in enumerate(boc):  # the encoder, batch 1
        for j in range(lpb):
            resnet(px, c_prev if j == 0 else c, c, 1)
        c_prev = c
        if i < len(boc) - 1:
            px //= 4
    h, w = latent_hw(cfg, traffic)
    rev = list(reversed(boc))
    for k in chunks(traffic["frames"], traffic["decode_chunk_size"]):
        px, c_prev = h * w, rev[0]
        for _ in range(lpb):  # the mid block's resnets, at the latents' size
            resnet(px, rev[0], rev[0], k)
        for i, c in enumerate(rev):
            for j in range(lpb + 1):
                resnet(px, c_prev if j == 0 else c, c, k)
            c_prev = c
            if i < len(rev) - 1:
                px *= 4
                if px >= K2_MIN_PIXELS:
                    add((px, c, c, k, False))
    return out
