"""The yardstick of the kernel metrics: the H100's published peaks, the
bound of a call, and the calls of the port's hand-written kernels that a
request makes, reckoned from the configuration's shapes.

A bound is max(operations ÷ 989 TFLOP/s, bytes ÷ 3.35 TB/s): the bf16
tensor-core rate and the HBM rate of an H100 SXM (NVIDIA's data sheet,
dense, at its 700 W limit), with every input byte read once and every
output byte written once.  K1's operations are 4·b·h·s_q·s_kv·d, K2's
2·N·H·W·C_in·C_out·9.

The reckoning follows the port's routes as they stand, copied as rules:
self-attention of head dim d over S tokens goes to K1 where d ≤ 160,
d % 8 == 0 and S ≥ 1024 (d ≤ 64) or S ≥ 2048; the VAE decoder's resnets
and upsample convs at 128² pixels and above go to K2 (two calls a resnet:
conv1 after GroupNorm+SiLU, conv2 with the residual).  A metric compares
the count reckoned here with the launches the program counted and with
the kernel rows of the trace; where they disagree the reckoning is stale
and the metric reads nothing.
"""

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2

K1_MAX_D, K1_SMALL_D, K1_MIN_S_SMALL_D, K1_MIN_S = 160, 64, 1024, 2048
K2_MIN_PIXELS = 128 * 128

# the device kernels each launch that the port counts runs once, by a piece
# of their names in the trace (chip_smoke.py's table)
KERNEL_ROWS = {
    "flash_attention": ("flash_fwd_kernel",),
    "quantize_qkv": ("::stats_kernel(", "::quantize_kernel("),
    "flash_attention_int8": ("flash_int8_kernel",),
    "conv3x3": ("conv3x3_kernel",),
    "group_norm_stats": ("gn_stats_kernel",),
    "group_norm_apply": ("gn_apply_kernel",),
    "group_norm_fused": ("gn_fused_kernel",),
    "linear_geglu": ("geglu_kernel",),
}


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def _levels(cfg: dict):
    from hb.program import per_level

    u = cfg["unet"]
    n = len(u["block_out_channels"])
    return (u, n, per_level(u["attention_head_dim"], n),
            per_level(u.get("transformer_layers_per_block", 1), n))


def k1_calls(cfg: dict, traffic: dict) -> Dict[Tuple[int, int, int, int], int]:
    """{(b, heads, tokens, head dim): calls} of K1 for one request."""
    u, n, heads, depth = _levels(cfg)
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    b = 2 if traffic["guidance_scale"] > 1.0 else 1
    lpb = u["layers_per_block"]
    per_eval: Dict[Tuple[int, int, int, int], int] = {}

    def add(level, blocks):
        c = u["block_out_channels"][level]
        d = c // heads[level]
        s = (traffic["height"] // f // 2**level) * (traffic["width"] // f // 2**level)
        min_s = K1_MIN_S_SMALL_D if d <= K1_SMALL_D else K1_MIN_S
        if d <= K1_MAX_D and d % 8 == 0 and s >= min_s:
            key = (b, heads[level], s, d)
            per_eval[key] = per_eval.get(key, 0) + blocks * depth[level]

    for i, kind in enumerate(u["down_block_types"]):
        if kind.startswith("CrossAttn"):
            add(i, lpb)
    add(n - 1, 1)  # the mid block
    for j, kind in enumerate(u["up_block_types"]):
        if kind.startswith("CrossAttn"):
            add(n - 1 - j, lpb + 1)
    return {k: v * traffic["steps"] for k, v in per_eval.items()}


def k1_bound_s(calls: Dict[Tuple[int, int, int, int], int]) -> float:
    return sum(n * bound_s(4 * b * h * s * s * d, 4 * b * h * s * d * BF16)
               for (b, h, s, d), n in calls.items())


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


def k2_bound_s(calls: Dict[Tuple[int, int, int, int, bool], int]) -> float:
    total = 0.0
    for (px, cin, cout, b, residual), n in calls.items():
        flops = 2 * b * px * cin * cout * 9
        nbytes = (b * px * cin + 9 * cin * cout + b * px * cout * (2 if residual else 1)) * BF16
        total += n * bound_s(flops, nbytes)
    return total
