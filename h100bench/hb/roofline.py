"""The yardstick of the kernel metrics: the H100's published peaks, and the
bound of each port kernel's calls by their shapes.

A bound is max(operations ÷ 989 TFLOP/s, bytes ÷ 3.35 TB/s): the bf16
tensor-core rate and the HBM rate of an H100 SXM (NVIDIA's data sheet,
dense, at its 700 W limit), with every input byte read once and every
output byte written once.  K1's operations are 4·b·h·s_q·s_kv·d, K2's
2·N·H·W·C_in·C_out·9.

How many calls of which shape a request makes is its family's reckoning
(``kernel_calls`` of ``families/<family>.py``), by the kernel names of
:data:`KERNEL_ROWS`.
"""

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2

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


def k1_bound_s(calls: Dict[Tuple[int, int, int, int, int], int]) -> float:
    """Σ bound of K1's calls {(b, heads, s_q, s_kv, head dim): calls}: q and
    the output s_q rows, k and v s_kv rows, of b·heads·d bf16 each."""
    return sum(n * bound_s(4 * b * h * sq * skv * d, 2 * b * h * (sq + skv) * d * BF16)
               for (b, h, sq, skv, d), n in calls.items())


def k2_bound_s(calls: Dict[Tuple[int, int, int, int, bool], int]) -> float:
    """Σ bound of K2's calls {(pixels, C_in, C_out, batch, residual): calls}."""
    total = 0.0
    for (px, cin, cout, b, residual), n in calls.items():
        flops = 2 * b * px * cin * cout * 9
        nbytes = (b * px * cin + 9 * cin * cout + b * px * cout * (2 if residual else 1)) * BF16
        total += n * bound_s(flops, nbytes)
    return total


# each kernel's bound by its calls, for the kernels a roofline metric reads
BOUNDS = {"flash_attention": k1_bound_s, "conv3x3": k2_bound_s}
