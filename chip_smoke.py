#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sfast_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   the torch / CUDA versions;
2. build the hand-written kernels from ``sfast_tpu_torch/csrc`` (nvcc, into
   ``build/sfast_tpu_torch/``) and print the build seconds;
3. hold each kernel against its plain PyTorch version in bf16 at the shapes
   the main path gives it, and time both: CUDA events around one call,
   and the device time of its kernels (torch.profiler); time beside it the
   one PyTorch call that computes the same function where there is one
   (``library_ms``), and state its bound (``bound_ms``: operations over
   the peak rate against bytes over the memory rate) and the share of it
   reached.  K6 is timed whole and as its two parts, the pre-processing
   (``quantize_qkv``) and the body, beside K1 at the same shape; the fused
   GroupNorm beside K3+K5 and the library GroupNorm at every UNet
   GroupNorm shape, with both routes' sums over one UNet eval; SDXL's
   opt-in shapes (K2 and K3 on the UNet's 128² resnets, its 46 GroupNorms
   an eval, K4 at its two GEMMs, K6 at head dim 64); and the int8 products
   of the quantized paths (``torch._int_mm`` and the W8A8 conv's im2col on
   it, library calls: JAX computes them with XLA ops) at the largest
   linear and conv sites of SD1.5 and SDXL, int32 equal to their plain
   versions, timed beside the bf16 call they replace;
4. run SD1.5 text2img at full width with seeded random weights — 512²,
   batch 1, DPM++ 50 steps, CFG 7.5 — through ``StableDiffusionPipeline``
   after ``sfast_tpu_torch.compile``, twice: eager (``enable_cuda_graph``
   off) and graphed (the default: a CUDA graph per signature for CLIP,
   the UNet, the DPM++ step and the VAE decode).  Each run captures its
   graphs in a first image and prints them with their capture and
   instantiate seconds and the host time of one ``replay()``, then counts
   the kernel launches of one image, times 3 more (1 eager), keeps the
   latents and image of fixed initial latents, and profiles one more
   (device time, the device's idle share of the timed images' median
   and the count of CUDA kernels an image launches; a trace whose rows
   of the port's kernels disagree with the counted launches is taken
   again), with its peak memory and the
   card's clocks, power and temperature during the timed images.  The
   graphed image is held against the eager one (within 1 uint8 level), and
   with the graphs in place one UNet eval and one VAE decode against the
   plain route, which must launch no kernel;
5. the same under the opt-in kernel configuration
   (``enable_fused_group_norm``, ``enable_fused_linear_geglu``,
   ``enable_int8_attention``), which takes the fused GroupNorm (the
   counterpart of K3′+K5), K4 and K6 in the UNet;
6. the default kernels with ``fuse_denoising_loop``: the 50 steps as one
   graph, its node count and instantiate seconds, held against phase 4's
   eager image (1 timed image, not profiled: its device time is
   the stepwise graphs');
7. img2img and inpainting (right half repainted) of a seeded uint8 image at
   strength 0.8, graphed (the VAE encode one more graph; inpainting not
   profiled), each held against one eager image; one VAE encode on the
   kernel route against the plain route, which must launch no kernel.  Phase 3 holds K2 and K3 at the
   encoder's shapes too (conv1 widening 128→256 at 256², 256→512 at 128²);
8. a seeded rank-8 LoRA on every UNet attention projection, swapped into
   the captured graphs (``lora.switch_lora``) on the stepwise path and the
   fused loop: the image changes, no graph is captured, one UNet eval
   equals the eager module's, and swapping back restores the base image bit
   for bit;
9. a prompt string through the CLIP tokenizer (a byte-level vocabulary
   written to a temporary directory) to one graphed image;
10. SDXL at full width with seeded random weights — UNet 320/640/1280 at
    transformer depth 1/2/10, CLIP ViT-L and OpenCLIP ViT-bigG, the VAE
    at 1024² — through ``StableDiffusionXLPipeline``: 1024², batch 1,
    Euler 30 steps, CFG 5.0.  One eager image, then graphed as phase 4
    (capture, count, 1 timed, not profiled), the fused loop against the
    stepwise graphs (not profiled), one UNet eval and one VAE decode on
    the kernel route against the plain route, img2img at strength 0.8
    graphed against eager (not profiled), and the plain routes this path
    keeps (the cross-attention at 77
    keys, the VAE's 16,384-token mid-block attention) timed alone; one
    counted and timed image (not profiled) under the opt-in configuration
    and one with ``enable_fused_conv`` added (K2 and K3 on the UNet's 128² resnets), the
    latter's UNet eval and decode on the kernel route against the plain
    route; a rank-8 LoRA swapped into the stepwise graphs (nothing
    captured, swapped back bit for bit).  Phase 3 holds K1 at head dim 64
    and K2 and K3 at the 1024² VAE shapes;
11. the other schedulers on phase 4's SD1.5 pipeline: LCM 4 steps at
    guidance 1 (its noise drawn before the loop), graphed and as the fused
    loop, each bit for bit against eager, and two seeds apart; an
    LCM-distilled UNet (``time_cond_proj_dim=256``) at guidance 8, graphed
    against eager; ancestral Euler and DDIM at 50 steps, graphed against
    eager; LCM with TAESD (``AutoencoderTiny``) in both VAE slots, graphed
    and fused bit for bit against eager, its e2e against the KL-decoded LCM
    image, TAESD's graphed decode and encode at 512², one img2img image;
12. ControlNet and IP-Adapter on phase 4's SD1.5 modules with a full-width
    ``SD15_CONTROLNET`` (its zero convs drawn at the init scale times
    ``CN_ZERO_CONV_SCALE``, as a trained ControlNet's are nonzero): 512²,
    DPM++ 30 steps, CFG 7.5, control scale 0.8 on a seeded uint8 control
    image (JAX's tracked configuration).  One eager image; graphed stepwise
    (capture, count, 3 timed, profiled) and the fused loop (not profiled),
    each against eager; with the graphs in place one ControlNet eval on the kernel route
    against the plain route, control scale 0 against the no-control image
    bit for bit, and a second scale that captures nothing.  The ViT-H image
    encoder (``compile_model``) graphed against eager; IP-Adapter tokens
    (4, scale 0.6) with IP scale 0 against the no-IP image; one ControlNet +
    IP image graphed against eager (not profiled); one counted image of the ControlNet path
    under the opt-in configuration; a LoRA swapped into the ``controlnet``
    slot; calibrated static W8A8 of the UNet (a fresh copy) and the
    ControlNet, with convs, counted and timed against bf16;
13. Stable Video Diffusion (SVD-XT) at full width with seeded random
    weights, after the SD1.5 modules are freed (phase 3 holds its kernels
    at its shapes: K1 and K6 at (50, 5, 9216, 64) and (50, 10, 2304, 64)
    against their plain versions on two batch rows, K2 and K3 at the
    temporal decoder's 576×1024 and 288×512 maps for a chunk of 5 frames,
    and every GroupNorm and K4 shape of the opt-in UNet eval): a
    seeded uint8 576×1024 image to 25 frames
    (EDM Euler 25 steps, guidance ramp 1.0 → 3.0, fps 7, motion bucket
    127, noise aug 0.02, ``decode_chunk_size`` 5: JAX's tracked
    configuration) through ``StableVideoDiffusionPipeline``: one eager
    clip; graphed stepwise (captured by a 1-step clip, one counted and
    timed clip against eager, not profiled); 2-step clips with a
    second guidance range and motion bucket, which capture nothing; one
    decoded chunk graphed against eager bit for bit; the fused loop
    (captured, then one counted clip against eager); one UNet eval of 2
    frames and one decoded chunk of 5 on the kernel route against the
    plain route; one counted opt-in clip and one opt-in UNet eval of 2
    frames against the plain route; calibrated static W8A8 of the UNet
    (temporal convs included), one graphed eval of 2 frames against bf16's;
14. quantization (after phase 10 on the SDXL pipeline, after phase 12 on
    the SD1.5 one): W8A16, dynamic W8A8 and calibrated static W8A8 (both
    with convs; JAX's tracked setup), each on a fresh bf16 copy of the
    UNet in the compiled slot: the quantized compiled pipeline captures
    anew, launches as bf16, its image differs from bf16's, its graphed
    10-step latents equal eager bit for bit; e2e against bf16 (the counted
    image is the timed one), the UNet's weight bytes, the 10-step latents'
    relative rms against bf16's (below 0.3);
15. serving and the compile surface, on phase 4's SD1.5 modules after
    phase 9: ``sfast_tpu_torch.compile`` of a diffusers-shaped stub
    pipeline (plain objects with SD1.5's published configs in diffusers'
    and transformers' names and phase 4's tensors; called, they raise)
    builds the port's models, whose image of phase 4's latents equals
    phase 4's graphed image bit for bit with its launches; a step callback
    (50 calls, the same image); four requests through ``map(window=2)``
    against four sequential calls, bit for bit, both timed, and the host
    syncs PyTorch reports in a steady-state ``'pt'`` call; one UNet eval
    under ``memory_format='NCHW'`` against the NHWC eval, bit for bit;
    ``warmup(background=True)`` of 512×768 while two 512² images are
    served, each equal to phase 4's with its launches on the serving
    thread, then a 512×768 image that captures nothing, within 1 uint8
    level of an eager one;
16. LoRA training on phase 4's SD1.5 UNet (bf16) at full width, after
    phase 15, with the JAX example's settings: an f32 rank-4 LoRA, AdamW
    (``capturable``) at 1e-4, batch 4 of 64×64×4 latents and 77×768 text
    embeddings, the kernels off.  The eager step
    (``enable_cuda_graph=False``): 3 steps timed with CUDA events and the
    host clock, every B moved by step 1, a fourth step profiled (device
    time, idle share, CUDA kernels and the host's launch calls).  The
    graphed step (the default ``enable_cuda_graph``: forward, backward and
    AdamW as one CUDA graph) from the same state on the same draws: its
    first call (3 warm-up steps, the capture: seconds, nodes, pool),
    after 3 steps the LoRA's factors and AdamW's state against the eager
    step's (bit for bit, or within 1e-5 relative rms), 5 timed replays,
    one profiled, peak memory; every loss finite, no kernel launched; the
    step dropped and its pool freed.  B's step-1 gradient at batch 1 against
    an f32 copy of the UNet (eager; relative rms below 5e-2); under
    ``CompilationConfig.Default()`` the graphed step's first warm-up
    launches K1 5 times and its backward raises: nothing captured, the
    LoRA and the optimizer's state as they were; the trained LoRA saved
    and read back through ``utils/checkpoint``, swapped into the compiled
    pipeline (nothing captured, the image changes) and back with scale 0
    (phase 4's graphed image bit for bit, which phases 11, 12 and 14
    reuse).

17. the mesh, after phase 16: ``init_process_group("nccl")`` as rank 0 of
    a world of 1 (a file store), ``parallel.make_mesh((1, 1, 1), ("dp",
    "tp", "sp"))``, and phase 4's SD1.5 weights in new modules compiled
    with ``CompilationConfig(mesh=...)``: every Linear the rule splits is
    tensor-parallel, its all-reduces and all-gathers (counted from the
    sharded modules and printed) captured in the graphs.  The graphed
    image of phase 4's latents equals phase 4's graphed image bit for bit,
    with phase 4's launches; the graphs' nodes against phase 4's, and one
    timed image against phase 4's e2e.  A rank-8 LoRA swapped in under the
    mesh captures nothing and changes the image; swapped back, the image
    is restored bit for bit.  One graphed LoRA train step on the sharded
    UNet at batch 1 (the gradients' all-reduces in the graph) against one
    eager step from the same state.  ``ring_attention`` on an ``sp`` group
    of one at SD1.5's level 0 (2, 8, 4096, 40) and SVD's (2, 5, 9216, 64) bf16
    against ``flash_attention_ref``, timed beside K1 (plain torch in f32:
    no kernel).  The process group is destroyed at the end;
18. the six ``examples_torch/`` scripts, last (after phase 13 freed the
    card), each in this process through its ``main`` at full width on the
    card: SD, LCM and LCM-LoRA (1 warm-up, 1 timed image), InstantID (30
    steps), SVD (2 steps, 25 frames at 576×1024) and LoRA training (3
    graphed steps, no mesh); each prints its ms, and one that raises fails the run.
    The launch counts are set to 0 before each script and read after it:
    each pipeline script must have launched K1, K2 and K3, and the
    training script (the kernels off) none.

Each phase prints its seconds and the graphs its pipeline holds, with
their nodes, capture and instantiate seconds, and the peak memory.

The line before the last is ``{"kernels": [...]}``: per kernel its
launches per image on each path, the main-path case's numbers and every
case under ``cases``.  The last is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

# Tolerances of the kernel-vs-plain checks, on bf16 inputs.  The kernels
# accumulate in f32 like their plain versions but round elsewhere (p to
# bf16 before the row sum in K1; K2 keeps the conv output in f32 where
# cuDNN rounds it to bf16), so relative rms errors of a few 1e-3 are
# expected; the bounds leave a factor of about 3 to 5.
K1_RMS_REL = 1e-2
K2_RMS_REL = 2e-2
STATS_REL = 1e-3  # K2's Σy, Σy², K3's and the fused GroupNorm's mean, rstd: f32 sums, other order
# K5, the fused GroupNorm and K4 against f32 plain versions: the kernels
# round their output to bf16 once (2^-9 relative), so rms errors of a few
# 1e-3 are expected.
K5_RMS_REL = 1e-2
K4_RMS_REL = 1e-2
# K6 against its plain version at the kernel's kv tile: the same int8 math,
# with exp2 and sums in another order flipping a few roundings of p; and
# against exact attention, the bound of the JAX package's own int8 test.
K6_RMS_REL = 1e-2
K6_EXACT_RMS_REL = 0.015
# K6's pre-processing against its plain version: the means are summed in
# another order, so a value on a rounding boundary may take the next int8
# level; the f32 outputs (scales, corr, v's mean) agree to 1e-6
PREP_CODE_SHARE = 1e-3
PREP_F32_REL = 1e-6
# Full-model kernel route vs plain route: one UNet eval, one VAE decode
# and one VAE encode in bf16 at random weights, where tens of layers
# compound those per-kernel errors.
MODEL_RMS_REL = 5e-2
# The opt-in route adds int8 attention (about 1e-2 at each level-0
# attention output) and the tanh GELU of K4 against the plain erf GELU.
OPTIN_MODEL_RMS_REL = 1e-1
STEPS = 50
# The card's published peaks (H100 SXM, dense): bf16 and int8 tensor-core
# rates and device memory; the exp2 rate of the MUFU units (16 per clock
# per SM, 132 SMs) at the 1.98 GHz boost clock, K1's second floor
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12
EXP2_PER_S = 16 * 132 * 1.98e9
# launches of one image: 5 level-0 self-attentions x 50 steps; 9 fused VAE
# resnets x 2 + 3 upsample convs; one K3 per fused resnet.  Opt-in: every
# UNet GroupNorm (22 resnets x 2 + 16 transformers + conv_norm_out = 61 per
# eval) is one fused GroupNorm; 11 of the 16 GEGLUs pass the width rule
# (K = 320 fails it); the 5 level-0 self-attentions take K6.
EXPECTED_LAUNCHES = {
    "flash_attention": 5 * STEPS, "quantize_qkv": 0, "flash_attention_int8": 0,
    "conv3x3": 21, "group_norm_stats": 9, "group_norm_apply": 0, "group_norm_fused": 0,
    "linear_geglu": 0,
}
# img2img and inpainting at strength 0.8 run steps 10..49: 40 UNet evals;
# the VAE encoder adds 6 fused resnets (12 K2, 6 K3) at 512², 256² and 128²
EXPECTED_IMG2IMG_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=5 * 40, conv3x3=21 + 12,
                                 group_norm_stats=9 + 6)
STRENGTH = 0.8
LORA_RANK = 8
# SDXL 1024², Euler 30 steps, CFG 5: 70 self-attentions an eval take K1 at
# head dim 64 (levels 1 and 2: 2 + 3 transformers of depth 2 at 4096
# tokens, 5 of depth 10 and the mid block's at 1024); the decoder's 14
# resnets (from 128², the mid block's two now above the K2 threshold) take
# K2 twice and K3 once, its 3 upsample convs K2.  img2img at strength 0.8
# runs 24 steps and the encoder's 10 resnets (1024² to 128², mid block).
SDXL_STEPS = 30
SDXL_HW = 1024
SDXL_GUIDANCE = 5.0
SDXL_ATTN_PER_EVAL = 70
EXPECTED_SDXL_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=SDXL_ATTN_PER_EVAL * SDXL_STEPS,
                              conv3x3=31, group_norm_stats=14)
SDXL_IMG2IMG_STEPS = int(SDXL_STEPS * STRENGTH)  # the steps img2img runs
EXPECTED_SDXL_IMG2IMG_LAUNCHES = dict(
    EXPECTED_SDXL_LAUNCHES, flash_attention=SDXL_ATTN_PER_EVAL * SDXL_IMG2IMG_STEPS,
    conv3x3=31 + 20, group_norm_stats=14 + 10)
# LCM 4 steps at guidance 1: no CFG, K1 at batch 1
LCM_STEPS = 4
EXPECTED_LCM_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=5 * LCM_STEPS)
LCM_COND_DIM = 256  # the time_cond_proj_dim of SimianLuo/LCM_Dreamshaper_v7
# ControlNet (JAX's tracked configuration, bench_extra_configs.py:126-175):
# 30 DPM++ steps, CFG 7.5, control scale 0.8.  Each step runs the UNet's 5
# and the ControlNet's 2 level-0 self-attentions through K1; the VAE as
# before.  Opt-in: the ControlNet's 27 GroupNorms (20 in its resnets, 7 in
# its transformers) and 5 GEGLUs (levels 1, 2 and mid) beside the UNet's.
CN_STEPS = 30
CN_SCALE, IP_SCALE, IP_TOKENS = 0.8, 0.6, 4
# the zero convs' weights, N(0, (scale)²/fan_in) with zero biases
CN_ZERO_CONV_SCALE = 0.1
EXPECTED_CN_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=(5 + 2) * CN_STEPS)
CN_EVAL_LAUNCHES = {"flash_attention": 2}  # one ControlNet eval on the CFG batch
EXPECTED_OPTIN_LAUNCHES = {
    "flash_attention": 0, "quantize_qkv": 5 * STEPS, "flash_attention_int8": 5 * STEPS,
    "conv3x3": 21, "group_norm_stats": 9, "group_norm_apply": 0,
    "group_norm_fused": 61 * STEPS, "linear_geglu": 11 * STEPS,
}
EXPECTED_CN_OPTIN_LAUNCHES = dict(
    EXPECTED_OPTIN_LAUNCHES, quantize_qkv=(5 + 2) * CN_STEPS,
    flash_attention_int8=(5 + 2) * CN_STEPS, group_norm_fused=(61 + 27) * CN_STEPS,
    linear_geglu=(11 + 5) * CN_STEPS)

# Stable Video Diffusion, SVD-XT (JAX's tracked configuration,
# benchmarks/bench_svd_xt_fullsize.py:26-30): 25 frames at 576×1024, batch
# 1, EDM Euler 25 steps, CFG with the per-frame guidance ramp 1.0 → 3.0,
# fps 7, motion bucket 127, noise aug 0.02, decode_chunk_size 5.  Each eval
# (the CFG pair of 25 frames, batch 50) runs 5 spatial self-attentions at
# 9,216 tokens (level 0) and 5 at 2,304 (level 1) through K1; each decoded
# chunk of 5 frames 9 fused decoder resnets (144×256 to 576×1024: K2 twice,
# K3 once) and 3 upsample convs, the conditioning image's encode at 576×1024
# 6 fused encoder resnets.  Opt-in: 33 GEGLUs an eval pass K4's width rule
# (K = 640, 1280), and of the 105 GroupNorms an eval `fused_plan` takes 84;
# the other 21 (the temporal GroupNorms' folded (2, 25·H·W, C) shapes at
# levels 0 and 1, and (50, 72·128, 960)) take K3 then K5.
SVD_FRAMES, SVD_H, SVD_W, SVD_STEPS, SVD_CHUNK = 25, 576, 1024, 25, 5
SVD_KW = dict(num_frames=SVD_FRAMES, height=SVD_H, width=SVD_W,
              num_inference_steps=SVD_STEPS, min_guidance_scale=1.0, max_guidance_scale=3.0,
              fps=7, motion_bucket_id=127, noise_aug_strength=0.02,
              decode_chunk_size=SVD_CHUNK)
SVD_CHUNKS = SVD_FRAMES // SVD_CHUNK
EXPECTED_SVD_LAUNCHES = dict(EXPECTED_LAUNCHES, flash_attention=10 * SVD_STEPS,
                             conv3x3=21 * SVD_CHUNKS + 12, group_norm_stats=9 * SVD_CHUNKS + 6)
EXPECTED_SVD_OPTIN_LAUNCHES = dict(
    EXPECTED_SVD_LAUNCHES, flash_attention=0, quantize_qkv=10 * SVD_STEPS,
    flash_attention_int8=10 * SVD_STEPS, linear_geglu=33 * SVD_STEPS,
    group_norm_fused=84 * SVD_STEPS, group_norm_apply=21 * SVD_STEPS,
    group_norm_stats=21 * SVD_STEPS + 9 * SVD_CHUNKS + 6)
# The route check's UNet eval: the CFG pair of 2 frames at 576×1024, its
# 10 flash self-attentions (levels 0 and 1) through K1.  Opt-in, they take
# K6, 33 GEGLUs K4, and of the 105 GroupNorms `fused_plan` takes 104 (the
# temporal ones folded to (2, 2·H·W, C) among them); (4, 72·128, 960)
# takes K3 then K5.
SVD_ROUTE_FRAMES = 2
SVD_ROUTE_LAUNCHES = {"flash_attention": 10}
SVD_OPTIN_ROUTE_LAUNCHES = {"quantize_qkv": 10, "flash_attention_int8": 10, "linear_geglu": 33,
                            "group_norm_fused": 104, "group_norm_stats": 1,
                            "group_norm_apply": 1}
# One decoded chunk of 5 frames: 9 fused resnets (K2 twice, K3 once) and 3
# upsample convs
SVD_DECODE_LAUNCHES = {"conv3x3": 21, "group_norm_stats": 9}
# K1 at the SVD shapes (b, h, s, d); K2 and K3 at the temporal decoder's
# for a chunk of frames (H, W, C, F, kind) and (H, W, C)
SVD_ATTN = [(50, 5, 9216, 64), (50, 10, 2304, 64)]
SVD_CONV = [(576, 1024, 256, 128, "conv1"), (576, 1024, 128, 128, "conv2"),
            (576, 1024, 256, 256, "upsample"), (288, 512, 512, 256, "conv1"),
            (288, 512, 256, 256, "conv2")]
SVD_GN = [(576, 1024, 256), (576, 1024, 128), (288, 512, 512), (288, 512, 256)]
# Every distinct UNet GroupNorm of the SVD opt-in path (25 frames, CFG):
# ((N, H, W, C), act, times one eval runs it: 105 in all).  act None is a
# transformer's norm (eps 1e-6); the temporal resnets' norms span the
# frames, folded to (2, 25·H, W, C); `fused_plan` rejects the first two
# of those and (50, 72, 128, 960), which take K3 then K5
SVD_OPTIN_GN = [
    ((2, 1800, 128, 320), "silu", 10), ((2, 900, 64, 640), "silu", 10),
    ((2, 450, 32, 1280), "silu", 10), ((2, 225, 16, 1280), "silu", 14),
    ((50, 72, 128, 320), None, 5), ((50, 72, 128, 320), "silu", 8),
    ((50, 72, 128, 640), "silu", 2), ((50, 72, 128, 960), "silu", 1),
    ((50, 36, 64, 320), "silu", 1), ((50, 36, 64, 640), None, 5),
    ((50, 36, 64, 640), "silu", 6), ((50, 36, 64, 960), "silu", 1),
    ((50, 36, 64, 1280), "silu", 1), ((50, 36, 64, 1920), "silu", 1),
    ((50, 18, 32, 640), "silu", 1), ((50, 18, 32, 1280), None, 5),
    ((50, 18, 32, 1280), "silu", 6), ((50, 18, 32, 1920), "silu", 1),
    ((50, 18, 32, 2560), "silu", 2), ((50, 9, 16, 1280), None, 1),
    ((50, 9, 16, 1280), "silu", 11), ((50, 9, 16, 2560), "silu", 3),
]
# K4's calls on the SVD opt-in path as (M, K, F, times one eval runs it):
# the temporal ff_in and ff over 25 frames of each pixel and the spatial
# ff over the pixels of each of 50 frames, at levels 1, 2 and mid
SVD_GEGLU = [(115200, 640, 2560, 15), (28800, 1280, 5120, 15), (7200, 1280, 5120, 3)]

# SDXL 1024² under the opt-in configuration (Euler 30, CFG 5): the 70
# self-attentions an eval (head dim 64, 4,096 and 1,024 tokens) pass the
# length rule and take K6; the 70 GEGLUs (K = 640, 1280) K4; of the 46
# GroupNorms an eval (34 in resnets, 11 in transformers, conv_norm_out)
# `fused_plan` takes 45, and the first up-level-2 resnet's 128²·960 entry
# takes K3 then K5.  With enable_fused_conv added, the 5 resnets at 128²
# (down level 0, up level 2) take K2 twice and K3 once, their 10 GroupNorms
# leaving the GroupNorm route, and the upsample conv into 128² takes K2.
SDXL_OPTIN_GN = [
    ((2, 128, 128, 320), "silu", 8), ((2, 128, 128, 640), "silu", 2),
    ((2, 128, 128, 960), "silu", 1), ((2, 64, 64, 320), "silu", 1),
    ((2, 64, 64, 640), "silu", 6), ((2, 64, 64, 640), None, 5), ((2, 64, 64, 960), "silu", 1),
    ((2, 64, 64, 1280), "silu", 1), ((2, 64, 64, 1920), "silu", 1),
    ((2, 32, 32, 640), "silu", 1), ((2, 32, 32, 1280), "silu", 10),
    ((2, 32, 32, 1280), None, 6), ((2, 32, 32, 1920), "silu", 1),
    ((2, 32, 32, 2560), "silu", 2),
]
SDXL_GEGLU = [(8192, 640, 2560, 10), (2048, 1280, 5120, 60)]
SDXL_INT8_ATTN = [(2, 10, 4096, 64), (2, 20, 1024, 64)]
# K2 and K3 at the SDXL UNet's 128² resnets (batch 2) under enable_fused_conv:
# (C_in, C_out, kind)
SDXL_UNET_CONV = [(320, 320, "conv1"), (320, 320, "conv2"), (640, 320, "conv1"),
                  (960, 320, "conv1"), (640, 640, "upsample")]
SDXL_UNET_STATS = [320, 640, 960]
EXPECTED_SDXL_OPTIN_LAUNCHES = dict(
    EXPECTED_SDXL_LAUNCHES, flash_attention=0,
    quantize_qkv=SDXL_ATTN_PER_EVAL * SDXL_STEPS,
    flash_attention_int8=SDXL_ATTN_PER_EVAL * SDXL_STEPS,
    linear_geglu=70 * SDXL_STEPS, group_norm_fused=45 * SDXL_STEPS,
    group_norm_stats=1 * SDXL_STEPS + 14, group_norm_apply=1 * SDXL_STEPS)
EXPECTED_SDXL_FUSED_CONV_LAUNCHES = dict(
    EXPECTED_SDXL_OPTIN_LAUNCHES, group_norm_fused=36 * SDXL_STEPS,
    group_norm_stats=5 * SDXL_STEPS + 14, group_norm_apply=0, conv3x3=11 * SDXL_STEPS + 31)
# LCM with TAESD in both VAE slots: TAESD has no GroupNorm, so no K2 or K3;
# img2img at strength 0.8 runs 3 of the 4 steps
EXPECTED_LCM_TAESD_LAUNCHES = dict(EXPECTED_LCM_LAUNCHES, conv3x3=0, group_norm_stats=0)
EXPECTED_LCM_TAESD_IMG2IMG_LAUNCHES = dict(EXPECTED_LCM_TAESD_LAUNCHES, flash_attention=5 * 3)
# Quantization (phase 14, JAX's tracked setup, benchmarks/bench_w8a8.py:
# 183-206): W8A16 (linears), dynamic W8A8 and calibrated static W8A8, both
# with the resnet and resampling convs; the latents of 10 steps of seed 3
# against bf16's.  The UNet's kernels launch as in bf16 (attention is not
# quantized; the UNet's convs take cuDNN by default).
QUANT_MODES = (("w8a16", dict(mode="w8a16")),
               ("w8a8 dynamic", dict(mode="w8a8", quantize_convs=True)),
               ("w8a8 static", dict(mode="w8a8", quantize_convs=True)))
QUANT_LATENT_STEPS = 10
# The quantized output's relative rms against bf16's (phase 14's latents,
# phase 13's UNet eval) must stay below this: on an H100 80GB HBM3 at
# 700 W the readings were 0.031 to 0.162 (phase 14) and 0.074 (phase 13),
# so a broken int8 route, which lands near 1 or above, fails
QUANT_RMS_REL = 0.3
# The int8 products at the largest linear and conv sites of SD1.5 512²
# and SDXL 1024² (batch 2): (label, M, K, N) for a linear (the level-0
# GEGLU proj of SD1.5, the level-1 one of SDXL); (label, N, H, W, C, F)
# for a 3×3 conv (the first resnet conv1 at the last up level)
INT8_LINEARS = [("sd15 ff.net.0.proj level 0", 8192, 320, 2560),
                ("sdxl ff.net.0.proj level 1", 8192, 640, 5120)]
INT8_CONVS = [("sd15 up_blocks.3.resnets.0.conv1", 2, 64, 64, 960, 320),
              ("sdxl up_blocks.2.resnets.0.conv1", 2, 128, 128, 960, 320)]

KERNELS = {
    "flash_attention": ("sfast_tpu_torch/csrc/flash_attention.cu",
                        "sfast_tpu/ops/flash_attention.py:52"),
    "flash_attention_int8": ("sfast_tpu_torch/csrc/flash_attention_int8.cu",
                             "sfast_tpu/ops/flash_attention.py:183"),
    # K6's pre-processing: XLA ops before the Pallas kernel in JAX
    "quantize_qkv": ("sfast_tpu_torch/csrc/quantize_qkv.cu",
                     "sfast_tpu/ops/flash_attention.py:326"),
    "conv3x3": ("sfast_tpu_torch/csrc/conv3x3.cu", "sfast_tpu/ops/conv_pallas.py:53"),
    "group_norm_stats": ("sfast_tpu_torch/csrc/group_norm_stats.cu",
                         "sfast_tpu/ops/group_norm.py:76"),
    "group_norm_apply": ("sfast_tpu_torch/csrc/group_norm_apply.cu",
                         "sfast_tpu/ops/group_norm.py:105"),
    # the pair _stats_kernel then _norm_apply_kernel of group_norm_pallas
    "group_norm_fused": ("sfast_tpu_torch/csrc/group_norm_fused.cu",
                         "sfast_tpu/ops/group_norm.py:76,105"),
    "linear_geglu": ("sfast_tpu_torch/csrc/geglu.cu", "sfast_tpu/ops/geglu.py:43"),
}

# Every distinct UNet GroupNorm of the opt-in path at 512² (batch 2):
# (H = W, C, act, times one UNet eval runs it: 61 in all); act None is a
# transformer's norm (eps 1e-6)
UNET_GN = [
    (64, 320, "silu", 8), (64, 320, None, 5), (64, 640, "silu", 2), (64, 960, "silu", 1),
    (32, 320, "silu", 1), (32, 640, "silu", 6), (32, 640, None, 5), (32, 960, "silu", 1),
    (32, 1280, "silu", 1), (32, 1920, "silu", 1),
    (16, 640, "silu", 1), (16, 1280, "silu", 6), (16, 1280, None, 5), (16, 1920, "silu", 1),
    (16, 2560, "silu", 2),
    (8, 1280, "silu", 11), (8, 1280, None, 1), (8, 2560, "silu", 3),
]
# K4's calls: (M, K, F) of the feed-forwards at levels 1, 2 and mid
UNET_GEGLU = [(2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120)]
# The device kernels each launch counted by cuda_build.launch_counts runs
# once, by a piece of their names in the profiler
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


def log(*a):
    print(*a, flush=True)


class CardSampler:
    """Samples the card's SM and memory clocks, power draw and temperature
    every 100 ms (``nvidia-smi -lms``) while the ``with`` block runs;
    ``text()`` gives their medians and ranges."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = [[float(v) for v in line.split(",")] for line in out.splitlines()
                if line.count(",") == len(self.FIELDS) - 1 and "N/A" not in line]
        self.samples = {f: [r[i] for r in rows] for i, f in enumerate(self.FIELDS)}
        return False

    def text(self):
        return "; ".join(
            f"{f} median {statistics.median(v):.0f} ({min(v):.0f}-{max(v):.0f})"
            for f, v in self.samples.items() if v) or "no nvidia-smi samples"


def rel_errors(got, ref):
    """(max |err|, max |err| / max |ref|, rms err / rms ref) in f32."""
    got, ref = got.float(), ref.float()
    d = got - ref
    max_abs = d.abs().max().item()
    return (
        max_abs,
        max_abs / max(ref.abs().max().item(), 1e-30),
        (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-30)).item(),
    )


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of one call, each timed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def events_ms(fn, calls=20):
    """Mean ms of one call over ``calls`` calls in a row between two CUDA
    events: device time where the calls keep the device busy (a call of
    several kernels, each far longer than its launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def device_ms(fn, floor_ms, iters=10, names=False, tries=5):
    """Mean device milliseconds of one call: the kernel rows of a
    torch.profiler trace.  CUDA events around one call also time the host's
    launch of it, which is most of what they read below ~0.1 ms.  With
    ``names`` also returns the names of the kernels that ran.

    The profiler now and then loses kernel rows, and the trace then reads
    too low.  A trace with no kernel row, with a kernel counted a number of
    times that is not a multiple of the calls, or whose time is not above
    ``floor_ms`` (the function's bound) is taken again; after ``tries``
    such traces this raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in rows) / iters / 1e3
        if rows and all(e.count % iters == 0 for e in rows) and ms > floor_ms:
            return (ms, sorted({e.key for e in rows})) if names else ms
        log(f"    profiler trace of {iters} calls lost kernel rows: {ms:.4f} ms per call, "
            f"bound {floor_ms:.4f} ms, counts {[e.count for e in rows]}; tracing again")
    raise RuntimeError(f"device_ms: {tries} profiler traces lost kernel rows "
                       f"(last: {ms:.4f} ms per call against a bound of {floor_ms:.4f} ms)")


def bound(flops, nbytes, peak=PEAK_BF16):
    """(least ms the card could take, what sets it): the operations over
    the peak rate of their type against every input read once and every
    output written once over the memory rate."""
    op_ms, byte_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def record(out, name, case, max_abs, t, bnd, lib=None, **extra):
    """Log one case of a kernel and keep it under ``out[name]``.  ``lib`` is
    (library device ms, what the call is) or None."""
    ms, plain_ms, dev, plain_dev = t
    row = {
        "case": case, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "device_ms": dev, "plain_device_ms": plain_dev,
        "library_ms": None if lib is None else lib[0],
        "library": "none" if lib is None else lib[1],
        "bound_ms": bnd[0], "bound_by": bnd[1], "share_of_bound": bnd[0] / dev,
        **extra,
    }
    lib_text = "none" if lib is None else f"{lib[0]:.4f} ({lib[1]})"
    log(f"    {name} {case}: device {dev:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
        f"{100 * bnd[0] / dev:.1f}% of bound; library {lib_text}")
    out.setdefault(name, []).append(row)


def time_pair(kernel, plain, bnd, iters=20, plain_events=False):
    """(kernel ms, plain ms, kernel device ms, plain device ms): CUDA-event
    medians of ``iters`` calls timed in turns plain, kernel, kernel, plain,
    then device times, each above ``bnd``, the function's bound.  With
    ``plain_events`` the plain version's device time is CUDA events over
    calls in a row (``events_ms``): at the SVD shapes its kernels are
    milliseconds long, and the profiler's rows of them do not come in whole
    calls."""
    p1, k1, k2, p2 = (cuda_ms(fn, iters) for fn in (plain, kernel, kernel, plain))
    dev_iters = min(iters, 10)
    plain_dev = events_ms(plain, dev_iters) if plain_events else device_ms(plain, bnd[0],
                                                                           dev_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel, bnd[0], dev_iters), plain_dev


def timing_text(t):
    return (f"kernel {t[0]:.4f} ms (device {t[2]:.4f})  "
            f"plain {t[1]:.4f} ms (device {t[3]:.4f})")


def sdpa_backend(names):
    """Which of PyTorch's attention backends ran, from its kernels' names."""
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "mem-efficient"),
                         ("efficient", "mem-efficient")):
        if key in text:
            return backend
    return "math"


def check_kernels(torch, dev):
    """Phase 3.  Returns {kernel: [case, ...]}, the main-path case first:
    errors, kernel / plain / library times, bound."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    out = {}
    # K1: UNet level-0 self-attention, q/k/v as head-split views of the
    # (B, S, H·D) projections; then a ragged kv tail (1000 = 7·128 + 104);
    # then SDXL's self-attentions at head dim 64 (64² and 32² levels)
    for b, h, sq, sk, d in [(2, 8, 4096, 4096, 40), (2, 8, 4096, 1000, 40),
                            (2, 10, 4096, 4096, 64), (2, 20, 1024, 1024, 64)]:
        q = randn(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        k = randn(b, sk, h * d).view(b, sk, h, d).transpose(1, 2)
        v = randn(b, sk, h * d).view(b, sk, h, d).transpose(1, 2)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        max_abs, max_rel, rms = rel_errors(got, flash_attention_ref(q, k, v))
        again = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K1: two calls on the same inputs differ")
        nbytes = 2 * b * h * d * (2 * sq + 2 * sk)  # q, k, v in, o out
        bnd = bound(4 * b * h * sq * sk * d, nbytes)
        t = time_pair(lambda: flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v),
                      bnd)
        sdpa_ms, sdpa_names = device_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                        bnd[0], names=True)
        log(f"K1 flash_attention q={tuple(q.shape)} kv={sk}: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e}  {timing_text(t)}")
        if not rms <= K1_RMS_REL:
            raise AssertionError(f"K1 rms rel error {rms} > {K1_RMS_REL}")
        record(out, "flash_attention", f"({b}, {h}, {sq}x{sk}, {d})", max_abs, t, bnd,
               (sdpa_ms, f"F.scaled_dot_product_attention, {sdpa_backend(sdpa_names)} backend"),
               exp2_floor_ms=b * h * sq * sk / EXP2_PER_S * 1e3)

    # K2: every distinct call of the VAE decoder's main path — the fused
    # resnets' conv1 (GN in, per-batch bias, stats out) and conv2 (GN in,
    # bias, residual in), including the 512→256 and 256→128 channel
    # changes, and the three upsample convs (no GN); then the two calls of
    # the encoder that the decoder has not (conv1 widening the channels);
    # then SDXL's decoder and encoder at 1024²: the 128→128 resnet convs,
    # conv1 narrowing 256→128, the upsample conv at 256 channels, and the
    # encoder's widening conv1s at 512² and 256²
    cases = [
        (128, 512, 512, "conv1"), (128, 512, 512, "conv2"), (128, 512, 512, "upsample"),
        (256, 512, 256, "conv1"), (256, 256, 256, "conv1"), (256, 256, 256, "conv2"),
        (256, 512, 512, "upsample"),
        (512, 256, 128, "conv1"), (512, 128, 128, "conv1"), (512, 128, 128, "conv2"),
        (512, 256, 256, "upsample"),
        (256, 128, 256, "encoder conv1"), (128, 256, 512, "encoder conv1"),
        (1024, 128, 128, "conv1"), (1024, 128, 128, "conv2"), (1024, 256, 128, "conv1"),
        (1024, 256, 256, "upsample"),
        (512, 128, 256, "encoder conv1"), (256, 256, 512, "encoder conv1"),
    ]
    for hw, c, f, kind in cases:
        conv_case(torch, dev, g, out, 1, hw, hw, c, f, kind)

    # K3: the fused-resnet entries' GroupNorm statistics (32 groups, eps
    # 1e-6): the decoder's, then the two the encoder adds, then SDXL's 1024²
    for hw, c in [(128, 512), (256, 512), (256, 256), (512, 256), (512, 128),
                  (256, 128), (128, 256), (1024, 128), (1024, 256)]:
        stats_case(torch, dev, g, out, 1, hw, hw, c)

    check_optin_kernels(torch, dev, randn, out)
    # SDXL's UNet at 128² under enable_fused_conv (batch 2), then SDXL's
    # opt-in shapes: its 46 GroupNorms an eval, K4 at its two GEMMs, K6 at
    # head dim 64 over 4,096 and 1,024 tokens
    for c, f, kind in SDXL_UNET_CONV:
        conv_case(torch, dev, g, out, 2, 128, 128, c, f, kind, "sdxl unet ", iters=10)
    for c in SDXL_UNET_STATS:
        stats_case(torch, dev, g, out, 2, 128, 128, c, "sdxl unet ", iters=10)
    check_optin_shape_kernels(torch, dev, g, randn, out, "sdxl", SDXL_OPTIN_GN, SDXL_GEGLU,
                              SDXL_INT8_ATTN)
    out["int8"] = check_int8_ops(torch, dev)
    svd = check_svd_kernels(torch, dev)
    out["svd_group_norm_per_eval_ms"] = svd.pop("svd_group_norm_per_eval_ms")
    for name, cases in svd.items():
        out[name].extend(cases)
    return out


def check_int8_ops(torch, dev):
    """Phase 3, the int8 products of the quantized paths (library calls,
    not TPU kernels: JAX computes them with XLA ops): ``int_mm``
    (``torch._int_mm``) and the W8A8 conv (an im2col on it) at the largest
    linear and conv sites of SD1.5 and SDXL, each int32 result equal to
    its plain version (f64 products, exact), timed beside the bf16 call it
    replaces and the whole quantized op (the activation's quantization and
    the epilogue included), with its bound at the int8 peak."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.quant import (
        conv2d_w8a8, conv2d_w8a8_static, int_conv2d, int_conv2d_ref, int_mm, int_mm_ref,
        linear_w8a8, linear_w8a8_static, quantize_conv_weight, quantize_weight,
    )

    g = torch.Generator(device=dev).manual_seed(50)
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for label, m, k, n in INT8_LINEARS:
        x, w = randn(m, k), randn(n, k) / k ** 0.5
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        wq, ws = quantize_weight(w)
        got = int_mm(a, wq.t())
        diff = (got.long() - int_mm_ref(a, wq.t()).long()).abs().max().item()
        bnd = bound(2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8)
        a_scale = (x.float().abs().amax() / 127).reshape(())
        ms = device_ms(lambda: int_mm(a, wq.t()), bnd[0])
        row = {"site": label, "shape": f"M={m} K={k} N={n}", "int32_max_diff": diff,
               "int_mm_ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
               "share_of_bound": bnd[0] / ms,
               "linear_w8a8_ms": device_ms(lambda: linear_w8a8(x, wq, ws), bnd[0]),
               "linear_w8a8_static_ms": device_ms(lambda: linear_w8a8_static(x, wq, ws, a_scale),
                                                  bnd[0]),
               "library_ms": device_ms(lambda: F.linear(x, w), bound(2 * m * k * n, 0)[0]),
               "library": "F.linear, bf16"}
        rows.append(row)
        log(f"int8 int_mm {label} {row['shape']}: int32 max diff {diff} against the plain "
            f"version; device {ms:.4f} ms (bound {bnd[0]:.4f} ms, {bnd[1]}), whole W8A8 linear "
            f"{row['linear_w8a8_ms']:.4f} dynamic / {row['linear_w8a8_static_ms']:.4f} static, "
            f"bf16 F.linear {row['library_ms']:.4f} ms")
        if diff != 0:
            raise AssertionError(f"int_mm {label}: int32 differs from the plain version by {diff}")
        del x, w, a, got
    for label, n, hh, ww, c, f in INT8_CONVS:
        x, w = randn(n, hh, ww, c), randn(f, c, 3, 3) / (9 * c) ** 0.5
        wq, ws = quantize_conv_weight(w)
        xq = torch.randint(-127, 128, (n, hh, ww, c), generator=g, device=dev, dtype=torch.int8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = int_conv2d(xq, wq, padding=1)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base - got.numel() * 4) / 2**20
        diff = (got.long() - int_conv2d_ref(xq, wq, padding=1).long()).abs().max().item()
        px = n * hh * ww
        bnd = bound(2 * px * 9 * c * f, px * c + 9 * c * f + 4 * px * f, PEAK_INT8)
        a_scale = (x.float().abs().amax() / 127).reshape(())
        ms = device_ms(lambda: int_conv2d(xq, wq, padding=1), bnd[0])
        xc = x.permute(0, 3, 1, 2)
        wc = w.contiguous(memory_format=torch.channels_last)
        row = {"site": label, "shape": f"{n}x{hh}x{ww}x{c}->{f} 3x3", "int32_max_diff": diff,
               "int_conv2d_ms": ms, "im2col_extra_mib": extra, "bound_ms": bnd[0],
               "bound_by": bnd[1], "share_of_bound": bnd[0] / ms,
               "conv2d_w8a8_ms": device_ms(lambda: conv2d_w8a8(x, wq, ws, padding=1), bnd[0]),
               "conv2d_w8a8_static_ms": device_ms(
                   lambda: conv2d_w8a8_static(x, wq, ws, a_scale, padding=1), bnd[0]),
               "library_ms": device_ms(lambda: F.conv2d(xc, wc, padding=1),
                                       bound(2 * px * 9 * c * f, 0)[0]),
               "library": "F.conv2d, bf16 (cuDNN)"}
        rows.append(row)
        log(f"int8 W8A8 conv {label} {row['shape']}: int32 max diff {diff} against the plain "
            f"version; im2col + int_mm device {ms:.4f} ms (bound {bnd[0]:.4f} ms, {bnd[1]}), "
            f"{extra:.0f} MiB of columns and padding above its output; whole W8A8 conv "
            f"{row['conv2d_w8a8_ms']:.4f} dynamic / {row['conv2d_w8a8_static_ms']:.4f} static, "
            f"bf16 cuDNN {row['library_ms']:.4f} ms")
        if diff != 0:
            raise AssertionError(f"W8A8 conv {label}: int32 differs from the plain version by "
                                 f"{diff}")
        del x, w, xq, got
    torch.cuda.empty_cache()
    return rows


def conv_case(torch, dev, g, out, n, hh, ww, c, f, kind, label="", iters=20):
    """One K2 case against its plain version at (n, hh, ww, c) → f, timed
    beside cuDNN's conv: ``kind`` is a fused resnet's conv1 (GN in,
    per-batch bias, stats out) or conv2 (GN in, bias, residual in), or an
    upsample conv (no GN).  Inputs are drawn from ``g``."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.fused_conv import conv3x3_block, conv3x3_block_ref

    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf16)

    x = randn(n, hh, ww, c)
    # HWIO view of (F, 3, 3, C) memory, as the modules pass their weights
    w = (torch.randn((f, 3, 3, c), generator=g, device=dev) / (9 * c) ** 0.5).to(bf16)
    w = w.permute(1, 2, 3, 0)
    kw = {}
    if kind != "upsample":
        kw["gn_scale"] = torch.rand((n, c), generator=g, device=dev) + 0.5
        kw["gn_shift"] = torch.randn((n, c), generator=g, device=dev) * 0.1
    if kind.endswith("conv1"):
        kw.update(bias_batch=torch.randn((n, f), generator=g, device=dev), emit_stats=True)
    else:
        kw["bias"] = torch.randn((f,), generator=g, device=dev)
    if kind == "conv2":
        kw["residual"] = randn(n, hh, ww, f)
    got = conv3x3_block(x, w, **kw)
    torch.cuda.synchronize()
    ref = conv3x3_block_ref(x, w, **kw)
    if kind.endswith("conv1"):
        again = conv3x3_block(x, w, **kw)
        got, s1, s2 = got
        ref, r1, r2 = ref
        if not (torch.equal(s1, again[1]) and torch.equal(s2, again[2])):
            raise AssertionError("K2: two calls give different statistics")
        stats_err = max(rel_errors(s1, r1)[1], rel_errors(s2, r2)[1])
        if not stats_err <= STATS_REL:
            raise AssertionError(f"K2 stats rel error {stats_err} > {STATS_REL}")
    max_abs, max_rel, rms = rel_errors(got, ref)
    del got, ref
    px = n * hh * ww
    flops, conv_bytes = 2 * px * 9 * c * f, 2 * (px * c + 9 * c * f + px * f)
    bnd = bound(flops, conv_bytes + (2 * px * f if kind == "conv2" else 0))
    t = time_pair(lambda: conv3x3_block(x, w, **kw), lambda: conv3x3_block_ref(x, w, **kw),
                  bnd, iters, plain_events=bool(label))
    # cuDNN's bf16 conv with bias on the channels-last NCHW views: the
    # same function where there is no GroupNorm in front (upsample), a
    # lower floor where there is (conv1, conv2)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    bc = kw.get("bias", kw.get("bias_batch", torch.zeros(1, f, device=dev))[0]).reshape(f).to(bf16)
    lib_ms = device_ms(lambda: F.conv2d(xc, wc, bc, padding=1), bound(flops, conv_bytes)[0],
                       iters=min(iters, 10))
    extra = f" stats_rel {stats_err:.3e}" if kind.endswith("conv1") else ""
    shape = f"{hh}²" if n == 1 and hh == ww else f"{n}×{hh}×{ww}"
    log(f"K2 conv3x3 {label}{kind} {shape}·{c}→{f}: max_rel {max_rel:.3e} rms_rel {rms:.3e}"
        f"{extra}  {timing_text(t)}")
    if not rms <= K2_RMS_REL:
        raise AssertionError(f"K2 rms rel error {rms} > {K2_RMS_REL}")
    case = f"{hh}^2" if n == 1 and hh == ww else f"{n}x{hh}x{ww}"
    record(out, "conv3x3", f"{label}{kind} {case} {c}->{f}", max_abs, t, bnd,
           (lib_ms, "F.conv2d + bias" + (", same function" if kind == "upsample"
                                         else ", without the GroupNorm: a lower floor")))


def stats_case(torch, dev, g, out, n, hh, ww, c, label="", iters=20):
    """One K3 case (32 groups, eps 1e-6: a fused resnet's entry) against
    its plain version, timed beside ``torch.var_mean``."""
    from sfast_tpu_torch.ops.group_norm import group_norm_stats, group_norm_stats_ref

    x = torch.randn((n, hh, ww, c), generator=g, device=dev).to(torch.bfloat16) + 0.5
    mean, rstd = group_norm_stats(x, groups=32, eps=1e-6)
    torch.cuda.synchronize()
    rm, rr = group_norm_stats_ref(x, groups=32, eps=1e-6)
    em, er = rel_errors(mean, rm), rel_errors(rstd, rr)
    bnd = bound(0, 2 * x.numel())
    t = time_pair(lambda: group_norm_stats(x, groups=32, eps=1e-6),
                  lambda: group_norm_stats_ref(x, groups=32, eps=1e-6), bnd, iters,
                  plain_events=bool(label))
    shape = f"{hh}²" if n == 1 and hh == ww else f"{n}×{hh}×{ww}"
    log(f"K3 group_norm_stats {label}{shape}·{c}: mean max_rel {em[1]:.3e} rstd "
        f"max_rel {er[1]:.3e}  {timing_text(t)}")
    if not max(em[1], er[1]) <= STATS_REL:
        raise AssertionError(f"K3 rel error {max(em[1], er[1])} > {STATS_REL}")
    xg = x.view(n, hh * ww, 32, c // 32)
    case = f"{hh}^2" if n == 1 and hh == ww else f"{n}x{hh}x{ww}"
    record(out, "group_norm_stats", f"K3 {label}{case} {c}", max(em[0], er[0]), t, bnd,
           (device_ms(lambda: torch.var_mean(xg, dim=(1, 3)), bnd[0], iters=min(iters, 10)),
            "torch.var_mean"))


def check_optin_kernels(torch, dev, randn, out):
    """Phase 3, the opt-in path's kernels: the fused GroupNorm, and K3 and
    K5 alone, at every UNet GroupNorm shape, K4 at its three shapes, K6 and
    its pre-processing at the level-0 shape and a ragged kv."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from sfast_tpu_torch.ops.flash_attention_int8 import (
        flash_attention_int8,
        flash_attention_int8_body,
        flash_attention_int8_ref,
        kernel_inputs,
        kv_tile,
        quantize_qkv_cuda,
    )
    from sfast_tpu_torch.ops.geglu import (
        linear_geglu_fused,
        linear_geglu_fused_ref,
        linear_geglu_plain,
    )
    from sfast_tpu_torch.ops.group_norm import (
        group_norm_apply,
        group_norm_apply_ref,
        group_norm_fused,
        group_norm_fused_ref,
        group_norm_stats,
        group_norm_stats_ref,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    per_eval = {"fused": 0.0, "K3+K5": 0.0, "library": 0.0}
    for hw, c, act, count in UNET_GN:
        eps = 1e-5 if act else 1e-6
        x = randn(2, hw, hw, c) + 0.3
        gamma = torch.rand((c,), generator=g, device=dev) + 0.5
        beta = torch.randn((c,), generator=g, device=dev) * 0.2
        kw = dict(groups=32, eps=eps, act=act)
        y, fm, fr = group_norm_fused(x, gamma, beta, stats=True, **kw)
        again = group_norm_fused(x, gamma, beta, **kw)
        mean, rstd = group_norm_stats(x, groups=32, eps=eps)
        got = group_norm_apply(x, mean, rstd, gamma, beta, act=act)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"fused GroupNorm (2, {hw}², {c}): two calls differ")
        ry, rm, rr = group_norm_fused_ref(x, gamma, beta, **kw)
        f_stats = max(rel_errors(fm, rm)[1], rel_errors(fr, rr)[1])
        f_abs, _, f_rms = rel_errors(y, ry)
        stats_err = max(rel_errors(mean, rm)[1], rel_errors(rstd, rr)[1])
        max_abs, max_rel, rms = rel_errors(got, group_norm_apply_ref(x, mean, rstd, gamma, beta,
                                                                      act=act))
        bnd, st_bnd = bound(0, 4 * x.numel()), bound(0, 2 * x.numel())
        ft = time_pair(lambda: group_norm_fused(x, gamma, beta, **kw),
                       lambda: group_norm_fused_ref(x, gamma, beta, **kw), bnd)
        t = time_pair(lambda: group_norm_apply(x, mean, rstd, gamma, beta, act=act),
                      lambda: group_norm_apply_ref(x, mean, rstd, gamma, beta, act=act), bnd)
        st = time_pair(lambda: group_norm_stats(x, groups=32, eps=eps),
                       lambda: group_norm_stats_ref(x, groups=32, eps=eps), st_bnd)
        # the library GroupNorm on the channels-last NCHW view, SiLU after it
        xc, gb, bb = x.permute(0, 3, 1, 2), gamma.to(x.dtype), beta.to(x.dtype)

        def library():
            o = F.group_norm(xc, 32, gb, bb, eps)
            return F.silu(o) if act == "silu" else o

        lib_ms = device_ms(library, bnd[0])
        pair_ms = st[2] + t[2]
        for route, ms in (("fused", ft[2]), ("K3+K5", pair_ms), ("library", lib_ms)):
            per_eval[route] += count * ms
        log(f"group_norm (2, {hw}², {c}) act={act}: fused stats_rel {f_stats:.3e} rms_rel "
            f"{f_rms:.3e}  {timing_text(ft)}; K3+K5 device {pair_ms:.4f} ms (K5 rms_rel "
            f"{rms:.3e}  {timing_text(t)}; K3 stats_rel {stats_err:.3e}  {timing_text(st)}); "
            f"library {lib_ms:.4f} ms")
        if not (f_rms <= K5_RMS_REL and rms <= K5_RMS_REL):
            raise AssertionError(f"GroupNorm rms rel error: fused {f_rms}, K5 {rms} > {K5_RMS_REL}")
        if not (f_stats <= STATS_REL and stats_err <= STATS_REL):
            raise AssertionError(f"GroupNorm stats rel error: fused {f_stats}, K3 {stats_err} "
                                 f"> {STATS_REL}")
        case = f"(2, {hw}^2, {c}) {act or 'none'}"
        record(out, "group_norm_fused", case, f_abs, ft, bnd,
               (lib_ms, "F.group_norm" + (" + F.silu" if act == "silu" else "")),
               stats_max_rel=f_stats, k3_k5_device_ms=pair_ms, per_eval=count)
        record(out, "group_norm_apply", case, max_abs, t, bnd)
        xg = x.view(2, hw * hw, 32, c // 32)
        stats_abs = max(rel_errors(mean, rm)[0], rel_errors(rstd, rr)[0])
        record(out, "group_norm_stats", "K3 " + case, stats_abs, st, st_bnd,
               (device_ms(lambda: torch.var_mean(xg, dim=(1, 3)), st_bnd[0]), "torch.var_mean"))
    log("GroupNorm device ms over one UNet eval's 61 GroupNorms: "
        + ", ".join(f"{route} {ms:.4f}" for route, ms in per_eval.items()))
    out["group_norm_per_eval_ms"] = per_eval

    for m, k, f in UNET_GEGLU:
        x = randn(m, k)
        w = (torch.randn((2 * f, k), generator=g, device=dev) / k**0.5).to(torch.bfloat16)
        b = (torch.randn((2 * f,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        got = linear_geglu_fused(x, w, b)
        torch.cuda.synchronize()
        max_abs, max_rel, rms = rel_errors(got, linear_geglu_fused_ref(x, w, b))
        bnd = bound(2 * m * k * 2 * f, 2 * (m * k + 2 * f * k + 2 * f + m * f))
        t = time_pair(lambda: linear_geglu_fused(x, w, b),
                      lambda: linear_geglu_fused_ref(x, w, b), bnd)
        unfused_ms = device_ms(lambda: linear_geglu_plain(x, w, b), bnd[0])
        log(f"K4 linear_geglu M={m} K={k} F={f}: max_rel {max_rel:.3e} rms_rel {rms:.3e}  "
            f"{timing_text(t)}  (unfused bf16 erf route: device {unfused_ms:.4f} ms)")
        if not rms <= K4_RMS_REL:
            raise AssertionError(f"K4 rms rel error {rms} > {K4_RMS_REL}")
        record(out, "linear_geglu", f"M={m} K={k} F={f}", max_abs, t, bnd,
               unfused_route_ms=unfused_ms)

    # K6: level-0 self-attention, head-split views; then a ragged kv tail.
    # The whole call (pre-processing and body) is held against the plain
    # version, the pre-processing alone against its own, and the body timed
    # alone on the pre-processing's output; K1 at the same shape beside it.
    for b, h, sq, sk, d in [(2, 8, 4096, 4096, 40), (2, 8, 4096, 1000, 40)]:
        q = randn(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        k = (randn(b, sk, h * d) + 0.5).view(b, sk, h, d).transpose(1, 2)
        v = (randn(b, sk, h * d) - 0.3).view(b, sk, h, d).transpose(1, 2)
        scale = d ** -0.5
        got = flash_attention_int8(q, k, v)
        again = flash_attention_int8(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K6: two calls on the same inputs differ")
        max_abs, max_rel, rms = rel_errors(got, flash_attention_int8_ref(q, k, v,
                                                                         block_k=kv_tile(d)))
        exact = rel_errors(got, flash_attention_ref(q, k, v))[2]
        inputs = quantize_qkv_cuda(q, k, v, scale)
        code_diff, code_share, f32_rel = prep_errors(
            torch, inputs, kernel_inputs(q.float(), k.float(), v.float(), scale))
        bnd = bound(4 * b * h * sq * sk * d, 2 * b * h * d * (2 * sq + 2 * sk), PEAK_INT8)
        t = time_pair(lambda: flash_attention_int8(q, k, v),
                      lambda: flash_attention_int8_ref(q, k, v, block_k=kv_tile(d)), bnd)
        prep_bnd = bound(0, sum(x.numel() * x.element_size() for x in (q, k, v, *inputs)))
        prep_t = time_pair(lambda: quantize_qkv_cuda(q, k, v, scale),
                           lambda: kernel_inputs(q, k, v, scale), prep_bnd)
        body_ms = device_ms(lambda: flash_attention_int8_body(inputs, q.shape), bnd[0])
        k1_ms = device_ms(lambda: flash_attention(q, k, v), bnd[0])
        exp2_floor = b * h * sq * sk / EXP2_PER_S * 1e3
        log(f"K6 flash_attention_int8 q={tuple(q.shape)} kv={sk}: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e} (exact attention: rms_rel {exact:.3e}); pre-processing: codes "
            f"off by {code_diff} on {code_share:.2e} of them, f32 max_rel {f32_rel:.2e}  "
            f"{timing_text(t)}; device: pre-processing {prep_t[2]:.4f} ms, body {body_ms:.4f} "
            f"ms, K1 at this shape {k1_ms:.4f} ms, exp2 floor {exp2_floor:.4f} ms")
        if not rms <= K6_RMS_REL:
            raise AssertionError(f"K6 rms rel error {rms} > {K6_RMS_REL}")
        if not exact <= K6_EXACT_RMS_REL:
            raise AssertionError(f"K6 vs exact attention: rms rel {exact} > {K6_EXACT_RMS_REL}")
        if not (code_diff <= 1 and code_share <= PREP_CODE_SHARE and f32_rel <= PREP_F32_REL):
            raise AssertionError(f"K6 pre-processing: codes off by {code_diff} on {code_share} "
                                 f"of them, f32 rel {f32_rel}")
        case = f"({b}, {h}, {sq}x{sk}, {d})"
        record(out, "flash_attention_int8", case, max_abs, t, bnd, exp2_floor_ms=exp2_floor,
               prep_device_ms=prep_t[2], body_device_ms=body_ms, k1_device_ms=k1_ms)
        record(out, "quantize_qkv", case, float(code_diff), prep_t, prep_bnd,
               code_mismatch_share=code_share, f32_max_rel=f32_rel)


def prep_errors(torch, got, ref):
    """K6's pre-processing against its plain version: (largest int8 code
    difference, share of codes that differ, largest relative error of the
    f32 outputs), each two calls bit-identical."""
    diff, share, rel = 0, 0.0, 0.0
    for name, a, r in zip(got._fields, got, ref):
        if a.shape != r.shape or a.dtype != r.dtype:
            raise AssertionError(f"K6 pre-processing {name}: {a.shape} {a.dtype} != "
                                 f"{r.shape} {r.dtype}")
        if a.dtype == torch.int8:
            dd = (a.int() - r.int()).abs()
            diff = max(diff, dd.max().item())
            share = max(share, (dd > 0).float().mean().item())
        else:
            rel = max(rel, rel_errors(a, r)[1])
    return diff, share, rel


def build_pipeline(torch, dev):
    """SD1.5 at full width with seeded random weights, through the entry
    points a user calls."""
    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import (
        SD15_TEXT_ENCODER, SD15_UNET, SD_VAE, AutoencoderKL, CLIPTextModel,
        UNet2DConditionModel, init_weights_,
    )
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    unet = init_weights_(UNet2DConditionModel(SD15_UNET, device=dev, dtype=bf16), gen)
    vae = init_weights_(AutoencoderKL(SD_VAE, device=dev, dtype=bf16), gen)
    te = init_weights_(CLIPTextModel(SD15_TEXT_ENCODER, device=dev, dtype=bf16), gen)
    pipe = sfast_tpu_torch.compile(
        StableDiffusionPipeline(unet, vae, te, DPMSolverMultistepScheduler(), vae_encode=vae,
                                device=dev, dtype=bf16),
        CompilationConfig.Default(),
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (unet, vae, te) for p in m.parameters())
    log(f"models built: {n_params / 1e6:.1f} M params in {time.perf_counter() - t0:.1f} s")
    return pipe


def call_kwargs(torch, **extra):
    """The pipeline's arguments of every image: seeded prompt ids, SD1.5
    at 512², 50 steps, CFG 7.5, each unless ``extra`` gives another."""
    prompt_ids = torch.randint(0, 49408, (1, 77), generator=torch.Generator().manual_seed(1))
    return {**dict(prompt_ids=prompt_ids, height=512, width=512, num_inference_steps=STEPS,
                   guidance_scale=7.5), **extra}


def run_mode(torch, dev, pipe, label, cfg, expected, lat, base=None, timed_images=3,
             profile=True, **extra):
    """One run of the pipeline under ``cfg`` with the call arguments
    ``base`` (SD1.5's, ``call_kwargs``, where None) and ``extra``: the first
    image (which captures the graphs), the counted image, ``timed_images``
    timed, the
    latents and image of the initial latents ``lat`` (of seed 5 where
    ``lat`` is None), and a profiled image of a graphed path unless not
    ``profile``.  Returns what the comparisons of phases 4 to 7 and 10
    need."""
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    pipe.set_compilation_config(cfg)
    kw = dict(base or call_kwargs(torch), **extra)
    fixed = {"seed": 5} if lat is None else {"latents": lat}

    def timed(**extra):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(**kw, **extra)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, first_ms = timed(seed=0)  # captures every graph of the path
    graphs = graph_summary(torch, pipe)
    log(f"[{label}] first image {first_ms:.1f} ms; graphs captured: {graphs_text(graphs)}")
    if cfg.enable_cuda_graph and not graphs:
        raise AssertionError(f"[{label}] no graph was captured")

    # the counted main-path run
    cuda_build.reset_launch_counts()
    out, _ = timed(seed=0)
    counts = dict(cuda_build.launch_counts)
    log(f"[{label}] launches per image: {counts}")
    if counts != expected:
        raise AssertionError(f"[{label}] launch counts {counts} != {expected}")
    img = out.images
    if img.shape != (1, kw["height"], kw["width"], 3) or str(img.dtype) != "uint8":
        raise AssertionError(f"[{label}] image {img.shape} {img.dtype}")

    with CardSampler() as card:
        runs = [timed(seed=s)[1] for s in range(1, timed_images + 1)]
    e2e = statistics.median(runs)
    log(f"[{label}] e2e ms: runs {[round(r, 3) for r in runs]} median {e2e:.3f}; card: "
        f"{card.text()}")

    latents = pipe(**kw, **fixed, output_type="latent").images
    image_f = pipe(**kw, **fixed, output_type="float").images
    if not bool(torch.isfinite(image_f).all()) or image_f.float().std().item() == 0.0:
        raise AssertionError(f"[{label}] decoded image is not finite or is constant")
    # a graphed image only: tracing an eager one takes many times its
    # length, and its device time is the graphed image's.  Its idle share
    # is read against the timed images' median wall time
    prof = profile_image(torch, lambda: pipe(**kw, seed=4), label,
                         unprofiled=(e2e, card.text())) if cfg.enable_cuda_graph and profile else {}
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    log(f"[{label}] peak memory {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved "
        "(the graphs' pools included)")
    return {"counts": counts, "latents": latents, "u8": denormalize_to_uint8(image_f),
            "e2e_ms": e2e, "peak_gib": peak, "peak_reserved_gib": reserved, "graphs": graphs,
            **prof}


def pipe_graphs(pipe):
    """Every graph ``pipe`` holds, by the name of what holds it: its
    compiled models, its compiled scheduler's step and its fused loops."""
    out = {}
    for attr in ("text_encoder", "text_encoder_2", "image_encoder", "unet", "controlnet", "vae",
                 "vae_encode"):
        call = getattr(getattr(pipe, attr, None), "_call", None)
        if call is not None and call.cache_size:
            out[attr] = call.graphs()
    decode = getattr(pipe, "_decode_u8", None)  # the SVD pipeline's decode to uint8
    if getattr(decode, "cache_size", 0):
        out[decode.name] = decode.graphs()
    step = getattr(pipe.scheduler, "_step", None)
    if step is not None and step.cache_size:
        out["scheduler.step"] = step.graphs()
    for loop in pipe._fused_loops.values():
        if getattr(loop, "cache_size", 0):
            out[loop.name] = loop.graphs()
    return out


def graph_summary(torch, pipe, replay=True):
    """Per holder of ``pipe``'s graphs: how many, their nodes, capture and
    instantiate seconds and (``replay``) the host ms until a ``replay()``
    returns; each graph has a memory pool of its own."""
    out = {}
    for name, gs in pipe_graphs(pipe).items():
        out[name] = {"graphs": len(gs), "nodes": sum(g.nodes for g in gs),
                     "capture_s": sum(g.capture_seconds for g in gs),
                     "instantiate_s": sum(g.instantiate_seconds for g in gs)}
        if replay:  # a loop of 100k nodes and more replays once: seconds a replay
            out[name]["launch_host_ms"] = sum(
                launch_host_ms(torch, g.graph, tries=1 if g.nodes > 100000 else 3) for g in gs)
    return out


def graphs_text(graphs):
    return ", ".join(
        f"{k} {v['graphs']} ({v['nodes']} nodes, capture {v['capture_s']:.3f} s, "
        f"instantiate {v['instantiate_s']:.3f} s"
        + (f", replay() returns after {v['launch_host_ms']:.3f} ms on the host"
           if "launch_host_ms" in v else "") + ")" for k, v in graphs.items()) or "none"


def log_pools(torch, pipe, label):
    """The graphs ``pipe`` holds at the end of a phase (one memory pool
    each) and the peak memory so far."""
    log(f"[{label}] graphs held: {graphs_text(graph_summary(torch, pipe, replay=False))}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved")


def launch_host_ms(torch, graph, tries=3):
    """Median host milliseconds until ``graph.replay()`` returns, on an idle
    card: the cost of submitting the graph, which the device waits for
    unless earlier work keeps it busy.  The replay reruns the graph on its
    static inputs, which changes no caller's tensor."""
    times = []
    for _ in range(tries):
        torch.cuda.synchronize()
        t = time.perf_counter()
        graph.replay()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def compare_runs(torch, label, ref, got):
    """``got``'s latents and image against ``ref``'s, from the same
    initial latents: the image within 1 uint8 level."""
    _, _, rms = rel_errors(got["latents"], ref["latents"])
    diff = (got["u8"].int() - ref["u8"].int()).abs().max().item()
    log(f"[{label}] same latents: max uint8 difference {diff}, latents rms_rel {rms:.3e}")
    if diff > 1:
        raise AssertionError(f"[{label}] images differ by {diff} uint8 levels")
    return {"max_uint8_diff": diff, "latents_rms_rel": rms}


def run_path(torch, dev, pipe, name, cfg, expected, model_bound, lat):
    """Phases 4 and 5: one path of the pipeline, eager then graphed.
    Returns both runs' results."""
    from sfast_tpu_torch.models import SD_VAE

    bf16 = torch.bfloat16
    # one timed eager image: an eager image follows the shared host
    res = {"eager": run_mode(torch, dev, pipe, f"{name} eager",
                             cfg.replace(enable_cuda_graph=False), expected, lat,
                             timed_images=1)}
    res["graphed"] = run_mode(torch, dev, pipe, f"{name} graphed", cfg, expected, lat)
    res["graphed_vs_eager"] = compare_runs(torch, f"{name} graphed vs eager", res["eager"],
                                           res["graphed"])

    gen = torch.Generator(device=dev).manual_seed(6)
    with torch.inference_mode():
        ctx = pipe.encode_prompt(torch.randint(0, 49408, (1, 77), generator=gen, device=dev))
        x = torch.randn((2, 64, 64, 4), generator=gen, device=dev).to(bf16)
        z = torch.randn((1, 64, 64, 4), generator=gen, device=dev) / SD_VAE.scaling_factor
    res["route"] = route_check(torch, dev, pipe, name, cfg, model_bound,
                               (x, torch.tensor(801.0, device=dev), ctx), {}, z)
    return res


def route_check(torch, dev, pipe, name, cfg, model_bound, unet_args, unet_kw, z):
    """Kernel route against plain route at full width: one UNet eval and
    one VAE decode of ``z``, with the path's graphs in place; the switch
    drops them, so the plain route must launch no kernel."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.runtime import cuda_build

    out = {}
    with torch.inference_mode():
        for route, rcfg in (("kernels", cfg), ("plain", CompilationConfig(enable_kernels=False))):
            if route == "plain":
                pipe.set_compilation_config(rcfg)
            cuda_build.reset_launch_counts()
            out[route] = (pipe.unet(*unet_args, **unet_kw), pipe.vae.decode(z))
            torch.cuda.synchronize()
            out[route + " launches"] = sum(cuda_build.launch_counts.values())
        pipe.set_compilation_config(CompilationConfig.Default())
    log(f"[{name}] route check: kernel route launched {out['kernels launches']} kernels, "
        f"plain route {out['plain launches']}")
    if out["plain launches"] != 0 or out["kernels launches"] == 0:
        raise AssertionError(f"[{name}] the plain route launched {out['plain launches']} "
                             f"kernels, the kernel route {out['kernels launches']}")
    for i, what in enumerate(("UNet eps", "VAE image")):
        _, max_rel, rms = rel_errors(out["kernels"][i], out["plain"][i])
        log(f"[{name}] {what}, kernel route vs plain route: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e}")
        if not 0 < rms <= model_bound:
            raise AssertionError(f"[{name}] {what}: rms rel {rms} not in (0, {model_bound}]")
        out[what + " rms_rel"] = rms
    return {k: v for k, v in out.items() if k.endswith(("launches", "rms_rel"))}


def profile_image(torch, run, name, unprofiled, tries=5, what="image"):
    """One image (or other ``what``: a train step) under torch.profiler:
    device time, the device's idle share of the image's wall time and the
    count of CUDA kernels the image launches (every host dispatch that
    reaches the card).  The profiler now
    and then loses kernel rows; a trace whose rows of the port's kernels do
    not match the launches ``cuda_build`` counted during it is taken again,
    and after ``tries`` such traces this raises.  ``unprofiled``: (wall ms,
    card text) of the unprofiled images of the same inputs that the caller
    has just timed.

    Tracing slows the card's kernels a little, so where the device is busy
    throughout, the traced device time may exceed the unprofiled wall
    time: the idle share is then below what this measures, and reads
    ``None``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sfast_tpu_torch.runtime import cuda_build

    wall_ms, card_text = unprofiled
    for _ in range(tries):
        cuda_build.reset_launch_counts()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
        launches = dict(cuda_build.launch_counts)
        events = prof.key_averages()
        # the kernels' own rows: an operator's row repeats its kernels' time,
        # and so does a user annotation's range on the device (the
        # optimizer's ``Optimizer.step#AdamW.step``)
        rows = [e for e in events if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        seen = {k: [sum(e.count for e in rows if piece in e.key) for piece in pieces]
                for k, pieces in KERNEL_ROWS.items()}
        lost = {k: c for k, c in seen.items() if any(n != launches[k] for n in c)}
        if not lost:
            break
        log(f"    [{name}] profiler trace lost kernel rows: rows {lost} against launches "
            f"{launches}; tracing again")
    else:
        raise RuntimeError(f"[{name}] {tries} profiler traces of one {what} lost kernel rows")
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    n_kernels = sum(e.count for e in rows)
    host_launches = {e.key: e.count for e in events
                     if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCH_CALLS}
    idle = 1 - dev_ms / wall_ms if dev_ms < wall_ms else None
    idle_text = (f"device idle {100 * idle:.1f}%" if idle is not None else
                 "device idle not resolved (traced device time above the wall time)")
    log(f"[{name}] profile: device time {dev_ms:.1f} ms per {what}; unprofiled {what} "
        f"{wall_ms:.1f} ms -> {idle_text}; "
        f"{n_kernels} CUDA kernels per {what}; the traced {what} took {traced_ms:.1f} ms; "
        f"card during the unprofiled {what}: {card_text}")
    log(events.table(sort_by="self_device_time_total", row_limit=15))
    return {"device_ms": dev_ms, "idle": idle, "cuda_kernels": n_kernels,
            "host_launches": host_launches, "profiled_wall_ms": wall_ms,
            "traced_wall_ms": traced_ms}


def synthetic_image(hw=512, width=None):
    """(a seeded uint8 RGB image of hw² pixels, or hw × ``width``, a mask
    whose right half is white: repaint)."""
    import numpy as np

    width = width or hw
    rng = np.random.default_rng(7)
    # smooth colour gradients plus noise, so the encoder sees structure
    yy, xx = np.mgrid[0:hw, 0:width]
    yy, xx = yy / hw, xx / width
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1) * 200 + 20
    image = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)[None]
    mask = np.zeros((hw, width), np.uint8)
    mask[:, width // 2:] = 255
    return image, mask


def eager_once(torch, pipe, kw):
    """One eager image of ``kw`` (seed 5): its latents and uint8 image."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    latents = pipe(**kw, seed=5, output_type="latent").images
    with torch.inference_mode():
        image = pipe.vae.decode(latents / pipe.vae.config.scaling_factor)
    pipe.set_compilation_config(CompilationConfig.Default())
    return {"latents": latents, "u8": denormalize_to_uint8(image)}


def run_img2img(torch, dev, pipe):
    """Phase 7: img2img and inpainting graphed, each against one eager
    image; then one VAE encode on the kernel route against the plain
    route."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.utils.image import preprocess_image

    image, mask = synthetic_image()
    res = {}
    for name, mask_image in (("img2img", None), ("inpaint", mask)):
        extra = dict(image=image, strength=STRENGTH, mask_image=mask_image)
        # inpainting is not profiled: its graphs and kernels are img2img's
        run = run_mode(torch, dev, pipe, name, CompilationConfig.Default(),
                       EXPECTED_IMG2IMG_LAUNCHES, None, profile=mask_image is None, **extra)
        enc = run["graphs"].get("vae_encode")
        if enc is None:
            raise AssertionError(f"[{name}] no vae_encode graph was captured")
        log(f"[{name}] the encode's graph: {enc['nodes']} nodes, captured in "
            f"{enc['capture_s']:.3f} s, instantiated in {enc['instantiate_s']:.3f} s")
        run["vs_eager"] = compare_runs(torch, f"{name} graphed vs eager",
                                       eager_once(torch, pipe, call_kwargs(torch, **extra)), run)
        res[name] = run

    res.update(encode_route_check(torch, pipe, preprocess_image(image, torch.bfloat16, dev),
                                  "encode", {"conv3x3": 12, "group_norm_stats": 6}))
    return res


def encode_route_check(torch, pipe, img, label, expected):
    """One graphed VAE encode of ``img`` on the kernel route against the
    plain route: the kernel route launches ``expected``, the plain route
    nothing, and mean and logvar agree within MODEL_RMS_REL."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.runtime import cuda_build

    res, out = {}, {}
    with torch.inference_mode():
        for route, rcfg in (("kernels", CompilationConfig.Default()),
                            ("plain", CompilationConfig(enable_kernels=False))):
            pipe.set_compilation_config(rcfg)
            pipe.vae_encode(img)  # the capture: three warm-up calls count as launches
            cuda_build.reset_launch_counts()
            out[route] = pipe.vae_encode(img)
            torch.cuda.synchronize()
            out[route + " launches"] = dict(cuda_build.launch_counts)
            # CUDA events around one replay: the profiler's trace of a replayed
            # encode drops a kernel record or two (counts not a multiple of the
            # calls), and beside a replay of milliseconds the host's launch of one
            # graph is negligible
            res[f"encode_{route}_ms"] = cuda_ms(lambda: pipe.vae_encode(img))
    hw = img.shape[1]
    log(f"[{label}] one graphed encode of a {hw}² image (CUDA events): "
        f"{res['encode_kernels_ms']:.3f} ms on the kernel route, "
        f"{res['encode_plain_ms']:.3f} ms on the plain route")
    pipe.set_compilation_config(CompilationConfig.Default())
    launched = {k: n for k, n in out["kernels launches"].items() if n}
    log(f"[{label}] route check: kernel route launched {launched}, plain route "
        f"{sum(out['plain launches'].values())} kernels")
    if sum(out["plain launches"].values()) or launched != expected:
        raise AssertionError(f"[{label}] launches: kernel route {launched} (expected "
                             f"{expected}), plain route {out['plain launches']}")
    for i, what in enumerate(("mean", "logvar")):
        _, max_rel, rms = rel_errors(out["kernels"][i], out["plain"][i])
        log(f"[{label}] {what}, kernel route vs plain route: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e}")
        if not 0 < rms <= MODEL_RMS_REL:
            raise AssertionError(f"[{label}] {what}: rms rel {rms} not in (0, {MODEL_RMS_REL}]")
        res[f"encode_{what}_rms_rel"] = rms
    return res


def module_bytes(module) -> int:
    """Bytes of a module's parameters and buffers (a quantized site's int8
    weight, scales and bias included)."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


def fresh_unet(torch, dev, module, state):
    """A new module of ``module``'s class and config holding ``state``
    (IP-Adapter projections added where ``state`` has them)."""
    from sfast_tpu_torch import ip_adapter

    fresh = type(module)(module.config, device=dev, dtype=module.dtype)
    if any(".to_k_ip." in k for k in state):
        ip_adapter.add_ip_projections(fresh)
    fresh.load_state_dict(state)
    return fresh


def lora_swap_check(torch, dev, pipe, slot, kw, expected, label, cfg=None):
    """A seeded rank-8 LoRA on every attention projection of the module in
    ``pipe``'s ``slot``, swapped into the stepwise graphs of ``cfg`` (the
    default config where None): the image changes, the launches are
    ``expected``, no graph is captured, and swapping back restores the base
    image bit for bit."""
    from sfast_tpu_torch import CompilationConfig, lora
    from sfast_tpu_torch.runtime import cuda_build

    sub = getattr(pipe, slot)
    base = {k: v.clone() for k, v in sub.module.state_dict().items()}
    lo = lora.init_lora_params(torch.Generator(device=dev).manual_seed(12), base, rank=LORA_RANK)
    g = torch.Generator(device=dev).manual_seed(13)
    for f in lo.values():
        f["b"] = torch.randn(f["b"].shape, generator=g, device=dev) * 0.02
    pipe.set_compilation_config(cfg or CompilationConfig.Default())
    pipe(**kw)  # captures the stepwise graphs
    base_img = pipe(**kw).images
    graphs = pipe_graphs(pipe)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lora.switch_lora(sub, base, lo)
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    img = pipe(**kw).images
    counts = dict(cuda_build.launch_counts)
    captured = pipe_graphs(pipe) != graphs
    changed = (img.int() - base_img.int()).abs().max().item()
    lora.switch_lora(sub, base, lo, 0.0)
    restored = torch.equal(pipe(**kw).images, base_img)
    row = {"lora_modules": len(lo), "swap_host_ms": host_ms, "image_max_uint8_change": changed,
           "captured": captured, "restored_bit_for_bit": restored}
    log(f"[{label}] {len(lo)} modules of the {slot}, rank {LORA_RANK}: swap {host_ms:.2f} ms on "
        f"the host; image changed by up to {changed} uint8 levels; launches {counts}; a graph "
        f"captured: {captured}; swapped back, base image bit for bit: {restored}")
    if counts != expected or captured or changed == 0 or not restored:
        raise AssertionError(f"[{label}] swap: launches {counts} (expected {expected}), "
                             f"captured {captured}, change {changed}, restored {restored}")
    del base
    return row


def quant_image(torch, pipe, label, kw, expected):
    """A quantized pipeline's image path: the first image (which captures
    anew: the quantization dropped the UNet's graphs), then the counted
    image (``expected`` launches), which is also the timed one."""
    from sfast_tpu_torch.runtime import cuda_build

    def run(seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(**kw, seed=seed).images
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    if pipe.unet.cache_size or pipe._fused_loops:
        raise AssertionError(f"[{label}] the quantization left graphs of the bf16 UNet")
    _, first_ms = run(0)
    captured = pipe.unet.cache_size
    cuda_build.reset_launch_counts()
    with CardSampler() as card:  # seed 0, as the caller's bf16 image
        img, e2e = run(0)
    counts = dict(cuda_build.launch_counts)
    log(f"[{label}] first image {first_ms:.1f} ms (the UNet captured anew: {captured} graph); "
        f"launches {counts}; e2e {e2e:.3f} ms; card: {card.text()}")
    if counts != expected or not captured:
        raise AssertionError(f"[{label}] launches {counts} (expected {expected}), "
                             f"{captured} UNet graphs captured")
    if img.float().std().item() == 0:
        raise AssertionError(f"[{label}] constant image")
    return {"counts": counts, "first_ms": first_ms, "e2e_ms": e2e, "img": img,
            "graphs": graph_summary(torch, pipe, replay=False)}


def run_quant(torch, dev, pipe, label, kw, expected, bf16_e2e, calibrate):
    """Phase 14 on one pipeline: W8A16, dynamic W8A8 and calibrated static
    W8A8 (both with convs) of its UNet, each on a fresh bf16 copy in the
    compiled slot: the quantized compiled pipeline captures anew, its image
    differs from bf16, its launches are bf16's, its graphed latents of 10
    steps equal the eager ones bit for bit; e2e against bf16's, the UNet's
    weight bytes after the bf16 weights are freed, and the latents' relative
    rms against bf16's after 10 steps.  ``calibrate(pipe)`` gives the
    static mode's Calibration."""
    from sfast_tpu_torch import CompilationConfig, compile_model, quant

    cfg = CompilationConfig.Default()
    pipe.set_compilation_config(cfg)
    kw = dict(kw, output_type="pt")
    lat_kw = dict(kw, num_inference_steps=QUANT_LATENT_STEPS, seed=3, output_type="latent")
    state = {k: v.clone() for k, v in pipe.unet.module.state_dict().items()}
    bf16_img = pipe(**kw, seed=0).images  # the bf16 graphs, captured
    bf16_lat = pipe(**lat_kw).images
    res = {"bf16": {"e2e_ms": bf16_e2e, "unet_weight_bytes": module_bytes(pipe.unet.module)}}
    for i, (mode, qkw) in enumerate(QUANT_MODES):
        name = f"{label} {mode}"
        if i:  # a fresh bf16 UNet of the same weights in the compiled slot
            fresh = fresh_unet(torch, dev, pipe.unet.module, state)
            pipe.unet = compile_model(fresh, cfg, name="unet")
            pipe.set_compilation_config(cfg)
            del fresh
        had = pipe.unet.cache_size
        t0 = time.perf_counter()
        cal = calibrate(pipe) if mode.endswith("static") else None
        cal_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quant.quantize_pipeline(pipe, act_scales=cal, **qkw)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        n_sites = sum(1 for m in pipe.unet.module.modules() if getattr(m, "w_scale", None)
                      is not None)
        n_static = sum(1 for m in pipe.unet.module.modules()
                       if getattr(m, "a_scale", None) is not None)
        del cal
        gc.collect()
        torch.cuda.empty_cache()
        row = quant_image(torch, pipe, name, kw, expected)
        img = row.pop("img")
        changed = (img.int() - bf16_img.int()).abs().max().item()
        lat = pipe(**lat_kw).images
        pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
        eager_lat = pipe(**lat_kw).images
        pipe.set_compilation_config(cfg)
        rms = rel_errors(lat, bf16_lat)[2]
        row.update(sites=n_sites, static_sites=n_static, graphs_before=had,
                   calibrate_s=cal_s, quantize_s=quant_s, image_max_uint8_vs_bf16=changed,
                   unet_weight_bytes=module_bytes(pipe.unet.module),
                   graphed_vs_eager_bit_equal=torch.equal(lat, eager_lat),
                   latents_rms_rel_vs_bf16=rms, e2e_vs_bf16=row["e2e_ms"] / bf16_e2e)
        log(f"[{name}] {n_sites} sites ({n_static} static; calibration {cal_s:.1f} s, "
            f"quantization {quant_s:.2f} s); the bf16 slot held {had} UNet graphs; image vs "
            f"bf16 up to {changed} uint8 levels; e2e {row['e2e_ms']:.3f} ms against bf16's "
            f"{bf16_e2e:.3f} ({row['e2e_vs_bf16']:.3f}x); UNet weights "
            f"{row['unet_weight_bytes'] / 2**30:.3f} GiB (bf16 "
            f"{res['bf16']['unet_weight_bytes'] / 2**30:.3f}); {QUANT_LATENT_STEPS}-step latents "
            f"rms_rel vs bf16 {rms:.4f}, graphed vs eager bit for bit "
            f"{row['graphed_vs_eager_bit_equal']}")
        if changed == 0 or not row["graphed_vs_eager_bit_equal"] or not 0 < rms < QUANT_RMS_REL:
            raise AssertionError(f"[{name}] image change {changed}, graphed vs eager "
                                 f"{row['graphed_vs_eager_bit_equal']}, latents rms {rms}")
        if i == 0 and had == 0:
            raise AssertionError(f"[{name}] the bf16 pipeline held no UNet graph to drop")
        res[mode] = row
    pipe.set_compilation_config(cfg)
    del state
    return res


# Phase 15: SD1.5's published configurations (runwayml/stable-diffusion-v1-5:
# unet/, vae/ and text_encoder/config.json), as diffusers' and transformers'
# objects carry them.  The text encoder's file states eos_token_id 2, which
# transformers reads as "the highest id"; the stub names that id, 49407, the
# port's SD15_TEXT_ENCODER's.
SD15_UNET_CONFIG = dict(
    act_fn="silu", attention_head_dim=8, block_out_channels=[320, 640, 1280, 1280],
    center_input_sample=False, cross_attention_dim=768,
    down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"], downsample_padding=1,
    flip_sin_to_cos=True, freq_shift=0, in_channels=4, layers_per_block=2,
    mid_block_scale_factor=1, norm_eps=1e-05, norm_num_groups=32, out_channels=4, sample_size=64,
    up_block_types=["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3)
SD15_VAE_CONFIG = dict(
    act_fn="silu", block_out_channels=[128, 256, 512, 512],
    down_block_types=["DownEncoderBlock2D"] * 4, in_channels=3, latent_channels=4,
    layers_per_block=2, norm_num_groups=32, out_channels=3, sample_size=512,
    up_block_types=["UpDecoderBlock2D"] * 4)
SD15_CLIP_CONFIG = dict(
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, max_position_embeddings=77, hidden_act="quick_gelu",
    projection_dim=768, bos_token_id=0, eos_token_id=49407, pad_token_id=1)
SD15_SCHEDULER_CONFIG = dict(
    beta_end=0.012, beta_schedule="scaled_linear", beta_start=0.00085, num_train_timesteps=1000,
    prediction_type="epsilon", steps_offset=1, timestep_spacing="leading")
MAP_REQUESTS = 4
WARM_HW = (512, 768)


class ForeignModule:
    """A diffusers or transformers module as ``sfast_tpu_torch.compile``
    sees it: its ``config``, its ``state_dict()`` and ``named_parameters``
    (here a port module's tensors, which take diffusers' names); calling it
    raises, so a compile that wrapped it would fail."""

    def __init__(self, config, module):
        self.config = config
        self._module = module

    def state_dict(self):
        return self._module.state_dict()

    def named_parameters(self):
        return self._module.named_parameters()

    def __call__(self, *args, **kwargs):
        raise AssertionError(f"{type(self).__name__}: a foreign module was called")


def diffusers_stub(pipe):
    """A diffusers-shaped SD1.5 pipeline over phase 4's modules, built from
    plain objects: neither diffusers nor transformers is imported."""
    import types

    def foreign(name, config, module):
        return type(name, (ForeignModule,), {})(config, module)

    return types.SimpleNamespace(
        unet=foreign("UNet2DConditionModel", SD15_UNET_CONFIG, pipe.unet.module),
        vae=foreign("AutoencoderKL", SD15_VAE_CONFIG, pipe.vae.module),
        text_encoder=foreign("CLIPTextModel", types.SimpleNamespace(**SD15_CLIP_CONFIG),
                             pipe.text_encoder.module),
        tokenizer=None,
        scheduler=type("DPMSolverMultistepScheduler", (), {"config": SD15_SCHEDULER_CONFIG})())


def host_syncs(torch, run):
    """The synchronizing CUDA calls PyTorch reports during ``run()``
    (``torch.cuda.set_sync_debug_mode``), as 'file:line: message'; the
    mode's own note that it is a prototype is not one."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({f"{os.path.basename(w.filename)}:{w.lineno}: {str(w.message)[:80]}"
                   for w in caught if "called a synchronizing" in str(w.message)})


def run_serving(torch, dev, pipe, default, lat):
    """Phase 15: ``sfast_tpu_torch.compile`` of a diffusers-shaped stub over
    phase 4's modules, a step callback, ``map`` against sequential calls,
    a background warm-up of 512×768 while 512² images are served, and one
    UNet eval under ``memory_format='NCHW'``; every image against phase 4's
    graphed image bit for bit."""
    import numpy as np

    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig, compile_unet
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    ref_u8, res = default["graphed"]["u8"], {}
    kw = call_kwargs(torch)

    def image_of_lat(**extra):
        out = spipe(**kw, latents=lat, output_type="float", **extra).images
        return denormalize_to_uint8(out)

    def same_as_phase4(label, u8):
        if not torch.equal(u8, ref_u8):
            diff = (u8.int() - ref_u8.int()).abs().max().item()
            raise AssertionError(f"[serving] {label}: differs from phase 4's graphed image by "
                                 f"{diff} uint8 levels")

    def expect(label, counts, expected=EXPECTED_LAUNCHES):
        if counts != expected:
            raise AssertionError(f"[serving] {label}: launches {counts} != {expected}")

    # (a) the stub through compile: the port's models, their graphs, phase 4's image
    t = time.perf_counter()
    spipe = sfast_tpu_torch.compile(diffusers_stub(pipe), CompilationConfig.Default())
    torch.cuda.synchronize()
    res["compile_s"] = time.perf_counter() - t
    if type(spipe) is not StableDiffusionPipeline or spipe.unet.module is pipe.unet.module:
        raise AssertionError(f"[serving] compile gave {type(spipe).__name__} over the stub's "
                             "modules, not the port's own")
    t = time.perf_counter()
    spipe(**kw, seed=0, output_type="pt")  # the capture
    torch.cuda.synchronize()
    res["first_image_s"] = time.perf_counter() - t
    cuda_build.reset_launch_counts()
    spipe(**kw, seed=0, output_type="pt")
    torch.cuda.synchronize()
    res["counts"] = dict(cuda_build.launch_counts)
    expect("stub image", res["counts"])
    same_as_phase4("the stub's image", image_of_lat())
    log(f"[serving] compile of the diffusers-shaped stub {res['compile_s']:.2f} s (the port's "
        f"models built and loaded), first image {res['first_image_s']:.2f} s (captures); "
        f"launches {res['counts']}; its image equals phase 4's bit for bit")

    # (b) a step callback: the stepwise graphs, the same image
    steps = []
    same_as_phase4("the callback image",
                   image_of_lat(callback_on_step_end=lambda p, i, t, d: steps.append(i)))
    if steps != list(range(STEPS)):
        raise AssertionError(f"[serving] the callback ran for steps {steps}")
    res["callback_calls"] = len(steps)

    # (c) map against sequential calls, and the host syncs of a 'pt' call
    gen = torch.Generator().manual_seed(31)
    ids = [torch.randint(0, SD15_CLIP_CONFIG["vocab_size"], (1, 77), generator=gen)
           for _ in range(MAP_REQUESTS)]
    mkw = {k: v for k, v in kw.items() if k != "prompt_ids"}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3 / MAP_REQUESTS

    seq, res["sequential_ms_per_image"] = timed(
        lambda: [spipe(prompt_ids=i, seed=0, **mkw).images for i in ids])
    piped, res["map_ms_per_image"] = timed(
        lambda: [o.images for o in spipe.map(ids, window=2, seed=0, **mkw)])
    if not all(np.array_equal(a, b) for a, b in zip(seq, piped)) or len(piped) != len(seq):
        raise AssertionError("[serving] map's images differ from the sequential calls'")
    res["syncs"] = host_syncs(torch, lambda: spipe(**kw, seed=0, output_type="pt"))
    # the detector's control: a copy to pageable host memory synchronizes
    if not host_syncs(torch, lambda: torch.ones(1, device=dev).cpu()):
        raise AssertionError("[serving] the sync detector saw no sync in a copy to the host")
    log(f"[serving] {MAP_REQUESTS} requests: map(window=2) {res['map_ms_per_image']:.3f} ms per "
        f"image, sequential calls {res['sequential_ms_per_image']:.3f} (phase 4's graphed "
        f"e2e {default['graphed']['e2e_ms']:.3f}); equal bit for bit; host syncs in a "
        f"steady-state 'pt' call: {res['syncs'] or 'none'}")

    # (e) one UNet eval under memory_format='NCHW' against the NHWC eval
    g = torch.Generator(device=dev).manual_seed(32)
    with torch.inference_mode():
        ctx = spipe.encode_prompt(ids[0].to(dev))
        x = torch.randn((2, 64, 64, 4), generator=g, device=dev).to(torch.bfloat16)
        tt = torch.tensor(801.0, device=dev)
        nhwc = spipe.unet(x, tt, ctx)
        nchw_model = compile_unet(spipe.unet.module, CompilationConfig(memory_format="NCHW"))
        nchw = nchw_model(x.permute(0, 3, 1, 2).contiguous(), tt, ctx)
    res["nchw_equal"] = tuple(nchw.shape) == (2, 4, 64, 64) and torch.equal(
        nchw.permute(0, 2, 3, 1), nhwc)
    # the module's config back, which compile_unet replaced (the same routes);
    # the pipeline's graphs stay
    spipe.unet.module.compilation_config = spipe.unet.compilation_config
    del nchw_model
    if not res["nchw_equal"]:
        raise AssertionError("[serving] the NCHW UNet eval differs from the NHWC eval")

    # (d) a background warm-up of 512×768 while two 512² images are served
    slots = (spipe.unet, spipe.vae, spipe.text_encoder, spipe.scheduler)
    t0 = time.perf_counter()
    thread = spipe.warmup(resolutions=(WARM_HW,), steps=(STEPS,), background=True)
    served = []
    for _ in range(2):
        alive = thread.is_alive()
        cuda_build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        u8 = image_of_lat()
        torch.cuda.synchronize()
        served.append({"ms": (time.perf_counter() - t) * 1e3, "during_warmup": alive,
                       "counts": cuda_build.thread_launch_counts()})
        same_as_phase4("an image served during the warm-up", u8)
        expect("an image served during the warm-up", served[-1]["counts"])
    thread.join()
    res["warmup_s"] = time.perf_counter() - t0
    res["served"] = [{k: v for k, v in s.items() if k != "counts"} for s in served]
    sizes = [m.cache_size for m in slots]
    wkw = dict(kw, height=WARM_HW[0], width=WARM_HW[1], seed=5, output_type="pt")
    cuda_build.reset_launch_counts()
    warmed = spipe(**wkw).images
    res["warmed_counts"] = cuda_build.thread_launch_counts()
    if [m.cache_size for m in slots] != sizes:
        raise AssertionError(f"[serving] a {WARM_HW} image captured after the warm-up: "
                             f"{sizes} -> {[m.cache_size for m in slots]}")
    spipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))  # drops the graphs
    eager = spipe(**wkw).images
    res["warmed_vs_eager"] = (warmed.int() - eager.int()).abs().max().item()
    if res["warmed_vs_eager"] > 1:
        raise AssertionError(f"[serving] the warmed {WARM_HW} image differs from eager by "
                             f"{res['warmed_vs_eager']} levels")
    log(f"[serving] background warm-up of {WARM_HW[0]}x{WARM_HW[1]}: {res['warmup_s']:.2f} s; "
        f"served meanwhile: {[(round(s['ms'], 3), s['during_warmup']) for s in served]} ms "
        f"(during the warm-up) against {res['sequential_ms_per_image']:.3f} for the sequential "
        f"calls above, each "
        f"equal to phase 4's image with launches {served[0]['counts']}; after join the "
        f"{WARM_HW} image captured nothing (graphs {sizes}), launches {res['warmed_counts']}, "
        f"{res['warmed_vs_eager']} levels from eager")
    del spipe
    gc.collect()
    torch.cuda.empty_cache()
    return res


# Training (phase 16), the JAX example's settings
# (examples/optimize_train_text_to_image_lora.py:31-35): SD1.5's UNet in
# bf16, an f32 rank-4 LoRA, AdamW at 1e-4, batch 4 of 64×64×4 f32 latents
# and 77×768 f32 text embeddings, kernels off.  The eager step: 3 steps,
# timed; the graphed step: 3 steps from the same state on the same draws
# (the first captures), then 5 timed.
TRAIN_BATCH = 4
TRAIN_RANK = 4
TRAIN_LR = 1e-4
TRAIN_COMPARED_STEPS = 3
TRAIN_TIMED_STEPS = 5
# B's gradient at step 1 (batch 1) of the bf16 UNet against an f32 copy:
# bf16 activations through the UNet's depth, forward and backward
TRAIN_GRAD_RMS_REL = 5e-2
# graphed against eager where not bit for bit: the relative rms of the
# LoRA's factors and AdamW's moments after the compared steps
TRAIN_GRAPH_RMS_REL = 1e-5
# the refused step's forward under CompilationConfig.Default(): the 5
# level-0 self-attentions of one eval, the batch folded into each launch
EXPECTED_REFUSED_LAUNCHES = dict.fromkeys(EXPECTED_LAUNCHES, 0) | {"flash_attention": 5}
# what the host issues to the card: the profiler's rows of these CUDA API
# calls (launches, copies, memsets) in a profiled step
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def train_b_grads(torch, unet, lora0, batch, t, noise, ccfg):
    """B's gradient (flat, f32) of one train step of ``unet`` from LoRA
    ``lora0`` on ``batch`` with the given t and noise, read by the
    optimizer's pre-step hook of an AdamW at lr 0 (the step changes
    nothing).  ``ccfg`` must be eager: a hook runs in no graph replay."""
    from sfast_tpu_torch.training import lora_factors, make_lora_train_step

    lora = {m: {k: f[k].detach().clone().requires_grad_(True) for k in ("a", "b")}
            for m, f in lora0.items()}
    opt = torch.optim.AdamW(lora_factors(lora), lr=0.0)
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(
        torch.cat([lora[m]["b"].grad.float().flatten() for m in lora])))
    make_lora_train_step(unet, opt, ccfg=ccfg)(lora, batch, t=t, noise=noise)
    return grads[0]


def training_state(lora, opt):
    """Copies of the LoRA's factors and AdamW's state, by name."""
    out = {}
    for m, f in lora.items():
        for k in ("a", "b"):
            out[f"{m}.{k}"] = f[k].detach().clone()
            for name, v in opt.state.get(f[k], {}).items():
                out[f"{m}.{k}.{name}"] = v.clone()
    return out


def compare_training(torch, label, got, ref, got_losses, ref_losses):
    """Graphed against eager after the same steps: bit for bit, or else
    the worst relative rms over the tensors (bound ``TRAIN_GRAPH_RMS_REL``)
    and the tensors that differ."""
    if got.keys() != ref.keys():
        raise AssertionError(f"[{label}] state keys differ: {sorted(got.keys() ^ ref.keys())[:4]}")
    differ = [k for k in ref if not torch.equal(got[k], ref[k])]
    worst = max((rel_errors(got[k].float(), ref[k].float())[2] for k in differ), default=0.0)
    losses_equal = all(torch.equal(a, b) for a, b in zip(got_losses, ref_losses))
    res = {"bit_for_bit": not differ and losses_equal, "tensors": len(ref),
           "tensors_differing": len(differ), "worst_rms_rel": worst, "losses_equal": losses_equal,
           "differing": differ[:6]}
    log(f"[{label}] graphed against eager after {len(ref_losses)} steps from one state on one "
        f"generator's draws: {len(ref)} tensors (factors, exp_avg, exp_avg_sq, step), "
        f"{len(differ)} differ (worst rms_rel {worst:.3e}: {differ[:6]}); losses "
        f"{[x.item() for x in got_losses]} against {[x.item() for x in ref_losses]}, "
        f"equal {losses_equal}")
    if not worst <= TRAIN_GRAPH_RMS_REL:
        raise AssertionError(f"[{label}] graphed against eager: rms_rel {worst} > "
                             f"{TRAIN_GRAPH_RMS_REL}")
    return res


def pool_bytes(torch, pool):
    """Bytes of the card's memory held by the memory pool ``pool``."""
    return sum(s["total_size"] for s in torch.cuda.memory._snapshot()["segments"]
               if tuple(s["segment_pool_id"]) == tuple(pool))


def timed_steps(torch, run, n):
    """``n`` calls of ``run``, each between syncs: (CUDA event ms, host ms,
    losses)."""
    device_ms, host_ms, losses = [], [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loss = run()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        losses.append(loss)
    return device_ms, host_ms, losses


def run_training(torch, dev, pipe, default, lat):
    """Phase 16: LoRA training on phase 4's SD1.5 UNet at full width with
    the kernels off: 3 eager steps (timed, one more profiled), then the
    graphed step from the same state on the same draws (its first call
    captures), held against the eager one, 5 timed replays and one
    profiled; B's gradient against an f32 copy; the refusal under the
    default configuration (graphed: it captures nothing); the trained LoRA
    saved and loaded (``utils/checkpoint``), then swapped into the
    compiled pipeline and back."""
    import tempfile

    from sfast_tpu_torch import CompilationConfig, lora
    from sfast_tpu_torch.models import SD15_UNET, UNet2DConditionModel
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step
    from sfast_tpu_torch.utils import checkpoint
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    graphed_cfg = CompilationConfig(enable_kernels=False)
    eager_cfg = CompilationConfig(enable_kernels=False, enable_cuda_graph=False)
    kw = call_kwargs(torch)
    res = {}

    def image():
        return denormalize_to_uint8(pipe(**kw, latents=lat, output_type="float").images)

    pipe.set_compilation_config(CompilationConfig.Default())
    if not torch.equal(image(), default["graphed"]["u8"]):  # captures the stepwise graphs
        raise AssertionError("[training] the pipeline's image before training differs from "
                             "phase 4's graphed image")
    graphs = pipe_graphs(pipe)

    # SD1.5 at 512²: 64×64×4 latents, 77×768 text embeddings
    shape = (TRAIN_BATCH, kw["height"] // 8, kw["width"] // 8, 4)
    g = torch.Generator(device=dev).manual_seed(16)
    batch = {"latents": torch.randn(shape, generator=g, device=dev),
             "context": torch.randn((TRAIN_BATCH, 77, pipe.unet.config.cross_attention_dim),
                                    generator=g, device=dev)}

    def setup():
        return lora_training_setup(pipe.unet, rank=TRAIN_RANK, learning_rate=TRAIN_LR,
                                   generator=torch.Generator(device=dev).manual_seed(17))

    trained, opt = setup()
    lora0 = {m: {k: f[k].detach().clone() for k in ("a", "b")} for m, f in trained.items()}
    t1 = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device=dev)
    noise1 = torch.randn(shape, generator=g, device=dev)

    def train(ccfg, label):
        """The compared steps of one kind from the initial LoRA and a fresh
        (capturable) AdamW, the draws on one seeded generator."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        lo, op = (trained, opt) if ccfg is graphed_cfg else setup()
        step = make_lora_train_step(pipe.unet, op, ccfg=ccfg)
        gen = torch.Generator(device=dev).manual_seed(18)
        dms, hms, losses = timed_steps(torch, lambda: step(lo, batch, gen),
                                       TRAIN_COMPARED_STEPS)
        out = {"step": step, "lora": lo, "opt": op, "gen": gen, "losses": losses,
               "state": training_state(lo, op), "first_call_ms": hms[0],
               "step_ms": dms[1:], "step_host_ms": hms[1:]}
        log(f"[training] {label}: {TRAIN_COMPARED_STEPS} steps, ms (CUDA events) "
            f"{[round(t, 3) for t in dms]}, host ms {[round(t, 3) for t in hms]}; losses "
            f"{[round(x.item(), 6) for x in losses]}")
        return out

    # the eager step: its timed steps, one profiled
    eager = train(eager_cfg, "eager step")
    unmoved = [m for m, f in eager["lora"].items() if not bool(f["b"].abs().max() > 0)]
    eager_counts = dict(cuda_build.launch_counts)
    res["eager"] = {k: eager[k] for k in ("step_ms", "step_host_ms", "first_call_ms")}
    res["eager"]["losses"] = [x.item() for x in eager["losses"]]
    res["eager"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["eager"]["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    res["eager"]["profile"] = profile_image(
        torch, lambda: eager["step"](eager["lora"], batch, eager["gen"]), "training step, eager",
        unprofiled=(statistics.median(eager["step_ms"]), "not sampled"), what="step")
    eager_state, eager_losses = eager["state"], eager["losses"]
    del eager
    if unmoved:
        raise AssertionError(f"[training] step 1 left {len(unmoved)} B factors at zero: "
                             f"{unmoved[:3]}")

    # the graphed step from the same state on the same draws
    graphed = train(graphed_cfg, "graphed step (the first call warms up 3 times and captures)")
    step = graphed["step"]
    (cg,) = step.graphs()
    pool = cg.graph.pool()
    res["graph"] = {"capture_s": cg.capture_seconds, "instantiate_s": cg.instantiate_seconds,
                    "nodes": cg.nodes, "pool_gib": pool_bytes(torch, pool) / 2**30,
                    "replay_host_ms": launch_host_ms(torch, cg.graph),
                    "first_call_s": graphed["first_call_ms"] / 1e3}
    res["graphed_vs_eager"] = compare_training(torch, "training", graphed["state"], eager_state,
                                               graphed["losses"], eager_losses)
    with CardSampler() as card:
        dms, hms, losses = timed_steps(torch, lambda: step(trained, batch, graphed["gen"]),
                                       TRAIN_TIMED_STEPS)
    counts = dict(cuda_build.launch_counts)
    res["graphed"] = {"step_ms": dms, "step_host_ms": hms, "step_ms_median": statistics.median(dms),
                      "step_host_ms_median": statistics.median(hms),
                      "losses": [x.item() for x in graphed["losses"] + losses],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
                      "counts": counts}
    res["graphed"]["profile"] = profile_image(
        torch, lambda: step(trained, batch, graphed["gen"]), "training step, graphed",
        unprofiled=(res["graphed"]["step_ms_median"], card.text()), what="step")
    log(f"[training] SD1.5 UNet bf16, LoRA rank {TRAIN_RANK} f32 on {len(trained)} modules, "
        f"batch {TRAIN_BATCH} at {shape[1]}x{shape[2]}x4, AdamW lr {TRAIN_LR} (capturable), "
        f"kernels off, graphed: first call {res['graph']['first_call_s']:.3f} s (3 warm-up "
        f"steps, capture {cg.capture_seconds:.3f} s, instantiate {cg.instantiate_seconds:.3f} s, "
        f"{cg.nodes} nodes, pool {res['graph']['pool_gib']:.2f} GiB, replay() returns after "
        f"{res['graph']['replay_host_ms']:.3f} ms on the host); ms per step (CUDA events) "
        f"{[round(t, 3) for t in dms]}, median {res['graphed']['step_ms_median']:.3f}; host ms "
        f"{[round(t, 3) for t in hms]}; peak {res['graphed']['peak_gib']:.2f} GiB allocated, "
        f"{res['graphed']['peak_reserved_gib']:.2f} GiB reserved (eager "
        f"{res['eager']['peak_gib']:.2f}, {res['eager']['peak_reserved_gib']:.2f}); host calls "
        f"a step: eager {res['eager']['profile']['host_launches']}, graphed "
        f"{res['graphed']['profile']['host_launches']}; launches {counts}; card: {card.text()}")
    losses = res["graphed"]["losses"] + res["eager"]["losses"]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"[training] a loss is not finite: {losses}")
    if any(counts.values()) or any(eager_counts.values()):
        raise AssertionError(f"[training] a kernel launched with the kernels off: {counts}, "
                             f"{eager_counts}")
    del step, cg, graphed
    gc.collect()
    torch.cuda.empty_cache()
    res["graph"]["pool_gib_after_drop"] = pool_bytes(torch, pool) / 2**30
    log(f"[training] the graphed step dropped: its pool holds "
        f"{res['graph']['pool_gib_after_drop']:.2f} GiB; "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    if res["graph"]["pool_gib_after_drop"]:
        raise AssertionError("[training] the dropped step's pool still holds memory")

    # B's gradient at step 1, batch 1: the bf16 UNet against an f32 copy
    one = {k: v[:1] for k, v in batch.items()}
    got = train_b_grads(torch, pipe.unet, lora0, one, t1[:1], noise1[:1], eager_cfg)
    f32 = UNet2DConditionModel(SD15_UNET, device=dev, dtype=torch.float32)
    f32.load_state_dict(pipe.unet.module.state_dict())
    ref = train_b_grads(torch, f32, lora0, one, t1[:1], noise1[:1], eager_cfg)
    del f32
    _, _, rms = rel_errors(got, ref)
    res["b_grad_rms_rel"] = rms
    log(f"[training] B's gradient at step 1 (batch 1, the same t and noise), bf16 UNet vs an "
        f"f32 copy: rms_rel {rms:.3e} (bound {TRAIN_GRAD_RMS_REL:g})")
    if not rms <= TRAIN_GRAD_RMS_REL:
        raise AssertionError(f"[training] B's gradient rms_rel {rms} > {TRAIN_GRAD_RMS_REL}")

    # the default configuration, graphed: K1 launches in the first warm-up's
    # forward, its backward refuses, nothing is captured
    before = training_state(trained, opt)
    cuda_build.reset_launch_counts()
    refusal = None
    refused = make_lora_train_step(pipe.unet, opt)
    try:
        refused(trained, batch, g)
    except RuntimeError as e:
        refusal = str(e)
    refused_counts = dict(cuda_build.launch_counts)
    after = training_state(trained, opt)
    kept = after.keys() == before.keys() and all(torch.equal(after[k], v)
                                                 for k, v in before.items())
    res["refusal"] = {"message": refusal, "launches": refused_counts, "state_unchanged": kept,
                      "graphs": refused.cache_size}
    log(f"[training] under CompilationConfig.Default(), graphed: forward launches "
        f"{refused_counts}; the backward raised: {refusal!r}; graphs captured "
        f"{refused.cache_size}; LoRA and AdamW state unchanged {kept}")
    if refusal is None or "flash_attention" not in refusal or \
            "enable_kernels=False" not in refusal:
        raise AssertionError(f"[training] the default configuration's backward did not refuse: "
                             f"{refusal!r}")
    if refused_counts != EXPECTED_REFUSED_LAUNCHES or not kept or refused.cache_size:
        raise AssertionError(f"[training] refused step: launches {refused_counts} (expected "
                             f"{EXPECTED_REFUSED_LAUNCHES}), state kept {kept}, graphs "
                             f"{refused.cache_size}")
    del before, after, opt, refused
    gc.collect()
    torch.cuda.empty_cache()

    # train, then serve: the LoRA through a checkpoint file into the graphs
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "lora.npz")
        checkpoint.save_params(path, trained)
        loaded = checkpoint.nest(checkpoint.load_params(path, device=dev))
    if not all(torch.equal(loaded[m][k], f[k]) for m, f in trained.items() for k in ("a", "b")):
        raise AssertionError("[training] the LoRA read back from its checkpoint differs")
    base = {k: v.clone() for k, v in pipe.unet.module.state_dict().items()}
    lora.switch_lora(pipe.unet, base, loaded)
    merged = pipe.unet.module.state_dict()
    changed = sum(int((merged[m + ".weight"] != base[m + ".weight"]).sum()) for m in loaded)
    cuda_build.reset_launch_counts()
    lora_u8 = image()
    counts = dict(cuda_build.launch_counts)
    captured = pipe_graphs(pipe) != graphs
    diff = (lora_u8.int() - default["graphed"]["u8"].int()).abs().max().item()
    lora.switch_lora(pipe.unet, base, loaded, 0.0)
    restored = torch.equal(image(), default["graphed"]["u8"])
    res["serve"] = {"weights_changed": changed, "image_max_uint8_change": diff,
                    "captured": captured, "launches": counts, "restored_bit_for_bit": restored}
    log(f"[training] the trained LoRA saved and read back ({len(loaded)} modules), swapped into "
        f"the compiled pipeline: {changed} weight elements changed; image changed by up to "
        f"{diff} uint8 levels against phase 4's; launches {counts}; a graph captured: "
        f"{captured}; swapped back with scale 0, phase 4's image bit for bit: {restored}")
    if captured or counts != EXPECTED_LAUNCHES or diff == 0 or not restored:
        raise AssertionError(f"[training] serve: captured {captured}, launches {counts}, "
                             f"change {diff}, restored {restored}")
    del base, merged
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_lora(torch, dev, pipe):
    """Phase 8: a seeded rank-8 LoRA on every UNet attention projection,
    swapped in on the stepwise graphs, then on the fused loop."""
    from sfast_tpu_torch import CompilationConfig, lora
    from sfast_tpu_torch.runtime import cuda_build

    base = {k: v.clone() for k, v in pipe.unet.module.state_dict().items()}
    lo = lora.init_lora_params(torch.Generator(device=dev).manual_seed(9), base, rank=LORA_RANK)
    g = torch.Generator(device=dev).manual_seed(10)
    for f in lo.values():
        f["b"] = torch.randn(f["b"].shape, generator=g, device=dev) * 0.02
    kw = call_kwargs(torch, seed=0, output_type="pt")
    res = {"lora_modules": len(lo)}

    def swap(scale):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lora.switch_lora(pipe.unet, base, lo, scale)
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return host_ms, (time.perf_counter() - t) * 1e3

    def image_diff(a, b):
        return (a.int() - b.int()).abs().max().item()

    for path, cfg in (("stepwise", CompilationConfig.Default()),
                      ("fused loop", CompilationConfig(fuse_denoising_loop=True))):
        pipe.set_compilation_config(cfg)
        pipe(**kw)  # captures the path's graphs
        base_img = pipe(**kw).images
        graphs = pipe_graphs(pipe)
        sizes = {n: len(v) for n, v in graphs.items()}
        host_ms, done_ms = swap(1.0)
        cuda_build.reset_launch_counts()
        lora_img = pipe(**kw).images
        if dict(cuda_build.launch_counts) != EXPECTED_LAUNCHES:
            raise AssertionError(f"[lora {path}] launches after the swap "
                                 f"{dict(cuda_build.launch_counts)} != {EXPECTED_LAUNCHES}")
        if pipe_graphs(pipe) != graphs:
            raise AssertionError(f"[lora {path}] the swap captured a graph: {sizes} -> "
                                 f"{ {n: len(v) for n, v in pipe_graphs(pipe).items()} }")
        changed = image_diff(lora_img, base_img)
        row = {"swap_host_ms": host_ms, "swap_done_ms": done_ms, "image_max_uint8_change": changed}
        if path == "stepwise":
            gen = torch.Generator(device=dev).manual_seed(11)
            with torch.inference_mode():
                ctx = pipe.encode_prompt(kw["prompt_ids"].to(dev))
                x = torch.randn((2, 64, 64, 4), generator=gen, device=dev).to(torch.bfloat16)
                t = torch.tensor(801.0, device=dev)
                graphed, eager = pipe.unet(x, t, ctx), pipe.unet.module(x, t, ctx)
            _, _, rms = rel_errors(graphed, eager)
            ug = pipe.unet._call.graphs()[0]
            # the swap's two parts on the host, again with the same LoRA (the
            # weights they write are those already in place)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            merged = lora.merge_lora(base, lo, 1.0)
            t1 = time.perf_counter()
            pipe.unet.update_params(merged)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            row.update(merge_host_ms=(t1 - t0) * 1e3, update_params_host_ms=(t2 - t1) * 1e3)
            log(f"[lora stepwise] of a swap on the host: merge_lora {row['merge_host_ms']:.2f} ms, "
                f"update_params {row['update_params_host_ms']:.2f} ms")
            row.update(unet_graphed_vs_eager_rms_rel=rms, unet_bit_equal=torch.equal(graphed, eager),
                       unet_capture_s=ug.capture_seconds, unet_instantiate_s=ug.instantiate_seconds)
            log(f"[lora stepwise] one UNet eval after the swap, graphed vs the eager module with "
                f"the merged weights: rms_rel {rms:.3e}, bit equal {row['unet_bit_equal']}")
            if not rms <= MODEL_RMS_REL:
                raise AssertionError(f"[lora] graphed UNet vs eager: rms rel {rms}")
            res["stepwise_lora_u8"] = lora_img
        else:
            row["vs_stepwise_max_uint8_diff"] = image_diff(lora_img, res["stepwise_lora_u8"])
            if row["vs_stepwise_max_uint8_diff"] > 1:
                raise AssertionError(f"[lora fused loop] differs from the stepwise LoRA image by "
                                     f"{row['vs_stepwise_max_uint8_diff']} uint8 levels")
        swap(0.0)
        back = pipe(**kw).images
        row["restored_bit_for_bit"] = torch.equal(back, base_img)
        log(f"[lora {path}] {len(lo)} modules, rank {LORA_RANK}: swap {host_ms:.2f} ms on the "
            f"host ({done_ms:.2f} ms to done); image changed by up to {changed} uint8 levels, "
            f"launches as without LoRA; "
            f"graphs {sizes} unchanged, none captured; swapped back: base image bit for bit "
            f"{row['restored_bit_for_bit']}" + (
                f"; the UNet graph took {row['unet_capture_s']:.3f} s to capture and "
                f"{row['unet_instantiate_s']:.3f} s to instantiate" if path == "stepwise" else ""))
        if changed == 0 or not row["restored_bit_for_bit"]:
            raise AssertionError(f"[lora {path}] image change {changed}, restored "
                                 f"{row['restored_bit_for_bit']}")
        res[path] = row
    del res["stepwise_lora_u8"]
    pipe.set_compilation_config(CompilationConfig.Default())
    return res


def byte_level_vocab(root):
    """A CLIP vocabulary with no merges in ``root``: the 256 byte tokens,
    their word-final forms, BOS and EOS (ids below CLIP's 49,408)."""
    from sfast_tpu_torch.text.clip_tokenizer import _bytes_to_unicode

    chars = list(_bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


def run_prompt_string(torch, pipe):
    """Phase 9: ``pipe("a photo of a cat")`` through the tokenizer: with no
    merges, each letter is one token, the last of a word its word-final
    form."""
    import tempfile

    from sfast_tpu_torch.text import CLIPTokenizer

    prompt = "a photo of a cat"
    with tempfile.TemporaryDirectory() as root:
        byte_level_vocab(root)
        tok = CLIPTokenizer.from_files(os.path.join(root, "vocab.json"),
                                       os.path.join(root, "merges.txt"))
    pipe.tokenizer = tok
    try:
        ids = pipe.tokenize(prompt)[0].tolist()
        kw = call_kwargs(torch, seed=0, output_type="pt")
        del kw["prompt_ids"]
        out = pipe(prompt, **kw).images
    finally:
        pipe.tokenizer = None
    content = ids[1:ids.index(tok.eos_token_id)]
    log(f"[prompt] {prompt!r} -> ids {ids[:len(content) + 3]}... ({len(content)} content "
        f"tokens); image {tuple(out.shape)} {out.dtype}, mean {out.float().mean().item():.2f}, "
        f"std {out.float().std().item():.2f}")
    if ids[0] != tok.bos_token_id or len(content) != len(prompt.replace(" ", "")):
        raise AssertionError(f"[prompt] ids {ids}")
    if out.shape != (1, kw["height"], kw["width"], 3) or out.dtype != torch.uint8 \
            or out.float().std() == 0:
        raise AssertionError(f"[prompt] image {tuple(out.shape)} {out.dtype}")
    return {"ids": ids[:len(content) + 2], "content_tokens": len(content)}


def sdxl_prompt_ids(torch):
    """Seeded ids as a CLIP tokenizer gives them: BOS, 12 tokens, EOS, EOS
    padding (the second encoder's ids pad with 0 after the first EOS)."""
    g = torch.Generator().manual_seed(21)
    ids = torch.full((1, 77), 49407, dtype=torch.long)
    ids[0, 0] = 49406
    ids[0, 1:13] = torch.randint(0, 49406, (12,), generator=g)
    return ids


def sdxl_kwargs(torch, **extra):
    """The SDXL image of JAX's tracked configuration
    (``benchmarks/bench_extra_configs.py:79-125``): 1024², 30 Euler steps,
    CFG 5.0."""
    return {**dict(prompt_ids=sdxl_prompt_ids(torch), height=SDXL_HW, width=SDXL_HW,
                   num_inference_steps=SDXL_STEPS, guidance_scale=SDXL_GUIDANCE), **extra}


def build_sdxl_pipeline(torch, dev):
    """SDXL at full width with seeded random weights, through the entry
    points a user calls."""
    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import (
        SD15_TEXT_ENCODER, SDXL_TEXT_ENCODER_2, SDXL_UNET, SDXL_VAE, AutoencoderKL,
        CLIPTextModel, UNet2DConditionModel, init_weights_,
    )
    from sfast_tpu_torch.pipelines import StableDiffusionXLPipeline
    from sfast_tpu_torch.schedulers import EulerDiscreteScheduler

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20)
    unet = init_weights_(UNet2DConditionModel(SDXL_UNET, device=dev, dtype=bf16), gen)
    vae = init_weights_(AutoencoderKL(SDXL_VAE, device=dev, dtype=bf16), gen)
    te = init_weights_(CLIPTextModel(SD15_TEXT_ENCODER, device=dev, dtype=bf16), gen)
    te2 = init_weights_(CLIPTextModel(SDXL_TEXT_ENCODER_2, device=dev, dtype=bf16), gen)
    pipe = sfast_tpu_torch.compile(
        StableDiffusionXLPipeline(unet, vae, te, te2, EulerDiscreteScheduler(), vae_encode=vae,
                                  device=dev, dtype=bf16),
        CompilationConfig.Default(),
    )
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters()) / 1e6
                for k, m in (("unet", unet), ("vae", vae), ("te", te), ("te2", te2))}
    log(f"SDXL models built: {n_params} M params in {time.perf_counter() - t0:.1f} s")
    return pipe


def plain_routes_sdxl(torch, dev, pipe):
    """The plain routes the SDXL path keeps, timed alone with their memory
    (CUDA events over 20 calls in a row: each call is several kernels, and
    the profiler's rows of them do not come in whole calls): the
    cross-attention at 77 keys (f32 scores, the f32 GEMM of PERF.md §5),
    beside SDPA, and the VAE's mid-block attention, 16,384 tokens of one
    512-wide head."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(22)
    out = {}
    with torch.inference_mode():
        for b, h, sq, per_eval in [(2, 10, 4096, 10), (2, 20, 1024, 60)]:
            d = 64
            q = torch.randn((b, sq, h * d), generator=g, device=dev).to(torch.bfloat16)
            kv = torch.randn((b, 77, h * d), generator=g, device=dev).to(torch.bfloat16)
            q = q.view(b, sq, h, d).transpose(1, 2)
            k = v = kv.view(b, 77, h, d).transpose(1, 2)
            bnd = bound(4 * b * h * sq * 77 * d, 2 * b * h * d * (2 * sq + 2 * 77))
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            plain = events_ms(lambda: flash_attention_ref(q, k, v))
            mem = (torch.cuda.max_memory_allocated() - base) / 2**20
            sdpa = events_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            key = f"cross-attention ({b}, {h}, {sq}x77, {d})"
            out[key] = {"plain_ms": plain, "sdpa_ms": sdpa, "bound_ms": bnd[0],
                        "per_image": per_eval * SDXL_STEPS, "peak_extra_mib": mem}
            log(f"[sdxl] {key}, plain route: {plain:.4f} ms, {mem:.0f} MiB above its "
                f"inputs; SDPA {sdpa:.4f} ms; bound {bnd[0]:.4f} ms; "
                f"{per_eval * SDXL_STEPS} calls an image")
        attn = pipe.vae.module.decoder.mid_block.attentions[0]
        c, hw = pipe.vae.config.block_out_channels[-1], SDXL_HW // pipe.vae_scale_factor
        x = torch.randn((1, hw, hw, c), generator=g, device=dev).to(torch.bfloat16)
        n = hw * hw
        bnd = bound(4 * n * n * c, 2 * 2 * n * c)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = events_ms(lambda: attn(x), calls=5)
        mem = (torch.cuda.max_memory_allocated() - base) / 2**30
        out["vae mid-block attention"] = {"ms": ms, "bound_ms": bnd[0],
                                          "peak_extra_gib": mem, "tokens": n}
        log(f"[sdxl] VAE mid-block attention at {n} tokens, plain route (one decode and one "
            f"encode an img2img image): {ms:.3f} ms, {mem:.2f} GiB above its input; "
            f"bound {bnd[0]:.3f} ms")
    return out


def run_sdxl(torch, dev):
    """Phase 10: SDXL 1024² text2img eager once, graphed, as the fused loop,
    the route check, the plain routes it keeps, img2img, and the encode's
    route check."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import SDXL_VAE
    from sfast_tpu_torch.utils.image import preprocess_image

    pipe = build_sdxl_pipeline(torch, dev)
    kw = sdxl_kwargs(torch)
    res = {}
    t = time.perf_counter()
    eager = eager_once(torch, pipe, kw)
    res["eager_image_s"] = time.perf_counter() - t
    log(f"[sdxl eager] one image of seed 5 and its decode: {res['eager_image_s']:.1f} s")
    res["graphed"] = run_mode(torch, dev, pipe, "sdxl graphed", CompilationConfig.Default(),
                              EXPECTED_SDXL_LAUNCHES, None, base=kw, timed_images=1,
                              profile=False)
    res["graphed"]["vs_eager"] = compare_runs(torch, "sdxl graphed vs eager", eager,
                                              res["graphed"])
    res["fused"] = run_mode(torch, dev, pipe, "sdxl fused loop",
                            CompilationConfig(fuse_denoising_loop=True), EXPECTED_SDXL_LAUNCHES,
                            None, base=kw, timed_images=1, profile=False)
    res["fused"]["vs_stepwise"] = compare_runs(torch, "sdxl fused loop vs stepwise graphs",
                                               res["graphed"], res["fused"])
    loop = res["fused"]["graphs"].get(f"denoise_loop_{SDXL_STEPS}")
    if loop is None:
        raise AssertionError("sdxl fused loop: no denoise_loop graph was captured")
    log(f"[sdxl fused loop] the loop's graph: {loop['nodes']} nodes, captured in "
        f"{loop['capture_s']:.3f} s, instantiated in {loop['instantiate_s']:.3f} s")
    log_pools(torch, pipe, "sdxl after the fused loop")

    pipe.set_compilation_config(CompilationConfig.Default())
    pipe(**kw, seed=0, output_type="latent")  # the stepwise graphs again
    gen = torch.Generator(device=dev).manual_seed(23)
    with torch.inference_mode():
        ids = kw["prompt_ids"].to(dev)
        cond, pooled = pipe.encode_prompt_xl(ids, pipe._ids_for_encoder_2(None, ids))
        ctx = torch.cat([torch.zeros_like(cond), cond])
        added = {"text_embeds": torch.cat([torch.zeros_like(pooled), pooled]),
                 "time_ids": pipe._time_ids((SDXL_HW, SDXL_HW), (0, 0), (SDXL_HW, SDXL_HW), 1)}
        x = torch.randn((2, SDXL_HW // 8, SDXL_HW // 8, 4), generator=gen,
                        device=dev).to(torch.bfloat16)
        z = torch.randn((1, SDXL_HW // 8, SDXL_HW // 8, 4), generator=gen,
                        device=dev) / SDXL_VAE.scaling_factor
    res["route"] = route_check(torch, dev, pipe, "sdxl", CompilationConfig.Default(),
                               MODEL_RMS_REL, (x, torch.tensor(801.0, device=dev), ctx),
                               {"added_cond_kwargs": added}, z)
    res["plain_routes"] = plain_routes_sdxl(torch, dev, pipe)

    image, _ = synthetic_image(SDXL_HW)
    extra = dict(image=image, strength=STRENGTH)
    res["img2img"] = run_mode(torch, dev, pipe, "sdxl img2img", CompilationConfig.Default(),
                              EXPECTED_SDXL_IMG2IMG_LAUNCHES, None, base=kw, timed_images=1,
                              profile=False, **extra)
    res["img2img"]["vs_eager"] = compare_runs(torch, "sdxl img2img graphed vs eager",
                                              eager_once(torch, pipe, dict(kw, **extra)),
                                              res["img2img"])
    log_pools(torch, pipe, "sdxl")
    res["encode"] = encode_route_check(
        torch, pipe, preprocess_image(image, torch.bfloat16, dev), "sdxl encode",
        {"conv3x3": 20, "group_norm_stats": 10})

    # the opt-in kernels (K6 at head dim 64, K4, the fused GroupNorm and K3
    # + K5 at 128²·960), then with enable_fused_conv (K2 and K3 on the
    # UNet's 128² resnets), each one counted and timed image
    optin = CompilationConfig(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                              enable_int8_attention=True)
    fused_conv = optin.replace(enable_fused_conv=True)
    res["optin"] = run_mode(torch, dev, pipe, "sdxl opt-in graphed", optin,
                            EXPECTED_SDXL_OPTIN_LAUNCHES, None, base=kw, timed_images=1,
                            profile=False)
    res["fused_conv"] = run_mode(torch, dev, pipe, "sdxl opt-in + fused conv graphed",
                                 fused_conv, EXPECTED_SDXL_FUSED_CONV_LAUNCHES, None, base=kw,
                                 timed_images=1, profile=False)
    log(f"[sdxl] e2e ms: default {res['graphed']['e2e_ms']:.3f}, opt-in "
        f"{res['optin']['e2e_ms']:.3f}, opt-in + fused conv {res['fused_conv']['e2e_ms']:.3f}")
    res["fused_conv_route"] = route_check(
        torch, dev, pipe, "sdxl opt-in + fused conv", fused_conv, OPTIN_MODEL_RMS_REL,
        (x, torch.tensor(801.0, device=dev), ctx), {"added_cond_kwargs": added}, z)
    for r in (res["optin"], res["fused_conv"]):
        del r["latents"], r["u8"]
    res["lora"] = lora_swap_check(torch, dev, pipe, "unet", dict(kw, seed=0, output_type="pt"),
                                  EXPECTED_SDXL_LAUNCHES, "sdxl lora")
    log_pools(torch, pipe, "sdxl")
    pipe.set_compilation_config(CompilationConfig.Default())  # drops every graph
    torch.cuda.empty_cache()
    res["pipe"] = pipe  # phase 14 quantizes its UNet, then frees it
    return res


def graphed_check(torch, pipe, label, cfg, expected, kw, eager, bit=False):
    """One path of phase 11: the capture, the counted image (its e2e), the
    latents and image of seed 5 against ``eager``'s (bit for bit where
    ``bit``)."""
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    pipe.set_compilation_config(cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pipe(**kw, seed=0, output_type="pt")  # captures the path's graphs
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    cuda_build.reset_launch_counts()
    t = time.perf_counter()
    img = pipe(**kw, seed=0, output_type="pt").images
    torch.cuda.synchronize()
    e2e = (time.perf_counter() - t) * 1e3
    counts = dict(cuda_build.launch_counts)
    log(f"[{label}] first image {first_ms:.1f} ms, then {e2e:.1f} ms; launches per image: "
        f"{counts}")
    if counts != expected:
        raise AssertionError(f"[{label}] launch counts {counts} != {expected}")
    if img.shape != (1, kw["height"], kw["width"], 3) or img.float().std() == 0:
        raise AssertionError(f"[{label}] image {tuple(img.shape)} is constant or misshapen")
    latents = pipe(**kw, seed=5, output_type="latent").images
    with torch.inference_mode():
        u8 = denormalize_to_uint8(pipe.vae.decode(latents / pipe.vae.config.scaling_factor))
    got = {"latents": latents, "u8": u8}
    vs = compare_runs(torch, f"{label} vs eager", eager, got)
    vs["latents_equal"] = torch.equal(latents, eager["latents"])
    if bit and not (vs["latents_equal"] and vs["max_uint8_diff"] == 0):
        raise AssertionError(f"[{label}] not bit for bit against eager: {vs}")
    return {"counts": counts, "first_ms": first_ms, "e2e_ms": e2e, "vs_eager": vs,
            "graphs": graph_summary(torch, pipe, replay=False), "latents": latents}


def run_schedulers(torch, dev, pipe):
    """Phase 11: LCM (graphed, fused, seeds), an LCM-distilled UNet, and
    ancestral Euler and DDIM on phase 4's SD1.5 pipeline."""
    import dataclasses

    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import SD15_UNET, UNet2DConditionModel, init_weights_
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.schedulers import (
        DDIMScheduler, EulerAncestralDiscreteScheduler, LCMScheduler, compile_scheduler,
    )

    res = {}
    original = pipe.scheduler
    pipe.scheduler = compile_scheduler(LCMScheduler())
    kw = call_kwargs(torch, num_inference_steps=LCM_STEPS, guidance_scale=1.0)
    eager = eager_once(torch, pipe, kw)
    res["lcm"] = graphed_check(torch, pipe, "lcm graphed", CompilationConfig.Default(),
                               EXPECTED_LCM_LAUNCHES, kw, eager, bit=True)
    res["lcm_fused_loop"] = graphed_check(
        torch, pipe, "lcm fused loop", CompilationConfig(fuse_denoising_loop=True),
        EXPECTED_LCM_LAUNCHES, kw, eager, bit=True)
    other = pipe(**kw, seed=6, output_type="latent").images
    res["lcm"]["seed_6_differs"] = not torch.equal(other, res["lcm_fused_loop"]["latents"])
    log(f"[lcm] seeds 5 and 6 give different latents: {res['lcm']['seed_6_differs']}")
    if not res["lcm"]["seed_6_differs"]:
        raise AssertionError("[lcm] two seeds gave the same latents")
    for name, sched in (("euler_ancestral", EulerAncestralDiscreteScheduler()),
                        ("ddim", DDIMScheduler())):
        pipe.scheduler = compile_scheduler(sched)
        kw = call_kwargs(torch)
        res[name] = graphed_check(torch, pipe, f"{name} graphed", CompilationConfig.Default(),
                                  EXPECTED_LAUNCHES, kw, eager_once(torch, pipe, kw))
    log_pools(torch, pipe, "sd1.5 schedulers")
    pipe.scheduler = original
    pipe.set_compilation_config(CompilationConfig.Default())

    bf16 = torch.bfloat16
    unet = init_weights_(UNet2DConditionModel(
        dataclasses.replace(SD15_UNET, time_cond_proj_dim=LCM_COND_DIM), device=dev, dtype=bf16),
        torch.Generator(device=dev).manual_seed(24))
    lpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        unet, pipe.vae.module, pipe.text_encoder.module, LCMScheduler(), device=dev, dtype=bf16))
    kw = call_kwargs(torch, num_inference_steps=LCM_STEPS, guidance_scale=8.0)
    res["lcm_distilled"] = graphed_check(
        torch, lpipe, "lcm-distilled unet graphed", CompilationConfig.Default(),
        EXPECTED_LCM_LAUNCHES, kw, eager_once(torch, lpipe, kw))
    log_pools(torch, lpipe, "lcm-distilled unet")
    lpipe.set_compilation_config(CompilationConfig.Default())
    res["taesd"] = run_taesd(torch, dev, pipe, res["lcm"]["e2e_ms"])
    for r in res.values():
        r.pop("latents", None)
    return res


def run_taesd(torch, dev, pipe, kl_lcm_ms):
    """Phase 11 with TAESD (``AutoencoderTiny`` at full width, seeded random
    weights) in both VAE slots of phase 4's SD1.5 modules: LCM 4 steps at
    512², graphed and as the fused loop, each bit for bit against eager;
    its e2e against the KL-decoded LCM image of this run; TAESD's graphed
    decode and encode at 512² against the KL VAE's; one img2img image."""
    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import TAESD, AutoencoderTiny, init_tiny_vae_weights_
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.schedulers import LCMScheduler
    from sfast_tpu_torch.utils.image import preprocess_image

    bf16 = torch.bfloat16
    taesd = init_tiny_vae_weights_(AutoencoderTiny(TAESD, device=dev, dtype=bf16),
                                   torch.Generator(device=dev).manual_seed(25))
    tpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        pipe.unet.module, taesd, pipe.text_encoder.module, LCMScheduler(), vae_encode=taesd,
        device=dev, dtype=bf16))
    kw = call_kwargs(torch, num_inference_steps=LCM_STEPS, guidance_scale=1.0)
    eager = eager_once(torch, tpipe, kw)
    res = {"graphed": graphed_check(torch, tpipe, "lcm taesd graphed", CompilationConfig.Default(),
                                    EXPECTED_LCM_TAESD_LAUNCHES, kw, eager, bit=True)}
    res["fused"] = graphed_check(torch, tpipe, "lcm taesd fused loop",
                                 CompilationConfig(fuse_denoising_loop=True),
                                 EXPECTED_LCM_TAESD_LAUNCHES, kw, eager, bit=True)
    tpipe.set_compilation_config(CompilationConfig.Default())
    g = torch.Generator(device=dev).manual_seed(26)
    z = torch.randn((1, 64, 64, 4), generator=g, device=dev)
    image, _ = synthetic_image(512)
    px = preprocess_image(image, bf16, dev)
    with torch.inference_mode():
        tpipe.vae.decode(z), tpipe.vae_encode.encode(px), pipe.vae.decode(z)  # the captures
        times = {"taesd_decode_ms": cuda_ms(lambda: tpipe.vae.decode(z)),
                 "taesd_encode_ms": cuda_ms(lambda: tpipe.vae_encode.encode(px)),
                 "kl_decode_ms": cuda_ms(lambda: pipe.vae.decode(z))}
    res.update(times, kl_lcm_e2e_ms=kl_lcm_ms)
    i2i = dict(kw, image=image, strength=STRENGTH, seed=0, output_type="pt")
    tpipe(**i2i)  # captures the UNet graph anew (the config switch above dropped it)
    cuda_build.reset_launch_counts()
    out = tpipe(**i2i).images
    counts = dict(cuda_build.launch_counts)
    res["img2img"] = {"counts": counts, "std": out.float().std().item()}
    log(f"[lcm taesd] e2e {res['graphed']['e2e_ms']:.1f} ms graphed, "
        f"{res['fused']['e2e_ms']:.1f} ms fused, against {kl_lcm_ms:.1f} ms with the KL VAE; "
        f"graphed TAESD decode {times['taesd_decode_ms']:.3f} ms and encode "
        f"{times['taesd_encode_ms']:.3f} ms at 512² (KL decode {times['kl_decode_ms']:.3f} ms, "
        f"CUDA events); img2img at {STRENGTH}: launches {counts}")
    if counts != EXPECTED_LCM_TAESD_IMG2IMG_LAUNCHES or res["img2img"]["std"] == 0:
        raise AssertionError(f"[lcm taesd img2img] launches {counts} (expected "
                             f"{EXPECTED_LCM_TAESD_IMG2IMG_LAUNCHES}), std {res['img2img']['std']}")
    log_pools(torch, tpipe, "lcm taesd")
    tpipe.set_compilation_config(CompilationConfig.Default())
    return res


def build_controlnet_pipeline(torch, dev, pipe):
    """Phase 4's SD1.5 modules with a full-width SD15_CONTROLNET, through
    the entry points a user calls."""
    import sfast_tpu_torch
    from sfast_tpu_torch.models import SD15_CONTROLNET, ControlNetModel, init_controlnet_weights_
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

    cn = init_controlnet_weights_(
        ControlNetModel(SD15_CONTROLNET, device=dev, dtype=torch.bfloat16),
        torch.Generator(device=dev).manual_seed(30), zero_conv_scale=CN_ZERO_CONV_SCALE)
    vae = pipe.vae.module
    cpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        pipe.unet.module, vae, pipe.text_encoder.module, DPMSolverMultistepScheduler(),
        vae_encode=vae, controlnet=cn, device=dev, dtype=torch.bfloat16))
    log(f"[controlnet] built: {sum(p.numel() for p in cn.parameters()) / 1e6:.1f} M params, "
        f"zero convs at {CN_ZERO_CONV_SCALE} x the init scale")
    return cpipe


def controlnet_route_check(torch, dev, cpipe, hw):
    """One graphed ControlNet eval at an ``hw``² image on the kernel route
    against the plain route: 2 K1 launches (its level-0 self-attentions),
    the plain route none; the residuals within MODEL_RMS_REL."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.runtime import cuda_build

    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    with torch.inference_mode():
        ctx = cpipe.encode_prompt(torch.randint(0, 49408, (1, 77), generator=gen, device=dev))
        lhw = hw // cpipe.vae_scale_factor
        x = torch.randn((2, lhw, lhw, 4), generator=gen, device=dev).to(torch.bfloat16)
        ctrl = torch.rand((2, hw, hw, 3), generator=gen, device=dev).to(torch.bfloat16)
        args = (x, torch.tensor(801.0, device=dev), ctx, ctrl)
        kw = {"conditioning_scale": cpipe._dev_scalar(CN_SCALE)}
        for route, rcfg in (("kernels", CompilationConfig.Default()),
                            ("plain", CompilationConfig(enable_kernels=False))):
            cpipe.set_compilation_config(rcfg)
            cpipe.controlnet(*args, **kw)  # the capture: its warm-ups count as launches
            cuda_build.reset_launch_counts()
            down, mid = cpipe.controlnet(*args, **kw)
            torch.cuda.synchronize()
            out[route] = torch.cat([r.flatten() for r in (*down, mid)])
            out[route + " launches"] = {k: n for k, n in cuda_build.launch_counts.items() if n}
            out[route + " residuals"] = len(down)
    cpipe.set_compilation_config(CompilationConfig.Default())
    _, max_rel, rms = rel_errors(out["kernels"], out["plain"])
    log(f"[controlnet] route check: {out['kernels residuals']} down residuals and the mid; "
        f"kernel route launched {out['kernels launches']}, plain route {out['plain launches']}; "
        f"residuals, kernel route vs plain route: max_rel {max_rel:.3e} rms_rel {rms:.3e}")
    n_skips = len(cpipe.controlnet.controlnet_down_blocks)
    if out["kernels residuals"] != n_skips or out["kernels launches"] != CN_EVAL_LAUNCHES \
            or out["plain launches"]:
        raise AssertionError(f"[controlnet] route check: {out['kernels residuals']} residuals, "
                             f"launches {out['kernels launches']} / {out['plain launches']}")
    if not 0 < rms <= MODEL_RMS_REL:
        raise AssertionError(f"[controlnet] residuals rms rel {rms} not in (0, {MODEL_RMS_REL}]")
    return {"down_residuals": out["kernels residuals"], "rms_rel": rms,
            "kernel_launches": out["kernels launches"]}


def image_encoder_check(torch, dev):
    """The ViT-H image encoder compiled alone (``compile_model``): its
    graphed embeds against eager, and one graphed call's time."""
    from sfast_tpu_torch import compile_model
    from sfast_tpu_torch.models import VIT_H_IMAGE_ENCODER, CLIPVisionModel, init_weights_

    enc = init_weights_(CLIPVisionModel(VIT_H_IMAGE_ENCODER, device=dev, dtype=torch.bfloat16),
                        torch.Generator(device=dev).manual_seed(32))
    compiled = compile_model(enc, name="image_encoder")
    side = VIT_H_IMAGE_ENCODER.image_size
    px = torch.randn((1, side, side, 3), generator=torch.Generator(device=dev).manual_seed(33),
                     device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        eager = enc(px)["image_embeds"]
        graphed = compiled(px)["image_embeds"]
        ms = cuda_ms(lambda: compiled(px))
    g = compiled._call.graphs()[0]
    equal = torch.equal(graphed, eager)
    _, _, rms = rel_errors(graphed, eager)
    n_params = sum(p.numel() for p in enc.parameters()) / 1e6
    log(f"[image encoder] ViT-H/14 at {side}², {n_params:.1f} M params: graphed embeds "
        f"{tuple(graphed.shape)} vs eager bit for bit {equal} (rms_rel {rms:.3e}); one graphed "
        f"call {ms:.3f} ms (CUDA events); graph {g.nodes} nodes, captured in "
        f"{g.capture_seconds:.3f} s")
    if graphed.shape != (1, VIT_H_IMAGE_ENCODER.projection_dim) or not rms <= 1e-6:
        raise AssertionError(f"[image encoder] graphed embeds {tuple(graphed.shape)}, rms {rms}")
    return {"graphed_ms": ms, "bit_equal": equal, "nodes": g.nodes}, graphed


def scale_checks(torch, cpipe, kw):
    """With the stepwise graphs in place: control scale 0 against the
    no-control image of the same call (bit for bit: the residuals are 0 and
    the UNet adds them in f32), then a second scale, which captures
    nothing and changes the image."""
    args = dict(kw, seed=0, output_type="latent")
    base = {k: v for k, v in args.items()
            if k not in ("control_image", "controlnet_conditioning_scale")}
    zero = cpipe(**dict(args, controlnet_conditioning_scale=0.0)).images
    plain = cpipe(**base).images
    graphs = {n: len(v) for n, v in pipe_graphs(cpipe).items()}
    at_scale = cpipe(**args).images
    other = cpipe(**dict(args, controlnet_conditioning_scale=0.5)).images
    after = {n: len(v) for n, v in pipe_graphs(cpipe).items()}
    res = {"scale_0_bit_equal": torch.equal(zero, plain), "second_scale_captured": after != graphs,
           "second_scale_changes": not torch.equal(at_scale, other)}
    log(f"[controlnet] control scale 0 vs no control image, latents bit for bit: "
        f"{res['scale_0_bit_equal']}; scale 0.5 after {CN_SCALE}: graphs {graphs} -> {after}, "
        f"latents changed {res['second_scale_changes']}")
    if not res["scale_0_bit_equal"] or res["second_scale_captured"] \
            or not res["second_scale_changes"]:
        raise AssertionError(f"[controlnet] scale checks: {res}")
    return res


def run_controlnet(torch, dev, pipe):
    """Phase 12: the ControlNet path eager, graphed and fused; the route
    and scale checks; the image encoder; IP-Adapter; opt-in."""
    import numpy as np

    from sfast_tpu_torch import CompilationConfig, ip_adapter

    cpipe = build_controlnet_pipeline(torch, dev, pipe)
    kw = call_kwargs(torch, num_inference_steps=CN_STEPS, controlnet_conditioning_scale=CN_SCALE)
    hw = kw["height"]
    kw["control_image"] = np.random.default_rng(34).integers(0, 256, (1, hw, hw, 3),
                                                             dtype=np.uint8)
    res = {}
    t = time.perf_counter()
    eager = eager_once(torch, cpipe, kw)
    res["eager_image_s"] = time.perf_counter() - t
    log(f"[controlnet eager] one image of seed 5 and its decode: {res['eager_image_s']:.1f} s")
    res["graphed"] = run_mode(torch, dev, cpipe, "controlnet graphed", CompilationConfig.Default(),
                              EXPECTED_CN_LAUNCHES, None, base=kw)
    res["graphed"]["vs_eager"] = compare_runs(torch, "controlnet graphed vs eager", eager,
                                              res["graphed"])
    res["route"] = controlnet_route_check(torch, dev, cpipe, hw)
    cpipe(**kw, seed=0, output_type="latent")  # the stepwise graphs again
    res["scales"] = scale_checks(torch, cpipe, kw)
    res["fused"] = run_mode(torch, dev, cpipe, "controlnet fused loop",
                            CompilationConfig(fuse_denoising_loop=True), EXPECTED_CN_LAUNCHES,
                            None, base=kw, timed_images=1, profile=False)
    res["fused"]["vs_eager"] = compare_runs(torch, "controlnet fused loop vs eager", eager,
                                            res["fused"])
    loop = res["fused"]["graphs"].get(f"denoise_loop_{CN_STEPS}_cn")
    if loop is None:
        raise AssertionError("controlnet fused loop: no denoise_loop graph was captured")
    log(f"[controlnet fused loop] the loop's graph: {loop['nodes']} nodes, captured in "
        f"{loop['capture_s']:.3f} s, instantiated in {loop['instantiate_s']:.3f} s")
    cpipe.set_compilation_config(CompilationConfig.Default())

    res["image_encoder"], embeds = image_encoder_check(torch, dev)
    proj = ip_adapter.load_ip_adapter(cpipe.unet, ip_adapter.init_ip_adapter_params(
        torch.Generator(device=dev).manual_seed(35), cpipe.unet, clip_embed_dim=embeds.shape[-1],
        num_tokens=IP_TOKENS), num_tokens=IP_TOKENS)
    with torch.inference_mode():
        tokens = ip_adapter.ip_image_embed(proj, embeds)
    # [uncond; cond] for the CFG batch, as the community example stacks them
    tokens = torch.cat([torch.zeros_like(tokens), tokens])
    ip_kw = dict(kw, ip_adapter_embeds=tokens, ip_adapter_scale=IP_SCALE)
    zero_ip = cpipe(**dict(ip_kw, ip_adapter_scale=0.0, seed=0, output_type="pt")).images
    no_ip = cpipe(**dict(kw, seed=0, output_type="pt")).images
    diff = (zero_ip.int() - no_ip.int()).abs().max().item()
    res["ip_scale_0"] = {"max_uint8_diff": diff, "bit_equal": torch.equal(zero_ip, no_ip)}
    log(f"[ip-adapter] {IP_TOKENS} tokens {tuple(tokens.shape)}: IP scale 0 vs no IP tokens, max "
        f"uint8 difference {diff}, bit for bit {res['ip_scale_0']['bit_equal']} (the IP term "
        "stays bf16: a 0-d f32 scale does not promote it)")
    if diff > 1:
        raise AssertionError(f"[ip-adapter] scale 0 differs from no IP by {diff} uint8 levels")
    res["controlnet_ip"] = run_mode(torch, dev, cpipe, "controlnet + ip-adapter graphed",
                                    CompilationConfig.Default(), EXPECTED_CN_LAUNCHES, None,
                                    base=ip_kw, timed_images=1, profile=False)
    res["controlnet_ip"]["vs_eager"] = compare_runs(
        torch, "controlnet + ip-adapter graphed vs eager", eager_once(torch, cpipe, ip_kw),
        res["controlnet_ip"])
    optin = CompilationConfig(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                              enable_int8_attention=True)
    res["optin"] = run_mode(torch, dev, cpipe, "controlnet opt-in graphed", optin,
                            EXPECTED_CN_OPTIN_LAUNCHES, None, base=kw, timed_images=1,
                            profile=False)
    log_pools(torch, cpipe, "controlnet")
    res["lora"] = lora_swap_check(torch, dev, cpipe, "controlnet",
                                  dict(kw, seed=0, output_type="pt"), EXPECTED_CN_LAUNCHES,
                                  "controlnet lora")
    res["w8a8"] = controlnet_w8a8(torch, dev, cpipe, kw, no_ip, res["graphed"]["e2e_ms"])
    cpipe.set_compilation_config(CompilationConfig.Default())  # drops every graph
    for r in (res["graphed"], res["fused"], res["controlnet_ip"], res["optin"]):
        del r["latents"], r["u8"]
    return res


def controlnet_w8a8(torch, dev, cpipe, kw, bf16_img, bf16_e2e):
    """Calibrated static W8A8 of the UNet and the ControlNet with their
    convs (JAX's tracked ``sd15_controlnet_512_30step_w8a8``), on a fresh
    bf16 copy of the UNet (phase 4's stays bf16): counted and timed against
    the bf16 ControlNet image of this run."""
    from sfast_tpu_torch import CompilationConfig, compile_model, quant

    cfg = CompilationConfig.Default()
    cpipe.set_compilation_config(cfg)
    state = cpipe.unet.module.state_dict()
    cpipe.unet = compile_model(fresh_unet(torch, dev, cpipe.unet.module, state), cfg, name="unet")
    cpipe.set_compilation_config(cfg)
    del state
    hw = kw["height"]
    t0 = time.perf_counter()
    ucal, ccal = quant.calibrate_controlnet_pipeline(cpipe, kw["prompt_ids"],
                                                     kw["control_image"], height=hw, width=hw)
    cal_s = time.perf_counter() - t0
    quant.quantize_pipeline(cpipe, mode="w8a8", quantize_convs=True, act_scales=ucal,
                            quantize_controlnet=True, controlnet_act_scales=ccal)
    row = quant_image(torch, cpipe, "controlnet w8a8 static", dict(kw, output_type="pt"),
                      EXPECTED_CN_LAUNCHES)
    img = row.pop("img")
    row.update(calibrate_s=cal_s, unet_sites=len(ucal.amax), controlnet_sites=len(ccal.amax),
               image_max_uint8_vs_bf16=(img.int() - bf16_img.int()).abs().max().item(),
               bf16_e2e_ms=bf16_e2e, e2e_vs_bf16=row["e2e_ms"] / bf16_e2e,
               controlnet_weight_bytes=module_bytes(cpipe.controlnet.module),
               unet_weight_bytes=module_bytes(cpipe.unet.module))
    log(f"[controlnet w8a8 static] calibration {cal_s:.1f} s ({len(ucal.amax)} UNet and "
        f"{len(ccal.amax)} ControlNet sites); e2e {row['e2e_ms']:.3f} ms against bf16's "
        f"{bf16_e2e:.3f} ({row['e2e_vs_bf16']:.3f}x); image vs bf16 up to "
        f"{row['image_max_uint8_vs_bf16']} uint8 levels")
    if row["image_max_uint8_vs_bf16"] == 0:
        raise AssertionError("[controlnet w8a8 static] the image is the bf16 image")
    return row


def check_svd_kernels(torch, dev):
    """Phase 3, the kernels at the SVD path's shapes: K1 at batch 50
    over 9,216 and 2,304 tokens (head dim 64), held against its plain
    version on the first and last batch rows (the plain version's f32
    scores at the full level-0 shape would take 85 GB), its plain time
    taken on those rows; K2 and K3 at the temporal decoder's shapes for a
    chunk of 5 frames.  Returns {kernel: [case, ...]}."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(40)
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    for b, h, sq, d in SVD_ATTN:
        q, k, v = (randn(b, sq, h * d).view(b, sq, h, d).transpose(1, 2) for _ in range(3))
        got = flash_attention(q, k, v)
        again = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("K1 (SVD): two calls on the same inputs differ")
        rows = [0, b - 1]
        qs, ks, vs = (t[rows] for t in (q, k, v))
        max_abs, max_rel, rms = rel_errors(got[rows], flash_attention_ref(qs, ks, vs))
        del got, again
        bnd = bound(4 * b * h * sq * sq * d, 2 * b * h * d * 4 * sq)
        t = (cuda_ms(lambda: flash_attention(q, k, v), iters=5),
             cuda_ms(lambda: flash_attention_ref(qs, ks, vs), iters=5),
             device_ms(lambda: flash_attention(q, k, v), bnd[0], iters=3),
             events_ms(lambda: flash_attention_ref(qs, ks, vs), calls=3))
        sdpa_ms, names = device_ms(lambda: F.scaled_dot_product_attention(q, k, v), bnd[0],
                                   iters=3, names=True)
        log(f"K1 flash_attention svd q={tuple(q.shape)}: rows {rows} against the plain "
            f"version: max_rel {max_rel:.3e} rms_rel {rms:.3e}; {timing_text(t)} (plain on "
            f"those {len(rows)} rows)")
        if not rms <= K1_RMS_REL:
            raise AssertionError(f"K1 (SVD) rms rel error {rms} > {K1_RMS_REL}")
        record(out, "flash_attention", f"svd ({b}, {h}, {sq}x{sq}, {d})", max_abs, t, bnd,
               (sdpa_ms, f"F.scaled_dot_product_attention, {sdpa_backend(names)} backend"),
               exp2_floor_ms=b * h * sq * sq / EXP2_PER_S * 1e3,
               plain_on=f"({len(rows)}, {h}, {sq}x{sq}, {d})")
        del q, k, v, qs, ks, vs
    for hh, ww, c, f, kind in SVD_CONV:
        conv_case(torch, dev, g, out, SVD_CHUNK, hh, ww, c, f, kind, "svd ", iters=5)
    for hh, ww, c in SVD_GN:
        stats_case(torch, dev, g, out, SVD_CHUNK, hh, ww, c, "svd ", iters=5)
    check_optin_shape_kernels(torch, dev, g, randn, out, "svd", SVD_OPTIN_GN, SVD_GEGLU,
                              SVD_ATTN)
    torch.cuda.empty_cache()
    return out


def check_optin_shape_kernels(torch, dev, g, randn, out, label, gn_shapes, geglu_shapes,
                              attn_shapes):
    """Phase 3, an opt-in path's kernels at its shapes (``label`` 'svd':
    SVD-XT's; 'sdxl': SDXL 1024²'s): every UNet GroupNorm of
    ``gn_shapes`` on the route the path gives it (the fused GroupNorm where
    ``fused_plan`` accepts the shape, else K3 then K5) beside the library
    GroupNorm, with both sums over one eval; K4 at the GEMM shapes of
    ``geglu_shapes``; K6 at ``attn_shapes``, held against its plain version
    on the first and last batch rows as K1 is (at SVD's batch 50 the plain
    version's f32 scores would not fit), and its pre-processing on the
    whole input."""
    import torch.nn.functional as F

    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from sfast_tpu_torch.ops.flash_attention_int8 import (
        flash_attention_int8,
        flash_attention_int8_body,
        flash_attention_int8_ref,
        kernel_inputs,
        kv_tile,
        quantize_qkv_cuda,
    )
    from sfast_tpu_torch.ops.geglu import (
        linear_geglu_fused,
        linear_geglu_fused_ref,
        linear_geglu_plain,
    )
    from sfast_tpu_torch.ops.group_norm import (
        fused_plan,
        group_norm_apply,
        group_norm_apply_ref,
        group_norm_fused,
        group_norm_fused_ref,
        group_norm_stats,
        group_norm_stats_ref,
    )

    per_eval = {"kernels": 0.0, "library": 0.0}
    for (n, hh, ww, c), act, count in gn_shapes:
        eps = 1e-5 if act else 1e-6
        x = randn(n, hh, ww, c) + 0.3
        gamma = torch.rand((c,), generator=g, device=dev) + 0.5
        beta = torch.randn((c,), generator=g, device=dev) * 0.2
        kw = dict(groups=32, eps=eps, act=act)
        case = f"{label} ({n}, {hh}x{ww}, {c}) {act or 'none'}"
        bnd, st_bnd = bound(0, 4 * x.numel()), bound(0, 2 * x.numel())
        xc, gb, bb = x.permute(0, 3, 1, 2), gamma.to(x.dtype), beta.to(x.dtype)

        def library():
            o = F.group_norm(xc, 32, gb, bb, eps)
            return F.silu(o) if act == "silu" else o

        lib = (device_ms(library, bnd[0], iters=3),
               "F.group_norm" + (" + F.silu" if act == "silu" else ""))
        if fused_plan(n, hh * ww, c, 32) is not None:
            route = "fused"
            y, fm, fr = group_norm_fused(x, gamma, beta, stats=True, **kw)
            again = group_norm_fused(x, gamma, beta, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise AssertionError(f"fused GroupNorm {case}: two calls differ")
            ry, rm, rr = group_norm_fused_ref(x, gamma, beta, **kw)
            stats_err = max(rel_errors(fm, rm)[1], rel_errors(fr, rr)[1])
            max_abs, _, rms = rel_errors(y, ry)
            del y, again, ry
            t = time_pair(lambda: group_norm_fused(x, gamma, beta, **kw),
                          lambda: group_norm_fused_ref(x, gamma, beta, **kw), bnd, iters=3,
                          plain_events=True)
            record(out, "group_norm_fused", case, max_abs, t, bnd, lib,
                   stats_max_rel=stats_err, per_eval=count)
            ms = t[2]
        else:
            route = "K3+K5"
            mean, rstd = group_norm_stats(x, groups=32, eps=eps)
            y = group_norm_apply(x, mean, rstd, gamma, beta, act=act)
            torch.cuda.synchronize()
            rm, rr = group_norm_stats_ref(x, groups=32, eps=eps)
            stats_err = max(rel_errors(mean, rm)[1], rel_errors(rstd, rr)[1])
            stats_abs = max(rel_errors(mean, rm)[0], rel_errors(rstd, rr)[0])
            max_abs, _, rms = rel_errors(y, group_norm_apply_ref(x, mean, rstd, gamma, beta,
                                                                 act=act))
            del y
            st = time_pair(lambda: group_norm_stats(x, groups=32, eps=eps),
                           lambda: group_norm_stats_ref(x, groups=32, eps=eps), st_bnd, iters=3,
                           plain_events=True)
            t = time_pair(lambda: group_norm_apply(x, mean, rstd, gamma, beta, act=act),
                          lambda: group_norm_apply_ref(x, mean, rstd, gamma, beta, act=act),
                          bnd, iters=3, plain_events=True)
            xg = x.view(n, hh * ww, 32, c // 32)
            record(out, "group_norm_stats", "K3 " + case, stats_abs, st, st_bnd,
                   (device_ms(lambda: torch.var_mean(xg, dim=(1, 3)), st_bnd[0], iters=3),
                    "torch.var_mean"), per_eval=count)
            record(out, "group_norm_apply", case, max_abs, t, bnd, per_eval=count,
                   k3_k5_device_ms=st[2] + t[2], group_norm_library_ms=lib[0])
            ms = st[2] + t[2]
        per_eval["kernels"] += count * ms
        per_eval["library"] += count * lib[0]
        log(f"group_norm {case} ({route}, {count} an eval): stats_rel {stats_err:.3e} "
            f"rms_rel {rms:.3e}; device {ms:.4f} ms, library {lib[0]:.4f} ms")
        if not (rms <= K5_RMS_REL and stats_err <= STATS_REL):
            raise AssertionError(f"GroupNorm {case} ({route}): rms rel {rms} > {K5_RMS_REL} or "
                                 f"stats rel {stats_err} > {STATS_REL}")
        del x, xc
    log(f"GroupNorm device ms over one {label} opt-in eval's "
        f"{sum(n for _, _, n in gn_shapes)} GroupNorms: "
        + ", ".join(f"{route} {ms:.4f}" for route, ms in per_eval.items()))
    out[f"{label}_group_norm_per_eval_ms"] = per_eval

    for m, k, f, count in geglu_shapes:
        x = randn(m, k)
        w = (torch.randn((2 * f, k), generator=g, device=dev) / k**0.5).to(torch.bfloat16)
        b = (torch.randn((2 * f,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        got = linear_geglu_fused(x, w, b)
        torch.cuda.synchronize()
        max_abs, max_rel, rms = rel_errors(got, linear_geglu_fused_ref(x, w, b))
        del got
        bnd = bound(2 * m * k * 2 * f, 2 * (m * k + 2 * f * k + 2 * f + m * f))
        t = time_pair(lambda: linear_geglu_fused(x, w, b),
                      lambda: linear_geglu_fused_ref(x, w, b), bnd, iters=3, plain_events=True)
        unfused_ms = device_ms(lambda: linear_geglu_plain(x, w, b), bnd[0], iters=3)
        log(f"K4 linear_geglu {label} M={m} K={k} F={f} ({count} an eval): max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e}  {timing_text(t)}  (unfused bf16 erf route: device "
            f"{unfused_ms:.4f} ms)")
        if not rms <= K4_RMS_REL:
            raise AssertionError(f"K4 ({label}) rms rel error {rms} > {K4_RMS_REL}")
        record(out, "linear_geglu", f"{label} M={m} K={k} F={f}", max_abs, t, bnd,
               unfused_route_ms=unfused_ms, per_eval=count)
        del x, w, b

    for b, h, sq, d in attn_shapes:
        q = randn(b, sq, h * d).view(b, sq, h, d).transpose(1, 2)
        k = (randn(b, sq, h * d) + 0.5).view(b, sq, h, d).transpose(1, 2)
        v = (randn(b, sq, h * d) - 0.3).view(b, sq, h, d).transpose(1, 2)
        scale = d ** -0.5
        got = flash_attention_int8(q, k, v)
        again = flash_attention_int8(q, k, v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K6 ({label}): two calls on the same inputs differ")
        rows = [0, b - 1]
        qs, ks, vs = (t[rows] for t in (q, k, v))
        max_abs, max_rel, rms = rel_errors(got[rows], flash_attention_int8_ref(
            qs, ks, vs, block_k=kv_tile(d)))
        exact = rel_errors(got[rows], flash_attention_ref(qs, ks, vs))[2]
        del got, again
        inputs = quantize_qkv_cuda(q, k, v, scale)
        code_diff, code_share, f32_rel = prep_errors(
            torch, inputs, kernel_inputs(q.float(), k.float(), v.float(), scale))
        bnd = bound(4 * b * h * sq * sq * d, 2 * b * h * d * 4 * sq, PEAK_INT8)
        t = (cuda_ms(lambda: flash_attention_int8(q, k, v), iters=3),
             cuda_ms(lambda: flash_attention_int8_ref(qs, ks, vs, block_k=kv_tile(d)), iters=3),
             device_ms(lambda: flash_attention_int8(q, k, v), bnd[0], iters=3),
             events_ms(lambda: flash_attention_int8_ref(qs, ks, vs, block_k=kv_tile(d)),
                       calls=2))
        prep_bnd = bound(0, sum(x.numel() * x.element_size() for x in (q, k, v, *inputs)))
        prep_t = time_pair(lambda: quantize_qkv_cuda(q, k, v, scale),
                           lambda: kernel_inputs(q, k, v, scale), prep_bnd, iters=3,
                           plain_events=True)
        body_ms = device_ms(lambda: flash_attention_int8_body(inputs, q.shape), bnd[0], iters=3)
        k1_ms = device_ms(lambda: flash_attention(q, k, v), bnd[0], iters=3)
        exp2_floor = b * h * sq * sq / EXP2_PER_S * 1e3
        log(f"K6 flash_attention_int8 {label} q={tuple(q.shape)}: rows {rows} against the plain "
            f"version: max_rel {max_rel:.3e} rms_rel {rms:.3e} (exact attention: rms_rel "
            f"{exact:.3e}); pre-processing: codes off by {code_diff} on {code_share:.2e} of "
            f"them, f32 max_rel {f32_rel:.2e}  {timing_text(t)} (plain on those {len(rows)} "
            f"rows); device: pre-processing {prep_t[2]:.4f} ms, body {body_ms:.4f} ms, K1 at "
            f"this shape {k1_ms:.4f} ms, exp2 floor {exp2_floor:.4f} ms")
        if not rms <= K6_RMS_REL:
            raise AssertionError(f"K6 ({label}) rms rel error {rms} > {K6_RMS_REL}")
        if not exact <= K6_EXACT_RMS_REL:
            raise AssertionError(f"K6 ({label}) vs exact attention: rms rel {exact} > "
                                 f"{K6_EXACT_RMS_REL}")
        if not (code_diff <= 1 and code_share <= PREP_CODE_SHARE and f32_rel <= PREP_F32_REL):
            raise AssertionError(f"K6 ({label}) pre-processing: codes off by {code_diff} on "
                                 f"{code_share} of them, f32 rel {f32_rel}")
        case = f"{label} ({b}, {h}, {sq}x{sq}, {d})"
        record(out, "flash_attention_int8", case, max_abs, t, bnd, exp2_floor_ms=exp2_floor,
               prep_device_ms=prep_t[2], body_device_ms=body_ms, k1_device_ms=k1_ms,
               plain_on=f"({len(rows)}, {h}, {sq}x{sq}, {d})")
        record(out, "quantize_qkv", case, float(code_diff), prep_t, prep_bnd,
               code_mismatch_share=code_share, f32_max_rel=f32_rel)
        del q, k, v, qs, ks, vs, inputs
        torch.cuda.empty_cache()


def build_svd_pipeline(torch, dev):
    """SVD-XT at full width with seeded random weights (the mix factors
    at JAX's 0.5 in the UNet and 0.0 in the decoder), the ViT-H image
    encoder, through the entry points a user calls."""
    import sfast_tpu_torch
    from sfast_tpu_torch.models import (
        SVD_UNET, SVD_VAE, VIT_H_IMAGE_ENCODER, AutoencoderKLTemporalDecoder, CLIPVisionModel,
        UNetSpatioTemporalConditionModel, init_svd_unet_weights_, init_temporal_vae_weights_,
        init_weights_,
    )
    from sfast_tpu_torch.pipelines import StableVideoDiffusionPipeline

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(42)
    unet = init_svd_unet_weights_(
        UNetSpatioTemporalConditionModel(SVD_UNET, device=dev, dtype=bf16), gen)
    vae = init_temporal_vae_weights_(
        AutoencoderKLTemporalDecoder(SVD_VAE, device=dev, dtype=bf16), gen)
    enc = init_weights_(CLIPVisionModel(VIT_H_IMAGE_ENCODER, device=dev, dtype=bf16), gen)
    pipe = sfast_tpu_torch.compile(StableVideoDiffusionPipeline(unet, vae, enc, device=dev,
                                                                dtype=bf16))
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters()) / 1e6
                for k, m in (("unet", unet), ("vae", vae), ("image_encoder", enc))}
    log(f"[svd] models built: {n_params} M params in {time.perf_counter() - t0:.1f} s")
    return pipe


def svd_clip(torch, pipe, **kw):
    """One clip of ``SVD_KW`` (updated by ``kw``): (uint8 frames on the
    host, host ms until they are there)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = pipe(synthetic_image(SVD_H, SVD_W)[0], **dict(SVD_KW, **kw)).images
    return frames, (time.perf_counter() - t) * 1e3


def frames_diff(a, b):
    import numpy as np

    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def svd_path(torch, pipe, label, cfg, expected, eager_frames):
    """One graphed path of the SVD pipeline: the capture (a 1-step clip,
    whose graphs serve every step count, except the fused loop's, which is
    captured by its own 25-step clip), the counted clip of seed 5 (its e2e;
    held against the eager clip within 1 uint8 level where
    ``eager_frames``); its graphs and peak memory.  No clip is profiled:
    a traced clip takes half a minute."""
    from sfast_tpu_torch.runtime import cuda_build

    pipe.set_compilation_config(cfg)
    torch.cuda.reset_peak_memory_stats()
    capture = {} if cfg.fuse_denoising_loop else {"num_inference_steps": 1}
    _, first_ms = svd_clip(torch, pipe, seed=0, **capture)  # captures the path's graphs
    # a replay of the fused loop (150k nodes) takes a clip's time: the
    # host ms of replay() is read for the stepwise path only
    graphs = graph_summary(torch, pipe, replay=not cfg.fuse_denoising_loop)
    log(f"[{label}] first clip ({capture or 'all steps'}) {first_ms:.1f} ms; graphs captured: "
        f"{graphs_text(graphs)}")
    if cfg.enable_cuda_graph and not graphs:
        raise AssertionError(f"[{label}] no graph was captured")
    cuda_build.reset_launch_counts()
    with CardSampler() as card:
        frames, ms = svd_clip(torch, pipe, seed=5)
    counts = dict(cuda_build.launch_counts)
    card_text = card.text()
    log(f"[{label}] one clip {ms:.1f} ms; launches per clip: {counts}; card: {card_text}")
    if counts != expected:
        raise AssertionError(f"[{label}] launch counts {counts} != {expected}")
    if frames.shape != (1, SVD_FRAMES, SVD_H, SVD_W, 3) or frames.dtype.name != "uint8" \
            or frames.std() == 0:
        raise AssertionError(f"[{label}] frames {frames.shape} {frames.dtype} are misshapen "
                             "or constant")
    res = {"counts": counts, "e2e_ms": ms, "first_ms": first_ms, "graphs": graphs}
    if eager_frames is not None:
        diff = frames_diff(frames, eager_frames)
        log(f"[{label}] seed 5 against the eager clip: max uint8 difference {diff}")
        if diff > 1:
            raise AssertionError(f"[{label}] frames differ from eager by {diff} uint8 levels")
        res["vs_eager"] = {"max_uint8_diff": diff}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    log(f"[{label}] peak memory {res['peak_gib']:.2f} GiB allocated, "
        f"{res['peak_reserved_gib']:.2f} GiB reserved (the graphs' pools included)")
    res["frames"] = frames
    return res


def svd_no_capture(torch, pipe):
    """With the stepwise graphs in place: a second guidance range and a
    second motion bucket capture nothing and change the clip (2-step clips:
    the graphs serve every step count)."""
    short = {"seed": 5, "num_inference_steps": 2}
    base, _ = svd_clip(torch, pipe, **short)
    before = {n: len(v) for n, v in pipe_graphs(pipe).items()}
    frames, _ = svd_clip(torch, pipe, min_guidance_scale=2.0, max_guidance_scale=5.0,
                         motion_bucket_id=40, **short)
    after = {n: len(v) for n, v in pipe_graphs(pipe).items()}
    res = {"captured": after != before, "max_uint8_change": frames_diff(frames, base)}
    log(f"[svd] 2-step clips, guidance 2.0 → 5.0 and motion bucket 40 after 1.0 → 3.0 and "
        f"127: graphs {before} -> {after}; the clip changed by up to "
        f"{res['max_uint8_change']} levels")
    if res["captured"] or res["max_uint8_change"] == 0:
        raise AssertionError(f"[svd] a second guidance range and motion bucket: {res}")
    return res


def svd_decode_check(torch, dev, pipe):
    """One decoded chunk of 5 frames through the pipeline's graph against
    the eager decoder, bit for bit."""
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    g = torch.Generator(device=dev).manual_seed(43)
    z = torch.randn((SVD_CHUNK, SVD_H // 8, SVD_W // 8, 4), generator=g, device=dev)
    z = (z / pipe.vae.config.scaling_factor).to(torch.bfloat16)
    with torch.inference_mode():
        graphed = pipe._decoder_u8()(z)
        eager = denormalize_to_uint8(pipe.vae.module.decode(z, num_frames=SVD_CHUNK))
        ms = cuda_ms(lambda: pipe._decoder_u8()(z), iters=3, warmup=1)
    equal = torch.equal(graphed, eager)
    log(f"[svd] one decoded chunk of {SVD_CHUNK} frames, graphed vs eager: bit for bit "
        f"{equal}; {ms:.2f} ms a graphed chunk (CUDA events)")
    if not equal:
        raise AssertionError("[svd] the graphed decode of a chunk differs from eager")
    return {"bit_equal": equal, "chunk_ms": ms}


def svd_route_check(torch, dev, pipe, label, cfg, expected, model_bound):
    """One UNet eval of the CFG pair of 2 frames at 576×1024 on the kernel
    route of ``cfg`` against the plain route, graphed: the kernel route
    launches ``expected``, the plain route no kernel."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.runtime import cuda_build

    g = torch.Generator(device=dev).manual_seed(44)
    f, lh, lw = SVD_ROUTE_FRAMES, SVD_H // 8, SVD_W // 8
    x = torch.randn((2, f, lh, lw, 8), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 1, 1024), generator=g, device=dev).to(torch.bfloat16)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev)
    t = torch.tensor(0.25, device=dev)
    out = {}
    with torch.inference_mode():
        for route, rcfg in (("kernels", cfg), ("plain", CompilationConfig(enable_kernels=False))):
            pipe.set_compilation_config(rcfg)
            pipe.unet(x, t, ctx, ids)  # the capture: its warm-ups count as launches
            cuda_build.reset_launch_counts()
            out[route] = pipe.unet(x, t, ctx, ids)
            torch.cuda.synchronize()
            out[route + " launches"] = {k: n for k, n in cuda_build.launch_counts.items() if n}
    pipe.set_compilation_config(CompilationConfig.Default())
    _, max_rel, rms = rel_errors(out["kernels"], out["plain"])
    log(f"[{label}] UNet route check at {f} frames: kernel route launched "
        f"{out['kernels launches']}, plain route {out['plain launches']}; kernel route vs "
        f"plain route: max_rel {max_rel:.3e} rms_rel {rms:.3e}")
    if out["kernels launches"] != expected or out["plain launches"]:
        raise AssertionError(f"[{label}] route check launches: {out['kernels launches']} "
                             f"(expected {expected}) / {out['plain launches']}")
    if not 0 < rms <= model_bound:
        raise AssertionError(f"[{label}] UNet rms rel {rms} not in (0, {model_bound}]")
    return {"rms_rel": rms, "max_rel": max_rel, "kernel_launches": out["kernels launches"]}


def svd_quant_check(torch, dev, pipe):
    """Calibrated static W8A8 (with convs, the temporal ones included) of
    the SVD UNet, calibrated at 2 frames: one graphed UNet eval of the CFG
    pair of 2 frames against the bf16 eval (relative rms), equal to the
    eager quantized module bit for bit."""
    from sfast_tpu_torch import CompilationConfig, quant

    g = torch.Generator(device=dev).manual_seed(45)
    f, lh, lw = SVD_ROUTE_FRAMES, SVD_H // 8, SVD_W // 8
    x = torch.randn((2, f, lh, lw, 8), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 1, 1024), generator=g, device=dev).to(torch.bfloat16)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev)
    t = torch.tensor(0.25, device=dev)
    pipe.set_compilation_config(CompilationConfig.Default())
    with torch.inference_mode():
        bf16 = pipe.unet(x, t, ctx, ids)
    bf16_bytes = module_bytes(pipe.unet.module)
    t0 = time.perf_counter()
    cal = quant.calibrate_svd_pipeline(pipe, synthetic_image(SVD_H, SVD_W)[0], num_frames=f,
                                       height=SVD_H, width=SVD_W, num_inference_steps=SVD_STEPS,
                                       step_indices=(0, 8, 16, 24))
    cal_s = time.perf_counter() - t0
    quant.quantize_pipeline(pipe, mode="w8a8", quantize_convs=True, act_scales=cal)
    if pipe.unet.cache_size:
        raise AssertionError("[svd w8a8] the quantization left the bf16 UNet's graphs")
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        q = pipe.unet(x, t, ctx, ids)
        eager = pipe.unet.module(x, t, ctx, ids)
    _, max_rel, rms = rel_errors(q, bf16)
    row = {"calibrate_s": cal_s, "sites": len(cal.amax), "rms_rel_vs_bf16": rms,
           "graphed_vs_eager_bit_equal": torch.equal(q, eager),
           "unet_weight_bytes": module_bytes(pipe.unet.module), "bf16_unet_weight_bytes": bf16_bytes}
    log(f"[svd w8a8 static] calibration at {f} frames {cal_s:.1f} s ({len(cal.amax)} sites); one "
        f"UNet eval of {f} frames vs bf16: max_rel {max_rel:.3e} rms_rel {rms:.3e}; graphed vs "
        f"eager bit for bit {row['graphed_vs_eager_bit_equal']}; UNet weights "
        f"{row['unet_weight_bytes'] / 2**30:.3f} GiB (bf16 {bf16_bytes / 2**30:.3f})")
    if not (0 < rms < QUANT_RMS_REL and row["graphed_vs_eager_bit_equal"]
            and bool(torch.isfinite(q).all())):
        raise AssertionError(f"[svd w8a8 static] {row}")
    return row


def svd_decode_route_check(torch, dev, pipe):
    """One graphed decode of a chunk of 5 frames at 576×1024 on the kernel
    route against the plain route: every K2 and K3 shape of the temporal
    decoder in one call (``SVD_DECODE_LAUNCHES``); the plain route launches
    no kernel."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.runtime import cuda_build

    g = torch.Generator(device=dev).manual_seed(45)
    z = torch.randn((SVD_CHUNK, SVD_H // 8, SVD_W // 8, 4), generator=g, device=dev)
    z = (z / pipe.vae.config.scaling_factor).to(torch.bfloat16)
    out, res = {}, {}

    def decode():
        return pipe.vae.decode(z, num_frames=SVD_CHUNK)

    with torch.inference_mode():
        for route, rcfg in (("kernels", CompilationConfig.Default()),
                            ("plain", CompilationConfig(enable_kernels=False))):
            pipe.set_compilation_config(rcfg)
            decode()  # the capture: its warm-ups count as launches
            cuda_build.reset_launch_counts()
            out[route] = decode()
            torch.cuda.synchronize()
            out[route + " launches"] = {k: n for k, n in cuda_build.launch_counts.items() if n}
            res[f"{route}_ms"] = cuda_ms(decode, iters=3, warmup=1)
    pipe.set_compilation_config(CompilationConfig.Default())
    _, max_rel, rms = rel_errors(out["kernels"], out["plain"])
    log(f"[svd] decode route check, {SVD_CHUNK} frames: kernel route launched "
        f"{out['kernels launches']} in {res['kernels_ms']:.2f} ms, plain route "
        f"{out['plain launches']} in {res['plain_ms']:.2f} ms (CUDA events, graphed); "
        f"kernel route vs plain route: max_rel {max_rel:.3e} rms_rel {rms:.3e}")
    if out["kernels launches"] != SVD_DECODE_LAUNCHES or out["plain launches"]:
        raise AssertionError(f"[svd] decode route check launches: {out['kernels launches']} "
                             f"(expected {SVD_DECODE_LAUNCHES}) / {out['plain launches']}")
    if not 0 < rms <= MODEL_RMS_REL:
        raise AssertionError(f"[svd] decoded frames rms rel {rms} not in (0, {MODEL_RMS_REL}]")
    return {"rms_rel": rms, "max_rel": max_rel, **res}


def run_svd(torch, dev):
    """Phase 13 (its kernels are held at its shapes in phase 3): SVD-XT
    eager once, graphed stepwise, a second guidance range and motion
    bucket, one decoded chunk, the fused loop, the UNet and decode route
    checks, one opt-in clip and the opt-in UNet route check."""
    from sfast_tpu_torch import CompilationConfig

    res = {}
    pipe = build_svd_pipeline(torch, dev)
    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    eager, ms = svd_clip(torch, pipe, seed=5)
    res["eager"] = {"e2e_ms": ms}
    log(f"[svd eager] one clip of seed 5: {ms:.1f} ms")
    res["graphed"] = svd_path(torch, pipe, "svd graphed", CompilationConfig.Default(),
                              EXPECTED_SVD_LAUNCHES, eager)
    res["no_capture"] = svd_no_capture(torch, pipe)
    res["decode"] = svd_decode_check(torch, dev, pipe)
    log_pools(torch, pipe, "svd stepwise")
    res["fused"] = svd_path(torch, pipe, "svd fused loop",
                            CompilationConfig(fuse_denoising_loop=True), EXPECTED_SVD_LAUNCHES,
                            eager)
    loop = res["fused"]["graphs"].get(f"svd_denoise_loop_{SVD_STEPS}_f{SVD_FRAMES}")
    if loop is None:
        raise AssertionError("svd fused loop: no svd_denoise_loop graph was captured")
    res["route"] = svd_route_check(torch, dev, pipe, "svd", CompilationConfig.Default(),
                                   SVD_ROUTE_LAUNCHES, MODEL_RMS_REL)
    res["decode_route"] = svd_decode_route_check(torch, dev, pipe)
    optin = CompilationConfig(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                              enable_int8_attention=True)
    res["optin"] = svd_path(torch, pipe, "svd opt-in graphed", optin,
                            EXPECTED_SVD_OPTIN_LAUNCHES, None)
    log_pools(torch, pipe, "svd")
    res["optin_route"] = svd_route_check(torch, dev, pipe, "svd opt-in", optin,
                                         SVD_OPTIN_ROUTE_LAUNCHES, OPTIN_MODEL_RMS_REL)
    res["w8a8"] = svd_quant_check(torch, dev, pipe)
    pipe.set_compilation_config(CompilationConfig.Default())  # drops every graph
    for r in (res["graphed"], res["fused"], res["optin"]):
        del r["frames"]
    return res


# The mesh (phase 17): ring attention at SD1.5's level 0 and SVD's level 0
# on 2 of its 50 batch rows, on an sp group of one
RING_SHAPES = [(2, 8, 4096, 40), (2, 5, 9216, 64)]


def collectives(module, prefix=""):
    """(all-reduces, all-gathers) that one forward of ``module``'s modules
    under ``prefix`` issues, read from its tensor-parallel linears: a
    row-parallel linear reduces, a column-parallel one outside its pair
    gathers."""
    from sfast_tpu_torch.parallel.tensor_parallel import parallel_linears

    ar = ag = 0
    for name, m in parallel_linears(module).items():
        if name.startswith(prefix):
            ar += m.mode == "row"
            ag += m.mode == "column" and not m.local
    return ar, ag


def ring_check(torch, dev, mesh):
    """``ring_attention`` on the mesh's ``sp`` group of one against
    ``flash_attention_ref``, timed beside K1 (its launches here are not
    the main path's: the caller counts before)."""
    from sfast_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from sfast_tpu_torch.parallel.ring_attention import ring_attention

    g = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for b, h, n, d in RING_SHAPES:
        q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        got = ring_attention(q, k, v, mesh=mesh, axis="sp")
        max_abs, max_rel, rms = rel_errors(got, flash_attention_ref(q, k, v))
        row = {"shape": (b, h, n, d), "max_abs_err": max_abs, "rms_rel": rms,
               "ring_ms": cuda_ms(lambda: ring_attention(q, k, v, mesh=mesh, axis="sp"), 5),
               "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v), 5),
               "k1_ms": cuda_ms(lambda: flash_attention(q, k, v), 10),
               "bound_ms": bound(4 * b * h * n * n * d, 2 * b * h * d * 4 * n)[0]}
        log(f"[mesh] ring_attention {row['shape']} bf16, sp group of 1: max_rel {max_rel:.3e} "
            f"rms_rel {rms:.3e} against flash_attention_ref; ring {row['ring_ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, K1 {row['k1_ms']:.4f} ms (CUDA events, one call); "
            f"bound {row['bound_ms']:.4f} ms")
        if not rms <= K1_RMS_REL:
            raise AssertionError(f"[mesh] ring_attention rms rel error {rms} > {K1_RMS_REL}")
        rows.append(row)
    return rows


def mesh_train_check(torch, dev, unet, mesh):
    """One graphed LoRA train step on the mesh's tensor-parallel UNet (the
    gradients' all-reduces over tp, sp and dp in the graph) against one
    eager step from the same state on the same draws, phase 16's settings
    at batch 1."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step

    g = torch.Generator(device=dev).manual_seed(19)
    batch = {"latents": torch.randn((1, 64, 64, 4), generator=g, device=dev),
             "context": torch.randn((1, 77, unet.config.cross_attention_dim), generator=g,
                                    device=dev)}
    runs = {}
    for graphed in (False, True):
        lo, op = lora_training_setup(unet, rank=TRAIN_RANK, learning_rate=TRAIN_LR,
                                     generator=torch.Generator(device=dev).manual_seed(17))
        step = make_lora_train_step(unet, op, ccfg=CompilationConfig(
            enable_kernels=False, enable_cuda_graph=graphed, mesh=mesh))
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(lo, batch, torch.Generator(device=dev).manual_seed(20))
        torch.cuda.synchronize()
        runs[graphed] = (loss, training_state(lo, op), time.perf_counter() - t, step.graphs())
        del lo, op, step
    res = compare_training(torch, "mesh training", runs[True][1], runs[False][1],
                           [runs[True][0]], [runs[False][0]])
    (cg,) = runs[True][3]
    res.update(nodes=cg.nodes, capture_s=cg.capture_seconds, first_call_s=runs[True][2],
               eager_step_s=runs[False][2])
    log(f"[mesh] a LoRA train step on the mesh, batch 1, kernels off: graphed (first call "
        f"{res['first_call_s']:.3f} s, capture {cg.capture_seconds:.3f} s, {cg.nodes} nodes) "
        f"against eager ({res['eager_step_s']:.3f} s): bit for bit {res['bit_for_bit']}")
    del runs, cg
    gc.collect()
    torch.cuda.empty_cache()
    return res

def run_mesh(torch, dev, pipe, default, lat):
    """Phase 17: phase 4's SD1.5 weights in new modules compiled over a
    world-1 NCCL mesh (dp, tp, sp all 1), their collectives in the graphs;
    the image against phase 4's bit for bit, a LoRA swap under the mesh,
    a graphed LoRA train step against an eager one, and ring attention on
    an sp group of one."""
    import tempfile

    import torch.distributed as dist

    import sfast_tpu_torch
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.models import (
        SD15_TEXT_ENCODER, SD15_UNET, SD_VAE, AutoencoderKL, CLIPTextModel,
        UNet2DConditionModel,
    )
    from sfast_tpu_torch.parallel import make_mesh
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline
    from sfast_tpu_torch.runtime import cuda_build
    from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler
    from sfast_tpu_torch.utils.image import denormalize_to_uint8

    bf16 = torch.bfloat16
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1, 1), ("dp", "tp", "sp"))
            if mesh.device_type != "cuda" or dist.get_backend() != "nccl":
                raise AssertionError(f"[mesh] {dist.get_backend()} mesh on {mesh.device_type}")
            cfg = CompilationConfig(mesh=mesh)
            t = time.perf_counter()
            models = []
            for cls, conf, src in ((UNet2DConditionModel, SD15_UNET, pipe.unet),
                                   (AutoencoderKL, SD_VAE, pipe.vae),
                                   (CLIPTextModel, SD15_TEXT_ENCODER, pipe.text_encoder)):
                m = cls(conf, device=dev, dtype=bf16)
                m.load_state_dict(src.module.state_dict())
                models.append(m)
            unet, vae, te = models
            mpipe = sfast_tpu_torch.compile(
                StableDiffusionPipeline(unet, vae, te, DPMSolverMultistepScheduler(),
                                        vae_encode=vae, device=dev, dtype=bf16), cfg)
            torch.cuda.synchronize()
            res["build_s"] = time.perf_counter() - t
            res["collectives"] = {"unet eval": collectives(mpipe.unet.module),
                                  "text encoder": collectives(mpipe.text_encoder.module),
                                  "vae decode": collectives(mpipe.vae.module, "decoder.")}
            log(f"[mesh] {dist.get_backend()} world of {dist.get_world_size()}, mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}; modules "
                f"built, loaded and sharded in {res['build_s']:.1f} s; collectives a call "
                f"(all-reduce, all-gather): {res['collectives']}")
            if res["collectives"]["unet eval"][0] == 0:
                raise AssertionError("[mesh] the UNet holds no row-parallel linear")

            kw = call_kwargs(torch)
            t = time.perf_counter()
            mpipe(**kw, seed=0, output_type="pt")  # captures, the all-reduces inside
            torch.cuda.synchronize()
            res["first_image_s"] = time.perf_counter() - t
            graphs = graph_summary(torch, mpipe, replay=False)
            res["nodes"] = {k: v["nodes"] for k, v in graphs.items()}
            res["phase4_nodes"] = {k: v["nodes"] for k, v in default["graphed"]["graphs"].items()}
            log(f"[mesh] first image {res['first_image_s']:.2f} s; graphs: {graphs_text(graphs)}; "
                f"nodes {res['nodes']} against phase 4's {res['phase4_nodes']}")
            cuda_build.reset_launch_counts()
            mpipe(**kw, seed=0, output_type="pt")
            torch.cuda.synchronize()
            res["counts"] = dict(cuda_build.launch_counts)
            if res["counts"] != EXPECTED_LAUNCHES:
                raise AssertionError(f"[mesh] launches {res['counts']} != {EXPECTED_LAUNCHES}")
            u8 = denormalize_to_uint8(mpipe(**kw, latents=lat, output_type="float").images)
            ref = default["graphed"]["u8"]
            res["bit_equal_phase4"] = torch.equal(u8, ref)
            if not res["bit_equal_phase4"]:
                diff = (u8.int() - ref.int()).abs().max().item()
                raise AssertionError(f"[mesh] the image differs from phase 4's graphed image by "
                                     f"{diff} uint8 levels")
            torch.cuda.synchronize()
            t = time.perf_counter()
            mpipe(**kw, seed=1)
            torch.cuda.synchronize()
            res["e2e_ms"] = (time.perf_counter() - t) * 1e3
            log(f"[mesh] launches per image {res['counts']}; phase 4's latents give phase 4's "
                f"graphed image bit for bit; one timed image {res['e2e_ms']:.3f} ms (phase 4's "
                f"graphed median {default['graphed']['e2e_ms']:.3f} ms)")
            res["lora"] = lora_swap_check(torch, dev, mpipe, "unet",
                                          dict(kw, seed=0, output_type="pt"), EXPECTED_LAUNCHES,
                                          "mesh lora", cfg=cfg)
            res["train"] = mesh_train_check(torch, dev, mpipe.unet, mesh)
            res["ring"] = ring_check(torch, dev, mesh)
            del mpipe, unet, vae, te, models
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return res


# The examples (phase 18): each script's arguments on the card
EXAMPLES = (
    ("optimize_stable_diffusion_pipeline", ["--repeats", "1", "--warmups", "1"]),
    ("optimize_lcm_pipeline", []),
    ("optimize_lcm_lora", ["--warmups", "1"]),
    ("optimize_instant_id_pipeline", ["--steps", "30"]),
    ("optimize_stable_video_diffusion_pipeline", ["--steps", "2"]),
    ("optimize_train_text_to_image_lora", ["--steps", "3"]),
)


# K1, K2 and K3: what the SD-family and SVD examples launch on their default
# routes; the training example runs with the kernels off and launches none
EXAMPLE_KERNELS = ("flash_attention", "conv3x3", "group_norm_stats")
TRAIN_EXAMPLE = "optimize_train_text_to_image_lora"


def run_examples(torch):
    """Phase 18: every ``examples_torch/`` script through its ``main`` on
    the card at full width; their seconds (each script's own ms printed by
    it) and the kernel launches of each script's run, the counts set to 0
    just before it.  Fails where a pipeline script launched none of K1, K2
    or K3, or the training script launched a kernel."""
    import importlib

    from sfast_tpu_torch.runtime import cuda_build

    seconds, launches = {}, {}
    for name, argv in EXAMPLES:
        mod = importlib.import_module(f"examples_torch.{name}")
        log(f"[examples] {name} {' '.join(argv)}")
        t = time.perf_counter()
        cuda_build.reset_launch_counts()
        mod.main(argv)
        torch.cuda.synchronize()
        launches[name] = {k: n for k, n in cuda_build.launch_counts.items() if n}
        seconds[name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[examples] {name}: {seconds[name]:.1f} s in all (models built, graphs captured); "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated so far; "
            f"launches {launches[name]}")
        if name == TRAIN_EXAMPLE:
            if launches[name]:
                raise RuntimeError(f"[examples] {name}: the kernels are off, yet it launched "
                                   f"{launches[name]}")
        else:
            missing = [k for k in EXAMPLE_KERNELS if not launches[name].get(k)]
            if missing:
                raise RuntimeError(f"[examples] {name}: no launch of {missing}")
    return {"seconds": seconds, "launches": launches}


def kernels_line(measured, default, optin, fused, img2img, sdxl, scheds, lora_res,
                 prompt_res, cn, svd, quant_res, serving, phase_s, mesh, examples):
    """The ``{"kernels": [...]}`` line: per kernel its launches per image on
    each path (``launches``: the stepwise paths' sum) and the main-path
    case's numbers, every case under ``cases``; then each path's numbers."""
    paths = {}
    for name, res in (("default", default), ("optin", optin)):
        for mode in ("eager", "graphed"):
            paths[f"{name} {mode}"] = res[mode]
        paths[f"{name} graphed"]["vs_eager"] = res["graphed_vs_eager"]
    paths["fused loop"] = fused
    paths["img2img"], paths["inpaint"] = img2img["img2img"], img2img["inpaint"]
    paths["sdxl graphed"], paths["sdxl fused loop"] = sdxl["graphed"], sdxl["fused"]
    paths["sdxl img2img"] = sdxl["img2img"]
    paths["sdxl opt-in graphed"] = sdxl["optin"]
    paths["sdxl opt-in + fused conv graphed"] = sdxl["fused_conv"]
    scheds = dict(scheds)
    taesd = scheds.pop("taesd")
    for name, r in scheds.items():
        paths[name.replace("_", " ")] = r
    paths["lcm taesd graphed"], paths["lcm taesd fused loop"] = taesd["graphed"], taesd["fused"]
    paths["controlnet w8a8 static"] = cn["w8a8"]
    for model, res in quant_res.items():
        for mode, r in res.items():
            if mode != "bf16":
                paths[f"{model} {mode}"] = r
    for name, key in (("controlnet graphed", "graphed"), ("controlnet fused loop", "fused"),
                      ("controlnet + ip-adapter graphed", "controlnet_ip"),
                      ("controlnet opt-in graphed", "optin")):
        paths[name] = cn[key]
    for name, key in (("svd eager", "eager"), ("svd graphed", "graphed"),
                      ("svd fused loop", "fused"), ("svd opt-in graphed", "optin")):
        paths[name] = svd[key]
    keep = ("e2e_ms", "device_ms", "idle", "cuda_kernels", "profiled_wall_ms", "traced_wall_ms",
            "peak_gib", "peak_reserved_gib", "graphs", "vs_eager", "vs_default_eager",
            "vs_stepwise", "first_ms", "seed_6_differs")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        first = measured[name][0]
        per_image = {"default": default["graphed"]["counts"][name],
                     "optin": optin["graphed"]["counts"][name],
                     "fused_loop": fused["counts"][name],
                     "img2img": img2img["img2img"]["counts"][name],
                     "inpaint": img2img["inpaint"]["counts"][name],
                     "sdxl": sdxl["graphed"]["counts"][name],
                     "sdxl_fused_loop": sdxl["fused"]["counts"][name],
                     "sdxl_img2img": sdxl["img2img"]["counts"][name],
                     **{k: r["counts"][name] for k, r in scheds.items()},
                     "controlnet": cn["graphed"]["counts"][name],
                     "controlnet_fused_loop": cn["fused"]["counts"][name],
                     "controlnet_ip": cn["controlnet_ip"]["counts"][name],
                     "controlnet_optin": cn["optin"]["counts"][name],
                     "svd": svd["graphed"]["counts"][name],
                     "svd_fused_loop": svd["fused"]["counts"][name],
                     "svd_optin": svd["optin"]["counts"][name],
                     "sdxl_optin": sdxl["optin"]["counts"][name],
                     "sdxl_optin_fused_conv": sdxl["fused_conv"]["counts"][name],
                     "lcm_taesd": taesd["graphed"]["counts"][name],
                     "serving": serving["counts"][name],
                     "mesh": mesh["counts"][name],
                     "controlnet_w8a8": cn["w8a8"]["counts"][name],
                     **{f"{model}_{mode}".replace(" ", "_").replace(".", ""): r["counts"][name]
                        for model, res in quant_res.items() for mode, r in res.items()
                        if mode != "bf16"}}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(n for p, n in per_image.items() if "fused_loop" not in p),
            "launches_per_image": per_image,
            **{key: first[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "plain_device_ms", "share_of_bound", "library")},
            "cases": measured[name],
        })
    return json.dumps({"kernels": kernels,
                       "group_norm_per_eval_ms": measured["group_norm_per_eval_ms"],
                       "svd_group_norm_per_eval_ms": measured["svd_group_norm_per_eval_ms"],
                       "sdxl_group_norm_per_eval_ms": measured["sdxl_group_norm_per_eval_ms"],
                       "int8": measured["int8"],
                       "paths": {k: {f: v[f] for f in keep if f in v} for k, v in paths.items()},
                       "encode": {k: v for k, v in img2img.items() if k.startswith("encode_")},
                       "lora": lora_res, "prompt": prompt_res,
                       "serving": {k: v for k, v in serving.items() if k != "counts"},
                       "sdxl": {k: sdxl[k] for k in ("eager_image_s", "route", "plain_routes",
                                                     "encode", "fused_conv_route", "lora")},
                       "taesd": {k: v for k, v in taesd.items() if k not in ("graphed", "fused")},
                       "quant": {model: {mode: {k: v for k, v in r.items() if k != "graphs"}
                                         for mode, r in res.items()}
                                 for model, res in quant_res.items()},
                       "controlnet": {k: cn[k] for k in ("eager_image_s", "route", "scales",
                                                         "image_encoder", "ip_scale_0", "lora")},
                       "svd": {k: svd[k] for k in ("no_capture", "decode", "route",
                                                   "decode_route", "optin_route", "w8a8")},
                       "mesh": {k: v for k, v in mesh.items() if k != "counts"},
                       "examples_s": examples["seconds"],
                       "examples_launches": examples["launches"],
                       "phase_s": phase_s})


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sfast_tpu_torch import CompilationConfig, quant
    from sfast_tpu_torch.runtime import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_s = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    def build():
        fresh = not cuda_build.library_path().exists()
        path = cuda_build.build()
        cuda_build.library()
        log(f"kernels: {path.name} " + ("built" if fresh else "already built"))

    phase("2 build", build)
    measured = phase("3 kernels", check_kernels, torch, dev)
    pipe = build_pipeline(torch, dev)
    lat = torch.randn((1, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    default = phase("4 default", run_path, torch, dev, pipe, "default",
                    CompilationConfig.Default(), EXPECTED_LAUNCHES, MODEL_RMS_REL, lat)
    optin_cfg = CompilationConfig(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                                  enable_int8_attention=True)
    optin = phase("5 opt-in", run_path, torch, dev, pipe, "opt-in", optin_cfg,
                  EXPECTED_OPTIN_LAUNCHES, OPTIN_MODEL_RMS_REL, lat)
    fused = phase("6 fused loop", run_mode, torch, dev, pipe, "fused loop",
                  CompilationConfig(fuse_denoising_loop=True), EXPECTED_LAUNCHES, lat,
                  timed_images=1, profile=False)
    fused["vs_default_eager"] = compare_runs(torch, "fused loop vs default eager",
                                             default["eager"], fused)
    loop = fused["graphs"].get(f"denoise_loop_{STEPS}")
    if loop is None:
        raise AssertionError("fused loop: no denoise_loop graph was captured")
    log(f"[fused loop] the loop's graph: {loop['nodes']} nodes, captured in "
        f"{loop['capture_s']:.3f} s, instantiated in {loop['instantiate_s']:.3f} s")
    pipe.set_compilation_config(CompilationConfig.Default())
    img2img = phase("7 img2img", run_img2img, torch, dev, pipe)
    lora_res = phase("8 lora", run_lora, torch, dev, pipe)
    prompt_res = phase("9 prompt string", run_prompt_string, torch, pipe)
    log_pools(torch, pipe, "sd1.5 phases 4 to 9")
    serving = phase("15 serving and the compile surface", run_serving, torch, dev, pipe,
                    default, lat)
    phase("16 training", run_training, torch, dev, pipe, default, lat)
    mesh = phase("17 mesh", run_mesh, torch, dev, pipe, default, lat)
    sdxl = phase("10 sdxl", run_sdxl, torch, dev)
    quant_res = {}
    sdxl_pipe = sdxl.pop("pipe")
    sdxl_kw = sdxl_kwargs(torch)
    quant_res["sdxl"] = phase(
        "14 quantization (sdxl)", run_quant, torch, dev, sdxl_pipe, "sdxl", sdxl_kw,
        EXPECTED_SDXL_LAUNCHES, sdxl["graphed"]["e2e_ms"],
        lambda p: quant.calibrate_pipeline(p, sdxl_kw["prompt_ids"], height=SDXL_HW,
                                           width=SDXL_HW))
    sdxl_pipe.set_compilation_config(CompilationConfig.Default())
    del sdxl_pipe
    gc.collect()
    torch.cuda.empty_cache()
    scheds = phase("11 schedulers", run_schedulers, torch, dev, pipe)
    cn = phase("12 controlnet / ip-adapter", run_controlnet, torch, dev, pipe)
    sd_kw = call_kwargs(torch)
    quant_res["sd15"] = phase(
        "14 quantization (sd1.5)", run_quant, torch, dev, pipe, "sd1.5", sd_kw,
        EXPECTED_LAUNCHES, default["graphed"]["e2e_ms"],
        lambda p: quant.calibrate_pipeline(p, sd_kw["prompt_ids"], height=512, width=512))
    # SVD's graphs and activations need the room: the SD1.5 modules go
    pipe.set_compilation_config(CompilationConfig.Default())
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"before phase 13: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    svd = phase("13 svd", run_svd, torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase("18 examples", run_examples, torch)

    print(kernels_line(measured, default, optin, fused, img2img, sdxl, scheds, lora_res,
                       prompt_res, cn, svd, quant_res, serving, phase_s, mesh, examples))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
