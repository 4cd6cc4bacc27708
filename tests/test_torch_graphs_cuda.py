"""CUDA graphs of the port's models on a card: captured against eager.

A UNet of SD1.5's level-0 and level-1 widths (320 and 640 channels, 8
heads of 40 and 80, 32 groups) at 32² latents, where every kernel of the
default and opt-in routes fires (K1 or K6 at 1024 tokens, the fused
GroupNorm at C = 320 and 640, K4 at K = 640), in bf16 with seeded random
weights.  A replay runs the kernels the capture recorded on the same
buffers, so graphed outputs must equal the eager ones bit for bit; the
fused loop and the stepwise graphs run the same kernels in the same
order, and are held to 1e-3 relative rms.  A scheduler that takes noise
every step (ancestral Euler, LCM) reads it from a buffer drawn before the
loop, so its graphed step equals the eager one and a new seed needs no
new capture.  The VAE encode is graphed like
the decode, and a LoRA swap reaches every graph that reads the UNet's
weights without a new capture.  A ControlNet (its zero convs drawn at the
init scale) and an IP-Adapter on the same UNet: the graphed image equals
the eager one, new scales capture nothing (they are 0-d device tensors),
and the fused loop, which embeds the control image once, equals the
stepwise graphs.  Stable Video Diffusion at small widths where K1 (1,024
tokens of head dim 64), K2 and K3 (a 128² decoder map) fire: the graphed
clip equals the eager one, and a new guidance range or motion bucket
captures nothing.  K3's ticket set that a graph holds outlives its
replacement by a larger one.  Quantizing a compiled pipeline drops the
UNet's graphs and the next image captures anew; TAESD's graphed decode and
encode equal eager.  Every test skips without a
CUDA card.  The file imports no JAX, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from sfast_tpu_torch import CompilationConfig, ip_adapter, lora
from sfast_tpu_torch.compilers import compile as compile_pipeline
from sfast_tpu_torch.compilers import compile_unet
from sfast_tpu_torch.compilers import compile_vae
from sfast_tpu_torch.models import (
    TINY_TEST_VAE, TINY_TEXT_ENCODER, AutoencoderKL, AutoencoderKLTemporalDecoder,
    CLIPTextModel, CLIPVisionConfig, CLIPVisionModel, ControlNetConfig, ControlNetModel,
    SD15_UNET, SD_VAE, SVDUNetConfig, TemporalVAEConfig, UNet2DConditionModel, UNetConfig,
    UNetSpatioTemporalConditionModel, init_controlnet_weights_, init_svd_unet_weights_,
    init_temporal_vae_weights_, init_weights_,
)
from sfast_tpu_torch.ops import group_norm as gn_ops
from sfast_tpu_torch.ops.group_norm import group_norm_stats
from sfast_tpu_torch.pipelines import StableDiffusionPipeline, StableVideoDiffusionPipeline
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction, capture_stream
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.schedulers import (
    DPMSolverMultistepScheduler,
    EulerAncestralDiscreteScheduler,
    LCMScheduler,
    compile_scheduler,
)

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
LOOP_RMS_REL = 1e-3
UNET = UNetConfig(
    sample_size=32,
    block_out_channels=(320, 640),
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_heads=(8, 8),
    cross_attention_dim=64,
)
OPTIN = CompilationConfig(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                          enable_int8_attention=True)
ROUTES = {"default": CompilationConfig(), "optin": OPTIN}
# a route against another over a whole model at random weights, where tens
# of layers compound each kernel's bf16 roundings (chip_smoke.MODEL_RMS_REL)
MODEL_RMS_REL = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unet(dev, seed=0):
    return init_weights_(UNet2DConditionModel(UNET, device=dev, dtype=BF16),
                         torch.Generator(device=dev).manual_seed(seed))


def _inputs(dev, batch=2):
    g = torch.Generator(device=dev).manual_seed(1)
    return (torch.randn((batch, 32, 32, 4), generator=g, device=dev).to(BF16),
            torch.tensor(601.0, device=dev),
            torch.randn((batch, 77, 64), generator=g, device=dev).to(BF16))


def _launched():
    return {k: n for k, n in cuda_build.launch_counts.items() if n}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graphed_unet_is_eager_bit_for_bit(dev, route):
    unet = _unet(dev)
    cm = compile_unet(unet, ROUTES[route])
    x, t, ctx = _inputs(dev)
    with torch.inference_mode():
        cuda_build.reset_launch_counts()
        eager = unet(x, t, ctx)
        eager_launches = _launched()
        first, second = cm(x, t, ctx), cm(x, t, ctx)
    assert eager_launches  # the route's kernels fire at these widths
    if route == "optin":
        assert {"flash_attention_int8", "group_norm_fused", "linear_geglu"} <= set(eager_launches)
    assert torch.equal(first, eager) and torch.equal(second, eager)
    assert cm.cache_size == 1


def test_launch_accounting_over_replays(dev):
    unet = _unet(dev)
    cm = compile_unet(unet, OPTIN)
    x, t, ctx = _inputs(dev)
    with torch.inference_mode():
        cuda_build.reset_launch_counts()
        unet(x, t, ctx)
        one = _launched()
        cuda_build.reset_launch_counts()
        cm(x, t, ctx)  # three warm-up calls, the capture (no launch), one replay
        assert _launched() == {k: 4 * n for k, n in one.items()}
        cuda_build.reset_launch_counts()
        for _ in range(5):
            cm(x, t, ctx)
    assert _launched() == {k: 5 * n for k, n in one.items()}
    assert cm._call.graphs()[0].launches == one


def test_update_params_changes_output_without_a_capture(dev):
    cm = compile_unet(_unet(dev))
    x, t, ctx = _inputs(dev)
    new = {k: v.clone() for k, v in _unet(dev, seed=3).state_dict().items()}
    with torch.inference_mode():
        before = cm(x, t, ctx)
        cm.update_params(new)
        after = cm(x, t, ctx)
        expected = cm.module(x, t, ctx)
    assert cm.cache_size == 1
    assert not torch.equal(before, after)
    assert torch.equal(after, expected)


def test_config_flip_after_capture_changes_the_route(dev):
    cm = compile_unet(_unet(dev))
    x, t, ctx = _inputs(dev)
    with torch.inference_mode():
        kernels = cm(x, t, ctx)
        cm.set_compilation_config(CompilationConfig(enable_kernels=False))
        assert cm.cache_size == 0
        cuda_build.reset_launch_counts()
        plain = cm(x, t, ctx)
    assert not _launched()
    assert cm.cache_size == 1
    rms = ((plain.float() - kernels.float()).pow(2).mean() / kernels.float().pow(2).mean()).sqrt()
    assert 0 < rms.item() < 5e-2


def test_two_graphs_replayed_in_turn(dev):
    unet = _unet(dev)
    cm = compile_unet(unet)
    one, two = _inputs(dev, batch=1), _inputs(dev, batch=2)
    with torch.inference_mode():
        ref1, ref2 = unet(*one), unet(*two)
        outs = [cm(*one), cm(*two), cm(*one), cm(*two)]
    assert cm.cache_size == 2
    # the first output is a clone: later replays leave it as it was
    for got, ref in zip(outs, (ref1, ref2, ref1, ref2)):
        assert torch.equal(got, ref)


def test_default_route_takes_the_fused_group_norm_at_sd15(dev, monkeypatch):
    """SD1.5's UNet at CFG batch 2 and 64² latents, and its VAE decode at
    512², under the default configuration: every UNet GroupNorm is one
    fused launch (61 an eval), the decoder's 11 GroupNorms at 64²·512 too
    and its ``conv_norm_out`` at 512²·128 K3 then K5; within
    MODEL_RMS_REL of the plain GroupNorm, and the graphed eval equals the
    eager one bit for bit."""
    g = torch.Generator(device=dev).manual_seed(7)
    unet = init_weights_(UNet2DConditionModel(SD15_UNET, device=dev, dtype=BF16), g)
    vae = init_weights_(AutoencoderKL(SD_VAE, device=dev, dtype=BF16), g)
    x = torch.randn((2, 64, 64, 4), generator=g, device=dev).to(BF16)
    t = torch.tensor(801.0, device=dev)
    ctx = torch.randn((2, 77, 768), generator=g, device=dev).to(BF16)
    z = torch.randn((1, 64, 64, 4), generator=g, device=dev) / SD_VAE.scaling_factor
    out, launched = {}, {}
    with torch.inference_mode():
        for route in ("default", "plain"):
            if route == "plain":  # the rule refuses every call: the plain GroupNorm
                monkeypatch.setattr(gn_ops, "group_norm_ok", lambda *a: False)
            for what, run in (("unet", lambda: unet(x, t, ctx)), ("vae", lambda: vae.decode(z))):
                cuda_build.reset_launch_counts()
                out[route, what] = run()
                torch.cuda.synchronize()
                launched[route, what] = _launched()
        monkeypatch.undo()
        graphed = compile_unet(unet)
        first, second = graphed(x, t, ctx), graphed(x, t, ctx)
    # and K7 for the 16 transformer blocks' 3 LayerNorms, on either GroupNorm route
    assert launched["default", "unet"] == {"flash_attention": 5, "group_norm_fused": 61,
                                           "layer_norm": 48}
    assert launched["plain", "unet"] == {"flash_attention": 5, "layer_norm": 48}
    assert launched["default", "vae"] == {"conv3x3": 21, "group_norm_stats": 9 + 1,
                                          "group_norm_apply": 1, "group_norm_fused": 11}
    assert launched["plain", "vae"] == {"conv3x3": 21, "group_norm_stats": 9}
    for what in ("unet", "vae"):
        assert 0 < _rms_rel(out["default", what], out["plain", what]) <= MODEL_RMS_REL
    assert torch.equal(first, out["default", "unet"]) and torch.equal(second, first)


def test_default_route_under_autograd_keeps_the_plain_group_norm(dev):
    """A kernels-on forward that autograd records (grad enabled, an input
    that requires grad) runs every GroupNorm plain, so its backward
    reaches no GroupNorm kernel; K1 still launches, under its refusal."""
    unet = _unet(dev)
    x, t, ctx = _inputs(dev)
    with torch.enable_grad():
        cuda_build.reset_launch_counts()
        out = unet(x.clone().requires_grad_(), t, ctx)
        torch.cuda.synchronize()
    assert out.requires_grad
    assert _launched() == {"flash_attention": 3}  # level 0: 1 down, 2 up
    with torch.inference_mode():
        cuda_build.reset_launch_counts()
        unet(x, t, ctx)
    assert _launched()["group_norm_fused"] > 0


@pytest.fixture
def pipe(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, device=dev, dtype=BF16), g)
    te = init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, device=dev, dtype=BF16), g)
    return compile_pipeline(StableDiffusionPipeline(
        _unet(dev), vae, te, DPMSolverMultistepScheduler(), vae_encode=vae, device=dev,
        dtype=BF16))


def _rms_rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item()


# the tiny VAE halves the image: 64² images are 32² latents
def test_one_graph_serves_every_step_and_matches_eager(pipe, dev):
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=4, seed=3, output_type="latent")
    graphed = pipe(**kw).images
    assert pipe.unet.cache_size == 1 and pipe.scheduler.cache_size == 1
    assert pipe.text_encoder.cache_size == 1
    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    eager = pipe(**kw).images
    assert torch.equal(graphed, eager)


def test_fused_loop_matches_the_stepwise_graphs(pipe, dev):
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=4, seed=3, output_type="latent")
    pipe(**kw)  # captures the stepwise graphs
    cuda_build.reset_launch_counts()
    stepwise = pipe(**kw).images
    stepwise_launches = _launched()
    pipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    pipe(**kw)  # captures the loop
    cuda_build.reset_launch_counts()
    fused = pipe(**kw).images
    assert _launched() == stepwise_launches
    (loop,) = pipe._fused_loops.values()
    assert loop.cache_size == 1 and loop.graphs()[0].nodes > 0
    assert _rms_rel(fused, stepwise) <= LOOP_RMS_REL


def test_encode_graph_is_eager_bit_for_bit(pipe, dev):
    """At a 256² image the tiny encoder's resnets take K2 and K3 (256² and
    128² maps)."""
    g = torch.Generator(device=dev).manual_seed(5)
    img = torch.rand((1, 256, 256, 3), generator=g, device=dev).to(BF16) * 2 - 1
    with torch.inference_mode():
        cuda_build.reset_launch_counts()
        eager = pipe.vae_encode.module.encode(img)
        launched = _launched()
        graphed = [pipe.vae_encode(img) for _ in range(2)]
    assert {"conv3x3", "group_norm_stats"} <= set(launched)
    assert pipe.vae_encode.cache_size == 1
    for mean, logvar in graphed:
        assert torch.equal(mean, eager[0]) and torch.equal(logvar, eager[1])


@pytest.mark.parametrize("inpaint", [False, True], ids=["img2img", "inpaint"])
def test_graphed_img2img_is_eager_bit_for_bit(pipe, dev, inpaint):
    rng = np.random.default_rng(6)
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=4, strength=0.5, seed=3, output_type="latent",
              image=rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8),
              mask_image=mask if inpaint else None)
    graphed = pipe(**kw).images
    assert pipe.vae_encode.cache_size == 1 and pipe.unet.cache_size == 1
    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    assert torch.equal(graphed, pipe(**kw).images)


def _seeded_lora(state, dev):
    lo = lora.init_lora_params(torch.Generator(device=dev).manual_seed(7), state, rank=8)
    g = torch.Generator(device=dev).manual_seed(8)
    for f in lo.values():
        f["b"] = torch.randn(f["b"].shape, generator=g, device=dev) * 0.02
    return lo


def test_switch_lora_changes_the_graphed_output_without_a_capture(dev):
    cm = compile_unet(_unet(dev))
    x, t, ctx = _inputs(dev)
    base = {k: v.clone() for k, v in cm.module.state_dict().items()}
    lo = _seeded_lora(base, dev)
    with torch.inference_mode():
        before = cm(x, t, ctx)
        graphs = cm._call.graphs()
        lora.switch_lora(cm, base, lo)
        after = cm(x, t, ctx)
        eager = cm.module(x, t, ctx)
        lora.switch_lora(cm, base, lo, scale=0.0)
        back = cm(x, t, ctx)
    assert cm._call.graphs() == graphs  # the same graph object: nothing captured
    assert not torch.equal(before, after) and torch.equal(after, eager)
    assert torch.equal(back, before)


def test_fused_loop_sees_a_lora_swap(pipe, dev):
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=4, seed=3, output_type="latent")
    base = {k: v.clone() for k, v in pipe.unet.module.state_dict().items()}
    lo = _seeded_lora(base, dev)
    lora.switch_lora(pipe.unet, base, lo)
    stepwise = pipe(**kw).images
    lora.switch_lora(pipe.unet, base, lo, scale=0.0)
    pipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    fused_base = pipe(**kw).images  # captures the loop with the base weights
    (loop,) = pipe._fused_loops.values()
    graphs = loop.graphs()
    lora.switch_lora(pipe.unet, base, lo)
    fused = pipe(**kw).images
    assert loop.graphs() == graphs
    assert _rms_rel(fused, fused_base) > 10 * LOOP_RMS_REL
    assert _rms_rel(fused, stepwise) <= LOOP_RMS_REL


@pytest.mark.parametrize("make", [EulerAncestralDiscreteScheduler, LCMScheduler],
                         ids=["euler_ancestral", "lcm"])
def test_graphed_noisy_step_is_eager_and_a_new_seed_captures_nothing(pipe, dev, make):
    """The step's noise is ``buf[i]`` of the pre-drawn buffer, an ordinary
    input of the one step graph: graphed equals eager bit for bit, the
    stepwise graphs and the fused loop's both; another seed draws another
    buffer and changes the image with the same graphs."""
    pipe.scheduler = compile_scheduler(make())
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=4, guidance_scale=1.0, output_type="latent")
    graphed = pipe(**kw, seed=3).images
    assert pipe.scheduler.cache_size == 1 and pipe.unet.cache_size == 1
    graphs = {n: g.graphs() for n, g in (("unet", pipe.unet._call),
                                         ("step", pipe.scheduler._step))}
    other = pipe(**kw, seed=4).images
    assert {"unet": pipe.unet._call.graphs(), "step": pipe.scheduler._step.graphs()} == graphs
    assert not torch.equal(graphed, other)
    pipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    fused = pipe(**kw, seed=3).images
    (loop,) = pipe._fused_loops.values()
    fused_other = pipe(**kw, seed=4).images
    assert loop.cache_size == 1 and not torch.equal(fused, fused_other)
    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    assert torch.equal(graphed, pipe(**kw, seed=3).images)
    assert _rms_rel(fused, graphed) <= LOOP_RMS_REL


# one stride-2 conv in the embedding: a 64² control image for 32² latents
CONTROLNET = ControlNetConfig(unet=UNET, conditioning_embedding_out_channels=(16, 32))


@pytest.fixture
def cn_pipe(dev):
    """The tiny pipeline with a ControlNet and an IP-Adapter on its UNet;
    returns it with [zeros; tokens] IP tokens for the CFG batch."""
    g = torch.Generator(device=dev).manual_seed(9)
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, device=dev, dtype=BF16), g)
    te = init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, device=dev, dtype=BF16), g)
    cn = init_controlnet_weights_(ControlNetModel(CONTROLNET, device=dev, dtype=BF16), g,
                                  zero_conv_scale=1.0)
    unet = _unet(dev)
    proj = ip_adapter.load_ip_adapter(
        unet, ip_adapter.init_ip_adapter_params(g, unet, clip_embed_dim=32))
    with torch.inference_mode():
        tokens = proj(torch.randn((1, 32), generator=g, device=dev))
    pipe = compile_pipeline(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), vae_encode=vae, controlnet=cn, device=dev,
        dtype=BF16))
    return pipe, torch.cat([torch.zeros_like(tokens), tokens])


def _cn_kw(**extra):
    ctrl = np.random.default_rng(10).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    return {**dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
                   num_inference_steps=4, seed=3, output_type="latent", control_image=ctrl,
                   controlnet_conditioning_scale=0.8), **extra}


def _held(pipe):
    return {n: m._call.graphs() for n, m in (("unet", pipe.unet), ("controlnet", pipe.controlnet))}


def test_graphed_controlnet_image_is_eager_bit_for_bit(cn_pipe):
    pipe, tokens = cn_pipe
    for extra in ({}, {"ip_adapter_embeds": tokens, "ip_adapter_scale": 0.6}):
        pipe.set_compilation_config(CompilationConfig())
        cuda_build.reset_launch_counts()
        graphed = pipe(**_cn_kw(**extra)).images
        assert pipe.controlnet.cache_size == 1 and pipe.unet.cache_size == 1
        assert cuda_build.launch_counts["flash_attention"] > 0  # K1 in the UNet and the ControlNet
        pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
        assert torch.equal(graphed, pipe(**_cn_kw(**extra)).images)


def test_a_new_control_or_ip_scale_captures_nothing(cn_pipe):
    """The scales are graph inputs: another scale replays the same graphs
    and changes the image; control scale 0 gives the no-control image and IP
    scale 0 the no-IP image, bit for bit."""
    pipe, tokens = cn_pipe
    both = pipe(**_cn_kw(ip_adapter_embeds=tokens, ip_adapter_scale=0.6)).images
    held = _held(pipe)
    other = pipe(**_cn_kw(ip_adapter_embeds=tokens, ip_adapter_scale=0.3,
                          controlnet_conditioning_scale=0.5)).images
    assert _held(pipe) == held and not torch.equal(both, other)
    no_ip = pipe(**_cn_kw()).images
    assert torch.equal(pipe(**_cn_kw(ip_adapter_embeds=tokens, ip_adapter_scale=0.0)).images,
                       no_ip)
    kw = _cn_kw()
    del kw["control_image"], kw["controlnet_conditioning_scale"]
    plain = pipe(**kw).images
    assert torch.equal(pipe(**_cn_kw(controlnet_conditioning_scale=0.0)).images, plain)
    assert pipe.controlnet.cache_size == 1


def test_fused_controlnet_loop_matches_the_stepwise_graphs(cn_pipe):
    pipe, tokens = cn_pipe
    kw = _cn_kw(ip_adapter_embeds=tokens, ip_adapter_scale=0.6)
    pipe(**kw)  # captures the stepwise graphs
    cuda_build.reset_launch_counts()
    stepwise = pipe(**kw).images
    stepwise_launches = _launched()
    pipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    pipe(**kw)  # captures the loop
    cuda_build.reset_launch_counts()
    fused = pipe(**kw).images
    assert _launched() == stepwise_launches
    (loop,) = pipe._fused_loops.values()
    assert loop.name == "denoise_loop_4_cn_ip" and loop.cache_size == 1
    fused_other = pipe(**dict(kw, controlnet_conditioning_scale=0.5)).images
    assert loop.cache_size == 1 and not torch.equal(fused, fused_other)
    assert _rms_rel(fused, stepwise) <= LOOP_RMS_REL


# SVD at small widths: two levels of 320 and 640 channels (5 and 10 heads of
# 64), 32² latents (1,024 tokens: K1), a 3-level temporal VAE whose last
# level decodes at 128² (K2, K3)
SVD_UNET = SVDUNetConfig(
    block_out_channels=(320, 640),
    down_block_types=("CrossAttnDownBlockSpatioTemporal",) * 2,
    up_block_types=("CrossAttnUpBlockSpatioTemporal",) * 2,
    layers_per_block=1, transformer_layers_per_block=(1, 1), num_heads=(5, 10),
    cross_attention_dim=64, num_frames=3,
)
SVD_VAE = TemporalVAEConfig(block_out_channels=(64, 128, 128), layers_per_block=1)
SVD_ENCODER = CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64,
                               intermediate_size=128, num_layers=2, num_heads=4,
                               projection_dim=64)


@pytest.fixture
def svd_pipe(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    unet = init_svd_unet_weights_(
        UNetSpatioTemporalConditionModel(SVD_UNET, device=dev, dtype=BF16), g)
    vae = init_temporal_vae_weights_(AutoencoderKLTemporalDecoder(SVD_VAE, device=dev,
                                                                  dtype=BF16), g)
    enc = init_weights_(CLIPVisionModel(SVD_ENCODER, device=dev, dtype=BF16), g)
    return compile_pipeline(StableVideoDiffusionPipeline(unet, vae, enc, device=dev,
                                                         dtype=BF16))


def _svd_kw(**extra):
    image = np.random.default_rng(12).integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    return image, {**dict(num_frames=3, height=128, width=128, num_inference_steps=3,
                          decode_chunk_size=2, seed=3), **extra}


def test_graphed_svd_clip_is_eager_bit_for_bit(svd_pipe):
    """The stepwise graphs and the fused loop against eager: the frames
    bit for bit (chunks of 2 and 1 frames: two decode graphs), the fused
    loop's latents within LOOP_RMS_REL of the stepwise graphs'."""
    image, kw = _svd_kw()
    cuda_build.reset_launch_counts()
    graphed = svd_pipe(image, **kw).images
    launched = _launched()
    assert {"flash_attention", "conv3x3", "group_norm_stats"} <= set(launched)
    assert svd_pipe.unet.cache_size == 1 and svd_pipe._decode_u8.cache_size == 2
    stepwise = svd_pipe(image, **kw, output_type="latent").images
    svd_pipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    fused = svd_pipe(image, **kw, output_type="latent").images
    (loop,) = svd_pipe._fused_loops.values()
    assert loop.name == "svd_denoise_loop_3_f3" and loop.cache_size == 1
    assert _rms_rel(fused, stepwise) <= LOOP_RMS_REL
    svd_pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    assert np.array_equal(graphed, svd_pipe(image, **kw).images)


def test_a_new_guidance_range_or_motion_bucket_captures_nothing(svd_pipe):
    image, kw = _svd_kw()
    base = svd_pipe(image, **kw).images
    held = {n: m._call.graphs() for n, m in (("unet", svd_pipe.unet),
                                             ("image_encoder", svd_pipe.image_encoder))}
    decode = svd_pipe._decode_u8.graphs()
    other = svd_pipe(image, **kw, min_guidance_scale=2.0, max_guidance_scale=6.0,
                     motion_bucket_id=30, fps=12).images
    assert not np.array_equal(base, other)
    assert {n: m._call.graphs() for n, m in (("unet", svd_pipe.unet),
                                             ("image_encoder", svd_pipe.image_encoder))} == held
    assert svd_pipe._decode_u8.graphs() == decode


def test_k3_tickets_a_graph_holds_outlive_a_larger_set(dev):
    """A decode graph holds K3 ticket sets of its own, allocated in its
    pool by the capture.  A call of more samples on the capture stream
    replaces that stream's set, and the small tensors allocated next on
    the stream may take the old one: the replay's K3 must not read their
    values as tickets."""
    vae = compile_vae(init_weights_(AutoencoderKL(TINY_TEST_VAE, device=dev, dtype=BF16),
                                    torch.Generator(device=dev).manual_seed(13)))
    z = torch.randn((1, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(14),
                    device=dev).to(BF16)
    with torch.inference_mode():
        first = vae(z)  # the capture: the 128² decoder map takes K2 and K3
        assert vae._call.graphs()[0].launches.get("group_norm_stats", 0) > 0
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            group_norm_stats(torch.randn((80, 8, 8, 64), device=dev).to(BF16), groups=32)
            junk = [torch.full((64,), 7, dtype=torch.int32, device=dev) for _ in range(64)]
        torch.cuda.current_stream(dev).wait_stream(stream)
        again = vae(z)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    del junk


# ---------------------------------------------------------------------------
# serving: map, and a capture on a warm-up thread beside replays
# ---------------------------------------------------------------------------


def test_map_equals_sequential_calls(pipe, dev):
    ids = [torch.full((1, 77), i + 1, dtype=torch.long) for i in range(3)]
    kw = dict(height=64, width=64, num_inference_steps=4, seed=3)
    seq = [pipe(prompt_ids=i, **kw).images for i in ids]
    piped = [o.images for o in pipe.map(ids, window=2, **kw)]
    assert len(piped) == 3
    for a, b in zip(seq, piped):
        np.testing.assert_array_equal(a, b)


def test_background_capture_beside_replays_keeps_counts_and_images(pipe, dev):
    """Images served while a warm-up thread captures another shape equal
    the image before it, with the same launches on the serving thread; the
    warmed shape then captures nothing, and its graphed image and launches
    are an eager image's."""
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), width=64,
              num_inference_steps=4, seed=3)
    ref = pipe(height=64, **kw).images  # captures the 64² graphs
    cuda_build.reset_launch_counts()
    pipe(height=64, **kw)
    one = cuda_build.thread_launch_counts()
    thread = pipe.warmup(resolutions=((128, 64),), steps=(4,), background=True)
    served = []
    while thread.is_alive() or len(served) < 2:
        cuda_build.reset_launch_counts()
        served.append((pipe(height=64, **kw).images, cuda_build.thread_launch_counts()))
    thread.join()
    for img, counts in served:
        np.testing.assert_array_equal(img, ref)
        assert counts == one
    slots = (pipe.unet, pipe.vae, pipe.text_encoder, pipe.scheduler)
    sizes = [m.cache_size for m in slots]
    cuda_build.reset_launch_counts()
    graphed = pipe(height=128, **kw).images
    graphed_launches = cuda_build.thread_launch_counts()
    assert [m.cache_size for m in slots] == sizes
    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    cuda_build.reset_launch_counts()
    eager = pipe(height=128, **kw).images
    assert cuda_build.thread_launch_counts() == graphed_launches
    assert np.abs(graphed.astype(int) - eager.astype(int)).max() <= 1


def test_another_threads_allocations_stay_out_of_a_capture(dev):
    """While a thread captures (``capture_error_mode="thread_local"``), the
    main thread allocates and copies to the host: the capture survives,
    and the main thread's tensors lie in the default pool, not in the
    graph's."""
    capturing, allocated = threading.Event(), threading.Event()

    def fn(x):
        y = x * 2 + 1
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            assert allocated.wait(timeout=60)
        return y.sin()

    f = LazyCompiledFunction(fn, name="slow_capture")
    x = torch.randn(1 << 16, device=dev)
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("out", f(x)))
    thread.start()
    assert capturing.wait(timeout=60)
    try:
        # a generator of its own: the default one belongs to the capture
        # while it runs, as the pipelines' per-call generators do not
        g = torch.Generator(device=dev).manual_seed(0)
        mine = [torch.randn(1 << 20, generator=g, device=dev) for _ in range(3)]
        mine.append(torch.full((1 << 20,), 2.0, device=dev))
        host = mine[0].sum().item()  # a host sync beside the capture
    finally:
        allocated.set()
        thread.join()
    assert f.cache_size == 1 and torch.equal(result["out"], (x * 2 + 1).sin())
    assert torch.equal(f(x), result["out"]) and host == mine[0].sum().item()
    segments = torch.cuda.memory_snapshot()
    for t in mine:
        (seg,) = [s for s in segments
                  if s["address"] <= t.data_ptr() < s["address"] + s["total_size"]]
        assert tuple(seg["segment_pool_id"]) == (0, 0), seg["segment_pool_id"]


# ---------------------------------------------------------------------------
# quantization and TAESD under graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,convs", [("w8a16", False), ("w8a8", True)])
def test_quantizing_a_compiled_pipeline_captures_anew(pipe, mode, convs):
    """The quantization drops the UNet's graphs; the next image captures
    anew, is not the bf16 image, and its graphed latents equal the eager
    quantized ones bit for bit."""
    from sfast_tpu_torch import quant

    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=3, seed=2, output_type="latent")
    bf16 = pipe(**kw).images
    assert pipe.unet.cache_size == 1
    quant.quantize_pipeline(pipe, mode=mode, quantize_convs=convs)
    assert pipe.unet.cache_size == 0
    graphed = pipe(**kw).images
    assert pipe.unet.cache_size == 1 and not torch.equal(graphed, bf16)
    pipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    assert torch.equal(pipe(**kw).images, graphed)


@pytest.mark.parametrize("fused", [False, True])
def test_quantizing_a_shared_unet_recaptures_the_other_pipeline(pipe, dev, fused):
    """A second compiled pipeline over the same modules holds graphs of the
    bf16 UNet when the first is quantized: its next image captures anew (a
    replay would read the freed bf16 weights), is not its bf16 image, and
    equals its eager quantized image bit for bit."""
    from sfast_tpu_torch import quant

    unet, vae, te = (s.module for s in (pipe.unet, pipe.vae, pipe.text_encoder))
    other = compile_pipeline(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), vae_encode=vae, device=dev, dtype=BF16))
    other.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
    kw = dict(prompt_ids=torch.ones((1, 77), dtype=torch.long), height=64, width=64,
              num_inference_steps=3, seed=2, output_type="latent")
    bf16 = other(**kw).images
    quant.quantize_pipeline(pipe, mode="w8a8", quantize_convs=True)
    torch.cuda.empty_cache()
    graphed = other(**kw).images
    assert not torch.equal(graphed, bf16)
    other.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    assert torch.equal(other(**kw).images, graphed)


def test_graphed_taesd_is_eager_bit_for_bit(dev):
    from sfast_tpu_torch.models import TAESD, AutoencoderTiny, init_tiny_vae_weights_

    vae = init_tiny_vae_weights_(AutoencoderTiny(TAESD, device=dev, dtype=BF16),
                                 torch.Generator(device=dev).manual_seed(3))

    class Pipe:
        pass

    p = Pipe()
    p.vae, p.vae_encode = vae, vae
    compile_pipeline(p)
    g = torch.Generator(device=dev).manual_seed(4)
    z = torch.randn((1, 64, 64, 4), generator=g, device=dev)
    img = (torch.rand((1, 512, 512, 3), generator=g, device=dev) * 2 - 1).to(BF16)
    with torch.inference_mode():
        for graphed, eager in ((p.vae.decode(z), vae.decode(z)),
                               (p.vae_encode.encode(img)[0], vae.encode(img)[0])):
            assert torch.equal(graphed, eager)
    assert p.vae.cache_size == p.vae_encode.cache_size == 1


def test_graphed_unet_over_a_world_1_nccl_mesh_is_eager_bit_for_bit(dev, tmp_path):
    """A world of one over NCCL: the UNet tensor-parallel at tp = 1, its
    all-reduces captured in the graph (more nodes than the unsharded
    UNet's graph).  Graphed equals eager bit for bit, and eager equals the
    unsharded module's output; a CPU tensor at a collective raises."""
    import torch.distributed as dist

    from sfast_tpu_torch.parallel import make_mesh
    from sfast_tpu_torch.parallel.tensor_parallel import all_reduce, parallel_linears

    unet, ref = _unet(dev), _unet(dev)
    x, t, ctx = _inputs(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("dp", "tp"))
        assert mesh.device_type == "cuda"
        cm = compile_unet(unet, CompilationConfig(mesh=mesh))
        plain = compile_unet(ref)
        with torch.inference_mode():
            eager = unet(x, t, ctx)
            first, second = cm(x, t, ctx), cm(x, t, ctx)
            assert torch.equal(plain(x, t, ctx), ref(x, t, ctx))
            unsharded = ref(x, t, ctx)
        assert len(parallel_linears(unet)) == 10 * 7  # 7 transformer blocks
        assert torch.equal(first, eager) and torch.equal(second, eager)
        assert torch.equal(eager, unsharded)
        assert cm._call.graphs()[0].nodes > plain._call.graphs()[0].nodes
        with pytest.raises(ValueError, match="cpu tensor on a cuda mesh"):
            all_reduce(torch.zeros(1), mesh, "tp")
    finally:
        dist.destroy_process_group()
