"""CUDA graphs of the port's models on a card: captured against eager.

A UNet of SD1.5's level-0 and level-1 widths (320 and 640 channels, 8
heads of 40 and 80, 32 groups) at 32² latents, where every kernel of the
default and opt-in routes fires (K1 or K6 at 1024 tokens, the fused
GroupNorm at C = 320 and 640, K4 at K = 640), in bf16 with seeded random
weights.  A replay runs the kernels the capture recorded on the same
buffers, so graphed outputs must equal the eager ones bit for bit; the
fused loop and the stepwise graphs run the same kernels in the same
order, and are held to 1e-3 relative rms.  Every test skips without a
CUDA card.  The file imports no JAX, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py
"""

import pytest
import torch

from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.compilers import compile as compile_pipeline
from sfast_tpu_torch.compilers import compile_unet
from sfast_tpu_torch.models import (
    TINY_TEST_VAE, TINY_TEXT_ENCODER, AutoencoderKL, CLIPTextModel, UNet2DConditionModel,
    UNetConfig, init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

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


@pytest.fixture
def pipe(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, device=dev, dtype=BF16), g)
    te = init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, device=dev, dtype=BF16), g)
    return compile_pipeline(StableDiffusionPipeline(
        _unet(dev), vae, te, DPMSolverMultistepScheduler(), device=dev, dtype=BF16))


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
