"""The port's spans (``profile/spans.py``) on a card: a served image's
``sfast.replay`` spans, one a graphed call of each graph; an
``sfast.capture`` inside the replay that missed, of the same graph; one
``sfast.wait`` a served image, closed-loop and under ``map``; and each
replay span holds the ``cudaGraphLaunch`` it made, by the profiler's host
timestamps.  The pipeline is ``tests/test_torch_graphs_cuda.py``'s: a UNet
of SD1.5's level-0 and level-1 widths at 32² latents, in bf16.  Every test
skips without a CUDA card.  The file imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans_cuda.py
"""

import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sfast_tpu_torch.compilers import compile as compile_pipeline
from sfast_tpu_torch.models import (
    TINY_TEST_VAE, TINY_TEXT_ENCODER, AutoencoderKL, CLIPTextModel, UNet2DConditionModel,
    UNetConfig, init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.profile import spans
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
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
STEPS = 3
KW = dict(height=64, width=64, num_inference_steps=STEPS, seed=3)
GRAPHS = ["text_encoder"] + ["unet", "scheduler.step"] * STEPS + ["vae"]


@pytest.fixture
def pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, device=dev, dtype=BF16), g)
    te = init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, device=dev, dtype=BF16), g)
    unet = init_weights_(UNet2DConditionModel(UNET, device=dev, dtype=BF16), g)
    return compile_pipeline(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), device=dev, dtype=BF16))


def _ids(i):
    return torch.full((1, 77), i + 1, dtype=torch.long)


def _session(work):
    """(the spans ``work()`` recorded, the profiler's host calls named
    cudaGraphLaunch as (start, end) ns) under one CPU + CUDA session."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    launches = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CPU
                      and e.name().startswith("cudaGraphLaunch"))
    return [s for s in spans.snapshot() if s.start_ns >= t0], launches


def _children(found, parent):
    return sorted((s for s in found if s.parent == parent.id), key=lambda s: s.start_ns)


def test_a_first_image_captures_inside_its_replays_and_a_second_only_replays(pipe):
    found, _ = _session(lambda: [pipe(prompt_ids=_ids(i), **KW) for i in range(2)])
    requests = sorted((s for s in found if s.name == "sfast.request"), key=lambda s: s.start_ns)
    assert len(requests) == 2 and requests[0].request != requests[1].request
    captured = []
    for req in requests:
        kids = _children(found, req)
        assert [(s.name, s.graph) for s in kids] == (
            [("sfast.replay", g) for g in GRAPHS] + [("sfast.wait", None)])
        for replay in kids[:-1]:
            inner = _children(found, replay)
            assert all((s.name, s.graph, s.request) == ("sfast.capture", replay.graph,
                                                        req.request) for s in inner)
            captured += [s.graph for s in inner]
    # each graph captured once, in the first image, by its first replay
    assert sorted(captured) == sorted(set(GRAPHS))
    first = _children(found, requests[0])
    assert [s.graph for s in first if _children(found, s)] == ["text_encoder", "unet",
                                                                "scheduler.step", "vae"]


def test_each_replay_holds_its_graph_launch(pipe):
    pipe(prompt_ids=_ids(0), **KW)  # captures
    found, launches = _session(lambda: [pipe(prompt_ids=_ids(i), **KW) for i in range(2)])
    replays = [s for s in found if s.name == "sfast.replay"]
    assert len(replays) == 2 * len(GRAPHS) == len(launches)
    for s in replays:
        held = [(a, b) for a, b in launches if s.start_ns <= a and b <= s.end_ns]
        assert len(held) == 1, (s, held)


def test_one_wait_a_served_image_under_map_with_the_fetched_id(pipe):
    pipe(prompt_ids=_ids(0), **KW)
    found, _ = _session(lambda: list(pipe.map([_ids(i) for i in range(3)], window=2, **KW)))
    waits = [s for s in found if s.name == "sfast.wait"]
    dispatched = {s.request for s in found if s.name == "sfast.replay"}
    assert len(waits) == 3 and {w.request for w in waits} == dispatched and len(dispatched) == 3
    assert all(s.request in dispatched for s in found)
