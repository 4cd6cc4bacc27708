"""The port's spans (``profile/spans.py``) on the CPU: nothing recorded
without a profiler session; under one, a pipeline's ``__call__`` and
``map`` record the span tree with one request id a request, ``map``'s
waits carry the fetched request's id, and no time in the caller's iterator
or after a ``yield`` lies inside a span; each span's ``sfast.*`` profiler
range is in the profiler's events and lies inside the span's recorded
times, which are on the profiler's clock (the shared clock).

A graph cannot be captured here, so the graphed calls are rehearsed with
a stand-in capture whose "graph" runs the function on its static inputs
(as ``tests/test_torch_compile.py``); captures and the card's replays are
in ``tests/test_torch_spans_cuda.py``.
"""

import dataclasses
import time

import pytest
import torch
import torch.utils._pytree as pytree
from torch.profiler import ProfilerActivity, profile

import sfast_tpu_torch
from sfast_tpu_torch.models import (
    TINY_IMAGE_ENCODER, TINY_SVD_UNET, TINY_TEMPORAL_VAE, TINY_TEST_VAE, TINY_TEXT_ENCODER,
    TINY_UNET, AutoencoderKL, AutoencoderKLTemporalDecoder, CLIPTextModel, CLIPVisionModel,
    UNet2DConditionModel, UNetSpatioTemporalConditionModel, init_svd_unet_weights_,
    init_temporal_vae_weights_, init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline, StableVideoDiffusionPipeline
from sfast_tpu_torch.profile import spans
from sfast_tpu_torch.runtime.tracing import CapturedGraph, LazyCompiledFunction
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

STEPS = 2
KW = dict(height=32, width=32, num_inference_steps=STEPS)
# one request's graphed calls: the text encoder, a UNet eval and a scheduler
# step a step, the decode
GRAPHS = ["text_encoder"] + ["unet", "scheduler.step"] * STEPS + ["vae"]
# a span's range opens after its start is stamped and closes before its end
# is; the profiler converts its own clock to this one, to well under
# CLOCK_SLACK_NS.  The stamp and the range's start lie microseconds apart
# (the thread may be preempted between them: the median is compared with
# CLOCK_TOL_NS); a clock of another base is off by seconds or years
CLOCK_SLACK_NS = 50_000
CLOCK_TOL_NS = 1_000_000
# a tiny SVD clip: 4 frames of 32², 2 steps, decoded in chunks of 3 + 1
SVD_KW = dict(num_frames=4, height=32, width=32, num_inference_steps=2, decode_chunk_size=3)
# its graphed calls: the image encoder, the VAE encode, a UNet eval and an
# EDM step a step, the decode graph a chunk
SVD_GRAPHS = (["image_encoder", "vae_encode"] + ["unet", "scheduler.step"] * 2
              + ["svd_decode_u8"] * 2)


@pytest.fixture(scope="module")
def pipe():
    f32 = dict(device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET, cross_attention_dim=64), **f32)
    vae = AutoencoderKL(TINY_TEST_VAE, **f32)
    te = CLIPTextModel(TINY_TEXT_ENCODER, **f32)
    for m in (unet, vae, te):
        init_weights_(m, g)
    return sfast_tpu_torch.compile(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), device="cpu", dtype=torch.float32))


@pytest.fixture(scope="module")
def svd_pipe():
    f32 = dict(device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    unet = init_svd_unet_weights_(UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **f32), g)
    vae = init_temporal_vae_weights_(AutoencoderKLTemporalDecoder(TINY_TEMPORAL_VAE, **f32), g)
    enc = init_weights_(CLIPVisionModel(TINY_IMAGE_ENCODER, **f32), g)
    return sfast_tpu_torch.compile(StableVideoDiffusionPipeline(unet, vae, enc, device="cpu",
                                                                dtype=torch.float32))


def _still(i):
    return torch.randint(0, 256, (1, 32, 32, 3), generator=torch.Generator().manual_seed(i),
                         dtype=torch.uint8).numpy()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _EagerGraph:
    """Stands in for a captured graph: a replay runs the function on the
    static inputs and copies its outputs into the static outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for static, x in zip(pytree.tree_leaves(self.out), pytree.tree_leaves(self.fn())):
            if isinstance(static, torch.Tensor):
                static.copy_(x)


@pytest.fixture
def graphed(monkeypatch):
    """Every compiled call takes the graph path, captured by the stand-in."""
    def capture(self, leaves, spec):
        static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args, kwargs = pytree.tree_unflatten(static, spec)

        def fn():
            return self.fn(*args, **kwargs)

        out = fn()
        return CapturedGraph(_EagerGraph(fn, out), static, out, {}, 0.0, 0.0, 0)

    monkeypatch.setattr(LazyCompiledFunction, "_capture", capture)
    monkeypatch.setattr(LazyCompiledFunction, "_uses_graph", staticmethod(lambda leaves: True))


def _ids(i):
    return torch.full((1, 77), i + 1, dtype=torch.long)


def _session(work):
    """(the spans ``work()`` recorded, the profiler) under one CPU session."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    return [s for s in spans.snapshot() if s.start_ns >= t0], prof


def _children(found, parent):
    return sorted((s for s in found if s.parent == parent.id), key=lambda s: s.start_ns)


def test_no_session_records_nothing(pipe, graphed):
    before = spans.snapshot()
    t0 = time.time_ns()
    pipe(prompt_ids=_ids(0), **KW)
    for _ in pipe.map([_ids(1), _ids(2)], window=2, **KW):
        pass
    after = spans.snapshot()
    assert len(after) == len(before) and not [s for s in after if s.start_ns >= t0]
    assert spans.request() is spans.wait() is spans.replay("unet") is spans.capture("unet")


def test_call_records_a_request_with_its_replays_and_its_wait(pipe, graphed):
    pipe(prompt_ids=_ids(0), **KW)  # captures
    found, _ = _session(lambda: [pipe(prompt_ids=_ids(i), **KW) for i in range(2)])
    requests = [s for s in found if s.name == "sfast.request"]
    assert len(requests) == 2 and len({r.request for r in requests}) == 2
    for req in requests:
        assert req.parent is None
        kids = _children(found, req)
        assert [(s.name, s.graph) for s in kids] == (
            [("sfast.replay", g) for g in GRAPHS] + [("sfast.wait", None)])
        assert all(s.request == req.request and req.start_ns <= s.start_ns <= s.end_ns
                   <= req.end_ns for s in kids)
    assert len(found) == 2 * (len(GRAPHS) + 2)


def test_svd_call_opens_no_span_without_a_session(svd_pipe, graphed):
    before = spans.snapshot()
    t0 = time.time_ns()
    frames = svd_pipe(_still(0), **SVD_KW).images
    assert frames.shape == (1, 4, 32, 32, 3)
    after = spans.snapshot()
    assert len(after) == len(before) and not [s for s in after if s.start_ns >= t0]


def test_svd_call_is_one_request_with_its_replays_and_its_decode_wait(svd_pipe, graphed):
    """A clip is one ``sfast.request``; its graphed calls replay inside it,
    and the decode's sync with the frames' ``.numpy()`` is the one
    ``sfast.wait``, last."""
    svd_pipe(_still(0), **SVD_KW)  # captures
    found, _ = _session(lambda: svd_pipe(_still(1), **SVD_KW))
    requests = [s for s in found if s.name == "sfast.request"]
    assert len(requests) == 1 and requests[0].parent is None
    req = requests[0]
    kids = _children(found, req)
    assert [(s.name, s.graph) for s in kids] == (
        [("sfast.replay", g) for g in SVD_GRAPHS] + [("sfast.wait", None)])
    assert all(s.request == req.request and req.start_ns <= s.start_ns <= s.end_ns
               <= req.end_ns for s in kids)
    assert len(found) == len(SVD_GRAPHS) + 2


def test_map_spans_each_item_and_its_fetch_and_leave_the_caller_out(pipe, graphed):
    pipe(prompt_ids=_ids(0), **KW)
    caller = []  # host intervals in the caller's iterator and after each yield

    def items():
        for i in range(3):
            t0 = time.time_ns()
            time.sleep(0.002)
            caller.append((t0, time.time_ns()))
            yield _ids(i)

    def serve():
        for _ in pipe.map(items(), window=2, **KW):
            t0 = time.time_ns()
            time.sleep(0.002)
            caller.append((t0, time.time_ns()))

    found, _ = _session(serve)
    tops = sorted((s for s in found if s.parent is None), key=lambda s: s.start_ns)
    assert all(s.name == "sfast.request" for s in tops)
    # dispatch 1, dispatch 2, fetch 1, dispatch 3, fetch 2, fetch 3
    ids = [s.request for s in tops]
    assert len(tops) == 6 and len({ids[0], ids[1], ids[3]}) == 3
    assert [ids[2], ids[4], ids[5]] == [ids[0], ids[1], ids[3]]
    for k in (0, 1, 3):  # a dispatch: the item's replays, under its id
        kids = _children(found, tops[k])
        assert [(s.name, s.graph) for s in kids] == [("sfast.replay", g) for g in GRAPHS]
        assert {s.request for s in kids} == {ids[k]}
    for k in (2, 4, 5):  # a fetch: one wait, with the fetched request's id
        kids = _children(found, tops[k])
        assert [s.name for s in kids] == ["sfast.wait"] and kids[0].request == ids[k]
    assert len(caller) == 6
    for a, b in caller:
        assert not [s for s in found if s.start_ns < b and s.end_ns > a]


def test_each_span_is_a_profiler_range_on_the_same_clock(pipe, graphed):
    pipe(prompt_ids=_ids(0), **KW)

    def work():
        pipe(prompt_ids=_ids(1), **KW)
        for _ in pipe.map([_ids(2)], window=1, **KW):
            pass

    found, prof = _session(work)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sfast."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert set(ranges) == {"sfast.request", "sfast.replay", "sfast.wait"}
    assert sum(map(len, ranges.values())) == len(found)
    lead = []
    for s in found:
        held = [a for a, b in ranges[s.name]
                if s.start_ns - CLOCK_SLACK_NS <= a and b <= s.end_ns + CLOCK_SLACK_NS]
        assert held, s
        lead.append(min(held) - s.start_ns)
    assert sorted(lead)[len(lead) // 2] <= CLOCK_TOL_NS


def test_a_graphed_train_step_is_one_replay(monkeypatch):
    """The graph path of ``LoraTrainStep`` (captured by a stand-in that
    runs the step on its static inputs): one ``sfast.replay`` span of
    ``lora_train_step`` a step, outside any request."""
    from sfast_tpu_torch import CompilationConfig
    from sfast_tpu_torch.training import lora_trainer, lora_training_setup, make_lora_train_step

    class ReplayEagerly:
        def __init__(self, fn, static):
            self.fn, self.static = fn, static

        def run(self, leaves):
            for s, x in zip(self.static, leaves):
                s.copy_(x)
            return self.fn().clone()

    monkeypatch.setattr(lora_trainer, "capture_graph",
                        lambda fn, device, static, **kw: ReplayEagerly(fn, static))
    monkeypatch.setattr(lora_trainer, "_on_card", lambda x: True)
    monkeypatch.setattr(lora_trainer, "_check_graphable", lambda opt, dev: None)
    unet = init_weights_(UNet2DConditionModel(dataclasses.replace(
        TINY_UNET, cross_attention_dim=64), device="cpu", dtype=torch.float32),
        torch.Generator().manual_seed(0))
    lora, opt = lora_training_setup(unet, rank=2, generator=torch.Generator().manual_seed(0))
    step = make_lora_train_step(unet, opt, ccfg=CompilationConfig(enable_kernels=False))
    batch = {"latents": torch.randn(1, 16, 16, 4), "context": torch.randn(1, 7, 64)}
    g = torch.Generator().manual_seed(1)
    step(lora, batch, g)  # captures
    found, _ = _session(lambda: [step(lora, batch, g) for _ in range(2)])
    assert [(s.name, s.graph, s.request, s.parent) for s in found] == [
        ("sfast.replay", "lora_train_step", None, None)] * 2
