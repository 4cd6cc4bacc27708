"""The ``svd`` family on the CPU at tiny sizes: its plain reference against
the port with the same seeded weights (a UNet eval, a temporal decode of a
chunk, the image encoder, a whole clip through the harness), the weights'
names both ways, the reckoned kernel calls against the launches
``chip_smoke.py`` expects of a clip, the model FLOPs of a clip at the
cell's size, and ``correct`` against faults planted under the timed path.

Tolerances: the models 1e-4 of the output's largest value (float32 on both
sides, sums in other orders and layouts: NHWC against NCHW, a (3, 1)
conv of the folded plane against a (3, 1, 1) Conv3d), as
``test_h100bench_reference.py``; a clip's uint8 frames within the uint8
rounding (mean under 0.3 levels, no pixel over 0.51).
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import h100bench_tiny as tiny
from conftest import BENCH, CHECKOUT
from hb.family import family, seeded_weights
from hb.report import Reading, read_metrics, result_line

CELL = "svd-xt-25f"
FULL = json.loads((BENCH / "configs" / "svd_xt.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "i2v-edm25-576x1024.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())

# the cell's configuration and traffic at tiny widths, depth and sizes
CFG = copy.deepcopy(FULL)
CFG.update(name="tiny_svd", dtype="float32")
CFG["assumed"]["image_size"] = {"height": 32, "width": 32}
CFG["unet"].update(
    block_out_channels=[32, 64], layers_per_block=1, num_attention_heads=[4, 4],
    down_block_types=["CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"],
    up_block_types=["UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"],
    cross_attention_dim=32, addition_time_embed_dim=32, projection_class_embeddings_input_dim=96,
    num_frames=4, norm_num_groups=8, sample_size=16)
CFG["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
CFG["image_encoder"].update(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4, projection_dim=32)
TINY = dict(TRAFFIC, frames=4, height=32, width=32, steps=2, decode_chunk_size=3)
SVD = family(FULL)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def cell(cfg=CFG, traffic=TINY, trace=False):
    return dataclasses.replace(tiny.cell(cfg, traffic), trace=trace)


def loaded():
    """(reference, port) modules with the same seeded weights, float32."""
    c = cell()
    meta = SVD.reference_modules(CFG)
    w = seeded_weights(c, meta, "cpu", torch.float32)
    port = SVD.port_modules(CFG, w, "cpu")
    for s, m in meta.items():
        m.load_state_dict(SVD.with_mix_factors(CFG, s, w[s]), strict=True, assign=True)
    return meta, port


def close(ref, got):
    assert (ref - got).abs().max() <= 1e-4 * ref.abs().max()


def test_models_against_the_port():
    ref, port = loaded()
    torch.manual_seed(0)
    b, f = 2, TINY["frames"]
    x = torch.randn(b, f, 8, 16, 16)
    t, ctx = torch.tensor(0.25 * np.log(7.0)), torch.randn(b, 1, 32)
    ids = torch.tensor([[6.0, 127.0, 0.02], [6.0, 127.0, 0.02]])
    got = port["unet"](x.permute(0, 1, 3, 4, 2), t, ctx, ids).permute(0, 1, 4, 2, 3)
    close(ref["unet"](x, t, ctx, ids), got)
    z = torch.randn(3, 4, 16, 16)  # one chunk of 3 frames
    got = port["vae"].decode(z.permute(0, 2, 3, 1), num_frames=3).permute(0, 3, 1, 2)
    close(ref["vae"].decode(z, num_frames=3), got)
    img = torch.rand(1, 3, 32, 32) * 2 - 1
    mean, _ = port["vae"].encode(img.permute(0, 2, 3, 1))
    close(ref["vae"].encode(img), mean.permute(0, 3, 1, 2))
    px = torch.randn(2, 3, 32, 32)
    close(ref["image_encoder"](px), port["image_encoder"](px.permute(0, 2, 3, 1))["image_embeds"])


def test_the_mix_factors_are_the_configurations():
    ref, port = loaded()
    for slot, want in (("unet", 0.5), ("vae", 0.0)):
        for m in (ref[slot], port[slot]):
            got = {k: v.item() for k, v in m.state_dict().items() if k.endswith("mix_factor")}
            assert got and set(got.values()) == {want}, slot


def test_weights_load_strictly_both_ways_at_full_size():
    """Every name and shape of the reference is the port's, at the cell's
    full size: the reference's state dict loads into the port strictly,
    and the port's into the reference."""
    from families.svd_lib.port import port_configs
    from sfast_tpu_torch.models import (
        AutoencoderKLTemporalDecoder, CLIPVisionModel, UNetSpatioTemporalConditionModel,
    )

    classes = {"unet": UNetSpatioTemporalConditionModel, "vae": AutoencoderKLTemporalDecoder,
               "image_encoder": CLIPVisionModel}
    confs = port_configs(FULL)
    for slot, ref in SVD.reference_modules(FULL).items():
        with torch.device("meta"):
            port = classes[slot](confs[slot], device="meta")
        want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want, slot
        port.load_state_dict(ref.state_dict(), strict=True, assign=True)
        ref.load_state_dict(port.state_dict(), strict=True, assign=True)


def test_the_reference_imports_nothing_of_the_program():
    """The family's reference, sampler and counts, and the family module
    found by name as a run finds it, in a fresh interpreter."""
    from test_h100bench_imports import imported

    new = imported(["families.svd_lib.reference", "families.svd_lib.sampling",
                    "families.svd_lib.counts", "hb.family"],
                   "import hb.family\nhb.family.family({'family': 'svd'})\n")
    assert not new & {"jax", "jaxlib", "flax", "sfast_tpu", "sfast_tpu_torch"}


def test_a_clip_against_the_reference():
    d = tiny.driver(cell())
    win = d.window(d.setup())
    d.free()
    assert win.done == len(d.images) * TINY["frames"] and d.images[0].shape == (4, 32, 32, 3)
    assert np.stack(d.images).std() > 10  # frames, not a constant
    r = d.check()
    assert r["image_mean_levels"] < 0.3 and r["image_max_levels"] <= 0.51


@pytest.mark.parametrize("hw", [(576, 1024), (32, 32), (40, 24)])
def test_the_clip_resize_is_torchs_antialiased_bilinear(hw):
    """The port's resize of the still for CLIP and the reference's, which
    follows it, against an independent one: torch's antialiased bilinear
    (``F.interpolate``), within float32 rounding."""
    import torch.nn.functional as F

    from families.svd_lib.sampling import CLIP_MEAN, CLIP_STD, clip_pixels
    from sfast_tpu_torch.utils.image import resize_bilinear

    x = torch.rand((1, *hw, 3), generator=torch.Generator().manual_seed(hw[0]))
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(16, 16), mode="bilinear",
                         align_corners=False, antialias=True)
    torch.testing.assert_close(resize_bilinear(x, 16, 16).permute(0, 3, 1, 2), want,
                               rtol=0, atol=1e-6)
    mean, std = (torch.tensor(v)[None, :, None, None] for v in (CLIP_MEAN, CLIP_STD))
    got = clip_pixels(x.permute(0, 3, 1, 2) * 2 - 1, 16) * std + mean
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_a_step_of_karras_sign_is_refused_before_any_weight(monkeypatch):
    """The parent's EDM step (c_out > 0, as ``sfast_tpu``'s) stops the cell
    when its driver is made, before the weights are drawn."""
    from sfast_tpu_torch.schedulers import edm_euler

    real = edm_euler.EDMEulerScheduler._c

    def karras(self, sigma):
        c_skip, c_out, c_in = real(self, sigma)
        return c_skip, -c_out, c_in

    monkeypatch.setattr(edm_euler.EDMEulerScheduler, "_c", karras)
    with pytest.raises(ValueError, match="Karras"):
        tiny.driver(cell())


def test_reckoned_kernel_calls_are_the_launches_chip_smoke_expects():
    """K1 250 and K2 117 calls a clip at the cell's shapes, as
    ``chip_smoke.py``'s ``EXPECTED_SVD_LAUNCHES`` (met on the card)."""
    import chip_smoke

    calls = SVD.kernel_calls(FULL, TRAFFIC)
    assert calls["flash_attention"] == {(50, 5, 9216, 9216, 64): 125,
                                        (50, 10, 2304, 2304, 64): 125}
    for kernel, shapes in calls.items():
        assert sum(shapes.values()) == chip_smoke.EXPECTED_SVD_LAUNCHES[kernel], kernel
    assert calls["conv3x3"][(589824, 128, 128, 5, True)] == 15  # the last level's conv2
    assert sum(n for (_, _, _, b, _), n in calls["conv3x3"].items() if b == 1) == 12  # encode


def test_request_flops_of_a_clip_at_full_size():
    """4,173.9 TFLOP a clip: the image encoder 0.335, the VAE encode 2.609,
    25 UNet evals of 159.9 at CFG batch 50, the decode of 25 frames 173.6."""
    assert SVD.request_flops(FULL, TRAFFIC) == {
        "image_encoder": 334590279680, "vae_encode": 2609118314496,
        "unet_eval": 159896460492800, "decode": 173574202982400,
        "request": 4173929423896576}


def test_a_traced_run_reads_its_metrics_without_a_card():
    """The ranges count the clip's calls; a metric of device ops or of the
    spans over them reads nothing where no device op was traced."""
    c = cell(trace=True)
    d = tiny.driver(c)
    w = d.window(d.setup())
    assert w.traced == 1 and w.calls == {"image_encoder": 1, "vae_encode": 1, "unet": 2,
                                         "scheduler_step": 2}
    entries = [m for m in json.loads((CHECKOUT / "BENCHMARK.json").read_text())["per_layer"]
               if CELL in m["workloads"]]
    got = read_metrics(entries, BENCH / "metrics", Reading(c, w))
    assert got == {"kernel_launches_per_image": {"value": 0.0, "unit": "count"}}


def run(capsys):
    c = cell()
    assert result_line(c, tiny.driver(c), LIMITS, [], [], BENCH, lambda: []) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    out = run(capsys)
    assert out["correct"] and set(out["check"]) == set(LIMITS)


def test_one_frame_altered(capsys, monkeypatch):
    """One frame of each clip inverted: the clip's mean gap is a quarter of
    the frame's, the worst frame's is all of it."""
    from sfast_tpu_torch.pipelines import stable_video_diffusion as svd

    real = svd.StableVideoDiffusionPipeline._decode

    def altered(self, latents, chunk):
        frames = real(self, latents, chunk).copy()
        frames[1] = 255 - frames[1]
        return frames

    monkeypatch.setattr(svd.StableVideoDiffusionPipeline, "_decode", altered)
    assert not run(capsys)["correct"]


def test_an_edm_step_that_leaves_the_latents_unchanged(capsys, monkeypatch):
    from sfast_tpu_torch.schedulers import edm_euler

    monkeypatch.setattr(edm_euler.EDMEulerScheduler, "step",
                        lambda self, state, out, i, sample: (sample, state))
    assert not run(capsys)["correct"]


def test_the_temporal_branch_skipped(capsys, monkeypatch):
    """Every blend forced to its spatial side: the temporal resnets and
    transformers, and the decoder's, reach nothing."""
    from sfast_tpu_torch.models import unet_spatio_temporal as st

    monkeypatch.setattr(st.AlphaBlender, "forward", lambda self, spatial, temporal: spatial)
    assert not run(capsys)["correct"]


def test_the_control_reads_far_above_the_program():
    """The reference with its products in fp8, served as uint8, against the
    float32 reference: many times the program's own gap (the cell's
    readings at full size: PERF.md)."""
    from hb import checks

    c = cell()
    d = tiny.driver(c)
    d.window(d.setup())
    d.free()
    program = d.check()["image_mean_levels"]
    reqs = [(0, d.request_seed(0))]
    ref = SVD.reference_outputs(c, reqs)
    low = [torch.round(x).to(torch.uint8).numpy() for x in SVD.reference_outputs(c, reqs, "fp8")]
    assert len(ref) == TINY["frames"]
    assert checks.image_gaps(low, ref)["image_mean_levels"] > 3 * program
