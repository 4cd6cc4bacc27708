"""The six ``examples_torch/`` scripts, each through its ``main`` at the
``TINY_*`` configs on the CPU (1–2 steps): they run through the port's
entry points without raising and give outputs of the expected shape.  On
the card they run at full width (``chip_smoke.py``'s phase 18)."""

import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from examples_torch import (
    _common,
    optimize_instant_id_pipeline,
    optimize_lcm_lora,
    optimize_lcm_pipeline,
    optimize_stable_diffusion_pipeline,
    optimize_stable_video_diffusion_pipeline,
    optimize_train_text_to_image_lora,
)
from sfast_tpu_torch.models import (
    TINY_CONTROLNET,
    TINY_IMAGE_ENCODER,
    TINY_SVD_UNET,
    TINY_TEMPORAL_VAE,
    TINY_TEST_VAE,
    TINY_TEXT_ENCODER,
    TINY_UNET,
)
from tests.test_torch_svd import _one_torch_thread  # noqa: F401  (an autouse fixture)

UNET64 = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
CPU = ["--device", "cpu"]


@pytest.fixture
def tiny_sd(monkeypatch):
    def swap(module):
        monkeypatch.setattr(module, "UNET_CONFIG", UNET64)
        monkeypatch.setattr(module, "VAE_CONFIG", TINY_TEST_VAE)
        monkeypatch.setattr(module, "TEXT_CONFIG", TINY_TEXT_ENCODER)
        return module

    return swap


@pytest.mark.parametrize("fuse", ["--fuse-loop", "--no-fuse-loop"])
def test_stable_diffusion(tiny_sd, fuse, capsys):
    out = tiny_sd(optimize_stable_diffusion_pipeline).main(
        ["--steps", "2", "--height", "32", "--width", "32", "--repeats", "1", "--serve", "2",
         fuse] + CPU)
    assert out["images"].shape == (1, 32, 32, 3) and out["images"].dtype == np.uint8
    said = capsys.readouterr().out
    assert "best e2e" in said and "sustained serving (2 images" in said
    assert ("it/s" in said.split("run 0")[1].splitlines()[0]) == (fuse == "--no-fuse-loop")


def test_lcm(tiny_sd, capsys):
    out = tiny_sd(optimize_lcm_pipeline).main(["--steps", "2", "--size", "32"] + CPU)
    assert out["images"].shape == (1, 32, 32, 3)
    assert "LCM 2-step e2e" in capsys.readouterr().out


def test_lcm_lora(tiny_sd):
    out = tiny_sd(optimize_lcm_lora).main(["--steps", "2", "--size", "32"] + CPU)
    assert out["images"].shape == (1, 32, 32, 3) and out["graphs"] == 0


def test_instant_id(tiny_sd, monkeypatch, capsys):
    monkeypatch.setattr(optimize_instant_id_pipeline, "CONTROLNET_CONFIG",
                        dataclasses.replace(TINY_CONTROLNET, unet=UNET64))
    out = tiny_sd(optimize_instant_id_pipeline).main(["--steps", "2", "--size", "32"] + CPU)
    assert out["images"].shape == (1, 32, 32, 3)
    assert "InstantID-style 2-step e2e" in capsys.readouterr().out


def test_stable_video_diffusion(monkeypatch):
    m = optimize_stable_video_diffusion_pipeline
    monkeypatch.setattr(m, "UNET_CONFIG", TINY_SVD_UNET)
    monkeypatch.setattr(m, "VAE_CONFIG", TINY_TEMPORAL_VAE)
    monkeypatch.setattr(m, "IMAGE_ENCODER_CONFIG", TINY_IMAGE_ENCODER)
    out = m.main(["--frames", "2", "--height", "32", "--width", "32", "--steps", "2",
                  "--decode-chunk-size", "1"] + CPU)
    assert out["frames"].shape == (1, 2, 32, 32, 3) and out["frames"].dtype == np.uint8


@pytest.fixture
def tiny_train(monkeypatch):
    m = optimize_train_text_to_image_lora
    monkeypatch.setattr(m, "UNET_CONFIG", UNET64)
    monkeypatch.setattr(m, "LATENT_HW", 16)
    monkeypatch.setattr(m, "CONTEXT_LEN", 7)
    return m


def test_train_lora(tiny_train):
    out = tiny_train.main(["--batch", "2", "--steps", "2", "--rank", "2"] + CPU)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert any(f["b"].abs().max() > 0 for f in out["lora"].values())  # B moved off zero


def test_train_lora_on_a_mesh_of_one(tiny_train, tmp_path):
    """``--mesh 1x1`` in a gloo world of one: the tensor-parallel UNet
    takes the same two steps as the script without a mesh."""
    plain = tiny_train.main(["--batch", "2", "--steps", "2", "--rank", "2"] + CPU)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        meshed = tiny_train.main(["--batch", "2", "--steps", "2", "--rank", "2",
                                  "--mesh", "1x1"] + CPU)
    finally:
        dist.destroy_process_group()
    assert meshed["losses"] == plain["losses"]
    for mod, f in plain["lora"].items():
        for k in ("a", "b"):
            assert torch.equal(meshed["lora"][mod][k], f[k])


def test_prompt_ids_stay_in_the_vocabulary():
    class Enc:
        config = TINY_TEXT_ENCODER

    ids = _common.prompt_ids(Enc())
    assert ids.shape == (1, 77) and int(ids.max()) < TINY_TEXT_ENCODER.vocab_size
