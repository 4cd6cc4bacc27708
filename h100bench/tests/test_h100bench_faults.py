"""A run's ``correct`` against faults planted under the timed path, and the
control: a tiny run on the CPU through the harness (everything but its
look for a card), with the cells' own limits."""

import json

import pytest
import torch

import h100bench_tiny as tiny
from conftest import BENCH, CHECKOUT
from hb import drive
from hb.report import result_line

BENCHMARK = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def run(cfg, traffic, cell_limits, capsys):
    c = tiny.cell(cfg, traffic)
    rc = result_line(c, drive.DRIVERS[traffic["call"]](c), cell_limits, [], [], BENCH,
                     lambda: [])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_runs_are_correct(capsys):
    assert run(tiny.SD, tiny.DPM, limits("sd15-t2i-dpm50"), capsys)["correct"]
    assert run(tiny.SD, tiny.TRAIN, limits("sd15-lora-train"), capsys)["correct"]


def test_an_image_altered_where_it_is_produced(capsys, monkeypatch):
    import sfast_tpu_torch.pipelines.stable_diffusion as sd

    real = sd.denormalize_to_uint8

    def altered(image):
        out = real(image).clone()
        out[:, : out.shape[1] // 4] = 255 - out[:, : out.shape[1] // 4]
        return out

    monkeypatch.setattr(sd, "denormalize_to_uint8", altered)
    for traffic, cell in ((tiny.DPM, "sd15-t2i-dpm50"), (tiny.LCM_MAP, "sd15-lcm4-map")):
        assert not run(tiny.SD, traffic, limits(cell), capsys)["correct"]


def test_a_scheduler_step_that_returns_its_state_unchanged(capsys, monkeypatch):
    from sfast_tpu_torch.schedulers import dpm

    monkeypatch.setattr(dpm.DPMSolverMultistepScheduler, "step",
                        lambda self, state, out, i, sample: (sample, state))
    assert not run(tiny.SD, tiny.DPM, limits("sd15-t2i-dpm50"), capsys)["correct"]


def test_a_train_step_that_returns_its_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    out = run(tiny.SD, tiny.TRAIN, limits("sd15-lora-train"), capsys)
    assert not out["correct"]
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_train_step_that_stops_moving_after_the_first_steps(capsys, monkeypatch):
    """A fault that shows only after set-up's three steps: the step after
    the window is held against the reference from the state it started
    from, and reads 1."""
    real = torch.optim.AdamW.step
    calls = []

    def tired(self, closure=None):
        calls.append(1)
        return real(self, closure) if len(calls) <= 3 else None

    monkeypatch.setattr(torch.optim.AdamW, "step", tired)
    out = run(tiny.SD, tiny.TRAIN, limits("sd15-lora-train"), capsys)
    assert out["check"]["change_gap"]["value"] < out["check"]["change_gap"]["limit"]
    assert out["check"]["late_change_gap"]["value"] == pytest.approx(1.0)
    assert not out["correct"]


def test_half_of_the_batch_left_out(capsys, monkeypatch):
    from sfast_tpu_torch.training import lora_trainer

    real = lora_trainer.LoraTrainStep._update

    def half(self, lora, latents, context, t, noise):
        n = latents.shape[0] // 2
        return real(self, lora, latents[:n], context[:n], t[:n], noise[:n])

    monkeypatch.setattr(lora_trainer.LoraTrainStep, "_update", half)
    assert not run(tiny.SD, tiny.TRAIN, limits("sd15-lora-train"), capsys)["correct"]


@pytest.mark.parametrize("traffic", [tiny.DPM, tiny.LCM_MAP], ids=["dpm", "lcm"])
def test_the_control_reads_far_above_the_program(traffic):
    """The reference with its products in fp8, served as uint8, against the
    float32 reference: many times the program's own gap (the cells' readings
    at full size: PERF.md)."""
    from hb import checks, inputs

    c = tiny.cell(tiny.SD, traffic)
    d = drive.ServeDriver(c)
    win = d.window(d.setup())
    d.free()
    program = d.check()["image_mean_levels"]
    reqs = [(inputs.prompt_ids(c.seed, i), d.request_seed(i)) for i in range(win.done)][:2]
    ref = checks.reference_images(c, reqs)
    low = [torch.round(x).to(torch.uint8).numpy() for x in checks.reference_images(c, reqs,
                                                                                   "fp8")]
    assert checks.image_gaps(low, ref)["image_mean_levels"] > 3 * program


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_the_control_fails_the_cell_limits_at_full_size(cell, card):
    """On the card: control.py's readings at the cell's own size fail one of
    the cell's limits."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(BENCH / "control.py"), "--workload", cell,
                          "--seeds", "3000000001"], capture_output=True, text=True, check=True,
                         cwd=CHECKOUT, timeout=600)
    got = json.loads(out.stdout.strip().splitlines()[-1])["control_fp8"]
    assert any(got[k] > v for k, v in limits(cell).items())
