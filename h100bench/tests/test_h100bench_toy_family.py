"""A new model family is added as new files alone: a copy of the benchmark
takes the toy family of ``tests/toy/`` (its configuration, family module,
driver, traffic and limits, and its entries in BENCHMARK.json) and runs a
cell of it through the copy's own harness, past the look for a card; no
file that the copy held before changes.

The toy has what the ``sd_unet`` family lacks: a ``Conv3d`` and a bare
``nn.Parameter`` (which the base init rules refuse), an image as a
request's input, several uint8 frames a request, a slot not named
``unet`` and a driver of its own."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import BENCH, CHECKOUT

TOY = BENCH / "tests" / "toy"
CELL = "toy-clip"
RUN = r"""
import json, sys
sys.path.insert(0, {bench!r})
import torch
import run
bench = json.loads((run.CHECKOUT / "BENCHMARK.json").read_text())
sys.exit(run.run(bench, {cell!r}, 2**31 + 777, 0.3, False, torch.device("cpu")))
"""


def hashes(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def add_toy(bench: dict) -> dict:
    """BENCHMARK.json with the toy's entries added and nothing else changed."""
    out = json.loads(json.dumps(bench))
    out["configs"].append({"name": "toy_clip", "source": "https://example.org/toy-clip",
                           "file": "h100bench/configs/toy_clip.json", "reduced": [],
                           "why": "a test family: Conv3d, a bare parameter, frames"})
    out["workloads"].append({"name": CELL, "config": "toy_clip", "traffic": "clip-4f-16",
                             "chips": 1, "why": "16x16 images made into 4-frame clips"})
    for m in out["end_to_end"]:
        if m["name"] == "image_ms":
            m["workloads"].append(CELL)
    return out


def test_a_family_is_added_by_new_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = hashes(tmp_path / "h100bench")
    for src in sorted(p for p in TOY.rglob("*") if p.is_file() and "__pycache__" not in p.parts):
        dst = tmp_path / "h100bench" / src.relative_to(TOY)
        assert not dst.exists(), dst
        shutil.copy(src, dst)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(add_toy(bench), indent=1))

    out = subprocess.run([sys.executable, "-c", RUN.format(bench=str(tmp_path / "h100bench"),
                                                           cell=CELL)],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"image_ms", "setup_s"}
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 4  # frames, 4 a request
    assert result["metrics"]["image_ms"]["value"] > 0
    assert result["check"]["image_mean_levels"]["value"] <= 0.5

    after = hashes(tmp_path / "h100bench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {p.relative_to(TOY).as_posix() for p in TOY.rglob("*")
                                        if p.is_file() and "__pycache__" not in p.parts}
