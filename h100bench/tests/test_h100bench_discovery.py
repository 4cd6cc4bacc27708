"""BENCHMARK.json against the files it names, and against the contract's
limits on names, units, bounds and sizes."""

import json
import re

import pytest

from conftest import BENCH, CHECKOUT
from hb.report import _module

BENCHMARK = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def entries():
    return [("end_to_end", m) for m in BENCHMARK["end_to_end"]] + [
        ("per_layer", m) for m in BENCHMARK["per_layer"]]


def test_keys_and_sizes():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["h100bench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [c["name"] for c in BENCHMARK["configs"]] + CELLS + [m["name"] for _, m in entries()]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for _, m in entries()}) == len(entries())


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_finds_its_files_by_name(cell):
    w = {x["name"]: x for x in BENCHMARK["workloads"]}[cell]
    config = {c["name"]: c for c in BENCHMARK["configs"]}[w["config"]]
    assert json.loads((CHECKOUT / config["file"]).read_text())["name"] == w["config"]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert traffic["call"] in ("call", "map", "train")
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    reported = [m for _, m in entries() if cell in m.get("workloads", [cell])]
    assert {m["name"] for m in reported} & {"setup_s"}
    assert any(m["name"] != "setup_s" for m in reported if m in BENCHMARK["end_to_end"])
    assert any(m in BENCHMARK["per_layer"] for m in reported)


@pytest.mark.parametrize("kind,metric", entries(), ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_a_metric_is_a_file_of_its_own_that_agrees_with_its_entry(kind, metric):
    folder = "e2e" if kind == "end_to_end" else "metrics"
    mod = _module(BENCH / folder / f"{metric['name']}.py")
    assert mod.UNIT == metric["unit"] and UNIT.match(metric["unit"])
    assert mod.SOURCE == metric["source"]
    assert metric["better"] in ("lower", "higher")
    if kind == "end_to_end":
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert mod.LAYER == metric["layer"] and mod.MOVES == metric["moves"]
        moved = {m["name"]: m for m in BENCHMARK["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))
