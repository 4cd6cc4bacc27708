"""A run's result: the metrics of the cell, read by the files that
``BENCHMARK.json`` names, the device, and the numbers compared with their
limits; printed as the last line of standard output."""

import functools
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List

import torch

from hb.drive import Window
from hb.family import by_path as _module


class Reading:
    """What a per-layer metric reads: the cell, the window with its traced
    stretch, and from the cell's family the model FLOPs of a request or a
    step and the calls of the port's kernels a request makes."""

    def __init__(self, cell, win: Window):
        self.cell, self.cfg, self.traffic, self.win = cell, cell.cfg, cell.traffic, win
        self.trace = win.trace

    @functools.cached_property
    def request_flops(self) -> int:
        return self.cell.family.request_flops(self.cfg, self.traffic)["request"]

    @functools.cached_property
    def step_flops(self) -> int:
        return self.cell.family.train_step_flops(self.cfg, self.traffic)

    @functools.cached_property
    def kernel_calls(self) -> dict:
        """{kernel: {call shape: calls}} of one request, where the family
        reckons them."""
        return self.cell.family.kernel_calls(self.cfg, self.traffic)

    def in_window(self, pred: Callable = lambda op: True) -> list:
        """The device ops launched in the traced window that ``pred`` takes."""
        return [o for o in self.trace.window_ops() if pred(o)]

    def device_s(self, pred: Callable = lambda op: True) -> float:
        return sum(o.end_ns - o.start_ns for o in self.in_window(pred)) / 1e9


def read_metrics(entries: List[dict], folder: Path, arg) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = _module(folder / f"{m['name']}.py").read(arg)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_record(dev: torch.device) -> dict:
    """The device the run used; its peak memory is read before the program's
    state is freed and the reference runs."""
    if dev.type != "cuda":  # the CPU tests drive the harness without a card
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {'value', 'limit'}}): every number that has a limit
    is finite and at most its limit."""
    check = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in check.values()), check


def result_line(cell, driver, limits: Dict[str, float], e2e: List[dict], per_layer: List[dict],
                here: Path, forbidden_modules: Callable[[], list]) -> int:
    win = driver.setup()
    win = driver.window(win)
    device = device_record(cell.device)
    if cell.trace:
        metrics = read_metrics(per_layer, here / "metrics", Reading(cell, win))
        device.update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
    else:
        metrics = read_metrics(e2e, here / "e2e", win)
    print("setup_phases_s " + json.dumps(win.phases), file=sys.stderr)
    if win.trace is not None:
        print(f"trace: {len(win.trace.ops)} device ops, {win.trace.unattributed} without their "
              f"launching call", file=sys.stderr)
    if win.latencies_s:
        print("latencies_ms " + " ".join(f"{x * 1e3:.1f}" for x in win.latencies_s),
              file=sys.stderr)
    driver.free()
    readings = driver.check()
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run imported {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    correct, check = judge(readings, limits)
    for k, v in readings.items():
        if k not in limits:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    out = {"correct": correct, "attempted": win.done, "failed": 0, "metrics": metrics,
           "device": device}
    if cell.trace:
        out["breakdown"] = win.trace.breakdown()
    out["check"] = check
    for k, v in check.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
