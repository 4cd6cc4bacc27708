"""The ``frames`` traffic of the toy family: a closed loop of requests, each
an image made into a clip of several uint8 frames; every frame delivered
to the host counts as one image of the window.  The toy traces nothing."""

import time
from typing import Dict, List

import numpy as np
import torch

from hb import checks, inputs
from hb.drive import Cell, Window, check_keys, phases
from hb.family import seeded_weights


class FramesDriver:
    KEYS = {"call", "check_requests"}

    def __init__(self, cell: Cell):
        self.cell = cell
        check_keys(cell.traffic, self.KEYS)
        self.family = cell.family
        self.clips: List[List[np.ndarray]] = []

    def _serve(self, i: int) -> List[np.ndarray]:
        return self.pipe(**self.family.request_inputs(self.cell.cfg, self.cell.seed, i))

    def setup(self) -> Window:
        cell, fam = self.cell, self.family
        marks = [("start", time.perf_counter())]
        meta = fam.reference_modules(cell.cfg)
        weights = seeded_weights(cell, meta, cell.device, getattr(torch, cell.cfg["dtype"]))
        marks.append(("weights", time.perf_counter()))
        self.pipe = fam.build_pipeline(cell.cfg, cell.traffic,
                                       fam.port_modules(cell.cfg, weights, cell.device),
                                       cell.device, "")
        for k in range(2):
            self._serve(-1 - k)
        marks.append(("warm-up", time.perf_counter()))
        win = Window(setup_s=time.perf_counter() - self.cell.t0)
        win.phases = phases(self.cell.t0, marks)
        return win

    def window(self, win: Window) -> Window:
        start = time.perf_counter()
        while True:
            self.clips.append(self._serve(len(self.clips)))
            win.done += len(self.clips[-1])
            if time.perf_counter() - start >= self.cell.seconds:
                break
        win.window_s = time.perf_counter() - start
        return win

    def free(self) -> None:
        del self.pipe

    def check(self) -> Dict[str, float]:
        cell = self.cell
        sample = inputs.check_sample(cell.seed, len(self.clips), cell.traffic["check_requests"])
        refs = self.family.reference_outputs(cell, [(i, 0) for i in sample])
        return checks.image_gaps([f for i in sample for f in self.clips[i]],
                                 [f for ref in refs for f in ref])


DRIVER = FramesDriver
