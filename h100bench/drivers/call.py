"""The ``call`` traffic: one image a request, a closed loop of ``pipe(...)``
calls; and, with ``"call": "map"``, one stream through ``pipe.map``
(``drivers/map.py``).  A request's inputs, the pipeline and the reference
are the cell's family's.

Set-up makes the weights on the device from the seed, builds the port's
models and loads them, compiles (``sfast_tpu_torch.compile``) and warms
up every shape of the cell: the first pass captures the graphs, a second
one replays them.  After the window the reference renders a sample of the
window's requests drawn from the seed.
"""

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hb import checks, inputs, program
from hb.drive import Cell, Tracer, Window, check_keys, phases, synchronize
from hb.family import seeded_weights


class ServeDriver:
    """The ``call`` and ``map`` traffic: requests of one image each, each
    with new inputs from the family (``request_inputs``, ``map_input``); a
    closed loop of ``pipe(...)`` calls, or one stream through ``pipe.map``."""

    # the traffic keys it reads; every request is one image (batch 1)
    KEYS = {"call", "scheduler", "steps", "guidance_scale", "height", "width", "kernels",
            "trace_requests", "check_requests"}
    MAP_KEYS = KEYS | {"window"}

    def __init__(self, cell: Cell):
        self.cell = cell
        self.tr = cell.traffic
        check_keys(self.tr, self.MAP_KEYS if self.tr["call"] == "map" else self.KEYS)
        self.family = cell.family
        self.images: List[np.ndarray] = []
        self.counts: Dict[str, int] = {}

    def request(self, i: int) -> dict:
        return self.family.request_inputs(self.cell.cfg, self.cell.seed, i)

    def map_input(self, i: int):
        return self.family.map_input(self.cell.cfg, self.cell.seed, i)

    def call_kwargs(self) -> dict:
        t = self.tr
        return dict(height=t["height"], width=t["width"], num_inference_steps=t["steps"],
                    guidance_scale=t["guidance_scale"])

    def request_seed(self, i: int) -> int:
        """The image seed of request ``i``: its own in a closed loop; one for
        the whole stream under ``map``, whose keyword arguments are shared."""
        if self.tr["call"] == "map":
            return inputs.image_seed(self.cell.seed, 0)
        return inputs.image_seed(self.cell.seed, i)

    def setup(self) -> Window:
        cell = self.cell
        dev = cell.device
        dtype = getattr(torch, cell.cfg["dtype"])
        marks = [("start", time.perf_counter())]
        fam = self.family
        meta = fam.reference_modules(cell.cfg)
        weights = seeded_weights(cell, meta, dev, dtype)
        synchronize(dev)
        marks.append(("weights", time.perf_counter()))
        mods = fam.port_modules(cell.cfg, weights, dev)
        del weights
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        marks.append(("modules", time.perf_counter()))
        self.pipe = fam.build_pipeline(cell.cfg, self.tr, mods, dev,
                                       str(cell.checkout / "build" / "sfast_tpu_torch"))
        if cell.trace:
            program.add_ranges(self.pipe, self.counts, fam.RANGED_SLOTS)
            self.tracer = Tracer(cell, self.counts)
            self.tracer.warm()
        # warm-up: the first pass captures every graph, the second replays them
        for k in range(2):
            if self.tr["call"] == "map":
                reqs = [self.map_input(-1 - j) for j in range(3)]
                for _ in self.pipe.map(reqs, window=self.tr["window"], seed=0,
                                       output_type="np", **self.call_kwargs()):
                    pass
            else:
                self.pipe(**self.request(-1 - k), seed=0, output_type="np", **self.call_kwargs())
            synchronize(dev)
            marks.append((f"warm-up {k}", time.perf_counter()))
        win = Window(setup_s=time.perf_counter() - cell.t0)
        win.phases = phases(cell.t0, marks)
        win.graphs = [(g.capture_seconds, g.instantiate_seconds, g.nodes)
                      for g in fam.pipeline_graphs(self.pipe)]
        return win

    def _serve_one(self, i: int, ended: list) -> None:
        from torch.profiler import record_function

        with record_function("request"):
            out = self.pipe(**self.request(i), seed=self.request_seed(i), output_type="np",
                            **self.call_kwargs())
        ended.append(time.perf_counter())
        self.images.append(out.images[0])

    def window(self, win: Window) -> Window:
        """Whole requests until the clock passes ``--seconds``; with
        ``--trace 1`` the traced stretches come first and the clock starts
        after them (such a run reports no end-to-end metric)."""
        cell = self.cell
        ended: List[float] = []
        start = time.perf_counter()
        if self.tr["call"] == "map":
            taken: List[float] = []

            def stream(first: int, stop_after: Optional[int]):
                i = first
                while (stop_after is None and time.perf_counter() - start < cell.seconds) or (
                        stop_after is not None and i < first + stop_after):
                    taken.append(time.perf_counter())
                    yield self.map_input(i)
                    i += 1

            def serve(stop_after: Optional[int]):
                for out in self.pipe.map(stream(len(self.images), stop_after),
                                         window=self.tr["window"], seed=self.request_seed(0),
                                         output_type="np", **self.call_kwargs()):
                    ended.append(time.perf_counter())
                    self.images.append(out.images[0])

            if cell.trace:
                k = self.tr["trace_requests"]
                self.tracer.stretch(lambda: serve(self.tr["window"]), lambda: serve(k), k, win)
                start = time.perf_counter()
            win.untraced_from = len(ended)
            serve(None)
            win.latencies_s = [e - t for t, e in zip(taken, ended)]
        else:
            if cell.trace:
                k = self.tr["trace_requests"]

                def run():
                    for _ in range(k):
                        self._serve_one(len(self.images), ended)

                self.tracer.stretch(lambda: self._serve_one(len(self.images), ended), run, k,
                                    win)
                start = time.perf_counter()
            win.untraced_from = len(ended)
            while True:
                self._serve_one(len(self.images), ended)
                if time.perf_counter() - start >= cell.seconds:
                    break
            win.latencies_s = [e - s for s, e in zip([start] + ended[:-1], ended)]
        win.window_s = ended[-1] - start
        win.done = len(ended)
        return win

    def free(self) -> None:
        del self.pipe
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The reference's images of a sample of the window's requests,
        against the program's: the worst sampled image's mean and largest
        gap, in uint8 levels."""
        cell = self.cell
        sample = inputs.check_sample(cell.seed, len(self.images), self.tr["check_requests"])
        refs = self.family.reference_outputs(cell, [(i, self.request_seed(i)) for i in sample])
        return checks.image_gaps([self.images[i] for i in sample], refs)


DRIVER = ServeDriver
