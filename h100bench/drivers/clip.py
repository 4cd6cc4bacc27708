"""The ``clip`` traffic: image-to-video, the ``call`` driver's closed loop
(``drivers/call.py``), each request one new still image from the family
(``request_inputs``) made into a clip of ``frames`` uint8 frames with its
own latent seed.  Every frame delivered to the host counts as one image of
the window; the check takes the worst frame of the sampled clips.

Set-up warms up with one whole clip at the cell's sizes and step count,
which captures every graph the timed clips replay (the scheduler step's
graph serves every step).  No replaying clip comes before the window: a
clip's first replay takes as long as a later one.
"""

import time
from typing import Dict

import torch

from hb import checks, inputs, program
from hb.drive import Cell, Tracer, Window, phases, synchronize
from hb.family import BENCH, by_path, seeded_weights

ServeDriver = by_path(BENCH / "drivers" / "call.py").DRIVER


class ClipDriver(ServeDriver):
    # the traffic keys it reads; every request is one still and one clip
    KEYS = {"call", "frames", "height", "width", "steps", "min_guidance_scale",
            "max_guidance_scale", "fps", "motion_bucket_id", "noise_aug_strength",
            "decode_chunk_size", "kernels", "trace_requests", "check_requests"}

    def __init__(self, cell: Cell):
        super().__init__(cell)
        # the port's scheduler of the configuration, before any weight is
        # drawn: a program that cannot build it stops here
        self.family.scheduler(cell.cfg)

    def call_kwargs(self) -> dict:
        t = self.tr
        return dict(num_frames=t["frames"], height=t["height"], width=t["width"],
                    num_inference_steps=t["steps"], min_guidance_scale=t["min_guidance_scale"],
                    max_guidance_scale=t["max_guidance_scale"], fps=t["fps"],
                    motion_bucket_id=t["motion_bucket_id"],
                    noise_aug_strength=t["noise_aug_strength"],
                    decode_chunk_size=t["decode_chunk_size"])

    def setup(self) -> Window:
        cell, fam, dev = self.cell, self.family, self.cell.device
        marks = [("start", time.perf_counter())]
        weights = seeded_weights(cell, fam.reference_modules(cell.cfg), dev,
                                 getattr(torch, cell.cfg["dtype"]))
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
        self.pipe(**self.request(-1), seed=0, output_type="np", **self.call_kwargs())
        synchronize(dev)
        marks.append(("warm-up 0", time.perf_counter()))
        win = Window(setup_s=time.perf_counter() - cell.t0)
        win.phases = phases(cell.t0, marks)
        win.graphs = [(g.capture_seconds, g.instantiate_seconds, g.nodes)
                      for g in fam.pipeline_graphs(self.pipe)]
        return win

    def window(self, win: Window) -> Window:
        win = super().window(win)
        win.done *= self.tr["frames"]
        return win

    def check(self) -> Dict[str, float]:
        """The reference's frames of a sample of the window's clips against
        the program's: the worst sampled frame's mean gap and the largest gap
        of any pixel, in uint8 levels."""
        cell = self.cell
        sample = inputs.check_sample(cell.seed, len(self.images), self.tr["check_requests"])
        refs = self.family.reference_outputs(cell, [(i, self.request_seed(i)) for i in sample])
        return checks.image_gaps([f for i in sample for f in self.images[i]], refs)


DRIVER = ClipDriver
