"""One run of one cell: set-up, the measured window, the traced stretch,
and the comparison with the reference that decides ``correct``.

Set-up makes the weights on the device from the seed, builds the port's
models and loads them, compiles (``sfast_tpu_torch.compile`` for serving,
the graphed train step for training) and warms up every shape of the
cell: the first call captures the graphs, a second one replays them.  The
window then runs whole requests or steps until the clock passes
``--seconds`` and ends at the last one's completion.  With ``--trace 1`` the
first requests or steps of the window run under ``torch.profiler``.

After the window the peak memory is read and the program's state is
freed; the reference then runs over a sample of the window's requests
drawn from the seed (serving), or over the first three steps and over one
step after the window from the state the window left (training).
"""

import dataclasses
import gc
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from hb import inputs, program
from hb.trace import OWN_SYNC, WINDOW, Trace, from_profile
from hb.weights import make_weights

SLOTS = ("unet", "vae", "text_encoder", "text_encoder_2")
TRIES = 3  # traces of a stretch before its lost rows are left standing


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    checkout: Path
    t0: float  # perf_counter at process start


@dataclasses.dataclass
class Window:
    """What the measured window and the traced stretch left."""
    setup_s: float
    window_s: float = 0.0
    done: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None
    traced: int = 0  # requests or steps in the traced stretch
    untraced_from: int = 0  # the first request after the traced stretches
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    graphs: list = dataclasses.field(default_factory=list)  # (capture s, instantiate s, nodes)
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up's seconds


def phases(t0: float, marks: list) -> Dict[str, float]:
    """Seconds of each phase of set-up: from the process's start to the
    first mark (imports, the card's start), then between marks."""
    out, prev = {}, t0
    for name, t in marks:
        out["imports" if name == "start" else name] = t - prev
        prev = t
    return out


def weights_for(cell: Cell, mods_meta: dict, device, dtype) -> Dict[str, dict]:
    return {slot: make_weights(m, inputs.sub_seed(cell.seed, inputs.WEIGHTS, SLOTS.index(slot)),
                               device, dtype)
            for slot, m in mods_meta.items()}


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_keys(traffic: dict, read: set) -> None:
    """Refuse a traffic mix with a key that its driver does not read: such
    a key would be written down and have no effect."""
    unread = sorted(set(traffic) - read - {"why"})
    if unread:
        raise ValueError(f"traffic keys {unread} are not read by the {traffic['call']!r} "
                         f"driver, which reads {sorted(read)}")


class Tracer:
    """The profiler around a stretch of requests or steps, and the program's
    counts over it."""

    def __init__(self, cell: Cell, counts: dict):
        self.cell, self.counts = cell, counts

    def warm(self) -> None:
        """One short session in set-up, so that the traced stretch does not
        pay the profiler's own start."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=self.cell.device).add_(1)
            synchronize(self.cell.device)

    def stretch(self, pre, run, n: int, w: Window) -> None:
        """Trace ``run()``, ``n`` requests or steps, inside one profiler
        session that ``pre()`` (one request or step) opens untimed, so that
        the profiler's first launches fall outside the window.  Where the
        trace lost rows of a kernel the program counted, the stretch is
        traced again, up to :data:`TRIES` times; everything read from a
        stretch is read anew from the last one."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from sfast_tpu_torch.runtime import cuda_build

        for _ in range(TRIES):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            pre()
            synchronize(self.cell.device)
            cuda_build.reset_launch_counts()
            for k in self.counts:
                self.counts[k] = 0
            with record_function(WINDOW):
                run()
                with record_function(OWN_SYNC):
                    synchronize(self.cell.device)
            prof.stop()
            w.launches = dict(cuda_build.launch_counts)
            w.calls = dict(self.counts)
            w.traced = n
            w.trace = from_profile(prof, list(self.counts) + ["request", "train_step"])
            del prof
            if not lost_rows(w):
                return


def lost_rows(w: Window) -> dict:
    """{kernel: (launches counted, rows traced)} of the port's kernels
    whose rows in the trace's window do not match the launches."""
    from hb.roofline import KERNEL_ROWS

    lo, hi = w.trace.window_ns
    out = {}
    for kernel, pieces in KERNEL_ROWS.items():
        n = w.launches.get(kernel, 0)
        for piece in pieces:
            rows = sum(1 for o in w.trace.ops if piece in o.name and lo <= o.start_ns < hi)
            if rows != n:
                out[kernel] = (n, rows)
    return out


class ServeDriver:
    """The ``call`` and ``map`` traffic: text2img requests, each with new
    prompt ids; a closed loop of ``pipe(...)`` calls, or one stream through
    ``pipe.map``."""

    # the traffic keys it reads; every request is one image (batch 1)
    KEYS = {"call", "scheduler", "steps", "guidance_scale", "height", "width", "kernels",
            "trace_requests", "check_requests"}
    MAP_KEYS = KEYS | {"window"}

    def __init__(self, cell: Cell):
        self.cell = cell
        self.tr = cell.traffic
        check_keys(self.tr, self.MAP_KEYS if self.tr["call"] == "map" else self.KEYS)
        self.sdxl = "text_encoder_2" in cell.cfg
        self.images: List[np.ndarray] = []
        self.counts: Dict[str, int] = {}

    def request(self, i: int) -> dict:
        ids = inputs.prompt_ids(self.cell.seed, i)
        kw = {"prompt_ids": torch.from_numpy(ids)}
        if self.sdxl:
            from hb.ref_sampling import ids_for_encoder_2
            kw["prompt_ids_2"] = torch.from_numpy(ids_for_encoder_2(ids))
        return kw

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
        meta = program.reference_modules(cell.cfg)
        weights = weights_for(cell, meta, dev, dtype)
        synchronize(dev)
        marks.append(("weights", time.perf_counter()))
        mods = program.port_modules(cell.cfg, weights, dev)
        del weights
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        marks.append(("modules", time.perf_counter()))
        self.pipe = program.build_pipeline(cell.cfg, self.tr, mods, dev,
                                           str(cell.checkout / "build" / "sfast_tpu_torch"))
        if cell.trace:
            program.add_ranges(self.pipe, self.counts)
            self.tracer = Tracer(cell, self.counts)
            self.tracer.warm()
        # warm-up: the first pass captures every graph, the second replays them
        for k in range(2):
            if self.tr["call"] == "map":
                reqs = [self.request(-1 - j)["prompt_ids"] for j in range(3)]
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
                      for g in program.pipeline_graphs(self.pipe)]
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
                    yield self.request(i)["prompt_ids"]
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
        from hb import checks

        cell = self.cell
        sample = inputs.check_sample(cell.seed, len(self.images), self.tr["check_requests"])
        reqs = [(inputs.prompt_ids(cell.seed, i), self.request_seed(i)) for i in sample]
        refs = checks.reference_images(cell, reqs)
        return checks.image_gaps([self.images[i] for i in sample], refs)


class TrainDriver:
    """The ``train`` traffic: the port's graphed LoRA train step, driven
    from one state through its first three steps in set-up, then through
    the window, then through one more step whose starting state is kept."""

    KEYS = {"call", "batch", "latent_hw", "rank", "learning_rate", "kernels", "pool_steps",
            "trace_steps"}

    def __init__(self, cell: Cell):
        self.cell = cell
        self.tr = cell.traffic
        check_keys(self.tr, self.KEYS)
        self.counts = {"train_step": 0}

    def batch(self, k: int) -> dict:
        p = self.pool
        j = k % p["latents"].shape[0]
        return {"latents": p["latents"][j], "context": p["context"][j], "t": p["t"][j],
                "noise": p["noise"][j]}

    def _step(self, k: int):
        from torch.profiler import record_function

        b = self.batch(k)
        self.counts["train_step"] += 1
        with record_function("train_step"):
            return self.step(self.lora, {"latents": b["latents"], "context": b["context"]},
                             t=b["t"], noise=b["noise"])

    def setup(self) -> Window:
        cell, tr = self.cell, self.tr
        dev = cell.device
        dtype = getattr(torch, cell.cfg["dtype"])
        marks = [("start", time.perf_counter())]
        meta = program.reference_modules(cell.cfg)
        weights = weights_for(cell, {"unet": meta["unet"]}, dev, dtype)
        synchronize(dev)
        marks.append(("weights", time.perf_counter()))
        unet = program.port_modules(cell.cfg, weights, dev, slots=["unet"])["unet"]
        del weights
        marks.append(("modules", time.perf_counter()))
        state = unet.state_dict()
        targets = program.lora_targets(state)
        lora_init = program.initial_lora({m: state[m + ".weight"].shape for m in targets},
                                         tr["rank"], inputs.sub_seed(cell.seed, inputs.LORA_INIT),
                                         dev)
        self.pool = inputs.train_pool(cell.seed, tr["pool_steps"], tr["batch"], tr["latent_hw"],
                                      cell.cfg["vae"]["latent_channels"], inputs.SEQ,
                                      cell.cfg["unet"]["cross_attention_dim"], dev, dtype)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        self.step, self.lora, self.opt = program.build_train_step(
            unet, tr, lora_init, str(cell.checkout / "build" / "sfast_tpu_torch"))
        if cell.trace:
            self.tracer = Tracer(cell, self.counts)
            self.tracer.warm()
        # the first three steps, which the reference follows: the first
        # call captures the step's graph
        self.initial = {n: t.detach().clone() for n, t in program.factor_list(lora_init)}
        losses = [self._step(0)]
        self.first_grads = program.first_gradients(self.lora, self.opt)
        synchronize(dev)
        marks.append(("step 1 (capture)", time.perf_counter()))
        losses += [self._step(1), self._step(2)]
        synchronize(dev)
        marks.append(("steps 2, 3", time.perf_counter()))
        self.losses = [float(x) for x in losses]
        self.after3 = {n: t.detach().clone() for n, t in program.factor_list(self.lora)}
        self.next = 3
        win = Window(setup_s=time.perf_counter() - cell.t0)
        win.phases = phases(cell.t0, marks)
        win.graphs = [(g.capture_seconds, g.instantiate_seconds, g.nodes)
                      for g in self.step.graphs()]
        return win

    def window(self, win: Window) -> Window:
        cell, dev = self.cell, self.cell.device
        if cell.trace:
            k = self.tr["trace_steps"]

            def run():
                for _ in range(k):
                    self._step(self.next)
                    self.next += 1

            def one():
                self._step(self.next)
                self.next += 1

            self.tracer.stretch(one, run, k, win)
        start = time.perf_counter()
        n0 = self.next
        prev = None
        while time.perf_counter() - start < cell.seconds:
            self._step(self.next)
            self.next += 1
            done = torch.cuda.Event() if dev.type == "cuda" else None
            if done is not None:
                done.record()
                if prev is not None:  # at most one step in flight behind the host
                    prev.synchronize()
                prev = done
        synchronize(dev)
        win.window_s = time.perf_counter() - start
        win.done = self.next - n0
        self.late = self._late_step()
        return win

    def _late_step(self) -> dict:
        """One more step through the same call, after the window, from the
        state the window left: that state (the factors and AdamW's), the
        batch's index, and the factors after it."""
        k = self.next
        before = {n: t.detach().clone() for n, t in program.factor_list(self.lora)}
        state = program.adam_state(self.lora, self.opt)
        self._step(k)
        self.next += 1
        after = {n: t.detach().clone() for n, t in program.factor_list(self.lora)}
        return {"k": k, "before": before, "state": state, "after": after}

    def free(self) -> None:
        del self.step, self.lora, self.opt
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The reference's first three steps from the same LoRA on the same
        batches, and its step from the state the window left on the late
        step's batch, against the program's."""
        from hb import checks

        model = checks.reference_unet(self.cell)
        ref = checks.reference_training(self.cell, self.initial,
                                        [self.batch(k) for k in range(3)], model=model)
        late = self.late
        ref_late = checks.reference_training(self.cell, late["before"], [self.batch(late["k"])],
                                             state=late["state"], model=model)
        return {**checks.train_gaps(self.initial, self.losses, self.first_grads, self.after3, ref),
                **checks.late_gaps(late["before"], late["after"], ref_late)}


DRIVERS = {"call": ServeDriver, "map": ServeDriver, "train": TrainDriver}
