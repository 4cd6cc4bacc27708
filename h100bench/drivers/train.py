"""The ``train`` traffic: a family's graphed LoRA train step (its
``build_train_step``, ``train_call`` and ``train_pool``), driven from one
state through its first three steps in set-up, then through the window,
then through one more step whose starting state is kept.  The family's
reference follows the first three steps and the step after the window
from the state the window left.
"""

import gc
import time
from typing import Dict

import torch

from hb import checks, inputs, program
from hb.drive import Cell, Tracer, Window, check_keys, phases, synchronize
from hb.family import seeded_weights


class TrainDriver:
    """The ``train`` traffic: the family's graphed LoRA train step, driven
    from one state through its first three steps in set-up, then through
    the window, then through one more step whose starting state is kept."""

    KEYS = {"call", "batch", "latent_hw", "rank", "learning_rate", "kernels", "pool_steps",
            "trace_steps"}

    def __init__(self, cell: Cell):
        self.cell = cell
        self.tr = cell.traffic
        check_keys(self.tr, self.KEYS)
        self.family = cell.family
        self.counts = {"train_step": 0}

    def batch(self, k: int) -> dict:
        j = k % self.tr["pool_steps"]
        return {name: x[j] for name, x in self.pool.items()}

    def _step(self, k: int):
        from torch.profiler import record_function

        b = self.batch(k)
        self.counts["train_step"] += 1
        with record_function("train_step"):
            return self.family.train_call(self.step, self.lora, b)

    def setup(self) -> Window:
        cell, tr = self.cell, self.tr
        dev = cell.device
        dtype = getattr(torch, cell.cfg["dtype"])
        marks = [("start", time.perf_counter())]
        fam = self.family
        meta = fam.reference_modules(cell.cfg)
        weights = seeded_weights(cell, {s: meta[s] for s in fam.TRAIN_SLOTS}, dev, dtype)
        synchronize(dev)
        marks.append(("weights", time.perf_counter()))
        mods = fam.port_modules(cell.cfg, weights, dev, slots=fam.TRAIN_SLOTS)
        del weights
        marks.append(("modules", time.perf_counter()))
        lora_init = program.initial_lora(fam.lora_shapes(mods), tr["rank"],
                                         inputs.sub_seed(cell.seed, inputs.LORA_INIT), dev)
        self.pool = fam.train_pool(cell)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        self.step, self.lora, self.opt = fam.build_train_step(
            mods, tr, lora_init, str(cell.checkout / "build" / "sfast_tpu_torch"))
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
        fam = self.family
        model = fam.reference_trainer(self.cell)
        ref = fam.reference_training(self.cell, self.initial,
                                     [self.batch(k) for k in range(3)], model=model)
        late = self.late
        ref_late = fam.reference_training(self.cell, late["before"], [self.batch(late["k"])],
                                          state=late["state"], model=model)
        return {**checks.train_gaps(self.initial, self.losses, self.first_grads, self.after3, ref),
                **checks.late_gaps(late["before"], late["after"], ref_late)}


DRIVER = TrainDriver
