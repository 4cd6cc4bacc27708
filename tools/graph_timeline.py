#!/usr/bin/env python3
"""Where a graphed image's wall time goes, on one CUDA card.

    python3 tools/graph_timeline.py [IMAGES_PER_GROUP]

Builds SD1.5 at full width as ``chip_smoke.py`` does (seeded random
weights, 512², 50 DPM++ steps, CFG 7.5, the default configuration after
``sfast_tpu_torch.compile``, so the UNet, the DPM++ step, CLIP and the VAE
decode replay CUDA graphs) and times images in four groups: as they come
after the first image; after ``torch.cuda.empty_cache()``; with Python's
garbage collector off; and after ``set_compilation_config`` dropped every
graph and a first image captured them again.  A CUDA event is recorded
after each DPM++ step is enqueued, so the time between two consecutive
events is the device's time for one step, idle included.  Per image it
prints the wall ms, the device ms from the call's start to the first
step's event (CLIP and step 0), the other steps' median, largest and
summed device ms, the device ms after the last step (VAE decode, uint8,
the copy to the host), and the host's median ms between two steps.  The
last line is one JSON object with every image's numbers.
"""

import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

IMAGES = 8


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("graph_timeline: torch.cuda.is_available() is false")
    import chip_smoke
    from sfast_tpu_torch import CompilationConfig

    images = int(sys.argv[1]) if len(sys.argv) > 1 else IMAGES
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pipe = chip_smoke.build_pipeline(torch, dev)
    prompt_ids = torch.randint(0, 49408, (1, 77), generator=torch.Generator().manual_seed(1))

    marks = []  # (host time, CUDA event) after each step is enqueued
    step = pipe.scheduler.step

    def marked_step(*args, **kwargs):
        out = step(*args, **kwargs)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((time.perf_counter(), event))
        return out

    pipe.scheduler.step = marked_step

    def image():
        marks.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        pipe(prompt_ids=prompt_ids, height=512, width=512, num_inference_steps=chip_smoke.STEPS,
             guidance_scale=7.5, seed=0)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = [start] + [e for _, e in marks] + [end]
        device = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        steps = device[1:-1]  # steps 1..N-1
        host = [(b - a) * 1e3 for (a, _), (b, _) in zip(marks, marks[1:])]
        return {"wall_ms": wall, "head_ms": device[0],
                "step_ms_median": statistics.median(steps), "step_ms_max": max(steps),
                "steps_ms": sum(steps), "tail_ms": device[-1],
                "host_step_ms_median": statistics.median(host)}

    def group(name, before=None):
        if before is not None:
            before()
        first = image()  # captures the graphs after a config change
        rows = [image() for _ in range(images)]
        for r in rows:
            chip_smoke.log(f"[{name}] wall {r['wall_ms']:.3f} ms: head {r['head_ms']:.3f}, steps "
                           f"{r['steps_ms']:.3f} (median {r['step_ms_median']:.3f}, largest "
                           f"{r['step_ms_max']:.3f}), tail {r['tail_ms']:.3f}; host "
                           f"{r['host_step_ms_median']:.3f} ms a step")
        return {"first_wall_ms": first["wall_ms"], "images": rows}

    out = {"as they come": group("as they come"),
           "after empty_cache": group("after empty_cache", torch.cuda.empty_cache)}
    gc.disable()
    try:
        out["gc off"] = group("gc off")
    finally:
        gc.enable()
    out["recaptured"] = group(
        "recaptured", lambda: pipe.set_compilation_config(CompilationConfig.Default()))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
