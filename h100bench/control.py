"""The readings that a cell's limits are set from, beside the program's:
the control, and the faults a comparison has to catch.

    python3 h100bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 10]
        [--program-only]

For each seed it draws the inputs the cell's run would draw and puts the
reference of the cell's family (``families/<family>.py``) in the program's
place:

- serving: the reference with its products in fp8 (e4m3, one scale a
  tensor), its images rounded to uint8 as the program serves them, against
  the float32 reference's, on the requests a run's check samples first;
- training: the program runs as a run does, with a window of ``--seconds``,
  and its own readings are taken; then the fp8 reference, and the float32
  reference over half of each batch (the mean taken over the rest), take
  the program's place in the first three steps and in the step after the
  window (from the state the program's window left), each against the
  float32 reference.  ``--program-only`` takes the program's readings
  alone, a dozen seeds in one process.

It prints one JSON line per seed.  The benchmark's own runs never run
this; it needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=10.0, help="the training window")
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from run import CHECKOUT, cell_entries, environment, load_json
    from hb.drive import Cell

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell_e, config_e, _, _ = cell_entries(bench, args.workload)
    cfg = load_json(CHECKOUT / config_e["file"])
    traffic = load_json(HERE / "traffic" / f"{cell_e['traffic']}.json")
    environment(CHECKOUT)
    sys.path.insert(0, str(CHECKOUT))  # the program, which training's readings run
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = Cell(args.workload, cfg, traffic, seed, args.seconds, False, dev, CHECKOUT, t)
        out = {"workload": args.workload, "seed": seed}
        if traffic["call"] == "train":
            out.update(train_readings(cell, args.program_only))
        else:
            out.update(serve_readings(cell))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


def serve_readings(cell) -> dict:
    import torch

    from hb import checks
    from hb.family import driver_for

    d = driver_for(cell)(cell)
    reqs = [(i, d.request_seed(i)) for i in range(cell.traffic["check_requests"])]
    ref = cell.family.reference_outputs(cell, reqs, "float32")
    low = cell.family.reference_outputs(cell, reqs, "fp8")
    served = [torch.round(x).to(torch.uint8).cpu().numpy() for x in low]
    return {"control_fp8": checks.image_gaps(served, ref)}


def train_readings(cell, program_only: bool) -> dict:
    import gc

    import torch

    from hb import checks
    from hb.family import driver_for

    fam = cell.family
    d = driver_for(cell)(cell)
    win = d.window(d.setup())
    d.free()
    out = {"steps": win.done, "program": d.check()}
    if not program_only:
        batches = [d.batch(k) for k in range(3)]
        late = d.late
        late_batch = [d.batch(late["k"])]
        f32 = fam.reference_trainer(cell)
        ref = fam.reference_training(cell, d.initial, batches, model=f32)
        ref_late = fam.reference_training(cell, late["before"], late_batch,
                                          state=late["state"], model=f32)
        for name, model, keep in (("control_fp8", fam.reference_trainer(cell, "fp8"), 0),
                                  ("fault_half_batch", f32, cell.traffic["batch"] // 2)):
            got = fam.reference_training(cell, d.initial, batches, keep_rows=keep,
                                         model=model)
            got_late = fam.reference_training(cell, late["before"], late_batch,
                                              keep_rows=keep, state=late["state"],
                                              model=model)
            out[name] = {**checks.train_gaps(d.initial, got["losses"], got["grads"][0],
                                             got["factors"], ref),
                         **checks.late_gaps(late["before"], got_late["factors"], ref_late)}
    del d
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
