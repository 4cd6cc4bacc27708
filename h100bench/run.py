"""Run one cell of the benchmark of ``sfast_tpu_torch`` once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, limits and metrics are
files under ``h100bench/`` found by name.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared, with its limit.  Standard error ends with
the same numbers.  Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# modules whose presence after the window means the run imported JAX or the
# JAX package, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "sfast_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_entries(bench: dict, workload: str):
    """(the cell's entry, its configuration entry, the end-to-end and
    per-layer metric entries it reports)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(m):
        return workload in m.get("workloads", [workload])

    return (cell, config, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def environment(checkout: Path) -> None:
    """The program's build and kernel caches at fixed paths in the
    checkout, and no JAX behind a library's back."""
    cache = checkout / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for k in ("USE_FLAX", "USE_JAX"):
        os.environ[k] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell_e, config_e, e2e, per_layer = cell_entries(bench, args.workload)
    cfg = load_json(CHECKOUT / config_e["file"])
    traffic = load_json(HERE / "traffic" / f"{cell_e['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{args.workload}.json")
    environment(CHECKOUT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_e["chips"]:
        print(f"h100bench: the cell needs {cell_e['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CHECKOUT))  # the program under test
    from hb.drive import DRIVERS, Cell
    from hb.report import result_line

    cell = Cell(args.workload, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                torch.device("cuda", 0), CHECKOUT, T0)
    torch.cuda.set_device(cell.device)
    return result_line(cell, DRIVERS[traffic["call"]](cell), limits, e2e, per_layer, HERE,
                       forbidden_modules)


if __name__ == "__main__":
    sys.exit(main())
