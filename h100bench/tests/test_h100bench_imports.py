"""What the benchmark imports, in a fresh interpreter: never JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference nothing of the program."""

import json
import subprocess
import sys

from conftest import BENCH, CHECKOUT

PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {checkout!r}]
before = {{n.split(".")[0] for n in sys.modules}}
for m in {mods!r}:
    __import__(m)
{extra}
after = {{n.split(".")[0] for n in sys.modules}}
print(json.dumps(sorted(after - before)))
"""


def imported(mods, extra=""):
    code = PROBE.format(bench=str(BENCH), checkout=str(CHECKOUT), mods=mods, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program():
    """The family's reference, its counts and the family module itself,
    found by name as a run finds it."""
    new = imported(["families.sd_unet_lib.reference", "families.sd_unet_lib.sampling",
                    "families.sd_unet_lib.training", "families.sd_unet_lib.counts",
                    "hb.weights", "hb.roofline", "hb.flops", "hb.family"],
                   "import hb.family\nhb.family.family({'family': 'sd_unet'})\n")
    assert not new & {"jax", "jaxlib", "flax", "sfast_tpu", "sfast_tpu_torch"}


def test_a_run_imports_no_jax():
    """The harness, the port's pipelines and train step, and a tiny run's
    path through them."""
    extra = (
        "import torch\n"
        "from hb import program\n"
        "import sfast_tpu_torch, sfast_tpu_torch.pipelines, sfast_tpu_torch.training\n"
        "import sfast_tpu_torch.schedulers\n"
        "from hb import drive, report, checks, trace, family\n"
        "for call in ('call', 'map', 'train'):\n"
        "    family.driver(call, family.family({'family': 'sd_unet'}))\n")
    new = imported(["run"], extra)
    assert "sfast_tpu_torch" in new
    assert not new & {"jax", "jaxlib", "flax", "sfast_tpu"}


def test_the_run_refuses_a_machine_without_a_card():
    """No card: no result line and exit code 2."""
    cells = [w["name"] for w in json.loads((CHECKOUT / "BENCHMARK.json").read_text())[
        "workloads"]]
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cells[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=CHECKOUT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and not out.stdout.strip()


def test_only_a_family_imports_its_reference():
    """No file of the harness (``hb/``, ``run.py``, ``drivers/``) imports a
    family's reference modules, by any spelling of their names: the harness
    reaches them through the family module."""
    import ast

    harness = [BENCH / "run.py", *sorted((BENCH / "hb").glob("*.py")),
               *sorted((BENCH / "drivers").glob("*.py"))]
    for path in harness:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                names = [base] + [f"{base}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                parts = name.split(".")
                assert not (parts[0] in ("hb", "families") and set(parts[1:]) & {
                    "reference", "ref_sampling", "ref_training", "sampling", "training",
                    "sd_unet_lib"}), f"{path.name} imports {name}"
