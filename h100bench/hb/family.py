"""What the harness finds by name: a configuration's model family and a
traffic mix's driver, each a file imported by its path.

A configuration names its family (``"family"`` in its file):
``families/<family>.py`` holds everything that knows the model's structure
(see README.md, "Adding a model family").  A traffic mix names its driver
(``"call"``): a ``DRIVERS`` entry of the family where it has one, else
``drivers/<call>.py``, whose ``DRIVER`` is the class.  Neither is imported
by name, so a later configuration or traffic mix brings its own as new
files and no file here changes.
"""

import functools
import importlib.util
from pathlib import Path
from typing import Dict

import torch

from hb import inputs
from hb.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def by_path(path: Path):
    """The Python file at ``path``, imported by its path (its name may hold
    dots), once a process."""
    spec = importlib.util.spec_from_file_location(f"h100bench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict):
    """The family module of the configuration ``cfg``."""
    return by_path(BENCH / "families" / f"{cfg['family']}.py")


def driver(call: str, fam):
    """The driver class of the traffic ``call``: the family's own, else
    ``drivers/<call>.py``'s."""
    own = getattr(fam, "DRIVERS", {})
    if call in own:
        return own[call]
    return by_path(BENCH / "drivers" / f"{call}.py").DRIVER


def driver_for(cell):
    return driver(cell.traffic["call"], cell.family)


def seeded_weights(cell, metas: Dict[str, torch.nn.Module], device,
                   dtype: torch.dtype) -> Dict[str, dict]:
    """The state dict of each slot's module in ``metas``, drawn on ``device``
    from the slot's own stream of the seed (its index in the family's
    ``SLOTS``), with the family's extra init rules (``INIT_RULES``)."""
    fam = cell.family
    rules = getattr(fam, "INIT_RULES", None)
    return {slot: make_weights(m, inputs.sub_seed(cell.seed, inputs.WEIGHTS,
                                                  fam.SLOTS.index(slot)), device, dtype,
                               rules=rules)
            for slot, m in metas.items()}
