"""A toy model family, for the harness's CPU tests: one tiny plain torch
module is both the program and the reference.  It turns an image into a
clip: the image repeated over the frames, a ``Conv3d`` over them, plus a
bare parameter of per-frame shifts, squashed into uint8 levels.  Its slot
is ``denoiser``, its requests are images, its driver is ``frames``."""

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from hb import inputs
from hb.family import seeded_weights
from hb.flops import count

SLOTS = ("denoiser",)
RANGED_SLOTS = {"denoiser": ("denoiser", ())}


class ToyClip(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c, k = cfg["channels"], cfg["kernel"]
        self.frames = cfg["frames"]
        self.conv = nn.Conv3d(c, c, kernel_size=k, padding=k // 2)
        self.frame_shift = nn.Parameter(torch.zeros(self.frames, 1, 1))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, C) levels in [0, 255] → (frames, H, W, C) unrounded levels."""
        x = (image.float() / 127.5 - 1).permute(2, 0, 1)[None, :, None]
        x = x.expand(-1, -1, self.frames, -1, -1)
        y = torch.tanh(self.conv(x) + self.frame_shift[None, None])
        return ((y[0] + 1) * 127.5).permute(1, 2, 3, 0)


def INIT_RULES(m: nn.Module, name: str, p: nn.Parameter):
    """A Conv3d's weight by its fan-in; the frame shifts as an embedding."""
    if isinstance(m, nn.Conv3d) and name == "weight":
        return p[0].numel()
    if isinstance(m, ToyClip) and name == "frame_shift":
        return "embedding"
    return None


class ToyPipeline:
    """The system under test: the module, its frames rounded to uint8."""

    def __init__(self, denoiser: ToyClip):
        self.denoiser = denoiser

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> List[np.ndarray]:
        levels = self.denoiser(torch.as_tensor(image))
        return list(torch.round(levels).clamp(0, 255).to(torch.uint8).numpy())


def reference_modules(cfg: dict) -> Dict[str, nn.Module]:
    with torch.device("meta"):
        return {"denoiser": ToyClip(cfg["denoiser"])}


def port_modules(cfg: dict, weights: Dict[str, dict], device, slots=None) -> dict:
    mods = {}
    for slot in slots or weights:
        m = ToyClip(cfg[slot]).to(device=device, dtype=getattr(torch, cfg["dtype"]))
        m.load_state_dict(weights[slot], strict=True)
        mods[slot] = m.eval().requires_grad_(False)
    return mods


def build_pipeline(cfg: dict, traffic: dict, mods: dict, device, cache_dir: str):
    return ToyPipeline(mods["denoiser"])


def pipeline_graphs(pipe) -> list:
    return []


def request_inputs(cfg: dict, seed: int, i: int) -> dict:
    """Request ``i``'s image: (size, size, 3) uint8 levels."""
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.REQUESTS, i))
    n = cfg["image_size"]
    return {"image": rng.integers(0, 256, (n, n, 3), dtype=np.uint8)}


def reference_outputs(cell, requests: List[Tuple[int, int]],
                      precision: str = "float32") -> List[torch.Tensor]:
    """Each request's frames (frames, H, W, 3) as unrounded levels, from the
    module made again from the seed in float32."""
    meta = reference_modules(cell.cfg)
    w = seeded_weights(cell, meta, cell.device, getattr(torch, cell.cfg["dtype"]))["denoiser"]
    m = meta["denoiser"]
    m.load_state_dict({k: v.float() for k, v in w.items()}, strict=True, assign=True)
    with torch.no_grad():
        return [m(torch.as_tensor(request_inputs(cell.cfg, cell.seed, i)["image"],
                                  device=cell.device)) for i, _ in requests]


def request_flops(cfg: dict, traffic: dict) -> dict:
    m = reference_modules(cfg)["denoiser"]
    image = torch.zeros((cfg["image_size"], cfg["image_size"], 3), device="meta")
    n = count(lambda: m(image))
    return {"request": n}


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    return {}
