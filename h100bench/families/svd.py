"""The ``svd`` family: Stable Video Diffusion (SVD-XT), a spatio-temporal UNet
denoiser, a temporal VAE (the KL encoder of the conditioning image, the
temporal decoder of the clip) and a CLIP ViT-H vision encoder, served
through the port's StableVideoDiffusion pipeline from one still image a
request to a clip of frames (``drivers/clip.py``).

What the harness asks of a family, by name (README.md, "Adding a model
family"): the reference modules on ``meta`` by slot with the init rules
of the ``Conv3d`` weights, the mix factors and CLIP's class embedding,
the port's modules and its compiled pipeline, the slots to range and the
graphs to count, the inputs of request ``i``, the reference's frames of
sampled requests, the model FLOPs of a clip and the calls of the port's
kernels.  The parts are in ``families/svd_lib/``.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from families.svd_lib import counts, port, reference, sampling
from hb import inputs
from hb.family import seeded_weights

# the slots, in the order of their weights' streams under the seed
SLOTS = ("unet", "vae", "image_encoder")
# the pipeline's slots the benchmark times by range: (range name, the
# methods the pipeline calls besides __call__); the decode runs the VAE's
# module inside the pipeline's own graph, past any range on the slot
RANGED_SLOTS = {"image_encoder": ("image_encoder", ()), "vae_encode": ("vae_encode", ("encode",)),
                "unet": ("unet", ()), "scheduler": ("scheduler_step", ("step",))}
IMAGE_GRID = (9, 16)  # the conditioning image's grid of random colours
IMAGE_NOISE = 12.0  # and the std of its uniform per-pixel noise, in levels

build_pipeline = port.build_pipeline
pipeline_graphs = port.pipeline_graphs
scheduler = port.scheduler


def reference_modules(cfg: dict) -> Dict[str, nn.Module]:
    """The configuration's reference modules on the ``meta`` device, by the
    pipeline slot they stand for."""
    with torch.device("meta"):
        return reference.modules(cfg)


def INIT_RULES(m: nn.Module, name: str, p: nn.Parameter):
    """The parameters the base rules do not know: a ``Conv3d``'s weight by
    its fan-in; each ``mix_factor`` drawn as zeros, then set to the
    configuration's merge factor (:func:`with_mix_factors`); CLIP's class
    embedding as an embedding."""
    if isinstance(m, nn.Conv3d) and name == "weight":
        return p[0].numel()
    if name == "mix_factor":
        return "zeros"
    if name == "class_embedding":
        return "embedding"
    return None


def with_mix_factors(cfg: dict, slot: str, state: dict) -> dict:
    """``state`` with every ``mix_factor`` at the configuration's value for
    the slot (``assumed.mix_factor``: the UNet's 0.5, the decoder's 0.0)."""
    value = cfg["assumed"]["mix_factor"].get(slot)
    if value is None:
        return state
    return {k: torch.full_like(v, value) if k.endswith("mix_factor") else v
            for k, v in state.items()}


def port_modules(cfg: dict, weights: Dict[str, dict], device, slots=None) -> dict:
    """The port's models loaded strictly from ``weights`` with the
    configuration's mix factors."""
    return port.port_modules(cfg, {s: with_mix_factors(cfg, s, w) for s, w in weights.items()},
                             device, slots)


def request_inputs(cfg: dict, seed: int, i: int) -> dict:
    """The pipeline's keyword arguments of request ``i``: its conditioning
    image, (H, W, 3) uint8 at the configuration's still size, from the
    seed's ``REQUESTS`` stream: a grid of random colours, bilinear, plus
    uniform noise, clipped; made in float32 in some ms, since the window
    times it."""
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.REQUESTS, i))
    size = cfg["assumed"]["image_size"]
    gh, gw = IMAGE_GRID
    grid = rng.uniform(0.0, 255.0, (gh + 1, gw + 1, 3)).astype(np.float32)
    rows = (_lerp(size["height"], gh) @ grid.reshape(gh + 1, -1)).reshape(-1, gw + 1, 3)
    image = _lerp(size["width"], gw)[None] @ rows  # (H, W, 3)
    image += (rng.random(image.shape, dtype=np.float32) - 0.5) * (IMAGE_NOISE * 12**0.5)
    return {"image": np.clip(np.rint(image, out=image), 0, 255).astype(np.uint8)}


def _lerp(n: int, cells: int) -> np.ndarray:
    """(n, cells + 1) weights that sample ``cells + 1`` grid points
    linearly at ``n`` evenly spaced places from the first to the last."""
    at = np.linspace(0, cells, n, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(at[:, None] - np.arange(cells + 1, dtype=np.float32)))


def reference_models(cell, precision: str) -> Dict[str, nn.Module]:
    """The configuration's reference modules on the cell's device, loaded
    with the seed's weights (drawn in the served dtype, then widened to
    float32) and its mix factors, with their products in ``precision``."""
    reference.no_tf32()
    meta = reference_modules(cell.cfg)
    dtype = getattr(torch, cell.cfg["dtype"])
    out = {}
    for slot in SLOTS:
        w = seeded_weights(cell, {slot: meta[slot]}, cell.device, dtype)[slot]
        w = with_mix_factors(cell.cfg, slot, w)
        m = meta[slot]
        m.load_state_dict({k: v.float() for k, v in w.items()}, strict=True, assign=True)
        out[slot] = reference.set_operand_precision(m.eval().requires_grad_(False), precision)
    return out


def reference_outputs(cell, requests: List[Tuple[int, int]],
                      precision: str = "float32") -> List[torch.Tensor]:
    """The reference's frames of each request (index, latent seed), in
    order, every frame unrounded uint8 levels (H, W, 3) on the device."""
    models = reference_models(cell, precision)
    frames: List[torch.Tensor] = []
    for i, seed in requests:
        image = request_inputs(cell.cfg, cell.seed, i)["image"]
        frames.extend(sampling.sample(cell.cfg, cell.traffic, models, image, seed, cell.device))
    return frames


def request_flops(cfg: dict, traffic: dict) -> dict:
    """{'image_encoder', 'vae_encode', 'unet_eval', 'decode', 'request'}
    model FLOPs of one clip."""
    return counts.request_flops(reference_modules(cfg), cfg, traffic)


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    """{kernel: {call shape: calls}} of the port's kernels one clip makes,
    where reckoned (K1 and K2)."""
    return {"flash_attention": counts.k1_calls(cfg, traffic),
            "conv3x3": counts.k2_calls(cfg, traffic)}
