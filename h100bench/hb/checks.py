"""The comparisons that decide ``correct``: the reference, made from the
seed again and run on the device in float32 with TF32 off (or, for the
control, with its products in fp8), against what the program's timed path
produced."""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hb import inputs, program
from hb.weights import make_weights


def reference_models(cell, slots: Sequence[str], precision: str) -> Dict[str, torch.nn.Module]:
    """The configuration's reference modules on the cell's device, loaded
    with the seed's weights (drawn in the served dtype, then widened to
    float32)."""
    from hb.drive import SLOTS
    from hb.reference import no_tf32, set_operand_precision

    no_tf32()
    meta = program.reference_modules(cell.cfg)
    dtype = getattr(torch, cell.cfg["dtype"])
    out = {}
    for slot in slots:
        w = make_weights(meta[slot], inputs.sub_seed(cell.seed, inputs.WEIGHTS, SLOTS.index(slot)),
                         cell.device, dtype)
        m = meta[slot]
        m.load_state_dict({k: v.float() for k, v in w.items()}, strict=True, assign=True)
        out[slot] = set_operand_precision(m.eval().requires_grad_(False), precision)
    return out


def reference_images(cell, requests: List[Tuple[np.ndarray, int]],
                     precision: str = "float32") -> List[torch.Tensor]:
    """The reference's image of each (prompt ids, image seed), as unrounded
    uint8 levels (H, W, 3) on the device."""
    from hb.ref_sampling import sample

    slots = [s for s in ("unet", "vae", "text_encoder", "text_encoder_2") if s in cell.cfg]
    models = reference_models(cell, slots, precision)
    return [sample(cell.cfg, cell.traffic, models, ids, seed, cell.device)[0]
            for ids, seed in requests]


def image_gaps(program_images: List[np.ndarray], refs: List[torch.Tensor]) -> Dict[str, float]:
    """The worst image's mean gap and the largest gap of any pixel, in
    uint8 levels, between the program's images and the reference's."""
    means, tops = [], []
    for img, ref in zip(program_images, refs):
        d = (torch.as_tensor(img, device=ref.device).float() - ref).abs()
        means.append(d.mean().item())
        tops.append(d.max().item())
    return {"image_mean_levels": max(means), "image_max_levels": max(tops)}


def reference_unet(cell, precision: str = "float32") -> tuple:
    """(the reference UNet, its state dict, ᾱ on the device): what
    :func:`reference_training` runs, built once for several calls."""
    from hb.ref_sampling import alphas_cumprod

    unet = reference_models(cell, ["unet"], precision)["unet"]
    ac = torch.as_tensor(alphas_cumprod(), dtype=torch.float32, device=cell.device)
    return unet, dict(unet.state_dict()), ac


def reference_training(cell, initial: Dict[str, torch.Tensor], batches: List[dict],
                       keep_rows: int = 0, state: dict = None, model: tuple = None) -> dict:
    """The reference's steps from the LoRA ``initial`` over ``batches``
    (``ref_training.train``'s result), from AdamW's ``state`` where given
    (:func:`program.adam_state`'s form), else from a fresh one; ``model``
    is :func:`reference_unet`'s (the control's is in fp8), the float32 one
    made here where not given."""
    from hb.ref_training import train

    unet, base, ac = model or reference_unet(cell)
    lora = {}
    for name, t in initial.items():
        mod, k = name.rsplit(".", 1)
        lora.setdefault(mod, {})[k] = t
    return train(unet, base, lora, batches, ac, cell.traffic["learning_rate"],
                 keep_rows=keep_rows, state=state)


def train_gaps(initial: Dict[str, torch.Tensor], losses: List[float],
               first_grads: Dict[str, torch.Tensor], after3: Dict[str, torch.Tensor],
               ref: dict) -> Dict[str, float]:
    """Three steps against the reference's (``reference_training``) from the
    same LoRA on the same batches: the worst step's loss gap, and by the
    worst leaf the gap of the first gradient's norm and of the change's
    norm after three steps (each against the larger of the reference's
    norm and the median leaf's), over the leaves the reference moves."""
    from hb.ref_training import moving_leaves, norm_gap, relative_gap

    grad_keep = moving_leaves(ref["grads"][:1])
    move_keep = moving_leaves(ref["grads"])
    change_p = {k: after3[k].float() - initial[k].float() for k in move_keep}
    change_r = {k: ref["factors"][k] - initial[k].float() for k in move_keep}
    return {
        "loss_gap": max(relative_gap(p, r) for p, r in zip(losses, ref["losses"])),
        "grad_gap": norm_gap(first_grads, ref["grads"][0], grad_keep),
        "change_gap": norm_gap(change_p, change_r, move_keep),
    }


def late_gaps(before: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor],
              ref: dict) -> Dict[str, float]:
    """The step after the window against the reference's step from the same
    state (``reference_training`` with ``state``): by the worst leaf, the gap
    of the change's norm, over the leaves the reference moves."""
    from hb.ref_training import moving_leaves, norm_gap

    keep = moving_leaves(ref["grads"])
    change_p = {k: after[k].float() - before[k].float() for k in keep}
    change_r = {k: ref["factors"][k] - before[k].float() for k in keep}
    return {"late_change_gap": norm_gap(change_p, change_r, keep)}
