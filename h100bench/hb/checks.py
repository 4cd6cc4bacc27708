"""The comparisons that decide ``correct``: what the program's timed path
produced against its family's reference (``families/<family>.py``), made
from the seed again and run on the device in float32 with TF32 off (or,
for the control, with its products in fp8)."""

from typing import Dict, List

import numpy as np
import torch


def image_gaps(program_images: List[np.ndarray], refs: List[torch.Tensor]) -> Dict[str, float]:
    """The worst image's mean gap and the largest gap of any pixel, in
    uint8 levels, between the program's images and the reference's."""
    means, tops = [], []
    for img, ref in zip(program_images, refs):
        d = (torch.as_tensor(img, device=ref.device).float() - ref).abs()
        means.append(d.mean().item())
        tops.append(d.max().item())
    return {"image_mean_levels": max(means), "image_max_levels": max(tops)}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| against the larger of ‖ref‖ and the
    median kept leaf's ‖ref‖, over the leaves in ``keep``."""
    norms = {k: (prog[k].float().norm().item(), ref[k].float().norm().item()) for k in keep}
    med = sorted(r for _, r in norms.values())[len(norms) // 2]
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in norms.values())


def moving_leaves(grads: List[Dict[str, torch.Tensor]], share: float = 1e-3) -> list:
    """The leaves whose reference gradient, at its largest over the steps,
    is at least ``share`` of the median leaf's: the others move by
    round-off alone under Adam."""
    top = {k: max(g[k].norm().item() for g in grads) for k in grads[0]}
    vals = sorted(top.values())
    med = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (vals[len(vals) // 2 - 1]
                                                             + vals[len(vals) // 2])
    return sorted(k for k, v in top.items() if v >= share * med)


def relative_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def train_gaps(initial: Dict[str, torch.Tensor], losses: List[float],
               first_grads: Dict[str, torch.Tensor], after3: Dict[str, torch.Tensor],
               ref: dict) -> Dict[str, float]:
    """Three steps against the reference's (the family's
    ``reference_training``: {'losses', 'grads' per step, 'factors' after the
    last}) from the same LoRA on the same batches: the worst step's loss
    gap, and by the worst leaf the gap of the first gradient's norm and of
    the change's norm after three steps (each against the larger of the
    reference's norm and the median leaf's), over the leaves the reference
    moves."""
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
    state (the family's ``reference_training`` with ``state``): by the worst
    leaf, the gap of the change's norm, over the leaves the reference
    moves."""
    keep = moving_leaves(ref["grads"])
    change_p = {k: after[k].float() - before[k].float() for k in keep}
    change_r = {k: ref["factors"][k] - before[k].float() for k in keep}
    return {"late_change_gap": norm_gap(change_p, change_r, keep)}
