"""The reference's LoRA train step: the LDM loss of the UNet with
``W + (A·B)ᵀ`` in each attention projection, its gradients with respect to
the factors alone, and AdamW as ``torch.optim.AdamW`` defines it
(decoupled weight decay), written out.  Plain torch; nothing of the
program under test."""

from typing import Dict, List, Optional

import torch
from torch.func import functional_call

BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the program's step uses


def lora_loss(unet, base: Dict[str, torch.Tensor], lora: dict, batch: dict,
              alphas_cumprod: torch.Tensor, rows=None) -> torch.Tensor:
    """mean((ε̂(√ᾱ·x + √(1−ᾱ)·ε, t) − ε)²) over ``rows`` of the batch
    (all where None); latents and noise NHWC, as the program takes them."""
    sel = slice(None) if rows is None else rows
    lat, noise, t = batch["latents"][sel], batch["noise"][sel], batch["t"][sel]
    ctx = batch["context"][sel]
    ac = alphas_cumprod[t].float()
    x = ac.sqrt()[:, None, None, None] * lat.float() + (1 - ac).sqrt()[:, None, None, None] * \
        noise.float()
    params = dict(base)
    for mod, f in lora.items():
        params[mod + ".weight"] = base[mod + ".weight"] + (f["a"] @ f["b"]).T
    pred = functional_call(unet, params, (x.permute(0, 3, 1, 2), t.float(), ctx.float()))
    return torch.mean((pred.permute(0, 2, 3, 1) - noise.float()) ** 2)


def train(unet, base: Dict[str, torch.Tensor], lora: dict, batches: List[dict],
          alphas_cumprod: torch.Tensor, lr: float, rows_per_pass: int = 1,
          keep_rows: int = 0, state: Optional[dict] = None) -> dict:
    """Steps of the reference from ``lora`` (copied, not written) over
    ``batches``: {'losses', 'grads' (per step, {factor: gradient}),
    'factors' (after the last step)}.  The loss of a batch is the mean of
    its rows' losses, so its gradients are summed over passes of
    ``rows_per_pass`` rows, which bounds the memory autograd holds.
    ``keep_rows`` > 0 computes every step on the first ``keep_rows`` rows
    alone: half the batch left out, the mean taken over the rest.  AdamW
    starts from ``state`` ({factor: {'exp_avg', 'exp_avg_sq', 'step'}}, the
    same step count on every factor) where given, else from zero moments at
    step 0."""
    factors = {f"{m}.{k}": lora[m][k].detach().clone().float().requires_grad_(True)
               for m in sorted(lora) for k in ("a", "b")}
    tree = {m: {k: factors[f"{m}.{k}"] for k in ("a", "b")} for m in lora}
    if state is None:
        m1 = {k: torch.zeros_like(v) for k, v in factors.items()}
        m2 = {k: torch.zeros_like(v) for k, v in factors.items()}
        start = 1
    else:
        m1 = {k: state[k]["exp_avg"].float().clone() for k in factors}
        m2 = {k: state[k]["exp_avg_sq"].float().clone() for k in factors}
        steps = {state[k]["step"] for k in factors}
        if len(steps) != 1:
            raise ValueError(f"the factors' AdamW states are at different steps: {steps}")
        start = steps.pop() + 1
    losses, grads = [], []
    for step, batch in enumerate(batches, start=start):
        b = batch["latents"].shape[0] if keep_rows <= 0 else keep_rows
        total = 0.0
        for lo in range(0, b, rows_per_pass):
            rows = slice(lo, min(lo + rows_per_pass, b))
            n = rows.stop - rows.start
            loss = lora_loss(unet, base, tree, batch, alphas_cumprod, rows) * (n / b)
            loss.backward()
            total += loss.item()
        losses.append(total)
        g = {k: v.grad.detach().clone() for k, v in factors.items()}
        grads.append(g)
        with torch.no_grad():
            c1, c2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
            for k, p in factors.items():
                p.mul_(1 - lr * WEIGHT_DECAY)
                m1[k].mul_(BETAS[0]).add_(g[k], alpha=1 - BETAS[0])
                m2[k].mul_(BETAS[1]).addcmul_(g[k], g[k], value=1 - BETAS[1])
                p.sub_(lr * (m1[k] / c1) / ((m2[k] / c2).sqrt() + EPS))
                p.grad = None
    return {"losses": losses, "grads": grads,
            "factors": {k: v.detach() for k, v in factors.items()}}


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
