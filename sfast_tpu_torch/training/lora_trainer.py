"""LoRA fine-tuning step: the training path.

Counterpart of ``sfast_tpu/training/lora_trainer.py:25-81``.  The recipe
is the standard LDM one of the reference's
``examples/optimize_train_text_to_image_lora.py``: draw t and the noise,
noise the clean latents, predict eps, take the MSE.  JAX takes
``value_and_grad`` with respect to the LoRA alone and applies an optax
AdamW update; here the UNet runs through ``torch.func.functional_call`` on
``merge_lora(base, lora)`` with the base weights detached, so only the
LoRA factors get gradients (the UNet's own parameters are never written,
and no gradient of its 860 M weights is computed), then
``torch.optim.AdamW`` takes the step.

No hand-written kernel has a backward (``runtime/cuda_build.no_backward``),
as no Pallas kernel of the JAX package has one.  On the card the default
``CompilationConfig`` sends the level-0 self-attention to K1, and the
backward pass raises there; train with
``CompilationConfig(enable_kernels=False)``, which sends every op to its
plain PyTorch version.  JAX's own tests train with ``enable_pallas=False``
for the same reason.

Under a mesh (``ccfg.mesh``, as the JAX example's ``--mesh dp×tp``,
``examples/optimize_train_text_to_image_lora.py:36,46-50``) the UNet is
tensor-parallel (a ``CompiledModel`` compiled with the mesh holds the
rank's shards), and with an ``sp`` axis of more than one rank its attention
runs as ring attention: each rank takes its ``dp`` slice of the batch (and
of t and the noise, drawn for the whole batch), merges the LoRA's delta
into its shards (``merge_lora``'s ``sharded``), and runs the forward with
the collectives of ``parallel/tensor_parallel.py`` and
``parallel/ring_attention.py``.  The LoRA stays replicated, as in JAX.
Every rank of a ``dp`` slice's tp × sp block computes the same loss, and
every collective's backward is its adjoint (the ring's rotation included),
so each rank differentiates its loss over tp · sp; the factors' gradients
are then summed over ``tp`` and ``sp`` and averaged over ``dp``, and every
rank's AdamW takes the same step.
"""

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.lora import LoRA, init_lora_params, merge_lora
from sfast_tpu_torch.parallel.mesh import axis_rank, axis_size
from sfast_tpu_torch.parallel.tensor_parallel import full_shapes, parallel_linears
from sfast_tpu_torch.schedulers.common import SchedulerConfig, alphas_cumprod

# optax.adamw's defaults; torch.optim.AdamW's weight decay is 1e-2
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def _module(unet) -> torch.nn.Module:
    """The ``nn.Module`` of a UNet or of a ``CompiledModel`` holding one."""
    return getattr(unet, "module", unet)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def lora_factors(lora: LoRA):
    """The factors of ``lora`` in its order: what the optimizer holds."""
    return [f[k] for f in lora.values() for k in ("a", "b")]


def lora_training_setup(
    unet,
    *,
    rank: int = 4,
    learning_rate: float = 1e-4,
    generator: Optional[torch.Generator] = None,
):
    """``(lora, optimizer)`` for a UNet (a module or a ``CompiledModel``).

    The LoRA is ``init_lora_params`` of the UNet's state dict in f32 (A
    Gaussian / rank, B zero) on the UNet's device, drawn on ``generator``
    (seed 0 on that device when None), its factors leaf tensors that
    require grad; a tensor-parallel UNet's is drawn for the unsharded
    shapes, the same on every rank.  The optimizer is AdamW at optax's
    defaults."""
    module = _module(unet)
    dev = _device(module)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    shapes = {k: torch.empty(s, device="meta") for k, s in full_shapes(module).items()}
    lora = init_lora_params(generator, shapes, rank=rank)
    for f in lora.values():
        for k in ("a", "b"):
            f[k] = f[k].to(dev).requires_grad_(True)
    optimizer = torch.optim.AdamW(lora_factors(lora), lr=learning_rate, betas=ADAMW_BETAS,
                                  eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    return lora, optimizer


def make_lora_train_step(
    unet,
    optimizer: torch.optim.Optimizer,
    *,
    ccfg: Optional[CompilationConfig] = None,
    sched_cfg: SchedulerConfig = SchedulerConfig(),
) -> Callable:
    """Returns ``train_step(lora, batch, generator=None, *, t=None,
    noise=None)`` → the loss, a 0-d f32 tensor, after one optimizer step.

    ``batch`` holds ``latents`` (B, h, w, 4), clean VAE latents, and
    ``context`` (B, S, D), text embeddings.  t ~ randint(0,
    num_train_timesteps) and noise ~ N(0, 1) in f32 are drawn on
    ``generator`` (on the latents' device) unless given; the tests hand in
    JAX's draws, since threefry is not Philox.  ``lora`` is the dict whose
    factors ``optimizer`` holds.

    ``ccfg`` defaults to ``CompilationConfig.Default()``, as JAX's does; it
    is passed to the UNet's forward with the call, as JAX passes it, so the
    module's own ``compilation_config`` is never written and a pipeline
    serving from the same UNet on another thread keeps its routes.  On the card
    the default's K1 refuses the backward pass (``cuda_build.no_backward``):
    pass ``CompilationConfig(enable_kernels=False)``.  A step that raises
    takes no optimizer step and leaves no gradient behind."""
    ccfg = ccfg or CompilationConfig.Default()
    module = _module(unet)
    ac_host = torch.tensor(alphas_cumprod(sched_cfg), dtype=torch.float32)
    n_train = sched_cfg.num_train_timesteps
    mesh = ccfg.mesh
    sharded = parallel_linears(module)
    dp, block = axis_size(mesh, "dp"), axis_size(mesh, "tp") * axis_size(mesh, "sp")

    def train_step(lora: LoRA, batch, generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        latents, context = batch["latents"], batch["context"]
        dev = latents.device
        if (t is None or noise is None) and generator is None:
            raise ValueError("train_step: pass a generator, or both t and noise")
        if t is None:
            t = torch.randint(0, n_train, (latents.shape[0],), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev,
                                dtype=torch.float32)
        if dp > 1:
            if latents.shape[0] % dp:
                raise ValueError(f"train_step: batch {latents.shape[0]} does not split {dp} ways")
            n = latents.shape[0] // dp
            r = axis_rank(mesh, "dp")
            latents, context, t, noise = (x.narrow(0, r * n, n)
                                          for x in (latents, context, t, noise))
        ac = ac_host.to(dev)[t.to(dev)]
        a = ac.sqrt()[:, None, None, None]
        s = (1 - ac).sqrt()[:, None, None, None]
        noisy = (a * latents + s * noise).to(latents.dtype)
        base = module.state_dict()  # detached: only the LoRA factors get gradients
        try:
            pred = functional_call(module, merge_lora(base, lora, 1.0, sharded),
                                   (noisy, t.to(torch.float32), context),
                                   {"compilation_config": ccfg})
            loss = torch.mean((pred.float() - noise.float()) ** 2)
            if mesh is None:
                loss.backward()
            else:
                (loss / block).backward()
                _reduce_grads(lora_factors(lora), mesh, dp)
                loss = _mean_over_dp(loss.detach(), mesh, dp)
            optimizer.step()
        finally:
            optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step


def _reduce_grads(factors, mesh, dp: int) -> None:
    """Sum the factors' gradients over ``tp`` and ``sp`` and average them
    over ``dp``, in one buffer an axis."""
    grads = [p.grad for p in factors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for axis in ("tp", "sp", "dp"):
        if axis in mesh.mesh_dim_names:
            dist.all_reduce(flat, group=mesh.get_group(axis))
    flat /= dp
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(parts, grads)])


def _mean_over_dp(loss: torch.Tensor, mesh, dp: int) -> torch.Tensor:
    if "dp" in mesh.mesh_dim_names:
        loss = loss.clone()
        dist.all_reduce(loss, group=mesh.get_group("dp"))
    return loss / dp
