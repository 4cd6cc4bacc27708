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

With ``ccfg.enable_cuda_graph`` (≙ JAX's ``jax.jit(train_step)``,
``examples/optimize_train_text_to_image_lora.py:43``) a step on the card
replays one CUDA graph per batch signature: the forward, autograd's
backward, the gradients' all-reduces under a mesh, and AdamW's update.
The graph reads and writes the LoRA's factors, the gradients and the
optimizer's state by address, as the model graphs read their weights; its
inputs are the latents, the text embeddings, t and the noise, which are
drawn before each replay on the caller's generator in the eager step's
order, so a graphed and an eager step on one generator take the same
draws.  The first call of a signature runs three eager warm-up steps and
the capture, then puts the LoRA and the optimizer's state back as they
were (state the warm-ups created goes back to zeros: what a first AdamW
step starts from) and replays once, so it takes the step an eager call
would have taken.  The optimizer must be ``torch.optim.Adam`` or
``AdamW`` built with ``capturable=True`` (``lora_training_setup`` builds
it so on the card).  A graph keeps the hyperparameters it was captured
with: a changed ``lr`` or ``weight_decay`` in ``param_groups`` raises at
the next call, and a schedule writes into a device-tensor ``lr`` in place
instead, which the graph reads by address.  Python hooks (an optimizer's
step hooks, tensor hooks) run in the warm-ups and the capture only, never
in a replay.  A step that raises in a warm-up (the kernels' refusal of a
backward under ``CompilationConfig.Default()``) or in the capture raises,
caches nothing and leaves the LoRA and the optimizer as they were; no
call falls back to the eager step.  CPU tensors, and
``enable_cuda_graph=False``, take the eager step.  Under a profiler
session a graphed step is an ``sfast.replay`` span of ``lora_train_step``
(``profile/spans.py``).  Dropping the step
frees its graphs' memory pools; the graphs are dropped when the UNet's
tensors are replaced (``runtime.tracing.weights_version``).
"""

import warnings
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.lora import LoRA, init_lora_params, merge_lora
from sfast_tpu_torch.parallel.mesh import axis_rank, axis_size
from sfast_tpu_torch.parallel.tensor_parallel import full_shapes, parallel_linears
from sfast_tpu_torch.profile import spans
from sfast_tpu_torch.runtime.signature import call_signature
from sfast_tpu_torch.runtime.tracing import (
    WARMUP_CALLS,
    CapturedGraph,
    capture_graph,
    weights_version,
)
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


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


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
    defaults, ``capturable`` on the card (its step count a device tensor,
    so that the train step's graph can hold its update)."""
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
                                  eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
                                  capturable=dev.type == "cuda")
    return lora, optimizer


def make_lora_train_step(
    unet,
    optimizer: torch.optim.Optimizer,
    *,
    ccfg: Optional[CompilationConfig] = None,
    sched_cfg: SchedulerConfig = SchedulerConfig(),
) -> "LoraTrainStep":
    """Returns ``train_step(lora, batch, generator=None, *, t=None,
    noise=None)`` → the loss, a 0-d f32 tensor, after one optimizer step.

    ``batch`` holds ``latents`` (B, h, w, 4), clean VAE latents, and
    ``context`` (B, S, D), text embeddings.  t ~ randint(0,
    num_train_timesteps) and noise ~ N(0, 1) in f32 are drawn on
    ``generator`` (on the latents' device) unless given; the tests hand in
    JAX's draws, since threefry is not Philox.  ``lora`` is the dict whose
    factors ``optimizer`` holds; another raises.

    ``ccfg`` defaults to ``CompilationConfig.Default()``, as JAX's does; it
    is passed to the UNet's forward with the call, as JAX passes it, so the
    module's own ``compilation_config`` is never written and a pipeline
    serving from the same UNet on another thread keeps its routes.  On the card
    the default's K1 refuses the backward pass (``cuda_build.no_backward``):
    pass ``CompilationConfig(enable_kernels=False)``.  A step that raises
    takes no optimizer step and leaves no gradient behind.  Its
    ``enable_cuda_graph`` (on by default) replays the step on the card as
    one CUDA graph (the module's docstring)."""
    return LoraTrainStep(unet, optimizer, ccfg or CompilationConfig.Default(), sched_cfg)


class LoraTrainStep:
    """The train step of :func:`make_lora_train_step`, and its CUDA graphs:
    one per batch signature (:attr:`cache_size`, :meth:`graphs`)."""

    def __init__(self, unet, optimizer: torch.optim.Optimizer, ccfg: CompilationConfig,
                 sched_cfg: SchedulerConfig):
        self.module = _module(unet)
        self.optimizer = optimizer
        self.ccfg = ccfg
        # on the module's device once: a copy from the host in every step
        # would wait for the card, and no capture may hold one
        self._ac = torch.tensor(alphas_cumprod(sched_cfg), dtype=torch.float32,
                                device=_device(self.module))
        self._n_train = sched_cfg.num_train_timesteps
        self._sharded = parallel_linears(self.module)
        mesh = ccfg.mesh
        self._dp = axis_size(mesh, "dp")
        self._block = axis_size(mesh, "tp") * axis_size(mesh, "sp")
        self._cache: Dict[tuple, CapturedGraph] = {}
        self._version = weights_version(self.module)
        self._captured_with = None  # the optimizer's hyperparameters at the captures

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def graphs(self) -> List[CapturedGraph]:
        return list(self._cache.values())

    def __call__(self, lora: LoRA, batch, generator: Optional[torch.Generator] = None, *,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        _check_lora(lora, self.optimizer)
        latents, context = batch["latents"], batch["context"]
        dev = latents.device
        if (t is None or noise is None) and generator is None:
            raise ValueError("train_step: pass a generator, or both t and noise")
        if t is None:
            t = torch.randint(0, self._n_train, (latents.shape[0],), generator=generator,
                              device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev,
                                dtype=torch.float32)
        inputs = [latents, context, t.to(dev), noise.to(dev)]
        if self.ccfg.enable_cuda_graph and _on_card(latents):
            with spans.replay("lora_train_step"):
                return self._graph(lora, inputs).run(inputs)
        return self._update(lora, *inputs)

    def _update(self, lora: LoRA, latents, context, t, noise) -> torch.Tensor:
        """One step's device work, with no host sync: the forward, the
        backward, the gradients' reduction under a mesh and the optimizer's
        update.  What a graph captures."""
        mesh = self.ccfg.mesh
        if self._dp > 1:
            if latents.shape[0] % self._dp:
                raise ValueError(f"train_step: batch {latents.shape[0]} does not split "
                                 f"{self._dp} ways")
            n = latents.shape[0] // self._dp
            r = axis_rank(mesh, "dp")
            latents, context, t, noise = (x.narrow(0, r * n, n)
                                          for x in (latents, context, t, noise))
        ac = self._ac[t]
        a = ac.sqrt()[:, None, None, None]
        s = (1 - ac).sqrt()[:, None, None, None]
        noisy = (a * latents + s * noise).to(latents.dtype)
        base = self.module.state_dict()  # detached: only the LoRA factors get gradients
        try:
            pred = functional_call(self.module, merge_lora(base, lora, 1.0, self._sharded),
                                   (noisy, t.to(torch.float32), context),
                                   {"compilation_config": self.ccfg})
            loss = torch.mean((pred.float() - noise.float()) ** 2)
            if mesh is None:
                loss.backward()
            else:
                (loss / self._block).backward()
                _reduce_grads(lora_factors(lora), mesh, self._dp)
                loss = _mean_over_dp(loss.detach(), mesh, self._dp)
            self.optimizer.step()
        finally:
            self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    def _graph(self, lora: LoRA, inputs) -> CapturedGraph:
        version = weights_version(self.module)
        if version != self._version:  # the UNet's tensors were replaced
            self._cache.clear()
            self._version = version
        hyper = _hyperparameters(self.optimizer)
        if self._cache and not _same_hyperparameters(hyper, self._captured_with):
            raise ValueError(
                "train_step: the optimizer's param_groups changed after the step's graph was "
                "captured, and a graph keeps the values it was captured with; change a "
                "device-tensor lr in place (AdamW(..., lr=torch.tensor(lr, device=...), "
                "capturable=True)), or make a new step")
        key = call_signature(inputs, {})
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = self._capture(lora, inputs)
            self._captured_with = hyper
        return entry

    def _capture(self, lora: LoRA, inputs) -> CapturedGraph:
        device = inputs[0].device
        _check_graphable(self.optimizer, device)
        static = [x.clone() for x in inputs]
        saved = _save_state(lora, self.optimizer)
        try:
            with warnings.catch_warnings():  # the warm-ups step a capturable AdamW eagerly
                warnings.filterwarnings("ignore", "This instance was constructed with "
                                        "capturable=True")
                return capture_graph(lambda: self._update(lora, *static), device, static,
                                     warmup_calls=WARMUP_CALLS, name="lora_train_step",
                                     cache_size=len(self._cache) + 1)
        finally:  # the warm-ups trained: put the LoRA and the optimizer back
            _restore_state(saved, lora, self.optimizer)


def _check_lora(lora: LoRA, optimizer: torch.optim.Optimizer) -> None:
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    factors = lora_factors(lora)
    if held != {id(f) for f in factors} or len(factors) != len(held):
        raise ValueError("train_step: the LoRA's factors are not the optimizer's parameters "
                         "(lora_training_setup returns a matching pair)")


def _check_graphable(optimizer: torch.optim.Optimizer, device: torch.device) -> None:
    """The graphed step holds Adam's update: a device step count, and no
    hyperparameter that a capture would copy from the host."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"train_step: the graphed step takes torch.optim.Adam or AdamW, not "
                        f"{type(optimizer).__name__}; pass CompilationConfig("
                        f"enable_cuda_graph=False) to train with it eagerly")
    for group in optimizer.param_groups:
        if not group["capturable"]:
            raise ValueError("train_step: the graphed step needs an optimizer built with "
                             "capturable=True (lora_training_setup builds one on the card)")
        for k, v in group.items():
            if k != "params" and torch.is_tensor(v) and v.device != device:
                raise ValueError(f"train_step: the optimizer's {k} is a tensor on {v.device}; "
                                 f"a graph on {device} would keep its value")


def _hyperparameters(optimizer: torch.optim.Optimizer) -> list:
    return [([id(p) for p in g["params"]], {k: v for k, v in g.items() if k != "params"})
            for g in optimizer.param_groups]


def _same_hyperparameters(a: list, b: list) -> bool:
    """A tensor by identity (a graph reads it by address), any other value
    by equality."""
    def same(x, y):
        if torch.is_tensor(x) or torch.is_tensor(y):
            return x is y
        return x == y

    return len(a) == len(b) and all(
        ids_a == ids_b and hp_a.keys() == hp_b.keys() and all(same(hp_a[k], hp_b[k]) for k in hp_a)
        for (ids_a, hp_a), (ids_b, hp_b) in zip(a, b))


def _save_state(lora: LoRA, optimizer: torch.optim.Optimizer):
    """Copies of the LoRA's factors and of the optimizer's per-parameter
    state (None for a parameter that has none yet)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {p: ({k: v.clone() for k, v in optimizer.state[p].items()}
                 if optimizer.state.get(p) else None) for p in params}
    return [f.detach().clone() for f in lora_factors(lora)], state


def _restore_state(saved, lora: LoRA, optimizer: torch.optim.Optimizer) -> None:
    """Writes ``saved`` back into the tensors in place, since a captured
    graph holds their addresses.  State created after ``saved`` goes back
    to zeros: an Adam whose step count and moments are zero takes exactly
    the step of one that has no state yet."""
    factors, state = saved
    with torch.no_grad():
        for f, v in zip(lora_factors(lora), factors):
            f.copy_(v)
        for p, was in state.items():
            for k, v in optimizer.state.get(p, {}).items():
                if was is None:
                    v.zero_()
                else:
                    v.copy_(was[k])


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
