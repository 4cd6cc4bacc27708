"""The LoRA train step as one CUDA graph on a card, against the eager step.

A tiny bf16 UNet (``TINY_UNET`` with ``cross_attention_dim=64``) at 32²
latents, whose level-0 self-attentions (1,024 tokens) take K1 under the
default configuration, with seeded random weights.  A replay runs the
kernels the capture recorded on the same buffers as the eager step, and
AdamW (``capturable=True`` on both sides) reads its step count from the
device either way, so graphed steps must equal eager ones bit for bit: the
losses, the factors and AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``.
Every test skips without a CUDA card.  The file imports no JAX, so on a
machine without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_training_cuda.py
"""

import dataclasses
import gc

import pytest
import torch

from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.models import TINY_UNET, UNet2DConditionModel, init_weights_
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.runtime.tracing import bump_weights_version, lazy_jit
from sfast_tpu_torch.training import lora_factors, lora_training_setup, make_lora_train_step

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
CFG = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
GRAPHED = CompilationConfig(enable_kernels=False)
EAGER = CompilationConfig(enable_kernels=False, enable_cuda_graph=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unet(dev):
    return init_weights_(UNet2DConditionModel(CFG, device=dev, dtype=BF16),
                         torch.Generator(device=dev).manual_seed(60))


def _batch(dev, seed=61):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"latents": torch.randn((2, 32, 32, 4), generator=g, device=dev),
            "context": torch.randn((2, 7, 64), generator=g, device=dev)}


def _state(lora, opt):
    factors = lora_factors(lora)
    return ([f.detach().clone() for f in factors],
            [{k: v.clone() for k, v in opt.state.get(f, {}).items()} for f in factors])


def _same_state(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
                    for x, y in zip(a[1], b[1])))


def _train(dev, unet, ccfg, steps=3, lr_schedule=None):
    """``steps`` steps from the same initial LoRA and a fresh capturable
    AdamW on one generator's draws: (losses, state, step)."""
    lora, opt = lora_training_setup(unet, rank=2,
                                    generator=torch.Generator(device=dev).manual_seed(62))
    if lr_schedule is not None:
        for group in opt.param_groups:
            group["lr"] = torch.tensor(lr_schedule[0], device=dev)
    step = make_lora_train_step(unet, opt, ccfg=ccfg)
    batch = _batch(dev)
    g = torch.Generator(device=dev).manual_seed(63)
    losses = []
    for i in range(steps):
        if lr_schedule is not None:
            opt.param_groups[0]["lr"].fill_(lr_schedule[i])
        losses.append(step(lora, batch, g))
    torch.cuda.synchronize()
    return losses, _state(lora, opt), step, (lora, opt)


def _pool_bytes(pool) -> int:
    return sum(s["total_size"] for s in torch.cuda.memory._snapshot()["segments"]
               if tuple(s["segment_pool_id"]) == pool)


def test_graphed_steps_equal_eager_steps(dev):
    """Three graphed steps (the first warms up three times, captures and
    replays) equal three eager steps bit for bit; the graph launches no
    kernel with the kernels off and holds the backward's kernels (more
    nodes than a forward's alone); the loss is a fresh 0-d f32 tensor."""
    unet = _unet(dev)
    eager, e_state, _, _ = _train(dev, unet, EAGER)
    cuda_build.reset_launch_counts()
    graphed, g_state, step, (lora, opt) = _train(dev, unet, GRAPHED)
    assert not any(cuda_build.launch_counts.values())
    assert step.cache_size == 1
    (graph,) = step.graphs()
    forward = lazy_jit(lambda x, t, c: unet(x, t, c, compilation_config=EAGER))
    x = _batch(dev)
    with torch.no_grad():
        forward(x["latents"].to(BF16), torch.zeros(2, device=dev), x["context"].to(BF16))
    assert graph.nodes > 2 * forward.graphs()[0].nodes  # the backward is in the graph
    assert all(loss.dim() == 0 and loss.dtype == torch.float32 for loss in graphed)
    assert graphed[0].data_ptr() != graphed[1].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager)), (graphed, eager)
    assert _same_state(g_state, e_state)
    assert all(s["step"].item() == 3 for s in g_state[1])
    assert all(f.grad is None for f in lora_factors(lora))


def test_lr_in_place_takes_effect_and_a_new_value_raises(dev):
    """A device-tensor ``lr`` written in place between steps is read by the
    replay: three graphed steps at 1e-4, 3e-4, 2e-4 equal the eager ones.
    A float written into ``param_groups`` after the capture raises; a new
    ``weights_version`` of the UNet captures anew."""
    unet = _unet(dev)
    schedule = (1e-4, 3e-4, 2e-4)
    eager, e_state, _, _ = _train(dev, unet, EAGER, lr_schedule=schedule)
    graphed, g_state, step, (lora, opt) = _train(dev, unet, GRAPHED, lr_schedule=schedule)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
    assert _same_state(g_state, e_state)
    lr = opt.param_groups[0]["lr"]
    opt.param_groups[0]["lr"] = 1e-4
    with pytest.raises(ValueError, match="param_groups changed"):
        step(lora, _batch(dev), torch.Generator(device=dev))
    opt.param_groups[0]["lr"] = lr
    (graph,) = step.graphs()
    bump_weights_version(unet)
    step(lora, _batch(dev), torch.Generator(device=dev))
    assert step.cache_size == 1 and step.graphs()[0] is not graph


def test_default_config_refuses_captures_nothing_and_restores(dev):
    """Under ``CompilationConfig.Default()`` the first warm-up's forward
    launches K1 at the three level-0 self-attentions and its backward
    raises: nothing is captured, and the LoRA and AdamW, trained one
    graphed step before, are as they were."""
    unet = _unet(dev)
    _, _, _, (lora, opt) = _train(dev, unet, GRAPHED, steps=1)
    before = _state(lora, opt)
    step = make_lora_train_step(unet, opt)
    cuda_build.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention: .*enable_kernels=False"):
        step(lora, _batch(dev), torch.Generator(device=dev).manual_seed(64))
    assert cuda_build.launch_counts["flash_attention"] == 3
    assert step.cache_size == 0
    assert _same_state(_state(lora, opt), before)
    assert all(f.grad is None for f in lora_factors(lora))


def test_graphed_step_needs_a_capturable_adam(dev):
    """A non-capturable AdamW or another optimizer raises at the first call,
    before any warm-up has trained."""
    unet = _unet(dev)
    lora, opt = lora_training_setup(unet, rank=2)
    before = _state(lora, opt)
    plain_opt = torch.optim.AdamW(lora_factors(lora), lr=1e-4)
    with pytest.raises(ValueError, match="capturable=True"):
        make_lora_train_step(unet, plain_opt, ccfg=GRAPHED)(lora, _batch(dev),
                                                             torch.Generator(device=dev))
    sgd = torch.optim.SGD(lora_factors(lora), lr=1e-4)
    with pytest.raises(TypeError, match="Adam or AdamW"):
        make_lora_train_step(unet, sgd, ccfg=GRAPHED)(lora, _batch(dev),
                                                      torch.Generator(device=dev))
    assert _same_state(_state(lora, opt), before)


def test_dropping_the_step_frees_its_pool(dev):
    """The graph's memory pool holds the step's working set; once the step
    is dropped and the cache emptied, no segment of that pool is left."""
    unet = _unet(dev)
    _, _, step, _ = _train(dev, unet, GRAPHED, steps=1)
    (graph,) = step.graphs()
    pool = tuple(graph.graph.pool())
    held = _pool_bytes(pool)
    assert held > 0
    del step, graph
    gc.collect()
    torch.cuda.empty_cache()
    assert _pool_bytes(pool) == 0, held
