"""The port's LoRA trainer against sfast_tpu's (CPU), and the kernels'
refusal to be differentiated.

Both sides train JAX's tiny UNet (``TINY_UNET`` with
``cross_attention_dim=64``, as ``tests/training/test_lora_trainer.py``) in
f32 on one set of weights (``interop.from_jax``), from one LoRA (the
port's ``lora_training_setup``, carried to JAX by ``from_jax.lora_to_jax``),
with the kernels off (``enable_pallas=False`` / ``enable_kernels=False``).
JAX's ``train_step`` is jitted once for the module and takes two steps on
its own ``rng``; the port's takes the same t and noise, drawn from that
``rng`` as ``lora_trainer.py:70-73`` splits it (threefry is not Philox).

Tolerances: the loss within 1e-5 relative and every factor within 1e-6
absolute after each step.  The gradients are the same math in f32 summed
in another order (about 2e-6 of the largest gradient apart).  Adam's first
step is close to lr·sign(g), so an element whose gradient is within that
noise of zero could take another sign; at these seeds no element of B's
step-1 gradient is that small (the least is 5.7e-7, 1.7e-5 of the
largest, with the two packages at most 7e-8 apart), so the bound holds for
every element and no element is excluded.  A's gradient at step 1 is exactly
zero on both sides (B starts at zero).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import unet_2d_condition as junet
from sfast_tpu.training import lora_training_setup as jax_setup
from sfast_tpu.training import make_lora_train_step as jax_make_step
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import TINY_UNET, UNet2DConditionModel
from sfast_tpu_torch.models import layers, unet_2d_condition
from sfast_tpu_torch.ops.flash_attention import flash_attention_ref
from sfast_tpu_torch.ops.flash_attention_int8 import flash_attention_int8_ref, kernel_inputs
from sfast_tpu_torch.ops.fused_conv import conv3x3_block_ref
from sfast_tpu_torch.ops.geglu import linear_geglu_fused_ref
from sfast_tpu_torch.ops.layer_norm import layer_norm_plain
from sfast_tpu_torch.ops.group_norm import (
    group_norm_apply_ref,
    group_norm_fused_ref,
    group_norm_stats_ref,
)
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.runtime.tracing import bump_weights_version
from sfast_tpu_torch.training import lora_factors, lora_training_setup, lora_trainer
from sfast_tpu_torch.training import make_lora_train_step
from tests.test_torch_svd import _one_torch_thread  # noqa: F401  (an autouse fixture)

J_CFG = dataclasses.replace(junet.TINY_UNET, cross_attention_dim=64)
CFG = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
PLAIN = CompilationConfig(enable_kernels=False)
RANK, BATCH, HW, SEQ = 2, 2, 16, 7
LOSS_REL, FACTOR_ABS = 1e-5, 1e-6


def _unet(params):
    m = UNet2DConditionModel(CFG, device="cpu", dtype=torch.float32)
    m.load_state_dict(from_jax.unet_state_dict(params))
    return m


def _batch():
    rng = np.random.default_rng(0)
    return {"latents": rng.standard_normal((BATCH, HW, HW, 4)).astype(np.float32),
            "context": rng.standard_normal((BATCH, SEQ, 64)).astype(np.float32)}


def _draws(key):
    """JAX's t and noise for ``key``, as its ``train_step`` draws them."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (BATCH,), 0, 1000)
    noise = jax.random.normal(k_n, (BATCH, HW, HW, 4), jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def _copy(lora):
    return {m: {k: f[k].detach().clone() for k in ("a", "b")} for m, f in lora.items()}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's two steps from the port's initial LoRA: the params, the initial
    LoRA (the port's layout), and per step (loss, LoRA after it, t, noise)."""
    unet = junet.create_unet(J_CFG, jax.random.key(0))
    lora, _ = lora_training_setup(_unet(unet.params), rank=RANK,
                                  generator=torch.Generator().manual_seed(0))
    jlora = {p: {k: jnp.asarray(v) for k, v in f.items()}
             for p, f in from_jax.lora_to_jax(lora, unet.params).items()}
    _, tx, _ = jax_setup(unet, rank=RANK)
    opt_state = tx.init(jlora)
    step = jax.jit(jax_make_step(unet, tx, ccfg=JaxConfig(enable_pallas=False,
                                                         enable_aot_cache=False)))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    steps = []
    for i in range(2):
        key = jax.random.key(3 + i)
        jlora, opt_state, loss = step(jlora, opt_state, unet.params, batch, key)
        steps.append((float(loss), from_jax.lora_params(jlora), *_draws(key)))
    return unet.params, _copy(lora), steps


def _port_steps(params, lora0, steps, weight_decay=None):
    """The port's two steps from ``lora0`` on JAX's draws: (module, lora,
    the losses, the largest factor errors after each step)."""
    m = _unet(params)
    lora, opt = lora_training_setup(m, rank=RANK, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod, f in lora.items():
            for k in ("a", "b"):
                f[k].copy_(lora0[mod][k])
    if weight_decay is not None:
        for group in opt.param_groups:
            group["weight_decay"] = weight_decay
    step = make_lora_train_step(m, opt, ccfg=PLAIN)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses, errors = [], []
    for _, ref, t, noise in steps:
        losses.append(float(step(lora, batch, t=t, noise=noise)))
        errors.append(max((f[k].detach() - ref[mod][k]).abs().max().item()
                          for mod, f in lora.items() for k in ("a", "b")))
    return m, lora, losses, errors


def test_two_steps_match_jax(jax_run):
    params, lora0, steps = jax_run
    _, _, losses, errors = _port_steps(params, lora0, steps)
    for (ref_loss, *_), loss, err in zip(steps, losses, errors):
        assert abs(loss - ref_loss) <= LOSS_REL * abs(ref_loss), (loss, ref_loss)
        assert err <= FACTOR_ABS, err
    assert losses[0] != losses[1]


def test_torch_default_weight_decay_misses_jax(jax_run):
    """optax.adamw decays by 1e-4, torch.optim.AdamW by 1e-2 by default: with
    torch's, A (about 0.5 in size) drifts 2e-6 from JAX's in one step."""
    params, lora0, steps = jax_run
    _, _, _, errors = _port_steps(params, lora0, steps, weight_decay=1e-2)
    assert errors[0] > FACTOR_ABS, errors


def test_setup_matches_optax_defaults_and_init():
    m = _unet(junet.init_unet_params(0, J_CFG))
    lora, opt = lora_training_setup(m, rank=RANK, learning_rate=3e-4)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.999), 1e-8, 1e-4)
    assert [id(p) for p in group["params"]] == [id(p) for p in lora_factors(lora)]
    for f in lora.values():
        assert f["a"].is_leaf and f["a"].requires_grad and f["a"].dtype == torch.float32
        assert f["b"].is_leaf and f["b"].requires_grad and not f["b"].any()
    assert len(lora) == 32  # q, k, v, out of 8 attentions


def test_only_the_lora_gets_gradients_and_the_base_stays(jax_run):
    params, lora0, steps = jax_run
    m = _unet(params)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    lora, opt = lora_training_setup(m, rank=RANK, generator=torch.Generator().manual_seed(0))
    seen = []

    def record(optimizer, args, kwargs):
        seen.append(([p.grad is not None for p in lora_factors(lora)],
                     [p.grad is None for p in m.parameters()]))

    opt.register_step_pre_hook(record)
    step = make_lora_train_step(m, opt, ccfg=PLAIN)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for _, _, t, noise in steps:
        step(lora, batch, t=t, noise=noise)
    assert len(seen) == 2
    for lora_grads, base_without in seen:
        assert all(lora_grads) and all(base_without)
    after = m.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for p in lora_factors(lora))  # zeroed after the step


def test_generator_draws_move_every_b_and_keep_the_config(monkeypatch):
    """The step's own draws (t, noise on the generator): the loss is finite,
    every B factor moves; the step's ``ccfg`` reaches the UNet with the
    call while the module's own config stays as it is throughout (a
    pipeline serving from the UNet on another thread keeps its routes); no
    generator and no draws raises."""
    m = _unet(junet.init_unet_params(0, J_CFG))
    saved = m.compilation_config
    routed = []
    backends = unet_2d_condition.backends

    def spy(ccfg):
        routed.append((ccfg, m.compilation_config))
        return backends(ccfg)

    monkeypatch.setattr(unet_2d_condition, "backends", spy)
    lora, opt = lora_training_setup(m, rank=RANK)
    step = make_lora_train_step(m, opt, ccfg=PLAIN)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss = step(lora, batch, torch.Generator().manual_seed(3))
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert all(f["b"].abs().max() > 0 for f in lora.values())
    assert routed == [(PLAIN, saved)]
    assert m.compilation_config is saved
    with pytest.raises(ValueError, match="generator"):
        step(lora, batch)


def _heads(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).requires_grad_(True) for _ in range(3)]


def _nhwc(n=2, hw=4, c=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, hw, hw, c), generator=g).requires_grad_(True)


def _gn_apply_inputs():
    x = _nhwc()
    mean, rstd = group_norm_stats_ref(x.detach(), groups=4)
    return x, mean, rstd, torch.ones(16), torch.zeros(16)


# kernel name (cuda_build.launch_counts) → (its plain version, its inputs)
PLAIN_VERSIONS = {
    "flash_attention": (flash_attention_ref, lambda: _heads(1, 2, 8, 8)),
    "quantize_qkv": (lambda q, k, v: tuple(kernel_inputs(q, k, v, 0.35)),
                     lambda: _heads(1, 2, 8, 8)),
    "flash_attention_int8": (flash_attention_int8_ref, lambda: _heads(1, 2, 8, 8)),
    "conv3x3": (conv3x3_block_ref,
                lambda: [_nhwc(), torch.randn(3, 3, 16, 8).requires_grad_(True)]),
    "group_norm_stats": (lambda x: group_norm_stats_ref(x, groups=4), lambda: [_nhwc()]),
    "group_norm_apply": (group_norm_apply_ref, _gn_apply_inputs),
    "group_norm_fused": (lambda x, g, b: group_norm_fused_ref(x, g, b, groups=4),
                         lambda: [_nhwc(), torch.ones(16), torch.zeros(16)]),
    "linear_geglu": (linear_geglu_fused_ref,
                     lambda: [torch.randn(4, 16, requires_grad=True),
                              torch.randn(32, 16, requires_grad=True), torch.zeros(32)]),
    "layer_norm": (layer_norm_plain,
                   lambda: [torch.randn(4, 16, requires_grad=True), torch.ones(16),
                            torch.zeros(16)]),
}


def _float_outputs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [o for o in outs if o is not None and o.is_floating_point()]


@pytest.mark.parametrize("kernel", sorted(PLAIN_VERSIONS))
def test_kernel_backward_raises(kernel):
    """Every kernel wrapper launches through ``NoBackward``: here its plain
    version is the forward, so nothing is launched.  The forward's values
    are the plain version's; the backward raises, naming the kernel, JAX's
    own limit and the configuration that trains."""
    assert set(PLAIN_VERSIONS) == set(cuda_build.launch_counts)
    plain, make_inputs = PLAIN_VERSIONS[kernel]
    inputs = make_inputs()
    out = cuda_build.NoBackward.apply(kernel, plain, *inputs)
    with torch.no_grad():
        ref = plain(*inputs)
    for got, want in zip(_float_outputs(out), _float_outputs(ref)):
        assert torch.equal(got, want)
        assert got.requires_grad
    total = sum(o.sum() for o in _float_outputs(out))
    with pytest.raises(RuntimeError, match=f"{kernel}: .*pallas_call.*enable_kernels=False"):
        total.backward()


def test_no_backward_records_only_where_autograd_would():
    """The decorator records a ``NoBackward`` node only for a tensor off
    the CPU that requires grad, with grad mode on (here on the ``meta``
    device, where the plain version runs on shapes alone); the CPU's plain
    versions keep their own gradients.  Tensors inside a tuple argument
    count, and the result keeps its structure."""
    wrapped = cuda_build.no_backward("flash_attention")(flash_attention_ref)
    q, k, v = (t.detach().to("meta").requires_grad_(True) for t in _heads(1, 2, 8, 8))
    out = wrapped(q, k, v, scale=0.5)
    assert type(out.grad_fn).__name__ == "NoBackwardBackward" and out.shape == q.shape
    with pytest.raises(RuntimeError, match="flash_attention: .*enable_kernels=False"):
        out.sum().backward()
    with torch.no_grad():
        assert wrapped(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert wrapped(q, k, v).grad_fn is None
    assert wrapped(*(t.detach() for t in (q, k, v))).grad_fn is None
    cq, ck, cv = _heads(1, 2, 8, 8)
    out = wrapped(cq, ck, cv)
    assert type(out.grad_fn).__name__ != "NoBackwardBackward"
    out.sum().backward()
    assert cq.grad is not None

    @cuda_build.no_backward("quantize_qkv")
    def pair(inputs, scale):
        return type(inputs)(inputs.q8 * scale, None)

    Pair = collections.namedtuple("Pair", "q8 vm")
    got = pair(Pair(q, None), 2.0)
    assert type(got) is Pair and got.vm is None
    assert type(got.q8.grad_fn).__name__ == "NoBackwardBackward"


def test_a_refused_backward_leaves_the_lora_and_optimizer_as_they_were(jax_run, monkeypatch):
    """The refusal met inside a train step: every attention taken as if it
    were K1 (``NoBackward`` around its plain version).  The step raises,
    takes no optimizer step, leaves no gradient and restores the config."""
    params, lora0, steps = jax_run
    attention = layers.dot_product_attention

    def as_kernel(q, k, v, **kw):
        return cuda_build.NoBackward.apply("flash_attention",
                                           lambda q, k, v: attention(q, k, v, **kw), q, k, v)

    monkeypatch.setattr(layers, "dot_product_attention", as_kernel)
    m = _unet(params)
    saved = m.compilation_config
    lora, opt = lora_training_setup(m, rank=RANK)
    before = _copy(lora)
    step = make_lora_train_step(m, opt)  # CompilationConfig.Default()
    _, _, t, noise = steps[0]
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(RuntimeError, match="flash_attention: .*enable_kernels=False"):
        step(lora, batch, t=t, noise=noise)
    assert all(torch.equal(f[k], before[mod][k]) for mod, f in lora.items() for k in ("a", "b"))
    assert all(p.grad is None for p in lora_factors(lora))
    assert not opt.state
    assert m.compilation_config is saved


# The graphed step's state handling, on the CPU.  A capture needs the card,
# so the graph path runs here with ``capture_graph`` replaced by a stand-in
# whose "replay" runs the captured function eagerly on the static inputs:
# the LoRA and the optimizer are read by address either way, so a replay
# equals an eager step exactly when the state around the warm-ups and the
# capture is put back exactly.

EAGER = CompilationConfig(enable_kernels=False, enable_cuda_graph=False)


def _state(lora, opt):
    """Copies of the factors and of AdamW's state, in the factors' order."""
    factors = lora_factors(lora)
    return ([f.detach().clone() for f in factors],
            [{k: v.clone() for k, v in opt.state.get(f, {}).items()} for f in factors])


def _assert_same_state(got, want):
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    for a, b in zip(got[1], want[1]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _setup(params):
    m = _unet(params)
    lora, opt = lora_training_setup(m, rank=RANK, generator=torch.Generator().manual_seed(0))
    return m, lora, opt


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


class _ReplayEagerly:
    """A captured graph's stand-in: ``run`` copies the inputs into the
    static ones and runs the captured function on them."""

    def __init__(self, fn, static):
        self.fn, self.static_leaves = fn, static

    def run(self, leaves):
        for s, x in zip(self.static_leaves, leaves):
            s.copy_(x)
        return self.fn().clone()


@pytest.fixture
def graph_path(monkeypatch):
    """The graphed step's path for CPU tensors; yields the names captured.
    The stand-in capture runs the warm-ups and then the function once more
    (a real capture runs nothing; the step restores the state after it
    either way)."""
    captured = []

    def capture(fn, device, static, *, warmup_calls, name, cache_size):
        assert warmup_calls == 3 and device.type == "cpu"
        for _ in range(warmup_calls + 1):
            fn()
        captured.append(name)
        return _ReplayEagerly(fn, static)

    monkeypatch.setattr(lora_trainer, "capture_graph", capture)
    monkeypatch.setattr(lora_trainer, "_on_card", lambda x: True)
    monkeypatch.setattr(lora_trainer, "_check_graphable", lambda opt, dev: None)
    return captured


@pytest.mark.parametrize("saved_after", [0, 1])
def test_restore_puts_back_the_lora_and_adamw_exactly(jax_run, saved_after):
    """State saved after ``saved_after`` steps (0: AdamW has none yet), two
    more steps, the restore: the next step equals the step taken right
    after the save, bit for bit (factors, exp_avg, exp_avg_sq, step, loss)."""
    params = jax_run[0]
    batch = _torch_batch()
    runs = []
    for detour in (False, True):
        m, lora, opt = _setup(params)
        step = make_lora_train_step(m, opt, ccfg=EAGER)
        g = torch.Generator().manual_seed(5)
        for _ in range(saved_after):
            step(lora, batch, g)
        saved = lora_trainer._save_state(lora, opt)
        if detour:
            for _ in range(2):
                step(lora, batch, torch.Generator().manual_seed(6))
            lora_trainer._restore_state(saved, lora, opt)
            if saved_after == 0:  # back to zeros, which a first AdamW step starts from
                assert all(not v.any() for f in lora_factors(lora) for v in opt.state[f].values())
        loss = step(lora, batch, g)
        runs.append((loss, _state(lora, opt)))
    (loss_a, state_a), (loss_b, state_b) = runs
    assert torch.equal(loss_a, loss_b)
    _assert_same_state(state_b, state_a)
    assert all(s["step"].item() == saved_after + 1 for s in state_b[1])


@pytest.mark.parametrize("mismatch", ["copied lora", "optimizer over half the factors"])
def test_a_lora_that_is_not_the_optimizers_raises(jax_run, mismatch):
    m, lora, opt = _setup(jax_run[0])
    if mismatch == "copied lora":
        lora = {mod: {k: f[k].detach().clone().requires_grad_(True) for k in ("a", "b")}
                for mod, f in lora.items()}
    else:
        opt = torch.optim.AdamW(lora_factors(lora)[::2])
    before = _state(lora, opt)
    with pytest.raises(ValueError, match="not the optimizer's parameters"):
        make_lora_train_step(m, opt, ccfg=PLAIN)(lora, _torch_batch(), torch.Generator())
    _assert_same_state(_state(lora, opt), before)


def test_graphed_steps_equal_eager_steps(jax_run, graph_path):
    """Three steps through the graph path from a fresh AdamW (the first
    call warms up three times and captures) equal three eager steps on
    one generator's draws, bit for bit; one capture for one signature."""
    params = jax_run[0]
    batch = _torch_batch()
    runs = []
    for ccfg in (PLAIN, EAGER):
        m, lora, opt = _setup(params)
        step = make_lora_train_step(m, opt, ccfg=ccfg)
        g = torch.Generator().manual_seed(7)
        losses = [step(lora, batch, g) for _ in range(3)]
        runs.append((losses, _state(lora, opt), step.cache_size))
    (graphed, g_state, n_graphs), (eager, e_state, n_eager) = runs
    assert graph_path == ["lora_train_step"] and (n_graphs, n_eager) == (1, 0)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
    _assert_same_state(g_state, e_state)


def test_graphed_step_hyperparameters_and_weights_version(jax_run, graph_path):
    """After the capture a float ``lr`` written into ``param_groups``
    raises (a graph keeps the value it was captured with), and so does a
    new parameter group; a tensor ``lr`` written in place is read at every
    step, and takes effect as in the eager step.  A new
    ``weights_version`` of the UNet drops the graph: the next call
    captures again."""
    params = jax_run[0]
    batch = _torch_batch()
    runs = []
    for ccfg in (PLAIN, EAGER):
        m, lora, opt = _setup(params)
        for group in opt.param_groups:
            group["lr"] = torch.tensor(group["lr"])
        step = make_lora_train_step(m, opt, ccfg=ccfg)
        g = torch.Generator().manual_seed(8)
        losses = [step(lora, batch, g)]
        opt.param_groups[0]["lr"].fill_(3e-4)
        losses.append(step(lora, batch, g))
        runs.append((losses, _state(lora, opt)))
        if ccfg is PLAIN:
            graphed = (m, lora, opt, step)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    _assert_same_state(runs[0][1], runs[1][1])

    m, lora, opt, step = graphed
    lr = opt.param_groups[0]["lr"]
    opt.param_groups[0]["lr"] = 3e-4
    with pytest.raises(ValueError, match="param_groups changed"):
        step(lora, batch, torch.Generator())
    opt.param_groups[0]["lr"] = lr
    opt.param_groups[0]["weight_decay"] = 1e-2
    with pytest.raises(ValueError, match="param_groups changed"):
        step(lora, batch, torch.Generator())
    opt.param_groups[0]["weight_decay"] = 1e-4
    step(lora, batch, torch.Generator())
    assert graph_path == ["lora_train_step"]
    bump_weights_version(m)
    step(lora, batch, torch.Generator())
    assert graph_path == ["lora_train_step"] * 2 and step.cache_size == 1


def test_graphed_refusal_caches_nothing_and_restores_the_state(jax_run, graph_path,
                                                               monkeypatch):
    """Under ``CompilationConfig.Default()`` the first warm-up's backward
    meets the refusal (every attention taken as if it were K1): the step
    raises the kernel's message, captures and caches nothing, and leaves
    the LoRA and AdamW, trained two steps before, as they were."""
    params = jax_run[0]
    m, lora, opt = _setup(params)
    batch = _torch_batch()
    trainer = make_lora_train_step(m, opt, ccfg=EAGER)
    for _ in range(2):
        trainer(lora, batch, torch.Generator().manual_seed(9))
    before = _state(lora, opt)
    attention = layers.dot_product_attention

    def as_kernel(q, k, v, **kw):
        return cuda_build.NoBackward.apply("flash_attention",
                                           lambda q, k, v: attention(q, k, v, **kw), q, k, v)

    monkeypatch.setattr(layers, "dot_product_attention", as_kernel)
    step = make_lora_train_step(m, opt)  # CompilationConfig.Default(): graphed
    with pytest.raises(RuntimeError, match="flash_attention: .*enable_kernels=False"):
        step(lora, batch, torch.Generator())
    assert step.cache_size == 0 and graph_path == []
    _assert_same_state(_state(lora, opt), before)
    assert all(p.grad is None for p in lora_factors(lora))
