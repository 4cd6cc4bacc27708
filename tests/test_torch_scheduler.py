"""sfast_tpu_torch's schedulers against sfast_tpu's on the CPU: DPM-Solver++
(2M), Euler (with Karras sigmas, and ancestral), DDIM, EDM Euler and LCM.

Tables (timesteps, sigmas) are host numpy on both sides and must agree
exactly or to f32 rounding.  Steps are fed the same seeded numpy model
outputs; both sides compute in f32, JAX with f32 device scalars and the
port with f32 numpy scalars, so 5 steps agree to ~1e-6 relative (bound
1e-5).  Ancestral Euler and LCM take JAX's own noise draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.schedulers import DDIMScheduler as JaxDDIM
from sfast_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from sfast_tpu.schedulers import EulerDiscreteScheduler as JaxEuler
from sfast_tpu.schedulers import LCMScheduler as JaxLCM
from sfast_tpu.schedulers import SchedulerConfig as JaxSchedulerConfig
from sfast_tpu.schedulers import common as jcommon
from sfast_tpu.schedulers.edm_euler import EDMEulerScheduler as JaxEDM
from sfast_tpu_torch.schedulers import (
    DDIMScheduler,
    DPMSolverMultistepScheduler,
    EDMEulerScheduler,
    EulerAncestralDiscreteScheduler,
    EulerDiscreteScheduler,
    LCMScheduler,
    SchedulerConfig,
)
from sfast_tpu_torch.schedulers import common

CONFIGS = [
    {},
    {"use_karras_sigmas": True},
    {"timestep_spacing": "trailing"},
    {"prediction_type": "v_prediction"},
]


def _pair(kw):
    return DPMSolverMultistepScheduler(SchedulerConfig(**kw)), JaxDPM(JaxSchedulerConfig(**kw))


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("num_steps", [5, 50])
def test_dpm_tables_match_jax(kw, num_steps):
    ours, theirs = _pair(kw)
    a, b = ours.set_timesteps(num_steps), theirs.set_timesteps(num_steps)
    np.testing.assert_array_equal(a["timesteps"], np.asarray(b["timesteps"]))
    np.testing.assert_array_equal(a["sigmas"], np.asarray(b["sigmas"]))
    assert a["num_steps"] == b["num_steps"] == num_steps
    assert len(a["sigmas"]) == num_steps + 1


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_common_tables_match_jax(schedule, spacing):
    cfg = SchedulerConfig(beta_schedule=schedule, timestep_spacing=spacing)
    jcfg = JaxSchedulerConfig(beta_schedule=schedule, timestep_spacing=spacing)
    np.testing.assert_array_equal(common.alphas_cumprod(cfg), jcommon.alphas_cumprod(jcfg))
    np.testing.assert_array_equal(
        common.select_timesteps(cfg, 20), jcommon.select_timesteps(jcfg, 20)
    )
    sig = np.linspace(0.03, 14.6, 20)
    np.testing.assert_array_equal(common.karras_respace(sig, 20), jcommon.karras_respace(sig, 20))


@pytest.mark.parametrize("kw", CONFIGS)
def test_dpm_five_steps_match_jax(kw):
    ours, theirs = _pair(kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((5, 2, 8, 8, 4)).astype(np.float32)
    st, jst = ours.set_timesteps(5), theirs.set_timesteps(5)
    jst = theirs.prepare_state(jst, jnp.asarray(x))
    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    for i in range(5):
        xt, st = ours.step(st, torch.from_numpy(eps[i]), i, xt)
        jx, jst = theirs.step(jst, jnp.asarray(eps[i]), i, jx)
        ref = np.asarray(jx)
        np.testing.assert_allclose(
            xt.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=f"step {i}"
        )


def test_dpm_order_selection():
    """First order on the first executed step and on the last; second
    order in between — the second-order update differs."""
    sch = DPMSolverMultistepScheduler()
    st = sch.set_timesteps(4)
    x = torch.ones(1, 2, 2, 4)
    x1, st1 = sch.step(st, torch.zeros_like(x), 0, x)
    assert st1["has_history"] and st["has_history"] is False
    second, _ = sch.step(st1, torch.full_like(x, 0.5), 1, x1)
    first, _ = sch.step(dict(st1, has_history=False), torch.full_like(x, 0.5), 1, x1)
    assert not torch.allclose(second, first)
    last_a, _ = sch.step(dict(st1, has_history=True), torch.full_like(x, 0.5), 3, x1)
    last_b, _ = sch.step(dict(st1, has_history=False), torch.full_like(x, 0.5), 3, x1)
    assert torch.equal(last_a, last_b)


def test_dpm_step_keeps_sample_dtype():
    sch = DPMSolverMultistepScheduler()
    st = sch.set_timesteps(3)
    x = torch.randn(1, 4, 4, 4, dtype=torch.bfloat16)
    out, _ = sch.step(st, torch.randn(1, 4, 4, 4), 0, x)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("solver_order", [1, 2])
@pytest.mark.parametrize("lower_order_final", [True, False])
def test_dpm_solver_order_matches_jax(solver_order, lower_order_final):
    """JAX's fields (``dpm.py:24-25``), through the device state and a 0-d
    step index, as the graphed pipeline runs them."""
    kw = dict(solver_order=solver_order, lower_order_final=lower_order_final)
    ours = DPMSolverMultistepScheduler(SchedulerConfig(), **kw)
    theirs = JaxDPM(JaxSchedulerConfig(), **kw)
    assert ours.order == theirs.order == 1
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((5, 2, 8, 8, 4)).astype(np.float32)
    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    st = ours.prepare_state(ours.set_timesteps(5), xt)
    jst = theirs.prepare_state(theirs.set_timesteps(5), jx)
    assert st["x0_prev"].shape == x.shape and st["has_history"].dim() == 0
    idx = torch.arange(5)
    for i in range(5):
        xt, st = ours.step(st, torch.from_numpy(eps[i]), idx[i], xt)
        jx, jst = theirs.step(jst, jnp.asarray(eps[i]), i, jx)
        ref = np.asarray(jx)
        np.testing.assert_allclose(
            xt.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=f"step {i}"
        )


def _host_step(sch, state, model_output, i, sample):
    """The step as the port computed it before its device table: host f32
    coefficients and a Python branch on the order (JAX's defaults)."""
    from sfast_tpu_torch.schedulers.dpm import _alpha_sigma

    sample, model_output = sample.float(), model_output.float()
    sig = state["sigmas"]
    a_t, st_t = _alpha_sigma(sig[i + 1])
    a_s0, st_s0 = _alpha_sigma(sig[i])
    a_s1, st_s1 = _alpha_sigma(sig[max(i - 1, 0)])
    lam_t, lam_s0, lam_s1 = (np.log(a / s) for a, s in ((a_t, st_t), (a_s0, st_s0),
                                                         (a_s1, st_s1)))
    h = lam_t - lam_s0
    x0 = (sample - float(st_s0) * model_output) / float(a_s0)
    ratio, a_phi = float(st_t / st_s0), float(a_t * np.expm1(-h))
    if not state["has_history"] or i == state["num_steps"] - 1:
        prev = ratio * sample - a_phi * x0
    else:
        r = (lam_s0 - lam_s1) / h
        d1 = (x0 - state["x0_prev"]) / float(max(r, np.float32(1e-20)))
        prev = ratio * sample - a_phi * (x0 + 0.5 * d1)
    return prev, dict(state, x0_prev=x0, has_history=True)


@pytest.mark.parametrize("num_steps", [5, 50])
def test_dpm_device_table_matches_host_form(num_steps):
    sch = DPMSolverMultistepScheduler()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    host = sch.set_timesteps(num_steps)
    dev = sch.prepare_state(sch.set_timesteps(num_steps), x)
    assert dev["table"].shape == (num_steps, 5)
    xh = xd = x
    idx = torch.arange(num_steps)
    for i in range(num_steps):
        e = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
        xh, host = _host_step(sch, host, e, i, xh)
        xd, dev = sch.step(dev, e, idx[i], xd)
        torch.testing.assert_close(xd, xh, rtol=1e-6, atol=1e-6 * xh.abs().max().item())


# ---------------------------------------------------------------------------
# Euler (and ancestral, Karras), DDIM, EDM Euler and LCM against JAX
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return SchedulerConfig(**kw), JaxSchedulerConfig(**kw)


def _schedulers(name):
    """(the port's scheduler, JAX's) of one case."""
    kind, _, variant = name.partition(":")
    kw = {"karras": {"use_karras_sigmas": True}, "v": {"prediction_type": "v_prediction"},
          "": {}}[variant]
    ours, theirs = _cfg(**kw)
    if kind == "euler":
        return EulerDiscreteScheduler(ours), JaxEuler(theirs)
    if kind == "euler_ancestral":
        return EulerAncestralDiscreteScheduler(ours), JaxEuler(theirs, ancestral=True)
    if kind == "ddim":
        return DDIMScheduler(ours), JaxDDIM(theirs)
    if kind == "edm_euler":
        return EDMEulerScheduler(), JaxEDM()
    if kind == "lcm":
        return LCMScheduler(ours), JaxLCM(theirs)
    raise ValueError(name)


SCHEDULERS = ["euler", "euler:karras", "euler:v", "euler_ancestral", "euler_ancestral:karras",
              "ddim", "ddim:v", "edm_euler", "lcm", "lcm:v"]
# the sign of the model output the port's step takes for JAX's: the port's
# EDM step is v-prediction (c_out < 0), JAX's takes Karras' c_out > 0
OUT_SIGN = {"edm_euler": -1.0}


@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_tables_match_jax(name):
    ours, theirs = _schedulers(name)
    a, b = ours.set_timesteps(5), theirs.set_timesteps(5)
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        if isinstance(v, int):
            assert a[k] == v
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v), err_msg=k)
    assert getattr(ours, "needs_noise", False) == getattr(theirs, "needs_noise", False)


@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_five_steps_match_jax(name):
    """scale_model_input and 5 steps on the same model outputs, with JAX's
    own noise draws handed to both where the scheduler takes noise."""
    ours, theirs = _schedulers(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((5, 2, 8, 8, 4)).astype(np.float32)
    st, jst = ours.device_state(ours.set_timesteps(5), "cpu"), theirs.set_timesteps(5)
    noisy = getattr(theirs, "needs_noise", False)
    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    key = jax.random.key(3)
    for i in range(5):
        np.testing.assert_allclose(
            ours.scale_model_input(st, xt, i).numpy(),
            np.asarray(theirs.scale_model_input(jst, jx, i)), rtol=1e-6, atol=1e-6)
        kw, jkw = {}, {}
        if noisy:
            key, sub = jax.random.split(key)
            jkw["noise"] = jax.random.normal(sub, x.shape, jnp.float32)
            kw["noise"] = torch.tensor(np.asarray(jkw["noise"]))
        xt, st = ours.step(st, OUT_SIGN.get(name, 1.0) * torch.from_numpy(eps[i]), i, xt, **kw)
        jx, jst = theirs.step(jst, jnp.asarray(eps[i]), i, jx, **jkw)
        ref = np.asarray(jx)
        np.testing.assert_allclose(
            xt.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=f"step {i}")


@pytest.mark.parametrize("name", SCHEDULERS)
def test_device_index_step_equals_int_index(name):
    """A 0-d device step index (one captured graph for every step) gives
    the int index's step bit for bit, the last step included."""
    ours, _ = _schedulers(name)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((4, 1, 4, 4, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((4, 1, 4, 4, 4)).astype(np.float32))
    st = ours.prepare_state(ours.device_state(ours.set_timesteps(4), "cpu"), x)
    kw = (lambda i: {"noise": noise[i]}) if getattr(ours, "needs_noise", False) else (
        lambda i: {})
    a = b = x
    for i in range(4):
        a, _ = ours.step(st, eps[i], i, a, **kw(i))
        b, _ = ours.step(st, eps[i], torch.tensor(i), b, **kw(i))
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("num_steps", [5, 25])
def test_edm_euler_steps_are_diffusers_v_prediction(num_steps):
    """The EDM step is diffusers' ``EulerDiscreteScheduler`` with
    ``prediction_type='v_prediction'`` (SVD's scheduler config):
    denoised = −σ/√(σ²+1)·out + x/(σ²+1), x ← x + (σ_next − σ)·(x −
    denoised)/σ, written out here in float64."""
    sch = EDMEulerScheduler()
    host = sch.set_timesteps(num_steps)
    st = sch.device_state(host, "cpu")
    sig = host["sigmas"].astype(np.float64)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 4, 4))
    xt = torch.from_numpy(x.astype(np.float32))
    for i in range(num_steps):
        out = rng.standard_normal(x.shape)
        den = -sig[i] / np.sqrt(sig[i] ** 2 + 1) * out + x / (sig[i] ** 2 + 1)
        x = x + (sig[i + 1] - sig[i]) * (x - den) / sig[i]
        xt, st = sch.step(st, torch.from_numpy(out.astype(np.float32)), i, xt)
        np.testing.assert_allclose(xt.numpy(), x, rtol=0, atol=1e-5 * np.abs(x).max(),
                                   err_msg=f"step {i}")


def test_lcm_last_step_is_denoised_and_others_renoised():
    sch = LCMScheduler()
    st = sch.device_state(sch.set_timesteps(4), "cpu")
    x, eps = torch.ones(1, 2, 2, 4), torch.full((1, 2, 2, 4), 0.5)
    noise = torch.full((1, 2, 2, 4), 3.0)
    for i in (torch.tensor(2), torch.tensor(3)):
        with_noise, _ = sch.step(st, eps, i, x, noise=noise)
        without, _ = sch.step(st, eps, i, x)
        assert torch.equal(with_noise, without) == (int(i) == 3)


@pytest.mark.parametrize("i", [0, 3, 49])
def test_euler_add_noise_and_init_sigma_match_jax(i):
    """img2img's entry in x-space, ``z + σ_i·noise``, and the initial
    noise scale in the state."""
    ours, theirs = _schedulers("euler")
    rng = np.random.default_rng(i)
    x0, noise = (rng.standard_normal((1, 4, 4, 4)).astype(np.float32) for _ in range(2))
    host, jst = ours.set_timesteps(50), theirs.set_timesteps(50)
    ref = np.asarray(theirs.add_noise(jst, jnp.asarray(x0), jnp.asarray(noise), i))
    dev = ours.device_state(host, "cpu")
    for state, idx in ((host, i), (dev, torch.tensor(i))):
        got = ours.add_noise(state, torch.from_numpy(x0), torch.from_numpy(noise), idx)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert float(dev["init_noise_sigma"]) == float(jst["init_noise_sigma"])
    assert dev["init_noise_sigma"].dim() == 0 and dev["sigmas"].dtype == torch.float32


def test_ddim_add_noise_is_the_vp_form():
    ours, theirs = _schedulers("ddim")
    rng = np.random.default_rng(4)
    x0, noise = (rng.standard_normal((1, 4, 4, 4)).astype(np.float32) for _ in range(2))
    jst = theirs.set_timesteps(10)
    ref = np.asarray(jcommon.add_noise(jst, jnp.asarray(x0), jnp.asarray(noise), 3))
    st = ours.device_state(ours.set_timesteps(10), "cpu")
    got = common.add_noise(st, torch.from_numpy(x0), torch.from_numpy(noise), torch.tensor(3))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
