"""sfast_tpu_torch's DPM-Solver++ (2M) against sfast_tpu's on the CPU.

Tables (timesteps, sigmas) are host numpy on both sides and must agree
exactly or to f32 rounding.  Steps are fed the same seeded numpy model
outputs; both sides compute in f32, JAX with f32 device scalars and the
port with f32 numpy scalars, so 5 steps agree to ~1e-6 relative (bound
1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from sfast_tpu.schedulers import SchedulerConfig as JaxSchedulerConfig
from sfast_tpu.schedulers import common as jcommon
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler, SchedulerConfig
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
