"""The port's activation-range calibrations (``quant/calibrate.py``)
against sfast_tpu's (CPU): SD, SDXL and SVD (the ControlNet's is in
``test_torch_quant_controlnet.py``).

Helpers and tolerances are ``tests/test_torch_quant.py``'s: the site sets
equal, each amax within 1e-5 relative.  JAX's draws reach the port through
``latents=`` (and SVD's augmentation noise through ``aug_noise=``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sfast_tpu.quant import calibrate as jcal
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.quant import calibrate as tcal
from tests.test_torch_quant import _one_torch_thread  # noqa: F401  (a fixture)
from tests.test_torch_quant import CAL_TOL, _rng, _sd_draws
from tests.test_torch_pipeline import tiny_pipes
from tests.test_torch_sdxl import _pipes as sdxl_pipes
from tests.test_torch_svd import _jax_draws as svd_jax_draws
from tests.test_torch_svd import svd_pipes  # noqa: F401  (a fixture)




def _cal_equal(ours, jax_cal, params, writer=from_jax.unet_state_dict):
    ref = from_jax.calibration_from_jax(jax_cal, params, writer)
    assert ours.amax and sorted(ours.amax) == sorted(ref.amax)
    for k, v in ref.amax.items():
        assert abs(ours.amax[k] - v) <= CAL_TOL * v, (k, ours.amax[k], v)
    assert ours.scale_for(k) == max(ours.amax[k], 1e-6) / 127.0 and ours.scale_for("x") is None


def test_calibrate_pipeline_matches_jax():
    jpipe, tpipe = tiny_pipes()
    ids = _rng(8).integers(0, 1000, (1, 77)).astype(np.int32)
    ts = (999, 500, 10)
    jc = jcal.calibrate_pipeline(jpipe, jnp.asarray(ids), height=32, width=32, timesteps=ts,
                                 seed=4)
    ours = tcal.calibrate_pipeline(tpipe, ids, height=32, width=32, timesteps=ts,
                                   latents=_sd_draws(4, 3, (2, 16, 16, 4)))
    _cal_equal(ours, jc, jpipe.unet.params)
    # the GEGLU proj is no calibration site; every other linear the UNet calls is
    assert not any(k.endswith("net.0.proj") for k in ours.amax)
    assert any(k.endswith("time_embedding.linear_1") for k in ours.amax)


def test_calibrate_sdxl_pipeline_matches_jax():
    jpipe, tpipe = sdxl_pipes()
    ids = _rng(9).integers(0, 1000, (1, 77)).astype(np.int32)
    ts = (999, 400)
    jc = jcal.calibrate_pipeline(jpipe, jnp.asarray(ids), height=32, width=32, timesteps=ts,
                                 seed=5)
    ours = tcal.calibrate_pipeline(tpipe, ids, height=32, width=32, timesteps=ts,
                                   latents=_sd_draws(5, 2, (2, 16, 16, 4)))
    _cal_equal(ours, jc, jpipe.unet.params)
    assert any(k.startswith("add_embedding") for k in ours.amax)


def test_calibrate_svd_pipeline_matches_jax(svd_pipes):  # noqa: F811
    (jpipe, tpipe), _ = svd_pipes
    frames, seed, idx = 4, 7, (0, 2)
    image = _rng(11).integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    kw = dict(num_frames=frames, height=32, width=32, num_inference_steps=3, step_indices=idx)
    jc = jcal.calibrate_svd_pipeline(jpipe, image, seed=seed, **kw)
    aug, _ = svd_jax_draws(seed, frames)
    key, _ = jax.random.split(jax.random.key(seed))  # the key prepare_conditioning returns
    draws = []
    for _ in idx:
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (1, frames, 16, 16, 4), jnp.float32)))
    ours = tcal.calibrate_svd_pipeline(tpipe, image, aug_noise=aug, latents=draws, **kw)
    _cal_equal(ours, jc, jpipe.unet.params, from_jax.svd_unet_state_dict)
    assert any(k.endswith("temporal_res_block.conv1") for k in ours.amax)


