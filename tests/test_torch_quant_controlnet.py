"""The port's ControlNet quantization against sfast_tpu's (CPU): the joint
UNet + ControlNet calibration and ``quantize_pipeline(quantize_controlnet=
True)`` with static W8A8 and convs, on the tiny ControlNet pipeline.

Helpers and tolerances are ``tests/test_torch_quant.py``'s: amax and each
site's ``a_scale`` within 1e-5 relative, the latents within 0.15 relative
rms; with JAX's own calibrations carried across, every ``a_scale`` equal
and every quantized site of both models within 1e-6 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.quant import calibrate as jcal
from sfast_tpu.quant import dynamic_quant as jdq
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.quant import calibrate as tcal
from sfast_tpu_torch.quant import dynamic_quant as tdq
from tests.test_torch_controlnet import tiny_cn_pipes
from tests.test_torch_quant import _one_torch_thread  # noqa: F401  (a fixture)
from tests.test_torch_quant import (
    CAL_TOL, W8A8_PIPE_RMS, _a_scales_match_jax, _port_sites, _rel_rms, _rng, _sd_draws,
    _sites_match_jax,
)
from tests.test_torch_quant_calibrate import _cal_equal


SLOTS = ("unet", "controlnet")
WRITERS = (from_jax.unet_state_dict, from_jax.controlnet_state_dict)


@pytest.fixture(scope="module")
def cn_pipes():
    jstep, _, tpipe, _ = tiny_cn_pipes()
    return jstep, tpipe


def test_calibrate_controlnet_pipeline_matches_jax(cn_pipes):
    jpipe, tpipe = cn_pipes
    rng = _rng(10)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    ctrl = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    ts = (999, 300)
    ju, jc = jcal.calibrate_controlnet_pipeline(jpipe, jnp.asarray(ids), ctrl, height=32,
                                                width=32, timesteps=ts,
                                                conditioning_scale=0.7, seed=6)
    tu, tc = tcal.calibrate_controlnet_pipeline(tpipe, ids, ctrl, height=32, width=32,
                                                timesteps=ts, conditioning_scale=0.7,
                                                latents=_sd_draws(6, 2, (2, 16, 16, 4)))
    _cal_equal(tu, ju, jpipe.unet.params)
    _cal_equal(tc, jc, jpipe.controlnet.params, from_jax.controlnet_state_dict)


def test_quantize_pipeline_with_controlnet_matches_jax(cn_pipes):
    jpipe, tpipe = cn_pipes
    rng = _rng(13)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctrl = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    ju, jc = jcal.calibrate_controlnet_pipeline(jpipe, jnp.asarray(ids), ctrl, height=32,
                                                width=32, seed=2)
    tu, tc = tcal.calibrate_controlnet_pipeline(tpipe, ids, ctrl, height=32, width=32,
                                                latents=_sd_draws(2, 4, (2, 16, 16, 4)))
    params = jpipe.unet.params, jpipe.controlnet.params
    kw = dict(mode="w8a8", quantize_convs=True, quantize_controlnet=True)
    jdq.quantize_pipeline(jpipe, act_scales=ju, controlnet_act_scales=jc, **kw)
    tdq.quantize_pipeline(tpipe, act_scales=tu, controlnet_act_scales=tc, **kw)
    for slot, p, writer in zip(SLOTS, params, WRITERS):  # each model its own calibration
        _a_scales_match_jax(getattr(tpipe, slot).module, getattr(jpipe, slot).params, p,
                            writer, tol=CAL_TOL)
    run = dict(height=32, width=32, num_inference_steps=2, guidance_scale=7.5,
               output_type="latent", control_image=ctrl, controlnet_conditioning_scale=0.8)
    ref = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat), **run).images)
    got = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **run).images
    assert _rel_rms(got, ref) < W8A8_PIPE_RMS




def test_quantized_controlnet_pipeline_sites_match_jax():
    """JAX's two calibrations carried across by ``calibration_from_jax``
    into the port's ``quantize_pipeline``: every static site of each model
    holds JAX's ``a_scale`` for that model (the ControlNet's site names
    overlap the UNet's, so a swap shows), and every quantized site of both,
    on the activations of the pipeline's first eval, is JAX's."""
    jpipe, _, tpipe, _ = tiny_cn_pipes()
    rng = _rng(18)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    ctrl = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    lat = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    cals = jcal.calibrate_controlnet_pipeline(jpipe, jnp.asarray(ids), ctrl, height=32,
                                              width=32, seed=4)
    params = jpipe.unet.params, jpipe.controlnet.params
    kw = dict(mode="w8a8", quantize_convs=True, quantize_controlnet=True)
    jdq.quantize_pipeline(jpipe, act_scales=cals[0], controlnet_act_scales=cals[1], **kw)
    ours = [from_jax.calibration_from_jax(c, p, w) for c, p, w in zip(cals, params, WRITERS)]
    tdq.quantize_pipeline(tpipe, act_scales=ours[0], controlnet_act_scales=ours[1], **kw)
    run = dict(prompt_ids=ids, latents=lat, height=32, width=32, num_inference_steps=2,
               guidance_scale=7.5, output_type="latent", control_image=ctrl,
               controlnet_conditioning_scale=0.8)
    for slot, p, writer in zip(SLOTS, params, WRITERS):
        m, jp = getattr(tpipe, slot).module, getattr(jpipe, slot).params
        _a_scales_match_jax(m, jp, p, writer)
        seen = _sites_match_jax(m, jp, p, writer, lambda: tpipe(**run))
        assert len(seen) == len(_port_sites(m, "w_q8"))
