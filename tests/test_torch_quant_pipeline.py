"""The port's ``quantize_pipeline`` (W8A16, dynamic and static W8A8, with
and without convs) against sfast_tpu's on the tiny SD pipeline (CPU); with
a ControlNet in ``test_torch_quant_controlnet.py``.

Helpers and tolerances are ``tests/test_torch_quant.py``'s: W8A16 latents
within the pipeline tolerance, W8A8 latents within 0.15 relative rms (its
module docstring says why); with dynamic W8A8 and convs every quantized
site of the UNet, on the activations of the pipeline's first eval, within
1e-6 of JAX's; with a calibration, each site's ``a_scale`` within 1e-5
relative of JAX's.
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
from tests.test_torch_quant import _one_torch_thread  # noqa: F401  (a fixture)
from tests.test_torch_quant import (
    CAL_TOL, PIPE_TOL, W8A8_PIPE_RMS, _a_scales_match_jax, _close, _port_sites, _rel_rms, _rng,
    _sd_draws, _sites_match_jax,
)
import sfast_tpu
from sfast_tpu.config import CompilationConfig as JaxConfig
from tests.test_torch_pipeline import tiny_pipes

JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)


def _jax_compiled(jpipe):
    return sfast_tpu.compile(jpipe, JAX_CCFG)


MODES = {"w8a16": dict(mode="w8a16"), "w8a8": dict(mode="w8a8"),
         "w8a8 convs": dict(mode="w8a8", quantize_convs=True),
         "static convs": dict(mode="w8a8", quantize_convs=True)}


@pytest.mark.parametrize("mode", MODES)
def test_quantize_pipeline_matches_jax(mode):
    jpipe, tpipe = tiny_pipes()
    _jax_compiled(jpipe)
    rng = _rng(12)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    kw = dict(**MODES[mode])
    jkw = dict(kw)
    if mode.startswith("static"):
        draws = _sd_draws(1, 4, (2, 16, 16, 4))
        jkw["act_scales"] = jcal.calibrate_pipeline(jpipe, jnp.asarray(ids), height=32,
                                                    width=32, seed=1)
        kw["act_scales"] = tcal.calibrate_pipeline(tpipe, ids, height=32, width=32,
                                                   latents=draws)
    p = jpipe.unet.params
    jdq.quantize_pipeline(jpipe, **jkw)
    assert tdq.quantize_pipeline(tpipe, **kw) is tpipe
    run = dict(height=32, width=32, num_inference_steps=2, guidance_scale=7.5,
               output_type="latent")
    ref = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat), **run).images)
    m, out = tpipe.unet.module, []

    def call():
        out.append(tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **run))

    if mode == "w8a8 convs":
        seen = _sites_match_jax(m, jpipe.unet.params, p, from_jax.unet_state_dict, call)
        assert len(seen) == len(_port_sites(m, "w_q8"))
    else:
        call()
    if "act_scales" in kw:  # the two calibrations differ by rounding
        _a_scales_match_jax(m, jpipe.unet.params, p, tol=CAL_TOL)
    assert _port_sites(m, "w_q" if mode == "w8a16" else "w_q8")
    got = out[0].images
    if mode == "w8a16":
        _close(got, ref, PIPE_TOL)
    else:
        assert _rel_rms(got, ref) < W8A8_PIPE_RMS


def test_quantize_pipeline_errors():
    _, tpipe = tiny_pipes()
    with pytest.raises(ValueError, match="quantize_convs requires"):
        tdq.quantize_pipeline(tpipe, mode="w8a16", quantize_convs=True)
    with pytest.raises(ValueError, match="no controlnet"):
        tdq.quantize_pipeline(tpipe, quantize_controlnet=True)
    with pytest.raises(ValueError, match="w4"):
        tdq.quantize_pipeline(tpipe, mode="w4")


