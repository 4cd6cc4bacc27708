"""LCM (LoRA-style at guidance ≤ 1, and an LCM-distilled UNet with
``time_cond_proj_dim``) and ancestral Euler through the port's pipeline
against sfast_tpu's (CPU), and the pieces they add: the guidance-scale
embedding, ``cond_proj``, the pre-drawn step noise.

The tiny pipelines share weights (``interop.from_jax``), prompt ids and
initial latents; JAX's per-step noise (its key split once a step,
``stable_diffusion.py:928-945``) reaches the port through
``_step_noise``, so both pipelines take the same numbers.  Tolerances:
modules 1e-4 of their output's scale (``test_torch_models.py``), latents
2e-3 (``test_torch_pipeline.py``); the fused loop equals the stepwise loop
to f32 rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
import sfast_tpu_torch
from sfast_tpu.models import layers as jlayers
from sfast_tpu.models.autoencoder_kl import TINY_TEST_VAE as J_TINY_VAE
from sfast_tpu.models.autoencoder_kl import create_vae
from sfast_tpu.models.clip_text import TINY_TEXT_ENCODER as J_TINY_TE
from sfast_tpu.models.clip_text import create_text_encoder
from sfast_tpu.models.unet_2d_condition import TINY_UNET as J_TINY_UNET
from sfast_tpu.models.unet_2d_condition import create_unet
from sfast_tpu.models.unet_2d_condition import unet_fwd
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from sfast_tpu.schedulers import EulerDiscreteScheduler as JaxEuler
from sfast_tpu.schedulers import LCMScheduler as JaxLCM
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    TINY_TEST_VAE, TINY_TEXT_ENCODER, TINY_UNET, AutoencoderKL, CLIPTextModel,
    UNet2DConditionModel,
)
from sfast_tpu_torch.models.layers import (
    TimestepEmbedding,
    guidance_scale_embedding,
    lcm_timestep_cond,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.schedulers import (
    DDIMScheduler,
    DPMSolverMultistepScheduler,
    EulerAncestralDiscreteScheduler,
    LCMScheduler,
)

F32 = dict(device="cpu", dtype=torch.float32)
# JAX's models jitted, on its plain routes
JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
HW = 32  # the tiny VAE halves: 16² latents
TCOND = 32  # the tiny LCM UNet's time_cond_proj_dim


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def jax_step_noise(shape, num_steps, seed, start=0, img2img=False):
    """JAX's stepwise draws for ``seed`` as the port's (N, *shape) buffer:
    from the call's key (after img2img's 3-way split), one split a step,
    the executed steps from ``start`` on."""
    key = jax.random.key(seed)
    if img2img:
        key, _, _ = jax.random.split(key, 3)
    buf = np.zeros((num_steps, *shape), np.float32)
    for i in range(start, num_steps):
        key, sub = jax.random.split(key)
        buf[i] = np.asarray(jax.random.normal(sub, shape, jnp.float32))
    return torch.from_numpy(buf)


def inject_step_noise(monkeypatch, tpipe, **kw):
    """Replace the port's draw by JAX's; returns the calls it saw."""
    calls = []

    def draw(shape, num_steps, seed):
        calls.append((tuple(shape), num_steps, seed))
        return jax_step_noise(tuple(shape), num_steps, seed, **kw)

    monkeypatch.setattr(tpipe, "_step_noise", draw)
    return calls


def make_pipes(j_unet_cfg, t_unet_cfg, jsched, tsched):
    """(JAX pipeline, the port's compiled pipeline) over one set of tiny
    f32 weights."""
    unet = create_unet(j_unet_cfg, jax.random.key(1))
    dec, enc = create_vae(J_TINY_VAE, jax.random.key(0))
    te = create_text_encoder(J_TINY_TE, jax.random.key(2))
    jpipe = sfast_tpu.compile(
        JaxPipeline(unet=unet, vae=dec, vae_encode=enc, text_encoder=te, scheduler=jsched,
                    dtype=jnp.float32), JAX_CCFG)
    tu = UNet2DConditionModel(t_unet_cfg, **F32)
    tu.load_state_dict(from_jax.unet_state_dict(unet.params))
    tv = AutoencoderKL(TINY_TEST_VAE, **F32)
    tv.load_state_dict(from_jax.vae_state_dict(dec.params))
    tt = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    tt.load_state_dict(from_jax.clip_text_state_dict(te.params))
    tpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        tu, tv, tt, tsched, vae_encode=tv, device="cpu", dtype=torch.float32))
    return jpipe, tpipe


J_UNET64 = dataclasses.replace(J_TINY_UNET, cross_attention_dim=64)
UNET64 = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
J_LCM_UNET = dataclasses.replace(J_UNET64, time_cond_proj_dim=TCOND)
LCM_UNET = dataclasses.replace(UNET64, time_cond_proj_dim=TCOND)


# ---------------------------------------------------------------------------
# the guidance embedding and cond_proj
# ---------------------------------------------------------------------------


def _arg_tol(w) -> float:
    """The embedding is sin / cos of ``1000·w·f``: an argument near 7000
    rad carries an f32 rounding of 2⁻²³·7000 ≈ 8e-4 rad, which each package
    rounds its own way (its exp of the frequencies differs by an ulp), so
    the bound is a few ulps of the largest argument."""
    return 4 * 2.0**-23 * 1000.0 * max(np.abs(np.asarray(w, np.float64)).max(), 1.0)


def _embedding_f64(w, dim):
    w = np.atleast_1d(np.asarray(w, np.float64)) * 1000.0
    half = dim // 2
    emb = w[:, None] * np.exp(np.arange(half) * (-np.log(10000.0) / (half - 1)))[None, :]
    emb = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    return np.pad(emb, [(0, 0), (0, dim % 2)])


@pytest.mark.parametrize("dim", [256, 7])
@pytest.mark.parametrize("w", [7.0, [0.0, 3.5, 11.0]], ids=["scalar", "vector"])
def test_guidance_scale_embedding_matches_jax(dim, w):
    ref = np.asarray(jlayers.guidance_scale_embedding(jnp.asarray(w, jnp.float32), dim))
    got = guidance_scale_embedding(torch.tensor(w), dim)
    assert got.shape == ref.shape == (np.size(w), dim) and got.dtype == torch.float32
    tol = _arg_tol(w)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), _embedding_f64(w, dim), rtol=0, atol=tol)
    np.testing.assert_allclose(ref, _embedding_f64(w, dim), rtol=0, atol=tol)


def test_lcm_timestep_cond_matches_jax():
    gs = 8.0
    ref = np.asarray(jlayers.lcm_timestep_cond(jnp.float32(gs), TCOND, 3))
    got = lcm_timestep_cond(torch.tensor(gs), TCOND, 3)
    assert got.shape == (3, TCOND)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_arg_tol(gs - 1.0))
    assert lcm_timestep_cond(torch.tensor(gs), None, 3) is None


def test_time_embedding_cond_proj_matches_jax():
    p = jlayers.init_time_embedding(jax.random.key(0), 32, 128, dtype=jnp.float32,
                                    cond_proj_dim=TCOND)
    m = TimestepEmbedding(32, 128, cond_proj_dim=TCOND, **F32)
    sd = {f"{n}.weight": torch.tensor(np.asarray(q["w"]).T) for n, q in p.items()}
    sd.update({f"{n}.bias": torch.tensor(np.asarray(q["b"])) for n, q in p.items() if "b" in q})
    m.load_state_dict(sd)
    assert m.cond_proj.bias is None
    rng = np.random.default_rng(0)
    t_emb, cond = (rng.standard_normal(s).astype(np.float32) for s in ((2, 32), (2, TCOND)))
    ref = np.asarray(jlayers.time_embedding_fwd(p, jnp.asarray(t_emb), jnp.asarray(cond)))
    with torch.no_grad():
        got = m(torch.from_numpy(t_emb), torch.from_numpy(cond))
        no_cond = m(torch.from_numpy(t_emb))
    _close(got, ref, 1e-4)
    assert not torch.allclose(got, no_cond)


def test_tiny_lcm_unet_matches_jax():
    """An LCM-distilled UNet: the guidance embedding through
    ``time_embedding.cond_proj``."""
    unet = create_unet(J_LCM_UNET, jax.random.key(4))
    m = UNet2DConditionModel(LCM_UNET, **F32)
    m.load_state_dict(from_jax.unet_state_dict(unet.params))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.asarray([801.0, 261.0], np.float32)
    tcond = np.asarray(jlayers.lcm_timestep_cond(jnp.float32(8.0), TCOND, 2))
    fwd = jax.jit(functools.partial(unet_fwd, J_LCM_UNET, JaxConfig(enable_pallas=False)))
    ref = np.asarray(fwd(unet.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         timestep_cond=jnp.asarray(tcond)))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                timestep_cond=torch.tensor(tcond))
    _close(got, ref, 1e-4)


# ---------------------------------------------------------------------------
# pipelines: LCM, the LCM-distilled UNet, ancestral Euler
# ---------------------------------------------------------------------------


CASES = {
    # LCM-LoRA style: a plain UNet, 4 steps at guidance 1 (no CFG)
    "lcm": (J_UNET64, UNET64, JaxLCM, LCMScheduler, 4, 1.0, (4, False, None, True)),
    # the form of SimianLuo/LCM_Dreamshaper_v7: no CFG whatever the guidance
    "lcm_distilled": (J_LCM_UNET, LCM_UNET, JaxLCM, LCMScheduler, 4, 8.0,
                      (4, False, TCOND, True)),
    "euler_ancestral": (J_UNET64, UNET64, lambda: JaxEuler(ancestral=True),
                        EulerAncestralDiscreteScheduler, 3, 7.5, (3, True, None, True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax_and_fused_equals_stepwise(monkeypatch, case):
    j_unet, t_unet, jsched, tsched, steps, gs, loop_key = CASES[case]
    jpipe, tpipe = make_pipes(j_unet, t_unet, jsched(), tsched())
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)
    if case == "euler_ancestral":  # x-space latents, as the pipeline draws them
        lat = lat * float(tsched().set_timesteps(steps)["init_noise_sigma"])
    calls = inject_step_noise(monkeypatch, tpipe)
    kw = dict(height=HW, width=HW, num_inference_steps=steps, guidance_scale=gs, seed=9,
              output_type="latent")
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat), **kw).images)
    stepwise = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
    _close(stepwise, jlat, 2e-3)
    assert calls == [((1, HW // 2, HW // 2, 4), steps, 9)]
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        fused = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
        assert list(tpipe._fused_loops) == [loop_key]
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    torch.testing.assert_close(fused, stepwise, rtol=0, atol=1e-6 * stepwise.abs().max().item())


def test_step_noise_is_seeded_per_call_and_drawn_only_when_needed(monkeypatch):
    _, tpipe = make_pipes(J_UNET64, UNET64, JaxLCM(), LCMScheduler())
    kw = dict(prompt_ids=np.ones((1, 77), np.int64), height=HW, width=HW,
              num_inference_steps=2, guidance_scale=1.0, output_type="latent")
    a, again, other = (tpipe(seed=s, **kw).images for s in (1, 1, 2))
    torch.testing.assert_close(a, again, rtol=0, atol=0)
    assert not torch.allclose(a, other)
    buf = tpipe._step_noise((1, 4, 4, 4), 3, 1)
    assert buf.shape == (3, 1, 4, 4, 4) and buf.dtype == torch.float32
    torch.testing.assert_close(buf, tpipe._step_noise((1, 4, 4, 4), 3, 1), rtol=0, atol=0)
    # the step noise is not the stream of any seed's initial latents
    first = torch.randn((1, 4, 4, 4), generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(buf[0], first)
    tpipe.scheduler = DPMSolverMultistepScheduler()
    monkeypatch.setattr(tpipe, "_step_noise", lambda *a: pytest.fail("DPM++ drew step noise"))
    tpipe(seed=1, **dict(kw, guidance_scale=7.5))


class _BareDDIM:
    """A duck-typed scheduler with neither ``device_state`` nor
    ``prepare_state``."""

    order = 1

    def __init__(self):
        self._s = DDIMScheduler()

    def set_timesteps(self, n):
        return self._s.set_timesteps(n)

    def scale_model_input(self, state, sample, i):
        return sample

    def step(self, state, model_output, i, sample):
        return self._s.step(state, model_output, i, sample)


def test_a_scheduler_without_prepare_state_runs():
    _, tpipe = make_pipes(J_UNET64, UNET64, JaxLCM(), DDIMScheduler())
    kw = dict(prompt_ids=np.ones((1, 77), np.int64), height=HW, width=HW,
              num_inference_steps=3, seed=4, output_type="latent")
    ref = tpipe(**kw).images
    tpipe.scheduler = _BareDDIM()
    torch.testing.assert_close(tpipe(**kw).images, ref, rtol=0, atol=0)
