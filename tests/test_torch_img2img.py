"""The port's VAE encoder, image preprocessing, img2img and inpainting
against sfast_tpu's (CPU).

The tiny models share weights (``interop.from_jax``); JAX's own noise draws
(``stable_diffusion.py:752-771``) reach the port through its draw method,
so both pipelines start from the same numbers.  Tolerances: the encoder
1e-4 relative to its output's scale, as the other models
(``test_torch_models.py``); latents 2e-3 of their scale and uint8 images 1
level, as the text2img pipeline test (``test_torch_pipeline.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import autoencoder_kl as jvae
from sfast_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from sfast_tpu.schedulers import common as jcommon
from sfast_tpu.utils import image as jimage
from sfast_tpu.utils.image import denormalize_to_uint8 as j_denormalize
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.compilers import CompiledModel
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import TINY_TEST_VAE, AutoencoderKL
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler, common
from sfast_tpu_torch.utils import image as timage
from tests.test_torch_pipeline import tiny_pipes

F32 = dict(device="cpu", dtype=torch.float32)
HW = 32  # the tiny VAE halves: 16² latents
STEPS = 5


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipes()


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the VAE encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 18, 26)], ids=["16x16", "18x26"])
def test_tiny_vae_encoder_matches_jax(shape):
    """Mean and logvar.  At 18×26 the latent grid is 9×13: each
    downsampler window starts at an even pixel and the pad is one row and
    column at the bottom and right only; symmetric padding would shift
    every window by a pixel."""
    p = jvae.init_vae_params(1, jvae.TINY_TEST_VAE)
    m = AutoencoderKL(TINY_TEST_VAE, **F32)
    m.load_state_dict(from_jax.vae_state_dict(p))
    x = np.random.default_rng(2).uniform(-1, 1, shape + (3,)).astype(np.float32)
    ref_mean, ref_logvar = jvae.vae_encode_fwd(
        jvae.TINY_TEST_VAE, JaxConfig(), jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    with torch.no_grad():
        mean, logvar = m.encode(torch.from_numpy(x))
    assert mean.shape == (shape[0], shape[1] // 2, shape[2] // 2, 4)
    _close(mean, ref_mean, 1e-4)
    _close(logvar, ref_logvar, 1e-4)


def test_encoder_logvar_is_clamped():
    m = AutoencoderKL(TINY_TEST_VAE, **F32)
    with torch.no_grad():
        m.quant_conv.bias[4:] = torch.tensor([-100.0, 100.0, 0.0, 5.0])
        _, logvar = m.encode(torch.zeros(1, 8, 8, 3))
    assert logvar.min().item() == -30.0 and logvar.max().item() == 20.0


# ---------------------------------------------------------------------------
# image and mask preprocessing (exact)
# ---------------------------------------------------------------------------


def _images():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    return {
        "uint8 batch": u8,
        "PIL": Image.fromarray(u8[0]),
        "list of PIL": [Image.fromarray(u8[0]), Image.fromarray(u8[1])],
        "float batch": rng.uniform(-1, 1, (2, 8, 12, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_images()))
def test_preprocess_image_matches_jax(name):
    img = _images()[name]
    got = timage.preprocess_image(img)
    ref = np.asarray(jimage.preprocess_image(img))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _masks():
    rng = np.random.default_rng(4)
    hw = rng.integers(0, 256, (24, 20), dtype=np.uint8)
    rgba = np.zeros((24, 20, 4), np.uint8)
    rgba[..., 3] = 255  # opaque: alpha must not count as repaint
    rgba[:, 10:, 0] = 255
    return {
        "(H,W) uint8": hw,
        "(B,H,W) uint8": rng.integers(0, 256, (2, 24, 20), dtype=np.uint8),
        "(H,W,3) float": rng.uniform(0, 1, (24, 20, 3)).astype(np.float32),
        "(B,H,W,1) float": rng.uniform(0, 1, (2, 24, 20, 1)).astype(np.float32),
        "RGBA": rgba,
        "PIL L": Image.fromarray(hw),
    }


@pytest.mark.parametrize("name", list(_masks()))
@pytest.mark.parametrize("lh,lw", [(3, 5), (12, 10)])
def test_preprocess_mask_image_matches_jax(name, lh, lw):
    mask = _masks()[name]
    got = timage.preprocess_mask_image(mask, lh, lw)
    ref = np.asarray(jimage.preprocess_mask_image(mask, lh, lw))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "RGBA":  # the red right half is repaint (0), the rest kept
        assert (got[..., : lw // 2, 0] == 1).all() and (got[..., -1, 0] == 0).all()


# ---------------------------------------------------------------------------
# forward diffusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", [0, 1, 17, 49])
def test_dpm_add_noise_matches_jax(i):
    rng = np.random.default_rng(i)
    x0, noise = (rng.standard_normal((1, 4, 4, 4)).astype(np.float32) for _ in range(2))
    jsched = JaxDPM()
    ref = np.asarray(jsched.add_noise(jsched.set_timesteps(50), jnp.asarray(x0),
                                      jnp.asarray(noise), i))
    sched = DPMSolverMultistepScheduler()
    host = sched.set_timesteps(50)
    dev = sched.device_state(host, "cpu")
    args = (torch.from_numpy(x0), torch.from_numpy(noise))
    for state, idx in ((host, i), (dev, i), (dev, torch.tensor(i))):
        got = sched.add_noise(state, *args, idx)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_common_add_noise_matches_jax():
    rng = np.random.default_rng(5)
    alpha_t = rng.uniform(0.1, 1.0, 10).astype(np.float32)
    state = {"alpha_t": alpha_t, "sigma_t": np.sqrt(1 - alpha_t**2).astype(np.float32)}
    x0, noise = (rng.standard_normal((2, 3, 3, 4)).astype(np.float32) for _ in range(2))
    for i in (0, 6):
        ref = np.asarray(jcommon.add_noise(state, jnp.asarray(x0), jnp.asarray(noise), i))
        got = common.add_noise(state, torch.from_numpy(x0), torch.from_numpy(noise),
                               torch.tensor(i))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# img2img and inpainting through the pipelines
# ---------------------------------------------------------------------------


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    image = rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
    mask = np.zeros((HW, HW), np.uint8)
    mask[:, HW // 2:] = 255  # right half repainted
    return ids, image, mask


def _jax_draws(jpipe, image, seed):
    """JAX's two img2img draws for ``seed``, as its pipeline derives them."""
    mean, _ = jpipe.vae_encode(jimage.preprocess_image(image, jnp.float32))
    _, k_enc, k_noise = jax.random.split(jax.random.key(seed), 3)
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, mean.shape, jnp.float32)))
                 for k in (k_enc, k_noise))


@pytest.mark.parametrize("inpaint", [False, True], ids=["img2img", "inpaint"])
def test_tiny_img2img_matches_jax(pipes, monkeypatch, inpaint):
    jpipe, tpipe = pipes
    ids, image, mask = _inputs(6)
    seed = 11
    draws = _jax_draws(jpipe, image, seed)
    monkeypatch.setattr(tpipe, "_img2img_noise", lambda shape, s: draws)
    kw = dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5,
              image=image, strength=0.6, mask_image=mask if inpaint else None, seed=seed)
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), output_type="latent", **kw).images)
    jimg = np.asarray(j_denormalize(jpipe.vae(jlat / jvae.TINY_TEST_VAE.scaling_factor)))
    tlat = tpipe(prompt_ids=ids, output_type="latent", **kw).images
    timg = tpipe(prompt_ids=ids, **kw).images
    _close(tlat, jlat, 2e-3)
    assert timg.shape == jimg.shape == (1, HW, HW, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
    assert tpipe.vae_encode.method == "encode" and tpipe.vae.method == "decode"


def test_inpaint_keeps_the_masked_region(pipes):
    """After the last step the kept half is the clean encoded image."""
    _, tpipe = pipes
    ids, image, mask = _inputs(7)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=3, image=image,
              seed=2, output_type="latent")
    with torch.inference_mode():
        mean, logvar = tpipe.vae_encode(timage.preprocess_image(image))
    n_enc, _ = tpipe._img2img_noise(mean.shape, 2)
    init = (mean + torch.exp(0.5 * logvar) * n_enc) * TINY_TEST_VAE.scaling_factor
    lat = tpipe(mask_image=mask, **kw).images
    free = tpipe(**kw).images
    half = HW // 4  # latent columns kept
    torch.testing.assert_close(lat[:, :, :half], init[:, :, :half], rtol=0, atol=0)
    assert not torch.allclose(lat[:, :, half:], init[:, :, half:])
    assert not torch.allclose(lat, free)


def test_img2img_first_executed_step_is_first_order(pipes):
    """Entering at step 2 of 4, DPM++ 2M takes a first-order step first
    (no history yet) and at the end (lower_order_final): both executed
    steps equal the first-order solver's."""
    _, tpipe = pipes
    ids, image, _ = _inputs(8)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=4, image=image,
              seed=3, output_type="latent")
    order2 = tpipe(**kw, strength=0.5).images
    original = tpipe.scheduler
    try:
        tpipe.scheduler = DPMSolverMultistepScheduler(solver_order=1)
        order1 = tpipe(**kw, strength=0.5).images
        tpipe.scheduler = DPMSolverMultistepScheduler(lower_order_final=False)
        order2_last = tpipe(**kw, strength=0.75).images  # enters at 1: a 2nd-order step
        tpipe.scheduler = DPMSolverMultistepScheduler(solver_order=1)
        order1_last = tpipe(**kw, strength=0.75).images
    finally:
        tpipe.scheduler = original
    torch.testing.assert_close(order2, order1, rtol=0, atol=1e-6)
    assert not torch.allclose(order2_last, order1_last)


@pytest.mark.parametrize("strength,inpaint", [(0.6, False), (1.0, True)],
                         ids=["img2img", "inpaint"])
def test_fused_loop_is_bypassed(pipes, strength, inpaint):
    """img2img entering after step 0, and inpainting at any strength, run
    the stepwise loop under ``fuse_denoising_loop``, as JAX does."""
    _, tpipe = pipes
    ids, image, mask = _inputs(9)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=3, image=image,
              strength=strength, mask_image=mask if inpaint else None, seed=4,
              output_type="latent")
    stepwise = tpipe(**kw).images
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        fused = tpipe(**kw).images
        assert not tpipe._fused_loops
        tpipe(prompt_ids=ids, height=HW, width=HW, num_inference_steps=3, image=image,
              strength=1.0, seed=4, output_type="latent")  # img2img from step 0: fused
        assert list(tpipe._fused_loops) == [(3, True, None, False)]
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    torch.testing.assert_close(fused, stepwise, rtol=0, atol=0)


def test_img2img_with_batch_buckets(pipes):
    """Padded to a bucket, the inpainted latents are the unpadded run's."""
    _, tpipe = pipes
    ids, image, mask = _inputs(10)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=2, image=image,
              mask_image=mask, seed=5, output_type="latent")
    plain = tpipe(**kw).images
    try:
        tpipe.set_compilation_config(CompilationConfig(batch_buckets=(2,)))
        padded = tpipe(**kw).images
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    assert padded.shape == plain.shape == (1, HW // 2, HW // 2, 4)
    torch.testing.assert_close(padded, plain, rtol=1e-5, atol=1e-5)


def test_img2img_errors(pipes):
    _, tpipe = pipes
    ids, image, mask = _inputs(11)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=2)
    with pytest.raises(ValueError, match="requires `image`"):
        tpipe(mask_image=mask, **kw)
    bare = StableDiffusionPipeline(tpipe.unet, tpipe.vae, tpipe.text_encoder, tpipe.scheduler,
                                   device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="no vae_encode"):
        bare(image=image, **kw)


def test_compile_wraps_the_encoder(pipes):
    """``vae_encode`` is its own compiled model over the VAE module: one
    config for both, and its graphs dropped by a config change."""
    _, tpipe = pipes
    enc, dec = tpipe.vae_encode, tpipe.vae
    assert isinstance(enc, CompiledModel) and enc.module is dec.module
    assert (enc.name, enc.method) == ("vae_encode", "encode")
    cfg = CompilationConfig(enable_kernels=False)
    try:
        tpipe.set_compilation_config(cfg)
        assert enc.compilation_config is cfg and enc.module.compilation_config is cfg
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    # the same pipeline uncompiled: the slot's encode, not its forward (the decode)
    raw = StableDiffusionPipeline(tpipe.unet.module, dec.module, tpipe.text_encoder.module,
                                  DPMSolverMultistepScheduler(), vae_encode=dec.module,
                                  device="cpu", dtype=torch.float32)
    ids, image, mask = _inputs(12)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=2, image=image,
              mask_image=mask, seed=6, output_type="latent")
    torch.testing.assert_close(raw(**kw).images, tpipe(**kw).images, rtol=0, atol=0)
