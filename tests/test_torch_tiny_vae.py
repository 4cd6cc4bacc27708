"""The port's Tiny VAE (TAESD) against sfast_tpu's (CPU): decode, encode,
the state dict's names, the SD pipeline with TAESD in both VAE slots, and
the compile layer's wrapping of both methods.

Weights are JAX's (``interop.from_jax.tiny_vae_state_dict``), in f32.
Tolerances: the VAE's outputs 1e-4 relative to their scale, as the models'
(``test_torch_models.py``); the pipeline's latents 2e-3 relative and its
uint8 images 1 level, as ``test_torch_pipeline.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import autoencoder_tiny as jtiny
from sfast_tpu.models.clip_text import TINY_TEXT_ENCODER as J_TINY_TE
from sfast_tpu.models.clip_text import create_text_encoder
from sfast_tpu.models.unet_2d_condition import create_unet
from sfast_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from sfast_tpu.schedulers import DDIMScheduler as JaxDDIM
from sfast_tpu.utils import image as jimage
from sfast_tpu.utils.image import denormalize_to_uint8 as j_denormalize
import sfast_tpu_torch
from sfast_tpu_torch.compilers import CompiledModel
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    TAESD, TINY_TEST_TAESD, TINY_TEXT_ENCODER, AutoencoderTiny, CLIPTextModel,
    UNet2DConditionModel, init_tiny_vae_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.schedulers import DDIMScheduler
from tests.test_torch_compile import recorder  # noqa: F401  (a fixture)
from tests.test_torch_pipeline import J_UNET64, UNET64

F32 = dict(device="cpu", dtype=torch.float32)
CONFIGS = {"tiny": (jtiny.TINY_TEST_TAESD, TINY_TEST_TAESD),
           "taesd": (dataclasses.replace(jtiny.TAESD, dtype=jnp.float32), TAESD)}


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * np.abs(ref).max())


def _vaes(name, seed=0):
    jcfg, tcfg = CONFIGS[name]
    dec, enc = jtiny.create_tiny_vae(jcfg, jax.random.key(seed))
    tv = AutoencoderTiny(tcfg, **F32)
    tv.load_state_dict(from_jax.tiny_vae_state_dict(dec.params))
    return dec, enc, tv


@pytest.mark.parametrize("name", ["tiny", "taesd"])
def test_decode_and_encode_match_jax(name):
    dec, enc, tv = _vaes(name)
    rng = np.random.default_rng(1)
    image = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jmean, jlogvar = enc(jnp.asarray(image))
    with torch.no_grad():
        mean, logvar = tv.encode(torch.from_numpy(image))
    _close(mean, jmean, 1e-4)
    assert torch.equal(logvar, torch.full_like(mean, -30.0)) and np.all(np.asarray(jlogvar) == -30)
    sf = 2 ** (len(CONFIGS[name][1].block_out_channels) - 1)
    assert mean.shape == (2, 32 // sf, 32 // sf, 4)
    # latents well past the clamp's knee, so tanh(x / 3)·3 matters
    lat = (rng.standard_normal((2, 32 // sf, 32 // sf, 4)) * 4).astype(np.float32)
    jout = dec(jnp.asarray(lat))
    with torch.no_grad():
        out = tv.decode(torch.from_numpy(lat))
    assert out.shape == (2, 32, 32, 3)
    _close(out, jout, 1e-4)


def test_state_dict_carries_diffusers_names():
    """TAESD's indices in diffusers' ``AutoencoderTiny``: the encoder's
    stride-2 convs at 2, 6 and 10 and its last conv at 14; the decoder's
    ReLU at 1, upsamples at 5, 10 and 15 (no weights) and last conv at 18."""
    sd = AutoencoderTiny(TAESD, device="meta").state_dict()
    for key in ("encoder.layers.0.weight", "encoder.layers.1.conv.4.weight",
                "encoder.layers.2.weight", "encoder.layers.10.bias",
                "encoder.layers.14.weight", "decoder.layers.0.weight",
                "decoder.layers.2.conv.2.weight", "decoder.layers.6.weight",
                "decoder.layers.17.conv.0.bias", "decoder.layers.18.weight"):
        assert key in sd, key
    assert not any(k.startswith(("decoder.layers.1.", "decoder.layers.5.")) for k in sd)
    assert sd["encoder.layers.14.weight"].shape == (4, 64, 3, 3)
    assert sd["decoder.layers.18.weight"].shape == (3, 64, 3, 3)
    n = sum(t.numel() for t in sd.values())
    assert 2_000_000 < n < 3_000_000, n  # JAX tests/models/test_tiny_vae.py:34-38
    init_tiny_vae_weights_(AutoencoderTiny(TINY_TEST_TAESD, **F32), torch.Generator())


def _pipes():
    """(JAX pipeline, the port's compiled pipeline): tiny UNet and CLIP, the
    tiny TAESD as decoder and encoder, DDIM, as JAX's drop-in test."""
    dec, enc, tv = _vaes("tiny")
    unet = create_unet(J_UNET64, jax.random.key(1))
    te = create_text_encoder(J_TINY_TE, jax.random.key(2))
    jpipe = JaxPipeline(unet=unet, vae=dec, vae_encode=enc, text_encoder=te,
                        scheduler=JaxDDIM(), dtype=jnp.float32)
    sfast_tpu.compile(jpipe, JaxConfig(enable_pallas=False))
    tu = UNet2DConditionModel(UNET64, **F32)
    tu.load_state_dict(from_jax.unet_state_dict(unet.params))
    tt = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    tt.load_state_dict(from_jax.clip_text_state_dict(te.params))
    tpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        tu, tv, tt, DDIMScheduler(), vae_encode=tv, device="cpu", dtype=torch.float32))
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    return _pipes()


def test_pipeline_drop_in_matches_jax(pipes):
    """JAX ``tests/models/test_tiny_vae.py:40-60`` held against JAX: the
    slots need no code of their own (``vae_scale_factor`` from
    ``block_out_channels``, ``scaling_factor`` 1.0, ``compile`` wrapping
    ``decode`` and ``encode`` through ``_SLOT_METHODS``)."""
    jpipe, tpipe = pipes
    assert isinstance(tpipe.vae, CompiledModel) and tpipe.vae.method == "decode"
    assert isinstance(tpipe.vae_encode, CompiledModel) and tpipe.vae_encode.method == "encode"
    assert tpipe.vae_scale_factor == 2 and tpipe.vae.config.scaling_factor == 1.0
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_inference_steps=2, guidance_scale=7.5)
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat),
                            output_type="latent", **kw).images)
    jimg = np.asarray(j_denormalize(jpipe.vae(jnp.asarray(jlat))))
    tlat = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), output_type="latent",
                 **kw).images
    timg = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
    _close(tlat, jlat, 2e-3)
    assert timg.shape == jimg.shape == (1, 32, 32, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
    taesd = StableDiffusionPipeline(tpipe.unet, AutoencoderTiny(TAESD, device="meta"),
                                    tpipe.text_encoder, DDIMScheduler(), device="cpu")
    assert taesd.vae_scale_factor == 8


def test_img2img_with_taesd_matches_jax(pipes, monkeypatch):
    """img2img through TAESD's encode, with JAX's two draws handed in (the
    posterior's noise is scaled by exp(−15) on both sides)."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    image = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    seed = 5
    mean, _ = jpipe.vae_encode(jimage.preprocess_image(image, jnp.float32))
    _, k_enc, k_noise = jax.random.split(jax.random.key(seed), 3)
    draws = tuple(torch.tensor(np.asarray(jax.random.normal(k, mean.shape, jnp.float32)))
                  for k in (k_enc, k_noise))
    monkeypatch.setattr(tpipe, "_img2img_noise", lambda shape, s: draws)
    kw = dict(height=32, width=32, num_inference_steps=4, guidance_scale=7.5, image=image,
              strength=0.5, seed=seed, output_type="latent")
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), **kw).images)
    tlat = tpipe(prompt_ids=ids, **kw).images
    _close(tlat, jlat, 2e-3)


def test_compiled_decode_and_encode_capture_once(recorder):  # noqa: F811
    """Each slot is its own graph per signature; a second call of the same
    shape replays it, and the replay equals the eager module."""
    tv = init_tiny_vae_weights_(AutoencoderTiny(TINY_TEST_TAESD, **F32),
                                torch.Generator().manual_seed(0))

    class Pipe:
        pass

    pipe = Pipe()
    pipe.vae, pipe.vae_encode = tv, tv
    sfast_tpu_torch.compile(pipe)
    z = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    img = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.inference_mode():
        outs = [pipe.vae.decode(z) for _ in range(2)] + [pipe.vae_encode.encode(img)[0]
                                                         for _ in range(2)]
        eager = [tv.decode(z), tv.encode(img)[0]]
    assert recorder.count("capture") == 2 and pipe.vae.cache_size == pipe.vae_encode.cache_size == 1
    for got, ref in zip(outs, eager[:1] * 2 + eager[1:] * 2):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
