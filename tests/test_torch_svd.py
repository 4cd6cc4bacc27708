"""sfast_tpu_torch's Stable Video Diffusion against sfast_tpu's on the CPU:
the spatio-temporal UNet, the temporal VAE, their state-dict names, the
resize and CLIP normalization, and the image-to-video pipeline.

JAX parameters come from the JAX package's ``init_*`` functions at the
``TINY_*`` configs and reach the port through ``interop.from_jax``, which
pads the C → C → C frame-position embedding JAX draws with zeros to
diffusers' C → 4·C → C.  JAX runs jitted, on its
plain routes; the port in f32 on the CPU, where every kernel wrapper takes
its plain version.

Tolerances as ``tests/test_torch_models.py`` (models: 1e-4 relative to the
output's scale, f32 sums in another order) and
``tests/test_torch_pipeline.py`` (pipelines: latents 2e-3 relative to their
scale, uint8 frames 1 level); the resize 1e-6 relative (the same weights,
summed in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
import sfast_tpu_torch
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.interop.convert_svd import convert_svd_unet_params
from sfast_tpu.interop.convert_vae import convert_temporal_vae_params
from sfast_tpu.models import autoencoder_kl_temporal as jtvae
from sfast_tpu.models import unet_spatio_temporal as jsvd
from sfast_tpu.models.autoencoder_kl import TINY_TEST_VAE as J_TINY_VAE
from sfast_tpu.models.autoencoder_kl import create_vae
from sfast_tpu.models.clip_vision import TINY_IMAGE_ENCODER as J_TINY_ENC
from sfast_tpu.models.clip_vision import create_image_encoder
from sfast_tpu.pipelines.stable_video_diffusion import _CLIP_MEAN, _CLIP_STD
from sfast_tpu.pipelines.stable_video_diffusion import StableVideoDiffusionPipeline as JaxSVD
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    TINY_IMAGE_ENCODER, TINY_SVD_UNET, TINY_TEMPORAL_VAE, TINY_TEST_VAE, AutoencoderKL,
    AutoencoderKLTemporalDecoder, CLIPVisionModel, UNetSpatioTemporalConditionModel,
)
from sfast_tpu_torch.pipelines import StableVideoDiffusionPipeline
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.signature import call_signature
from sfast_tpu_torch.utils.image import CLIP_MEAN, CLIP_STD, clip_normalize, resize_bilinear
from tests.test_torch_compile import recorder  # noqa: F401  (a fixture)

F32 = dict(device="cpu", dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side in one thread: its ops are tiny, and under the
    suite's parallel workers a thread pool a worker spins every op over the
    machine's cores makes them hundreds of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
MODEL_TOL, PIPE_TOL, RESIZE_TOL = 1e-4, 2e-3, 1e-6
FRAMES, HW, STEPS = 4, 32, 3


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _leaves_equal(got, ref):
    """Two JAX trees with the same structure and the same f32 values."""
    gl, gs = jax.tree_util.tree_flatten(got)
    rl, rs = jax.tree_util.tree_flatten(ref)
    assert gs == rs
    for g, r in zip(gl, rl):
        np.testing.assert_array_equal(np.asarray(g, np.float32).reshape(np.shape(r)),
                                      np.asarray(r, np.float32))


@pytest.fixture(scope="module")
def unets():
    """(JAX params, the port's UNet with them)."""
    params = jsvd.init_svd_unet_params(jax.random.key(1), jsvd.TINY_SVD_UNET)
    m = UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32)
    m.load_state_dict(from_jax.svd_unet_state_dict(params))
    return params, m


@pytest.fixture(scope="module")
def vaes():
    params = jtvae.init_temporal_vae_params(jax.random.key(0), jtvae.TINY_TEMPORAL_VAE)
    m = AutoencoderKLTemporalDecoder(TINY_TEMPORAL_VAE, **F32)
    m.load_state_dict(from_jax.temporal_vae_state_dict(params))
    return params, m


@functools.lru_cache(maxsize=None)
def _jax_unet():
    return jax.jit(functools.partial(jsvd.svd_unet_fwd, jsvd.TINY_SVD_UNET, JAX_CCFG))


@pytest.mark.parametrize("frames", ["in order", "reversed"])
def test_svd_unet_matches_jax(unets, frames):
    """Both UNets on 2 videos of 4 frames, and with the frames reversed:
    the temporal layers look across frames, so the output of the reversed
    video is not the reversed output."""
    params, m = unets
    x = _randn(0, 2, FRAMES, 16, 16, 8)
    if frames == "reversed":
        x = x[:, ::-1].copy()
    t = np.array([0.5, -1.2], np.float32)
    ctx, ids = _randn(1, 2, 1, 32), np.array([[6, 127, 0.02], [9, 40, 0.1]], np.float32)
    ref = _jax_unet()(params, *map(jnp.asarray, (x, t, ctx, ids)))
    with torch.no_grad():
        got = m(*map(torch.tensor, (x, t, ctx, ids)))
    assert got.shape == (2, FRAMES, 16, 16, 4)
    _close(got, ref, MODEL_TOL)
    if frames == "reversed":
        with torch.no_grad():
            straight = m(torch.tensor(x[:, ::-1].copy()), *map(torch.tensor, (t, ctx, ids)))
        assert (got - straight.flip(1)).abs().max() > 1e-3 * got.abs().max()


@pytest.mark.parametrize("num_frames", [2, 4])
def test_temporal_vae_decode_matches_jax(vaes, num_frames):
    params, m = vaes
    z = _randn(2, 4, 8, 8, 4)
    ref = jax.jit(functools.partial(jtvae.temporal_vae_decode_fwd, jtvae.TINY_TEMPORAL_VAE,
                                    JAX_CCFG, num_frames=num_frames))(params, jnp.asarray(z))
    with torch.no_grad():
        got = m.decode(torch.tensor(z), num_frames=num_frames)
    assert got.shape == (4, 16, 16, 3)
    _close(got, ref, MODEL_TOL)


def test_temporal_vae_encode_matches_jax(vaes):
    params, m = vaes
    img = _randn(3, 2, 16, 16, 3)
    ref = jax.jit(functools.partial(jtvae.temporal_vae_encode_fwd, jtvae.TINY_TEMPORAL_VAE,
                                    JAX_CCFG))(params, jnp.asarray(img))
    with torch.no_grad():
        got = m.encode(torch.tensor(img))
    for g, r in zip(got, ref):
        _close(g, r, MODEL_TOL)
    with pytest.raises(ValueError, match="not videos of 3 frames"):
        m.decode(torch.zeros(4, 8, 8, 4), num_frames=3)


def _jax_width_time_pos_embed(sd):
    """``sd`` with each frame-position embedding trimmed back from
    diffusers' 4·C inner width to JAX's C, the padding checked to be zeros."""
    sd = dict(sd)
    for key in [k for k in sd if k.endswith("time_pos_embed.linear_2.weight")]:
        pre = key[: -len("linear_2.weight")]
        c = sd[key].shape[0]
        w1, b1, w2 = sd[pre + "linear_1.weight"], sd[pre + "linear_1.bias"], sd[key]
        assert w1.shape == (4 * c, c) and w2.shape == (c, 4 * c)
        assert not (w1[c:].any() or b1[c:].any() or w2[:, c:].any())
        sd[pre + "linear_1.weight"], sd[pre + "linear_1.bias"] = w1[:c], b1[:c]
        sd[key] = w2[:, :c]
    return sd


@pytest.mark.parametrize("model", ["unet", "vae"])
def test_state_dict_names_round_trip_through_jax_converters(unets, vaes, model):
    """The port's own state dict, read by JAX's diffusers converters, gives
    back the JAX tree: the port carries diffusers' names and layouts (the
    frame-position embeddings trimmed back to JAX's width)."""
    if model == "unet":
        params, m = unets
        back = convert_svd_unet_params(_jax_width_time_pos_embed(m.state_dict()),
                                       jsvd.TINY_SVD_UNET)
    else:
        params, m = vaes
        back = convert_temporal_vae_params(m.state_dict(), jtvae.TINY_TEMPORAL_VAE)
        assert not any(k.startswith("post_quant_conv") for k in m.state_dict())
    _leaves_equal(back, params)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    conv = next(k for k in shapes if k.endswith("temporal_res_block.conv1.weight"))
    assert shapes[conv][2:] == (3, 1, 1) and shapes[conv][0] == shapes[conv][1]
    assert all(shapes[k] == (1,) for k in shapes if k.endswith("time_mixer.mix_factor"))


def test_diffusers_time_pos_embed_width():
    """The frame-position embedding is diffusers' C → 4·C → C."""
    m = UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32)
    emb = m.down_blocks[0].attentions[0].time_pos_embed
    assert tuple(emb.linear_1.weight.shape) == (128, 32)
    assert tuple(emb.linear_2.weight.shape) == (32, 128)


@pytest.mark.parametrize("hw, to", [((48, 80), (32, 32)), ((32, 32), (48, 80)),
                                    ((72, 128), (28, 28))])
def test_resize_and_clip_normalize_match_jax(hw, to):
    """Downsampling antialiases, as ``jax.image.resize``'s 'bilinear' does;
    upsampling interpolates."""
    x = np.random.default_rng(4).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *to, 3), "bilinear")
    got = resize_bilinear(torch.tensor(x), *to)
    _close(got, ref, RESIZE_TOL)
    np.testing.assert_array_equal(np.float32(CLIP_MEAN), _CLIP_MEAN)
    np.testing.assert_array_equal(np.float32(CLIP_STD), _CLIP_STD)
    _close(clip_normalize(got), (np.asarray(ref) - _CLIP_MEAN) / _CLIP_STD, RESIZE_TOL)


def test_signature_keys_video_shapes_and_int_keywords():
    """A 5-D input keys its graph by its frame count, an int keyword (the
    temporal decode's ``num_frames``) by its value."""
    a = torch.zeros(2, 4, 8, 8, 8)
    key = call_signature((a,), {"num_frames": 4})
    assert key == call_signature((torch.ones(2, 4, 8, 8, 8),), {"num_frames": 4})
    assert key != call_signature((torch.zeros(2, 3, 8, 8, 8),), {"num_frames": 4})
    assert key != call_signature((a,), {"num_frames": 2})


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)


def _jax_draws(seed, num_frames):
    """JAX's augmentation noise and initial latents of ``seed``, as its
    pipeline splits the key (``prepare_conditioning``, ``__call__``)."""
    key, k_aug = jax.random.split(jax.random.key(seed))
    aug = jax.random.normal(k_aug, (1, HW, HW, 3), jnp.float32)
    _, k_lat = jax.random.split(key)
    lat = jax.random.normal(k_lat, (1, num_frames, HW // 2, HW // 2, 4), jnp.float32)
    return np.array(aug), np.array(lat)


def negate_output_(unet):
    """``unet`` with ``conv_out``'s weight and bias negated in place, so its
    output is the negative of the loaded weights' bit for bit: the port's
    EDM step takes SVD's v-prediction c_out, the negative of ``sfast_tpu``'s
    Karras c_out, so the port then steps as JAX does."""
    with torch.no_grad():
        unet.conv_out.weight.neg_()
        unet.conv_out.bias.neg_()
    return unet


@pytest.fixture(scope="module")
def svd_pipes():
    """(JAX pipeline, the port's compiled pipeline) over one set of tiny f32
    weights, the temporal VAE in the vae slot; then the same UNet and image
    encoder (JAX's compiled, the port's modules) with a standard KL VAE.
    The port's UNet has its output negated (:func:`negate_output_`)."""
    unet = jsvd.create_svd_unet(jsvd.TINY_SVD_UNET, jax.random.key(1))
    enc = create_image_encoder(J_TINY_ENC, jax.random.key(2))
    jdec, jenc = jtvae.create_temporal_vae(jtvae.TINY_TEMPORAL_VAE, jax.random.key(0))
    jpipe = sfast_tpu.compile(JaxSVD(unet=unet, vae=jdec, vae_encode=jenc, image_encoder=enc,
                                     dtype=jnp.float32), JAX_CCFG)
    tu = UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32)
    tu.load_state_dict(from_jax.svd_unet_state_dict(unet.params))
    negate_output_(tu)
    te = CLIPVisionModel(TINY_IMAGE_ENCODER, **F32)
    te.load_state_dict(from_jax.clip_vision_state_dict(enc.params))
    tv = AutoencoderKLTemporalDecoder(TINY_TEMPORAL_VAE, **F32)
    tv.load_state_dict(from_jax.temporal_vae_state_dict(jdec.params))
    tpipe = sfast_tpu_torch.compile(StableVideoDiffusionPipeline(
        tu, tv, te, device="cpu", dtype=torch.float32))

    sdec, senc = create_vae(J_TINY_VAE, jax.random.key(0))
    jstd = sfast_tpu.compile(JaxSVD(unet=jpipe.unet, vae=sdec, vae_encode=senc,
                                    image_encoder=jpipe.image_encoder, dtype=jnp.float32),
                             JAX_CCFG)
    sv = AutoencoderKL(TINY_TEST_VAE, **F32)
    sv.load_state_dict(from_jax.vae_state_dict(sdec.params))
    tstd = sfast_tpu_torch.compile(StableVideoDiffusionPipeline(
        tu, sv, te, device="cpu", dtype=torch.float32))
    return (jpipe, tpipe), (jstd, tstd)


def _both(jpipe, tpipe, otypes=("latent", "np"), seed=3, **kw):
    """The outputs of both pipelines with JAX's draws: latents, then uint8
    frames."""
    aug, lat = _jax_draws(seed, FRAMES)
    kw = dict(num_frames=FRAMES, height=HW, width=HW, num_inference_steps=STEPS,
              seed=seed, **kw)
    out = {}
    for otype in otypes:
        ref = jpipe(_image(), **kw, output_type=otype).images
        got = tpipe(_image(), **kw, output_type=otype, latents=lat, aug_noise=aug).images
        out[otype] = (np.asarray(got, np.float32), np.asarray(ref, np.float32))
    return out


def _check(out):
    if "latent" in out:
        got, ref = out["latent"]
        assert got.shape == (1, FRAMES, HW // 2, HW // 2, 4)
        _close(got, ref, PIPE_TOL)
    got, ref = out["np"]
    assert got.shape == (1, FRAMES, HW, HW, 3)
    assert np.abs(got - ref).max() <= 1


def test_svd_pipeline_stepwise_matches_jax(svd_pipes):
    """The stepwise loop at a second guidance range and motion bucket; the
    clip decoded in chunks of 3 frames (3 + 1 of 4): each chunk is a video
    of its own frames, in both."""
    _check(_both(*svd_pipes[0], decode_chunk_size=3, motion_bucket_id=60,
                 min_guidance_scale=1.5, max_guidance_scale=4.0))


def test_svd_pipeline_fused_loop_matches_jax_fori_loop(svd_pipes):
    """The fused loop against JAX's ``fori_loop``, the clip decoded whole."""
    pipes = svd_pipes[0]
    for p in pipes:
        p.set_compilation_config(p._ccfg.replace(fuse_denoising_loop=True))
    try:
        _check(_both(*pipes, seed=5))
        assert (STEPS, FRAMES) in pipes[1]._fused_loops
    finally:
        for p in pipes:
            p.set_compilation_config(p._ccfg.replace(fuse_denoising_loop=False))


def test_svd_pipeline_standard_kl_decoder_matches_jax(svd_pipes):
    """A standard AutoencoderKL in the vae slot decodes frame by frame."""
    _check(_both(*svd_pipes[1], otypes=("np",), decode_chunk_size=2))


def test_new_guidance_fps_and_motion_capture_nothing(svd_pipes, recorder):
    """With capture replaced by a recorder: a second guidance range, fps
    and motion bucket reach the graphs as inputs, so neither the stepwise
    graphs nor the fused loop capture again; a new frame count does."""
    tpipe = svd_pipes[0][1]
    kw = dict(num_frames=FRAMES, height=HW, width=HW, num_inference_steps=1)

    def sizes():
        return {n: c for n, c in global_executable_cache().stats().items()
                if n.startswith(("svd_", "unet", "vae", "image_encoder", "scheduler"))}

    for fused in (False, True):
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
        tpipe(_image(), **kw)
        before = sizes()
        other = tpipe(_image(), **kw, min_guidance_scale=2.0, max_guidance_scale=6.0, fps=12,
                      motion_bucket_id=30).images
        assert sizes() == before and other.shape == (1, FRAMES, HW, HW, 3)
        assert before.get("svd_denoise_loop_1_f4", 0) == int(fused)
        assert before["svd_decode_u8"] == 1 and before["image_encoder"] == 1
    tpipe(_image(), **dict(kw, num_frames=2))
    assert sizes()["svd_denoise_loop_1_f2"] == 1
    tpipe.set_compilation_config(CompilationConfig())
