"""sfast_tpu_torch's ControlNet against sfast_tpu's on the CPU, and the
pipeline with a ControlNet, alone and with an IP-Adapter.

The JAX ControlNet's zero-initialised convs (``controlnet_down_blocks``,
``controlnet_mid_block``, the embedding's ``conv_out``) are redrawn from a
numpy seed at the init scale, N(0, 1/fan_in) with biases N(0, 0.1²), as a
trained ControlNet's are nonzero: with zeros every residual is exactly 0
and nothing would show whether the residuals reach the UNet.  The weights
reach the port through ``interop.from_jax.controlnet_state_dict``.

Tolerances as ``tests/test_torch_models.py`` (models: 1e-4 relative to the
output's scale, f32 sums in another order) and
``tests/test_torch_pipeline.py`` (pipelines: latents 2e-3 relative to their
scale, uint8 images 1 level).  JAX runs jitted, on its plain routes.
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
from sfast_tpu import ip_adapter as jip
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import controlnet as jcn
from sfast_tpu.models import unet_2d_condition as junet
from sfast_tpu.models.autoencoder_kl import TINY_TEST_VAE as J_TINY_VAE
from sfast_tpu.models.autoencoder_kl import create_vae
from sfast_tpu.models.clip_text import TINY_TEXT_ENCODER as J_TINY_TE
from sfast_tpu.models.clip_text import create_text_encoder
from sfast_tpu.models.unet_2d_condition import create_unet
from sfast_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from sfast_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from sfast_tpu.utils.image import preprocess_control_image as j_preprocess_control
from sfast_tpu_torch import CompilationConfig, ip_adapter
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    SD15_CONTROLNET, SDXL_UNET, TINY_CONTROLNET, TINY_TEST_VAE, TINY_TEXT_ENCODER, TINY_UNET,
    AutoencoderKL, CLIPTextModel, ControlNetConfig, ControlNetModel, UNet2DConditionModel,
    init_controlnet_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler
from sfast_tpu_torch.utils.image import preprocess_control_image

F32 = dict(device="cpu", dtype=torch.float32)
JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
MODEL_TOL, PIPE_TOL = 1e-4, 2e-3
STEPS, HW = 3, 32  # the tiny VAE halves: 16² latents, one stride-2 conv in the embedding
CLIP_DIM, NUM_TOKENS = 32, 4  # the IP-Adapter's image embedding width and tokens
# the tiny text encoder is 64 wide; the UNet's cross-attention must match
J_UNET64 = dataclasses.replace(junet.TINY_UNET, cross_attention_dim=64)
UNET64 = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
J_CN64 = jcn.ControlNetConfig(unet=J_UNET64, conditioning_embedding_out_channels=(16, 32))
CN64 = ControlNetConfig(unet=UNET64, conditioning_embedding_out_channels=(16, 32))


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def jax_controlnet_params(cfg, seed):
    """``init_controlnet_params`` with its zero convs redrawn nonzero."""
    p = jcn.init_controlnet_params(seed, cfg)
    rng = np.random.default_rng(seed + 100)

    def draw(conv):
        w = np.asarray(conv["w"])
        fan_in = int(np.prod(w.shape[:3]))
        return {"w": (rng.standard_normal(w.shape) / np.sqrt(fan_in)).astype(np.float32),
                "b": (rng.standard_normal(w.shape[-1]) * 0.1).astype(np.float32)}

    p["controlnet_down_blocks"] = [draw(c) for c in p["controlnet_down_blocks"]]
    p["controlnet_mid_block"] = draw(p["controlnet_mid_block"])
    p["controlnet_cond_embedding"]["conv_out"] = draw(p["controlnet_cond_embedding"]["conv_out"])
    return p


def port_controlnet(cfg, params):
    m = ControlNetModel(cfg, **F32)
    m.load_state_dict(from_jax.controlnet_state_dict(params))
    return m


def skip_shapes(cfg, b, hw):
    """The shapes of the UNet's skips (conv_in's, each resnet's, each
    downsampler's) and of its mid block's output."""
    shapes = [(b, hw, hw, cfg.block_out_channels[0])]
    for i, c in enumerate(cfg.block_out_channels):
        shapes += [(b, hw, hw, c)] * cfg.layers_per_block
        if i < len(cfg.block_out_channels) - 1:
            hw //= 2
            shapes.append((b, hw, hw, c))
    return shapes, (b, hw, hw, cfg.block_out_channels[-1])


def _inputs(seed, b=2, ctx_dim=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 16, 16, 4)).astype(np.float32),
            np.asarray([801.0, 261.0][:b], np.float32),
            rng.standard_normal((b, 7, ctx_dim)).astype(np.float32),
            rng.uniform(0.0, 1.0, (b, 32, 32, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_tiny_configs_mirror_jax():
    for ours, theirs in [(TINY_CONTROLNET, jcn.TINY_CONTROLNET),
                         (SD15_CONTROLNET, jcn.SD15_CONTROLNET)]:
        mine = dataclasses.asdict(ours)
        ref = dataclasses.asdict(theirs)
        ref["unet"] = {k: v for k, v in ref["unet"].items() if k in mine["unet"]}
        assert mine == ref


def test_sd15_residual_count_and_order():
    """12 down residuals for SD1.5 — conv_in's first, then each level's two
    resnets and its downsampler — then the mid block's."""
    m = ControlNetModel(SD15_CONTROLNET, device="meta", dtype=torch.bfloat16)
    chans = [conv.in_channels for conv in m.controlnet_down_blocks]
    assert chans == [320] * 4 + [640] * 3 + [1280] * 3 + [1280] * 2
    assert m.controlnet_mid_block.in_channels == 1280
    # the stride-2 convs pad symmetrically, conv2d(padding=1): [(1, 1), (1, 1)]
    strided = [c for c in m.controlnet_cond_embedding.blocks if c.stride == (2, 2)]
    assert len(strided) == 3 and all(c.padding == (1, 1) for c in strided)


# SDXL's text_time addition embedding on a tiny UNet (as tests/test_torch_sdxl.py)
_XL_TINY = dict(
    block_out_channels=(32, 64), down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), transformer_layers_per_block=(1, 2),
    num_heads=(4, 4), cross_attention_dim=128, layers_per_block=1, norm_num_groups=8,
    projection_class_embeddings_input_dim=64 + 6 * 256,
)
CASES = {
    "sd15": (jcn.TINY_CONTROLNET, TINY_CONTROLNET, 32),
    "sdxl": (jcn.ControlNetConfig(unet=dataclasses.replace(junet.SDXL_UNET, dtype=jnp.float32,
                                                           **_XL_TINY),
                                  conditioning_embedding_out_channels=(16, 32)),
             ControlNetConfig(unet=dataclasses.replace(SDXL_UNET, **_XL_TINY),
                              conditioning_embedding_out_channels=(16, 32)), 128),
}


@functools.lru_cache(maxsize=None)
def _jax_controlnet_fwd(case):
    """JAX's tiny ControlNet forward, jitted once a case (the scale is
    traced)."""
    return jax.jit(functools.partial(jcn.controlnet_fwd, CASES[case][0], JAX_CCFG))


@pytest.mark.parametrize("case,scale", [("sd15", 1.0), ("sd15", 0.7), ("sdxl", 0.7)])
def test_controlnet_matches_jax(case, scale):
    """Down residuals (count, shapes, values) and the mid against JAX's
    ``controlnet_fwd``, and the control image's embedding against
    ``controlnet_cond_embed``; the SDXL case adds the text_time
    ``add_embedding`` (no pipeline takes an SDXL ControlNet yet)."""
    jcfg, cfg, ctx_dim = CASES[case]
    p = jax_controlnet_params(jcfg, 0)
    m = port_controlnet(cfg, p)
    x, t, ctx, cond = _inputs(1, ctx_dim=ctx_dim)
    added = jadded = None
    if case == "sdxl":
        assert "add_embedding" in p
        rng = np.random.default_rng(2)
        added = {"text_embeds": rng.standard_normal((2, 64)).astype(np.float32),
                 "time_ids": np.asarray([[1024, 1024, 0, 0, 1024, 1024],
                                         [512, 768, 16, 32, 1024, 1024]], np.float32)}
        jadded = {k: jnp.asarray(v) for k, v in added.items()}
        added = {k: _t(v) for k, v in added.items()}
    jdown, jmid = _jax_controlnet_fwd(case)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                            jnp.asarray(cond), conditioning_scale=scale,
                                            added_cond_kwargs=jadded)
    with torch.no_grad():
        down, mid = m(_t(x), _t(t), _t(ctx), _t(cond), conditioning_scale=scale,
                      added_cond_kwargs=added)
        embed = m.cond_embed(_t(cond))
    shapes, mid_shape = skip_shapes(cfg.unet, 2, 16)
    assert [tuple(r.shape) for r in down] == shapes == [r.shape for r in jdown]
    assert tuple(mid.shape) == mid_shape
    for got, ref in zip(down, jdown):
        assert float(np.abs(np.asarray(ref)).max()) > 0  # the residuals are not zero
        _close(got, ref, MODEL_TOL)
    _close(mid, jmid, MODEL_TOL)
    _close(embed, jcn.controlnet_cond_embed(jcfg, p, jnp.asarray(cond)), MODEL_TOL)


def test_cond_embed_hoisted_equals_recomputed():
    m = port_controlnet(TINY_CONTROLNET, jax_controlnet_params(jcn.TINY_CONTROLNET, 2))
    x, t, ctx, cond = (_t(a) for a in _inputs(3))
    with torch.no_grad():
        down, mid = m(x, t, ctx, cond, conditioning_scale=0.8)
        hdown, hmid = m(x, t, ctx, None, conditioning_scale=0.8, cond_embed=m.cond_embed(cond))
    assert all(torch.equal(a, b) for a, b in zip(down, hdown)) and torch.equal(mid, hmid)


def test_fresh_controlnet_is_inert_and_scale_zero_is_exact():
    """Fresh zero convs give exactly zero residuals; drawn at a scale they
    do not, and a conditioning scale of 0 zeroes them exactly."""
    cfg = TINY_CONTROLNET
    x, t, ctx, cond = (_t(a) for a in _inputs(4))
    with torch.no_grad():
        fresh = init_controlnet_weights_(ControlNetModel(cfg, **F32),
                                         torch.Generator().manual_seed(0))
        down, mid = fresh(x, t, ctx, cond)
        assert all(float(r.abs().max()) == 0.0 for r in (*down, mid))
        drawn = init_controlnet_weights_(ControlNetModel(cfg, **F32),
                                         torch.Generator().manual_seed(0), zero_conv_scale=0.5)
        down, mid = drawn(x, t, ctx, cond)
        assert all(float(r.abs().max()) > 0.0 for r in (*down, mid))
        down, mid = drawn(x, t, ctx, cond, conditioning_scale=torch.tensor(0.0))
        assert all(float(r.abs().max()) == 0.0 for r in (*down, mid))


def test_unet_with_residuals_matches_jax():
    """The UNet adds each residual to its skip, and the mid one to the mid
    block's output, in f32 (JAX ``unet_2d_condition.py:469-493``)."""
    p = junet.init_unet_params(0, junet.TINY_UNET)
    m = UNet2DConditionModel(TINY_UNET, **F32)
    m.load_state_dict(from_jax.unet_state_dict(p))
    x, t, ctx, _ = _inputs(5)
    rng = np.random.default_rng(6)
    shapes, mid_shape = skip_shapes(TINY_UNET, 2, 16)
    res = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    mid = rng.standard_normal(mid_shape).astype(np.float32)
    fwd = jax.jit(functools.partial(junet.unet_fwd, junet.TINY_UNET, JAX_CCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ref = fwd(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
              down_block_additional_residuals=[jnp.asarray(r) for r in res],
              mid_block_additional_residual=jnp.asarray(mid))
    with torch.no_grad():
        got = m(_t(x), _t(t), _t(ctx), down_block_additional_residuals=[_t(r) for r in res],
                mid_block_additional_residual=_t(mid))
        base = m(_t(x), _t(t), _t(ctx))
        with pytest.raises(ValueError, match="down residuals"):
            m(_t(x), _t(t), _t(ctx), down_block_additional_residuals=[_t(r) for r in res[:-1]])
    assert float((got - base).abs().max()) > 1e-2 * float(got.abs().max())
    _close(got, ref, MODEL_TOL)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def tiny_cn_pipes():
    """(the JAX stepwise pipeline, the JAX fused-loop pipeline, the port's
    compiled pipeline, (JAX's image projection, the port's)) over one set of
    tiny f32 weights with a ControlNet and JAX's random IP-Adapter, carried
    by ``from_jax.ip_adapter_state_dicts`` (the IP projections act only
    where a call passes IP tokens)."""
    unet = create_unet(J_UNET64, jax.random.key(1))
    dec, enc = create_vae(J_TINY_VAE, jax.random.key(0))
    te = create_text_encoder(J_TINY_TE, jax.random.key(2))
    cn = jcn.create_controlnet(J_CN64, params=jax_controlnet_params(J_CN64, 3))
    ip_params, image_proj = jip.init_ip_adapter_params(
        jax.random.key(5), J_UNET64, unet.params, clip_embed_dim=CLIP_DIM, num_tokens=NUM_TOKENS)
    unet = unet.replace_params(ip_params)

    def jax_pipe(**knobs):
        return sfast_tpu.compile(
            JaxPipeline(unet=unet, vae=dec, vae_encode=enc, text_encoder=te, controlnet=cn,
                        scheduler=JaxDPM(), dtype=jnp.float32), JAX_CCFG.replace(**knobs))

    tu = UNet2DConditionModel(UNET64, **F32)
    ip_adapter.add_ip_projections(tu)
    ip_sd, proj_sd = from_jax.ip_adapter_state_dicts(unet.params, image_proj)
    tu.load_state_dict({**from_jax.unet_state_dict(unet.params), **ip_sd})
    proj = ip_adapter.ImageProjModel(CLIP_DIM, 64, NUM_TOKENS, **F32)
    proj.load_state_dict(proj_sd)
    tv = AutoencoderKL(TINY_TEST_VAE, **F32)
    tv.load_state_dict(from_jax.vae_state_dict(dec.params))
    tt = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    tt.load_state_dict(from_jax.clip_text_state_dict(te.params))
    tpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        tu, tv, tt, DPMSolverMultistepScheduler(), vae_encode=tv,
        controlnet=port_controlnet(CN64, cn.params), device="cpu", dtype=torch.float32))
    return jax_pipe(), jax_pipe(fuse_denoising_loop=True), tpipe, (image_proj, proj)


@pytest.fixture(scope="module")
def pipes():
    return tiny_cn_pipes()


def control_images(seed):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (1, HW, HW, 3)).astype(np.uint8)
    return {"uint8": u8, "float": rng.uniform(0.0, 1.0, (1, HW, HW, 3)).astype(np.float32)}


def latent_kw(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)
    return ids, lat, dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5,
                          output_type="latent")


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_preprocess_control_image_matches_jax(kind):
    img = control_images(8)[kind]
    got = preprocess_control_image(img, torch.float32, "cpu")
    ref = np.asarray(j_preprocess_control(img))
    assert got.shape == ref.shape == (1, HW, HW, 3) and float(got.max()) <= 1.0
    np.testing.assert_array_equal(got.numpy(), ref)  # [0, 1], not the VAE's [-1, 1]
    np.testing.assert_array_equal(preprocess_control_image(img[0]).numpy(), ref)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_pipeline_with_control_matches_jax(pipes, kind):
    """Stepwise, with a uint8 and a float control image: the port's latents
    against JAX's within 2e-3 of their scale, and the control changes them."""
    jpipe, _, tpipe, _ = pipes
    ids, lat, kw = latent_kw(10)
    ctrl = control_images(11)[kind]
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat),
                            control_image=ctrl, controlnet_conditioning_scale=0.8, **kw).images)
    tlat = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), control_image=ctrl,
                 controlnet_conditioning_scale=0.8, **kw).images
    plain = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
    _close(tlat, jlat, PIPE_TOL)
    assert not torch.allclose(tlat, plain, atol=1e-2 * float(plain.abs().max()))


def test_fused_loop_with_control_matches_jax_fused_loop(pipes):
    """The fused loop (the embedding hoisted out of the steps) against
    JAX's fused loop, and against the port's stepwise path."""
    _, jfused, tpipe, _ = pipes
    ids, lat, kw = latent_kw(12)
    ctrl = control_images(13)["uint8"]
    jlat = np.asarray(jfused(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat),
                             control_image=ctrl, controlnet_conditioning_scale=0.8, **kw).images)
    assert any(k[1] for k in jfused._fused_loops)  # JAX took its loop with the branch
    args = dict(prompt_ids=ids, latents=torch.from_numpy(lat), control_image=ctrl,
                controlnet_conditioning_scale=0.8, **kw)
    stepwise = tpipe(**args).images
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        fused = tpipe(**args).images
        assert list(tpipe._fused_loops) == [(STEPS, True, None, False, "cn")]
        loop = tpipe._fused_loops[(STEPS, True, None, False, "cn")]
        assert loop.name == f"denoise_loop_{STEPS}_cn"
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    _close(fused, jlat, PIPE_TOL)
    torch.testing.assert_close(fused, stepwise, rtol=0, atol=1e-6 * float(stepwise.abs().max()))


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_control_scale_zero_equals_no_control(pipes, fused):
    """A scale of 0 zeroes every residual exactly, and the UNet adds them
    in f32: the latents of the call without a control image, bit for bit."""
    _, _, tpipe, _ = pipes
    ids, lat, kw = latent_kw(14)
    args = dict(prompt_ids=ids, latents=torch.from_numpy(lat), **kw)
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
        zero = tpipe(control_image=control_images(15)["uint8"],
                     controlnet_conditioning_scale=0.0, **args).images
        plain = tpipe(**args).images
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    assert torch.equal(zero, plain)


def test_batch_one_control_image_broadcasts_and_buckets_pad(pipes):
    """A batch-1 control image serves a batch of 2 prompts as the same image
    twice would (diffusers' behaviour); padded to a bucket of 4, the rows
    are those of the unpadded call."""
    _, _, tpipe, _ = pipes
    rng = np.random.default_rng(16)
    ids = rng.integers(0, 1000, (2, 77)).astype(np.int32)
    lat = torch.from_numpy(rng.standard_normal((2, HW // 2, HW // 2, 4)).astype(np.float32))
    ctrl = control_images(17)["uint8"]
    kw = dict(prompt_ids=ids, latents=lat, height=HW, width=HW, num_inference_steps=2,
              output_type="latent", controlnet_conditioning_scale=0.8)
    one = tpipe(control_image=ctrl, **kw).images
    two = tpipe(control_image=np.concatenate([ctrl, ctrl]), **kw).images
    torch.testing.assert_close(one, two, rtol=0, atol=0)
    try:
        tpipe.set_compilation_config(CompilationConfig(batch_buckets=(4,)))
        padded = tpipe(control_image=ctrl, **kw).images
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    # f32 sums in another order at another batch size: the model tolerance
    _close(padded, one, MODEL_TOL)
    with pytest.raises(ValueError, match="control images"):
        tpipe(control_image=np.concatenate([ctrl] * 3), **kw)


def test_img2img_takes_the_control_image(pipes):
    """img2img runs the stepwise loop with the ControlNet, as in JAX."""
    _, _, tpipe, _ = pipes
    ids, _, kw = latent_kw(18)
    image = np.random.default_rng(19).integers(0, 256, (1, HW, HW, 3)).astype(np.uint8)
    kw = dict(kw, prompt_ids=ids, image=image, strength=0.7)
    ctrl = control_images(20)["uint8"]
    with_cn = tpipe(control_image=ctrl, controlnet_conditioning_scale=0.8, **kw).images
    zero = tpipe(control_image=ctrl, controlnet_conditioning_scale=0.0, **kw).images
    torch.testing.assert_close(zero, tpipe(**kw).images, rtol=0, atol=0)
    assert not torch.allclose(with_cn, zero)


def test_control_image_without_controlnet_raises():
    tu = UNet2DConditionModel(UNET64, **F32)
    tv = AutoencoderKL(TINY_TEST_VAE, **F32)
    tt = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    pipe = StableDiffusionPipeline(tu, tv, tt, DPMSolverMultistepScheduler(), device="cpu",
                                   dtype=torch.float32)
    with pytest.raises(ValueError, match="no controlnet"):
        pipe(prompt_ids=np.ones((1, 77), np.int32), height=HW, width=HW, num_inference_steps=1,
             control_image=control_images(21)["uint8"])


# ---------------------------------------------------------------------------
# the pipeline with a ControlNet and an IP-Adapter
# ---------------------------------------------------------------------------


def _tokens(pipes):
    """JAX's IP tokens of one image embedding, [zeros; tokens] for CFG (as
    the community example stacks them), and the port's of the same."""
    _, _, _, (jproj, proj) = pipes
    embeds = np.random.default_rng(30).standard_normal((1, CLIP_DIM)).astype(np.float32)
    jtok = np.asarray(jip.ip_image_embed(jproj, jnp.asarray(embeds)))
    with torch.no_grad():
        tok = ip_adapter.ip_image_embed(proj, _t(embeds))
    _close(tok, jtok, MODEL_TOL)
    return np.concatenate([np.zeros_like(jtok), jtok])


def test_pipeline_with_controlnet_and_ip_matches_jax(pipes):
    """Control scale 0.8 and IP scale 0.6: stepwise against JAX's stepwise
    pipeline, the fused loop against JAX's fused loop."""
    jpipe, jfused, tpipe, _ = pipes
    tok = _tokens(pipes)
    ids, lat, kw = latent_kw(31)
    ctrl = control_images(32)["uint8"]
    common = dict(control_image=ctrl, controlnet_conditioning_scale=0.8, ip_adapter_scale=0.6,
                  **kw)
    jargs = dict(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat),
                 ip_adapter_embeds=jnp.asarray(tok), **common)
    targs = dict(prompt_ids=ids, latents=torch.from_numpy(lat), ip_adapter_embeds=_t(tok),
                 **common)
    jlat = np.asarray(jpipe(**jargs).images)
    jlat_fused = np.asarray(jfused(**jargs).images)
    stepwise = tpipe(**targs).images
    only_cn = tpipe(**dict(targs, ip_adapter_embeds=None)).images
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        fused = tpipe(**targs).images
        assert list(tpipe._fused_loops) == [(STEPS, True, None, False, "cn", "ip")]
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    _close(stepwise, jlat, PIPE_TOL)
    _close(fused, jlat_fused, PIPE_TOL)
    assert not torch.allclose(stepwise, only_cn, atol=1e-2 * float(only_cn.abs().max()))


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_ip_scale_zero_equals_no_ip(pipes, fused):
    _, _, tpipe, _ = pipes
    tok = _tokens(pipes)
    ids, lat, kw = latent_kw(33)
    args = dict(prompt_ids=ids, latents=torch.from_numpy(lat),
                control_image=control_images(34)["uint8"], controlnet_conditioning_scale=0.8,
                **kw)
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
        zero = tpipe(ip_adapter_embeds=_t(tok), ip_adapter_scale=0.0, **args).images
        plain = tpipe(**args).images
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    assert torch.equal(zero, plain)


def test_ip_tokens_pad_with_the_batch(pipes):
    """Under ``batch_buckets`` each CFG half of the tokens is padded with
    the latents: the real rows are the unpadded call's.  Tokens for another
    batch raise."""
    _, _, tpipe, _ = pipes
    tok = _t(_tokens(pipes))
    ids, lat, kw = latent_kw(35)
    args = dict(prompt_ids=ids, latents=torch.from_numpy(lat), ip_adapter_embeds=tok,
                ip_adapter_scale=0.6, **kw)
    plain = tpipe(**args).images
    try:
        tpipe.set_compilation_config(CompilationConfig(batch_buckets=(2,)))
        padded = tpipe(**args).images
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    _close(padded, plain, MODEL_TOL)
    with pytest.raises(ValueError, match="ip_adapter_embeds"):
        tpipe(**dict(args, ip_adapter_embeds=tok[1:]))
