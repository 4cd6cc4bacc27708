"""The port's SDXL pieces against sfast_tpu's (CPU): the second text encoder
(exact gelu, a projection, pad 0; the penultimate and pooled outputs), the
UNet's ``text_time`` embedding with linear projections, the ids of the
second encoder, and the SDXL pipeline (zero uncond, a negative prompt,
micro-conditioning, no CFG, img2img; the fused loop against the stepwise
one).

The tiny models share weights (``interop.from_jax``); the pipelines share
prompt ids and initial latents, and img2img JAX's own noise draws.  The
tiny encoders name their EOS (999) inside their 1000-token vocabulary, so
that the pooled output and the second encoder's ids see it.  Tolerances:
modules 1e-4 of their output's scale, latents 2e-3, uint8 images 1 level
(as ``test_torch_models.py`` and ``test_torch_pipeline.py``).
"""

import dataclasses
import importlib
import types
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
import sfast_tpu_torch
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import clip_text as jclip
from sfast_tpu.models.autoencoder_kl import TINY_TEST_VAE as J_TINY_VAE
from sfast_tpu.models.autoencoder_kl import create_vae
from sfast_tpu.models.unet_2d_condition import SDXL_UNET as J_SDXL_UNET
from sfast_tpu.models.unet_2d_condition import create_unet, unet_fwd
from sfast_tpu.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline as JaxXL
from sfast_tpu.schedulers import EulerDiscreteScheduler as JaxEuler
from sfast_tpu.text import clip_tokenizer as jtok
from sfast_tpu.utils.image import denormalize_to_uint8 as j_denormalize
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    SDXL_TEXT_ENCODER_2, SDXL_UNET, SDXL_VAE, TINY_TEST_VAE, TINY_TEXT_ENCODER, AutoencoderKL,
    CLIPTextModel, UNet2DConditionModel,
)
from sfast_tpu_torch.pipelines import StableDiffusionXLPipeline
from sfast_tpu_torch.schedulers import EulerDiscreteScheduler
from sfast_tpu_torch.text import clip_tokenizer as ttok
from tests.test_torch_compile import recorder  # noqa: F401  (a fixture)
from tests.test_torch_img2img import _jax_draws
from tests.test_torch_tokenizer import _files, vocab_dir  # noqa: F401  (a fixture)

F32 = dict(device="cpu", dtype=torch.float32)
# JAX's models jitted, on its plain routes
JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
HW = 32  # the tiny VAE halves: 16² latents
STEPS = 3
EOS = 999

J_TE1 = dataclasses.replace(jclip.TINY_TEXT_ENCODER, eos_token_id=EOS, pad_token_id=EOS)
J_TE2 = dataclasses.replace(jclip.TINY_TEXT_ENCODER, eos_token_id=EOS, pad_token_id=0,
                            hidden_act="gelu", projection_dim=64)
TE2 = dataclasses.replace(TINY_TEXT_ENCODER, pad_token_id=0, hidden_act="gelu",
                          projection_dim=64)
_XL_TINY = dict(
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    transformer_layers_per_block=(1, 2),
    num_heads=(4, 4),
    cross_attention_dim=128,  # 64 + 64 from the two tiny encoders
    projection_class_embeddings_input_dim=64 + 6 * 256,
    layers_per_block=1,
    norm_num_groups=8,
)
J_TINY_XL_UNET = dataclasses.replace(J_SDXL_UNET, dtype=jnp.float32, **_XL_TINY)
TINY_XL_UNET = dataclasses.replace(SDXL_UNET, **_XL_TINY)


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _ids(rng, b=2):
    """Prompt ids with an EOS at a random place, a second EOS later in the
    first row, EOS padding."""
    ids = rng.integers(1, EOS, (b, 77)).astype(np.int32)
    for r, n in enumerate(rng.integers(3, 20, b)):
        ids[r, n:] = EOS
    ids[0, 40] = 5
    return ids


def test_presets_mirror_jax():
    assert SDXL_UNET == dataclasses.replace(
        SDXL_UNET, **{f.name: getattr(J_SDXL_UNET, f.name)
                      for f in dataclasses.fields(SDXL_UNET)})
    mine = dataclasses.asdict(SDXL_TEXT_ENCODER_2)
    assert mine == {k: v for k, v in dataclasses.asdict(jclip.SDXL_TEXT_ENCODER_2).items()
                    if k in mine}
    assert SDXL_VAE.scaling_factor == 0.13025


# ---------------------------------------------------------------------------
# the second text encoder and the SDXL UNet
# ---------------------------------------------------------------------------


def test_tiny_text_encoder_2_matches_jax():
    """gelu, a bias-free projection at the top level, pad 0: the last and
    penultimate hidden states and the projected pooled output, which
    sits at the first EOS."""
    p = jclip.init_clip_text_params(3, J_TE2)
    m = CLIPTextModel(TE2, **F32)
    sd = from_jax.clip_text_state_dict(p)
    assert "text_projection.weight" in sd and "text_projection.bias" not in sd
    m.load_state_dict(sd)
    ids = _ids(np.random.default_rng(0))
    ref = jclip.clip_text_fwd(J_TE2, JaxConfig(), jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(ids), output_hidden_states=True)
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        last = m(t_ids)
        pen = m(t_ids, output="penultimate")
        pen2, pooled = m(t_ids, output="penultimate_pooled")
    _close(last, ref["last_hidden_state"])
    _close(pen, ref["hidden_states"][-2])
    torch.testing.assert_close(pen, pen2, rtol=0, atol=0)
    _close(pooled, ref["text_embeds"])
    with pytest.raises(ValueError, match="output"):
        m(t_ids, output="hidden_states")
    with pytest.raises(ValueError, match="text_projection"):
        CLIPTextModel(TINY_TEXT_ENCODER, **F32)(t_ids, output="penultimate_pooled")


def test_tiny_sdxl_unet_matches_jax():
    """``text_time``: six ids embedded at 256 each beside the pooled text
    embeds, through ``add_embedding``; linear proj_in / proj_out."""
    unet = create_unet(J_TINY_XL_UNET, jax.random.key(4))
    sd = from_jax.unet_state_dict(unet.params)
    assert sd["down_blocks.1.attentions.0.proj_in.weight"].dim() == 2
    assert "add_embedding.linear_1.weight" in sd
    m = UNet2DConditionModel(TINY_XL_UNET, **F32)
    m.load_state_dict(sd)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 128)).astype(np.float32)
    t = np.asarray([801.0, 261.0], np.float32)
    added = {"text_embeds": rng.standard_normal((2, 64)).astype(np.float32),
             "time_ids": np.asarray([[1024, 1024, 0, 0, 1024, 1024],
                                     [512, 768, 16, 32, 1024, 1024]], np.float32)}
    fwd = jax.jit(functools.partial(unet_fwd, J_TINY_XL_UNET, JaxConfig(enable_pallas=False)))
    ref = fwd(unet.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
              added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()})
    _close(got, ref)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _pipes(tokenizers=(None, None)):
    """(JAX SDXL pipeline, the port's compiled one) over one set of tiny
    f32 weights, Euler as in JAX's SDXL configuration."""
    unet = create_unet(J_TINY_XL_UNET, jax.random.key(1))
    dec, enc = create_vae(J_TINY_VAE, jax.random.key(0))
    te1 = jclip.create_text_encoder(J_TE1, jax.random.key(2))
    te2 = jclip.create_text_encoder(J_TE2, jax.random.key(3))
    jpipe = sfast_tpu.compile(
        JaxXL(unet=unet, vae=dec, vae_encode=enc, text_encoder=te1, text_encoder_2=te2,
              scheduler=JaxEuler(), tokenizer=tokenizers[0], dtype=jnp.float32), JAX_CCFG)
    tu = UNet2DConditionModel(TINY_XL_UNET, **F32)
    tu.load_state_dict(from_jax.unet_state_dict(unet.params))
    tv = AutoencoderKL(TINY_TEST_VAE, **F32)
    tv.load_state_dict(from_jax.vae_state_dict(dec.params))
    t1 = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    t1.load_state_dict(from_jax.clip_text_state_dict(te1.params))
    t2 = CLIPTextModel(TE2, **F32)
    t2.load_state_dict(from_jax.clip_text_state_dict(te2.params))
    tpipe = sfast_tpu_torch.compile(StableDiffusionXLPipeline(
        tu, tv, t1, t2, EulerDiscreteScheduler(), vae_encode=tv, tokenizer=tokenizers[1],
        device="cpu", dtype=torch.float32))
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    return _pipes()


def test_compile_wraps_the_second_encoder(pipes, recorder):  # noqa: F811
    """``text_encoder_2`` is a compiled model whose graphs are keyed by the
    output mode."""
    _, tpipe = pipes
    te2 = tpipe.text_encoder_2
    assert isinstance(te2, sfast_tpu_torch.compilers.CompiledModel) and te2.name == "text_encoder_2"
    ids = torch.ones((1, 77), dtype=torch.long)
    try:
        te2.clear_cache()
        with torch.inference_mode():
            h, pooled = te2(ids, output="penultimate_pooled")
            te2(ids, output="penultimate_pooled")
            assert te2.cache_size == 1
            last = te2(ids)
        assert te2.cache_size == 2
        assert h.shape == last.shape == (1, 77, 64) and pooled.shape == (1, 64)
    finally:
        te2.clear_cache()


def test_ids_for_encoder_2_matches_jax_on_ids(pipes):
    jpipe, tpipe = pipes
    ids = _ids(np.random.default_rng(1), b=3)
    ids[2] = 7  # a row with no EOS stays as it is
    ref = np.asarray(jpipe._ids_for_encoder_2(None, jnp.asarray(ids)))
    got = tpipe._ids_for_encoder_2(None, ids)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0, 41:].eq(0).all() and got[0, 40] == 0 and (got[2] == 7).all()


def test_ids_for_encoder_2_matches_jax_on_strings(vocab_dir):  # noqa: F811
    """With only ``tokenizer`` attached the second tokenizer is derived
    from it (pad "!"): "!" in the text splits out as pad ids."""
    jpipe, tpipe = _pipes((jtok.CLIPTokenizer.from_files(*_files(vocab_dir)),
                           ttok.CLIPTokenizer.from_files(*_files(vocab_dir))))
    for prompt in ("a photo of a cat", "hey!!! you", ["caps AND puncts!!!", "a"]):
        ref = np.asarray(jpipe._ids_for_encoder_2(prompt, jpipe.tokenize(prompt)))
        got = tpipe._ids_for_encoder_2(prompt, tpipe.tokenize(prompt))
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tpipe.tokenizer_2.pad_token_id == tpipe.tokenizer.encoder["!"]
    hey = tpipe._ids_for_encoder_2("hey!!!", None)[0].tolist()
    bang = tpipe.tokenizer_2.pad_token_id
    assert hey[hey.index(tpipe.tokenizer.eos_token_id) - 3:][:3] == [bang] * 3


CASES = {
    "zero_uncond": {},
    "negative": {"negative_prompt_ids": "neg"},
    "micro": {"original_size": (64, 96), "crops_coords_top_left": (8, 16),
              "target_size": (48, 48)},
    "no_cfg": {"guidance_scale": 1.0},
    "img2img": {"image": "image", "strength": 0.7},
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_sdxl_pipeline_matches_jax(pipes, monkeypatch, case):
    """Latents against JAX's, the uint8 image within 1 level, and the fused
    loop (img2img enters after step 0 and stays stepwise) equal to the
    stepwise one."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(7)
    ids = _ids(rng, b=1)
    sigma = float(EulerDiscreteScheduler().set_timesteps(STEPS)["init_noise_sigma"])
    lat = (rng.standard_normal((1, HW // 2, HW // 2, 4)) * sigma).astype(np.float32)
    extra = dict(CASES[case])
    jextra, textra = dict(extra), dict(extra)
    if "negative_prompt_ids" in extra:
        neg = _ids(rng, b=1)
        jextra["negative_prompt_ids"], textra["negative_prompt_ids"] = jnp.asarray(neg), neg
    if "image" in extra:
        image = rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
        jextra["image"] = textra["image"] = image
        draws = _jax_draws(jpipe, image, 11)
        monkeypatch.setattr(tpipe, "_img2img_noise", lambda shape, s: draws)
    else:
        jextra["latents"], textra["latents"] = jnp.asarray(lat), torch.from_numpy(lat)
    kw = dict(height=HW, width=HW, num_inference_steps=STEPS, seed=11, output_type="latent")
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), **kw, **jextra).images)
    jimg = np.asarray(j_denormalize(jpipe.vae(jlat / J_TINY_VAE.scaling_factor)))
    tlat = tpipe(prompt_ids=ids, **kw, **textra).images
    timg = tpipe(prompt_ids=ids, **dict(kw, output_type="np"), **textra).images
    _close(tlat, jlat, 2e-3)
    assert timg.shape == jimg.shape == (1, HW, HW, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        fused = tpipe(prompt_ids=ids, **kw, **textra).images
        loops = list(tpipe._fused_loops)
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    use_cfg = case != "no_cfg"
    assert loops == ([] if case == "img2img" else [(STEPS, use_cfg, None, False)])
    torch.testing.assert_close(fused, tlat, rtol=0, atol=1e-6 * tlat.abs().max().item())
    if case == "micro":  # the micro-conditioning changes the output
        plain = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
        assert not torch.allclose(plain, tlat)


def test_zero_uncond_and_time_ids(pipes):
    """Without a negative prompt the uncond half of the context and of the
    pooled embeds is zeros; the time ids have a row per UNet sample."""
    _, tpipe = pipes
    seen = []
    unet = tpipe.unet.module
    original = unet.forward

    def spy(sample, t, context, added_cond_kwargs=None, timestep_cond=None):
        seen.append((context, added_cond_kwargs))
        return original(sample, t, context, added_cond_kwargs, timestep_cond)

    tpipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    unet.forward = spy
    try:
        kw = dict(prompt_ids=np.ones((2, 77), np.int64), height=HW, width=HW,
                  num_inference_steps=1, output_type="latent", original_size=(40, 48))
        tpipe(**kw)
        tpipe(**kw, guidance_scale=1.0)
    finally:
        del unet.forward
        tpipe.set_compilation_config(CompilationConfig.Default())
    (ctx, added), (ctx1, added1) = seen
    assert ctx.shape == (4, 77, 128) and ctx[:2].eq(0).all() and not ctx[2:].eq(0).all()
    assert added["text_embeds"][:2].eq(0).all() and added["time_ids"].shape == (4, 6)
    assert added["time_ids"][0].tolist() == [40, 48, 0, 0, HW, HW]
    assert ctx1.shape == (2, 77, 128) and added1["time_ids"].shape == (2, 6)


# ---------------------------------------------------------------------------
# the opt-in routing rules at SDXL 1024²'s shapes (batch 2), against JAX's
# ---------------------------------------------------------------------------


def _on_tpu(monkeypatch):
    """JAX's rules read "on TPU" where the port's read "on CUDA"."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("m,k,f", [(8192, 640, 2560), (2048, 1280, 5120)],
                         ids=["64^2", "32^2"])
def test_sdxl_geglu_rule_matches_jax(monkeypatch, m, k, f):
    """Every one of the 70 GEGLUs an eval (levels 1 and 2) takes K4."""
    from sfast_tpu_torch.ops.geglu import geglu_ok

    j_geglu = importlib.import_module("sfast_tpu.ops.geglu")
    _on_tpu(monkeypatch)
    seen = []
    monkeypatch.setattr(j_geglu, "linear_geglu_pallas", lambda *a, **kw: seen.append("pallas"))
    monkeypatch.setattr(j_geglu, "linear_geglu_xla", lambda *a, **kw: seen.append("xla"))
    j_geglu.linear_geglu(jax.ShapeDtypeStruct((m, k), jnp.bfloat16),
                         jax.ShapeDtypeStruct((k, 2 * f), jnp.bfloat16))
    assert seen == ["pallas"] and geglu_ok((m, k), (2 * f, k), torch.bfloat16, "cuda")


@pytest.mark.parametrize("h,sq,sk,int8", [(10, 4096, 4096, True), (20, 1024, 1024, True),
                                          (10, 4096, 77, False), (20, 1024, 77, False)])
def test_sdxl_int8_attention_rule_matches_jax(monkeypatch, h, sq, sk, int8):
    """At head dim 64 the length rule takes 1,024 tokens: both levels'
    self-attentions take K6, the cross-attentions at 77 keys the plain
    route."""
    from sfast_tpu_torch.ops.attention import flash_ok

    j_attention = importlib.import_module("sfast_tpu.ops.attention")
    _on_tpu(monkeypatch)
    seen = []
    for name in ("flash_attention", "flash_attention_int8", "xla_attention"):
        monkeypatch.setattr(j_attention, name, lambda *a, _n=name, **kw: seen.append(_n))
    q = jax.ShapeDtypeStruct((2, h, sq, 64), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((2, h, sk, 64), jnp.bfloat16)
    j_attention.dot_product_attention(q, kv, kv, backend="int8")
    assert seen == ["flash_attention_int8" if int8 else "xla_attention"]
    assert flash_ok(q.shape, kv.shape, torch.bfloat16, "cuda") is int8


@pytest.mark.parametrize("c,fused", [(320, True), (640, True), (960, False)])
def test_sdxl_128_group_norms_take_a_kernel_route(monkeypatch, c, fused):
    """JAX's opt-in GroupNorm is its Pallas pair at every shape; the port's
    is the fused GroupNorm where ``fused_plan`` takes the shape, else K3
    then K5, the same pair.  At 128² the 960-channel entry of up level 2's
    first resnet does not fit a cluster's tiles."""
    from sfast_tpu_torch.ops import group_norm as t_gn

    j_gn = importlib.import_module("sfast_tpu.ops.group_norm")
    jseen, seen = [], []
    monkeypatch.setattr(j_gn, "group_norm_pallas", lambda *a, **kw: jseen.append("pallas"))
    j_gn.group_norm(jax.ShapeDtypeStruct((2, 128, 128, c), jnp.bfloat16),
                    jnp.ones((c,)), jnp.zeros((c,)), act="silu", backend="pallas")
    stats = torch.zeros(2, 1, 1, c)
    monkeypatch.setattr(t_gn, "group_norm_fused", lambda *a, **kw: seen.append("fused"))
    monkeypatch.setattr(t_gn, "group_norm_stats", lambda *a, **kw: seen.append("K3") or (stats,
                                                                                      stats))
    monkeypatch.setattr(t_gn, "group_norm_apply", lambda *a, **kw: seen.append("K5"))
    x = torch.empty(2, 128, 128, c, device="meta")
    t_gn.group_norm(x, torch.ones(c), torch.zeros(c), groups=32, act="silu", backend="kernel")
    assert jseen == ["pallas"]
    assert (t_gn.fused_plan(2, 128 * 128, c, 32) is not None) is fused
    assert seen == (["fused"] if fused else ["K3", "K5"])


@pytest.mark.parametrize("shape,ks,backend,ok", [
    ((2, 128, 128, 320), (3, 3), None, True),    # down level 0 conv1, conv2; up level 2 conv2
    ((2, 128, 128, 640), (3, 3), None, True),    # up level 2 conv1; the upsample conv into 128²
    ((2, 128, 128, 960), (3, 3), None, True),    # up level 2's first conv1
    ((2, 64, 64, 640), (3, 3), None, False),     # level 1: below the 128² rule
    ((2, 128, 128, 960), (1, 1), None, False),   # a conv_shortcut
    ((2, 128, 128, 320), (3, 3), "plain", False),  # enable_fused_conv off
])
def test_sdxl_fused_conv_rule_matches_jax(monkeypatch, shape, ks, backend, ok):
    """With ``enable_fused_conv`` the SDXL UNet's resnets at 128² take K2,
    and a quantized conv never does (JAX: no ``w`` in its parameters)."""
    from sfast_tpu.models import layers as JL
    from sfast_tpu_torch.models import layers as L

    _on_tpu(monkeypatch)
    conv_p = {"w": jax.ShapeDtypeStruct((*ks, shape[-1], 320), jnp.bfloat16)}
    x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    jbackend = {"plain": "xla"}.get(backend, backend)
    assert JL._fused_conv_ok(conv_p, x, jbackend) is ok
    assert L.fused_conv_ok(shape, torch.bfloat16, "cuda", ks, backend) is ok
    assert not JL._fused_conv_ok({"w_q": conv_p["w"]}, x, jbackend)
    conv = L.Conv2d(shape[-1], 320, ks, padding=ks[0] // 2, device="meta", dtype=torch.bfloat16)
    on_card = types.SimpleNamespace(shape=shape, dtype=torch.bfloat16, device=torch.device("cuda"))
    assert L._fused_ok(conv, on_card, backend) is ok
    conv.weight = None  # quantized: no bf16 weight
    assert not L._fused_ok(conv, on_card, backend)
