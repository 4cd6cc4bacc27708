"""``sfast_tpu_torch.compile`` of a diffusers-shaped pipeline against
``sfast_tpu.compile`` of the same one (CPU).

The stubs stand for diffusers' and transformers' modules as the adapters
see them: a ``.config`` (a dict in diffusers' keys; for CLIP a namespace in
transformers' names), a ``.state_dict()`` and ``named_parameters``; called,
they raise.  Their tensors are seeded port modules' (which take diffusers'
names) at the ``TINY_*`` widths, and both packages convert the same state
dicts.  Tolerances as ``tests/test_torch_pipeline.py``: uint8 images at
most 1 level; the state dicts the port loads equal the stubs' exactly.
"""

import dataclasses
import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
import sfast_tpu_torch
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.interop import convert_clip, convert_svd, convert_unet, convert_vae
from sfast_tpu.interop.diffusers_adapter import _convert_scheduler as jax_convert_scheduler
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.compilers import CompiledModel
from sfast_tpu_torch.interop import diffusers_adapter as adapter
from sfast_tpu_torch.models import (
    AutoencoderKL, AutoencoderKLTemporalDecoder, CLIPTextModel, CLIPVisionModel, ControlNetConfig,
    ControlNetModel, UNet2DConditionModel, UNetSpatioTemporalConditionModel,
    init_controlnet_weights_, init_svd_unet_weights_, init_temporal_vae_weights_, init_weights_,
)
from sfast_tpu_torch.pipelines import (
    StableDiffusionPipeline, StableDiffusionXLPipeline, StableVideoDiffusionPipeline,
)
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler, EulerDiscreteScheduler
from tests.test_torch_svd import _image as svd_image
from tests.test_torch_svd import _jax_draws as svd_draws
from tests.test_torch_svd import negate_output_
from tests.test_torch_svd import _one_torch_thread  # noqa: F401  (an autouse fixture)

F32 = dict(device="cpu", dtype=torch.float32)
JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False, param_dtype="float32")
CCFG = CompilationConfig(param_dtype="float32")
HW, STEPS, FRAMES = 32, 2, 4


class Stub:
    """A foreign torch module seen from outside: config, state dict, and a
    forward that must never run."""

    def __init__(self, config, module):
        self.config = config
        self._sd = {k: v.detach().clone() for k, v in module.state_dict().items()}

    def state_dict(self):
        return self._sd

    def named_parameters(self):
        return iter(self._sd.items())

    def forward(self, *args, **kwargs):
        raise AssertionError(f"{type(self).__name__} was called: compile wrapped a foreign module")

    __call__ = forward


def stub(cls_name, config, module):
    return type(cls_name, (Stub,), {})(config, module)


def scheduler_stub(cls_name, **config):
    return type(cls_name, (), {"config": dict(num_train_timesteps=1000, beta_start=0.00085,
                                              beta_end=0.012, beta_schedule="scaled_linear",
                                              steps_offset=1, **config)})()


# diffusers' and transformers' config keys at the tiny widths
UNET = dict(sample_size=16, in_channels=4, out_channels=4, block_out_channels=[32, 64],
            down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"], layers_per_block=1,
            attention_head_dim=4, cross_attention_dim=64, norm_num_groups=8)
SD2_UNET = dict(UNET, attention_head_dim=[4, 4], use_linear_projection=True)
XL_UNET = dict(UNET, down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
               up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
               transformer_layers_per_block=[1, 2], attention_head_dim=[4, 4],
               cross_attention_dim=128, use_linear_projection=True,
               addition_embed_type="text_time", addition_time_embed_dim=256,
               projection_class_embeddings_input_dim=64 + 6 * 256)
CONTROLNET = dict({k: v for k, v in UNET.items() if k not in ("out_channels", "up_block_types")},
                  conditioning_channels=3, conditioning_embedding_out_channels=[16, 32])
VAE = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8,
           latent_channels=4, scaling_factor=0.18215)
SVD_UNET = dict(sample_size=16, in_channels=8, out_channels=4, block_out_channels=[32, 64],
                down_block_types=["CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"],
                up_block_types=["UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"],
                layers_per_block=1, transformer_layers_per_block=1, num_attention_heads=[4, 4],
                cross_attention_dim=32, addition_time_embed_dim=32,
                projection_class_embeddings_input_dim=96, num_frames=FRAMES)
# transformers' CLIPTextConfig states a projection_dim (512) for a model without one
CLIP = dict(vocab_size=1000, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=77, hidden_act="quick_gelu",
            projection_dim=512, eos_token_id=999, bos_token_id=998)
CLIP_SD2 = dict(CLIP, num_hidden_layers=23, hidden_act="gelu")
CLIP_XL2 = dict(CLIP, hidden_act="gelu", projection_dim=64)
VISION = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, projection_dim=32,
              hidden_act="quick_gelu")


def _seeded(module, seed, init=init_weights_, **kw):
    return init(module, torch.Generator().manual_seed(seed), **kw)


def _clip(cfg_dict, seed):
    ns = types.SimpleNamespace(**cfg_dict)
    cfg = adapter.clip_config_from_hf(ns)
    if cfg_dict is not CLIP_XL2:
        cfg = dataclasses.replace(cfg, projection_dim=None)
    cls = "CLIPTextModelWithProjection" if cfg.projection_dim else "CLIPTextModel"
    return stub(cls, ns, _seeded(CLIPTextModel(cfg, **F32), seed))


def _sd_stub(kind):
    """A diffusers SD / SD2.x / SDXL / ControlNet pipeline object."""
    unet_dict = {"sd2": SD2_UNET, "sdxl": XL_UNET}.get(kind, UNET)
    unet = _seeded(UNet2DConditionModel(adapter.unet_config_from_diffusers(unet_dict), **F32), 1)
    vae = _seeded(AutoencoderKL(adapter.vae_config_from_diffusers(VAE), **F32), 0)
    pipe = types.SimpleNamespace(
        unet=stub("UNet2DConditionModel", unet_dict, unet),
        vae=stub("AutoencoderKL", VAE, vae),
        text_encoder=_clip(CLIP_SD2 if kind == "sd2" else CLIP, 2),
        tokenizer=None,
        scheduler=scheduler_stub("EulerDiscreteScheduler" if kind == "sdxl"
                                 else "DPMSolverMultistepScheduler"))
    if kind == "sdxl":
        pipe.text_encoder_2, pipe.tokenizer_2 = _clip(CLIP_XL2, 3), None
    if kind == "controlnet":
        ucfg = adapter.unet_config_from_diffusers(
            dict(CONTROLNET, out_channels=4, up_block_types=["UpBlock2D"] * 2))
        cn = _seeded(ControlNetModel(ControlNetConfig(ucfg, 3, (16, 32)), **F32), 4,
                     init=init_controlnet_weights_, zero_conv_scale=0.5)
        pipe.controlnet = stub("ControlNetModel", CONTROLNET, cn)
    return pipe


def _svd_stub():
    unet = _seeded(UNetSpatioTemporalConditionModel(
        adapter.svd_config_from_diffusers(SVD_UNET), **F32), 1, init=init_svd_unet_weights_)
    vae = _seeded(AutoencoderKLTemporalDecoder(
        adapter.temporal_vae_config_from_diffusers(VAE), **F32), 0,
        init=init_temporal_vae_weights_)
    ns = types.SimpleNamespace(**VISION)
    enc = _seeded(CLIPVisionModel(adapter.clip_vision_config_from_hf(ns), **F32), 2)
    return types.SimpleNamespace(
        unet=stub("UNetSpatioTemporalConditionModel", SVD_UNET, unet),
        vae=stub("AutoencoderKLTemporalDecoder", VAE, vae),
        image_encoder=stub("CLIPVisionModelWithProjection", ns, enc))


EXPECTED = {"sd15": StableDiffusionPipeline, "sd2": StableDiffusionPipeline,
            "sdxl": StableDiffusionXLPipeline, "controlnet": StableDiffusionPipeline,
            "svd": StableVideoDiffusionPipeline}


def _slots(pipe):
    return [a for a in ("unet", "controlnet", "vae", "text_encoder", "text_encoder_2",
                        "image_encoder") if getattr(pipe, a, None) is not None]


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_compile_converts_a_diffusers_pipeline_and_matches_jax(kind):
    stub_pipe = _svd_stub() if kind == "svd" else _sd_stub(kind)
    tpipe = sfast_tpu_torch.compile(stub_pipe, CCFG, device="cpu")
    assert type(tpipe) is EXPECTED[kind] and tpipe is not stub_pipe
    for slot in _slots(stub_pipe):
        compiled = getattr(tpipe, slot)
        assert isinstance(compiled, CompiledModel), slot
        got = compiled.module.state_dict()
        want = getattr(stub_pipe, slot).state_dict()
        assert sorted(got) == sorted(want), slot
        assert all(torch.equal(got[k], want[k]) for k in want), slot
    jpipe = sfast_tpu.compile(stub_pipe, JAX_CCFG)

    if kind == "svd":
        aug, lat = svd_draws(3, FRAMES)
        kw = dict(num_frames=FRAMES, height=HW, width=HW, num_inference_steps=STEPS, seed=3)
        ref = jpipe(svd_image(), **kw).images
        negate_output_(tpipe.unet.module)  # JAX's EDM step takes Karras' c_out, the port's −c_out
        got = tpipe(svd_image(), latents=lat, aug_noise=aug, **kw).images
    else:
        if kind == "sd2":
            assert tpipe.clip_skip_mode == jpipe.clip_skip_mode == "penultimate"
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 998, (1, 77)).astype(np.int32)
        lat = rng.standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)
        kw = dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5)
        if kind != "sdxl":  # the stubs' vocabulary holds no synthesized empty prompt
            kw["negative_prompt_ids"] = np.zeros((1, 77), np.int32)
        if kind == "controlnet":
            kw["control_image"] = rng.integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
        ref = jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat),
                    **{k: jnp.asarray(v) if k == "negative_prompt_ids" else v
                       for k, v in kw.items()}).images
        got = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sfast_tpu_torch.compile(_sd_stub("sd15"), CCFG)


def test_the_mapping_of_legacy_names_and_shapes():
    """What ``map_state_dict`` maps: the legacy VAE attention names with
    their 1×1 conv weights, a 1×1 conv ``proj_in`` / ``proj_out`` where the
    port holds linear projections (and linear ones where it holds convs),
    and transformers' ``position_ids`` buffer."""
    vae = _seeded(AutoencoderKL(adapter.vae_config_from_diffusers(VAE), **F32), 5)
    legacy = {}
    for k, v in vae.state_dict().items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                v = v[:, :, None, None] if v.dim() == 2 else v
        legacy[k] = v
    assert any(".query.weight" in k for k in legacy)
    got = adapter.convert_vae(stub("AutoencoderKL", VAE, vae), "cpu", torch.float32)
    for k, v in vae.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    got = adapter._load(AutoencoderKL(adapter.vae_config_from_diffusers(VAE), **F32), legacy)
    assert all(torch.equal(got.state_dict()[k], v) for k, v in vae.state_dict().items())

    for unet_dict in (UNET, SD2_UNET):  # 1×1 convs, then linear projections
        unet = _seeded(UNet2DConditionModel(adapter.unet_config_from_diffusers(unet_dict),
                                            **F32), 6)
        flipped = {k: (v.reshape(v.shape[:2]) if v.dim() == 4 else v[:, :, None, None])
                   if ".proj_in.weight" in k or ".proj_out.weight" in k else v
                   for k, v in unet.state_dict().items()}
        assert any(v.dim() != unet.state_dict()[k].dim() for k, v in flipped.items())
        got = adapter._load(UNet2DConditionModel(adapter.unet_config_from_diffusers(unet_dict),
                                                 **F32), flipped)
        assert all(torch.equal(got.state_dict()[k], v) for k, v in unet.state_dict().items())

    te = _clip(CLIP, 7)  # its config states projection_dim 512, its tensors hold none
    te._sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    got = adapter.convert_text_encoder(te, "cpu", torch.float32)
    assert got.text_projection is None and "position_ids" not in str(list(got.state_dict()))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        adapter._load(UNet2DConditionModel(adapter.unet_config_from_diffusers(UNET), **F32),
                      dict(unet.state_dict(), extra=torch.zeros(1)))


# published configurations, read by both packages' readers
SD15_UNET_JSON = dict(
    act_fn="silu", attention_head_dim=8, block_out_channels=[320, 640, 1280, 1280],
    center_input_sample=False, cross_attention_dim=768,
    down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"], downsample_padding=1,
    flip_sin_to_cos=True, freq_shift=0, in_channels=4, layers_per_block=2, mid_block_scale_factor=1,
    norm_eps=1e-05, norm_num_groups=32, out_channels=4, sample_size=64,
    up_block_types=["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3)
SD21_UNET_JSON = dict(SD15_UNET_JSON, attention_head_dim=[5, 10, 20, 20], cross_attention_dim=1024,
                      use_linear_projection=True, sample_size=96)
SDXL_UNET_JSON = dict(
    SD15_UNET_JSON, addition_embed_type="text_time", addition_time_embed_dim=256,
    attention_head_dim=[5, 10, 20], block_out_channels=[320, 640, 1280], cross_attention_dim=2048,
    down_block_types=["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    projection_class_embeddings_input_dim=2816, sample_size=128,
    transformer_layers_per_block=[1, 2, 10], use_linear_projection=True,
    up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"])
LCM_UNET_JSON = dict(SD15_UNET_JSON, time_cond_proj_dim=256)
SD_VAE_JSON = dict(act_fn="silu", block_out_channels=[128, 256, 512, 512],
                   down_block_types=["DownEncoderBlock2D"] * 4, in_channels=3, latent_channels=4,
                   layers_per_block=2, norm_num_groups=32, out_channels=3, sample_size=512,
                   up_block_types=["UpDecoderBlock2D"] * 4)
SDXL_VAE_JSON = dict(SD_VAE_JSON, scaling_factor=0.13025, sample_size=1024)
SVD_UNET_JSON = dict(
    addition_time_embed_dim=256, block_out_channels=[320, 640, 1280, 1280],
    cross_attention_dim=1024,
    down_block_types=["CrossAttnDownBlockSpatioTemporal"] * 3 + ["DownBlockSpatioTemporal"],
    in_channels=8, layers_per_block=2, num_attention_heads=[5, 10, 20, 20], num_frames=25,
    out_channels=4, projection_class_embeddings_input_dim=768, sample_size=96,
    transformer_layers_per_block=1,
    up_block_types=["UpBlockSpatioTemporal"] + ["CrossAttnUpBlockSpatioTemporal"] * 3)
VIT_L_TEXT = types.SimpleNamespace(
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, max_position_embeddings=77, hidden_act="quick_gelu",
    projection_dim=768, eos_token_id=2)
BIGG_TEXT = types.SimpleNamespace(
    vocab_size=49408, hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
    num_attention_heads=20, max_position_embeddings=77, hidden_act="gelu", projection_dim=1280,
    eos_token_id=None)
VIT_H_VISION = types.SimpleNamespace(
    image_size=224, patch_size=14, hidden_size=1280, intermediate_size=5120,
    num_hidden_layers=32, num_attention_heads=16, projection_dim=1024, hidden_act="gelu")

READERS = {
    "unet sd1.5": (adapter.unet_config_from_diffusers, convert_unet.unet_config_from_diffusers,
                   SD15_UNET_JSON),
    "unet sd2.1": (adapter.unet_config_from_diffusers, convert_unet.unet_config_from_diffusers,
                   SD21_UNET_JSON),
    "unet sdxl": (adapter.unet_config_from_diffusers, convert_unet.unet_config_from_diffusers,
                  SDXL_UNET_JSON),
    "unet lcm": (adapter.unet_config_from_diffusers, convert_unet.unet_config_from_diffusers,
                 LCM_UNET_JSON),
    "vae sd": (adapter.vae_config_from_diffusers, convert_vae.vae_config_from_diffusers,
               SD_VAE_JSON),
    "vae sdxl": (adapter.vae_config_from_diffusers, convert_vae.vae_config_from_diffusers,
                 SDXL_VAE_JSON),
    "temporal vae": (adapter.temporal_vae_config_from_diffusers,
                     convert_vae.temporal_vae_config_from_diffusers, SD_VAE_JSON),
    "svd unet": (adapter.svd_config_from_diffusers, convert_svd.svd_config_from_diffusers,
                 SVD_UNET_JSON),
    "clip vit-l": (adapter.clip_config_from_hf, convert_clip.clip_config_from_hf, VIT_L_TEXT),
    "clip bigg": (adapter.clip_config_from_hf, convert_clip.clip_config_from_hf, BIGG_TEXT),
    "clip vision vit-h": (adapter.clip_vision_config_from_hf,
                          convert_clip.clip_vision_config_from_hf, VIT_H_VISION),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_config_readers_match_jax(name):
    ours, theirs, raw = READERS[name]
    got = dataclasses.asdict(ours(raw))
    # JAX's configs carry a dtype, and its temporal VAE's a marker the
    # port's class (TemporalVAEConfig) stands for
    want = {k: v for k, v in dataclasses.asdict(theirs(raw)).items()
            if k not in ("dtype", "temporal_decoder")}
    assert set(want) <= set(got), set(want) - set(got)
    assert {k: got[k] for k in want} == want


SCHEDULERS = ["DDIMScheduler", "DPMSolverMultistepScheduler", "EulerAncestralDiscreteScheduler",
              "EulerDiscreteScheduler", "LCMScheduler", "PNDMScheduler"]


@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_mapping_matches_jax(name, caplog):
    foreign = scheduler_stub(name, timestep_spacing="trailing", use_karras_sigmas=True,
                             prediction_type="v_prediction")
    with caplog.at_level(logging.WARNING):
        ours = adapter._convert_scheduler(foreign)
    theirs = jax_convert_scheduler(foreign)
    assert type(ours).__name__ == type(theirs).__name__
    assert getattr(ours, "ancestral", False) == getattr(theirs, "ancestral", False) == (
        "Ancestral" in name)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(theirs.config)
    unknown = name == "PNDMScheduler"
    assert ("unknown scheduler PNDMScheduler" in caplog.text) == unknown
    if unknown:
        assert isinstance(ours, DPMSolverMultistepScheduler)
    assert isinstance(adapter._convert_scheduler(None), DPMSolverMultistepScheduler)
    assert isinstance(ours, EulerDiscreteScheduler) == ("Euler" in name)


def test_a_foreign_module_is_never_called_or_wrapped():
    """Compile converts the stub and runs an image: the stubs, whose
    forward raises, are never called, and no slot holds one."""
    stub_pipe = _sd_stub("sd15")
    tpipe = sfast_tpu_torch.compile(stub_pipe, CCFG, device="cpu")
    img = tpipe(prompt_ids=np.ones((1, 77), np.int64), negative_prompt_ids=np.zeros((1, 77)),
                height=HW, width=HW, num_inference_steps=STEPS).images
    assert img.shape == (1, HW, HW, 3)
    assert not any(isinstance(getattr(tpipe, a, None), Stub) for a in _slots(tpipe))
    assert all(not isinstance(getattr(tpipe, a).module, Stub) for a in _slots(tpipe))
    # a pipeline of the port's models compiles in place, as before
    assert sfast_tpu_torch.compile(tpipe, CCFG) is tpipe
