"""The port's LoRA against sfast_tpu's (CPU): initialisation, merging,
diffusers / kohya conversion, and the hot-swap of a compiled model, on
SD1.5's UNet, SDXL's and the ControlNet slot.

The tiny UNets share weights (``interop.from_jax``); a JAX LoRA tree reaches
the port through ``from_jax.lora_params``.  Tolerance: 1e-4 relative to the
output's scale, as the models' (``test_torch_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu import lora as jlora
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import unet_2d_condition as junet
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch import lora
from sfast_tpu_torch.compilers import compile_unet
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import TINY_UNET, UNet2DConditionModel
from tests.test_torch_compile import recorder  # noqa: F401  (a fixture)
from tests.test_torch_pipeline import tiny_pipes

F32 = dict(device="cpu", dtype=torch.float32)
TOL = 1e-4


@pytest.fixture(scope="module")
def base():
    """(JAX params, the port's state dict of the same weights)."""
    p = junet.init_unet_params(0, junet.TINY_UNET)
    return p, from_jax.unet_state_dict(p)


def _unet(state):
    m = UNet2DConditionModel(TINY_UNET, **F32)
    m.load_state_dict(state)
    return m


def _inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((1, 16, 16, 4)).astype(np.float32), np.array([5.0], np.float32),
            rng.standard_normal((1, 7, 32)).astype(np.float32))


def _run(m, x, t, ctx):
    with torch.no_grad():
        return m(*(torch.from_numpy(a) for a in (x, t, ctx)))


def _jax_lora(p, rank=2, seed=2):
    """JAX's LoRA tree with a seeded non-zero B, so that the delta shows."""
    lo = jlora.init_lora_params(jax.random.key(1), p, rank=rank)
    rng = np.random.default_rng(seed)
    return {k: {"a": f["a"], "b": jnp.asarray(rng.standard_normal(f["b"].shape) * 0.1,
                                               jnp.float32)} for k, f in lo.items()}


def test_init_lora_targets_the_attention_projections(base):
    p, state = base
    ours = lora.init_lora_params(torch.Generator().manual_seed(0), state, rank=2)
    theirs = from_jax.lora_params(jlora.init_lora_params(jax.random.key(1), p, rank=2))
    assert sorted(ours) == sorted(theirs) and ours
    for mod, f in ours.items():
        assert mod.rsplit(".", 1)[-1] in ("to_q", "to_k", "to_v", "0")
        dout, din = state[mod + ".weight"].shape
        assert f["a"].shape == (din, 2) and f["b"].shape == (2, dout)
        assert not f["b"].any()


def test_merge_with_zero_b_is_the_identity(base):
    _, state = base
    fresh = lora.init_lora_params(torch.Generator().manual_seed(0), state, rank=4)
    merged = lora.merge_lora(state, fresh, scale=1.0)
    assert merged.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(merged[k], v), k


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_merged_unet_matches_jax(base, scale):
    p, state = base
    jl = _jax_lora(p)
    merged = lora.merge_lora(state, from_jax.lora_params(jl), scale)
    ref_merged = from_jax.unet_state_dict(jlora.merge_lora(p, jl, scale))
    for k in state:  # (A·B)ᵀ lands on the (out, in) weight
        torch.testing.assert_close(merged[k], ref_merged[k], rtol=0, atol=1e-6)
    assert any(not torch.equal(merged[k], state[k]) for k in state)
    x, t, ctx = _inputs()
    ref = junet.unet_fwd(junet.TINY_UNET, JaxConfig(),
                         jax.tree_util.tree_map(jnp.asarray, jlora.merge_lora(p, jl, scale)),
                         jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = _run(_unet(merged), x, t, ctx)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_merge_raises_for_a_module_the_model_lacks(base):
    _, state = base
    with pytest.raises(KeyError, match="no module"):
        lora.merge_lora(state, {"down_blocks.0.nothing.to_q": {"a": torch.zeros(1, 1),
                                                               "b": torch.zeros(1, 1)}})


def _diffusers_sd(state, kohya: bool):
    g = torch.Generator().manual_seed(3)
    r = 2
    mods = ["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
            "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0",
            "up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_v"]
    sd = {}
    for m in mods:
        dout, din = state[m + ".weight"].shape
        down = torch.randn(r, din, generator=g) * 0.1
        up = torch.randn(dout, r, generator=g) * 0.1
        if kohya:
            key = "lora_unet_" + m.replace(".", "_")
            sd.update({f"{key}.lora_down.weight": down, f"{key}.lora_up.weight": up,
                       f"{key}.alpha": torch.tensor(1.0)})
        else:
            sd.update({f"unet.{m}.lora_A.weight": down, f"unet.{m}.lora_B.weight": up})
    return mods, sd


@pytest.mark.parametrize("kohya", [False, True], ids=["peft", "kohya"])
def test_convert_diffusers_lora_names(base, kohya):
    _, state = base
    mods, sd = _diffusers_sd(state, kohya)
    ours, scale = lora.convert_diffusers_lora(sd)
    assert scale == 1.0 and sorted(ours) == sorted(mods)
    for m, f in ours.items():
        dout, din = state[m + ".weight"].shape
        assert f["a"].shape == (din, 2) and f["b"].shape == (2, dout)
    if kohya:  # alpha 1 over rank 2 is folded into A
        key = "lora_unet_" + mods[0].replace(".", "_")
        torch.testing.assert_close(ours[mods[0]]["a"], sd[f"{key}.lora_down.weight"].T * 0.5)
    else:  # the JAX converter reads PEFT names to the same modules and factors
        theirs = from_jax.lora_params(jlora.convert_diffusers_lora(sd)[0])
        assert sorted(theirs) == sorted(ours)
        for m in ours:
            for k in ("a", "b"):
                torch.testing.assert_close(ours[m][k], theirs[m][k], rtol=0, atol=0)
    lora.merge_lora(state, ours)  # every converted name is a module of the UNet


def test_switch_lora_changes_the_output_without_a_capture(base):
    """Graphs off (CPU): a swap changes the output to that of a fresh UNet
    loaded with the merged weights, so no module keeps a copy of a weight
    between calls; scale 0 swaps back exactly."""
    p, state = base
    cm = compile_unet(_unet(state), CompilationConfig(enable_cuda_graph=False))
    base_state = {k: v.clone() for k, v in cm.module.state_dict().items()}
    lo = from_jax.lora_params(_jax_lora(p))
    x, t, ctx = _inputs()
    before = _run(cm, x, t, ctx)
    size = cm.cache_size
    lora.switch_lora(cm, base_state, lo, scale=1.0)
    after = _run(cm, x, t, ctx)
    assert cm.cache_size == size
    assert not torch.allclose(after, before)
    torch.testing.assert_close(after, _run(_unet(lora.merge_lora(state, lo)), x, t, ctx),
                               rtol=0, atol=0)
    lora.switch_lora(cm, base_state, lo, scale=0.0)
    torch.testing.assert_close(_run(cm, x, t, ctx), before, rtol=0, atol=0)
    with pytest.raises(ValueError, match="own weight"):
        lora.switch_lora(cm, cm.module.state_dict(), lo)


def test_switch_lora_reaches_the_pipeline_and_its_fused_loop():
    _, tpipe = tiny_pipes()
    state = {k: v.clone() for k, v in tpipe.unet.module.state_dict().items()}
    lo = lora.init_lora_params(torch.Generator().manual_seed(4), state, rank=2)
    for f in lo.values():
        f["b"] = torch.randn(f["b"].shape, generator=torch.Generator().manual_seed(5)) * 0.1
    kw = dict(prompt_ids=np.ones((1, 77), np.int64), height=32, width=32,
              num_inference_steps=2, seed=1, output_type="latent")
    out = {}
    for fused in (False, True):
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
        base_lat = tpipe(**kw).images
        lora.switch_lora(tpipe.unet, state, lo)
        out[fused] = tpipe(**kw).images
        lora.switch_lora(tpipe.unet, state, lo, scale=0.0)
        assert not torch.allclose(out[fused], base_lat)
        torch.testing.assert_close(tpipe(**kw).images, base_lat, rtol=0, atol=0)
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# SDXL's UNet and the ControlNet slot
# ---------------------------------------------------------------------------


def _xl_and_cn():
    from tests.test_torch_controlnet import J_CN64, jax_controlnet_params
    from tests.test_torch_sdxl import J_TINY_XL_UNET

    return {"sdxl": (junet.init_unet_params(0, J_TINY_XL_UNET), from_jax.unet_state_dict),
            "controlnet": (jax_controlnet_params(J_CN64, 3), from_jax.controlnet_state_dict)}


@pytest.mark.parametrize("model", ["sdxl", "controlnet"])
def test_merge_matches_jax_on_sdxl_and_the_controlnet(model):
    """JAX's LoRA tree over SDXL's UNet (transformer depth 2) and over a
    ControlNet (its trunk's attentions) merges as JAX merges it."""
    p, writer = _xl_and_cn()[model]
    state = writer(p)
    jl = _jax_lora(p)
    lo = from_jax.lora_params(jl)
    assert lo and all(mod + ".weight" in state for mod in lo)
    merged = lora.merge_lora(state, lo, 0.7)
    ref = writer(jlora.merge_lora(p, jl, 0.7))
    for k in state:
        torch.testing.assert_close(merged[k], ref[k], rtol=0, atol=1e-6)
    assert sum(not torch.equal(merged[k], state[k]) for k in state) == len(lo)


@pytest.mark.parametrize("model", ["sdxl", "controlnet"])
def test_switch_lora_on_sdxl_and_the_controlnet_slot_captures_nothing(recorder, model):
    """A swap into SDXL's ``unet`` slot or the ``controlnet`` slot of a
    compiled pipeline (captures recorded) changes the image and captures
    nothing; scale 0 swaps back bit for bit."""
    import sfast_tpu_torch
    from sfast_tpu_torch.models import (
        TINY_TEST_VAE, TINY_TEXT_ENCODER, AutoencoderKL, CLIPTextModel, ControlNetModel,
        init_controlnet_weights_, init_weights_,
    )
    from sfast_tpu_torch.pipelines import StableDiffusionPipeline, StableDiffusionXLPipeline
    from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler, EulerDiscreteScheduler
    from tests.test_torch_controlnet import CN64, UNET64
    from tests.test_torch_sdxl import TE2, TINY_XL_UNET

    g = torch.Generator().manual_seed(6)
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, **F32), g)
    te = init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, **F32), g)
    kw = dict(prompt_ids=np.ones((1, 77), np.int64), height=32, width=32,
              num_inference_steps=2, seed=1, output_type="latent")
    if model == "sdxl":
        tpipe = sfast_tpu_torch.compile(StableDiffusionXLPipeline(
            init_weights_(UNet2DConditionModel(TINY_XL_UNET, **F32), g), vae, te,
            init_weights_(CLIPTextModel(TE2, **F32), g), EulerDiscreteScheduler(),
            device="cpu", dtype=torch.float32))
        slot = tpipe.unet
    else:
        cn = init_controlnet_weights_(ControlNetModel(CN64, **F32), g, zero_conv_scale=1.0)
        tpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
            init_weights_(UNet2DConditionModel(UNET64, **F32), g), vae, te,
            DPMSolverMultistepScheduler(), controlnet=cn, device="cpu", dtype=torch.float32))
        slot = tpipe.controlnet
        kw.update(control_image=np.full((1, 32, 32, 3), 128, np.uint8),
                  controlnet_conditioning_scale=0.8)
    state = {k: v.clone() for k, v in slot.module.state_dict().items()}
    lo = lora.init_lora_params(torch.Generator().manual_seed(4), state, rank=2)
    for f in lo.values():
        f["b"] = torch.randn(f["b"].shape, generator=torch.Generator().manual_seed(5)) * 0.1
    base_lat = tpipe(**kw).images
    captures = recorder.count("capture")
    lora.switch_lora(slot, state, lo)
    swapped = tpipe(**kw).images
    lora.switch_lora(slot, state, lo, scale=0.0)
    back = tpipe(**kw).images
    assert recorder.count("capture") == captures
    assert not torch.allclose(swapped, base_lat)
    torch.testing.assert_close(back, base_lat, rtol=0, atol=0)
