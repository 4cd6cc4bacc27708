"""The sfast_tpu_torch text2img slice against sfast_tpu's, plus its routing
rules and its independence from JAX (CPU).

The tiny pipelines share weights (``interop.from_jax``), prompt ids and
initial latents, and run DPM++ for 3 steps with CFG in f32.  Tolerances:
latents 2e-3 relative to their scale — f32 model differences (~1e-5 per
eval) amplified by CFG 7.5 and the solver over 3 steps; uint8 images at
most 1 level, the rounding of values that land near a level boundary.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
import sfast_tpu_torch
from sfast_tpu.models.autoencoder_kl import TINY_TEST_VAE as J_TINY_VAE
from sfast_tpu.models.autoencoder_kl import create_vae
from sfast_tpu.models.clip_text import TINY_TEXT_ENCODER as J_TINY_TE
from sfast_tpu.models.clip_text import create_text_encoder
from sfast_tpu.models.unet_2d_condition import TINY_UNET as J_TINY_UNET
from sfast_tpu.models.unet_2d_condition import create_unet
from sfast_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from sfast_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from sfast_tpu.compilers.diffusion_pipeline_compiler import compile_unet
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.utils.image import denormalize_to_uint8 as j_denormalize
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    TINY_TEST_VAE, TINY_TEXT_ENCODER, TINY_UNET, AutoencoderKL, CLIPTextModel,
    UNet2DConditionModel,
)
from sfast_tpu_torch.models.layers import fused_conv_ok
from sfast_tpu_torch.models.unet_2d_condition import backends
from sfast_tpu_torch.ops import group_norm as t_group_norm
from sfast_tpu_torch.ops.attention import flash_ok
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny text encoder is 64 wide; the UNet's cross-attention must match
J_UNET64 = dataclasses.replace(J_TINY_UNET, cross_attention_dim=64)
UNET64 = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
STEPS, HW = 3, 32
# the opt-in kernel configuration, in both packages
OPTIN_KNOBS = dict(enable_fused_group_norm=True, enable_fused_linear_geglu=True,
                   enable_int8_attention=True)
OPTIN = CompilationConfig(**OPTIN_KNOBS)


@pytest.fixture(scope="module")
def pipes():
    unet = create_unet(J_UNET64, jax.random.key(1))
    dec, enc = create_vae(J_TINY_VAE, jax.random.key(0))
    te = create_text_encoder(J_TINY_TE, jax.random.key(2))
    jpipe = JaxPipeline(unet=unet, vae=dec, vae_encode=enc, text_encoder=te,
                        scheduler=JaxDPM(), dtype=jnp.float32)
    f32 = dict(device="cpu", dtype=torch.float32)
    tu = UNet2DConditionModel(UNET64, **f32)
    tu.load_state_dict(from_jax.unet_state_dict(unet.params))
    tv = AutoencoderKL(TINY_TEST_VAE, **f32)
    tv.load_state_dict(from_jax.vae_decoder_state_dict(dec.params))
    tt = CLIPTextModel(TINY_TEXT_ENCODER, **f32)
    tt.load_state_dict(from_jax.clip_text_state_dict(te.params))
    tpipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        tu, tv, tt, DPMSolverMultistepScheduler(), device="cpu", dtype=torch.float32
    ))
    return jpipe, tpipe


def test_tiny_pipeline_matches_jax(pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)
    kw = dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5)
    jlat = jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat), output_type="latent", **kw).images
    jimg = np.asarray(j_denormalize(jpipe.vae(jlat / J_TINY_VAE.scaling_factor)))
    cuda_build.reset_launch_counts()
    tlat = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), output_type="latent", **kw).images
    timg = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), output_type="np", **kw).images
    ref = np.asarray(jlat)
    np.testing.assert_allclose(tlat.numpy(), ref, rtol=0, atol=2e-3 * np.abs(ref).max())
    assert timg.shape == jimg.shape == (1, HW, HW, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
    # on CPU tensors no kernel launches
    assert cuda_build.launch_counts == {
        "flash_attention": 0, "quantize_qkv": 0, "flash_attention_int8": 0, "conv3x3": 0,
        "group_norm_stats": 0, "group_norm_apply": 0, "group_norm_fused": 0, "linear_geglu": 0,
    }


def test_tiny_pipeline_optin_matches_jax(pipes, monkeypatch):
    """The opt-in configuration end to end.  At these widths K4 (K < 128)
    and K6 (sequences below the length rule) do not fire on either side, so
    this covers the kernel route of every UNet GroupNorm (the fused
    GroupNorm where a group has 8 channels or more; K3 then K5 below, here
    C = 32 at 8 groups and the transformers' 32 groups) and the config
    plumbing;
    tests/test_torch_optin.py covers K4 and K6 at module level."""
    jpipe, tpipe = pipes
    gn_mod = sys.modules["sfast_tpu.ops.group_norm"]
    pallas_gn = gn_mod.group_norm_pallas
    calls = []

    def interpret_gn(*a, **kw):
        calls.append(a[0].shape)
        return pallas_gn(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(gn_mod, "group_norm_pallas", interpret_gn)
    ours, pairs = [], []
    fused, apply = t_group_norm.group_norm_fused, t_group_norm.group_norm_apply
    monkeypatch.setattr(t_group_norm, "group_norm_fused",
                        lambda x, *a, **kw: ours.append(x.shape) or fused(x, *a, **kw))
    monkeypatch.setattr(t_group_norm, "group_norm_apply",
                        lambda x, *a, **kw: pairs.append(x.shape) or apply(x, *a, **kw))
    # JAX's stepwise pipeline calls its UNet bundle, which takes its config
    # from sfast_tpu's compile step
    monkeypatch.setattr(jpipe, "unet", compile_unet(
        jpipe.unet, JaxConfig(**OPTIN_KNOBS, enable_aot_cache=False)))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)
    kw = dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5,
              output_type="latent")
    jlat = np.asarray(jpipe(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat), **kw).images)
    try:
        tpipe.set_compilation_config(OPTIN)
        tlat = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    # every UNet GroupNorm took the kernel route on both sides (K3′+K5 in
    # JAX, the fused GroupNorm or K3 then K5 here): JAX traced its UNet
    # once, the port ran it STEPS times on the CFG batch
    assert calls and ours and pairs and len(ours) + len(pairs) == STEPS * len(calls)
    np.testing.assert_allclose(tlat.numpy(), jlat, rtol=0, atol=2e-3 * np.abs(jlat).max())


def test_tiny_pipeline_seeds_and_outputs(pipes):
    _, tpipe = pipes
    ids = np.ones((1, 77), np.int64)
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=2)
    a, b, c = (tpipe(seed=s, **kw).images for s in (3, 3, 4))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    img = tpipe(seed=3, output_type="float", **kw).images
    assert img.shape == (1, HW, HW, 3) and bool(torch.isfinite(img).all())
    lat_g1 = tpipe(seed=3, output_type="latent", guidance_scale=1.0, **kw).images
    lat_g7 = tpipe(seed=3, output_type="latent", **kw).images
    assert lat_g1.shape == (1, HW // 2, HW // 2, 4) and not torch.equal(lat_g1, lat_g7)
    with pytest.raises(ValueError, match="output_type"):
        tpipe(output_type="pil", **kw)


def test_compile_applies_config(pipes):
    _, tpipe = pipes
    cfg = CompilationConfig(enable_kernels=False)
    assert sfast_tpu_torch.compile(tpipe, cfg) is tpipe
    assert all(m.compilation_config is cfg for m in (tpipe.unet, tpipe.vae, tpipe.text_encoder))
    sfast_tpu_torch.compile(tpipe)
    assert tpipe.unet.compilation_config == CompilationConfig.Default()


# ---------------------------------------------------------------------------
# the fused denoising loop, step-count re-keying, scheduler swaps, buckets
# ---------------------------------------------------------------------------


def _latent_kw(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    lat = rng.standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)
    return ids, lat


def test_fused_loop_matches_jax_fused_loop(pipes):
    """The port's fuse_denoising_loop path (run eagerly here: CPU tensors
    never capture) against JAX's fori_loop executable, same weights and
    latents, and against the port's stepwise path."""
    jpipe, tpipe = pipes
    jfused = JaxPipeline(unet=jpipe.unet, vae=jpipe.vae, text_encoder=jpipe.text_encoder,
                         scheduler=JaxDPM(), dtype=jnp.float32)
    sfast_tpu.compile(jfused, JaxConfig(enable_pallas=False, fuse_denoising_loop=True))
    ids, lat = _latent_kw(4)
    kw = dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5)
    jlat = np.asarray(jfused(prompt_ids=jnp.asarray(ids), latents=jnp.asarray(lat),
                             output_type="latent", **kw).images)
    assert jfused._fused_loops  # JAX took its fused loop
    jimg = np.asarray(j_denormalize(jfused.vae(jnp.asarray(jlat) / J_TINY_VAE.scaling_factor)))
    stepwise = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), output_type="latent",
                     **kw).images
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        tlat = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), output_type="latent",
                     **kw).images
        timg = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
        assert list(tpipe._fused_loops) == [(STEPS, True)]
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    np.testing.assert_allclose(tlat.numpy(), jlat, rtol=0, atol=2e-3 * np.abs(jlat).max())
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
    torch.testing.assert_close(tlat, stepwise, rtol=0, atol=1e-6 * stepwise.abs().max().item())


def test_fused_loop_rekeys_on_step_count_change(pipes):
    _, tpipe = pipes
    ids, lat = _latent_kw(5)

    def run(steps, fused):
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
        return tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), height=HW, width=HW,
                     num_inference_steps=steps, output_type="latent").images

    try:
        fused3 = run(3, True)
        fused2 = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), height=HW, width=HW,
                       num_inference_steps=2, output_type="latent").images
        assert sorted(tpipe._fused_loops) == [(2, True), (3, True)]
        stepwise2, stepwise3 = run(2, False), run(3, False)
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    assert not torch.allclose(fused2, fused3)
    torch.testing.assert_close(fused2, stepwise2, rtol=0, atol=1e-6)
    torch.testing.assert_close(fused3, stepwise3, rtol=0, atol=1e-6)


def test_scheduler_swap_drops_fused_loops_and_cached_state(pipes):
    """JAX ``tests/pipelines/test_stable_diffusion.py:298``: a first-order
    DPM++ installed in place of the compiled default must run its own
    trajectory, and swapping back must give the first result again."""
    _, tpipe = pipes
    ids, lat = _latent_kw(6)
    kw = dict(prompt_ids=ids, latents=torch.from_numpy(lat), height=HW, width=HW,
              num_inference_steps=3, output_type="latent")
    original = tpipe.scheduler
    try:
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        a = tpipe(**kw).images
        assert 3 in tpipe._sched_states and tpipe._fused_loops
        tpipe.scheduler = DPMSolverMultistepScheduler(solver_order=1)
        b = tpipe(**kw).images
        assert tpipe._sched_obj is tpipe.scheduler
        assert tpipe._sched_states[3][0]["table"].shape == (3, 5)
        tpipe.scheduler = original
        c = tpipe(**kw).images
    finally:
        tpipe.scheduler = original
        tpipe.set_compilation_config(CompilationConfig.Default())
    assert not torch.allclose(a, b)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("batch,buckets", [(1, (2,)), (3, (2, 4))])
def test_batch_buckets_drop_padded_rows(pipes, batch, buckets):
    """Padded to its bucket, a batch gives the unpadded run's rows: from
    given latents (the decoded images) and from a seed (the latents)."""
    _, tpipe = pipes
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 1000, (batch, 77)).astype(np.int32)
    lat = torch.from_numpy(rng.standard_normal((batch, HW // 2, HW // 2, 4)).astype(np.float32))
    kw = dict(prompt_ids=ids, height=HW, width=HW, num_inference_steps=1)

    def run():
        return (tpipe(latents=lat, output_type="float", **kw).images,
                tpipe(seed=9, output_type="latent", **kw).images)

    plain, plain_seeded = run()
    try:
        tpipe.set_compilation_config(CompilationConfig(batch_buckets=buckets))
        padded, padded_seeded = run()
    finally:
        tpipe.set_compilation_config(CompilationConfig.Default())
    assert padded.shape == plain.shape == (batch, HW, HW, 3)
    assert padded_seeded.shape == (batch, HW // 2, HW // 2, 4)
    torch.testing.assert_close(padded, plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(padded_seeded, plain_seeded, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# routing rules at the SD1.5 512² shapes
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


@pytest.mark.parametrize(
    "q,k,dtype,dev,expect",
    [
        ((2, 8, 4096, 40), (2, 8, 4096, 40), BF16, "cuda", True),    # UNet level-0 self
        ((2, 8, 4096, 40), (2, 8, 4096, 40), BF16, "cpu", False),    # same, on the CPU
        ((2, 8, 4096, 40), (2, 8, 4096, 40), torch.float32, "cuda", False),
        ((2, 8, 4096, 40), (2, 8, 77, 40), BF16, "cuda", False),     # level-0 cross
        ((2, 8, 1024, 80), (2, 8, 1024, 80), BF16, "cuda", False),   # level-1 self
        ((2, 8, 256, 160), (2, 8, 256, 160), BF16, "cuda", False),   # level-2 self
        ((2, 8, 4096, 80), (2, 8, 4096, 80), BF16, "cuda", True),    # level 1 at 1024²
        ((2, 12, 77, 64), (2, 12, 77, 64), BF16, "cuda", False),     # CLIP
        ((1, 1, 4096, 512), (1, 1, 4096, 512), BF16, "cuda", False),  # VAE mid, d > 160
        ((2, 8, 4096, 36), (2, 8, 4096, 36), BF16, "cuda", False),  # d % 8 != 0
    ],
)
def test_flash_routing_rule(q, k, dtype, dev, expect):
    assert flash_ok(q, k, dtype, dev) is expect


@pytest.mark.parametrize(
    "x,dtype,dev,ks,backend,expect",
    [
        ((1, 128, 128, 512), BF16, "cuda", (3, 3), None, True),   # VAE up block 1
        ((1, 512, 512, 256), BF16, "cuda", (3, 3), None, True),   # VAE up block 3 / upsample
        ((1, 64, 64, 512), BF16, "cuda", (3, 3), None, False),    # VAE mid, 64²
        ((2, 64, 64, 320), BF16, "cuda", (3, 3), None, False),    # UNet level 0
        ((1, 128, 128, 512), torch.float32, "cuda", (3, 3), None, False),
        ((1, 128, 128, 512), BF16, "cpu", (3, 3), None, False),
        ((1, 128, 128, 512), BF16, "cuda", (1, 1), None, False),  # conv_shortcut
        ((1, 128, 128, 512), BF16, "cuda", (3, 3), "plain", False),
    ],
)
def test_fused_conv_routing_rule(x, dtype, dev, ks, backend, expect):
    assert fused_conv_ok(x, dtype, dev, ks, backend) is expect


def test_config_to_backends():
    assert backends(CompilationConfig()) == {
        "gn": None, "attn": None, "geglu": "plain", "conv": "plain"}
    assert backends(CompilationConfig(enable_kernels=False)) == {
        "gn": "plain", "attn": "plain", "geglu": "plain", "conv": "plain"}
    assert backends(CompilationConfig(enable_fused_conv=True)) == {
        "gn": None, "attn": None, "geglu": "plain", "conv": None}
    assert backends(CompilationConfig(enable_flash_attention=False))["attn"] == "plain"
    assert backends(OPTIN) == {"gn": "kernel", "attn": "int8", "geglu": None, "conv": "plain"}


# ---------------------------------------------------------------------------
# the port without JAX
# ---------------------------------------------------------------------------


def test_port_imports_and_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises
        import torch
        import sfast_tpu_torch
        from sfast_tpu_torch.models import TINY_UNET, UNet2DConditionModel, init_weights_
        from sfast_tpu_torch.runtime import cuda_build
        import sfast_tpu_torch.interop.from_jax, sfast_tpu_torch.pipelines, sfast_tpu_torch.schedulers
        import sfast_tpu_torch.compilers, sfast_tpu_torch.schedulers.compile
        from sfast_tpu_torch.runtime import executable_cache, shape_bucket, signature, tracing
        unet = init_weights_(UNet2DConditionModel(TINY_UNET, device="cpu", dtype=torch.float32),
                             torch.Generator().manual_seed(0))
        with torch.inference_mode():
            out = unet(torch.randn(1, 16, 16, 4), torch.tensor([10.0]), torch.randn(1, 7, 32))
        assert out.shape == (1, 16, 16, 4) and bool(torch.isfinite(out).all())
        assert cuda_build._lib is None  # importing builds and loads no kernel
        assert not any(m == "sfast_tpu" or m.startswith(("sfast_tpu.", "jax."))
                       for m in sys.modules)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
