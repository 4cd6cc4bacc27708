"""sfast_tpu_torch model blocks and tiny models against sfast_tpu on the CPU.

JAX parameters come from the JAX package's own ``init_*`` functions and
reach the port through ``sfast_tpu_torch.interop.from_jax``; inputs come
from seeded numpy.  Everything runs in f32 on the CPU, so both sides take
their plain routes.  Tolerance: 1e-4 relative to the output's scale — the
same math in f32, with sums (matmuls, convs, norms) taken in another order
and compounded over the layers of a model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import autoencoder_kl as jvae
from sfast_tpu.models import clip_text as jclip
from sfast_tpu.models import layers as JL
from sfast_tpu.models import unet_2d_condition as junet
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import layers as L
from sfast_tpu_torch.models.autoencoder_kl import TINY_TEST_VAE, AutoencoderKL
from sfast_tpu_torch.models.clip_text import TINY_TEXT_ENCODER, CLIPTextModel
from sfast_tpu_torch.models.unet_2d_condition import TINY_UNET, UNet2DConditionModel

TOL = 1e-4
F32 = dict(device="cpu", dtype=torch.float32)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _load(module, put, params):
    sd = {}
    put(sd, "", params)
    module.load_state_dict(sd, strict=True)
    return module


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*(_t(a) for a in args), **kw)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    for dim, flip, shift in [(320, True, 0.0), (33, False, 1.0)]:
        ref = JL.sinusoidal_timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip, freq_shift=shift)
        got = L.timestep_embedding(_t(t), dim, flip_sin_to_cos=flip, freq_shift=shift)
        # sin/cos of f32 arguments up to ~1e3, whose ulp is ~6e-5
        _close(got, ref, 2e-4)


def test_time_embedding_matches_jax():
    p = JL.init_time_embedding(0, 32, 128, dtype=jnp.float32)
    m = L.TimestepEmbedding(32, 128, **F32)
    sd = {}
    from_jax._put_lin(sd, "linear_1", p["linear_1"])
    from_jax._put_lin(sd, "linear_2", p["linear_2"])
    m.load_state_dict(sd)
    x = _randn(1, 3, 32)
    _close(_run(m, x), JL.time_embedding_fwd(_j(p), jnp.asarray(x)))


@pytest.mark.parametrize(
    "cin,cout,temb,output_scale",
    [(32, 64, 128, 1.0), (32, 32, None, 1.0), (64, 32, 16, 2.0)],
)
def test_resnet_block_matches_jax(cin, cout, temb, output_scale):
    p = JL.init_resnet_block(0, cin, cout, temb, dtype=jnp.float32)
    m = _load(L.ResnetBlock2D(cin, cout, temb, groups=8, **F32), from_jax._put_resnet, p)
    x = _randn(1, 2, 8, 6, cin)
    te = _randn(2, 2, temb) if temb else None
    ref = JL.resnet_block_fwd(
        _j(p), jnp.asarray(x), None if te is None else jnp.asarray(te),
        groups=8, output_scale=output_scale,
    )
    with torch.no_grad():
        got = m(_t(x), None if te is None else _t(te), output_scale=output_scale)
    _close(got, ref)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_jax(cross):
    ctx_dim = 24 if cross else None
    p = JL.init_attention(0, 32, 4, context_dim=ctx_dim, dtype=jnp.float32)
    m = _load(L.Attention(32, 4, context_dim=ctx_dim, **F32), from_jax._put_attention, p)
    x = _randn(1, 2, 10, 32)
    ctx = _randn(2, 2, 7, 24) if cross else None
    ref = JL.attention_fwd(_j(p), jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), heads=4)
    with torch.no_grad():
        got = m(_t(x), None if ctx is None else _t(ctx))
    _close(got, ref)


def test_feed_forward_matches_jax():
    p = JL.init_feed_forward(0, 16, dtype=jnp.float32)
    m = L.FeedForward(16, **F32)
    sd = {}
    from_jax._put_lin(sd, "net.0.proj", p["proj"])
    from_jax._put_lin(sd, "net.2", p["out"])
    m.load_state_dict(sd)
    x = _randn(1, 2, 5, 16)
    _close(_run(m, x), JL.feed_forward_fwd(_j(p), jnp.asarray(x)))


@pytest.mark.parametrize("use_linear", [False, True])
def test_spatial_transformer_matches_jax(use_linear):
    p = JL.init_spatial_transformer(
        0, 32, 4, 24, depth=2, use_linear_projection=use_linear, dtype=jnp.float32
    )
    m = _load(
        L.Transformer2DModel(32, 4, 24, depth=2, use_linear_projection=use_linear, **F32),
        from_jax._put_spatial_transformer, p,
    )
    x, ctx = _randn(1, 2, 6, 5, 32), _randn(2, 2, 7, 24)
    ref = JL.spatial_transformer_fwd(
        _j(p), jnp.asarray(x), jnp.asarray(ctx), heads=4, use_linear_projection=use_linear
    )
    with torch.no_grad():
        got = m(_t(x), _t(ctx))
    _close(got, ref)


def test_transformer_block_matches_jax():
    p = JL.init_transformer_block(0, 32, 4, 24, dtype=jnp.float32)
    # a depth-1 spatial transformer's state dict carries the block under
    # transformer_blocks.0; reuse that mapping
    sd = {}
    from_jax._put_spatial_transformer(
        sd, "", {"norm": JL.init_norm(32), "proj_in": {"w": np.zeros((32, 32))},
                 "proj_out": {"w": np.zeros((32, 32))}, "blocks": [p]},
    )
    m = L.BasicTransformerBlock(32, 4, 24, **F32)
    m.load_state_dict({k[len("transformer_blocks.0."):]: v for k, v in sd.items()
                       if k.startswith("transformer_blocks.0.")})
    x, ctx = _randn(1, 2, 9, 32), _randn(2, 2, 7, 24)
    ref = JL.transformer_block_fwd(_j(p), jnp.asarray(x), jnp.asarray(ctx), heads=4)
    with torch.no_grad():
        got = m(_t(x), _t(ctx))
    _close(got, ref)


@pytest.mark.parametrize("kind", ["upsample", "downsample"])
def test_resampling_matches_jax(kind):
    init = JL.init_upsample if kind == "upsample" else JL.init_downsample
    p = init(0, 16, dtype=jnp.float32)
    m = (L.Upsample2D if kind == "upsample" else L.Downsample2D)(16, **F32)
    sd = {}
    from_jax._put_conv(sd, "conv", p["conv"])
    m.load_state_dict(sd)
    x = _randn(1, 2, 5, 7, 16)
    fwd = JL.upsample_fwd if kind == "upsample" else JL.downsample_fwd
    _close(_run(m, x), fwd(_j(p), jnp.asarray(x)))


def test_conv_hwio_weight_is_a_view_in_the_kernel_layout():
    conv = L.Conv2d(8, 4, 3, padding=1, **F32)
    w = conv.hwio_weight()
    np.testing.assert_array_equal(w.numpy(), conv.weight.detach().permute(2, 3, 1, 0).numpy())
    assert w.data_ptr() == conv.weight.data_ptr()  # no copy
    # K2 reads (F, 3, 3, C) rows: the channels_last weight is that, in place
    assert w.permute(3, 0, 1, 2).is_contiguous()
    conv.load_state_dict({"weight": torch.randn(4, 8, 3, 3), "bias": torch.zeros(4)})
    assert conv.hwio_weight().permute(3, 0, 1, 2).is_contiguous()


def test_init_weights_is_seeded_and_scaled():
    a = L.init_weights_(L.ResnetBlock2D(32, 64, 16, groups=8, **F32), torch.Generator().manual_seed(3))
    b = L.init_weights_(L.ResnetBlock2D(32, 64, 16, groups=8, **F32), torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    std = a.conv1.weight.std().item() * (9 * 32) ** 0.5  # N(0, 1/fan_in)
    assert 0.9 < std < 1.1
    assert float(a.conv1.bias.detach().abs().max()) == 0.0
    assert float(a.norm1.weight.detach().min()) == 1.0


# ---------------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------------


def test_tiny_text_encoder_matches_jax():
    p = jclip.init_clip_text_params(2, jclip.TINY_TEXT_ENCODER)
    m = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    m.load_state_dict(from_jax.clip_text_state_dict(p))
    ids = np.random.default_rng(3).integers(0, 1000, (2, 77)).astype(np.int32)
    ref = jclip.clip_text_fwd(jclip.TINY_TEXT_ENCODER, JaxConfig(), _j(p), jnp.asarray(ids))
    with torch.no_grad():
        got = m(torch.from_numpy(ids).long())
    _close(got, ref["last_hidden_state"])


def test_tiny_unet_matches_jax():
    p = junet.init_unet_params(0, junet.TINY_UNET)
    m = UNet2DConditionModel(TINY_UNET, **F32)
    m.load_state_dict(from_jax.unet_state_dict(p))
    x, ctx = _randn(1, 2, 16, 16, 4), _randn(2, 2, 7, 32)
    t = np.array([10.0, 500.0], np.float32)
    ref = junet.unet_fwd(
        junet.TINY_UNET, JaxConfig(), _j(p), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)
    )
    _close(_run(m, x, t, ctx), ref)


def test_tiny_vae_decoder_matches_jax():
    p = jvae.init_vae_params(1, jvae.TINY_TEST_VAE)
    m = AutoencoderKL(TINY_TEST_VAE, **F32)
    m.load_state_dict(from_jax.vae_state_dict(p))
    z = _randn(4, 1, 8, 8, 4)
    ref = jvae.vae_decode_fwd(jvae.TINY_TEST_VAE, JaxConfig(), _j(p), jnp.asarray(z))
    with torch.no_grad():
        got = m.decode(_t(z))
    assert got.shape == (1, 16, 16, 3)
    _close(got, ref)


def test_tiny_configs_mirror_jax():
    for ours, theirs in [(TINY_UNET, junet.TINY_UNET), (TINY_TEST_VAE, jvae.TINY_TEST_VAE)]:
        mine = dataclasses.asdict(ours)
        ref = {k: v for k, v in dataclasses.asdict(theirs).items() if k in mine}
        assert mine == ref


@pytest.mark.parametrize(
    "build",
    [
        lambda **kw: UNet2DConditionModel(TINY_UNET, **kw),
        lambda **kw: AutoencoderKL(TINY_TEST_VAE, **kw),
        lambda **kw: CLIPTextModel(TINY_TEXT_ENCODER, **kw),
    ],
    ids=["unet", "vae", "clip"],
)
def test_models_build_on_the_card_by_default(build, monkeypatch):
    """With no device a model is built on ``cuda``; without a CUDA device
    that raises and says how to ask for the CPU, and ``device="cpu"``
    builds there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build(dtype=torch.float32)
    m = build(device="cpu", dtype=torch.float32)
    assert {p.device.type for p in m.parameters()} == {"cpu"}
