"""sfast_tpu_torch's CLIP vision encoder and IP-Adapter against sfast_tpu's
on the CPU.  The pipeline with a ControlNet and an IP-Adapter together is
held against JAX's in ``tests/test_torch_controlnet.py``, on that file's
pipelines, which carry JAX's random IP-Adapter.

Weights reach the port through ``interop.from_jax`` (``clip_vision_state_dict``,
``ip_adapter_state_dicts``) or, for ``load_ip_adapter``, as a torch
``ip_adapter.bin``-layout dict that both packages read.  Tolerances as
``tests/test_torch_controlnet.py``: models 1e-4 relative to the output's
scale; the bf16 attention 2e-2 (a few bf16 ulps, rounded in each
package's own order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfast_tpu import ip_adapter as jip
from sfast_tpu.models import clip_vision as jcv
from sfast_tpu.models import layers as JL
from sfast_tpu.models import unet_2d_condition as junet
from sfast_tpu_torch import ip_adapter
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    SD15_UNET, SDXL_UNET, TINY_IMAGE_ENCODER, TINY_UNET, CLIPVisionModel, UNet2DConditionModel,
)
from sfast_tpu_torch.models import layers as L
from tests.test_torch_controlnet import CLIP_DIM, JAX_CCFG, MODEL_TOL, NUM_TOKENS, _close, _t

F32 = dict(device="cpu", dtype=torch.float32)
BF16_TOL = 2e-2


# ---------------------------------------------------------------------------
# the image encoder
# ---------------------------------------------------------------------------


def test_tiny_image_encoder_matches_jax():
    """Every output key, each hidden state included."""
    p = jcv.init_clip_vision_params(0, jcv.TINY_IMAGE_ENCODER)
    m = CLIPVisionModel(TINY_IMAGE_ENCODER, **F32)
    m.load_state_dict(from_jax.clip_vision_state_dict(p))
    px = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    fwd = jax.jit(functools.partial(jcv.clip_vision_fwd, jcv.TINY_IMAGE_ENCODER, JAX_CCFG),
                  static_argnames=("output_hidden_states",))
    ref = fwd(p, jnp.asarray(px), output_hidden_states=True)
    with torch.no_grad():
        got = m(_t(px), output_hidden_states=True)
        short = m(_t(px))
    assert set(got) == set(ref) == {"last_hidden_state", "pooler_output", "image_embeds",
                                    "hidden_states"}
    assert "hidden_states" not in short
    assert len(got["hidden_states"]) == len(ref["hidden_states"]) == 3
    for key in ("last_hidden_state", "pooler_output", "image_embeds"):
        _close(got[key], ref[key], MODEL_TOL)
    for g, r in zip(got["hidden_states"], ref["hidden_states"]):
        _close(g, r, MODEL_TOL)


# ---------------------------------------------------------------------------
# IP-Adapter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TINY_UNET", "SD15_UNET", "SDXL_UNET"])
def test_attn2_paths_match_jax(name):
    ours = {"TINY_UNET": TINY_UNET, "SD15_UNET": SD15_UNET, "SDXL_UNET": SDXL_UNET}[name]
    names = {"blocks": "transformer_blocks"}
    ref = [".".join(names.get(q, str(q)) for q in path)
           for path in jip.attn2_paths_in_diffusers_order(getattr(junet, name))]
    assert ip_adapter.attn2_paths_in_diffusers_order(ours) == ref
    assert ref[0].startswith("down_blocks") and ref[-1].startswith("mid_block")


def torch_format_ip_adapter(unet_params, cfg, seed, *, cross_dim):
    """A random ``ip_adapter.bin``-layout dict for a UNet tree: the attn2
    keys under odd ids (diffusers numbers attn1 too)."""
    rng = np.random.default_rng(seed)

    def randn(*shape, s=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))

    ip = {}
    for n, path in enumerate(jip.attn2_paths_in_diffusers_order(cfg)):
        node = unet_params
        for q in path:
            node = node[q]
        dim = np.asarray(node["to_k"]["w"]).shape[1]
        ip[f"{2 * n + 1}.to_k_ip.weight"] = randn(dim, cross_dim)
        ip[f"{2 * n + 1}.to_v_ip.weight"] = randn(dim, cross_dim)
    proj = {"proj.weight": randn(NUM_TOKENS * cross_dim, CLIP_DIM),
            "proj.bias": randn(NUM_TOKENS * cross_dim), "norm.weight": 1.0 + randn(cross_dim),
            "norm.bias": randn(cross_dim)}
    return {"image_proj": proj, "ip_adapter": ip}


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
            np.asarray([801.0, 261.0], np.float32),
            rng.standard_normal((2, 7, 32)).astype(np.float32),
            rng.standard_normal((2, CLIP_DIM)).astype(np.float32))


def test_load_ip_adapter_torch_format_matches_jax():
    """The same torch-format dict through JAX's ``load_ip_adapter`` and the
    port's: the same image tokens and the same UNet output with them."""
    cfg = junet.TINY_UNET
    p = junet.init_unet_params(0, cfg)
    sd = torch_format_ip_adapter(p, cfg, 1, cross_dim=32)
    assert sorted({int(k.split(".")[0]) for k in sd["ip_adapter"]}) == [1, 3, 5, 7]
    jparams, jproj = jip.load_ip_adapter(cfg, p, sd, num_tokens=NUM_TOKENS, dtype=jnp.float32)
    m = UNet2DConditionModel(TINY_UNET, **F32)
    m.load_state_dict(from_jax.unet_state_dict(p))
    proj = ip_adapter.load_ip_adapter(m, sd, num_tokens=NUM_TOKENS)
    x, t, ctx, embeds = _unet_inputs(2)
    jtok = jip.ip_image_embed(jproj, jnp.asarray(embeds))
    with torch.no_grad():
        tok = ip_adapter.ip_image_embed(proj, _t(embeds))
    assert tuple(tok.shape) == (2, NUM_TOKENS, 32)
    _close(tok, jtok, MODEL_TOL)
    fwd = jax.jit(functools.partial(junet.unet_fwd, cfg, JAX_CCFG))
    ref = fwd(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x), jnp.asarray(t),
              jnp.asarray(ctx), ip_adapter_embeds=jtok, ip_adapter_scale=0.6)
    with torch.no_grad():
        got = m(_t(x), _t(t), _t(ctx), ip_adapter_embeds=tok, ip_adapter_scale=0.6)
    _close(got, ref, MODEL_TOL)
    # even ids are attn1's: a dict under them matches no attn2
    even = {"image_proj": sd["image_proj"],
            "ip_adapter": {f"{int(k.split('.')[0]) - 1}.{k.split('.', 1)[1]}": v
                           for k, v in sd["ip_adapter"].items()}}
    with pytest.raises(ValueError, match="odd id"):
        ip_adapter.load_ip_adapter(UNet2DConditionModel(TINY_UNET, **F32), even)


@pytest.fixture(scope="module")
def ip_unets():
    """(JAX's UNet tree with ``init_ip_adapter_params``, its image
    projection, the port's UNet and image projection with those weights)."""
    cfg = junet.TINY_UNET
    p = junet.init_unet_params(3, cfg)
    jparams, jproj = jip.init_ip_adapter_params(jax.random.key(4), cfg, p,
                                                clip_embed_dim=CLIP_DIM)
    m = UNet2DConditionModel(TINY_UNET, **F32)
    assert len(ip_adapter.add_ip_projections(m)) == 4
    ip_sd, proj_sd = from_jax.ip_adapter_state_dicts(jparams, jproj)
    assert len(ip_sd) == 8
    m.load_state_dict({**from_jax.unet_state_dict(jparams), **ip_sd})
    proj = ip_adapter.ImageProjModel(CLIP_DIM, 32, NUM_TOKENS, **F32)
    proj.load_state_dict(proj_sd)
    return jparams, jproj, m, proj


def test_ip_image_embed_matches_jax(ip_unets):
    _, jproj, _, proj = ip_unets
    embeds = _unet_inputs(5)[3]
    with torch.no_grad():
        got = ip_adapter.ip_image_embed(proj, _t(embeds))
    _close(got, jip.ip_image_embed(jproj, jnp.asarray(embeds)), MODEL_TOL)


def test_unet_with_ip_tokens_matches_jax(ip_unets):
    """The UNet with IP tokens at scale 0.6 against JAX's; at scale 0 the
    base UNet's output exactly (the term is 0 · ip, added before to_out)."""
    jparams, _, m, _ = ip_unets
    x, t, ctx, _ = _unet_inputs(6)
    tok = np.random.default_rng(7).standard_normal((2, NUM_TOKENS, 32)).astype(np.float32)
    fwd = jax.jit(functools.partial(junet.unet_fwd, junet.TINY_UNET, JAX_CCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = fwd(jp, *args, ip_adapter_embeds=jnp.asarray(tok), ip_adapter_scale=0.6)
    base_ref = fwd(jp, *args)
    with torch.no_grad():
        got = m(_t(x), _t(t), _t(ctx), ip_adapter_embeds=_t(tok), ip_adapter_scale=0.6)
        zero = m(_t(x), _t(t), _t(ctx), ip_adapter_embeds=_t(tok),
                 ip_adapter_scale=torch.tensor(0.0))
        base = m(_t(x), _t(t), _t(ctx))
    assert np.abs(np.asarray(ref) - np.asarray(base_ref)).max() > 1e-3 * np.abs(base_ref).max()
    _close(got, ref, MODEL_TOL)
    _close(base, base_ref, MODEL_TOL)
    assert torch.equal(zero, base)


def test_ip_term_dtype_against_both_jax_paths():
    """bf16 attention with IP tokens.  JAX's stepwise path passes the scale
    as a Python float (the term stays bf16), its fused loop as a 0-d f32
    array (the term, and from there the attention's output, become f32).
    The port passes a 0-d f32 tensor on both paths, which does not promote
    a bf16 tensor: it mirrors the stepwise path, and is held against both."""
    dim, heads, ctx_dim = 32, 4, 24
    p = JL.init_attention(0, dim, heads, context_dim=ctx_dim, dtype=jnp.float32)
    rng = np.random.default_rng(8)
    p["ip_to_k"] = {"w": (rng.standard_normal((ctx_dim, dim)) * 0.2).astype(np.float32)}
    p["ip_to_v"] = {"w": (rng.standard_normal((ctx_dim, dim)) * 0.2).astype(np.float32)}
    x = rng.standard_normal((2, 10, dim)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, ctx_dim)).astype(np.float32)
    tok = rng.standard_normal((2, NUM_TOKENS, ctx_dim)).astype(np.float32)
    bf = jnp.bfloat16
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, bf), p)

    def jax_attn(scale):
        return JL.attention_fwd(jp, jnp.asarray(x, bf), jnp.asarray(ctx, bf), heads=heads,
                                ip_embeds=jnp.asarray(tok, bf), ip_scale=scale)

    stepwise, fused = jax_attn(0.6), jax_attn(jnp.float32(0.6))
    assert stepwise.dtype == bf and fused.dtype == jnp.float32
    m = L.Attention(dim, heads, context_dim=ctx_dim, device="cpu", dtype=torch.float32)
    m.add_ip_projections()
    sd = {}
    from_jax._put_attention(sd, "", p)
    from_jax._put_lin(sd, "to_k_ip", p["ip_to_k"])
    from_jax._put_lin(sd, "to_v_ip", p["ip_to_v"])
    m.load_state_dict(sd)
    m.to(torch.bfloat16)
    with torch.no_grad():
        got = m(_t(x).bfloat16(), _t(ctx).bfloat16(), ip_embeds=_t(tok),
                ip_scale=torch.tensor(0.6))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(stepwise, np.float32), BF16_TOL)
    _close(got.float(), np.asarray(fused, np.float32), BF16_TOL)
