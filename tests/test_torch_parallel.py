"""The port's multi-device layer (``sfast_tpu_torch/parallel``) in a gloo
world of four CPU processes, against sfast_tpu's single-device results.

A module fixture spawns one world (``tests/torch_parallel_worker.py``,
whose processes import torch and the port only) that runs every case and
saves its results; the JAX references run here meanwhile (jitted,
``enable_pallas=False``, as ``tests/parallel/*`` run them).  Weights go to
the port through ``interop.from_jax``; inputs are drawn from a numpy seed.
Each test below asserts one case.

Tolerances: 2e-4, as JAX's own parallel tests (``tests/parallel/
test_ring_attention.py:29``, ``test_sharded_inference.py:57``): f32 sums in
another order (a row-parallel linear's partial sums, the ring's blocks).
The LoRA steps under dp × tp take ``tests/test_torch_training.py``'s bounds
against JAX (loss 1e-5 relative, factors 1e-6 absolute: its analysis of
Adam's first step holds at these draws); the ranks' factors agree exactly.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import sfast_tpu
import sfast_tpu_torch
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import clip_vision as jcv
from sfast_tpu.models import controlnet as jcn
from sfast_tpu.models import layers as JL
from sfast_tpu.models import unet_spatio_temporal as jsvd
from sfast_tpu.models.autoencoder_kl import TINY_TEST_VAE as J_TINY_VAE
from sfast_tpu.models.autoencoder_kl import _init_vae_attention, _vae_attention_fwd, create_vae
from sfast_tpu.models.clip_text import TINY_TEXT_ENCODER as J_TINY_TE
from sfast_tpu.models.clip_text import create_text_encoder
from sfast_tpu.models.unet_2d_condition import TINY_UNET as J_TINY_UNET
from sfast_tpu.models.unet_2d_condition import create_unet
from sfast_tpu.ops.attention import xla_attention
from sfast_tpu.parallel.sharding import unet_param_spec as jax_param_spec
from sfast_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from sfast_tpu.schedulers import DDIMScheduler as JaxDDIM
from sfast_tpu.version import __version__ as jax_version
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.compilers import compile_model
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import TINY_UNET, UNet2DConditionModel
from sfast_tpu_torch.parallel import make_mesh, unet_param_spec
from sfast_tpu_torch.runtime import cuda_build
from tests.test_torch_controlnet import jax_controlnet_params
from tests.test_torch_training import FACTOR_ABS, LOSS_REL, RANK, _batch, _port_steps
from tests.test_torch_training import jax_run  # noqa: F401  (a module fixture)

TOL = 2e-4
J_UNET64 = dataclasses.replace(J_TINY_UNET, cross_attention_dim=64)
J_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
RING_SHAPES = [(2, 4, 128, 32), (2, 4, 256, 64)]
WORKER_TIMEOUT_S = 300


def _np(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _other_models(rng):
    """JAX's weights for the models held against JAX one by one: the
    ControlNet (its zero convs drawn nonzero), the SVD UNet, the CLIP vision
    encoder, an attention with IP-Adapter projections and the VAE's
    single-head attention; with their inputs."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ip = JL.init_attention(0, 32, 4, context_dim=64, qkv_bias=True, dtype=jnp.float32)
    ip["ip_to_k"], ip["ip_to_v"] = ({"w": f32(64, 32) * 0.2} for _ in range(2))
    return {
        "controlnet": (jax_controlnet_params(jcn.TINY_CONTROLNET, 0),
                       (f32(2, 16, 16, 4), np.asarray([801.0, 261.0], np.float32), f32(2, 7, 32),
                        rng.uniform(0.0, 1.0, (2, 32, 32, 3)).astype(np.float32))),
        "svd": (jsvd.init_svd_unet_params(jax.random.key(1), jsvd.TINY_SVD_UNET),
                (f32(1, 4, 16, 16, 8), np.asarray([20.0], np.float32), f32(1, 1, 32),
                 np.asarray([[6.0, 127.0, 0.02]], np.float32))),
        "vision": (jcv.init_clip_vision_params(0, jcv.TINY_IMAGE_ENCODER), (f32(1, 32, 32, 3),)),
        "ip_attn": (ip, (f32(2, 16, 32), f32(2, 7, 64), f32(2, 4, 64))),
        "vae_attn": (_init_vae_attention(0, 32, jnp.float32), (f32(1, 8, 8, 32),)),
    }


def _port_inputs(other):
    """The port's state dicts and inputs of :func:`_other_models`."""
    tt = lambda args: tuple(torch.from_numpy(np.asarray(a)) for a in args)  # noqa: E731
    ip, (x, ctx, tok) = other["ip_attn"]
    ip_sd = {}
    from_jax._put_attention(ip_sd, "", ip)
    from_jax._put_lin(ip_sd, "to_k_ip", ip["ip_to_k"])
    from_jax._put_lin(ip_sd, "to_v_ip", ip["ip_to_v"])
    va, (h,) = other["vae_attn"]
    va_sd = {}
    from_jax._put_attention(va_sd, "", va)
    from_jax._put_norm(va_sd, "group_norm", va["group_norm"])
    return {
        **{name: {"sd": writer(other[name][0]), "args": tt(other[name][1])}
           for name, writer in (("controlnet", from_jax.controlnet_state_dict),
                                ("svd", from_jax.svd_unet_state_dict),
                                ("vision", from_jax.clip_vision_state_dict))},
        "ip_attn": dict(zip(("x", "ctx", "tok"), tt((x, ctx, tok))), sd=ip_sd),
        "vae_attn": {"sd": va_sd, "h": tt((h,))[0]},
    }


def _jax_refs(unet, dec, te, inp, other):
    """JAX's single-device results for the world's cases."""
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    refs = {"ring": [np.asarray(xla_attention(*map(j, qkv))) for qkv in inp["ring"]]}
    refs["ring_grad"] = [
        [np.asarray(g) for g in jax.grad(
            lambda q, k, v, w=j(w): jnp.sum(xla_attention(q, k, v) * w), argnums=(0, 1, 2))(
                *map(j, qkv))]
        for qkv, w in zip(inp["ring"], inp["ring_w"])]
    apply = jax.jit(unet.apply_fn(J_CCFG))
    x, t, ctx = (j(inp[k]) for k in ("x", "t", "ctx"))
    refs["unet"] = np.asarray(apply(unet.params, x, t, ctx))
    ids, lat = j(inp["ids"]), j(inp["latents"])
    for name, cfg in (("stepwise", J_CCFG), ("fused", J_CCFG.replace(fuse_denoising_loop=True))):
        pipe = sfast_tpu.compile(JaxPipeline(unet=unet, vae=dec, text_encoder=te,
                                             scheduler=JaxDDIM(), dtype=jnp.float32), cfg)
        refs[name] = np.asarray(pipe(prompt_ids=ids, latents=lat, height=64, width=64,
                                     num_inference_steps=2, output_type="latent").images)
        if name == "stepwise":
            refs["decoded"] = np.asarray(pipe.vae(j(inp["dec_in"])))
    p, args = other["controlnet"]
    down, mid = jax.jit(functools.partial(jcn.controlnet_fwd, jcn.TINY_CONTROLNET, J_CCFG))(
        p, *map(jnp.asarray, args))
    refs["controlnet"] = np.concatenate([np.asarray(r).ravel() for r in (*down, mid)])
    p, args = other["svd"]
    refs["svd"] = np.asarray(jax.jit(functools.partial(
        jsvd.svd_unet_fwd, jsvd.TINY_SVD_UNET, J_CCFG))(p, *map(jnp.asarray, args)))
    p, (px,) = other["vision"]
    refs["vision"] = np.asarray(jax.jit(functools.partial(
        jcv.clip_vision_fwd, jcv.TINY_IMAGE_ENCODER, J_CCFG))(p, jnp.asarray(px))["image_embeds"])
    p, (xi, ci, ti) = other["ip_attn"]
    refs["ip"] = np.asarray(JL.attention_fwd(p, jnp.asarray(xi), jnp.asarray(ci), heads=4,
                                             ip_embeds=jnp.asarray(ti), ip_scale=0.6))
    p, (h,) = other["vae_attn"]
    refs["vae_attn"] = np.asarray(_vae_attention_fwd(p, jnp.asarray(h), groups=8))
    return refs


@pytest.fixture(scope="module")
def world(jax_run):  # noqa: F811
    """(results per rank, JAX's references): the world runs while JAX
    computes."""
    unet = create_unet(J_UNET64, jax.random.key(1))
    dec, _ = create_vae(J_TINY_VAE, jax.random.key(0))
    te = create_text_encoder(J_TINY_TE, jax.random.key(2))
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    params, lora0, steps = jax_run
    inp = {
        "unet": from_jax.unet_state_dict(unet.params),
        "vae": from_jax.vae_state_dict(dec.params),
        "te": from_jax.clip_text_state_dict(te.params),
        "x": f32(2, 16, 16, 4), "t": torch.tensor([7.0, 503.0]), "ctx": f32(2, 7, 64),
        "ring": [tuple(f32(*s) for _ in range(3)) for s in RING_SHAPES],
        "ring_w": [f32(*s) for s in RING_SHAPES],
        "ids": torch.from_numpy(rng.integers(0, 1000, (1, 77)).astype(np.int32)),
        "latents": f32(1, 32, 32, 4), "dec_in": f32(1, 32, 32, 4),
        "train": {"unet": from_jax.unet_state_dict(params), "rank": RANK, "lora0": lora0,
                  "batch": _np(_batch()), "draws": [(t, noise) for _, _, t, noise in steps]},
    }
    other = _other_models(rng)
    inp.update(_port_inputs(other))
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.pt")
        torch.save(inp, in_path)
        from tests import torch_parallel_worker as worker

        ctx = mp.start_processes(worker.run, args=(os.path.join(tmp, "store"), in_path, tmp),
                                 nprocs=worker.WORLD, join=False, start_method="spawn")
        try:
            refs = _jax_refs(unet, dec, te, inp, other)
        finally:
            while not ctx.join(timeout=WORKER_TIMEOUT_S):
                pass
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(worker.WORLD)]
    return ranks, refs, inp


def _case(world, name):
    """Each rank's result of case ``name``; a case that raised fails here
    with its traceback."""
    ranks = world[0]
    for r, res in enumerate(ranks):
        if isinstance(res[name], str):
            pytest.fail(f"rank {r}, case {name}:\n{res[name]}")
    return [res[name] for res in ranks]


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol)


def test_make_mesh_without_a_process_group_raises():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("dp", "tp"))


def test_make_mesh_shapes(world):
    for res in _case(world, "mesh"):
        assert res["shape"] == (2, 2) and res["names"] == ("dp", "tp")
        assert res["default"] == (1, 4) and res["device_type"] == "cpu"
        assert "device count 4" in res["mismatch"]
        assert "meta tensor on a cpu mesh" in res["wrong_device"]
        r, sp = res["tp_rank"], res["shard_params"]
        full = torch.arange(32.0)
        assert torch.equal(sp["a.to_q.weight"], full.reshape(8, 4)[4 * r:4 * r + 4])
        assert torch.equal(sp["a.to_out.0.weight"], full.reshape(4, 8)[:, 4 * r:4 * r + 4])
        assert torch.equal(sp["a.norm.weight"], torch.ones(8))
        assert torch.equal(sp["a.to_q.bias"], torch.arange(8.0)[4 * r:4 * r + 4])
        # the GEGLU's (16, 4) proj: of each half (hidden, gate) the rank's 4
        # rows; shard_params is what the sharded module holds
        full, mine = res["ff_full"], res["ff_shard_params"]
        for key in ("net.0.proj.weight", "net.0.proj.bias"):
            want = torch.cat([full[key][4 * r:4 * r + 4], full[key][8 + 4 * r:8 + 4 * r + 4]])
            assert torch.equal(mine[key], want), key
        assert torch.equal(mine["net.2.weight"], full["net.2.weight"][:, 4 * r:4 * r + 4])
        assert sorted(mine) == sorted(res["ff_module"])
        assert all(torch.equal(mine[k], res["ff_module"][k]) for k in mine)
        assert res["ff_err"] <= TOL


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


_TO_PORT = {P(None, "tp"): ("tp", None), P("tp", None): (None, "tp"), P(): ()}


@pytest.mark.parametrize("model", ["unet", "clip", "vae"])
def test_param_spec_matches_jax(model):
    """The port's rule on its names against JAX's on the same JAX paths:
    every 2-D weight, in the port's (out, in) layout."""
    if model == "unet":
        params, writer = create_unet(J_UNET64, jax.random.key(1)).params, from_jax.unet_state_dict
    elif model == "clip":
        params = create_text_encoder(J_TINY_TE, jax.random.key(2)).params
        writer = from_jax.clip_text_state_dict
    else:
        params, writer = create_vae(J_TINY_VAE, jax.random.key(0))[0].params, \
            from_jax.vae_state_dict
    sd = writer(params)
    names = from_jax.module_names(params, writer)
    seen, split = set(), 0
    for path, mod in names.items():
        leaf = _leaf(params, path)
        if np.ndim(leaf) != 2:
            continue
        want = _TO_PORT[jax_param_spec(path, leaf)]
        assert unet_param_spec(mod + ".weight", sd[mod + ".weight"]) == want, (path, mod)
        seen.add(mod + ".weight")
        split += want != ()
    # every other 2-D tensor (embeddings) is replicated, as JAX's non-"w" leaves
    for key, t in sd.items():
        if t.dim() == 2 and key not in seen:
            assert unet_param_spec(key, t) == (), key
    assert split > 0


@pytest.mark.parametrize("i", range(len(RING_SHAPES)))
def test_ring_attention_matches_jax(world, i):
    out = torch.cat([res[i] for res in _case(world, "ring")], dim=2)
    assert out.shape == RING_SHAPES[i]
    _close(out, world[1]["ring"][i])


@pytest.mark.parametrize("i", range(len(RING_SHAPES)))
def test_ring_attention_gradients_match_jax(world, i):
    """The gradients of sum(out · w) through the ring: every rank's queries'
    K and V gradients reach the rank that holds the shard (the rotation's
    adjoint), against JAX's ``jax.grad`` of ``xla_attention``."""
    per_rank = [res[i] for res in _case(world, "ring_grad")]  # each rank: its dq, dk, dv
    for got, ref in zip(zip(*per_rank), world[1]["ring_grad"][i]):
        _close(torch.cat(got, dim=2), ref)


def test_unet_dp_tp_matches_jax(world):
    """(2, 2) dp × tp: each rank its dp row, the heads split over tp."""
    ref = world[1]["unet"]
    rows = set()
    for res in _case(world, "unet_dp_tp"):
        start, n = res["rows"]
        rows.add(start)
        _close(res["y"], ref[start:start + n])
        assert res["heads"] == 2
        assert all(k == ("ParallelLinear", "column", True) for k in res["kinds"].values())
    assert rows == {0, 1}


def test_unet_tp_matches_jax(world):
    for res in _case(world, "unet_tp"):
        _close(res["y"], world[1]["unet"])
        assert res["heads"] == 1


def test_unet_sp_ring_matches_jax(world):
    """(1, 1, 4): self-attention through the ring (16² and 8² tokens divide
    by 4; the 7-token context does not and takes the plain path)."""
    for res in _case(world, "unet_sp"):
        _close(res["y"], world[1]["unet"])
        assert res["ring_calls"] == 4  # every attn1: 16² tokens (down, 2 up), 8² (mid)
        assert res["heads"] == 4  # tp = 1: every head on every rank


def test_custom_rule_keeps_values(world):
    """``to_q`` row-split by a custom rule: outside its pair it slices its
    input and all-reduces; ``to_k`` and ``to_v`` stay replicated."""
    for res in _case(world, "unet_custom_rule"):
        _close(res["y"], world[1]["unet"])
        assert res["kinds"] == {"to_q": ("ParallelLinear", "row", False),
                                "to_k": ("Linear", None, None), "to_v": ("Linear", None, None)}
        assert res["heads"] == 4


@pytest.mark.parametrize("mode", ["stepwise", "fused"])
def test_pipeline_under_tp_matches_jax(world, mode):
    """The tiny SD1.5 pipeline (DDIM 2 steps, 64², f32) compiled with a
    (1, 4) mesh, against JAX's single-device latents."""
    for res in _case(world, "pipeline"):
        _close(res[mode], world[1][mode])
        if mode == "fused":
            assert res["fused_loops"] == 1
        else:
            assert res["clip_kinds"] == ["ParallelLinear"]


def test_vae_decode_under_tp_matches_jax(world):
    for res in _case(world, "pipeline"):
        _close(res["decoded"], world[1]["decoded"])


def test_update_params_and_switch_lora_under_mesh(world):
    for res in _case(world, "update_params"):
        # 4 transformer blocks: 10 linears, 1 GEGLU each
        assert res["shard_err"] == 0.0 and res["n_parallel"] == 40 and res["n_chunked"] == 4
        assert res["updated_err"] <= TOL
        assert "the module's is" in res["local_dict"]
        assert res["lora_err"] <= TOL and res["restored_err"] <= TOL
        assert res["cache_sizes"][0] == res["cache_sizes"][1]


def test_ip_adapter_attention_under_tp(world):
    for res in _case(world, "ip_and_vae_attention"):
        _close(res["ip"], world[1]["ip"])
        assert res["ip_kinds"] == {n: ("column", True) for n in ("to_q", "to_k_ip", "to_v_ip")}
        assert res["ip_heads"] == 1
        assert "before sharding" in res["ip_after"]


def test_vae_single_head_attention_under_tp(world):
    for res in _case(world, "ip_and_vae_attention"):
        _close(res["vae_attn"], world[1]["vae_attn"])
        assert res["vae_kinds"] == {"to_q": ("column", False)}
        assert res["vae_out"] == ("row", False)


@pytest.mark.parametrize("model", ["controlnet", "svd", "svd_sp", "vision"])
def test_other_models_under_the_mesh_keep_their_values(world, model):
    """``compile`` shards every model it wraps: the ControlNet, the SVD UNet
    (also under sp, its spatial and temporal attention through the ring)
    and the CLIP vision encoder, each against JAX's single-device forward,
    2e-4 of the output's scale where it exceeds 1."""
    ref = world[1][model.split("_")[0]]
    for res in _case(world, "other_models"):
        got, n_parallel, ring_calls = res[model]
        err = (got - torch.from_numpy(np.array(ref))).abs().max().item()
        scale = float(np.abs(ref).max())
        assert tuple(got.shape) == ref.shape
        assert err <= TOL * max(1.0, scale), (err, scale)
        assert n_parallel > 0  # under sp: the tp axis of 1 still wraps them
        assert (ring_calls > 0) == (model == "svd_sp")


def _check_train(world, jax_run, case):  # noqa: F811
    """Every rank's LoRA equal, and equal to the single-process port's and to
    JAX's two steps."""
    params, lora0, steps = jax_run
    res = _case(world, case)
    assert res[0]["init_diff"] == 0.0
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for a, b in zip(r["loras"], res[0]["loras"]):
            assert all(torch.equal(a[m][k], b[m][k]) for m in a for k in ("a", "b"))
    _, _, port_losses, _ = _port_steps(params, lora0, steps)
    for i, ((ref_loss, ref_lora, _, _), loss) in enumerate(zip(steps, res[0]["losses"])):
        assert abs(loss - ref_loss) <= LOSS_REL * abs(ref_loss), (i, loss, ref_loss)
        assert abs(loss - port_losses[i]) <= LOSS_REL * abs(port_losses[i])
        err = max((res[0]["loras"][i][m][k] - ref_lora[m][k]).abs().max().item()
                  for m in ref_lora for k in ("a", "b"))
        assert err <= FACTOR_ABS, (i, err)
    return res


def test_lora_train_steps_under_dp_tp_match_jax(world, jax_run):  # noqa: F811
    """Two steps under (2, 2), the kernels off."""
    res = _check_train(world, jax_run, "train")
    assert res[0]["ring_calls"] == 0


def test_lora_train_steps_under_tp_sp_match_jax(world, jax_run):  # noqa: F811
    """Two steps under (1, 2, 2) dp × tp × sp with the kernels' routes on:
    the self-attention runs through the ring (4 calls a forward), and its
    K/V gradients come back through the rotations."""
    res = _check_train(world, jax_run, "train_tp_sp")
    assert all(r["ring_calls"] == 8 for r in res)


def test_world_imports_no_jax(world):
    for res in _case(world, "imports"):
        assert res == []


def test_cache_dir_names_the_build_dir(tmp_path, monkeypatch):
    """The first ``cache_dir`` fixes the process's build directory; None
    names none, and another directory raises."""
    monkeypatch.setattr(cuda_build, "_build_dir", cuda_build.BUILD_DIR)
    monkeypatch.setattr(cuda_build, "_build_dir_fixed", False)
    unet = UNet2DConditionModel(TINY_UNET, device="cpu", dtype=torch.float32)
    m = compile_model(unet, CompilationConfig(cache_dir=str(tmp_path)))
    assert cuda_build.library_path().parent == tmp_path.resolve()
    m.set_compilation_config(CompilationConfig())
    m.set_compilation_config(CompilationConfig(cache_dir=str(tmp_path)))
    assert cuda_build.library_path().parent == tmp_path.resolve()
    with pytest.raises(ValueError, match="cannot change it"):
        m.set_compilation_config(CompilationConfig(cache_dir=str(tmp_path / "other")))
    assert cuda_build.library_path().parent == tmp_path.resolve()


def test_version_is_jax_packages():
    assert sfast_tpu_torch.__version__ == jax_version


def test_parallel_package_imports_without_jax():
    code = ("import sys; import sfast_tpu_torch.parallel.tensor_parallel, "
            "sfast_tpu_torch.parallel.ring_attention; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'sfast_tpu.'))"
            " or m == 'sfast_tpu']; print(bad); sys.exit(bool(bad))")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
