"""One rank of the gloo world that ``tests/test_torch_parallel.py`` spawns.

Imports torch and the port only (the children of a spawn import this
module, never the test file, which imports JAX).  :func:`run` reads the
parent's inputs (``torch.save``'d state dicts and arrays), runs every case
on its rank and saves ``{case: result}`` for the parent, which holds the
results against JAX.  A case that raises is saved as its traceback, so the
parent's test of that case fails with it and the other cases still run.
"""

import copy
import dataclasses
import datetime
import os
import sys
import traceback

import torch
import torch.distributed as dist

import sfast_tpu_torch
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.compilers import compile_model
from sfast_tpu_torch.lora import init_lora_params, switch_lora
from sfast_tpu_torch.models import (
    TINY_CONTROLNET, TINY_IMAGE_ENCODER, TINY_SVD_UNET, TINY_TEST_VAE, TINY_TEXT_ENCODER,
    TINY_UNET, AutoencoderKL, CLIPTextModel, CLIPVisionModel, ControlNetModel,
    UNet2DConditionModel, UNetSpatioTemporalConditionModel, init_weights_,
)
from sfast_tpu_torch.models.autoencoder_kl import VAEAttention
from sfast_tpu_torch.models.layers import Attention, FeedForward, Linear
from sfast_tpu_torch.parallel import make_mesh, shard_params
from sfast_tpu_torch.parallel import ring_attention as ring_module
from sfast_tpu_torch.parallel.ring_attention import ring_attention
from sfast_tpu_torch.parallel.tensor_parallel import (
    ParallelLinear,
    all_reduce,
    parallel_linears,
    shard_module,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.schedulers import DDIMScheduler
from sfast_tpu_torch.training import lora_factors, lora_training_setup, make_lora_train_step

WORLD = 4
UNET64 = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
F32 = dict(device="cpu", dtype=torch.float32)


def _unet(sd):
    m = UNet2DConditionModel(UNET64, **F32)
    m.load_state_dict(sd)
    return m


def case_mesh(inp):
    mesh = make_mesh((2, 2), ("dp", "tp"))
    out = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
           "device_type": mesh.device_type,
           "default": tuple(make_mesh(axis_names=("dp", "tp")).shape)}
    try:
        make_mesh((3, 3), ("dp", "tp"))
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    full = {"a.to_q.weight": torch.arange(32.0).reshape(8, 4), "a.to_q.bias": torch.arange(8.0),
            "a.to_out.0.weight": torch.arange(32.0).reshape(4, 8), "a.norm.weight": torch.ones(8)}
    out["shard_params"] = shard_params(full, mesh)
    out["tp_rank"] = mesh.get_local_rank("tp")
    # a GEGLU feed-forward: shard_params of its full weights against what
    # the sharded module holds, and the module's values
    gen = torch.Generator().manual_seed(3)
    ff = init_weights_(FeedForward(4, mult=2, **F32), gen)
    ff_full = {k: v.clone() for k, v in ff.state_dict().items()}
    x = torch.randn((2, 3, 4), generator=gen)
    with torch.no_grad():
        ref = ff(x)
        sharded = shard_module(ff, mesh)
        out["ff_err"] = (sharded(x) - ref).abs().max().item()
    out["ff_full"], out["ff_shard_params"] = ff_full, shard_params(ff_full, mesh)
    out["ff_module"] = {k: v.clone() for k, v in sharded.state_dict().items()}
    try:
        all_reduce(torch.zeros(1, device="meta"), mesh, "tp")
        out["wrong_device"] = None
    except ValueError as e:
        out["wrong_device"] = str(e)
    return out


def case_ring(inp):
    mesh = make_mesh((1, 1, WORLD), ("dp", "tp", "sp"))
    r = mesh.get_local_rank("sp")
    outs = []
    for q, k, v in inp["ring"]:
        n = q.shape[2] // WORLD
        shard = [t.narrow(2, r * n, n) for t in (q, k, v)]
        outs.append(ring_attention(*shard, mesh=mesh, axis="sp"))
    return outs


def case_ring_grad(inp):
    """The ring's gradients: each rank's shards of dq, dk and dv of
    sum(out · w)."""
    mesh = make_mesh((1, 1, WORLD), ("dp", "tp", "sp"))
    r = mesh.get_local_rank("sp")
    outs = []
    for (q, k, v), w in zip(inp["ring"], inp["ring_w"]):
        n = q.shape[2] // WORLD
        shard = [t.narrow(2, r * n, n).clone().requires_grad_(True) for t in (q, k, v)]
        out = ring_attention(*shard, mesh=mesh, axis="sp")
        (out * w.narrow(2, r * n, n)).sum().backward()
        outs.append([t.grad for t in shard])
    return outs


def _counting_ring():
    """A context that counts the calls of ``ring_attention`` into a list."""
    calls = []
    orig = ring_module.ring_attention

    class _Count:
        def __enter__(self):
            ring_module.ring_attention = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
            return calls

        def __exit__(self, *exc):
            ring_module.ring_attention = orig

    return _Count()


def _unet_case(inp, shape, names, rules=None, dp_slice=False):
    mesh = make_mesh(shape, names)
    m = compile_model(_unet(inp["unet"]), CompilationConfig(mesh=mesh, sharding_rules=rules),
                      name="unet")
    x, t, ctx = inp["x"], inp["t"], inp["ctx"]
    out = {}
    if dp_slice:
        r = mesh.get_local_rank("dp")
        n = x.shape[0] // mesh["dp"].size()
        x, t, ctx = (a.narrow(0, r * n, n) for a in (x, t, ctx))
        out["rows"] = (r * n, n)
    with torch.no_grad():
        out["y"] = m(x, t, ctx)
    at = m.module.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    out["kinds"] = {n: (type(getattr(at, n)).__name__, getattr(getattr(at, n), "mode", None),
                        getattr(getattr(at, n), "local", None)) for n in ("to_q", "to_k", "to_v")}
    out["heads"] = at.heads
    return out


def case_unet_dp_tp(inp):
    return _unet_case(inp, (2, 2), ("dp", "tp"), dp_slice=True)


def case_unet_tp(inp):
    return _unet_case(inp, (1, WORLD), ("dp", "tp"))


def case_unet_sp(inp):
    with _counting_ring() as calls:
        out = _unet_case(inp, (1, 1, WORLD), ("dp", "tp", "sp"))
    out["ring_calls"] = len(calls)
    return out


def case_unet_custom_rule(inp):
    return _unet_case(inp, (1, WORLD), ("dp", "tp"), rules=(("*.to_q.weight", (None, "tp")),))


def _pipe(inp, mesh, **cfg):
    tu = _unet(inp["unet"])
    tv = AutoencoderKL(TINY_TEST_VAE, **F32)
    tv.load_state_dict(inp["vae"])
    tt = CLIPTextModel(TINY_TEXT_ENCODER, **F32)
    tt.load_state_dict(inp["te"])
    return sfast_tpu_torch.compile(
        StableDiffusionPipeline(tu, tv, tt, DDIMScheduler(), vae_encode=tv, device="cpu",
                                dtype=torch.float32),
        CompilationConfig(mesh=mesh, **cfg))


def case_pipeline(inp):
    mesh = make_mesh((1, WORLD), ("dp", "tp"))
    out = {}
    for name, cfg in (("stepwise", {}), ("fused", dict(fuse_denoising_loop=True))):
        pipe = _pipe(inp, mesh, **cfg)
        out[name] = pipe(prompt_ids=inp["ids"], latents=inp["latents"], height=64, width=64,
                         num_inference_steps=2, output_type="latent").images
        if name == "fused":
            out["fused_loops"] = len(pipe._fused_loops)
        else:
            with torch.no_grad():
                out["decoded"] = pipe.vae(inp["dec_in"])
            out["clip_kinds"] = sorted({type(m).__name__ for m in
                                        pipe.text_encoder.module.modules()
                                        if isinstance(m, Linear)})
    return out


def _expected_shard(full, pl, rank, size):
    """The rank's slice of a full tensor, written out independently of
    ``take_shard``: contiguous rows or columns, or the slice of each half."""
    if pl.mode == "row":
        n = full.shape[1] // size
        return full[:, rank * n:(rank + 1) * n]
    if pl.chunks == 2:
        f = full.shape[0] // 2
        n = f // size
        return torch.cat([full[rank * n:(rank + 1) * n], full[f + rank * n:f + (rank + 1) * n]])
    n = full.shape[0] // size
    return full[rank * n:(rank + 1) * n]


def case_update_params(inp):
    mesh = make_mesh((1, WORLD), ("dp", "tp"))
    rank = mesh.get_local_rank("tp")
    unet = _unet(inp["unet"])
    base = {k: v.clone() for k, v in unet.state_dict().items()}
    m = compile_model(unet, CompilationConfig(mesh=mesh), name="unet")
    x, t, ctx = inp["x"], inp["t"], inp["ctx"]
    out = {}
    with torch.no_grad():
        m(x, t, ctx)
        size0 = m.cache_size
        new = {k: v * 1.01 for k, v in base.items()}
        m.update_params(new)
        worst, n_checked, chunked = 0.0, 0, 0
        for name, pl in parallel_linears(m.module).items():
            exp_w = _expected_shard(new[name + ".weight"], pl, rank, WORLD)
            worst = max(worst, (pl.weight - exp_w).abs().max().item())
            if pl.bias is not None:
                b = new[name + ".bias"]
                exp_b = (b if pl.mode == "row"
                         else _expected_shard(b[:, None], pl, rank, WORLD)[:, 0])
                worst = max(worst, (pl.bias - exp_b).abs().max().item())
            n_checked += 1
            chunked += pl.chunks == 2
        out.update(shard_err=worst, n_parallel=n_checked, n_chunked=chunked)
        ref_new = _unet(inp["unet"])
        ref_new.load_state_dict(new)
        out["updated_err"] = (m(x, t, ctx) - ref_new(x, t, ctx)).abs().max().item()
        try:
            m.update_params(m.module.state_dict())  # the shards: the wrong shapes
            out["local_dict"] = None
        except ValueError as e:
            out["local_dict"] = str(e)
        gen = torch.Generator().manual_seed(4)
        lora = init_lora_params(gen, base, rank=2)
        for f in lora.values():
            f["b"] = torch.randn(f["b"].shape, generator=gen) * 0.1
        switch_lora(m, base, lora, 0.7)
        merged = _unet(inp["unet"])
        switch_lora(compile_model(merged, CompilationConfig(), name="ref"), base, lora, 0.7)
        out["lora_err"] = (m(x, t, ctx) - merged(x, t, ctx)).abs().max().item()
        switch_lora(m, base, lora, 0.0)
        out["restored_err"] = (m(x, t, ctx) - _unet(inp["unet"])(x, t, ctx)).abs().max().item()
        out["cache_sizes"] = (size0, m.cache_size)
    return out


def case_ip_and_vae_attention(inp):
    """The IP-Adapter attention and the VAE's single-head attention, with
    JAX's weights, under tp = 4."""
    mesh = make_mesh((1, WORLD), ("dp", "tp"))
    out = {}
    ia, vaa = inp["ip_attn"], inp["vae_attn"]
    with torch.no_grad():
        attn = Attention(32, 4, context_dim=64, qkv_bias=True, **F32)
        attn.add_ip_projections()
        attn.load_state_dict(ia["sd"])
        sharded = shard_module(attn, mesh)
        out["ip"] = sharded(ia["x"], ia["ctx"], ip_embeds=ia["tok"], ip_scale=0.6)
        out["ip_kinds"] = {n: (getattr(sharded, n).mode, getattr(sharded, n).local)
                           for n in ("to_q", "to_k_ip", "to_v_ip")}
        out["ip_heads"] = sharded.heads
        try:
            sharded.add_ip_projections()
            out["ip_after"] = None
        except ValueError as e:
            out["ip_after"] = str(e)
        va = VAEAttention(32, 8, **F32)
        va.load_state_dict(vaa["sd"])
        sva = shard_module(va, mesh)
        out["vae_attn"] = sva(vaa["h"])
        out["vae_kinds"] = {n: (sva.to_q.mode, sva.to_q.local) for n in ("to_q",)}
        out["vae_out"] = (sva.to_out[0].mode, sva.to_out[0].local)
    return out


def case_other_models(inp):
    """The ControlNet, the SVD UNet (under tp and under sp) and the CLIP
    vision encoder, with JAX's weights, compiled with the mesh: their
    outputs, flattened, for the parent to hold against JAX's."""
    cn = ControlNetModel(TINY_CONTROLNET, **F32)
    cn.load_state_dict(inp["controlnet"]["sd"])
    svd = UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32)
    svd.load_state_dict(inp["svd"]["sd"])
    enc = CLIPVisionModel(TINY_IMAGE_ENCODER, **F32)
    enc.load_state_dict(inp["vision"]["sd"])
    out = {}
    with torch.no_grad():
        for name, shape, names, module, key in (
                ("controlnet", (1, WORLD), ("dp", "tp"), cn, "controlnet"),
                ("svd", (1, WORLD), ("dp", "tp"), svd, "svd"),
                ("svd_sp", (1, 1, WORLD), ("dp", "tp", "sp"), svd, "svd"),
                ("vision", (1, WORLD), ("dp", "tp"), enc, "vision")):
            cfg = CompilationConfig(mesh=make_mesh(shape, names))
            m = compile_model(copy.deepcopy(module), cfg, name=name)
            with _counting_ring() as calls:
                got = m(*inp[key]["args"])
            if name == "controlnet":
                got = torch.cat([t.flatten() for t in (*got[0], got[1])])
            elif name == "vision":
                got = got["image_embeds"]
            out[name] = (got, len(parallel_linears(m.module)), len(calls))
    return out


def _train(inp, shape, names, **cfg):
    mesh = make_mesh(shape, names)
    tr = inp["train"]
    unet = _unet(tr["unet"])
    ccfg = CompilationConfig(mesh=mesh, **cfg)
    m = compile_model(unet, ccfg, name="unet")
    lora, opt = lora_training_setup(m, rank=tr["rank"], generator=torch.Generator().manual_seed(0))
    init_diff = max((f[k].detach() - tr["lora0"][mod][k]).abs().max().item()
                    for mod, f in lora.items() for k in ("a", "b"))
    with torch.no_grad():
        for mod, f in lora.items():
            for k in ("a", "b"):
                f[k].copy_(tr["lora0"][mod][k])
    step = make_lora_train_step(m, opt, ccfg=ccfg)
    losses, loras = [], []
    with _counting_ring() as calls:
        for t, noise in tr["draws"]:
            losses.append(float(step(lora, tr["batch"], t=t, noise=noise)))
            loras.append({mod: {k: f[k].detach().clone() for k in ("a", "b")}
                          for mod, f in lora.items()})
    return {"losses": losses, "loras": loras, "init_diff": init_diff,
            "n_factors": len(lora_factors(lora)), "ring_calls": len(calls)}


def case_train(inp):
    return _train(inp, (2, 2), ("dp", "tp"), enable_kernels=False)


def case_train_tp_sp(inp):
    """tp × sp with the kernels' routes on: the UNet's self-attention
    through the ring, its backward through the ring's rotations."""
    return _train(inp, (1, 2, 2), ("dp", "tp", "sp"))


def case_imports(inp):
    """The modules of JAX or of the JAX package this process imported."""
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "sfast_tpu" or m.startswith("sfast_tpu."))


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def run(rank: int, store: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        inp = torch.load(in_path, weights_only=False)
        results = {}
        for name, fn in CASES.items():
            try:
                results[name] = fn(inp)
            except Exception:  # the parent's test of this case reports it
                results[name] = traceback.format_exc()
            dist.barrier()
        results["parallel_linear"] = ParallelLinear.__name__
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
