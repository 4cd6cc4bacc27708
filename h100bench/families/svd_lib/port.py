"""The system under test of the ``svd`` family: the port's spatio-temporal
UNet, temporal VAE and CLIP vision encoder, its StableVideoDiffusion
pipeline and EDM scheduler, built from a configuration file as a user
builds them, with the benchmark's weights loaded by
``load_state_dict(strict=True)``.

Everything of ``sfast_tpu_torch`` is imported inside these functions, so
that the reference and the tests can import the family without the
program.
"""

from typing import Dict

import torch

from families.sd_unet_lib.port import per_level
from hb.program import compilation_config


def port_configs(cfg: dict) -> dict:
    """The port's model configs for the published ``cfg``."""
    from sfast_tpu_torch.models.autoencoder_kl_temporal import TemporalVAEConfig
    from sfast_tpu_torch.models.clip_vision import CLIPVisionConfig
    from sfast_tpu_torch.models.unet_spatio_temporal import SVDUNetConfig

    u, v, e = cfg["unet"], cfg["vae"], cfg["image_encoder"]
    n = len(u["block_out_channels"])
    return {
        "unet": SVDUNetConfig(
            sample_size=u["sample_size"], in_channels=u["in_channels"],
            out_channels=u["out_channels"], block_out_channels=tuple(u["block_out_channels"]),
            down_block_types=tuple(u["down_block_types"]),
            up_block_types=tuple(u["up_block_types"]), layers_per_block=u["layers_per_block"],
            transformer_layers_per_block=per_level(u.get("transformer_layers_per_block", 1), n),
            num_heads=per_level(u["num_attention_heads"], n),
            cross_attention_dim=u["cross_attention_dim"],
            addition_time_embed_dim=u["addition_time_embed_dim"],
            projection_class_embeddings_input_dim=u["projection_class_embeddings_input_dim"],
            num_frames=u["num_frames"], norm_num_groups=u.get("norm_num_groups", 32)),
        "vae": TemporalVAEConfig(
            in_channels=v["in_channels"], out_channels=v["out_channels"],
            latent_channels=v["latent_channels"], block_out_channels=tuple(v["block_out_channels"]),
            layers_per_block=v["layers_per_block"], norm_num_groups=v.get("norm_num_groups", 32),
            scaling_factor=v["scaling_factor"]),
        "image_encoder": CLIPVisionConfig(
            image_size=e["image_size"], patch_size=e["patch_size"], hidden_size=e["hidden_size"],
            intermediate_size=e["intermediate_size"], num_layers=e["num_hidden_layers"],
            num_heads=e["num_attention_heads"], projection_dim=e["projection_dim"],
            hidden_act=e["hidden_act"]),
    }


def port_modules(cfg: dict, weights: Dict[str, dict], device, slots=None) -> dict:
    """The port's models of ``cfg`` on ``device`` in the configuration's
    dtype, each loaded from ``weights[slot]`` strictly."""
    from sfast_tpu_torch.models import (
        AutoencoderKLTemporalDecoder,
        CLIPVisionModel,
        UNetSpatioTemporalConditionModel,
    )

    dtype = getattr(torch, cfg["dtype"])
    classes = {"unet": UNetSpatioTemporalConditionModel, "vae": AutoencoderKLTemporalDecoder,
               "image_encoder": CLIPVisionModel}
    confs = port_configs(cfg)
    mods = {}
    for slot in slots or weights:
        m = classes[slot](confs[slot], device=device, dtype=dtype)
        m.load_state_dict(weights[slot], strict=True)
        mods[slot] = m.eval().requires_grad_(False)
    return mods


def scheduler(cfg: dict):
    """The port's EDM Euler scheduler with the published scheduler config's
    sigmas.  The config's prediction type is v-prediction, which the port's
    step must take (c_out < 0): one step from zero latents on a model output
    of ones moves them below zero.  A step of Karras' sign (c_out > 0)
    renders clips far off the reference; it is refused here, before any
    weight is drawn."""
    from sfast_tpu_torch.schedulers import EDMEulerScheduler

    s = cfg["scheduler"]
    if s["prediction_type"] != "v_prediction":
        raise ValueError(f"the port's EDM step predicts v, not {s['prediction_type']!r}")
    sch = EDMEulerScheduler(sigma_min=s["sigma_min"], sigma_max=s["sigma_max"], rho=s["rho"])
    x = torch.zeros(1, 1, 1, 1)
    moved, _ = sch.step(sch.device_state(sch.set_timesteps(2), "cpu"), torch.ones_like(x), 0, x)
    if moved.item() > 0:
        raise ValueError("the port's EDM step takes Karras' c_out, not v-prediction's")
    return sch


def build_pipeline(cfg: dict, traffic: dict, mods: dict, device, cache_dir: str):
    """The image-to-video pipeline through ``sfast_tpu_torch.compile`` under
    the traffic's config."""
    import sfast_tpu_torch
    from sfast_tpu_torch.pipelines import StableVideoDiffusionPipeline

    pipe = StableVideoDiffusionPipeline(mods["unet"], mods["vae"], mods["image_encoder"],
                                        scheduler(cfg), device=device,
                                        dtype=getattr(torch, cfg["dtype"]))
    return sfast_tpu_torch.compile(pipe, compilation_config(traffic, cache_dir))


def pipeline_graphs(pipe) -> list:
    """Every CUDA graph ``pipe`` holds: its compiled slots', its compiled
    scheduler step's, its decode's (one a chunk size) and any fused loop's."""
    out = []
    for slot in ("image_encoder", "vae_encode", "unet", "vae"):
        call = getattr(getattr(pipe, slot, None), "_call", None)
        if call is not None:
            out += call.graphs()
    fns = [getattr(pipe.scheduler, "_step", None), getattr(pipe, "_decode_u8", None),
           *getattr(pipe, "_fused_loops", {}).values()]
    for fn in fns:
        if hasattr(fn, "graphs"):
            out += fn.graphs()
    return out
