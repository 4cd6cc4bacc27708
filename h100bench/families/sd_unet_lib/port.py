"""The system under test of the ``sd_unet`` family: the port's UNet, VAE and
CLIP text encoders, its StableDiffusion pipelines and its LoRA train step,
built from a configuration file as a user builds them, with the
benchmark's weights loaded by ``load_state_dict(strict=True)``.

Everything of ``sfast_tpu_torch`` is imported inside these functions, so
that the reference and the tests can import the family without the
program.
"""

from typing import Dict

import torch

from hb.program import compilation_config


def per_level(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def port_configs(cfg: dict) -> dict:
    """The port's model configs for the published ``cfg``."""
    from sfast_tpu_torch.models.autoencoder_kl import VAEConfig
    from sfast_tpu_torch.models.clip_text import CLIPTextConfig
    from sfast_tpu_torch.models.unet_2d_condition import UNetConfig

    u = cfg["unet"]
    n = len(u["block_out_channels"])
    out = {"unet": UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"],
        out_channels=u["out_channels"], block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=tuple(u["down_block_types"]), up_block_types=tuple(u["up_block_types"]),
        layers_per_block=u["layers_per_block"],
        transformer_layers_per_block=per_level(u.get("transformer_layers_per_block", 1), n),
        num_heads=per_level(u["attention_head_dim"], n),
        cross_attention_dim=u["cross_attention_dim"],
        use_linear_projection=u.get("use_linear_projection", False),
        addition_embed_type=u.get("addition_embed_type"),
        addition_time_embed_dim=u.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=u.get("projection_class_embeddings_input_dim"),
        norm_num_groups=u["norm_num_groups"], flip_sin_to_cos=u.get("flip_sin_to_cos", True),
        freq_shift=u.get("freq_shift", 0))}
    v = cfg["vae"]
    out["vae"] = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"],
                           latent_channels=v["latent_channels"],
                           block_out_channels=tuple(v["block_out_channels"]),
                           layers_per_block=v["layers_per_block"],
                           norm_num_groups=v["norm_num_groups"],
                           scaling_factor=v["scaling_factor"])
    for slot in ("text_encoder", "text_encoder_2"):
        if slot in cfg:
            t = cfg[slot]
            proj = t["projection_dim"] if t["architectures"][0].endswith("Projection") else None
            out[slot] = CLIPTextConfig(
                vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                intermediate_size=t["intermediate_size"], num_layers=t["num_hidden_layers"],
                num_heads=t["num_attention_heads"],
                max_position_embeddings=t["max_position_embeddings"], hidden_act=t["hidden_act"],
                projection_dim=proj, eos_token_id=t["eos_token_id"],
                pad_token_id=t["pad_token_id"])
    return out


def port_modules(cfg: dict, weights: Dict[str, dict], device, slots=None) -> dict:
    """The port's models of ``cfg`` on ``device`` in the configuration's
    dtype, each loaded from ``weights[slot]`` strictly."""
    from sfast_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel

    dtype = getattr(torch, cfg["dtype"])
    classes = {"unet": UNet2DConditionModel, "vae": AutoencoderKL, "text_encoder": CLIPTextModel,
               "text_encoder_2": CLIPTextModel}
    confs = port_configs(cfg)
    mods = {}
    for slot in slots or weights:
        m = classes[slot](confs[slot], device=device, dtype=dtype)
        m.load_state_dict(weights[slot], strict=True)
        mods[slot] = m.eval().requires_grad_(False)
    return mods


def build_pipeline(cfg: dict, traffic: dict, mods: dict, device, cache_dir: str):
    """The configuration's pipeline with the traffic's scheduler, through
    ``sfast_tpu_torch.compile`` under the traffic's config."""
    import sfast_tpu_torch
    from sfast_tpu_torch import pipelines, schedulers

    dtype = getattr(torch, cfg["dtype"])
    sched = getattr(schedulers, traffic["scheduler"])()
    cls = getattr(pipelines, cfg["pipeline"])
    if "text_encoder_2" in mods:
        pipe = cls(mods["unet"], mods["vae"], mods["text_encoder"], mods["text_encoder_2"], sched,
                   device=device, dtype=dtype)
    else:
        pipe = cls(mods["unet"], mods["vae"], mods["text_encoder"], sched, device=device,
                   dtype=dtype)
    return sfast_tpu_torch.compile(pipe, compilation_config(traffic, cache_dir))


def pipeline_graphs(pipe) -> list:
    """Every CUDA graph ``pipe`` holds: its compiled slots' and its
    compiled scheduler step's."""
    out = []
    for slot in ("text_encoder", "text_encoder_2", "unet", "vae"):
        call = getattr(getattr(pipe, slot, None), "_call", None)
        if call is not None:
            out += call.graphs()
    step = getattr(pipe.scheduler, "_step", None)
    if step is not None:
        out += step.graphs()
    return out


def lora_shapes(mods: dict) -> Dict[str, torch.Size]:
    """{module: its weight's (out, in)} of the UNet's attention projections
    a LoRA goes into, sorted."""
    state = mods["unet"].state_dict()
    targets = sorted(k[:-len(".weight")] for k, w in state.items()
                     if w.dim() == 2 and k.endswith((".to_q.weight", ".to_k.weight",
                                                     ".to_v.weight", ".to_out.0.weight")))
    return {m: state[m + ".weight"].shape for m in targets}


def build_train_step(mods: dict, traffic: dict, lora_init: dict, cache_dir: str):
    """(step, lora, optimizer): the port's graphed LoRA train step over the
    UNet with the benchmark's initial LoRA copied into its factors."""
    from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step

    unet = mods["unet"]
    lora, opt = lora_training_setup(unet, rank=traffic["rank"],
                                    learning_rate=traffic["learning_rate"])
    if set(lora) != set(lora_init):
        raise ValueError("the program's LoRA targets are not the benchmark's")
    with torch.no_grad():
        for mod, f in lora.items():
            f["a"].copy_(lora_init[mod]["a"])
            f["b"].copy_(lora_init[mod]["b"])
    step = make_lora_train_step(unet, opt, ccfg=compilation_config(traffic, cache_dir))
    return step, lora, opt


def train_call(step, lora: dict, batch: dict):
    """One call of the train step on ``batch`` (a batch of the family's
    pool): its loss."""
    return step(lora, {"latents": batch["latents"], "context": batch["context"]},
                t=batch["t"], noise=batch["noise"])
