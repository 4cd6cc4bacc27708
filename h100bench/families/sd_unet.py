"""The ``sd_unet`` family: SD1.5 and SDXL, a UNet2DConditionModel denoiser,
a KL VAE decoder and one or two CLIP text encoders, served through the
port's StableDiffusion pipelines from prompt token ids; and the graphed
LoRA train step of the UNet.

What the harness asks of a family, by name (README.md, "Adding a model
family"): the reference modules on ``meta`` by slot, the port's modules
and its compiled pipeline, the slots to range and the graphs to count,
the inputs of request ``i``, the reference's outputs of sampled requests,
the model FLOPs and the calls of the port's kernels; here also the train
step.  The parts are in ``families/sd_unet_lib/``.
"""

from typing import Dict, List, Sequence, Tuple

import torch

from families.sd_unet_lib import counts, port, prompts, reference, sampling
from hb import inputs
from hb.family import seeded_weights

# the slots, in the order of their weights' streams under the seed
SLOTS = ("unet", "vae", "text_encoder", "text_encoder_2")
# the slots the benchmark times by range: (range name, the methods the
# pipelines call besides __call__)
RANGED_SLOTS = {"text_encoder": ("text_encoder", ()), "text_encoder_2": ("text_encoder_2", ()),
                "unet": ("unet", ()), "vae": ("vae", ("decode",)),
                "scheduler": ("scheduler_step", ("step",))}
# the slots the train step holds
TRAIN_SLOTS = ("unet",)

port_modules = port.port_modules
build_pipeline = port.build_pipeline
pipeline_graphs = port.pipeline_graphs
lora_shapes = port.lora_shapes
build_train_step = port.build_train_step
train_call = port.train_call


def reference_modules(cfg: dict) -> Dict[str, torch.nn.Module]:
    """The configuration's reference modules on the ``meta`` device, by the
    pipeline slot they stand for."""
    with torch.device("meta"):
        mods = {"unet": reference.UNet2DConditionModel(cfg["unet"]),
                "vae": reference.AutoencoderKL(cfg["vae"])}
        for slot in ("text_encoder", "text_encoder_2"):
            if slot in cfg:
                mods[slot] = reference.CLIPTextModel(cfg[slot], cfg[slot]["eos_token_id"])
    return mods


def request_inputs(cfg: dict, seed: int, i: int) -> dict:
    """The pipeline's keyword arguments of request ``i``: its prompt ids
    (SDXL: and its second encoder's)."""
    ids = prompts.prompt_ids(seed, i)
    kw = {"prompt_ids": torch.from_numpy(ids)}
    if "text_encoder_2" in cfg:
        kw["prompt_ids_2"] = torch.from_numpy(prompts.ids_for_encoder_2(ids))
    return kw


def map_input(cfg: dict, seed: int, i: int):
    """The item ``pipe.map`` takes for request ``i``: its prompt ids."""
    return request_inputs(cfg, seed, i)["prompt_ids"]


def reference_models(cell, slots: Sequence[str], precision: str) -> Dict[str, torch.nn.Module]:
    """The configuration's reference modules on the cell's device, loaded
    with the seed's weights (drawn in the served dtype, then widened to
    float32), with their products in ``precision``."""
    reference.no_tf32()
    meta = reference_modules(cell.cfg)
    dtype = getattr(torch, cell.cfg["dtype"])
    out = {}
    for slot in slots:
        w = seeded_weights(cell, {slot: meta[slot]}, cell.device, dtype)[slot]
        m = meta[slot]
        m.load_state_dict({k: v.float() for k, v in w.items()}, strict=True, assign=True)
        out[slot] = reference.set_operand_precision(m.eval().requires_grad_(False), precision)
    return out


def reference_outputs(cell, requests: List[Tuple[int, int]],
                      precision: str = "float32") -> List[torch.Tensor]:
    """The reference's image of each request (index, image seed), as
    unrounded uint8 levels (H, W, 3) on the device."""
    models = reference_models(cell, [s for s in SLOTS if s in cell.cfg], precision)
    return [sampling.sample(cell.cfg, cell.traffic, models, prompts.prompt_ids(cell.seed, i),
                            seed, cell.device)[0]
            for i, seed in requests]


def train_pool(cell) -> dict:
    """The traffic's ``pool_steps`` batches of the train step, every row
    its own: clean latents (steps, B, hw, hw, C) and text embeddings
    (steps, B, S, D) in the configuration's dtype, timesteps (steps, B) and
    noise (steps, B, hw, hw, C) in float32, drawn on the device in four
    calls."""
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    steps, batch, hw = tr["pool_steps"], tr["batch"], tr["latent_hw"]
    channels, ctx_dim = cfg["vae"]["latent_channels"], cfg["unet"]["cross_attention_dim"]
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=dev).manual_seed(inputs.sub_seed(cell.seed, inputs.TRAIN_DATA))
    lat = torch.randn((steps, batch, hw, hw, channels), generator=gen, device=dev)
    ctx = torch.randn((steps, batch, prompts.SEQ, ctx_dim), generator=gen, device=dev)
    t = torch.randint(0, 1000, (steps, batch), generator=gen, device=dev)
    noise = torch.randn((steps, batch, hw, hw, channels), generator=gen, device=dev)
    return {"latents": lat.to(dtype), "context": ctx.to(dtype), "t": t, "noise": noise}


def reference_trainer(cell, precision: str = "float32") -> tuple:
    """(the reference UNet, its state dict, ᾱ on the device): what
    :func:`reference_training` runs, built once for several calls."""
    unet = reference_models(cell, ["unet"], precision)["unet"]
    ac = torch.as_tensor(sampling.alphas_cumprod(), dtype=torch.float32, device=cell.device)
    return unet, dict(unet.state_dict()), ac


def reference_training(cell, initial: Dict[str, torch.Tensor], batches: List[dict],
                       keep_rows: int = 0, state: dict = None, model: tuple = None) -> dict:
    """The reference's steps from the LoRA ``initial`` ({'<module>.a' or
    '.b': factor}) over ``batches`` (``training.train``'s result), from
    AdamW's ``state`` where given (``hb.program.adam_state``'s form), else
    from a fresh one; ``model`` is :func:`reference_trainer`'s (the
    control's is in fp8), the float32 one made here where not given."""
    from families.sd_unet_lib.training import train

    unet, base, ac = model or reference_trainer(cell)
    lora = {}
    for name, t in initial.items():
        mod, k = name.rsplit(".", 1)
        lora.setdefault(mod, {})[k] = t
    return train(unet, base, lora, batches, ac, cell.traffic["learning_rate"],
                 keep_rows=keep_rows, state=state)


def request_flops(cfg: dict, traffic: dict) -> dict:
    """{'text', 'unet_eval', 'decode', 'request'} model FLOPs of one image."""
    return counts.request_flops(reference_modules(cfg), cfg, traffic)


def train_step_flops(cfg: dict, traffic: dict) -> int:
    return counts.train_step_flops(reference_modules(cfg)["unet"], cfg, traffic)


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    """{kernel: {call shape: calls}} of the port's kernels one request
    makes, where reckoned (K1 and K2)."""
    return {"flash_attention": counts.k1_calls(cfg, traffic),
            "conv3x3": counts.k2_calls(cfg, traffic)}
