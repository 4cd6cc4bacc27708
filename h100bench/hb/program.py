"""The system under test: the port's pipelines and train step, built from a
configuration file as a user builds them, with the benchmark's weights
loaded by ``load_state_dict(strict=True)``.

Everything of ``sfast_tpu_torch`` is imported inside these functions, so
that the reference and the tests can import this module's neighbours
without the program.
"""

from typing import Callable, Dict

import torch

from hb.reference import AutoencoderKL, CLIPTextModel, UNet2DConditionModel


def per_level(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def reference_modules(cfg: dict) -> Dict[str, torch.nn.Module]:
    """The configuration's reference modules on the ``meta`` device, by the
    pipeline slot they stand for."""
    with torch.device("meta"):
        mods = {"unet": UNet2DConditionModel(cfg["unet"]), "vae": AutoencoderKL(cfg["vae"])}
        for slot in ("text_encoder", "text_encoder_2"):
            if slot in cfg:
                mods[slot] = CLIPTextModel(cfg[slot], cfg[slot]["eos_token_id"])
    return mods


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
    from sfast_tpu_torch.models import AutoencoderKL as PortVAE
    from sfast_tpu_torch.models import CLIPTextModel as PortCLIP
    from sfast_tpu_torch.models import UNet2DConditionModel as PortUNet

    dtype = getattr(torch, cfg["dtype"])
    classes = {"unet": PortUNet, "vae": PortVAE, "text_encoder": PortCLIP,
               "text_encoder_2": PortCLIP}
    confs = port_configs(cfg)
    mods = {}
    for slot in slots or weights:
        m = classes[slot](confs[slot], device=device, dtype=dtype)
        m.load_state_dict(weights[slot], strict=True)
        mods[slot] = m.eval().requires_grad_(False)
    return mods


def compilation_config(traffic: dict, cache_dir: str):
    from sfast_tpu_torch import CompilationConfig

    if traffic.get("kernels", True):
        return CompilationConfig(cache_dir=cache_dir)
    return CompilationConfig(enable_kernels=False, cache_dir=cache_dir)


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


class Ranged:
    """A pipeline slot seen through a ``torch.profiler.record_function``
    range named ``name`` around each call of ``methods`` (``__call__``
    always), counting the calls; every other attribute is the slot's."""

    def __init__(self, inner, name: str, counts: dict, methods=()):
        self.__dict__.update(_inner=inner, _name=name, _counts=counts, _methods=set(methods))
        counts.setdefault(name, 0)

    def _ranged(self, fn: Callable) -> Callable:
        from torch.profiler import record_function

        def call(*args, **kwargs):
            self._counts[self._name] += 1
            with record_function(self._name):
                return fn(*args, **kwargs)

        return call

    def __call__(self, *args, **kwargs):
        return self._ranged(self._inner)(*args, **kwargs)

    def __getattr__(self, attr):
        value = getattr(self.__dict__["_inner"], attr)
        return self._ranged(value) if attr in self.__dict__["_methods"] else value


# the slots the benchmark times by range, with the methods the pipelines call
RANGED_SLOTS = {"text_encoder": (), "text_encoder_2": (), "unet": (), "vae": ("decode",),
                "scheduler": ("step",)}


def add_ranges(pipe, counts: dict) -> None:
    """Put a named range around every call the pipeline makes into its
    compiled slots."""
    for slot, methods in RANGED_SLOTS.items():
        inner = getattr(pipe, slot, None)
        if inner is not None:
            name = "scheduler_step" if slot == "scheduler" else slot
            setattr(pipe, slot, Ranged(inner, name, counts, methods))


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


def lora_targets(state: Dict[str, torch.Tensor]) -> list:
    """The UNet's attention projections a LoRA goes into, sorted."""
    return sorted(k[:-len(".weight")] for k, w in state.items()
                  if w.dim() == 2 and k.endswith((".to_q.weight", ".to_k.weight",
                                                  ".to_v.weight", ".to_out.0.weight")))


def initial_lora(shapes: Dict[str, torch.Size], rank: int, seed: int, device) -> dict:
    """A fresh LoRA from the seed, in the benchmark's order: A (in, r)
    N(0, 1)/r, B (r, out) zero, float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lora = {}
    for mod in sorted(shapes):
        dout, din = shapes[mod]
        lora[mod] = {"a": torch.randn((din, rank), generator=gen, device=device) / rank,
                     "b": torch.zeros((rank, dout), device=device)}
    return lora


def build_train_step(unet, traffic: dict, lora_init: dict, cache_dir: str):
    """(step, lora, optimizer): the port's graphed LoRA train step over
    ``unet`` with the benchmark's initial LoRA copied into its factors."""
    from sfast_tpu_torch.training import lora_training_setup, make_lora_train_step

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


def factor_list(lora: dict) -> list:
    """[(name, tensor)] of every factor, sorted by module then a, b."""
    return [(f"{m}.{k}", lora[m][k]) for m in sorted(lora) for k in ("a", "b")]


def first_gradients(lora: dict, opt) -> Dict[str, torch.Tensor]:
    """Each factor's first gradient as the optimizer got it, from its state
    after one step: ``exp_avg / (1 − β1)``, with the optimizer's own β1
    (zero where it holds none)."""
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for name, p in factor_list(lora):
        m = opt.state[p].get("exp_avg")
        out[name] = (torch.zeros_like(p, dtype=torch.float32) if m is None
                     else m.detach().float() / (1 - beta1))
    return out


def adam_state(lora: dict, opt) -> Dict[str, dict]:
    """{factor: {'exp_avg', 'exp_avg_sq' (float32 copies), 'step' (int)}}:
    the optimizer's state of each factor as it stands (zero moments at step
    0 where it holds none)."""
    out = {}
    for name, p in factor_list(lora):
        st = opt.state[p]
        zero = torch.zeros_like(p, dtype=torch.float32)
        out[name] = {k: st[k].detach().float().clone() if k in st else zero
                     for k in ("exp_avg", "exp_avg_sq")}
        out[name]["step"] = int(round(float(st["step"]))) if "step" in st else 0
    return out
