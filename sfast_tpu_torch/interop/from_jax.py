"""sfast_tpu parameter trees → this package's state dicts.

The JAX package keeps its weights as nested dicts of arrays (linear
``w`` as (in, out), conv ``w`` as HWIO, norms as ``scale``/``bias``).  These
functions turn such a tree — numpy arrays, or JAX arrays, which numpy
reads without importing JAX — into f32 state dicts for
``UNet2DConditionModel`` (SDXL's ``add_embedding`` and an LCM UNet's
``time_embedding.cond_proj`` included), ``ControlNetModel``,
``AutoencoderKL`` (both halves), ``AutoencoderTiny``, ``CLIPTextModel`` (with
``text_projection``), ``CLIPVisionModel``, the SVD
``UNetSpatioTemporalConditionModel`` and ``AutoencoderKLTemporalDecoder``,
whose ``load_state_dict``
casts to the model's dtype; IP-Adapter trees into the UNet's added attn2
keys and the image projection's; and LoRA trees into the port's LoRA
layout (``sfast_tpu_torch/lora.py``) and back (:func:`lora_to_jax`).

UNet and VAE follow ``sfast_tpu/interop/export_unet.py:16-126`` and
``export_vae.py:16-63``, the temporal VAE ``export_vae.py:65-126``; CLIP
is the inverse of ``convert_clip.py:28-88``, the SVD UNet of
``convert_svd.py``.  JAX has no ControlNet, CLIP vision, IP-Adapter or
SVD UNet exporter; those here are the port's own, in diffusers' and
transformers' names.
"""

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# JAX keys whose module takes another name in the port (diffusers'), in the
# writers below and in ``jax_key``, which ``sfast_tpu_torch.quant`` reads to
# select JAX's quantization sites among the port's modules
PORT_NAMES = {"to_out": "to_out.0", "proj": "net.0.proj", "out": "net.2",
              "blocks": "transformer_blocks"}
_JAX_KEYS = {v: k for k, v in PORT_NAMES.items() if k != "blocks"}


def jax_key(module_name: str):
    """The key under which JAX keeps the weight of the port's module
    ``module_name``: ``...attn1.to_out.0`` → ``'to_out'``, ``...ff.net.0.proj``
    → ``'proj'``, ``...ff.net.2`` → ``'out'``, ``controlnet_down_blocks.3`` →
    3, else the name's last part."""
    for suffix, key in _JAX_KEYS.items():
        if module_name == suffix or module_name.endswith("." + suffix):
            return key
    last = module_name.rsplit(".", 1)[-1]
    return int(last) if last.isdigit() else last


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _put_lin(sd: StateDict, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.asarray(p["w"], dtype=np.float32).T)
    if "b" in p:
        sd[key + ".bias"] = _t(p["b"])


def _put_conv(sd: StateDict, key: str, p) -> None:  # HWIO → OIHW
    sd[key + ".weight"] = _t(np.asarray(p["w"], dtype=np.float32).transpose(3, 2, 0, 1))
    sd[key + ".bias"] = _t(p["b"])


def _put_conv3d(sd: StateDict, key: str, p) -> None:
    """A temporal (3, 1, 1) conv → Conv3d's OIDHW (C_out, C_in, 3, 1, 1):
    JAX keeps ``time_conv_out`` as DHWIO (3, 1, 1, C_in, C_out) and the
    temporal resnets' kernels as (3, 1, C_in, C_out), without the
    singleton W axis (``unet_spatio_temporal._conv_temporal2d``)."""
    w = np.asarray(p["w"], dtype=np.float32)
    if w.ndim == 4:
        w = w[:, :, None]
    sd[key + ".weight"] = _t(w.transpose(4, 3, 0, 1, 2))
    sd[key + ".bias"] = _t(p["b"])


def _put_norm(sd: StateDict, key: str, p) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def _put_resnet(sd: StateDict, pre: str, p) -> None:
    _put_norm(sd, pre + "norm1", p["norm1"])
    _put_conv(sd, pre + "conv1", p["conv1"])
    _put_norm(sd, pre + "norm2", p["norm2"])
    _put_conv(sd, pre + "conv2", p["conv2"])
    if "time_emb_proj" in p:
        _put_lin(sd, pre + "time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _put_conv(sd, pre + "conv_shortcut", p["conv_shortcut"])


def _put_attention(sd: StateDict, pre: str, p) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _put_lin(sd, pre + name, p[name])
    _put_lin(sd, pre + PORT_NAMES["to_out"], p["to_out"])


def _put_spatial_transformer(sd: StateDict, pre: str, p) -> None:
    _put_norm(sd, pre + "norm", p["norm"])
    # linear projections are 2-D weights, 1×1 convs 4-D
    put = _put_lin if np.ndim(p["proj_in"]["w"]) == 2 else _put_conv
    put(sd, pre + "proj_in", p["proj_in"])
    put(sd, pre + "proj_out", p["proj_out"])
    for k, blk in enumerate(p["blocks"]):
        bp = f"{pre}{PORT_NAMES['blocks']}.{k}."
        _put_norm(sd, bp + "norm1", blk["norm1"])
        _put_attention(sd, bp + "attn1.", blk["attn1"])
        _put_norm(sd, bp + "norm2", blk["norm2"])
        _put_attention(sd, bp + "attn2.", blk["attn2"])
        _put_norm(sd, bp + "norm3", blk["norm3"])
        _put_ff(sd, bp + "ff.", blk["ff"])


def _put_ff(sd: StateDict, pre: str, p) -> None:
    """A feed-forward: GEGLU's fused ``proj`` and the ``out`` linear."""
    _put_lin(sd, pre + PORT_NAMES["proj"], p["proj"])
    _put_lin(sd, pre + PORT_NAMES["out"], p["out"])


def _put_trunk(sd: StateDict, params) -> None:
    """conv_in, the embeddings, the down blocks and the mid block: the part
    a ControlNet shares with the UNet (``models.unet_2d_condition.UNetTrunk``)."""
    _put_conv(sd, "conv_in", params["conv_in"])
    for name, p in params["time_embedding"].items():  # linear_1, linear_2, LCM's cond_proj
        _put_lin(sd, f"time_embedding.{name}", p)
    for name, p in params.get("add_embedding", {}).items():  # SDXL's text_time MLP
        _put_lin(sd, f"add_embedding.{name}", p)
    _put_blocks(sd, "down_blocks", params["down_blocks"])
    mid = params["mid_block"]
    for j, rn in enumerate(mid["resnets"]):
        _put_resnet(sd, f"mid_block.resnets.{j}.", rn)
    _put_spatial_transformer(sd, "mid_block.attentions.0.", mid["attentions"][0])


def _put_blocks(sd: StateDict, part: str, blocks) -> None:
    for i, blk in enumerate(blocks):
        pre = f"{part}.{i}."
        for j, rn in enumerate(blk["resnets"]):
            _put_resnet(sd, f"{pre}resnets.{j}.", rn)
        for j, at in enumerate(blk.get("attentions", [])):
            _put_spatial_transformer(sd, f"{pre}attentions.{j}.", at)
        if "downsample" in blk:
            _put_conv(sd, f"{pre}downsamplers.0.conv", blk["downsample"]["conv"])
        if "upsample" in blk:
            _put_conv(sd, f"{pre}upsamplers.0.conv", blk["upsample"]["conv"])


def unet_state_dict(params) -> StateDict:
    """``init_unet_params`` tree → ``UNet2DConditionModel`` state dict
    (without IP-Adapter keys: ``ip_adapter_state_dicts``)."""
    sd: StateDict = {}
    _put_trunk(sd, params)
    _put_blocks(sd, "up_blocks", params["up_blocks"])
    _put_norm(sd, "conv_norm_out", params["conv_norm_out"])
    _put_conv(sd, "conv_out", params["conv_out"])
    return sd


def controlnet_state_dict(params) -> StateDict:
    """``init_controlnet_params`` tree → ``ControlNetModel`` state dict
    (diffusers' names)."""
    sd: StateDict = {}
    _put_trunk(sd, params)
    ce = params["controlnet_cond_embedding"]
    _put_conv(sd, "controlnet_cond_embedding.conv_in", ce["conv_in"])
    for i, conv in enumerate(ce["blocks"]):
        _put_conv(sd, f"controlnet_cond_embedding.blocks.{i}", conv)
    _put_conv(sd, "controlnet_cond_embedding.conv_out", ce["conv_out"])
    for i, conv in enumerate(params["controlnet_down_blocks"]):
        _put_conv(sd, f"controlnet_down_blocks.{i}", conv)
    _put_conv(sd, "controlnet_mid_block", params["controlnet_mid_block"])
    return sd


def _attn2_nodes(params):
    """(module name, attn2 param dict) of every cross-attention of a UNet
    tree."""
    for part in ("down_blocks", "up_blocks"):
        for i, blk in enumerate(params[part]):
            for j, at in enumerate(blk.get("attentions", [])):
                for k, b in enumerate(at["blocks"]):
                    yield f"{part}.{i}.attentions.{j}.transformer_blocks.{k}.attn2", b["attn2"]
    for k, b in enumerate(params["mid_block"]["attentions"][0]["blocks"]):
        yield f"mid_block.attentions.0.transformer_blocks.{k}.attn2", b["attn2"]


def ip_adapter_state_dicts(unet_params, image_proj):
    """A UNet tree with IP-Adapter weights (JAX's ``load_ip_adapter`` or
    ``init_ip_adapter_params``) and its image projection → (the UNet's
    added keys, ``...attn2.to_k_ip.weight`` / ``to_v_ip.weight``, for a UNet
    given them by ``ip_adapter.add_ip_projections``; the
    ``ImageProjModel`` state dict)."""
    sd: StateDict = {}
    for name, p in _attn2_nodes(unet_params):
        if "ip_to_k" in p:
            _put_lin(sd, f"{name}.to_k_ip", p["ip_to_k"])
            _put_lin(sd, f"{name}.to_v_ip", p["ip_to_v"])
    proj: StateDict = {}
    _put_lin(proj, "proj", image_proj["proj"])
    _put_norm(proj, "norm", image_proj["norm"])
    return sd, proj


def _put_st_resnet(sd: StateDict, pre: str, p) -> None:
    """A SpatioTemporalResBlock: ``spatial_res_block``,
    ``temporal_res_block`` and ``time_mixer.mix_factor`` (shape (1,), as
    diffusers' AlphaBlender holds it)."""
    _put_resnet(sd, pre + "spatial_res_block.", p["spatial"])
    t = p["temporal"]
    tp = pre + "temporal_res_block."
    _put_norm(sd, tp + "norm1", t["norm1"])
    _put_conv3d(sd, tp + "conv1", t["conv1"])
    _put_norm(sd, tp + "norm2", t["norm2"])
    _put_conv3d(sd, tp + "conv2", t["conv2"])
    if "time_emb_proj" in t:
        _put_lin(sd, tp + "time_emb_proj", t["time_emb_proj"])
    sd[pre + "time_mixer.mix_factor"] = _t(p["mix_factor"]).reshape(1)


def _put_st_transformer(sd: StateDict, pre: str, p) -> None:
    _put_spatial_transformer(sd, pre, p)
    for k, blk in enumerate(p["temporal_blocks"]):
        bp = f"{pre}temporal_transformer_blocks.{k}."
        _put_norm(sd, bp + "norm_in", blk["norm_in"])
        _put_ff(sd, bp + "ff_in.", blk["ff_in"])
        for name in ("norm1", "norm2", "norm3"):
            _put_norm(sd, bp + name, blk[name])
        _put_attention(sd, bp + "attn1.", blk["attn1"])
        _put_attention(sd, bp + "attn2.", blk["attn2"])
        _put_ff(sd, bp + "ff.", blk["ff"])
    _put_time_pos_embed(sd, pre + "time_pos_embed.", p["time_pos_embed"])
    sd[pre + "time_mixer.mix_factor"] = _t(p["mix_factor"]).reshape(1)


def _put_time_pos_embed(sd: StateDict, pre: str, p) -> None:
    """JAX's C → C → C frame-position embedding at diffusers' C → 4·C → C
    width: ``linear_1``'s extra outputs and ``linear_2``'s extra inputs
    are zeros, so the extra units are silu(0) = 0 and add nothing."""
    _put_lin(sd, pre + "linear_1", p["linear_1"])
    _put_lin(sd, pre + "linear_2", p["linear_2"])
    w1, b1, w2 = (sd[pre + k] for k in ("linear_1.weight", "linear_1.bias", "linear_2.weight"))
    extra = 4 * w2.shape[0] - w2.shape[1]
    sd[pre + "linear_1.weight"] = torch.nn.functional.pad(w1, (0, 0, 0, extra))
    sd[pre + "linear_1.bias"] = torch.nn.functional.pad(b1, (0, extra))
    sd[pre + "linear_2.weight"] = torch.nn.functional.pad(w2, (0, extra))


def svd_unet_state_dict(params) -> StateDict:
    """``init_svd_unet_params`` tree → ``UNetSpatioTemporalConditionModel``
    state dict (diffusers' names: JAX's ``convert_svd_unet_params`` reads it
    back)."""
    sd: StateDict = {}
    _put_conv(sd, "conv_in", params["conv_in"])
    for emb in ("time_embedding", "add_embedding"):
        for name, p in params[emb].items():
            _put_lin(sd, f"{emb}.{name}", p)
    for part in ("down_blocks", "up_blocks"):
        for i, blk in enumerate(params[part]):
            pre = f"{part}.{i}."
            for j, rn in enumerate(blk["resnets"]):
                _put_st_resnet(sd, f"{pre}resnets.{j}.", rn)
            for j, at in enumerate(blk.get("attentions", [])):
                _put_st_transformer(sd, f"{pre}attentions.{j}.", at)
            if "downsample" in blk:
                _put_conv(sd, f"{pre}downsamplers.0.conv", blk["downsample"]["conv"])
            if "upsample" in blk:
                _put_conv(sd, f"{pre}upsamplers.0.conv", blk["upsample"]["conv"])
    mid = params["mid_block"]
    for j, rn in enumerate(mid["resnets"]):
        _put_st_resnet(sd, f"mid_block.resnets.{j}.", rn)
    _put_st_transformer(sd, "mid_block.attentions.0.", mid["attentions"][0])
    _put_norm(sd, "conv_norm_out", params["conv_norm_out"])
    _put_conv(sd, "conv_out", params["conv_out"])
    return sd


def _put_vae_mid(sd: StateDict, pre: str, mid) -> None:
    _put_resnet(sd, pre + "resnets.0.", mid["resnet1"])
    _put_attention(sd, pre + "attentions.0.", mid["attn"])
    _put_norm(sd, pre + "attentions.0.group_norm", mid["attn"]["group_norm"])
    _put_resnet(sd, pre + "resnets.1.", mid["resnet2"])


def _put_encoder(sd: StateDict, params) -> None:
    enc = params["encoder"]
    _put_conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down_blocks"]):
        pre = f"encoder.down_blocks.{i}."
        for j, rn in enumerate(blk["resnets"]):
            _put_resnet(sd, f"{pre}resnets.{j}.", rn)
        if "downsample" in blk:
            _put_conv(sd, f"{pre}downsamplers.0.conv", blk["downsample"]["conv"])
    _put_vae_mid(sd, "encoder.mid_block.", enc["mid"])
    _put_norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _put_conv(sd, "encoder.conv_out", enc["conv_out"])
    _put_conv(sd, "quant_conv", params["quant_conv"])


def vae_state_dict(params) -> StateDict:
    """``init_vae_params`` tree → ``AutoencoderKL`` state dict, both halves."""
    sd: StateDict = {}
    _put_encoder(sd, params)
    dec = params["decoder"]
    _put_conv(sd, "post_quant_conv", params["post_quant_conv"])
    _put_conv(sd, "decoder.conv_in", dec["conv_in"])
    _put_vae_mid(sd, "decoder.mid_block.", dec["mid"])
    for i, blk in enumerate(dec["up_blocks"]):
        pre = f"decoder.up_blocks.{i}."
        for j, rn in enumerate(blk["resnets"]):
            _put_resnet(sd, f"{pre}resnets.{j}.", rn)
        if "upsample" in blk:
            _put_conv(sd, f"{pre}upsamplers.0.conv", blk["upsample"]["conv"])
    _put_norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _put_conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


def temporal_vae_state_dict(params) -> StateDict:
    """``init_temporal_vae_params`` tree → ``AutoencoderKLTemporalDecoder``
    state dict: ``AutoencoderKL``'s encoder and ``quant_conv``, the
    temporal decoder (JAX ``export_temporal_vae_state_dict``'s names)."""
    sd: StateDict = {}
    _put_encoder(sd, params)
    dec = params["decoder"]
    _put_conv(sd, "decoder.conv_in", dec["conv_in"])
    for j, rn in enumerate(dec["mid"]["resnets"]):
        _put_st_resnet(sd, f"decoder.mid_block.resnets.{j}.", rn)
    pre = "decoder.mid_block.attentions.0."
    _put_attention(sd, pre, dec["mid"]["attn"])
    _put_norm(sd, pre + "group_norm", dec["mid"]["attn"]["group_norm"])
    for i, blk in enumerate(dec["up_blocks"]):
        pre = f"decoder.up_blocks.{i}."
        for j, rn in enumerate(blk["resnets"]):
            _put_st_resnet(sd, f"{pre}resnets.{j}.", rn)
        if "upsample" in blk:
            _put_conv(sd, f"{pre}upsamplers.0.conv", blk["upsample"]["conv"])
    _put_norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _put_conv(sd, "decoder.conv_out", dec["conv_out"])
    _put_conv3d(sd, "decoder.time_conv_out", dec["time_conv_out"])
    return sd


def _put_tiny_block(sd: StateDict, pre: str, p) -> None:
    for j, name in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
        _put_conv(sd, f"{pre}conv.{j}", p[name])


def tiny_vae_state_dict(params) -> StateDict:
    """``init_tiny_vae_params`` tree → ``AutoencoderTiny`` state dict
    (diffusers' ``encoder.layers.{i}`` / ``decoder.layers.{i}``; the
    decoder's ReLU after ``conv_in`` and each upsample hold an index and
    no weight)."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    i = 0
    # each stage starts with a conv: conv_in, then the previous stage's down
    convs = [enc["conv_in"]] + [stage["down"] for stage in enc["stages"][:-1]]
    for conv, stage in zip(convs, enc["stages"]):
        _put_conv(sd, f"encoder.layers.{i}", conv)
        i += 1
        for blk in stage["blocks"]:
            _put_tiny_block(sd, f"encoder.layers.{i}.", blk)
            i += 1
    _put_conv(sd, f"encoder.layers.{i}", enc["conv_out"])
    _put_conv(sd, "decoder.layers.0", dec["conv_in"])
    i = 2
    for stage in dec["stages"]:
        for blk in stage["blocks"]:
            _put_tiny_block(sd, f"decoder.layers.{i}.", blk)
            i += 1
        if "up_conv" in stage:
            _put_conv(sd, f"decoder.layers.{i + 1}", stage["up_conv"])
            i += 2
    _put_conv(sd, f"decoder.layers.{i}", dec["conv_out"])
    return sd


def _put_clip_layers(sd: StateDict, pre: str, layers) -> None:
    for i, lyr in enumerate(layers):
        lp = f"{pre}{i}."
        _put_norm(sd, lp + "layer_norm1", lyr["layer_norm1"])
        for ours, theirs in (("to_q", "q_proj"), ("to_k", "k_proj"),
                             ("to_v", "v_proj"), ("to_out", "out_proj")):
            _put_lin(sd, f"{lp}self_attn.{theirs}", lyr["attn"][ours])
        _put_norm(sd, lp + "layer_norm2", lyr["layer_norm2"])
        _put_lin(sd, lp + "mlp.fc1", lyr["fc1"])
        _put_lin(sd, lp + "mlp.fc2", lyr["fc2"])


def clip_text_state_dict(params) -> StateDict:
    """``init_clip_text_params`` tree → ``CLIPTextModel`` state dict
    (transformers' names)."""
    pre = "text_model."
    sd: StateDict = {
        pre + "embeddings.token_embedding.weight": _t(params["token_embedding"]),
        pre + "embeddings.position_embedding.weight": _t(params["position_embedding"]),
    }
    _put_norm(sd, pre + "final_layer_norm", params["final_layer_norm"])
    _put_clip_layers(sd, pre + "encoder.layers.", params["layers"])
    if "text_projection" in params:  # CLIPTextModelWithProjection: top level
        _put_lin(sd, "text_projection", params["text_projection"])
    return sd


def clip_vision_state_dict(params) -> StateDict:
    """``init_clip_vision_params`` tree → ``CLIPVisionModel`` state dict
    (transformers' names, ``pre_layrnorm`` as transformers spells it)."""
    pre = "vision_model."
    sd: StateDict = {
        pre + "embeddings.class_embedding": _t(params["class_embedding"]),
        pre + "embeddings.patch_embedding.weight":
            _t(np.asarray(params["patch_embedding"]["w"], np.float32).transpose(3, 2, 0, 1)),
        pre + "embeddings.position_embedding.weight": _t(params["position_embedding"]),
    }
    _put_norm(sd, pre + "pre_layrnorm", params["pre_layernorm"])
    _put_norm(sd, pre + "post_layernorm", params["post_layernorm"])
    _put_clip_layers(sd, pre + "encoder.layers.", params["layers"])
    if "visual_projection" in params:
        _put_lin(sd, "visual_projection", params["visual_projection"])
    return sd


def _lora_module_name(path) -> str:
    """A JAX LoRA path, ``("down_blocks", 0, "attentions", 0, "blocks", 0,
    "attn1", "to_out", "w")``, → the port's module name,
    ``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0``."""
    names = {k: PORT_NAMES[k] for k in ("blocks", "to_out")}
    return ".".join(names.get(p, str(p)) for p in path[:-1])


def lora_params(lora) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree (``sfast_tpu.lora.init_lora_params`` or
    ``convert_diffusers_lora``: {path: {"a": (in, r), "b": (r, out)}}) →
    the port's, keyed by module name with the same orientation."""
    return {_lora_module_name(path): {"a": _t(f["a"]), "b": _t(f["b"])}
            for path, f in lora.items()}


# ---------------------------------------------------------------------------
# JAX weight paths → the port's module names, and calibrations
# ---------------------------------------------------------------------------


def _rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, the path as
    JAX's calibration keys a weight leaf (dict keys and list indices)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def module_names(params, state_dict_fn=unet_state_dict) -> Dict[tuple, str]:
    """JAX path of each weight leaf (``(..., "attn1", "to_out", "w")``) →
    the port's module name (``...attn1.to_out.0``), read from the writer
    ``state_dict_fn`` itself: it is given a tree whose every leaf, of
    shape (1,)·ndim, holds its own index, so the map cannot drift from
    the state dicts."""
    paths = []

    def index_leaf(path, leaf):
        paths.append(path)
        return np.full((1,) * np.ndim(leaf), len(paths), np.float32)

    sd = state_dict_fn(_rebuild(params, index_leaf))
    out = {}
    for key, t in sd.items():
        path = paths[int(t.reshape(-1)[0].item()) - 1]
        if path[-1] == "w":
            out[path] = key.rsplit(".", 1)[0]
    return out


def lora_to_jax(lora, params):
    """The port's LoRA (module name → {"a", "b"}) → JAX's tree, keyed by
    the weight path of each module in ``params`` (through
    :func:`module_names`), the factors as f32 numpy copies (a CPU tensor's
    ``numpy()`` shares its memory, which a JAX array may share in turn, so
    an optimizer step on the port's factors would reach JAX's): the
    reverse of :func:`lora_params`."""
    paths = {name: path for path, name in module_names(params).items()}
    missing = [m for m in lora if m not in paths]
    if missing:
        raise KeyError(f"lora_to_jax: no JAX weight for {missing[:3]}")
    return {paths[m]: {k: np.array(f[k].detach().float().cpu().numpy()) for k in ("a", "b")}
            for m, f in lora.items()}


def calibration_from_jax(cal, params, state_dict_fn=unet_state_dict):
    """A JAX ``quant.calibrate.Calibration`` (amax keyed by weight path) →
    the port's (keyed by module name), through :func:`module_names`."""
    from sfast_tpu_torch.quant.calibrate import Calibration

    names = module_names(params, state_dict_fn)
    missing = [p for p in cal.amax if p not in names]
    if missing:
        raise KeyError(f"calibration_from_jax: no port module for {missing[:3]}")
    return Calibration(amax={names[p]: float(v) for p, v in cal.amax.items()})
