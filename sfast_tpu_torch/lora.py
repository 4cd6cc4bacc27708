"""LoRA: merging into a model's weights, and hot-swap under CUDA graphs.

Counterpart of ``sfast_tpu/lora.py`` (``:59-194``).  A LoRA here is a dict
``{module name: {"a": (in, r), "b": (r, out)}}`` keyed by the port's module
names, which are diffusers' (``down_blocks.0.attentions.0.transformer_blocks
.0.attn1.to_q``, ``...attn1.to_out.0``), with A and B in JAX's orientation.
The port's ``Linear.weight`` is (out, in), so a merge folds in
``scale·(A·B)ᵀ``, summed in f32 and cast back to the weight's dtype.

:func:`switch_lora` is the reference's recompile-free swap
(``README.md:228-265``): it copies the merged weights into the compiled
model's own parameters (``CompiledModel.update_params``).  Every CUDA graph
reads them by address, the model's own and a fused denoising loop that
captured the module alike, so the next replay computes with the new
weights and nothing is captured again.
"""

import logging
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

LoRA = Dict[str, Dict[str, torch.Tensor]]

# the attention projections LoRA goes into, by the last parts of their names
_DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")


def _target_modules(state: Mapping[str, torch.Tensor], targets) -> list:
    suffixes = tuple("." + t for t in targets)
    return [key[: -len(".weight")] for key, w in state.items()
            if key.endswith(".weight") and w.dim() == 2
            and key[: -len(".weight")].endswith(suffixes)]


def init_lora_params(
    generator: torch.Generator,
    base_state: Mapping[str, torch.Tensor],
    rank: int = 4,
    targets: Tuple[str, ...] = _DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> LoRA:
    """Factors for every target linear of ``base_state`` (a state dict):
    A Gaussian / rank, B zero, so that a fresh LoRA changes nothing.  Drawn
    on ``generator``'s device, in the state dict's order."""
    lora = {}
    for mod in _target_modules(base_state, targets):
        dout, din = base_state[mod + ".weight"].shape
        a = torch.randn((din, rank), generator=generator, device=generator.device, dtype=dtype)
        lora[mod] = {"a": a * (1.0 / rank),
                     "b": torch.zeros((rank, dout), device=generator.device, dtype=dtype)}
    return lora


def merge_lora(base_state: Mapping[str, torch.Tensor], lora: LoRA, scale: float = 1.0,
               sharded: Optional[Mapping[str, torch.nn.Module]] = None):
    """A new state dict: ``base_state`` with ``W + scale·(A·B)ᵀ`` for each
    module of ``lora``; every other entry is ``base_state``'s own tensor.
    Raises for a module that ``base_state`` does not have.

    ``sharded`` (module name → ``parallel.tensor_parallel.ParallelLinear``)
    says which weights of ``base_state`` are a tensor-parallel rank's
    shards: their delta is the shard's, from B's output columns for a
    column-parallel weight, from A's input rows for a row-parallel one."""
    merged = dict(base_state)
    sharded = sharded or {}
    for mod, f in lora.items():
        key = mod + ".weight"
        if key not in base_state:
            raise KeyError(f"merge_lora: the model has no module {mod!r}")
        w = base_state[key]
        a, b = (f[k].to(device=w.device, dtype=torch.float32) for k in ("a", "b"))
        bt, at = b.T, a.T
        m = sharded.get(mod)
        if m is not None:
            bt, at = (m.shard(bt, 0), at) if m.mode == "column" else (bt, m.shard(at, 1))
        # W + scale·(A·B)ᵀ = W + scale·(Bᵀ·Aᵀ) in one product
        merged[key] = torch.addmm(w.float(), bt, at, alpha=scale).to(w.dtype)
    return merged


def switch_lora(compiled_model, base_state: Mapping[str, torch.Tensor], lora: LoRA,
                scale: float = 1.0) -> None:
    """Hot-swap a :class:`~sfast_tpu_torch.compilers.CompiledModel` to
    base + LoRA (``scale`` 0 swaps back to the base) with no new capture.

    ``base_state`` is a copy of the base weights, such as
    ``{k: v.clone() for k, v in model.state_dict().items()}`` taken before
    the first swap: the swap writes into the model's own tensors, so a
    ``base_state`` that holds them would take each swap in.  Under a mesh
    it holds the unsharded weights, as ``update_params`` takes them."""
    own = compiled_model.module.state_dict()
    for mod in lora:
        if mod + ".w_q" in own or mod + ".w_q8" in own:
            raise ValueError(f"switch_lora: {mod} is quantized (int8, quant.quantize_pipeline); "
                             "a LoRA merges into bf16 weights: swap before quantizing")
        key = mod + ".weight"
        if key in own and key in base_state and \
                base_state[key].data_ptr() == own[key].data_ptr():
            raise ValueError(f"switch_lora: base_state[{key!r}] is the model's own weight; "
                             "pass a copy of the base weights")
    compiled_model.update_params(merge_lora(base_state, lora, scale))


# ---------------------------------------------------------------------------
# diffusers / PEFT and kohya LoRA state dicts
# ---------------------------------------------------------------------------

_KEY_RES = [
    # PEFT: unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q
    #       .lora_A.weight / .lora_B.weight, torch (out, in) layouts
    re.compile(r"(?P<module>.+)\.lora_A\.(?:default\.)?weight$"),
    # kohya: lora_unet_down_blocks_0_attentions_0_..._to_q.lora_down.weight
    re.compile(r"(?P<module>.+)\.lora_down\.weight$"),
]
_UP_FOR_DOWN = {"lora_A": "lora_B", "lora_down": "lora_up"}


def _module_name(module: str) -> str:
    """A LoRA file's module string → the port's module name."""
    m = module
    for prefix in ("unet.", "lora_unet_"):
        if m.startswith(prefix):
            m = m[len(prefix):]
    m = m.replace("processor.", "")
    if "." not in m:  # kohya: every separator is an underscore
        m = re.sub(r"_(\d+)", r".\1", m)  # down_blocks_0 → down_blocks.0
        m = re.sub(r"(\d)_", r"\1.", m)  # .0_attentions → .0.attentions, attn1_to_q → attn1.to_q
        m = m.replace("mid_block_", "mid_block.")
    return m


def convert_diffusers_lora(sd: Mapping[str, torch.Tensor],
                           dtype: torch.dtype = torch.float32) -> Tuple[LoRA, float]:
    """A diffusers / PEFT or kohya LoRA state dict → (the port's LoRA, 1.0).
    The (out, in) factors are transposed to A (in, r) and B (r, out); a
    network alpha, where given, is folded into A as alpha / rank."""
    lora: LoRA = {}
    for key, val in sd.items():
        for pat in _KEY_RES:
            mm = pat.match(key)
            if not mm:
                continue
            module = mm.group("module")
            down_tag = "lora_A" if ".lora_A" in key else "lora_down"
            up_key = key.replace(down_tag, _UP_FOR_DOWN[down_tag])
            if up_key not in sd:
                continue
            a = val.T.contiguous().to(dtype)  # (in, r)
            b = sd[up_key].T.contiguous().to(dtype)  # (r, out)
            alpha = sd.get(module + ".alpha")
            scale = 1.0 if alpha is None else float(alpha) / a.shape[-1]
            lora[_module_name(module)] = {"a": a * scale, "b": b}
            break
    if not lora:
        logger.warning("convert_diffusers_lora: no LoRA keys recognized")
    return lora, 1.0
