"""Weights from the seed, keyed by the reference model's state-dict names.

Linear and conv weights N(0, 1/fan_in), biases 0, GroupNorm and LayerNorm
scales 1 and shifts 0, embeddings N(0, 0.02²): the init scales of
``sfast_tpu/models/layers.py:118-137``, copied as numbers.  The draws are
made on the generator's device in a few large float32 calls, in the
state dict's order, then scaled and cast to the dtype they are served in
(norms in float32, as the program keeps them; the rest in the
configuration's dtype).  The same seed gives the same tensors, so the
reference regenerates them after the program has run.

A model family may bring rules for parameters these do not know (a
``Conv3d``'s weight, a bare ``nn.Parameter``): ``rules(module, name,
param)`` gives the kind of :func:`plan` or None.  It is asked only where
the base rules have none, so it never changes the draws of a parameter
they know.
"""

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

EMBEDDING_STD = 0.02
CHUNK = 1 << 28  # elements drawn by one call


Rules = Optional[Callable[[nn.Module, str, nn.Parameter], object]]


def base_kind(m: nn.Module, p_name: str, p: nn.Parameter):
    """The base rules' kind of parameter ``p_name`` of ``m``, or None."""
    if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
        return "ones" if p_name == "weight" else "zeros"
    if p_name == "bias":
        return "zeros"
    if isinstance(m, nn.Embedding):
        return "embedding"
    if isinstance(m, (nn.Linear, nn.Conv2d)):
        return p[0].numel()
    return None


def plan(model: nn.Module, rules: Rules = None):
    """[(name, shape, kind)] of ``model``'s parameters in state-dict order;
    ``kind`` is 'zeros', 'ones', 'embedding' or the weight's fan-in."""
    out = []
    for mod_name, m in model.named_modules():
        for p_name, p in m.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            kind = base_kind(m, p_name, p)
            if kind is None and rules is not None:
                kind = rules(m, p_name, p)
            if kind is None:
                raise ValueError(f"no init rule for {name} ({type(m).__name__})")
            out.append((name, tuple(p.shape), kind))
    return out


def make_weights(model: nn.Module, seed: int, device, dtype: torch.dtype,
                 norm_dtype: torch.dtype = torch.float32,
                 rules: Rules = None) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (built anywhere, the ``meta`` device
    included) drawn from ``seed`` on ``device``, with the extra ``rules``
    of its family."""
    gen = torch.Generator(device=device).manual_seed(seed)
    entries = plan(model, rules)
    out: Dict[str, torch.Tensor] = {}
    drawn = [e for e in entries if e[2] not in ("zeros", "ones")]
    i = 0
    while i < len(drawn):
        j, n = i, 0
        while j < len(drawn) and (n == 0 or n + math.prod(drawn[j][1]) <= CHUNK):
            n += math.prod(drawn[j][1])
            j += 1
        r = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for name, shape, kind in drawn[i:j]:
            k = math.prod(shape)
            std = EMBEDDING_STD if kind == "embedding" else 1.0 / math.sqrt(kind)
            out[name] = (r[at:at + k] * std).view(shape).to(dtype)
            at += k
        del r
        i = j
    for name, shape, kind in entries:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device, dtype=norm_dtype)
        elif kind == "zeros":
            norm = name.rsplit(".", 1)[0]
            is_norm = any(e[0] == norm + ".weight" and e[2] == "ones" for e in entries)
            out[name] = torch.zeros(shape, device=device, dtype=norm_dtype if is_norm else dtype)
    return {name: out[name] for name, _, _ in entries}
