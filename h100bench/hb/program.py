"""What every model family's system under test shares: the port's
compilation config, the benchmark's named ranges around a pipeline's
slots, and the LoRA of a train step with its AdamW state.  What builds a
family's models, pipeline and train step is its own
(``families/<family>.py``).

Everything of ``sfast_tpu_torch`` is imported inside these functions, so
that the reference and the tests can import this module's neighbours
without the program.
"""

from typing import Callable, Dict

import torch


def compilation_config(traffic: dict, cache_dir: str):
    """The port's ``CompilationConfig`` for the traffic: its defaults, or
    every hand-written kernel off where the traffic says ``kernels``
    false; the kernel library is built under ``cache_dir``."""
    from sfast_tpu_torch import CompilationConfig

    if traffic.get("kernels", True):
        return CompilationConfig(cache_dir=cache_dir)
    return CompilationConfig(enable_kernels=False, cache_dir=cache_dir)


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


def add_ranges(pipe, counts: dict, slots: dict) -> None:
    """Put a named range around every call the pipeline makes into its
    compiled slots: ``slots`` maps a slot to (its range's name, the methods
    the pipeline calls besides ``__call__``)."""
    for slot, (name, methods) in slots.items():
        inner = getattr(pipe, slot, None)
        if inner is not None:
            setattr(pipe, slot, Ranged(inner, name, counts, methods))


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
