"""``sfast_tpu_torch.compile(pipe, config)`` — counterpart of
``sfast_tpu/compilers/diffusion_pipeline_compiler.py`` (``:51-337``).

``compile`` wraps the callable the pipeline uses of each submodel (the
UNet's ``forward``, the VAE's ``decode``, CLIP's ``forward``) in a
:class:`CompiledModel`, which replays one CUDA graph per input signature
(``runtime/tracing.py``), and the scheduler's step in a
``CompiledScheduler`` when ``trace_scheduler`` is on; then it applies the
config's kernel routes.  It compiles nothing itself: each graph is
captured at its first call.  With ``enable_cuda_graph=False`` the models
run eagerly.
"""

import logging
from typing import Any, Optional

import torch

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction

logger = logging.getLogger(__name__)

# Submodel attributes probed on a pipeline, in JAX's order (:40-48)
_SUBMODEL_ATTRS = (
    "unet",
    "controlnet",
    "vae",
    "vae_encode",
    "text_encoder",
    "text_encoder_2",
    "image_encoder",
)


class CompiledModel:
    """A submodel whose ``method`` replays a CUDA graph per signature.

    Every other attribute is the module's (``unet.conv_in.weight``,
    ``vae.config``); ``compilation_config`` is the config it was given.  The graphs read the weights by address, so
    :meth:`update_params` copies new weights into the same tensors and
    nothing is captured again (LoRA hot-swap)."""

    def __init__(self, module: torch.nn.Module, config: Optional[CompilationConfig] = None,
                 name: Optional[str] = None, method: str = "forward"):
        self.module = module
        self.name = name or type(module).__name__
        self.method = method
        self._call = global_executable_cache().register(
            self.name, LazyCompiledFunction(getattr(module, method), name=self.name))
        self.set_compilation_config(config or CompilationConfig.Default())

    def set_compilation_config(self, config: CompilationConfig) -> None:
        """Apply ``config``'s routes to the module and drop every graph: a
        graph bakes in the kernel routes it was captured with."""
        self.compilation_config = config
        self.module.compilation_config = config
        self.clear_cache()

    def __call__(self, *args, **kwargs):
        if self.compilation_config.enable_cuda_graph:
            return self._call(*args, **kwargs)
        return getattr(self.module, self.method)(*args, **kwargs)

    def __getattr__(self, name):
        if name == self.__dict__.get("method"):
            return self.__call__
        if "module" not in self.__dict__:  # not yet initialised
            raise AttributeError(name)
        return getattr(self.__dict__["module"], name)

    def warmup(self, *args, **kwargs) -> "CompiledModel":
        """Capture the graph of this signature without replaying it."""
        if self.compilation_config.enable_cuda_graph:
            self._call.warmup(*args, **kwargs)
        return self

    @torch.no_grad()
    def update_params(self, state_dict) -> None:
        """Copy ``state_dict`` into the module's parameters and buffers in
        place.  Its names and shapes must be the module's: anything else
        raises, since the graphs would go on reading the old tensors."""
        own = self.module.state_dict(keep_vars=True)
        missing, extra = sorted(set(own) - set(state_dict)), sorted(set(state_dict) - set(own))
        if missing or extra:
            raise ValueError(f"{self.name}: state dict structure changed: missing {missing[:5]}, "
                             f"unexpected {extra[:5]}")
        for key, t in own.items():
            if tuple(state_dict[key].shape) != tuple(t.shape):
                raise ValueError(f"{self.name}: {key} has shape {tuple(state_dict[key].shape)}, "
                                 f"the module's is {tuple(t.shape)}")
        for key, t in own.items():
            t.copy_(state_dict[key])

    @property
    def cache_size(self) -> int:
        return self._call.cache_size

    def clear_cache(self) -> None:
        self._call.clear_cache()


def compile_model(module, config=None, name=None, method="forward") -> CompiledModel:
    return CompiledModel(module, config, name, method)


def compile_unet(unet, config=None) -> CompiledModel:
    return compile_model(unet, config, name="unet")


def compile_vae(vae, config=None) -> CompiledModel:
    """The VAE's ``decode``, which the text2img pipeline calls."""
    return compile_model(vae, config, name="vae", method="decode")


def _is_module(m) -> bool:
    return hasattr(m, "state_dict") and hasattr(m, "named_parameters")


def compile(pipeline: Any, config: Optional[CompilationConfig] = None):
    """Compile a pipeline in place and return it.  Idempotent and
    duck-typed: every ``_SUBMODEL_ATTRS`` slot holding a module is
    wrapped once (the VAE by its ``decode``), the scheduler's step when
    ``trace_scheduler`` is on; then the pipeline's
    ``set_compilation_config`` applies ``config`` and drops every graph."""
    config = config or CompilationConfig.Default()
    for attr in _SUBMODEL_ATTRS:
        sub = getattr(pipeline, attr, None)
        if sub is None or isinstance(sub, CompiledModel) or not _is_module(sub):
            continue
        method = "decode" if attr == "vae" and hasattr(sub, "decode") else "forward"
        setattr(pipeline, attr, compile_model(sub, config, name=attr, method=method))
        logger.info("sfast_tpu_torch: compiled %s", attr)

    scheduler = getattr(pipeline, "scheduler", None)
    if scheduler is not None and config.trace_scheduler:
        from sfast_tpu_torch.schedulers.compile import compile_scheduler

        pipeline.scheduler = compile_scheduler(scheduler, config)

    if hasattr(pipeline, "set_compilation_config"):
        pipeline.set_compilation_config(config)
    else:
        for attr in _SUBMODEL_ATTRS:
            sub = getattr(pipeline, attr, None)
            if isinstance(sub, CompiledModel):
                sub.set_compilation_config(config)
    return pipeline
