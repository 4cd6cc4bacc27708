"""``sfast_tpu_torch.compile(pipe, config)`` — counterpart of
``sfast_tpu/compilers/diffusion_pipeline_compiler.py`` (``:51-337``).

A pipeline whose slots hold torch modules that are not the port's models
(a diffusers pipeline: diffusers' UNet and VAE, transformers' CLIP) is
first converted by ``interop/diffusers_adapter.py`` into the port's
pipeline of the port's models, built on the card unless ``device`` says
otherwise, as JAX converts one into its native models (``:295-337``).  A
foreign module is never wrapped as it is: its graphs would launch none of
the port's kernels.

``compile`` wraps the callable the pipeline uses of each submodel (the
UNet's ``forward``, a ControlNet's ``forward``, whose graph returns the
tuple of its down residuals and its mid residual, the VAE's ``decode``,
its ``encode`` in the ``vae_encode`` slot, CLIP's ``forward``) in a
:class:`CompiledModel`, which replays one CUDA graph per input signature
(``runtime/tracing.py``), and the scheduler's step in a
``CompiledScheduler`` when ``trace_scheduler`` is on; then it applies the
config's kernel routes.  It compiles nothing itself: each graph is
captured at its first call.  With ``enable_cuda_graph=False`` the models
run eagerly.  A compiled model applies the config's ``memory_format`` at
its boundary (``utils/memory_format.py``) and, with ``prefer_lowp_gemm``
off, runs each call and its capture under
``utils.compute_precision.high_compute_precision``.

The SD pipelines hold no image encoder, as in JAX: an IP-Adapter caller
compiles its CLIP vision encoder alone, ``compile_model(image_encoder,
name="image_encoder")``, as the reference's community example does.  The
SVD pipeline holds one in its ``image_encoder`` slot, compiled with the
rest; its temporal VAE's ``decode(latents, num_frames)`` keys a graph by
the chunk's shape and ``num_frames``'s value.

With ``config.mesh`` (JAX ``:67-88``) a compiled model shards its module on
construction (``parallel/tensor_parallel.shard_module``, by
``config.sharding_rules`` or the Megatron rule), after one eager collective
on each of the mesh's groups, so that NCCL's communicators exist before a
graph captures a collective.  ``compile`` hands every model the config,
and so the mesh.  Every rank runs the same pipeline on the same inputs; a
data-parallel caller hands each rank its ``dp`` slice of the batch.
"""

import contextlib
import logging
from typing import Any, Optional

import torch

from sfast_tpu_torch.config import CompilationConfig
from sfast_tpu_torch.runtime.executable_cache import global_executable_cache
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction
from sfast_tpu_torch.utils.compute_precision import high_compute_precision
from sfast_tpu_torch.utils.memory_format import tree_to_nchw, tree_to_nhwc

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
    nothing is captured again (LoRA hot-swap).  Under a mesh the module
    holds the rank's shards, and :meth:`update_params` takes the full
    weights and copies each rank's slice (JAX ``:216-237``)."""

    def __init__(self, module: torch.nn.Module, config: Optional[CompilationConfig] = None,
                 name: Optional[str] = None, method: str = "forward"):
        self.module = module
        self.name = name or type(module).__name__
        self.method = method
        self._call = global_executable_cache().register(
            self.name, LazyCompiledFunction(getattr(module, method), name=self.name))
        self._mesh = None
        self._full_shapes = None  # under a mesh: the unsharded model's state-dict shapes
        self.set_compilation_config(config or CompilationConfig.Default())

    def _shard(self, config: CompilationConfig) -> None:
        from sfast_tpu_torch.parallel.sharding import spec_fn_from_rules, unet_param_spec
        from sfast_tpu_torch.parallel.tensor_parallel import (
            full_shapes,
            init_communicators,
            shard_module,
        )

        spec_fn = (spec_fn_from_rules(config.sharding_rules) if config.sharding_rules
                   else unet_param_spec)
        init_communicators(config.mesh)
        shard_module(self.module, config.mesh, spec_fn)
        self._mesh = config.mesh
        self._full_shapes = full_shapes(self.module)

    def set_compilation_config(self, config: CompilationConfig) -> None:
        """Apply ``config``'s routes to the module and drop every graph: a
        graph bakes in the kernel routes it was captured with.  The first
        config with a mesh shards the module; a sharded module takes no
        other mesh, and no config without one.  A ``cache_dir`` fixes the
        process's build directory (``cuda_build.set_build_dir``)."""
        if config.cache_dir is not None:
            from sfast_tpu_torch.runtime import cuda_build

            cuda_build.set_build_dir(config.cache_dir)
        if config.mesh is not self._mesh:
            if self._mesh is not None:
                raise ValueError(f"{self.name}: the module is sharded over another mesh; a "
                                 "sharded module keeps its mesh (compile a new module)")
            self._shard(config)
        self.compilation_config = config
        self.module.compilation_config = config
        self.clear_cache()

    def _boundary(self, run, args, kwargs):
        """``run(*args, **kwargs)`` in the config's layout and precision."""
        cfg = self.compilation_config
        nchw = cfg.memory_format == "NCHW"
        if nchw:
            args, kwargs = tree_to_nhwc((args, kwargs))
        with contextlib.nullcontext() if cfg.prefer_lowp_gemm else high_compute_precision():
            out = run(*args, **kwargs)
        return tree_to_nchw(out) if nchw else out

    def __call__(self, *args, **kwargs):
        if self.compilation_config.enable_cuda_graph:
            return self._boundary(self._call, args, kwargs)
        return self._boundary(getattr(self.module, self.method), args, kwargs)

    def __getattr__(self, name):
        if name == self.__dict__.get("method"):
            return self.__call__
        if "module" not in self.__dict__:  # not yet initialised
            raise AttributeError(name)
        return getattr(self.__dict__["module"], name)

    def warmup(self, *args, **kwargs) -> "CompiledModel":
        """Capture the graph of this signature without replaying it."""
        if self.compilation_config.enable_cuda_graph:
            self._boundary(self._call.warmup, args, kwargs)
        return self

    @torch.no_grad()
    def update_params(self, state_dict) -> None:
        """Copy ``state_dict`` into the module's parameters and buffers in
        place.  Its names and shapes must be the module's (under a mesh:
        the unsharded model's, of which each rank copies its slice):
        anything else raises, since the graphs would go on reading the old
        tensors."""
        own = self.module.state_dict(keep_vars=True)
        missing, extra = sorted(set(own) - set(state_dict)), sorted(set(state_dict) - set(own))
        if missing or extra:
            raise ValueError(f"{self.name}: state dict structure changed: missing {missing[:5]}, "
                             f"unexpected {extra[:5]}")
        shapes = self._full_shapes or {k: t.shape for k, t in own.items()}
        for key in own:
            if tuple(state_dict[key].shape) != tuple(shapes[key]):
                raise ValueError(f"{self.name}: {key} has shape {tuple(state_dict[key].shape)}, "
                                 f"the module's is {tuple(shapes[key])}")
        if self._mesh is not None:
            from sfast_tpu_torch.parallel.tensor_parallel import local_state_dict

            state_dict = local_state_dict(self.module, state_dict)
        # one call for all the copies: a LoRA swap copies ~700 UNet tensors
        torch._foreach_copy_(list(own.values()), [state_dict[k] for k in own])

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


# The method the pipeline calls of a slot's module, where it is not forward
_SLOT_METHODS = {"vae": "decode", "vae_encode": "encode"}


def _looks_like_torch_module(m) -> bool:
    return hasattr(m, "state_dict") and hasattr(m, "named_parameters")


def _is_native_model(m) -> bool:
    """A model of the port (or a subclass of one)."""
    from sfast_tpu_torch import models

    return isinstance(m, (
        models.UNet2DConditionModel, models.ControlNetModel, models.AutoencoderKL,
        models.AutoencoderKLTemporalDecoder, models.AutoencoderTiny, models.CLIPTextModel,
        models.CLIPVisionModel, models.UNetSpatioTemporalConditionModel))


def _is_foreign(m) -> bool:
    return (_looks_like_torch_module(m) and not isinstance(m, CompiledModel)
            and not _is_native_model(m))


def compile(pipeline: Any, config: Optional[CompilationConfig] = None, *, device=None):
    """Compile a pipeline and return it.  A pipeline with a foreign module
    in a slot (a diffusers pipeline) is first converted into the port's
    pipeline (``interop/diffusers_adapter.convert_pipeline``: its models
    built on ``device``, the card when None), which is returned; any other
    is compiled in place.  Idempotent and duck-typed: every
    ``_SUBMODEL_ATTRS`` slot holding a model of the port is wrapped once
    (the VAE by its ``decode``, ``vae_encode`` — which may be the same
    module — by its ``encode``), the scheduler's step when
    ``trace_scheduler`` is on; then the pipeline's
    ``set_compilation_config`` applies ``config`` and drops every graph."""
    from sfast_tpu_torch.pipelines.stable_diffusion import PipelineBase

    config = config or CompilationConfig.Default()
    if isinstance(pipeline, PipelineBase):
        pipeline.check_compilation_config(config)
    if any(_is_foreign(getattr(pipeline, a, None)) for a in _SUBMODEL_ATTRS):
        from sfast_tpu_torch.interop.diffusers_adapter import convert_pipeline

        pipeline = convert_pipeline(pipeline, config, device=device)
    for attr in _SUBMODEL_ATTRS:
        sub = getattr(pipeline, attr, None)
        if not _is_native_model(sub):
            continue
        method = _SLOT_METHODS.get(attr, "forward")
        if not hasattr(sub, method):
            method = "forward"
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
