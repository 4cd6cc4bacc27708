"""The port's compile surface (CPU): ``memory_format`` at a compiled model's
boundary, ``prefer_lowp_gemm`` and the precision contexts, ``lazy_jit``,
the top-level exports, the deprecated compiler alias, ``utils/env.py``,
``utils/patch.py``, and an import with JAX blocked.

A channel-first call must equal the NHWC call transposed exactly: the
model sees the same contiguous NHWC tensors either way.
"""

import importlib
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import sfast_tpu_torch
from sfast_tpu_torch import CompilationConfig, compile_model, compile_unet, compile_vae, lazy_jit
from sfast_tpu_torch.compilers import diffusion_pipeline_compiler
from sfast_tpu_torch.models import (
    TINY_SVD_UNET, TINY_TEST_VAE, TINY_TEXT_ENCODER, TINY_UNET, AutoencoderKL, CLIPTextModel,
    UNet2DConditionModel, UNetSpatioTemporalConditionModel, init_svd_unet_weights_,
    init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction, weights_version
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler
from sfast_tpu_torch.utils import env
from sfast_tpu_torch.utils.compute_precision import high_compute_precision, low_compute_precision
from sfast_tpu_torch.utils.patch import patch_module
from tests.test_torch_svd import _one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(device="cpu", dtype=torch.float32)
NCHW = CompilationConfig(memory_format="NCHW")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _precision():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def test_nchw_unet_equals_the_transposed_nhwc_unet():
    unet = init_weights_(UNet2DConditionModel(TINY_UNET, **F32), _gen(0))
    x = torch.randn((2, 16, 16, 4), generator=_gen(1))
    t, ctx = torch.tensor(500.0), torch.randn((2, 7, 32), generator=_gen(2))
    with torch.inference_mode():
        nhwc = compile_unet(unet)(x, t, ctx)
        nchw = compile_unet(unet, NCHW)(x.permute(0, 3, 1, 2).contiguous(), t, ctx)
    assert nchw.shape == (2, 4, 16, 16)
    assert torch.equal(nchw.permute(0, 2, 3, 1), nhwc)
    assert nchw.is_contiguous(memory_format=torch.channels_last)  # a view: no copy


def test_nchw_vae_decode_equals_the_transposed_nhwc_decode():
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, **F32), _gen(3))
    z = torch.randn((1, 8, 8, 4), generator=_gen(4))
    with torch.inference_mode():
        nhwc = compile_vae(vae).decode(z)
        # a channels-last NCHW input is already NHWC in memory
        nchw = compile_vae(vae, NCHW).decode(z.permute(0, 3, 1, 2))
    assert torch.equal(nchw.permute(0, 2, 3, 1), nhwc)


def test_nchw_svd_unet_takes_five_dimensional_input():
    unet = init_svd_unet_weights_(UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32), _gen(5))
    x = torch.randn((1, 2, 16, 16, 8), generator=_gen(6))  # (B, F, H, W, C)
    t = torch.tensor(0.5)
    ctx = torch.randn((1, 1, 32), generator=_gen(7))
    ids = torch.tensor([[6.0, 127.0, 0.02]])
    with torch.inference_mode():
        nhwc = compile_model(unet)(x, t, ctx, ids)
        nchw = compile_model(unet, NCHW)(x.permute(0, 4, 1, 2, 3).contiguous(), t, ctx, ids)
    assert nchw.shape == (1, 4, 2, 16, 16)
    assert torch.equal(nchw.permute(0, 2, 3, 4, 1), nhwc)


def test_unknown_memory_format_raises_and_pipelines_refuse_nchw():
    with pytest.raises(ValueError, match="memory_format must be 'NHWC' or 'NCHW'"):
        CompilationConfig(memory_format="NCWH")
    with pytest.raises(ValueError, match="memory_format must be"):
        CompilationConfig().replace(memory_format="channels_last")
    pipe = StableDiffusionPipeline(
        UNet2DConditionModel(TINY_UNET, **F32), AutoencoderKL(TINY_TEST_VAE, **F32),
        CLIPTextModel(TINY_TEXT_ENCODER, **F32), DPMSolverMultistepScheduler(), device="cpu",
        dtype=torch.float32)
    with pytest.raises(ValueError, match="NHWC"):
        sfast_tpu_torch.compile(pipe, NCHW)
    assert not isinstance(pipe.unet, diffusion_pipeline_compiler.CompiledModel)


class _Probe(torch.nn.Module):
    """Records the precision flags it runs under."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)
        self.seen = []

    def forward(self, x):
        self.seen.append(_precision())
        return self.lin(x)


def test_prefer_lowp_gemm_false_runs_the_call_at_high_precision():
    before = _precision()
    probe = _Probe()
    compiled = compile_model(probe, CompilationConfig(prefer_lowp_gemm=False))
    compiled(torch.ones(2, 4))
    compile_model(probe, CompilationConfig())(torch.ones(2, 4))
    assert probe.seen == [(False, False, False), before]
    assert _precision() == before


@pytest.mark.parametrize("ctx,flags", [(low_compute_precision, (True, True, True)),
                                       (high_compute_precision, (False, False, False))])
def test_precision_contexts_set_and_restore_the_flags(ctx, flags):
    before = _precision()
    with ctx():
        assert _precision() == flags
    assert _precision() == before
    with pytest.raises(KeyError):
        with ctx():
            raise KeyError("restored on an exception too")
    assert _precision() == before


def test_lazy_jit_wraps_a_function_directly_and_as_a_decorator():
    def double(x):
        return 2 * x

    f = lazy_jit(double)
    assert isinstance(f, LazyCompiledFunction) and f.name == "double" and f.warmup_calls == 3

    @lazy_jit(name="triple", warmup_calls=1)
    def g(x):
        return 3 * x

    assert isinstance(g, LazyCompiledFunction) and g.name == "triple" and g.warmup_calls == 1
    x = torch.arange(3.0)
    assert torch.equal(f(x), 2 * x) and torch.equal(g(x), 3 * x)
    assert f.cache_size == g.cache_size == 0  # CPU tensors run the function, capture nothing


def test_top_level_exports():
    for name in ("compile", "compile_model", "compile_unet", "compile_vae", "lazy_jit",
                 "CompilationConfig", "quant"):
        assert name in sfast_tpu_torch.__all__ and hasattr(sfast_tpu_torch, name)
    assert sfast_tpu_torch.compile_unet is diffusion_pipeline_compiler.compile_unet
    vae = AutoencoderKL(TINY_TEST_VAE, **F32)
    assert sfast_tpu_torch.compile_vae(vae).method == "decode"
    assert sfast_tpu_torch.compile_unet(vae).name == "unet"


def test_the_deprecated_alias_warns():
    name = "sfast_tpu_torch.compilers.stable_diffusion_pipeline_compiler"
    sys.modules.pop(name, None)
    with pytest.warns(DeprecationWarning, match="diffusion_pipeline_compiler"):
        alias = importlib.import_module(name)
    assert alias.compile is sfast_tpu_torch.compile
    assert alias.CompiledModel is diffusion_pipeline_compiler.CompiledModel


def test_setup_environment_is_idempotent_and_runs_the_hook(tmp_path, monkeypatch):
    (tmp_path / "sfast_env_hook.py").write_text(textwrap.dedent("""
        calls = []

        def setup_environment():
            calls.append(1)
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("SFAST_TPU_ENV_MODULE", "sfast_env_hook")
    monkeypatch.setattr(env, "_SETUP_DONE", False)
    env.setup_environment()
    env.setup_environment()
    assert importlib.import_module("sfast_env_hook").calls == [1]


def test_seed_all_rng_makes_draws_repeatable():
    def draws():
        return random.random(), np.random.rand(), torch.rand(2).tolist()

    env.seed_all_rng(123)
    first = draws()
    env.seed_all_rng(123)
    assert draws() == first
    env.seed_all_rng(124)
    assert draws() != first


def test_patch_module_replaces_matching_submodules_and_bumps_weights_version():
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                                torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU()))
    inner = model[2]
    seen = []
    before = weights_version(model), weights_version(inner)
    out = patch_module(model, lambda name, m: isinstance(m, torch.nn.Linear),
                       lambda name, m: seen.append(name) or torch.nn.Identity())
    assert out is model and seen == ["0", "2.0"]
    assert isinstance(model[0], torch.nn.Identity) and isinstance(inner[0], torch.nn.Identity)
    assert weights_version(model) == before[0] + 1 and weights_version(inner) == before[1] + 1
    # a matched submodule is replaced whole, not walked
    patch_module(model, lambda name, m: name == "2", lambda name, m: torch.nn.Tanh())
    assert isinstance(model[2], torch.nn.Tanh)
    # nothing matched: nothing bumped
    version = weights_version(model)
    patch_module(model, lambda name, m: False, lambda name, m: m)
    assert weights_version(model) == version


def test_import_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises
        import sfast_tpu_torch
        import sfast_tpu_torch.interop.diffusers_adapter
        import sfast_tpu_torch.compilers.stable_diffusion_pipeline_compiler
        import sfast_tpu_torch.utils.env, sfast_tpu_torch.utils.patch
        import sfast_tpu_torch.utils.memory_format, sfast_tpu_torch.utils.compute_precision
        from sfast_tpu_torch.runtime import cuda_build
        assert cuda_build._lib is None  # importing builds and loads no kernel
        assert not any(m == "sfast_tpu" or m.startswith(("sfast_tpu.", "jax.", "diffusers",
                                                          "transformers", "PIL"))
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-W", "ignore::DeprecationWarning", "-c", code],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
