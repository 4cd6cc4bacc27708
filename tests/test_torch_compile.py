"""The port's compile layer on the CPU: signatures, batch buckets, the
CUDA-graph cache's bookkeeping, and ``CompiledModel``.

A graph cannot be captured here, so the cache tests replace the capture
step with a recorder whose "graph" runs the function on the static inputs
(counterparts of ``tests/runtime/test_tracing.py:13-104`` and
``tests/compilers/test_compiled_model.py``).  ``CapturedGraph.run`` is
tested with a stand-in graph that computes on its static inputs, as a
replay does.  Captures and replays on the card are in
``tests/test_torch_graphs_cuda.py``.
"""

import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import sfast_tpu_torch
from sfast_tpu.runtime import shape_bucket as jax_bucket
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.compilers import CompiledModel, compile_unet, compile_vae
from sfast_tpu_torch.models import (
    TINY_TEST_VAE, TINY_TEXT_ENCODER, TINY_UNET, AutoencoderKL, CLIPTextModel,
    UNet2DConditionModel, init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.runtime import cuda_build, shape_bucket
from sfast_tpu_torch.runtime.executable_cache import ExecutableCache, global_executable_cache
from sfast_tpu_torch.runtime.signature import arg_signature, call_signature
from sfast_tpu_torch.runtime.tracing import (
    CapturedGraph, LazyCompiledFunction, bump_weights_version,
)
from sfast_tpu_torch.schedulers import CompiledScheduler, DPMSolverMultistepScheduler

# ---------------------------------------------------------------------------
# signatures (tests/runtime/test_signature.py)
# ---------------------------------------------------------------------------


def test_shape_sensitive_distinguishes_shapes():
    assert arg_signature(torch.zeros(2, 3)) != arg_signature(torch.zeros(2, 4))
    assert arg_signature(torch.zeros(2, 3)) == arg_signature(torch.ones(2, 3))


def test_dtype_and_device_matter():
    a = torch.zeros(2, 3)
    assert arg_signature(a) != arg_signature(a.to(torch.bfloat16))
    assert arg_signature(a) != arg_signature(torch.zeros(2, 3, device="meta"))


def test_scalars_hash_by_value():
    # host scalars are baked into a graph, so they key it by value
    assert arg_signature(np.float32(1.0)) != arg_signature(np.float32(2.0))
    assert arg_signature(torch.tensor(1.0)) != arg_signature(torch.tensor(2.0))
    assert arg_signature(np.zeros((2,), np.float32)) == arg_signature(np.ones((2,), np.float32))


def test_structures():
    s1 = call_signature((torch.zeros(2),), {"k": [1, 2, None]})
    s2 = call_signature((torch.zeros(2),), {"k": [1, 2, None]})
    s3 = call_signature((torch.zeros(3),), {"k": [1, 2, None]})
    assert s1 == s2
    assert s1 != s3
    assert isinstance(hash(s1), int)
    assert arg_signature([torch.zeros(2)]) != arg_signature((torch.zeros(2),))


def test_primitives_vs_types():
    assert arg_signature(1) != arg_signature(1.0)
    assert arg_signature(True) != arg_signature(1)
    assert arg_signature("x") != arg_signature(b"x")


def test_opaque_objects_hash_by_type():
    class Foo:
        pass

    assert arg_signature(Foo()) == arg_signature(Foo())
    assert arg_signature(Foo()) != arg_signature(object())


def test_dict_order_insensitive():
    assert arg_signature({"a": 1, "b": 2}) == arg_signature({"b": 2, "a": 1})


def test_grad_and_inference_modes_join_the_key():
    x = torch.zeros(2)
    assert arg_signature(x) != arg_signature(torch.zeros(2, requires_grad=True))
    plain = call_signature((x,), {})
    with torch.no_grad():
        assert call_signature((x,), {}) != plain
    with torch.inference_mode():
        assert call_signature((x,), {}) != plain


# ---------------------------------------------------------------------------
# batch buckets against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 41))
def test_bucket_and_pad_match_jax(n):
    for buckets in (None, (2, 6), (3,)):
        assert shape_bucket.bucket_size(n, buckets) == jax_bucket.bucket_size(n, buckets)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    ours, real = shape_bucket.pad_batch(torch.from_numpy(x))
    theirs, jreal = jax_bucket.pad_batch(jnp.asarray(x))
    assert real == jreal == n
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(shape_bucket.unpad_batch(ours, real).numpy(), x)


def test_exact_bucket_is_not_copied():
    x = torch.ones(4, 2)
    padded, n = shape_bucket.pad_batch(x)
    assert padded is x and n == 4


# ---------------------------------------------------------------------------
# the graph cache's bookkeeping, capture replaced by a recorder
# ---------------------------------------------------------------------------


class _RecordedGraph:
    """Stands in for a capture: runs the function on its arguments."""

    def __init__(self, fn, spec, log):
        self.fn, self.spec, self.log = fn, spec, log

    def run(self, leaves):
        self.log.append("run")
        args, kwargs = pytree.tree_unflatten(leaves, self.spec)
        return self.fn(*args, **kwargs)


@pytest.fixture
def recorder(monkeypatch):
    log = []

    def capture(self, leaves, spec):
        log.append("capture")
        return _RecordedGraph(self.fn, spec, log)

    monkeypatch.setattr(LazyCompiledFunction, "_capture", capture)
    monkeypatch.setattr(LazyCompiledFunction, "_uses_graph", staticmethod(lambda leaves: True))
    return log


def test_cache_grows_only_on_a_new_signature(recorder):
    f = LazyCompiledFunction(lambda x, y: x * 2 + y, name="f")
    a = torch.ones(4, 4)
    np.testing.assert_array_equal(f(a, a).numpy(), np.full((4, 4), 3.0))
    f(a + 1, a)
    assert f.cache_size == 1 and recorder == ["capture", "run", "run"]
    f(torch.ones(2, 2), torch.ones(2, 2))  # a new shape: a new graph
    assert f.cache_size == 2


def test_kwargs_and_structures(recorder):
    def fn(x, scale=None, extras=None):
        out = x * scale
        if extras is not None:
            out = out + extras["bias"]
        return {"out": out, "aux": (out.sum(),)}

    f = LazyCompiledFunction(fn)
    x = torch.ones(3)
    r = f(x, scale=torch.tensor(2.0), extras={"bias": torch.ones(3)})
    np.testing.assert_array_equal(r["out"].numpy(), [3, 3, 3])
    assert r["aux"][0].item() == 9
    # the same signature with the dict's keys in another order
    f(x, extras={"bias": torch.zeros(3)}, scale=torch.tensor(2.0))
    assert f.cache_size == 1
    f(x, scale=torch.tensor(3.0), extras={"bias": torch.ones(3)})  # a CPU scalar is baked in
    assert f.cache_size == 2


def test_warmup_captures_without_running(recorder):
    calls = []
    f = LazyCompiledFunction(lambda x: calls.append(1) or x + 1)
    assert f.warmup(torch.zeros(8)) is f
    assert f.cache_size == 1 and recorder == ["capture"] and not calls
    f(torch.zeros(8))
    assert recorder == ["capture", "run"]


def test_a_new_weights_version_drops_the_graphs_that_read_it(recorder):
    """A module's bound method reads its module; a closure reads what it is
    told.  Bumping the module's version drops those graphs at their next
    call, and no other."""
    lin = torch.nn.Linear(4, 4)
    f = LazyCompiledFunction(lin.forward)
    g = LazyCompiledFunction(lambda x: lin(x) * 2, reads=(lin, None))
    h = LazyCompiledFunction(lambda x: x + 1)
    assert f.reads == g.reads == (lin,) and h.reads == ()
    x = torch.ones(2, 4)
    for fn in (f, g, h):
        fn(x)
    assert recorder.count("capture") == 3
    bump_weights_version(lin)
    for fn in (f, g, h):
        fn(x)
        fn(x)
    assert recorder.count("capture") == 5 and f.cache_size == g.cache_size == h.cache_size == 1


def test_clear_cache(recorder):
    f = LazyCompiledFunction(lambda x: x * 2)
    f(torch.ones(2))
    assert f.cache_size == 1
    f.clear_cache()
    assert f.cache_size == 0


def test_cpu_tensors_never_capture(monkeypatch):
    def refuse(self, leaves, spec):
        raise AssertionError("a CPU call must not capture")

    monkeypatch.setattr(LazyCompiledFunction, "_capture", refuse)
    f = LazyCompiledFunction(lambda x: x + 1)
    np.testing.assert_array_equal(f(torch.zeros(3)).numpy(), [1, 1, 1])
    f.warmup(torch.zeros(3))
    assert f.cache_size == 0


def test_executable_cache_registry(recorder):
    cache = ExecutableCache()
    f = cache.register("f", LazyCompiledFunction(lambda x: x + 1))
    g = cache.register("g", LazyCompiledFunction(lambda x: x - 1))
    assert cache.get("f") is f and cache.get("g") is g and cache.get("h") is None
    f(torch.zeros(2))
    f(torch.zeros(3))
    assert cache.stats() == {"f": 2, "g": 0}
    cache.clear()
    assert cache.stats() == {} and f.cache_size == 0


def test_executable_cache_keeps_every_function_under_a_name(recorder):
    cache = ExecutableCache()
    a = cache.register("unet", LazyCompiledFunction(lambda x: x + 1))
    b = cache.register("unet", LazyCompiledFunction(lambda x: x + 2))
    assert cache.get_all("unet") == [a, b] and cache.get("unet") is b
    cache.register("unet", a)  # again: held once, now the newest
    assert cache.get_all("unet") == [b, a] and cache.get("unet") is a
    a(torch.zeros(2))
    b(torch.zeros(3))
    b(torch.zeros(4))
    assert cache.stats() == {"unet": 3}
    del b  # held weakly: a dropped function leaves the registry
    gc.collect()
    assert cache.get_all("unet") == [a] and cache.stats() == {"unet": 1}
    cache.clear()
    assert cache.stats() == {} and a.cache_size == 0


def test_two_pipelines_share_the_registry(recorder):
    pipes = []
    for _ in range(2):
        unet, vae, te = _modules()
        pipes.append(sfast_tpu_torch.compile(StableDiffusionPipeline(
            unet, vae, te, DPMSolverMultistepScheduler(), device="cpu", dtype=torch.float32)))
    cache = global_executable_cache()
    for slot in ("unet", "vae", "text_encoder"):
        assert all(getattr(p, slot)._call in cache.get_all(slot) for p in pipes)
    assert all(p.scheduler._step in cache.get_all("scheduler.step") for p in pipes)
    with torch.inference_mode():
        for p in pipes:
            p.vae.decode(torch.randn(1, 8, 8, 4))
    assert cache.stats()["vae"] >= 2
    cache.clear()  # both pipelines' graphs go
    assert [p.vae.cache_size for p in pipes] == [0, 0]


class _StandInGraph:
    """Replays ``fn`` from the static inputs into the static outputs."""

    def __init__(self, fn, static_in, static_out):
        self.fn, self.static_in, self.static_out = fn, static_in, static_out

    def replay(self):
        self.static_out.copy_(self.fn(self.static_in))


def test_captured_graph_run_copies_in_counts_and_clones_out():
    static_in, static_out = torch.zeros(3), torch.zeros(3)
    g = CapturedGraph(_StandInGraph(lambda x: x * 2, static_in, static_out), [static_in],
                      static_out, {"flash_attention": 5}, 0.0, 0.0, 1)
    cuda_build.reset_launch_counts()
    a = g.run([torch.ones(3)])
    b = g.run([torch.full((3,), 2.0)])
    # the first output survives the second replay: outputs are clones
    np.testing.assert_array_equal(a.numpy(), [2, 2, 2])
    np.testing.assert_array_equal(b.numpy(), [4, 4, 4])
    assert a.data_ptr() != static_out.data_ptr()
    assert cuda_build.launch_counts["flash_attention"] == 10
    cuda_build.reset_launch_counts()


# ---------------------------------------------------------------------------
# CompiledModel and compile()
# ---------------------------------------------------------------------------

F32 = dict(device="cpu", dtype=torch.float32)
UNET64 = dataclasses.replace(TINY_UNET, cross_attention_dim=64)


def _modules(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (init_weights_(UNet2DConditionModel(UNET64, **F32), g),
            init_weights_(AutoencoderKL(TINY_TEST_VAE, **F32), g),
            init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, **F32), g))


def _unet_inputs():
    g = torch.Generator().manual_seed(1)
    return (torch.randn(2, 16, 16, 4, generator=g), torch.tensor(500.0),
            torch.randn(2, 7, 64, generator=g))


def test_compile_is_idempotent_and_duck_typed():
    class Pipe:
        pass

    unet, vae, _ = _modules()
    pipe = Pipe()
    pipe.unet, pipe.vae, pipe.text_encoder = unet, vae, None
    out = sfast_tpu_torch.compile(pipe)
    assert out is pipe and isinstance(pipe.unet, CompiledModel)
    assert pipe.vae.method == "decode" and pipe.text_encoder is None
    first = pipe.unet
    sfast_tpu_torch.compile(pipe)
    assert pipe.unet is first and pipe.unet.module is unet
    # attributes are the module's, and decode is the compiled call
    assert pipe.vae.config is vae.config and pipe.unet.conv_in is unet.conv_in
    z = torch.randn(1, 8, 8, 4)
    with torch.inference_mode():
        torch.testing.assert_close(pipe.vae.decode(z), vae.decode(z), rtol=0, atol=0)


def test_update_params_keeps_the_graphs_and_changes_the_output(recorder):
    unet, _, _ = _modules()
    cm = compile_unet(unet)
    x, t, ctx = _unet_inputs()
    with torch.inference_mode():
        before = cm(x, t, ctx)
    weights = cm.conv_out.weight
    new = {k: v * 1.5 for k, v in unet.state_dict().items()}
    cm.update_params(new)
    with torch.inference_mode():
        after = cm(x, t, ctx)
    assert cm.cache_size == 1 and recorder.count("capture") == 1
    assert cm.conv_out.weight is weights  # copied in place: the same tensor
    torch.testing.assert_close(weights, new["conv_out.weight"], rtol=0, atol=0)
    assert not torch.allclose(before, after)


def test_update_params_rejects_a_structure_change():
    unet, _, _ = _modules()
    cm = compile_unet(unet)
    sd = unet.state_dict()
    with pytest.raises(ValueError, match="structure"):
        cm.update_params({k: v for k, v in sd.items() if k != "conv_out.bias"})
    with pytest.raises(ValueError, match="structure"):
        cm.update_params(dict(sd, extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="shape"):
        cm.update_params(dict(sd, **{"conv_out.bias": torch.zeros(5)}))


def test_graphs_off_runs_the_module(recorder):
    unet, vae, _ = _modules()
    cm = compile_vae(vae, CompilationConfig(enable_cuda_graph=False))
    with torch.inference_mode():
        cm.decode(torch.randn(1, 8, 8, 4))
    assert cm.cache_size == 0 and not recorder
    assert cm.module.compilation_config.enable_cuda_graph is False


def test_config_change_clears_every_cache(recorder):
    unet, vae, te = _modules()
    pipe = sfast_tpu_torch.compile(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), device="cpu", dtype=torch.float32))
    assert isinstance(pipe.scheduler, CompiledScheduler)
    kw = dict(prompt_ids=np.ones((1, 77), np.int64), height=32, width=32,
              num_inference_steps=2, output_type="pt")
    pipe(**kw)
    parts = (pipe.unet, pipe.vae, pipe.text_encoder, pipe.scheduler)
    # here the 0-d timestep and step index are CPU scalars, keyed by value:
    # one graph per step (on the card, one for every step)
    assert [p.cache_size for p in parts] == [2, 1, 1, 2]
    pipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    assert [p.cache_size for p in parts] == [0, 0, 0, 0]
    pipe(**kw)
    loop = global_executable_cache().get("denoise_loop_2")
    assert loop.cache_size == 1 and pipe.scheduler.cache_size == 0
    pipe.set_compilation_config(CompilationConfig(enable_kernels=False))
    assert loop.cache_size == 0 and not pipe._fused_loops
    assert all(p.cache_size == 0 for p in parts)
    assert unet.compilation_config.enable_kernels is False
