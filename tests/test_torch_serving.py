"""The port's serving surface against sfast_tpu's (CPU): ``map``, step
callbacks, PIL output and background warm-up, on SD1.5 and SDXL at tiny
size.

The pipelines share weights (``interop.from_jax``), prompt ids and initial
latents (``latents=`` on both sides: JAX's threefry is not torch's
Philox).  JAX runs compiled on its plain routes.  Tolerance as
``tests/test_torch_pipeline.py``: uint8 images at most 1 level, the
rounding of values that land near a level boundary; the port's ``map``
against its own sequential calls, exactly.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfast_tpu
from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu_torch import CompilationConfig
from sfast_tpu_torch.pipelines.stable_diffusion import WarmupThread
from tests.test_torch_pipeline import HW, tiny_pipes
from tests.test_torch_sdxl import _pipes as tiny_xl_pipes
from tests.test_torch_svd import _one_torch_thread  # noqa: F401  (an autouse fixture)

JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
STEPS = 2


@pytest.fixture(scope="module")
def pipes():
    jpipe, tpipe = tiny_pipes()
    return sfast_tpu.compile(jpipe, JAX_CCFG), tpipe


@pytest.fixture(scope="module")
def xl_pipes():
    return tiny_xl_pipes()


def _ids(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, (1, 77)).astype(np.int32) for _ in range(n)]


def _latents(seed=0):
    return np.random.default_rng(seed).standard_normal((1, HW // 2, HW // 2, 4)).astype(np.float32)


def _kw(**extra):
    return {**dict(height=HW, width=HW, num_inference_steps=STEPS, guidance_scale=7.5), **extra}


def test_map_equals_sequential_calls_and_jax_map(pipes):
    jpipe, tpipe = pipes
    ids, lat = _ids(3), _latents()
    seq = [tpipe(prompt_ids=i, latents=torch.from_numpy(lat), **_kw()).images for i in ids]
    piped = [o.images for o in tpipe.map(ids, window=2, latents=torch.from_numpy(lat), **_kw())]
    ref = [o.images for o in jpipe.map([jnp.asarray(i) for i in ids], window=2,
                                       latents=jnp.asarray(lat), **_kw())]
    assert len(piped) == len(seq) == len(ref) == 3
    for got, want, jax_img in zip(piped, seq, ref):
        assert got.dtype == np.uint8 and got.shape == (1, HW, HW, 3)
        np.testing.assert_array_equal(got, want)
        assert np.abs(got.astype(int) - np.asarray(jax_img).astype(int)).max() <= 1
    # window 1 fetches each image before the next call: the same images
    one = [o.images for o in tpipe.map(ids, window=1, latents=torch.from_numpy(lat), **_kw())]
    for got, want in zip(one, seq):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["window", "pt", "latent", "item"])
def test_map_raises_as_jax_does(pipes, kind):
    """JAX's messages (``tests/pipelines/test_stable_diffusion.py:124-152``)."""
    jpipe, tpipe = pipes
    items, kw, error, match = _ids(1), {}, ValueError, "output_type"
    if kind == "window":
        kw, match = dict(window=0), "window must be >= 1"
    elif kind in ("pt", "latent"):
        kw = dict(output_type=kind)
    else:
        items, error, match = [("a", "b")], TypeError, "map\\(\\) items"
    for pipe in (jpipe, tpipe):
        with pytest.raises(error, match=match):
            next(pipe.map(items, **_kw(), **kw))


def test_callback_runs_once_per_executed_step_with_its_latents(pipes):
    _, tpipe = pipes
    ids, lat = _ids(1)[0], torch.from_numpy(_latents(1))
    seen = []

    def record(pipe, i, t, kw):
        assert pipe is tpipe
        seen.append((i, float(t), kw["latents"].clone()))

    plain = tpipe(prompt_ids=ids, latents=lat, **_kw(num_inference_steps=3))
    called = tpipe(prompt_ids=ids, latents=lat, callback_on_step_end=record,
                   **_kw(num_inference_steps=3))
    np.testing.assert_array_equal(called.images, plain.images)
    state, _ = tpipe._scheduler_state(3)
    assert [i for i, _, _ in seen] == [0, 1, 2]
    assert [t for _, t, _ in seen] == [float(t) for t in state["timesteps"]]
    final = tpipe(prompt_ids=ids, latents=lat, output_type="latent",
                  **_kw(num_inference_steps=3)).images
    torch.testing.assert_close(seen[-1][2], final, rtol=0, atol=0)

    # img2img enters at step N − int(N·strength) = 2 of 4: its steps only
    seen.clear()
    image = np.random.default_rng(2).integers(0, 256, (1, HW, HW, 3), dtype=np.uint8)
    tpipe(prompt_ids=ids, image=image, strength=0.5, callback_on_step_end=record,
          **_kw(num_inference_steps=4))
    assert [i for i, _, _ in seen] == [2, 3]


def test_callback_takes_the_stepwise_path_under_the_fused_loop(pipes):
    _, tpipe = pipes
    ids, lat = _ids(1)[0], torch.from_numpy(_latents(2))
    tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
    try:
        fused = tpipe(prompt_ids=ids, latents=lat, **_kw()).images
        assert tpipe._fused_loops
        tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=True))
        steps = []
        stepwise = tpipe(prompt_ids=ids, latents=lat,
                         callback_on_step_end=lambda p, i, t, kw: steps.append(i), **_kw()).images
        assert steps == list(range(STEPS)) and not tpipe._fused_loops
    finally:
        tpipe.set_compilation_config(CompilationConfig())
    assert np.abs(stepwise.astype(int) - fused.astype(int)).max() <= 1


def test_pil_output_is_the_np_images(pipes):
    _, tpipe = pipes
    ids, lat = _ids(1, seed=4), torch.from_numpy(_latents(3))
    array = tpipe(prompt_ids=ids[0], latents=lat, **_kw()).images
    (mapped,) = [o.images for o in tpipe.map(ids, output_type="pil", latents=lat, **_kw())]
    direct = tpipe(prompt_ids=ids[0], latents=lat, output_type="pil", **_kw()).images
    for pil in (mapped, direct):
        assert len(pil) == 1 and pil[0].size == (HW, HW) and pil[0].mode == "RGB"
        np.testing.assert_array_equal(np.asarray(pil[0]), array[0])


def test_background_warmup_returns_a_started_thread_that_joins(pipes):
    _, tpipe = pipes
    thread = tpipe.warmup(resolutions=((HW, HW),), steps=(STEPS,), background=True)
    assert isinstance(thread, WarmupThread) and isinstance(thread, threading.Thread)
    assert thread.daemon and thread.ident is not None  # started
    thread.join(timeout=120)
    assert not thread.is_alive() and thread.error is None
    assert tpipe.warmup(resolutions=((HW, HW),), steps=(STEPS,)) is None


def test_a_failing_background_warmup_raises_from_join(pipes, monkeypatch):
    _, tpipe = pipes

    def fail(*a, **kw):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(tpipe.vae, "decode", fail)
    thread = tpipe.warmup(resolutions=((HW, HW),), steps=(STEPS,), background=True)
    with pytest.raises(RuntimeError, match="decode failed"):
        thread.join(timeout=120)
    with pytest.raises(RuntimeError, match="decode failed"):  # and on every join
        thread.join()


def test_sdxl_callback_and_map(xl_pipes):
    _, tpipe = xl_pipes
    ids, lat = _ids(2, seed=5), torch.from_numpy(_latents(4))
    kw = _kw(guidance_scale=5.0)
    seq = [tpipe(prompt_ids=i, latents=lat, **kw).images for i in ids]
    piped = [o.images for o in tpipe.map(ids, latents=lat, **kw)]
    for got, want in zip(piped, seq):
        np.testing.assert_array_equal(got, want)
    seen = []
    img = tpipe(prompt_ids=ids[0], latents=lat, output_type="pil",
                callback_on_step_end=lambda p, i, t, k: seen.append((i, k["latents"].shape)),
                **kw).images
    assert seen == [(i, (1, HW // 2, HW // 2, 4)) for i in range(STEPS)]
    np.testing.assert_array_equal(np.asarray(img[0]), seq[0][0])
