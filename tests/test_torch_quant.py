"""The port's int8 quantization against sfast_tpu's (CPU): the ops, the
site sets on four UNets, quantized UNets, and the compile layer's
recapture after a quantization; the calibrations are in
``test_torch_quant_calibrate.py`` and ``quantize_pipeline`` on the tiny
pipelines in ``test_torch_quant_pipeline.py``, which share this file's
helpers and tolerances.

JAX runs jitted with ``enable_pallas=False``; weights cross through
``interop.from_jax``; the port runs in f32.  Tolerances:

- the ops on the same inputs: int8 weights, scales and int32 sums exactly
  equal; f32 outputs within 1e-6 relative to their scale;
- calibrations: the site sets equal, each amax within 1e-5 relative;
- quantized UNets: every quantized site, on the activations the port's
  UNet meets, against JAX's ``apply_linear`` / ``apply_conv`` with JAX's
  quantized parameters within 1e-6 (measured: 0 at most sites);
- whole quantized UNets and pipelines against JAX, as relative rms (the
  error's rms over the reference's).  The two sides' f32 activations
  differ by rounding (~1e-6); where one straddles an int8 rounding
  boundary its code differs by one step, 1/127 of the tensor's range,
  which moves the next layer's inputs far more than rounding did, and
  such flips cascade.  W8A16 has no activation codes: a UNet eval within
  1e-2 and a pipeline's latents within the pipeline tolerance, 2e-3 of
  their scale (measured 1e-6 and 3e-6).  W8A8: a UNet eval within 1e-2
  with int8 linears (measured up to 8.4e-4) and 1e-1 with int8 convs
  (2.5e-3 to 3.5e-2, where the quantized UNet is 3.6e-2 to 3.9e-2 from
  the f32 one); a pipeline's latents after 2 CFG steps within 0.15
  (measured 4e-3 to 7.8e-2, against 4e-2 to 9e-2 from the unquantized
  pipeline).  The site-level checks carry the exactness.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sfast_tpu.config import CompilationConfig as JaxConfig
from sfast_tpu.models import unet_2d_condition as junet
from sfast_tpu.models import unet_spatio_temporal as jsvd
from sfast_tpu.ops import quant as jq
from sfast_tpu.quant import calibrate as jcal
from sfast_tpu.quant import dynamic_quant as jdq
import sfast_tpu_torch
from sfast_tpu_torch import CompilationConfig, ip_adapter, lora
from sfast_tpu_torch.interop import from_jax
from sfast_tpu_torch.models import (
    TINY_SVD_UNET, ControlNetModel, UNet2DConditionModel, UNetSpatioTemporalConditionModel,
)
from sfast_tpu_torch.ops import quant as tq
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.quant import calibrate as tcal
from sfast_tpu_torch.quant import dynamic_quant as tdq
from sfast_tpu_torch.runtime.tracing import LazyCompiledFunction
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler
from tests.test_torch_compile import _RecordedGraph
from tests.test_torch_compile import recorder  # noqa: F401  (a fixture)
from tests.test_torch_controlnet import CN64, J_CN64, jax_controlnet_params
from tests.test_torch_pipeline import J_UNET64, UNET64, tiny_pipes
from tests.test_torch_sdxl import J_TINY_XL_UNET, TINY_XL_UNET

F32 = dict(device="cpu", dtype=torch.float32)
JAX_CCFG = JaxConfig(enable_pallas=False, enable_aot_cache=False)
OP_TOL, CAL_TOL, UNET_RMS, PIPE_TOL, W8A8_PIPE_RMS = 1e-6, 1e-5, 1e-2, 2e-3, 0.15
# the tolerances of the other two files, here with the reasons for them


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side in one thread, as tests/test_torch_svd.py: its ops
    are tiny, and a thread pool over the machine's cores under the suite's
    parallel workers makes them far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, ref, tol):
    got, ref = np.asarray(_np(got), np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _rel_rms(got, ref) -> float:
    got, ref = np.asarray(_np(got), np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def test_weight_quantization_matches_jax():
    w = _rng(0).standard_normal((96, 40)).astype(np.float32)  # JAX (in, out)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jwq, jscale = jq.quantize_weight(jnp.asarray(w))
    wq, scale = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    assert wq.dtype == torch.int8 and wq.shape == (40, 96)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale).reshape(-1))
    cw = _rng(1).standard_normal((3, 3, 24, 16)).astype(np.float32)  # HWIO
    jcq, jcs = jq.quantize_conv_weight(jnp.asarray(cw))
    cq, cs = tq.quantize_conv_weight(torch.from_numpy(cw).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(cq.permute(2, 3, 1, 0).numpy(), np.asarray(jcq))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs).reshape(-1))
    assert cq.is_contiguous(memory_format=torch.channels_last)


def test_activation_quantization_matches_jax_at_ties():
    """Dynamic divides, static multiplies by the f32 reciprocal; both
    round half to even.  Values at exact half steps of a scale, and random
    ones, give JAX's int8 codes on both paths."""
    a_scale = np.float32(0.037)
    ties = (np.arange(-40, 40) + 0.5).astype(np.float32) * a_scale
    x = np.concatenate([ties, _rng(2).standard_normal(200).astype(np.float32)])
    jxq, js = jq.dynamic_quant_per_tensor(jnp.asarray(x))
    xq, s = tq.dynamic_quant_per_tensor(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert s.dim() == 0 and s.item() == float(js)
    jst = jq._quant_static(jnp.asarray(x), jnp.float32(a_scale))
    st = tq.quant_static(torch.from_numpy(x), torch.tensor(a_scale))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


@pytest.mark.parametrize("m,k,n", [(40, 64, 48), (3, 12, 10), (20, 20, 7)])
def test_int_mm_is_exact_and_pads_for_int_mm(m, k, n):
    """``int_mm``'s plain version against JAX's int32 dot, and the card
    route's zero padding (``_int_mm_cuda``, run here through the CPU's
    ``torch._int_mm``) at shapes that break its rules."""
    rng = _rng(3)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    ref = np.asarray(jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b.T), (((1,), (0,)), ((), ())),
                                         preferred_element_type=jnp.int32))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(tq.int_mm(ta, tb.t()).numpy(), ref)
    np.testing.assert_array_equal(tq._int_mm_cuda(ta, tb.t()).numpy(), ref)


CONVS = {"3x3": (3, 3, 1, 1), "3x3 stride 2": (3, 3, 2, 1), "1x1": (1, 1, 1, 0),
         "temporal (3, 1)": (3, 1, 1, (1, 0))}


@pytest.mark.parametrize("conv", CONVS)
def test_int_conv2d_im2col_is_exact(conv):
    kh, kw, stride, pad = CONVS[conv]
    rng = _rng(4)
    x = rng.integers(-127, 128, (2, 9, 8, 16)).astype(np.int8)
    w = rng.integers(-127, 128, (kh, kw, 16, 24)).astype(np.int8)  # HWIO
    p = [(pad, pad)] * 2 if isinstance(pad, int) else [(pad[0], pad[0]), (pad[1], pad[1])]
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), p, dimension_numbers=("NHWC", "HWIO",
                                                                              "NHWC"),
        preferred_element_type=jnp.int32))
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    got = tq.int_conv2d(tx, tw, stride=stride, padding=pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tq.int_conv2d_ref(tx, tw, stride=stride, padding=pad).numpy(),
                                  ref)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
def test_quantized_linears_match_jax(act):
    rng = _rng(5)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32) / 8  # (in, out)
    b = rng.standard_normal(40).astype(np.float32)
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    wq, ws = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    a = np.float32(0.021)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    _close(tq.linear_w8a8(tx, wq, ws, tb, act=act), jq.linear_w8a8(jx, jwq, jws, jb, act=act),
           OP_TOL)
    _close(tq.linear_w8a8_static(tx, wq, ws, torch.tensor(a), tb, act=act),
           jq.linear_w8a8_static(jx, jwq, jws, jnp.float32(a), jb, act=act), OP_TOL)
    _close(tq.int8_linear(tx, wq, ws, tb, act=act), jq.int8_linear(jx, jwq, jws, jb, act=act),
           OP_TOL)


@pytest.mark.parametrize("act,residual", [(None, False), ("silu", True), ("relu", False)])
def test_quantized_convs_match_jax(act, residual):
    rng = _rng(6)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, 16)) / 17).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    r = rng.standard_normal((2, 4, 4, 16)).astype(np.float32) if residual else None
    jwq, jws = jq.quantize_conv_weight(jnp.asarray(w))
    wq, ws = tq.quantize_conv_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    kw = dict(stride=2, padding=1, act=act)
    jr, tr = (jnp.asarray(r), torch.from_numpy(r)) if residual else (None, None)
    _close(tq.conv2d_w8a8(torch.from_numpy(x), wq, ws, torch.from_numpy(b), residual=tr, **kw),
           jq.conv2d_w8a8(jnp.asarray(x), jwq, jws, jnp.asarray(b), residual=jr, **kw), OP_TOL)
    a = np.float32(0.03)
    _close(tq.conv2d_w8a8_static(torch.from_numpy(x), wq, ws, torch.tensor(a),
                                 torch.from_numpy(b), residual=tr, **kw),
           jq.conv2d_w8a8_static(jnp.asarray(x), jwq, jws, jnp.float32(a), jnp.asarray(b),
                                 residual=jr, **kw), OP_TOL)


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------


def _svd_params():
    return jsvd.init_svd_unet_params(jax.random.key(1), jsvd.TINY_SVD_UNET)


MODELS = {
    "sd": (lambda: junet.init_unet_params(0, J_UNET64),
           lambda: UNet2DConditionModel(UNET64, **F32), from_jax.unet_state_dict),
    "sdxl": (lambda: junet.init_unet_params(0, J_TINY_XL_UNET),
             lambda: UNet2DConditionModel(TINY_XL_UNET, **F32), from_jax.unet_state_dict),
    "controlnet": (lambda: jax_controlnet_params(J_CN64, 3),
                   lambda: ControlNetModel(CN64, **F32), from_jax.controlnet_state_dict),
    "svd": (_svd_params, lambda: UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32),
            from_jax.svd_unet_state_dict),
}


def _leaves(tree, path=()):
    """(path, leaf) of every array of a JAX parameter tree, the path as
    JAX's calibration keys it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _jax_sites(tree, key):
    """Weight paths of the dicts of a JAX tree that hold ``key``."""
    return [path[:-1] + ("w",) for path, _ in _leaves(tree) if path[-1] == key]


def _port_sites(module, key):
    return {name: m for name, m in module.named_modules() if getattr(m, key, None) is not None}


@pytest.mark.parametrize("model", MODELS)
def test_quantized_sites_equal_jax(model):
    """Site for site, W8A8 linears and convs and W8A16 linears, with JAX's
    int8 weights and scales; the IP-Adapter's projections are no site."""
    init, build, writer = MODELS[model]
    p = init()
    names = from_jax.module_names(p, writer)
    m = build()
    m.load_state_dict(writer(p))
    w8 = jdq.quantize_conv_params(jdq.quantize_linear_params(p, mode="w8a8"))
    tdq.quantize_conv_params(tdq.quantize_linear_params(m, mode="w8a8"))
    jlin, jconv = _jax_sites(w8, "w_q8"), _jax_sites(w8, "w_q")
    ours = _port_sites(m, "w_q8")
    assert jlin and jconv
    assert sorted(ours) == sorted(names[q] for q in jlin + jconv)
    flat = dict(_leaves(w8))
    for path in jlin:
        got = ours[names[path]]
        np.testing.assert_array_equal(got.w_q8.numpy(), np.asarray(flat[path[:-1] + ("w_q8",)]).T)
    for path in jconv:
        got = ours[names[path]]
        np.testing.assert_array_equal(got.w_q8.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(flat[path[:-1] + ("w_q",)]))
        np.testing.assert_array_equal(got.w_scale.numpy(),
                                      np.asarray(flat[path[:-1] + ("w_scale",)]).reshape(-1))
    w16 = build()
    tdq.quantize_linear_params(w16)
    assert sorted(_port_sites(w16, "w_q")) == sorted(
        names[q] for q in _jax_sites(jdq.quantize_linear_params(p), "w_q"))
    assert all(mod.weight is None for mod in ours.values())


# ---------------------------------------------------------------------------
# quantized UNets
# ---------------------------------------------------------------------------


def _unet_inputs(seed):
    rng = _rng(seed)
    return (rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
            np.asarray([801.0, 261.0], np.float32),
            rng.standard_normal((2, 7, 64)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_unet_fwd():
    return jax.jit(functools.partial(junet.unet_fwd, J_UNET64, JAX_CCFG))


def _jax_unet_cal(p, inputs):
    """JAX's own calibration of the UNet at ``inputs``."""
    apply = functools.partial(junet.unet_fwd, J_UNET64, JAX_CCFG)
    return jcal.calibrate_forward(apply, p, [tuple(jnp.asarray(a) for a in inputs)])


def _quantize_both(p, m, mode, jc=None, tc=None):
    """JAX's tree and the port's module quantized alike: ``mode`` is
    'w8a16', 'w8a8' (linears) or either W8A8 with ' convs'."""
    qmode = "w8a16" if mode == "w8a16" else "w8a8"
    jp = jdq.quantize_linear_params(p, mode=qmode, act_scales=jc)
    tdq.quantize_linear_params(m, mode=qmode, act_scales=tc)
    if "convs" in mode:
        jp = jdq.quantize_conv_params(jp, act_scales=jc)
        tdq.quantize_conv_params(m, act_scales=tc)
    return jp


def _sites_match_jax(m, jp, params, writer, call):
    """Every quantized site of the port's module, on the activations it
    meets in ``call()``, against JAX's ``apply_linear`` / ``apply_conv``
    with JAX's quantized parameters: the routes and the epilogues, exactly
    as far as f32 goes."""
    from sfast_tpu.models import layers as jlayers

    names = {v: k for k, v in from_jax.module_names(params, writer).items()}
    seen, handles = {}, []

    def keep(name, mod, args, out):  # the first call of each site
        seen.setdefault(name, (args[0], out))

    for name, mod in m.named_modules():
        if getattr(mod, "w_q", None) is not None or getattr(mod, "w_q8", None) is not None:
            handles.append(mod.register_forward_hook(functools.partial(keep, name)))
    try:
        with torch.no_grad():
            call()
    finally:
        for h in handles:
            h.remove()
    tree = dict(_leaves(jp))
    for name, (x, y) in seen.items():
        path = names[name][:-1]
        site = {k[-1]: v for k, v in tree.items() if k[:-1] == path}
        mod = m.get_submodule(name)
        jx = jnp.asarray(x.numpy())
        if isinstance(mod, nn.Linear):
            ref = jlayers.apply_linear(site, jx)
        elif isinstance(mod, nn.Conv3d):
            ref = jsvd._conv_temporal2d(site, jx)
        else:
            ref = jlayers.apply_conv(site, jx, stride=mod.stride[0], padding=mod.padding[0])
        _close(y, ref, OP_TOL)
    return seen


def _a_scales_match_jax(m, jp, params, writer=from_jax.unet_state_dict, tol=0.0):
    """The port's static sites are those of JAX's quantized tree ``jp``,
    each holding JAX's ``a_scale`` within ``tol`` relative."""
    names = from_jax.module_names(params, writer)
    flat = dict(_leaves(jp))
    ref = {names[q]: float(flat[q[:-1] + ("a_scale",)]) for q in _jax_sites(jp, "a_scale")}
    ours = _port_sites(m, "a_scale")
    assert ref and sorted(ours) == sorted(ref)
    for name, mod in ours.items():
        assert abs(mod.a_scale.item() - ref[name]) <= tol * ref[name], \
            (name, mod.a_scale.item(), ref[name])


UNET_MODES = ["w8a16", "w8a8", "w8a8 convs", "static convs"]


@pytest.mark.parametrize("mode", UNET_MODES)
def test_quantized_unet_matches_jax(mode):
    """Site for site exact on the UNet's own activations; whole, within
    the module docstring's relative rms (1e-2, or 1e-1 with int8 convs)."""
    p = junet.init_unet_params(0, J_UNET64)
    m = UNet2DConditionModel(UNET64, **F32)
    m.load_state_dict(from_jax.unet_state_dict(p))
    inputs = _unet_inputs(7)
    jc = tc = None
    if mode.startswith("static"):
        jc = _jax_unet_cal(p, inputs)
        tc = from_jax.calibration_from_jax(jc, p)
    jp = _quantize_both(p, m, mode, jc, tc)
    if tc is not None:  # JAX's static sites and scales are the port's
        _a_scales_match_jax(m, jp, p)
        assert _port_sites(m, "w_q8").keys() - _port_sites(m, "a_scale").keys()  # GEGLU proj
    targs = [torch.from_numpy(a) for a in inputs]
    seen = _sites_match_jax(m, jp, p, from_jax.unet_state_dict, lambda: m(*targs))
    assert len(seen) == len(_port_sites(m, "w_q" if mode == "w8a16" else "w_q8"))
    ref = np.asarray(_jax_unet_fwd()(jp, *(jnp.asarray(a) for a in inputs)))
    with torch.no_grad():
        got = m(*targs)
    assert _rel_rms(got, ref) < (1e-1 if "convs" in mode else UNET_RMS)


def test_quantized_svd_unet_sites_match_jax():
    """The SVD UNet under W8A8 with convs, its temporal (3, 1, 1) convs
    on the int8 route, site for site on its own activations."""
    p = _svd_params()
    m = UNetSpatioTemporalConditionModel(TINY_SVD_UNET, **F32)
    m.load_state_dict(from_jax.svd_unet_state_dict(p))
    jp = _quantize_both(p, m, "w8a8 convs")
    rng = _rng(16)
    args = (torch.from_numpy(rng.standard_normal((2, 4, 16, 16, 8)).astype(np.float32)),
            torch.tensor([10.0, 700.0]),
            torch.from_numpy(rng.standard_normal((2, 1, 32)).astype(np.float32)),
            torch.tensor([[6.0, 127.0, 0.02]] * 2))
    seen = _sites_match_jax(m, jp, p, from_jax.svd_unet_state_dict, lambda: m(*args))
    assert any(k.endswith("temporal_res_block.conv2") for k in seen)


def _sd_draws(seed, n, shape):
    """JAX's calibration draws: one key split per timestep."""
    key, out = jax.random.key(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


# ---------------------------------------------------------------------------
# the compile layer and LoRA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_quantizing_a_compiled_pipeline_captures_anew(recorder, fused):  # noqa: F811
    """The quantization drops the UNet's graphs and the fused loops (they
    read the bf16 weights by address); the next image captures anew, is
    quantized (not the bf16 image) and equals the eager quantized image.
    Graphs of the slots it does not touch stay."""
    _, tpipe = tiny_pipes()
    tpipe.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
    rng = _rng(14)
    kw = dict(prompt_ids=rng.integers(0, 1000, (1, 77)).astype(np.int32),
              latents=torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32)),
              height=32, width=32, num_inference_steps=2, output_type="latent")
    base = tpipe(**kw).images
    captures = recorder.count("capture")
    assert (tpipe._fused_loops if fused else tpipe.unet.cache_size) and tpipe.vae.cache_size == 0
    te_graphs = tpipe.text_encoder.cache_size
    tdq.quantize_pipeline(tpipe, mode="w8a8", quantize_convs=True)
    assert tpipe.unet.cache_size == 0 and not tpipe._fused_loops
    assert tpipe.text_encoder.cache_size == te_graphs
    q = tpipe(**kw).images
    assert recorder.count("capture") > captures
    assert (q - base).abs().max() > 1e-4 * base.abs().max()
    tpipe.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    torch.testing.assert_close(tpipe(**kw).images, q, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_quantizing_a_shared_unet_drops_every_pipelines_graphs(monkeypatch, fused):
    """Two compiled pipelines over one UNet, one of them quantized: no graph
    of the other that reads the UNet (its slot's, its fused loop) and was
    captured before the quantization replays after it, since it would read
    the freed bf16 weights by address.  The other's next image captures
    anew, is quantized and equals its eager image; its text encoder's
    graph stays."""
    log = []

    def capture(self, leaves, spec):  # a graph that logs its capture's place at each replay
        log.append(("capture", self.name))
        graph, born = _RecordedGraph(self.fn, spec, []), len(log)
        run = graph.run
        graph.run = lambda leaves: log.append(("run", self.name, born)) or run(leaves)
        return graph

    monkeypatch.setattr(LazyCompiledFunction, "_capture", capture)
    monkeypatch.setattr(LazyCompiledFunction, "_uses_graph", staticmethod(lambda leaves: True))
    _, tpipe = tiny_pipes()
    unet, vae, te = (s.module for s in (tpipe.unet, tpipe.vae, tpipe.text_encoder))
    other = sfast_tpu_torch.compile(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), vae_encode=vae, device="cpu",
        dtype=torch.float32))
    for p in (tpipe, other):
        p.set_compilation_config(CompilationConfig(fuse_denoising_loop=fused))
    rng = _rng(17)
    kw = dict(prompt_ids=rng.integers(0, 1000, (1, 77)).astype(np.int32),
              latents=torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32)),
              height=32, width=32, num_inference_steps=2, output_type="latent")
    base = other(**kw).images
    tpipe(**kw)
    mark = len(log)
    tdq.quantize_pipeline(tpipe, mode="w8a8", quantize_convs=True)
    q = other(**kw).images
    after = log[mark:]
    reads_unet = ("unet", "denoise_loop")
    assert not [e for e in after if e[0] == "run" and e[1].startswith(reads_unet)
                and e[2] <= mark]
    assert [e for e in after if e[0] == "capture" and e[1].startswith(reads_unet)]
    assert ("capture", "text_encoder") not in after
    assert (q - base).abs().max() > 1e-4 * base.abs().max()
    other.set_compilation_config(CompilationConfig(enable_cuda_graph=False))
    torch.testing.assert_close(other(**kw).images, q, rtol=0, atol=0)


def test_ip_adapter_init_on_a_quantized_unet():
    """``init_ip_adapter_params`` reads a quantized ``to_k``'s widths, not
    its weight (None there): the same draws as on the bf16 UNet."""
    m = UNet2DConditionModel(UNET64, **F32)
    ref = ip_adapter.init_ip_adapter_params(torch.Generator().manual_seed(0), m)
    tdq.quantize_linear_params(m, mode="w8a8")
    assert m.get_submodule("down_blocks.0.attentions.0.transformer_blocks.0.attn2").to_k.weight \
        is None
    got = ip_adapter.init_ip_adapter_params(torch.Generator().manual_seed(0), m)
    for part in ref:
        assert ref[part].keys() == got[part].keys()
        for k, v in ref[part].items():
            torch.testing.assert_close(got[part][k], v, rtol=0, atol=0)


def test_switch_lora_on_a_quantized_site_raises():
    _, tpipe = tiny_pipes()
    state = {k: v.clone() for k, v in tpipe.unet.module.state_dict().items()}
    lo = lora.init_lora_params(torch.Generator().manual_seed(0), state, rank=2)
    tdq.quantize_pipeline(tpipe, mode="w8a16")
    with pytest.raises(ValueError, match="quantized"):
        lora.switch_lora(tpipe.unet, state, lo)


def test_calibration_records_nothing_outside_its_thread():
    m = UNet2DConditionModel(UNET64, **F32)
    x, t, ctx = (torch.from_numpy(a) for a in _unet_inputs(15))
    sink = {}
    handles = [mod.register_forward_pre_hook(functools.partial(tcal._record, n))
               for n, mod in tcal.calibration_sites(m)]
    try:
        with torch.no_grad():
            m(x, t, ctx)  # no sink in this thread: nothing recorded
        assert not sink
        with tcal._sink(sink), torch.no_grad():
            m(x, t, ctx)
    finally:
        for h in handles:
            h.remove()
    assert sink and all(v.dim() == 0 for v in sink.values())
    assert isinstance(dataclasses.replace(tcal.Calibration({}), amax={"a": 1.0}),
                      tcal.Calibration)
    assert all(isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d))
               for _, mod in tcal.calibration_sites(m))
