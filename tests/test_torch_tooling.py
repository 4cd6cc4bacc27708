"""The port's tooling against sfast_tpu's (CPU): profiling, checkpoints,
op counts and graphs, the terminal renderer and the vocabulary installer.

Checkpoints are exact: a file written by either package loads in the other
bit for bit, bf16 included.  The ANSI string of an image is equal to JAX's
for the same array.  ``fetch_vocab`` installs from a checkpoint directory
holding a byte-level CLIP vocabulary written in the test; its hub branch
meets a fake ``huggingface_hub``, so nothing is fetched.
"""

import dataclasses
import json
import os
import sys
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sfast_tpu_torch
from sfast_tpu.text import fetch_vocab as jax_fetch_vocab
from sfast_tpu.utils import checkpoint as jax_checkpoint
from sfast_tpu.utils.term_image import image_to_ansi as jax_image_to_ansi
from sfast_tpu_torch.models import (
    TINY_TEST_VAE,
    TINY_TEXT_ENCODER,
    TINY_UNET,
    AutoencoderKL,
    CLIPTextModel,
    UNet2DConditionModel,
    init_weights_,
)
from sfast_tpu_torch.pipelines import StableDiffusionPipeline
from sfast_tpu_torch.profile import AutoProfiler, IterationProfiler, trace, with_cProfile
from sfast_tpu_torch.runtime import cuda_build
from sfast_tpu_torch.schedulers import DPMSolverMultistepScheduler
from sfast_tpu_torch.text import fetch_vocab
from sfast_tpu_torch.text.clip_tokenizer import CLIPTokenizer, _bytes_to_unicode
from sfast_tpu_torch.utils import checkpoint, debug, term_image
from tests.test_torch_svd import _one_torch_thread  # noqa: F401  (an autouse fixture)

STEPS = 3

# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------


def test_auto_profiler_times_the_block():
    said = []
    x = torch.randn(64, 64)
    with AutoProfiler("matmul", echo=said.append) as p:
        y = p.track(x @ x)
        p.track({"nested": [y, None, 3]})
    assert y.shape == (64, 64)
    assert p.elapsed is not None and p.elapsed >= 0
    assert said == [f"[sfast_tpu_torch] matmul: {p.elapsed * 1e3:.1f} ms"]


@pytest.fixture(scope="module")
def tiny_pipe():
    """The port's tiny SD pipeline (UNet at cross-attention width 64) with
    seeded random weights on the CPU."""
    f32 = dict(device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(TINY_UNET, cross_attention_dim=64)
    unet = init_weights_(UNet2DConditionModel(cfg, **f32), g)
    vae = init_weights_(AutoencoderKL(TINY_TEST_VAE, **f32), g)
    te = init_weights_(CLIPTextModel(TINY_TEXT_ENCODER, **f32), g)
    return sfast_tpu_torch.compile(StableDiffusionPipeline(
        unet, vae, te, DPMSolverMultistepScheduler(), device="cpu", dtype=torch.float32))


def test_iteration_profiler_as_a_step_callback(tiny_pipe):
    prof = IterationProfiler()
    assert prof.iterations_per_second is None and prof.summary() == "n/a"
    ids = np.random.default_rng(0).integers(0, 1000, (1, 77)).astype(np.int32)
    out = tiny_pipe(prompt_ids=ids, height=32, width=32, num_inference_steps=STEPS,
                    guidance_scale=7.5, output_type="latent", callback_on_step_end=prof)
    assert out.images.shape == (1, 16, 16, 4)
    assert len(prof.times) == STEPS - 1 and all(t >= 0 for t in prof.times)
    assert prof.iterations_per_second > 0
    assert prof.summary().endswith(" it/s")


def test_with_cprofile_reports_and_returns():
    said = []

    @with_cProfile(top=5, echo=said.append)
    def work(n):
        return sum(i * i for i in range(n))

    assert work(1000) == sum(i * i for i in range(1000))
    assert len(said) == 1 and "work" in said[0] and "function calls" in said[0]
    assert with_cProfile(echo=said.append)(len)([1, 2]) == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with trace(str(tmp_path / "prof")) as prof:
        torch.mm(x, x)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(row.key == "aten::mm" for row in prof.key_averages())


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _bits(a):
    """An array's bytes with its dtype name, for bit-for-bit comparison."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return "bfloat16", a.view(torch.int16).numpy().tobytes()
        return str(a.dtype).replace("torch.", ""), a.numpy().tobytes()
    a = np.asarray(a)
    return str(a.dtype), a.tobytes()


def test_a_jax_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "conv_in": {"w": jnp.asarray(rng.standard_normal((3, 3, 4, 8)), jnp.bfloat16),
                    "b": jnp.asarray(rng.standard_normal(8), jnp.float32)},
        "blocks": [{"scale": jnp.asarray(rng.standard_normal(5), jnp.float16)},
                   {"ids": jnp.arange(7, dtype=jnp.int32)}],
    }
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_params(path, tree)
    got = checkpoint.load_params(path, device="cpu")
    assert sorted(got) == ["blocks/[0]/scale", "blocks/[1]/ids", "conv_in/b", "conv_in/w"]
    assert got["conv_in/w"].dtype == torch.bfloat16
    assert _bits(got["conv_in/w"]) == _bits(tree["conv_in"]["w"])
    assert _bits(got["conv_in/b"]) == _bits(tree["conv_in"]["b"])
    assert _bits(got["blocks/[0]/scale"]) == _bits(tree["blocks"][0]["scale"])
    assert _bits(got["blocks/[1]/ids"]) == _bits(tree["blocks"][1]["ids"])
    nested = checkpoint.nest(got)
    assert isinstance(nested["blocks"], list) and len(nested["blocks"]) == 2
    assert torch.equal(nested["conv_in"]["w"], got["conv_in/w"])


def test_a_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {
        "conv_in.weight": torch.randn(8, 4, 3, 3, generator=g).to(torch.bfloat16),
        "conv_in.bias": torch.randn(8, generator=g),
        "norm.weight": torch.randn(5, generator=g).to(torch.float16),
        "step": torch.tensor(3, dtype=torch.int64),
    }
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, state)
    got = jax_checkpoint.load_params(path, device_put=False)
    assert sorted(got) == sorted(state)
    assert got["conv_in.weight"].dtype == ml_dtypes.bfloat16
    for k, v in state.items():
        assert _bits(got[k]) == _bits(v), k
    back = checkpoint.load_params(path, device="cpu")
    assert all(_bits(back[k]) == _bits(v) for k, v in state.items())


def test_a_trained_lora_round_trips(tmp_path):
    g = torch.Generator().manual_seed(0)
    lora = {"down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q":
            {"a": torch.randn(32, 2, generator=g), "b": torch.randn(2, 32, generator=g)},
            "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0":
            {"a": torch.randn(64, 2, generator=g), "b": torch.randn(2, 64, generator=g)}}
    path = str(tmp_path / "lora.npz")
    checkpoint.save_params(path, lora)
    back = checkpoint.nest(checkpoint.load_params(path, device="cpu"))
    assert back.keys() == lora.keys()
    assert all(torch.equal(back[m][k], f[k]) for m, f in lora.items() for k in ("a", "b"))


def test_device_memory_stats_needs_a_card(monkeypatch):
    with pytest.raises(ValueError, match="not a CUDA device"):
        checkpoint.device_memory_stats("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.device_memory_stats()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_params("unused.npz")


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------


def _tiny_fn(x, w):
    return torch.relu(x @ w) + 1.0


def test_count_ops_counts_aten_ops_and_kernel_launches():
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    counts = debug.count_ops(_tiny_fn, x, w)
    assert counts == {"aten.mm": 1, "aten.relu": 1, "aten.add": 1}

    def with_a_launch(x):
        cuda_build.count_launch("flash_attention")  # what a wrapper counts where it launches
        return x * 2

    assert debug.count_ops(with_a_launch, x) == {"aten.mul": 1, "flash_attention": 1}


def test_print_graph_prints_the_aten_graph():
    said = []
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    gm = debug.print_graph(_tiny_fn, x, w, echo=said.append)
    assert len(said) == 1
    assert all(op in said[0] for op in ("aten.mm", "aten.relu", "aten.add"))
    torch.testing.assert_close(gm(x, w), _tiny_fn(x, w), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# term_image
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype,width", [((37, 53, 3), np.uint8, 80),
                                               ((1, 64, 200, 3), np.uint8, 40),
                                               ((20, 30, 4), np.float32, 80)])
def test_ansi_string_equals_jax(shape, dtype, width):
    rng = np.random.default_rng(0)
    img = (rng.random(shape) * 300 - 20).astype(dtype) if dtype == np.float32 else \
        rng.integers(0, 256, shape).astype(dtype)
    ref = jax_image_to_ansi(img, width)
    assert term_image.image_to_ansi(img, width) == ref
    assert term_image.image_to_ansi(torch.from_numpy(img), width) == ref


# ---------------------------------------------------------------------------
# fetch_vocab
# ---------------------------------------------------------------------------


def _byte_level_vocab(root):
    """A CLIP vocabulary with no merges: the 256 byte tokens, their
    word-final forms, BOS and EOS."""
    os.makedirs(root, exist_ok=True)
    chars = list(_bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


@pytest.fixture
def no_vocab_anywhere(tmp_path, monkeypatch):
    """No vocabulary for auto-discovery, and a ``huggingface_hub`` whose
    downloads fail: nothing is fetched."""
    monkeypatch.delenv("SFAST_TPU_CLIP_VOCAB", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    calls = []

    def hf_hub_download(repo_id, filename):
        calls.append((repo_id, filename))
        raise OSError("offline")

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))
    return calls


def test_install_from_a_checkpoint_dir(tmp_path, no_vocab_anywhere):
    _byte_level_vocab(str(tmp_path / "ckpt" / "tokenizer"))
    out = fetch_vocab.install(str(tmp_path / "ckpt"), str(tmp_path / "data"))
    assert out == str(tmp_path / "data")
    tok = CLIPTokenizer.from_pretrained(out)
    assert tok(fetch_vocab.PROBE, return_tensors="pt").input_ids.shape == (1, 77)
    jax_fetch_vocab.install(str(tmp_path / "ckpt"), str(tmp_path / "jax_data"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "data" / name).read_bytes() == \
            (tmp_path / "jax_data" / name).read_bytes()
    assert not no_vocab_anywhere


def test_install_from_a_missing_source_raises(tmp_path, no_vocab_anywhere):
    with pytest.raises(FileNotFoundError, match="no vocab files under"):
        fetch_vocab.install(str(tmp_path), str(tmp_path / "data"))
    with pytest.raises(FileNotFoundError, match="no CLIP vocab found"):
        fetch_vocab.install(None, str(tmp_path / "data"))
    with pytest.raises(FileNotFoundError, match="no CLIP vocab found"):
        fetch_vocab.install("org/missing-model", str(tmp_path / "data"))
    assert no_vocab_anywhere == [("org/missing-model", "tokenizer/vocab.json"),
                                 ("org/missing-model", "vocab.json")]
    assert not (tmp_path / "data").exists()


def test_install_refuses_a_vocab_that_is_not_clip(tmp_path, no_vocab_anywhere):
    d = tmp_path / "gpt2"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps({"a": 0, "b": 1}))
    (d / "merges.txt").write_text("#version: 0.2\na b\n")
    with pytest.raises(ValueError, match="does not look like a CLIP vocab"):
        fetch_vocab.install(str(d), str(tmp_path / "data"))


def test_the_cli(tmp_path, no_vocab_anywhere, capsys):
    _byte_level_vocab(str(tmp_path / "vocab"))
    fetch_vocab.main(["--from", str(tmp_path / "vocab"), "--out", str(tmp_path / "data")])
    assert f"installed CLIP vocab into {tmp_path / 'data'}" in capsys.readouterr().out
    assert (tmp_path / "data" / "vocab.json").exists()


def test_the_hub_branch_faked(tmp_path, no_vocab_anywhere, monkeypatch):
    """A repo id goes to ``huggingface_hub.hf_hub_download`` (faked here:
    the files come from a local directory) after auto-discovery finds
    nothing; its ``tokenizer/`` folder first."""
    src = tmp_path / "hub_files"
    _byte_level_vocab(str(src))
    asked = []

    def hf_hub_download(repo_id, filename):
        asked.append((repo_id, filename))
        return str(src / os.path.basename(filename))

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))
    fetch_vocab.install("openai/clip-vit-large-patch14", str(tmp_path / "data"))
    assert asked == [("openai/clip-vit-large-patch14", "tokenizer/vocab.json"),
                     ("openai/clip-vit-large-patch14", "tokenizer/merges.txt")]
    assert (tmp_path / "data" / "merges.txt").read_bytes() == (src / "merges.txt").read_bytes()
