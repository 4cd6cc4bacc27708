"""The port's CLIP tokenizer against sfast_tpu's and ``transformers``' (CPU),
and prompt strings through the port's pipeline against the JAX pipeline.

The vocabulary is trained in the test, as ``tests/text/test_clip_tokenizer.py``
does (the 49k learned vocabulary is user data): both HuggingFace files and
OpenAI's ``.gz`` format.  Ids must be equal exactly.
"""

import gzip
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from sfast_tpu.text import clip_tokenizer as jtok
from sfast_tpu_torch.text import clip_tokenizer as ttok
from tests.test_torch_pipeline import tiny_pipes
from tests.text.test_clip_tokenizer import PROMPTS, _train_bpe

MAX_LEN = 77


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_vocab_torch")
    merges = _train_bpe(PROMPTS + ["a photo of a cat", "the quick brown fox"], 64)
    chars = list(ttok._bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(d / "vocab.json", "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f, ensure_ascii=False)
    with open(d / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return str(d)


def _files(d):
    return os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")


def test_byte_table_matches_jax():
    assert ttok._bytes_to_unicode() == jtok._bytes_to_unicode()


@pytest.mark.parametrize("pad_token", [None, "!"], ids=["pad-eos", "pad-bang"])
def test_ids_match_jax_and_transformers(vocab_dir, pad_token):
    """Every prompt, padded to 77: equal to the JAX copy and to
    transformers (``pad_token="!"`` is SDXL's ``tokenizer_2``, whose pad
    token also splits out of the text)."""
    kw = {} if pad_token is None else {"pad_token": pad_token}
    ours = ttok.CLIPTokenizer.from_files(*_files(vocab_dir), **kw)
    theirs = jtok.CLIPTokenizer.from_files(*_files(vocab_dir), **kw)
    hf = transformers.CLIPTokenizer.from_pretrained(vocab_dir, **kw)
    for p in PROMPTS + ["caps AND puncts!!!", "word " * 100]:
        ids = ours(p, max_length=MAX_LEN)["input_ids"][0]
        assert ids == theirs(p, max_length=MAX_LEN)["input_ids"][0], p
        assert ids == hf(p, padding="max_length", max_length=MAX_LEN,
                         truncation=True)["input_ids"], p
    if pad_token is not None:
        clone = ttok.CLIPTokenizer.from_files(*_files(vocab_dir)).with_pad_token(pad_token)
        assert clone("hey!!! you")["input_ids"] == ours("hey!!! you")["input_ids"]


def test_truncation_and_tensors(vocab_dir):
    tok = ttok.CLIPTokenizer.from_files(*_files(vocab_dir))
    enc = tok(["word " * 500, ""], return_tensors="pt")
    ids = enc["input_ids"]
    assert ids.dtype == torch.long and ids.shape == (2, MAX_LEN)
    assert ids[0, -1] == tok.eos_token_id  # content cut to 75, EOS last
    assert ids[1, :2].tolist() == [tok.bos_token_id, tok.eos_token_id]
    assert (ids[1, 2:] == tok.pad_token_id).all()
    np.testing.assert_array_equal(
        ids.numpy(), jtok.CLIPTokenizer.from_files(*_files(vocab_dir))(
            ["word " * 500, ""], return_tensors="np")["input_ids"])
    text = "a photo of an astronaut"
    assert tok.decode(tok.encode(text)) == text


def test_openai_gz_format(vocab_dir, tmp_path):
    with open(_files(vocab_dir)[1], encoding="utf-8") as f:
        lines = f.read().splitlines()[1:]
    gz = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("header line\n" + "\n".join(lines) + "\n")
    ours = ttok.CLIPTokenizer.from_files(str(gz), str(gz))
    theirs = jtok.CLIPTokenizer.from_files(str(gz), str(gz))
    for p in PROMPTS:
        assert ours.encode(p) == theirs.encode(p) == \
            ttok.CLIPTokenizer.from_files(*_files(vocab_dir)).encode(p)


def test_find_vocab_files_matches_jax(vocab_dir, tmp_path, monkeypatch):
    """Checkpoint layout, the environment variable and the hub cache give
    the JAX copy's answer; a non-CLIP vocabulary in the hub is refused."""
    ckpt = tmp_path / "ckpt" / "tokenizer"
    ckpt.mkdir(parents=True)
    for f in _files(vocab_dir):
        shutil.copy(f, ckpt)
    monkeypatch.delenv("SFAST_TPU_CLIP_VOCAB", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    assert ttok.find_vocab_files(str(ckpt.parent)) == jtok.find_vocab_files(str(ckpt.parent))
    assert ttok.find_vocab_files(None) is None
    monkeypatch.setenv("SFAST_TPU_CLIP_VOCAB", str(ckpt.parent))
    assert ttok.find_vocab_files(None) == jtok.find_vocab_files(None) is not None
    monkeypatch.delenv("SFAST_TPU_CLIP_VOCAB")
    snap = tmp_path / "hf" / "hub" / "models--sd" / "snapshots" / "r1" / "tokenizer"
    snap.mkdir(parents=True)
    for f in _files(vocab_dir):
        shutil.copy(f, snap)
    found = ttok.find_vocab_files(None)
    assert found == jtok.find_vocab_files(None) and "snapshots" in found[0]
    gpt = tmp_path / "hf" / "hub" / "models--gpt2" / "snapshots" / "r1"
    gpt.mkdir(parents=True)
    (gpt / "vocab.json").write_text(json.dumps({"a": 0, "b": 1}))
    (gpt / "merges.txt").write_text("#version: 0.2\na b\n")
    shutil.rmtree(tmp_path / "hf" / "hub" / "models--sd")
    assert ttok.find_vocab_files(None) is None


def test_string_prompt_pipeline_matches_jax(vocab_dir):
    """``pipe("…")`` with each package's tokenizer attached: the prompt's
    ids and the empty prompt's (CFG's uncond) come from the tokenizer."""
    jpipe, tpipe = tiny_pipes((jtok.CLIPTokenizer.from_files(*_files(vocab_dir)),
                               ttok.CLIPTokenizer.from_files(*_files(vocab_dir))))
    lat = np.random.default_rng(0).standard_normal((1, 16, 16, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_inference_steps=3, guidance_scale=7.5,
              output_type="latent")
    prompt = "a photo of a cat"
    jlat = np.asarray(jpipe(prompt, latents=jnp.asarray(lat), **kw).images)
    tlat = tpipe(prompt, latents=torch.from_numpy(lat), **kw).images
    np.testing.assert_allclose(tlat.numpy(), jlat, rtol=0, atol=2e-3 * np.abs(jlat).max())
    ids = tpipe.tokenize(prompt)
    assert ids.tolist() == np.asarray(jpipe.tokenize(prompt)).tolist()
    torch.testing.assert_close(tpipe._empty_prompt_ids(ids), tpipe.tokenize([""]))
    by_ids = tpipe(prompt_ids=ids, latents=torch.from_numpy(lat), **kw).images
    torch.testing.assert_close(by_ids, tlat, rtol=0, atol=0)


def test_string_prompt_without_a_vocabulary_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("SFAST_TPU_CLIP_VOCAB", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    _, tpipe = tiny_pipes()
    with pytest.raises(ValueError, match="no tokenizer attached"):
        tpipe("a prompt", height=32, width=32, num_inference_steps=1)
