"""Install the CLIP tokenizer vocabulary into ``sfast_tpu_torch/text/data/``.

Counterpart of ``sfast_tpu/text/fetch_vocab.py:44-116``.  The 49k-entry
BPE vocabulary is data, not code: the port ships the tokenizer's algorithm
(``clip_tokenizer.py``) and this command puts a vocabulary where
``find_vocab_files`` looks first among the packaged locations, so that
``pipe("a prompt")`` works after one explicit step:

    python -m sfast_tpu_torch.text.fetch_vocab                      # auto-discover
    python -m sfast_tpu_torch.text.fetch_vocab --from /path/to/ckpt # checkpoint dir
    python -m sfast_tpu_torch.text.fetch_vocab --from openai/clip-vit-large-patch14
                                                                    # HF hub download

Sources, in order:

1. ``--from <dir>``: a checkpoint dir (``<dir>/tokenizer/vocab.json``) or
   any dir holding ``vocab.json`` + ``merges.txt`` or OpenAI's
   ``bpe_simple_vocab_16e6.txt.gz``;
2. auto-discovery (``find_vocab_files``): ``SFAST_TPU_CLIP_VOCAB``, the
   drop-in directory, the local HuggingFace hub cache (content-validated);
3. ``--from <repo-id>``: downloaded with ``huggingface_hub`` where the
   package and a network are there.

The files are validated (loaded, and a probe prompt encoded to 77 ids)
before they are copied.
"""

import argparse
import os
import shutil
import sys

from sfast_tpu_torch.text.clip_tokenizer import (
    CLIPTokenizer,
    _is_clip_vocab,
    find_vocab_files,
)

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PROBE = "a photo of a cat"


def _download_from_hub(repo_id: str):
    """(vocab.json, merges.txt) of ``repo_id`` from the HuggingFace hub
    (its ``tokenizer/`` folder, else its root), or None."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        print("huggingface_hub is not installed; pass --from <local dir> "
              "or set SFAST_TPU_CLIP_VOCAB", file=sys.stderr)
        return None
    for sub in ("tokenizer/", ""):
        try:
            return tuple(hf_hub_download(repo_id, sub + name)
                         for name in ("vocab.json", "merges.txt"))
        except Exception:  # the hub raises many kinds: try the next layout
            continue
    print(f"could not download vocab files from {repo_id!r}", file=sys.stderr)
    return None


def install(source=None, data_dir: str = DATA_DIR) -> str:
    """Locate the vocabulary (see the module's docstring), validate it and
    copy it into ``data_dir``.  Returns ``data_dir``; raises
    ``FileNotFoundError`` where nothing is found and ``ValueError`` where
    what was found is not a CLIP vocabulary."""
    found = None
    if source and os.path.isdir(source):
        found = find_vocab_files(source)
        if found is None:
            raise FileNotFoundError(f"no vocab files under {source!r}")
    if found is None:
        found = find_vocab_files(None)
    if found is None and source:
        found = _download_from_hub(source)
    if found is None:
        raise FileNotFoundError(
            "no CLIP vocab found: pass --from <checkpoint dir or HF repo id>, "
            "or set SFAST_TPU_CLIP_VOCAB")
    vocab_file, merges_file = found
    if not vocab_file.endswith(".txt.gz") and not _is_clip_vocab(vocab_file):
        raise ValueError(f"{vocab_file!r} does not look like a CLIP vocab")
    tok = CLIPTokenizer.from_files(vocab_file, merges_file)
    probe = tok(PROBE, return_tensors="pt").input_ids
    if tuple(probe.shape) != (1, 77):
        raise ValueError(f"the vocab encodes {PROBE!r} to shape {tuple(probe.shape)}")
    os.makedirs(data_dir, exist_ok=True)
    if vocab_file.endswith(".txt.gz"):
        shutil.copy(vocab_file, os.path.join(data_dir, os.path.basename(vocab_file)))
    else:
        shutil.copy(vocab_file, os.path.join(data_dir, "vocab.json"))
        shutil.copy(merges_file, os.path.join(data_dir, "merges.txt"))
    return data_dir


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="install CLIP vocab files into sfast_tpu_torch/text/data/")
    ap.add_argument("--from", dest="source", default=None,
                    help="checkpoint dir, vocab dir, or HF hub repo id")
    ap.add_argument("--out", dest="out", default=DATA_DIR)
    args = ap.parse_args(argv)
    d = install(args.source, args.out)
    print(f"installed CLIP vocab into {d}")
    print("pipe('a prompt') now tokenizes without an explicit tokenizer.")


if __name__ == "__main__":
    main()
