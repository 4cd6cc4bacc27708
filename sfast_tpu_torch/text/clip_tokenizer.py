"""CLIP byte-level BPE tokenizer: prompt strings → token ids, with no
dependency beyond the standard library (and ``regex`` where present).

A copy of ``sfast_tpu/text/clip_tokenizer.py``, which is pure Python but
cannot be imported without JAX (importing ``sfast_tpu`` pulls JAX in).  It
is file-compatible with both public vocabulary formats: HuggingFace
``vocab.json`` + ``merges.txt`` (every SD checkpoint ships them under
``tokenizer/``) and OpenAI's ``bpe_simple_vocab_16e6.txt.gz``.  It
implements the byte→unicode table, merge ranks, CLIP's whitespace and
lowercase normalization, the ``<|startoftext|>`` / ``<|endoftext|>``
special tokens and padding to 77; ``return_tensors="pt"`` gives a torch
tensor where the JAX copy's caller makes a jnp array.

The 49,152-entry vocabulary is data the user supplies, found by
:func:`find_vocab_files` in (in order) an explicit path, the
``SFAST_TPU_CLIP_VOCAB`` environment variable (the JAX package's too), a
``sfast_tpu_torch/text/data/`` drop-in, or the local HuggingFace hub
cache.  ``tests/test_torch_tokenizer.py`` holds the ids against the JAX
copy and ``transformers.CLIPTokenizer`` on a vocabulary trained in the
test.
"""

from __future__ import annotations

import functools
import gzip

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["CLIPTokenizer", "find_vocab_files"]


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte→printable-unicode map (GPT-2/CLIP standard).

    Printable ASCII/latin bytes map to themselves; the rest are remapped
    to 256+ codepoints so every byte has a visible, json-safe character.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


# CJK codepoint ranges treated as standalone words (HF BasicTokenizer
# _is_chinese_char — the no-ftfy normalization path every SD install
# without ftfy uses, and therefore the ecosystem-default ids).
_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _basic_normalize(text: str) -> str:
    """Replicates ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize`` joined with spaces — the exact
    normalization transformers' CLIPTokenizer applies when ftfy is not
    installed: control-char removal, CJK char isolation, NFC, lowercase.
    """
    import unicodedata

    out = []
    for ch in text:
        cp = ord(ch)
        if cp in (0, 0xFFFD):
            continue
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C"):
            continue
        if ch == " " or cat == "Zs":
            out.append(" ")
        elif _is_cjk(cp):
            out.extend((" ", ch, " "))
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(t.lower() for t in text.split())


# CLIP's pre-tokenization pattern (case-insensitive): special tokens,
# common English contractions, letter runs, digit runs, other-symbol
# runs.  Unicode letter/number classes (\p{L}/\p{N}) need the `regex`
# module (a transformers dependency); degrade to
# an ASCII approximation if it is ever absent.
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


def _is_clip_vocab(vocab_path: str) -> bool:
    """Cheap validation that a discovered vocab.json is actually CLIP's:
    the hub cache holds vocab.json+merges.txt for MANY byte-level BPE
    models (GPT-2, RoBERTa, BART) whose ids would silently index past
    the 49,408-entry CLIP embedding table.  CLIP's vocab (and only
    CLIP-family vocabs among the common ones) contains the
    ``<|startoftext|>`` special token."""
    try:
        with open(vocab_path, encoding="utf-8", errors="ignore") as f:
            return '"<|startoftext|>"' in f.read()
    except OSError:
        return False


def _hf_hub_candidates() -> List[str]:
    """Tokenizer dirs inside the local HuggingFace hub cache
    (``models--*/snapshots/*/tokenizer``) — any machine that has ever
    downloaded an SD checkpoint has the CLIP vocab here.  CLIP-ViT text
    towers share one vocabulary, so any CLIP hit tokenizes identically
    (non-CLIP vocabs are rejected by ``_is_clip_vocab``); prefer
    stable-diffusion repos for determinism."""
    base = os.environ.get(
        "HF_HOME", os.path.join(os.path.expanduser("~"), ".cache", "huggingface")
    )
    hub = os.environ.get("HF_HUB_CACHE", os.path.join(base, "hub"))
    if not os.path.isdir(hub):
        return []
    out: List[str] = []
    for model in sorted(
        os.listdir(hub),
        key=lambda m: (0 if "stable-diffusion" in m else 1, m),
    ):
        snaps = os.path.join(hub, model, "snapshots")
        if not model.startswith("models--") or not os.path.isdir(snaps):
            continue
        for snap in sorted(os.listdir(snaps)):
            for sub in ("tokenizer", ""):
                d = os.path.join(snaps, snap, sub) if sub else os.path.join(snaps, snap)
                if os.path.isfile(os.path.join(d, "vocab.json")):
                    out.append(d)
    return out


def _match(c: str, validate: bool = False) -> Optional[Tuple[str, str]]:
    v = os.path.join(c, "vocab.json")
    m = os.path.join(c, "merges.txt")
    if os.path.isfile(v) and os.path.isfile(m):
        if validate and not _is_clip_vocab(v):
            return None
        return v, m
    g = c if c.endswith(".txt.gz") else os.path.join(c, "bpe_simple_vocab_16e6.txt.gz")
    if os.path.isfile(g):
        return g, g
    return None


def find_vocab_files(root: Optional[str] = None) -> Optional[Tuple[str, str]]:
    """Locate (vocab.json, merges.txt) under common layouts.

    Search order: ``root`` itself, ``root/tokenizer``, the
    ``SFAST_TPU_CLIP_VOCAB`` env var, the packaged
    ``sfast_tpu_torch/text/data`` drop-in directory, and finally any CLIP
    vocab in the local HuggingFace hub cache (validated — the hub holds
    vocab.json for many non-CLIP BPE models, which would tokenize to
    garbage ids).  Returns None when nothing is found (callers degrade
    to requiring pre-tokenized ids).
    """
    explicit: List[str] = []
    if root:
        explicit += [root, os.path.join(root, "tokenizer")]
    env = os.environ.get("SFAST_TPU_CLIP_VOCAB")
    if env:
        explicit += [env, os.path.join(env, "tokenizer")]
    explicit.append(os.path.join(os.path.dirname(__file__), "data"))
    for c in explicit:  # trusted locations: no content validation
        hit = _match(c)
        if hit:
            return hit
    # hub cache walked LAZILY (only when every explicit location missed)
    # and content-validated per candidate
    for c in _hf_hub_candidates():
        hit = _match(c, validate=True)
        if hit:
            return hit
    return None


class CLIPTokenizer:
    """Byte-level BPE tokenizer matching HF ``CLIPTokenizer`` semantics.

    Call interface mirrors the HF tokenizer exactly as the pipelines use
    it: returns an object
    with ``input_ids`` padded to ``max_length`` with the pad token
    (CLIP pads with ``<|endoftext|>``), BOS prepended, EOS appended,
    truncation to ``model_max_length``.
    """

    model_max_length = 77

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        *,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        pad_token: Optional[str] = None,
        model_max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        # CLIP pads with the EOS token (HF CLIPTokenizer.pad_token = eos);
        # SDXL's tokenizer_2 overrides pad_token to "!" (id 0) — pass
        # pad_token="!" to reproduce OpenCLIP padding.  transformers
        # registers a non-default pad token as an ADDED special token,
        # which splits out of content text before BPE ("hey!!!" →
        # [..hey.., 0, 0, 0], not [.., 0, 0, id("!</w>")]); _split_pad
        # replicates that so ids stay bit-exact to HF's tokenizer_2.
        self._split_pad: Optional[Tuple[str, int]] = None
        if pad_token is not None and pad_token not in (bos_token, eos_token):
            self.pad_token_id = self.encoder[pad_token]
            self._split_pad = (pad_token, self.pad_token_id)
        else:
            self.pad_token_id = self.eos_token_id
        self.model_max_length = model_max_length
        self._cache: Dict[str, str] = {
            bos_token: bos_token,
            eos_token: eos_token,
        }

    # -- constructors ---------------------------------------------------

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "CLIPTokenizer":
        if vocab_file.endswith(".txt.gz"):
            return cls._from_openai_gz(vocab_file, **kw)
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if (i == 0 and line.startswith("#version")) or not line:
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def _from_openai_gz(cls, path: str, **kw) -> "CLIPTokenizer":
        """OpenAI ``bpe_simple_vocab_16e6.txt.gz``: merge list only; the
        vocab is reconstructed the way open_clip does (bytes, bytes+</w>,
        merged tokens, specials) with 48894 merges."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # real file: 48894 merges after the header line (49152 vocab −
        # 512 byte symbols − 2 specials); tolerate shorter files (tests)
        merges = []
        for m in lines[1 : 49152 - 256 - 2 + 1]:
            parts = tuple(m.split())
            if len(parts) != 2:
                break
            merges.append(parts)
        chars = list(_bytes_to_unicode().values())
        vocab_list = chars + [c + "</w>" for c in chars]
        vocab_list += ["".join(m) for m in merges]
        vocab_list += ["<|startoftext|>", "<|endoftext|>"]
        vocab = {tok: i for i, tok in enumerate(vocab_list)}
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained(cls, root: Optional[str] = None, **kw) -> "CLIPTokenizer":
        found = find_vocab_files(root)
        if found is None:
            raise FileNotFoundError(
                "CLIP vocab files not found; pass a checkpoint dir with a "
                "tokenizer/ subfolder, set SFAST_TPU_CLIP_VOCAB, or drop "
                "vocab.json+merges.txt into sfast_tpu_torch/text/data/"
            )
        return cls.from_files(*found, **kw)

    # -- BPE ------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        # CLIP's word-end convention: last character carries </w>
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def with_pad_token(self, pad_token: str) -> "CLIPTokenizer":
        """Clone sharing vocab/merges but padding (and content-splitting)
        on ``pad_token`` — how SDXL's ``tokenizer_2`` relates to
        ``tokenizer`` (same files, different pad config)."""
        import copy

        clone = copy.copy(self)
        clone.pad_token_id = self.encoder[pad_token]
        clone._split_pad = (pad_token, clone.pad_token_id)
        clone._cache = dict(self._cache)
        return clone

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no specials appended; the added pad token, if
        configured, splits out of raw text first, matching transformers)."""
        split = getattr(self, "_split_pad", None)
        if split is not None:
            tok, tid = split
            ids: List[int] = []
            for i, part in enumerate(text.split(tok)):
                if i:
                    ids.append(tid)
                ids.extend(self._encode_chunk(part))
            return ids
        return self._encode_chunk(text)

    def _encode_chunk(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_normalize(text))
        for token in _PAT.findall(text):
            token_bytes = token.encode("utf-8")
            token = "".join(self.byte_encoder[b] for b in token_bytes)
            ids.extend(
                self.encoder[t] for t in self._bpe(token).split(" ")
            )
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(
            self.decoder.get(i, "") for i in ids
        )
        text = (
            bytearray(self.byte_decoder.get(c, 0) for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )
        for special in (self.bos_token, self.eos_token):
            text = text.replace(special, "")
        return text.strip()

    # -- HF-style call interface (what the pipelines use) ---------------

    class _Encoding:
        def __init__(self, input_ids):
            self.input_ids = input_ids

        def __getitem__(self, k):
            if k == "input_ids":
                return self.input_ids
            raise KeyError(k)

    def __call__(
        self,
        text,
        *,
        padding: str = "max_length",
        max_length: Optional[int] = None,
        truncation: bool = True,
        return_tensors: Optional[str] = None,
    ) -> "CLIPTokenizer._Encoding":
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        rows = []
        for t in text:
            ids = self.encode(t)
            if truncation and len(ids) > max_length - 2:
                ids = ids[: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding == "max_length" and len(row) < max_length:
                row = row + [self.pad_token_id] * (max_length - len(row))
            rows.append(row)
        if return_tensors == "np":
            import numpy as np

            return self._Encoding(np.asarray(rows, dtype=np.int32))
        if return_tensors == "pt":
            import torch

            return self._Encoding(torch.tensor(rows, dtype=torch.long))
        return self._Encoding(rows)
