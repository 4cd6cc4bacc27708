"""Prompt text → token ids: the CLIP BPE tokenizer."""

from sfast_tpu_torch.text.clip_tokenizer import CLIPTokenizer, find_vocab_files

__all__ = ["CLIPTokenizer", "find_vocab_files"]
