"""A request's prompt token ids, drawn from the seed, as the CLIP
tokenizers would give them."""

import numpy as np

from hb import inputs

BOS, EOS = 49406, 49407
SEQ = 77
PROMPT_TOKENS = (4, 60)  # the range of a prompt's length in tokens, BOS and EOS aside


def prompt_ids(seed: int, i: int, pad: int = EOS) -> np.ndarray:
    """(1, 77) int64 ids of request ``i``: BOS, a prompt of random tokens,
    EOS, then ``pad``."""
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.REQUESTS, i))
    n = int(rng.integers(PROMPT_TOKENS[0], PROMPT_TOKENS[1] + 1))
    ids = np.full((1, SEQ), pad, np.int64)
    ids[0, 0] = BOS
    ids[0, 1:1 + n] = rng.integers(1, BOS, n)
    ids[0, 1 + n] = EOS
    return ids


def empty_prompt_ids(pad: int = EOS) -> np.ndarray:
    """The tokenizer's ids of the empty prompt."""
    ids = np.full((1, SEQ), pad, np.int64)
    ids[0, 0], ids[0, 1] = BOS, EOS
    return ids


def ids_for_encoder_2(ids: np.ndarray) -> np.ndarray:
    """The second SDXL encoder's ids: its tokenizer pads with 0 ('!')
    after the first EOS."""
    out = ids.copy()
    for row in out:
        at = int(np.argmax(row == EOS))
        row[at + 1:] = 0
    return out
