"""Inputs from the seed: sub-seeds, prompt token ids, a request's image
seed, and the batches of the train step.

Request ``i`` of a run is made from ``(seed, i)`` alone, so the reference
makes the same inputs again after the window, however many requests the
window held.  Every request has the same shapes; only the values differ.
"""

import numpy as np
import torch

BOS, EOS = 49406, 49407
SEQ = 77
PROMPT_TOKENS = (4, 60)  # the range of a prompt's length in tokens, BOS and EOS aside


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream named by ``path`` under ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, *(p % 2**64 for p in path)]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# the streams drawn from a run's seed
WEIGHTS, PROMPTS, IMAGE_SEEDS, LORA_INIT, TRAIN_DATA, CHECK_SAMPLE = range(6)


def prompt_ids(seed: int, i: int, pad: int = EOS) -> np.ndarray:
    """(1, 77) int64 ids of request ``i``: BOS, a prompt of random tokens,
    EOS, then ``pad``."""
    rng = np.random.default_rng(sub_seed(seed, PROMPTS, i))
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


def image_seed(seed: int, i: int) -> int:
    """The seed request ``i`` hands the pipeline for its initial latents."""
    return sub_seed(seed, IMAGE_SEEDS, i)


def check_sample(seed: int, n_done: int, k: int) -> list:
    """``k`` of the ``n_done`` finished requests, drawn from the seed, in
    order."""
    if n_done <= k:
        return list(range(n_done))
    rng = np.random.default_rng(sub_seed(seed, CHECK_SAMPLE))
    return sorted(int(i) for i in rng.choice(n_done, size=k, replace=False))


def train_pool(seed: int, steps: int, batch: int, hw: int, channels: int, ctx_len: int,
               ctx_dim: int, device, dtype) -> dict:
    """``steps`` batches of the train step, every row its own: clean
    latents (steps, B, hw, hw, C) and text embeddings (steps, B, S, D) in
    ``dtype``, timesteps (steps, B) and noise (steps, B, hw, hw, C) in
    float32, drawn on ``device`` in four calls."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, TRAIN_DATA))
    lat = torch.randn((steps, batch, hw, hw, channels), generator=gen, device=device)
    ctx = torch.randn((steps, batch, ctx_len, ctx_dim), generator=gen, device=device)
    t = torch.randint(0, 1000, (steps, batch), generator=gen, device=device)
    noise = torch.randn((steps, batch, hw, hw, channels), generator=gen, device=device)
    return {"latents": lat.to(dtype), "context": ctx.to(dtype), "t": t, "noise": noise}
