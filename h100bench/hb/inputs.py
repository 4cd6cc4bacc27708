"""Inputs from the seed: sub-seeds, a request's image seed, and the sample
of requests the check takes.

Request ``i`` of a run is made from ``(seed, i)`` alone, so the reference
makes the same inputs again after the window, however many requests the
window held.  What a request holds (prompt ids, an image) is its family's
(``families/<family>.py``), drawn from the stream :data:`REQUESTS`; every
request of a cell has the same shapes, only the values differ.
"""

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream named by ``path`` under ``seed``."""
    return int(np.random.SeedSequence([seed % 2**64, *(p % 2**64 for p in path)]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# the streams drawn from a run's seed
WEIGHTS, REQUESTS, IMAGE_SEEDS, LORA_INIT, TRAIN_DATA, CHECK_SAMPLE = range(6)


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
