"""Terminal image rendering (≙ the reference's ``utils/term_image/``).

A copy of ``sfast_tpu/utils/term_image.py``, which cannot be imported
without JAX: truecolor half-block characters (▀ with fg = top pixel, bg =
bottom pixel), two pixels per cell, for eyeballing generated images
without a display.  Takes a uint8 (H, W, 3) numpy array, a PIL image, or a
tensor (copied to the host).
"""

import sys

import numpy as np


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[ys][:, xs]


def image_to_ansi(img, max_width: int = 80) -> str:
    """uint8 (H, W, 3) image (or a batch of them: the first) → ANSI
    truecolor string."""
    if hasattr(img, "detach"):  # a torch tensor, maybe on the card
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    out_w = min(max_width, w)
    out_h = max(2, int(h * out_w / w)) & ~1  # even rows for half blocks
    small = _resize_nearest(arr, out_w, out_h)

    lines = []
    for y in range(0, out_h, 2):
        row = []
        for x in range(out_w):
            rt, gt, bt = small[y, x][:3]
            rb, gb, bb = small[y + 1, x][:3]
            row.append(f"\x1b[38;2;{rt};{gt};{bt}m\x1b[48;2;{rb};{gb};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def print_image(img, max_width: int = 80, file=None) -> None:
    print(image_to_ansi(img, max_width), file=file or sys.stdout)
