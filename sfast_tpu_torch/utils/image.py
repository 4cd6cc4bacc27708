"""Image pre- and postprocessing: counterpart of ``sfast_tpu/utils/image.py``
(``:25-119``, ``to_pil`` and ``denormalize_to_uint8``), with the bilinear resize and the
CLIP normalization of the SVD pipeline
(``sfast_tpu/pipelines/stable_video_diffusion.py:35-41,160-172``)."""

import numpy as np
import torch

from sfast_tpu_torch.profile import spans

# CLIP's image normalization (OpenAI's mean and std, which OpenCLIP's
# ViT-H keeps)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) f32 weights of ``jax.image.resize``'s 'bilinear' along
    one axis (``scale_and_translate``'s ``compute_weight_mat``): half-pixel
    centres; a triangle kernel widened by n_in / n_out when downsampling
    (antialiasing), not when upsampling; each output's weights normalized
    to sum 1 over the input pixels (so an edge renormalizes); outputs whose
    centre falls outside the input are 0."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float32, device=device)[None, :])
    w = torch.clamp(1.0 - x.abs() / kernel_scale, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) f32 → (B, h, w, C) as ``jax.image.resize(img, (B, h, w,
    C), "bilinear")``: antialiased when it downsamples (576×1024 → 224² for
    the image encoder), which ``F.interpolate(antialias=False)`` is not.
    An axis of unchanged size is left as it is, as JAX skips it."""
    out = img.float()
    if out.shape[1] != h:
        out = torch.einsum("oh,bhwc->bowc", _resize_weights(out.shape[1], h, out.device), out)
    if out.shape[2] != w:
        out = torch.einsum("ow,bhwc->bhoc", _resize_weights(out.shape[2], w, out.device), out)
    return out


def clip_normalize(pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → CLIP-normalized, (x − mean) / std per channel."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=pixels.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=pixels.device)
    return (pixels.float() - mean) / std


def denormalize_to_uint8(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] → uint8, on the image's device."""
    img = torch.clamp(image.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)


def to_pil(image) -> list:
    """uint8 (B, H, W, 3) images, a tensor on any device or an array → a
    list of PIL images (``sfast_tpu/utils/image.py:25-32``); Pillow is
    imported here, and only here."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("Pillow is required for PIL output") from e
    if isinstance(image, torch.Tensor):
        with spans.wait():
            image = image.cpu()
        image = image.numpy()
    return [Image.fromarray(a) for a in np.asarray(image)]


def preprocess_image(img, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """PIL image, list of them, or uint8 / float array (B, H, W, 3) or
    (H, W, 3) → (B, H, W, 3) in [-1, 1] (uint8 scaled, floats as given)."""
    if isinstance(img, (list, tuple)):
        img = np.stack([np.asarray(i) for i in img])
    else:
        img = np.asarray(img)
        if img.ndim == 3:
            img = img[None]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 127.5 - 1.0
    return torch.as_tensor(img).to(device=device, dtype=dtype)


def preprocess_control_image(img, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """A ControlNet's control image → (B, H, W, C) in [0, 1] on ``device``
    (diffusers' convention; the VAE's inputs are [-1, 1] instead).  Takes
    PIL, a list of them, or a uint8 / float array or tensor, (B, H, W, C)
    or (H, W, C).  A uint8 image crosses to the device raw and is divided
    by 255 there in f32, then cast; a float image passes as it is (JAX
    ``utils/image.py:35-66``)."""
    if isinstance(img, torch.Tensor):
        t = img
    elif isinstance(img, (list, tuple)):
        t = torch.from_numpy(np.stack([np.asarray(i) for i in img]))
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(img)))
    if t.dim() == 3:
        t = t[None]
    t = t.to(device)
    if t.dtype == torch.uint8:
        t = t.float() / 255.0
    return t.to(dtype)


def preprocess_mask_image(mask, lh: int, lw: int, device=None) -> torch.Tensor:
    """Inpainting mask → keep-mask at latent resolution, (B, lh, lw, 1) f32.

    diffusers' convention: white is repaint, black is keep.  Takes PIL,
    (H, W), (H, W, C) or (B, H, W[, C]) uint8 or float arrays; any channel
    marked counts as repaint, and an RGBA mask's alpha is dropped first
    (it is opacity: an opaque mask would otherwise repaint everything).
    Nearest-sampled down to the latent grid, binarized at 0.5, then
    inverted, so that 1 keeps the original, as the pipeline's blend reads
    it."""
    arr = np.asarray(mask)
    if arr.ndim == 2:
        arr = arr[None, :, :, None]
    elif arr.ndim == 3:
        arr = arr[None] if arr.shape[-1] in (1, 3, 4) else arr[..., None]
    arr = arr.astype(np.float32) / 255.0 if arr.dtype == np.uint8 else arr.astype(np.float32)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    arr = arr.max(axis=-1, keepdims=True)
    _, h, w, _ = arr.shape
    ys = (np.arange(lh) * h) // lh
    xs = (np.arange(lw) * w) // lw
    inpaint = (arr[:, ys][:, :, xs] >= 0.5).astype(np.float32)
    return torch.from_numpy(1.0 - inpaint).to(device)
