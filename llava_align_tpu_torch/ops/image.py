"""CLIP image preprocessing (torch twin of llava_align_tpu/ops/image.py).

* `clip_preprocess_pil` / `clip_resize_pil_uint8`: host-side PIL resize and
  crop matching HF's CLIPImageProcessor (the parity path), normalized on the
  host or left as uint8 for `normalize_device`. PIL is imported inside them,
  so the module imports without it.
* `clip_preprocess_torch`: the twin of `clip_preprocess_jax`, resize + crop
  + normalize as tensor ops on the image's device, with the same weight
  matrices as jax.image.resize (Keys cubic, antialiased when shrinking):
  close to PIL but not bit-identical.
* `normalize_host` / `normalize_device`: uint8 CHW pixels to CLIP-normalized
  floats on the host or on the device.
* `synthetic_image_uint8`: the POPE runner's deterministic noise image for a
  missing file, built without PIL.

* `qwen_preprocess_pil`: Qwen-VL's transform, a copy of the JAX one.

`expand2square` implements the 'pad' aspect-ratio mode (reference
experiments/llava/mm_utils.py:152-163).
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def expand2square(pil_img, background_color: Tuple[int, int, int]):
    """Pad a PIL image to a square with the given background color,
    centering the original (reference mm_utils.py:152-163)."""
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    result.paste(pil_img, ((side - width) // 2, (side - height) // 2))
    return result


def _resize_crop_pil(pil_img, image_size: int, image_aspect_ratio: Optional[str], mean: Sequence[float]):
    """RGB, optional 'pad' to a mean-color square, shortest edge to
    image_size (bicubic), center crop to image_size x image_size."""
    from PIL import Image

    img = pil_img.convert("RGB")
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in mean)
        img = expand2square(img, bg)
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    # int() truncation, not round: HF get_resize_output_image_size computes
    # int(size * long / short) (transformers/image_transforms.py)
    new_long = int(image_size * long / short)
    new_w, new_h = (image_size, new_long) if w <= h else (new_long, image_size)
    img = img.resize((new_w, new_h), resample=Image.BICUBIC)
    left = (new_w - image_size) // 2
    top = (new_h - image_size) // 2
    return img.crop((left, top, left + image_size, top + image_size))


def clip_preprocess_pil(
    pil_img,
    image_size: int = 336,
    image_aspect_ratio: Optional[str] = None,
    mean: Sequence[float] = OPENAI_CLIP_MEAN,
    std: Sequence[float] = OPENAI_CLIP_STD,
) -> np.ndarray:
    """PIL → normalized CHW float32, matching HF CLIPImageProcessor:
    resize shortest edge (bicubic) → center crop → rescale 1/255 → normalize.
    With image_aspect_ratio='pad', first expand to a square filled with the
    CLIP mean color (reference mm_utils.py:166-173)."""
    img = _resize_crop_pil(pil_img, image_size, image_aspect_ratio, mean)
    arr = np.asarray(img, dtype=np.float32) / 255.0  # HWC
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)  # CHW


def clip_resize_pil_uint8(
    pil_img,
    image_size: int = 336,
    image_aspect_ratio: Optional[str] = None,
    mean: Sequence[float] = OPENAI_CLIP_MEAN,
) -> np.ndarray:
    """PIL → uint8 CHW, the resize/crop half of clip_preprocess_pil with
    normalization left to the device (normalize_device): 4x fewer bytes to
    the device than normalized fp32, the same math."""
    img = _resize_crop_pil(pil_img, image_size, image_aspect_ratio, mean)
    return np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)


def qwen_preprocess_pil(
    pil_img,
    image_size: int = 448,
    mean: Sequence[float] = OPENAI_CLIP_MEAN,
    std: Sequence[float] = OPENAI_CLIP_STD,
) -> np.ndarray:
    """Qwen-VL's image transform: direct (aspect-destroying) bicubic resize to
    image_size x image_size + CLIP normalize (reference Qwen_VL/visual.py:352-361).
    Returns CHW float32."""
    from PIL import Image

    img = pil_img.convert("RGB").resize((image_size, image_size), resample=Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)


def synthetic_image_uint8(image_file: str, image_size: int = 336) -> np.ndarray:
    """The deterministic noise image that stands in for a missing file
    (runners' --synthetic-images), as uint8 CHW. The JAX runner passes the
    [H, W, 3] noise through clip_resize_pil_uint8: a same-size resize, which
    Pillow returns as a copy, and a crop of the whole image, so the pixels
    come out as drawn and no PIL is needed."""
    rng = np.random.default_rng(zlib.crc32(image_file.encode()))
    raw = rng.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
    return np.ascontiguousarray(raw.transpose(2, 0, 1))


def normalize_host(u8: np.ndarray) -> np.ndarray:
    """uint8 CHW pixels → CLIP-normalized float32 on the host."""
    x = u8.astype(np.float32) / 255.0
    m = np.asarray(OPENAI_CLIP_MEAN, np.float32).reshape(3, 1, 1)
    s = np.asarray(OPENAI_CLIP_STD, np.float32).reshape(3, 1, 1)
    return (x - m) / s


def normalize_device(
    images: torch.Tensor,
    dtype: torch.dtype,
    mean: Sequence[float] = OPENAI_CLIP_MEAN,
    std: Sequence[float] = OPENAI_CLIP_STD,
) -> torch.Tensor:
    """uint8 raw pixels [..., 3, H, W] → /255 → CLIP-normalize → dtype, on
    the images' device; float inputs are already normalized and only cast."""
    if images.dtype.is_floating_point:
        return images.to(dtype)
    x = images.float() / 255.0
    shape = (1,) * (x.ndim - 3) + (3, 1, 1)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(shape)
    s = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(shape)
    return ((x - m) / s).to(dtype)


def clip_normalize(image_01: torch.Tensor) -> torch.Tensor:
    """Normalize an already-resized [0, 1] image. Accepts HWC or CHW;
    returns CHW."""
    x = image_01
    if x.shape[-1] == 3:
        x = torch.movedim(x, -1, -3)
    mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=x.dtype, device=x.device).reshape(3, 1, 1)
    std = torch.tensor(OPENAI_CLIP_STD, dtype=x.dtype, device=x.device).reshape(3, 1, 1)
    return (x - mean) / std


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5 (jax.image's 'bicubic')."""
    x = x.abs()
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in_size, out_size] fp32 weights of jax.image.resize's 'bicubic' with
    antialias along one axis (jax/_src/image/scale.py compute_weight_mat):
    the kernel stretched by 1/scale when shrinking, each output's weights
    normalized to sum to one, outputs whose sample falls outside zeroed."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * float(inv_scale) - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    w = _keys_cubic(dist / float(kernel_scale))
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_hw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] fp32 → [out_h, out_w, C], each axis that changes size
    through its weight matrix (as jax.image.resize skips the others)."""
    if x.shape[0] != out_h:
        x = torch.einsum("hwc,ho->owc", x, _resize_weights(x.shape[0], out_h, x.device))
    if x.shape[1] != out_w:
        x = torch.einsum("hwc,wp->hpc", x, _resize_weights(x.shape[1], out_w, x.device))
    return x


def clip_preprocess_torch(
    image_uint8: torch.Tensor,
    image_size: int = 336,
    pad_to_square: bool = True,
) -> torch.Tensor:
    """Twin of clip_preprocess_jax: uint8 HWC → normalized CHW float32 on
    the image's device. pad_to_square=True reproduces the 'pad' aspect mode
    (pad with the CLIP mean color, then resize, no crop); otherwise the
    shortest edge goes to image_size and the center is cropped."""
    x = image_uint8.float() / 255.0  # HWC in [0, 1]
    h, w = x.shape[0], x.shape[1]
    if pad_to_square:
        side = max(h, w)
        top, left = (side - h) // 2, (side - w) // 2
        canvas = torch.tensor(OPENAI_CLIP_MEAN, dtype=torch.float32, device=x.device).expand(side, side, 3)
        canvas = canvas.clone()
        canvas[top:top + h, left:left + w] = x
        x = _resize_hw(canvas, image_size, image_size)
    else:
        if h <= w:  # int() truncation, as HF (see _resize_crop_pil)
            nh, nw = image_size, int(image_size * w / h)
        else:
            nh, nw = int(image_size * h / w), image_size
        x = _resize_hw(x, nh, nw)
        top, left = (nh - image_size) // 2, (nw - image_size) // 2
        x = x[top:top + image_size, left:left + image_size]
    return clip_normalize(x.clamp(0.0, 1.0))
