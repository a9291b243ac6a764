"""CLIP pixel normalisation (torch twin of llava_align_tpu/ops/image.py
normalize_host / normalize_device).

Resizing real image files (PIL) comes with the runners, in a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


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
