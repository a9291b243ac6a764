"""AnyRes multi-patch image preprocessing (LLaVA-1.6 style grids): a copy of
llava_align_tpu/ops/anyres.py, numpy and PIL only.

Parity: reference experiments/llava/mm_utils.py — select_best_resolution
(:12-39), resize_and_pad_image (:42-74), divide_to_patches (:77-96),
get_anyres_image_grid_shape (:99-116), process_anyres_image (:119-145).
"""

from __future__ import annotations

import ast
import math
from typing import List, Sequence, Tuple

import numpy as np


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """Pick the grid resolution maximizing effective resolution then
    minimizing waste (reference :12-39)."""
    ow, oh = original_size
    best = None
    max_effective = 0
    min_wasted = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = w * h - effective
        if effective > max_effective or (effective == max_effective and wasted < min_wasted):
            max_effective = effective
            min_wasted = wasted
            best = (w, h)
    return best


def resize_and_pad_image(image, target_resolution: Tuple[int, int]):
    """Aspect-preserving resize, centered on a black canvas (reference :42-74)."""
    from PIL import Image

    ow, oh = image.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def divide_to_patches(image, patch_size: int) -> List:
    """Non-overlapping patch crops, row-major (reference :77-96)."""
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def get_anyres_image_grid_shape(
    image_size: Tuple[int, int], grid_pinpoints, patch_size: int
) -> Tuple[int, int]:
    """(grid_w, grid_h) in patches (reference :99-116)."""
    resolutions = (
        grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    )
    w, h = select_best_resolution(image_size, resolutions)
    return w // patch_size, h // patch_size


def process_anyres_image(
    image, grid_pinpoints, base_size: int = 336, crop_size: int = 336
) -> np.ndarray:
    """[1 + n_patches, 3, crop, crop] CLIP-normalized stack: the base resize
    of the full image first, then the grid patches (reference :119-145)."""
    from llava_align_tpu_torch.ops.image import clip_preprocess_pil

    resolutions = (
        grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    )
    best = select_best_resolution(image.size, resolutions)
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, crop_size)
    base = image.resize((base_size, base_size))
    stack = [clip_preprocess_pil(p, crop_size) for p in [base] + patches]
    return np.stack(stack, axis=0)
