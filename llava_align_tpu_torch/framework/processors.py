"""Image processors, registered by name: the part the caption training
path reaches (copies of _normalize and BlipImageEvalProcessor from
llava_align_tpu/framework/processors.py, the source unchanged;
tests/test_torch_copies.py holds them to it). PIL is imported where an
image is processed.

Capability parity: reference lavis/processors/blip_processors.py:105-185 —
blip_image_eval (resize + normalize). The train transforms
(blip_image_train, RandAugment) and the text processors are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from llava_align_tpu_torch.framework.registry import registry
from llava_align_tpu_torch.ops.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


def _normalize(arr_hwc: np.ndarray, mean, std) -> np.ndarray:
    x = arr_hwc.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return x.transpose(2, 0, 1)


@registry.register_processor("blip_image_eval")
class BlipImageEvalProcessor:
    def __init__(self, image_size: int = 224, mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD):
        self.image_size = image_size
        self.mean, self.std = mean, std

    def __call__(self, pil_img) -> np.ndarray:
        from PIL import Image

        img = pil_img.convert("RGB").resize(
            (self.image_size, self.image_size), resample=Image.BICUBIC
        )
        return _normalize(np.asarray(img), self.mean, self.std)
