"""Image and text processors, registered by name (copies of
llava_align_tpu/framework/processors.py's image-text ones, the source
unchanged; tests/test_torch_copies.py holds them to it). PIL is imported
where an image is processed.

Capability parity: reference lavis/processors/blip_processors.py and
clip_processors.py: blip_image_eval (resize + normalize), blip_image_train
(random resized crop + flip + 2-op RandAugment at magnitude 5),
blip2_image_train (364 px, no RandAugment), clip_image_train (crop scale
0.9-1.0, no flip) and clip_image_eval (short-edge resize + center crop),
and the blip_caption / blip_question text processors. The video and
BLIP-Diffusion processors are not ported yet.
"""

from __future__ import annotations

import re
from typing import Optional

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


@registry.register_processor("blip_image_train")
class BlipImageTrainProcessor:
    """Random resized crop (area scale + 3/4..4/3 aspect, torchvision
    semantics) + horizontal flip + 2-op RandAugment (M=5, the 10-op blip
    subset) + normalize — the reference train transform
    (blip_processors.py:110-138)."""

    def __init__(
        self,
        image_size: int = 224,
        min_scale: float = 0.5,
        max_scale: float = 1.0,
        mean=OPENAI_CLIP_MEAN,
        std=OPENAI_CLIP_STD,
        seed: Optional[int] = None,
    ):
        from llava_align_tpu_torch.framework.randaugment import (
            BLIP_TRAIN_AUGS, RandomAugment,
        )

        self.image_size = image_size
        self.min_scale, self.max_scale = min_scale, max_scale
        self.mean, self.std = mean, std
        self.rng = np.random.default_rng(seed)
        self.randaug = RandomAugment(
            2, 5, augs=list(BLIP_TRAIN_AUGS), rng=self.rng
        )

    def _random_resized_crop(self, img):
        """torchvision RandomResizedCrop: 10 tries of (area, log-ratio)
        sampling, center-crop fallback."""
        from PIL import Image

        w, h = img.size
        area = w * h
        for _ in range(10):
            target = area * self.rng.uniform(self.min_scale, self.max_scale)
            ratio = float(np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3))))
            cw = int(round(np.sqrt(target * ratio)))
            ch = int(round(np.sqrt(target / ratio)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = int(self.rng.integers(0, w - cw + 1))
                y0 = int(self.rng.integers(0, h - ch + 1))
                return img.crop((x0, y0, x0 + cw, y0 + ch)).resize(
                    (self.image_size, self.image_size), resample=Image.BICUBIC
                )
        # torchvision fallback: center crop clamped to the ratio range
        min_ratio, max_ratio = 3 / 4, 4 / 3
        in_ratio = w / h
        if in_ratio < min_ratio:
            cw = w
            ch = int(round(cw / min_ratio))
        elif in_ratio > max_ratio:
            ch = h
            cw = int(round(ch * max_ratio))
        else:
            cw, ch = w, h
        x0, y0 = (w - cw) // 2, (h - ch) // 2
        return img.crop((x0, y0, x0 + cw, y0 + ch)).resize(
            (self.image_size, self.image_size), resample=Image.BICUBIC
        )

    def __call__(self, pil_img) -> np.ndarray:
        from PIL import Image

        img = self._random_resized_crop(pil_img.convert("RGB"))
        if self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = self.randaug(np.asarray(img))
        return _normalize(arr, self.mean, self.std)


def _resize_short_edge(img, size: int):
    """torchvision transforms.Resize(int) semantics: scale the SHORT edge to
    `size`, preserving aspect ratio (bicubic)."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, int(round(h * size / w)))
    else:
        nh, nw = size, max(1, int(round(w * size / h)))
    return img.resize((nw, nh), resample=Image.BICUBIC)


def _center_crop(img, size: int):
    """torchvision transforms.CenterCrop(int), incl. the pad-when-smaller
    branch torchvision applies before cropping."""
    from PIL import Image

    w, h = img.size
    if w < size or h < size:
        canvas = Image.new("RGB", (max(w, size), max(h, size)), (0, 0, 0))
        canvas.paste(img.convert("RGB"), ((canvas.width - w) // 2, (canvas.height - h) // 2))
        img = canvas
        w, h = img.size
    x0 = int(round((w - size) / 2.0))
    y0 = int(round((h - size) / 2.0))
    return img.crop((x0, y0, x0 + size, y0 + size))


@registry.register_processor("blip2_image_train")
class Blip2ImageTrainProcessor(BlipImageTrainProcessor):
    """BLIP-2 train transform (reference blip_processors.py:197-239):
    RandomResizedCrop(364, scale 0.5-1.0, bicubic) + horizontal flip +
    normalize — same as blip_image_train but at 364px and WITHOUT
    RandAugment."""

    def __init__(self, image_size: int = 364, min_scale: float = 0.5,
                 max_scale: float = 1.0, mean=OPENAI_CLIP_MEAN,
                 std=OPENAI_CLIP_STD, seed: Optional[int] = None):
        super().__init__(image_size=image_size, min_scale=min_scale,
                         max_scale=max_scale, mean=mean, std=std, seed=seed)

    def __call__(self, pil_img) -> np.ndarray:
        from PIL import Image

        img = self._random_resized_crop(pil_img.convert("RGB"))
        if self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _normalize(np.asarray(img), self.mean, self.std)


@registry.register_processor("clip_image_train")
class ClipImageTrainProcessor(BlipImageTrainProcessor):
    """CLIP train transform (reference clip_processors.py:19-59):
    RandomResizedCrop(224, scale 0.9-1.0, bicubic) + to-RGB + normalize —
    narrower crop range, NO flip, NO RandAugment."""

    def __init__(self, image_size: int = 224, min_scale: float = 0.9,
                 max_scale: float = 1.0, mean=OPENAI_CLIP_MEAN,
                 std=OPENAI_CLIP_STD, seed: Optional[int] = None):
        super().__init__(image_size=image_size, min_scale=min_scale,
                         max_scale=max_scale, mean=mean, std=std, seed=seed)

    def __call__(self, pil_img) -> np.ndarray:
        img = self._random_resized_crop(pil_img.convert("RGB"))
        return _normalize(np.asarray(img), self.mean, self.std)


@registry.register_processor("clip_image_eval")
class ClipImageEvalProcessor:
    """CLIP eval transform (reference clip_processors.py:62-96): resize the
    SHORT edge to image_size (aspect preserved) + center crop + normalize —
    unlike blip_image_eval's square resize."""

    def __init__(self, image_size: int = 224, mean=OPENAI_CLIP_MEAN,
                 std=OPENAI_CLIP_STD):
        self.image_size = image_size
        self.mean, self.std = mean, std

    def __call__(self, pil_img) -> np.ndarray:
        img = _resize_short_edge(pil_img.convert("RGB"), self.image_size)
        img = _center_crop(img, self.image_size)
        return _normalize(np.asarray(img), self.mean, self.std)


@registry.register_processor("blip_caption")
class BlipCaptionProcessor:
    """Caption text processor (reference blip_processors.py:30-68
    BlipCaptionProcessor): prompt + pre_caption — lowercase, the punctuation
    class [.!"()*#:;~] replaced with SPACE, whitespace runs collapsed,
    strip, then truncate to max_words."""

    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        caption = re.sub(r'([.!"()*#:;~])', " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return self.prompt + caption


@registry.register_processor("blip_question")
class BlipQuestionProcessor:
    """Question text processor (reference blip_processors.py:71-102
    pre_question): lowercase, the punctuation class [.!"()*#:;~] DELETED
    (not spaced — unlike pre_caption), rstrip, truncate to max_words."""

    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        question = re.sub(r'([.!"()*#:;~])', "", question.lower())
        question = question.rstrip(" ")
        words = question.split(" ")
        if len(words) > self.max_words:
            question = " ".join(words[: self.max_words])
        return question

