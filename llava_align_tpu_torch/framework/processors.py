"""Image, video and text processors, registered by name (copies of
llava_align_tpu/framework/processors.py's image-text, ALPRO video and GPT
dialogue ones, the source unchanged; tests/test_torch_copies.py holds them
to it). PIL is imported where an image is processed; cv2 where a video
file is decoded (frame directories, arrays and PIL frame lists need it
not).

Capability parity: reference lavis/processors/blip_processors.py,
clip_processors.py, alpro_processors.py and gpt_processors.py:
blip_image_eval (resize + normalize), blip_image_train (random resized
crop + flip + 2-op RandAugment at magnitude 5), blip2_image_train (364
px, no RandAugment), clip_image_train (crop scale 0.9-1.0, no flip),
clip_image_eval (short-edge resize + center crop), the BLIP-Diffusion
subject input (blip_diffusion_inp_image_train / _eval: short-edge resize,
center crop, CLIP normalize) and target (blip_diffusion_tgt_image_train:
512 px, normalized to [-1, 1]) transforms, alpro_video_eval /
alpro_video_train (uniform / headtail frame sampling to [3, T, H, W]),
gpt_dialogue / gpt_video_ft (AVSD token streams and feature prefixes),
and the blip_caption / blip_question text processors. One departure:
without `tokenizer=` the GPT processors raise (the JAX package fetches
GPT-2's tokenizer by name, which needs the network).
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


@registry.register_processor("blip_diffusion_inp_image_train")
@registry.register_processor("blip_diffusion_inp_image_eval")
class BlipDiffusionInputImageProcessor:
    """BLIP-diffusion subject-input transform (reference
    blip_diffusion_processors.py:17-50, registered under both the train and
    eval names): resize short edge + center crop + CLIP normalize."""

    def __init__(self, image_size: int = 224, mean=OPENAI_CLIP_MEAN,
                 std=OPENAI_CLIP_STD):
        self.image_size = image_size
        self.mean, self.std = mean, std

    def __call__(self, pil_img) -> np.ndarray:
        img = _resize_short_edge(pil_img.convert("RGB"), self.image_size)
        img = _center_crop(img, self.image_size)
        return _normalize(np.asarray(img), self.mean, self.std)


@registry.register_processor("blip_diffusion_tgt_image_train")
class BlipDiffusionTargetImageProcessor:
    """BLIP-diffusion target transform (reference
    blip_diffusion_processors.py:53-81): resize short edge to 512 + center
    crop + Normalize([0.5],[0.5]) → pixel range [-1, 1] for the VAE."""

    def __init__(self, image_size: int = 512):
        self.image_size = image_size

    def __call__(self, pil_img) -> np.ndarray:
        img = _resize_short_edge(pil_img.convert("RGB"), self.image_size)
        img = _center_crop(img, self.image_size)
        return _normalize(np.asarray(img), [0.5, 0.5, 0.5], [0.5, 0.5, 0.5])


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


@registry.register_processor("alpro_video_eval")
class AlproVideoEvalProcessor:
    """Video eval processor (reference lavis/processors/alpro_processors.py
    AlproVideoEvalProcessor: uniformly sample n_frms, resize, CLIP-normalize
    → [3, T, H, W]). The reference decodes videos with decord (not installed
    here); this processor decodes real video FILES through OpenCV's
    VideoCapture (ffmpeg-backed), and also consumes a directory of frame
    images, a list of PIL images, or a [T, H, W, 3] uint8/float array
    (pre-extracted .npy frames)."""

    def __init__(self, image_size: int = 224, n_frms: int = 8,
                 mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD):
        self.image_size = image_size
        self.n_frms = n_frms
        self.mean = mean
        self.std = std

    def _frame(self, pil_img) -> np.ndarray:
        from PIL import Image

        img = pil_img.convert("RGB").resize(
            (self.image_size, self.image_size), resample=Image.BICUBIC
        )
        return _normalize(np.asarray(img), self.mean, self.std)  # [3, H, W]

    def _decode_video_file(self, path: str):
        """cv2.VideoCapture decode with uniform n_frms sampling — the
        reference's decord load_video semantics (alpro_processors.py) on
        the ffmpeg backend OpenCV ships."""
        import cv2
        from PIL import Image

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise ValueError(f"cannot open video file {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        frames = []
        if total > 0:
            idx = set(
                np.linspace(0, total - 1, self.n_frms).round().astype(int).tolist()
            )
            i = 0
            while True:
                ret, f = cap.read()
                if not ret:
                    break
                if i in idx:
                    frames.append(Image.fromarray(cv2.cvtColor(f, cv2.COLOR_BGR2RGB)))
                i += 1
        else:  # container without a frame count: read all, sample after
            while True:
                ret, f = cap.read()
                if not ret:
                    break
                frames.append(Image.fromarray(cv2.cvtColor(f, cv2.COLOR_BGR2RGB)))
        cap.release()
        return frames

    def __call__(self, video) -> np.ndarray:
        import os

        from PIL import Image

        if isinstance(video, str) and os.path.isfile(video):  # real video file
            frames = self._decode_video_file(video)
        elif isinstance(video, str):  # directory of frame images
            files = sorted(
                os.path.join(video, f) for f in os.listdir(video)
                if f.lower().endswith((".jpg", ".jpeg", ".png"))
            )
            frames = [Image.open(f) for f in files]
        elif isinstance(video, np.ndarray):  # [T, H, W, 3]
            frames = [Image.fromarray(np.asarray(f, np.uint8)) for f in video]
        else:  # sequence of PIL images
            frames = list(video)
        if not frames:
            raise ValueError("empty video input")
        # uniform temporal sampling to n_frms (alpro_processors.py load_video)
        idx = np.linspace(0, len(frames) - 1, self.n_frms).round().astype(int)
        arr = np.stack([self._frame(frames[i]) for i in idx])  # [T, 3, H, W]
        return arr.transpose(1, 0, 2, 3)  # [3, T, H, W]

    def _raw_frames(self, video):
        """Decode to a list of PIL frames without sampling/normalizing
        (shared input-format tolerance for the train subclass)."""
        import os

        from PIL import Image

        if isinstance(video, str) and os.path.isfile(video):
            return self._decode_video_file(video)
        if isinstance(video, str):
            files = sorted(
                os.path.join(video, f) for f in os.listdir(video)
                if f.lower().endswith((".jpg", ".jpeg", ".png"))
            )
            return [Image.open(f) for f in files]
        if isinstance(video, np.ndarray):
            return [Image.fromarray(np.asarray(f, np.uint8)) for f in video]
        return list(video)


@registry.register_processor("alpro_video_train")
class AlproVideoTrainProcessor(AlproVideoEvalProcessor):
    """Video train processor (reference alpro_processors.py:81-143
    AlproVideoTrainProcessor): headtail frame sampling (load_video
    sampling="headtail", data_utils.py:39-42: n/2 frames drawn at random
    from each half, sorted), then the clip-consistent train transform —
    RandomResizedCropVideo (ONE crop box for the whole clip,
    transforms_video.py:53-88) + RandomHorizontalFlipVideo +
    VideoRandomAugment(2, 5, 10-op subset, randaugment.py:352-392) +
    normalize → [3, T, H, W]."""

    def __init__(self, image_size: int = 224, n_frms: int = 8,
                 min_scale: float = 0.5, max_scale: float = 1.0,
                 mean=OPENAI_CLIP_MEAN, std=OPENAI_CLIP_STD,
                 seed: Optional[int] = None):
        from llava_align_tpu_torch.framework.randaugment import VideoRandomAugment

        super().__init__(image_size=image_size, n_frms=n_frms, mean=mean, std=std)
        self.min_scale, self.max_scale = min_scale, max_scale
        self.rng = np.random.default_rng(seed)
        self.randaug = VideoRandomAugment(
            2, 5,
            augs=["Identity", "AutoContrast", "Brightness", "Sharpness",
                  "Equalize", "ShearX", "ShearY", "TranslateX", "TranslateY",
                  "Rotate"],
            rng=self.rng,
        )

    def _headtail_indices(self, vlen: int) -> np.ndarray:
        """reference data_utils.py:39-42: sorted random n/2 from each half."""
        n = min(self.n_frms, vlen)
        half = max(vlen // 2, 1)
        n_h = n // 2
        head = np.sort(self.rng.choice(half, size=min(n_h, half), replace=False))
        tail_pool = np.arange(half, vlen)
        n_t = n - len(head)
        if len(tail_pool) == 0:
            tail = np.empty(0, int)
        else:
            tail = half + np.sort(
                self.rng.choice(len(tail_pool), size=min(n_t, len(tail_pool)),
                                replace=False)
            )
        return np.concatenate([head, tail]).astype(int)

    def _clip_random_resized_crop_box(self, w: int, h: int):
        """torchvision RandomResizedCrop.get_params, drawn ONCE per clip."""
        area = w * h
        for _ in range(10):
            target = area * self.rng.uniform(self.min_scale, self.max_scale)
            ratio = float(np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3))))
            cw = int(round(np.sqrt(target * ratio)))
            ch = int(round(np.sqrt(target / ratio)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = int(self.rng.integers(0, w - cw + 1))
                y0 = int(self.rng.integers(0, h - ch + 1))
                return x0, y0, cw, ch
        min_ratio, max_ratio = 3 / 4, 4 / 3
        in_ratio = w / h
        if in_ratio < min_ratio:
            cw, ch = w, int(round(w / min_ratio))
        elif in_ratio > max_ratio:
            ch, cw = h, int(round(h * max_ratio))
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def __call__(self, video) -> np.ndarray:
        from PIL import Image

        frames = self._raw_frames(video)
        if not frames:
            raise ValueError("empty video input")
        idx = self._headtail_indices(len(frames))
        # decode-time resize to image_size² (reference load_video passes
        # height=width=image_size), so the crop box is in that frame
        size = (self.image_size, self.image_size)
        sampled = [
            frames[i].convert("RGB").resize(size, resample=Image.BICUBIC)
            for i in idx
        ]
        x0, y0, cw, ch = self._clip_random_resized_crop_box(*size)
        flip = self.rng.random() < 0.5
        out = []
        for f in sampled:
            f = f.crop((x0, y0, x0 + cw, y0 + ch)).resize(size, resample=Image.BICUBIC)
            if flip:
                f = f.transpose(Image.FLIP_LEFT_RIGHT)
            out.append(np.asarray(f))
        clip = self.randaug(np.stack(out))          # [T, H, W, 3] float
        clip = np.stack([
            _normalize(frame.astype(np.uint8), self.mean, self.std)
            for frame in clip
        ])                                           # [T, 3, H, W]
        return clip.transpose(1, 0, 2, 3)            # [3, T, H, W]


# GPT-dialogue special tokens (reference gpt_processors.py:22-36)
GPT_SPECIAL_TOKENS_DICT = {
    "bos_token": "<bos>",
    "eos_token": "<eos>",
    "additional_special_tokens": ["<speaker1>", "<speaker2>", "<video>", "<cap>"],
    "pad_token": "<pad>",
}
GPT_SPECIAL_TOKENS = [
    "<bos>", "<eos>", "<speaker1>", "<speaker2>", "<cap>", "<video>", "<pad>",
]


def _default_gpt2_tokenizer():
    """The JAX package's default is transformers' GPT2Tokenizer fetched by
    name ("gpt2"), which needs transformers and the network; the port
    takes the tokenizer from its caller."""
    raise ValueError(
        "the GPT-2 processors need tokenizer=: an object with encode(), "
        "convert_tokens_to_ids() and pad_token_id whose vocabulary holds "
        f"the special tokens {GPT_SPECIAL_TOKENS} (transformers' "
        "GPT2Tokenizer with add_special_tokens(GPT_SPECIAL_TOKENS_DICT) is one)"
    )


def pad_sequences(seqs, pad_value) -> np.ndarray:
    """numpy analog of torch.nn.utils.rnn.pad_sequence(batch_first=True)."""
    seqs = [np.asarray(s) for s in seqs]
    max_len = max(s.shape[0] for s in seqs)
    out = np.full((len(seqs), max_len) + seqs[0].shape[1:], pad_value,
                  dtype=seqs[0].dtype)
    for i, s in enumerate(seqs):
        out[i, : s.shape[0]] = s
    return out


@registry.register_processor("gpt_dialogue")
class GPTDialogueProcessor:
    """AVSD dialogue → GPT token streams (reference gpt_processors.py:45-117
    GPTDialogueProcessor): caption+summary prefix, last `max_turns` QA turns
    plus the current question as history, answer as the supervised suffix.
    sample_sequence appends <eos> to every segment, assigns token types
    <cap>/<speaker1>/<speaker2> (speakers alternate starting at speaker1 for
    history segment 0), and labels = -1 everywhere except the answer tokens.

    The tokenizer is injectable (`tokenizer=`) because this image has no
    network egress for GPT2Tokenizer.from_pretrained; any object with
    encode() / convert_tokens_to_ids() / pad_token_id works."""

    def __init__(self, max_turns: int = 3, use_caption: bool = True,
                 tokenizer=None):
        self.max_turns = max_turns
        self.use_caption = use_caption
        self.tokenizer = tokenizer if tokenizer is not None else _default_gpt2_tokenizer()

    def sample_sequence(self, caption, history, answer):
        bos, eos, speaker1, speaker2, cap = self.tokenizer.convert_tokens_to_ids(
            GPT_SPECIAL_TOKENS[:-2]
        )
        sequence = [list(caption)] + [list(h) for h in history] + [list(answer)]
        sequence = [s + [eos] for s in sequence]
        instance = {}
        instance["input_ids"] = [t for s in sequence for t in s]
        instance["token_type_ids"] = [cap] * len(sequence[0]) + [
            speaker2 if i % 2 else speaker1
            for i, s in enumerate(sequence[1:])
            for _ in s
        ]
        instance["labels"] = (
            [-1] * sum(len(s) for s in sequence[:-1]) + sequence[-1]
        )
        assert len(instance["input_ids"]) == len(instance["token_type_ids"])
        assert len(instance["token_type_ids"]) == len(instance["labels"])
        return {k: np.asarray(v, np.int64) for k, v in instance.items()}

    def padding(self, seqs, pad_token=-1):
        if pad_token == -1:
            pad_token = self.tokenizer.pad_token_id
        return pad_sequences(seqs, pad_token)

    def get_attention_mask(self, seq, pad_token=-1):
        if pad_token == -1:
            pad_token = self.tokenizer.pad_token_id
        return np.asarray(seq) != pad_token

    def __call__(self, ann) -> dict:
        if self.use_caption:
            caption = self.tokenizer.encode(
                " ".join([ann["caption"], ann["summary"]])
            )
        else:
            caption = []
        dial_history = []
        for turn in ann["dialog"][-self.max_turns:]:
            dial_history.append(turn["question"])
            dial_history.append(turn["answer"])
        dial_history.append(ann["question"])
        dial_history = [self.tokenizer.encode(t) for t in dial_history]
        answer = self.tokenizer.encode(ann["answer"])
        return self.sample_sequence(caption, dial_history, answer)


@registry.register_processor("gpt_video_ft")
class GPTVideoFeatureProcessor:
    """Pre-extracted video features → model inputs (reference
    gpt_processors.py:121-172 GPTVideoFeatureProcessor): load each named
    visual/audio .npy feature from ft_root/<name>/<vname>.npy, truncate all
    streams to the shortest length, concatenate on the feature axis; emit
    {video_fts [T, D], token_type_ids [T] = <video> id}. padding pads with
    1.0 and the attention mask marks frames with any non-1.0 feature
    (:134-140)."""

    def __init__(self, visual_ft=("i3d_rgb",), audio_ft=("vggish",),
                 tokenizer=None):
        self.visual_ft = list(visual_ft)
        self.audio_ft = list(audio_ft)
        self.tokenizer = tokenizer if tokenizer is not None else _default_gpt2_tokenizer()

    def padding(self, seqs):
        return pad_sequences([np.asarray(s, np.float32) for s in seqs], 1.0)

    def get_attention_mask(self, seq):
        return np.sum(np.asarray(seq) != 1, axis=2) != 0

    def __call__(self, ft_root: str, vname: str) -> dict:
        import os

        all_ft = []
        for ft_name in self.visual_ft + self.audio_ft:
            ft_path = os.path.join(ft_root, ft_name, vname)
            all_ft.append(np.load(ft_path + ".npy"))
        min_len = min(len(ft) for ft in all_ft)
        sampled = np.concatenate([ft[:min_len] for ft in all_ft], axis=1)
        video_type = self.tokenizer.convert_tokens_to_ids("<video>")
        return {
            "video_fts": sampled.astype(np.float32),
            "token_type_ids": np.full(len(sampled), video_type, np.int64),
        }

