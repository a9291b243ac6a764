"""Qwen-VL: the ViT + Resampler visual encoder and the Qwen decoder with
in-band image spans (torch twin of llava_align_tpu/models/qwen_vl.py).

Parity: reference experiments/Qwen_VL/modeling_qwen.py QWenModel.forward
(:555-577): the token stream carries [image_start_id, 256 span tokens,
image_end_id], and the 256 positions between the framing tokens take the
Resampler's outputs; the framing tokens stay ordinary embeddings. Spans are
located on the host (`sentinelize_span`) and turned into the splice plan's
sentinel, so the device side is LLaVA's gather and select
(decoding/adapters.QwenVLAdapter.splice_embeds).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.models import qwen_vit
from llava_align_tpu_torch.models.qwen import QwenConfig
from llava_align_tpu_torch.models.qwen_vit import QwenVisionConfig

Params = Dict[str, Any]

# Qwen-VL special token ids (config.json visual.image_start_id = 151857;
# end = start + 1, pad = start + 2, modeling_qwen.py:555-565)
DEFAULT_IMAGE_START_ID = 151857


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    text: QwenConfig = dataclasses.field(default_factory=QwenConfig)
    vision: QwenVisionConfig = dataclasses.field(default_factory=QwenVisionConfig)
    image_start_id: int = DEFAULT_IMAGE_START_ID

    @property
    def image_end_id(self) -> int:
        return self.image_start_id + 1

    @property
    def image_pad_id(self) -> int:
        return self.image_start_id + 2

    @staticmethod
    def qwen_vl_7b() -> "QwenVLConfig":
        return QwenVLConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "QwenVLConfig":
        text = QwenConfig.tiny(vocab_size)
        vision = dataclasses.replace(QwenVisionConfig.tiny(), output_dim=text.hidden_size)
        return QwenVLConfig(text=text, vision=vision, image_start_id=vocab_size - 5)


def sentinelize_span(input_ids: Sequence[int], cfg: QwenVLConfig) -> Tuple[List[int], int]:
    """Collapse each [start, ...span..., end] image block into [start,
    IMAGE_TOKEN_INDEX, end]; the splice plan re-expands the sentinel to
    n_queries feature slots. Returns (ids, num_images)."""
    out: List[int] = []
    n_images = 0
    i = 0
    ids = [int(t) for t in input_ids]
    while i < len(ids):
        t = ids[i]
        if t == cfg.image_start_id:
            try:
                j = ids.index(cfg.image_end_id, i + 1)
            except ValueError:
                raise ValueError("unterminated image span in input_ids")
            out += [cfg.image_start_id, IMAGE_TOKEN_INDEX, cfg.image_end_id]
            n_images += 1
            i = j + 1
        else:
            out.append(t)
            i += 1
    return out, n_images


def make_image_span_ids(cfg: QwenVLConfig) -> List[int]:
    """The token block the tokenizer emits for '<img>…</img>', the path
    bytes padded to n_queries (modeling_qwen.py:555-565). For images fed as
    tensors the span's content does not matter: pads suffice."""
    return [cfg.image_start_id] + [cfg.image_pad_id] * cfg.vision.n_queries + [cfg.image_end_id]


def encode_images(params: Params, cfg: QwenVLConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] normalized pixels → [B, n_queries, D] in the decoder's dtype."""
    return qwen_vit.forward(params["visual"], cfg.vision, images).to(cfg.text.dtype)
