"""LLaVA-MPT: CLIP tower + projector + MPT decoder (torch twin of
llava_align_tpu/models/llava_mpt.py).

Capability parity: reference experiments/llava/model/language_model/
llava_mpt.py (LlavaMPTForCausalLM): the multimodal splice and projector
are LLaVA-LLaMA's; only the language backbone differs (alibi MPT). Decode
with decoding.adapters.LlavaMptAdapter. Param tree: mpt (models/mpt),
vision (models/clip_vit), projector (models/projector).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from llava_align_tpu_torch.config import ClipVisionConfig
from llava_align_tpu_torch.models.mpt import MptConfig
from llava_align_tpu_torch.utils.synthetic import build_random_llava_mpt_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlavaMptConfig:
    text: MptConfig = dataclasses.field(default_factory=MptConfig)
    vision: ClipVisionConfig = dataclasses.field(default_factory=ClipVisionConfig)
    mm_projector_type: str = "mlp2x_gelu"
    mm_use_im_start_end: bool = False

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlavaMptConfig":
        return LlavaMptConfig(text=MptConfig.tiny(vocab_size), vision=ClipVisionConfig.tiny())


def init(cfg: LlavaMptConfig, device=None, seed: int = 0) -> Params:
    """Random params with llava_mpt.init's tree and scales on `device` (the
    GPU unless another is named), drawn from one torch.Generator."""
    return build_random_llava_mpt_params(cfg, device, seed)
