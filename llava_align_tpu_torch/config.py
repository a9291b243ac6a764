"""Configuration dataclasses — the torch twin of llava_align_tpu/config.py.

Same classes, presets and field names; dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-family decoder config (the LLaVA language backbone)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def llava_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llava_13b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=5120,
            intermediate_size=13824,
            num_layers=40,
            num_heads=40,
            num_kv_heads=40,
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """Small config for CPU tests."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_position_embeddings=512,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower config (openai/clip-vit-large-patch14-336)."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    select_layer: int = -2
    select_feature: str = "patch"
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def clip_vit_l_336() -> "ClipVisionConfig":
        return ClipVisionConfig()

    @staticmethod
    def tiny() -> "ClipVisionConfig":
        return ClipVisionConfig(
            image_size=28,
            patch_size=14,
            hidden_size=32,
            intermediate_size=64,
            num_layers=3,
            num_heads=2,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    """Full LLaVA model: vision tower + projector + LLaMA decoder."""

    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = dataclasses.field(default_factory=ClipVisionConfig)
    mm_projector_type: str = "mlp2x_gelu"
    image_aspect_ratio: Optional[str] = "pad"
    image_grid_pinpoints: Optional[str] = None
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    @staticmethod
    def llava_v15_7b() -> "LlavaConfig":
        return LlavaConfig()

    @staticmethod
    def llava_v15_13b() -> "LlavaConfig":
        return LlavaConfig(text=LlamaConfig.llava_13b())

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlavaConfig":
        return LlavaConfig(
            text=LlamaConfig.tiny(vocab_size),
            vision=ClipVisionConfig.tiny(),
            mm_projector_type="mlp2x_gelu",
        )


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-time knobs (defaults as llava_align_tpu.config.GenerationConfig)."""

    max_new_tokens: int = 64
    do_sample: bool = True
    temperature: float = 1.0
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    seed: int = 42

    use_cd: bool = False       # VCD: contrast against a diffusion-noised image
    use_dd: bool = False       # VDD 'none': image tokens physically removed
    use_dd_unk: bool = False   # VDD 'unk' : image token ids replaced with 0
    cd_alpha: float = 0.5
    cd_beta: float = 0.1
    noise_step: int = 500

    eos_token_id: int = 2
    pad_token_id: int = 0

    @property
    def num_branches(self) -> int:
        """Rows in the packed branch axis — mirrors decoding.engine.branch_kinds."""
        primary = int(self.use_cd or self.use_dd_unk or self.use_dd)
        return 1 + primary + int(self.use_dd and self.use_dd_unk)

    @property
    def contrastive(self) -> bool:
        return self.use_cd or self.use_dd or self.use_dd_unk
