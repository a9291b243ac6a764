"""LLaVA: CLIP vision tower + projector + LLaMA decoder (torch twin of
llava_align_tpu/models/llava.py).

The splice is planned on the host as integer gather plans (`SplicePlan`,
numpy; a copy of the JAX package's plan_splice) and run on the device as
one embedding gather, one feature gather and a select.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.models import clip_vit, llama, projector

Params = Dict[str, Any]


def encode_images(params: Params, cfg: LlavaConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] normalized pixels → [B, num_patches, text_hidden]."""
    feats = clip_vit.forward_features(params["vision"], cfg.vision, images)
    return projector.forward(params["projector"], feats.to(cfg.text.dtype))


@dataclasses.dataclass
class SplicePlan:
    """Static-shape gather plan for one sequence.

    Output position i holds:
        is_image[i] ? image_features[img_gather[i]] : embed(tokens[tok_gather[i]])
    Positions >= length are padding.
    """

    tokens: np.ndarray      # [T] int32, sentinel removed (safe ids for gather)
    tok_gather: np.ndarray  # [S] int32
    img_gather: np.ndarray  # [S] int32
    is_image: np.ndarray    # [S] bool
    length: int             # true sequence length


def plan_splice(
    input_ids: Sequence[int], num_image_tokens: int, pad_to: int
) -> SplicePlan:
    """Expand each IMAGE_TOKEN_INDEX into `num_image_tokens` feature slots
    (multiple images consume their features in order)."""
    ids = list(int(t) for t in input_ids)
    tok_gather: List[int] = []
    img_gather: List[int] = []
    is_image: List[bool] = []
    tokens: List[int] = []
    img_base = 0
    for t in ids:
        if t == IMAGE_TOKEN_INDEX:
            for j in range(num_image_tokens):
                tok_gather.append(0)
                img_gather.append(img_base + j)
                is_image.append(True)
            img_base += num_image_tokens
        else:
            tok_gather.append(len(tokens))
            img_gather.append(0)
            is_image.append(False)
            tokens.append(t)
    length = len(tok_gather)
    if length > pad_to:
        raise ValueError(f"sequence length {length} exceeds pad_to={pad_to}")
    pad = pad_to - length
    tok_gather += [0] * pad
    img_gather += [0] * pad
    is_image += [False] * pad
    if not tokens:
        tokens = [0]
    return SplicePlan(
        tokens=np.asarray(tokens, np.int32),
        tok_gather=np.asarray(tok_gather, np.int32),
        img_gather=np.asarray(img_gather, np.int32),
        is_image=np.asarray(is_image, bool),
        length=length,
    )


def splice_embeds(
    params: Params,
    cfg: LlavaConfig,
    tokens: torch.Tensor,          # [B, T] int (sentinel-free)
    tok_gather: torch.Tensor,      # [B, S]
    img_gather: torch.Tensor,      # [B, S]
    is_image: torch.Tensor,        # [B, S] bool
    image_features: torch.Tensor,  # [B, N_img_slots, D]
) -> torch.Tensor:
    """Device-side splice → [B, S, D]. The plans index inside their arrays
    by construction (torch gathers do not clamp as JAX's do)."""
    text_emb = llama.embed_tokens(params["llama"], tokens)  # [B, T, D]
    D = text_emb.shape[-1]
    gathered_text = torch.gather(text_emb, 1, tok_gather.long()[..., None].expand(-1, -1, D))
    gathered_img = torch.gather(
        image_features, 1, img_gather.long()[..., None].expand(-1, -1, D)
    ).to(gathered_text.dtype)
    return torch.where(is_image[..., None], gathered_img, gathered_text)
