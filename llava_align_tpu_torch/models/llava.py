"""LLaVA: CLIP vision tower + projector + LLaMA decoder (torch twin of
llava_align_tpu/models/llava.py).

The splice is planned on the host as integer gather plans (`SplicePlan`,
numpy; a copy of the JAX package's plan_splice) and run on the device as
one embedding gather, one feature gather and a select.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.models import clip_vit, llama, projector

Params = Dict[str, Any]


def encode_images(params: Params, cfg: LlavaConfig, images: torch.Tensor,
                  tp_mesh=None) -> torch.Tensor:
    """[B, 3, H, W] normalized pixels → [B, num_patches, text_hidden].
    tp_mesh: the vision tower split over 'model' (clip_vit); the projector
    is replicated."""
    feats = clip_vit.forward_features(params["vision"], cfg.vision, images, tp_mesh)
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


def text_only_plan(input_ids: Sequence[int], pad_to: int) -> SplicePlan:
    """Plan with zero image slots — the VDD branches ('unk': sentinel→token 0,
    'none': sentinel dropped) are built by the caller editing input_ids first
    (reference vcd_sample.py:153-160)."""
    return plan_splice([t for t in input_ids], 0, pad_to)


def splice_embeds(
    params: Params,
    cfg: LlavaConfig,
    tokens: torch.Tensor,          # [B, T] int (sentinel-free)
    tok_gather: torch.Tensor,      # [B, S]
    img_gather: torch.Tensor,      # [B, S]
    is_image: torch.Tensor,        # [B, S] bool
    image_features: torch.Tensor,  # [B, N_img_slots, D]
    tp_group=None,
) -> torch.Tensor:
    """Device-side splice → [B, S, D]. tp_group: the 'model' group of an
    embed split on its hidden dim: its hidden shards are gathered before
    the splice."""
    text_emb = llama.embed_tokens(params["llama"], tokens, tp_group)  # [B, T, D]
    return splice(text_emb, tok_gather, img_gather, is_image, image_features)


def splice(text_emb: torch.Tensor, tok_gather: torch.Tensor, img_gather: torch.Tensor,
           is_image: torch.Tensor, image_features: torch.Tensor) -> torch.Tensor:
    """Gather the token rows of text_emb [B, T, D] and the feature rows of
    image_features, select by is_image → [B, S, D] in text_emb's dtype. The
    plans index inside their arrays by construction (torch gathers do not
    clamp as JAX's do)."""
    D = text_emb.shape[-1]
    gathered_text = torch.gather(text_emb, 1, tok_gather.long()[..., None].expand(-1, -1, D))
    gathered_img = torch.gather(
        image_features, 1, img_gather.long()[..., None].expand(-1, -1, D)
    ).to(gathered_text.dtype)
    return torch.where(is_image[..., None], gathered_img, gathered_text)


def forward_multimodal(
    params: Params,
    cfg: LlavaConfig,
    input_ids: Sequence[int],
    images: Optional[torch.Tensor],
    pad_to: int,
    *,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, int]:
    """Convenience single-sequence forward (no cache), the JAX package's:
    returns (logits [pad_to, V] fp32, true_length). images [n, 3, H, W]
    (or one [3, H, W]) normalized, one per IMAGE_TOKEN_INDEX, or None."""
    n_img = cfg.num_image_tokens if images is not None else 0
    plan = plan_splice(input_ids, n_img, pad_to)
    dev = params["llama"]["embed"].device
    if images is not None:
        if images.dim() == 3:
            images = images[None]
        n_sent = sum(1 for t in input_ids if t == IMAGE_TOKEN_INDEX)
        if n_sent != images.shape[0]:
            # the reference's llava_arch.py:142 ValueError (a gather past the
            # features would clamp in JAX and fault here)
            raise ValueError(
                f"Number of images ({images.shape[0]}) does not match number of"
                f" special image tokens ({n_sent}) in the prompt"
            )
        # [n, N, D] → [1, n*N, D]: each sentinel consumes its image's block
        feats = encode_images(params, cfg, images.to(dev))
        feats = feats.reshape(1, -1, feats.shape[-1])
    else:
        feats = torch.zeros((1, 1, cfg.text.hidden_size), dtype=cfg.text.dtype, device=dev)

    def row(a):
        return torch.from_numpy(a).to(dev)[None]

    embeds = splice_embeds(params, cfg, row(plan.tokens), row(plan.tok_gather), row(plan.img_gather),
                           row(plan.is_image), feats)
    positions = torch.arange(pad_to, device=dev)[None]
    hidden, _ = llama.forward(params["llama"], cfg.text, embeds, positions, attn_impl=attn_impl)
    return llama.logits_from_hidden(params["llama"], hidden[0]), plan.length
