"""Model adapters: the decode engine's interface to each VLM family (torch
twin of llava_align_tpu/decoding/adapters.py; LLaVA only so far).

Branch degradation for llava: 'unk' → IMAGE_TOKEN_INDEX→token 0; 'none' →
sentinel removed (reference vcd_sample.py:153-160).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.models import llama, llava

Params = Dict[str, Any]

UNK_TOKEN_ID = 0  # reference vcd_sample.py:155


class LlavaAdapter:
    name = "llava"

    def __init__(self, cfg: LlavaConfig):
        self.cfg = cfg

    @property
    def num_image_tokens(self) -> int:
        return self.cfg.num_image_tokens

    @property
    def vision_dtype(self) -> torch.dtype:
        return self.cfg.vision.dtype

    @property
    def image_size(self) -> int:
        return self.cfg.vision.image_size

    def branch_token_ids(self, input_ids: Sequence[int], kind: str) -> List[int]:
        ids = [int(t) for t in input_ids]
        if kind in ("main", "cd"):
            return ids
        if kind == "unk":
            return [UNK_TOKEN_ID if t == IMAGE_TOKEN_INDEX else t for t in ids]
        if kind == "none":
            return [t for t in ids if t != IMAGE_TOKEN_INDEX]
        raise ValueError(kind)

    def encode_images(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return llava.encode_images(params, self.cfg, images)

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice_embeds(params, self.cfg, tokens, tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return llama.embed_tokens(params["llama"], ids)

    def init_cache(self, batch: int, max_len: int, device=None):
        return llama.init_cache(self.cfg.text, batch, max_len, device=device)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                cache_row_offset=0, shared_kv=None, shared_len=None, shared_rows_per_prefix=None,
                shared_rows_per_prefix2=0):
        return llama.forward(
            params["llama"], self.cfg.text, embeds, positions, cache, offsets,
            attn_impl=attn_impl, cache_row_offset=cache_row_offset, shared_kv=shared_kv,
            shared_len=shared_len,
            shared_rows_per_prefix=shared_rows_per_prefix,
            shared_rows_per_prefix2=shared_rows_per_prefix2,
        )

    # Shared-prefix decoding (engine.generate_batch_groups) needs the model
    # forward to accept a read-only prefix KV segment; the llama forward does.
    supports_shared_prefix = True

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return llama.logits_from_hidden(params["llama"], hidden)
