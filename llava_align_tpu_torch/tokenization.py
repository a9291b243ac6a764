"""Tokenizer helpers (copy of llava_align_tpu/tokenization.py, with a torch
tensor return in place of the jax one): tokenizer_image_token,
get_model_name_from_path, keyword_token_ids.

`tokenizer_image_token` reproduces reference experiments/llava/mm_utils.py:185-204:
split the prompt on the literal "<image>", tokenize each chunk, and rejoin with
the out-of-vocab IMAGE_TOKEN_INDEX sentinel, keeping a single BOS at the front
and dropping the BOS the tokenizer prepends to every later chunk.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize a prompt containing "<image>" placeholders.

    `tokenizer` is any callable object with HF semantics:
    tokenizer(text).input_ids -> List[int], plus a `bos_token_id` attribute.
    """
    chunks: List[List[int]] = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    bos = getattr(tokenizer, "bos_token_id", None)
    has_bos = bool(chunks and chunks[0] and bos is not None and chunks[0][0] == bos)
    offset = 1 if has_bos else 0

    ids: List[int] = []
    if has_bos:
        ids.append(bos)
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(image_token_index)
        ids.extend(chunk[offset:])

    if return_tensors is None:
        return ids
    if return_tensors == "np":
        return np.asarray(ids, dtype=np.int64)
    if return_tensors == "pt":
        import torch

        return torch.tensor(ids, dtype=torch.long)
    raise ValueError(f"Unsupported tensor type: {return_tensors}")


def get_model_name_from_path(model_path: str) -> str:
    """The model's name from its checkpoint path (reference
    mm_utils.py:207-213): the last path part, prefixed by its parent for a
    `checkpoint-*` dir."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


def keyword_token_ids(keywords: Sequence[str], tokenizer) -> List[List[int]]:
    """Token-id sequences for stop keywords, BOS-stripped
    (reference mm_utils.py:215-228)."""
    bos = getattr(tokenizer, "bos_token_id", None)
    out = []
    for kw in keywords:
        ids = tokenizer(kw).input_ids
        if len(ids) > 1 and bos is not None and ids[0] == bos:
            ids = ids[1:]
        out.append(list(ids))
    return out
