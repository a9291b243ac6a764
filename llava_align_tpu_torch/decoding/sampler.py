"""Logit pipeline for the debiased sampler (torch twin of
llava_align_tpu/decoding/sampler.py).

  * the VCD/VDD contrastive fusion with adaptive-plausibility cutoff:
        cutoff = log(beta) + max(logits)
        out    = (1+alpha)*logits - alpha*logits_cd,  -inf where logits < cutoff
  * HF's logit warpers in generation order (temperature → top-k → top-p).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -float("inf")


def fuse_contrastive_logits(
    logits: torch.Tensor, logits_cd: torch.Tensor, cd_alpha: float, cd_beta: float
) -> torch.Tensor:
    """logits/logits_cd [..., V] fp32 → fused [..., V]."""
    cutoff = math.log(cd_beta) + logits.amax(dim=-1, keepdim=True)
    diffs = (1.0 + cd_alpha) * logits - cd_alpha * logits_cd
    return diffs.masked_fill(logits < cutoff, NEG_INF)


def fuse_calibrate_logits(
    logits: torch.Tensor,
    logits_custom: torch.Tensor,
    cb_cut_weight: float,
    cb_m_weight: float,
    eos_token_id: int,
) -> torch.Tensor:
    """Decode-time Post-Hoc 'calibrate' fusion (the JAX function's semantics):
    cutoff = cb_cut_weight * max(logits); -inf below it; columns past eos
    subtract cb_m_weight * logits_custom."""
    cutoff = cb_cut_weight * logits.amax(dim=-1, keepdim=True)
    masked = logits.masked_fill(logits < cutoff, NEG_INF)
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids > eos_token_id, masked - cb_m_weight * logits_custom, masked)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k scores (ties at the k-th value kept, HF semantics)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def _top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering, HF TopPLogitsWarper semantics with
    min_tokens_to_keep=1: keep the smallest descending-prob prefix whose
    exclusive cumulative probability is < top_p."""
    sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sorted_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep_sorted[..., 0] = True
    keep = torch.empty_like(keep_sorted).scatter_(-1, sorted_idx, keep_sorted)
    return logits.masked_fill(~keep, NEG_INF)


def warp_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """HF generation warper chain; each warper is skipped exactly when HF
    skips it (temperature==1, top_k in (None, 0), top_p in (None, >=1))."""
    x = logits.float()
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if top_k is not None and top_k > 0:
        x = _top_k_mask(x, min(top_k, x.shape[-1]))
    if top_p is not None and top_p < 1.0:
        x = _top_p_mask(x, top_p)
    return x


def sample_token(
    generator: Optional[torch.Generator], warped_logits: torch.Tensor, do_sample: bool = True
) -> torch.Tensor:
    """Categorical sample (torch.multinomial over the softmax) or greedy
    argmax (first maximum, as jnp.argmax). warped_logits [..., V] → [...]."""
    if do_sample:
        probs = torch.softmax(warped_logits, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])
    return torch.argmax(warped_logits, dim=-1)
