"""Elementwise / norm / position-embedding primitives
(torch twin of llava_align_tpu/ops/layers.py).

Norms accumulate in float32 whatever the activation dtype, and return the
input's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """LLaMA RMSNorm: x * rsqrt(mean(x^2) + eps) * scale, fp32 accumulation."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU (torch.nn.GELU default; the projector's activation)."""
    return torch.nn.functional.gelu(x, approximate="none")


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] int → cos, sin each [..., S, head_dim] float32
    (HF LLaMA rotate_half convention)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exponent / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh]; cos/sin [B, S, Dh] → same shape/dtype as x."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos[..., None, :] + rotated * sin[..., None, :]).to(x.dtype)


def linear_bias(x: torch.Tensor, p) -> torch.Tensor:
    """x @ W.T + b for torch-layout params {"w": [out, in], "b": [out]}, the
    Linear the LAVIS zoo modules share."""
    return x @ p["w"].t() + p["b"]


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def sample_hard_negative_indices(generator: Optional[torch.Generator], weights: torch.Tensor) -> torch.Tensor:
    """One draw per row of [B, N] mining weights (positives already zeroed),
    the in-batch hard-negative selection of the ALBEF and BLIP retrieval
    steps. The JAX package draws categorical(log(w + 1e-20)); this draws
    from the same distribution, w + 1e-20 normalized, with torch.multinomial
    on `generator` (its bits are torch's, not JAX's)."""
    w = weights.detach().float() + 1e-20
    return torch.multinomial(w, 1, generator=generator)[:, 0]
