"""Plain fp32 building blocks of the benchmark's references.

Imports torch and numpy only: nothing of the program under test. The
references compute in fp32 with TF32 off (`fp32_mode`), and derive every
quantized weight themselves from the float weights the benchmark made
(`weight_in`): the program's packed or quantized tensors are never read.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

IMAGE_SENTINEL = -200  # the prompt's image placeholder, expanded to the image's features

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# weight precisions a reference can compute in: the one a configuration
# states, and the one below it that serves as the control
PRECISIONS = ("float", "int8", "int4", "fp8")


def fp32_mode() -> None:
    """fp32 products in full fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def randn(g: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """One N(0, scale^2) draw of `shape` in `dtype` from `g` (one call a leaf)."""
    return torch.randn(tuple(shape), generator=g, device=device, dtype=dtype).mul_(scale)


def weight_in(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A float weight [..., O, D] as fp32 after rounding it to `precision`:
    float (as given), int8 (symmetric, one scale per output row, absmax /
    127), int4 (symmetric, one scale per 128 inputs of a row, absmax / 7)
    or fp8 (e4m3 with one scale per output row, absmax / 448; its products
    also round their inputs, act_in)."""
    wf = w.float()
    if precision == "float":
        return wf
    if precision == "int8":
        a = wf.abs().amax(dim=-1, keepdim=True)
        s = a / torch.full_like(a, 127.0)  # a true division, as on the host
        s = torch.where(s == 0, torch.ones_like(s), s)
        return torch.clamp(torch.round(wf / s), -127, 127) * s
    if precision == "int4":
        D = wf.shape[-1]
        gsz = 128 if D % 128 == 0 else D
        g = wf.reshape(*wf.shape[:-1], D // gsz, gsz)
        s = g.abs().amax(dim=-1, keepdim=True) / 7.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        return (torch.clamp(torch.round(g / s), -7, 7) * s).reshape(wf.shape)
    if precision == "fp8":
        s = wf.abs().amax(dim=-1, keepdim=True) / 448.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        return (wf / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown precision {precision!r}")


def act_in(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A linear's input as its product reads it: under fp8, rounded to e4m3
    with one scale per row (absmax / 448), as an fp8 product takes both
    operands; as given otherwise (the weight-only precisions)."""
    if precision != "fp8":
        return x
    s = x.abs().amax(dim=-1, keepdim=True) / 448.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    y = torch.nn.functional.layer_norm(x, (x.shape[-1],), eps=eps) * scale.float()
    return y if bias is None else y + bias.float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + bias, masked) v in fp32. q [B, Sq, H, Dh],
    k/v [B, Sk, H, Dh], mask [B or 1, Sq, Sk] bool (True = attend) or None,
    bias broadcast to [B, H, Sq, Sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = s.masked_fill(~mask[:, None], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def causal_key_mask(lengths: Sequence[int], S: int, device) -> torch.Tensor:
    """[B, S, S]: causal, and no key past a row's own length."""
    ar = torch.arange(S, device=device)
    causal = ar[None, :] <= ar[:, None]
    valid = ar[None, :] < torch.as_tensor(list(lengths), device=device)[:, None]
    return causal[None] & valid[:, None, :]


def row_chunks(lengths: Sequence[int], budget: int) -> List[List[int]]:
    """Row indices in chunks whose padded positions stay within `budget`."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    out: List[List[int]] = []
    for i in order:
        if out and (len(out[-1]) + 1) * lengths[out[-1][0]] <= budget:
            out[-1].append(i)
        else:
            out.append([i])
    return out


def fused_scores(main: torch.Tensor, contrast: Optional[torch.Tensor], alpha: float, beta: float) -> torch.Tensor:
    """The decoding's fused scores [..., V]: the contrastive fusion with its
    plausibility cutoff (-inf where main < log(beta) + max(main)), or the
    main logits alone when there is no contrast branch."""
    if contrast is None:
        return main
    cutoff = math.log(beta) + main.amax(dim=-1, keepdim=True)
    fused = (1.0 + alpha) * main - alpha * contrast
    return fused.masked_fill(main < cutoff, float("-inf"))


def token_gaps(main: torch.Tensor, contrast: Optional[torch.Tensor], tokens: torch.Tensor,
               alpha: float, beta: float) -> torch.Tensor:
    """By how far each chosen token [n] falls short of the reference's
    greedy choice at its position, from the reference's logits main and
    contrast [n, V]: the larger of its shortfall below the plausibility
    cutoff and its fused score's shortfall below the best plausible fused
    score (0 where the reference would pick it too)."""
    tokens = tokens.long()[:, None]
    if contrast is None:
        return (main.amax(dim=-1) - main.gather(-1, tokens)[:, 0]).clamp_min(0)
    cutoff = math.log(beta) + main.amax(dim=-1)
    fused = (1.0 + alpha) * main - alpha * contrast
    best = fused.masked_fill(main < cutoff[:, None], float("-inf")).amax(dim=-1)
    short_cut = (cutoff - main.gather(-1, tokens)[:, 0]).clamp_min(0)
    short_fused = (best - fused.gather(-1, tokens)[:, 0]).clamp_min(0)
    return torch.maximum(short_cut, short_fused)


def diffusion_coefficients(step: int) -> Tuple[float, float]:
    """(sqrt(alpha_bar_t), sqrt(1 - alpha_bar_t)) of VCD's sigmoid beta
    schedule over 1000 steps."""
    betas = 1.0 / (1.0 + np.exp(-np.linspace(-6.0, 6.0, 1000)))
    betas = betas * (0.5e-2 - 1e-5) + 1e-5
    ab = np.cumprod(1.0 - betas)
    return float(np.float32(np.sqrt(ab[step]))), float(np.float32(np.sqrt(1.0 - ab[step])))


def pixels(images_u8: torch.Tensor, eps: Optional[torch.Tensor] = None, noise_step: int = 500) -> torch.Tensor:
    """uint8 [G, 3, H, W] → CLIP-normalized fp32; with eps the diffusion-noised
    copy q(x_t | x_0) at noise_step."""
    x = images_u8.float() / 255.0
    m = torch.tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    s = torch.tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    x = (x - m) / s
    if eps is not None:
        a, b = diffusion_coefficients(noise_step)
        x = a * x + b * eps.float()
    return x
