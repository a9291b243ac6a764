"""Forward-diffusion image noising for Visual Contrastive Decoding (VCD);
torch twin of llava_align_tpu/ops/noise.py.

The schedule is a sigmoid beta ramp over 1000 steps,

    betas      = sigmoid(linspace(-6, 6, 1000)) * (0.5e-2 - 1e-5) + 1e-5
    alpha_bar  = cumprod(1 - betas)
    q(x_t|x_0) = sqrt(alpha_bar_t) * x_0 + sqrt(1 - alpha_bar_t) * eps

`diffusion_schedule` is an exact copy of the JAX package's (numpy). The
noising is one elementwise multiply-add in fp32, cast back to the input's
dtype; it runs outside any kernel of the TPU package, so plain torch is its
port. eps comes from an explicit torch.Generator, or is passed in.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from llava_align_tpu_torch.utils.synthetic import resolve_device

NUM_DIFFUSION_STEPS = 1000


@functools.lru_cache(maxsize=1)
def diffusion_schedule() -> tuple[np.ndarray, np.ndarray]:
    """Returns (sqrt(alpha_bar), sqrt(1 - alpha_bar)), each [1000] float32.

    Computed in float64 then cast, matching torch's float32 evaluation to
    well below float32 resolution.
    """
    betas = 1.0 / (1.0 + np.exp(-np.linspace(-6.0, 6.0, NUM_DIFFUSION_STEPS)))
    betas = betas * (0.5e-2 - 1e-5) + 1e-5
    alpha_bar = np.cumprod(1.0 - betas)
    return (
        np.sqrt(alpha_bar).astype(np.float32),
        np.sqrt(1.0 - alpha_bar).astype(np.float32),
    )


def add_diffusion_noise(
    image,
    noise_step: int,
    *,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """q(x_t | x_0) with t = noise_step in [0, 999], in fp32, cast back to
    the image's dtype. image: a tensor (noised where it lies) or a numpy
    array (moved to `device`: the GPU unless another is named). eps: the
    standard-normal draw, [image shape], else drawn from `generator`."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image)).to(resolve_device(device))
    t = int(noise_step)
    if not 0 <= t < NUM_DIFFUSION_STEPS:
        raise ValueError(f"noise_step {t} outside [0, {NUM_DIFFUSION_STEPS})")
    sqrt_ab, sqrt_1m_ab = diffusion_schedule()
    if eps is None:
        eps = torch.randn(image.shape, generator=generator, device=image.device, dtype=torch.float32)
    elif tuple(eps.shape) != tuple(image.shape):
        raise ValueError(f"eps {tuple(eps.shape)} does not match the image {tuple(image.shape)}")
    out = float(sqrt_ab[t]) * image.float() + float(sqrt_1m_ab[t]) * eps.to(image.device, torch.float32)
    return out.to(image.dtype)
