"""EVA-CLIP ViT-g vision encoder, InstructBLIP's tower (torch twin of
llava_align_tpu/models/eva_vit.py).

Capability parity: reference experiments/lavis/models/eva_vit.py —
attention with a q/v-only qkv bias ([q_bias, 0, v_bias]), pre-LN blocks,
the patch conv as a matmul, cls token + absolute position embeddings, and NO
final norm (InstructBLIP applies ln_vision outside the tower). The BLIP-2
config is create_eva_vit_g: patch 14, width 1408, depth 39, 16 heads, mlp
ratio 4.3637, eps 1e-6. Attention is the plain `mha` (the JAX package's
mha_xla), not causal; the tower's Dh is 88.

Param tree (linear weights [out, in], stacked on a leading layer axis, as
in the JAX package):
    patch_embed   {w [W, 3*P*P], b [W]}
    cls [W], pos_embed [1+N, W]
    layers/norm1, layers/norm2   {scale [L, W], bias [L, W]}
    layers/qkv_w [L, 3W, W], layers/q_bias [L, W], layers/v_bias [L, W]
    layers/proj  {w [L, W, W], b [L, W]}
    layers/fc1   {w [L, F, W], b [L, F]}, layers/fc2 {w [L, W, F], b [L, W]}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from llava_align_tpu_torch.models.clip_vit import patchify
from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import gelu_exact, layer_norm
from llava_align_tpu_torch.utils.synthetic import normal_init, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EvaVitConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    num_layers: int = 39
    num_heads: int = 16
    mlp_ratio: float = 4.3637
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)

    @staticmethod
    def eva_vit_g(image_size: int = 224) -> "EvaVitConfig":
        return EvaVitConfig(image_size=image_size)

    @staticmethod
    def tiny() -> "EvaVitConfig":
        return EvaVitConfig(
            image_size=28, patch_size=14, width=32, num_layers=2, num_heads=2,
            mlp_ratio=2.0, dtype=torch.float32,
        )


def init(cfg: EvaVitConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree and scales (N(0, 1/fan_in)
    weights, zero biases, unit norms), drawn from a torch.Generator seeded
    with `seed` on `device` (the GPU unless another is named)."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed), device)
    W, F, L, P, N, dt = cfg.width, cfg.mlp_width, cfg.num_layers, cfg.patch_size, cfg.num_patches, cfg.dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ln():
        return {"scale": torch.ones((L, W), dtype=dt, device=device), "bias": zeros(L, W)}

    return {
        "patch_embed": {"w": w((W, 3 * P * P), 3 * P * P, dt), "b": zeros(W)},
        "cls": w((W,), W, dt),
        "pos_embed": w((1 + N, W), W, dt),
        "layers": {
            "norm1": ln(),
            "qkv_w": w((L, 3 * W, W), W, dt),
            "q_bias": zeros(L, W),
            "v_bias": zeros(L, W),
            "proj": {"w": w((L, W, W), W, dt), "b": zeros(L, W)},
            "norm2": ln(),
            "fc1": {"w": w((L, F, W), W, dt), "b": zeros(L, F)},
            "fc2": {"w": w((L, W, F), F, dt), "b": zeros(L, W)},
        },
    }


def _lin(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return h @ w.t() + b


def forward(params: Params, cfg: EvaVitConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] normalized → [B, 1+N, width] (cls + patches, no
    final norm: the reference's forward_features returns the raw stream)."""
    B = images.shape[0]
    W, H, eps = cfg.width, cfg.num_heads, cfg.layer_norm_eps

    pe = params["patch_embed"]
    x = _lin(patchify(images.to(cfg.dtype), cfg.patch_size), pe["w"], pe["b"])
    cls = params["cls"].expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(cfg.dtype)

    lay = params["layers"]
    for li in range(cfg.num_layers):
        y = layer_norm(x, lay["norm1"]["scale"][li], lay["norm1"]["bias"][li], eps)
        q_bias = lay["q_bias"][li]
        qkv_bias = torch.cat([q_bias, torch.zeros_like(q_bias), lay["v_bias"][li]])
        q, k, v = _lin(y, lay["qkv_w"][li], qkv_bias).chunk(3, dim=-1)
        S = y.shape[1]
        attn = mha(q.reshape(B, S, H, W // H), k.reshape(B, S, H, W // H), v.reshape(B, S, H, W // H),
                   causal=False).reshape(B, S, W)
        x = x + _lin(attn, lay["proj"]["w"][li], lay["proj"]["b"][li])
        y = layer_norm(x, lay["norm2"]["scale"][li], lay["norm2"]["bias"][li], eps)
        y = gelu_exact(_lin(y, lay["fc1"]["w"][li], lay["fc1"]["b"][li]))
        x = x + _lin(y, lay["fc2"]["w"][li], lay["fc2"]["b"][li])
    return x
