"""Qwen-VL visual encoder: OpenCLIP-style ViT + perceiver Resampler (torch
twin of llava_align_tpu/models/qwen_vit.py).

Capability parity: reference experiments/Qwen_VL/visual.py —
VisionTransformer (bias-free conv patchify, a 256-entry position table
bicubic-interpolated to the patch grid, ln_pre, pre-LN GELU blocks with a
per-head packed in_proj), Resampler (learned queries with fixed 2D sin-cos
position tables, cross-attention through a torch-style MultiheadAttention),
ln_post and the output projection. The position tables are interpolated to
the target grid when the tree is built or converted, not per forward.
Attention is the plain `mha` (the JAX package's mha_xla): not causal, and
the tower's Dh is 104.

Param tree (linear kernels [out, in], as models/qwen):
    conv          [width, 3*P*P]
    pos_embed     [N, width]         (already at the target grid)
    ln_pre / ln_post {scale, bias}
    layers/ln_1 {scale[L,W], bias}, layers/in_proj {w [L,3W,W], b [L,3W]},
    layers/out_proj {w [L,W,W], b}, layers/ln_2, layers/c_fc {w [L,F,W], b},
    layers/c_proj {w [L,W,F], b}
    resampler/query [Q, E], resampler/pos_q [Q, E], resampler/pos_kv [N, E],
    resampler/kv_proj [E, W], resampler/ln_q {scale, bias}, resampler/ln_kv,
    resampler/in_proj {w [3E,E], b}, resampler/out_proj {w [E,E], b}
    proj          [E, E_out]
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llava_align_tpu_torch.models.clip_vit import patchify
from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import gelu_exact, layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    num_layers: int = 48
    num_heads: int = 16
    mlp_ratio: float = 4.9231
    n_queries: int = 256
    output_dim: int = 4096
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid**2

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)

    @staticmethod
    def qwen_vl() -> "QwenVisionConfig":
        return QwenVisionConfig()

    @staticmethod
    def tiny() -> "QwenVisionConfig":
        return QwenVisionConfig(
            image_size=56, patch_size=14, width=32, num_layers=2, num_heads=2,
            mlp_ratio=2.0, n_queries=4, output_dim=48, dtype=torch.float32,
        )


def sincos_2d_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2D sin-cos position table [grid^2, embed_dim] (reference
    visual.py:42-89; the w coordinate first in the meshgrid)."""

    def one_dim(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first
    emb_h = one_dim(embed_dim // 2, grid[0])
    emb_w = one_dim(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def interpolate_pos_embed(abs_pos: np.ndarray, tgt_len: int) -> np.ndarray:
    """Bicubic grid interpolation [S*S, C] → [T*T, C] by
    F.interpolate(mode='bicubic', align_corners=False), in fp32 on the host
    (reference visual.py:23-39)."""
    src = int(math.sqrt(abs_pos.shape[0]))
    tgt = int(math.sqrt(tgt_len))
    if src == tgt:
        return abs_pos
    t = torch.from_numpy(np.asarray(abs_pos, np.float32))
    t = t.reshape(1, src, src, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(tgt, tgt), mode="bicubic", align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(tgt * tgt, -1).numpy()


def _lin(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = h @ w.t()
    return out if b is None else out + b


def _resampler(params: Params, cfg: QwenVisionConfig, x: torch.Tensor) -> torch.Tensor:
    """Cross-attend the Q learned queries over the N patch features
    (reference visual.py:139-153): E // 128 heads, in_proj the [q; k; v]
    block split of torch's MultiheadAttention; the keys carry the position
    table, the values do not."""
    rp = params["resampler"]
    B = x.shape[0]
    E = cfg.output_dim
    H = max(E // 128, 1)
    eps = cfg.layer_norm_eps

    kv = layer_norm(_lin(x, rp["kv_proj"]), rp["ln_kv"]["scale"], rp["ln_kv"]["bias"], eps)  # [B, N, E]
    q = layer_norm(rp["query"], rp["ln_q"]["scale"], rp["ln_q"]["bias"], eps)  # [Q, E]
    q_in = q + rp["pos_q"].to(q.dtype)
    k_in = kv + rp["pos_kv"].to(kv.dtype)

    wq, wk, wv = rp["in_proj"]["w"].chunk(3, dim=0)
    bq, bk, bv = rp["in_proj"]["b"].chunk(3, dim=0)
    Dh = E // H
    qh = _lin(q_in, wq, bq)[None].expand(B, -1, -1).reshape(B, -1, H, Dh)
    kh = _lin(k_in, wk, bk).reshape(B, -1, H, Dh)
    vh = _lin(kv, wv, bv).reshape(B, -1, H, Dh)
    attn = mha(qh, kh, vh, causal=False).reshape(B, -1, E)
    return _lin(attn, rp["out_proj"]["w"], rp["out_proj"]["b"])


def forward(params: Params, cfg: QwenVisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] normalized → [B, n_queries, output_dim]."""
    B = images.shape[0]
    W, H = cfg.width, cfg.num_heads
    eps = cfg.layer_norm_eps

    x = _lin(patchify(images.to(cfg.dtype), cfg.patch_size), params["conv"])  # [B, N, W]
    x = x + params["pos_embed"].to(x.dtype)
    x = layer_norm(x, params["ln_pre"]["scale"], params["ln_pre"]["bias"], eps)

    lay = params["layers"]
    for li in range(cfg.num_layers):
        y = layer_norm(x, lay["ln_1"]["scale"][li], lay["ln_1"]["bias"][li], eps)
        S = y.shape[1]
        # in_proj packed PER HEAD: [H, (q, k, v), Dh] (reference
        # visual.py:196-204), not torch MHA's [q; k; v] blocks
        qkv = _lin(y, lay["in_proj"]["w"][li], lay["in_proj"]["b"][li]).reshape(B, S, H, 3, W // H)
        q, k, v = (qkv[..., j, :].contiguous() for j in range(3))
        attn = mha(q, k, v, causal=False).reshape(B, S, W)
        x = x + _lin(attn, lay["out_proj"]["w"][li], lay["out_proj"]["b"][li])
        y = layer_norm(x, lay["ln_2"]["scale"][li], lay["ln_2"]["bias"][li], eps)
        y = gelu_exact(_lin(y, lay["c_fc"]["w"][li], lay["c_fc"]["b"][li]))
        x = x + _lin(y, lay["c_proj"]["w"][li], lay["c_proj"]["b"][li])

    x = _resampler(params, cfg, x)  # [B, Q, E]
    x = layer_norm(x, params["ln_post"]["scale"], params["ln_post"]["bias"], eps)
    return x @ params["proj"].to(x.dtype)
