"""CLIP ViT vision tower (torch twin of llava_align_tpu/models/clip_vit.py).

Feature selection as the reference clip_encoder.py:29-37: hidden_states[k]
is the residual stream after k encoder layers, before the post-layernorm,
so select_layer=-2 runs num_layers-1 layers.

Param tree — the JAX layout, linear kernels [in, out] used as y @ kernel:
    cls            [D]
    patch_embed    [P*P*3, D]
    pos_embed      [1+N, D]
    pre_ln         {scale[D], bias[D]}
    layers/ln1     {scale[L,D], bias[L,D]}
    layers/{q,k,v,o}        kernel [L,D,D], bias [L,D]
    layers/ln2     {scale[L,D], bias[L,D]}
    layers/fc1     kernel [L,D,F], bias [L,F]
    layers/fc2     kernel [L,F,D], bias [L,D]
    post_ln        {scale[D], bias[D]}   (unused when select_layer < 0)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from llava_align_tpu_torch.config import ClipVisionConfig
from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import layer_norm, quick_gelu

Params = Dict[str, Any]


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, 3, H, W] → [B, N, 3*P*P], channel-major within a patch (a torch
    Conv2d(3, D, P, stride=P) kernel flattened)."""
    B, C, H, W = images.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = images.reshape(B, C, gh, P, gw, P).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gw, C * P * P)


def forward_features(params: Params, cfg: ClipVisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] normalized → 'patch' [B, N, D] or 'cls_patch'
    [B, 1+N, D] features."""
    B = images.shape[0]
    D, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads

    patches = patchify(images.to(cfg.dtype), cfg.patch_size)
    x = (patches @ params["patch_embed"]).to(cfg.dtype)
    cls = params["cls"].expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"], cfg.layer_norm_eps)

    sl = cfg.select_layer
    run_layers = L + 1 + sl if sl < 0 else sl
    if not 0 < run_layers <= L:
        raise ValueError(f"select_layer {sl} out of range for {L} layers")

    lay = params["layers"]
    for li in range(run_layers):
        def lin(name, y):
            return y @ lay[name]["kernel"][li] + lay[name]["bias"][li]

        y = layer_norm(x, lay["ln1"]["scale"][li], lay["ln1"]["bias"][li], cfg.layer_norm_eps)
        S = y.shape[1]
        q = lin("q", y).reshape(B, S, H, D // H)
        k = lin("k", y).reshape(B, S, H, D // H)
        v = lin("v", y).reshape(B, S, H, D // H)
        attn = mha(q, k, v, causal=False).reshape(B, S, D)
        x = x + lin("o", attn)
        y = layer_norm(x, lay["ln2"]["scale"][li], lay["ln2"]["bias"][li], cfg.layer_norm_eps)
        x = x + lin("fc2", quick_gelu(lin("fc1", y)))

    if cfg.select_feature == "patch":
        return x[:, 1:]
    if cfg.select_feature == "cls_patch":
        return x
    raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
