"""TimeSformer: the divided space-time attention video transformer, ALPRO's
video encoder (torch twin of llava_align_tpu/models/timesformer.py).

Capability parity: the reference's vendored LAVIS TimeSformer
(lavis/models/timesformer/vit.py). Each block runs (1) temporal attention
over the frame axis per spatial location, projected by `temporal_fc`
(vit.py:210-223), (2) spatial attention per frame with the cls token
replicated per frame and frame-averaged on the way out (vit.py:226-249),
(3) an MLP with exact (erf) GELU over all tokens (vit.py:251-260). The
final LayerNorm comes before the TimeSformer wrapper's time average of the
patch tokens (vit.py:459, 596-612).

Patches are carried as [B, N, T, D] (the reference's `(h w t)` order);
both attentions are ops.attention.mha over the folded batch (fp32 logits
and softmax), plain torch: no kernel of the port lies on this path. Layers
are stacked on a leading [L] axis and run in a Python loop.

Param tree (linears {w [out, in], b [out]}):
    cls [1, 1, D], pos [1, 1+N, D], time [1, T, D], patch {w [D, 3, P, P], b [D]},
    layers/{t_ln, ln1, ln2} {scale, bias [L, D]},
    layers/{t_qkv, t_proj, t_fc, qkv, proj, fc1, fc2} {w [L, out, in], b [L, out]},
    final_ln {scale, bias [D]}
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
class TimeSformerConfig:
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 8
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def ffn_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def tiny() -> "TimeSformerConfig":
        return TimeSformerConfig(image_size=32, patch_size=16, num_frames=3, hidden_size=32, num_layers=2,
                                 num_heads=4)


def init(cfg: TimeSformerConfig, device=None, seed: int = 0) -> Params:
    """The JAX init's tree and scales (N(0, 1/fan_in) weights, zero biases,
    unit norms); the random numbers are torch's, from `seed`."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed), device)
    D, F, L, N, T, P, dt = (cfg.hidden_size, cfg.ffn_dim, cfg.num_layers, cfg.num_patches, cfg.num_frames,
                            cfg.patch_size, cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def lin(o, i):
        return {"w": w((L, o, i), i, dt), "b": zeros(L, o)}

    def ln(*lead):
        return {"scale": torch.ones(lead + (D,), dtype=dt, device=device), "bias": zeros(*lead, D)}

    return {
        "cls": w((1, 1, D), D, dt),
        "pos": w((1, N + 1, D), D, dt),
        "time": w((1, T, D), D, dt),
        "patch": {"w": w((D, 3, P, P), 3 * P * P, dt), "b": zeros(D)},
        "layers": {"t_ln": ln(L), "t_qkv": lin(3 * D, D), "t_proj": lin(D, D), "t_fc": lin(D, D),
                   "ln1": ln(L), "qkv": lin(3 * D, D), "proj": lin(D, D),
                   "ln2": ln(L), "fc1": lin(F, D), "fc2": lin(D, F)},
        "final_ln": ln(),
    }


def _lin(h: torch.Tensor, p: Params, li: int) -> torch.Tensor:
    return h @ p["w"][li].t() + p["b"][li]


def _ln(x: torch.Tensor, p: Params, eps: float, li: int) -> torch.Tensor:
    return layer_norm(x, p["scale"][li], p["bias"][li], eps)


def _self_attn(x: torch.Tensor, qkv_p: Params, proj_p: Params, H: int, li: int) -> torch.Tensor:
    """x [B, S, D] → proj(MHA(x)) [B, S, D]; fp32 softmax."""
    B, S, D = x.shape
    q, k, v = _lin(x, qkv_p, li).chunk(3, dim=-1)
    Dh = D // H
    o = mha(q.reshape(B, S, H, Dh), k.reshape(B, S, H, Dh), v.reshape(B, S, H, Dh), causal=False)
    return _lin(o.reshape(B, S, D), proj_p, li)


def _mlp(x: torch.Tensor, lay: Params, eps: float, li: int) -> torch.Tensor:
    h = _ln(x, lay["ln2"], eps, li)
    return x + _lin(gelu_exact(_lin(h, lay["fc1"], li)), lay["fc2"], li)


def forward_features(params: Params, cfg: TimeSformerConfig, pixels: torch.Tensor, *,
                     pool_frames: bool = True) -> torch.Tensor:
    """pixels [B, 3, T, H, W] → [B, 1+N, D] (the patch tokens averaged over
    the frames, ALPRO's surface) or, with pool_frames=False, the full
    [B, 1+N*T, D] in the reference's (n t) layout."""
    B = pixels.shape[0]
    D, H, T, N, eps = cfg.hidden_size, cfg.num_heads, cfg.num_frames, cfg.num_patches, cfg.layer_norm_eps
    # [(B T), 3, H, W]: the JAX package reshapes to pixels.shape[-3:] =
    # (T, H, W) here, which is right only when T == 3
    frames = pixels.transpose(1, 2).reshape(B * T, 3, *pixels.shape[-2:]).to(cfg.dtype)
    pw = params["patch"]["w"]
    x = patchify(frames, cfg.patch_size) @ pw.reshape(D, -1).t() + params["patch"]["b"]  # [(B T), N, D]
    x = x + params["pos"][:, 1:]
    # the cls rows are identical across (b, t) here (vit.py:414-433)
    cls = (params["cls"] + params["pos"][:, :1]).expand(B, 1, D)
    xp = x.reshape(B, T, N, D).transpose(1, 2) + params["time"][0]  # [B, N, T, D]
    lay = params["layers"]
    for li in range(cfg.num_layers):
        # temporal attention over T per (b, n)
        h = _ln(xp, lay["t_ln"], eps, li)
        a = _self_attn(h.reshape(B * N, T, D), lay["t_qkv"], lay["t_proj"], H, li)
        xt = xp + _lin(a.reshape(B, N, T, D), lay["t_fc"], li)
        # spatial attention per (b, t), the cls row replicated per frame
        cls_rep = cls[:, None].expand(B, T, 1, D).reshape(B * T, 1, D)
        xs = torch.cat([cls_rep, xt.transpose(1, 2).reshape(B * T, N, D)], dim=1)  # [(B T), 1+N, D]
        a = _self_attn(_ln(xs, lay["ln1"], eps, li), lay["qkv"], lay["proj"], H, li)
        cls = cls + a[:, 0].reshape(B, T, D).mean(dim=1, keepdim=True)  # frame-averaged
        xp = xt + a[:, 1:].reshape(B, T, N, D).transpose(1, 2)
        # the MLP over every token
        cls, xp = _mlp(cls, lay, eps, li), _mlp(xp, lay, eps, li)
    fl = params["final_ln"]
    cls = layer_norm(cls, fl["scale"], fl["bias"], eps)
    xp = layer_norm(xp, fl["scale"], fl["bias"], eps)
    if pool_frames:
        return torch.cat([cls, xp.mean(dim=2)], dim=1)  # [B, 1+N, D]
    return torch.cat([cls, xp.reshape(B, N * T, D)], dim=1)  # [B, 1+N*T, D], (n t)
