"""CLIP contrastive model: a ViT vision tower and a causal text transformer
(torch twin of llava_align_tpu/models/clip.py).

Capability parity: the reference's vendored LAVIS CLIP family
(lavis/models/clip_models/model.py, open_clip style, registered as "clip"
and "clip_feature_extractor"): encode_image / encode_text with EOT-argmax
pooling, the symmetric InfoNCE of loss.py ClipLoss, extract_features, the
zero-shot classifier from prompt templates and zero-shot predict. The
ViT-B/L OpenAI variants use QuickGELU.

The vision tower is models/clip_vit run to its last layer, then the cls
state through post_ln and visual_proj. The text tower is a pre-LN stack
with a causal mask through ops.attention.mha (fp32 softmax).

Param tree: visual (models/clip_vit), visual_proj [Dv, E],
token_embedding [V, D], positional_embedding [ctx, D],
text_layers/{ln1, ln2} {scale, bias [L, D]},
text_layers/{qkv, o, fc1, fc2} {w [L, out, in], b [L, out]},
ln_final {scale, bias}, text_proj [D, E], logit_scale (0-d fp32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from llava_align_tpu_torch.config import ClipVisionConfig
from llava_align_tpu_torch.models import clip_vit
from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import layer_norm, quick_gelu
from llava_align_tpu_torch.utils.synthetic import normal_init, random_clip_vision, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    num_heads: int = 8
    num_layers: int = 12
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(vocab_size: int = 64) -> "ClipTextConfig":
        return ClipTextConfig(context_length=16, vocab_size=vocab_size, width=32, num_heads=4, num_layers=2)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    vision: ClipVisionConfig = dataclasses.field(default_factory=lambda: ClipVisionConfig(
        image_size=224, patch_size=32, hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12,
        select_layer=-1, select_feature="cls_patch", dtype=torch.float32))
    text: ClipTextConfig = dataclasses.field(default_factory=ClipTextConfig)
    embed_dim: int = 512

    @staticmethod
    def tiny(vocab_size: int = 64) -> "ClipConfig":
        return ClipConfig(
            vision=ClipVisionConfig(image_size=32, patch_size=16, hidden_size=32, intermediate_size=64,
                                    num_layers=2, num_heads=4, select_layer=-1, select_feature="cls_patch",
                                    dtype=torch.float32),
            text=ClipTextConfig.tiny(vocab_size),
            embed_dim=16,
        )


def init(cfg: ClipConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree and scales, drawn from
    torch.Generators seeded from `seed` on `device` (the GPU unless another
    is named); logit_scale = log(1 / 0.07)."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 1), device)
    t = cfg.text
    D, F, L, E, dt = t.width, 4 * t.width, t.num_layers, cfg.embed_dim, t.dtype

    def lin(o, i):
        return {"w": w((L, o, i), i, dt), "b": torch.zeros((L, o), dtype=dt, device=device)}

    def ln(*lead):
        return {"scale": torch.ones(lead + (D,), dtype=dt, device=device),
                "bias": torch.zeros(lead + (D,), dtype=dt, device=device)}

    return {
        "visual": random_clip_vision(cfg.vision, device,
                                     normal_init(torch.Generator(device=device).manual_seed(seed), device)),
        "visual_proj": w((cfg.vision.hidden_size, E), cfg.vision.hidden_size, dt),
        "token_embedding": w((t.vocab_size, D), D, dt),
        "positional_embedding": w((t.context_length, D), D, dt),
        "text_layers": {"ln1": ln(L), "qkv": lin(3 * D, D), "o": lin(D, D), "ln2": ln(L), "fc1": lin(F, D),
                        "fc2": lin(D, F)},
        "ln_final": ln(),
        "text_proj": w((D, E), D, dt),
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device),
    }


def encode_image(params: Params, cfg: ClipConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] → [B, embed_dim] (model.py: cls → ln_post → proj)."""
    x = clip_vit.forward_features(params["visual"], cfg.vision, pixels)
    post = params["visual"]["post_ln"]
    return layer_norm(x[:, 0], post["scale"], post["bias"], cfg.vision.layer_norm_eps) @ params["visual_proj"]


def text_transformer(params: Params, cfg: ClipConfig, embeds: torch.Tensor) -> torch.Tensor:
    """The causal text stack on built embeddings (token + position) → the
    hidden [B, S, D] after ln_final."""
    t = cfg.text
    B, S, _ = embeds.shape
    D, H, eps = t.width, t.num_heads, t.layer_norm_eps
    lay = params["text_layers"]
    x = embeds

    def lin(h, name, li):
        return h @ lay[name]["w"][li].t() + lay[name]["b"][li]

    for li in range(t.num_layers):
        h = layer_norm(x, lay["ln1"]["scale"][li], lay["ln1"]["bias"][li], eps)
        q, k, v = lin(h, "qkv", li).chunk(3, dim=-1)
        a = mha(q.reshape(B, S, H, D // H), k.reshape(B, S, H, D // H), v.reshape(B, S, H, D // H), causal=True)
        x = x + lin(a.reshape(B, S, D), "o", li)
        h = layer_norm(x, lay["ln2"]["scale"][li], lay["ln2"]["bias"][li], eps)
        x = x + lin(quick_gelu(lin(h, "fc1", li)), "fc2", li)
    return layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"], eps)


def encode_text(params: Params, cfg: ClipConfig, ids: torch.Tensor) -> torch.Tensor:
    """[B, ctx] → [B, embed_dim], pooled at the EOT position = argmax(ids)."""
    B, S = ids.shape
    ids = ids.long()
    x = text_transformer(params, cfg, params["token_embedding"][ids] + params["positional_embedding"][:S])
    pooled = x[torch.arange(B, device=ids.device), ids.argmax(-1)]
    return pooled @ params["text_proj"]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def extract_features(params: Params, cfg: ClipConfig, pixels: Optional[torch.Tensor] = None,
                     text_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """model.py extract_features: raw and normalized projections."""
    out: Dict[str, torch.Tensor] = {}
    if pixels is not None:
        e = encode_image(params, cfg, pixels)
        out["image_embeds"], out["image_embeds_proj"] = e, _norm(e)
    if text_ids is not None:
        e = encode_text(params, cfg, text_ids)
        out["text_embeds"], out["text_embeds_proj"] = e, _norm(e)
    return out


def contrastive_loss(params: Params, cfg: ClipConfig, pixels: torch.Tensor,
                     text_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ClipLoss: symmetric InfoNCE over the batch, the loss logits in fp32
    (autocast's softmax policy under bf16)."""
    img = _norm(encode_image(params, cfg, pixels))
    txt = _norm(encode_text(params, cfg, text_ids))
    scale = params["logit_scale"].exp()
    labels = torch.arange(img.shape[0], device=img.device)
    logits_i = (scale * img @ txt.t()).float()
    logits_t = (scale * txt @ img.t()).float()
    li = torch.nn.functional.cross_entropy(logits_i, labels)
    lt = torch.nn.functional.cross_entropy(logits_t, labels)
    return {"loss": (li + lt) / 2, "logit_scale_exp": scale}


@torch.inference_mode()
def zero_shot_classifier(params: Params, cfg: ClipConfig, classnames: Sequence[str],
                         templates: Sequence[Callable[[str], str]],
                         tokenize: Callable[[List[str]], np.ndarray]) -> torch.Tensor:
    """Per class, every template encoded and normalized, averaged and
    normalized again → [embed_dim, n_classes]."""
    dev = params["token_embedding"].device
    weights = []
    for name in classnames:
        ids = torch.from_numpy(np.asarray(tokenize([tpl(name) for tpl in templates]))).to(dev)
        emb = _norm(encode_text(params, cfg, ids)).mean(0)
        weights.append(emb / torch.linalg.vector_norm(emb))
    return torch.stack(weights, dim=1)


def zero_shot_predict(params: Params, cfg: ClipConfig, pixels: torch.Tensor,
                      classifier: torch.Tensor) -> torch.Tensor:
    """→ [B, n_classes] logits (x 100, as the reference)."""
    return 100.0 * _norm(encode_image(params, cfg, pixels)) @ classifier


@torch.inference_mode()
def compute_sim_matrix(params: Params, cfg: ClipConfig, pixels: torch.Tensor, text_ids: torch.Tensor):
    """Retrieval similarity: ITC alone (CLIP has no ITM re-ranker)."""
    feats = extract_features(params, cfg, pixels=pixels, text_ids=text_ids)
    sims = feats["image_embeds_proj"].float().cpu().numpy() @ feats["text_embeds_proj"].float().cpu().numpy().T
    return sims, sims.T


# a representative subset of the 80 openai_imagenet_template prompts, as in
# the JAX package
DEFAULT_PROMPT_TEMPLATES: List[Callable[[str], str]] = [
    lambda c: f"a photo of a {c}.",
    lambda c: f"a bad photo of a {c}.",
    lambda c: f"a photo of many {c}.",
    lambda c: f"a photo of the large {c}.",
    lambda c: f"a photo of the small {c}.",
    lambda c: f"a cropped photo of a {c}.",
    lambda c: f"a close-up photo of a {c}.",
    lambda c: f"a black and white photo of a {c}.",
]
