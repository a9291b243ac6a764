"""InstructBLIP (blip2_vicuna_instruct): EVA-ViT-g → ln_vision →
instruction-conditioned Q-Former (32 queries) → llm_proj → Vicuna (LLaMA)
decoder (torch twin of llava_align_tpu/models/instructblip.py).

Capability parity: reference experiments/lavis/models/blip2_models/
blip2_vicuna_instruct.py generate: image → ln_vision(visual) →
Qformer.bert(text, queries, cross-attention to the image) → llm_proj of
the first 32 positions, prepended to the Vicuna token embeddings. The VCD
branch is a second embedding stream encoded from the noised image: the
contrast works on EMBEDDINGS, not pixels.

`encode` gives the 32 projected query embeddings; the decode engine takes
them as the image features (precomputed_feats) through the splice plan
([sentinel] + prompt ids, num_image_tokens = 32).

Param tree: visual (models/eva_vit), ln_vision {scale, bias}, query_tokens
[Q, Dq], qformer (models/qformer), llm_proj {w [Dt, Dq], b [Dt]}, llama
(models/llama).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from llava_align_tpu_torch.config import LlamaConfig
from llava_align_tpu_torch.models import eva_vit, qformer
from llava_align_tpu_torch.models.eva_vit import EvaVitConfig
from llava_align_tpu_torch.models.qformer import QFormerConfig
from llava_align_tpu_torch.ops.layers import layer_norm
from llava_align_tpu_torch.utils.synthetic import build_random_llama_params, normal_init, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class InstructBlipConfig:
    vision: EvaVitConfig = dataclasses.field(default_factory=EvaVitConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    num_query_tokens: int = 32

    @staticmethod
    def vicuna7b() -> "InstructBlipConfig":
        return InstructBlipConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "InstructBlipConfig":
        vision = EvaVitConfig.tiny()
        return InstructBlipConfig(
            vision=vision,
            qformer=QFormerConfig.tiny(encoder_width=vision.width),
            text=LlamaConfig.tiny(vocab_size),
            num_query_tokens=QFormerConfig.tiny().query_length,
        )


def init(cfg: InstructBlipConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree and scales on `device` (the
    GPU unless another is named); each part draws from its own
    torch.Generator, seeded from `seed`."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 3), device)
    D_q, D_t, W = cfg.qformer.hidden_size, cfg.text.hidden_size, cfg.vision.width
    vdt = cfg.vision.dtype
    return {
        "visual": eva_vit.init(cfg.vision, device, seed),
        "ln_vision": {"scale": torch.ones((W,), dtype=vdt, device=device),
                      "bias": torch.zeros((W,), dtype=vdt, device=device)},
        # N(0, 0.02): fan_in 2500
        "query_tokens": w((cfg.num_query_tokens, D_q), 2500, cfg.qformer.dtype),
        "qformer": qformer.init(cfg.qformer, device, seed + 1),
        "llm_proj": {"w": w((D_t, D_q), D_q, cfg.text.dtype),
                     "b": torch.zeros((D_t,), dtype=cfg.text.dtype, device=device)},
        "llama": build_random_llama_params(cfg.text, device=device, seed=seed + 2),
    }


def encode(
    params: Params,
    cfg: InstructBlipConfig,
    images: torch.Tensor,                              # [B, 3, H, W] normalized
    qformer_text_ids: Optional[torch.Tensor] = None,   # [B, T] BERT-tokenized prompt
    qformer_text_mask: Optional[torch.Tensor] = None,  # [B, T]
) -> torch.Tensor:
    """→ inputs_llm [B, num_query_tokens, text hidden] in the text dtype
    (reference blip2_vicuna_instruct.py:330-366)."""
    feats = eva_vit.forward(params["visual"], cfg.vision, images)
    feats = layer_norm(feats, params["ln_vision"]["scale"], params["ln_vision"]["bias"],
                       cfg.vision.layer_norm_eps)
    B = images.shape[0]
    qt = params["query_tokens"]
    queries = qt.expand(B, cfg.num_query_tokens, qt.shape[-1])
    hidden = qformer.forward(params["qformer"], cfg.qformer, queries, feats.to(cfg.qformer.dtype),
                             text_ids=qformer_text_ids, text_mask=qformer_text_mask)
    q_out = hidden[:, : cfg.num_query_tokens]
    w, b = params["llm_proj"]["w"], params["llm_proj"]["b"]
    return q_out.to(w.dtype) @ w.t() + b
