"""Q-Former, the BLIP-2 querying transformer (torch twin of
llava_align_tpu/models/qformer.py: the instruction-conditioned query
stream InstructBLIP runs, and the stage-1 BLIP-2 paths).

Capability parity: reference experiments/lavis/models/blip2_models/Qformer.py —
BertEmbeddings (word + position for text, learned queries prepended, one
shared LayerNorm), post-LN BERT self-attention over [queries; text],
query-only cross-attention to the image stream every
`cross_attention_freq` layers, and a SPLIT feed-forward:
intermediate_query/output_query for the query positions,
intermediate/output for the text positions. Text ids are clipped to the
vocab and text positions start at 0. The padding mask is an additive fp32
bias (0 or NEG) on the logits, shaped [B, H, 1, Sq, Sk] as `mha` takes it.

Param tree (linears {w [out, in], b [out]}); `layers` is a list of unlike
dicts, a 'cross_attn' entry only on the layers has_cross_attention names:
    embeddings/word [V, D], embeddings/position [P, D], embeddings/ln
    layers[i]/self_attn, layers[i]/cross_attn:
        {query, key, value, out, ln}
    layers[i]/{intermediate, output, output_ln,
               intermediate_query, output_query, output_query_ln}

Stage-1 BLIP-2 (reference blip2_qformer.py): `forward_text` (text-only
bidirectional encode), `forward_queries` (query-only pass that also returns
each layer's self-attention K/V of the queries, the past the LM path
decodes against), `forward_lm` (causal text over that cached query K/V;
text positions start at 0), the MLM head (`lm_head_init`, `lm_logits`) and
`lm_loss_mean` (shifted CE with label smoothing 0.1). A stage-1 tree
carries the head under "head".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import gelu_exact, layer_norm
from llava_align_tpu_torch.utils.synthetic import normal_init, resolve_device

Params = Dict[str, Any]
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    encoder_width: int = 1408  # image stream width (EVA ViT-g)
    cross_attention_freq: int = 2
    query_length: int = 32
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def blip2() -> "QFormerConfig":
        return QFormerConfig()

    @staticmethod
    def tiny(encoder_width: int = 32) -> "QFormerConfig":
        return QFormerConfig(
            vocab_size=128, hidden_size=48, num_layers=3, num_heads=4,
            intermediate_size=96, max_position_embeddings=64,
            encoder_width=encoder_width, cross_attention_freq=2,
            query_length=4, dtype=torch.float32,
        )


def has_cross_attention(cfg: QFormerConfig, layer_num: int) -> bool:
    return layer_num % cfg.cross_attention_freq == 0


def init(cfg: QFormerConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree and scales, drawn from a
    torch.Generator seeded with `seed` on `device` (the GPU unless another
    is named)."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed), device)
    D, F, E, dt = cfg.hidden_size, cfg.intermediate_size, cfg.encoder_width, cfg.dtype

    def dense(out_d, in_d):
        return {"w": w((out_d, in_d), in_d, dt), "b": torch.zeros((out_d,), dtype=dt, device=device)}

    def ln():
        return {"scale": torch.ones((D,), dtype=dt, device=device),
                "bias": torch.zeros((D,), dtype=dt, device=device)}

    def attn_params(kv_dim):
        return {"query": dense(D, D), "key": dense(D, kv_dim), "value": dense(D, kv_dim),
                "out": dense(D, D), "ln": ln()}

    layers: List[Dict[str, Any]] = []
    for i in range(cfg.num_layers):
        lp: Dict[str, Any] = {
            "self_attn": attn_params(D),
            "intermediate": dense(F, D),
            "output": dense(D, F),
            "output_ln": ln(),
            "intermediate_query": dense(F, D),
            "output_query": dense(D, F),
            "output_query_ln": ln(),
        }
        if has_cross_attention(cfg, i):
            lp["cross_attn"] = attn_params(E)
        layers.append(lp)
    return {
        "embeddings": {"word": w((cfg.vocab_size, D), D, dt),
                       "position": w((cfg.max_position_embeddings, D), D, dt), "ln": ln()},
        "layers": layers,
    }


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["w"].t() + p["b"]


def _attn_kv(ap: Params, cfg: QFormerConfig, kv_in: torch.Tensor):
    """Self/cross-attention K, V head-split [B, Sk, H, Dh]."""
    B, Sk, _ = kv_in.shape
    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    return _dense(kv_in, ap["key"]).reshape(B, Sk, H, Dh), _dense(kv_in, ap["value"]).reshape(B, Sk, H, Dh)


def _attend(ap: Params, cfg: QFormerConfig, q_in, k, v, bias, eps: float) -> torch.Tensor:
    """Post-LN BERT attention given K/V: LayerNorm(dense(attn) + q_in)."""
    B, Sq, D = q_in.shape
    H = cfg.num_heads
    q = _dense(q_in, ap["query"]).reshape(B, Sq, H, D // H)
    attn = mha(q, k, v, causal=False, bias=bias).reshape(B, Sq, D)
    out = _dense(attn, ap["out"])
    return layer_norm(out + q_in, ap["ln"]["scale"], ap["ln"]["bias"], eps)


def _bert_attention(ap: Params, cfg: QFormerConfig, q_in, kv_in, mask: Optional[torch.Tensor],
                    eps: float) -> torch.Tensor:
    """Post-LN BERT attention: out = LayerNorm(dense(attn) + q_in).
    mask: [B, Sk] 1 = attend, or None."""
    B, Sq, _ = q_in.shape
    k, v = _attn_kv(ap, cfg, kv_in)
    bias = None
    if mask is not None:
        # an fp32 bias, 0 or NEG (finite), as mha's logits are fp32
        bias = torch.where(mask[:, None, None, None, :].bool(), 0.0, NEG).to(torch.float32)
        bias = bias.expand(B, cfg.num_heads, 1, Sq, kv_in.shape[1])
    return _attend(ap, cfg, q_in, k, v, bias, eps)


def _ffn(x, inter: Params, output: Params, out_ln: Params, eps: float) -> torch.Tensor:
    y = _dense(gelu_exact(_dense(x, inter)), output)
    return layer_norm(y + x, out_ln["scale"], out_ln["bias"], eps)


def forward(
    params: Params,
    cfg: QFormerConfig,
    query_embeds: torch.Tensor,                 # [B, Q, D] learned query tokens
    image_embeds: torch.Tensor,                 # [B, N, E]
    text_ids: Optional[torch.Tensor] = None,    # [B, T]
    text_mask: Optional[torch.Tensor] = None,   # [B, T] 1 = real
) -> torch.Tensor:
    """The full hidden stream [B, Q(+T), D]; callers take [:, :Q]."""
    eps = cfg.layer_norm_eps
    emb = params["embeddings"]
    B, Q, _ = query_embeds.shape
    dev = query_embeds.device

    if text_ids is not None:
        T = text_ids.shape[1]
        text = emb["word"][text_ids.long().clamp(0, cfg.vocab_size - 1)] + emb["position"][:T]
        x = torch.cat([query_embeds.to(text.dtype), text], dim=1)
        if text_mask is None:
            text_mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        mask = torch.cat([torch.ones((B, Q), dtype=text_mask.dtype, device=dev), text_mask], dim=1)
    else:
        x = query_embeds
        mask = torch.ones((B, Q), dtype=torch.int32, device=dev)
    x = layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"], eps)

    for lp in params["layers"]:
        x = _bert_attention(lp["self_attn"], cfg, x, x, mask, eps)
        q_part = x[:, :Q]
        if "cross_attn" in lp:
            q_part = _bert_attention(lp["cross_attn"], cfg, q_part, image_embeds, None, eps)
        q_out = _ffn(q_part, lp["intermediate_query"], lp["output_query"], lp["output_query_ln"], eps)
        if x.shape[1] > Q:
            t_out = _ffn(x[:, Q:], lp["intermediate"], lp["output"], lp["output_ln"], eps)
            x = torch.cat([q_out, t_out], dim=1)
        else:
            x = q_out
    return x


# ---------------------------------------------------------------------------
# stage-1 BLIP-2 paths (text-only encode, cached-query causal LM, MLM head)
# ---------------------------------------------------------------------------


def _embed_text(params: Params, cfg: QFormerConfig, text_ids: torch.Tensor) -> torch.Tensor:
    """Word + position embeddings + the shared LayerNorm; text positions
    start at 0 (the reference subtracts query_length from the past length,
    Qformer.py:859-864)."""
    emb = params["embeddings"]
    T = text_ids.shape[1]
    x = emb["word"][text_ids.long().clamp(0, cfg.vocab_size - 1)] + emb["position"][:T]
    return layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"], cfg.layer_norm_eps)


def forward_text(params: Params, cfg: QFormerConfig, text_ids: torch.Tensor,
                 text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Text-only bidirectional encode → [B, T, D] (blip2_qformer.forward_text:
    the text feed-forward, no cross-attention)."""
    eps = cfg.layer_norm_eps
    x = _embed_text(params, cfg, text_ids)
    for lp in params["layers"]:
        x = _bert_attention(lp["self_attn"], cfg, x, x, text_mask, eps)
        x = _ffn(x, lp["intermediate"], lp["output"], lp["output_ln"], eps)
    return x


def forward_queries(params: Params, cfg: QFormerConfig, query_embeds: torch.Tensor,
                    image_embeds: torch.Tensor) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Query-only pass → (hidden [B, Q, D], per layer the queries'
    self-attention (K, V) [B, Q, H, Dh]) (blip2_qformer.py:101-107)."""
    eps = cfg.layer_norm_eps
    emb = params["embeddings"]
    x = layer_norm(query_embeds, emb["ln"]["scale"], emb["ln"]["bias"], eps)
    kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for lp in params["layers"]:
        k, v = _attn_kv(lp["self_attn"], cfg, x)
        kv.append((k, v))
        x = _attend(lp["self_attn"], cfg, x, k, v, None, eps)
        if "cross_attn" in lp:
            x = _bert_attention(lp["cross_attn"], cfg, x, image_embeds, None, eps)
        x = _ffn(x, lp["intermediate_query"], lp["output_query"], lp["output_query_ln"], eps)
    return x, kv


def forward_lm(params: Params, cfg: QFormerConfig, text_ids: torch.Tensor, text_mask: Optional[torch.Tensor],
               query_kv: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Causal text pass over the cached query K/V → text hidden [B, T, D]:
    each text row attends every query column and the text columns up to
    its own (Qformer.py:743-783), through the TEXT feed-forward."""
    eps = cfg.layer_norm_eps
    B, T = text_ids.shape
    Q = query_kv[0][0].shape[1]
    x = _embed_text(params, cfg, text_ids)
    dev = x.device
    causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    cols = torch.cat([torch.ones((B, T, Q), dtype=torch.bool, device=dev), causal.expand(B, T, T)], dim=-1)
    if text_mask is not None:
        pad = torch.cat([torch.ones((B, Q), dtype=torch.bool, device=dev), text_mask.bool()], dim=1)
        cols = cols & pad[:, None, :]
    bias = torch.where(cols[:, None, None], 0.0, NEG).to(torch.float32)
    bias = bias.expand(B, cfg.num_heads, 1, T, Q + T)
    for (qk, qv), lp in zip(query_kv, params["layers"]):
        k_t, v_t = _attn_kv(lp["self_attn"], cfg, x)
        k = torch.cat([qk.to(k_t.dtype), k_t], dim=1)
        v = torch.cat([qv.to(v_t.dtype), v_t], dim=1)
        x = _attend(lp["self_attn"], cfg, x, k, v, bias, eps)
        x = _ffn(x, lp["intermediate"], lp["output"], lp["output_ln"], eps)
    return x


def lm_head_init(cfg: QFormerConfig, word_embeddings: torch.Tensor, device=None, seed: int = 0) -> Params:
    """BertOnlyMLMHead params (Qformer.py:607-651), the decoder tied to
    `word_embeddings` (the same tensor); converters load
    cls.predictions.decoder.weight in its place."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed), device)
    D, dt = cfg.hidden_size, cfg.dtype
    return {
        "transform": {"w": w((D, D), D, dt), "b": torch.zeros((D,), dtype=dt, device=device)},
        "ln": {"scale": torch.ones((D,), dtype=dt, device=device), "bias": torch.zeros((D,), dtype=dt, device=device)},
        "decoder": word_embeddings,
        "bias": torch.zeros((cfg.vocab_size,), dtype=dt, device=device),
    }


def lm_logits(head: Params, hidden: torch.Tensor) -> torch.Tensor:
    """cls.predictions: dense → gelu → LayerNorm → decoder + bias, fp32."""
    x = gelu_exact(_dense(hidden, head["transform"]))
    x = layer_norm(x, head["ln"]["scale"], head["ln"]["bias"], 1e-12)
    return x.float() @ head["decoder"].float().t() + head["bias"].float()


def lm_loss_mean(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.1) -> torch.Tensor:
    """Shifted next-token CE with label smoothing, the mean over targets
    that are not -100 (Qformer.py:1073-1080)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:].long()
    valid = tgt != -100
    nll = -torch.gather(logp, -1, torch.where(valid, tgt, 0)[..., None])[..., 0]
    tok = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(-1)
    return torch.where(valid, tok, 0.0).sum() / valid.sum().clamp(min=1)
