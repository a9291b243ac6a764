"""BLIP-2: the stage-1 Q-Former model (Blip2Qformer / Blip2ITM) and the
LM-backed variants Blip2-OPT and Blip2-T5 (torch twin of the serving and
evaluation functions of llava_align_tpu/models/blip2.py).

Capability parity: reference lavis/models/blip2_models/blip2.py
(compute_sim_matrix), blip2_qformer.py (feature extraction, captioning),
blip2_image_text_matching.py (itm / itc heads), blip2_opt.py / blip2_t5.py
(query-only Q-Former + a frozen LM with the query embeddings as its
prefix), blip2_t5_instruct.py (text-conditioned Q-Former + Flan-T5,
per-candidate loss ranking).

  image → EVA-ViT-g → ln_vision → Q-Former (32 queries) → proj → LM prefix

The rankings (compute_sim_matrix's shortlists) are numpy argsorts of host
copies, as in the JAX version. The caption loop (greedy_lm_decode) and
t5's generate are host loops, one read a step. The training losses:
pretrain_forward (stage 1: ITC + ITM with hard negatives + the captioning
LM), opt_forward_loss and t5_forward_loss; hard negatives are drawn from a
torch.Generator unless `neg_idx` hands the draw in.

Param trees: visual (models/eva_vit), ln_vision {scale, bias},
query_tokens [Q, Dq], qformer (models/qformer), then
    OPT / T5:  proj {w [Dt, Dq], b [Dt]}, lm (models/opt or models/t5)
    stage 1:   qformer/head (the MLM head), vision_proj, text_proj
               {w [E, Dq], b [E]}, itm_head {w [2, Dq], b [2]}, temp (0-d fp32)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.models import eva_vit, opt, qformer, t5
from llava_align_tpu_torch.models.eva_vit import EvaVitConfig
from llava_align_tpu_torch.models.opt import OptConfig
from llava_align_tpu_torch.models.qformer import QFormerConfig
from llava_align_tpu_torch.models.t5 import T5Config
from llava_align_tpu_torch.ops.layers import layer_norm, sample_hard_negative_indices
from llava_align_tpu_torch.utils.synthetic import (
    build_random_opt_params,
    build_random_t5_params,
    normal_init,
    resolve_device,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Blip2OptConfig:
    vision: EvaVitConfig = dataclasses.field(default_factory=EvaVitConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    text: OptConfig = dataclasses.field(default_factory=OptConfig)
    num_query_tokens: int = 32

    @staticmethod
    def tiny(vocab_size: int = 256) -> "Blip2OptConfig":
        vision = EvaVitConfig.tiny()
        return Blip2OptConfig(vision=vision, qformer=QFormerConfig.tiny(encoder_width=vision.width),
                              text=OptConfig.tiny(vocab_size), num_query_tokens=QFormerConfig.tiny().query_length)


@dataclasses.dataclass(frozen=True)
class Blip2T5Config:
    vision: EvaVitConfig = dataclasses.field(default_factory=EvaVitConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    text: T5Config = dataclasses.field(default_factory=T5Config)
    num_query_tokens: int = 32

    @staticmethod
    def tiny(vocab_size: int = 128) -> "Blip2T5Config":
        vision = EvaVitConfig.tiny()
        return Blip2T5Config(vision=vision, qformer=QFormerConfig.tiny(encoder_width=vision.width),
                             text=T5Config.tiny(vocab_size), num_query_tokens=QFormerConfig.tiny().query_length)


@dataclasses.dataclass(frozen=True)
class Blip2QformerConfig:
    """First-stage BLIP-2 (reference blip2_qformer.py:45-88)."""

    vision: EvaVitConfig = dataclasses.field(default_factory=EvaVitConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    num_query_tokens: int = 32
    embed_dim: int = 256
    max_txt_len: int = 32

    @staticmethod
    def tiny(vocab_size: int = 128) -> "Blip2QformerConfig":
        vision = EvaVitConfig.tiny()
        return Blip2QformerConfig(vision=vision, qformer=QFormerConfig.tiny(encoder_width=vision.width),
                                  num_query_tokens=QFormerConfig.tiny().query_length, embed_dim=16)


def _init_vision_side(cfg, device, seed: int, w) -> Params:
    """visual, ln_vision, query_tokens (N(0, 0.02)) and the Q-Former."""
    W = cfg.vision.width
    vdt = cfg.vision.dtype
    return {
        "visual": eva_vit.init(cfg.vision, device, seed),
        "ln_vision": {"scale": torch.ones((W,), dtype=vdt, device=device),
                      "bias": torch.zeros((W,), dtype=vdt, device=device)},
        # N(0, 0.02): fan_in 2500
        "query_tokens": w((cfg.num_query_tokens, cfg.qformer.hidden_size), 2500, cfg.qformer.dtype),
        "qformer": qformer.init(cfg.qformer, device, seed + 1),
    }


def _init_lm_backed(cfg, device, seed: int, lm_width: int, build_lm) -> Params:
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 3), device)
    D_q, dt = cfg.qformer.hidden_size, cfg.text.dtype
    out = _init_vision_side(cfg, device, seed, w)
    out["proj"] = {"w": w((lm_width, D_q), D_q, dt), "b": torch.zeros((lm_width,), dtype=dt, device=device)}
    out["lm"] = build_lm(cfg.text, device, seed + 2)
    return out


def init_opt(cfg: Blip2OptConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init_opt's tree and scales on `device`
    (the GPU unless another is named); each part draws from its own
    torch.Generator, seeded from `seed` (as instructblip.init)."""
    return _init_lm_backed(cfg, device, seed, cfg.text.hidden_size, build_random_opt_params)


def init_t5(cfg: Blip2T5Config, device=None, seed: int = 0) -> Params:
    """As init_opt, with the T5 backend."""
    return _init_lm_backed(cfg, device, seed, cfg.text.d_model, build_random_t5_params)


def init_stage1(cfg: Blip2QformerConfig, device=None, seed: int = 0) -> Params:
    """Random stage-1 params with the JAX init_stage1's tree (the MLM head's
    decoder tied to the word embeddings, temp 0.07 fp32)."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 3), device)
    D_q, E, dt = cfg.qformer.hidden_size, cfg.embed_dim, cfg.qformer.dtype

    def lin(o, i):
        return {"w": w((o, i), i, dt), "b": torch.zeros((o,), dtype=dt, device=device)}

    out = _init_vision_side(cfg, device, seed, w)
    qf = out["qformer"]
    qf["head"] = qformer.lm_head_init(cfg.qformer, qf["embeddings"]["word"], device, seed + 4)
    out.update(vision_proj=lin(E, D_q), text_proj=lin(E, D_q), itm_head=lin(2, D_q),
               temp=torch.tensor(0.07, dtype=torch.float32, device=device))
    return out


def vision_embeds(params: Params, cfg, images: torch.Tensor) -> torch.Tensor:
    """image → ln_vision(EVA-ViT features) [B, N, W] (blip2_qformer.py:94)."""
    feats = eva_vit.forward(params["visual"], cfg.vision, images)
    return layer_norm(feats, params["ln_vision"]["scale"], params["ln_vision"]["bias"], cfg.vision.layer_norm_eps)


def _queries(params: Params, cfg, B: int) -> torch.Tensor:
    qt = params["query_tokens"]
    return qt.expand(B, cfg.num_query_tokens, qt.shape[-1])


def _proj(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    w, b = params["proj"]["w"], params["proj"]["b"]
    return hidden.to(w.dtype) @ w.t() + b


def encode_image_queries(params: Params, cfg, images: torch.Tensor) -> torch.Tensor:
    """image → projected query embeddings [B, Q, lm width] (the query-only
    Q-Former of blip2_opt / blip2_t5 generate)."""
    feats = vision_embeds(params, cfg, images)
    hidden = qformer.forward(params["qformer"], cfg.qformer, _queries(params, cfg, images.shape[0]),
                             feats.to(cfg.qformer.dtype))
    return _proj(params, hidden)


def encode_image_queries_instruct(params: Params, cfg, images: torch.Tensor,
                                  qformer_text_ids: Optional[torch.Tensor] = None,
                                  qformer_text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Text-conditioned query encoding (blip2_t5_instruct.py:312-386). A
    5-D video input [B, 3, F, H, W] encodes each frame and concatenates the
    query outputs along the token axis."""
    if images.dim() == 5:
        return torch.cat([encode_image_queries_instruct(params, cfg, images[:, :, j], qformer_text_ids,
                                                        qformer_text_mask)
                          for j in range(images.shape[2])], dim=1)
    feats = vision_embeds(params, cfg, images)
    hidden = qformer.forward(params["qformer"], cfg.qformer, _queries(params, cfg, images.shape[0]),
                             feats.to(cfg.qformer.dtype), text_ids=qformer_text_ids, text_mask=qformer_text_mask)
    return _proj(params, hidden[:, : cfg.num_query_tokens])


# ---------------------------------------------------------------------------
# stage-1 Q-Former model (blip2 / blip2_feature_extractor / blip2_itm)
# ---------------------------------------------------------------------------


def _lin(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x.to(p["w"].dtype) @ p["w"].t() + p["b"]


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


def forward_image(params: Params, cfg: Blip2QformerConfig, images: torch.Tensor):
    """→ (query hidden [B, Q, D], image_embeds [B, N, W])
    (blip2_qformer.forward_image)."""
    image_embeds = vision_embeds(params, cfg, images)
    hidden, _ = qformer.forward_queries(params["qformer"], cfg.qformer, _queries(params, cfg, images.shape[0]),
                                        image_embeds.to(cfg.qformer.dtype))
    return hidden, image_embeds


def forward_text(params: Params, cfg: Blip2QformerConfig, text_ids, text_mask) -> torch.Tensor:
    """→ CLS hidden [B, D] (blip2_qformer.forward_text)."""
    return qformer.forward_text(params["qformer"], cfg.qformer, text_ids, text_mask)[:, 0]


def _itm_hidden(params: Params, cfg: Blip2QformerConfig, image_embeds, text_ids, text_mask) -> torch.Tensor:
    hidden = qformer.forward(params["qformer"], cfg.qformer, _queries(params, cfg, image_embeds.shape[0]),
                             image_embeds.to(cfg.qformer.dtype), text_ids=text_ids, text_mask=text_mask)
    return hidden[:, : cfg.num_query_tokens]


def compute_itm(params: Params, cfg: Blip2QformerConfig, image_embeds, text_ids, text_mask) -> torch.Tensor:
    """ITM logit [B]: the positive class's logit, meaned over the query
    positions (blip2_qformer.compute_itm); image_embeds are ln_vision
    outputs."""
    return _lin(_itm_hidden(params, cfg, image_embeds, text_ids, text_mask), params["itm_head"])[:, :, 1].mean(1)


def _text_feat(params: Params, cfg: Blip2QformerConfig, text_ids, text_mask) -> torch.Tensor:
    return _l2norm(_lin(forward_text(params, cfg, text_ids, text_mask), params["text_proj"]))


def match(params: Params, cfg: Blip2QformerConfig, images, text_ids, text_mask,
          match_head: str = "itm") -> torch.Tensor:
    """Blip2ITM.forward: 'itm' → [B, 2] query-mean logits; 'itc' → [B]
    query-max cosine similarity."""
    image_embeds = vision_embeds(params, cfg, images)
    if match_head == "itm":
        return _lin(_itm_hidden(params, cfg, image_embeds, text_ids, text_mask), params["itm_head"]).mean(1)
    if match_head == "itc":
        q_hidden, _ = qformer.forward_queries(params["qformer"], cfg.qformer,
                                              _queries(params, cfg, images.shape[0]),
                                              image_embeds.to(cfg.qformer.dtype))
        image_feats = _l2norm(_lin(q_hidden, params["vision_proj"]))
        text_feat = _text_feat(params, cfg, text_ids, text_mask)
        return torch.einsum("bqe,be->bq", image_feats, text_feat).amax(1)
    raise ValueError(f"unknown match_head {match_head!r}")


def _ce_label_smooth(logits: torch.Tensor, targets: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
    """torch CrossEntropyLoss(label_smoothing=eps) over hard targets, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[:, None])[:, 0]
    return ((1.0 - eps) * nll + eps * -logp.mean(-1)).mean()


def pretrain_forward(params: Params, cfg: Blip2QformerConfig, images: Optional[torch.Tensor],
                     text_ids: torch.Tensor, text_mask: torch.Tensor, *, bos_token_id: int, pad_token_id: int,
                     generator: Optional[torch.Generator] = None, image_ids: Optional[torch.Tensor] = None,
                     neg_idx=None, image_embeds: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Stage-1 pretraining losses (blip2_qformer.forward): query-max ITC with
    label smoothing 0.1, ITM with ITC-weighted hard negatives, the
    captioning LM over the cached query K/V; one process (the reference's
    concat_all_gather is the identity at world size 1). `image_ids` gives
    the coco-retrieval targets; `image_embeds` bypasses the vision tower;
    `neg_idx` = (image negatives, text negatives) hands the draw in."""
    if image_embeds is None:
        image_embeds = vision_embeds(params, cfg, images)
    B = image_embeds.shape[0]
    q_hidden, q_kv = qformer.forward_queries(params["qformer"], cfg.qformer, _queries(params, cfg, B),
                                             image_embeds.to(cfg.qformer.dtype))
    image_feats = _l2norm(_lin(q_hidden, params["vision_proj"])).float()        # [B, Q, E]
    text_feat = _text_feat(params, cfg, text_ids, text_mask).float()           # [B, E]
    temp = params["temp"]
    sim_i2t = torch.einsum("bqe,ne->bnq", image_feats, text_feat).amax(-1) / temp
    sim_t2i = torch.einsum("be,nqe->bnq", text_feat, image_feats).amax(-1) / temp

    if image_ids is not None:
        iid = image_ids.reshape(-1, 1)
        mask_same = iid == iid.t()
        pos_idx = mask_same.float()
        sim_targets = pos_idx / pos_idx.sum(1, keepdim=True)
        sim_targets = 0.9 * sim_targets + 0.1 * torch.ones_like(sim_targets) / sim_targets.shape[1]
        loss_t2i = -(torch.log_softmax(sim_t2i, dim=1) * sim_targets).sum(1).mean()
        loss_i2t = -(torch.log_softmax(sim_i2t, dim=1) * sim_targets).sum(1).mean()
        loss_itc = (loss_t2i + loss_i2t) / 2
    else:
        mask_same = torch.eye(B, dtype=torch.bool, device=image_embeds.device)
        targets = torch.arange(B, device=image_embeds.device)
        loss_itc = (_ce_label_smooth(sim_i2t, targets) + _ce_label_smooth(sim_t2i, targets)) / 2

    # ITM with hard negatives
    with torch.no_grad():
        w_t2i = torch.softmax(sim_t2i.masked_fill(mask_same, -10000.0), dim=1)
        w_i2t = torch.softmax(sim_i2t.masked_fill(mask_same, -10000.0), dim=1)
    if neg_idx is not None:
        img_neg, txt_neg = (torch.as_tensor(n, device=image_embeds.device).long() for n in neg_idx)
    else:
        img_neg = sample_hard_negative_indices(generator, w_t2i)
        txt_neg = sample_hard_negative_indices(generator, w_i2t)
    text_ids_all = torch.cat([text_ids, text_ids, text_ids[txt_neg]], dim=0)
    text_mask_all = torch.cat([text_mask, text_mask, text_mask[txt_neg]], dim=0)
    image_embeds_all = torch.cat([image_embeds, image_embeds[img_neg], image_embeds], dim=0)
    itm_logits = _lin(_itm_hidden(params, cfg, image_embeds_all, text_ids_all, text_mask_all),
                      params["itm_head"]).mean(1)
    itm_labels = torch.cat([torch.ones(B, dtype=torch.long, device=itm_logits.device),
                            torch.zeros(2 * B, dtype=torch.long, device=itm_logits.device)])
    loss_itm = torch.nn.functional.cross_entropy(itm_logits.float(), itm_labels)

    # the captioning LM over the cached query K/V
    dec_ids = text_ids.clone()
    dec_ids[:, 0] = bos_token_id
    labels = torch.where(dec_ids == pad_token_id, -100, dec_ids)
    lm_hidden = qformer.forward_lm(params["qformer"], cfg.qformer, dec_ids, text_mask, q_kv)
    loss_lm = qformer.lm_loss_mean(qformer.lm_logits(params["qformer"]["head"], lm_hidden), labels)
    return {"loss": loss_itc + loss_itm + loss_lm, "loss_itc": loss_itc, "loss_itm": loss_itm, "loss_lm": loss_lm}


def _categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) [B, V] → [B] ids."""
    return torch.multinomial(torch.softmax(logits.float(), dim=-1), 1, generator=generator)[:, 0]


def nucleus_filter(logits: np.ndarray, top_p: float) -> np.ndarray:
    """The caption loop's top-p filter on host logits [B, V]: the smallest
    prefix of the descending order whose mass reaches top_p keeps its
    logits, the rest become -1e30 (the JAX loop's numpy, softmax in
    float32)."""
    order = np.argsort(-logits, axis=-1)
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z.astype(np.float32))
    probs = np.take_along_axis(p / p.sum(-1, keepdims=True), order, axis=-1)
    keep = np.cumsum(probs, axis=-1) - probs < top_p
    keep[:, 0] = True
    filt = np.full_like(logits, -1e30)
    np.put_along_axis(filt, order, np.where(keep, np.take_along_axis(logits, order, -1), -1e30), -1)
    return filt


@torch.inference_mode()
def greedy_lm_decode(qf_params: Params, qf_cfg: QFormerConfig, query_embeds: torch.Tensor,
                     image_embeds: torch.Tensor, *, bos_token_id: int, eos_token_id: int,
                     max_new_tokens: int = 30, min_length: int = 0,
                     generator: Optional[torch.Generator] = None, top_p: Optional[float] = None) -> np.ndarray:
    """Caption decoding over the cached query K/V (the reference Qformer
    generate path, blip2_qformer.py:277-338): greedy by default, nucleus
    sampling with top_p (draws from `generator`). Each step re-runs the
    causal text pass on the growing prefix. Returns the ids after BOS
    [B, n] (finished rows pad with eos)."""
    _, kv = qformer.forward_queries(qf_params, qf_cfg, query_embeds, image_embeds)
    B = query_embeds.shape[0]
    dev = query_embeds.device
    ids = np.full((B, 1), bos_token_id, np.int32)
    done = np.zeros((B,), bool)
    for t in range(max_new_tokens):
        hidden = qformer.forward_lm(qf_params, qf_cfg, torch.from_numpy(ids).to(dev), None, kv)
        logits = qformer.lm_logits(qf_params["head"], hidden[:, -1]).cpu().numpy()
        if t < min_length - 1:
            logits[:, eos_token_id] = -1e30
        if top_p is not None:
            if generator is None:
                raise ValueError("top_p sampling needs a generator")
            nxt = _categorical(generator, torch.from_numpy(nucleus_filter(logits, top_p)).to(dev)).cpu().numpy()
        else:
            nxt = logits.argmax(-1)
        nxt = np.where(done, eos_token_id, nxt).astype(np.int32)
        ids = np.concatenate([ids, nxt[:, None]], axis=1)
        done |= nxt == eos_token_id
        if done.all():
            break
    return ids[:, 1:]


def generate_caption(params: Params, cfg: Blip2QformerConfig, images: torch.Tensor, **kw) -> np.ndarray:
    """blip2_qformer.generate: image → query K/V → caption token ids."""
    image_embeds = vision_embeds(params, cfg, images)
    return greedy_lm_decode(params["qformer"], cfg.qformer, _queries(params, cfg, images.shape[0]),
                            image_embeds.to(cfg.qformer.dtype), **kw)


def extract_features(params: Params, cfg: Blip2QformerConfig, images: Optional[torch.Tensor] = None,
                     text_ids: Optional[torch.Tensor] = None, text_mask: Optional[torch.Tensor] = None,
                     mode: str = "multimodal") -> Dict[str, Optional[torch.Tensor]]:
    """blip2_qformer.extract_features: image / text / multimodal."""
    out: Dict[str, Optional[torch.Tensor]] = {
        "image_embeds": None, "image_embeds_proj": None,
        "text_embeds": None, "text_embeds_proj": None, "multimodal_embeds": None,
    }
    if mode == "image":
        q_hidden, _ = forward_image(params, cfg, images)
        out["image_embeds"] = q_hidden
        out["image_embeds_proj"] = _l2norm(_lin(q_hidden, params["vision_proj"]))
    elif mode == "text":
        t_hidden = qformer.forward_text(params["qformer"], cfg.qformer, text_ids, text_mask)
        out["text_embeds"] = t_hidden
        out["text_embeds_proj"] = _l2norm(_lin(t_hidden, params["text_proj"]))
    elif mode == "multimodal":
        out["multimodal_embeds"] = _itm_hidden(params, cfg, vision_embeds(params, cfg, images), text_ids, text_mask)
    else:
        raise ValueError(f"mode must be image|text|multimodal, got {mode!r}")
    return out


@torch.inference_mode()
def compute_sim_matrix(params: Params, cfg: Blip2QformerConfig, images: torch.Tensor, text_ids: torch.Tensor,
                       text_mask: torch.Tensor, *, k_test: int) -> Tuple[np.ndarray, np.ndarray]:
    """Retrieval score matrices (blip2.py compute_sim_matrix): the query-max
    cosine ITC shortlist (numpy argsort on the host), an ITM re-rank of the
    top k_test, final score = itm logit + itc similarity; -100 elsewhere."""
    q_hidden, vit_feats = forward_image(params, cfg, images)
    image_embeds = _l2norm(_lin(q_hidden, params["vision_proj"]))
    text_feat = _text_feat(params, cfg, text_ids, text_mask)
    sims = torch.einsum("iqe,te->itq", image_embeds.float(), text_feat.float()).amax(-1).cpu().numpy()
    Ni, Nt = sims.shape
    dev = text_ids.device
    k = min(k_test, Nt)
    score_i2t = np.full((Ni, Nt), -100.0, np.float32)
    for i in range(Ni):
        topk = np.argsort(-sims[i])[:k]
        sel = torch.from_numpy(topk).to(dev)
        score = compute_itm(params, cfg, vit_feats[i].expand((k,) + vit_feats.shape[1:]),
                            text_ids[sel], text_mask[sel]).float().cpu().numpy()
        score_i2t[i, topk] = score + sims[i, topk]
    k = min(k_test, Ni)
    score_t2i = np.full((Nt, Ni), -100.0, np.float32)
    for t in range(Nt):
        topk = np.argsort(-sims[:, t])[:k]
        sel = torch.from_numpy(topk).to(vit_feats.device)
        score = compute_itm(params, cfg, vit_feats[sel], text_ids[t].expand((k,) + text_ids.shape[1:]),
                            text_mask[t].expand((k,) + text_mask.shape[1:])).float().cpu().numpy()
        score_t2i[t, topk] = score + sims[topk, t]
    return score_i2t, score_t2i


# ---------------------------------------------------------------------------
# the T5 backend: prefix encode, candidate ranking, generation
# ---------------------------------------------------------------------------


def _t5_shift_right(targets: torch.Tensor, pad_token_id: int, start_id: int) -> torch.Tensor:
    ids = torch.where(targets == -100, pad_token_id, targets)
    start = torch.full((targets.shape[0], 1), start_id, dtype=targets.dtype, device=targets.device)
    return torch.cat([start, ids[:, :-1]], dim=1)


def t5_encode_with_prefix(params: Params, cfg: Blip2T5Config, q_emb: torch.Tensor, input_ids: torch.Tensor,
                          input_mask: torch.Tensor, *, few_shot_embeds: Optional[torch.Tensor] = None,
                          few_shot_mask: Optional[torch.Tensor] = None):
    """[few-shot context?; query prefix; token embeds] → (T5 encoder states,
    the joint mask)."""
    B = q_emb.shape[0]
    tok = t5.embed_tokens(params["lm"], input_ids)
    enc_in = torch.cat([q_emb.to(tok.dtype), tok], dim=1)
    ones = torch.ones((B, q_emb.shape[1]), dtype=input_mask.dtype, device=input_mask.device)
    mask = torch.cat([ones, input_mask], dim=1)
    if few_shot_embeds is not None:
        enc_in = torch.cat([few_shot_embeds.to(tok.dtype), enc_in], dim=1)
        if few_shot_mask is None:
            few_shot_mask = torch.ones(few_shot_embeds.shape[:2], dtype=mask.dtype, device=mask.device)
        mask = torch.cat([few_shot_mask.to(mask.dtype), mask], dim=1)
    return t5.encode(params["lm"], cfg.text, enc_in, mask), mask


def t5_candidate_losses(params: Params, cfg: Blip2T5Config, enc_hidden: torch.Tensor, enc_mask: torch.Tensor,
                        cand_ids: torch.Tensor, *, pad_token_id: int = 0,
                        decoder_start_token_id: int = 0) -> torch.Tensor:
    """Per-candidate summed LM loss [B, C] for predict_class ranking
    (blip2_t5_instruct._predict_class, reduction='none' = per-sample token
    sum). Rank with argsort(axis=-1)."""
    B = enc_hidden.shape[0]
    C = cand_ids.shape[0]
    enc_rep = enc_hidden.repeat_interleave(C, dim=0)
    mask_rep = enc_mask.repeat_interleave(C, dim=0)
    cand_rep = cand_ids.repeat(B, 1)
    targets = torch.where(cand_rep == pad_token_id, -100, cand_rep)
    dec_ids = _t5_shift_right(targets, pad_token_id, decoder_start_token_id)
    logp = torch.log_softmax(t5.decode(params["lm"], cfg.text, dec_ids, enc_rep, mask_rep).float(), dim=-1)
    valid = targets != -100
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(-1).reshape(B, C)


@torch.inference_mode()
def t5_generate(params: Params, cfg: Blip2T5Config, images: torch.Tensor, prompt_ids: Sequence[Sequence[int]], *,
                max_new_tokens: int = 32, decoder_start_token_id: int = 0, eos_token_id: int = 1,
                qformer_text_ids: Optional[torch.Tensor] = None,
                qformer_text_mask: Optional[torch.Tensor] = None) -> List[List[int]]:
    """BLIP-2 T5 generation: [query embeds; prompt embeds] → T5 encoder →
    greedy decoder (blip2_t5 generate); with qformer_text_ids the
    instruct path (text-conditioned Q-Former)."""
    B = images.shape[0]
    dev = images.device
    if qformer_text_ids is not None:
        q_emb = encode_image_queries_instruct(params, cfg, images, qformer_text_ids, qformer_text_mask)
    else:
        q_emb = encode_image_queries(params, cfg, images)
    Qtok = q_emb.shape[1]
    T = max(len(p) for p in prompt_ids)
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, Qtok + T), np.int32)
    mask[:, :Qtok] = 1
    for b, p in enumerate(prompt_ids):
        ids[b, : len(p)] = p
        mask[b, Qtok : Qtok + len(p)] = 1
    tok_emb = t5.embed_tokens(params["lm"], torch.from_numpy(ids).to(dev))
    enc_in = torch.cat([q_emb.to(tok_emb.dtype), tok_emb], dim=1)
    mask_t = torch.from_numpy(mask).to(dev)
    enc_hidden = t5.encode(params["lm"], cfg.text, enc_in, mask_t)
    return t5.generate_greedy(params["lm"], cfg.text, enc_hidden, mask_t, max_new_tokens=max_new_tokens,
                              decoder_start_token_id=decoder_start_token_id, eos_token_id=eos_token_id)


# ---------------------------------------------------------------------------
# the LM backends' training losses
# ---------------------------------------------------------------------------


def _ce_mean_ignore(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE mean over the labels != -100 (HF's default reduction), in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != -100
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def opt_forward_loss(params: Params, cfg: Blip2OptConfig, images: Optional[torch.Tensor], text_ids: torch.Tensor,
                     text_mask: torch.Tensor, *, pad_token_id: int, prompt_length: int = 0,
                     q_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blip2OPT.forward (blip2_opt.py): [query prefix; token embeds] through
    the OPT, -100 targets on the prefix (and on the prompt's first
    prompt_length columns), the shifted CE mean. Positions derive from the
    mask (cumsum - 1, clamped at 0), as HF OPT's do."""
    if q_emb is None:
        q_emb = encode_image_queries(params, cfg, images)
    B, Q, _ = q_emb.shape
    T = text_ids.shape[1]
    tok = opt.embed_tokens(params["lm"], text_ids)
    embeds = torch.cat([q_emb.to(tok.dtype), tok], dim=1)
    mask = torch.cat([torch.ones((B, Q), dtype=text_mask.dtype, device=text_mask.device), text_mask], dim=1)
    positions = (mask.long().cumsum(1) - 1).clamp(min=0)
    hidden, _ = opt.forward(params["lm"], cfg.text, embeds, positions)
    logits = opt.logits_from_hidden(params["lm"], hidden)
    targets = torch.where(text_ids == pad_token_id, -100, text_ids).long()
    if prompt_length:
        col = torch.arange(T, device=targets.device)
        targets = torch.where(col[None, :] < prompt_length, -100, targets)
    targets = torch.cat([torch.full((B, Q), -100, dtype=targets.dtype, device=targets.device), targets], dim=1)
    return _ce_mean_ignore(logits[:, :-1], targets[:, 1:])


def t5_forward_loss(params: Params, cfg: Blip2T5Config, images: Optional[torch.Tensor], input_ids: torch.Tensor,
                    input_mask: torch.Tensor, output_ids: torch.Tensor, output_mask: torch.Tensor, *,
                    pad_token_id: int = 0, decoder_start_token_id: int = 0, q_emb: Optional[torch.Tensor] = None,
                    qformer_text_ids: Optional[torch.Tensor] = None,
                    qformer_text_mask: Optional[torch.Tensor] = None,
                    few_shot_embeds: Optional[torch.Tensor] = None,
                    few_shot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blip2T5.forward / Blip2T5Instruct.forward: [query prefix; input
    tokens] through the T5 encoder, targets = the output ids with pads
    ignored, CE mean. With qformer_text_ids the queries are
    text-conditioned (instruct); few-shot context embeds are prepended to
    the encoder stream (their sampling is the caller's)."""
    if q_emb is None:
        if qformer_text_ids is not None:
            q_emb = encode_image_queries_instruct(params, cfg, images, qformer_text_ids, qformer_text_mask)
        else:
            q_emb = encode_image_queries(params, cfg, images)
    enc_hidden, enc_mask = t5_encode_with_prefix(params, cfg, q_emb, input_ids, input_mask,
                                                 few_shot_embeds=few_shot_embeds, few_shot_mask=few_shot_mask)
    targets = torch.where(output_ids == pad_token_id, -100, output_ids)
    dec_ids = _t5_shift_right(targets, pad_token_id, decoder_start_token_id)
    logits = t5.decode(params["lm"], cfg.text, dec_ids, enc_hidden, enc_mask)
    return _ce_mean_ignore(logits, targets)
