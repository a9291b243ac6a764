"""ALBEF: a ViT + fusion BERT for retrieval, VQA, classification, NLVR2,
features and pretraining (torch twin of llava_align_tpu/models/albef.py).

Capability parity: the reference's vendored LAVIS ALBEF stack
(lavis/models/albef_models/{albef_retrieval, albef_vqa,
albef_classification, albef_nlvr, albef_feature_extractor,
albef_pretrain}.py) on med.py's fusion BERT and vit.py: a 12-layer BERT
whose first `fusion_layer` = 6 layers are text-only and whose last 6
cross-attend the ViT states, through models/blip's MED machinery
(MedConfig.fusion_layer, modes "text" / "fusion" / "multimodal"). The VQA
variant adds a 6-layer causal MED decoder (fusion_layer 0: cross-attention
in every layer); NLVR2 uses an 18-layer encoder whose 12 fusion layers
alternate between the two images.

The training losses are functions of explicit (params, momentum params,
queue state), as in the JAX package. Here the momentum tree and the queue
state are updated in place (torch's buffers), under no_grad, and returned.
Hard negatives and MLM masks are drawn from a torch.Generator; each
function that draws also takes the draw itself as a keyword (neg_idx,
mlm_inputs / mlm_labels, or mlm_mask_inputs' `draws`), so a test can hand
it the JAX package's draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.models.blip import (
    BlipVitConfig,
    MedConfig,
    _init_tools,
    linear_init,
    med_forward,
    med_init,
    med_logits,
    rerank_sims,
    vit_forward,
    vit_init,
)
from llava_align_tpu_torch.ops.layers import l2_normalize as _norm
from llava_align_tpu_torch.ops.layers import linear_bias as _proj
from llava_align_tpu_torch.ops.layers import sample_hard_negative_indices

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AlbefConfig:
    vision: BlipVitConfig = dataclasses.field(default_factory=lambda: BlipVitConfig(image_size=384))
    # 12-layer encoder, cross-attention from layer 6 (ALBEF's med config)
    text: MedConfig = dataclasses.field(default_factory=lambda: MedConfig(vocab_size=30522, fusion_layer=6))
    # the VQA answer decoder: 6 layers, cross-attention everywhere
    decoder: MedConfig = dataclasses.field(
        default_factory=lambda: MedConfig(vocab_size=30522, num_layers=6, fusion_layer=0))
    embed_dim: int = 256
    num_classes: int = 0          # classification / NLVR head width
    queue_size: int = 65536
    temp: float = 0.07
    label_smoothing: float = 0.1  # med.py CrossEntropyLoss(label_smoothing=0.1)

    @staticmethod
    def tiny(vocab_size: int = 64, *, num_classes: int = 0, nlvr: bool = False,
             queue_size: int = 16) -> "AlbefConfig":
        n_layers, fl = (6, 2) if nlvr else (4, 2)
        return AlbefConfig(
            vision=BlipVitConfig.tiny(),
            text=MedConfig(vocab_size=vocab_size, hidden_size=32, num_layers=n_layers, num_heads=4,
                           intermediate_size=64, max_position_embeddings=64, fusion_layer=fl),
            decoder=MedConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64, max_position_embeddings=64, fusion_layer=0),
            embed_dim=16, num_classes=num_classes, queue_size=queue_size,
        )


def init(cfg: AlbefConfig, variant: str = "retrieval", device=None, seed: int = 0) -> Params:
    """variant ∈ {retrieval, pretrain, vqa, classification, nlvr, feature}:
    the JAX init's tree and scales, torch's random numbers. pretrain
    carries the retrieval heads and the MED MLM head med_init provides."""
    device, w = _init_tools(device, seed + 3)
    D, E, dt = cfg.text.hidden_size, cfg.embed_dim, cfg.text.dtype
    p: Params = {"visual": vit_init(cfg.vision, device, seed), "text": med_init(cfg.text, device, seed + 1)}
    if variant in ("retrieval", "feature", "pretrain"):
        p["vision_proj"] = linear_init(w, E, cfg.vision.hidden_size, dt, device)
        p["text_proj"] = linear_init(w, E, D, dt, device)
    if variant in ("retrieval", "pretrain"):
        p["itm_head"] = linear_init(w, 2, D, dt, device)
        p["temp"] = torch.tensor(cfg.temp, dtype=torch.float32, device=device)
    if variant == "vqa":
        p["decoder"] = med_init(cfg.decoder, device, seed + 2)
    if variant in ("classification", "nlvr"):
        if cfg.num_classes < 2:
            raise ValueError(f"num_classes must be >1 for {variant}, got {cfg.num_classes}")
        # Linear → ReLU → Linear (albef_classification.py)
        p["cls_head"] = {"fc1": linear_init(w, D, D, dt, device), "fc2": linear_init(w, cfg.num_classes, D, dt, device)}
    return p


def _cls_head(p: Params, cls: torch.Tensor) -> torch.Tensor:
    return _proj(torch.relu(_proj(cls, p["fc1"])), p["fc2"])


def _ones_mask(states: torch.Tensor) -> torch.Tensor:
    return torch.ones(states.shape[:2], dtype=torch.int32, device=states.device)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def fused_encode(params: Params, cfg: AlbefConfig, pixels: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """ViT + multimodal BERT (XBertEncoder.forward_automask) → [B, S, D]."""
    enc = vit_forward(params["visual"], cfg.vision, pixels)
    return med_forward(params["text"], cfg.text, ids, mask, encoder_states=enc, encoder_mask=_ones_mask(enc),
                       mode="multimodal")


def itc_features(params: Params, cfg: AlbefConfig, pixels: Optional[torch.Tensor] = None,
                 ids: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Unimodal embeddings and the normalized cls ITC projections."""
    out: Dict[str, torch.Tensor] = {}
    if pixels is not None:
        enc = vit_forward(params["visual"], cfg.vision, pixels)
        out["image_embeds"] = enc
        out["image_feat"] = _norm(_proj(enc[:, 0], params["vision_proj"]))
    if ids is not None:
        h = med_forward(params["text"], cfg.text, ids, mask, mode="text")
        out["text_embeds"] = h
        out["text_feat"] = _norm(_proj(h[:, 0], params["text_proj"]))
    return out


def itm_logits_from_ids(params: Params, cfg: AlbefConfig, image_embeds: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """The multimodal pass + ITM head → [B, 2] (the re-rank path)."""
    h = med_forward(params["text"], cfg.text, ids, mask, encoder_states=image_embeds,
                    encoder_mask=_ones_mask(image_embeds), mode="multimodal")
    return _proj(h[:, 0], params["itm_head"])


def extract_features(params: Params, cfg: AlbefConfig, pixels: Optional[torch.Tensor] = None,
                     ids: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None, *,
                     mode: str = "multimodal") -> Dict[str, torch.Tensor]:
    """albef_feature_extractor: per-token projections; "text" runs only the
    pre-fusion layers, "multimodal" continues them through fusion."""
    out: Dict[str, torch.Tensor] = {}
    if mode in ("image", "multimodal"):
        enc = vit_forward(params["visual"], cfg.vision, pixels)
        out["image_embeds"] = enc
        out["image_features"] = _norm(_proj(enc, params["vision_proj"]))
    if mode in ("text", "multimodal"):
        h = med_forward(params["text"], cfg.text, ids, mask, mode="text")
        out["text_embeds"] = h
        out["text_features"] = _norm(_proj(h, params["text_proj"]))
    if mode == "multimodal":
        enc = out["image_embeds"]
        out["multimodal_embeds"] = med_forward(params["text"], cfg.text, None, mask, encoder_states=enc,
                                               encoder_mask=_ones_mask(enc), mode="fusion",
                                               input_embeds=out["text_embeds"])
    return out


# ---------------------------------------------------------------------------
# VQA: answer ranking
# ---------------------------------------------------------------------------


def lm_loss_per_sample(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    """Shifted next-token CE with label smoothing, summed per sample
    (med.py)."""
    lg, lb = logits[:, :-1].float(), labels[:, 1:]
    logp = torch.log_softmax(lg, dim=-1)
    valid = lb != -100
    tgt = lb.long().clamp(0, lg.shape[-1] - 1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    tok = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(-1)
    return torch.where(valid, tok, 0.0).sum(-1)


def top_k_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, M] → the indices [N, k] of each row's k largest, the lower index
    first among equal values (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][:, :k]


def rank_answers_from_states(params: Params, cfg: AlbefConfig, fused: torch.Tensor, q_mask: torch.Tensor,
                             answer_ids: torch.Tensor, answer_mask: torch.Tensor, *, num_ans_candidates: int = 128,
                             pad_token_id: int = 0, dec_cfg: Optional[MedConfig] = None,
                             label_smoothing: Optional[float] = None) -> np.ndarray:
    """Two-stage answer ranking (albef_vqa.py rank_answers): the answers'
    first tokens scored by one decoder step over the fused question
    states, the top k kept, then ranked by the label-smoothed LM loss of
    the whole answer → [Nq] indices into the answer list."""
    dec_cfg = cfg.decoder if dec_cfg is None else dec_cfg
    ls = cfg.label_smoothing if label_smoothing is None else label_smoothing
    dec = params["decoder"]
    k = min(num_ans_candidates, answer_ids.shape[0])
    nq = fused.shape[0]
    start = answer_ids[0, 0].expand(nq, 1)
    h = med_forward(dec, dec_cfg, start, encoder_states=fused, encoder_mask=q_mask, causal=True)
    probs0 = torch.softmax(med_logits(dec, h)[:, 0], dim=-1)
    topk_ids = top_k_rows(probs0[:, answer_ids[:, 1].long()], k)
    flat = topk_ids.reshape(-1)
    cand_ids, cand_mask = answer_ids[flat], answer_mask[flat]
    targets = torch.where(cand_ids == pad_token_id, -100, cand_ids)
    h = med_forward(dec, dec_cfg, cand_ids, cand_mask, encoder_states=fused.repeat_interleave(k, dim=0),
                    encoder_mask=q_mask.repeat_interleave(k, dim=0), causal=True)
    loss = lm_loss_per_sample(med_logits(dec, h), targets, ls)
    best = torch.argmax((-loss).reshape(nq, k), dim=1)
    return topk_ids.gather(1, best[:, None])[:, 0].cpu().numpy()


@torch.inference_mode()
def rank_answers(params: Params, cfg: AlbefConfig, pixels: torch.Tensor, q_ids: torch.Tensor, q_mask: torch.Tensor,
                 answer_ids: torch.Tensor, answer_mask: torch.Tensor, *, num_ans_candidates: int = 128,
                 pad_token_id: int = 0) -> np.ndarray:
    fused = fused_encode(params, cfg, pixels, q_ids, q_mask)
    return rank_answers_from_states(params, cfg, fused, q_mask, answer_ids, answer_mask,
                                    num_ans_candidates=num_ans_candidates, pad_token_id=pad_token_id)


# ---------------------------------------------------------------------------
# classification / NLVR2
# ---------------------------------------------------------------------------


def classify(params: Params, cfg: AlbefConfig, pixels: torch.Tensor, ids: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """albef_classification → [B, num_classes]."""
    return _cls_head(params["cls_head"], fused_encode(params, cfg, pixels, ids, mask)[:, 0])


def distilled_ce(logits: torch.Tensor, targets: torch.Tensor, logits_m: Optional[torch.Tensor],
                 alpha: float) -> torch.Tensor:
    """(1 - α)·CE + α·distillation against the momentum logits' softmax
    (CE alone without them)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, targets.long()[:, None])[:, 0].mean()
    if logits_m is None:
        return ce
    distill = -(torch.softmax(logits_m.float(), dim=-1) * logp).sum(-1).mean()
    return (1.0 - alpha) * ce + alpha * distill


def classification_loss(params: Params, cfg: AlbefConfig, pixels: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor, targets: torch.Tensor, *, m_params: Optional[Params] = None,
                        alpha: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1-α)·CE + α·distillation against the momentum logits → (loss,
    logits), the logits in fp32."""
    logits = classify(params, cfg, pixels, ids, mask).float()
    logits_m = None
    if m_params is not None and alpha != 0.0:
        with torch.no_grad():
            logits_m = classify(m_params, cfg, pixels, ids, mask).float()
    return distilled_ce(logits, targets, logits_m, alpha), logits


def nlvr_forward(params: Params, cfg: AlbefConfig, pixels0: torch.Tensor, pixels1: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """NLVR2: one ViT pass over both images; the fusion layers alternate
    between them → [B, num_classes]."""
    enc = vit_forward(params["visual"], cfg.vision, torch.cat([pixels0, pixels1], dim=0))
    b = pixels0.shape[0]
    e0, e1 = enc[:b], enc[b:]
    am = _ones_mask(e0)
    h = med_forward(params["text"], cfg.text, ids, mask, encoder_states=(e0, e1), encoder_mask=(am, am),
                    mode="multimodal")
    return _cls_head(params["cls_head"], h[:, 0])


def nlvr_loss(params: Params, cfg: AlbefConfig, pixels0: torch.Tensor, pixels1: torch.Tensor, ids: torch.Tensor,
              mask: torch.Tensor, targets: torch.Tensor, *, m_params: Optional[Params] = None,
              alpha: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE + the optional momentum distillation (albef_nlvr.py)."""
    logits = nlvr_forward(params, cfg, pixels0, pixels1, ids, mask)
    logits_m = None
    if m_params is not None and alpha != 0.0:
        with torch.no_grad():
            logits_m = nlvr_forward(m_params, cfg, pixels0, pixels1, ids, mask)
    return distilled_ce(logits, targets, logits_m, alpha), logits


# ---------------------------------------------------------------------------
# retrieval: the similarity matrix and the ITC/ITM training step
# ---------------------------------------------------------------------------


@torch.inference_mode()
def compute_sim_matrix(params: Params, cfg: AlbefConfig, pixels: torch.Tensor, text_ids: torch.Tensor,
                       text_mask: torch.Tensor, *, k_test: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(scores_i2t, scores_t2i): ITC similarity, re-ranked by the ITM head's
    logit[1] on the top k_test pairs of each row when k_test > 0."""
    feats = itc_features(params, cfg, pixels=pixels, ids=text_ids, mask=text_mask)
    sims = feats["image_feat"].float().cpu().numpy() @ feats["text_feat"].float().cpu().numpy().T
    if k_test <= 0:
        return sims, sims.T
    return rerank_sims(sims, feats["image_embeds"], text_ids, text_mask, k_test,
                       lambda e, i, m: itm_logits_from_ids(params, cfg, e, i, m)[:, 1])


def init_queue_state(cfg: AlbefConfig, generator: Optional[torch.Generator] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """The queue buffers (albef_retrieval.py): normalized random image and
    text feature queues [E, Q], the index queue at -100, the pointer 0."""
    iq = torch.randn((cfg.embed_dim, cfg.queue_size), generator=generator, device=device)
    tq = torch.randn((cfg.embed_dim, cfg.queue_size), generator=generator, device=device)
    return {"image_queue": _norm(iq, dim=0), "text_queue": _norm(tq, dim=0),
            "idx_queue": torch.full((1, cfg.queue_size), -100, dtype=torch.int32, device=device),
            "ptr": torch.zeros((), dtype=torch.int32, device=device)}


def _pairs(params, m_params):
    """(param, momentum leaf) pairs, matched by key and index."""
    if isinstance(m_params, dict):
        for k, m in m_params.items():
            yield from _pairs(params[k], m)
    elif isinstance(m_params, (list, tuple)):
        for p, m in zip(params, m_params):
            yield from _pairs(p, m)
    elif m_params is not None:
        yield params, m_params


@torch.no_grad()
def momentum_update(params: Params, m_params: Params, momentum: float = 0.995) -> Params:
    """The EMA step (MomentumDistilationMixin._momentum_update), m = m·μ +
    p·(1 - μ), in place on m_params, which is returned."""
    pairs = list(_pairs(params, m_params))
    ms = [m for _, m in pairs]
    torch._foreach_mul_(ms, momentum)
    torch._foreach_add_(ms, torch._foreach_mul([p.detach().to(m.dtype) for p, m in pairs], 1.0 - momentum))
    return m_params


@torch.no_grad()
def enqueue(state: Dict[str, torch.Tensor], queue_size: int, image_feat_m: torch.Tensor,
            text_feat_m: torch.Tensor, idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """_dequeue_and_enqueue, in place: the batch's momentum features (and
    ids) written at the pointer, modulo the queue (so a batch that does not
    divide the queue wraps, where the reference asserts), the pointer
    advanced."""
    bs = image_feat_m.shape[0]
    ptr = int(state["ptr"])
    pos = (ptr + torch.arange(bs, device=image_feat_m.device)) % queue_size
    state["image_queue"][:, pos] = image_feat_m.t().to(state["image_queue"].dtype)
    state["text_queue"][:, pos] = text_feat_m.t().to(state["text_queue"].dtype)
    if idx is not None:
        state["idx_queue"][:, pos] = idx.t().to(state["idx_queue"].dtype)
    state["ptr"].fill_((ptr + bs) % queue_size)
    return state


def soft_itc_loss(sim_i2t: torch.Tensor, sim_t2i: torch.Tensor, i2t_tgt: torch.Tensor,
                  t2i_tgt: torch.Tensor) -> torch.Tensor:
    loss_i2t = -(torch.log_softmax(sim_i2t, dim=1) * i2t_tgt).sum(1).mean()
    loss_t2i = -(torch.log_softmax(sim_t2i, dim=1) * t2i_tgt).sum(1).mean()
    return (loss_i2t + loss_t2i) / 2


def itm_loss(vl: torch.Tensor, head: Params, bs: int) -> torch.Tensor:
    """CE of the ITM head over [positives (bs); negatives (2 bs)]."""
    logits = _proj(vl, head).float()
    labels = torch.cat([torch.ones(bs, dtype=torch.long, device=vl.device),
                        torch.zeros(2 * bs, dtype=torch.long, device=vl.device)])
    return torch.nn.functional.cross_entropy(logits, labels)


def draw_negatives(generator, w_t2i: torch.Tensor, w_i2t: torch.Tensor, neg_idx=None):
    """(negative image per text, negative text per image): the given pair,
    else one draw each from the mining weights (images first, as the JAX
    package splits its key)."""
    if neg_idx is not None:
        return tuple(torch.as_tensor(n, device=w_t2i.device).long() for n in neg_idx)
    return sample_hard_negative_indices(generator, w_t2i), sample_hard_negative_indices(generator, w_i2t)


def _fusion_itm(params: Params, cfg: AlbefConfig, image_embeds, text_embeds, mask, neg_img, neg_txt, bs: int):
    pos_out = med_forward(params["text"], cfg.text, None, mask, encoder_states=image_embeds,
                          encoder_mask=_ones_mask(image_embeds), mode="fusion", input_embeds=text_embeds)
    text_embeds_all = torch.cat([text_embeds, text_embeds[neg_txt]], dim=0)
    text_mask_all = torch.cat([mask, mask[neg_txt]], dim=0)
    image_embeds_all = torch.cat([image_embeds[neg_img], image_embeds], dim=0)
    neg_out = med_forward(params["text"], cfg.text, None, text_mask_all, encoder_states=image_embeds_all,
                          encoder_mask=_ones_mask(image_embeds_all), mode="fusion", input_embeds=text_embeds_all)
    return itm_loss(torch.cat([pos_out[:, 0], neg_out[:, 0]], dim=0), params["itm_head"], bs)


def retrieval_train_step(params: Params, m_params: Params, state: Dict[str, torch.Tensor], cfg: AlbefConfig,
                         generator: Optional[torch.Generator], pixels: torch.Tensor, ids: torch.Tensor,
                         mask: torch.Tensor, idx: torch.Tensor, *, alpha: float = 0.4, momentum: float = 0.995,
                         use_distill: bool = True, neg_idx=None):
    """One ALBEF retrieval training forward (albef_retrieval.py): ITC over
    in-batch + queue negatives with momentum-distilled soft targets, ITM
    with in-batch hard negatives mined by ITC weight → (losses, m_params,
    state). Differentiate losses["loss"] w.r.t. params; m_params (EMA'd)
    and state (enqueued) are updated in place, outside the graph."""
    bs = pixels.shape[0]
    temp = params["temp"].clamp(0.001, 0.5)
    feats = itc_features(params, cfg, pixels=pixels, ids=ids, mask=mask)
    image_embeds, text_embeds = feats["image_embeds"], feats["text_embeds"]
    image_feat, text_feat = feats["image_feat"], feats["text_feat"]

    idx = idx.reshape(-1, 1)
    idx_all = torch.cat([idx.t().to(state["idx_queue"].dtype), state["idx_queue"]], dim=1)
    pos = (idx == idx_all).float()
    sim_targets = pos / pos.sum(1, keepdim=True)

    m_params = momentum_update(params, m_params, momentum)
    with torch.no_grad():
        mfeats = itc_features(m_params, cfg, pixels=pixels, ids=ids, mask=mask)
        image_feat_m, text_feat_m = mfeats["image_feat"], mfeats["text_feat"]
        image_feat_all = torch.cat([image_feat_m.t().float(), state["image_queue"].float()], dim=1)
        text_feat_all = torch.cat([text_feat_m.t().float(), state["text_queue"].float()], dim=1)
        if use_distill:
            sim_i2t_m = image_feat_m.float() @ text_feat_all / temp
            sim_t2i_m = text_feat_m.float() @ image_feat_all / temp
            i2t_tgt = alpha * torch.softmax(sim_i2t_m, dim=1) + (1 - alpha) * sim_targets
            t2i_tgt = alpha * torch.softmax(sim_t2i_m, dim=1) + (1 - alpha) * sim_targets
        else:
            i2t_tgt = t2i_tgt = sim_targets
    sim_i2t = image_feat.float() @ text_feat_all / temp
    sim_t2i = text_feat.float() @ image_feat_all / temp
    loss_itc = soft_itc_loss(sim_i2t, sim_t2i, i2t_tgt, t2i_tgt)
    state = enqueue(state, cfg.queue_size, image_feat_m, text_feat_m, idx)

    with torch.no_grad():
        same = idx == idx.t()
        w_i2t = torch.softmax(sim_i2t[:, :bs] + 1e-4, dim=1).masked_fill(same, 0.0)
        w_t2i = torch.softmax(sim_t2i[:, :bs] + 1e-4, dim=1).masked_fill(same, 0.0)
    neg_img, neg_txt = draw_negatives(generator, w_t2i, w_i2t, neg_idx)
    loss_itm = _fusion_itm(params, cfg, image_embeds, text_embeds, mask, neg_img, neg_txt, bs)
    return {"loss": loss_itc + loss_itm, "loss_itc": loss_itc, "loss_itm": loss_itm}, m_params, state


def mlm_mask_inputs(generator: Optional[torch.Generator], ids: torch.Tensor, vocab_size: int, *, mask_token_id: int,
                    pad_token_id: int, cls_token_id: int, mlm_probability: float = 0.15,
                    draws: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT-style MLM corruption (albef_pretrain.mask): mlm_probability of
    the non-pad, non-CLS positions are selected; of those 80% → [MASK], 10%
    → a random token, 10% unchanged → (masked ids, labels, -100 off the
    selection). `draws` = (selected, replace, random) boolean planes before
    the masking and the random-token plane, as the JAX package draws them;
    else drawn from `generator`."""
    if draws is None:
        def bern(p):
            return torch.rand(ids.shape, generator=generator, device=ids.device) < p

        draws = (bern(mlm_probability), bern(0.8), bern(0.5),
                 torch.randint(0, vocab_size, ids.shape, generator=generator, device=ids.device))
    sel, rep, rnd, words = (torch.as_tensor(d, device=ids.device) for d in draws)
    masked = sel.bool() & (ids != pad_token_id) & (ids != cls_token_id)
    labels = torch.where(masked, ids, -100)
    replace = rep.bool() & masked
    out = torch.where(replace, mask_token_id, ids)
    rand = rnd.bool() & masked & ~replace
    return torch.where(rand, words.to(ids.dtype), out), labels


def masked_ce(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token CE mean over labels != -100 (HF's default reduction)."""
    valid = labels != -100
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def mlm_loss(params: Params, cfg: AlbefConfig, masked_ids: torch.Tensor, mask: torch.Tensor,
             image_embeds: torch.Tensor, labels: torch.Tensor, *, m_params: Optional[Params] = None,
             image_embeds_m: Optional[torch.Tensor] = None, alpha: float = 0.0) -> torch.Tensor:
    """Masked-LM loss with momentum distillation (albef_pretrain.py + med.py):
    CE over the masked tokens, blended with the momentum model's soft
    distribution there."""
    h = med_forward(params["text"], cfg.text, masked_ids, mask, encoder_states=image_embeds,
                    encoder_mask=_ones_mask(image_embeds), mode="multimodal")
    logp = torch.log_softmax(med_logits(params["text"], h).float(), dim=-1)
    loss = masked_ce(logp, labels)
    if m_params is not None and alpha > 0.0:
        with torch.no_grad():
            h_m = med_forward(m_params["text"], cfg.text, masked_ids, mask, encoder_states=image_embeds_m,
                              encoder_mask=_ones_mask(image_embeds), mode="multimodal")
            soft = torch.softmax(med_logits(m_params["text"], h_m).float(), dim=-1)
        valid = labels != -100
        distill = torch.where(valid, -(soft * logp).sum(-1), 0.0).sum() / valid.sum().clamp(min=1)
        loss = (1.0 - alpha) * loss + alpha * distill
    return loss


def rampup_factor(epoch, iters, num_iters_per_epoch) -> float:
    """albef_pretrain._rampup_factor."""
    return min(1.0, (epoch * num_iters_per_epoch + iters) / (2 * num_iters_per_epoch))


def pretrain_train_step(params: Params, m_params: Params, state: Dict[str, torch.Tensor], cfg: AlbefConfig,
                        generator: Optional[torch.Generator], pixels: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor, *, alpha: float, momentum: float = 0.995, mask_token_id: int = 103,
                        pad_token_id: int = 0, cls_token_id: int = 101, mlm_probability: float = 0.15,
                        mlm_inputs: Optional[torch.Tensor] = None, mlm_labels: Optional[torch.Tensor] = None,
                        neg_idx=None):
    """One ALBEF pretraining forward (albef_pretrain.py): ITC over in-batch +
    queue negatives with momentum-distilled diagonal targets, ITM with
    in-batch hard negatives, masked LM with momentum distillation. alpha
    arrives ramped (rampup_factor) → (losses, m_params, state), the last two
    updated in place."""
    bs = pixels.shape[0]
    temp = params["temp"].clamp(0.001, 0.5)
    feats = itc_features(params, cfg, pixels=pixels, ids=ids, mask=mask)
    image_embeds, text_embeds = feats["image_embeds"], feats["text_embeds"]
    image_feat, text_feat = feats["image_feat"], feats["text_feat"]

    m_params = momentum_update(params, m_params, momentum)
    with torch.no_grad():
        mfeats = itc_features(m_params, cfg, pixels=pixels, ids=ids, mask=mask)
        image_feat_m, text_feat_m = mfeats["image_feat"], mfeats["text_feat"]
        image_feat_all = torch.cat([image_feat_m.t().float(), state["image_queue"].float()], dim=1)
        text_feat_all = torch.cat([text_feat_m.t().float(), state["text_queue"].float()], dim=1)
        sim_targets = torch.zeros((bs, image_feat_all.shape[1]), dtype=torch.float32, device=pixels.device)
        sim_targets[:, :bs] = torch.eye(bs, device=pixels.device)
        i2t_tgt = alpha * torch.softmax(image_feat_m.float() @ text_feat_all / temp, dim=1) + (1 - alpha) * sim_targets
        t2i_tgt = alpha * torch.softmax(text_feat_m.float() @ image_feat_all / temp, dim=1) + (1 - alpha) * sim_targets
    sim_i2t = image_feat.float() @ text_feat_all / temp
    sim_t2i = text_feat.float() @ image_feat_all / temp
    loss_itc = soft_itc_loss(sim_i2t, sim_t2i, i2t_tgt, t2i_tgt)
    state = enqueue(state, cfg.queue_size, image_feat_m, text_feat_m)

    # the mining weights from diagonal-masked sims (no +1e-4: that epsilon is
    # the retrieval step's)
    with torch.no_grad():
        eye = torch.eye(bs, dtype=torch.bool, device=pixels.device)
        w_i2t = torch.softmax(sim_i2t[:, :bs].masked_fill(eye, -float("inf")), dim=1)
        w_t2i = torch.softmax(sim_t2i[:, :bs].masked_fill(eye, -float("inf")), dim=1)
    neg_img, neg_txt = draw_negatives(generator, w_t2i, w_i2t, neg_idx)
    loss_itm = _fusion_itm(params, cfg, image_embeds, text_embeds, mask, neg_img, neg_txt, bs)

    if mlm_inputs is None:
        mlm_inputs, mlm_labels = mlm_mask_inputs(generator, ids, cfg.text.vocab_size, mask_token_id=mask_token_id,
                                                 pad_token_id=pad_token_id, cls_token_id=cls_token_id,
                                                 mlm_probability=mlm_probability)
    loss_mlm = mlm_loss(params, cfg, mlm_inputs, mask, image_embeds, mlm_labels, m_params=m_params,
                        image_embeds_m=mfeats["image_embeds"], alpha=alpha)
    losses = {"loss": loss_itc + loss_itm + loss_mlm, "loss_itc": loss_itc, "loss_itm": loss_itm,
              "loss_mlm": loss_mlm}
    return losses, m_params, state


def vqa_train_loss(params: Params, cfg: AlbefConfig, pixels: torch.Tensor, q_ids: torch.Tensor, q_mask: torch.Tensor,
                   answer_ids: torch.Tensor, answer_mask: torch.Tensor, n_answers: Sequence[int],
                   weights: torch.Tensor, *, m_params: Optional[Params] = None, alpha: float = 0.0,
                   pad_token_id: int = 0) -> torch.Tensor:
    """ALBEF's VQA objective (albef_vqa.py): the fused question states tiled
    per answer, the label-smoothed answer LM loss with optional momentum
    distillation (per sample (1-α)·lm + α·distill), weighted and averaged
    over the question batch."""
    fused = fused_encode(params, cfg, pixels, q_ids, q_mask)
    rep = torch.from_numpy(np.repeat(np.arange(len(n_answers)), np.asarray(n_answers))).to(pixels.device)
    smask = q_mask[rep]
    targets = torch.where(answer_ids == pad_token_id, -100, answer_ids)
    h = med_forward(params["decoder"], cfg.decoder, answer_ids, answer_mask, encoder_states=fused[rep],
                    encoder_mask=smask, causal=True)
    logits = med_logits(params["decoder"], h)
    loss = lm_loss_per_sample(logits, targets, cfg.label_smoothing)
    if m_params is not None and alpha > 0.0:
        with torch.no_grad():
            fused_m = fused_encode(m_params, cfg, pixels, q_ids, q_mask)
            h_m = med_forward(m_params["decoder"], cfg.decoder, answer_ids, answer_mask,
                              encoder_states=fused_m[rep], encoder_mask=smask, causal=True)
            soft = torch.softmax(med_logits(m_params["decoder"], h_m)[:, :-1], dim=-1)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        valid = targets[:, 1:] != -100
        distill = torch.where(valid, -(soft * logp).sum(-1), 0.0).sum(-1)
        loss = (1.0 - alpha) * loss + alpha * distill
    return (weights * loss).sum() / pixels.shape[0]
