"""BLIP variants: retrieval training, VQA, classification, NLVR2 and
pretraining (torch twin of llava_align_tpu/models/blip_variants.py).

Capability parity: the reference's vendored LAVIS BLIP family beyond the
caption / ITM / feature trio of models/blip.py: blip_retrieval.py (ITC with
momentum queues + ITM with hard negatives), blip_vqa.py (a multimodal
question encoder + an answer decoder: greedy generation and two-stage
answer ranking), blip_classification.py (a fused cls head), blip_nlvr.py +
nlvr_encoder.py (every layer carries twin cross-attentions over the two
images, averaged below `merge_from` and merge-projected from it) and
blip_pretrain.py (ITC + ITM + captioning LM).

As in models/albef, the momentum tree and the queue state are updated in
place and returned, and hard negatives are drawn from a torch.Generator
unless `neg_idx` hands the draw in. The JAX package's `negative_all_rank`
/ `axis_name` (negatives mined over a shard_map's gathered batch) is not
ported: one process mines its own batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.models import blip as blip_mod
from llava_align_tpu_torch.models.albef import (
    distilled_ce,
    draw_negatives,
    enqueue,
    init_queue_state,
    itm_loss,
    lm_loss_per_sample,
    momentum_update,
    rank_answers_from_states,
    soft_itc_loss,
)
from llava_align_tpu_torch.models.blip import (
    BlipConfig,
    _init_tools,
    _lin,
    _ln,
    attend,
    decode_step,
    init_self_cache,
    linear_init,
    mask_bias,
    med_embed,
    med_forward,
    med_init,
    med_logits,
    precompute_cross_kv,
    vit_forward,
    vit_init,
)
from llava_align_tpu_torch.ops.layers import gelu_exact
from llava_align_tpu_torch.ops.layers import l2_normalize as _norm
from llava_align_tpu_torch.ops.layers import linear_bias as _proj

Params = Dict[str, Any]

__all__ = [
    "init_retrieval", "retrieval_train_step", "init_queue_state",
    "init_vqa", "vqa_rank_answers", "vqa_generate",
    "init_classification", "classification_loss", "classify",
    "NlvrConfig", "init_nlvr", "nlvr_forward", "nlvr_encode", "nlvr_loss",
    "pretrain_step",
]


def _itc_feats(params: Params, cfg: BlipConfig, pixels, ids, mask):
    enc = vit_forward(params["visual"], cfg.vision, pixels)
    te = med_forward(params["text"], cfg.text, ids, mask, mode="text")
    return enc, _norm(_proj(enc[:, 0], params["vision_proj"])), te, _norm(_proj(te[:, 0], params["text_proj"]))


def init_retrieval(cfg: BlipConfig, temp: float = 0.07, device=None, seed: int = 0) -> Params:
    p = blip_mod.init(cfg, device, seed)
    p["temp"] = torch.tensor(temp, dtype=torch.float32, device=p["text_proj"]["w"].device)
    return p


def retrieval_train_step(params: Params, m_params: Params, state: Dict[str, torch.Tensor], cfg: BlipConfig,
                         generator: Optional[torch.Generator], pixels: torch.Tensor, ids: torch.Tensor,
                         enc_ids: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, *, alpha: float = 0.4,
                         momentum: float = 0.995, queue_size: Optional[int] = None,
                         return_image_embeds: bool = False, neg_idx=None):
    """One BLIP retrieval forward (blip_retrieval.py): ITC against the
    momentum + queue features with soft distilled targets, ITM over the
    positives and hard-mined negatives (`enc_ids`: the captions with [ENC]
    first) → (losses, m_params, state[, image_embeds]), the middle two
    updated in place."""
    bs = pixels.shape[0]
    temp = params["temp"].clamp(0.001, 0.5)
    Q = queue_size if queue_size is not None else state["image_queue"].shape[1]
    image_embeds, image_feat, text_embeds, text_feat = _itc_feats(params, cfg, pixels, ids, mask)
    idx = idx.reshape(-1, 1)
    idx_all = torch.cat([idx.t().to(state["idx_queue"].dtype), state["idx_queue"]], dim=1)
    pos = (idx == idx_all).float()
    sim_targets = pos / pos.sum(1, keepdim=True)

    m_params = momentum_update(params, m_params, momentum)
    with torch.no_grad():
        _, image_feat_m, _, text_feat_m = _itc_feats(m_params, cfg, pixels, ids, mask)
        image_feat_m_all = torch.cat([image_feat_m.t().float(), state["image_queue"].float()], dim=1)
        text_feat_m_all = torch.cat([text_feat_m.t().float(), state["text_queue"].float()], dim=1)
        i2t_tgt = alpha * torch.softmax(image_feat_m.float() @ text_feat_m_all / temp, dim=1)
        i2t_tgt = i2t_tgt + (1 - alpha) * sim_targets
        t2i_tgt = alpha * torch.softmax(text_feat_m.float() @ image_feat_m_all / temp, dim=1)
        t2i_tgt = t2i_tgt + (1 - alpha) * sim_targets
    sim_i2t = image_feat.float() @ text_feat_m_all / temp
    sim_t2i = text_feat.float() @ image_feat_m_all / temp
    loss_itc = soft_itc_loss(sim_i2t, sim_t2i, i2t_tgt, t2i_tgt)
    state = enqueue(state, Q, image_feat_m, text_feat_m, idx)

    # ITM (blip_retrieval.py): the positives, then hard negatives
    am = torch.ones(image_embeds.shape[:2], dtype=torch.int32, device=pixels.device)
    pos_out = med_forward(params["text"], cfg.text, enc_ids, mask, encoder_states=image_embeds, encoder_mask=am)
    with torch.no_grad():
        same = idx == idx.t()
        w_i2t = torch.softmax(image_feat @ text_feat.t() / temp, dim=1).masked_fill(same, 0.0)
        w_t2i = torch.softmax(text_feat @ image_feat.t() / temp, dim=1).masked_fill(same, 0.0)
    neg_img, neg_txt = draw_negatives(generator, w_t2i, w_i2t, neg_idx)
    text_ids_all = torch.cat([enc_ids, enc_ids[neg_txt]], dim=0)
    text_mask_all = torch.cat([mask, mask[neg_txt]], dim=0)
    image_embeds_all = torch.cat([image_embeds[neg_img], image_embeds], dim=0)
    am2 = torch.ones(image_embeds_all.shape[:2], dtype=torch.int32, device=pixels.device)
    neg_out = med_forward(params["text"], cfg.text, text_ids_all, text_mask_all, encoder_states=image_embeds_all,
                          encoder_mask=am2)
    loss_itm = itm_loss(torch.cat([pos_out[:, 0], neg_out[:, 0]], dim=0), params["itm_head"], bs)
    losses = {"loss": loss_itc + loss_itm, "loss_itc": loss_itc, "loss_itm": loss_itm}
    if return_image_embeds:
        return losses, m_params, state, image_embeds
    return losses, m_params, state


# ---------------------------------------------------------------------------
# VQA (blip_vqa.py)
# ---------------------------------------------------------------------------


def init_vqa(cfg: BlipConfig, device=None, seed: int = 0) -> Params:
    return {"visual": vit_init(cfg.vision, device, seed), "text": med_init(cfg.text, device, seed + 1),
            "decoder": med_init(cfg.text, device, seed + 2)}


def _question_states(params: Params, cfg: BlipConfig, pixels, q_ids, q_mask) -> torch.Tensor:
    enc = vit_forward(params["visual"], cfg.vision, pixels)
    am = torch.ones(enc.shape[:2], dtype=torch.int32, device=enc.device)
    return med_forward(params["text"], cfg.text, q_ids, q_mask, encoder_states=enc, encoder_mask=am)


@torch.inference_mode()
def vqa_rank_answers(params: Params, cfg: BlipConfig, pixels: torch.Tensor, q_ids: torch.Tensor,
                     q_mask: torch.Tensor, answer_ids: torch.Tensor, answer_mask: torch.Tensor, *,
                     num_ans_candidates: int = 128, pad_token_id: int = 0, label_smoothing: float = 0.1) -> np.ndarray:
    """blip_vqa.py rank_answers: ALBEF's two-stage ranking over the question
    states of the multimodal BLIP encoder (q_ids lead with [ENC])."""
    fused = _question_states(params, cfg, pixels, q_ids, q_mask)
    return rank_answers_from_states(params, cfg, fused, q_mask, answer_ids, answer_mask,
                                    num_ans_candidates=num_ans_candidates, pad_token_id=pad_token_id,
                                    dec_cfg=cfg.text, label_smoothing=label_smoothing)


@torch.inference_mode()
def vqa_generate(params: Params, cfg: BlipConfig, pixels: torch.Tensor, q_ids: torch.Tensor, q_mask: torch.Tensor,
                 *, bos_token_id: int = 30522, eos_token_id: int = 102, max_new_tokens: int = 10) -> List[List[int]]:
    """Open-ended answers (blip_vqa.py generate): greedy decoding with
    cross-attention over the fused question states."""
    fused = _question_states(params, cfg, pixels, q_ids, q_mask)
    B, dev = fused.shape[0], fused.device
    cross = precompute_cross_kv(params["decoder"], cfg.text, fused)
    cache = init_self_cache(cfg.text, B, max_new_tokens + 1, dev)
    token = torch.full((B,), bos_token_id, dtype=torch.long, device=dev)
    done = np.zeros((B,), bool)
    rows = []
    for t in range(max_new_tokens):
        logits, cache = decode_step(params["decoder"], cfg.text, token, t, cache, cross, q_mask)
        nxt = np.where(done, eos_token_id, logits.argmax(-1).cpu().numpy())
        rows.append(nxt)
        done |= nxt == eos_token_id
        token = torch.from_numpy(nxt).to(dev)
        if done.all():
            break
    ids = np.stack(rows, axis=1) if rows else np.zeros((B, 0), np.int64)
    return blip_mod._strip_eos([[int(x) for x in r] for r in ids], eos_token_id)


# ---------------------------------------------------------------------------
# classification (blip_classification.py)
# ---------------------------------------------------------------------------


def init_classification(cfg: BlipConfig, num_classes: int, device=None, seed: int = 0) -> Params:
    if num_classes < 2:
        raise ValueError(f"num_classes must be >1, got {num_classes}")
    device, w = _init_tools(device, seed + 2)
    D, dt = cfg.text.hidden_size, cfg.text.dtype
    return {"visual": vit_init(cfg.vision, device, seed), "text": med_init(cfg.text, device, seed + 1),
            "cls_head": {"fc1": linear_init(w, D, D, dt, device), "fc2": linear_init(w, num_classes, D, dt, device)}}


def classify(params: Params, cfg: BlipConfig, pixels, ids, mask) -> torch.Tensor:
    h = _question_states(params, cfg, pixels, ids, mask)
    c = params["cls_head"]
    return _proj(torch.relu(_proj(h[:, 0], c["fc1"])), c["fc2"])


def classification_loss(params: Params, cfg: BlipConfig, pixels, ids, mask, targets, *,
                        m_params: Optional[Params] = None, alpha: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1-α)·CE + α·distillation (blip_classification.py) → (loss, fp32
    logits)."""
    logits = classify(params, cfg, pixels, ids, mask).float()
    logits_m = None
    if m_params is not None and alpha != 0.0:
        with torch.no_grad():
            logits_m = classify(m_params, cfg, pixels, ids, mask).float()
    return distilled_ce(logits, targets, logits_m, alpha), logits


# ---------------------------------------------------------------------------
# NLVR2 (blip_nlvr.py + nlvr_encoder.py: twin cross-attention in each layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NlvrConfig:
    base: BlipConfig = dataclasses.field(default_factory=BlipConfig)
    num_classes: int = 2
    merge_from: int = 6  # layers >= merge_from concat + project (nlvr_encoder.py)

    @staticmethod
    def tiny(vocab_size: int = 64) -> "NlvrConfig":
        return NlvrConfig(base=BlipConfig.tiny(vocab_size), merge_from=1)


def init_nlvr(cfg: NlvrConfig, device=None, seed: int = 0) -> Params:
    device, w = _init_tools(device, seed + 2)
    t = cfg.base.text
    D, L, dt = t.hidden_size, t.num_layers, t.dtype
    base = med_init(t, device, seed + 1)

    def lin(o, i):
        return {"w": w((L, o, i), i, dt), "b": torch.zeros((L, o), dtype=dt, device=device)}

    layers = dict(base["layers"])
    for tw in ("0", "1"):  # the twin cross stacks: self0/self1, dense0/dense1
        for name in ("q", "k", "v"):
            layers[f"c{tw}{name}"] = lin(D, D)
        layers[f"d{tw}"] = lin(D, D)
    layers["merge"] = lin(D, 2 * D)
    for k in ("cq", "ck", "cv", "co"):
        layers.pop(k, None)
    base["layers"] = layers
    return {"visual": vit_init(cfg.base.vision, device, seed), "text": base,
            "cls_head": {"fc1": linear_init(w, D, D, dt, device),
                         "fc2": linear_init(w, cfg.num_classes, D, dt, device)}}


def nlvr_encode(params: Params, cfg: NlvrConfig, e0: torch.Tensor, e1: torch.Tensor, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """The twin-cross text encoder over precomputed image states → [B, S, D]:
    each layer attends both images; their dense outputs are averaged below
    merge_from, concatenated and merge-projected from it."""
    t = cfg.base.text
    H, eps = t.num_heads, t.layer_norm_eps
    B, S = ids.shape
    x = med_embed(params["text"], t, ids, torch.arange(S, device=ids.device)[None])
    smask = mask_bias(mask[:, None, :].bool())
    lay = params["text"]["layers"]
    for li in range(t.num_layers):
        a = attend(_lin(x, lay["sq"], li), _lin(x, lay["sk"], li), _lin(x, lay["sv"], li), H, smask)
        x = _ln(x + _lin(a, lay["so"], li), lay["s_ln"], eps, li)
        h0 = _lin(attend(_lin(x, lay["c0q"], li), _lin(e0, lay["c0k"], li), _lin(e0, lay["c0v"], li), H),
                  lay["d0"], li)
        h1 = _lin(attend(_lin(x, lay["c1q"], li), _lin(e1, lay["c1k"], li), _lin(e1, lay["c1v"], li), H),
                  lay["d1"], li)
        merged = _lin(torch.cat([h0, h1], dim=-1), lay["merge"], li)
        merge_f = 1.0 if li >= cfg.merge_from else 0.0
        h = merge_f * merged + (1.0 - merge_f) * ((h0 + h1) / 2)
        x = _ln(x + h, lay["c_ln"], eps, li)
        f = _lin(gelu_exact(_lin(x, lay["fc1"], li)), lay["fc2"], li)
        x = _ln(x + f, lay["f_ln"], eps, li)
    return x


def nlvr_forward(params: Params, cfg: NlvrConfig, pixels0: torch.Tensor, pixels1: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """blip_nlvr.py forward over the twin-cross encoder → [B, num_classes]."""
    enc = vit_forward(params["visual"], cfg.base.vision, torch.cat([pixels0, pixels1], dim=0))
    b = pixels0.shape[0]
    x = nlvr_encode(params, cfg, enc[:b], enc[b:], ids, mask)
    c = params["cls_head"]
    return _proj(torch.relu(_proj(x[:, 0], c["fc1"])), c["fc2"])


def nlvr_loss(params: Params, cfg: NlvrConfig, pixels0, pixels1, ids, mask,
              targets) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = nlvr_forward(params, cfg, pixels0, pixels1, ids, mask)
    return distilled_ce(logits, targets, None, 0.0), logits


# ---------------------------------------------------------------------------
# pretraining (blip_pretrain.py): ITC + ITM + LM
# ---------------------------------------------------------------------------


def pretrain_step(params: Params, m_params: Params, state: Dict[str, torch.Tensor], cfg: BlipConfig,
                  generator: Optional[torch.Generator], pixels: torch.Tensor, ids: torch.Tensor, enc_ids: torch.Tensor,
                  dec_ids: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, *, alpha: float = 0.4,
                  momentum: float = 0.995, pad_token_id: int = 0, neg_idx=None):
    """blip_pretrain.py forward: the retrieval ITC/ITM losses plus the
    captioning LM loss on [DEC]-led ids (pads → -100), a token mean over
    the whole batch; the image is encoded once for both. `params` needs
    the retrieval tree plus a "decoder" MED."""
    losses, m_params, state, enc = retrieval_train_step(params, m_params, state, cfg, generator, pixels, ids,
                                                        enc_ids, mask, idx, alpha=alpha, momentum=momentum,
                                                        return_image_embeds=True, neg_idx=neg_idx)
    am = torch.ones(enc.shape[:2], dtype=torch.int32, device=enc.device)
    targets = torch.where(dec_ids == pad_token_id, -100, dec_ids)
    h = med_forward(params["decoder"], cfg.text, dec_ids, mask, encoder_states=enc, encoder_mask=am, causal=True)
    per = lm_loss_per_sample(med_logits(params["decoder"], h), targets, 0.1)
    loss_lm = per.sum() / (targets[:, 1:] != -100).sum().clamp(min=1)
    losses = dict(losses, loss_lm=loss_lm, loss=losses["loss"] + loss_lm)
    return losses, m_params, state
