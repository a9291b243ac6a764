"""ALPRO: video-text retrieval and video QA on TimeSformer + a fusion BERT
(torch twin of llava_align_tpu/models/alpro.py).

Capability parity: the reference's vendored LAVIS ALPRO stack
(lavis/models/alpro_models/{alpro_retrieval.py, alpro_qa.py} on the
bert_config_alpro.json fusion BERT: fusion_layer=6 and no cross-attention;
fusion is self-attention over the concatenated [text; video] embeddings).
The text and fusion halves are models/blip.med_forward in its "text" and
"fusion" modes; the video tower is models/timesformer. Plain torch: no
kernel of the port lies on these paths.

retrieval_train_step is differentiable (call it under autograd). Its
hard negatives are drawn from `generator` (ops/layers.
sample_hard_negative_indices), or given as `neg_idx` = (negative video per
text, negative text per video). One departure: the JAX step's `axis_name`
all-gather of the features across a data-parallel mesh is not ported; the
VTC loss runs over the local batch, as the JAX step does without it.

compute_sim_matrix ranks each row's re-rank candidates with numpy's
argsort of the host copy of the VTC similarities, as the JAX package does,
so both pick the same candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llava_align_tpu_torch.models import timesformer as tsf
from llava_align_tpu_torch.models.blip import MedConfig, linear_init, med_forward, med_init
from llava_align_tpu_torch.models.timesformer import TimeSformerConfig
from llava_align_tpu_torch.ops.layers import l2_normalize as _norm
from llava_align_tpu_torch.ops.layers import linear_bias as _proj
from llava_align_tpu_torch.ops.layers import sample_hard_negative_indices
from llava_align_tpu_torch.utils.synthetic import normal_init, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AlproConfig:
    video: TimeSformerConfig = dataclasses.field(default_factory=TimeSformerConfig)
    # bert_config_alpro.json: 12 layers, fusion at 6, no cross-attention
    text: MedConfig = dataclasses.field(default_factory=lambda: MedConfig(vocab_size=30522, fusion_layer=6))
    embed_dim: int = 256
    num_classes: int = 0
    temp: float = 0.07

    @staticmethod
    def tiny(vocab_size: int = 64, num_classes: int = 0) -> "AlproConfig":
        return AlproConfig(
            video=TimeSformerConfig.tiny(),
            text=MedConfig(vocab_size=vocab_size, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
                           max_position_embeddings=64, fusion_layer=2),
            embed_dim=16, num_classes=num_classes)


def init(cfg: AlproConfig, variant: str = "retrieval", device=None, seed: int = 0) -> Params:
    """variant ∈ {retrieval, qa}: the JAX init's tree and scales, torch's
    random numbers from `seed`."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 2), device)
    D, E, dt = cfg.text.hidden_size, cfg.embed_dim, cfg.text.dtype
    p: Params = {"visual": tsf.init(cfg.video, device, seed), "text": med_init(cfg.text, device, seed + 1)}
    if variant == "retrieval":
        p["vision_proj"] = linear_init(w, E, cfg.video.hidden_size, dt, device)
        p["text_proj"] = linear_init(w, E, D, dt, device)
        p["itm_head"] = linear_init(w, 2, D, dt, device)
        p["temp"] = torch.tensor(cfg.temp, dtype=torch.float32, device=device)
    if variant == "qa":
        if cfg.num_classes < 2:
            raise ValueError(f"num_classes must be >1 for qa, got {cfg.num_classes}")
        # Linear(D, 2D) → ReLU → Linear(2D, C) (alpro_qa.py:41-45)
        p["classifier"] = {"fc1": linear_init(w, 2 * D, D, dt, device),
                           "fc2": linear_init(w, cfg.num_classes, 2 * D, dt, device)}
    return p


def encode_text(params: Params, cfg: AlproConfig, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """forward_text: the pre-fusion layers only (alpro_qa.py:71-77)."""
    return med_forward(params["text"], cfg.text, ids, mask, mode="text")


def encode_video(params: Params, cfg: AlproConfig, video: torch.Tensor) -> torch.Tensor:
    """[B, 3, T, H, W] → frame-pooled [B, 1+N, D] (alpro_qa.py:80-84)."""
    return tsf.forward_features(params["visual"], cfg.video, video, pool_frames=True)


def fuse(params: Params, cfg: AlproConfig, text_embeds: torch.Tensor, text_mask: torch.Tensor,
         video_embeds: torch.Tensor) -> torch.Tensor:
    """The fusion layers over the concatenated [text; video] sequence
    (alpro_qa.py:87-96, alpro_retrieval.py:155-165) → [B, St+Sv, D]."""
    video_mask = torch.ones(video_embeds.shape[:2], dtype=text_mask.dtype, device=text_mask.device)
    return med_forward(params["text"], cfg.text, None, torch.cat([text_mask, video_mask], dim=1), mode="fusion",
                       input_embeds=torch.cat([text_embeds, video_embeds], dim=1))


# ---------------------------------------------------------------------------
# QA
# ---------------------------------------------------------------------------


def qa_logits(params: Params, cfg: AlproConfig, video: torch.Tensor, ids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """alpro_qa.py:65-96 → [B, num_classes]."""
    h = fuse(params, cfg, encode_text(params, cfg, ids, mask), mask, encode_video(params, cfg, video))
    c = params["classifier"]
    return _proj(torch.relu(_proj(h[:, 0], c["fc1"])), c["fc2"])


def qa_loss(params: Params, cfg: AlproConfig, video: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
            targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy over the answer classes, logits)."""
    logits = qa_logits(params, cfg, video, ids, mask)
    return F.cross_entropy(logits.float(), targets.long()), logits


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------


def vtc_features(params: Params, cfg: AlproConfig, video: Optional[torch.Tensor] = None,
                 ids: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """video_embeds / video_feat (the normalized cls projection) and
    text_embeds / text_feat, for whichever inputs are given."""
    out: Dict[str, torch.Tensor] = {}
    if video is not None:
        ve = encode_video(params, cfg, video)
        out["video_embeds"] = ve
        out["video_feat"] = _norm(_proj(ve[:, 0], params["vision_proj"]))
    if ids is not None:
        te = encode_text(params, cfg, ids, mask)
        out["text_embeds"] = te
        out["text_feat"] = _norm(_proj(te[:, 0], params["text_proj"]))
    return out


def retrieval_train_step(params: Params, cfg: AlproConfig, generator: Optional[torch.Generator],
                         video: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
                         neg_idx=None) -> Dict[str, torch.Tensor]:
    """One ALPRO retrieval forward (alpro_retrieval.py:65-149): in-batch VTC
    + VTM with in-batch hard negatives → {loss, loss_vtc, loss_vtm}."""
    temp = params["temp"].clamp(0.001, 0.5)
    feats = vtc_features(params, cfg, video=video, ids=ids, mask=mask)
    video_feat, text_feat = feats["video_feat"], feats["text_feat"]
    b = video_feat.shape[0]
    sim_v2t = video_feat.float() @ text_feat.float().t() / temp
    sim_t2v = text_feat.float() @ video_feat.float().t() / temp
    diag = torch.arange(b, device=video.device)
    vtc = (F.cross_entropy(sim_v2t, diag) + F.cross_entropy(sim_t2v, diag)) / 2

    # VTM with in-batch hard negatives (alpro_retrieval.py:150-240)
    text_embeds, video_embeds = feats["text_embeds"], feats["video_embeds"]
    pos = fuse(params, cfg, text_embeds, mask, video_embeds)
    with torch.no_grad():
        eye = torch.eye(b, dtype=torch.bool, device=video.device)
        w_v2t = torch.softmax(sim_v2t.masked_fill(eye, -torch.inf), dim=1)
        w_t2v = torch.softmax(sim_t2v.masked_fill(eye, -torch.inf), dim=1)
    if neg_idx is not None:
        neg_vid, neg_txt = (torch.as_tensor(n, device=video.device).long() for n in neg_idx)
    else:  # videos first, as the JAX step splits its key
        neg_vid = sample_hard_negative_indices(generator, w_t2v)
        neg_txt = sample_hard_negative_indices(generator, w_v2t)
    neg = fuse(params, cfg, torch.cat([text_embeds, text_embeds[neg_txt]], dim=0),
               torch.cat([mask, mask[neg_txt]], dim=0), torch.cat([video_embeds[neg_vid], video_embeds], dim=0))
    vtm_logits = _proj(torch.cat([pos[:, 0], neg[:, 0]], dim=0), params["itm_head"])
    vtm_labels = torch.cat([torch.ones(b, dtype=torch.long, device=video.device),
                            torch.zeros(2 * b, dtype=torch.long, device=video.device)])
    vtm = F.cross_entropy(vtm_logits.float(), vtm_labels)
    return {"loss": vtc + vtm, "loss_vtc": vtc, "loss_vtm": vtm}


def _vtm_score(params: Params, cfg: AlproConfig, te: torch.Tensor, tm: torch.Tensor, ve: torch.Tensor) -> np.ndarray:
    return _proj(fuse(params, cfg, te, tm, ve)[:, 0], params["itm_head"])[:, 1].float().cpu().numpy()


@torch.inference_mode()
def compute_sim_matrix(params: Params, cfg: AlproConfig, videos: torch.Tensor, text_ids: torch.Tensor,
                       text_mask: torch.Tensor, *, k_test: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(scores_v2t [Nv, Nt], scores_t2v [Nt, Nv]): the VTC similarity; with
    k_test > 0 each row's top k_test pairs get sim + the VTM head's
    logit[1] over the fused pair, the rest -100 (alpro_retrieval.py:242-396).
    The TimeSformer runs once; the re-rank reuses its embeddings."""
    feats = vtc_features(params, cfg, video=videos, ids=text_ids, mask=text_mask)
    sims = feats["video_feat"].float().cpu().numpy() @ feats["text_feat"].float().cpu().numpy().T
    if k_test <= 0:
        return sims, sims.T
    video_embeds, text_embeds = feats["video_embeds"], feats["text_embeds"]
    dev = text_embeds.device
    Nv, Nt = sims.shape
    k = min(k_test, Nt)
    v2t = np.full_like(sims, -100.0)
    for i in range(Nv):
        topk = np.argsort(sims[i])[::-1][:k].copy()
        sel = torch.from_numpy(topk).to(dev)
        score = _vtm_score(params, cfg, text_embeds[sel], text_mask[sel],
                           video_embeds[i : i + 1].repeat_interleave(k, dim=0))
        v2t[i, topk] = sims[i, topk] + score
    kt = min(k_test, Nv)
    t2v = np.full_like(sims.T, -100.0)
    for t in range(Nt):
        topk = np.argsort(sims[:, t])[::-1][:kt].copy()
        sel = torch.from_numpy(topk).to(dev)
        score = _vtm_score(params, cfg, text_embeds[t : t + 1].repeat_interleave(kt, dim=0),
                           text_mask[t : t + 1].repeat_interleave(kt, dim=0), video_embeds[sel])
        t2v[t, topk] = sims[topk, t] + score
    return v2t, t2v
