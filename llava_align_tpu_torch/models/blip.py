"""BLIP base (ViT + MED BERT): captioning, image-text matching, features,
GradCAM and sampled captions (torch twin of llava_align_tpu/models/blip.py).

Capability parity: the reference's vendored LAVIS BLIP family
(lavis/models/blip_models/blip_caption.py, blip_image_text_matching.py,
blip_feature_extractor.py) on lavis/models/vit.py (a timm ViT) and
lavis/models/med.py (BERT with cross-attention, a fork of HF Bert).

Layers are stacked on a leading [L] axis, as in the JAX package, and run in
a Python loop. Attention is ops.attention.mha with an additive fp32 bias (0
where a key is attended, NEG where it is masked), shaped
[B, 1, 1, Sq|1, Sk] so that it broadcasts over the heads; softmax and the
norms accumulate in fp32. Captioning keeps a self K/V cache and the
cross-attention K/V computed once (precompute_cross_kv), as models/t5.py
does; beams go through decoding/beam.make_beam_fn.

Param tree (linears {w [out, in], b [out]}):
    visual:  cls [1, 1, D], pos [1, 1+N, D], patch {w [D, 3, P, P], b [D]},
             layers/{ln1, ln2} {scale, bias [L, D]},
             layers/{q, k, v, o, fc1, fc2} {w [L, out, in], b [L, out]},
             final_ln {scale, bias}
    text (MED): embeddings/{word [V, D], pos [P, D], type [2, D], ln},
             layers/{sq, sk, sv, so, cq, ck, cv, co, fc1, fc2} {w, b},
             layers/{s_ln, c_ln, f_ln} {scale, bias},
             head/{transform {w, b}, ln, decoder [V, D], bias [V]}
    vision_proj, text_proj {w [E, *], b [E]}, itm_head {w [2, D], b [2]}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.models.clip_vit import patchify
from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import gelu_exact, layer_norm
from llava_align_tpu_torch.utils.synthetic import normal_init, resolve_device

Params = Dict[str, Any]
NEG = -1e30


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlipVitConfig:
    image_size: int = 224
    patch_size: int = 16
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
    def tiny() -> "BlipVitConfig":
        return BlipVitConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)


@dataclasses.dataclass(frozen=True)
class MedConfig:
    vocab_size: int = 30524  # bert-base-uncased + [DEC]/[ENC]
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32
    # ALBEF's fusion point (med.py BertLayer: cross-attention only in layers
    # >= fusion_layer; mode "text" runs [0, fusion_layer), "fusion"
    # [fusion_layer, L)). None: BLIP, cross-attention in every layer.
    fusion_layer: Optional[int] = None
    # med.py adds the token-type vector only when token_type_ids are passed:
    # BLIP callers never pass them (False), ALPRO passes zeros (True).
    use_type_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 64) -> "MedConfig":
        return MedConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, max_position_embeddings=64)


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: BlipVitConfig = dataclasses.field(default_factory=BlipVitConfig)
    text: MedConfig = dataclasses.field(default_factory=lambda: MedConfig(use_type_embeddings=False))
    embed_dim: int = 256  # ITC projection width

    @staticmethod
    def tiny(vocab_size: int = 64) -> "BlipConfig":
        return BlipConfig(vision=BlipVitConfig.tiny(),
                          text=dataclasses.replace(MedConfig.tiny(vocab_size), use_type_embeddings=False),
                          embed_dim=16)


# ---------------------------------------------------------------------------
# inits (the JAX inits' trees and scales; the random numbers are torch's)
# ---------------------------------------------------------------------------


def _init_tools(device, seed: int):
    device = resolve_device(device)
    return device, normal_init(torch.Generator(device=device).manual_seed(seed), device)


def vit_init(cfg: BlipVitConfig, device=None, seed: int = 0) -> Params:
    device, w = _init_tools(device, seed)
    D, F, L, P, dt = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers, cfg.patch_size, cfg.dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ln(*lead):
        return {"scale": torch.ones(lead + (D,), dtype=dt, device=device), "bias": zeros(*lead, D)}

    def lin(o, i):
        return {"w": w((L, o, i), i, dt), "b": zeros(L, o)}

    return {
        "cls": w((1, 1, D), D, dt),
        "pos": w((1, cfg.num_patches + 1, D), D, dt),
        "patch": {"w": w((D, 3, P, P), 3 * P * P, dt), "b": zeros(D)},
        "layers": {"ln1": ln(L), "q": lin(D, D), "k": lin(D, D), "v": lin(D, D), "o": lin(D, D),
                   "ln2": ln(L), "fc1": lin(F, D), "fc2": lin(D, F)},
        "final_ln": ln(),
    }


def med_init(cfg: MedConfig, device=None, seed: int = 0) -> Params:
    device, w = _init_tools(device, seed)
    D, F, L, V, dt = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size, cfg.dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ln(*lead):
        return {"scale": torch.ones(lead + (D,), dtype=dt, device=device), "bias": zeros(*lead, D)}

    def lin(o, i):
        return {"w": w((L, o, i), i, dt), "b": zeros(L, o)}

    return {
        "embeddings": {"word": w((V, D), D, dt), "pos": w((cfg.max_position_embeddings, D), D, dt),
                       "type": zeros(2, D), "ln": ln()},
        "layers": {"sq": lin(D, D), "sk": lin(D, D), "sv": lin(D, D), "so": lin(D, D), "s_ln": ln(L),
                   "cq": lin(D, D), "ck": lin(D, D), "cv": lin(D, D), "co": lin(D, D), "c_ln": ln(L),
                   "fc1": lin(F, D), "fc2": lin(D, F), "f_ln": ln(L)},
        "head": {"transform": {"w": w((D, D), D, dt), "b": zeros(D)}, "ln": ln(),
                 "decoder": w((V, D), D, dt), "bias": zeros(V)},
    }


def linear_init(w, o: int, i: int, dt, device) -> Params:
    """{w [o, i] ~ N(0, 1/i), b zeros}: the heads' init."""
    return {"w": w((o, i), i, dt), "b": torch.zeros((o,), dtype=dt, device=device)}


def init(cfg: BlipConfig, device=None, seed: int = 0) -> Params:
    device, w = _init_tools(device, seed + 2)
    D, E, dt = cfg.text.hidden_size, cfg.embed_dim, cfg.text.dtype
    return {
        "visual": vit_init(cfg.vision, device, seed),
        "text": med_init(cfg.text, device, seed + 1),
        "vision_proj": linear_init(w, E, cfg.vision.hidden_size, dt, device),
        "text_proj": linear_init(w, E, D, dt, device),
        "itm_head": linear_init(w, 2, D, dt, device),
    }


# ---------------------------------------------------------------------------
# the ViT (pre-LN blocks, cls token) and MED BERT (post-LN, optional causal
# self-attention and cross-attention)
# ---------------------------------------------------------------------------


def _lin(h: torch.Tensor, p: Params, li: Optional[int] = None) -> torch.Tensor:
    w, b = (p["w"], p["b"]) if li is None else (p["w"][li], p["b"][li])
    return h @ w.t() + b


def _ln(x: torch.Tensor, p: Params, eps: float, li: Optional[int] = None) -> torch.Tensor:
    s, b = (p["scale"], p["bias"]) if li is None else (p["scale"][li], p["bias"][li])
    return layer_norm(x, s, b, eps)


def mask_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sq|1, Sk] bool (True = attend) → the additive fp32 bias mha takes,
    [B, 1, 1, Sq|1, Sk]; None stays None (attend everywhere)."""
    if mask is None:
        return None
    return torch.where(mask, 0.0, NEG).to(torch.float32)[:, None, None]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Sq, D], k/v [B, Sk, D] → [B, Sq, D]; fp32 softmax."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    Dh = D // H
    out = mha(q.reshape(B, Sq, H, Dh), k.reshape(B, Sk, H, Dh), v.reshape(B, Sk, H, Dh), causal=False, bias=bias)
    return out.reshape(B, Sq, D)


def vit_forward(params: Params, cfg: BlipVitConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W] → [B, 1+N, D] (after the final LN). The patch
    conv (stride = kernel) is patchify + one matmul."""
    B = pixels.shape[0]
    D, H, eps = cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps
    pw = params["patch"]["w"]
    x = patchify(pixels.to(cfg.dtype), cfg.patch_size) @ pw.reshape(D, -1).t() + params["patch"]["b"]
    x = torch.cat([params["cls"].expand(B, 1, D), x], dim=1) + params["pos"]
    lay = params["layers"]
    for li in range(cfg.num_layers):
        h = _ln(x, lay["ln1"], eps, li)
        a = attend(_lin(h, lay["q"], li), _lin(h, lay["k"], li), _lin(h, lay["v"], li), H)
        x = x + _lin(a, lay["o"], li)
        h = _ln(x, lay["ln2"], eps, li)
        x = x + _lin(gelu_exact(_lin(h, lay["fc1"], li)), lay["fc2"], li)
    return _ln(x, params["final_ln"], eps)


def med_embed(params: Params, cfg: MedConfig, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    e = params["embeddings"]
    x = e["word"][ids.long().clamp(0, cfg.vocab_size - 1)] + e["pos"][positions]
    if cfg.use_type_embeddings:
        x = x + e["type"][0]
    return _ln(x, e["ln"], cfg.layer_norm_eps)


def _ffn(x: torch.Tensor, lay: Params, li: int, eps: float) -> torch.Tensor:
    f = _lin(gelu_exact(_lin(x, lay["fc1"], li)), lay["fc2"], li)
    return _ln(x + f, lay["f_ln"], eps, li)


def med_forward(params: Params, cfg: MedConfig, ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, encoder_states=None, encoder_mask=None, *,
                causal: bool = False, mode: str = "multimodal",
                input_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (non-incremental) pass → hidden [B, S, D].

    Modes follow med.py's BertEncoder: "text" runs layers [0, fusion_layer)
    without cross-attention, "fusion" runs [fusion_layer, L) with it (from
    `input_embeds`), "multimodal" runs all layers with cross-attention in
    layers >= fusion_layer. With fusion_layer None (BLIP) cross-attention is
    in every layer and "text" runs the whole stack. `encoder_states` may be
    a pair (ALBEF NLVR): fusion layer i attends states[(i - fusion_layer) %
    2]."""
    if input_embeds is not None:
        x = input_embeds
        B, S = x.shape[:2]
    else:
        B, S = ids.shape
        x = med_embed(params, cfg, ids, torch.arange(S, device=ids.device)[None])
    H, eps, L = cfg.num_heads, cfg.layer_norm_eps, cfg.num_layers
    fl = cfg.fusion_layer if cfg.fusion_layer is not None else L

    mask = torch.ones((B, S, S), dtype=torch.bool, device=x.device)
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, :].bool()
    if causal:
        mask = mask & torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    self_bias = mask_bias(mask)

    encs, xbias = [], []
    if encoder_states is not None:
        pair = isinstance(encoder_states, (tuple, list))
        encs = list(encoder_states) if pair else [encoder_states]
        masks = (list(encoder_mask) if pair else [encoder_mask]) if encoder_mask is not None else [None] * len(encs)
        xbias = [None if m is None else mask_bias(m[:, None, :].bool()) for m in masks]

    if mode == "text":
        lo, hi = 0, fl
    elif mode == "fusion":
        if cfg.fusion_layer is None:
            raise ValueError("mode='fusion' needs MedConfig.fusion_layer (BLIP configs have none: use "
                             "mode='multimodal')")
        lo, hi = fl, L
    else:
        lo, hi = 0, L
    cross_start = 0 if cfg.fusion_layer is None else fl
    use_cross = bool(encs) and mode != "text"

    lay = params["layers"]
    for li in range(lo, hi):
        a = attend(_lin(x, lay["sq"], li), _lin(x, lay["sk"], li), _lin(x, lay["sv"], li), H, self_bias)
        x = _ln(x + _lin(a, lay["so"], li), lay["s_ln"], eps, li)
        if use_cross and li >= cross_start:
            sel = (li - fl) % len(encs)
            enc = encs[sel]
            a = attend(_lin(x, lay["cq"], li), _lin(enc, lay["ck"], li), _lin(enc, lay["cv"], li), H, xbias[sel])
            x = _ln(x + _lin(a, lay["co"], li), lay["c_ln"], eps, li)
        x = _ffn(x, lay, li, eps)
    return x


def med_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The MLM / LM head: dense → gelu → LayerNorm → decoder + bias, fp32."""
    h = params["head"]
    x = gelu_exact(hidden @ h["transform"]["w"].t() + h["transform"]["b"])
    x = _ln(x, h["ln"], 1e-12)
    return x.float() @ h["decoder"].float().t() + h["bias"].float()


# ---------------------------------------------------------------------------
# incremental decoding (a self K/V cache + the cross K/V computed once)
# ---------------------------------------------------------------------------


def init_self_cache(cfg: MedConfig, batch: int, max_len: int, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def precompute_cross_kv(params: Params, cfg: MedConfig, encoder_states: torch.Tensor) -> Dict[str, torch.Tensor]:
    B, Se, _ = encoder_states.shape
    H, Dh, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    lk, lv = params["layers"]["ck"], params["layers"]["cv"]
    k = torch.einsum("bsd,lod->lbso", encoder_states, lk["w"]) + lk["b"][:, None, None]
    v = torch.einsum("bsd,lod->lbso", encoder_states, lv["w"]) + lv["b"][:, None, None]
    return {"k": k.reshape(L, B, Se, H, Dh), "v": v.reshape(L, B, Se, H, Dh)}


def decode_step(params: Params, cfg: MedConfig, token_ids: torch.Tensor, t: int, cache: Dict[str, torch.Tensor],
                cross_kv: Dict[str, torch.Tensor], encoder_mask: Optional[torch.Tensor] = None):
    """One causal decoder step with cross-attention → (logits [B, V], cache).
    The cache is written in place at position t."""
    B = token_ids.shape[0]
    H, Dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    Smax = cache["k"].shape[2]
    dev = token_ids.device
    x = med_embed(params, cfg, token_ids[:, None], torch.full((1, 1), t, dtype=torch.long, device=dev))
    self_bias = mask_bias((torch.arange(Smax, device=dev) <= t)[None, None, :])
    xbias = None if encoder_mask is None else mask_bias(encoder_mask[:, None, :].bool())
    kc, vc = cache["k"], cache["v"]
    lay = params["layers"]
    for li in range(cfg.num_layers):
        q = _lin(x, lay["sq"], li).reshape(B, 1, H, Dh)
        kc[li, :, t] = _lin(x, lay["sk"], li).reshape(B, H, Dh)
        vc[li, :, t] = _lin(x, lay["sv"], li).reshape(B, H, Dh)
        a = mha(q, kc[li], vc[li], causal=False, bias=self_bias).reshape(B, 1, -1)
        x = _ln(x + _lin(a, lay["so"], li), lay["s_ln"], eps, li)
        q = _lin(x, lay["cq"], li).reshape(B, 1, H, Dh)
        a = mha(q, cross_kv["k"][li], cross_kv["v"][li], causal=False, bias=xbias).reshape(B, 1, -1)
        x = _ln(x + _lin(a, lay["co"], li), lay["c_ln"], eps, li)
        x = _ffn(x, lay, li, eps)
    return med_logits(params, x[:, 0]), cache


def _strip_eos(rows: List[List[int]], eos_token_id: int) -> List[List[int]]:
    return [row[: row.index(eos_token_id)] if eos_token_id in row else row for row in rows]


class _MedBeamAdapter:
    """decoding/beam.py's adapter over decode_step: the cross K/V rides in
    `params`, and the forward returns logits, which `logits` passes on."""

    def __init__(self, cfg: MedConfig):
        self.cfg = cfg

    @staticmethod
    def embed_tokens(p, ids):
        return ids  # decode_step embeds (positions included)

    def forward(self, p, emb, positions, cache, offsets, *, attn_impl, max_seq_len):
        logits, cache = decode_step(p["text"], self.cfg, emb[:, 0], int(offsets[0]), cache, p["cross"])
        return logits[:, None], cache

    @staticmethod
    def logits(p, hidden):
        return hidden


@torch.inference_mode()
def generate_caption(params: Params, cfg: BlipConfig, pixels: torch.Tensor, prompt_ids: Sequence[int], *,
                     max_new_tokens: int = 30, eos_token_id: int = 102, num_beams: int = 1,
                     length_penalty: float = 1.0, min_new_tokens: int = 0) -> List[List[int]]:
    """BLIP captioning (blip_caption.py generate): the ViT states
    cross-attended by the causal MED decoder. Greedy for num_beams=1, HF
    beam search otherwise. Returns the generated ids of each image (eos and
    what follows cut)."""
    if not prompt_ids:
        raise ValueError("prompt_ids must contain at least the bos ([DEC]) token")
    enc = vit_forward(params["visual"], cfg.vision, pixels)
    B, dev = enc.shape[0], enc.device
    P = len(prompt_ids)
    T = P + max_new_tokens
    cross = precompute_cross_kv(params["text"], cfg.text, enc)

    if num_beams == 1:
        cache = init_self_cache(cfg.text, B, T, dev)
        token = torch.full((B,), prompt_ids[0], dtype=torch.long, device=dev)
        done = np.zeros((B,), bool)
        rows = []
        for t in range(T - 1):
            logits, cache = decode_step(params["text"], cfg.text, token, t, cache, cross)
            if t + 1 < P:
                token = torch.full((B,), prompt_ids[t + 1], dtype=torch.long, device=dev)
                continue
            if len(rows) < min_new_tokens:
                logits[:, eos_token_id] = NEG  # LAVIS min_length
            nxt = np.where(done, eos_token_id, logits.argmax(-1).cpu().numpy())
            rows.append(nxt)
            done |= nxt == eos_token_id
            token = torch.from_numpy(nxt).to(dev)
            if done.all():
                break
        ids = np.stack(rows, axis=1) if rows else np.zeros((B, 0), np.int64)
        return _strip_eos([[int(x) for x in r] for r in ids], eos_token_id)

    from llava_align_tpu_torch.decoding.beam import make_beam_fn

    beam_fn = make_beam_fn(_MedBeamAdapter(cfg.text), num_beams=num_beams, max_new_tokens=max_new_tokens,
                           eos_token_id=eos_token_id, pad_token_id=0, length_penalty=length_penalty,
                           min_new_tokens=min_new_tokens, cache_len=T)
    out = []
    for b in range(B):
        cross_b = {k: v[:, b : b + 1] for k, v in cross.items()}
        cache1 = init_self_cache(cfg.text, 1, T, dev)
        logits = None
        for t in range(P):
            tok = torch.full((1,), prompt_ids[t], dtype=torch.long, device=dev)
            logits, cache1 = decode_step(params["text"], cfg.text, tok, t, cache1, cross_b)
        pw = {"text": params["text"], "cross": {k: v.repeat_interleave(num_beams, dim=1) for k, v in cross_b.items()}}
        seq, n, _ = beam_fn(pw, cache1, logits, torch.tensor([P], device=dev))
        out.append([int(x) for x in seq[:n].tolist() if int(x) != eos_token_id])
    return out


def _itm_head(params: Params, hidden_cls: torch.Tensor) -> torch.Tensor:
    return hidden_cls @ params["itm_head"]["w"].t() + params["itm_head"]["b"]


def itm_score_from_embeds(params: Params, cfg: BlipConfig, image_embeds: torch.Tensor, text_ids: torch.Tensor,
                          text_mask: torch.Tensor) -> torch.Tensor:
    """The ITM head on precomputed ViT states (the re-rank path) → [B, 2]."""
    enc_mask = torch.ones(image_embeds.shape[:2], dtype=torch.int32, device=image_embeds.device)
    h = med_forward(params["text"], cfg.text, text_ids, text_mask, encoder_states=image_embeds,
                    encoder_mask=enc_mask, causal=False)
    return _itm_head(params, h[:, 0])


def itm_score(params: Params, cfg: BlipConfig, pixels: torch.Tensor, text_ids: torch.Tensor,
              text_mask: torch.Tensor) -> torch.Tensor:
    """Image-text matching on the multimodal cls state
    (blip_image_text_matching.py 'itm') → [B, 2] logits."""
    return itm_score_from_embeds(params, cfg, vit_forward(params["visual"], cfg.vision, pixels), text_ids, text_mask)


def extract_features(params: Params, cfg: BlipConfig, pixels: Optional[torch.Tensor] = None,
                     text_ids: Optional[torch.Tensor] = None,
                     text_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Unimodal ITC embeddings (blip_feature_extractor.py): L2-normalized
    projections of the cls states."""
    out: Dict[str, torch.Tensor] = {}
    if pixels is not None:
        enc = vit_forward(params["visual"], cfg.vision, pixels)
        v = _lin(enc[:, 0], params["vision_proj"])
        out["image_embeds"] = enc
        out["image_features"] = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    if text_ids is not None:
        h = med_forward(params["text"], cfg.text, text_ids, text_mask, causal=False)
        t = _lin(h[:, 0], params["text_proj"])
        out["text_embeds"] = h
        out["text_features"] = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return out


def rerank_sims(sims: np.ndarray, image_embeds: torch.Tensor, text_ids: torch.Tensor, text_mask: torch.Tensor,
                k_test: int, itm) -> Tuple[np.ndarray, np.ndarray]:
    """The ITM re-rank of compute_sim_matrix (BLIP's and ALBEF's): for each
    row the top k_test by ITC similarity (numpy argsort of the host copy,
    descending, as the JAX package ranks) get sim + itm(states, ids, mask),
    the rest -100."""
    Ni, Nt = sims.shape
    dev = text_ids.device
    k = min(k_test, Nt)
    i2t = np.full_like(sims, -100.0)
    for i in range(Ni):
        topk = np.argsort(sims[i])[::-1][:k].copy()
        sel = torch.from_numpy(topk).to(dev)
        score = itm(image_embeds[i : i + 1].repeat_interleave(k, dim=0), text_ids[sel], text_mask[sel])
        i2t[i, topk] = sims[i, topk] + score.float().cpu().numpy()
    kt = min(k_test, Ni)
    t2i = np.full_like(sims.T, -100.0)
    for t in range(Nt):
        topk = np.argsort(sims[:, t])[::-1][:kt].copy()
        sel = torch.from_numpy(topk).to(image_embeds.device)
        score = itm(image_embeds[sel], text_ids[t : t + 1].repeat_interleave(kt, dim=0),
                    text_mask[t : t + 1].repeat_interleave(kt, dim=0))
        t2i[t, topk] = sims[topk, t] + score.float().cpu().numpy()
    return i2t, t2i


@torch.inference_mode()
def compute_sim_matrix(params: Params, cfg: BlipConfig, pixels: torch.Tensor, text_ids: torch.Tensor,
                       text_mask: torch.Tensor, *, k_test: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(scores_i2t [Ni, Nt], scores_t2i [Nt, Ni]) for RetrievalTask
    (blip_retrieval compute_sim_matrix): ITC similarity, re-ranked by the
    ITM head's logit[1] on the top k_test pairs of each row when k_test >
    0. The ViT runs once; the re-rank reuses its states."""
    feats = extract_features(params, cfg, pixels=pixels, text_ids=text_ids, text_mask=text_mask)
    sims = feats["image_features"].float().cpu().numpy() @ feats["text_features"].float().cpu().numpy().T
    if k_test <= 0:
        return sims, sims.T
    return rerank_sims(sims, feats["image_embeds"], text_ids, text_mask, k_test,
                       lambda e, i, m: itm_score_from_embeds(params, cfg, e, i, m)[:, 1])


# ---------------------------------------------------------------------------
# GradCAM (blip_image_text_matching.py compute_gradcam) and sampled
# captions: the building blocks of PnP-VQA / Img2Prompt
# ---------------------------------------------------------------------------


def _itm_forward_probed(params: Params, cfg: BlipConfig, ids: torch.Tensor, mask: torch.Tensor,
                        enc: torch.Tensor, probe: torch.Tensor, block_num: int):
    """The ITM forward with `probe` (zeros) added to layer block_num's
    cross-attention probabilities → (sum of the class-1 logits, those
    probabilities). d(out)/d(probe) is the attention-map gradient the
    reference captures with save_attention hooks."""
    tc = cfg.text
    H, eps, Dh = tc.num_heads, tc.layer_norm_eps, tc.head_dim
    B, S = ids.shape
    x = med_embed(params["text"], tc, ids, torch.arange(S, device=ids.device)[None])
    self_bias = mask_bias(mask[:, None, :].bool())
    cams = None
    lay = params["text"]["layers"]
    for li in range(tc.num_layers):
        a = attend(_lin(x, lay["sq"], li), _lin(x, lay["sk"], li), _lin(x, lay["sv"], li), H, self_bias)
        x = _ln(x + _lin(a, lay["so"], li), lay["s_ln"], eps, li)
        q = _lin(x, lay["cq"], li).reshape(B, S, H, Dh)
        k = _lin(enc, lay["ck"], li).reshape(B, -1, H, Dh)
        v = _lin(enc, lay["cv"], li).reshape(B, -1, H, Dh)
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / Dh**0.5, dim=-1)
        if li == block_num:
            p = p + probe
            cams = p
        a = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(x.dtype).reshape(B, S, -1)
        x = _ln(x + _lin(a, lay["co"], li), lay["c_ln"], eps, li)
        x = _ffn(x, lay, li, eps)
    return _itm_head(params, x[:, 0])[:, 1].sum(), cams


def compute_gradcam(params: Params, cfg: BlipConfig, pixels: Optional[torch.Tensor], text_ids: torch.Tensor,
                    text_mask: torch.Tensor, *, block_num: int = 6, enc_states: Optional[torch.Tensor] = None):
    """Per-patch question relevance from the ITM head
    (blip_image_text_matching.py:151-200): gradcam = attention probs ·
    relu(d itm_1 / d probs), text-masked, head-averaged. Returns (the
    question-averaged row [B, N], the per-token map [B, S, N]); the
    gradient is torch autograd's."""
    with torch.no_grad():
        enc = enc_states if enc_states is not None else vit_forward(params["visual"], cfg.vision, pixels)
    B, S = text_ids.shape
    probe = torch.zeros((B, cfg.text.num_heads, S, enc.shape[1]), dtype=torch.float32, device=enc.device,
                        requires_grad=True)
    with torch.enable_grad():
        out, cams = _itm_forward_probed(params, cfg, text_ids, text_mask, enc, probe, block_num)
        (grads,) = torch.autograd.grad(out, probe)
    with torch.no_grad():
        m = text_mask[:, None, :, None].float()
        cams = cams[..., 1:] * m  # the image cls column dropped
        grads = grads[..., 1:].clamp(min=0) * m
        gradcam = (cams * grads).mean(1)
        tok_len = text_mask.sum(-1) - 2  # minus [ENC] and [SEP]
        pos = torch.arange(S, device=text_ids.device)[None]
        span = (pos >= 1) & (pos <= tok_len[:, None])
        avg = (gradcam * span[..., None]).sum(1) / tok_len[:, None]
    return avg, gradcam


@torch.inference_mode()
def generate_caption_sampled(params: Params, cfg: BlipConfig, enc_states: torch.Tensor, prompt_ids: Sequence[int],
                             generator: Optional[torch.Generator] = None, *, max_new_tokens: int = 20,
                             min_new_tokens: int = 0, top_k: int = 50, top_p: float = 1.0,
                             repetition_penalty: float = 1.0, eos_token_id: int = 102) -> List[List[int]]:
    """Sampled captions over the caller's encoder states (PnP-VQA
    forward_cap: HF do_sample with top-k / top-p and a repetition penalty),
    drawn from `generator`."""
    from llava_align_tpu_torch.decoding.sampler import sample_token, warp_logits

    B, dev = enc_states.shape[0], enc_states.device
    P = len(prompt_ids)
    T = P + max_new_tokens
    cross = precompute_cross_kv(params["text"], cfg.text, enc_states)
    cache = init_self_cache(cfg.text, B, T, dev)
    token = torch.full((B,), prompt_ids[0], dtype=torch.long, device=dev)
    done = np.zeros((B,), bool)
    generated: List[List[int]] = [[] for _ in range(B)]
    n_rows = 0
    for t in range(T - 1):
        logits, cache = decode_step(params["text"], cfg.text, token, t, cache, cross)
        if t + 1 < P:
            token = torch.full((B,), prompt_ids[t + 1], dtype=torch.long, device=dev)
            continue
        lg = logits.float()
        if repetition_penalty != 1.0:
            for b in range(B):
                seen = torch.tensor(sorted(set(prompt_ids) | set(generated[b])), device=dev)
                v = lg[b, seen]
                lg[b, seen] = torch.where(v > 0, v / repetition_penalty, v * repetition_penalty)
        if n_rows < min_new_tokens:
            lg[:, eos_token_id] = NEG
        nxt = sample_token(generator, warp_logits(lg, top_k=top_k, top_p=top_p)).cpu().numpy()
        nxt = np.where(done, eos_token_id, nxt)
        n_rows += 1
        for b in range(B):
            if not done[b]:
                generated[b].append(int(nxt[b]))
        done |= nxt == eos_token_id
        token = torch.from_numpy(nxt).to(dev)
        if done.all():
            break
    return _strip_eos(generated, eos_token_id)
