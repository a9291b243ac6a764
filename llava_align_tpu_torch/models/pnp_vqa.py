"""PnP-VQA: plug-and-play zero-shot VQA, GradCAM → sampled captions →
Fusion-in-Decoder QA (torch twin of llava_align_tpu/models/pnp_vqa.py;
prepare_qa_input is a copy, tests/test_torch_copies.py holds it to the
original's source).

Capability parity: the reference's vendored LAVIS PNPVQA
(lavis/models/pnp_vqa_models/pnp_vqa.py + pnp_unifiedqav2_fid.py): (1)
GradCAM patch relevance from a BLIP-ITM model (forward_itm), (2) sampled
captioning over gradcam-drawn patch subsets, deduplicated, until
`num_captions` per image (forward_cap), (3) Fusion-in-Decoder QA with a
T5: each question+caption context is encoded alone and the decoder
attends over the concatenated encoder states (fid_generate).

Patch subsets are drawn without replacement by a Gumbel top-k, as in JAX,
in the same float32 order of operations; ties break as jax.lax.top_k's (a
stable descending sort). Each round draws its patch uniforms and then its
captions from the caller's torch.Generator; `patch_uniforms=` hands in a
round's uniforms instead (the tests give JAX's). FiD is a reshape: T5's
cross-attention has no relative position bias, so concatenating the
per-context encoder states is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from llava_align_tpu_torch.models import blip as blip_mod
from llava_align_tpu_torch.models import t5 as t5_mod
from llava_align_tpu_torch.models.blip import BlipConfig
from llava_align_tpu_torch.models.t5 import T5Config
from llava_align_tpu_torch.utils.synthetic import build_random_t5_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PnpVqaConfig:
    itm: BlipConfig = dataclasses.field(default_factory=BlipConfig)
    cap: BlipConfig = dataclasses.field(default_factory=BlipConfig)
    qa: T5Config = dataclasses.field(default_factory=T5Config)
    block_num: int = 7  # the cross-attention block GradCAM reads (pnp_vqa.py:54)

    @staticmethod
    def tiny(vocab_size: int = 64) -> "PnpVqaConfig":
        return PnpVqaConfig(itm=BlipConfig.tiny(vocab_size), cap=BlipConfig.tiny(vocab_size),
                            qa=T5Config.tiny(vocab_size), block_num=1)


def init(cfg: PnpVqaConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree on `device` (the GPU unless
    another is named): BLIP-ITM, BLIP-caption and the T5 reader, each
    from its own seed."""
    return {"itm": blip_mod.init(cfg.itm, device=device, seed=seed),
            "cap": blip_mod.init(cfg.cap, device=device, seed=seed + 1),
            "qa": build_random_t5_params(cfg.qa, device=device, seed=seed + 2)}


def forward_itm(params: Params, cfg: PnpVqaConfig, pixels: torch.Tensor, q_ids: torch.Tensor,
                q_mask: torch.Tensor) -> torch.Tensor:
    """→ gradcams [B, N] (pnp_vqa.py:54-82)."""
    avg, _ = blip_mod.compute_gradcam(params["itm"], cfg.itm, pixels, q_ids, q_mask, block_num=cfg.block_num)
    return avg


def _sample_patches(weights: torch.Tensor, num_patches: int, generator: Optional[torch.Generator] = None, *,
                    uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R, B, N] Gumbel top-k draw of `num_patches` patch indices without
    replacement per (round, image), sorted ascending: the reference's
    torch.multinomial(replacement=False) in distribution
    (pnp_vqa.py:124-127). `uniforms` [R, B, N] in [0, 1) replace the
    draw from `generator`."""
    if uniforms is None:
        uniforms = torch.rand(weights.shape, generator=generator, device=weights.device)
    logw = torch.log(torch.clamp(weights, min=1e-20))
    g = -torch.log(-torch.log(uniforms.to(weights.device) + 1e-20) + 1e-20)
    idx = torch.sort(logw + g, dim=-1, descending=True, stable=True).indices[..., :num_patches]
    return torch.sort(idx, dim=-1).values


def _keep_new(rows: List[List[int]], keep: Sequence[bool], per: int, captions: List[List[List[int]]],
              texts: List[List[str]], num_captions: int, decode: Optional[Callable[[List[int]], str]]) -> None:
    """Append each kept row to its image's captions unless the image is
    full or the row repeats one kept before: with `decode`, its text is a
    substring of a kept caption's text; without, its tokens equal a kept
    caption's (pnp_vqa.py:136-147)."""
    for i, row in enumerate(rows):
        b = i // per
        if len(captions[b]) >= num_captions or not keep[i]:
            continue
        if decode is not None:
            text = decode(row)
            if any(text in prev for prev in texts[b]):
                continue
            texts[b].append(text)
        elif any(tuple(row) == tuple(prev) for prev in captions[b]):
            continue
        captions[b].append(row)


def sampled_patch_captions(params_cap: Params, cfg_cap: BlipConfig, enc: torch.Tensor, gradcams: torch.Tensor,
                           prompt_ids: Sequence[int], generator: Optional[torch.Generator], uniforms, *,
                           num_captions: int, num_patches: int, **gen_kw):
    """One round of forward_cap: `num_captions` patch subsets per image
    drawn by gradcam weight, their states [B * R, P, D] (image-major) and a
    sampled caption of each → (states, rows)."""
    B, _, D = enc.shape
    w = gradcams.expand(num_captions, B, gradcams.shape[-1])
    idx = _sample_patches(w, num_patches, generator, uniforms=uniforms)          # [R, B, P]
    patches = enc[:, 1:][torch.arange(B, device=enc.device)[None, :, None], idx]  # [R, B, P, D] (cls skipped)
    flat = patches.transpose(0, 1).reshape(B * num_captions, num_patches, D)
    return flat, blip_mod.generate_caption_sampled(params_cap, cfg_cap, flat, list(prompt_ids), generator, **gen_kw)


@torch.inference_mode()
def forward_cap(params: Params, cfg: PnpVqaConfig, pixels: torch.Tensor, gradcams: torch.Tensor,
                prompt_ids: Sequence[int], generator: Optional[torch.Generator] = None, *, num_captions: int = 100,
                num_patches: int = 20, cap_max_length: int = 20, cap_min_length: int = 0, top_k: int = 50,
                top_p: float = 1.0, repetition_penalty: float = 1.0, eos_token_id: int = 102,
                decode: Optional[Callable[[List[int]], str]] = None, max_rounds: int = 10,
                patch_uniforms: Optional[Sequence[torch.Tensor]] = None) -> List[List[List[int]]]:
    """Sampled captioning over gradcam-drawn patch subsets, deduplicated
    (a substring of a kept caption's decoded text when `decode` is given,
    equal tokens otherwise) until every image has `num_captions`
    (pnp_vqa.py:117-172) → per-image lists of caption token ids. Round r
    draws its patch uniforms from `generator`, or takes patch_uniforms[r]
    [num_captions, B, N]."""
    enc = blip_mod.vit_forward(params["cap"]["visual"], cfg.cap.vision, pixels)
    B = enc.shape[0]
    captions: List[List[List[int]]] = [[] for _ in range(B)]
    texts: List[List[str]] = [[] for _ in range(B)]
    for r in range(max_rounds):
        if min(len(c) for c in captions) >= num_captions:
            break
        _, rows = sampled_patch_captions(
            params["cap"], cfg.cap, enc, gradcams, prompt_ids, generator,
            None if patch_uniforms is None else patch_uniforms[r], num_captions=num_captions,
            num_patches=num_patches, max_new_tokens=cap_max_length, min_new_tokens=cap_min_length, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty, eos_token_id=eos_token_id)
        _keep_new(rows, [True] * len(rows), num_captions, captions, texts, num_captions, decode)
    return captions


@torch.inference_mode()
def fid_generate(params_qa: Params, cfg_qa: T5Config, context_ids: torch.Tensor, context_mask: torch.Tensor, *,
                 max_len: int = 20, min_len: int = 0, eos_token_id: int = 1,
                 decoder_start_token_id: int = 0) -> List[int]:
    """Fusion-in-Decoder (pnp_unifiedqav2_fid.py:29-52): each context
    [n_ctx, S] encoded alone, the encoder states concatenated along the
    sequence, one greedy decode over all of them."""
    emb = t5_mod.embed_tokens(params_qa, context_ids)
    enc = t5_mod.encode(params_qa, cfg_qa, emb, context_mask)  # [n_ctx, S, D]
    n, S, D = enc.shape
    out = t5_mod.generate_greedy(params_qa, cfg_qa, enc.reshape(1, n * S, D), context_mask.reshape(1, n * S),
                                 max_new_tokens=max_len, eos_token_id=eos_token_id,
                                 decoder_start_token_id=decoder_start_token_id)
    del min_len  # the reference passes min_length=0 in every caller
    return out[0]


def prepare_qa_input(
    question: str, captions: List[str],
    *,
    num_captions: int,
    num_captions_fid: int,
) -> List[str]:
    """pnp_vqa_models/__init__.py:11-29: group `num_captions_fid` captions
    per FiD context, each prefixed with the lower-cased question."""
    contexts = []
    acc = ""
    for cap_id, cap in enumerate(captions[:num_captions]):
        acc += cap.strip() + ". "
        last = (cap_id + 1) == num_captions
        if last or (cap_id + 1) % num_captions_fid == 0:
            contexts.append(
                question.lower().strip() + " \\n " + acc.lower().strip()
            )
            acc = ""
        if last:
            break
    return contexts


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device)


def predict_answers(params: Params, cfg: PnpVqaConfig, pixels: torch.Tensor, questions: List[str], *,
                    tokenize_q: Callable[[List[str]], Any], tokenize_ctx: Callable[[List[str]], Any],
                    decode_cap: Callable[[List[int]], str], decode_ans: Callable[[List[int]], str],
                    prompt_ids: Sequence[int], generator: Optional[torch.Generator] = None,
                    num_captions: int = 50, num_captions_fid: int = 1, num_patches: int = 20, max_len: int = 20,
                    **cap_kwargs):
    """The whole pipeline (pnp_vqa.py predict_answers :232-318) →
    (answers, captions, gradcams as numpy). The tokenizers return (ids,
    mask) arrays: tokenize_q for the ITM BERT, tokenize_ctx for the T5."""
    dev = pixels.device
    q_ids, q_mask = tokenize_q(questions)
    gradcams = forward_itm(params, cfg, pixels, _on(q_ids, dev), _on(q_mask, dev))
    cap_tokens = forward_cap(params, cfg, pixels, gradcams, prompt_ids, generator, num_captions=num_captions,
                             num_patches=num_patches, decode=decode_cap, **cap_kwargs)
    captions = [[decode_cap(row) for row in rows] for rows in cap_tokens]
    answers = []
    for b, question in enumerate(questions):
        contexts = prepare_qa_input(question, captions[b], num_captions=num_captions,
                                    num_captions_fid=num_captions_fid)
        ids, mask = tokenize_ctx(contexts)
        answers.append(decode_ans(fid_generate(params["qa"], cfg.qa, _on(ids, dev), _on(mask, dev),
                                               max_len=max_len)))
    return answers, captions, gradcams.float().cpu().numpy()
