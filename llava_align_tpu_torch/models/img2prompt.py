"""Img2Prompt-VQA (Img2LLM): zero-shot VQA through an LLM prompt built from
captions and synthetic questions (torch twin of
llava_align_tpu/models/img2prompt.py; OPEN_POS, _STOPWORDS,
HeuristicExtractor, answer_extraction and the prompt construction are
copies, tests/test_torch_copies.py holds them to the original's source).

Capability parity: the reference's vendored LAVIS Img2PromptVQA
(lavis/models/img2prompt_models/img2prompt_vqa.py): (1) GradCAM patch
relevance from BLIP-ITM (forward_itm), (2) sampled captioning over
gradcam-drawn patches (PnP-VQA's rounds, models/pnp_vqa) with an ITM match
filter (forward_cap, itm_rank), (3) answer candidates from the captions
(answer_extraction, a pluggable extractor with a spacy-free heuristic),
(4) synthetic questions from a T5 question generator, greedy in 10-row
chunks (forward_qa_generation), (5) the LLM prompt (prompts_construction).
The prompt goes to a frozen LLM of the caller's.

As in JAX: create_task_prompt keeps the reference's dead rule branch (only
the yes/no demonstration pair is emitted), and the ITM filter keeps a
caption when its softmax match probability is >= the threshold (the
reference compares a 2-logit tensor with a scalar, :245).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.models import blip as blip_mod
from llava_align_tpu_torch.models import t5 as t5_mod
from llava_align_tpu_torch.models.blip import BlipConfig
from llava_align_tpu_torch.models.pnp_vqa import _keep_new, sampled_patch_captions
from llava_align_tpu_torch.models.t5 import T5Config
from llava_align_tpu_torch.utils.synthetic import build_random_t5_params

Params = Dict[str, Any]

OPEN_POS = ("NOUN", "VERB", "ADJ", "ADV", "NUM")

_STOPWORDS = frozenset(
    "a an the this that these those is are was were be been being am do does did "
    "have has had of in on at to from with by for and or but not no as it its "
    "his her their our your my he she they we you i there here what which who "
    "whom whose when where why how very so too also just only".split()
)


@dataclasses.dataclass(frozen=True)
class Img2PromptConfig:
    itm: BlipConfig = dataclasses.field(default_factory=BlipConfig)
    cap: BlipConfig = dataclasses.field(default_factory=BlipConfig)
    qg: T5Config = dataclasses.field(default_factory=T5Config)
    block_num: int = 7
    prompt_length: int = 1  # caption prompt token count fed to itm_rank

    @staticmethod
    def tiny(vocab_size: int = 64) -> "Img2PromptConfig":
        return Img2PromptConfig(itm=BlipConfig.tiny(vocab_size), cap=BlipConfig.tiny(vocab_size),
                                qg=T5Config.tiny(vocab_size), block_num=1)


def init(cfg: Img2PromptConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree on `device` (the GPU unless
    another is named): BLIP-ITM, BLIP-caption and the T5 question
    generator, each from its own seed."""
    return {"itm": blip_mod.init(cfg.itm, device=device, seed=seed),
            "cap": blip_mod.init(cfg.cap, device=device, seed=seed + 1),
            "qg": build_random_t5_params(cfg.qg, device=device, seed=seed + 2)}


def forward_itm(params: Params, cfg: Img2PromptConfig, pixels: torch.Tensor, q_ids: torch.Tensor,
                q_mask: torch.Tensor) -> torch.Tensor:
    """→ gradcams [B, N] (img2prompt_vqa.py:68-101)."""
    avg, _ = blip_mod.compute_gradcam(params["itm"], cfg.itm, pixels, q_ids, q_mask, block_num=cfg.block_num)
    return avg


def itm_rank(params_itm: Params, cfg_itm: BlipConfig, image_embeds: torch.Tensor, caption_ids: torch.Tensor,
             caption_mask: torch.Tensor) -> torch.Tensor:
    """Match probability of each (patch subset [N, P, D], caption [N, S])
    pair (img2prompt_vqa.py:103-123) → [N]."""
    logits = blip_mod.itm_score_from_embeds(params_itm, cfg_itm, image_embeds, caption_ids, caption_mask)
    return torch.softmax(logits, dim=-1)[:, 1]


@torch.inference_mode()
def forward_cap(params: Params, cfg: Img2PromptConfig, pixels: torch.Tensor, gradcams: torch.Tensor,
                prompt_ids: Sequence[int], generator: Optional[torch.Generator] = None, *, num_captions: int = 100,
                num_patches: int = 20, cap_max_length: int = 20, cap_min_length: int = 0, top_k: int = 50,
                top_p: float = 1.0, repetition_penalty: float = 1.0, eos_token_id: int = 102,
                enc_token_id: int = 101, itm_threshold: float = 0.5,
                decode: Optional[Callable[[List[int]], str]] = None, max_rounds: int = 10,
                patch_uniforms: Optional[Sequence[torch.Tensor]] = None) -> List[List[List[int]]]:
    """PnP-VQA's sampled rounds (models/pnp_vqa.forward_cap, the same draws
    and dedup) with the Img2Prompt ITM filter (img2prompt_vqa.py:228-247):
    a caption is kept only when the ITM head matches it, [ENC] + caption
    + [SEP], to the patch subset it was generated from."""
    enc = blip_mod.vit_forward(params["cap"]["visual"], cfg.cap.vision, pixels)
    B, dev = enc.shape[0], enc.device
    captions: List[List[List[int]]] = [[] for _ in range(B)]
    texts: List[List[str]] = [[] for _ in range(B)]
    for r in range(max_rounds):
        if min(len(c) for c in captions) >= num_captions:
            break
        flat, rows = sampled_patch_captions(
            params["cap"], cfg.cap, enc, gradcams, prompt_ids, generator,
            None if patch_uniforms is None else patch_uniforms[r], num_captions=num_captions,
            num_patches=num_patches, max_new_tokens=cap_max_length, min_new_tokens=cap_min_length, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty, eos_token_id=eos_token_id)
        S = max(max((len(row) for row in rows), default=0) + 2, 2)
        cap_ids = np.zeros((len(rows), S), np.int64)
        cap_mask = np.zeros((len(rows), S), np.int64)
        for i, row in enumerate(rows):
            ids = [enc_token_id] + row + [eos_token_id]
            cap_ids[i, : len(ids)] = ids
            cap_mask[i, : len(ids)] = 1
        match = itm_rank(params["itm"], cfg.itm, flat, torch.from_numpy(cap_ids).to(dev),
                         torch.from_numpy(cap_mask).to(dev)).float().cpu().numpy()
        _keep_new(rows, match >= itm_threshold, num_captions, captions, texts, num_captions, decode)
    return captions


# ---------------------------------------------------------------------------
# answer extraction (spacy-free pluggable)
# ---------------------------------------------------------------------------


class HeuristicExtractor:
    """Spacy-free stand-in for the reference's nlp() pass: open-class words
    = non-stopword alphanumeric tokens; noun chunks = adjacent non-stopword
    runs of <4 words. Plug a spacy-backed extractor with the same interface
    for the reference's exact POS behavior (img2prompt_vqa.py:252-297 uses
    spacy pos_/ents/noun_chunks; spacy is not vendored here)."""

    def __call__(self, sentence: str) -> Tuple[List[str], List[str]]:
        words = [w for w in re.findall(r"[A-Za-z0-9']+", sentence)]
        tokens = [w for w in words if w.lower() not in _STOPWORDS]
        chunks: List[str] = []
        run: List[str] = []
        for w in words:
            if w.lower() in _STOPWORDS:
                if 0 < len(run) < 4:
                    chunks.append(" ".join(run))
                run = []
            else:
                run.append(w)
        if 0 < len(run) < 4:
            chunks.append(" ".join(run))
        return tokens, chunks


def answer_extraction(
    captions: List[str],
    *,
    num_question_generation: int = 30,
    extractor: Optional[Callable[[str], Tuple[List[str], List[str]]]] = None,
) -> Tuple[List[str], List[str], Dict[str, List[int]]]:
    """img2prompt_vqa.py:252-311: collect candidate answers (open-class
    tokens + entity/noun chunks) with the caption ids they came from, rank
    by frequency, and emit QG contexts 'answer: X  context: <all caps>.'
    plus the fixed trailing 'yes.' candidate."""
    extractor = extractor or HeuristicExtractor()
    cap_use = ""
    ans_to_cap: Dict[str, List[int]] = {}
    answers: List[str] = []
    for cap_idx, cap in enumerate(captions):
        cap_use += cap
        sent = cap.strip().strip(".")
        tokens, chunks = extractor(sent)
        for tok in tokens:
            key = tok.lower()
            ans_to_cap.setdefault(key, [])
            if cap_idx not in ans_to_cap[key]:
                ans_to_cap[key].append(cap_idx)
            answers.append(tok)
        for chunk in chunks:
            if chunk in answers:
                continue
            key = chunk.lower()
            ans_to_cap.setdefault(key, [])
            if cap_idx not in ans_to_cap[key]:
                ans_to_cap[key].append(cap_idx)
            answers.append(chunk)
    answers = sorted(answers, key=answers.count, reverse=True)
    real_answers: List[str] = []
    for a in answers:
        a = a + "."
        if a not in real_answers:
            real_answers.append(a)

    contexts = []
    out_answers = []
    for ans in real_answers[:num_question_generation]:
        contexts.append("answer: %s  context: %s." % (ans, cap_use))
        out_answers.append(ans)
    contexts.append("answer: %s  context: %s." % ("yes.", cap_use))
    out_answers.append("yes.")
    return contexts, out_answers, ans_to_cap



@torch.inference_mode()
def forward_qa_generation(params_qg: Params, cfg_qg: T5Config, context_ids: torch.Tensor,
                          context_mask: torch.Tensor, *, max_length: int = 30, batch: int = 10,
                          eos_token_id: int = 1, decoder_start_token_id: int = 0) -> List[List[int]]:
    """Question generation over the QG contexts (img2prompt_vqa.py:312-341;
    the reference decodes with num_beams=3 in 10-row chunks: greedy here,
    as in JAX, chunked the same way)."""
    out: List[List[int]] = []
    for lo in range(0, context_ids.shape[0], batch):
        ids, mask = context_ids[lo : lo + batch], context_mask[lo : lo + batch]
        enc = t5_mod.encode(params_qg, cfg_qg, t5_mod.embed_tokens(params_qg, ids), mask)
        out += t5_mod.generate_greedy(params_qg, cfg_qg, enc, mask, max_new_tokens=max_length,
                                      eos_token_id=eos_token_id, decoder_start_token_id=decoder_start_token_id)
    return out



# ---------------------------------------------------------------------------
# prompt construction (pure string machinery, reference :349-462)
# ---------------------------------------------------------------------------


def create_context_prompt(
    captions: List[str], answers: List[str], ans_to_cap: Dict[str, List[int]],
    *,
    num_caps_per_img: int = 30,
) -> str:
    context = ""
    used: List[int] = []
    for idx in range(num_caps_per_img):
        key = answers[(len(answers) - 1 - idx) % len(answers)][:-1].lower()
        for cap_id in ans_to_cap.get(key, [0]):
            if cap_id not in used:
                context += captions[cap_id]
                used.append(cap_id)
                break
    return context


def create_task_prompt(
    questions: List[str], answers: List[str],
    *,
    question_type: str = "neural",
    num_question_per_img: int = 30,
) -> str:
    """Reproduces the reference's observable behavior exactly: one yes/no
    demonstration pair for non-"rule" types; the rule branch is dead
    (img2prompt_vqa.py:395 compares string literals)."""
    task = ""
    for idx in range(num_question_per_img):
        if question_type != "rule" and num_question_per_img > 0 and idx < 1:
            task += "Question:"
            task += questions[-1]
            task += "\n"
            task += "Answer:"
            task += "yes\n"
            task += "Question:Is this a toilet?\n"
            task += "Answer:no\n"
    return task


def prompts_construction(
    question: str,
    captions: List[str],
    questions: List[str],
    answers: List[str],
    ans_to_cap: Dict[str, List[int]],
    *,
    question_type: str = "neural",
    num_caps_per_img: int = 30,
    num_question_per_img: int = 30,
) -> str:
    """img2prompt_vqa.py:437-462 → the final LLM prompt."""
    prompt = "Please reason the answer of the questions according to the given contexts.\n"
    context_prompt = create_context_prompt(
        captions, answers, ans_to_cap, num_caps_per_img=num_caps_per_img
    )
    task_prompt = create_task_prompt(
        questions, answers, question_type=question_type,
        num_question_per_img=num_question_per_img,
    )
    return (
        prompt
        + "Contexts:" + context_prompt + "\n"
        + task_prompt
        + "Question:" + question + "\nAnswer:"
    )
