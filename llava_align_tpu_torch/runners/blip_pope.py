"""InstructBLIP POPE runner, the port of llava_align_tpu/runners/blip_pope.py
with the same knobs and the same jsonl records.

Capability parity: experiments/eval/calibrate/blip_calibrate.py — prompt
'{q} Please answer this question with one word.', num_beams=1 decoding,
VCD through the Q-Former stream of a diffusion-noised image (the contrast
branch reads embeddings), and the content-free scoring runs for the
'none' (text only) and 'noise' (the image at step 999) dumps.

    python -m llava_align_tpu_torch.runners.blip_pope --model-path random:tiny --device cpu \\
        --question-file questions.jsonl --answers-file answers.jsonl --use_cd \\
        --temperature 0 --synthetic-images --calibrate
    python -m llava_align_tpu_torch.evals.pope questions.jsonl answers.jsonl

--model-path: random:* (the tiny random tree, InstructBlipConfig.tiny, with
the mock tokenizer for both the Vicuna and the BERT side, as in the JAX
runner) or a LAVIS blip2_vicuna_instruct checkpoint dir (weights, with
llm_tokenizer/ and bert_tokenizer/ beside them, read by transformers). The
GPU unless --device cpu is given. --quant is read by nothing, as in the
JAX runner (the tree stays in its float dtype). --dist auto as in the POPE
runner.
"""

from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import torch

from llava_align_tpu_torch.calibrate.posthoc import calibrate_label_dict, get_prob_from_logits
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.models import instructblip
from llava_align_tpu_torch.models.instructblip import InstructBlipConfig
from llava_align_tpu_torch.ops.image import normalize_host, synthetic_image_uint8
from llava_align_tpu_torch.ops.noise import add_diffusion_noise
from llava_align_tpu_torch.runners.common import (
    AnswerFile,
    apply_dist_auto,
    finish_dist_auto,
    MockTokenizer,
    load_questions_for,
    make_generation_config,
)


def load_blip_model(model_path: str, device=None):
    """(Vicuna tokenizer, BERT tokenizer, params, cfg, model name) on
    `device` (the GPU unless another is named): random:* gives the tiny
    random tree with the mock tokenizer on both sides; a checkpoint dir goes
    through utils.hf_convert.convert_instructblip at vicuna7b's config, its
    tokenizers through transformers."""
    if model_path.startswith("random:"):
        cfg = InstructBlipConfig.tiny()
        return MockTokenizer(), MockTokenizer(), instructblip.init(cfg, device=device), cfg, "random-instructblip"
    from llava_align_tpu_torch.utils.hf_convert import convert_instructblip, load_state_dict

    path = os.path.expanduser(model_path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint dir at {path}")
    try:
        from transformers import AutoTokenizer, BertTokenizer
    except ImportError as e:
        raise ImportError(
            f"the tokenizers of {path} (llm_tokenizer/, bert_tokenizer/) need the transformers "
            "package, which is not installed") from e
    llm_tok = AutoTokenizer.from_pretrained(os.path.join(path, "llm_tokenizer"), use_fast=False)
    bert_tok = BertTokenizer.from_pretrained(os.path.join(path, "bert_tokenizer"))
    cfg = InstructBlipConfig.vicuna7b()
    params = convert_instructblip(load_state_dict(path), cfg, device=device)
    return llm_tok, bert_tok, params, cfg, "instructblip-vicuna7b"


def qformer_text(bert_tok, prompt_text: str, cfg) -> tuple:
    """The instruction as the Q-Former reads it: BERT ids cut to
    min(max_txt_len 128, the Q-Former's position table) keeping the trailing
    [SEP] (blip2_vicuna_instruct.py:286-296 tokenizes with truncation at
    max_txt_len), padded with zeros to a multiple of 32 (capped at that
    length), and its mask → (ids [1, pad], mask [1, pad]) int32."""
    max_txt = min(int(getattr(cfg, "max_txt_len", 128)), cfg.qformer.max_position_embeddings)
    raw = [int(t) for t in bert_tok(prompt_text).input_ids]
    if len(raw) > max_txt:
        raw = raw[: max_txt - 1] + [raw[-1]]
    pad = max(min(-(-len(raw) // 32) * 32, max_txt), len(raw))
    tid = np.zeros((1, pad), np.int32)
    tid[0, : len(raw)] = raw
    tmask = np.zeros_like(tid)
    tmask[0, : len(raw)] = 1
    return tid, tmask


def run(args) -> str:
    """Answer the question file into args.answers_file; returns its path."""
    apply_dist_auto(args)
    device = torch.device(args.device) if getattr(args, "device", None) else None
    llm_tok, bert_tok, params, cfg, model_name = load_blip_model(args.model_path, device=device)
    questions = load_questions_for(args)
    if args.max_questions:
        questions = questions[: args.max_questions]
    ans = AnswerFile(args.answers_file, resume=args.resume)

    gen = make_generation_config(args, eos_token_id=2)
    adapter = InstructBlipAdapter(cfg)
    engine = DecodeEngine(params, cfg, gen, adapter=adapter, bucket=32)
    dev = engine.device
    score_engine = None
    if args.calibrate:
        score_gen = make_generation_config(
            args, eos_token_id=2, use_cd=False, use_dd=False, use_dd_unk=False, max_new_tokens=1,
        )
        score_engine = DecodeEngine(params, cfg, score_gen, adapter=adapter, bucket=32)

    @torch.inference_mode()
    def encode_feats(image_np, prompt_text, generator=None, noise_step=None):
        imgs = torch.from_numpy(image_np).to(dev, cfg.vision.dtype)[None]
        if generator is not None:
            imgs = add_diffusion_noise(imgs, noise_step, generator=generator)
        tid, tmask = (torch.from_numpy(a).to(dev) for a in qformer_text(bert_tok, prompt_text, cfg))
        return instructblip.encode(params, cfg, imgs, tid, tmask)

    def _submit(line):
        """Every device call of one question."""
        idx = line["question_id"]
        prompt = line["text"] + " Please answer this question with one word."
        ids = [IMAGE_TOKEN_INDEX] + list(llm_tok(prompt).input_ids)
        image = _load_image(args, line.get("image", ""), cfg)
        # the noise and sampling stream of this question
        g = torch.Generator(device=dev).manual_seed(args.seed + (zlib.crc32(str(idx).encode()) % 65536))

        feats = encode_feats(image, prompt)
        if gen.use_cd:
            feats = torch.cat([feats, encode_feats(image, prompt, g, gen.noise_step)])

        handles = {"main": engine.submit_generate(ids, None, generator=g, precomputed_feats=feats)}
        if score_engine is not None:
            # 'none' = text only (blip_calibrate.py:95): no sentinel, so the
            # dummy features are never read
            dummy = np.zeros((1, 1, feats.shape[-1]), np.float32)
            handles["none"] = score_engine.submit_generate(ids[1:], None, generator=g, precomputed_feats=dummy)
            # 'noise' = the pure-noise image (noise_step 999, blip_calibrate.py:94)
            handles["noise"] = score_engine.submit_generate(
                ids, None, generator=g, precomputed_feats=encode_feats(image, prompt, g, 999))
        return line, handles

    def _finish(line, handles):
        out = engine.collect_generate(handles["main"])
        tokens_naive = calibrate_label_dict(out.first_scores_top_probs, out.first_scores_top_ids, llm_tok)
        record = {
            "question_id": line["question_id"],
            "prompt": line["text"],
            "text": llm_tok.decode(out.token_ids, skip_special_tokens=True).strip(),
            "model_id": model_name,
            "image": line.get("image", ""),
            "logits_score": get_prob_from_logits(tokens_naive),
            "naive": tokens_naive,
            "metadata": {},
        }
        for name in ("none", "noise"):
            if name in handles:
                o = score_engine.collect_generate(handles[name])
                record[name] = calibrate_label_dict(o.first_scores_top_probs, o.first_scores_top_ids, llm_tok)
        ans.write(record)

    # one question in flight, as in the JAX runner: an answer already
    # decoded is written before an error in the next question propagates
    in_flight = None
    for line in questions:
        if ans.is_done(line["question_id"], line.get("text")):
            continue
        try:
            entry = _submit(line)
        except BaseException:
            if in_flight is not None:
                _finish(*in_flight)
                in_flight = None
            raise
        if in_flight is not None:
            _finish(*in_flight)
        in_flight = entry
    if in_flight is not None:
        _finish(*in_flight)
    ans.close()
    return finish_dist_auto(args)


def _load_image(args, image_file: str, cfg) -> np.ndarray:
    """CLIP-preprocessed [3, S, S] float32: the file through
    clip_preprocess_pil, or with --synthetic-images a missing file's seeded
    noise image, normalized without PIL (the JAX runner's same-size PIL
    resize and whole-image crop are copies, so the pixels are as drawn)."""
    path = os.path.join(args.image_folder, image_file) if args.image_folder else image_file
    if os.path.exists(path):
        from PIL import Image

        from llava_align_tpu_torch.ops.image import clip_preprocess_pil

        return clip_preprocess_pil(Image.open(path), cfg.vision.image_size)
    if not args.synthetic_images:
        raise FileNotFoundError(path)
    return normalize_host(synthetic_image_uint8(image_file, cfg.vision.image_size))


def build_parser() -> argparse.ArgumentParser:
    from llava_align_tpu_torch.runners.pope import build_parser as base

    return base()


if __name__ == "__main__":
    run(build_parser().parse_args())
