"""Qwen-VL POPE runner, the port of llava_align_tpu/runners/qwen_pope.py with
the same knobs and the same jsonl records.

Capability parity: experiments/eval/calibrate/qwen_calibrate.py — prompt
format '<img>{path}</img>{question} Answer:' (:41,100), content-free variants
'none' = '{q} Answer:' and 'unk' = 'None {q} Answer:' (:34-39), eod stopping,
max_new_tokens=20 (:47,115).

    python -m llava_align_tpu_torch.runners.qwen_pope --model-path random:tiny --device cpu \\
        --question-file questions.jsonl --answers-file answers.jsonl --use_dd --use_dd_unk \\
        --temperature 0 --synthetic-images --calibrate
    python -m llava_align_tpu_torch.evals.pope questions.jsonl answers.jsonl

--model-path: random:* (the tiny random tree with the mock tokenizer, as in
the JAX runner) or a Qwen-VL checkpoint dir (config.json, weights, and
qwen.tiktoken for the native tokenizer, which needs `regex`; without
qwen.tiktoken the tokenizer needs transformers). The GPU unless --device cpu
is given. --quant int8 quantizes the decoder; --quant w8a8 does too and
adds W8A8 at prefill row counts (DecodeEngine act_quant). Refused: --quant
int4 (the JAX runner's reason). --dist auto as in the POPE runner.
"""

from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import torch

from llava_align_tpu_torch.calibrate.posthoc import calibrate_label_dict, get_prob_from_logits
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.models import qwen_vl as qwen_vl_model
from llava_align_tpu_torch.models.qwen_vl import QwenVLConfig
from llava_align_tpu_torch.ops.image import normalize_host, qwen_preprocess_pil
from llava_align_tpu_torch.runners.common import (
    AnswerFile,
    apply_dist_auto,
    finish_dist_auto,
    MockTokenizer,
    load_questions_for,
    make_generation_config,
)


class QwenMockTokenizer(MockTokenizer):
    eod_id = 2


def load_qwen_model(model_path: str, device=None):
    """(tokenizer, params, cfg, model name) on `device` (the GPU unless
    another is named): random:* gives the tiny random tree
    (QwenVLConfig.tiny) with the mock tokenizer; a checkpoint dir goes
    through utils.hf_convert.load_qwen_vl_checkpoint in bf16."""
    if model_path.startswith("random:"):
        from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

        cfg = QwenVLConfig.tiny()
        return QwenMockTokenizer(), build_random_qwen_vl_params(cfg, device=device), cfg, "random-qwen-vl"
    from llava_align_tpu_torch.utils.hf_convert import load_qwen_vl_checkpoint

    path = os.path.expanduser(model_path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint dir at {path}")
    vocab_file = os.path.join(path, "qwen.tiktoken")
    if os.path.exists(vocab_file):
        # the native offline tokenizer (models/qwen_tokenizer.py), not the
        # checkpoint's trust_remote_code tokenization_qwen.py
        from llava_align_tpu_torch.models.qwen_tokenizer import QwenTokenizer

        tok = QwenTokenizer(vocab_file)
    else:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"{path} has no qwen.tiktoken, and its tokenizer then needs the transformers "
                "package, which is not installed") from e
        tok = AutoTokenizer.from_pretrained(path, trust_remote_code=True)
    params, cfg = load_qwen_vl_checkpoint(path, torch.bfloat16, device=device)
    name = "qwen-vl" if "Chat" not in model_path else "qwen-vl-chat"
    return tok, params, cfg, name


def _text_ids(tokenizer, text: str):
    return list(tokenizer(text).input_ids)


def run(args) -> str:
    """Answer the question file into args.answers_file; returns its path."""
    apply_dist_auto(args)
    quant = getattr(args, "quant", "none")
    act_quant = quant == "w8a8"  # int8 weights + W8A8 at prefill row counts
    if act_quant:
        quant = "int8"
    if quant == "int4":
        raise ValueError(
            "qwen int4 is unsupported: the 13696-wide FFN is not 256-aligned "
            "for split-half int4 packing; use --quant int8"
        )
    device = torch.device(args.device) if getattr(args, "device", None) else None
    tokenizer, params, cfg, model_name = load_qwen_model(args.model_path, device=device)
    if quant == "int8":
        # int8 weight-only serving for the decoder; the visual tower stays in
        # its float dtype (it runs once per image group, not per token)
        from llava_align_tpu_torch.ops.quant import quantize_qwen_params

        params = dict(params, qwen=quantize_qwen_params(params["qwen"]))
    eod = getattr(tokenizer, "eod_id", getattr(tokenizer, "eos_token_id", 2))
    questions = load_questions_for(args)
    if args.max_questions:
        questions = questions[: args.max_questions]
    ans = AnswerFile(args.answers_file, resume=args.resume)

    gen = make_generation_config(args, eos_token_id=eod, max_new_tokens=args.max_new_tokens)
    adapter = QwenVLAdapter(cfg)
    engine = DecodeEngine(params, cfg, gen, adapter=adapter, bucket=64, act_quant=act_quant)
    score_engine = None
    if args.calibrate:
        score_gen = make_generation_config(
            args, eos_token_id=eod, use_cd=False, use_dd=False, use_dd_unk=False, max_new_tokens=1,
        )
        score_engine = DecodeEngine(params, cfg, score_gen, adapter=adapter, bucket=64,
                                    act_quant=act_quant)

    def rng(seed: int) -> torch.Generator:
        """A fresh sampling stream per call, as the JAX runner hands each
        call of a batch the same key."""
        return torch.Generator(device=engine.device).manual_seed(seed)

    span = qwen_vl_model.make_image_span_ids(cfg)

    def prompt_ids(q: str):
        # main prompt: '<img>{path}</img>{q} Answer:', the span first
        sent_ids, _ = qwen_vl_model.sentinelize_span(span + _text_ids(tokenizer, f"{q} Answer:"), cfg)
        # the 'unk' branch = 'None {q} Answer:' needs the tokenizer's text:
        # explicit branch ids (qwen_calibrate.py:37)
        branch_ids = {}
        if gen.use_dd_unk:
            branch_ids["unk"] = _text_ids(tokenizer, f"None {q} Answer:")
        return sent_ids, branch_ids

    # consecutive same-image questions share the [<img> span] prefix KV:
    # the span is 256+ of the prompt's ~270 tokens, so the grouped path
    # prefills the image once per POPE group of 6 (the POPE runner's grouping)
    group_by_image = getattr(args, "group_by_image", True) and adapter.supports_shared_prefix
    pending = [l for l in questions if not ans.is_done(l["question_id"], l.get("text"))]
    groups: list = []
    for l in pending:
        if (group_by_image and groups and len(groups[-1]) < 6
                and groups[-1][-1].get("image", "") == l.get("image", "")):
            groups[-1].append(l)
        else:
            groups.append([l])

    def write_group(group, outs, seed):
        for line, out in zip(group, outs):
            q = line["text"]
            text = tokenizer.decode(out.token_ids, skip_special_tokens=True).strip()
            tokens_naive = calibrate_label_dict(out.first_scores_top_probs, out.first_scores_top_ids, tokenizer)
            record = {
                "question_id": line["question_id"],
                "prompt": q,
                "text": text,
                "model_id": model_name,
                "image": line.get("image", ""),
                "logits_score": get_prob_from_logits(tokens_naive),
                "naive": tokens_naive,
                "metadata": {},
            }
            if score_engine is not None:
                out_none = score_engine.generate(_text_ids(tokenizer, f"{q} Answer:"), None, generator=rng(seed))
                record["none"] = calibrate_label_dict(
                    out_none.first_scores_top_probs, out_none.first_scores_top_ids, tokenizer)
                out_unk = score_engine.generate(_text_ids(tokenizer, f"None {q} Answer:"), None,
                                                generator=rng(seed))
                record["unk"] = calibrate_label_dict(
                    out_unk.first_scores_top_probs, out_unk.first_scores_top_ids, tokenizer)
            ans.write(record)

    def make_split(group, image):
        """(prefix, suffixes, image, bids_list) for the grouped path, or None
        when the group cannot share a prefix; and each question's ids."""
        prepped = [prompt_ids(l["text"]) for l in group]
        ids_list = [ids for ids, _ in prepped]
        if len(group) < 2:
            return None, prepped
        p = DecodeEngine.common_token_prefix(ids_list)
        prefix = ids_list[0][:p]
        if IMAGE_TOKEN_INDEX not in prefix:
            return None, prepped
        return (prefix, [ids[p:] for ids in ids_list], image, [b for _, b in prepped]), prepped

    # GB uniform-size image groups per grouped call (the JAX runner's
    # default: 1, its int8 pick, and 2 under W8A8, its picks on a TPU),
    # submitted before the previous call is collected, in the JAX runner's
    # order (the port's submit runs the whole call, so nothing overlaps)
    GB = max(1, getattr(args, "group_batch", 0) or (2 if act_quant else 1))
    batches, cur = [], []
    for g in groups:
        if cur and (len(g) != len(cur[0]) or len(cur) >= GB):
            batches.append(cur)
            cur = []
        cur.append(g)
    if cur:
        batches.append(cur)

    in_flight = None  # (groups, seed, handle)

    def _flush_pending():
        nonlocal in_flight
        if in_flight is None:
            return
        gl, seed_p, handle = in_flight
        in_flight = None
        outs = engine.collect_batch_groups(handle)
        off = 0
        for g in gl:
            write_group(g, outs[off : off + len(g)], seed_p)
            off += len(g)

    gi = 0
    for batch in batches:
        seed = args.seed + (gi % 65536)
        gi += len(batch)
        images = [_load_image(args, g[0].get("image", ""), cfg) for g in batch]
        splits = [make_split(g, im) for g, im in zip(batch, images)]
        if all(sp is not None for sp, _ in splits):
            handle = engine.submit_batch_groups([sp for sp, _ in splits], generator=rng(seed))
            _flush_pending()  # collect the previous call
            in_flight = (batch, seed, handle)
            continue
        _flush_pending()
        for g, im, (sp, prepped) in zip(batch, images, splits):
            if sp is not None:
                outs = engine.generate_batch_groups([sp], generator=rng(seed))
            else:
                outs = [engine.generate(ids, im, generator=rng(seed), branch_ids=b) for ids, b in prepped]
            write_group(g, outs, seed)

    _flush_pending()
    ans.close()
    return finish_dist_auto(args)


def _load_image(args, image_file: str, cfg) -> np.ndarray:
    """Qwen-preprocessed [3, S, S] float32: the file through
    qwen_preprocess_pil, or with --synthetic-images a missing file's seeded
    noise image, normalized without PIL (PIL's resize to the size an image
    already has is a copy, so this is what qwen_preprocess_pil gives it)."""
    path = os.path.join(args.image_folder, image_file) if args.image_folder else image_file
    if os.path.exists(path):
        from PIL import Image

        return qwen_preprocess_pil(Image.open(path), cfg.vision.image_size)
    if not args.synthetic_images:
        raise FileNotFoundError(path)
    rng = np.random.default_rng(zlib.crc32(image_file.encode()))
    S = cfg.vision.image_size
    return normalize_host(rng.integers(0, 256, (S, S, 3), dtype=np.uint8).transpose(2, 0, 1))


def build_parser() -> argparse.ArgumentParser:
    from llava_align_tpu_torch.runners.pope import build_parser as base

    p = base()
    p.set_defaults(max_new_tokens=20)  # qwen_calibrate.py:47
    return p


if __name__ == "__main__":
    run(build_parser().parse_args())
