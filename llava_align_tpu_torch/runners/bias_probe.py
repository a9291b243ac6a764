"""Bias probe: first-token class distributions under meaningless visual
inputs (the port of llava_align_tpu/runners/bias_probe.py, with the same
records).

Capability parity: experiments/eval/calibrate/test_samples_llava.py:82-160
(the Figs 1/10 probes): for each probe question, dump the model's top-k
first-token distribution under inputs none / unk / pure-noise(999) / zeros /
ones (and the real image when provided). These are the content-free inputs
Post-Hoc calibration is fitted from.

    python -m llava_align_tpu_torch.runners.bias_probe --model-path random:tiny --device cpu \\
        --question-file questions.jsonl --answers-file probes.jsonl --synthetic-images

The GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from llava_align_tpu_torch.calibrate.posthoc import calibrate_label_dict
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.ops.noise import add_diffusion_noise
from llava_align_tpu_torch.runners.common import (
    AnswerFile,
    build_prompt,
    load_image_tensor,
    load_model,
    load_questions_for,
    make_generation_config,
)
from llava_align_tpu_torch.tokenization import keyword_token_ids, tokenizer_image_token


def run(args) -> str:
    """Write one record of probe dumps per question; returns the file."""
    device = torch.device(args.device) if getattr(args, "device", None) else None
    model = load_model(args.model_path, device=device)
    tokenizer, params, cfg = model.tokenizer, model.params, model.cfg
    questions = load_questions_for(args)
    if args.max_questions:
        questions = questions[: args.max_questions]
    ans = AnswerFile(args.answers_file, resume=args.resume)

    gen = make_generation_config(
        args, use_cd=False, use_dd=False, use_dd_unk=False, max_new_tokens=1
    )
    _, stop_str = build_prompt("x", args.conv_mode)
    engine = DecodeEngine(
        params, cfg, gen, stop_keyword_ids=keyword_token_ids([stop_str], tokenizer)
    )
    H = cfg.vision.image_size

    def stream(seed: int) -> torch.Generator:
        """A fresh stream per call, as the JAX runner hands each call one key."""
        return torch.Generator(device=engine.device).manual_seed(seed)

    def dump(input_ids, image, seed):
        out = engine.generate(input_ids, image, generator=stream(seed))
        return calibrate_label_dict(
            out.first_scores_top_probs, out.first_scores_top_ids, tokenizer, top_k=args.probe_top_k
        )

    for line in questions:
        idx = line["question_id"]
        if ans.is_done(idx, line.get("text")):
            continue
        qs = line["text"]
        seed = args.seed + (zlib.crc32(str(idx).encode()) % 65536)

        p_img, _ = build_prompt(qs, args.conv_mode, with_image=True, one_word=args.one_word)
        p_txt, _ = build_prompt(qs, args.conv_mode, with_image=False, one_word=args.one_word)
        ids_img = tokenizer_image_token(p_img, tokenizer)
        ids_txt = tokenizer_image_token(p_txt, tokenizer)
        ids_unk = [
            getattr(tokenizer, "unk_token_id", 0) if t == -200 else t for t in ids_img
        ]

        record = {"question_id": idx, "prompt": qs}
        record["none"] = dump(ids_txt, None, seed)
        record["unk"] = dump(ids_unk, None, seed)
        zeros = np.zeros((3, H, H), np.float32)
        record["zero"] = dump(ids_img, zeros, seed)
        record["one"] = dump(ids_img, np.ones((3, H, H), np.float32), seed)
        noise = add_diffusion_noise(torch.zeros((3, H, H), dtype=torch.float32, device=engine.device),
                                    999, generator=stream(seed))
        record["noise"] = dump(ids_img, noise.cpu().numpy(), seed)

        if line.get("image") and (args.image_folder or args.synthetic_images):
            image = load_image_tensor(
                args.image_folder, line["image"], image_size=H,
                image_aspect_ratio=args.image_aspect_ratio,
                synthetic_ok=args.synthetic_images,
            )
            record["naive"] = dump(ids_img, image, seed)
        ans.write(record)
    ans.close()
    return args.answers_file


def build_parser() -> argparse.ArgumentParser:
    from llava_align_tpu_torch.runners.pope import build_parser as base

    p = base()
    p.add_argument("--probe-top-k", type=int, default=10)
    return p


if __name__ == "__main__":
    run(build_parser().parse_args())
