"""Image-captioning runner: InstructBLIP beam-search captions through the
CaptionTask orchestration (the port of llava_align_tpu/runners/caption.py,
the same command line and the same results file).

Capability parity: LAVIS's caption evaluation (lavis/tasks/captioning.py
valid_step → model.generate with num_beams / max_len / min_len;
blip2_vicuna_instruct.py generate, num_beams=5 by default). Decoding is
the engine's beam search (decoding/beam.py, HF semantics).

    python -m llava_align_tpu_torch.runners.caption --model-path random:tiny --device cpu \\
        --question-file images.jsonl --result-dir results --synthetic-images

--question-file: jsonl rows {image, image_id?}; the captions go to
<result-dir>/<split>_epoch0.json as [{caption, image_id}]. The defaults are
LAVIS captioning's: 5 beams, max_len 30, min_len 8, length_penalty 1.
"""

from __future__ import annotations

import argparse

import torch

from llava_align_tpu_torch.config import GenerationConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.framework.tasks import CaptionTask, _coerce_id
from llava_align_tpu_torch.models import instructblip
from llava_align_tpu_torch.runners.blip_pope import _load_image, load_blip_model
from llava_align_tpu_torch.runners.common import load_questions_for


def run(args) -> str:
    """Caption every image of the question file; returns args.result_dir."""
    device = torch.device(args.device) if args.device else None
    llm_tok, bert_tok, params, cfg, model_name = load_blip_model(args.model_path, device=device)
    questions = load_questions_for(args)
    if args.max_questions:
        questions = questions[: args.max_questions]

    gen = GenerationConfig(max_new_tokens=args.max_len, do_sample=False, eos_token_id=2, pad_token_id=0)
    engine = DecodeEngine(params, cfg, gen, adapter=InstructBlipAdapter(cfg), bucket=32)
    dev = engine.device

    @torch.inference_mode()
    def generate_fn(params_unused, sample, **kw):
        image = _load_image(args, sample["image"], cfg)
        # the instruction-conditioned Q-Former stream, then the LLM's beams
        prompt = args.prompt
        tid = torch.tensor([bert_tok(prompt).input_ids], dtype=torch.int32, device=dev)
        feats = instructblip.encode(params, cfg, torch.from_numpy(image).to(dev, cfg.vision.dtype)[None],
                                    tid, torch.ones_like(tid))
        ids = [IMAGE_TOKEN_INDEX] + list(llm_tok(prompt).input_ids)
        out = engine.generate_beam(
            ids, num_beams=kw.get("num_beams", args.num_beams), length_penalty=args.length_penalty,
            min_new_tokens=kw.get("min_length", args.min_len), precomputed_feats=feats,
        )
        return [llm_tok.decode(out.token_ids, skip_special_tokens=True).strip()]

    task = CaptionTask(generate_fn=generate_fn, num_beams=args.num_beams, max_len=args.max_len,
                       min_len=args.min_len, result_dir=args.result_dir)
    samples = [{"image_id": [q.get("image_id", q.get("question_id", i))], "image": q["image"]}
               for i, q in enumerate(questions)]

    # CaptionTask.valid_step reads sample["image_id"]; generate_fn needs the
    # image path too, so the whole sample goes through
    def wrapped_valid(params_, sample):
        return [{"caption": generate_fn(params_, sample)[0], "image_id": _coerce_id(sample["image_id"][0])}]

    task.valid_step = wrapped_valid
    results = task.evaluation(params, samples, log_freq=args.log_freq)
    print(task.after_evaluation(results, split_name=args.split, epoch=0))
    return args.result_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--question-file", required=True, help="jsonl rows with {image, image_id?}")
    p.add_argument("--image-folder", default="")
    p.add_argument("--result-dir", default="results")
    p.add_argument("--split", default="val")
    p.add_argument("--prompt", default="A short image description:")
    p.add_argument("--num-beams", type=int, default=5)
    p.add_argument("--max-len", dest="max_len", type=int, default=30)
    p.add_argument("--min-len", dest="min_len", type=int, default=8)
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--max-questions", type=int, default=0)
    p.add_argument("--log-freq", type=int, default=10)
    p.add_argument("--synthetic-images", action="store_true", default=False)
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return p


if __name__ == "__main__":
    run(build_parser().parse_args())
