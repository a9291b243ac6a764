"""MME benchmark runner: generate answers over llava_mme.jsonl, convert them
to per-category txts, score (the port of llava_align_tpu/runners/mme.py, on
the port's POPE runner, with the same knobs and records).

Capability parity: experiments/eval/MME/run_llava.py (generation; the
prompt has no 'one word' suffix: the MME questions carry 'Please answer yes
or no.'), run_qwen.py (--model-family qwen: '<img>{path}</img>{q} Answer:'
prompts through the qwen_pope runner, run_qwen.py:69,104-108),
convert_answer_to_mme.py, eval_tool/calculation.py (+ the
calculation_sampling.py / _calibrate.py multi-setting aggregation mains via
evals.mme.score_sweep_dirs).

    python -m llava_align_tpu_torch.runners.mme \\
        --model-path /ckpt/llava-v1.5-7b \\
        --question-file eval/MME/llava_mme.jsonl \\
        --image-folder /data/MME_Benchmark \\
        --answers-file out/mme/answers.jsonl \\
        --mme-data-root /data/MME_Benchmark [--use_dd --use_dd_unk ...]
    python -m llava_align_tpu_torch.runners.mme --score-sweep out/ --sweep-prefix mme_

The GPU unless --device cpu is given. --quant (w8a8 included) passes
through to the POPE runner (with --model-family qwen, the qwen_pope
runner), as in the JAX package. Refused: what those runners refuse.
"""

from __future__ import annotations

import json
import os

from llava_align_tpu_torch.evals.mme import convert_answers_to_category_txt, score_results_dir
from llava_align_tpu_torch.runners import pope
from llava_align_tpu_torch.runners.common import is_dist_worker


def load_mme_gt(data_path: str) -> dict:
    """MME_Benchmark dir → {(category, file, question): answer}
    (reference convert_answer_to_mme.py:19-38)."""
    gt = {}
    for category in os.listdir(data_path):
        category_dir = os.path.join(data_path, category)
        if not os.path.isdir(category_dir):
            continue
        if os.path.exists(os.path.join(category_dir, "images")):
            qa_path = os.path.join(category_dir, "questions_answers_YN")
        else:
            qa_path = category_dir
        if not os.path.isdir(qa_path):
            continue
        for file in os.listdir(qa_path):
            if not file.endswith(".txt"):
                continue
            with open(os.path.join(qa_path, file)) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        gt[(category, file, parts[0])] = parts[1]
    return gt


def run(args) -> dict:
    if getattr(args, "score_sweep", ""):
        # scoring-only mode: aggregate {prefix}{setting} results dirs
        # (reference calculation_sampling.py / _calibrate.py mains)
        from llava_align_tpu_torch.evals.mme import score_sweep_dirs

        results = score_sweep_dirs(args.score_sweep, args.sweep_prefix, csv_path=args.sweep_csv or None)
        for setting in sorted(results):
            scores = {k: round(v["total_score"], 2) for k, v in results[setting].items()}
            print(setting, json.dumps(scores))
        return results

    args.one_word = False  # MME questions already instruct yes/no
    if getattr(args, "model_family", "llava") == "qwen":
        # reference MME/run_qwen.py: the same flow with the qwen prompt
        # format; the qwen runner groups MME's 2 questions per image onto
        # the shared-prefix path
        from llava_align_tpu_torch.runners import qwen_pope

        answers_file = qwen_pope.run(args)
    else:
        if args.image_aspect_ratio is None:
            args.image_aspect_ratio = "pad"  # llava-v1.5 config default
        answers_file = pope.run(args)

    if is_dist_worker(args):
        # under --dist auto only rank 0 converts and scores: it holds the
        # merged file, the others a part, and they would race it into the
        # same mme_eval dir
        print("rank != 0: skipping MME conversion/scoring")
        return {}
    if not args.mme_data_root or not os.path.isdir(args.mme_data_root):
        print(f"--mme-data-root {args.mme_data_root!r} missing or not a directory; "
              "skipping conversion/scoring")
        return {}
    with open(answers_file) as f:
        answers = [json.loads(line) for line in f]
    gt = load_mme_gt(args.mme_data_root)
    out_dir = os.path.join(os.path.dirname(answers_file), "mme_eval")
    convert_answers_to_category_txt(answers, gt, out_dir)
    report = score_results_dir(out_dir)
    print(json.dumps(report, indent=2, default=float))
    return report


def build_parser():
    p = pope.build_parser()
    p.add_argument("--mme-data-root", type=str, default="")
    p.add_argument("--model-family", default="llava", choices=["llava", "qwen"],
                   help="qwen = reference MME/run_qwen.py counterpart")
    p.add_argument("--score-sweep", type=str, default="",
                   help="scoring-only: folder of {prefix}{setting} results dirs")
    p.add_argument("--sweep-prefix", type=str, default="")
    p.add_argument("--sweep-csv", type=str, default="")
    return p


def main(argv=None):
    import argparse
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if "--score-sweep" in argv:
        # scoring-only CLI: model/question args are irrelevant
        sp = argparse.ArgumentParser()
        sp.add_argument("--score-sweep", required=True)
        sp.add_argument("--sweep-prefix", default="")
        sp.add_argument("--sweep-csv", default="")
        return run(sp.parse_args(argv))
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
