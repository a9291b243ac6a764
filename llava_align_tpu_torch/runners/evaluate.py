"""Config-driven evaluation entry point (the LAVIS `evaluate.py` surface;
torch twin of llava_align_tpu/runners/evaluate.py).

    python -m llava_align_tpu_torch.runners.evaluate --cfg-path eval.yaml \
        [--options run.device=cpu run.k_test=4 ...]

LAVIS assembles every run from a YAML config — task, model arch, dataset
builders — through its registries and `RunnerBase.evaluate`. This CLI
closes the same loop on framework/: a YAML of the shape

    run:
      task: retrieval            # registry task name
      task_args: {...}           # optional task kwargs
      split: test                # which built split to evaluate
      k_test: 2                  # retrieval re-rank depth
      device: cpu                # optional; the GPU when unset
    model:
      arch: albef_retrieval      # registry model arch
      model_path: null           # checkpoint dir, or null for random/tiny
    datasets:
      flickr_tiny:
        builder: retrieval
        synthetic_images: true
        build_info:
          test: {ann_paths: [/path/ann.json], vis_root: ""}

evaluates every configured dataset and prints one JSON metrics line per
dataset. Four branches, as in the JAX CLI: `retrieval` (images or, for
ALPRO, videos against their captions: recall@{1,5,10} both ways, with the
re-rank of the top k_test), `multimodal_classification` (accuracy), `vqa`
(the answer list ranked per question, VQAv2 soft accuracy) and any other
task through its own evaluation loop. One departure: for the `dialogue`
task the port supplies DialogueTask's loss_fn (the model's dialogue loss
on each collated sample); the JAX CLI leaves it unset, and its run fails
there.

Text tokenization: pass `run.tokenizer_path` (a local BERT vocab file,
needs transformers) for real checkpoints; without it a deterministic crc32
mock is used — the offline smoke configuration, whose metrics are
meaningful only for random-weight models.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Any, Dict

import numpy as np
import torch

from llava_align_tpu_torch.runners.common import resolve_tokenizer


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x)).to(device)


def _eval_retrieval(task, model, dataset, run_cfg: Dict[str, Any], tokenize, device) -> Dict[str, float]:
    def visual(i):
        s = dataset[i]
        return s["image"] if "image" in s else s["video"]

    pixels = np.stack([visual(i) for i in range(len(dataset.image))])
    ids, mask = tokenize(dataset.text)
    k_test = int(run_cfg.get("k_test", 0))
    task.sim_fn = lambda params, loader: model.compute_sim_matrix(
        _t(pixels, device), _t(ids, device), _t(mask, device), k_test=k_test)
    results = task.evaluation(model.params, loader=None)
    return task.after_evaluation(results, txt2img=dataset.txt2img, img2txt=dataset.img2txt)


@torch.inference_mode()
def _eval_classification(task, model, dataset, run_cfg, tokenize, device) -> Dict[str, float]:
    correct = total = 0
    for i in range(len(dataset)):
        s = dataset[i]
        ids, mask = tokenize([s["text_input"]])
        logits = model.predict(_t(s["image"][None], device), _t(ids, device), _t(mask, device))
        pred = int(logits.float().cpu().numpy().argmax(-1)[0])
        correct += int(pred == int(s["label"]))
        total += 1
    acc = 100.0 * correct / max(total, 1)
    return {"acc": acc, "agg_metrics": acc, "n": total}


def _eval_vqa(task, model, dataset, run_cfg, tokenize, device) -> Dict[str, float]:
    """Rank-based VQA eval (the LAVIS inference_method='rank' path): rank
    the dataset's answer_list per question with the model's two-stage
    answer decoder, score VQAv2 soft accuracy when gt answers exist."""
    answer_list = dataset.answer_list or run_cfg.get("answer_list")
    if not answer_list:
        raise ValueError("vqa rank eval needs an answer list (dataset answer_list_path or run.answer_list)")
    # answers led by the decoder bos id (reference rank_answers convention)
    bos = int(run_cfg.get("answer_bos_id", 2))
    a_ids, a_mask = tokenize(answer_list)
    a_ids = np.concatenate([np.full((len(answer_list), 1), bos, np.int64), a_ids[:, :-1]], axis=1)
    a_mask = np.concatenate([np.ones((len(answer_list), 1), np.int64), a_mask[:, :-1]], axis=1)
    a_ids, a_mask = _t(a_ids, device), _t(a_mask, device)
    k = int(run_cfg.get("num_ans_candidates", min(128, len(answer_list))))
    results = []
    for i in range(len(dataset)):
        s = dataset[i]
        q_ids, q_mask = tokenize([s["text_input"]])
        idx = model.predict_answers(_t(s["image"][None], device), _t(q_ids, device), _t(q_mask, device), a_ids,
                                    a_mask, num_ans_candidates=k)
        out = {"question_id": s["question_id"], "answer": answer_list[int(idx[0])]}
        ann = dataset.annotation[i]
        if "answer" in ann:
            out["gt_answers"] = ann["answer"]
        results.append(out)
    return task.after_evaluation(results, split_name=run_cfg.get("split", "val"))


def _dialogue_loss(model, dataset, device):
    """DialogueTask's loss_fn: the model's loss on one sample, collated by
    the dataset as a batch of one."""
    keys = ("input_ids", "video_fts", "attn_mask", "token_type_ids", "labels")

    @torch.inference_mode()
    def loss_fn(params, sample):
        batch = dataset.collater([sample])
        return model.forward(**{k: _t(batch[k], device) for k in keys})["loss"].item()

    return loss_fn


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg-path", required=True, help="run YAML")
    ap.add_argument("--options", nargs="*", default=[],
                    help="dot-list overrides, e.g. run.k_test=4 model.arch=blip_retrieval run.device=cpu")
    args = ap.parse_args(argv)

    import llava_align_tpu_torch  # noqa: F401
    from llava_align_tpu_torch.framework import model_zoo, processors, tasks  # noqa: F401 (the registrations)
    from llava_align_tpu_torch.framework.config import Config
    from llava_align_tpu_torch.framework.datasets import build_datasets_for_model
    from llava_align_tpu_torch.framework.registry import registry
    from llava_align_tpu_torch.utils.synthetic import resolve_device

    cfg = Config(args.cfg_path, options=args.options)
    run_cfg = cfg.run_cfg
    device = resolve_device(run_cfg.get("device"))
    task_name = run_cfg.get("task")
    task_cls = registry.get_task_class(task_name)
    if task_cls is None:
        raise KeyError(f"unknown task {task_name!r}")
    task = task_cls.setup_task(run_cfg)
    model = task.build_model({"device": device, **cfg.model_cfg})
    datasets = build_datasets_for_model(task, model, cfg.datasets_cfg)

    vocab = getattr(getattr(model.cfg, "text", None), "vocab_size", 64) or 64
    tokenize = resolve_tokenizer(run_cfg, vocab)
    split = run_cfg.get("split", "test")
    metrics: Dict[str, float] = {}
    for name, splits in datasets.items():
        if split not in splits:
            raise KeyError(f"dataset {name!r} has no split {split!r} (has {list(splits)})")
        dataset = splits[split]
        if task_name == "retrieval":
            metrics = _eval_retrieval(task, model, dataset, run_cfg, tokenize, device)
        elif task_name == "multimodal_classification":
            metrics = _eval_classification(task, model, dataset, run_cfg, tokenize, device)
        elif task_name == "vqa":
            metrics = _eval_vqa(task, model, dataset, run_cfg, tokenize, device)
        else:
            if task_name == "dialogue" and task.loss_fn is None:
                task.loss_fn = _dialogue_loss(model, dataset, device)
            results = task.evaluation(model.params, loader=(dataset[i] for i in range(len(dataset))))
            metrics = task.after_evaluation(results, split_name=split)
        print(json.dumps({"dataset": name, "split": split, **{
            k: (float(v) if isinstance(v, (int, float, np.floating)) else v) for k, v in metrics.items()}}))
    return metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
