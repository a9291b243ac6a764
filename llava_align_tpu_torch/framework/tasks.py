"""Task abstraction, the captioning, POPE, classification, pretraining and
retrieval parts (copies of save_result, BaseTask, CaptionTask, _coerce_id,
PopeTask, MultimodalClassificationTask, ImageTextPretrainTask and
RetrievalTask from llava_align_tpu/framework/tasks.py, the source
unchanged; tests/test_torch_copies.py holds them to it).

Capability parity: reference lavis/tasks/base_task.py — setup from config
via the registry, train_epoch delegation, the evaluation loop collecting
per-sample results, the after_evaluation hook and save_result — and
lavis/tasks/captioning.py (CaptionTask), multimodal_classification.py,
image_text_pretrain.py and retrieval.py (recall@{1,5,10} both ways);
PopeTask scores through evals/pope.score_pope. The VQA, GQA, AOK-VQA,
reading-comprehension, dialogue and text-to-image tasks of the JAX module
are not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, Iterable, List, Optional

from llava_align_tpu_torch.framework.logger import MetricLogger
from llava_align_tpu_torch.framework.registry import registry


def save_result(
    results: List[dict],
    result_dir: str,
    filename: str,
    remove_duplicate: Optional[str] = None,
) -> str:
    """Write per-sample results to json, deduplicating on a key (reference
    base_task.save_result; the dist-gather collapses to a no-op under SPMD
    where every host holds the full result list)."""
    os.makedirs(result_dir, exist_ok=True)
    if remove_duplicate:
        seen, deduped = set(), []
        for r in results:
            k = r.get(remove_duplicate)
            if k not in seen:
                seen.add(k)
                deduped.append(r)
        results = deduped
    path = os.path.join(result_dir, f"{filename}.json")
    with open(path, "w") as f:
        json.dump(results, f)
    logging.info("result file saved to %s", path)
    return path


@registry.register_task("base")
class BaseTask:
    def __init__(self, **kwargs):
        self.cfg = kwargs

    # -- assembly ------------------------------------------------------------

    @classmethod
    def setup_task(cls, run_cfg: Dict[str, Any]) -> "BaseTask":
        return cls(**run_cfg.get("task_args", {}))

    def build_model(self, model_cfg: Dict[str, Any]):
        arch = model_cfg.get("arch")
        model_cls = registry.get_model_class(arch)
        if model_cls is None:
            raise KeyError(f"unknown model arch {arch!r}")
        return model_cls(**{k: v for k, v in model_cfg.items() if k != "arch"})

    def build_datasets(self, datasets_cfg: Dict[str, Any]) -> Dict[str, Any]:
        """name → {split: dataset} via registered builders (the reference's
        lavis BaseTask.build_datasets → builder.build_datasets())."""
        datasets = {}
        for name, dcfg in datasets_cfg.items():
            builder_cls = registry.get_builder_class(dcfg.get("builder", name))
            if builder_cls is None:
                raise KeyError(f"unknown dataset builder {name!r}")
            builder = builder_cls(**{k: v for k, v in dcfg.items() if k != "builder"})
            datasets[name] = builder.build() if hasattr(builder, "build") else builder
        return datasets

    # -- training ------------------------------------------------------------

    def train_epoch(
        self, epoch: int, train_step: Callable, state: tuple, loader: Iterable,
        *, log_freq: int = 50,
    ):
        """state = (params, opt_state); returns (state, stats)."""
        params, opt_state = state
        metrics = MetricLogger()
        for batch in metrics.log_every(loader, log_freq, header=f"Train epoch {epoch}"):
            params, opt_state, loss = train_step(params, opt_state, batch)
            metrics.update(loss=float(loss))
        return (params, opt_state), metrics.global_avg()

    # -- evaluation ----------------------------------------------------------

    def valid_step(self, params, sample) -> List[dict]:
        raise NotImplementedError

    def evaluation(self, params, loader: Iterable, *, log_freq: int = 50) -> List[dict]:
        metrics = MetricLogger()
        results: List[dict] = []
        for sample in metrics.log_every(loader, log_freq, header="Evaluation"):
            results.extend(self.valid_step(params, sample))
        return results

    def after_evaluation(self, results: List[dict], **kwargs) -> Dict[str, float]:
        return {"agg_metrics": 0.0, "n": len(results)}


@registry.register_task("captioning")
class CaptionTask(BaseTask):
    """Image captioning (reference lavis/tasks/captioning.py:16-85): generate
    with beam/len knobs, save {caption, image_id} results deduped on
    image_id. COCO CIDEr/BLEU scoring needs pycocoevalcap (not in this
    image), so report_metric defaults False and `metric_fn` is the hook."""

    def __init__(
        self,
        generate_fn: Optional[Callable] = None,
        num_beams: int = 3,
        max_len: int = 30,
        min_len: int = 8,
        evaluate: bool = True,
        report_metric: bool = False,
        metric_fn: Optional[Callable] = None,
        result_dir: str = "results",
        **kw,
    ):
        super().__init__(**kw)
        self.generate_fn = generate_fn
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.evaluate = evaluate
        self.report_metric = report_metric
        self.metric_fn = metric_fn
        self.result_dir = result_dir

    def valid_step(self, params, sample) -> List[dict]:
        captions = self.generate_fn(
            params, sample, num_beams=self.num_beams,
            max_length=self.max_len, min_length=self.min_len,
        )
        ids = sample["image_id"]
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
            if not isinstance(captions, (list, tuple)):
                captions = [captions]
        return [
            {"caption": c, "image_id": _coerce_id(i)} for c, i in zip(captions, ids)
        ]

    def after_evaluation(self, results, split_name="val", epoch=0, **kwargs):
        path = save_result(
            results, self.result_dir, f"{split_name}_epoch{epoch}",
            remove_duplicate="image_id",
        )
        if self.report_metric and self.metric_fn is not None:
            return self.metric_fn(path, split_name)
        return {"agg_metrics": 0.0, "n": len(results)}


def _coerce_id(i):
    """COCO-style integer ids when possible; string ids pass through
    (POPE/MME image names are not integers)."""
    try:
        return int(i)
    except (TypeError, ValueError):
        return i


@registry.register_task("pope")
class PopeTask(BaseTask):
    """Eval-only task: samples are POPE jsonl rows; valid_step is supplied a
    generate callable; after_evaluation runs the plain scorer."""

    def __init__(self, generate_fn: Optional[Callable] = None, **kw):
        super().__init__(**kw)
        self.generate_fn = generate_fn

    def valid_step(self, params, sample) -> List[dict]:
        text = self.generate_fn(params, sample)
        return [{"question_id": sample["question_id"], "text": text,
                 "label": sample.get("label")}]

    def after_evaluation(self, results: List[dict], **kwargs) -> Dict[str, float]:
        from llava_align_tpu_torch.evals.pope import score_pope

        gt = [{"question_id": r["question_id"], "label": r["label"]} for r in results]
        m = score_pope(gt, results)
        m["agg_metrics"] = m["f1"]
        logging.info("POPE eval: %s", m)
        return m


@registry.register_task("multimodal_classification")
class MultimodalClassificationTask(BaseTask):
    """Prediction-vs-label accuracy (reference
    lavis/tasks/multimodal_classification.py): valid_step emits
    {prediction, target}; after_evaluation reports accuracy."""

    def __init__(self, predict_fn: Optional[Callable] = None, result_dir: str = "results", **kw):
        super().__init__(**kw)
        self.predict_fn = predict_fn
        self.result_dir = result_dir

    def valid_step(self, params, sample) -> List[dict]:
        pred = self.predict_fn(params, sample)
        return [{
            "question_id": sample.get("question_id"),
            "prediction": pred,
            "target": sample.get("label"),
        }]

    def after_evaluation(self, results, split_name="val", **kwargs):
        save_result(results, self.result_dir, f"{split_name}_cls_result")
        n = len(results)
        correct = sum(1 for r in results if r["prediction"] == r["target"])
        acc = 100.0 * correct / max(n, 1)
        return {"agg_metrics": acc, "accuracy": acc, "n": n}


@registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    """Pretraining task (reference lavis/tasks/image_text_pretrain.py:12-19):
    training-only — evaluation is a no-op returning no results."""

    def evaluation(self, params, loader, **kw):
        return []

    def after_evaluation(self, results, **kwargs):
        return {"agg_metrics": 0.0, "n": 0}


@registry.register_task("retrieval")
class RetrievalTask(BaseTask):
    """Image-text retrieval recall@{1,5,10} (reference lavis/tasks/
    retrieval.py:33-100): the model supplies similarity matrices
    (`sim_fn(params, loader) -> (scores_i2t, scores_t2i)`; BLIP's ITC
    features + optional ITM re-ranking), the task computes both directions'
    recalls with multi-caption ground truth (img2txt lists)."""

    def __init__(self, sim_fn: Optional[Callable] = None, result_dir: str = "results", **kw):
        super().__init__(**kw)
        self.sim_fn = sim_fn
        self.result_dir = result_dir

    def evaluation(self, params, loader, **kw):
        scores_i2t, scores_t2i = self.sim_fn(params, loader)
        return {"scores_i2t": scores_i2t, "scores_t2i": scores_t2i}

    @staticmethod
    def report_metrics(scores_i2t, scores_t2i, txt2img, img2txt) -> Dict[str, float]:
        import numpy as np

        scores_i2t = np.asarray(scores_i2t)
        scores_t2i = np.asarray(scores_t2i)
        # images → text: best rank over the image's caption set
        ranks = np.zeros(scores_i2t.shape[0])
        for index, score in enumerate(scores_i2t):
            inds = np.argsort(score)[::-1]
            ranks[index] = min(np.where(inds == i)[0][0] for i in img2txt[index])
        tr1, tr5, tr10 = (
            100.0 * float(np.mean(ranks < k)) for k in (1, 5, 10)
        )
        # text → images
        ranks = np.zeros(scores_t2i.shape[0])
        for index, score in enumerate(scores_t2i):
            inds = np.argsort(score)[::-1]
            ranks[index] = np.where(inds == txt2img[index])[0][0]
        ir1, ir5, ir10 = (
            100.0 * float(np.mean(ranks < k)) for k in (1, 5, 10)
        )
        tr_mean = (tr1 + tr5 + tr10) / 3
        ir_mean = (ir1 + ir5 + ir10) / 3
        return {
            "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
            "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
            "r_mean": (tr_mean + ir_mean) / 2, "agg_metrics": tr_mean,
        }

    def after_evaluation(self, results, *, txt2img, img2txt, **kw) -> Dict[str, float]:
        m = self.report_metrics(
            results["scores_i2t"], results["scores_t2i"], txt2img, img2txt
        )
        logging.info("retrieval: %s", m)
        return m

