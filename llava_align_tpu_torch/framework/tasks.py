"""Task abstraction and the evaluation tasks (copies of save_result,
BaseTask, CaptionTask, _coerce_id, PopeTask, MultimodalClassificationTask,
ImageTextPretrainTask, TextToImageGenerationTask, RetrievalTask, the VQAv2
tables with _vqa_process_punct and vqa_normalize, VQATask, GQATask,
AOKVQATask, VQARCTask, GQARCTask and DialogueTask from
llava_align_tpu/framework/tasks.py, the source unchanged;
tests/test_torch_copies.py holds them to it).

Capability parity: reference lavis/tasks/base_task.py — setup from config
via the registry, train_epoch delegation, the evaluation loop collecting
per-sample results, the after_evaluation hook and save_result — and
lavis/tasks/captioning.py (CaptionTask), multimodal_classification.py,
image_text_pretrain.py, retrieval.py (recall@{1,5,10} both ways), vqa.py
(VQAv2 leave-one-out soft accuracy, GQA exact match, A-OKVQA direct
answers), vqa_reading_comprehension.py, dialogue.py and
text_to_image_generation.py (a config-holding task for BLIP-Diffusion);
PopeTask scores through evals/pope.score_pope.
"""

from __future__ import annotations

import json
import logging
import os
import re
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


@registry.register_task("text-to-image-generation")
class TextToImageGenerationTask(BaseTask):
    """Text-to-image generation (reference
    lavis/tasks/text_to_image_generation.py:11-22): a config-holding task —
    the reference defines no valid_step/metrics; training goes through the
    base train loop. Kept as the registered assembly point for the
    blip-diffusion trainer."""

    @classmethod
    def setup_task(cls, run_cfg: Dict[str, Any]) -> "TextToImageGenerationTask":
        return cls(**run_cfg.get("task_args", {}), run_cfg=run_cfg)


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


# ---------------------------------------------------------------------------
# VQA (VQAv2 soft accuracy, GQA, A-OKVQA, the reading-comprehension
# variants) and dialogue
# ---------------------------------------------------------------------------


# VQAv2 evaluation spec data (reference lavis/common/vqa_tools/vqa_eval.py:
# punct/periodStrip/commaStrip/manualMap/articles/contractions tables — the
# official VQA eval constants, reproduced by spec like the prompt templates).
_VQA_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]
_VQA_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_VQA_COMMA = re.compile(r"(\d)(,)(\d)")
_VQA_MANUAL = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_VQA_ARTICLES = ("a", "an", "the")
_VQA_CONTRACTIONS = {
    "'ow'sat": "'ow's'at", "'ows'at": "'ow's'at", "I'dve": "I'd've",
    "Id've": "I'd've", 'Im': "I'm", 'Ive': "I've", 'aint': "ain't",
    'arent': "aren't", 'cant': "can't", "couldn'tve": "couldn't've",
    'couldnt': "couldn't", "couldnt've": "couldn't've",
    'couldve': "could've", 'didnt': "didn't", 'doesnt': "doesn't",
    'dont': "don't", "hadn'tve": "hadn't've", 'hadnt': "hadn't",
    "hadnt've": "hadn't've", 'hasnt': "hasn't", 'havent': "haven't",
    "he'dve": "he'd've", 'hed': "he'd", "hed've": "he'd've", 'hes': "he's",
    'howd': "how'd", 'howll': "how'll", 'hows': "how's", 'isnt': "isn't",
    "it'dve": "it'd've", 'itd': "it'd", "itd've": "it'd've", 'itll': "it'll",
    "let's": "let's", 'maam': "ma'am", "mightn'tve": "mightn't've",
    'mightnt': "mightn't", "mightnt've": "mightn't've",
    'mightve': "might've", 'mustnt': "mustn't", 'mustve': "must've",
    'neednt': "needn't", 'notve': "not've", 'oclock': "o'clock",
    'oughtnt': "oughtn't", "ow's'at": "'ow's'at", 'shant': "shan't",
    "she'dve": "she'd've", "she's": "she's", "shed've": "she'd've",
    "shouldn'tve": "shouldn't've", 'shouldnt': "shouldn't",
    "shouldnt've": "shouldn't've", 'shouldve': "should've",
    "somebody'd": 'somebodyd', "somebody'dve": "somebody'd've",
    "somebodyd've": "somebody'd've", 'somebodyll': "somebody'll",
    'somebodys': "somebody's", "someone'dve": "someone'd've",
    'someoned': "someone'd", "someoned've": "someone'd've",
    'someonell': "someone'll", 'someones': "someone's",
    "something'dve": "something'd've", 'somethingd': "something'd",
    "somethingd've": "something'd've", 'somethingll': "something'll",
    'thats': "that's", "there'dve": "there'd've", 'thered': "there'd",
    "thered've": "there'd've", 'therere': "there're", 'theres': "there's",
    "they'dve": "they'd've", 'theyd': "they'd", "theyd've": "they'd've",
    'theyll': "they'll", 'theyre': "they're", 'theyve': "they've",
    'twas': "'twas", 'wasnt': "wasn't", "we'dve": "we'd've",
    "wed've": "we'd've", 'werent': "weren't", 'weve': "we've",
    'whatll': "what'll", 'whatre': "what're", 'whats': "what's",
    'whatve': "what've", 'whens': "when's", 'whered': "where'd",
    'wheres': "where's", 'whereve': "where've", "who'dve": "who'd've",
    'whod': "who'd", "whod've": "who'd've", 'wholl': "who'll",
    'whos': "who's", 'whove': "who've", 'whyll': "why'll", 'whyre': "why're",
    'whys': "why's", 'wont': "won't", "wouldn'tve": "wouldn't've",
    'wouldnt': "wouldn't", "wouldnt've": "wouldn't've",
    'wouldve': "would've", "y'all'dve": "y'all'd've",
    "y'alld've": "y'all'd've", "y'allll": "y'all'll", 'yall': "y'all",
    "yall'd've": "y'all'd've", "yall'll": "y'all'll", "you'dve": "you'd've",
    'youd': "you'd", "youd've": "you'd've", 'youll': "you'll",
    'youre': "you're", 'youve': "you've",
}


def _vqa_process_punct(text: str) -> str:
    """reference vqa_eval.processPunctuation (:249-259)."""
    out = text
    for p in _VQA_PUNCT:
        if (p + " " in text or " " + p in text) or _VQA_COMMA.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _VQA_PERIOD.sub("", out)


def vqa_normalize(ans: str) -> str:
    """VQAv2 answer normalization (reference vqa_eval.py processPunctuation +
    processDigitArticle): punctuation rules incl. decimal-preserving period
    strip, digit words → digits, article removal, contraction canonicalization."""
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _vqa_process_punct(ans)
    words = []
    for w in ans.split():
        w = _VQA_MANUAL.get(w, w)
        if w not in _VQA_ARTICLES:
            words.append(w)
    words = [_VQA_CONTRACTIONS.get(w, w) for w in words]
    return " ".join(words)


@registry.register_task("vqa")
class VQATask(BaseTask):
    """Open-ended VQA (reference lavis/tasks/vqa.py): generate short answers,
    save {question_id, answer}, and when per-question human answer lists are
    attached, score with the official VQAv2 leave-one-out soft accuracy
    (reference vqa_eval.py:209-231): for each of the N human answers, count
    matches among the OTHER N-1, acc_i = min(1, matches/3), question accuracy
    = mean(acc_i). NOT the simplified min(total_matches/3, 1) — a prediction
    matching 3 of 10 humans scores 0.9 officially, not 1.0."""

    def __init__(
        self,
        generate_fn: Optional[Callable] = None,
        num_beams: int = 3,
        max_len: int = 10,
        min_len: int = 1,
        prompt: str = "",
        inference_method: str = "generate",
        result_dir: str = "results",
        **kw,
    ):
        super().__init__(**kw)
        self.generate_fn = generate_fn
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.prompt = prompt
        self.inference_method = inference_method
        self.result_dir = result_dir

    def valid_step(self, params, sample) -> List[dict]:
        answer = self.generate_fn(
            params, sample, num_beams=self.num_beams,
            max_length=self.max_len, min_length=self.min_len,
            prompt=self.prompt,
        )
        out = {"question_id": sample["question_id"], "answer": answer}
        if "gt_answers" in sample:
            out["gt_answers"] = sample["gt_answers"]
        return [out]

    def after_evaluation(self, results, split_name="val", **kwargs):
        save_result(
            results, self.result_dir, f"{split_name}_vqa_result",
            remove_duplicate="question_id",
        )
        scored = [r for r in results if r.get("gt_answers")]
        if not scored:
            return {"agg_metrics": 0.0, "n": len(results)}
        total = 0.0
        for r in scored:
            # pred gets the full pipeline; gts get processPunctuation only
            # (and only when the humans disagree) — the reference's exact
            # asymmetry, vqa_eval.py:211-222
            pred = vqa_normalize(str(r["answer"]))
            gts = [str(g) for g in r["gt_answers"]]
            if len(set(gts)) > 1:
                gts = [_vqa_process_punct(g) for g in gts]
            # leave-one-out by INDEX (the reference excludes one answer
            # datum; string-identity exclusion would drop duplicates too)
            accs = [
                min(1.0, sum(1 for j, g in enumerate(gts) if j != i and g == pred) / 3.0)
                for i in range(len(gts))
            ]
            total += sum(accs) / len(accs)
        acc = 100.0 * total / len(scored)
        logging.info("VQA accuracy: %.2f (%d scored)", acc, len(scored))
        return {"agg_metrics": acc, "accuracy": acc, "n": len(results)}


@registry.register_task("gqa")
class GQATask(VQATask):
    """GQA exact-match VQA (reference lavis/tasks/vqa.py:169-230): valid_step
    emits {question_id, pred_ans, gt_ans}; scoring normalizes the PREDICTION
    only (processPunctuation + processDigitArticle) and counts exact string
    matches against the single ground-truth answer. Rows with gt_ans=None
    trigger a leaderboard dump instead of scoring (vqa.py:204-207)."""

    def valid_step(self, params, sample) -> List[dict]:
        answer = self.generate_fn(
            params, sample, num_beams=self.num_beams,
            max_length=self.max_len, min_length=self.min_len,
            prompt=self.prompt,
        )
        return [{
            "question_id": _coerce_id(sample["question_id"]),
            "pred_ans": answer,
            "gt_ans": sample.get("answer"),
        }]

    def _save_result_leaderboard(self, results) -> str:
        """GQA leaderboard format: [{questionId, prediction}] strings
        (reference vqa_reading_comprehension.py:231-248)."""
        rows = [
            {"questionId": str(r["question_id"]), "prediction": str(r["pred_ans"])}
            for r in results
        ]
        path = os.path.join(self.result_dir, "leaderboard.json")
        os.makedirs(self.result_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f)
        logging.info("Saved results for leaderboard evaluation at %s", path)
        return path

    def after_evaluation(self, results, split_name="val", **kwargs):
        save_result(
            results, self.result_dir, f"{split_name}_vqa_result",
            remove_duplicate="question_id",
        )
        acc = []
        for r in results:
            if r["gt_ans"] is None:
                self._save_result_leaderboard(results)
                return {}
            acc.append(1.0 if vqa_normalize(str(r["pred_ans"])) == r["gt_ans"] else 0.0)
        accuracy = 100.0 * sum(acc) / max(len(acc), 1)
        metrics = {"agg_metrics": accuracy, "acc": accuracy, "n": len(results)}
        logging.info("GQA eval: %s", metrics)
        return metrics


@registry.register_task("aok_vqa")
class AOKVQATask(VQATask):
    """A-OKVQA direct-answer VQA (reference lavis/tasks/vqa.py:233-314):
    per question, accuracy = min(1, #direct-answer matches / 3) with NO
    normalization of either side (allenai eval_predictions.py semantics the
    reference copies at vqa.py:276-281); leaderboard dump is a dict
    question_id → {direct_answer, multiple_choice: ""} (vqa.py:295-314)."""

    def valid_step(self, params, sample) -> List[dict]:
        answer = self.generate_fn(
            params, sample, num_beams=self.num_beams,
            max_length=self.max_len, min_length=self.min_len,
        )
        return [{
            "question_id": sample["question_id"],
            "pred_ans": answer,
            "gt_ans": sample.get("direct_answers"),
        }]

    def _save_result_leaderboard(self, results) -> str:
        board = {
            r["question_id"]: {"direct_answer": r["pred_ans"], "multiple_choice": ""}
            for r in results
        }
        path = os.path.join(self.result_dir, "leaderboard.json")
        os.makedirs(self.result_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(board, f)
        logging.info("Saved results for leaderboard evaluation at %s", path)
        return path

    def after_evaluation(self, results, split_name="val", **kwargs):
        save_result(
            results, self.result_dir, f"{split_name}_vqa_result",
            remove_duplicate="question_id",
        )
        acc = []
        for r in results:
            if r["gt_ans"] is None:
                self._save_result_leaderboard(results)
                return {}
            num_match = sum(1 for g in r["gt_ans"] if r["pred_ans"] == g)
            acc.append(min(1.0, num_match / 3.0))
        accuracy = 100.0 * sum(acc) / max(len(acc), 1)
        metrics = {"agg_metrics": accuracy, "acc": accuracy, "n": len(results)}
        logging.info("A-OKVQA eval: %s", metrics)
        return metrics


@registry.register_task("vqa_reading_comprehension")
class VQARCTask(VQATask):
    """Three-stream reading-comprehension VQA (reference
    lavis/tasks/vqa_reading_comprehension.py:22-153) — the serving harness
    for PnP-VQA / Img2Prompt: `predict_answers_fn(params, sample, **knobs)`
    returns (answers, captions, gradcams); valid_step emits the three
    parallel result streams; after_evaluation saves gradcam (.npz — the
    TPU-native stand-in for the reference's torch .pth, :122-153), caption,
    and vqa result files, then scores like VQATask when gt is attached.

    Config knobs mirror vqa_reading_comprehension.py:61-78:
    internal_bsz_fid / num_captions / num_captions_fid / cap_max_length /
    cap_min_length / top_k / top_p / repetition_penalty / num_patches /
    block_num."""

    RC_KNOBS = (
        "internal_bsz_fid", "num_captions", "num_captions_fid",
        "cap_max_length", "cap_min_length", "top_k", "top_p",
        "repetition_penalty", "num_patches", "block_num",
    )

    def __init__(self, predict_answers_fn: Optional[Callable] = None, **kw):
        rc_cfg = {k: kw.pop(k) for k in list(kw) if k in self.RC_KNOBS}
        super().__init__(**kw)
        self.predict_answers_fn = predict_answers_fn
        self.rc_cfg = rc_cfg

    def valid_step(self, params, sample) -> List[list]:
        answers, captions, gradcams = self.predict_answers_fn(
            params, sample,
            inference_method=self.inference_method,
            num_beams=self.num_beams, max_len=self.max_len,
            min_len=self.min_len, **self.rc_cfg,
        )
        qids = sample["question_id"]
        if not isinstance(qids, (list, tuple)):
            qids, answers = [qids], [answers]
            captions, gradcams = [captions], [gradcams]
        pred_qa, caps, cams = [], [], []
        for ans, cap, cam, qid in zip(answers, captions, gradcams, qids):
            qid = _coerce_id(qid)
            pred_qa.append({"question_id": qid, "answer": ans})
            caps.append({"question_id": qid, "caption": cap})
            cams.append({"question_id": qid, "gradcam": cam})
        return [cams, caps, pred_qa]

    def evaluation(self, params, loader, *, log_freq: int = 50) -> List[list]:
        metrics = MetricLogger()
        results: List[list] = []
        for sample in metrics.log_every(loader, log_freq, header="Evaluation"):
            results.extend(self.valid_step(params, sample))
        return results

    def save_gradcam(self, result, filename) -> str:
        """Gradcam arrays → one .npz keyed by question_id (replacing the
        reference's per-rank torch.save + merge, :122-153 — under SPMD each
        host already holds the full stream)."""
        import numpy as np

        os.makedirs(self.result_dir, exist_ok=True)
        path = os.path.join(self.result_dir, f"{filename}.npz")
        seen: Dict[str, Any] = {}
        for r in result:
            k = str(r["question_id"])
            if k not in seen:
                seen[k] = np.asarray(r["gradcam"])
        np.savez(path, **seen)
        logging.info("gradcam file saved to %s", path)
        return path

    def after_evaluation(self, results, split_name="val", **kwargs):
        # results is a flat list of interleaved [cams, caps, qa] triples
        # (reference chains val_result[0::3]/[1::3]/[2::3], :93-116)
        from itertools import chain

        cams = list(chain(*results[0::3]))
        caps = list(chain(*results[1::3]))
        qa = list(chain(*results[2::3]))
        self.save_gradcam(cams, f"{split_name}_gradcam_result")
        save_result(caps, self.result_dir, f"{split_name}_caption_result",
                    remove_duplicate="question_id")
        save_result(qa, self.result_dir, f"{split_name}_vqa_result",
                    remove_duplicate="question_id")
        return self._score_qa(qa)

    def _score_qa(self, qa: List[dict]) -> Dict[str, float]:
        return {"agg_metrics": 0.0, "n": len(qa)}


@registry.register_task("gqa_reading_comprehension")
class GQARCTask(VQARCTask):
    """GQA through the reading-comprehension pipeline (reference
    vqa_reading_comprehension.py:156-248): valid_step also carries gt_ans;
    scoring is GQA exact match with prediction-side normalization applied
    only under inference_method == 'generate' (:211-215)."""

    def valid_step(self, params, sample) -> List[list]:
        cams, caps, pred_qa = super().valid_step(params, sample)
        gts = sample.get("answer")
        if not isinstance(gts, (list, tuple)):
            gts = [gts]
        out_qa = []
        for row, gt in zip(pred_qa, gts):
            out_qa.append({
                "question_id": row["question_id"],
                "pred_ans": row["answer"],
                "gt_ans": gt,
            })
        return [cams, caps, out_qa]

    def _score_qa(self, qa: List[dict]) -> Dict[str, float]:
        acc = []
        for r in qa:
            if r["gt_ans"] is None:
                GQATask._save_result_leaderboard(self, qa)
                return {}
            pred = r["pred_ans"]
            if self.inference_method == "generate":
                pred = vqa_normalize(str(pred))
            acc.append(1.0 if pred == r["gt_ans"] else 0.0)
        accuracy = 100.0 * sum(acc) / max(len(acc), 1)
        metrics = {"agg_metrics": accuracy, "acc": accuracy, "n": len(qa)}
        logging.info("GQA-RC eval: %s", metrics)
        return metrics


@registry.register_task("dialogue")
class DialogueTask(BaseTask):
    """Video-grounded dialogue (reference lavis/tasks/dialogue.py:20-84):
    valid_step is the model LOSS on the dialogue sample (not generation,
    :51-55); after_evaluation reports mean validation loss as agg_metrics
    when report_metric is set (:57-65). The reference's dormant
    coco_dialogue_eval CIDEr+BLEU path (:93-127) is represented by the
    caption-metric hook `metric_fn` (pycocoevalcap is not in this image)."""

    def __init__(
        self,
        loss_fn: Optional[Callable] = None,
        num_beams: int = 3,
        max_len: int = 30,
        min_len: int = 8,
        evaluate: bool = True,
        report_metric: bool = True,
        metric_fn: Optional[Callable] = None,
        **kw,
    ):
        super().__init__(**kw)
        self.loss_fn = loss_fn
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.evaluate = evaluate
        self.report_metric = report_metric
        self.metric_fn = metric_fn

    def valid_step(self, params, sample) -> List[float]:
        return [float(self.loss_fn(params, sample))]

    def after_evaluation(self, results, split_name="val", epoch=0, **kwargs):
        if self.report_metric:
            avg = sum(results) / max(len(results), 1)
            return {"agg_metrics": avg, "n": len(results)}
        return {"agg_metrics": 0.0, "n": len(results)}

