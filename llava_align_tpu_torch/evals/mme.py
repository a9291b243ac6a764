"""MME benchmark scoring (copy of llava_align_tpu/evals/mme.py, numpy only,
on the port's calibrate/posthoc.py and evals/pope.py).

Parity: reference experiments/eval/MME/eval_tool/calculation.py (answer
parsing :23-37, per-task metrics :40-83, acc+ pairing :86-154) and
convert_answer_to_mme.py (answers-jsonl → per-category txt :40-73).
Implemented with numpy (no sklearn dependency).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

EVAL_TYPE_DICT = {
    "Perception": ["existence", "count", "position", "color"],
    "Cognition": [
        "commonsense_reasoning",
        "numerical_calculation",
        "text_translation",
        "code_reasoning",
    ],
}

LABEL_MAP = {"yes": 1, "no": 0, "other": -1}


def parse_pred_ans(pred_ans: str) -> str:
    """reference calculation.py:23-37."""
    pred_ans = pred_ans.lower()
    if pred_ans in ("yes", "no"):
        return pred_ans
    prefix = pred_ans[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def compute_metric(gts: Sequence[str], preds: Sequence[str]) -> Dict[str, float]:
    """reference calculation.py:40-83 (sklearn replaced with direct counts;
    accuracy includes 'other' predictions as wrong, precision/recall are on
    the cleaned subset with positive class 'yes')."""
    if len(gts) != len(preds):
        raise ValueError(
            f"count mismatch: {len(preds)} predictions vs {len(gts)} ground"
            " truths — partial answers file or wrong split?"
        )
    g = [LABEL_MAP[x] for x in gts]
    p = [LABEL_MAP[x] for x in preds]
    n = len(g)
    acc = sum(1 for a, b in zip(g, p) if a == b) / n if n else 0.0

    tp = fn = fp = tn = other = 0
    for gt, pred in zip(g, p):
        if pred == -1:
            other += 1
            continue
        if gt == 1 and pred == 1:
            tp += 1
        elif gt == 1 and pred == 0:
            fn += 1
        elif gt == 0 and pred == 1:
            fp += 1
        else:
            tn += 1
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    return {
        "TP": tp, "FN": fn, "TN": tn, "FP": fp,
        "precision": precision, "recall": recall,
        "other_num": other, "acc": acc,
    }


def score_task_lines(lines: Sequence[str]) -> Dict[str, float]:
    """Score one task's txt lines ('img\\tquestion\\tgt\\tpred', 2 per image).
    Task score = (acc + acc_plus) * 100 (reference calculation.py:108-145)."""
    chunks = [lines[i : i + 2] for i in range(0, len(lines), 2)]
    gts: List[str] = []
    preds: List[str] = []
    acc_plus_correct = 0
    for ci, pair in enumerate(chunks):
        if len(pair) != 2:
            raise ValueError(
                f"odd line count ({len(lines)}): MME ships exactly two"
                " questions per image (reference calculation.py:118) — pair"
                f" {ci} has {len(pair)} line(s); truncated answers file?"
            )
        correct = 0
        for item in pair:
            fields = item.rstrip("\n").split("\t")
            if len(fields) != 4:
                raise ValueError(
                    f"malformed line (pair {ci}): expected 4 tab-separated"
                    f" fields img\\tquestion\\tgt\\tpred, got {len(fields)}:"
                    f" {item.rstrip()[:120]!r}"
                )
            _, _, gt_ans, pred_ans = fields
            gt_ans = gt_ans.lower()
            if gt_ans not in ("yes", "no"):
                raise ValueError(
                    f"ground-truth answer must be yes/no, got {gt_ans!r}"
                    f" (pair {ci}) — gt and pred columns swapped?"
                )
            pred = parse_pred_ans(pred_ans)
            gts.append(gt_ans)
            preds.append(pred)
            if gt_ans == pred:
                correct += 1
        if correct == 2:
            acc_plus_correct += 1
    m = compute_metric(gts, preds)
    m["acc_plus"] = acc_plus_correct / len(chunks) if chunks else 0.0
    m["task_score"] = (m["acc"] + m["acc_plus"]) * 100
    return m


def score_results_dir(results_dir: str) -> Dict[str, Dict]:
    """Full MME report over a per-category txt dir."""
    report: Dict[str, Dict] = {}
    for eval_type, tasks in EVAL_TYPE_DICT.items():
        total = 0.0
        task_scores = {}
        for task in tasks:
            path = os.path.join(results_dir, task + ".txt")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                m = score_task_lines(f.readlines())
            task_scores[task] = m
            total += m["task_score"]
        report[eval_type] = {"total_score": total, "tasks": task_scores}
    return report


def score_sweep_dirs(
    folder: str,
    prefix: str,
    *,
    combined: bool = True,
    filter_malformed: bool = True,
    csv_path: str | None = None,
) -> Dict[str, Dict]:
    """Aggregate per-setting MME scores across results dirs named
    ``{prefix}{setting}`` under `folder` — the main loops of the reference's
    eval_tool/calculation_sampling.py:162-181 and
    calculation_calibrate.py:160-182 (pandas/xlsx replaced with a returned
    {setting: report} dict + optional CSV).

    combined=True scores the single 'All' task group those variants use
    (calculation_sampling.py:10); filter_malformed drops lines without the
    4-field img\\tq\\tgt\\tpred shape (calculation_sampling.py:98)."""
    eval_types = (
        {"All": [t for ts in EVAL_TYPE_DICT.values() for t in ts]}
        if combined
        else EVAL_TYPE_DICT
    )
    results: Dict[str, Dict] = {}
    for file in sorted(os.listdir(folder)):
        full = os.path.join(folder, file)
        if not (file.startswith(prefix) and os.path.isdir(full)):
            continue
        setting = file[len(prefix):] or "default"
        report: Dict[str, Dict] = {}
        for eval_type, tasks in eval_types.items():
            total = 0.0
            task_scores = {}
            for task in tasks:
                path = os.path.join(full, task + ".txt")
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    lines = f.readlines()
                if filter_malformed:
                    lines = [
                        ln.strip() for ln in lines
                        if len(ln.strip().split("\t")) == 4
                    ]
                m = score_task_lines(lines)
                task_scores[task] = m
                total += m["task_score"]
            report[eval_type] = {"total_score": total, "tasks": task_scores}
        results[setting] = report
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("setting,eval_type,total_score\n")
            for setting in sorted(results):
                for eval_type, rep in results[setting].items():
                    f.write(f"{setting},{eval_type},{rep['total_score']:.2f}\n")
    return results


def calibrated_predictions(
    answers: Sequence[dict],
    setting: str = "none_unk",
    calibrate_mode: str = "individual",
) -> List[str]:
    """Post-Hoc-calibrated yes/no predictions from dumped top-k dicts
    (reference convert_answer_to_mme_calibrate.py:80-140): the naive class
    probs are corrected with the content-free distribution of `setting`
    ('none' | 'unk' | 'none_unk' | ...), per-sample or globally."""
    import numpy as np

    from llava_align_tpu_torch.calibrate.posthoc import calibrate_weight, get_prob_from_logits
    from llava_align_tpu_torch.evals.pope import COMBO_SETTINGS, _safe_normalize

    if setting == "naive":
        return [a["text"] for a in answers]

    parts = COMBO_SETTINGS.get(setting, [setting])
    for p in parts:
        missing = next((i for i, a in enumerate(answers) if p not in a), None)
        if missing is not None:
            raise ValueError(
                f"answers record {missing} has no {p!r} top-k dump — was the"
                " run made with --calibrate (and the matching probe flags)?"
            )
    naive = [get_prob_from_logits(a["naive"]) for a in answers]
    cf = {p: [get_prob_from_logits(a[p]) for a in answers] for p in parts}

    W = np.identity(2)
    b = np.zeros([2, 1])
    if calibrate_mode == "all":
        all_p_y = np.sum([np.asarray(cf[p], np.float64) for p in parts], axis=0)
        p_cf = _safe_normalize(np.mean(all_p_y, axis=0))
        W, b = calibrate_weight(p_cf)

    preds = []
    label = {0: "yes", 1: "no"}
    for i in range(len(answers)):
        if calibrate_mode == "individual":
            p_cf = np.sum([np.asarray(cf[p][i], np.float64) for p in parts], axis=0)
            p_cf = _safe_normalize(p_cf) + 1e-4
            W, b = calibrate_weight(p_cf)
        # raw class-prob sums, NOT normalized (reference
        # convert_answer_to_mme_calibrate.py:116 uses prob['naive'][i] as-is)
        gen = np.asarray(naive[i], np.float64)
        cal = np.matmul(W, gen[:, None]) + b
        s = float(np.sum(cal))
        # identity-W calibration can sum to ~0 (see evals/pope.py) — argmax
        # is taken unnormalized then, same ordering, no nan
        if np.isfinite(s) and abs(s) > 1e-12:
            cal = cal / s
        preds.append(label[int(np.argmax(cal))].capitalize())
    return preds


def convert_calibrated_answers_to_category_txt(
    answers: Sequence[dict],
    gt: Mapping[Tuple[str, str, str], str],
    out_dir: str,
    setting: str = "none_unk",
    calibrate_mode: str = "individual",
) -> List[str]:
    """Calibrated variant of the converter: predictions come from the affine
    correction instead of the generated text."""
    preds = calibrated_predictions(answers, setting, calibrate_mode)
    rewritten = [dict(a, text=p) for a, p in zip(answers, preds)]
    return convert_answers_to_category_txt(rewritten, gt, out_dir)


def convert_answers_to_category_txt(
    answers: Iterable[dict],
    gt: Mapping[Tuple[str, str, str], str],
    out_dir: str,
) -> List[str]:
    """answers jsonl rows {question_id: 'category/.../img.png', prompt, text}
    → per-category txt files (reference convert_answer_to_mme.py:55-73)."""
    os.makedirs(out_dir, exist_ok=True)
    results = defaultdict(list)
    for answer in answers:
        category = answer["question_id"].split("/")[0]
        file = answer["question_id"].split("/")[-1].split(".")[0] + ".txt"
        results[category].append((file, answer["prompt"], answer["text"]))

    written = []
    for category, tups in results.items():
        path = os.path.join(out_dir, f"{category}.txt")
        with open(path, "w") as fp:
            for file, prompt, answer in tups:
                if "Answer the question using a single word or phrase." in prompt:
                    prompt = prompt.replace(
                        "Answer the question using a single word or phrase.", ""
                    ).strip()
                if "Please answer yes or no." not in prompt:
                    prompt = prompt + " Please answer yes or no."
                    if (category, file, prompt) not in gt:
                        prompt = prompt.replace(
                            " Please answer yes or no.", "  Please answer yes or no."
                        )
                gt_ans = gt[(category, file, prompt)]
                fp.write("\t".join((file, prompt, gt_ans, answer)) + "\n")
        written.append(path)
    return written
